"""The port's checkpointed, fault-tolerant train loop
(`repro_torch.launch.train.train_loop(ckpt_dir=)`) against the JAX
package's (`tests/test_checkpoint_resume.py`).

A killed run restored from its checkpoint replays onto the uninterrupted
run's trajectory bit for bit: the checkpoint holds params, quantizers,
the whole QASSOState (AdamW's moments, the step counter and AdamW's
count as Python ints, partition and keep masks, gamma) and the data key;
a failure before any checkpoint restarts from an initial state that the
in-place updates never touched.

Parity: the JAX package's `train_loop` (internlm2 smoke config, 10
steps, checkpoint every 5, a failure at step 7: 12 losses over its
warm-up, projection and first joint steps, the replay crossing from
projection into the joint stage) against `run_steps`, the port's loop,
from the reference's initial state on the reference's batches (both
cross as numpy). Driving the reference's own step, the port's loop gives
its losses and final state bit for bit. With the port's own step:

- every step, taken from the reference's state at that step, matches
  the reference's step: loss within 1e-5 relative, identical masks,
  gammas within 1e-4 relative (Eq 16 divides by cos_g; a forget term
  gamma * x_Q then moves params by under 1e-4 of max|w|), q_m and t
  within 1e-4, params within 1e-4 of max|w| but for elements exactly
  one forget quantum (gamma * d) apart, d within 1e-2 relative. Two
  things part further, and the reference's own step parts as far from
  itself when every weight moves by one ulp (the witness, three draws):
  where an SGD step has driven d to its 1e-8 floor, v = |w|^t / d
  reaches 4e7, beyond 2^22, so the fraction round(v) - v that Eq 4's
  d-gradient sums is rounding (measured: the port's next d parts by up
  to 0.25, a witness's by up to 383); and a d that moves by 4e-6 flips
  round(|w| / d) of a few forgotten weights (the port: 1-6 elements a
  tensor, a witness: up to 3158);
- over the trajectory those roundings compound, as they do between the
  reference and the witnesses that start from one ulp on every initial
  weight: each of the 12 losses is held within 4x the witnesses' largest
  gap at or before its step (their gaps spread over a factor of ~10
  between perturbations; the port's reach 3.1e-2 at step 9, the
  witnesses' 1.3e-2), the first three within 1e-5, and the final
  partition (set at step 8) differs from the reference's in no more
  units than the witnesses' do.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import CompressionConfig as JComp
from repro.configs import get_arch as j_get_arch
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.launch import train as JT
from repro.models.transformer import LM as JLM
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.configs import get_arch, get_overrides
from repro_torch.convert import geta_state_from_numpy
from repro_torch.data.synthetic import step_key
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM

ARCH = "internlm2-1.8b"
KW = dict(smoke=True, batch=2, seq=8, verbose=False, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny ops: one intra-op thread, so parallel suite workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_tree_bitwise(a, b):
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb, f"tree structure differs: {sa} vs {sb}"
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


def test_kill_and_resume_bitwise(tmp_path):
    """Train 10 steps; checkpoint at 5; die at 7; restore and replay.
    The final tree equals the uninterrupted run bit for bit."""
    clean, _, _, want = T.train_loop(ARCH, steps=10, **KW)
    report = {}
    faulty, _, _, losses = T.train_loop(
        ARCH, steps=10, ckpt_dir=str(tmp_path), inject_failure_at=7,
        checkpoint_every=5, report=report, **KW)
    # steps 5 and 6 ran twice (once before the kill, once on replay)
    assert len(losses) == 12
    assert losses == want[:7] + want[5:]
    assert_tree_bitwise(clean, faulty)
    assert report["run_result"].restarts == 1
    assert report["run_result"].final_step == 10
    assert len(report["save_s"]) == 2 and len(report["restore_s"]) == 1
    # ... and the newest checkpoint is on disk, loadable
    assert latest_step(str(tmp_path)) == 10


def test_failure_before_first_checkpoint_restarts_fresh(tmp_path):
    """A failure with NO checkpoint on disk restarts from the INITIAL
    state, which the in-place moment updates of steps 0-2 must not have
    touched: the final tree still equals the uninterrupted run's."""
    clean, _, _, _ = T.train_loop(ARCH, steps=8, **KW)
    faulty, _, _, losses = T.train_loop(
        ARCH, steps=8, ckpt_dir=str(tmp_path), inject_failure_at=3,
        checkpoint_every=5, **KW)
    # steps 0-2 ran, failure at 3 (pre-checkpoint), then a full 0-7 replay
    assert len(losses) == 11
    assert_tree_bitwise(clean, faulty)


def test_resume_covers_int_and_rng_leaves(tmp_path):
    """The saved tree holds QASSO's step counter and AdamW's count as
    Python ints and the next step's data key (int64), each restored with
    its exact type."""
    state, _, _, _ = T.train_loop(ARCH, steps=4, ckpt_dir=str(tmp_path),
                                  checkpoint_every=2, **KW)
    restored, step = restore_checkpoint(str(tmp_path), state)
    assert step == 4
    assert type(restored["qstate"].step) is int
    assert restored["qstate"].step == 4
    assert type(restored["qstate"].base.count) is int
    assert restored["rng"].dtype == torch.int64
    assert torch.equal(restored["rng"], step_key(0, 4))
    assert_tree_bitwise(state, restored)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX package's loop with a failure at 7 (losses, final state as
    numpy), and the pieces to drive its step from outside: its jitted
    step, its initial state as numpy and its batches."""
    state, _, _, losses = JT.train_loop(
        ARCH, smoke=True, steps=10, batch=2, seq=8, verbose=False,
        ckpt_dir=str(tmp_path_factory.mktemp("ref")), inject_failure_at=7,
        checkpoint_every=5)
    jlm = JLM(j_get_arch(ARCH, smoke=True))
    _, jqasso = JT.build_geta(jlm, JComp(**vars(T.default_compression(10))),
                              lr=3e-4)
    params, _ = jlm.init(jax.random.PRNGKey(0))
    qparams = jlm.init_qparams(params, bits_init=16.0)
    init = (params, qparams, jqasso.init(params, qparams))
    batches = [np.asarray(j_lm_batch(0, i, 2, 8, jlm.cfg.vocab)["tokens"])
               for i in range(10)]
    final = _np((state["params"], state["qparams"], state["qstate"]))
    return (losses, final, init, batches,
            jax.jit(JT.make_geta_train_step(jlm, jqasso)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _initial(np_state):
    p, q, s = geta_state_from_numpy(*np_state)
    return {"params": p, "qparams": q, "qstate": s, "rng": step_key(0, 0)}


def _tokens(batches):
    return lambda i, key: {"tokens": torch.from_numpy(
        batches[i].astype(np.int64))}


def _ulp(params, seed):
    """Every weight moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)
    return {k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, -np.inf,
                                        np.inf).astype(v.dtype))
            for k, v in params.items()}


def _trajectory(jstep, state, batches):
    """The reference's step over the batches from a numpy state: the
    states before each step and after the last, and each step's loss."""
    states, losses = [state], []
    for b in batches:
        out = _np(jstep(*state, {"tokens": b}))
        state = out[:3]
        states.append(state)
        losses.append(float(out[3]["loss"]))
    return states, losses


@pytest.fixture(scope="module")
def trajectories(reference_run):
    """The reference's uninterrupted trajectory (which its loop replays
    bit for bit) and the witnesses': the same from the initial state
    with every weight moved by one ulp, for three draws of the signs."""
    _, _, init, batches, jstep = reference_run
    init = _np(init)
    ref = _trajectory(jstep, init, batches)
    witnesses = [_trajectory(jstep, (_ulp(init[0], seed), *init[1:]),
                             batches) for seed in (1, 2, 3)]
    return ref, witnesses


def test_port_loop_drives_the_reference_step_bitwise(reference_run,
                                                      tmp_path):
    """The port's loop (its FaultTolerantLoop, checkpoints, the copy that
    keeps the initial state untouched, the data key) around the JAX
    package's own jitted step, the state crossing as numpy each step:
    the reference loop's 12 losses and final state, bit for bit."""
    want, (wp, wq, ws), init, batches, jstep = reference_run
    jleaves, jdef = jax.tree_util.tree_flatten(init)

    def step(p, q, s, batch):
        leaves, _ = tree_flatten((p, q, s))
        args = jax.tree_util.tree_unflatten(jdef, [
            np.asarray(x if isinstance(x, int) else x.numpy(),
                       np.asarray(t).dtype) for x, t in zip(leaves, jleaves)])
        out = _np(jstep(*args, {"tokens": batch["tokens"].numpy().astype(
            np.int32)}))
        return (*geta_state_from_numpy(*out[:3]), out[3])

    report = {}
    state, losses = T.run_steps(
        step, _initial(_np(init)), 10, _tokens(batches),
        lambda i: step_key(0, i), ckpt_dir=str(tmp_path),
        checkpoint_every=5, inject_failure_at=7, report=report)
    assert losses == want and len(losses) == 12
    assert report["run_result"].restarts == 1
    got = (state["params"], state["qparams"], state["qstate"])
    assert_tree_bitwise(got, geta_state_from_numpy(wp, wq, ws))


def _port_step():
    lm = LM(get_arch(ARCH, smoke=True))
    _, qasso = T.build_geta(
        lm, T.default_compression(10), lr=3e-4,
        base_optimizer=get_overrides(ARCH).get("base_optimizer", "adamw"))
    return T.make_geta_train_step(lm, qasso), qasso


def _red_diff(a, b) -> int:
    """Units in which two partitions differ."""
    return sum(int((np.asarray(a[k]) != np.asarray(b[k])).sum()) for k in a)


def test_loss_sequence_against_the_reference_loop(reference_run,
                                                  trajectories, tmp_path):
    """The port's loop and step from the reference's initial state on its
    batches: 12 losses, the replayed steps' losses equal to their first
    run's on each side; the first three within 1e-5 of the reference's,
    and each of the 12 within 4x the running maximum of the witnesses'
    gap; the final partition as close to the reference's as the
    witnesses' (see the module docstring)."""
    want, (_, _, ws), init, batches, _ = reference_run
    _, witnesses = trajectories
    step, _ = _port_step()
    report = {}
    state, losses = T.run_steps(
        step, _initial(_np(init)), 10, _tokens(batches),
        lambda i: step_key(0, i), ckpt_dir=str(tmp_path),
        checkpoint_every=5, inject_failure_at=7, report=report)
    assert len(losses) == len(want) == 12
    assert losses[7:9] == losses[5:7] and want[7:9] == want[5:7]
    assert report["run_result"].restarts == 1
    np.testing.assert_allclose(losses[:3], want[:3], rtol=1e-5, atol=0)
    order = list(range(7)) + list(range(5, 10))     # the loop's 12 steps
    gap = lambda a, i: abs(a[i] - want[order.index(i)]) / abs(
        want[order.index(i)])
    for n, i in enumerate(order):
        bound = max(gap(w[1], j) for w in witnesses for j in range(i + 1))
        assert abs(losses[n] - want[n]) <= 4 * bound * abs(want[n]), (
            n, abs(losses[n] - want[n]) / abs(want[n]), bound)
    red = {k: v.numpy() for k, v in state["qstate"].redundant.items()}
    assert sum(int(v.sum()) for v in red.values()) > 0
    assert _red_diff(red, ws.redundant) <= max(
        _red_diff(w[0][-1][2].redundant, ws.redundant) for w in witnesses)


def test_every_step_matches_the_reference_from_its_state(reference_run,
                                                         trajectories):
    """Each of the 10 steps of the reference's trajectory (its loop's 12
    replay two of them), taken by the port's step from the reference's
    state before it, against the reference's state after it, at the
    limits of the module docstring; d and the params' forget quanta
    part no further than the witness step's (one ulp on every weight)."""
    _, _, _, batches, jstep = reference_run
    (states, losses), _ = trajectories
    step, qasso = _port_step()
    sites = [s.name for s in qasso.weight_sites]
    stages = set()
    for i, b in enumerate(batches):
        (wp, wq, ws), (p0, q0, s0) = states[i + 1], states[i]
        p, q, s, met = step(*geta_state_from_numpy(p0, q0, s0), {
            "tokens": torch.from_numpy(b.astype(np.int64))})
        wits = [_np(jstep(_ulp(p0, 10 * i + k), q0, s0, {"tokens": b}))
                for k in range(3)]
        stages.add(int(met["stage"]))
        assert abs(float(met["loss"]) - losses[i]) <= 1e-5 * abs(losses[i])
        for k in ws.redundant:
            assert np.array_equal(s.redundant[k].numpy(), ws.redundant[k])
            assert np.array_equal(s.keep_mask[k].numpy(), ws.keep_mask[k])
        np.testing.assert_allclose(s.gamma.numpy(), ws.gamma, rtol=1e-4)
        for k in wq:
            for f in ("q_m", "t"):
                np.testing.assert_allclose(float(getattr(q[k], f)),
                                           float(getattr(wq[k], f)),
                                           rtol=1e-4, err_msg=(i, k, f))
            rel = lambda x: abs(float(x) - float(wq[k].d)) / float(wq[k].d)
            held = rel(q[k].d) <= T.STEP_TOLERANCES["d"]
            if float(q0[k].q_m) ** float(q0[k].t) / float(q0[k].d) >= 2 ** 22:
                # v = |w|^t / d beyond 2^22: the fraction round(v) - v that
                # Eq 4 sums is rounding, and so is the reference's own d
                held = held or max(rel(w[1][k].d) for w in wits) > \
                    T.STEP_TOLERANCES["d"]
            assert held and float(q[k].d) > 0, (i, k, rel(q[k].d))
        for k, w in wp.items():
            tol = 1e-4 * float(np.abs(w).max())
            diff = np.abs(p[k].numpy() - w)
            far = diff > tol
            if not far.any():
                continue
            site = qasso.site_of_param[k]
            quantum = float(ws.gamma[sites.index(site)]) * float(wq[site].d)
            assert int(far.sum()) <= max(
                int((np.abs(x[0][k] - w) > tol).sum()) for x in wits), (i, k)
            np.testing.assert_allclose(diff[far], quantum, rtol=1e-2,
                                       err_msg=(i, k))
    assert stages == {0, 1, 2}

"""The port's deterministic data-parallel and FSDP GETA training against
the JAX package's (`tests/test_sharded_training.py`, its 5 tests
mirrored), on CPU ranks over gloo.

The contract: a GETA step on k ranks is bitwise the 1-rank step with
`grad_slices=k` (ordered gradient sum, QASSO on fully gathered,
rank-identical inputs), so 10 steps through every QASSO stage (warm-up
[0, 2), projection [2, 4), joint [4, 8) with partitions at 4 and 6 and the
hard zeroing at 7, cool-down [8, 10)) agree within the reference's 1e-6
with identical masks and step, and in fact bit for bit; every rank ends
with the same masks and quantizers. Ranks run one intra-op thread, and
so does this process's 1-rank reference (`one_torch_thread`); they train
every case while this process runs the references (`runs`).

The 1-rank port step with grad_slices=4 is held to the JAX package's
1-device sharded step one step at a time, each step from the JAX state
before it, at the tolerances `tests/test_torch_run_loop.py` holds (its
module docstring): loss within 1e-5 relative, identical masks, gammas,
q_m and t within 1e-4, d within `STEP_TOLERANCES["d"]` unless v =
|w|^t / d passed 2^22, where the reference's own step from one ulp on
every weight (the witness) parts as far (gamma likewise: beyond 1e-4
only where a witness's gamma parts further), and params within 1e-4 of
max|w| but for elements one forget quantum apart, no more of them than a
witness has. Whole trajectories part for the known reason (ROADMAP,
"Multi-step trajectories").
"""
import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro.configs import CompressionConfig as JComp
from repro.configs import get_arch as jget_arch
from repro.data.synthetic import batch_for as jbatch_for
from repro.launch import train as JT
from repro.launch.mesh import make_subset_mesh as jsubset_mesh
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_arch
from repro_torch.convert import geta_state_from_numpy
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch import train as T
from repro_torch.launch.mesh import Mesh, RankPool, make_subset_mesh
from repro_torch.models.transformer import LM


@pytest.fixture(scope="module")
def ranks():
    with RankPool(4, "cpu", verbose=False) as pool:
        yield pool


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (ranks, fsdp, grad_slices, model) of every multi-rank case
CASES = [(n, fsdp, n, "lm") for n in (2, 4) for fsdp in (False, True)] + [
    (4, False, 4, "cnn")]
_JAX: dict = {}


@pytest.fixture(scope="module")
def runs(ranks):
    """({case: per-rank results}, {(grad_slices, model): the 1-rank
    result}); the JAX package's run (`jax_run`) is made meanwhile."""
    ranks.submit(R.train_cases, CASES)
    refs = {(k, m): R.sharded_train(1, False, k, m)
            for _, _, k, m in CASES}
    _jax_run()
    per_rank = ranks.collect()
    return {c: [r[c] for r in per_rank] for c in CASES}, refs


def _assert_parity(a, b):
    losses_a, params_a, q_a, s_a, _ = a
    losses_b, params_b, q_b, s_b, _ = b
    np.testing.assert_allclose(losses_a, losses_b, rtol=0, atol=1e-6)
    for k in q_a:
        np.testing.assert_allclose(q_a[k], q_b[k], rtol=0, atol=1e-6)
    for k in params_a:
        np.testing.assert_allclose(params_a[k], params_b[k], rtol=0,
                                   atol=1e-6)
    # masks and the step counter must be IDENTICAL: a single flipped unit
    # means the ranks trained different subnets
    for key in ("redundant", "keep_mask"):
        for fam in s_a[key]:
            np.testing.assert_array_equal(s_a[key][fam], s_b[key][fam])
    assert s_a["step"] == s_b["step"]
    # and bit for bit, which one intra-op thread makes so
    assert losses_a == losses_b
    for k in params_a:
        np.testing.assert_array_equal(params_a[k], params_b[k])
    assert q_a == q_b


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_transformer_parity_1dev_vs_4dev(runs, fsdp, n):
    """n-rank GETA steps == the 1-rank step with grad_slices=n over 10
    steps, through every QASSO stage, on every rank."""
    got, refs = runs
    res = got[(n, fsdp, n, "lm")]
    assert all(r is None for r in res[n:])
    for r in res[:n]:
        _assert_parity(refs[(n, "lm")], r)


def test_cnn_parity_1dev_vs_4dev(runs):
    got, refs = runs
    for r in got[(4, False, 4, "cnn")]:
        _assert_parity(refs[(4, "cnn")], r)


def test_fsdp_plan_actually_shards_params():
    """Guard against the FSDP parity case degenerating to pure DP: the
    plan shards the embed axis across the 4 data ranks."""
    lm = LM(get_arch("internlm2-1.8b", smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    plan = make_plan(Mesh(("data", "model"), (4, 1)), fsdp=True)
    p_sh = plan.shardings(lm.param_axes(),
                          {k: tuple(v.shape) for k, v in params.items()})
    sharded = [k for k, s in p_sh.items() if any(p is not None
                                                 for p in s.spec)]
    assert sharded, "fsdp plan produced no sharded params"
    assert "blocks.0.attn.wq" in sharded and "embed" in sharded


def test_sharded_step_matches_plain_step_single_device():
    """On a 1-rank mesh with grad_slices=1 the sharded step reduces to
    the plain GETA step."""
    lm = LM(get_arch("internlm2-1.8b", smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    qparams = lm.init_qparams(params, bits_init=16.0)
    b = T.batch_for(lm.cfg, 0, 0, 4, 16)
    _, qasso = T.build_geta(lm, R.COMP, lr=3e-3, base_optimizer="momentum")
    p_ref, q_ref, _, m_ref = T.make_geta_train_step(lm, qasso)(
        params, qparams, qasso.init(params, qparams), b)
    _, qasso2 = T.build_geta(lm, R.COMP, lr=3e-3, base_optimizer="momentum")
    step, _ = T.make_sharded_geta_train_step(
        lm, qasso2, make_subset_mesh(1), params, qparams, grad_slices=1)
    p_s, q_s, _, m_s = step(params, qparams, qasso2.init(params, qparams), b)
    np.testing.assert_allclose(float(m_ref["loss"]), float(m_s["loss"]),
                               rtol=0, atol=1e-6)
    for k in p_ref:
        np.testing.assert_allclose(p_ref[k].numpy(), p_s[k].numpy(), rtol=0,
                                   atol=1e-6)
    for k in q_ref:
        for f in ("d", "q_m", "t"):
            np.testing.assert_allclose(float(getattr(q_ref[k], f)),
                                       float(getattr(q_s[k], f)), rtol=0,
                                       atol=1e-6)


def test_ordered_grads_reject_mismatched_slices():
    """grad_slices must equal the data degree on a multi-rank mesh; on a
    1-rank mesh any slice count is a sequential split."""
    lm = LM(get_arch("internlm2-1.8b", smoke=True))
    with pytest.raises(ValueError, match="one slice per device"):
        T.make_ordered_loss_grads(lm, Mesh(("data", "model"), (4, 1)), None,
                                  grad_slices=2)
    assert callable(T.make_ordered_loss_grads(lm, make_subset_mesh(1), None,
                                              grad_slices=2))


# ---------------------------------------- the JAX package's 1-device step
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _ulp(params, seed):
    rng = np.random.default_rng(seed)
    return {k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, -np.inf,
                                        np.inf).astype(v.dtype))
            for k, v in params.items()}


def _jax_run():
    """The JAX package's 1-device sharded step (grad_slices=4): its jitted
    step, the states before each of 10 steps and after the last, each
    step's loss and batch (made once per module)."""
    if "run" in _JAX:
        return _JAX["run"]
    jlm = JLM(jget_arch("internlm2-1.8b", smoke=True))
    params, _ = jlm.init(jax.random.PRNGKey(0))
    qparams = jlm.init_qparams(params, bits_init=16.0)
    _, jqasso = JT.build_geta(jlm, JComp(**vars(R.COMP)), lr=3e-3,
                              base_optimizer="momentum")
    jstep, _ = JT.make_sharded_geta_train_step(
        jlm, jqasso, jsubset_mesh(1), params, qparams, grad_slices=4)
    state = _np((params, qparams, jqasso.init(params, qparams)))
    states, losses, batches = [state], [], []
    for i in range(R.STEPS):
        b = np.asarray(jbatch_for(jlm.cfg, 0, i, 4, 16)["tokens"])
        out = _np(jstep(*state, {"tokens": b}))
        state = out[:3]
        states.append(state)
        losses.append(float(out[3]["loss"]))
        batches.append(b)
    _JAX["run"] = jstep, states, losses, batches
    return _JAX["run"]


def test_one_rank_step_matches_jax_step_by_step():
    jstep, states, losses, batches = _jax_run()
    lm = LM(get_arch("internlm2-1.8b", smoke=True))
    _, qasso = T.build_geta(lm, R.COMP, lr=3e-3, base_optimizer="momentum")
    sites = [s.name for s in qasso.weight_sites]
    stages = set()
    for i, b in enumerate(batches):
        (wp, wq, ws), (p0, q0, s0) = states[i + 1], states[i]
        params, qparams, qstate = geta_state_from_numpy(p0, q0, s0)
        step, _ = T.make_sharded_geta_train_step(
            lm, qasso, make_subset_mesh(1), params, qparams, grad_slices=4)
        p, q, s, met = step(params, qparams, qstate,
                            {"tokens": torch.from_numpy(b.astype(np.int64))})
        wits = [_np(jstep(_ulp(p0, 10 * i + k), q0, s0, {"tokens": b}))
                for k in range(3)]
        stages.add(int(met["stage"]))
        assert abs(float(met["loss"]) - losses[i]) <= 1e-5 * abs(losses[i])
        for k in ws.redundant:
            assert np.array_equal(s.redundant[k].numpy(), ws.redundant[k])
            assert np.array_equal(s.keep_mask[k].numpy(), ws.keep_mask[k])
        # gamma within 1e-4 relative, or, where the reference's own
        # gamma parts further under one ulp on the weights (Eq 16 divides
        # by cos_g: at step 6 of this run the witnesses part by 3.4e-2),
        # within the witnesses' gap
        scale = np.maximum(np.abs(ws.gamma), 1e-30)
        g_rel = np.abs(s.gamma.numpy() - ws.gamma) / scale
        w_rel = max(float(np.max(np.abs(w[2].gamma - ws.gamma) / scale))
                    for w in wits)
        assert float(np.max(g_rel)) <= max(1e-4, w_rel), (i, g_rel)
        for k in wq:
            for f in ("q_m", "t"):
                np.testing.assert_allclose(float(getattr(q[k], f)),
                                           float(getattr(wq[k], f)),
                                           rtol=1e-4, err_msg=(i, k, f))
            rel = lambda x: abs(float(x) - float(wq[k].d)) / float(wq[k].d)
            held = rel(q[k].d) <= T.STEP_TOLERANCES["d"]
            if float(q0[k].q_m) ** float(q0[k].t) / float(q0[k].d) >= 2 ** 22:
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
    assert stages == {0, 1, 2, 3}

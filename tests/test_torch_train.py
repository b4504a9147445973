"""The port's training slice against the JAX package's: the LM loss and
its gradients, the remat path, the train loop and its CLI.

The JAX package's smoke params, quantizers and batch cross as numpy
(`repro_torch.convert`). Tolerances: the loss within 1e-5 relative, every
gradient within 1e-4 of its own max|g| (f32 sums in another order than
XLA's through two layers, the head and the STE), except the activation
quantizers' (d, q_m, t) at 1e-2: activations differ from XLA's in the last
ulp, and an ulp can flip round(v) at a tie, which moves Eq 4's sum by a
whole |g| of that element. Remat (`cfg.remat`) must not change a bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.models.transformer import LM as JLM
from repro_torch.configs import CompressionConfig, get_arch
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core.quant import bit_width
from repro_torch.data.synthetic import batch_for, lm_batch
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM

ARCH = "internlm2-1.8b"
# every stage in 5 steps: warm-up 1, projection 1 x 1, pruning 2 x 1,
# cool-down 1
COMP5 = CompressionConfig(target_sparsity=0.3, warmup_steps=1,
                          projection_periods=1, projection_steps=1,
                          pruning_periods=2, pruning_steps=1,
                          cooldown_steps=1)


def jax_state(act_quant, seed=0, batch=2, seq=12):
    jlm = JLM(j_get_arch(ARCH, smoke=True))
    jp, _ = jlm.init(jax.random.PRNGKey(seed))
    jq = jlm.init_qparams(jp, bits_init=8.0, act_quant=act_quant)
    jb = j_lm_batch(seed, 0, batch, seq, jlm.cfg.vocab)
    return jlm, jp, jq, jb


def crossed(jp, jq, jb):
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    return (params_from_numpy(np_p),
            qparams_from_numpy({k: tuple(np.asarray(x) for x in
                                         (v.d, v.q_m, v.t))
                                for k, v in jq.items()}),
            {"tokens": torch.from_numpy(np.asarray(jb["tokens"])
                                        .astype(np.int64))})


def _assert_grads_close(got: dict, want: dict):
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].to(torch.float32).numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = 1e-2 if k.endswith(".aq") else 1e-4
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("act_quant", [False, True])
def test_loss_and_grads_match_jax(act_quant):
    jlm, jp, jq, jb = jax_state(act_quant)
    jloss, (jgx, jgq) = jax.value_and_grad(jlm.loss, argnums=(0, 1))(
        jp, jq, jb)
    tp, tq, tb = crossed(jp, jq, jb)
    lm = LM(get_arch(ARCH, smoke=True))
    loss, gx, gq = T.loss_and_grads(lm, tp, tq, tb)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    _assert_grads_close(gx, jgx)
    for f in ("d", "q_m", "t"):
        _assert_grads_close({k: getattr(v, f) for k, v in gq.items()},
                            {k: getattr(v, f) for k, v in jgq.items()})


def test_remat_changes_no_number():
    jlm, jp, jq, jb = jax_state(True)
    tp, tq, tb = crossed(jp, jq, jb)
    cfg = get_arch(ARCH, smoke=True)
    outs = [T.loss_and_grads(LM(dataclasses.replace(cfg, remat=r)), tp, tq,
                             tb) for r in (False, True)]
    (l0, gx0, gq0), (l1, gx1, gq1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(gx0[k], gx1[k]) for k in gx0)
    assert all(torch.equal(a, b) for k in gq0
               for a, b in zip(vars(gq0[k]).values(), vars(gq1[k]).values()))


def test_act_sites_and_qparams_match_jax():
    jlm, jp, jq, _ = jax_state(True)
    lm = LM(get_arch(ARCH, smoke=True))
    assert lm.act_site_names() == jlm.act_site_names()
    tp, tq, _ = crossed(jp, jq, {"tokens": np.zeros((1, 2), np.int32)})
    got = lm.init_qparams(tp, bits_init=8.0, act_quant=True)
    assert list(got) == list(jq)
    for k, v in jq.items():
        for f in ("d", "q_m", "t"):
            assert getattr(got[k], f).numpy().tobytes() == \
                np.asarray(getattr(v, f)).tobytes(), (k, f)


def test_five_step_run_walks_every_stage():
    hist = []
    state, qadg, qasso, losses = T.train_loop(
        ARCH, True, 5, 2, 16, comp=COMP5, verbose=False, device="cpu",
        history=hist)
    assert [h["stage"] for h in hist] == [0, 1, 2, 2, 3]
    assert all(np.isfinite(losses))
    space, keep = qasso.space, state["qstate"].keep_mask
    assert sum(int(torch.sum(v < 0.5)) for v in keep.values()) == \
        qasso.k_units
    assert float(space.sparsity(keep)) == pytest.approx(
        qasso.k_units / qasso.total_units)
    b_l, b_u = qasso.cfg.bit_lower, qasso.cfg.bit_upper_final
    for s in qadg.sites:
        q = state["qparams"][s.name]
        assert b_l - 1e-3 <= float(bit_width(q.d, q.q_m, q.t)) <= b_u + 1e-3
    pruned = qasso._keep_elem_tree(state["params"], keep)
    for k, p in state["params"].items():
        zero = (pruned[k] < 0.5).expand(p.shape)
        assert torch.count_nonzero(p[zero]) == 0, k


def test_train_step_is_reproducible():
    """Two runs of step 0 from one state give the same bits."""
    outs = []
    for _ in range(2):
        lm, p, q, _, qasso, s = T.init_geta(ARCH, True, comp=COMP5,
                                            device="cpu")
        b = batch_for(lm.cfg, 0, 0, 2, 16)
        outs.append(T.make_geta_train_step(lm, qasso)(p, q, s, b))
    (p0, q0, s0, m0), (p1, q1, s1, m1) = outs
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(getattr(q0[k], f), getattr(q1[k], f))
               for k in q0 for f in ("d", "q_m", "t"))
    assert torch.equal(m0["loss"], m1["loss"])


def test_microbatches_average_the_batch():
    lm, p, q, _, qasso, s = T.init_geta(ARCH, True, comp=COMP5, device="cpu")
    b = batch_for(lm.cfg, 0, 0, 4, 16)
    lg = lambda mb: T.loss_and_grads(lm, p, q, mb)
    loss, gx, _ = T._accumulate_grads(lg, b, 2)
    halves = [lg({"tokens": b["tokens"][i:i + 2]}) for i in (0, 2)]
    assert float(loss) == pytest.approx(
        (float(halves[0][0]) + float(halves[1][0])) / 2, rel=1e-6)
    assert gx["embed"].dtype == torch.float32


def test_lm_batch_is_a_function_of_seed_and_step():
    a = lm_batch(3, 7, 2, 32, 100)["tokens"]
    assert torch.equal(a, lm_batch(3, 7, 2, 32, 100)["tokens"])
    assert not torch.equal(a, lm_batch(3, 8, 2, 32, 100)["tokens"])
    assert a.shape == (2, 32) and int(a.min()) >= 0 and int(a.max()) < 100
    # the process: 70% of tokens are 31 * base[t-1] + 7 mod V, so about
    # 0.7 * 0.3 of them follow that rule from the previous token
    hit = (a[:, 1:] == (a[:, :-1] * 31 + 7) % 100).float().mean()
    assert 0.1 < float(hit) < 0.45


def test_cli_runs_on_cpu_and_needs_cuda_by_default(capsys, tmp_path):
    T.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu"])
    assert "trained 2 steps" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    # --ckpt-dir runs the checkpointed loop: steps // 4 = 1, a save a step
    T.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "trained 2 steps" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1", "step_2"]
    # --devices N trains on N ranks (--fsdp shards over them); --fsdp
    # alone has no ranks to shard over
    T.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--devices", "2", "--fsdp"])
    assert "trained 2 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        T.main(["--arch", ARCH, "--steps", "1", "--device", "cpu",
                "--fsdp"])


def test_act_quant_step_on_devices_reports_the_activation_sites():
    """`step_on_devices` takes the CompressionConfig: with `act_quant` the
    step quantizes the activation sites (and moves their quantizers), and
    `step_differences` reports those sites apart from the weight sites. On
    one device it repeats bit for bit (the card test runs it card vs
    CPU)."""
    comp = dataclasses.replace(T.JOINT_STEP0, act_quant=True)
    a = T.step_on_devices(ARCH, ["cpu"], comp=comp)["cpu"]
    b = T.step_on_devices(ARCH, ["cpu"], comp=comp)["cpu"]
    act = [k for k in a[1] if k.endswith(".aq")]
    assert act and len(act) < len(a[1])
    _, _, q0, _, _, _ = T.init_geta(ARCH, True, comp=comp, device="cpu")
    assert any(not torch.equal(getattr(a[1][k], f), getattr(q0[k], f))
               for k in act for f in ("d", "q_m", "t"))
    diff = T.step_differences(a, b)
    assert diff.pop("masks")
    assert set(diff) == {*T.STEP_TOLERANCES, "act_d", "act_q_m", "act_t"}
    assert all(v == 0.0 for v in diff.values())
    plain = T.step_differences(*[T.step_on_devices(ARCH, ["cpu"])["cpu"]
                                 for _ in range(2)])
    assert set(plain) == {*T.STEP_TOLERANCES, "masks"}


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::gemm_tc<2, __nv_bfloat16, 0, 256, false,"
     " true>(CUtensorMap_st, CUtensorMap_st)", "gemm_tc<2"),
    ("void (anonymous namespace)::fq_bwd<__nv_bfloat16, float, true>("
     "__nv_bfloat16 const*, float const*)", "fq_bwd<__nv_bfloat16"),
    ("void (anonymous namespace)::fq_bwd_reduce(float const*, int, float*)",
     "fq_bwd_reduce"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1},"
     " std::array<char*, 2ul> >(int)", "bfloat16_copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >("
     "at::native::ReduceOp<float>)", "reduce_kernel<512")])
def test_profile_train_kernel_families(name, want):
    """The train profile's kernel families: the first template argument,
    the bare name of a kernel that is no template, every bf16 cast as
    one."""
    from repro_torch.launch.profile_train import family
    assert family(name) == want


def test_profile_train_summarizes_a_saved_profile(tmp_path, capsys):
    """`--families` reads a profile written by `--out` (on the card, by any
    checkout) and prints its families on a host with no device."""
    import json
    from repro_torch.launch import profile_train as PT
    kernels = [{"name": "void (anonymous namespace)::fq_bwd_reduce(float "
                "const*, int, float*)", "ms": 0.5, "calls": 2},
               {"name": "void (anonymous namespace)::fq_bwd<float, float, "
                "true>(float const*)", "ms": 1.0, "calls": 2},
               {"name": "void (anonymous namespace)::fq_bwd<float, float, "
                "false>(float const*)", "ms": 0.25, "calls": 1},
               {"name": "void at::native::reduce_kernel<512, 1>()",
                "ms": 9.0, "calls": 4}]
    path = tmp_path / "profile.json"
    path.write_text(json.dumps({"device": "card", "rows": [
        {"step": 0, "stage": 2, "wall_ms": 10.0, "device_ms": 8.0,
         "idle_share": 0.2, "kernels": kernels}]}))
    PT.main(["--families", str(path)])
    out = capsys.readouterr().out.splitlines()
    assert out == ["step 0 (stage 2): wall 10.0 ms, device busy 8.0 ms, "
                   "idle share 0.200",
                   "step 0 family fq_bwd<float: 1.250 ms, 3 calls",
                   "step 0 family fq_bwd_reduce: 0.500 ms, 2 calls"]

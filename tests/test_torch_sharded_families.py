"""Deterministic data-parallel and FSDP GETA training of every non-dense
family (grok-1, llama4, jamba, rwkv6, musicgen's codebooks, internvl2's
vision embeds) on CPU ranks over gloo, against the JAX package's step.

One `RankPool` of 4 ranks serves the module; k-rank cases run on blocks
of k ranks side by side, and the 1-rank references one a rank
(`torch_ranks.on_blocks`). Every case starts from the JAX package's
PRNGKey(0) params, its 16-bit quantizers and its 4 x 16 `batch_for`
batch (codebook frames (4, 16, C); internvl2's patch embeds with their
text), handed over as numpy, and takes one GETA step under
`train.JOINT_STEP0` (the partition computed and the keep mask frozen)
with the arch's base optimizer. The JAX loss and gradients run here while
the ranks train (`trained`).

- The k-rank DP and FSDP steps (k = 2, 4) are bitwise the 1-rank step
  with `grad_slices=k`, on every rank: loss, params, quantizers, masks.
- The 1-rank `grad_slices=k` loss and gradients (the slices' sum in
  order) lie within the tolerances `tests/test_torch_moe.py`,
  `test_torch_recurrent_train.py` and `test_torch_codebook.py` state
  against the JAX package's on the whole batch: loss 1e-5 relative,
  each gradient 1e-4 of its largest magnitude, each quantizer's (d, q_m,
  t) gradients 1e-4 relative, or within 4x the reference's own witness
  where that moves further (the JAX gradient after one ulp on every
  weight, as `check_geta_step` holds a sensitive d): a d gradient sums
  terms that cancel (jamba's in_proj_z site: the four sequences' terms
  of -0.163, 0.053, 0.069 and 0.039 sum to -3.6e-4), and the port's
  own unsliced gradient on this batch parts from the reference's by
  1.1e-4 relative there. llama4's router gradient (top_k 1: the
  renormalised gate is p / p) is rounding noise in both packages and is
  held as noise (1e-6 of the largest gradient).
- An MoE's capacity is per sequence (one group per sequence in
  `moe_apply`), so a slice of whole sequences routes as the batch does.
- `train_loop(mesh=, fsdp=True)` takes every family.
"""
import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro.configs import get_arch as jget_arch
from repro.data.synthetic import batch_for as jbatch_for
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import layers as Lyr
from repro_torch.launch.mesh import RankPool

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
         "rwkv6-3b", "musicgen-large", "internvl2-26b"]
B, S = 4, 16
STEPS = [(n, arch, fsdp, k) for arch in ARCHS for k in (2, 4)
         for n, fsdp in ((1, False), (k, False), (k, True))]
LOOPS = [(2, arch, True) for arch in ARCHS]
_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q_np(jq):
    return {k: tuple(np.asarray(t) for t in (v.d, v.q_m, v.t))
            for k, v in jq.items()}


def _reference(arch):
    """The JAX package's PRNGKey(0) params, 16-bit quantizers and batch,
    as numpy."""
    if ("ref", arch) not in _JAX:
        jlm = JLM(jget_arch(arch, smoke=True))
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        jq = jlm.init_qparams(jp, bits_init=16.0)
        jb = jbatch_for(jlm.cfg, 0, 0, B, S)
        batch = {k: np.asarray(v) for k, v in jb.items()}
        batch["tokens"] = batch["tokens"].astype(np.int64)
        _JAX[("ref", arch)] = (jlm, jp, jq, jb, {
            k: np.asarray(v) for k, v in jp.items()}, _q_np(jq), batch)
    return _JAX[("ref", arch)]


def jax_grads(arch):
    """The JAX package's loss and gradients on the whole batch, and its
    quantizer gradients' witness: how far each moves when every weight
    moves by one ulp (one draw of directions; the compiled pass again)."""
    if ("grads", arch) not in _JAX:
        jlm, jp, jq, jb = _reference(arch)[:4]
        fn = jax.jit(jax.value_and_grad(jlm.loss, argnums=(0, 1)))
        jl, (jgx, jgq) = fn(jp, jq, jb)
        rng = np.random.default_rng(0)
        moved = {k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5,
                                             np.inf, -np.inf).astype(v.dtype))
                 for k, v in _reference(arch)[4].items()}
        _, (_, wgq) = fn(moved, jq, jb)
        gq, wq = _q_np(jgq), _q_np(wgq)
        _JAX[("grads", arch)] = (
            float(jl), {k: np.asarray(v) for k, v in jgx.items()},
            {k: tuple(float(t) for t in q) for k, q in gq.items()},
            {k: tuple(abs(float(a) - float(b)) for a, b in zip(q, wq[k]))
             for k, q in gq.items()})
    return _JAX[("grads", arch)]


@pytest.fixture(scope="module")
def trained():
    """({step case: per-rank result}, {loop case: per-rank result})."""
    refs = {a: _reference(a) for a in ARCHS}
    with RankPool(4, "cpu", verbose=False) as pool:
        pool.submit(R.train_families, {a: r[4] for a, r in refs.items()},
                    {a: r[5] for a, r in refs.items()},
                    {a: r[6] for a, r in refs.items()}, STEPS)
        for arch in ARCHS:
            jax_grads(arch)
        steps = pool.collect()
        loops = pool.run(R.loop_families, LOOPS)
    return ({c: [r.get(c) for r in steps] for c in STEPS},
            {c: [r.get(c) for r in loops] for c in LOOPS})


def _done(results, n):
    done = [r for r in results if r is not None]
    assert len(done) == n
    return done


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_k_rank_step_is_bitwise_the_one_rank_step(trained, arch, k, fsdp):
    (one,) = _done(trained[0][(1, arch, False, k)], 1)
    for got in _done(trained[0][(k, arch, fsdp, k)], k):
        assert got[0] == one[0]                                   # loss
        for key, want in one[1].items():
            np.testing.assert_array_equal(got[1][key], want, err_msg=key)
        assert got[2] == one[2]                                   # qparams
        for part in ("redundant", "keep_mask"):
            for fam, want in one[3][part].items():
                np.testing.assert_array_equal(got[3][part][fam], want)
        assert got[3]["step"] == one[3]["step"]
        # FSDP shards the embed axis of the params; DP keeps them whole
        assert "embed" in got[4] if fsdp else got[4] == []


def _router_noise(arch, name):
    moe = get_arch(arch, smoke=True).moe
    return moe is not None and moe.top_k == 1 and ".router" in name


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_sliced_grads_match_jax(trained, arch, k):
    (one,) = _done(trained[0][(1, arch, False, k)], 1)
    loss, gx, gq = one[5]
    jl, jgx, jgq, witness = jax_grads(arch)
    assert loss == pytest.approx(jl, rel=1e-5)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    top = max(float(np.abs(v).max()) for v in jgx.values())
    for key, want in jgx.items():
        if _router_noise(arch, key):
            assert max(np.abs(gx[key]).max(), np.abs(want).max()) \
                <= 1e-6 * top, key
            continue
        np.testing.assert_allclose(gx[key], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)
    for key, want in jgq.items():
        for f, g, w, wit in zip(("d", "q_m", "t"), gq[key], want,
                                witness[key]):
            if _router_noise(arch, key):
                assert abs(g) <= 1e-6 and abs(w) <= 1e-6, (key, f)
                continue
            assert abs(g - w) <= max(1e-4 * abs(w), 4 * wit, 1e-12), \
                (key, f, g, w, wit)


@pytest.mark.parametrize("arch", ["grok-1-314b", "jamba-1.5-large-398b"])
def test_moe_capacity_is_per_sequence(arch):
    """moe_apply on the batch equals moe_apply on each half of it bit for
    bit (at the training capacity, where tokens drop): a data-parallel
    slice of whole sequences routes as the batch does."""
    lm_cfg = get_arch(arch, smoke=True)
    params = convert.params_from_numpy(_reference(arch)[4])
    pre = "blocks.1.moe" if lm_cfg.mamba else "blocks.0.moe"
    lp = {k: v[0] for k, v in params.items() if k.startswith(pre)}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, lm_cfg.d_model)).astype(np.float32))
    whole = Lyr.moe_apply(lp, None, lm_cfg, x, prefix=pre)
    halves = torch.cat([Lyr.moe_apply(lp, None, lm_cfg, x[i:i + 2],
                                      prefix=pre) for i in (0, 2)])
    assert torch.equal(whole, halves)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_trains_every_family_sharded(trained, arch):
    """`train_loop(mesh=, fsdp=True)` on 2 ranks: one step, the same loss
    on both ranks, finite params."""
    res = _done(trained[1][(2, arch, True)], 2)
    assert res[0][0] == res[1][0] and np.isfinite(res[0][0])
    assert all(finite for _, finite in res)

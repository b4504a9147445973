"""The port's training GEMM ops and epilogues against the JAX package's.

Seeded numpy inputs go through `repro.kernels.ops`' `matmul_op`,
`masked_matmul_op`, `fq_matmul_op` and `fq_masked_matmul_op` (the xla-ref
oracle; `jax.grad` for their custom VJPs) and through the port's autograd
Functions on CPU tensors (the GEMM kernels' plain versions), at
M in {4, 8, 33, 64} and an odd K. The `none`, `col_mask` and
`fq_col_mask` epilogues also go through `repro.kernels.gemm_core.gemm` in
Pallas interpret mode. Tolerance rtol/atol 1e-4 (relative to max|y| for
the gradients): f32 sums in another order than XLA's; the masked columns
of a masked product must be exactly zero. The CUDA kernels are held to
the plain versions in `test_torch_gpu.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels import gemm_core as JG
from repro.kernels import ops as JOPS
from repro.models import layers as JL
from repro_torch.kernels import fake_quant as TFQ
from repro_torch.kernels import gemm_core as TG
from repro_torch.kernels import ops as TOPS
from repro_torch.models import layers as TL

K, N = 45, 32          # odd K
TOL = dict(rtol=1e-4, atol=1e-4)


def _data(M, seed=0, t=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    mask = (np.arange(N) % 4 > 0).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    qm = np.float32(np.abs(w).max() * 0.8)          # some weights clip
    qp = JQ.init_quant_params(q_m=qm, bits=4.0, t=t)
    sc = tuple(np.asarray(v, np.float32) for v in (qp.d, qp.q_m, qp.t))
    return x, w, mask, g, sc


def sc_tensors(sc):
    return [torch.from_numpy(v.copy()) for v in sc]


def _close(got, want, scale=None):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    atol = TOL["atol"] * (scale if scale is not None
                          else max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol)


OPS = ["matmul", "masked", "fq", "fq_masked"]


def _jax_op(name, sc, mask):
    b = dict(backend="xla-ref")
    return {"matmul": lambda x, w, *s: JOPS.matmul_op(x, w, **b),
            "masked": lambda x, w, *s: JOPS.masked_matmul_op(x, w, mask, **b),
            "fq": lambda x, w, *s: JOPS.fq_matmul_op(x, w, *s, **b),
            "fq_masked": lambda x, w, *s: JOPS.fq_masked_matmul_op(
                x, w, mask, *s, **b)}[name]


def _torch_op(name, mask):
    return {"matmul": lambda x, w, *s: TOPS.matmul_op(x, w),
            "masked": lambda x, w, *s: TOPS.masked_matmul_op(x, w, mask),
            "fq": lambda x, w, *s: TOPS.fq_matmul_op(x, w, *s),
            "fq_masked": lambda x, w, *s: TOPS.fq_masked_matmul_op(
                x, w, mask, *s)}[name]


@pytest.mark.parametrize("t", [1.0, 0.85])
@pytest.mark.parametrize("M", [4, 8, 33, 64])
@pytest.mark.parametrize("op", OPS)
def test_op_values_and_grads_match_jax(op, M, t):
    x, w, mask, g, sc = _data(M, seed=M, t=t)
    quant = op.startswith("fq")
    jop = _jax_op(op, tuple(map(jnp.asarray, sc)), jnp.asarray(mask))
    nargs = 5 if quant else 2
    jargs = (jnp.asarray(x), jnp.asarray(w)) + tuple(map(jnp.asarray, sc))
    jargs = jargs[:nargs]
    y, vjp = jax.vjp(jop, *jargs)
    want = vjp(jnp.asarray(g))

    targs = [torch.from_numpy(a.copy()).requires_grad_(True)
             for a in (x, w, *sc)][:nargs]
    tm = torch.from_numpy(mask).requires_grad_(True)
    yt = _torch_op(op, tm)(*targs)
    inputs = targs + ([tm] if "masked" in op else [])
    got = torch.autograd.grad(yt, inputs, torch.from_numpy(g))
    _close(yt, y)
    ymax = float(np.abs(np.asarray(y)).max())
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)
    for a, b in zip(got[2:nargs], want[2:nargs]):       # dd, dq_m, dt
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                   atol=1e-4 * ymax)
    if "masked" in op:
        assert torch.count_nonzero(got[-1]) == 0         # mask cotangent 0
        zero = np.nonzero(mask < 0.5)[0]
        assert np.all(yt.detach().numpy()[:, zero] == 0.0)


def _epi(name, sc, mask):
    j = {"none": (), "col_mask": (JG.col_mask(mask),),
         "fq_col_mask": JG.fq_mask_ops(*sc, mask)}[name]
    tm = torch.from_numpy(mask)
    t = {"none": TG.none(), "col_mask": TG.col_mask(tm),
         "fq_col_mask": TG.fq_col_mask(*map(torch.tensor, sc), tm)}[name]
    return j, t


@pytest.mark.parametrize("M", [4, 8, 33, 64])
@pytest.mark.parametrize("epi", ["none", "col_mask", "fq_col_mask"])
def test_plain_epilogues_match_jax_pallas_and_xla_ref(epi, M):
    x, w, mask, _, sc = _data(M, seed=M + 1, t=0.85)
    jops, tepi = _epi(epi, sc, mask)
    got = TG.gemm(torch.from_numpy(x), torch.from_numpy(w), tepi).numpy()
    for backend in ("pallas-interpret", "xla-ref"):
        want = np.asarray(JG.gemm(jnp.asarray(x), jnp.asarray(w), jops,
                                  backend=backend))
        np.testing.assert_allclose(got, want, err_msg=backend, **TOL)


def test_plain_bf16_weights_and_f32_out():
    """The backward's shapes: a bf16 operand pair written in f32
    (`dwq = x.T @ g`) against the xla-ref oracle at out_dtype f32."""
    x, w, mask, g, sc = _data(33, seed=7)
    xb, gb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    want = JG.gemm(xb.T, gb, (), backend="xla-ref", out_dtype=jnp.float32)
    got = TG.gemm(torch.from_numpy(x).to(torch.bfloat16).T,
                  torch.from_numpy(g).to(torch.bfloat16), TG.none(),
                  out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_proj_routes_colmask_like_jax():
    """dense_proj picks fq_masked_matmul for a `.colmask` riding the
    param dict, masked_matmul without a site, and a `mask=` argument
    wins, as in the JAX package."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.5).astype(np.float32)
    mask = (np.arange(24) % 2).astype(np.float32)
    jq = JQ.init_quant_params(jnp.asarray(w), bits=8.0)
    tq = {"w.wq": TL.QuantParams(*(torch.tensor(np.asarray(v))
                                   for v in (jq.d, jq.q_m, jq.t)))}
    jqp = {"w.wq": jq}
    xt, wt, mt = map(torch.from_numpy, (x, w, mask))
    cases = [({"w": w, "w.colmask": mask}, jqp, {}),
             ({"w": w, "w.colmask": mask}, None, {}),
             ({"w": w}, jqp, {"mask": mask})]
    for jp, jq_, kw in cases:
        want = JL.dense_proj(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in jp.items()},
                             jq_, "w", **{k: jnp.asarray(v)
                                          for k, v in kw.items()})
        got = TL.dense_proj(xt, {k: torch.from_numpy(v)
                                 for k, v in jp.items()},
                            tq if jq_ else None, "w",
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(got, want)


def test_gemm_rejects_a_mask_of_the_wrong_width():
    x, w, mask, _, _ = _data(4)
    with pytest.raises(RuntimeError):
        TG.gemm(torch.from_numpy(x), torch.from_numpy(w),
                TG.col_mask(torch.ones(N + 1)))


@pytest.mark.parametrize("t", [1.0, 0.85])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("op", ["fq", "fq_masked"])
def test_fq_weight_grads_are_the_f32_dwq_cast_route(op, wdtype, t):
    """dwq written by the GEMM in w's dtype gives the weight's gradients
    of the route that wrote it in f32 and cast it with `.to(w.dtype)`, bit
    for bit (one rounding of the same f32 sums)."""
    x, w, mask, g, sc = _data(33, seed=11, t=t)
    xt, wt, gt = (torch.from_numpy(a).to(wdtype) for a in (x, w, g))
    tm = torch.from_numpy(mask)
    s = [torch.from_numpy(v.copy()).requires_grad_(True) for v in sc]
    wg = wt.clone().requires_grad_(True)
    yt = _torch_op(op, tm)(xt, wg, *s)
    got = torch.autograd.grad(yt, [wg, *s], gt)
    gm = TOPS._mask_cols(gt, tm) if op == "fq_masked" else gt
    dwq = TG.gemm(xt.T, gm, TG.none(), out_dtype=torch.float32).to(wdtype)
    want = TFQ.fake_quant_bwd(wt, *sc_tensors(sc), dwq)
    assert got[0].dtype == wdtype
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(b.shape), b)

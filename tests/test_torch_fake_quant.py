"""The port's fake-quant (forward, and backward by the STE of Eqs 4-6)
against the JAX package's.

Same seeded numpy inputs through `repro.core.quant.fake_quant` (its
`jax.vjp`), the Pallas kernels `fake_quant_fwd_pallas` /
`fake_quant_bwd_pallas` in interpret mode, and the port's
`core.quant.fake_quant` Function on CPU tensors (the kernels' plain
versions in `kernels.ref`). Tolerances:

- the forward is bit-equal to `repro.core.quant.fake_quant` at t = 1 and
  t != 1 on these inputs (torch's and XLA's CPU pow differ in the last ulp
  for t != 1, which the rounding to multiples of d absorbs here); against
  the Pallas kernel, whose clip^t is exp(t * log a), `tests/test_kernels.py`'s
  own tolerances (1e-5 f32, 2e-2 bf16);
- dx is bit-equal (a select of g);
- the scalar sums (dd, dq_m, dt) run in another order than XLA's: rtol
  1e-4 plus 1e-6 of the sum of the terms' magnitudes (1e-3 against the
  Pallas kernel's per-tile partials, as `tests/test_kernels.py`).
The CUDA kernels are held to the plain versions in `test_torch_gpu.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels import fake_quant as JFQ
from repro.kernels import ops as JOPS
from repro_torch.core import quant as TQ
from repro_torch.kernels import fake_quant as TFQ
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TR

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    x.reshape(-1)[:3] = 0.0                     # sign 0 and |x| = 0
    g = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    xj, gj = jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd)
    xt = torch.from_numpy(x).to(td)
    gt = torch.from_numpy(g).to(td)
    return xj, gj, xt, gt


def _scalars(t):
    return (np.float32(0.07), np.float32(1.1), np.float32(t))


def _to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t_np(a):
    return a.detach().to(torch.float32).numpy()


def _scalar_tol(x, g, scalars):
    """1e-6 of sum |g * term| over the three Eq 4-6 terms (f64)."""
    x64 = np.asarray(jnp.asarray(x, jnp.float32), np.float64)
    g64 = np.abs(np.asarray(jnp.asarray(g, jnp.float32), np.float64))
    d, qm, t = (float(v) for v in scalars)
    a = np.abs(x64)
    base = np.where(a <= qm, np.maximum(a, 1e-12), qm)
    terms = [np.ones_like(a) * d, np.where(a <= qm, 0.0, t * qm ** (t - 1)),
             np.abs(base ** t * np.log(base))]
    return [1e-6 * float(np.sum(g64 * tm)) for tm in terms]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t", [1.0, 0.85])
def test_forward_and_grads_match_jax_vjp(t, dtype):
    xj, gj, xt, gt = _inputs((37, 53), 1, dtype)
    sc = _scalars(t)
    y, vjp = jax.vjp(JQ.fake_quant, xj, *map(jnp.asarray, sc))
    want = vjp(gj)
    ts = [torch.tensor(v).requires_grad_(True) for v in sc]
    xg = xt.clone().requires_grad_(True)
    yt = TQ.fake_quant(xg, *ts)
    got = torch.autograd.grad(yt, [xg, *ts], gt)
    assert yt.dtype == xt.dtype and got[0].dtype == xt.dtype
    np.testing.assert_array_equal(_t_np(yt), _to_np(y))
    np.testing.assert_array_equal(_t_np(got[0]), _to_np(want[0]))
    for a, b, tol in zip(got[1:], want[1:], _scalar_tol(xj, gj, sc)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=tol)


@pytest.mark.parametrize("shape", [(8, 128), (57, 200), (1, 384), (130, 129)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_forward_matches_pallas_kernel(shape, dtype):
    xj, _, xt, _ = _inputs(shape, 0, dtype)
    d, qm, t = np.float32(0.05), np.float32(1.4), np.float32(0.85)
    want = JFQ.fake_quant_fwd_pallas(xj, d, qm, t, interpret=True)
    got = TR.fake_quant_fwd_ref(xt, *map(torch.tensor, (d, qm, t)))
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(_t_np(got), _to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(64, 256), (33, 140)])
@pytest.mark.parametrize("t", [1.0, 0.85])
def test_plain_backward_matches_pallas_kernel(shape, t):
    xj, gj, xt, gt = _inputs(shape, 2, "f32")
    sc = (np.float32(0.08), np.float32(1.1), np.float32(t))
    dx, dd, dqm, dt = JFQ.fake_quant_bwd_pallas(xj, *sc, gj, interpret=True)
    got = TR.fake_quant_bwd_ref(xt, *map(torch.tensor, sc), gt)
    np.testing.assert_allclose(_t_np(got[0]), np.asarray(dx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(dd), rtol=1e-3)
    np.testing.assert_allclose(float(got[2]), float(dqm), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(dt), rtol=1e-3)


def test_fake_quant_op_is_the_same_function_as_jax_op():
    """`fake_quant_op` (the routed op) and its gradients: the xla-ref
    oracle of `repro.kernels.ops.fake_quant_op` on the same inputs."""
    xj, gj, xt, gt = _inputs((4, 33, 57), 3, "bf16")
    sc = _scalars(1.0)
    y = JOPS.fake_quant_op(xj, *sc, "xla-ref")
    want = jax.grad(lambda x: jnp.sum(
        JOPS.fake_quant_op(x, *sc, "xla-ref").astype(jnp.float32)
        * gj.astype(jnp.float32)))(xj)
    xg = xt.clone().requires_grad_(True)
    yt = TOPS.fake_quant_op(xg, *map(torch.tensor, sc))
    (dx,) = torch.autograd.grad(yt, [xg], gt)
    np.testing.assert_array_equal(_t_np(yt), _to_np(y))
    np.testing.assert_array_equal(_t_np(dx), _to_np(want))


def test_grad_qm_zero_inside_clip():
    """Eq 6: dL/dq_m = 0 when every |x| <= q_m."""
    x = torch.full((8, 8), 0.3)
    qm = torch.tensor(2.0, requires_grad=True)
    y = TQ.fake_quant(x, torch.tensor(0.01), qm, torch.tensor(1.0))
    (g,) = torch.autograd.grad(y.sum(), [qm])
    assert float(g) == 0.0


def test_levels_match_bits():
    """b = 4 gives at most 2^4 - 1 distinct levels (7 a side and 0)."""
    x = torch.linspace(-2.0, 2.0, 4001)
    one = torch.tensor(1.0)
    d = TQ.step_size_for_bits(one, one, torch.tensor(4.0))
    levels = torch.unique(TQ.fake_quant(x, d, one, one))
    assert 2 ** 4 - 3 <= len(levels) <= 2 ** 4 - 1


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    before = dict(TFQ.launches)
    x = torch.randn(5, 7)
    s = [torch.tensor(v) for v in _scalars(1.0)]
    TFQ.fake_quant_fwd(x, *s)
    TFQ.fake_quant_bwd(x, *s, torch.randn(5, 7))
    assert TFQ.launches == before
    with pytest.raises(ValueError):
        TFQ.fake_quant_bwd(x, *s, torch.randn(7, 5))


def _no_card(*args):
    raise AssertionError("the backward's plan must not ask for the card")


@pytest.mark.parametrize("n", [1, 7, 8192, 8195, 8 * 2049 + 3,
                               2048 * 8192, 2048 * 92672])
def test_bwd_rows_are_a_function_of_the_element_count(n, monkeypatch):
    """One partial-sum row per BWD_CHUNK elements (the last one ragged),
    from n alone: the SM count is never read, so the fold order is the
    same on every card."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "sm_count", _no_card)
    rows = TFQ.bwd_rows(n)
    assert (rows - 1) * TFQ.BWD_CHUNK < n <= rows * TFQ.BWD_CHUNK


def test_bwd_rows_reject_an_empty_tensor():
    with pytest.raises(ValueError):
        TFQ.bwd_rows(0)


def test_bwd_chunk_is_the_kernels():
    """The wrapper sizes the row buffer with BWD_CHUNK; the kernel's
    blocks take kChunk elements each."""
    from pathlib import Path
    src = (Path(TFQ.build.CSRC) / "fake_quant.cu").read_text()
    assert f"constexpr long long kChunk = {TFQ.BWD_CHUNK};" in src


@pytest.mark.parametrize("dtype,off", [(torch.bfloat16, o) for o in range(8)]
                         + [(torch.float32, o) for o in range(4)])
def test_empty_coaligned_keeps_the_offset_from_16_bytes(dtype, off):
    """The forward's output lies as far past a 16-byte boundary as its
    input, so that one vector loop reads the one and writes the other."""
    base = torch.zeros(off + 3 * 37, dtype=dtype)
    x = base[off:].view(3, 37)
    y = TFQ.empty_coaligned(x)
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert y.data_ptr() != x.data_ptr()

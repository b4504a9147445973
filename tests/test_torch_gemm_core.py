"""The port's GEMM core against the JAX package's, at decode and prefill M.

The same numpy inputs go through `repro.kernels.gemm_core.gemm` (the
Pallas kernel in interpret mode, and the xla-ref oracle) and through
`repro_torch.kernels.gemm_core.gemm` on CPU tensors (its plain PyTorch
version), for the three serving epilogues. Tolerance rtol/atol 1e-4: the
sums run in another order than the Pallas tiles', in f32. The CUDA kernel
is held to the plain version in `test_torch_gpu.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels import gemm_core as JG
from repro_torch.core import quant as TQ
from repro_torch.kernels import gemm_core as TG

K, N = 160, 96          # K not a multiple of any tile or of 10 codes/word
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(epilogue, M, seed=0):
    """(numpy x, numpy w, JAX RhsOp, port Epilogue factory)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    if epilogue == "fake_quant_rhs":
        qp = JQ.init_quant_params(jnp.asarray(w), bits=4.0)
        d, qm, t = (np.array(v) for v in (qp.d, qp.q_m, qp.t))
        return (x, w, JG.fake_quant_rhs(d, qm, t),
                lambda: TG.fake_quant_rhs(*map(torch.from_numpy, (d, qm, t))))
    bits = 8 if epilogue == "dequant" else int(epilogue[-1])
    qp = JQ.init_quant_params(jnp.asarray(w), bits=float(bits))
    codes, d = JQ.quantize_int(jnp.asarray(w), qp, bits=float(bits))
    scale = np.full((N,), np.asarray(d), np.float32)
    scale[::7] *= 1.5       # per-column scales really per column
    if epilogue == "dequant":
        store = np.asarray(codes).astype(np.int8)
        return (x, store, JG.dequant(scale),
                lambda: TG.dequant(torch.from_numpy(scale)))
    words = np.array(JQ.pack_codes(codes, bits, axis=0))
    return (x, words, JG.unpack_dequant(bits, scale),
            lambda: TG.unpack_dequant(bits, torch.from_numpy(scale)))


EPILOGUES = ["fake_quant_rhs", "dequant", "unpack_b2", "unpack_b3",
             "unpack_b4", "unpack_b8"]


@pytest.mark.parametrize("M", [4, 8, 37])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_plain_matches_jax_pallas_and_xla_ref(epilogue, M):
    x, w, jop, tepi = _case(epilogue, M)
    got = TG.gemm(torch.from_numpy(x), torch.from_numpy(w), tepi()).numpy()
    for backend in ("pallas-interpret", "xla-ref"):
        want = np.asarray(JG.gemm(jnp.asarray(x), jnp.asarray(w), (jop,),
                                  backend=backend))
        np.testing.assert_allclose(got, want, err_msg=backend, **TOL)


def test_dequant_and_unpack_give_identical_outputs():
    """Packed serving's token contract: unpacked words and the int8
    container decode to the same f32 weights, so the outputs agree."""
    x, words, _, unpack = _case("unpack_b4", 8)
    codes = TQ.unpack_codes(torch.from_numpy(words), 4, K, axis=0)
    xt = torch.from_numpy(x)
    scale = unpack().operands[0]
    a = TG.gemm(xt, codes.to(torch.int8), TG.dequant(scale))
    b = TG.gemm(xt, torch.from_numpy(words), unpack())
    assert torch.equal(a, b)


def test_gemm_rejects_mismatched_word_stream():
    x, words, _, unpack = _case("unpack_b3", 4)
    with pytest.raises(ValueError):
        TG.gemm(torch.from_numpy(x), torch.from_numpy(words[:-1]), unpack())


# the decode GEMMs' (K, N) at full width, a ragged pair and a K past what
# eight blocks stage in one 2048-row window each
PLAN_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
               (2048, 92672), (2000, 1028), (160, 96), (20000, 2048)]


@pytest.mark.parametrize("bits", [None, 2, 3, 4, 8], ids=lambda b:
                         f"b{b}" if b else "codes")
@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("K,N", PLAN_SHAPES, ids=str)
def test_k_splits_depend_on_shape_only(K, N, M, bits):
    """The small-M kernel's plan: every K row in exactly one K-group of one
    block, no block without rows, a cluster of at most 8, and one plan for
    a shape whatever its storage: int codes (`bits` None) and packed words
    decode the same rows in the same groups; a group whose rows start
    inside a word (3-bit words straddle 128-row boundaries) reads the
    words its rows span and no word past the stream."""
    plan = TG.small_m_plan(M, N, K, 132)
    assert plan.strip == 128 and 1 <= plan.cluster <= TG.SMALL_M_CLUSTER_MAX
    assert -(-N // 128) * plan.cluster <= max(132, -(-N // 128))
    groups = list(plan.group_rows(K))
    seen = np.zeros(K, np.int64)
    for rank, g, lo, hi in groups:
        assert rank * plan.k_slice <= lo < hi <= (rank + 1) * plan.k_slice
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert {rank for rank, *_ in groups} == set(range(plan.cluster))
    cpw = TQ.codes_per_word(bits) if bits else 1
    words = -(-K // cpw)
    for _, _, lo, hi in groups:
        assert 0 <= lo // cpw <= (hi - 1) // cpw < words
    if bits == 3 and K > 128:
        assert any(lo % cpw for _, _, lo, _ in groups)


def test_small_m_plan_at_the_decode_shapes():
    """One block per SM at most (132 on the H100), clusters of up to 8."""
    plan = lambda K, N, M=4: TG.small_m_plan(M, N, K, 132)
    assert plan(2048, 2048) == TG.SmallMPlan(128, 8, 256)
    assert plan(2048, 1024) == TG.SmallMPlan(128, 8, 256)
    assert plan(2048, 8192) == TG.SmallMPlan(128, 2, 1024)
    assert plan(8192, 2048) == TG.SmallMPlan(128, 8, 1024)
    assert plan(2048, 92672) == TG.SmallMPlan(128, 1, 2048)
    assert plan(20000, 2048) == TG.SmallMPlan(128, 5, 4096)
    assert plan(2048, 8192, 8) == plan(2048, 8192, 1)
    with pytest.raises(ValueError):
        TG.small_m_plan(9, 2048, 2048, 132)

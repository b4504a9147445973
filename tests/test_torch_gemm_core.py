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


def test_k_splits_depend_on_shape_only():
    assert TG.k_splits(37, 1024, 2048, 132) == (1, 16)
    assert TG.k_splits(4, 1024, 2048, 132) == (16, 1)
    assert TG.k_splits(4, 92672, 2048, 132) == (1, 16)
    # 17 splits wanted over 64 chunks: 4 chunks each fill only 16 splits
    assert TG.k_splits(4, 2048, 8192, 132) == (16, 4)
    for M, N, K in [(4, 1024, 2048), (8, 2048, 8192), (4, 96, 160),
                    (4, 8192, 2048), (5, 2048, 2000)]:
        splits, per_split = TG.k_splits(M, N, K, 132)
        n_chunks = -(-K // 128)
        assert (splits - 1) * per_split < n_chunks <= splits * per_split

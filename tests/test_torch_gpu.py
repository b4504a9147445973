"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (marker `gpu`) and skip without one. They
import only torch, numpy and the port, so they run where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the GEMM compares in f32 at rtol 1e-4, atol 1e-4 * max|y| (the
kernel sums in another order than the plain matmul); decode attention,
contiguous and paged (f32, bf16, int8 and int4 pages), at 1e-4 (online
softmax against the full softmax). On f32 and bf16 pages the paged kernel
must equal the contiguous kernel on the gathered rows bit for bit, and the
paged engine's tokens the contiguous engine's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quant import (init_quant_params, kv_quant_encode,
                                    pack_codes, quantize_int)
from repro_torch.kernels import decode_attn as TDA
from repro_torch.kernels import gemm_core as TG
from repro_torch.kernels import ref
from repro_torch.launch.engine import (WEIGHT_MODES, engine_serve,
                                       serve_on_devices)

pytestmark = pytest.mark.gpu
EPILOGUES = ["fake_quant_rhs", "dequant", "unpack_b2", "unpack_b3",
             "unpack_b4", "unpack_b8"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the repro_torch kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(epilogue, K, N, gen):
    """(weight operand, epilogue) on the card, quantizers at their init."""
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    if epilogue == "fake_quant_rhs":
        qp = init_quant_params(w, bits=4.0)
        return w.to(torch.bfloat16), TG.fake_quant_rhs(qp.d, qp.q_m, qp.t)
    bits = 8 if epilogue == "dequant" else int(epilogue[-1])
    codes, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                            bits=float(bits))
    scale = d * (1.0 + (torch.arange(N, device="cuda") % 7 == 0) * 0.5)
    if epilogue == "dequant":
        return codes.to(torch.int8), TG.dequant(scale)
    return pack_codes(codes, bits, axis=0), TG.unpack_dequant(bits, scale)


@pytest.mark.parametrize("K,N", [(160, 96), (2048, 1024)])
@pytest.mark.parametrize("M", [4, 8, 37])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_gemm_kernel_matches_plain(cuda, epilogue, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(K + M)
    w, epi = _weights(epilogue, K, N, gen)
    x = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    before = dict(TG.gemm.launches)
    y = TG.gemm(x, w, epi, out_dtype=torch.float32)
    want = TG.plain(x, w, epi, torch.float32)
    torch.cuda.synchronize()
    splits, _ = TG.k_splits(M, N, K, TG._sm_count(x.device))
    assert TG.gemm.launches[epi.name] == before[epi.name] + 1
    assert (TG.gemm.launches[TG.REDUCE]
            == before[TG.REDUCE] + (splits > 1))
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("M", [4, 37])
def test_dequant_and_unpack_are_bitwise_equal_on_card(cuda, M):
    gen = torch.Generator(device=cuda).manual_seed(M)
    w = torch.randn((2048, 1024), generator=gen, device=cuda) * 0.02
    codes, d = quantize_int(w, init_quant_params(w, bits=4.0), bits=4.0)
    x = torch.randn((M, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    a = TG.gemm(x, codes.to(torch.int8), TG.dequant(d))
    b = TG.gemm(x, pack_codes(codes, 4, axis=0), TG.unpack_dequant(4, d))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_matches_plain(cuda, kv_dtype):
    B, S, KVh, g, dh = 4, 200, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, KVh, g, dh), generator=gen, device=cuda)
    cache = torch.randn((2, 2, B, S, KVh, dh), generator=gen,
                        device=cuda).to(kv_dtype)
    k, v = cache[0, 1], cache[1, 1]        # per-layer views, read in place
    pos = torch.tensor([0, S - 1, 63, 64], dtype=torch.int32, device=cuda)
    before = TDA.decode_attn.launches
    got = TDA.decode_attn(q, k, v, pos)
    want = ref.decode_attn_ref(q, k, v, pos)
    torch.cuda.synchronize()
    assert TDA.decode_attn.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_decode_attn_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 1, 9, 32), device=cuda)        # g = 9 > 8
    k = torch.zeros((1, 4, 1, 32), device=cuda)
    with pytest.raises(ValueError):
        TDA.decode_attn(q, k, k, torch.zeros(1, dtype=torch.int32,
                                             device=cuda))


def test_pow_of_one_is_identity_on_card(cuda):
    """The fake-quant epilogue skips powf at t == 1 and keeps c; the plain
    version's torch.pow(c, 1) must give c for every positive float."""
    ones = torch.ones(1 << 27, device=cuda)
    top = 0x7F800000                       # +inf: every finite float below
    for start in range(1, top, 1 << 27):
        c = torch.arange(start, min(start + (1 << 27), top), device=cuda,
                         dtype=torch.int64).to(torch.int32).view(torch.float32)
        assert torch.equal(torch.pow(c, ones[:c.numel()]), c)


@pytest.mark.parametrize("mode", list(WEIGHT_MODES))
def test_engine_on_card_matches_cpu(cuda, mode):
    """The smoke engine emits the same greedy tokens on the card (CUDA
    kernels) as on the CPU (plain versions), from the same weights."""
    toks = serve_on_devices("internlm2-1.8b", True, [6, 3, 9], 6,
                            ["cpu", "cuda"], max_slots=2,
                            **WEIGHT_MODES[mode])
    for rid in toks["cpu"]:
        np.testing.assert_array_equal(toks["cuda"][rid], toks["cpu"][rid])


def _paged(kind, gen, B=4, seq_len=200, P=16, KVh=8, g=2, dh=128):
    """q, pools, table, pos and scales for one paged call on the card: the
    slots' pages in a shuffled order, slot 0's tail on the zero page."""
    Lp = -(-seq_len // P)
    n_pages = 2 + B * Lp
    perm = torch.randperm(n_pages - 2, generator=gen, device="cuda") + 2
    table = perm.reshape(B, Lp).to(torch.int32)
    table[0, 1:] = 0
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda")
    pools = [torch.randn((n_pages, P, KVh, dh), generator=gen, device="cuda")
             for _ in range(2)]
    kw = dict(page_size=P, seq_len=seq_len)
    if kind in ("int8", "int4"):
        bits = int(kind[-1])
        (kp, ks), (vp, vs) = (kv_quant_encode(p, bits) for p in pools)
        kw.update(kv_bits=bits, k_scale=ks, v_scale=vs)
    else:
        kp, vp = (p.to(getattr(torch, kind)) for p in pools)
    pos = torch.tensor([P - 1, seq_len - 1, 63, 64], dtype=torch.int32,
                       device="cuda")[:B]
    return q, kp, vp, pos, table, kw


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
def test_paged_decode_attn_kernel_matches_plain(cuda, kind):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, kp, vp, pos, table, kw = _paged(kind, gen)
    storage = {"float32": "f32", "bfloat16": "bf16"}.get(kind, kind)
    before = dict(TDA.paged_decode_attn.launches)
    got = TDA.paged_decode_attn(q, kp, vp, pos, table, **kw)
    want = ref.paged_decode_attn_ref(q, kp, vp, pos, table, **kw)
    torch.cuda.synchronize()
    assert TDA.paged_decode_attn.launches == dict(
        before, **{storage: before[storage] + 1})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_paged_kernel_is_contiguous_kernel_on_gathered_rows(cuda, kind):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, kp, vp, pos, table, kw = _paged(kind, gen)
    rows = lambda pool: ref.gather_pages(pool, None, table, **kw)
    got = TDA.paged_decode_attn(q, kp, vp, pos, table, **kw)
    want = TDA.decode_attn(q, rows(kp), rows(vp), pos)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", list(WEIGHT_MODES))
def test_paged_engine_on_card_matches_contiguous(cuda, mode):
    """The smoke engine emits the same greedy tokens from the paged arena
    (pages of 8 rows) as from the contiguous one, on the card."""
    kw = dict(max_slots=2, verbose=False, device="cuda", **WEIGHT_MODES[mode])
    lens = [6, 3, 9, 17]
    want = engine_serve("internlm2-1.8b", True, lens, 6, **kw)
    got = engine_serve("internlm2-1.8b", True, lens, 6, paged=True,
                       page_size=8, **kw)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])

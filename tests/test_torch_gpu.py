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
paged engine's tokens the contiguous engine's. The fake-quant forward and
dx are bitwise the plain versions' at t = 1 and t != 1 (both take the same
powf), and the backward's three sums agree to 1e-5 of the sum of their
terms' magnitudes (another summation order) and repeat bit for bit run to
run. One smoke train step on the card agrees with its CPU run at
`repro_torch.launch.train.STEP_TOLERANCES` (loss 1e-5, params 1e-4 of
max|x|, q_m and t 1e-4, d 1e-2; identical masks) and repeats bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quant import (init_quant_params, kv_quant_encode,
                                    pack_codes, quantize_int)
from repro_torch.kernels import decode_attn as TDA
from repro_torch.kernels import fake_quant as TFQ
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
    splits, _ = TG.k_splits(M, N, K, TG.build.sm_count(x.device))
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


# ---------------------------------------------------------- training slice
def _fq_case(shape, dtype, t, gen):
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    qm = x.float().abs().max() * 0.8                  # some elements clip
    qp = init_quant_params(q_m=qm, bits=6.0, t=t)
    return x, g, (qp.d, qp.q_m, qp.t)


@pytest.mark.parametrize("t", [1.0, 0.85])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 8192), (37, 53)])
def test_fake_quant_kernels_match_plain(cuda, shape, dtype, t):
    gen = torch.Generator(device=cuda).manual_seed(shape[0])
    x, g, sc = _fq_case(shape, dtype, t, gen)
    before = dict(TFQ.launches)
    y = TFQ.fake_quant_fwd(x, *sc)
    got = TFQ.fake_quant_bwd(x, *sc, g)
    want_y = ref.fake_quant_fwd_ref(x, *sc)
    want = ref.fake_quant_bwd_ref(x, *sc, g)
    torch.cuda.synchronize()
    assert TFQ.launches == {TFQ.FWD: before[TFQ.FWD] + 1,
                            TFQ.BWD: before[TFQ.BWD] + 1}
    assert y.dtype == x.dtype and got[0].dtype == x.dtype
    assert torch.equal(y, want_y)
    assert torch.equal(got[0], want[0])
    for a, b, scale in zip(got[1:], want[1:], TFQ.sum_scales(x, g, *sc)):
        assert abs(float(a) - float(b)) <= 1e-5 * scale + 1e-30


def test_fake_quant_backward_repeats_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, g, sc = _fq_case((2048, 8192), torch.bfloat16, 0.85, gen)
    a = TFQ.fake_quant_bwd(x, *sc, g)
    b = TFQ.fake_quant_bwd(x, *sc, g)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("K,N", [(160, 96), (2048, 1024)])
@pytest.mark.parametrize("M", [4, 37, 2048])
@pytest.mark.parametrize("epi", ["none", "col_mask", "fq_col_mask"])
def test_training_epilogues_match_plain(cuda, epi, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(K + M)
    w = (torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5).to(
        torch.bfloat16)
    mask = (torch.arange(N, device=cuda) % 3 > 0).float()
    qp = init_quant_params(w, bits=8.0, t=0.85)
    e = {"none": TG.none(), "col_mask": TG.col_mask(mask),
         "fq_col_mask": TG.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[epi]
    x = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    before = dict(TG.gemm.launches)
    y = TG.gemm(x, w, e, out_dtype=torch.float32)
    want = TG.plain(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert TG.gemm.launches[epi] == before[epi] + 1
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    if epi != "none":
        assert not y[:, mask == 0].any()


def test_smoke_train_step_on_card_matches_cpu(cuda):
    """One joint-stage step (the partition is computed) from the same
    state: card kernels against the CPU plain versions, at
    `train.STEP_TOLERANCES`; a second card run repeats bit for bit."""
    from repro_torch.launch import train as T
    runs = T.step_on_devices("internlm2-1.8b", ["cpu", "cuda"])
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    assert diff.pop("masks")
    for k, tol in T.STEP_TOLERANCES.items():
        assert diff[k] <= tol, (k, diff[k], tol)
    pg, _, _, mg = runs["cuda"]
    pa, _, _, ma = T.step_on_devices("internlm2-1.8b", ["cuda"])["cuda"]
    assert torch.equal(ma["loss"], mg["loss"])
    assert all(torch.equal(pa[k], pg[k]) for k in pg)

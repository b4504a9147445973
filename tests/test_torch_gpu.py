"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (marker `gpu`) and skip without one. They
import only torch, numpy and the port, so they run where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the GEMM compares in f32 at rtol 1e-4, atol 1e-4 * max|y| (the
kernel sums in another order than the plain matmul), its small-M variant
one kernel per call (a profiler trace), three calls bitwise equal and
dequant bitwise unpack_dequant at ragged N and K; its tensor-core
variant (`test_tc_*`) at the same bound, every case run twice and held
bitwise, its bf16 output bitwise its f32 output rounded, and its SIMT
variant (`test_simt_*`, f32 x) at the same bound, a second call bitwise
the first; decode attention,
contiguous and paged (f32, bf16, int8 and int4 pages), at 1e-4 against
the full softmax and at 1e-5 against the split-rows mirror
(`ref.decode_attn_split_ref`, the kernel's own order; another summation
order inside a split), with slots at the split edges, at GQA ratios g 1,
3, 5, 6 and head widths 64 and 80, and at S = 4096
(at 1e-4 past 256 splits, the combine's chunk: over thousands of splits
its sum cancels and the roundoff the two do not share grows); its
result across rows per split (1, 4 and 16 splits) at 1e-6, as the JAX
kernel's across chunks (`tests/test_decode_attn.py`); bf16 q and int64 pos
(any stride) read directly, bitwise the converted inputs' result; a call
makes no host sync (it would read `pos`). On f32 and bf16 pages the paged
kernel must equal the contiguous kernel on the gathered rows bit for bit,
and the paged engine's tokens the contiguous engine's. The fake-quant forward and
dx are bitwise the plain versions' at t = 1 and t != 1 (both take the same
powf), and the backward's three sums agree to 1e-5 of the sum of their
terms' magnitudes (another summation order; for a few elements, where
one f32 ulp of the sum exceeds that, two ulps of the plain sum) and repeat
bit for bit run to run; also at 1, 7 and ragged element counts, on views
that start 1-7 elements past a 16-byte boundary (bitwise the sums of
aligned copies), on bf16 x with f32 g, at t = 1 less one ulp; one kernel a
call and no host sync. dwq's GEMM writes bf16 bitwise its f32 output
rounded; the tensor-core GEMM launches as a thread's first CUDA call. One
smoke train step on the card agrees with its CPU run at
`repro_torch.launch.train.STEP_TOLERANCES` (loss 1e-5, params 1e-4 of
max|x|, q_m and t 1e-4, d 1e-2; identical masks) and repeats bit for bit;
with activation quantizers the masks, the loss and the parameter
gradients (1e-4 of max|g|) agree and the card step repeats bit for bit.
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
    kind = TG.variant(M, x.dtype)
    assert TG.gemm.launches == dict(before, **{
        epi.name: before[epi.name] + 1, kind: before[kind] + 1})
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


def _device_kernels(fn) -> list[str]:
    """The names of the device kernels one call of `fn` runs, from a
    torch.profiler trace of a call after a first one outside it. A trace
    that recorded no device event at all (a short session now and then
    comes back empty on the H100) is taken again, up to eight times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(8):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.events() if e.device_type == cuda]
        if names:
            break
    return names


# the small-M variant at decode shapes (clusters of 8, 2 and 1 blocks), a
# ragged one (N % 16 == 4: rows not 16-byte aligned for int8 or bf16; K
# not a multiple of 128 or of 10 codes per word) and a K past one 2048-row
# window per block
SMALL_M_SHAPES = [(2048, 2048), (2048, 8192), (2048, 92672), (2000, 1028),
                  (20000, 256)]


@pytest.mark.parametrize("K,N", SMALL_M_SHAPES, ids=str)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_small_m_is_one_launch_and_repeats_bitwise(cuda, epilogue, K, N):
    """One kernel per call (a profiler trace: no second pass), three calls
    bitwise equal (the cluster sums in a fixed order, no atomics), within
    the GEMM's bound of the plain version, bf16 output the f32 rounded."""
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    w, epi = _weights(epilogue, K, N, gen)
    x = torch.randn((4, K), generator=gen, device=cuda).to(torch.bfloat16)
    run = lambda: TG.gemm(x, w, epi, out_dtype=torch.float32)
    names = _device_kernels(run)
    assert len(names) == 1 and "gemm_small_m" in names[0], names
    ys = [run() for _ in range(3)]
    want = TG.plain(x, w, epi, torch.float32)
    torch.cuda.synchronize()
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    torch.testing.assert_close(ys[0], want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(TG.gemm(x, w, epi, out_dtype=torch.bfloat16),
                       ys[0].to(torch.bfloat16))


@pytest.mark.parametrize("K,N", [(2000, 1028), (2048, 8192)], ids=str)
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_small_m_dequant_and_unpack_are_bitwise_equal(cuda, M, bits, K, N):
    """Packed serving's token contract at decode M, ragged N and K: the
    plan does not depend on the epilogue, so int8 codes and packed words
    sum the same codes in the same order."""
    gen = torch.Generator(device=cuda).manual_seed(M + bits)
    w = torch.randn((K, N), generator=gen, device=cuda) * 0.02
    codes, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                            bits=float(bits))
    scale = d * (1.0 + (torch.arange(N, device=cuda) % 7 == 0) * 0.5)
    x = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    a = TG.gemm(x, codes.to(torch.int8), TG.dequant(scale))
    b = TG.gemm(x, pack_codes(codes, bits, axis=0),
                TG.unpack_dequant(bits, scale))
    assert torch.equal(a, b)


@pytest.mark.parametrize("K,N", [(160, 96), (2000, 1028)], ids=str)
@pytest.mark.parametrize("M", [1, 2, 5, 8])
@pytest.mark.parametrize("epi", ["none", "col_mask", "fake_quant_rhs",
                                 "fq_col_mask", "dequant", "unpack_b3"])
def test_small_m_f32_x_matches_plain(cuda, epi, M, K, N):
    """f32 x and f32 weights at M <= 8, as the f32 smoke configuration
    hands them to its decode steps, at t = 0.85 (a powf per weight)."""
    gen = torch.Generator(device=cuda).manual_seed(K + M + 5)
    w = torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5
    mask = (torch.arange(N, device=cuda) % 3 > 0).float()
    qp = init_quant_params(w, bits=8.0, t=0.85)
    if epi in ("dequant", "unpack_b3"):
        bits = 8 if epi == "dequant" else 3
        codes, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                                bits=float(bits))
        w, e = ((codes.to(torch.int8), TG.dequant(d)) if epi == "dequant"
                else (pack_codes(codes, 3, axis=0), TG.unpack_dequant(3, d)))
    else:
        e = {"none": TG.none(), "col_mask": TG.col_mask(mask),
             "fake_quant_rhs": TG.fake_quant_rhs(qp.d, qp.q_m, qp.t),
             "fq_col_mask": TG.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[epi]
    x = torch.randn((M, K), generator=gen, device=cuda)
    y = TG.gemm(x, w, e, out_dtype=torch.float32)
    want = TG.plain(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert TG.variant(M, x.dtype) == "small_m"
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    if "mask" in epi:
        assert not y[:, mask == 0].any()


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


@pytest.mark.parametrize("dh,R", [(30, 64), (32, 0), (32, 129)])
def test_decode_attn_rejects_widths_and_splits_it_does_not_take(cuda, dh, R):
    q = torch.zeros((1, 1, 2, dh), device=cuda)
    k = torch.zeros((1, 4, 1, dh), device=cuda)
    with pytest.raises(ValueError):
        TDA.decode_attn(q, k, k, torch.zeros(1, dtype=torch.int32,
                                             device=cuda), rows_per_split=R)


R = TDA.ROWS_PER_SPLIT


def _edge_pos(S, device):
    """Slots whose valid rows end at the split edges (R-1, R and R+1 rows),
    fill the arena, hold one row, and sit past the arena's end."""
    return torch.tensor([R - 2, R - 1, R, S - 1, 0, S + 7],
                        dtype=torch.int32, device=device)


def _contiguous(gen, B, S, kv_dtype, KVh=8, g=2, dh=128):
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda")
    cache = torch.randn((2, 2, B, S, KVh, dh), generator=gen,
                        device="cuda").to(kv_dtype)
    return q, cache[0, 1], cache[1, 1]     # per-layer views, strided


@pytest.mark.parametrize("S", [200, 4096])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_matches_plain_and_split_mirror(cuda, kv_dtype,
                                                           S):
    gen = torch.Generator(device=cuda).manual_seed(S)
    pos = _edge_pos(S, cuda)
    q, k, v = _contiguous(gen, pos.numel(), S, kv_dtype)
    got = TDA.decode_attn(q, k, v, pos)
    plain = ref.decode_attn_ref(q, k, v, pos)
    mirror = ref.decode_attn_split_ref(q, k, v, pos, R)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, mirror, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq_len", [200, 4096])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
def test_paged_kernel_matches_plain_and_split_mirror(cuda, kind, seq_len):
    gen = torch.Generator(device=cuda).manual_seed(seq_len + 1)
    pos = _edge_pos(seq_len, cuda)
    q, kp, vp, pos, table, kw = _paged(kind, gen, B=pos.numel(),
                                       seq_len=seq_len, pos=pos)
    got = TDA.paged_decode_attn(q, kp, vp, pos, table, **kw)
    plain = ref.paged_decode_attn_ref(q, kp, vp, pos, table, **kw)
    mirror = ref.paged_decode_attn_split_ref(q, kp, vp, pos, table,
                                             rows_per_split=R, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, mirror, rtol=1e-5, atol=1e-5)


# GQA ratios and head widths of the dense configs beside internlm2-1.8b
# (stablelm-3b g 1 dh 80, minitron-4b g 3, qwen2.5-14b g 5, grok-1 g 6):
# the kernel rounds g up to a template G of 1, 2, 4 or 8, so g = 3, 5 and 6
# run with idle query rows, and dh 64 and 80 fill fewer lanes than 128
@pytest.mark.parametrize("g,dh", [(g, dh) for g in (1, 3, 5, 6)
                                  for dh in (64, 80)], ids=str)
@pytest.mark.parametrize("kind", ["contiguous", "bfloat16", "int8"])
def test_decode_kernels_at_other_gqa_ratios_and_head_widths(cuda, kind, g,
                                                            dh):
    gen = torch.Generator(device=cuda).manual_seed(100 * g + dh)
    S = 300
    pos = _edge_pos(S, cuda)
    if kind == "contiguous":
        q, k, v = _contiguous(gen, pos.numel(), S, torch.bfloat16, KVh=4,
                              g=g, dh=dh)
        got = TDA.decode_attn(q, k, v, pos)
        plain = ref.decode_attn_ref(q, k, v, pos)
        mirror = ref.decode_attn_split_ref(q, k, v, pos, R)
    else:
        q, kp, vp, pos, table, kw = _paged(kind, gen, B=pos.numel(),
                                           seq_len=S, KVh=4, g=g, dh=dh,
                                           pos=pos)
        got = TDA.paged_decode_attn(q, kp, vp, pos, table, **kw)
        plain = ref.paged_decode_attn_ref(q, kp, vp, pos, table, **kw)
        mirror = ref.paged_decode_attn_split_ref(q, kp, vp, pos, table,
                                                 rows_per_split=R, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, mirror, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_is_invariant_across_rows_per_split(cuda, paged):
    """1 split (R = 128) vs 4 (R = 32) vs 16 (R = 8) over 128 rows: the
    combine reproduces the one-split softmax to f32 roundoff."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    S = 128
    pos = torch.tensor([S - 1, 100, 31, 64], dtype=torch.int32, device=cuda)
    if paged:
        q, kp, vp, pos, table, kw = _paged("float32", gen, seq_len=S,
                                           pos=pos)
        run = lambda R: TDA.paged_decode_attn(q, kp, vp, pos, table, **kw,
                                              rows_per_split=R)
    else:
        q, k, v = _contiguous(gen, 4, S, torch.float32)
        run = lambda R: TDA.decode_attn(q, k, v, pos, rows_per_split=R)
    one = run(128)
    for R_ in (32, 8):
        torch.testing.assert_close(run(R_), one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("g,S,R_", [(2, 4096, 1), (8, 40960, 8)])
def test_kernel_combines_more_splits_than_one_chunk(cuda, paged, g, S, R_):
    """More splits per head than the combine stages at once (256): 4096
    splits of one row at g = 2, and 5120 of 8 rows at g = 8 (64 query
    heads over 8 KV heads) over a 40960-row arena. Held to the split
    mirror at the plain version's 1e-4, not 1e-5: over thousands of
    splits, sum w_i o_i cancels (its terms have both signs), and the
    per-split roundoff that the kernel and the mirror do not share grows
    with the number of splits (6.4e-5 relative at 5120 splits on the
    H100)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    pos = torch.tensor([S - 1, S // 2 + 3, 300, 0], dtype=torch.int32,
                       device=cuda)
    if paged:
        q, kp, vp, pos, table, kw = _paged("bfloat16", gen, seq_len=S,
                                           KVh=2, g=g, pos=pos)
        got = TDA.paged_decode_attn(q, kp, vp, pos, table, **kw,
                                    rows_per_split=R_)
        plain = ref.paged_decode_attn_ref(q, kp, vp, pos, table, **kw)
        mirror = ref.paged_decode_attn_split_ref(q, kp, vp, pos, table,
                                                 rows_per_split=R_, **kw)
    else:
        q, k, v = _contiguous(gen, 4, S, torch.bfloat16, KVh=2, g=g)
        got = TDA.decode_attn(q, k, v, pos, rows_per_split=R_)
        plain = ref.decode_attn_ref(q, k, v, pos)
        mirror = ref.decode_attn_split_ref(q, k, v, pos, R_)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, mirror, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_reads_rows_at_any_alignment(cuda, kv_dtype):
    """Rows that start 4 (f32) or 2 (bf16) bytes past a 16-byte boundary
    are staged by narrower copies than cp.async's 16 bytes."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, S, KVh, g, dh = 4, 150, 2, 2, 128
    q = torch.randn((B, KVh, g, dh), generator=gen, device=cuda)
    k, v = (torch.randn((B, S, KVh, dh + 1), generator=gen, device=cuda)
            .to(kv_dtype)[..., 1:] for _ in range(2))
    pos = torch.tensor([S - 1, 0, 63, 64], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(TDA.decode_attn(q, k, v, pos),
                               ref.decode_attn_ref(q, k, v, pos),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,dh", [("bfloat16", 4), ("int8", 8),
                                     ("int4", 8)])
def test_paged_kernel_takes_rows_narrower_than_16_bytes(cuda, kind, dh):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, kp, vp, pos, table, kw = _paged(kind, gen, KVh=2, dh=dh)
    torch.testing.assert_close(
        TDA.paged_decode_attn(q, kp, vp, pos, table, **kw),
        ref.paged_decode_attn_ref(q, kp, vp, pos, table, **kw),
        rtol=1e-4, atol=1e-4)


def test_kernel_reads_bf16_q_and_int64_pos_as_converted(cuda):
    """What the layers hand the kernel (bf16 q, int64 pos, here also a
    stride-0 pos) gives bitwise the result of f32 q and int32 pos: both
    conversions are exact."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = _contiguous(gen, 4, 300, torch.bfloat16)
    qb = q.to(torch.bfloat16)
    pos = torch.tensor([299, 0, 64, 130], dtype=torch.int64, device=cuda)
    want = TDA.decode_attn(qb.float(), k, v, pos.int())
    assert torch.equal(TDA.decode_attn(qb, k, v, pos), want)
    same = torch.full((1,), 130, dtype=torch.int64, device=cuda).expand(4)
    assert torch.equal(TDA.decode_attn(qb, k, v, same),
                       TDA.decode_attn(qb.float(), k, v, same.int()
                                       .contiguous()))
    q, kp, vp, pos, table, kw = _paged("int8", gen)
    qb = q.to(torch.bfloat16)
    want = TDA.paged_decode_attn(qb.float(), kp, vp, pos, table, **kw)
    assert torch.equal(TDA.paged_decode_attn(qb, kp, vp, pos.long(), table,
                                             **kw), want)


def test_kernel_call_makes_no_host_sync(cuda):
    """The split plan comes from S on the host, never from `pos` on the
    device: a call syncs nothing."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = _contiguous(gen, 4, 576, torch.bfloat16)
    pos = torch.tensor([575, 0, 300, 63], dtype=torch.int64, device=cuda)
    pq, kp, vp, ppos, table, kw = _paged("int4", gen, seq_len=576)
    args = [(TDA.decode_attn, (q.to(torch.bfloat16), k, v, pos), {}),
            (TDA.paged_decode_attn, (pq, kp, vp, ppos.long(), table), kw)]
    for fn, a, kwargs in args:
        fn(*a, **kwargs)                   # builds the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, a, kwargs in args:
            fn(*a, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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


def _paged(kind, gen, B=4, seq_len=200, P=16, KVh=8, g=2, dh=128, pos=None):
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
    if pos is None:
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


# element counts 1, 7, 8k + 3 (ragged slots) and past three 8192-element
# chunks with a ragged tail; t = 1 less one ulp takes the powf body on a t
# that rounds like 1
T_BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
FQ_TYPES = {"f32": (torch.float32, torch.float32),
            "bf16": (torch.bfloat16, torch.bfloat16),
            "bf16_x_f32_g": (torch.bfloat16, torch.float32)}


def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of t that starts `off` elements past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("t", [1.0, 0.85, T_BELOW_ONE], ids=str)
@pytest.mark.parametrize("types", list(FQ_TYPES))
@pytest.mark.parametrize("n", [1, 7, 8 * 2049 + 3, 3 * 8192 + 5])
def test_fake_quant_kernels_at_ragged_and_misaligned_inputs(cuda, n, types,
                                                            t):
    """Forward and dx bitwise the plain versions and the sums within 1e-5
    of their scale (or two ulps of the plain sum, which a few elements
    summed in another order can reach), for x and g that start 0-7
    elements past a 16-byte
    boundary (x and g at different offsets); the sums are also bitwise
    those of aligned copies: their fold order depends on n alone."""
    x_dtype, g_dtype = FQ_TYPES[types]
    gen = torch.Generator(device=cuda).manual_seed(n)
    x, g, sc = _fq_case((n,), x_dtype, t, gen)
    g = g.to(g_dtype)
    want_y = ref.fake_quant_fwd_ref(x, *sc)
    want = ref.fake_quant_bwd_ref(x, *sc, g)
    scales = TFQ.sum_scales(x, g, *sc)
    aligned = TFQ.fake_quant_bwd(x, *sc, g)
    for off in range(8):
        xo, go = _at_offset(x, off), _at_offset(g, 3 * off % 8)
        y = TFQ.fake_quant_fwd(xo, *sc)
        got = TFQ.fake_quant_bwd(xo, *sc, go)
        again = TFQ.fake_quant_bwd(xo, *sc, go)
        torch.cuda.synchronize()
        assert y.dtype == x_dtype and got[0].dtype == x_dtype
        assert torch.equal(y, want_y), off
        assert torch.equal(got[0], want[0]), off
        for a, b, scale in zip(got[1:], want[1:], scales):
            # at a few elements one f32 ulp of the sum can exceed 1e-5 of
            # the scale (dd's scale is sum |g| * d, far below |dd|)
            ulps = 2 * float(np.spacing(np.float32(abs(float(b)))))
            assert abs(float(a) - float(b)) <= max(1e-5 * scale, ulps), off
        assert all(torch.equal(a, b) for a, b in zip(got, again)), off
        assert all(torch.equal(a, b) for a, b in zip(got[1:], aligned[1:])), off


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_fake_quant_is_one_kernel_per_call(cuda, direction):
    """A profiler trace of one call holds one device kernel: the
    backward folds its rows in the same launch."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, g, sc = _fq_case((2048, 8192), torch.bfloat16, 0.85, gen)
    fn = {"fwd": lambda: TFQ.fake_quant_fwd(x, *sc),
          "bwd": lambda: TFQ.fake_quant_bwd(x, *sc, g)}[direction]
    names = _device_kernels(fn)
    assert len(names) == 1 and f"fq_{direction}" in names[0], names


def test_fake_quant_call_makes_no_host_sync(cuda):
    """t is read on the device (its t == 1 branch is taken per block), so
    neither call syncs with the host."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x, g, sc = _fq_case((37, 53), torch.bfloat16, 1.0, gen)
    TFQ.fake_quant_fwd(x, *sc)          # builds the library first
    TFQ.fake_quant_bwd(x, *sc, g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TFQ.fake_quant_fwd(x, *sc)
        TFQ.fake_quant_bwd(x, *sc, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("K,N", [(2048, 8192), (8192, 2048)], ids=str)
def test_dwq_gemm_writes_bf16_as_its_f32_output_rounded(cuda, K, N):
    """dwq = x.T @ g at the training shapes (2048 tokens, x.T a view) in
    bf16 is the f32 output cast to bf16, bit for bit, so the backward
    takes it with no cast pass; and through `fq_matmul_op` the weight's
    gradients are those of the f32-and-cast route."""
    from repro_torch.kernels import ops as TOPS
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    x = torch.randn((2048, K), generator=gen, device=cuda).to(torch.bfloat16)
    g = (torch.randn((2048, N), generator=gen, device=cuda) * 1e-2).to(
        torch.bfloat16)
    assert TG.variant(K, torch.bfloat16) == "tc"
    f32 = TG.gemm(x.T, g, TG.none(), out_dtype=torch.float32)
    bf16 = TG.gemm(x.T, g, TG.none(), out_dtype=torch.bfloat16)
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    w = (torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5).to(
        torch.bfloat16)
    qp = init_quant_params(w, bits=8.0, t=0.85)
    s = [v.clone().requires_grad_(True) for v in (qp.d, qp.q_m, qp.t)]
    wg = w.clone().requires_grad_(True)
    got = torch.autograd.grad(TOPS.fq_matmul_op(x, wg, *s), [wg, *s], g)
    want = TFQ.fake_quant_bwd(w, qp.d, qp.q_m, qp.t, f32.to(torch.bfloat16))
    assert all(torch.equal(a.reshape(b.shape), b) for a, b in zip(got, want))


def test_act_quant_smoke_step_on_card(cuda):
    """The smoke config's joint step with activation quantizers, each
    activation site through the fake-quant kernels on the card (their plain
    versions on the CPU). Held: the card step repeats bit for bit, its
    masks equal the CPU step's, its loss is within STEP_TOLERANCES, and the
    loss-and-gradient pass's parameter gradients lie within 1e-4 of each
    tensor's max|g| of the CPU's (the bound of the CPU test against JAX).
    The step's params and (d, q_m, t) are reported by `chip_smoke.py`
    phase 7, not held: a rounding tie of an activation, flipped by the
    GEMMs' summation order, moves them past STEP_TOLERANCES."""
    import dataclasses
    from repro_torch.launch import train as T
    comp = dataclasses.replace(T.JOINT_STEP0, act_quant=True)
    before = dict(TFQ.launches)
    runs = T.step_on_devices("internlm2-1.8b", ["cpu", "cuda"], comp=comp)
    act = [k for k in runs["cuda"][1] if k.endswith(".aq")]
    assert act
    assert TFQ.launches[TFQ.FWD] - before[TFQ.FWD] >= len(act)
    assert TFQ.launches[TFQ.BWD] - before[TFQ.BWD] >= len(act)
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    assert diff["masks"]
    assert diff["loss"] <= T.STEP_TOLERANCES["loss"]
    again = T.step_on_devices("internlm2-1.8b", ["cuda"], comp=comp)["cuda"]
    pg, qg, _, mg = runs["cuda"]
    assert torch.equal(again[3]["loss"], mg["loss"])
    assert all(torch.equal(again[0][k], pg[k]) for k in pg)
    assert all(torch.equal(getattr(again[1][k], f), getattr(qg[k], f))
               for k in qg for f in ("d", "q_m", "t"))
    lm, p0, q0, _, _, _ = T.init_geta("internlm2-1.8b", True, comp=comp,
                                      device="cpu")
    tokens = torch.randint(0, lm.cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in p0.items()}
        q = {k: type(v)(*(t.to(dev) for t in (v.d, v.q_m, v.t)))
             for k, v in q0.items()}
        grads[dev] = T.loss_and_grads(lm, p, q, {"tokens": tokens.to(dev)})[1]
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k].float().cpu()
        scale = float(want.float().abs().max())
        assert float((got - want.float()).abs().max()) <= 1e-4 * scale, k


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


# ------------------------------------------- the GEMM's tensor-core variant
# The model's prefill and training shapes (M, K, N), and a ragged one: no
# dimension a multiple of its tile (128 x 128 x 64), K not a multiple of
# 10 codes per word, every row stride still a multiple of 16 bytes
TC_SHAPES = [(M, K, N) for M in (512, 2048)
             for K, N in ((2048, 2048), (2048, 1024), (2048, 8192),
                          (8192, 2048))] + [(296, 200, 144)]
# (epilogue, t, bits) of the float-weight cases: 8-bit codes take one
# bf16 pass, 14-bit codes (|q| up to 8191) a second one, codes of 2^17 and
# more (quantizers above about 18 bits, as in warm-up) a third one; 17 and
# 18 bits sit on either side of the kernel's choice of K loop
TC_FLOAT = [("none", 1.0, 8.0), ("col_mask", 1.0, 8.0),
            ("fake_quant_rhs", 1.0, 8.0), ("fake_quant_rhs", 0.85, 8.0),
            ("fake_quant_rhs", 1.0, 14.0), ("fake_quant_rhs", 0.85, 14.0),
            ("fake_quant_rhs", 1.0, 17.0), ("fake_quant_rhs", 0.85, 18.0),
            ("fake_quant_rhs", 1.0, 20.0), ("fake_quant_rhs", 0.85, 20.0),
            ("fake_quant_rhs", 1.0, 24.0), ("fake_quant_rhs", 0.85, 24.0),
            ("fq_col_mask", 1.0, 8.0), ("fq_col_mask", 0.85, 14.0),
            ("fq_col_mask", 0.85, 24.0)]
TC_LAYOUTS = ["x,w", "x.T,w", "x,w.T", "x.T,w.T"]


def _operand(shape, transposed, gen, scale=1.0, dtype=torch.bfloat16):
    """A random (rows, cols) operand on the card, row-major or the
    transposed view of a row-major (cols, rows) array."""
    rows, cols = shape
    store = (cols, rows) if transposed else (rows, cols)
    t = (torch.randn(store, generator=gen, device="cuda") * scale).to(dtype)
    return t.T if transposed else t


def _tc_check(x, w, e, mask=None):
    """The tensor-core variant against its plain version: twice (bitwise
    equal: no race, no atomics), counted as `tc` and never `simt`, and its
    bf16 output the f32 one rounded."""
    before = dict(TG.gemm.launches)
    y = TG.gemm(x, w, e, out_dtype=torch.float32)
    again = TG.gemm(x, w, e, out_dtype=torch.float32)
    y16 = TG.gemm(x, w, e, out_dtype=torch.bfloat16)
    want = TG.plain(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert TG.variant(x.shape[0], x.dtype) == "tc"
    assert TG.gemm.launches == dict(before, tc=before["tc"] + 3, **{
        e.name: before[e.name] + 3})
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(y, again)
    assert torch.equal(y16, y.to(torch.bfloat16))
    if mask is not None:
        assert not y[:, mask == 0].any()


@pytest.mark.parametrize("layout", TC_LAYOUTS)
@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
@pytest.mark.parametrize("epi,t,bits", TC_FLOAT)
def test_tc_float_weight_epilogues_match_plain(cuda, epi, t, bits, shape,
                                               layout):
    M, K, N = shape
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = _operand((M, K), layout.startswith("x.T"), gen)
    w = _operand((K, N), layout.endswith("w.T"), gen, K ** -0.5)
    mask = (torch.arange(N, device=cuda) % 3 > 0).float()
    qp = init_quant_params(w.float(), bits=bits, t=t)
    e = {"none": TG.none(), "col_mask": TG.col_mask(mask),
         "fake_quant_rhs": TG.fake_quant_rhs(qp.d, qp.q_m, qp.t),
         "fq_col_mask": TG.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[epi]
    _tc_check(x, w, e, mask if "mask" in epi else None)


@pytest.mark.parametrize("layout", TC_LAYOUTS)
@pytest.mark.parametrize("shape", [(512, 2048, 1024), (296, 200, 144)],
                         ids=str)
@pytest.mark.parametrize("epi", ["none", "col_mask", "fake_quant_rhs"])
def test_tc_f32_weights_match_plain(cuda, epi, shape, layout):
    """f32 weights with bf16 x: fake-quant codes and raw f32 weights (24
    significand bits, the third bf16 piece) split exactly."""
    M, K, N = shape
    gen = torch.Generator(device=cuda).manual_seed(M + K + N + 1)
    x = _operand((M, K), layout.startswith("x.T"), gen)
    w = _operand((K, N), layout.endswith("w.T"), gen, K ** -0.5,
                 torch.float32)
    mask = (torch.arange(N, device=cuda) % 3 > 0).float()
    qp = init_quant_params(w, bits=12.0, t=0.85)
    e = {"none": TG.none(), "col_mask": TG.col_mask(mask),
         "fake_quant_rhs": TG.fake_quant_rhs(qp.d, qp.q_m, qp.t)}[epi]
    _tc_check(x, w, e, mask if epi == "col_mask" else None)


@pytest.mark.parametrize("x_t", [False, True], ids=["x", "x.T"])
@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
@pytest.mark.parametrize("codes", ["int8_b8", "int16_b12", "int32_b20",
                                   "unpack_b2", "unpack_b3", "unpack_b4",
                                   "unpack_b8"])
def test_tc_code_epilogues_match_plain(cuda, codes, shape, x_t):
    M, K, N = shape
    gen = torch.Generator(device=cuda).manual_seed(M + K + N + 2)
    x = _operand((M, K), x_t, gen)
    w = torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5
    bits = int(codes.split("_b")[1])
    q, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                        bits=float(bits))
    scale = d * (1.0 + (torch.arange(N, device=cuda) % 7 == 0) * 0.5)
    if codes.startswith("int"):
        store = q.to({8: torch.int8, 12: torch.int16}.get(bits, torch.int32))
        _tc_check(x, store, TG.dequant(scale))
    else:
        _tc_check(x, pack_codes(q, bits, axis=0),
                  TG.unpack_dequant(bits, scale))


@pytest.mark.parametrize("x_t", [False, True], ids=["x", "x.T"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_tc_dequant_and_unpack_are_bitwise_equal(cuda, bits, x_t):
    gen = torch.Generator(device=cuda).manual_seed(bits)
    w = torch.randn((2048, 2048), generator=gen, device=cuda) * 0.02
    q, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                        bits=float(bits))
    x = _operand((512, 2048), x_t, gen)
    a = TG.gemm(x, q.to(torch.int8), TG.dequant(d))
    b = TG.gemm(x, pack_codes(q, bits, axis=0), TG.unpack_dequant(bits, d))
    assert torch.equal(a, b)


def test_tc_raises_on_rows_tma_cannot_take(cuda):
    x = torch.zeros((64, 100), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        TG.gemm(x, torch.zeros((100, 128), dtype=torch.bfloat16,
                               device=cuda), TG.none())


@pytest.mark.parametrize("epi", ["none", "fake_quant_rhs"])
def test_tc_launches_as_a_threads_first_cuda_call(cuda, epi):
    """The tensor-core variant encodes its TMA descriptors with
    cuTensorMapEncodeTiled, which needs the thread's context current: a
    thread whose first CUDA call it is (autograd's worker, in a backward
    that starts at a GEMM) must get the same result as the main thread."""
    import threading
    gen = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((256, 512), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((512, 256), generator=gen, device=cuda).to(torch.bfloat16)
    qp = init_quant_params(w, bits=8.0, t=0.85)
    e = {"none": TG.none(),
         "fake_quant_rhs": TG.fake_quant_rhs(qp.d, qp.q_m, qp.t)}[epi]
    want = TG.gemm(x, w, e, out_dtype=torch.float32)
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["y"] = TG.gemm(x, w, e, out_dtype=torch.float32)
            torch.cuda.synchronize()
        except Exception as err:          # reported below, in this thread
            out["err"] = err

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "err" not in out, out.get("err")
    assert torch.equal(out["y"], want)


# ------------------------------------------------ the GEMM's SIMT variant
@pytest.mark.parametrize("K,N", [(160, 96), (2048, 1024), (2048, 8192),
                                 (8192, 2048), (2000, 1028), (2001, 1028)],
                         ids=str)
@pytest.mark.parametrize("M", [37, 300, 2048])
@pytest.mark.parametrize("epi", ["none", "col_mask", "fake_quant_rhs",
                                 "fq_col_mask", "dequant", "unpack_b3"])
def test_simt_f32_x_matches_plain(cuda, epi, M, K, N):
    """f32 x (the f32 configuration) at M > 8 takes the SIMT variant, in
    f32 products, against the plain version at the GEMM's bound, fake-quant
    at t = 0.85; M, N and K off the 128 x 128 x 16 tile (K 2001: x's rows
    not 16-byte aligned); a second call is bitwise the first (each output
    sums its K range in one thread, in order)."""
    gen = torch.Generator(device=cuda).manual_seed(K + M + 3)
    w = torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5
    mask = (torch.arange(N, device=cuda) % 3 > 0).float()
    qp = init_quant_params(w, bits=8.0, t=0.85)
    if epi in ("dequant", "unpack_b3"):
        bits = 8 if epi == "dequant" else 3
        codes, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                                bits=float(bits))
        w, e = ((codes.to(torch.int8), TG.dequant(d)) if epi == "dequant"
                else (pack_codes(codes, 3, axis=0), TG.unpack_dequant(3, d)))
    else:
        e = {"none": TG.none(), "col_mask": TG.col_mask(mask),
             "fake_quant_rhs": TG.fake_quant_rhs(qp.d, qp.q_m, qp.t),
             "fq_col_mask": TG.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[epi]
    x = torch.randn((M, K), generator=gen, device=cuda)
    before = dict(TG.gemm.launches)
    y = TG.gemm(x, w, e, out_dtype=torch.float32)
    want = TG.plain(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert TG.variant(M, x.dtype) == "simt"
    assert TG.gemm.launches == dict(before, simt=before["simt"] + 1, **{
        e.name: before[e.name] + 1})
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(TG.gemm(x, w, e, out_dtype=torch.float32), y)
    if "mask" in epi:
        assert not y[:, mask == 0].any()

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
The engine's decode windows replay CUDA graphs captured in `warmup()`:
their tokens equal repeated eager `step()` in every weight mode over the
contiguous arena and f32, int8 and int4 pages, also after the page table
changes; every window length is captured once, in `warmup()`, none in
`run()`; a window body that reads the device from the host makes the
capture raise, with no eager fallback. `attention_blockwise` on the card
agrees with `attention_dense` at 1e-5 (f32).

The widths pruning leaves (`test_pruned_*`): every GEMM variant and
epilogue at N % 4 = 1, 2, 3 and at K whose rows are not 16-byte
multiples, the full-width pruned shapes (2048, 5734), (5734, 2048) and
(2048, 5733), on weights as `materialize` leaves them and as
`prepare_serving` stores them (rows padded to 16 bytes), at the GEMM's
bound of the plain version, repeats bitwise, bf16 output the f32 rounded,
dequant bitwise unpack_dequant, one GEMM kernel a call (plus the counted
copy of an x whose rows TMA cannot take). The smoke config's pruned
engine (f32) emits its masked reference's tokens and the CPU run's at
sparsity 0.5 and 0.3, its graph windows eager `step()`'s, its paged
arena the contiguous one's.

Speculative decoding and chunked prefill (`test_spec_*`, `test_chunked_*`,
`test_verify_heights_*`): the tensor-core GEMM at the verify heights M =
12, 20, 36 (bf16 x, every serving epilogue, the pruned widths) within the
GEMM's bound of the plain version and bitwise on a repeat; the smoke
config (f32) speculative engine's tokens equal the plain engine's on the
card and the CPU run's, for a faithful and an aggressive draft; its
graph-replayed rounds equal eager rounds bit for bit (contiguous, f32
and int8 pages), with the rollback invariant after every eager round
(rows at and past each active slot's position zero in both arenas);
`warmup()` captures exactly `len(_spec_ks())` graphs and a drain none;
paged speculative (unquantized pages) equals contiguous; chunked tokens
equal one-shot tokens on the card (whose decode replays the one-step
window) and the CPU run's.

The run loop and the paper's substrates (`test_fake_quant_kernels_at_cnn_
shapes`, `test_kill_and_resume_*`, `test_substrate_*`): the fake-quant
kernels at VGG7's f32 conv-weight and activation shapes (bitwise, one
kernel a call); the smoke config's checkpointed loop killed and resumed
on the card, bitwise the clean run; the reduced CNNs' and BERT's loss
and gradients card vs CPU (TF32 off) and their joint QASSO update from
shared gradients at `STEP_TOLERANCES`, d where Eq 17 is well-conditioned.

The MoE family (`test_moe_*`, `test_fake_quant_past_2_31_*`): the grok-1
and llama4 smoke engines (f32, dense and int8) emit the CPU run's tokens
on the card; llama4's speculative engine with its MoE draft the plain
engine's and the CPU run's; grok's smoke GETA step (momentum) card vs CPU
at `STEP_TOLERANCES`, d where Eq 17 is well-conditioned; the fake-quant
kernels on a bf16 tensor of more than 2^31 elements, piece by piece
bitwise their plain versions.

The recurrent mixers (`test_recurrent_*`): the rwkv6 and jamba smoke
engines (f32, dense and int8, contiguous and paged without prefix
sharing, a slot re-admitted after another occupant) emit the CPU run's
tokens on the card; rwkv6's smoke GETA step card vs CPU at
`STEP_TOLERANCES`, d where Eq 17 is well-conditioned, bitwise on a
repeat; the small-M and tensor-core GEMMs at the mixers' shapes (K = 8,
64, 512 with x a strided view, 11469; N = 8, 64, 544), and f32 x on bf16
weights (rwkv6's decay LoRA), within the GEMM's bound of the plain
version.

The last LM families (`test_frontend_*`, `test_codebook_*`,
`test_vision_*`, `test_window_engine_*`): decode attention at musicgen's
MHA (KVh 32, g 1, dh 64) and on a 256-row ring at positions past its end
against the plain version and the split mirror (a wrapped ring bitwise
the full ring); musicgen's smoke `serve_loop` frames, internvl2's vision
prefill + decode tokens and the window-8 engine's tokens past the wrap
(graph windows and eager `step()`) on the card equal to the CPU run's
(f32, one CPU-drawn model).
Launch introspection and the tuner (`test_introspect_*`,
`test_autotune_*`): for every kernel instantiation chip_smoke.py's
phases 5 and 7 launch, the launch record's shared bytes equal the card's
`sharedSizeBytes` plus the dynamic bytes its launcher opts into, its
`numRegs` the card's, within Hopper's budget; `autotune_gemm`'s winner is
the next call's plan, a tuned tensor-core call bitwise the untuned one, a
tuned small-M call within the GEMM's bound of the plain version, bitwise
on a repeat, bitwise unpack_dequant b8 on the same codes and bitwise a
column half called with plan_n = N; the table reloads from its file.
Every profiler trace opens with 64 int16 fill kernels that no count
includes (`_traced_kernels`): a trace now and then loses the session's
first kernels.
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
from repro_torch.core.subnet import masked_reference_params, prepare_serving
from repro_torch.launch.engine import (WEIGHT_MODES, Engine, build_engine,
                                       engine_serve, serve_on_devices)
from repro_torch.models import layers as TL

pytestmark = pytest.mark.gpu
EPILOGUES = ["fake_quant_rhs", "dequant", "unpack_b2", "unpack_b3",
             "unpack_b4", "unpack_b8"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the repro_torch kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False     # the CNNs' convolutions
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


# fill kernels that open every trace: a trace on the H100 now and then
# loses the session's first kernels, and these are the ones it loses; no
# count includes them (an int16 fill: no wrapper under test launches one)
TRACE_WARMUP = 64
FILL_KERNEL = "FillFunctor<short>"


def _traced_kernels(fn) -> list[str]:
    """The device kernels of one call of `fn` under a torch.profiler trace
    that opens with TRACE_WARMUP fill kernels, which are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    fill = torch.zeros(1, dtype=torch.int16, device="cuda")
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACE_WARMUP):
            fill.fill_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.events()
            if e.device_type == cuda and FILL_KERNEL not in e.key]


def _device_kernels(fn) -> list[str]:
    """The names of the device kernels one call of `fn` runs, from a
    torch.profiler trace of a call after a first one outside it. A trace
    that recorded no device event at all (a short session now and then
    comes back empty on the H100) is taken again, up to eight times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        names = _traced_kernels(fn)
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


@pytest.mark.parametrize("g", [6, 8])
@pytest.mark.parametrize("kind", ["contiguous", "bfloat16", "int8", "int4"])
def test_decode_kernels_at_full_head_width_and_wide_groups(cuda, kind, g):
    """grok-1's decode: KVh 8, g 6 (48 query heads), dh 128, and g 8 at
    the same width: the split kernel's shared memory (its static arrays
    beside 44-48 KB of dynamic rows and partials) passes 48 KB, which a
    launch takes only after opting in."""
    gen = torch.Generator(device=cuda).manual_seed(1000 + g)
    S = 576
    pos = _edge_pos(S, cuda)
    if kind == "contiguous":
        q, k, v = _contiguous(gen, pos.numel(), S, torch.bfloat16, KVh=8,
                              g=g, dh=128)
        got = TDA.decode_attn(q, k, v, pos)
        plain = ref.decode_attn_ref(q, k, v, pos)
        mirror = ref.decode_attn_split_ref(q, k, v, pos, R)
    else:
        q, kp, vp, pos, table, kw = _paged(kind, gen, B=pos.numel(),
                                           seq_len=S, KVh=8, g=g, dh=128,
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
    """Rows TMA cannot take (x's 200 bytes) raised before the GEMM took
    the widths pruning leaves; now x is copied into 16-byte rows, counted
    once, and the call matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    x = torch.randn((64, 100), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((100, 128), generator=gen, device=cuda).to(torch.bfloat16)
    before = TG.gemm.launches["copies"]
    y = TG.gemm(x, w, TG.none(), out_dtype=torch.float32)
    want = TG.plain(x, w, TG.none(), torch.float32)
    torch.cuda.synchronize()
    assert TG.gemm.launches["copies"] == before + 1
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


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


# ------------------------------------------------------ graph decode windows
ARENAS = {"contiguous": {}, "paged": dict(paged=True, page_size=8),
          "paged_int8": dict(paged=True, page_size=8, kv_bits=8),
          "paged_int4": dict(paged=True, page_size=8, kv_bits=4)}
LENS, GENS = (5, 9, 3, 12, 7, 9), (9, 5, 12, 3, 7, 17)


def _card_engine(mode, arena, **kw):
    eng, lm = build_engine("internlm2-1.8b", True, max_slots=2, max_seq=32,
                           device="cuda", **WEIGHT_MODES[mode],
                           **ARENAS[arena], **kw)
    return eng, lm


def _prompts(lm, repeat=False):
    rng = np.random.default_rng(7)
    out = [rng.integers(0, lm.cfg.vocab, n).astype(np.int32) for n in LENS]
    if repeat:          # requests 3 and 5 on request 1's prompt
        out[3], out[5] = out[1].copy(), out[1].copy()
    return out


def _captures(monkeypatch) -> list:
    """Every CUDA graph capture from here on, as it enters."""
    seen = []
    enter = torch.cuda.graph.__enter__

    def spy(self):
        seen.append(self)
        return enter(self)

    monkeypatch.setattr(torch.cuda.graph, "__enter__", spy)
    return seen


@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("mode", list(WEIGHT_MODES))
def test_graph_windows_match_eager_steps(cuda, monkeypatch, mode, arena):
    """Six requests on two slots, budgets that make windows of 16, 8, 4,
    2 and 1 steps across admissions and evictions: the replayed windows
    emit the tokens of repeated eager `step()` on an engine of the same
    weights. Every window length is captured once, in `warmup()`; `run()`
    captures nothing."""
    captures = _captures(monkeypatch)
    eng, lm = _card_engine(mode, arena)
    ref, _ = _card_engine(mode, arena)
    prompts = _prompts(lm)
    for e in (eng, ref):
        for p, g in zip(prompts, GENS):
            e.submit(p, g)
    eng.warmup()
    ks = eng.warmed_window_ks()
    assert len(captures) == len(ks) and sorted(eng.graphs) == ks
    got = eng.run()
    assert len(captures) == len(ks)
    want = ref._drain(ref.step)
    assert sorted(got) == sorted(want) == list(range(len(LENS)))
    for rid in want:
        assert len(got[rid]) == GENS[rid]
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")
    assert len(eng.replays) >= 4 and not ref.replays
    # a second warmup captures nothing more
    eng.warmup()
    assert len(captures) == len(ks)


@pytest.mark.parametrize("arena", ["paged", "paged_int4"])
def test_graph_replays_follow_page_table_changes(cuda, arena):
    """A paged engine serves two batches in turn: the second's admissions
    land on other pages (the first's were freed and zeroed) and three of
    its requests share one prompt's pages through the prefix cache. Every
    replay reads the table staged for it: the tokens equal eager steps'."""
    eng, lm = _card_engine("compressed", arena)
    ref, _ = _card_engine("compressed", arena)
    eng.warmup()
    for batch in (_prompts(lm), _prompts(lm, repeat=True)):
        for e in (eng, ref):
            for p, g in zip(batch, GENS):
                e.submit(p, g)
        got, want = eng.run(), ref._drain(ref.step)
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid],
                                          err_msg=f"request {rid}")
    assert eng.stats["prefix_hits"] == ref.stats["prefix_hits"] >= 2


def test_window_body_with_a_host_sync_makes_capture_raise(cuda):
    """A host read inside the window body is refused by the capture, which
    raises out of `warmup()`; `run()` then raises for the missing graph
    instead of decoding eagerly."""
    eng, lm = _card_engine("compressed", "contiguous")
    decode = eng._decode

    def reads_the_device(tok, pos, pages):
        nxt = decode(tok, pos, pages)
        int(nxt[0])                  # a device -> host copy and a sync
        return nxt

    eng._decode = reads_the_device
    with pytest.raises(RuntimeError):
        eng.warmup()
    eng._decode = decode
    assert not eng.graphs
    eng.submit(_prompts(lm)[0], 4)
    with pytest.raises(RuntimeError, match="call warmup"):
        eng.run()


def test_run_without_warmup_raises_on_card(cuda):
    eng, lm = _card_engine("dense", "contiguous")
    eng.submit(_prompts(lm)[0], 4)
    with pytest.raises(RuntimeError, match="call warmup"):
        eng.run()


def test_graph_launch_accounting(cuda):
    """Each graph's host launch counts are those of k eager steps, and the
    replays' launches are the sum over the windows run."""
    eng, lm = _card_engine("compressed", "contiguous")
    eng.warmup()
    one = eng.graph_launches[1]
    assert one["gemm_core.dequant"] > 0 and one["decode_attn"] > 0
    for k in eng.warmed_window_ks():
        assert eng.graph_launches[k] == {n: k * c for n, c in one.items()}
    for p, g in zip(_prompts(lm), GENS):
        eng.submit(p, g)
    eng.run()
    steps = sum(k * n for k, n in eng.replays.items())
    assert steps == eng.stats["decode_steps"]
    assert eng.graph_device_launches() == {n: steps * c
                                           for n, c in one.items()}


@pytest.mark.parametrize("S,block", [(4096, 512), (96, 32)])
def test_attention_blockwise_on_card_matches_dense(cuda, S, block):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, S, 16, 128), generator=gen, device=cuda)
    k, v = (torch.randn((1, S, 8, 128), generator=gen, device=cuda)
            for _ in range(2))
    got = TL.attention_blockwise(q, k, v, block=block)
    want = TL.attention_dense(q, k, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if S <= 96:
        g = torch.randn(q.shape, generator=gen, device=cuda)
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        a = torch.autograd.grad(
            (TL.attention_blockwise(*ts, block=block) * g).sum(), ts)
        b = torch.autograd.grad((TL.attention_dense(*ts) * g).sum(), ts)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_rope_frequencies_are_kept_out_of_the_captured_step(cuda):
    """`rope_freqs` builds theta on the card with a synchronous copy, which
    a capture refuses; the decode step reads the LM's kept tensor instead,
    the same bits as a fresh computation."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import LM
    dev = torch.device("cuda", torch.cuda.current_device())
    lm = LM(get_arch("internlm2-1.8b"))
    kept = lm._rope_freqs(dev)
    assert torch.equal(kept, TL.rope_freqs(128, lm.cfg.rope_theta, dev))
    stream = torch.cuda.Stream()
    with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
        again = lm._rope_freqs(dev)           # kept: no copy
    assert again is kept
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            TL.rope_freqs(128, lm.cfg.rope_theta, dev)


# ------------------------------------------------ the widths pruning leaves
# full width at sparsity 0.3: w_gate / w_up 2048 -> 5734 (N % 4 = 2; bf16
# rows 11468 bytes), w_down 5734 -> 2048 (x's rows 11468 bytes), and the
# odd neighbour 5733 (rows 2-byte, int8 1-byte aligned)
PRUNED_SHAPES = [(2048, 5734), (5734, 2048), (2048, 5733)]
# (label, M, x dtype): small-M at decode M, tensor-core prefill, SIMT f32
PRUNED_CALLS = [("small_m", 1, torch.bfloat16), ("small_m", 4, torch.bfloat16),
                ("small_m", 8, torch.bfloat16), ("tc", 512, torch.bfloat16),
                ("simt", 64, torch.float32)]
PRUNED_EPIS = ["none", "col_mask", "fake_quant_rhs", "fq_col_mask",
               "dequant", "unpack_b2", "unpack_b3", "unpack_b4", "unpack_b8"]


def _pruned_operands(epi, K, N, w_dtype, gen):
    """(weight, epilogue, mask) on the card at (K, N), contiguous as
    `materialize` leaves it; quantizers at their init, t = 0.85 for the
    float epilogues (a powf per weight)."""
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    mask = (torch.arange(N, device="cuda") % 3 > 0).float()
    if epi in ("none", "col_mask", "fake_quant_rhs", "fq_col_mask"):
        qp = init_quant_params(w, bits=8.0, t=0.85)
        e = {"none": TG.none(), "col_mask": TG.col_mask(mask),
             "fake_quant_rhs": TG.fake_quant_rhs(qp.d, qp.q_m, qp.t),
             "fq_col_mask": TG.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[epi]
        return w.to(w_dtype), e, mask if "mask" in epi else None
    bits = 8 if epi == "dequant" else int(epi[-1])
    codes, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                            bits=float(bits))
    scale = d * (1.0 + (torch.arange(N, device="cuda") % 7 == 0) * 0.5)
    if epi == "dequant":
        return codes.to(torch.int8), TG.dequant(scale), None
    return pack_codes(codes, bits, axis=0), TG.unpack_dequant(bits,
                                                              scale), None


@pytest.mark.parametrize("store", ["contiguous", "aligned_rows"])
@pytest.mark.parametrize("epi", PRUNED_EPIS)
@pytest.mark.parametrize("call", PRUNED_CALLS, ids=lambda c: f"{c[0]}{c[1]}")
@pytest.mark.parametrize("K,N", PRUNED_SHAPES, ids=str)
def test_pruned_widths_match_plain(cuda, K, N, call, epi, store):
    """Every variant and epilogue at the pruned widths: within the GEMM's
    bound of the plain version, a second call bitwise the first, the bf16
    output the f32 one rounded, masked columns exactly zero; counted as
    one launch of its variant, plus the same operand copies each call
    (none of a weight stored with `aligned_rows`)."""
    label, M, x_dtype = call
    gen = torch.Generator(device=cuda).manual_seed(K + N + M)
    w_dtype = torch.float32 if label == "simt" else torch.bfloat16
    w, e, mask = _pruned_operands(epi, K, N, w_dtype, gen)
    if store == "aligned_rows":
        w = TG.aligned_rows(w)
    x = torch.randn((M, K), generator=gen, device=cuda).to(x_dtype)
    assert TG.variant(M, x_dtype) == label
    before = dict(TG.gemm.launches)
    y = TG.gemm(x, w, e, out_dtype=torch.float32)
    copies = TG.gemm.launches["copies"] - before["copies"]
    again = TG.gemm(x, w, e, out_dtype=torch.float32)
    y16 = TG.gemm(x, w, e, out_dtype=torch.bfloat16)
    want = TG.plain(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert TG.gemm.launches == dict(before, **{
        e.name: before[e.name] + 3, label: before[label] + 3,
        "copies": before["copies"] + 3 * copies})
    x_copy = label == "tc" and (K * 2) % 16 != 0
    assert copies == x_copy + (store == "contiguous" and (
        (N * w.element_size()) % 16 if label == "tc" else N % 4) != 0)
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(y, again)
    assert torch.equal(y16, y.to(torch.bfloat16))
    if mask is not None:
        assert not y[:, mask == 0].any()


@pytest.mark.parametrize("store", ["contiguous", "aligned_rows"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("call", PRUNED_CALLS, ids=lambda c: f"{c[0]}{c[1]}")
@pytest.mark.parametrize("K,N", PRUNED_SHAPES, ids=str)
def test_pruned_widths_dequant_and_unpack_are_bitwise_equal(cuda, K, N, call,
                                                            bits, store):
    """Packed serving's token contract at the pruned widths: int8 codes and
    packed words (each stored as materialize leaves it, or with padded
    rows) sum the same codes in the same order."""
    _, M, x_dtype = call
    gen = torch.Generator(device=cuda).manual_seed(K + N + bits)
    w = torch.randn((K, N), generator=gen, device=cuda) * 0.02
    codes, d = quantize_int(w, init_quant_params(w, bits=float(bits)),
                            bits=float(bits))
    scale = d * (1.0 + (torch.arange(N, device=cuda) % 7 == 0) * 0.5)
    c8, words = codes.to(torch.int8), pack_codes(codes, bits, axis=0)
    if store == "aligned_rows":
        c8, words = TG.aligned_rows(c8), TG.aligned_rows(words)
    x = torch.randn((M, K), generator=gen, device=cuda).to(x_dtype)
    assert torch.equal(TG.gemm(x, c8, TG.dequant(scale)),
                       TG.gemm(x, words, TG.unpack_dequant(bits, scale)))


@pytest.mark.parametrize("K,N", PRUNED_SHAPES, ids=str)
def test_pruned_widths_are_one_gemm_kernel_per_call(cuda, K, N):
    """One profiler trace of one call per variant and epilogue
    (fake_quant_rhs, dequant, unpack b4) at a pruned width, weights stored
    as `prepare_serving` leaves them: one GEMM kernel of the call's variant
    per call, plus one copy kernel per copy the wrapper counted (the
    tensor-core variant's x with rows TMA cannot take: K = 5734), and no
    other kernel."""
    gen = torch.Generator(device=cuda).manual_seed(K + N + 1)
    calls, copies = [], 0
    for label, M, x_dtype in PRUNED_CALLS:
        w_dtype = torch.float32 if label == "simt" else torch.bfloat16
        x = torch.randn((M, K), generator=gen, device=cuda).to(x_dtype)
        for epi in ("fake_quant_rhs", "dequant", "unpack_b4"):
            w, e, _ = _pruned_operands(epi, K, N, w_dtype, gen)
            calls.append((label, x, TG.aligned_rows(w), e))
            copies += label == "tc" and (K * 2) % 16 != 0
    run = lambda: [TG.gemm(x, w, e) for _, x, w, e in calls]
    run()
    torch.cuda.synchronize()
    want = len(calls) + copies
    # a trace may lose device events on the H100 (an empty or a short
    # trace, the session's first kernels: the fill kernels that open it
    # take that loss), never add one: more kernels than expected fail at
    # once, a short trace is taken again, up to eight times
    for _ in range(8):
        before = TG.gemm.launches["copies"]
        names = _traced_kernels(run)
        assert TG.gemm.launches["copies"] - before == copies
        assert len(names) <= want, names
        if len(names) == want:
            break
    kernel = {"small_m": "gemm_small_m", "tc": "gemm_tc",
              "simt": "gemm_general"}
    gemms = [n for n in names if "gemm_" in n]
    assert len(gemms) == len(calls) and len(names) == want, names
    for label in kernel:
        assert sum(kernel[label] in n for n in gemms) == sum(
            c[0] == label for c in calls), (label, gemms)


def _pruned_tokens(dev, params, sparsity, mode, masked=False, **engine_kw):
    """The smoke config's pruned engine (or, `masked`, its masked dense
    reference) on `dev`, from CPU-drawn params moved there."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import LM
    lm = LM(get_arch("internlm2-1.8b", smoke=True))
    p = {k: v.to(dev) for k, v in params.items()}
    if masked:
        p, q = masked_reference_params(lm, p, sparsity)
    else:
        p, q, _ = prepare_serving(lm, p, prune_sparsity=sparsity,
                                  **WEIGHT_MODES[mode])
    eng = Engine(lm, p, q, max_slots=2, max_seq=24, **engine_kw)
    for n, g in zip((6, 3, 9, 12), (6, 9, 4, 8)):
        eng.submit(np.arange(n, dtype=np.int32) * 7 % 500, g)
    eng.warmup()
    return eng.run()


@pytest.mark.parametrize("mode", ["dense", "compressed"])
@pytest.mark.parametrize("sparsity", [0.5, 0.3])
def test_pruned_engine_on_card_matches_masked_reference_and_cpu(
        cuda, sparsity, mode):
    """The smoke config (f32) pruned on the card: tokens equal its masked
    dense reference's on the card and the CPU run's, at the aligned 0.5
    and the ragged 0.3 (d_ff 179)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import LM
    params = LM(get_arch("internlm2-1.8b", smoke=True)).init(
        torch.Generator().manual_seed(0))
    got = _pruned_tokens("cuda", params, sparsity, mode)
    for want in (_pruned_tokens("cuda", params, sparsity, mode, masked=True),
                 _pruned_tokens("cpu", params, sparsity, mode)):
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid],
                                          err_msg=f"request {rid}")


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", list(WEIGHT_MODES))
def test_pruned_graph_windows_match_eager_steps(cuda, monkeypatch, mode,
                                                arena):
    """At the ragged sparsity 0.3 the replayed windows emit repeated eager
    `step()`'s tokens; windows are captured in `warmup()` only, the same
    lengths as an unpruned engine's; the paged arena's tokens equal the
    contiguous arena's."""
    captures = _captures(monkeypatch)
    kw = dict(pruned=True, sparsity=0.3)
    eng, lm = _card_engine(mode, arena, **kw)
    ref, _ = _card_engine(mode, arena, **kw)
    prompts = _prompts(lm)
    for e in (eng, ref):
        for p, g in zip(prompts, GENS):
            e.submit(p, g)
    eng.warmup()
    ks = eng.warmed_window_ks()
    assert len(captures) == len(ks) and sorted(eng.graphs) == ks
    got = eng.run()
    assert len(captures) == len(ks)
    want = ref._drain(ref.step)
    assert sorted(got) == sorted(want) == list(range(len(LENS)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")
    if arena == "paged":
        contiguous, _ = _card_engine(mode, "contiguous", **kw)
        for p, g in zip(prompts, GENS):
            contiguous.submit(p, g)
        contiguous.warmup()
        flat = contiguous.run()
        for rid in flat:
            np.testing.assert_array_equal(got[rid], flat[rid])


# ------------------------------------- speculative decoding, chunked prefill
VERIFY_MS = [12, 20, 36]          # 4 slots x (k + 1) at k = 2, 4, 8


@pytest.mark.parametrize("epi", ["fake_quant_rhs", "dequant", "unpack_b4",
                                 "unpack_b2"])
@pytest.mark.parametrize("M", VERIFY_MS)
@pytest.mark.parametrize("K,N", PRUNED_SHAPES + [(2048, 8192), (2048, 2048),
                                                (2048, 1024)], ids=str)
def test_verify_heights_tc_match_plain(cuda, K, N, M, epi):
    """The verify pass's heights take the tensor-core variant (a 128-row
    block mostly past M): within the GEMM's bound of the plain version,
    bitwise on a repeat, rows past M never written (the output has M)."""
    gen = torch.Generator(device=cuda).manual_seed(K + N + M)
    w, e, _ = _pruned_operands(epi, K, N, torch.bfloat16, gen)
    w = TG.aligned_rows(w)
    x = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    assert TG.variant(M, x.dtype) == "tc"
    y = TG.gemm(x, w, e, out_dtype=torch.float32)
    again = TG.gemm(x, w, e, out_dtype=torch.float32)
    want = TG.plain(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert y.shape == (M, N)
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(y, again)


SPEC_DRAFTS = {"faithful": dict(draft_sparsity=0.0, draft_bits=8.0),
               "aggressive": dict(draft_sparsity=0.5, draft_bits=2.0)}


@pytest.mark.parametrize("draft", list(SPEC_DRAFTS))
@pytest.mark.parametrize("mode", ["dense", "compressed"])
def test_spec_smoke_on_card_matches_plain_and_cpu(cuda, mode, draft):
    """The smoke config (f32) speculative engine on the card: its tokens
    equal the plain engine's on the card and its own CPU run's."""
    kw = dict(WEIGHT_MODES[mode], speculative=True, draft_k=4,
              **SPEC_DRAFTS[draft])
    got = serve_on_devices("internlm2-1.8b", True, [6, 3, 9, 12], 8,
                           ["cuda", "cpu"], max_slots=2, **kw)
    plain = serve_on_devices("internlm2-1.8b", True, [6, 3, 9, 12], 8,
                             ["cuda"], max_slots=2, **WEIGHT_MODES[mode])
    for want in (got["cpu"], plain["cuda"]):
        assert sorted(got["cuda"]) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got["cuda"][rid], want[rid],
                                          err_msg=f"request {rid}")


def _spec_never_drafted(eng) -> None:
    """Rows at and past each active slot's position are zero in both
    arenas (gathered from the pools when paged)."""
    arenas = [eng.caches, eng.dcaches]
    if eng.paged:
        eng._stage()
        arenas = [eng._gather(a) for a in arenas]
    for slot, req in enumerate(eng.active):
        if req is None:
            continue
        pos = int(eng.pos[slot])
        assert pos == req.prompt.size + len(req.tokens) - 1
        for arena in arenas:
            for c in arena.values():
                assert not torch.any(c[:, slot, pos:]), (slot, pos)


@pytest.mark.parametrize("arena", ["contiguous", "paged", "paged_int8"])
def test_spec_graph_rounds_match_eager_rounds(cuda, monkeypatch, arena):
    """The replayed rounds emit the tokens of eager rounds (bit for bit:
    the same kernels on the same inputs) on an engine of the same
    weights, whose every round keeps the never-drafted state; `warmup()`
    captures one graph per draft length of `_spec_ks()`, the drain none,
    and a second warm-up nothing more; every round ran a captured k."""
    captures = _captures(monkeypatch)
    kw = dict(speculative=True, draft_k=4, **SPEC_DRAFTS["aggressive"])
    eng, lm = _card_engine("compressed", arena, **kw)
    ref, _ = _card_engine("compressed", arena, **kw)
    prompts = _prompts(lm)
    for e in (eng, ref):
        for p, g in zip(prompts, GENS):
            e.submit(p, g)
    eng.warmup()
    ks = eng._spec_ks()
    assert len(captures) == len(ks) and sorted(eng.graphs) == ks
    got = eng.run()
    assert len(captures) == len(ks)
    while ref.pending:
        ref.eager_step()
        _spec_never_drafted(ref)
    want = ref._drain(ref.eager_step)
    assert sorted(got) == sorted(want) == list(range(len(LENS)))
    for rid in want:
        assert len(got[rid]) == GENS[rid]
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")
    assert sum(eng.replays.values()) == eng.stats["spec_steps"] > 0
    assert not ref.replays
    eng.warmup()
    assert len(captures) == len(ks)


def test_spec_run_without_warmup_raises_on_card(cuda):
    eng, lm = _card_engine("dense", "contiguous", speculative=True)
    eng.submit(_prompts(lm)[0], 4)
    with pytest.raises(RuntimeError, match="call warmup"):
        eng.run()


@pytest.mark.parametrize("draft", list(SPEC_DRAFTS))
def test_spec_paged_matches_contiguous_on_card(cuda, draft):
    """Paged speculative rounds (unquantized pages) run on gathered views
    of the contiguous arena's shape: the tokens equal the contiguous
    speculative engine's, and the plain engine's."""
    kw = dict(speculative=True, draft_k=4, **SPEC_DRAFTS[draft])
    outs = []
    for arena, extra in (("paged", kw), ("contiguous", kw),
                         ("contiguous", {})):
        eng, lm = _card_engine("dense", arena, **extra)
        for p, g in zip(_prompts(lm, repeat=True), GENS):
            eng.submit(p, g)
        eng.warmup()
        outs.append(eng.run())
    for want in outs[1:]:
        for rid in want:
            np.testing.assert_array_equal(outs[0][rid], want[rid],
                                          err_msg=f"request {rid}")


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["dense", "packed_b4"])
def test_chunked_prefill_on_card_matches_one_shot_and_cpu(cuda, mode,
                                                          arena):
    """Chunked prefill (chunks of 8 rows, f32: the SIMT GEMM, and their
    power-of-two tails: the small-M GEMM) on the card: tokens equal the
    one-shot engine's on the card and the chunked engine's on the CPU
    (CPU-drawn weights on both devices); its decode replays the one-step
    window captured in `warmup()`."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.scheduler import ChunkedPrefillScheduler
    from repro_torch.models.transformer import LM
    lm = LM(get_arch("internlm2-1.8b", smoke=True))
    base = lm.init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cuda", "cpu"):
        params, qparams, _ = prepare_serving(
            lm, {k: v.to(dev) for k, v in base.items()}, **WEIGHT_MODES[mode])
        for chunk in (8, None):
            eng = Engine(lm, params, qparams, max_slots=2, max_seq=32,
                         scheduler=(ChunkedPrefillScheduler(chunk) if chunk
                                    else None), **ARENAS[arena])
            for p, g in zip(_prompts(lm), GENS):
                eng.submit(p, g)
            eng.warmup()
            runs[dev, chunk] = eng.run()
            if dev == "cuda" and chunk:
                assert sorted(eng.graphs) == [1]
                assert eng.replays[1] == eng.stats["decode_steps"] > 0
                assert eng.stats["decode_steps_mid_prefill"] > 0
    got = runs["cuda", 8]
    for key in (("cuda", None), ("cpu", 8), ("cpu", None)):
        for rid in runs[key]:
            np.testing.assert_array_equal(got[rid], runs[key][rid],
                                          err_msg=f"{key} request {rid}")


# ------------------------------------------------ the run loop and the
# paper's substrates (CNN, BERT)
CNN_FQ_SHAPES = [(3, 3, 512, 512), (64, 32, 32, 128)]


@pytest.mark.parametrize("t", [1.0, 0.85])
@pytest.mark.parametrize("shape", CNN_FQ_SHAPES, ids=str)
def test_fake_quant_kernels_at_cnn_shapes(cuda, shape, t):
    """The fake-quant kernels at the CNN's shapes in f32: VGG7's largest
    conv weight (HWIO) and its first activation site (NHWC, a ReLU's
    output): forward and dx bitwise the plain versions', the three sums
    within 1e-5 of the sum of their terms' magnitudes and bitwise on a
    repeat, one kernel a call."""
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    x = torch.randn(shape, generator=gen, device=cuda) * shape[0] ** -0.5
    if shape[0] == 64:
        x = torch.relu(x)
    g = torch.randn(shape, generator=gen, device=cuda) * 1e-3
    qp = init_quant_params(q_m=x.abs().max() * 0.9, bits=8.0, t=t)
    sc = (qp.d, qp.q_m, qp.t)
    assert torch.equal(TFQ.fake_quant_fwd(x, *sc), ref.fake_quant_fwd_ref(
        x, *sc))
    got = TFQ.fake_quant_bwd(x, *sc, g)
    want = ref.fake_quant_bwd_ref(x, *sc, g)
    assert torch.equal(got[0], want[0])
    for a, b, scale in zip(got[1:], want[1:], TFQ.sum_scales(x, g, *sc)):
        assert abs(float(a) - float(b)) <= 1e-5 * scale
    again = TFQ.fake_quant_bwd(x, *sc, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for fn in (lambda: TFQ.fake_quant_fwd(x, *sc),
               lambda: TFQ.fake_quant_bwd(x, *sc, g)):
        names = _device_kernels(fn)
        assert len(names) == 1 and "fq_" in names[0], names


def test_kill_and_resume_is_bitwise_on_card(cuda, tmp_path):
    """The smoke config's checkpointed loop on the card: 10 steps, a
    checkpoint every 5, a failure at 7; the final tree equals the
    uninterrupted run's bit for bit, every tensor back on its device
    (params and moments on the card, gamma and the data key on the
    CPU)."""
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.launch import train as T
    kw = dict(smoke=True, batch=2, seq=16, verbose=False, device="cuda")
    clean, _, _, want = T.train_loop("internlm2-1.8b", steps=10, **kw)
    report = {}
    killed, _, _, losses = T.train_loop(
        "internlm2-1.8b", steps=10, ckpt_dir=str(tmp_path),
        checkpoint_every=5, inject_failure_at=7, report=report, **kw)
    assert losses == want[:7] + want[5:]
    assert report["run_result"].restarts == 1
    (la, sa), (lb, sb) = tree_flatten(clean), tree_flatten(killed)
    assert sa == sb
    for a, b in zip(la, lb):
        if isinstance(a, torch.Tensor):
            assert a.device == b.device and a.dtype == b.dtype
            assert torch.equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    assert killed["params"]["embed"].is_cuda
    assert not killed["qstate"].gamma.is_cuda and not killed["rng"].is_cuda


def _substrate(name):
    """(model, act_quant, bits, batch on the CPU) of a reduced substrate:
    VGG7 and ResNet20 at `benchmarks/geta_experiments.py`'s reduced
    widths on 8 images (vgg7-r-act with activation quantizers at 6
    bits), the reduced BERT encoder on 8 x 64 tokens."""
    from repro_torch.data.synthetic import image_batch, qa_batch
    from repro_torch.models import bert, cnn
    if name == "bert-r":
        m = bert.BertEncoder(n_layers=2, d_model=64, n_heads=4, d_ff=256,
                             vocab=512, max_seq=64)
        return m, False, 8.0, qa_batch(0, 0, 8, 64, m.V)
    spec = (cnn.CNNSpec("vgg7-r", "vgg", [16, 16, 32, 32, 64, 64],
                        fc_dim=128) if name.startswith("vgg7")
            else cnn.CNNSpec("resnet20-r", "resnet", [8, 16, 32],
                             blocks_per_stage=2))
    act = name == "vgg7-r-act"
    return cnn.CNN(spec), act, 6.0 if act else 16.0, image_batch(0, 0, 8)


class _Pinned(torch.autograd.Function):
    """`value` forward; the identity's gradient to `x` backward."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


@pytest.mark.parametrize("name", ["vgg7-r", "vgg7-r-act", "resnet20-r",
                                  "bert-r"])
def test_substrate_loss_and_grads_card_vs_cpu(cuda, name, monkeypatch):
    """A substrate's loss and gradients with its weight quantizers (and
    vgg7-r-act's activation quantizers), card (cuDNN convolutions, the
    fake-quant kernels) against the CPU (the plain versions; TF32 off),
    from one CPU-drawn state: the loss within 1e-5 relative, each param
    gradient within 1e-4 of its max|g| (the BERT gradients that are zero
    in exact arithmetic within 1e-6), every site's within 1e-5 of the
    sum of its terms' magnitudes (an activation site's from its input
    and cotangent); fake-quant launched once per site each way, no GEMM
    kernel. With activation quantizers the CPU pass takes each batch
    norm's output and each activation site's input as the card computed
    them (each within 1e-4 of the CPU's max), gradients flowing to its
    own: a convolution summed in another order flips round(x / d) of an
    element near a half-integer, and the flipped activation moves every
    later number (the loss by 2.7e-3, measured). Pinned at the sites
    alone, the ReLU after a batch norm still flips where its input lies
    within rounding of zero; at 6 bits such inputs come in clusters (a
    convolution of 6-bit activations takes few values), and the
    cotangents agreed within 1.2e-6 at relu4's site and parted by 1.9e-2
    at relu3's, below relu4's ReLU (measured on the H100)."""
    from repro_torch.launch import train as T
    from repro_torch.models import cnn
    m, act, bits, batch = _substrate(name)
    p = m.init(torch.Generator().manual_seed(0))
    q = m.init_qparams(p, bits_init=bits, act_quant=act)
    seen, card_in, card_bn, cpu_bn = {}, {}, [], []
    qa, bn = cnn._qa, cnn.batchnorm

    def pin(h, x):
        assert float((h.detach() - x).abs().max()) <= 1e-4 * float(
            h.detach().abs().max())
        return _Pinned.apply(h, x)

    def pinning_qa(h, qparams, site):
        if qparams is not None and site in qparams:
            if h.is_cuda:
                card_in[site] = h.detach().cpu()
            else:
                h = pin(h, card_in[site])
                seen[site] = [card_in[site]]
        out = qa(h, qparams, site)
        if site in seen and not h.is_cuda:
            out.register_hook(lambda g: seen[site].append(g))
        return out

    def pinning_bn(x, scale, bias, eps=1e-5):
        y = bn(x, scale, bias, eps)
        if y.is_cuda:
            card_bn.append(y.detach().cpu())
            return y
        cpu_bn.append(y)
        return pin(y, card_bn[len(cpu_bn) - 1])

    if act:
        monkeypatch.setattr(cnn, "_qa", pinning_qa)
        monkeypatch.setattr(cnn, "batchnorm", pinning_bn)
    before_fq, before_gemm = dict(TFQ.launches), dict(TG.gemm.launches)
    out = {dev: T.loss_and_grads(
        m, {k: v.to(dev) for k, v in p.items()},
        {k: type(v)(*(t.to(dev) for t in (v.d, v.q_m, v.t)))
         for k, v in q.items()}, {k: v.to(dev) for k, v in batch.items()})
        for dev in ("cuda", "cpu")}
    assert TFQ.launches[TFQ.FWD] - before_fq[TFQ.FWD] == len(q)
    assert TFQ.launches[TFQ.BWD] - before_fq[TFQ.BWD] == len(q)
    assert TG.gemm.launches == before_gemm
    (lc, gxc, gqc), (lg, gxg, gqg) = out["cpu"], out["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    zero = (".attn.bk", "qa_head.b", f"enc.{getattr(m, 'L', 0) - 1}.ln2.bias")
    for k, want in gxc.items():
        got = gxg[k].cpu()
        atol = 1e-6 if k.endswith(zero) else 1e-4 * float(want.abs().max())
        assert float((got - want).abs().max()) <= atol, k
    assert sorted(seen) == sorted(k for k in q if k.endswith(".aq"))
    assert len(seen) == (7 if act else 0)
    assert len(cpu_bn) == len(card_bn) == (6 if act else 0)
    for k, want in gqc.items():
        scales = (_term_scales(*seen[k], q[k]) if k.endswith(".aq") else
                  _term_scales(p[k[:-3]], gxc[k[:-3]], q[k]))
        for f, scale in zip(("d", "q_m", "t"), scales):
            a, b = float(getattr(gqg[k], f)), float(getattr(want, f))
            assert abs(a - b) <= 1e-5 * scale, (k, f, a, b, scale)


def _term_scales(w, g, qp):
    """For each of a site's Eq 4-6 sums (dd, dq_m, dt), the sum of its
    terms' magnitudes in f64, the scale two summation orders' difference
    is held against (the sums cancel: VGG7-r's conv3 dt is 9e-5 of it).
    `w` is the site's input and `g` its cotangent; a weight's cotangent
    is its gradient: |w| <= q_m."""
    w, g = w.double().abs(), g.double().abs()
    d, q_m, t = (float(v) for v in (qp.d, qp.q_m, qp.t))
    inside = w <= q_m
    base = torch.where(inside, w.clamp_min(1e-12), torch.full_like(w, q_m))
    v = w.clamp_max(q_m) ** t / d
    return (float((g * (v.round() - v).abs()).sum()),
            float((g * torch.where(inside, 0.0, t * q_m ** (t - 1))).sum()),
            float((g * (base ** t * base.log()).abs()).sum()))


def _cos_d(qasso, site, params, grads, redundant, qp) -> float:
    """Eq 17's cos(theta_d) of a weight site on the CPU: the cosine of
    the gradient with the masked rounding residuals."""
    red = qasso._mask_tree(params, redundant)
    stats = sum(qasso._site_stats_chunked(params[n], grads[n], red[n], qp.d,
                                          qp.q_m, qp.t)
                for n in site.quantized_params)
    dot_res, n_g2, n_res2 = float(stats[1]), float(stats[2]), float(stats[4])
    return dot_res / max((n_g2 * n_res2) ** 0.5, 1e-30)


@pytest.mark.parametrize("name", ["vgg7-r-act", "bert-r"])
def test_substrate_joint_update_card_vs_cpu(cuda, name):
    """QASSO's joint update (step 0 of `train.JOINT_STEP0`; VGG7 with
    activation quantizers) on the card against the CPU from one state and
    one set of CPU gradients (activation quantizers make a CNN's own
    gradients chaotic across summation orders: `tests/test_torch_cnn.py`)
    at `train.STEP_TOLERANCES` with identical masks; the forget step's
    fake-quant runs on the card. Eq 17's d divides by cos(theta_d), the
    cosine of the gradient with the rounding residuals round(v) - v,
    which the card computes from its own clip^t (torch.pow on the card);
    at 16 bits v reaches 32767, so an ulp of the clip moves a residual by
    ~1e-3. Where that cosine is below 1e-2 the two devices' d part (BERT:
    by 0.45 relative at a site of |cos| 1.6e-4, measured): d is held at
    the sites whose |cos(theta_d)| is at least 1e-2."""
    import dataclasses
    from repro_torch.launch import train as T
    m, act_quant, _, batch = _substrate(name)
    comp = dataclasses.replace(T.JOINT_STEP0, act_quant=act_quant)
    _, qasso = T.build_geta(m, comp, lr=3e-4)
    p = m.init(torch.Generator().manual_seed(0))
    q = m.init_qparams(p, bits_init=16.0, act_quant=act_quant)
    s = qasso.init(p, q)
    loss, gx, gq = T.loss_and_grads(m, p, q, batch)
    mv = lambda d: {k: v.cuda() for k, v in d.items()}
    qv = lambda d: {k: type(v)(*(t.cuda() for t in (v.d, v.q_m, v.t)))
                    for k, v in d.items()}
    # the card's copy first: the update advances the moments in place
    sg = s._replace(base=s.base._replace(m=mv(s.base.m), v=mv(s.base.v)),
                    redundant=mv(s.redundant), keep_mask=mv(s.keep_mask))
    card = (mv(p), qv(q), mv(gx), qv(gq), sg)
    want = qasso.update(p, q, gx, gq, s)[:3] + ({"loss": loss},)
    before = TFQ.launches[TFQ.FWD]
    got = qasso.update(*card)[:3] + ({"loss": loss},)
    assert TFQ.launches[TFQ.FWD] > before
    diff = T.step_differences(want, got)
    assert diff.pop("masks")
    assert any(float(v.sum()) > 0 for v in got[2].redundant.values())
    for k, v in diff.items():
        if k != "d":
            assert v <= T.STEP_TOLERANCES.get(k.removeprefix("act_"), 0), (
                k, v)
    red = want[2].redundant
    held = 0
    for site in qasso.weight_sites:
        cos = _cos_d(qasso, site, p, gx, red, q[site.name])
        if abs(cos) < 1e-2:
            continue
        held += 1
        a, b = float(got[1][site.name].d), float(want[1][site.name].d)
        assert abs(a - b) <= T.STEP_TOLERANCES["d"] * abs(b), (site.name, a,
                                                                b, cos)
    assert held > 0


# ------------------------------------------------- the MoE family (grok, llama4)
MOE_ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("mode", ["dense", "compressed"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_on_card_matches_cpu(cuda, arch, mode):
    """The MoE smoke engines (f32) emit the same greedy tokens on the card
    (the GEMM, decode-attention and fake-quant kernels; the expert
    products in cuBLAS) as on the CPU, from the same weights."""
    toks = serve_on_devices(arch, True, [6, 3, 9, 12], 8, ["cpu", "cuda"],
                            max_slots=2, **WEIGHT_MODES[mode])
    assert sorted(toks["cuda"]) == sorted(toks["cpu"])
    for rid in toks["cpu"]:
        np.testing.assert_array_equal(toks["cuda"][rid], toks["cpu"][rid],
                                      err_msg=f"{arch} request {rid}")


def test_moe_spec_on_card_matches_plain_and_cpu(cuda):
    """llama4's smoke engine with its s50 b4 MoE draft, draft_k 4 (the
    mirror of the reference's MoE-target identity test), on the card: the
    plain engine's tokens on the card and its own CPU run's."""
    arch = "llama4-maverick-400b-a17b"
    kw = dict(speculative=True, draft_k=4, draft_sparsity=0.5,
              draft_bits=4.0)
    got = serve_on_devices(arch, True, [5, 3, 9, 12], 8, ["cuda", "cpu"],
                           max_slots=2, **kw)
    plain = serve_on_devices(arch, True, [5, 3, 9, 12], 8, ["cuda"],
                             max_slots=2)
    for want in (got["cpu"], plain["cuda"]):
        assert sorted(got["cuda"]) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got["cuda"][rid], want[rid],
                                          err_msg=f"request {rid}")


def test_moe_smoke_train_step_on_card_matches_cpu(cuda):
    """grok's smoke GETA step (`train.JOINT_STEP0`, momentum, 16-bit init)
    on the card against the CPU from one state, at `train.STEP_TOLERANCES`
    with identical masks; Eq 17's d where it is well conditioned (|cos
    theta_d| >= 1e-2, as `test_substrate_joint_update_card_vs_cpu` holds
    it); a second card run repeats bit for bit."""
    from repro_torch.launch import train as T
    runs = T.step_on_devices("grok-1-314b", ["cpu", "cuda"])
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    assert diff.pop("masks")
    for k, tol in T.STEP_TOLERANCES.items():
        if k != "d":
            assert diff[k] <= tol, (k, diff[k], tol)
    lm, p0, q0, _, qasso, s0 = T.init_geta("grok-1-314b", True,
                                           comp=T.JOINT_STEP0, device="cpu")
    tokens = torch.randint(0, lm.cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    _, gx, _ = T.loss_and_grads(lm, p0, q0, {"tokens": tokens})
    red = runs["cpu"][2].redundant
    held = 0
    for site in qasso.weight_sites:
        if abs(_cos_d(qasso, site, p0, gx, red, q0[site.name])) < 1e-2:
            continue
        held += 1
        a = float(runs["cuda"][1][site.name].d)
        b = float(runs["cpu"][1][site.name].d)
        assert abs(a - b) <= T.STEP_TOLERANCES["d"] * abs(b), site.name
    assert held > 0
    again = T.step_on_devices("grok-1-314b", ["cuda"])["cuda"]
    assert torch.equal(again[3]["loss"], runs["cuda"][3]["loss"])
    assert all(torch.equal(again[0][k], runs["cuda"][0][k])
               for k in again[0])


def _moe_layer_on_card(arch, dtype):
    """(cfg, layer 0's MoE params on the card in `dtype`, its 8-bit
    quantizers, a random (2, 8, D) input, the prefix)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import LM
    lm = LM(get_arch(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    qp = {k: type(q)(*(t.cuda() for t in (q.d, q.q_m, q.t)))
          for k, q in lm.init_qparams(params).items()}
    lp = {k: v[0].cuda().to(dtype) for k, v in params.items()
          if k.startswith("blocks.0.moe")}
    x = torch.randn((2, 8, lm.cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda").to(dtype)
    return lm.cfg, lp, qp, x, "blocks.0.moe"


def _ep(mesh, pre):
    """A layer's expert-parallel layout: the stacks split on `model`."""
    from repro_torch.distributed.sharding import TensorParallel
    return TensorParallel(mesh, {f"{pre}.{w}": (None, "model", None, None)
                                 for w in ("we_gate", "we_up", "we_down")})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_expert_parallel_at_tp1_on_card(cuda, arch, dtype):
    """`moe_apply`'s expert-parallel path on the card at one rank (the
    rank's local experts are every expert; the combine's ordered sum runs
    over one rank) is bitwise the plain call."""
    from repro_torch.launch.mesh import Mesh
    cfg, lp, qp, x, pre = _moe_layer_on_card(arch, dtype)
    want = TL.moe_apply(lp, qp, cfg, x, prefix=pre)
    got = TL.moe_apply(lp, qp, cfg, x, prefix=pre,
                       tp=_ep(Mesh(("data", "model"), (1, 1), rank=0), pre))
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_moe_expert_parallel_partials_on_card(cuda):
    """grok's smoke MoE layer (f32) on the card as two ranks of a (1, 2)
    mesh run it: each rank's local experts (2 of 4) and its partial
    combine (the collective replaced by the partial itself), summed in
    rank order, within 1e-6 of the plain call's largest magnitude, and
    each rank's local stacks its half of the experts."""
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.launch.mesh import Mesh
    cfg, lp, qp, x, pre = _moe_layer_on_card("grok-1-314b", torch.float32)
    want = TL.moe_apply(lp, qp, cfg, x, prefix=pre)
    total = None
    for rank in (0, 1):
        mesh = Mesh(("data", "model"), (1, 2), rank=rank)
        tp = _ep(mesh, pre)
        tp.sum = lambda y: y          # this rank's partial, uncombined
        local = {k: local_shard(v[None], tp.specs[k], mesh)[0]
                 if k in tp.specs else v for k, v in lp.items()}
        assert local[f"{pre}.we_gate"].shape[0] == cfg.moe.n_experts // 2
        part = TL.moe_apply(local, qp, cfg, x, prefix=pre, tp=tp).float()
        total = part if total is None else total + part
    err = (total - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err


def test_fake_quant_past_2_31_elements_matches_plain(cuda):
    """The fake-quant kernels on one bf16 tensor of more than 2^31
    elements (an odd count, as a full-width expert stack's 3.2e9 are past
    the 32-bit range): the forward and dx bitwise their plain versions,
    compared piece by piece, and the three sums within 1e-5 of
    `sum_scales`; one kernel launch each."""
    n = 2 ** 31 + 2 ** 20 + 7
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn((n,), generator=gen, device=cuda,
                    dtype=torch.bfloat16).mul_(0.02)
    qp = init_quant_params(x, bits=8.0)
    sc = (qp.d, qp.q_m, qp.t)
    before = dict(TFQ.launches)
    y = TFQ.fake_quant_fwd(x, *sc)
    torch.cuda.synchronize()
    assert TFQ.launches[TFQ.FWD] == before[TFQ.FWD] + 1
    piece = 1 << 27
    for i in range(0, n, piece):
        assert torch.equal(y[i:i + piece],
                           ref.fake_quant_fwd_ref(x[i:i + piece], *sc)), i
    del y
    g = torch.randn((n,), generator=gen, device=cuda,
                    dtype=torch.bfloat16).mul_(1e-3)
    dx, *sums = TFQ.fake_quant_bwd(x, *sc, g)
    torch.cuda.synchronize()
    assert TFQ.launches[TFQ.BWD] == before[TFQ.BWD] + 1
    want = [0.0, 0.0, 0.0]
    for i in range(0, n, piece):
        d, *s = ref.fake_quant_bwd_ref(x[i:i + piece], *sc, g[i:i + piece])
        assert torch.equal(dx[i:i + piece], d), i
        want = [a + float(b) for a, b in zip(want, s)]
    rows = n // 4096
    scales = TFQ.sum_scales(x[:rows * 4096].view(rows, 4096),
                            g[:rows * 4096].view(rows, 4096), *sc)
    tail = TFQ.sum_scales(x[rows * 4096:].view(1, -1),
                          g[rows * 4096:].view(1, -1), *sc)
    for got, w, a, b in zip(sums, want, scales, tail):
        assert abs(float(got) - w) <= 1e-5 * (a + b), (float(got), w)


# ------------------------------- the recurrent mixers (rwkv6, jamba's mamba)
RECURRENT_ARCHS = ["rwkv6-3b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["dense", "compressed"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_engine_on_card_matches_cpu(cuda, arch, mode, arena):
    """The recurrent smoke engines (f32, dense and int8) emit the same
    greedy tokens on the card (the GEMM kernels under the plain recurrent
    scans; jamba's decode attention) as on the CPU, from the same weights,
    over both arenas (paged without prefix sharing), with a slot
    re-admitted after another occupant (5 requests on 2 slots)."""
    kw = (dict(paged=True, page_size=4, prefix_sharing=False)
          if arena == "paged" else None)
    toks = serve_on_devices(arch, True, [6, 3, 9, 12, 6], 8,
                            ["cpu", "cuda"], max_slots=2, arena=kw,
                            **WEIGHT_MODES[mode])
    assert sorted(toks["cuda"]) == sorted(toks["cpu"])
    for rid in toks["cpu"]:
        np.testing.assert_array_equal(toks["cuda"][rid], toks["cpu"][rid],
                                      err_msg=f"{arch} request {rid}")


def test_recurrent_smoke_train_step_on_card_matches_cpu(cuda):
    """rwkv6's smoke GETA step (`train.JOINT_STEP0`, AdamW, 16-bit init:
    the chunk-checkpointed WKV scan in the backward) on the card against
    the CPU from one state, at `train.STEP_TOLERANCES` with identical
    masks; Eq 17's d where it is well conditioned (|cos theta_d| >=
    1e-2); a second card run repeats bit for bit."""
    from repro_torch.launch import train as T
    arch = "rwkv6-3b"
    runs = T.step_on_devices(arch, ["cpu", "cuda"])
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    assert diff.pop("masks")
    for k, tol in T.STEP_TOLERANCES.items():
        if k != "d":
            assert diff[k] <= tol, (k, diff[k], tol)
    lm, p0, q0, _, qasso, s0 = T.init_geta(arch, True, comp=T.JOINT_STEP0,
                                           device="cpu")
    tokens = torch.randint(0, lm.cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    _, gx, _ = T.loss_and_grads(lm, p0, q0, {"tokens": tokens})
    red = runs["cpu"][2].redundant
    held = 0
    for site in qasso.weight_sites:
        if abs(_cos_d(qasso, site, p0, gx, red, q0[site.name])) < 1e-2:
            continue
        held += 1
        a = float(runs["cuda"][1][site.name].d)
        b = float(runs["cpu"][1][site.name].d)
        assert abs(a - b) <= T.STEP_TOLERANCES["d"] * abs(b), site.name
    assert held > 0
    again = T.step_on_devices(arch, ["cuda"])["cuda"]
    assert torch.equal(again[3]["loss"], runs["cuda"][3]["loss"])
    assert all(torch.equal(again[0][k], runs["cuda"][0][k])
               for k in again[0])


# (K, N) of the recurrent mixers' projections the GEMM had not met: the
# smoke decay LoRA / dt_rank (K = 8, N = 8), rwkv6's decay_w1 (N = 64) and
# decay_w2 (K = 64), jamba's x_proj (N = 544), dt_proj (K = 512, x a view
# with rows 544 apart) and, pruned at 0.3, x_proj and out_proj at K = 11469
RECURRENT_GEMMS = [(8, 8), (2560, 64), (64, 2560), (16384, 544),
                   (512, 16384), (11469, 544), (11469, 8192)]


@pytest.mark.parametrize("K,N", RECURRENT_GEMMS, ids=str)
@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("epilogue", ["fake_quant_rhs", "dequant",
                                      "unpack_b4"])
def test_recurrent_gemm_shapes_match_plain(cuda, epilogue, M, K, N):
    """The small-M (M = 4) and tensor-core (M = 512, bf16 x) variants at
    the recurrent mixers' shapes, weights stored as `prepare_serving`
    stores them (rows padded to 16 bytes): within the GEMM's bound of the
    plain version, a second call bitwise. dt_proj's x is the strided
    view `torch.split` leaves (rows dt_rank + 2 d_state apart)."""
    gen = torch.Generator(device=cuda).manual_seed(K + N + M)
    w, epi = _weights(epilogue, K, N, gen)
    w = TG.aligned_rows(w)
    if K == 512:
        proj = torch.randn((M, 544), generator=gen, device=cuda)
        x = proj.to(torch.bfloat16)[:, :K]
        assert x.stride() == (544, 1)
    else:
        x = torch.randn((M, K), generator=gen, device=cuda).to(
            torch.bfloat16)
    y = TG.gemm(x, w, epi, out_dtype=torch.float32)
    again = TG.gemm(x, w, epi, out_dtype=torch.float32)
    want = TG.plain(x, w, epi, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("K,N", [(64, 2560), (8, 8)], ids=str)
def test_recurrent_f32_x_on_bf16_weights_matches_plain(cuda, K, N, M):
    """rwkv6's decay_w2 takes the f32 tanh of the LoRA's first product on
    bf16 weights (f32 output): the small-M and SIMT variants with f32 x
    and bf16 w, fake-quant and plain, within the GEMM's bound."""
    gen = torch.Generator(device=cuda).manual_seed(K * N + M)
    w = (torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5).to(
        torch.bfloat16)
    qp = init_quant_params(w.float(), bits=8.0)
    x = torch.tanh(torch.randn((M, K), generator=gen, device=cuda))
    for epi in (TG.fake_quant_rhs(qp.d, qp.q_m, qp.t), TG.none()):
        y = TG.gemm(x, TG.aligned_rows(w), epi)
        want = TG.plain(x, w, epi, torch.float32)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32
        torch.testing.assert_close(y, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


# ------------------------------------------- codebooks, vision, windows
def _cpu_drawn(lm, device, seed=0):
    """`lm`'s params drawn from the CPU generator (the CPU and CUDA
    generators give different numbers from one seed), on `device`."""
    return {k: v.to(device) for k, v in lm.init(
        torch.Generator().manual_seed(seed)).items()}


@pytest.mark.parametrize("kind", ["musicgen", "ring"])
def test_frontend_decode_attn_shapes_match_plain_and_split_mirror(cuda,
                                                                  kind):
    """musicgen's decode (MHA: KVh 32, g 1, dh 64, where only half of a
    warp's lanes hold a column of a row) over S = 576 at the split edges,
    and a sliding window's 256-row ring at positions past its end (pos
    300, 1000, 256 and 255: the kernel attends over min(pos + 1, S) rows,
    the whole ring once it has wrapped)."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    if kind == "musicgen":
        S, KVh, g, dh = 576, 32, 1, 64
        pos = _edge_pos(S, cuda)
    else:
        S, KVh, g, dh = 256, 8, 2, 128
        pos = torch.tensor([300, 255, 1000, 256], dtype=torch.int64,
                           device=cuda)
    q, k, v = _contiguous(gen, pos.numel(), S, torch.bfloat16, KVh=KVh,
                          g=g, dh=dh)
    got = TDA.decode_attn(q, k, v, pos)
    plain = ref.decode_attn_ref(q, k, v, pos)
    mirror = ref.decode_attn_split_ref(q, k, v, pos, R)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, mirror, rtol=1e-5, atol=1e-5)
    if kind == "ring":      # a wrapped ring is the full ring
        full = torch.full_like(pos, S - 1)
        assert torch.equal(got[[0, 2, 3]], TDA.decode_attn(
            q, k, v, full)[[0, 2, 3]])


def test_codebook_serve_loop_on_card_matches_cpu(cuda, monkeypatch):
    """musicgen's smoke config (f32) through the static loop, dense and
    int8: the card's frames equal the CPU run's."""
    from repro_torch.launch import serve as TSV
    from repro_torch.models.transformer import LM
    init = LM.init
    monkeypatch.setattr(LM, "init", lambda self, g: {
        k: v.to(g.device) for k, v in init(
            self, torch.Generator().manual_seed(0)).items()})
    prompts = np.random.default_rng(3).integers(0, 128, (2, 6, 4))
    for kw in ({}, dict(compressed=True)):
        got = TSV.serve_loop("musicgen-large", True, 2, 6, 8,
                             prompts=prompts, verbose=False, device="cuda",
                             **kw)
        want = TSV.serve_loop("musicgen-large", True, 2, 6, 8,
                              prompts=prompts, verbose=False, device="cpu",
                              **kw)
        assert got.shape == (2, 8, 4)
        np.testing.assert_array_equal(got, want)


def test_vision_prefill_and_decode_on_card_match_cpu(cuda):
    """internvl2's smoke config (f32): 8 patches and 6 text tokens
    prefilled, then 8 greedy decode steps; the card's tokens equal the
    CPU run's, and the prefill's last logits agree within 1e-4 of their
    range."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import vlm_batch
    from repro_torch.models.transformer import LM
    lm = LM(get_arch("internvl2-26b", smoke=True))
    cfg = lm.cfg
    b = vlm_batch(0, 0, 2, 6, cfg.vocab, cfg.vision_patches, cfg.d_model,
                  dtype=torch.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = _cpu_drawn(lm, dev)
        cache = lm.init_cache(2, 24, dtype=torch.float32, device=dev)
        lg, _ = lm.prefill(params, None, cache, b["tokens"].to(dev),
                           vision_embeds=b["vision_embeds"].to(dev),
                           last_logit_only=True)
        first = lg[:, -1].cpu()
        tok = torch.argmax(lg[:, -1], -1)[:, None]
        toks = [tok]
        for i in range(8):
            lg, _ = lm.decode_step(params, None, cache, tok,
                                   cfg.vision_patches + 6 + i)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
            toks.append(tok)
        out[dev] = (first, torch.cat(toks, 1).cpu())
    span = float(out["cpu"][0].max() - out["cpu"][0].min())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 1e-4 * span
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def _windowed_engine(device, window=8):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import LM
    lm = LM(dataclasses.replace(get_arch("internlm2-1.8b", smoke=True),
                                window=window))
    params, qparams, _ = prepare_serving(lm, _cpu_drawn(lm, device))
    return Engine(lm, params, qparams, max_slots=2, max_seq=32)


def test_window_engine_on_card_matches_cpu_and_eager_steps(cuda,
                                                           monkeypatch):
    """The windowed smoke engine (window 8, f32, dense fake-quant): six
    requests on two slots, every one decoding past its ring's wrap. Graph
    windows emit the tokens of eager `step()` on the card and of the CPU
    run; every window length is captured once, in `warmup()`."""
    captures = _captures(monkeypatch)
    prompts = [np.random.default_rng(i).integers(0, 512, n).astype(np.int32)
               for i, n in enumerate((5, 8, 3, 7, 2, 6))]
    gens = (12, 9, 17, 5, 14, 10)
    runs = {}
    for name, dev in (("graph", "cuda"), ("eager", "cuda"), ("cpu", "cpu")):
        eng = _windowed_engine(dev)
        assert eng.caches["blocks.0.k"].shape[2] == 8
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        if name == "eager":
            runs[name] = eng._drain(eng.step)
        else:
            eng.warmup()
            runs[name] = eng.run()
        if name == "graph":
            assert len(captures) == len(eng.warmed_window_ks())
            assert eng.replays
    for rid in range(len(prompts)):
        assert len(runs["graph"][rid]) == gens[rid]
        for other in ("eager", "cpu"):
            np.testing.assert_array_equal(runs["graph"][rid],
                                          runs[other][rid],
                                          err_msg=f"{other} {rid}")


# ------------------------------------------------------------ multi-rank
# Two ranks share the card (gloo, each collective staged through host
# memory; `launch.mesh`); their functions live in `tests/torch_ranks.py`.
@pytest.fixture(scope="module")
def card_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the repro_torch kernels")
    from repro_torch.launch.mesh import RankPool
    with RankPool(2, "cuda", verbose=False) as pool:
        yield pool


def test_tp_wrappers_bitwise_the_one_rank_kernels(card_ranks):
    """tp_gemm at the small-M and tensor-core heights in fake_quant_rhs,
    dequant and unpack_dequant b4 (each rank's column tile planned as the
    full-width call, `plan_n`), and tp_decode_attn (KV heads 8 -> 4 a
    rank), on 2 ranks: every rank's gathered result bitwise the 1-rank
    kernel call's."""
    import torch_ranks as R
    for res in card_ranks.run(R.tp_kernels_card, 2):
        assert res and all(res.values()), res
        assert {"small_m.dequant", "tc.unpack_b4", "decode_attn"} <= set(res)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_tp2_engine_tokens_equal_the_one_rank_engine(card_ranks, paged):
    """The smoke config (f32) served at tp 2 on the card emits the 1-rank
    engine's tokens on both ranks, decoding eagerly (gloo collectives
    cannot be captured) while the 1-rank engine replays graphs."""
    import torch_ranks as R
    kw = dict(paged=True, page_size=8) if paged else {}
    want = engine_serve("internlm2-1.8b", True, [12, 5, 9], 8,
                        verbose=False, **kw)
    for out, mode in card_ranks.run(R.serve_card, 2, [12, 5, 9], 8, kw):
        assert mode.startswith("eager (gloo")
        for rid in want:
            np.testing.assert_array_equal(out[rid], want[rid])


def test_tp2_ordered_grads_step_bitwise_one_rank(card_ranks):
    """Two ranks, one batch slice each, on the card: 3 GETA steps bitwise
    the 1-rank step with grad_slices=2 (loss, params, quantizers, masks),
    and FSDP the same."""
    import torch_ranks as R
    want = R.sharded_train(1, False, 2, steps=3, device="cuda")
    for fsdp in (False, True):
        for got in card_ranks.run(R.sharded_train, 2, fsdp, 2, "lm", 3,
                                  True, "cuda"):
            assert got[0] == want[0]
            for k in want[1]:
                np.testing.assert_array_equal(got[1][k], want[1][k])
            assert got[2] == want[2]
            for key in ("redundant", "keep_mask"):
                for fam in want[3][key]:
                    np.testing.assert_array_equal(got[3][key][fam],
                                                  want[3][key][fam])


# ------------------------------------------- launch introspection, tuner
def _introspect_calls(cuda):
    """One call of every kernel instantiation chip_smoke.py's phases 5
    (serving, 4 slots: the small-M GEMM in each weight mode, the
    tensor-core GEMM at prefill heights, contiguous decode attention) and
    7 (training: the tensor-core GEMM in every training epilogue and
    layout, the fake-quant kernels) launch, at full-width shapes."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    bf = torch.bfloat16
    rn = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    mask = (torch.rand(8192, generator=gen, device=cuda) > 0.3).float()
    for epilogue in ("fake_quant_rhs", "dequant", "unpack_b4"):
        w, epi = _weights(epilogue, 2048, 8192, gen)
        for M in (4, 64, 512):              # decode; prefill bm 128, 256
            TG.gemm(rn(M, 2048).to(bf), w, epi)
    qp = init_quant_params(rn(2048, 8192), bits=8.0)
    fq = (qp.d, qp.q_m, qp.t)
    w = (rn(2048, 8192) * 0.02).to(bf)
    x, g = rn(2048, 2048).to(bf), rn(2048, 8192).to(bf)
    for epi in (TG.fake_quant_rhs(*fq), TG.fq_col_mask(*fq, mask),
                TG.col_mask(mask), TG.none()):
        TG.gemm(x, w, epi)                              # the forward
    TG.gemm(g, w.T, TG.fake_quant_rhs(*fq), out_dtype=bf)   # dx
    TG.gemm(x.T, g, TG.none(), out_dtype=bf)                 # dwq
    TFQ.fake_quant_fwd(w, *fq)
    TFQ.fake_quant_bwd(w, *fq, w)
    q = rn(4, 8, 2, 128).to(bf)
    kv = rn(4, 576, 8, 128).to(bf)
    TDA.decode_attn(q, kv, kv, torch.tensor([575, 0, 300, 63], device=cuda))


def test_introspect_smem_model_equals_the_cards_attributes(cuda):
    """For every instantiation phases 5 and 7 launch, the record's shared
    bytes are the card's sharedSizeBytes plus the dynamic bytes its
    launcher opts into, its numRegs the card's, and the launch within
    Hopper's budget."""
    from repro_torch.kernels import introspect
    with introspect.record_launches() as launches:
        _introspect_calls(cuda)
    torch.cuda.synchronize()
    seen = {}
    for launch in launches:
        assert launch.route == "cuda" and not introspect.launch_faults(launch)
        for k in launch.kernels:
            seen[(k.name, k.query)] = k
    assert len(seen) >= 12, sorted(seen)
    for k in seen.values():
        a = introspect.card_attributes(k)
        assert (k.smem_static, k.smem_dynamic) == (a["static"],
                                                   a["dynamic"]), k.name
        assert k.regs == a["regs"] and k.threads <= a["max_threads"], k.name


def test_autotune_winner_is_used_and_keeps_the_bitwise_rules(cuda, tmp_path,
                                                           monkeypatch):
    """`autotune_gemm` records a winner the next call takes: a tensor-core
    call under either bm is bitwise the untuned one; a tuned small-M call is
    within the GEMM's bound of the plain version, repeats bitwise, equals
    unpack_dequant b8 on the same codes bitwise, and a column half called
    with plan_n = N equals the full call's columns bitwise; the table
    reloads from its file."""
    from repro_torch.kernels import autotune, introspect
    monkeypatch.setenv(autotune.ENV_VAR, str(tmp_path / "tune.json"))
    autotune.clear()
    try:
        gen = torch.Generator(device=cuda).manual_seed(3)
        w, epi = _weights("fake_quant_rhs", 2048, 4096, gen)
        x = torch.randn((512, 2048), generator=gen, device=cuda).to(
            torch.bfloat16)
        before = TG.gemm(x, w, epi, out_dtype=torch.float32)
        win, times = autotune.autotune_gemm(x, w, epi, repeats=2)
        assert set(times) == {(128,), (256,)} and win in times
        with introspect.record_launches() as rec:
            y = TG.gemm(x, w, epi, out_dtype=torch.float32)
        assert rec[0].tuned and rec[0].plan == win
        assert torch.equal(y, before)
        # every bm, forced through the table, bitwise the untuned call
        sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        for bm in autotune.TC_HEIGHTS:
            autotune.record(512, 4096, 2048, "tc", sm, (bm,),
                            autotune.ops_key(epi), persist=False)
            with introspect.record_launches() as rec:
                y = TG.gemm(x, w, epi, out_dtype=torch.float32)
            assert rec[0].plan == (bm,) and torch.equal(y, before), bm
        K, N = 8192, 2048
        codes, epi = _weights("dequant", K, N, gen)
        x = torch.randn((4, K), generator=gen, device=cuda).to(torch.bfloat16)
        # a split that is not the rule's, so the table visibly decides
        win, _ = autotune.autotune_gemm(x, codes, epi,
                                        candidates=[(6, 1536), (5, 1792)],
                                        repeats=2)
        with introspect.record_launches() as rec:
            ys = [TG.gemm(x, codes, epi, out_dtype=torch.float32)
                  for _ in range(2)]
            b8 = TG.gemm(x, pack_codes(codes.to(torch.int32), 8, axis=0),
                         TG.unpack_dequant(8, epi.operands[0]),
                         out_dtype=torch.float32)
            half = TG.gemm(x, codes[:, :N // 2],
                           TG.dequant(epi.operands[0][:N // 2]),
                           out_dtype=torch.float32, plan_n=N)
        assert all(r.tuned and r.plan == (128, *win) for r in rec)
        want = TG.plain(x, codes, epi, torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(ys[0], want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())
        assert torch.equal(ys[0], ys[1]) and torch.equal(b8, ys[0])
        assert torch.equal(half, ys[0][:, :N // 2])
        autotune.clear()
        assert autotune.lookup(4, N, K, "small_m", sm) == win
    finally:
        autotune.clear()

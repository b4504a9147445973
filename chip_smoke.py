"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Run from the repo root; needs one CUDA device (Hopper: the kernels build
for sm_90a) and nvcc. It imports nothing of JAX or of the JAX package.
Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: nvcc builds every kernel of the serving and training paths from
   the sources.
3. Kernels against their plain PyTorch versions on the card, at the
   full-width shapes of internlm2-1.8b's decode (M = 4, 8 slots) and
   prefill (M = 512): the GEMM core's fake_quant_rhs (bf16 weights),
   dequant (int8) and unpack_dequant (bits 2, 3, 4, 8) epilogues over
   K->N = 2048->2048, 2048->1024, 2048->8192, 8192->2048 and 2048->92672,
   split-rows flash-decode attention at B = 4, 8 (KVh 8, g 2, dh 128, S
   576, bf16 K/V) and at long context (B = 4, S = 4096, slots spread over
   the arena), and page-indirect flash decode at the same shapes over
   pages of 16 rows in a shuffled order, with bf16, int8 and int4 pages.
   Outputs compare in f32 at rtol 1e-4, atol 1e-4 * max|y| against the
   plain version (a GEMM's second call bitwise its first; a small-M GEMM
   one device kernel per call, counted from a profiler trace) and at rtol
   1e-5, atol 1e-5 * max|y| against the split
   mirror (`ref.decode_attn_split_ref`, the kernel's own algorithm and
   order); on bf16 pages the paged kernel must also equal the contiguous
   kernel on the gathered rows bit for bit. Then the training shapes (T =
   B*S = 2048 tokens):
   the fake-quant forward and backward kernels on the head weight
   (2048 x 92672 bf16) and a w_gate slice (2048 x 8192 bf16) at t = 1 and
   t = 0.85 (forward and dx bitwise at both, the three sums within
   1e-5 of the sum of their terms' magnitudes and bitwise on a second
   call, one device kernel per call from a profiler trace); the GEMM's
   no-epilogue variant on x.T @ g (2048 x 2048 -> 8192 and 8192 x 2048 ->
   2048, x.T a view; its bf16 output, dwq's, bitwise its f32 output
   rounded), fake_quant_rhs on g @ fq(w.T) (w.T a view) and on
   the forward at M = 2048, each at t = 1 and t = 0.85 (dx also with
   24-bit quantizers, whose codes need the third bf16 piece), and the
   column mask alone and after fake-quant at M = 2048 and M = 4; and the
   SIMT variant (f32 x and weights) on fake_quant_rhs and no epilogue at
   M = 512 and 2048 over 2048->8192 and 8192->2048, and fake_quant_rhs at
   t = 0.85 at M = 2048 over 2048->8192 (rtol 1e-4, atol 1e-4 * max|y|).
   Every GEMM row names its variant: M <= 8 the small-M
   one, M > 8 the tensor-core one for bf16 x, the SIMT one for f32 x; a
   tensor-core row is also timed at both block heights (128 and 256 rows)
   beside the one `gemm_core.tc_block_m` picks. Each case prints the
   kernel's time,
   the plain version's, one PyTorch library call's (timed only; the port
   never calls it; for the paged kernel SDPA over the already gathered
   and decoded rows, since no single PyTorch call reads pages; for the
   GEMMs torch.matmul on the decoded weight; none for the fake-quant,
   whose (d, q_m, t) quantizer no single PyTorch call computes) and the
   bound.
4. Correctness: at full width, the compressed model's one-shot prefill of
   a 32-token prompt (plain attention) against 32 sequential decode steps
   (flash-decode kernel); and the smoke config's engine tokens on the
   card against the CPU run of the plain versions (f32: its prefill
   GEMMs must launch the SIMT variant).
5. The main path: the continuous-batching engine serving internlm2-1.8b
   at full width in bf16 (24 layers, random weights from a seed) on 4
   slots, 8 requests, in the dense fake-quant, compressed int8 and packed
   4-bit modes. Launch counts are zeroed right before and read right
   after; every kernel of the path must have launched, the GEMM's
   small-M variant (decode) and tensor-core variant (prefill) among them.
   Packed tokens must equal those of an int8 run with the same 4-bit
   quantizer init; over that int8 run a profiler trace must count exactly
   one `gemm_small_m` kernel per small-M call (each decode GEMM is one
   launch; a trace with fewer kernels than calls lost events and is
   taken again, up to three times).
6. The paged main path: the same engine and requests from the paged KV
   arena (pages of 16 rows). With bf16 pages its tokens must equal phase
   5's in each weight mode; packed 4-bit weights with int8 and with int4
   pages must serve full-length outputs with the bf16 run's first tokens
   from a smaller pool; with 4 of the 8 requests on one prompt, prefix
   sharing must hit at least 3 times and leave the tokens of a run
   without sharing unchanged. Counts are zeroed right before and read
   right after; the page-indirect kernel must launch 24 times (once per
   layer) per decode step, and in every page storage of the path.
7. Training, the main path of GETA: `train_loop` on internlm2-1.8b at
   full width in bf16 (random weights from seed 0), batch 4 x 512
   tokens, target sparsity 0.3, with the schedule compressed so that
   every stage runs in 5 steps (warm-up 1, projection 1 x 1, pruning
   2 x 1, cool-down 1), under torch.use_deterministic_algorithms.
   Checks: finite losses, stages 0, 1, 2, 2, 3, every site's bits in
   [b_l, b_u_final], hard sparsity of exactly k_units / total_units,
   pruned units exactly 0, and the launch counts of every kernel of the
   path at their predicted values (counted from 0 over `train_loop`),
   every GEMM on the tensor-core variant (`gemm_core.tc` counts them all,
   `gemm_core.simt` stays 0).
   Then, counted from 0 on their own, one loss-and-gradient step with
   `.colmask` params (seeded random masks keeping about 70% of the
   output columns of wq, wk, wv, w_gate, w_up), with quantizers and
   without: each loss must equal bit for bit the loss of the params with
   those columns zeroed (with quantizers through fake_quant_rhs, without
   through col_mask under an all-ones mask), the masks must move the
   loss, and the plain loss must lie within 1e-3 relative of the
   torch.matmul path's; the col_mask rows of the kernel line take their
   launches from this step. Then two runs of a joint step from one
   state, which must give the same params, quantizers and masks bit for
   bit; and the smoke config's joint step on the card against its CPU
   run at `train.STEP_TOLERANCES` (its GEMMs on the SIMT variant), and
   the same step with activation quantizers (masks identical and the loss
   within tolerance held; params and quantizers reported, since a rounding
   tie of an activation flipped by the summation order moves them past
   it). Prints step wall times, tokens/s and peak device memory.
8. Two JSON lines: the kernel table, then the device line (last).

Times are CUDA-event medians with the 50 MB L2 flushed before each launch
(each decode-step launch finds its weights cold); after the flush the
device sleeps ~0.1 ms, so the host has enqueued the call before the start
event fires and the interval holds device time only. Bounds: the larger of
the bytes the call must move over 3.35 TB/s and its operations over
989 TFLOP/s (H100 SXM datasheet: HBM3 and dense bf16 tensor-core peaks).
TF32 is off for every PyTorch matmul here, so plain versions and library
calls run in full f32 (the kernels never use TF32). `--out PATH` also
writes every kernel row and the launch counts to PATH as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12      # f32 FMAs outside the tensor cores
ARCH = "internlm2-1.8b"
GEMM_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
               (2048, 92672)]
GEMM_MS = [4, 8, 512]
PROMPT_LENS = [64, 128, 256, 512, 96, 200, 32, 384]
GEN = 64
SLOTS = 4
PAGE = 16
SHARED = (1, 3, 5, 7)     # requests that carry request 5's prompt (200
                          # tokens: 12 full pages and a shared tail page)
PAGED_KERNELS = ("paged_decode_attn.bf16", "paged_decode_attn.int8",
                 "paged_decode_attn.int4")
REPORT_SHAPE = (4, 2048, 8192)      # the JSON line's GEMM row: w_gate at decode
TOKENS = 2048                        # training batch 4 x 512
TRAIN_BATCH, TRAIN_SEQ = 4, 512
FQ_SHAPES = {"head": (2048, 92672), "w_gate": (2048, 8192)}
# (label, M, K, N, layout, t, bits) of the training GEMMs, each in the
# layout the train step hands it: x.T @ g (dwq, x.T a view), g @ fq(w.T)
# (dx, w.T a view) and the forward, for w_gate (2048 -> 8192) and w_down
# (8192 -> 2048); fake-quant at t = 1 (every quantizer's init) and at
# t = 0.85 (once QASSO moves t: a powf per decoded weight), at 8 bits and
# at 24 (codes of more than 16 significant bits, as warm-up's quantizers
# reach: the third bf16 piece)
TRAIN_GEMMS = [("none", 2048, 2048, 8192, "x.T,w", 1.0, 8),
               ("none", 8192, 2048, 2048, "x.T,w", 1.0, 8),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 1.0, 8),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 0.85, 8),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 1.0, 24),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 0.85, 24),
               ("fake_quant_rhs", 2048, 2048, 8192, "x,w", 1.0, 8),
               ("fake_quant_rhs", 2048, 2048, 8192, "x,w", 0.85, 8),
               ("col_mask", 2048, 2048, 8192, "x,w", 1.0, 8),
               ("col_mask", 4, 2048, 8192, "x,w", 1.0, 8),
               ("fq_col_mask", 2048, 2048, 8192, "x,w", 1.0, 8),
               ("fq_col_mask", 4, 2048, 8192, "x,w", 1.0, 8)]
# the JSON line's rows of the training kernels (all on the tensor-core
# variant but the fake-quant kernels); the fake_quant_rhs row also carries
# its t = 0.85 time (`at_t0.85`), one kernel and one launch count
TRAIN_REPORT = {"gemm_core.tc.none": TRAIN_GEMMS[0],
                "gemm_core.tc.fake_quant_rhs": TRAIN_GEMMS[2],
                "gemm_core.tc.col_mask": TRAIN_GEMMS[8],
                "gemm_core.tc.fq_col_mask": TRAIN_GEMMS[10],
                "fake_quant.fwd": ("head", 1.0),
                "fake_quant.bwd": ("w_gate", 1.0)}
AT_T085 = TRAIN_GEMMS[3]
# (label, M, K, N, t) of the SIMT variant's rows: f32 x and f32 weights,
# the f32 configuration's operands, at the model's prefill and training
# rows, and fake-quant once at t = 0.85 (a powf per decoded weight)
SIMT_GEMMS = [(label, M, K, N, 1.0) for label in ("fake_quant_rhs", "none")
              for M in (512, 2048) for K, N in ((2048, 8192), (8192, 2048))
              ] + [("fake_quant_rhs", 2048, 2048, 8192, 0.85)]
SIMT_REPORT = ("fake_quant_rhs", 2048, 2048, 8192, 1.0)
TC_HEIGHTS = (128, 256)      # the tensor-core variant's block heights
DECODE_S = 576                # phase 3's decode arena: prompt 512 + 64
LONG_S = 4096                 # and its long-context arena
DECODE_POS = [DECODE_S - 1, 0, 300, 63, 64, 575, 17, 200]
LONG_POS = [LONG_S - 1, 1000, 2500, 63]
SLEEP_CYCLES = 200_000        # ~0.1 ms of device sleep before each timing
DECODE_KERNELS = "flash_decode"   # in the decode-attention kernels' names
ROWS_PER_SPLIT = (32, 64, 128)   # the decode kernels' R, timed at B = 4


def bound_ms(nbytes: int, flops: int,
             flop_per_s: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call.
    After the flush the device sleeps `sleep_cycles` (0: not at all), so
    that the host has enqueued the call before its start event runs."""

    def __init__(self, torch, sleep_cycles: int = SLEEP_CYCLES):
        self.torch = torch
        self.sleep_cycles = sleep_cycles
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")     # 256 MB > 50 MB L2

    def __call__(self, fn, target_ms: float = 40.0) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        iters = int(min(20, max(3, target_ms / max(once, 1e-3))))
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            if self.sleep_cycles:
                torch.cuda._sleep(self.sleep_cycles)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def _height_ms(timer, gc, fn, M, N) -> dict:
    """The tensor-core call `fn` timed at each block height, `rule` the
    height `gc.tc_block_m` picks for it."""
    from repro_torch.kernels import build
    rule = gc.tc_block_m
    out = {"rule": rule(M, N, build.sm_count(0))}
    try:
        for bm in TC_HEIGHTS:
            gc.tc_block_m = lambda M, N, sm, bm=bm: bm
            out[bm] = timer(fn)
    finally:
        gc.tc_block_m = rule
    return out


def _heights(row) -> str:
    h = row.get("heights")
    return "" if h is None else (
        f" bm={h['rule']} (" + ", ".join(f"{bm}: {h[bm]:.4f}"
                                          for bm in TC_HEIGHTS) + " ms)")


def _one_kernel(torch, row, call) -> None:
    """A small-M GEMM or fake-quant row's device kernels per call, from a
    profiler trace after its timings; anything but one clears row["ok"]."""
    if row.get("variant") == "small_m" or row["kernel"].startswith("fake_"):
        row["kernels_per_call"] = _kernels_per_call(torch, call, "")
        row["ok"] = row["ok"] and row["kernels_per_call"] == 1


def _per_call(row) -> str:
    n = row.get("kernels_per_call")
    return "" if n is None else f" kernels/call {n}"


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] nvidia-smi: {line} | torch: {kind}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return kind


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    print(f"[2 build] nvcc built {len(build._sources())} kernel sources "
          f"(sm_90a) in {time.perf_counter() - t0:.2f} s")


def _gemm_cases(torch, K, N, gen):
    """(label, weight tensor, epilogue, dequantized bf16 weight) per
    epilogue, from one random bf16 weight with quantizers at their init."""
    from repro_torch.core.quant import (init_quant_params, pack_codes,
                                        quantize_int)
    from repro_torch.kernels import gemm_core as gc
    w = torch.randn((K, N), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * K ** -0.5
    qp = init_quant_params(w, bits=8.0)
    yield ("fake_quant_rhs", w, gc.fake_quant_rhs(qp.d, qp.q_m, qp.t),
           lambda: gc.ref.fake_quant_weight(w.float(), qp.d, qp.q_m,
                                            qp.t).to(torch.bfloat16))
    codes, d = quantize_int(w, qp, bits=8.0)
    c8 = codes.to(torch.int8)
    yield ("dequant", c8, gc.dequant(d),
           lambda: (c8.float() * d).to(torch.bfloat16))
    del codes
    for bits in (2, 3, 4, 8):
        qb = init_quant_params(w, bits=float(bits))
        cb, db = quantize_int(w, qb, bits=float(bits))
        words = pack_codes(cb, bits, axis=0)
        yield (f"unpack_dequant_b{bits}", words, gc.unpack_dequant(bits, db),
               lambda cb=cb, db=db: (cb * db).to(torch.bfloat16))


def phase_kernels(torch, timer) -> tuple[list, dict, list]:
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failures, report = [], [], {}
    for K, N in GEMM_SHAPES:
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in GEMM_MS}
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            w_lib = dequantized()
            for M in GEMM_MS:
                x = xs[M]
                call = lambda: gc.gemm(x, w, epi, out_dtype=torch.float32)
                y, again = call(), call()
                want = gc.plain(x, w, epi, torch.float32)
                torch.cuda.synchronize()
                err = (y - want).abs().max().item()
                tol = 1e-4 * want.abs().max().item()
                ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                          and torch.isfinite(y).all()
                          and torch.equal(y, again))
                row = {"kernel": f"gemm_core.{label}", "M": M, "K": K,
                       "N": N, "variant": gc.variant(M, x.dtype),
                       "max_abs_err": err, "atol": tol, "ok": ok}
                del y, again, want
                row["ms"] = timer(call)
                row["plain_ms"] = timer(lambda: gc.plain(x, w, epi,
                                                         torch.float32))
                row["library_ms"] = timer(lambda: torch.matmul(x, w_lib))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    gc.bytes_moved(M, N, K, 2, w, 4, epi), gc.flops(M, N, K))
                if row["variant"] == "tc":
                    row["heights"] = _height_ms(timer, gc, call, M, N)
                _one_kernel(torch, row, call)
                rows.append(row)
                if not row["ok"]:
                    failures.append(row)
                print(f"[3 kernels] {row['kernel']:<29} M={M:<3} K={K:<4} "
                      f"N={N:<5} {row['variant']} ms={row['ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"library_ms={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"err={err:.2e} tol={tol:.2e}{_heights(row)}"
                      f"{_per_call(row)} {'ok' if row['ok'] else 'FAIL'}")
                if (M, K, N) == REPORT_SHAPE and label in (
                        "fake_quant_rhs", "dequant", "unpack_dequant_b4"):
                    name = ("gemm_core.unpack_dequant"
                            if label.startswith("unpack") else
                            f"gemm_core.{label}")
                    report[name] = row
            del w_lib
        del xs
        torch.cuda.empty_cache()

    KVh, g, dh = 8, 2, 128
    for B, S, pos in ((4, DECODE_S, DECODE_POS), (8, DECODE_S, DECODE_POS),
                      (4, LONG_S, LONG_POS)):
        # int64 pos and (in the helpers) bf16 q, as the layers hand them
        pos = torch.tensor(pos[:B], dtype=torch.int64, device="cuda")
        decode_rows = [_decode_check(torch, timer, gen, B, S, KVh, g, dh,
                                     pos)]
        decode_rows += [_paged_check(torch, timer, gen, B, S, KVh, g, dh,
                                     storage, pos)
                        for storage in ("bf16", "int8", "int4")]
        for row in decode_rows:
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            if B == SLOTS and S == DECODE_S:
                report[row["kernel"]] = row
            elif S == LONG_S:
                report[row["kernel"]]["at_S4096"] = {k: row[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err")}
    return rows, report, failures


def _check_decode(torch, row, y, plain, mirror, tag="") -> None:
    """Hold a decode kernel's output to its plain version (rtol 1e-4) and
    to the split mirror (rtol 1e-5), both with atol relative to max|y|;
    the errors go under keys prefixed with `tag`, and a failure clears
    row["ok"]."""
    torch.cuda.synchronize()
    scale = plain.abs().max().item()
    row[tag + "max_abs_err"] = (y - plain).abs().max().item()
    row[tag + "atol"] = 1e-4 * scale
    row[tag + "split_max_abs_err"] = (y - mirror).abs().max().item()
    row["ok"] = row.get("ok", True) and bool(
        torch.allclose(y, plain, rtol=1e-4, atol=1e-4 * scale)
        and torch.allclose(y, mirror, rtol=1e-5, atol=1e-5 * scale)
        and torch.isfinite(y).all())


def _kernels_per_call(torch, fn, match: str = DECODE_KERNELS) -> int:
    """The device kernels whose names hold `match` (default: the
    decode-attention kernels; "" for every kernel) that one call of `fn`
    runs, read from a torch.profiler trace. A trace that recorded no device
    event at all (on the H100 a short trace now and then comes back
    empty, even three times in a row) is taken again, up to eight times:
    it measures nothing."""
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
    return sum(1 for name in names if match in name)


def _one_pos(pos):
    """Every slot at pos[0] through a stride-0 view, as the layers expand
    one position over the batch."""
    return pos[:1].expand(pos.numel())


def _sdpa(torch, q, k_rows, v_rows, pos):
    """The library yardstick: SDPA over the same (gathered, decoded) rows
    in bf16, heads expanded for GQA, masked to each slot's valid rows."""
    B, KVh, g, dh = q.shape
    S = k_rows.shape[1]
    ql = q.reshape(B, KVh * g, 1, dh).to(torch.bfloat16)
    kl, vl = (r.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
              .to(torch.bfloat16) for r in (k_rows, v_rows))
    mask = (torch.arange(S, device="cuda")[None, :]
            < torch.clamp(pos.long() + 1, max=S)[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(ql, kl, vl, attn_mask=mask)


def _decode_check(torch, timer, gen, B, S, KVh, g, dh, pos) -> dict:
    """The contiguous split-rows kernel on per-layer (strided) views of a
    stacked bf16 cache, against its plain version and the split mirror."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ref
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    cache = torch.randn((2, 2, B, S, KVh, dh), generator=gen,
                        device="cuda").to(torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]         # per-layer views, strided
    row = {"kernel": "decode_attn", "B": B, "S": S, "KVh": KVh, "g": g,
           "dh": dh, "R": da.ROWS_PER_SPLIT}
    for tag, p in (("", pos), ("one_pos_", _one_pos(pos))):
        _check_decode(torch, row, da.decode_attn(q, k, v, p),
                      ref.decode_attn_ref(q, k, v, p),
                      ref.decode_attn_split_ref(q, k, v, p,
                                                da.ROWS_PER_SPLIT), tag)
    row["ms"] = timer(lambda: da.decode_attn(q, k, v, pos))
    if B == SLOTS:
        row["rows_ms"] = {R: timer(lambda R=R: da.decode_attn(
            q, k, v, pos, rows_per_split=R)) for R in ROWS_PER_SPLIT}
    row["plain_ms"] = timer(lambda: ref.decode_attn_ref(q, k, v, pos))
    row["library_ms"] = timer(_sdpa(torch, q, k, v, pos))
    row["bound_ms"], row["bound_by"] = bound_ms(
        da.bytes_moved(q, k, pos), da.flops(q, k, pos))
    if B == SLOTS:      # after the timings: no profiler session before them
        row["kernels_per_call"] = _kernels_per_call(
            torch, lambda: da.decode_attn(q, k, v, pos))
    print(f"[3 kernels] decode_attn B={B} S={S} KVh={KVh} g={g} "
          f"dh={dh} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={row['max_abs_err']:.2e} tol={row['atol']:.2e} "
          f"vs split mirror {row['split_max_abs_err']:.2e} one pos "
          f"{row['one_pos_max_abs_err']:.2e}{_rows(row)} "
          f"{'ok' if row['ok'] else 'FAIL'}")
    return row


def _rows(row) -> str:
    r = row.get("rows_ms")
    return "" if r is None else (" R (" + ", ".join(
        f"{R}: {ms:.4f}" for R, ms in r.items()) + f" ms) kernels/call "
        f"{row['kernels_per_call']}")


def _paged_check(torch, timer, gen, B, S, KVh, g, dh, storage, pos) -> dict:
    """The page-indirect kernel on B slots of S rows in pages of PAGE rows,
    each slot's pages in a shuffled order, against its plain version and
    the split mirror (and, on bf16 pages, bitwise against the contiguous
    kernel on the gathered rows)."""
    from repro_torch.core.quant import kv_quant_encode
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ref
    Lp = S // PAGE
    n_pages = 2 + B * Lp
    table = (torch.randperm(n_pages - 2, generator=gen, device="cuda")
             + 2).reshape(B, Lp).to(torch.int32)
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    pools = [torch.randn((n_pages, PAGE, KVh, dh), generator=gen,
                         device="cuda") for _ in range(2)]
    kw = dict(page_size=PAGE, seq_len=S)
    if storage == "bf16":
        kp, vp = (p.to(torch.bfloat16) for p in pools)
    else:
        bits = int(storage[-1])
        (kp, ks), (vp, vs) = (kv_quant_encode(p, bits) for p in pools)
        kw.update(kv_bits=bits, k_scale=ks, v_scale=vs)
    del pools
    y = da.paged_decode_attn(q, kp, vp, pos, table, **kw)
    row = {"kernel": f"paged_decode_attn.{storage}", "B": B, "S": S,
           "P": PAGE, "KVh": KVh, "g": g, "dh": dh, "R": da.ROWS_PER_SPLIT}
    for tag, p in (("", pos), ("one_pos_", _one_pos(pos))):
        _check_decode(torch, row,
                      da.paged_decode_attn(q, kp, vp, p, table, **kw),
                      ref.paged_decode_attn_ref(q, kp, vp, p, table, **kw),
                      ref.paged_decode_attn_split_ref(
                          q, kp, vp, p, table,
                          rows_per_split=da.ROWS_PER_SPLIT, **kw), tag)
    # the gathered (and decoded) rows: the contiguous kernel's input on
    # bf16 pages, and the library yardstick's in every storage
    rows_k, rows_v = (ref.gather_pages(pool, kw.get(sc), table, PAGE, S,
                                       kw.get("kv_bits"))
                      for pool, sc in ((kp, "k_scale"), (vp, "v_scale")))
    if storage == "bf16":
        contiguous = da.decode_attn(q, rows_k, rows_v, pos)
        torch.cuda.synchronize()
        row["contiguous_max_abs_err"] = (y - contiguous).abs().max().item()
        row["ok"] = row["ok"] and torch.equal(y, contiguous)
    row["ms"] = timer(lambda: da.paged_decode_attn(q, kp, vp, pos, table,
                                                   **kw))
    if B == SLOTS:
        row["rows_ms"] = {R: timer(lambda R=R: da.paged_decode_attn(
            q, kp, vp, pos, table, rows_per_split=R, **kw))
            for R in ROWS_PER_SPLIT}
    row["plain_ms"] = timer(lambda: ref.paged_decode_attn_ref(
        q, kp, vp, pos, table, **kw))
    row["library_ms"] = timer(_sdpa(torch, q, rows_k, rows_v, pos))
    row["bound_ms"], row["bound_by"] = bound_ms(
        da.paged_bytes_moved(q, kp, pos, PAGE, S, kw.get("kv_bits")),
        da.paged_flops(q, pos, S))
    if B == SLOTS:      # after the timings: no profiler session before them
        row["kernels_per_call"] = _kernels_per_call(
            torch, lambda: da.paged_decode_attn(q, kp, vp, pos, table, **kw))
    bitwise = (f" vs contiguous kernel max|diff|="
               f"{row['contiguous_max_abs_err']:.1e}"
               if storage == "bf16" else "")
    print(f"[3 kernels] paged_decode_attn {storage} B={B} S={S} P={PAGE} "
          f"KVh={KVh} g={g} dh={dh} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} (SDPA on gathered rows) "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={row['max_abs_err']:.2e} tol={row['atol']:.2e} "
          f"vs split mirror {row['split_max_abs_err']:.2e} one pos "
          f"{row['one_pos_max_abs_err']:.2e}{_rows(row)}{bitwise} "
          f"{'ok' if row['ok'] else 'FAIL'}")
    return row

def _fq_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """The fake-quant kernels at the training path's shapes."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import ref
    rows, report, failures = [], {}, []
    for label, shape in FQ_SHAPES.items():
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16) * shape[0] ** -0.5
        g = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 1e-3
        for t in (1.0, 0.85):
            qp = init_quant_params(q_m=x.float().abs().max() * 0.9, bits=8.0,
                                   t=t)
            sc = (qp.d, qp.q_m, qp.t)
            y, want = fq.fake_quant_fwd(x, *sc), ref.fake_quant_fwd_ref(x, *sc)
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            # bitwise at every t: the kernel and torch.pow take one powf
            ok = torch.equal(y, want)
            row = {"kernel": "fake_quant.fwd", "w": label, "shape": shape,
                   "t": t, "max_abs_err": err, "bitwise": torch.equal(y, want),
                   "ok": ok, "library_ms": None,
                   "ms": timer(lambda: fq.fake_quant_fwd(x, *sc)),
                   "plain_ms": timer(lambda: ref.fake_quant_fwd_ref(x, *sc))}
            row["bound_ms"], row["bound_by"] = bound_ms(fq.fwd_bytes(x), 0)
            _one_kernel(torch, row, lambda: fq.fake_quant_fwd(x, *sc))
            rows.append(row)
            del y, want
            got = fq.fake_quant_bwd(x, *sc, g)
            want = ref.fake_quant_bwd_ref(x, *sc, g)
            torch.cuda.synchronize()
            again = fq.fake_quant_bwd(x, *sc, g)
            scales = fq.sum_scales(x, g, *sc)
            serr = [abs(float(a) - float(b)) / max(s, 1e-30)
                    for a, b, s in zip(got[1:], want[1:], scales)]
            dx_same = torch.equal(got[0], want[0])
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            brow = {"kernel": "fake_quant.bwd", "w": label, "shape": shape,
                    "t": t, "max_abs_err": (got[0].float()
                                            - want[0].float()).abs().max()
                    .item(), "dx_bitwise": dx_same,
                    "sum_err_over_scale": serr, "repeat_bitwise": repeat,
                    "ok": dx_same and repeat and max(serr) <= 1e-5,
                    "library_ms": None,
                    "ms": timer(lambda: fq.fake_quant_bwd(x, *sc, g)),
                    "plain_ms": timer(lambda: ref.fake_quant_bwd_ref(
                        x, *sc, g))}
            brow["bound_ms"], brow["bound_by"] = bound_ms(fq.bwd_bytes(x, g),
                                                          0)
            _one_kernel(torch, brow, lambda: fq.fake_quant_bwd(x, *sc, g))
            rows.append(brow)
            del got, want, again
            for r in (row, brow):
                print(f"[3 kernels] {r['kernel']:<29} {label:<6} "
                      f"{shape[0]}x{shape[1]} t={t} ms={r['ms']:.4f} "
                      f"plain_ms={r['plain_ms']:.4f} library_ms=none "
                      f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                      f"err={r['max_abs_err']:.2e}"
                      + (f" bitwise={r['bitwise']}" if "bitwise" in r else
                         f" dx_bitwise={r['dx_bitwise']} sums/scale="
                         f"{max(r['sum_err_over_scale']):.1e} repeat_bitwise="
                         f"{r['repeat_bitwise']}")
                      + f"{_per_call(r)} {'ok' if r['ok'] else 'FAIL'}")
                if not r["ok"]:
                    failures.append(r)
                if TRAIN_REPORT[r["kernel"]] == (label, t):
                    report[r["kernel"]] = r
                elif TRAIN_REPORT[r["kernel"]] == (label, 1.0):
                    report[r["kernel"] + ".at_t0.85"] = r
        del x, g
        torch.cuda.empty_cache()
    return rows, report, failures


def _operand(torch, gen, shape, transposed, scale=1.0):
    """A random bf16 (rows, cols) operand, row-major or the transposed view
    of a row-major (cols, rows) array."""
    rows, cols = shape
    t = torch.randn((cols, rows) if transposed else (rows, cols),
                    generator=gen, device="cuda",
                    dtype=torch.bfloat16) * scale
    return t.T if transposed else t


def _train_gemm_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """The GEMM core's training epilogues at the training path's shapes and
    layouts (M = 2048: the tensor-core variant)."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import gemm_core as gc
    rows, report, failures = [], {}, []
    for case in TRAIN_GEMMS:
        label, M, K, N, layout, t, bits = case
        x = _operand(torch, gen, (M, K), layout.startswith("x.T"))
        w = _operand(torch, gen, (K, N), layout.endswith("w.T"), K ** -0.5)
        mask = (torch.rand((N,), generator=gen, device="cuda") > 0.3).float()
        qp = init_quant_params(w, bits=float(bits), t=t)
        epi = {"none": gc.none(), "col_mask": gc.col_mask(mask),
               "fake_quant_rhs": gc.fake_quant_rhs(qp.d, qp.q_m, qp.t),
               "fq_col_mask": gc.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[label]
        # checked in f32 like the serving rows; timed in the path's out
        # dtype, bf16 (dwq is written in the weight's dtype, and its bf16
        # output must be the f32 output rounded, bit for bit)
        out = torch.bfloat16
        y = gc.gemm(x, w, epi, out_dtype=torch.float32)
        want = gc.plain(x, w, epi, torch.float32)
        rounded = torch.equal(gc.gemm(x, w, epi, out_dtype=out),
                              y.to(out))
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                  and torch.isfinite(y).all()) and rounded
        if label in ("col_mask", "fq_col_mask"):
            ok = ok and not y[:, mask == 0].any()
        del y, want
        w_lib = (w.float() * mask if label == "col_mask" else
                 gc.ref.fake_quant_weight(w.float(), qp.d, qp.q_m, qp.t)
                 * (mask if label == "fq_col_mask" else 1.0)
                 if label != "none" else w.float()).to(torch.bfloat16)
        variant = gc.variant(M, torch.bfloat16)
        row = {"kernel": f"gemm_core.{label}", "M": M, "K": K, "N": N,
               "layout": layout, "t": t, "bits": bits, "variant": variant,
               "out": str(out), "max_abs_err": err, "atol": tol,
               "bf16_is_f32_rounded": rounded, "ok": ok,
               "ms": timer(lambda: gc.gemm(x, w, epi, out_dtype=out)),
               "plain_ms": timer(lambda: gc.plain(x, w, epi, out)),
               "library_ms": timer(lambda: torch.matmul(x, w_lib))}
        row["bound_ms"], row["bound_by"] = bound_ms(
            gc.bytes_moved(M, N, K, 2, w, out.itemsize, epi),
            gc.flops(M, N, K))
        if variant == "tc":
            row["heights"] = _height_ms(
                timer, gc, lambda: gc.gemm(x, w, epi, out_dtype=out), M, N)
        _one_kernel(torch, row, lambda: gc.gemm(x, w, epi, out_dtype=out))
        rows.append(row)
        if not row["ok"]:
            failures.append(row)
        print(f"[3 kernels] {row['kernel']:<29} M={M:<4} K={K:<4} N={N:<5} "
              f"{layout} t={t} bits={bits} {variant} "
              f"out={str(out)[6:]} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"err={err:.2e} tol={tol:.2e} bf16_is_f32_rounded={rounded}"
              f"{_heights(row)}{_per_call(row)} "
              f"{'ok' if row['ok'] else 'FAIL'}")
        for name, key in TRAIN_REPORT.items():
            if key == case:
                report[name] = row
        if case == AT_T085:
            report["at_t0.85"] = row
        del x, w, w_lib
        torch.cuda.empty_cache()
    return rows, report, failures


def _simt_gemm_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """The SIMT variant (f32 x, f32 weights: the f32 configuration's
    operands, which keep f32 products) at the model's prefill and training
    rows, against its plain version at the same bounds."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import gemm_core as gc
    rows, report, failures = [], {}, []
    f32 = torch.float32
    for case in SIMT_GEMMS:
        label, M, K, N, t = case
        x = torch.randn((M, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        qp = init_quant_params(w, bits=8.0, t=t)
        epi = (gc.none() if label == "none" else
               gc.fake_quant_rhs(qp.d, qp.q_m, qp.t))
        y = gc.gemm(x, w, epi, out_dtype=f32)
        again = gc.gemm(x, w, epi, out_dtype=f32)
        want = gc.plain(x, w, epi, f32)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                  and torch.isfinite(y).all() and torch.equal(y, again))
        del y, again, want
        w_lib = (w if label == "none" else
                 gc.ref.fake_quant_weight(w, qp.d, qp.q_m, qp.t))
        row = {"kernel": f"gemm_core.{label}", "M": M, "K": K, "N": N,
               "t": t, "variant": gc.variant(M, f32), "out": str(f32),
               "max_abs_err": err, "atol": tol,
               "ok": ok and gc.variant(M, f32) == "simt",
               "ms": timer(lambda: gc.gemm(x, w, epi, out_dtype=f32)),
               "plain_ms": timer(lambda: gc.plain(x, w, epi, f32)),
               "library_ms": timer(lambda: torch.matmul(x, w_lib))}
        row["bound_ms"], row["bound_by"] = bound_ms(
            gc.bytes_moved(M, N, K, 4, w, 4, epi), gc.flops(M, N, K),
            F32_FLOP_PER_S)
        rows.append(row)
        if not row["ok"]:
            failures.append(row)
        print(f"[3 kernels] {row['kernel']:<29} M={M:<4} K={K:<4} N={N:<5} "
              f"t={t} f32 x, f32 w {row['variant']} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (f32) "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"err={err:.2e} tol={tol:.2e} {'ok' if row['ok'] else 'FAIL'}")
        if case == SIMT_REPORT:
            report["gemm_core.simt.fake_quant_rhs"] = row
        elif case[0] == "fake_quant_rhs" and t != 1.0:
            report["simt_at_t0.85"] = row
        del x, w, w_lib
        torch.cuda.empty_cache()
    return rows, report, failures


def phase_train_kernels(torch, timer) -> tuple[list, dict, list]:
    """Phase 3's training half: the fake-quant kernels and the GEMM's
    training variants at the full-width training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, report, failures = _fq_rows(torch, timer, gen)
    for part in (_train_gemm_rows, _simt_gemm_rows):
        r2, rep2, f2 = part(torch, timer, gen)
        rows, failures = rows + r2, failures + f2
        report.update(rep2)
    return rows, report, failures


def phase_correctness(torch) -> tuple[dict, list[str]]:
    """Full-width prefill vs sequential decode, and smoke card vs CPU.
    Returns the launch counts of the smoke config's card runs (f32: its
    prefill GEMMs take the SIMT variant) and the failures."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES, serve_on_devices,
                                           synthetic_prompts)
    from repro_torch.models.transformer import LM
    failures = []
    lm = LM(get_arch(ARCH))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, qparams, _ = prepare_serving(lm, lm.init(gen), compressed=True)
    prompt = torch.as_tensor(synthetic_prompts(lm.cfg, [32], seed=1)[0],
                             dtype=torch.int64, device="cuda")[None]
    cache = lm.init_cache(1, 32, dtype=torch.bfloat16, device="cuda")
    pre, _ = lm.prefill(params, qparams, cache, prompt)
    cache = lm.init_cache(1, 32, dtype=torch.bfloat16, device="cuda")
    for p in range(32):
        dec, _ = lm.decode_step(params, qparams, cache, prompt[:, p:p + 1], p)
    a, b = pre[0, -1].float(), dec[0, -1].float()
    diff = (a - b).abs().max().item()
    scale = a.abs().max().item()
    top2 = torch.topk(a, 2).values
    same_argmax = int(a.argmax()) == int(b.argmax())
    # bf16 activations through 24 layers, summed in another order
    # (prefill M = 32 vs decode M = 1 tiles): 2^-5 of the logit range
    ok = (same_argmax and diff <= scale / 32
          and bool(torch.isfinite(pre).all() and torch.isfinite(dec).all())
          and pre.shape == (1, 32, lm.cfg.vocab_padded))
    print(f"[4 correctness] full-width compressed prefill vs 32 decode "
          f"steps, last-position logits: max|diff|={diff:.4f} "
          f"max|logit|={scale:.4f} (tol {scale / 32:.4f}), top-2 gap "
          f"{(top2[0] - top2[1]).item():.4f}, argmax "
          f"{int(a.argmax())} vs {int(b.argmax())} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("prefill vs sequential decode")
    del params, qparams, cache, pre, dec
    torch.cuda.empty_cache()

    # the smoke config on both devices from the same weights
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        toks = serve_on_devices(ARCH, True, [6, 3, 9], 6, ["cpu", "cuda"],
                                max_slots=2, **kw)
        cpu, card = toks["cpu"], toks["cuda"]
        ok = all((cpu[r] == card[r]).all() for r in cpu)
        print(f"[4 correctness] smoke config {mode}: card tokens "
              f"{'equal' if ok else 'DIFFER FROM'} the CPU plain versions' "
              f"({sum(len(t) for t in cpu.values())} tokens)")
        if not ok:
            failures.append(f"smoke {mode} card vs cpu")
    counts = _nonzero(ops.launch_counts())
    simt = counts.get("gemm_core.simt", 0)
    print(f"[4 correctness] smoke config card launches {counts}: the f32 "
          f"prefill GEMMs on the SIMT variant {simt} times "
          f"{'ok' if simt > 0 else 'FAIL'}")
    if simt <= 0:
        failures.append("the SIMT variant never launched on the f32 path")
    return counts, failures


def phase_engine(torch) -> tuple[dict, dict, list[str]]:
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import WEIGHT_MODES, engine_serve
    expect = {"dense": "gemm_core.fake_quant_rhs",
              "compressed": "gemm_core.dequant",
              "packed_b4": "gemm_core.unpack_dequant"}
    failures, outs = [], {}
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        before = ops.launch_counts()
        stats = {}
        t0 = time.perf_counter()
        outs[mode] = engine_serve(ARCH, False, PROMPT_LENS, GEN,
                                  max_slots=SLOTS, verbose=False,
                                  device="cuda", stats=stats, **kw)
        wall = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        toks = outs[mode]
        ok = (len(toks) == len(PROMPT_LENS)
              and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                      for t in toks.values())
              and delta[expect[mode]] > 0 and delta["decode_attn"] > 0
              and delta["gemm_core.small_m"] > 0)
        print(f"[5 engine] {mode}: decode {stats['decode_tok_per_s']:.1f} "
              f"tok/s ({stats['decode_tokens']} tokens in "
              f"{stats['decode_s']:.3f} s, {stats['decode_steps']} steps), "
              f"prefill {stats['prefill_tok_per_s']:.1f} tok/s "
              f"({stats['prefill_tokens']} tokens in "
              f"{stats['prefill_s']:.3f} s), param_bytes "
              f"{stats['param_bytes']}, kv_bytes {stats['kv_bytes']}, "
              f"launches {_nonzero(delta)}, wall {wall:.1f} s "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"engine {mode}")
    counts = ops.launch_counts()
    print(f"[5 engine] main-path launch counts: {_nonzero(counts)}")
    for name in [*expect.values(), "decode_attn", "fake_quant.fwd",
                 "gemm_core.small_m", "gemm_core.tc"]:
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the main path")
    # each decode GEMM is one launch: over this run, the device kernels of
    # the small-M variant, counted from a profiler trace, equal its calls.
    # A call is counted only after its launch succeeded, so fewer kernels
    # than calls means the trace lost events (on the H100 one now and then
    # drops a few dozen of this run's ~60k): it is taken again, up to
    # three times.
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        before = ops.launch_counts()["gemm_core.small_m"]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ref_int8 = engine_serve(ARCH, False, PROMPT_LENS, GEN,
                                    max_slots=SLOTS, verbose=False,
                                    device="cuda", compressed=True,
                                    bits_init=4.0)
            torch.cuda.synchronize()
        calls = ops.launch_counts()["gemm_core.small_m"] - before
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == cuda and "gemm_small_m" in e.key)
        if kernels >= calls:
            break
    print(f"[5 engine] int8 run at 4-bit init: {calls} small-M GEMM calls, "
          f"{kernels} gemm_small_m kernels in the profiler trace "
          f"{'ok' if calls > 0 and kernels == calls else 'FAIL'}")
    if not (calls > 0 and kernels == calls):
        failures.append("a decode GEMM was not one launch")
    same = all((ref_int8[r] == outs["packed_b4"][r]).all() for r in ref_int8)
    print(f"[5 engine] packed 4-bit tokens "
          f"{'equal' if same else 'DIFFER FROM'} the int8 run at the same "
          f"4-bit quantizer init ({len(ref_int8)} requests x {GEN} tokens)")
    if not same:
        failures.append("packed tokens differ from int8 tokens")
    return counts, outs, failures


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _serve_paged(torch, prompts, kw) -> tuple[dict, dict]:
    """One paged engine at full width: build, submit, warm up, drain.
    Returns its tokens and stats, with the page-indirect launches per
    decode step counted over the drain."""
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import build_engine
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda",
                          paged=True, page_size=PAGE, **kw)
    for p in prompts:
        eng.submit(p, GEN)
    eng.warmup()
    before = ops.launch_counts()
    out = eng.run()
    paged = sum(v - before[k] for k, v in ops.launch_counts().items()
                if k.startswith("paged_decode_attn."))
    stats = dict(eng.stats, **eng.throughput(), kv_bytes=eng.kv_bytes(),
                 kv_pool_bytes=eng.kv_pool_bytes(),
                 paged_per_step=paged / max(eng.stats["decode_steps"], 1))
    del eng
    torch.cuda.empty_cache()
    return out, stats


def phase_paged(torch, contiguous: dict) -> tuple[dict, list[str]]:
    """The paged main path at full width (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import WEIGHT_MODES, synthetic_prompts
    failures = []
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    n_layers = get_arch(ARCH).n_layers

    def report(label, out, st, ok):
        full = (len(out) == len(prompts)
                and all(len(t) == GEN for t in out.values()))
        ok = ok and full and st["paged_per_step"] == n_layers
        print(f"[6 paged] {label}: decode {st['decode_tok_per_s']:.1f} tok/s "
              f"({st['decode_tokens']} tokens, {st['decode_steps']} steps), "
              f"prefill {st['prefill_tok_per_s']:.1f} tok/s "
              f"({st['prefills']} prefills, {st['prefix_hits']} prefix "
              f"hits), kv_bytes {st['kv_bytes']}, kv_pool_bytes "
              f"{st['kv_pool_bytes']}, paged_decode_attn launches per "
              f"decode step {st['paged_per_step']:.2f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"paged {label}")

    ops.reset_launch_counts()
    runs = {}
    for mode, kw in WEIGHT_MODES.items():
        out, st = _serve_paged(torch, prompts, kw)
        same = all((out[r] == contiguous[mode][r]).all() for r in out)
        report(f"{mode}, bf16 pages, tokens "
               f"{'equal' if same else 'DIFFER FROM'} the contiguous run's",
               out, st, same)
        runs[mode] = (out, st)
    bf16_out, bf16_st = runs["packed_b4"]
    for bits in (8, 4):
        out, st = _serve_paged(torch, prompts, dict(WEIGHT_MODES["packed_b4"],
                                                    kv_bits=bits))
        first = all(out[r][0] == bf16_out[r][0] for r in out)
        smaller = st["kv_pool_bytes"] < bf16_st["kv_pool_bytes"]
        report(f"packed_b4, int{bits} pages, first tokens "
               f"{'equal' if first else 'DIFFER FROM'} the bf16-page run's, "
               f"pool {st['kv_pool_bytes']} B vs {bf16_st['kv_pool_bytes']} "
               f"B", out, st, first and smaller)
    shared = [prompts[5] if i in SHARED else p for i, p in enumerate(prompts)]
    kw = WEIGHT_MODES["compressed"]
    want, st = _serve_paged(torch, shared, dict(kw, prefix_sharing=False))
    same = all((want[i] == want[SHARED[0]]).all() for i in SHARED)
    report(f"compressed, {len(SHARED)} of {len(shared)} requests on one "
           f"prompt, no prefix sharing: their tokens "
           f"{'agree' if same else 'DIFFER'}", want, st, same)
    got, st = _serve_paged(torch, shared, kw)
    same = all((got[r] == want[r]).all() for r in got)
    report(f"compressed, {len(SHARED)} of {len(shared)} requests on one "
           f"prompt, prefix sharing: tokens "
           f"{'equal' if same else 'DIFFER FROM'} the run without sharing",
           got, st, same and st["prefix_hits"] >= len(SHARED) - 1)
    counts = ops.launch_counts()
    print(f"[6 paged] main-path launch counts: {_nonzero(counts)}")
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", *PAGED_KERNELS):
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the paged path")
    if counts["decode_attn"]:
        failures.append("the paged path launched the contiguous kernel")
    return counts, failures


# every stage in 5 steps
COMP5 = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
             projection_steps=1, pruning_periods=2, pruning_steps=1,
             cooldown_steps=1)
COLMASK = ("attn.wq", "attn.wk", "attn.wv", "mlp.w_gate", "mlp.w_up")


def predicted_train_launches(lm, qasso, stages) -> dict:
    """Kernel launches of `train_loop` steps in `stages`: per step every
    routed projection (P of them) runs the fake_quant_rhs GEMM forward,
    again in the remat recompute, and for dx; its dwq runs with no
    epilogue; the fake-quant backward runs per projection and once for
    the head, whose forward quantizes once per step; a joint step also
    fake-quantizes each weight site's stacked tensor once (Alg 2 line
    18). No call splits K (M >= 2048), and every GEMM takes the
    tensor-core variant (bf16 x): `tc` counts them all, `simt` none."""
    P = lm.n_blocks * sum(n.startswith("blocks.")
                          for n in lm.quant_weight_names())
    passes = 2 + int(lm.cfg.remat)
    n = len(stages)
    return {"gemm_core.fake_quant_rhs": passes * P * n,
            "gemm_core.none": P * n, "gemm_core.tc": (passes + 1) * P * n,
            "fake_quant.bwd": (P + 1) * n,
            "fake_quant.fwd": n + len(qasso.weight_sites) * sum(
                s == 2 for s in stages)}


def predicted_colmask_launches(lm) -> dict:
    """One loss-and-gradient pass with `.colmask` on COLMASK's projections
    (C per layer of 7), with quantizers, then without; every GEMM on the
    tensor-core variant."""
    L, C = lm.n_blocks, len(COLMASK)
    fwd = 1 + int(lm.cfg.remat)
    gemms = {"gemm_core.fq_col_mask": C * L * fwd,
             "gemm_core.fake_quant_rhs": (7 - C) * L * fwd + 7 * L,
             "gemm_core.none": 7 * L + C * L,
             "gemm_core.col_mask": C * L * (fwd + 1)}
    return {**gemms, "gemm_core.tc": sum(gemms.values()),
            "fake_quant.bwd": 7 * L + 1, "fake_quant.fwd": 1}


def _colmask_params(torch, params, gen) -> tuple[dict, dict, dict]:
    """Three param dicts for COLMASK's stacked projections (L, K, N):
    `<name>.colmask` seeded random (L, N) masks that keep about 70% of the
    output columns; the masked columns zeroed in the weight, with all-ones
    `.colmask`s; and the masked columns zeroed, with no `.colmask`."""
    masked, ones, zeroed = dict(params), dict(params), dict(params)
    for k, w in params.items():
        if k.endswith(COLMASK) and w.ndim == 3:
            m = (torch.rand((w.shape[0], w.shape[2]), generator=gen,
                            device=w.device) > 0.3).float()
            masked[k + ".colmask"] = m
            zeroed[k] = ones[k] = w * m[:, None, :].to(w.dtype)
            ones[k + ".colmask"] = torch.ones_like(m)
    return masked, ones, zeroed


def _bitwise(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a, b)


def phase_train(torch) -> tuple[dict, dict, list[str]]:
    """Phase 7 (see the module docstring). Returns (launch counts of
    `train_loop`, launch counts of the `.colmask` step, failures)."""
    from repro_torch.configs import CompressionConfig, get_arch
    from repro_torch.core.quant import bit_width
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import LM
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return "ok" if ok else "FAIL"

    torch.use_deterministic_algorithms(True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hist = []
    t0 = time.perf_counter()
    state, qadg, qasso, losses = T.train_loop(
        ARCH, False, 5, TRAIN_BATCH, TRAIN_SEQ, seed=0,
        comp=CompressionConfig(**COMP5), verbose=False, device="cuda",
        history=hist)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lm_cfg = get_arch(ARCH)
    lm = LM(lm_cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, h in enumerate(hist):
        print(f"[7 train] step {i} stage {h['stage']} loss {h['loss']:.4f} "
              f"bits [{h['bits_min']:.2f}, {h['bits_max']:.2f}] sparsity "
              f"{h['sparsity_hard']:.4f} wall {h['wall_s']:.3f} s "
              f"{tokens / h['wall_s']:.1f} tok/s")
    stages = [h["stage"] for h in hist]
    keep = state["qstate"].keep_mask
    n_pruned = sum(int(torch.sum(v < 0.5)) for v in keep.values())
    b_l, b_u = qasso.cfg.bit_lower, qasso.cfg.bit_upper_final
    bits = [float(bit_width(q.d, q.q_m, q.t))
            for q in state["qparams"].values()]
    elem_keep = qasso._keep_elem_tree(state["params"], keep)
    nonzero_pruned = sum(int(torch.count_nonzero(
        p * (1.0 - elem_keep[k]).to(p.dtype)))
        for k, p in state["params"].items())
    print(f"[7 train] internlm2-1.8b full width bf16, batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, 5 steps in {wall:.2f} s, stages "
          f"{stages} {check(stages == [0, 1, 2, 2, 3], 'stage order')}, "
          f"losses finite "
          f"{check(all(math.isfinite(x) for x in losses), 'finite loss')}, "
          f"pruned units {n_pruned} of {qasso.total_units} (k_units "
          f"{qasso.k_units}) {check(n_pruned == qasso.k_units, 'sparsity')}"
          f", nonzero pruned elements {nonzero_pruned} "
          f"{check(nonzero_pruned == 0, 'pruned units zero')}, bits "
          f"[{min(bits):.3f}, {max(bits):.3f}] in [{b_l}, {b_u}] "
          f"{check(b_l - 1e-3 <= min(bits) and max(bits) <= b_u + 1e-3, 'bits')}"
          f", peak memory {peak:.2f} GiB "
          f"{check(peak < 60 * 1e9 / 2 ** 30, 'peak memory < 60 GB')}")
    want = predicted_train_launches(lm, qasso, stages)
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items() if v and k not in want}
    print(f"[7 train] launches {got} predicted {want} "
          f"{check(got == want and not others, 'train launch counts')}"
          + (f" unexpected {others}" if others else "")
          + f"; every GEMM on the tensor-core variant: tc "
          f"{counts['gemm_core.tc']}, simt {counts['gemm_core.simt']}, "
          f"small_m {counts['gemm_core.small_m']} "
          f"{check(counts['gemm_core.simt'] == 0, 'train GEMMs on tc')}")

    # one loss-and-gradient pass with .colmask params, quantized and not,
    # its launches counted from 0 on their own
    params, qparams = state["params"], state["qparams"]
    del state
    torch.cuda.empty_cache()
    batch = T.batch_for(lm_cfg, 0, 5, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    masked, ones, zeroed = _colmask_params(
        torch, params, torch.Generator(device="cuda").manual_seed(7))
    ops.reset_launch_counts()
    loss_q, gx, _ = T.loss_and_grads(lm, masked, qparams, batch)
    del gx
    loss_p, gx, _ = T.loss_and_grads(lm, masked, None, batch)
    del gx
    colmask_counts = _nonzero(ops.launch_counts())
    want_c = predicted_colmask_launches(lm)
    with torch.no_grad():
        ref_q = lm.loss(zeroed, qparams, batch)     # fake_quant_rhs on w*m
        ref_p = lm.loss(ones, None, batch)          # col_mask on w*m, m = 1
        lib_p = lm.loss(zeroed, None, batch)        # torch.matmul on w*m
        unmasked = lm.loss(params, qparams, batch)
    rel = abs(float(loss_p) - float(lib_p)) / abs(float(lib_p))
    moved = not torch.equal(unmasked, ref_q)
    print(f"[7 train] .colmask step, random masks keeping ~70% of the "
          f"columns: loss with quantizers {float(loss_q):.6f} vs zeroed "
          f"columns {float(ref_q):.6f} "
          f"{check(torch.equal(loss_q, ref_q), 'colmask loss bitwise')} "
          f"(bitwise; unmasked {float(unmasked):.6f}, masks move the loss "
          f"{check(moved, 'colmask masks move the loss')}); without "
          f"quantizers {float(loss_p):.6f} vs zeroed columns under an "
          f"all-ones mask {float(ref_p):.6f} "
          f"{check(torch.equal(loss_p, ref_p), 'colmask plain loss bitwise')}"
          f" (bitwise) and vs the torch.matmul path {float(lib_p):.6f} (rel "
          f"{rel:.1e}, tol 1e-3) {check(rel < 1e-3, 'colmask plain loss')}; "
          f"launches {colmask_counts} predicted {want_c} "
          f"{check(colmask_counts == want_c, 'colmask launch counts')}")
    del params, qparams, masked, ones, zeroed, batch
    torch.cuda.empty_cache()

    # two runs of a joint step 0 from one seeded state
    runs = []
    for _ in range(2):
        lm2, p, q, _, qa, s = T.init_geta(ARCH, False, seed=0, device="cuda",
                                          comp=T.JOINT_STEP0)
        b = T.batch_for(lm2.cfg, 0, 0, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
        p, q, s, m = T.make_geta_train_step(lm2, qa)(p, q, s, b)
        runs.append((p, q, s.redundant, s.keep_mask, m["loss"]))
        del s, b
        torch.cuda.empty_cache()
    (p0, q0, r0, k0, l0), (p1, q1, r1, k1, l1) = runs
    same = (all(_bitwise(torch, p0[k], p1[k]) for k in p0)
            and all(_bitwise(torch, getattr(q0[k], f), getattr(q1[k], f))
                    for k in q0 for f in ("d", "q_m", "t"))
            and all(_bitwise(torch, r0[k], r1[k])
                    and _bitwise(torch, k0[k], k1[k]) for k in r0)
            and _bitwise(torch, l0, l1))
    print(f"[7 train] two runs of a joint step 0 from one state: params, "
          f"quantizers, masks and loss {'bitwise equal' if same else 'DIFFER'}"
          f" {check(same, 'train step reproducible')}")
    del runs, p0, p1, q0, q1
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)

    # the smoke config's joint step (f32: its GEMMs take the SIMT
    # variant), card against the CPU plain versions
    ops.reset_launch_counts()
    runs = T.step_on_devices(ARCH, ["cpu", "cuda"])
    simt = ops.launch_counts()["gemm_core.simt"]
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    tol = T.STEP_TOLERANCES
    ok = diff["masks"] and all(diff[k] <= v for k, v in tol.items())
    print(f"[7 train] smoke config joint step, card vs CPU: masks "
          f"{'identical' if diff['masks'] else 'DIFFER'}, "
          + ", ".join(f"{k} {diff[k]:.1e} (tol {v:.0e})"
                      for k, v in tol.items())
          + f" {check(ok, 'smoke step card vs cpu')}; its GEMMs on the "
          f"SIMT variant {simt} times "
          f"{check(simt > 0, 'smoke step on the SIMT variant')}")

    # the same step with activation quantizers (each activation site
    # through the fake-quant kernels): masks and loss held, the rest
    # reported, since a rounding tie of an activation that the GEMMs'
    # summation order flips moves the step's params and quantizers
    comp = dataclasses.replace(T.JOINT_STEP0, act_quant=True)
    before = ops.launch_counts()["fake_quant.fwd"]
    runs = T.step_on_devices(ARCH, ["cpu", "cuda"], comp=comp)
    fwd = ops.launch_counts()["fake_quant.fwd"] - before
    n_act = sum(k.endswith(".aq") for k in runs["cuda"][1])
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    ok = diff["masks"] and diff["loss"] <= tol["loss"] and fwd >= n_act > 0
    print(f"[7 train] smoke config joint step with act_quant ({n_act} "
          f"activation sites, {fwd} fake_quant.fwd launches), card vs CPU: "
          f"masks {'identical' if diff['masks'] else 'DIFFER'}, loss "
          f"{diff['loss']:.1e} (tol {tol['loss']:.0e}) "
          f"{check(ok, 'act_quant smoke step card vs cpu')}; reported: "
          + ", ".join(f"{k} {diff[k]:.1e}" for k in (
              "params", "d", "q_m", "t", "act_d", "act_q_m", "act_t")))
    return counts, colmask_counts, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the kernel rows and launch counts here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # cuBLAS is deterministic only with a fixed workspace; phase 7 runs
    # under torch.use_deterministic_algorithms, which requires it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # full f32 in every PyTorch matmul and convolution: plain versions and
    # library yardsticks must not round through TF32 (the kernels never do)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    kind = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    rows, report, failures = phase_kernels(torch, timer)
    train_rows, train_report, train_failures = phase_train_kernels(torch,
                                                                   timer)
    rows += train_rows
    failures += train_failures
    del timer
    torch.cuda.empty_cache()
    failures = [f"{r['kernel']} {r}" for r in failures]
    smoke_counts, smoke_failures = phase_correctness(torch)
    failures += smoke_failures
    counts, outs, engine_failures = phase_engine(torch)
    failures += engine_failures
    paged_counts, paged_failures = phase_paged(torch, outs)
    failures += paged_failures
    train_counts, colmask_counts, train_fail = phase_train(torch)
    failures += train_fail

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"device": kind, "rows": rows, "launches": counts,
             "paged_launches": paged_counts, "train_launches": train_counts,
             "colmask_launches": colmask_counts,
             "smoke_launches": smoke_counts},
            indent=1, default=str))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    attn = ("src/repro_torch/kernels/csrc/decode_attn.cu",
            "src/repro/kernels/decode_attn.py:63")
    paged = ("src/repro_torch/kernels/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:238")
    gemm = ("src/repro_torch/kernels/csrc/gemm_core.cu",
            "src/repro/kernels/gemm_core.py:127")
    kernels = []
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", "decode_attn", *PAGED_KERNELS):
        row = report[name]
        src, replaces = (paged if name in PAGED_KERNELS else
                         attn if name == "decode_attn" else gemm)
        launches = (paged_counts if name in PAGED_KERNELS else counts)[name]
        shape = (f"M={row['M']} K={row['K']} N={row['N']}"
                 + (" bits=4" if "unpack" in name else "")
                 if name.startswith("gemm") else
                 f"B={row['B']} S={row['S']} KVh={row['KVh']} g={row['g']} "
                 f"dh={row['dh']}" + (f" P={row['P']}" if "P" in row else "")
                 + f" R={row['R']} q bf16, pos int64")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape, **({"variant": row["variant"]}
                               if "variant" in row else {}),
            # device kernels per call, read from a profiler trace
            "kernels_per_launch": row["kernels_per_call"],
            **({"rows_per_split_ms": row["rows_ms"],
                "at_S4096": row["at_S4096"]} if "at_S4096" in row else {})})
    fq_src = "src/repro_torch/kernels/csrc/fake_quant.cu"
    train_src = {"fake_quant.fwd": (fq_src,
                                    "src/repro/kernels/fake_quant.py:31"),
                 "fake_quant.bwd": (fq_src,
                                    "src/repro/kernels/fake_quant.py:45")}
    for name in (*TRAIN_REPORT, "gemm_core.simt.fake_quant_rhs"):
        row = train_report[name]
        src, replaces = train_src.get(name, gemm)
        key = row["kernel"]
        shape = (f"{row['w']} {row['shape'][0]}x{row['shape'][1]} bf16 "
                 f"t={row['t']}" if name.startswith("fake_quant") else
                 f"M={row['M']} K={row['K']} N={row['N']} "
                 f"{row.get('layout', 'x,w')} t={row['t']} out {row['out']}")
        # col_mask launches only in phase 7's .colmask step; phase 7 checks
        # that every training GEMM took the tensor-core variant; the SIMT
        # variant launches only for f32 x, in phase 4's smoke config runs
        launches = (smoke_counts["gemm_core.simt"] if "simt" in name else
                    (colmask_counts if "col_mask" in key else
                     train_counts)[key])
        extra = {}
        t85 = {"gemm_core.tc.fake_quant_rhs": "at_t0.85",
               "gemm_core.simt.fake_quant_rhs": "simt_at_t0.85"}.get(name)
        if t85 is not None:
            extra["at_t0.85"] = {k: train_report[t85][k] for k in (
                "ms", "plain_ms", "library_ms", "max_abs_err")}
        if name.startswith("fake_quant"):
            t85 = train_report[name + ".at_t0.85"]
            extra["at_t0.85"] = {k: t85[k] for k in (
                "ms", "plain_ms", "max_abs_err", "kernels_per_call")}
            # device kernels per call, read from a profiler trace
            extra["kernels_per_launch"] = row["kernels_per_call"]
        if "heights" in row:
            extra["block_height_ms"] = row["heights"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape, **({"variant": row["variant"]}
                               if "variant" in row else {}), **extra})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   K->N = 2048->2048, 2048->1024, 2048->8192, 8192->2048 and 2048->92672
   (and at M = 4 the widths phase 8's pruning leaves, 2048->5734 and
   5734->2048, in fake_quant_rhs, dequant and unpack_dequant b4, each
   weight stored as `prepare_serving` stores it: rows padded to 16 bytes;
   and at the heights of phase 9's verify pass, M = 12 and 20, on the
   tensor-core variant, in the same three epilogues over every
   projection shape of a verify pass: 2048->8192, 8192->2048,
   2048->92672, 2048->2048 and 2048->1024),
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
   (2048 x 92672 bf16), a w_gate slice (2048 x 8192 bf16) and phase 11's
   largest shapes in f32, VGG7's conv5 weight (3 x 3 x 512 x 512) and its
   first activation site (64 x 32 x 32 x 128), at t = 1 and
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
   GEMMs must launch the SIMT variant). Then the long sequences:
   `attention_blockwise` in f32 at the model's attention shapes (S 4096,
   block 512) against `attention_dense` at rtol 1e-5, atol 1e-5; a
   4096-token prompt prefilled through it (24 calls, one per layer), its
   last logits within 2^-5 of the logit range of the same prefill
   through the dense attention (bf16 activations: another summation
   order flips a bf16 rounding now and then) with the same argmax unless
   the top-2 gap is within twice that difference, then served by the
   engine for 8 tokens through graph windows, the first the blockwise
   prefill's argmax; and one loss-and-gradient pass at 1 x 4096 (16-bit
   quantizers, remat), every gradient finite, with its peak memory.
5. The main path: the continuous-batching engine serving internlm2-1.8b
   at full width in bf16 (24 layers, random weights from a seed) on 4
   slots, 8 requests, in the dense fake-quant, compressed int8 and packed
   4-bit modes. `warmup()` captures one CUDA graph per window length
   (1-32 steps) and `run()` decodes by replaying them. Each engine drains
   the requests three times: once for its stats, once (the first 4
   requests, 24 tokens each) under a profiler trace, and once through
   eager `step()`; the three must emit the same tokens, and no graph may
   be captured during a drain. The wrapper
   launch counts are zeroed right before and read right after; they count
   host calls, so a graph's calls count once, at capture: every kernel
   of the path must have counted, the GEMM's small-M variant (decode) and
   tensor-core variant (prefill) among them. From the trace, the device
   kernels must equal the eager calls of the drain (its prefills) plus
   each replayed window's captured calls: every small-M GEMM, the small-M
   GEMM of each epilogue (its first template argument), and the
   decode-attention split and combine kernels; every captured GEMM is a
   small-M one. Packed tokens must equal those of an int8 run with the
   same 4-bit quantizer init. Prints each engine's capture time, graph
   pool and peak memory.
6. The paged main path: the same engine and requests from the paged KV
   arena (pages of 16 rows), drained the same three ways with the same
   checks. With bf16 pages its tokens must equal phase 5's in each weight
   mode; packed 4-bit weights with int8 and with int4 pages must serve
   full-length outputs with the bf16 run's first tokens from a smaller
   pool; with 4 of the 8 requests on one prompt, prefix sharing must hit
   at least 3 times and leave the tokens of a run without sharing
   unchanged. The page-indirect split kernel must run 24 times (once per
   layer) per decode step of the traced drain, in every page storage of
   the path.
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
8. Pruned serving at full width: the engine of phase 5 on the subnet at
   magnitude masks of sparsity 0.3 (d_ff 8192 -> 5734 in every layer, 6
   of the 8 KV-head groups: 12 heads), phase 5's 8 requests, in the
   three weight modes over the contiguous arena, each drained the same
   three ways with phase 5's checks (graph windows equal eager steps and
   a traced drain; the trace's small-M kernels equal the host counts),
   the launch counts zeroed before the three engines and read after.
   Against phase 5, per mode: param_bytes, decode tok/s, and the block
   projections' bytes, which must equal the bytes the sliced widths
   predict (the heads fall by 2/8, the MLP units by 2458/8192: the units'
   sparsity is 0.3, the bytes' ~0.29); kv_bytes exactly 6/8 of phase 5's.
   Packed 4-bit tokens must equal an int8 run's at the same 4-bit init;
   packed 4-bit over bf16 pages the contiguous run's tokens, over int8
   pages full-length outputs with its first tokens from a smaller pool.
   Against the masked reference engine (the dense model with the pruned
   units multiplied by zero, same seed and quantizers): the first decode
   step's logits within 2^-5 of the logit range with the same argmax
   (bf16 sums over K 5734 and the masked 8192 split differently, so only
   the f32 smoke config is held to token identity; its card tests do),
   greedy-token agreement and first divergences printed. Then GETA's
   train-then-deploy path: phase 7's final params, quantizers and QASSO
   keep masks (exactly k_units pruned) through `construct_subnet`
   (sparsity, mean bits, code bytes printed), then `prepare_serving(
   keep_masks=..., compressed=True)` serves one request of 16 tokens
   through the engine, held to its masked reference the same way.
9. Speculative decoding and chunked prefill at full width (bf16, 4
   slots, phase 5's 8 requests). The pair `build_checkpoint_engines`
   builds: the magnitude-masked checkpoint at sparsity 0.5 as the target,
   served dense fake-quant b8 and as int8 codes, its s50 packed subnet as
   the draft, faithful (b8) and aggressive (b2), draft_k 4. Per engine:
   the first round's verify logits (by hand, then rolled back) against
   the plain engine's first decode step (within 2^-5 of the range, the
   same argmax unless the top-2 gap is within twice the difference);
   `warmup()` captures one graph per draft length of `_spec_ks()`; a
   drain of graph rounds (the measurement); then the first 4 requests
   (6 tokens each) three times, in graph rounds, in eager rounds with
   the rollback invariant after every round (both arenas' rows at and
   past each active slot's position zero) and in graph rounds under a
   profiler trace, equal tokens, the trace's small-M and tensor-core
   GEMMs and decode-attention kernels equal to the replayed graphs'
   captured calls plus the drain's eager ones; no capture in any drain;
   the k = 2 and 4 graphs (verify M = 12, 20) hold tensor-core GEMMs and
   replay. Printed: decode tok/s
   (committed tokens over round time), ms per round by k, acceptance
   (faithful must exceed aggressive), capture time, graph pool, kv_bytes
   of both arenas, peak memory, token agreement with the plain engine
   (graph windows) and first divergences (bf16: the verify pass sums in
   other tiles than the decode step, so token identity is held in f32,
   by the card tests). The faithful dense pair over bf16 pages must emit
   the contiguous pair's tokens, over int8 pages full-length outputs with
   its first tokens. Chunked prefill (chunk 128: 96 -> 64 + 32, 200 ->
   128 + 64 + 8) on the dense and packed 4-bit engines, contiguous and
   paged: the first token's logits of a chunked prefill against the
   one-shot prefill's (same rule), tokens against phase 5's one-shot
   engines (agreement printed), prefill tok/s against phase 5's, the
   one-step decode graph captured in `warmup()`; then the longest gap
   between two decode steps of a slot while a 512-token prompt is
   prefilled, chunked and one-shot, three runs each. The launch counts
   are zeroed before the phase and read after it.
10. The checkpointed, fault-tolerant run loop: `train_loop` on
   internlm2-1.8b at full width (d_model 2048, d_ff 8192, vocab 92544)
   with its depth cut to 4 of 24 layers (a checkpoint of the whole
   model, ~19 GB with AdamW's f32 moments, would take most of the
   phase to write), bf16, batch 4 x 512, 8 steps (warm-up 1, projection
   1 x 1, pruning 2 x 2, cool-down 2) under
   torch.use_deterministic_algorithms: once uninterrupted, once with a
   checkpoint every 5 steps and a failure injected at step 7, which
   restores step 5 and replays 5-7 across the joint stage's end. The
   final trees must be equal bit for bit (every leaf: params, quantizers,
   the QASSO state with its Python-int counters, the data key), the
   killed run's 10 losses the clean run's at each step, one restart, the
   stages in order, and each run's launch counts at
   `predicted_train_launches`. Prints the checkpoint's bytes, the save
   and restore seconds, the step walls past step 5 and peak memory; the
   checkpoint directory is removed.
11. The paper's substrates at the JAX package's full specs: VGG7 (widths
   128-512, fc 1024) with weight and activation quantizers (Table 4) and
   ResNet20 with weight quantizers (Table 2), each on batches of 64
   32 x 32 images (`image_batch`, NHWC), and the BERT encoder at its
   defaults (4 layers, d_model 256, 4 heads, d_ff 1024, vocab 8192) on
   `qa_batch` at 16 x 64 (Table 3's harness), each through 6 GETA steps
   (every stage) under torch.use_deterministic_algorithms. Checks: finite
   losses, stages in order, every site's bits in [b_l, b_u_final],
   exactly k_units pruned units, all zero, two runs of the first joint
   step from one state bitwise equal, the fake-quant launches at
   `predicted_substrate_launches` (each weight and activation site once
   forward and once backward a step, each weight once more in a joint
   step) and no GEMM kernel (convolutions and products are plain
   PyTorch, as they are plain XLA in the JAX package). Then
   `construct_subnet` and `model_bops` on the trained state; prints
   sparsity, mean bits, rel_bops, step walls, images or tokens per
   second and peak memory.
12. Two JSON lines: the kernel table, then the device line (last). A
   serving kernel's `launches` are the host counts of phases 5-6 (a
   graph's calls once, at capture), a pruned-shape GEMM row's those of
   phase 8, a verify-height row's those of phase 9 (the captures of its
   draft length's graphs, with `replayed_launches` the replays' kernels),
   the fake-quant rows at phase 11's shapes those of phase 11;
   `traced_device_launches` are its device kernels in their traced
   drains (for a GEMM epilogue the small-M kernels, for decode attention
   the split kernels).

Each phase prints its seconds.

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

import numpy as np

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
TRACE_GEN = 24            # tokens per request of phases 5-6's traced drains
TRACE_WARMUP = 64         # fill kernels that open each traced drain
PAGE = 16
SHARED = (1, 3, 5, 7)     # requests that carry request 5's prompt (200
                          # tokens: 12 full pages and a shared tail page)
PAGED_KERNELS = ("paged_decode_attn.bf16", "paged_decode_attn.int8",
                 "paged_decode_attn.int4")
REPORT_SHAPE = (4, 2048, 8192)      # the JSON line's GEMM row: w_gate at decode
PRUNE_SPARSITY = 0.3       # phase 8: d_ff 8192 -> 5734, 8 -> 6 KV heads
# phase 3's rows at those widths (M = 4): w_gate / w_up, then w_down
PRUNED_GEMMS = [(2048, 5734), (5734, 2048)]
PRUNED_EPIS = ("fake_quant_rhs", "dequant", "unpack_dequant_b4")
GETA_GEN = 16              # phase 8's request from phase 7's trained masks
# phase 3's rows at phase 9's verify heights (4 slots x (k + 1), k = 2, 4)
VERIFY_MS = [12, 20]
# every projection shape of a verify pass: w_gate / w_up, w_down, the head,
# wq / wo and wk / wv
VERIFY_SHAPES = [(2048, 8192), (8192, 2048), (2048, 92672), (2048, 2048),
                 (2048, 1024)]
# phase 8: the pruned engine's first decode-step logits against the masked
# reference's, in units of the reference's logit range: phase 4's bound for
# bf16 activations summed in another order (here K = 5734 against the
# masked K = 8192, split differently)
MASKED_TOL = 2 ** -5
TOKENS = 2048                        # training batch 4 x 512
TRAIN_BATCH, TRAIN_SEQ = 4, 512
FQ_SHAPES = {"head": (2048, 92672), "w_gate": (2048, 8192)}
# phase 11's largest fake-quant shapes, f32: VGG7's largest conv weight
# (conv5, HWIO) and its first activation site (relu0 at batch 64, NHWC)
CNN_FQ_SHAPES = {"vgg7_conv": (3, 3, 512, 512), "vgg7_act": (64, 32, 32, 128)}
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


def _report_name(label: str) -> str:
    """The kernel line's name of a GEMM epilogue row."""
    return ("gemm_core.unpack_dequant" if label.startswith("unpack") else
            f"gemm_core.{label}")


def _gemm_row(torch, timer, gc, label, x, w, epi, w_lib, tag="") -> dict:
    """One GEMM row of phase 3: the kernel against its plain version (a
    second call bitwise the first), its time, the plain version's, the
    library call's (torch.matmul on the decoded weight) and the bound;
    the tensor-core rows at both block heights, the small-M rows' kernels
    per call from a profiler trace."""
    (M, K), N = x.shape, w.shape[1]
    call = lambda: gc.gemm(x, w, epi, out_dtype=torch.float32)
    y, again = call(), call()
    want = gc.plain(x, w, epi, torch.float32)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
              and torch.isfinite(y).all() and torch.equal(y, again))
    row = {"kernel": f"gemm_core.{label}", "M": M, "K": K, "N": N,
           "variant": gc.variant(M, x.dtype), "max_abs_err": err,
           "atol": tol, "ok": ok}
    del y, again, want
    row["ms"] = timer(call)
    row["plain_ms"] = timer(lambda: gc.plain(x, w, epi, torch.float32))
    row["library_ms"] = timer(lambda: torch.matmul(x, w_lib))
    row["bound_ms"], row["bound_by"] = bound_ms(
        gc.bytes_moved(M, N, K, 2, w, 4, epi), gc.flops(M, N, K))
    if row["variant"] == "tc":
        row["heights"] = _height_ms(timer, gc, call, M, N)
    _one_kernel(torch, row, call)
    print(f"[3 kernels] {row['kernel']:<29} M={M:<3} K={K:<4} "
          f"N={N:<5} {row['variant']}{tag} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={err:.2e} tol={tol:.2e}{_heights(row)}"
          f"{_per_call(row)} {'ok' if row['ok'] else 'FAIL'}")
    return row


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
                row = _gemm_row(torch, timer, gc, label, xs[M], w, epi, w_lib)
                rows.append(row)
                if not row["ok"]:
                    failures.append(row)
                if (M, K, N) == REPORT_SHAPE and label in PRUNED_EPIS:
                    report[_report_name(label)] = row
            del w_lib
        del xs
        torch.cuda.empty_cache()
    # the decode rows at sparsity 0.3's widths, each weight stored as
    # prepare_serving stores it (rows padded to 16 bytes)
    for K, N in PRUNED_GEMMS:
        x = torch.randn((SLOTS, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            if label not in PRUNED_EPIS:
                continue
            row = _gemm_row(torch, timer, gc, label, x, gc.aligned_rows(w),
                            epi, dequantized(), tag=" (pruned, padded rows)")
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            report[f"{_report_name(label)}.pruned.{K}x{N}"] = row
        torch.cuda.empty_cache()
    # the verify pass's heights on the tensor-core variant
    for K, N in VERIFY_SHAPES:
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in VERIFY_MS}
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            if label not in PRUNED_EPIS:
                continue
            w_lib = dequantized()
            for M in VERIFY_MS:
                row = _gemm_row(torch, timer, gc, label, xs[M], w, epi,
                                w_lib, tag=" (verify)")
                rows.append(row)
                if not row["ok"] or row["variant"] != "tc":
                    failures.append(row)
                report[f"{_report_name(label)}.verify.M{M}.{K}x{N}"] = row
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
    cases = [(label, shape, torch.bfloat16)
             for label, shape in FQ_SHAPES.items()] + [
        (label, shape, torch.float32)
        for label, shape in CNN_FQ_SHAPES.items()]
    for label, shape, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=dtype) * shape[0] ** -0.5
        if label.endswith("_act"):          # a ReLU's output
            x = torch.relu(x)
        g = torch.randn(shape, generator=gen, device="cuda",
                        dtype=dtype) * 1e-3
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
                      f"{'x'.join(map(str, shape))} {str(dtype)[6:]} t={t} "
                      f"ms={r['ms']:.4f} "
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
                key = (r["kernel"] if TRAIN_REPORT[r["kernel"]][0] == label
                       else f"{r['kernel']}.{label}"
                       if label in CNN_FQ_SHAPES else None)
                if key is not None:
                    report[key if t == 1.0 else key + ".at_t0.85"] = r
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


_CAPTURES = [0]      # CUDA graph captures in this process
_TRACE_TAKES = []    # {"engine", "takes"} of every traced drain


def _count_captures(torch) -> None:
    """Count every CUDA graph capture as it starts (`torch.cuda.graph`)."""
    enter = torch.cuda.graph.__enter__

    def counted(self):
        _CAPTURES[0] += 1
        return enter(self)

    torch.cuda.graph.__enter__ = counted


def _gemm_tally(gc, tally):
    """Wrap `gc.gemm` so that each CUDA call adds one to tally[(variant,
    epilogue)]; returns the unwrapped function (restore it after)."""
    real = gc.gemm

    def tallied(x, w, epi, **kw):
        out = real(x, w, epi, **kw)
        if x.is_cuda:
            tally[(gc.variant(x.shape[0], x.dtype), epi.name)] += 1
        return out

    tallied.launches = real.launches
    gc.gemm = tallied
    return real


def _trace_drain(torch, eng, prompts, label, spec=False, gen=TRACE_GEN
                 ) -> tuple[dict, dict, int, int]:
    """Serve the first SLOTS prompts once more, `gen` tokens each
    (windows of 16, 4, 2 and 1 steps, or, `spec`, speculative rounds),
    under a profiler trace of the card. Returns the tokens, {kernel
    family: (kernels in the trace, launches expected)}, the decode
    steps traced and the takes the trace needed (also kept under
    `label` in _TRACE_TAKES, which the --out JSON holds). Expected are the eager calls the wrappers made during
    the drain (the prefills; no capture happens in it) plus each replayed
    graph's captured calls. Families: every small-M GEMM, the small-M
    GEMM of each epilogue (its first template argument; `spec`: every
    tensor-core GEMM instead, since a round's graph holds GEMMs of both
    variants, which the launch counts do not tell apart by epilogue), and
    the decode-attention split and combine kernels. The drain is short
    since a long trace loses events (on the
    H100, drains of 8 requests x 64 tokens, ~170k kernels each, came back
    a few to a few hundred kernels short in 6 of 10 engines); a trace
    that still lost some is taken again, up to three times. A session
    also lost its first few kernels now and then (the drain's first
    prefill GEMMs), so each starts with TRACE_WARMUP fill kernels,
    which no family counts."""
    from collections import Counter
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ops
    cuda = torch.autograd.DeviceType.CUDA
    for takes in range(1, 4):
        for p in prompts[:SLOTS]:
            eng.submit(p, gen)
        g0, h0, tally = (Counter(eng.graph_device_launches()),
                         ops.launch_counts(), Counter())
        steps0 = eng.stats["decode_steps"]
        real = _gemm_tally(gc, tally)
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                warm = torch.zeros(1, device="cuda")
                for _ in range(TRACE_WARMUP):
                    warm.fill_(1.0)
                torch.cuda.synchronize()
                out = eng.run()
                torch.cuda.synchronize()
        finally:
            gc.gemm = real
        names = Counter(e.name for e in prof.events() if e.device_type == cuda)
        replayed = Counter(eng.graph_device_launches()) - g0
        host = {k: v - h0[k] for k, v in ops.launch_counts().items()}
        attn = sum(v for k, v in host.items() if "decode_attn" in k) + sum(
            v for k, v in replayed.items() if "decode_attn" in k)
        fam = {"gemm_small_m": (
            sum(v for k, v in names.items() if "gemm_small_m" in k),
            sum(v for (var, _), v in tally.items() if var == "small_m")
            + replayed["gemm_core.small_m"])}
        if spec:
            fam["gemm_tc"] = (
                sum(v for k, v in names.items() if "gemm_tc" in k),
                sum(v for (var, _), v in tally.items() if var == "tc")
                + replayed["gemm_core.tc"])
        for epi in () if spec else ("fake_quant_rhs", "dequant",
                                    "unpack_dequant"):
            tag = f"gemm_small_m<{gc._EPI_CODE[epi]},"
            fam[f"gemm_small_m.{epi}"] = (
                sum(v for k, v in names.items() if tag in k.replace(" ", "")),
                tally[("small_m", epi)] + replayed[f"gemm_core.{epi}"])
        for kern in ("flash_decode_split", "flash_decode_combine"):
            fam[kern] = (sum(v for k, v in names.items() if kern in k), attn)
        if all(got >= want for got, want in fam.values()):
            break
    if not spec:
        # every captured GEMM of a window is a small-M one (M = the slots)
        fam["graph_gemms_small_m"] = (
            replayed["gemm_core.small_m"],
            sum(replayed[f"gemm_core.{e}"] for e in gc._EPI_CODE))
    _TRACE_TAKES.append({"engine": label, "takes": takes})
    return out, fam, eng.stats["decode_steps"] - steps0, takes


def _serve_full(torch, prompts, kw) -> tuple[dict, dict, list[str]]:
    """One engine at full width: build, submit, warm up (which captures
    the window graphs), drain; then the first requests again, shorter,
    under a profiler trace (`_trace_drain`), and all of them again through
    eager `step()`.
    Returns the first drain's tokens, its stats (with the capture's time,
    graph pool bytes, peak memory and the trace's families) and the
    failures: tokens that differ between the three drains, a capture
    inside a drain, a trace family off its expected count."""
    from repro_torch.launch.engine import build_engine
    failures = []
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda", **kw)
    for p in prompts:
        eng.submit(p, GEN)
    torch.cuda.reset_peak_memory_stats()
    eng.warmup()
    peak = torch.cuda.max_memory_allocated()
    captured = _CAPTURES[0]
    out = eng.run()
    stats = dict(eng.stats, **eng.throughput(), kv_bytes=eng.kv_bytes(),
                 kv_pool_bytes=eng.kv_pool_bytes(),
                 param_bytes=eng.param_bytes(),
                 param_alloc_bytes=eng.serving_meta["param_alloc_bytes"],
                 block_weight_bytes=_block_weight_bytes(eng.params),
                 sparsity=eng.serving_meta.get("sparsity"),
                 shapes=eng.lm.shapes[0],
                 graph_pool_bytes=eng.graph_pool_bytes, peak_bytes=peak,
                 graphs=sorted(eng.graphs), replays=dict(eng.replays))
    traced, fam, stats["traced_steps"], stats["trace_takes"] = _trace_drain(
        torch, eng, prompts, repr(kw))
    stats["trace"] = fam
    for p in prompts:
        eng.submit(p, GEN)
    eager = eng._drain(eng.step)
    if _CAPTURES[0] != captured:
        failures.append("a CUDA graph was captured inside run()")
    if sorted(eng.graphs) != eng.warmed_window_ks():
        failures.append("warmup() did not capture every window length")
    for name, (got, want) in fam.items():
        if got != want:
            failures.append(f"trace: {got} {name} kernels, {want} expected")
    stats["graph_eq_traced"] = _same(
        {r: out[r][:TRACE_GEN] for r in sorted(out)[:SLOTS]}, traced)
    stats["graph_eq_eager"] = _same(out, eager)
    if not (stats["graph_eq_traced"] and stats["graph_eq_eager"]):
        failures.append("graph-window tokens differ from a second drain or "
                        "from eager steps")
    del eng
    torch.cuda.empty_cache()
    return out, stats, failures


def _block_weight_bytes(params: dict) -> int:
    """Logical bytes of the served block projections (dense weights, codes
    or packed words; not the norms, not the scales)."""
    return sum(v.numel() * v.element_size() for k, v in params.items()
               if k.startswith("blocks.") and (".attn." in k or ".mlp." in k)
               and not k.endswith(".scale"))


def _predicted_block_bytes(cfg, shp, mode: str) -> int:
    """The block projections' bytes at the widths `shp` in a weight mode,
    from the shapes alone: weights in the config's dtype (dense), int8
    codes (compressed, 8-bit init) or 4-bit codes packed 8 to an int32
    word along K (packed_b4)."""
    D, dh = cfg.d_model, cfg.d_head
    Q, KV, F = shp.n_heads * dh, shp.n_kv_heads * dh, shp.d_ff
    mats = [(D, Q), (D, KV), (D, KV), (Q, D), (D, F), (D, F), (F, D)]
    item = 2 if cfg.dtype == "bfloat16" else 4
    per = {"dense": lambda K, N: item * K * N,
           "compressed": lambda K, N: K * N,
           "packed_b4": lambda K, N: 4 * -(-K // 8) * N}[mode]
    return cfg.n_layers * sum(per(K, N) for K, N in mats)


def _same(a: dict, b: dict) -> bool:
    """Two drains of the same requests emitted the same tokens, request by
    request in submission order (a later drain's requests have new ids)."""
    return len(a) == len(b) and all(
        np.array_equal(a[r], b[q]) for r, q in zip(sorted(a), sorted(b)))


def _graph_line(st) -> str:
    fam = st["trace"]
    return (f"graphs {st['graphs']} captured in {st['capture_s']:.2f} s, "
            f"pool {st['graph_pool_bytes'] / 2 ** 20:.1f} MiB, peak "
            f"{st['peak_bytes'] / 2 ** 30:.2f} GiB, replays {st['replays']}; "
            f"tokens {'equal' if st['graph_eq_eager'] else 'DIFFER FROM'} "
            f"eager step()'s and "
            f"{'equal' if st['graph_eq_traced'] else 'DIFFER FROM'} a "
            f"traced drain's ({SLOTS} requests x {TRACE_GEN} tokens, "
            f"{st['traced_steps']} steps, trace taken "
            f"{st['trace_takes']}x); trace kernels (seen, expected) "
            + ", ".join(f"{k} {v[0]}/{v[1]}" for k, v in fam.items()
                        if v[1]))


def phase_engine(torch) -> tuple[dict, dict, list[str], dict, dict]:
    """Phase 5 (see the module docstring). Returns the launch counts, the
    tokens per mode, the failures, the trace families summed over the
    modes and the stats per mode."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES, engine_serve,
                                           synthetic_prompts)
    expect = {"dense": "gemm_core.fake_quant_rhs",
              "compressed": "gemm_core.dequant",
              "packed_b4": "gemm_core.unpack_dequant"}
    failures, outs, seen, by_mode = [], {}, Counter(), {}
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        before = ops.launch_counts()
        t0 = time.perf_counter()
        toks, stats, fails = _serve_full(torch, prompts, kw)
        wall = time.perf_counter() - t0
        outs[mode], by_mode[mode] = toks, stats
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        fam = stats["trace"]
        epi = expect[mode].split(".")[1]
        ok = (not fails and len(toks) == len(PROMPT_LENS)
              and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                      for t in toks.values())
              and delta[expect[mode]] > 0 and delta["decode_attn"] > 0
              and delta["gemm_core.small_m"] > 0
              and fam[f"gemm_small_m.{epi}"][0] > 0
              and fam["flash_decode_split"][0] > 0)
        for name, (got, _) in fam.items():
            seen[name] += got
        print(f"[5 engine] {mode}: decode {stats['decode_tok_per_s']:.1f} "
              f"tok/s ({stats['decode_tokens']} tokens in "
              f"{stats['decode_s']:.3f} s, {stats['decode_steps']} steps), "
              f"prefill {stats['prefill_tok_per_s']:.1f} tok/s "
              f"({stats['prefill_tokens']} tokens in "
              f"{stats['prefill_s']:.3f} s), param_bytes "
              f"{stats['param_bytes']}, kv_bytes {stats['kv_bytes']}, host "
              f"launches "
              f"{_nonzero(delta)}, wall {wall:.1f} s; {_graph_line(stats)} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"engine {mode}: {fails}")
    counts = ops.launch_counts()
    print(f"[5 engine] main-path launch counts (host calls; a graph's "
          f"calls count once, at capture): {_nonzero(counts)}")
    for name in [*expect.values(), "decode_attn", "fake_quant.fwd",
                 "gemm_core.small_m", "gemm_core.tc"]:
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the main path")
    ref_int8 = engine_serve(ARCH, False, PROMPT_LENS, GEN, max_slots=SLOTS,
                            verbose=False, device="cuda", compressed=True,
                            bits_init=4.0)
    same = _same(ref_int8, outs["packed_b4"])
    print(f"[5 engine] packed 4-bit tokens "
          f"{'equal' if same else 'DIFFER FROM'} the int8 run at the same "
          f"4-bit quantizer init ({len(ref_int8)} requests x {GEN} tokens)")
    if not same:
        failures.append("packed tokens differ from int8 tokens")
    return counts, outs, failures, dict(seen), by_mode


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def phase_paged(torch, contiguous: dict) -> tuple[dict, list[str], dict]:
    """The paged main path at full width (see the module docstring)."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import WEIGHT_MODES, synthetic_prompts
    failures, seen = [], Counter()
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    n_layers = get_arch(ARCH).n_layers

    def serve(label, prompts, kw, check):
        out, st, fails = _serve_full(
            torch, prompts, dict(kw, paged=True, page_size=PAGE))
        split = st["trace"]["flash_decode_split"][0]
        per_step = split / max(st["traced_steps"], 1)
        storage = {None: "bf16", 8: "int8", 4: "int4"}[kw.get("kv_bits")]
        seen[f"flash_decode_split.{storage}"] += split
        full = (len(out) == len(prompts)
                and all(len(t) == GEN for t in out.values()))
        ok, what = check(out, st)
        ok = ok and full and not fails and per_step == n_layers
        for name, (got, _) in st["trace"].items():
            seen[name] += got
        print(f"[6 paged] {label}, {what}: decode "
              f"{st['decode_tok_per_s']:.1f} tok/s ({st['decode_tokens']} "
              f"tokens, {st['decode_steps']} steps), prefill "
              f"{st['prefill_tok_per_s']:.1f} tok/s ({st['prefills']} "
              f"prefills, {st['prefix_hits']} prefix hits), kv_bytes "
              f"{st['kv_bytes']}, kv_pool_bytes {st['kv_pool_bytes']}, "
              f"page-indirect split kernels per decode step (trace) "
              f"{per_step:.2f}; {_graph_line(st)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"paged {label}: {fails}")
        return out, st

    ops.reset_launch_counts()
    runs = {}
    for mode, kw in WEIGHT_MODES.items():
        runs[mode] = serve(
            f"{mode}, bf16 pages", prompts, kw,
            lambda out, st, mode=mode: (
                _same(out, contiguous[mode]),
                "tokens " + ("equal" if _same(out, contiguous[mode])
                             else "DIFFER FROM") + " the contiguous run's"))
    bf16_out, bf16_st = runs["packed_b4"]
    for bits in (8, 4):
        def quantized(out, st):
            first = all(out[r][0] == bf16_out[r][0] for r in out)
            smaller = st["kv_pool_bytes"] < bf16_st["kv_pool_bytes"]
            return first and smaller, (
                f"first tokens {'equal' if first else 'DIFFER FROM'} the "
                f"bf16-page run's, pool {st['kv_pool_bytes']} B vs "
                f"{bf16_st['kv_pool_bytes']} B")
        serve(f"packed_b4, int{bits} pages", prompts,
              dict(WEIGHT_MODES["packed_b4"], kv_bits=bits), quantized)
    shared = [prompts[5] if i in SHARED else p for i, p in enumerate(prompts)]
    kw = WEIGHT_MODES["compressed"]
    want, _ = serve(
        f"compressed, {len(SHARED)} of {len(shared)} requests on one prompt, "
        f"no prefix sharing", shared, dict(kw, prefix_sharing=False),
        lambda out, st: (all(_same({0: out[i]}, {0: out[SHARED[0]]})
                             for i in SHARED), "their tokens agree"))
    serve(f"compressed, {len(SHARED)} of {len(shared)} requests on one "
          f"prompt, prefix sharing", shared, kw,
          lambda out, st: (_same(out, want)
                           and st["prefix_hits"] >= len(SHARED) - 1,
                           "tokens equal the run without sharing"))
    counts = ops.launch_counts()
    print(f"[6 paged] main-path launch counts (host calls; a graph's calls "
          f"count once, at capture): {_nonzero(counts)}")
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", *PAGED_KERNELS):
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the paged path")
    if counts["decode_attn"]:
        failures.append("the paged path launched the contiguous kernel")
    return counts, failures, dict(seen)


def _first_step_logits(torch, eng, prompts, gen) -> "torch.Tensor":
    """Submit `prompts` (`gen` tokens each) to `eng`, admit them and return
    the (slots, V) f32 logits of its first batched decode step, on the
    slots' state as `run()` would stage it. The step writes the K/V rows
    `run()`'s first step writes again, so the engine may then be warmed
    up and run."""
    for p in prompts:
        eng.submit(p, gen)
    eng._admit()
    eng._stage()
    with torch.no_grad():
        logits, _ = eng.lm.decode_step(eng._run_params, eng._run_qparams,
                                       eng.caches, eng._static["tok"],
                                       eng._static["pos"], eng._pages())
    return logits[:, -1].float()


def _held_to_masked(torch, label, got, want, toks, ref_toks) -> tuple:
    """Phase 8's comparison of a pruned engine with its masked reference:
    the first decode step's logits within MASKED_TOL of the logit range
    with the same argmax per slot (checked), greedy-token agreement and
    the first divergence per request (printed). Returns (ok, line)."""
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    ok = diff <= MASKED_TOL * scale and same_argmax
    agree, first = [], []
    for r in sorted(ref_toks):
        a, b = toks[r], ref_toks[r]
        eq = a == b
        agree.append(float(eq.mean()))
        first.append(int(np.argmin(eq)) if not eq.all() else None)
    line = (f"{label}: first decode step's logits vs the masked reference "
            f"max|diff| {diff:.4f} of max|logit| {scale:.4f} (tol "
            f"{MASKED_TOL} x, {diff / max(scale, 1e-30):.2e}), argmax "
            f"{'equal' if same_argmax else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}; greedy tokens agree "
            f"{np.mean(agree):.3f} (per request {[round(a, 3) for a in agree]}"
            f"), first divergence {first}")
    return ok, line


def phase_pruned(torch, full: dict, geta) -> tuple[dict, list[str], dict]:
    """Phase 8 (see the module docstring). `full`: phase 5's stats per
    mode; `geta`: phase 7's final (params, qparams, keep masks). Returns
    the launch counts of the pruned main path, the failures and its trace
    families summed over the modes."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES,
                                           build_masked_reference_engine,
                                           engine_serve, synthetic_prompts)
    from repro_torch.models.layers import LayerShapes
    cfg = get_arch(ARCH)
    prompts = synthetic_prompts(cfg, PROMPT_LENS, seed=0)
    prune = dict(pruned=True, sparsity=PRUNE_SPARSITY)
    expect = {"dense": "gemm_core.fake_quant_rhs",
              "compressed": "gemm_core.dequant",
              "packed_b4": "gemm_core.unpack_dequant"}
    failures, seen, outs = [], Counter(), {}
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        before = ops.launch_counts()
        t0 = time.perf_counter()
        toks, st, fails = _serve_full(torch, prompts, dict(kw, **prune))
        wall = time.perf_counter() - t0
        outs[mode] = toks
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        for name, (got, _) in st["trace"].items():
            seen[name] += got
        f, shp = full[mode], st["shapes"]
        kv_ok = st["kv_bytes"] * cfg.n_kv_heads == f["kv_bytes"] * 6 \
            and shp.n_kv_heads == 6
        blk_want = (_predicted_block_bytes(cfg, shp, mode),
                    _predicted_block_bytes(cfg, LayerShapes.from_config(cfg),
                                           mode))
        blk_ok = (st["block_weight_bytes"], f["block_weight_bytes"]) == \
            blk_want and shp.d_ff == 5734
        epi = expect[mode].split(".")[1]
        ok = (not fails and kv_ok and blk_ok
              and abs(st["sparsity"] - PRUNE_SPARSITY) < 1e-3
              and len(toks) == len(PROMPT_LENS)
              and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                      for t in toks.values())
              and delta[expect[mode]] > 0 and delta["decode_attn"] > 0
              and st["trace"][f"gemm_small_m.{epi}"][0] > 0)
        print(f"[8 pruned] {mode} at sparsity {st['sparsity']:.4f} (d_ff "
              f"{shp.d_ff}, {shp.n_heads} heads, {shp.n_kv_heads} of "
              f"{cfg.n_kv_heads} KV heads): decode "
              f"{st['decode_tok_per_s']:.1f} tok/s vs phase 5's "
              f"{f['decode_tok_per_s']:.1f} ({st['decode_tokens']} tokens, "
              f"{st['decode_steps']} steps), prefill "
              f"{st['prefill_tok_per_s']:.1f} vs "
              f"{f['prefill_tok_per_s']:.1f} tok/s; param_bytes "
              f"{st['param_bytes']} vs {f['param_bytes']} (x"
              f"{st['param_bytes'] / f['param_bytes']:.4f}; allocated "
              f"{st['param_alloc_bytes']}), block weights "
              f"{st['block_weight_bytes']} vs {f['block_weight_bytes']} (x"
              f"{st['block_weight_bytes'] / f['block_weight_bytes']:.4f}, "
              f"predicted from the widths {blk_want}) "
              f"{'ok' if blk_ok else 'FAIL'}, kv_bytes {st['kv_bytes']} vs "
              f"{f['kv_bytes']} (6/8: {'ok' if kv_ok else 'FAIL'}); host "
              f"launches {_nonzero(delta)}, wall {wall:.1f} s; "
              f"{_graph_line(st)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"pruned {mode}: {fails}")
    counts = ops.launch_counts()
    print(f"[8 pruned] main-path launch counts (host calls; a graph's calls "
          f"count once, at capture): {_nonzero(counts)}; the tensor-core "
          f"prefill copied x {counts['gemm_core.copies']} times (w_down's "
          f"rows of 5734 bf16 = 11468 bytes)")
    for name in [*expect.values(), "decode_attn", "fake_quant.fwd",
                 "gemm_core.small_m", "gemm_core.tc"]:
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the pruned path")
    if counts["gemm_core.copies"] <= 0:
        failures.append("no x copy on the pruned prefill (w_down K 5734)")

    common = dict(max_slots=SLOTS, verbose=False, device="cuda", **prune)
    ref_int8 = engine_serve(ARCH, False, PROMPT_LENS, GEN, compressed=True,
                            bits_init=4.0, **common)
    same = _same(ref_int8, outs["packed_b4"])
    print(f"[8 pruned] packed 4-bit tokens "
          f"{'equal' if same else 'DIFFER FROM'} the int8 run's at the same "
          f"4-bit quantizer init {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("pruned packed tokens differ from int8 tokens")
    for kv_bits in (None, 8):
        st: dict = {}
        out = engine_serve(ARCH, False, PROMPT_LENS, GEN, paged=True,
                           page_size=PAGE, kv_bits=kv_bits, stats=st,
                           **WEIGHT_MODES["packed_b4"], **common)
        full_len = all(len(t) == GEN for t in out.values())
        if kv_bits is None:
            ok = full_len and _same(out, outs["packed_b4"])
            what = "tokens " + ("equal" if ok else "DIFFER FROM") + \
                " the contiguous run's"
            bf16_pool = st["kv_pool_bytes"]
        else:
            first = all(out[r][0] == outs["packed_b4"][q][0]
                        for r, q in zip(sorted(out), sorted(outs["packed_b4"])))
            ok = full_len and first and st["kv_pool_bytes"] < bf16_pool
            what = (f"full-length outputs, first tokens "
                    f"{'equal' if first else 'DIFFER FROM'} the contiguous "
                    f"run's, pool {st['kv_pool_bytes']} B vs bf16 pages' "
                    f"{bf16_pool} B")
        print(f"[8 pruned] packed_b4 over {'int8' if kv_bits else 'bf16'} "
              f"pages: {what}; decode {st['decode_tok_per_s']:.1f} tok/s, "
              f"kv_bytes {st['kv_bytes']} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"pruned paged kv_bits={kv_bits}")

    # the masked reference: the same model served dense with the pruned
    # units multiplied by zero; bf16 sums over K = 8192 (zeros included)
    # and K = 5734 split differently, so the logits are held to a bound
    ref, lm = build_masked_reference_engine(
        ARCH, False, sparsity=PRUNE_SPARSITY, max_slots=SLOTS,
        max_seq=max(PROMPT_LENS) + GEN, device="cuda")
    want = _first_step_logits(torch, ref, prompts, GEN)
    ref.warmup()
    ref_toks = ref.run()
    del ref
    torch.cuda.empty_cache()
    from repro_torch.launch.engine import build_engine
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda",
                          **prune)
    got = _first_step_logits(torch, eng, prompts[:SLOTS], GEN)
    del eng
    torch.cuda.empty_cache()
    ok, line = _held_to_masked(torch, "dense, magnitude masks", got,
                               want[:SLOTS], outs["dense"], ref_toks)
    print(f"[8 pruned] {line}")
    if not ok:
        failures.append("pruned vs masked reference logits")
    failures += _geta_serving(torch, *geta)
    return counts, failures, dict(seen)


def _geta_serving(torch, params, qparams, keep) -> list[str]:
    """Phase 7's trained model through `construct_subnet` and into the
    engine: QASSO's keep masks (exactly k_units pruned) slice it, its
    learned bit widths become codes; one request of GETA_GEN tokens is
    served compressed, held to the masked reference (the trained params,
    whose pruned units QASSO already zeroed, with the masks multiplied
    in, served dense with the trained quantizers)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.qadg import build_qadg
    from repro_torch.core.subnet import construct_subnet, prepare_serving
    from repro_torch.launch.engine import Engine, synthetic_prompts
    from repro_torch.models.transformer import LM
    cfg = get_arch(ARCH)
    lm = LM(cfg)
    qadg = build_qadg(lm.build_graph().graph)
    t0 = time.perf_counter()
    sub = construct_subnet(qadg, params, qparams, keep)
    codes = sum(v.numel() * v.element_size()
                for v in sub.int_weights.values())
    dense = sum(sub.params[k].numel() * sub.params[k].element_size()
                for k in sub.int_weights)
    m = sub.meta
    print(f"[8 pruned] GETA: construct_subnet on phase 7's trained params "
          f"and QASSO's keep masks in {time.perf_counter() - t0:.2f} s: "
          f"sparsity {m['sparsity']:.4f}, {m['n_sites']} sites at mean "
          f"{m['mean_bits']:.3f} bits ({m['mean_storage_bits']:.2f} "
          f"storage), {len(sub.int_weights)} weights as codes: {codes} B "
          f"vs {dense} B as sliced dense weights (x{codes / dense:.4f})")
    failures = []
    if abs(m["sparsity"] - PRUNE_SPARSITY) > 1e-3:
        failures.append("GETA subnet sparsity")
    del sub
    torch.cuda.empty_cache()
    prompt = synthetic_prompts(cfg, [128], seed=3)
    p, q, meta = prepare_serving(lm, params, qparams, keep_masks=keep,
                                 compressed=True)
    eng = Engine(lm, p, q, max_slots=1, max_seq=128 + GETA_GEN)
    masked = qadg.space.apply_masks(params, keep)
    ref = Engine(LM(cfg), masked, qparams, max_slots=1,
                 max_seq=128 + GETA_GEN)
    logits, toks = [], []
    for e in (eng, ref):
        logits.append(_first_step_logits(torch, e, prompt, GETA_GEN))
        e.warmup()
        toks.append(e.run())
    ok, line = _held_to_masked(torch, "GETA, QASSO's masks, compressed",
                               logits[0], logits[1], toks[0], toks[1])
    full = all(len(t) == GETA_GEN for t in toks[0].values())
    print(f"[8 pruned] {line}; served {GETA_GEN} tokens at sparsity "
          f"{meta['sparsity']:.4f}, param_bytes {meta['param_bytes']}, "
          f"kv_bytes {eng.kv_bytes()} {'ok' if ok and full else 'FAIL'}")
    if not (ok and full):
        failures.append("GETA subnet vs masked reference")
    del eng, ref, masked, p
    torch.cuda.empty_cache()
    return failures


# ------------------------------------------------------------------ phase 9
SPEC_SPARSITY = 0.5         # the checkpoint pair's masks and draft
SPEC_K = 4                  # draft_k: rounds of k in {0, 1, 2, 4}
SPEC_DRAFTS = {"faithful": 8.0, "aggressive": 2.0}    # the draft's bits
SPEC_TARGETS = {"dense": False, "compressed": True}   # compressed= target
CHUNK = 128                 # chunked prefill: 96 -> 64+32, 200 -> 128+64+8
GAP_PROMPT = 512            # the prompt prefilled while a slot decodes
SPEC_TOL = 2 ** -5          # bf16 logits summed in another order
# the short workload's tokens per request (its three drains: graph, eager,
# traced): a traced round holds ~8500 kernels, and a trace of ~200k (24
# tokens, the aggressive draft) came back short on the H100
SPEC_TRACE_GEN = 6
GAP_TRIALS = 3


def _logits_held(torch, got, want) -> tuple[bool, str]:
    """`got` within SPEC_TOL of `want`'s range, with `want`'s argmax in
    every row unless its top-2 gap is within twice the difference."""
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    top2 = torch.topk(want, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).min().item()
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    ok = diff <= SPEC_TOL * scale and (same or gap <= 2 * diff)
    return ok, (f"max|diff| {diff:.4f} of max|logit| {scale:.4f} "
                f"({diff / max(scale, 1e-30):.2e}, tol {SPEC_TOL}), argmax "
                f"{'equal' if same else 'DIFFERS'} (least top-2 gap "
                f"{gap:.4f})")


def _agreement(got: dict, want: dict) -> str:
    """Greedy-token agreement of two drains of the same requests and each
    request's first divergence (None: none)."""
    agree, first = [], []
    for r, q in zip(sorted(got), sorted(want)):
        n = min(len(got[r]), len(want[q]))
        eq = got[r][:n] == want[q][:n]
        agree.append(float(eq.mean()))
        first.append(int(np.argmin(eq)) if not eq.all() else None)
    return (f"tokens agree {np.mean(agree):.3f}, first divergences "
            f"{first}")


def _first_verify_logits(torch, eng, prompts, gen, k) -> "torch.Tensor":
    """Submit `prompts` to the speculative engine, admit, and run the
    first round's draft steps and verify pass by hand on the live arenas;
    return the verify logits of position 0 (the plain engine's first
    decode step's input), (slots, V) f32. The rows the pass wrote are
    rolled back, so the engine is as admission left it and may be warmed
    up and run."""
    from repro_torch.launch.speculative import rollback_rows
    for p in prompts:
        eng.submit(p, gen)
    eng._admit()
    eng._stage()
    tok, pos = eng._static["tok"], eng._static["pos"]
    d = eng.draft
    with torch.no_grad():
        t, p, props = tok, pos, []
        for _ in range(k + 1):
            lg, _ = d.lm.decode_step(eng._draft_params, eng._draft_qparams,
                                     eng.dcaches, t, p)
            t, p = lg[:, -1].argmax(-1)[:, None], p + 1
            props.append(t)
        chunk = torch.cat([tok] + props[:k], dim=1)
        logits, _ = eng.lm.verify_chunk(eng._run_params, eng._run_qparams,
                                        eng.caches, chunk, pos)
    rollback_rows(eng.caches, pos, pos + k)
    rollback_rows(eng.dcaches, pos, pos + k)
    return logits[:, 0].float()


def _never_drafted(torch, eng) -> bool:
    """Rows at and past every active slot's position are zero in both
    arenas (the contiguous ones: phase 9 checks its eager drains there)."""
    for slot, req in enumerate(eng.active):
        if req is None:
            continue
        pos = int(eng.pos[slot])
        for arena in (eng.caches, eng.dcaches):
            for c in arena.values():
                if torch.any(c[:, slot, pos:]):
                    return False
    return True


def _spec_line(eng, st) -> str:
    per_k = {k: round(1e3 * eng.spec_round_s[k] / n, 3)
             for k, n in sorted(eng.spec_rounds.items())}
    return (f"decode {st['decode_tok_per_s']:.1f} tok/s "
            f"({st['decode_tokens']} committed tokens in "
            f"{st['decode_s']:.3f} s, "
            f"{st['spec_steps']} rounds), acceptance "
            f"{st['acceptance_rate']:.3f} ({st['spec_accepted']}/"
            f"{st['spec_drafted']}), ms per round by k {per_k}, rounds by k "
            f"{dict(sorted(eng.spec_rounds.items()))}, capture "
            f"{st['capture_s']:.2f} s of {sorted(eng.graphs)}, graph "
            f"pool {eng.graph_pool_bytes / 2 ** 20:.1f} MiB, kv_bytes "
            f"{eng.kv_bytes()} (target {st['kv_target']} + draft "
            f"{st['kv_draft']}), peak {st['peak_bytes'] / 2 ** 30:.2f} GiB")


def _spec_engine(torch, target, draft, prompts, base_logits, base_toks,
                 **engine_kw) -> tuple[dict, dict, list[str]]:
    """One checkpoint pair's speculative engine at full width (see the
    module docstring): first-round verify logits against the plain
    engine's first step, warm-up (the round graphs), then graph rounds,
    eager rounds with the rollback invariant after each (contiguous
    only), and a short workload twice, untraced and under a profiler
    trace. Returns (tokens of the graph drain, stats, failures)."""
    from repro_torch.launch.speculative import build_checkpoint_engines
    failures = []
    spec, base, _ = build_checkpoint_engines(
        ARCH, False, sparsity=SPEC_SPARSITY, draft_bits=SPEC_DRAFTS[draft],
        draft_k=SPEC_K, max_slots=SLOTS, max_seq=max(PROMPT_LENS) + GEN,
        compressed=SPEC_TARGETS[target], device="cuda", **engine_kw)
    if base_logits is None:
        # the plain engine of the same target arrays, through phase 5's
        # graph windows
        base_logits = _first_step_logits(torch, base, prompts, GEN)
        base.warmup()
        base_toks = base.run()
        base_st = dict(base.stats, **base.throughput())
    else:
        base_st = None
    del base
    torch.cuda.empty_cache()
    if spec.paged:
        # its arenas are pools: the contiguous pair holds the logits
        for p in prompts:
            spec.submit(p, GEN)
        ok_logits, logit_line = True, "checked on the contiguous pair"
    else:
        got = _first_verify_logits(torch, spec, prompts, GEN, SPEC_K)
        ok_logits, logit_line = _logits_held(torch, got,
                                             base_logits[:SLOTS])
    torch.cuda.reset_peak_memory_stats()
    spec.warmup()
    captured = _CAPTURES[0]
    out = spec.run()
    st = dict(spec.stats, **spec.throughput(),
              kv_target=sum(c.numel() * c.element_size()
                            for c in spec.caches.values()),
              kv_draft=sum(c.numel() * c.element_size()
                           for c in spec.dcaches.values()),
              peak_bytes=torch.cuda.max_memory_allocated(),
              rounds=dict(spec.spec_rounds),
              round_s=dict(spec.spec_round_s),
              graph_pool_bytes=spec.graph_pool_bytes,
              replays=dict(spec.replays),
              graph_launches=spec.graph_launches)
    line = _spec_line(spec, st)
    full = (len(out) == len(prompts)
            and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                    for t in out.values()))
    eager_ok = None
    if not spec.paged:
        # the first SLOTS requests, SPEC_TRACE_GEN tokens each, three
        # times: graph rounds, eager rounds, graph rounds under a trace
        for p in prompts[:SLOTS]:
            spec.submit(p, SPEC_TRACE_GEN)
        short = spec.run()
        for p in prompts[:SLOTS]:
            spec.submit(p, SPEC_TRACE_GEN)
        eager_ok = True
        while spec.pending:
            spec.eager_step()
            eager_ok = eager_ok and _never_drafted(torch, spec)
        eager = spec._drain(spec.eager_step)
        st["graph_eq_eager"] = _same(short, eager)
        if not (eager_ok and st["graph_eq_eager"]):
            failures.append("graph rounds differ from eager rounds, or the "
                            "rollback left rows past pos")
        traced, fam, st["traced_steps"], st["trace_takes"] = _trace_drain(
            torch, spec, prompts, f"speculative {target}/{draft}",
            spec=True, gen=SPEC_TRACE_GEN)
        st["trace"] = fam
        st["graph_eq_traced"] = _same(short, traced)
        for name, (seen, want) in fam.items():
            if seen != want:
                failures.append(f"trace: {seen} {name} kernels, {want} "
                                f"expected")
        if not st["graph_eq_traced"]:
            failures.append("a traced drain's tokens differ from an "
                            "untraced drain's")
    if _CAPTURES[0] != captured:
        failures.append("a CUDA graph was captured inside a drain")
    if sorted(spec.graphs) != spec._spec_ks():
        failures.append("warmup() did not capture every draft length")
    for k in (2, 4):
        if spec.graph_launches[k].get("gemm_core.tc", 0) <= 0:
            failures.append(f"the k={k} verify took no tensor-core GEMM")
    if not (full and ok_logits):
        failures.append(f"outputs or first-round logits ({logit_line})")
    agree = _agreement(out, base_toks)
    kind = "paged " if spec.paged else ""
    checks = "" if eager_ok is None else (
        f"; {SLOTS} requests x {SPEC_TRACE_GEN} tokens in graph rounds == "
        f"in eager rounds {'yes' if st['graph_eq_eager'] else 'NO'} "
        f"(rollback invariant after every eager round "
        f"{'held' if eager_ok else 'BROKEN'}) == in traced graph rounds "
        f"{'yes' if st['graph_eq_traced'] else 'NO'} (trace taken "
        f"{st['trace_takes']}x; kernels "
        f"(seen, expected) "
        + ", ".join(f"{k} {v[0]}/{v[1]}" for k, v in st["trace"].items())
        + ")")
    print(f"[9 speculative] {kind}{target} target, {draft} draft "
          f"(s{100 * SPEC_SPARSITY:.0f}/b{SPEC_DRAFTS[draft]:.0f}, k "
          f"{SPEC_K}): {line}; first-round verify logits vs the plain "
          f"engine's first step: {logit_line}; vs the plain engine: "
          f"{agree}{checks} {'ok' if not failures else 'FAIL'}")
    st["base_logits"], st["base_toks"], st["base_stats"] = \
        base_logits, base_toks, base_st
    del spec
    torch.cuda.empty_cache()
    return out, st, failures


def _chunked_logits(torch, eng, prompt) -> tuple["torch.Tensor", ...]:
    """The first generated token's logits of `prompt` through the
    engine's chunked prefill (`verify_chunk` over `chunk_plan`) and
    through its one-shot prefill, f32, on fresh rows."""
    from repro_torch.launch.scheduler import chunk_plan
    toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
    with torch.no_grad():
        row, done = eng._fresh_row(), 0
        for c in chunk_plan(len(prompt), CHUNK):
            lg, _ = eng.lm.verify_chunk(eng._run_params, eng._run_qparams,
                                        row, toks[:, done:done + c], done,
                                        last_logit_only=True)
            done += c
        one, _ = eng.lm.prefill(eng._run_params, eng._run_qparams,
                                eng._fresh_row(), toks, last_logit_only=True)
    return lg[0, -1].float(), one[0, -1].float()


def _decode_gaps(torch, eng, chunked: bool) -> list[float]:
    """The longest interval (ms, host clock) between two decode steps of
    a slot that decodes while a GAP_PROMPT-token prompt arrives and is
    prefilled, in each of GAP_TRIALS runs: one-step decodes replaying the
    captured one-step window, the prompt prefilled one-shot at admission,
    or chunk by chunk between the steps."""
    from repro_torch.launch.engine import synthetic_prompts
    short, long_ = synthetic_prompts(eng.lm.cfg, [32, GAP_PROMPT], seed=5)
    real = eng._commit
    eng.submit(short, GEN)
    eng.warmup()
    eng.run()
    gaps = []
    for _ in range(GAP_TRIALS):
        stamps = []

        def commit(toks):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            real(toks)

        eng._commit = commit
        eng.submit(short, GEN)
        steps = 0
        while eng.pending:
            if steps == 8:
                eng.submit(long_, 8)
            if chunked:
                eng.step()
            else:
                eng._admit()
                if eng.n_active:
                    eng._stage()
                    eng._commit(eng._replay(1))
            steps += 1
        del eng._commit
        eng.run()
        gaps.append(1e3 * max(b - a for a, b in zip(stamps, stamps[1:])))
    return gaps


def phase_spec(torch, full: dict, one_shot: dict
               ) -> tuple[dict, list[str], dict, dict]:
    """Phase 9 (see the module docstring). `full`: phase 5's stats per
    mode; `one_shot`: phase 5's tokens per mode. Returns the launch
    counts of the phase, its failures, its trace families summed and the
    speculative engines' stats."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES, build_engine,
                                           synthetic_prompts)
    cfg = get_arch(ARCH)
    prompts = synthetic_prompts(cfg, PROMPT_LENS, seed=0)
    failures, seen, stats = [], Counter(), {}
    ops.reset_launch_counts()
    outs = {}
    for target in SPEC_TARGETS:
        base_logits = base_toks = None
        for draft in SPEC_DRAFTS:
            t0 = time.perf_counter()
            out, st, fails = _spec_engine(torch, target, draft, prompts,
                                          base_logits, base_toks)
            base_logits, base_toks = st["base_logits"], st["base_toks"]
            if st["base_stats"] is not None:
                b = st["base_stats"]
                print(f"[9 speculative] {target} target, plain engine "
                      f"(graph windows): decode {b['decode_tok_per_s']:.1f} "
                      f"tok/s ({b['decode_tokens']} tokens in "
                      f"{b['decode_s']:.3f} s)")
            print(f"[9 speculative] {target}/{draft}: wall "
                  f"{time.perf_counter() - t0:.1f} s")
            outs[target, draft] = out
            stats[target, draft] = st
            failures += [f"spec {target}/{draft}: {f}" for f in fails]
            for name, (got, _) in st.get("trace", {}).items():
                seen[name] += got
        acc = {d: stats[target, d]["acceptance_rate"] for d in SPEC_DRAFTS}
        ok = acc["faithful"] > acc["aggressive"]
        print(f"[9 speculative] {target} target: acceptance faithful "
              f"{acc['faithful']:.3f} vs aggressive {acc['aggressive']:.3f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{target}: faithful acceptance not above "
                            f"aggressive")
    replays = Counter()
    for st in stats.values():
        replays.update(st["replays"])
    for k in (2, 4):
        if replays[k] <= 0:
            failures.append(f"no round of draft length {k} (verify M = "
                            f"{SLOTS * (k + 1)}) replayed")
    # the faithful dense pair over pages
    for kv_bits in (None, 8):
        out, st, fails = _spec_engine(
            torch, "dense", "faithful", prompts,
            stats["dense", "faithful"]["base_logits"],
            stats["dense", "faithful"]["base_toks"], paged=True,
            page_size=PAGE, kv_bits=kv_bits)
        want = outs["dense", "faithful"]
        if kv_bits is None:
            ok = _same(out, want)
            what = "tokens " + ("equal" if ok else "DIFFER FROM") + \
                " the contiguous pair's"
        else:
            ok = all(len(t) == GEN for t in out.values()) and all(
                out[r][0] == want[q][0]
                for r, q in zip(sorted(out), sorted(want)))
            what = ("full-length outputs, first tokens "
                    + ("equal" if ok else "DIFFER FROM")
                    + " the contiguous pair's")
        print(f"[9 speculative] paged dense/faithful over "
              f"{'int8' if kv_bits else 'bf16'} pages: {what} "
              f"{'ok' if ok and not fails else 'FAIL'}")
        if not ok or fails:
            failures.append(f"paged spec kv_bits={kv_bits}: {fails}")
    # chunked prefill: logits of the first token, tokens against phase 5's
    # one-shot engines, prefill rate, and the decode gap
    for mode in ("dense", "packed_b4"):
        for paged in (False, True):
            kw = dict(WEIGHT_MODES[mode], max_slots=SLOTS,
                      max_seq=max(PROMPT_LENS) + GEN, device="cuda",
                      prefill_chunk=CHUNK)
            if paged:
                kw.update(paged=True, page_size=PAGE)
            eng, _ = build_engine(ARCH, False, **kw)
            lg, one = _chunked_logits(torch, eng, prompts[5])
            ok_l, logit_line = _logits_held(torch, lg[None], one[None])
            for p in prompts:
                eng.submit(p, GEN)
            captured = _CAPTURES[0]
            eng.warmup()
            out = eng.run()
            st = dict(eng.stats, **eng.throughput())
            ok = (ok_l and _CAPTURES[0] == captured + 1
                  and sorted(eng.graphs) == [1]
                  and all(len(t) == GEN for t in out.values())
                  and st["chunked_prefills"] == len(prompts))
            print(f"[9 chunked] {mode}, {'paged' if paged else 'contiguous'}"
                  f", chunk {CHUNK}: first token's logits, chunked prefill "
                  f"of {len(prompts[5])} tokens vs one-shot: {logit_line}; "
                  f"vs phase 5's one-shot engine: "
                  f"{_agreement(out, one_shot[mode])}; prefill "
                  f"{st['prefill_tok_per_s']:.1f} tok/s vs phase 5's "
                  f"{full[mode]['prefill_tok_per_s']:.1f} "
                  f"({st['prefill_chunks']} chunks), decode "
                  f"{st['decode_tok_per_s']:.1f} tok/s "
                  f"({st['decode_steps_mid_prefill']} steps mid-prefill) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"chunked {mode} paged={paged}")
            if mode == "dense" and not paged:
                gap_c = _decode_gaps(torch, eng, chunked=True)
            del eng
            torch.cuda.empty_cache()
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda")
    gap_o = _decode_gaps(torch, eng, chunked=False)
    del eng
    torch.cuda.empty_cache()
    print(f"[9 chunked] longest gap between two decode steps of a slot "
          f"while a {GAP_PROMPT}-token prompt is prefilled (dense, one-step "
          f"graph decodes; {GAP_TRIALS} runs each): chunked ({CHUNK}) "
          f"{[round(g, 2) for g in gap_c]} ms, one-shot "
          f"{[round(g, 2) for g in gap_o]} ms")
    counts = ops.launch_counts()
    print(f"[9 speculative] phase launch counts (host calls; a graph's "
          f"calls count once, at capture): {_nonzero(counts)}")
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", "gemm_core.small_m",
                 "gemm_core.tc", "decode_attn", "paged_decode_attn.bf16"):
        if counts[name] <= 0:
            failures.append(f"{name} never launched in phase 9")
    return counts, failures, dict(seen), stats


LONG_PROMPT = 4096     # past attn_block_threshold: attention_blockwise
LONG_GEN = 8


def phase_long(torch) -> list[str]:
    """Phase 4's full-width long-sequence checks (see the module
    docstring): a 4096-token prompt through `attention_blockwise`, and one
    loss-and-gradient pass at 1 x 4096."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.launch import train as T
    from repro_torch.launch.engine import Engine, synthetic_prompts
    from repro_torch.models import layers
    from repro_torch.models.transformer import LM
    failures = []
    calls = [0]
    blockwise = layers.attention_blockwise

    def counted(*a, **kw):
        calls[0] += 1
        return blockwise(*a, **kw)

    # the attention itself at the model's shapes, f32, against the dense
    gen = torch.Generator(device="cuda").manual_seed(4)
    cfg = get_arch(ARCH)
    q = torch.randn((1, LONG_PROMPT, cfg.n_heads, cfg.d_head), generator=gen,
                    device="cuda")
    k, v = (torch.randn((1, LONG_PROMPT, cfg.n_kv_heads, cfg.d_head),
                        generator=gen, device="cuda") for _ in range(2))
    got = blockwise(q, k, v, block=cfg.attn_block_size)
    want = layers.attention_dense(q, k, v)
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    print(f"[4 correctness] attention_blockwise f32 at S={LONG_PROMPT}, "
          f"block {cfg.attn_block_size}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV, dh {cfg.d_head} vs attention_dense: "
          f"max|diff| {err:.2e} (rtol 1e-5, atol 1e-5) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("attention_blockwise vs dense on the card")
    del q, k, v, got, want

    # a 4096-token prompt prefilled through attention_blockwise (bf16,
    # compressed weights), against the same prefill through the dense
    # attention, then served by the engine for LONG_GEN tokens
    lm = LM(cfg)
    params, qparams, _ = prepare_serving(
        lm, lm.init(torch.Generator(device="cuda").manual_seed(0)),
        compressed=True)
    prompt = synthetic_prompts(cfg, [LONG_PROMPT], seed=2)[0]
    toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
    layers.attention_blockwise = counted
    try:
        cache = lm.init_cache(1, LONG_PROMPT, dtype=torch.bfloat16,
                              device="cuda")
        blk, _ = lm.prefill(params, qparams, cache, toks, last_logit_only=True)
    finally:
        layers.attention_blockwise = blockwise
    dense_lm = LM(dataclasses.replace(cfg, attn_block_threshold=LONG_PROMPT))
    cache = lm.init_cache(1, LONG_PROMPT, dtype=torch.bfloat16, device="cuda")
    dense, _ = dense_lm.prefill(params, qparams, cache, toks,
                                last_logit_only=True)
    del cache
    a, b = blk[0, -1].float(), dense[0, -1].float()
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    top2 = torch.topk(b, 2).values
    gap = (top2[0] - top2[1]).item()
    # bf16 activations: the two attentions sum in another order, so a bf16
    # rounding of their outputs flips now and then and moves through 24
    # layers; 2^-5 of the logit range, as the prefill-vs-decode check; the
    # argmax must agree unless the top-2 gap is within twice the diff
    same_argmax = int(a.argmax()) == int(b.argmax()) or gap <= 2 * diff
    ok = (calls[0] == cfg.n_layers and diff <= scale / 32 and same_argmax
          and bool(torch.isfinite(blk).all()))
    print(f"[4 correctness] {LONG_PROMPT}-token prompt, full width "
          f"compressed: attention_blockwise calls {calls[0]} (one per "
          f"layer), last-position logits vs the dense attention's "
          f"max|diff| {diff:.4f} max|logit| {scale:.4f} (tol "
          f"{scale / 32:.4f}), argmax {int(a.argmax())} vs "
          f"{int(b.argmax())} (top-2 gap {gap:.4f}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("4096-token blockwise prefill")
    eng = Engine(lm, params, qparams, max_slots=1,
                 max_seq=LONG_PROMPT + LONG_GEN)
    rid = eng.submit(prompt, LONG_GEN)
    eng.warmup()
    out = eng.run()[rid]
    ok = (len(out) == LONG_GEN and out[0] == int(a.argmax())
          and 0 <= out.min() and out.max() < cfg.vocab_padded
          and sum(eng.replays.values()) > 0)
    print(f"[4 correctness] the {LONG_PROMPT}-token prompt served by the "
          f"engine: {len(out)} tokens {out.tolist()}, first = the blockwise "
          f"prefill's argmax, windows {dict(eng.replays)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("4096-token prompt through the engine")
    del eng, params, qparams, blk, dense
    torch.cuda.empty_cache()

    # one loss-and-gradient pass at 1 x 4096 (fake-quant training path)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    qparams = lm.init_qparams(params, bits_init=16.0)
    batch = T.batch_for(cfg, 0, 0, 1, LONG_PROMPT, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls[0] = 0
    layers.attention_blockwise = counted
    t0 = time.perf_counter()
    try:
        loss, gx, gq = T.loss_and_grads(lm, params, qparams, batch)
        torch.cuda.synchronize()
    finally:
        layers.attention_blockwise = blockwise
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = (bool(torch.isfinite(loss))
              and all(bool(torch.isfinite(g).all()) for g in gx.values())
              and all(bool(torch.isfinite(t).all()) for q in gq.values()
                      for t in (q.d, q.q_m, q.t)))
    # the forward and, under remat, its recompute in the backward
    want_calls = cfg.n_layers * (1 + int(cfg.remat))
    ok = finite and calls[0] == want_calls
    print(f"[4 correctness] loss and gradients at 1 x {LONG_PROMPT}, full "
          f"width bf16, 16-bit quantizers: loss {float(loss):.4f}, every "
          f"gradient finite {finite}, attention_blockwise calls {calls[0]} "
          f"(expected {want_calls}), wall {wall:.2f} s, peak memory "
          f"{peak:.2f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("1 x 4096 loss and gradients")
    del params, qparams, gx, gq, batch
    torch.cuda.empty_cache()
    return failures


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


def phase_train(torch) -> tuple[dict, dict, list[str], tuple]:
    """Phase 7 (see the module docstring). Returns (launch counts of
    `train_loop`, launch counts of the `.colmask` step, failures, the
    final params, quantizers and QASSO keep masks)."""
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
    geta = (params, qparams, keep)       # phase 8 serves the trained subnet
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
    del masked, ones, zeroed, batch
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
    return counts, colmask_counts, failures, geta


# ----------------------------------------------------------------- phase 10
RUN_LAYERS = 4          # phase 10's depth cut: 4 of 24 layers, widths full
RUN_STEPS, RUN_EVERY, RUN_FAIL = 8, 5, 7
# every stage in 8 steps: warm-up 1, projection 1 x 1, pruning 2 x 2,
# cool-down 2; the checkpoint at 5 holds the state after the first pruning
# period, and the replay of steps 5-6 crosses from the last joint step
# (which hard-zeroes G_R and freezes the keep mask) into cool-down
COMP8 = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
             projection_steps=1, pruning_periods=2, pruning_steps=2,
             cooldown_steps=2)


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _same_tree(torch, a, b) -> bool:
    """Two state trees equal leaf for leaf: structure, types, dtypes,
    devices and bits."""
    from repro_torch.checkpoint.checkpoint import tree_flatten
    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(
        (type(x) is type(y) and x.dtype == y.dtype and x.device == y.device
         and torch.equal(x, y)) if isinstance(x, torch.Tensor)
        else (type(x) is type(y) and x == y) for x, y in zip(la, lb))


def phase_run_loop(torch) -> tuple[dict, list]:
    """Phase 10 (see the module docstring). Returns the killed run's
    launch counts and the failures."""
    import shutil
    import tempfile
    from repro_torch.configs import CompressionConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import LM
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return "ok" if ok else "FAIL"

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    runs = {}
    try:
        for label, kw in (("clean", {}), ("killed", dict(
                ckpt_dir=tmp, checkpoint_every=RUN_EVERY,
                inject_failure_at=RUN_FAIL))):
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            hist, report = [], {}
            t0 = time.perf_counter()
            state, _, qasso, losses = T.train_loop(
                ARCH, False, RUN_STEPS, batch, seq, seed=0,
                comp=CompressionConfig(**COMP8), verbose=False,
                device="cuda", history=hist, report=report,
                layers=RUN_LAYERS, **kw)
            runs[label] = dict(
                state=state, qasso=qasso, losses=losses, hist=hist,
                report=report, counts=ops.launch_counts(),
                wall=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        runs["killed"]["bytes"] = _dir_bytes(Path(tmp) / f"step_{RUN_EVERY}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    clean, killed = runs["clean"], runs["killed"]
    cfg = get_arch(ARCH)
    lm = LM(dataclasses.replace(cfg, n_layers=RUN_LAYERS))
    stages = [h["stage"] for h in clean["hist"]]
    k_stages = [h["stage"] for h in killed["hist"]]
    result = killed["report"]["run_result"]
    tokens = batch * seq
    print(f"[10 run loop] internlm2-1.8b at full width (d_model "
          f"{lm.cfg.d_model}, d_ff {lm.cfg.d_ff}, vocab {lm.cfg.vocab}), "
          f"depth cut to {lm.cfg.n_layers} of {cfg.n_layers} layers, "
          f"{lm.cfg.dtype}, batch {batch}x{seq}, {RUN_STEPS} steps, "
          f"checkpoint every {RUN_EVERY}, a failure injected at step "
          f"{RUN_FAIL}")
    for i, h in enumerate(clean["hist"]):
        print(f"[10 run loop] clean step {i} stage {h['stage']} loss "
              f"{h['loss']:.6f} wall {h['wall_s']:.3f} s "
              f"{tokens / h['wall_s']:.1f} tok/s")
    same = _same_tree(torch, clean["state"], killed["state"])
    replay = clean["losses"][:RUN_FAIL] + clean["losses"][RUN_EVERY:]
    want_stages = stages[:RUN_FAIL] + stages[RUN_EVERY:]
    print(f"[10 run loop] killed run: {len(killed['losses'])} losses (want "
          f"{RUN_STEPS + RUN_FAIL - RUN_EVERY}), each the clean run's at its "
          f"step {check(killed['losses'] == replay, 'replayed losses')}; "
          f"restarts {result.restarts} "
          f"{check(result.restarts == 1, 'one restart')}; stages {stages}, "
          f"killed {k_stages} "
          f"{check(stages == [0, 1, 2, 2, 2, 2, 3, 3] and k_stages == want_stages, 'run loop stages')}"
          f"; final trees (params, quantizers, the QASSO state with its int "
          f"counters, rng) {'bitwise equal' if same else 'DIFFER'} "
          f"{check(same, 'killed run bitwise the clean run')}; losses finite "
          f"{check(all(math.isfinite(x) for x in clean['losses']), 'finite run-loop loss')}")
    save_s = killed["report"]["save_s"]
    restore_s = killed["report"]["restore_s"]
    walls = ", ".join(f"{h['wall_s']:.3f}" for h in clean["hist"][5:])
    print(f"[10 run loop] checkpoint at step {RUN_EVERY}: "
          f"{killed['bytes']} bytes ({killed['bytes'] / 2 ** 30:.2f} GiB); "
          f"save {', '.join(f'{s:.3f}' for s in save_s)} s, restore "
          f"{', '.join(f'{s:.3f}' for s in restore_s)} s "
          f"{check(len(save_s) == 1 and len(restore_s) == 1, 'one save, one restore')}"
          f"; clean step walls past step 5: {walls} s; runs {clean['wall']:.1f}"
          f" s clean, {killed['wall']:.1f} s killed; peak memory "
          f"{clean['peak']:.2f} GiB clean, {killed['peak']:.2f} GiB killed")
    for label, stg in (("clean", stages), ("killed", k_stages)):
        want = predicted_train_launches(lm, runs[label]["qasso"], stg)
        counts = runs[label]["counts"]
        got = {k: counts[k] for k in want}
        others = {k: v for k, v in counts.items() if v and k not in want}
        ok = got == want and not others
        print(f"[10 run loop] {label} run launches {got} predicted {want} "
              f"{check(ok, f'{label} run-loop launch counts')}"
              + (f" unexpected {others}" if others else ""))
    return killed["counts"], failures


# ----------------------------------------------------------------- phase 11
# the paper's substrates: every stage in 6 steps (warm-up 1, projection
# 2 x 1, pruning 2 x 1, cool-down 1) under `benchmarks/geta_experiments.py`'s
# choices (bits [4, 16], b_r 2, Adam, lr_quant 1e-3)
SUB_SCHED = dict(target_sparsity=0.35, bit_lower=4.0, bit_upper=16.0,
                 warmup_steps=1, projection_periods=2, projection_steps=1,
                 bit_reduction=2.0, pruning_periods=2, pruning_steps=1,
                 cooldown_steps=1, base_optimizer="adam", lr_quant=1e-3)
SUB_STAGES = [0, 1, 1, 2, 2, 3]
CNN_BATCH = 64
BERT_BATCH, BERT_SEQ = 16, 64


def substrates() -> list[dict]:
    """Phase 11's models at the JAX package's full specs: VGG7 with weight
    and activation quantizers (Table 4), ResNet20 with weight quantizers
    (Table 2), the BERT encoder at its defaults (Table 3's harness)."""
    from repro_torch.data.synthetic import image_batch, qa_batch
    from repro_torch.models import bert, cnn
    enc = bert.BertEncoder()

    def images(i):
        return image_batch(0, i, CNN_BATCH, device="cuda")

    return [dict(name=cnn.VGG7.name, model=cnn.CNN(cnn.VGG7), act_quant=True,
                 bits=16.0, lr=3e-3, unit="images", per_step=CNN_BATCH,
                 batch=images),
            dict(name=cnn.RESNET20.name, model=cnn.CNN(cnn.RESNET20),
                 act_quant=False, bits=16.0, lr=3e-3, unit="images",
                 per_step=CNN_BATCH, batch=images),
            dict(name="bert", model=enc, act_quant=False, bits=8.0, lr=2e-3,
                 unit="tokens", per_step=BERT_BATCH * BERT_SEQ,
                 batch=lambda i: qa_batch(0, i, BERT_BATCH, BERT_SEQ, enc.V,
                                          device="cuda"))]


def predicted_substrate_launches(qasso, stages, act_sites: int) -> dict:
    """Fake-quant launches of a substrate's steps: every weight site and
    every activation site its forward quantizes once forward and once
    backward; a joint step also fake-quantizes each weight site's params
    once (Alg 2 line 18). Convolutions and products are plain PyTorch: no
    GEMM kernel."""
    sites = len(qasso.weight_sites) + act_sites
    joint = sum(s == 2 for s in stages) * sum(
        len(s.quantized_params) for s in qasso.weight_sites)
    return {"fake_quant.fwd": sites * len(stages) + joint,
            "fake_quant.bwd": sites * len(stages)}


def _tally_fq_shapes(tally: dict):
    """Count the fake-quant wrappers' launches by "kernel shape" until
    the returned function is called: each call adds the difference of its
    wrapper's own count across the call."""
    from repro_torch.kernels import fake_quant as fq
    orig = {fq.FWD: fq.fake_quant_fwd, fq.BWD: fq.fake_quant_bwd}

    def wrap(direction):
        def call(x, *args):
            before = fq.launches[direction]
            out = orig[direction](x, *args)
            key = f"fake_quant.{direction} {'x'.join(map(str, x.shape))}"
            tally[key] = tally.get(key, 0) + fq.launches[direction] - before
            return out
        return call

    fq.fake_quant_fwd, fq.fake_quant_bwd = wrap(fq.FWD), wrap(fq.BWD)

    def restore():
        fq.fake_quant_fwd, fq.fake_quant_bwd = orig[fq.FWD], orig[fq.BWD]
    return restore


def phase_substrates(torch) -> tuple[dict, list]:
    """Phase 11 (see the module docstring). Returns, per model, the
    fake-quant launch counts and, under "by_shape", those launches by
    kernel and shape; and the failures."""
    from repro_torch.checkpoint import clone_tree
    from repro_torch.core.bops import model_bops
    from repro_torch.core.qadg import build_qadg
    from repro_torch.core.qasso import QASSO, QASSOConfig
    from repro_torch.core.quant import bit_width
    from repro_torch.core.subnet import construct_subnet
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.optim.schedules import constant
    failures, out = [], {}

    def check(ok, what):
        if not ok:
            failures.append(what)
        return "ok" if ok else "FAIL"

    torch.use_deterministic_algorithms(True)
    try:
        for sub in substrates():
            m, name = sub["model"], sub["name"]
            torch.cuda.reset_peak_memory_stats()
            params = m.init(torch.Generator(device="cuda").manual_seed(0))
            qparams = m.init_qparams(params, bits_init=sub["bits"],
                                     act_quant=sub["act_quant"])
            qadg = build_qadg(m.build_graph(act_quant=sub["act_quant"])
                              .graph)
            qadg.space.validate(params)
            qasso = QASSO(qadg.space, qadg.sites, QASSOConfig(**SUB_SCHED),
                          constant(sub["lr"]))
            state = qasso.init(params, qparams)
            step = T.make_geta_train_step(m, qasso)
            stages, losses, walls, snap, by_shape = [], [], [], None, {}
            ops.reset_launch_counts()
            restore = _tally_fq_shapes(by_shape)
            for i in range(qasso.cfg.total_steps):
                b = sub["batch"](i)
                if qasso.stage_index(i) == 2 and snap is None:
                    snap = (clone_tree(params), clone_tree(qparams),
                            clone_tree(state), b)
                t0 = time.perf_counter()
                params, qparams, state, met = step(params, qparams, state, b)
                losses.append(float(met["loss"]))         # syncs the device
                walls.append(time.perf_counter() - t0)
                stages.append(met["stage"])
            restore()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            # two runs of the first joint step from one state
            reps = [step(*clone_tree(snap[:3]), snap[3]) for _ in range(2)]
            (p0, q0, s0, m0), (p1, q1, s1, m1) = reps
            same = (_same_tree(torch, (p0, q0, s0.redundant, s0.keep_mask),
                               (p1, q1, s1.redundant, s1.keep_mask))
                    and torch.equal(m0["loss"], m1["loss"]))
            del reps, snap
            keep = state.keep_mask
            n_pruned = sum(int(torch.sum(v < 0.5)) for v in keep.values())
            elem_keep = qasso._keep_elem_tree(params, keep)
            nonzero = sum(int(torch.count_nonzero(
                p * (1.0 - elem_keep[k]).to(p.dtype)))
                for k, p in params.items())
            b_l, b_u = qasso.cfg.bit_lower, qasso.cfg.bit_upper_final
            bits = [float(bit_width(q.d, q.q_m, q.t))
                    for q in qparams.values()]
            act = sum(s.kind == "act" for s in qadg.sites)
            want = predicted_substrate_launches(qasso, stages, act)
            got = {k: counts[k] for k in want}
            gemm = {k: v for k, v in counts.items()
                    if k.startswith("gemm_core") and v}
            sn = construct_subnet(qadg, params, qparams, keep)
            macs = (m.layer_macs(BERT_BATCH, BERT_SEQ) if name == "bert"
                    else m.layer_macs(batch=1))
            bops = model_bops(qadg, params, qparams, macs, masks=keep)
            wall = statistics.median(walls)
            out[name] = dict(got, by_shape=by_shape)
            print(f"[11 substrates] {name}: {len(qadg.sites)} sites ({act} "
                  f"activation), {qasso.total_units} units, stages {stages} "
                  f"{check(stages == SUB_STAGES, f'{name} stages')}, losses "
                  f"{', '.join(f'{x:.4f}' for x in losses)} finite "
                  f"{check(all(math.isfinite(x) for x in losses), f'{name} finite loss')}"
                  f", pruned units {n_pruned} (k_units {qasso.k_units}) "
                  f"{check(n_pruned == qasso.k_units, f'{name} sparsity')}, "
                  f"nonzero pruned elements {nonzero} "
                  f"{check(nonzero == 0, f'{name} pruned units zero')}, bits "
                  f"[{min(bits):.3f}, {max(bits):.3f}] in [{b_l}, {b_u}] "
                  f"{check(b_l - 1e-3 <= min(bits) and max(bits) <= b_u + 1e-3, f'{name} bits')}"
                  f", two runs of a joint step from one state "
                  f"{'bitwise equal' if same else 'DIFFER'} "
                  f"{check(same, f'{name} step reproducible')}")
            tallied = {k: sum(v for key, v in by_shape.items()
                              if key.split()[0] == k) for k in want}
            at = {key: v for key, v in by_shape.items()
                  if key.split()[1] in {"x".join(map(str, sh))
                                        for sh in CNN_FQ_SHAPES.values()}}
            print(f"[11 substrates] {name}: launches {got} predicted {want} "
                  f"{check(got == want, f'{name} fake-quant launches')}, "
                  f"by shape {tallied} "
                  f"{check(tallied == got, f'{name} launches by shape')}"
                  + (f" ({at} at phase 3's CNN shapes)" if at else "") +
                  f", GEMM kernels {gemm or 'none'} "
                  f"{check(not gemm, f'{name} launched a GEMM kernel')}; "
                  f"construct_subnet sparsity {sn.meta['sparsity']:.4f} mean "
                  f"bits {sn.meta['mean_bits']:.3f}; rel_bops "
                  f"{bops['rel_bops']:.5f}; step wall median {wall:.4f} s "
                  f"({', '.join(f'{w:.4f}' for w in walls)}), "
                  f"{sub['per_step'] / wall:.1f} {sub['unit']}/s; peak "
                  f"memory {peak:.2f} GiB")
            del params, qparams, state, step
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out, failures


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

    t_phase = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        print(f"[{label}] phase seconds {now - t_phase[0]:.1f}")
        t_phase[0] = now

    kind = phase_device(torch)
    phase_build()
    lap("2 build")
    timer = Timer(torch)
    rows, report, failures = phase_kernels(torch, timer)
    train_rows, train_report, train_failures = phase_train_kernels(torch,
                                                                   timer)
    rows += train_rows
    failures += train_failures
    del timer
    torch.cuda.empty_cache()
    failures = [f"{r['kernel']} {r}" for r in failures]
    lap("3 kernels")
    _count_captures(torch)
    smoke_counts, smoke_failures = phase_correctness(torch)
    failures += smoke_failures
    failures += phase_long(torch)
    lap("4 correctness")
    counts, outs, engine_failures, seen, full_stats = phase_engine(torch)
    failures += engine_failures
    lap("5 engine")
    paged_counts, paged_failures, paged_seen = phase_paged(torch, outs)
    failures += paged_failures
    lap("6 paged")
    train_counts, colmask_counts, train_fail, geta = phase_train(torch)
    failures += train_fail
    lap("7 train")
    pruned_counts, pruned_fail, pruned_seen = phase_pruned(torch, full_stats,
                                                           geta)
    failures += pruned_fail
    del geta
    lap("8 pruned")
    spec_counts, spec_fail, spec_seen, spec_stats = phase_spec(
        torch, full_stats, outs)
    failures += spec_fail
    lap("9 speculative")
    torch.cuda.empty_cache()
    run_counts, run_fail = phase_run_loop(torch)
    failures += run_fail
    lap("10 run loop")
    sub_counts, sub_fail = phase_substrates(torch)
    failures += sub_fail
    lap("11 substrates")

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"device": kind, "rows": rows, "launches": counts,
             "paged_launches": paged_counts, "traced_kernels": seen,
             "paged_traced_kernels": paged_seen,
             "train_launches": train_counts,
             "pruned_launches": pruned_counts,
             "pruned_traced_kernels": pruned_seen,
             "colmask_launches": colmask_counts,
             "smoke_launches": smoke_counts,
             "spec_launches": spec_counts,
             "spec_traced_kernels": spec_seen,
             "run_loop_launches": run_counts,
             "substrate_launches": sub_counts,
             "trace_takes": _TRACE_TAKES,
             "spec_engines": {f"{t}/{d}": {
                 k: v for k, v in st.items()
                 if k not in ("base_logits", "base_toks", "base_stats")}
                 for (t, d), st in spec_stats.items()}},
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
        # the device kernels of phases 5-6's traced drains (graph replays
        # included), which the host counts see only at capture
        device = (paged_seen[f"flash_decode_split.{name.split('.')[1]}"]
                  if name in PAGED_KERNELS else
                  seen["flash_decode_split"] if name == "decode_attn" else
                  seen[f"gemm_small_m.{name.split('.')[1]}"]
                  + paged_seen[f"gemm_small_m.{name.split('.')[1]}"])
        shape = (f"M={row['M']} K={row['K']} N={row['N']}"
                 + (" bits=4" if "unpack" in name else "")
                 if name.startswith("gemm") else
                 f"B={row['B']} S={row['S']} KVh={row['KVh']} g={row['g']} "
                 f"dh={row['dh']}" + (f" P={row['P']}" if "P" in row else "")
                 + f" R={row['R']} q bf16, pos int64")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "traced_device_launches": device,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape, **({"variant": row["variant"]}
                               if "variant" in row else {}),
            # device kernels per call, read from a profiler trace
            "kernels_per_launch": row["kernels_per_call"],
            **({"rows_per_split_ms": row["rows_ms"],
                "at_S4096": row["at_S4096"]} if "at_S4096" in row else {})})
    # the decode GEMMs at sparsity 0.3's widths, launched by phase 8
    for K, N in PRUNED_GEMMS:
        for label in PRUNED_EPIS:
            base = _report_name(label)
            row = report[f"{base}.pruned.{K}x{N}"]
            epi = base.split(".")[1]
            kernels.append({
                "name": f"{base}.pruned.{K}x{N}", "route": "cuda",
                "source": gemm[0], "replaces": gemm[1],
                "launches": pruned_counts[base],
                "traced_device_launches": pruned_seen[f"gemm_small_m.{epi}"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={row['M']} K={K} N={N}"
                         + (" bits=4" if "unpack" in base else "")
                         + " rows padded to 16 bytes",
                "variant": row["variant"],
                "kernels_per_launch": row["kernels_per_call"]})
    # the verify heights, launched by phase 9's round graphs: a row's
    # launches are the captures of its draft length's graphs (host counts),
    # `replayed_launches` the kernels their replays ran
    for label, target in (("fake_quant_rhs", "dense"),
                          ("dequant", "compressed")):
        for M in VERIFY_MS:
            k = M // SLOTS - 1
            K, N = REPORT_SHAPE[1:]
            row = report[f"gemm_core.{label}.verify.M{M}.{K}x{N}"]
            engines = [st for (t, _), st in spec_stats.items()
                       if t == target]
            per_graph = [st["graph_launches"][k].get("gemm_core.tc", 0)
                         for st in engines]
            kernels.append({
                "name": f"gemm_core.{label}.verify.M{M}", "route": "cuda",
                "source": gemm[0], "replaces": gemm[1],
                "launches": sum(per_graph),
                "replayed_launches": sum(
                    n * st["replays"].get(k, 0)
                    for n, st in zip(per_graph, engines)),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={M} K={K} N={N} (verify, k={k})",
                "variant": row["variant"],
                "block_height_ms": row["heights"]})
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
    # the fake-quant kernels at phase 11's VGG7 shapes (f32): launches are
    # phase 11's VGG7 launches at the row's shape (conv5's weight site; the
    # relu0 and relu1 activation sites), over its len(SUB_STAGES) steps
    for base in ("fake_quant.fwd", "fake_quant.bwd"):
        for label, shape in CNN_FQ_SHAPES.items():
            row = train_report[f"{base}.{label}"]
            t85 = train_report[f"{base}.{label}.at_t0.85"]
            n = sub_counts["vgg7"]["by_shape"].get(
                f"{base} {'x'.join(map(str, shape))}", 0)
            kernels.append({
                "name": f"{base}.{label}", "route": "cuda", "source": fq_src,
                "replaces": train_src[base][1], "launches": n,
                "launches_per_step": n / len(SUB_STAGES),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"{label} {'x'.join(map(str, shape))} f32 t=1",
                "at_t0.85": {k: t85[k] for k in (
                    "ms", "plain_ms", "max_abs_err", "kernels_per_call")},
                "kernels_per_launch": row["kernels_per_call"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

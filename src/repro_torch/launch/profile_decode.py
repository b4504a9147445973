"""Where a decode step's time goes: host wall time per engine decode step
against the device time of the kernels it launched, at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--mode dense|compressed|packed_b4] [--paged] [--window K]
        [--pruned [--sparsity S]]

Serves internlm2-1.8b at full width with every one of its 4 slots holding
a 128-token prompt, then times 8 batched decode steps on the host clock
(each ends in a device sync) and profiles 8 more with `torch.profiler`
(the card's activity only).
Prints, per step: the wall time, the device busy time (the union of its
kernels' intervals: the decode-attention combine pass starts while its
split kernel runs), the device's idle share, the device ms and calls of
the small-M GEMM kernels (`gemm_small_m`, every decode projection and the
head) and of decode attention (the union of its split and combine
kernels), the top kernels by device time, and every kernel of those two
families by name with its device ms and calls per step. `--paged` serves
from the paged KV arena (bf16 pages of 16 rows); `--pruned` serves the
sliced subnet at magnitude masks of `--sparsity` (default 0.3: d_ff 5734,
6 of 8 KV heads). Needs a CUDA device.

Without `--window` the steps are the engine's eager `step()` decodes.
`--window K` times `run()`'s decode windows of K steps instead: the
engine's MAX_WINDOW set to K before `warmup()` and every budget a
multiple of K, 8 windows on the host clock (each ends in its one sync)
and 32 / K more profiled (at least one; a long trace loses events),
reported per step (a window's numbers over K), with
the engine's capture time and graph pool bytes where it captured its
windows as CUDA graphs. The window mode reads only the engine's
`warmup`, `_admit`, `_window` and `MAX_WINDOW`, so pointed at an older
checkout's package (`PYTHONPATH=OTHER/src python
src/repro_torch/launch/profile_decode.py --window 8`) it times that
engine's windows. A short profiler session runs before the engine is
built, so the tracer is up before any graph is captured.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.engine import (WEIGHT_MODES, build_engine,
                                       synthetic_prompts)

ARCH = "internlm2-1.8b"
SLOTS = 4
PROMPT_LEN = 128
STEPS = 8
WINDOWS = 8
PROFILED_STEPS = 32       # window mode: steps of the profiled windows
DECODE_ATTN = "flash_decode"     # the decode-attention kernels' names
SMALL_M = "gemm_small_m"         # the small-M GEMM kernels' names
ACTS = [torch.profiler.ProfilerActivity.CUDA]


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _union_ms(events) -> float:
    """Length of the union of the events' [start, end) device intervals."""
    total, covered = 0.0, float("-inf")
    for start, stop in sorted((ev.time_range.start, ev.time_range.end)
                              for ev in events):
        if stop > covered:
            total += stop - max(start, covered)
            covered = stop
    return total / 1e3


def _timed(fn, reps: int, profiled: int) -> tuple[float, object]:
    """(host ms of `reps` calls of fn, each ending in a sync; the profile
    of `profiled` more)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=ACTS) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    return wall_ms, prof


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=list(WEIGHT_MODES), default="compressed")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV arena")
    ap.add_argument("--window", type=int, default=None, metavar="K",
                    help="time run()'s decode windows of K steps")
    ap.add_argument("--pruned", action="store_true",
                    help="serve the sliced subnet at --sparsity")
    ap.add_argument("--sparsity", type=float, default=0.3)
    args = ap.parse_args(argv)
    # an older engine's build_engine may not take the pruned keywords
    prune = (dict(pruned=True, sparsity=args.sparsity) if args.pruned
             else {})
    k = args.window or 1
    with torch.profiler.profile(activities=ACTS):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    reps = WINDOWS if args.window else STEPS
    profiled = max(1, PROFILED_STEPS // k) if args.window else STEPS
    gen = 1 + k * (2 + reps + profiled)
    eng, lm = build_engine(ARCH, False, max_slots=SLOTS,
                           max_seq=PROMPT_LEN + gen, device="cuda",
                           paged=args.paged, **WEIGHT_MODES[args.mode],
                           **prune)
    for p in synthetic_prompts(lm.cfg, [PROMPT_LEN] * SLOTS):
        eng.submit(p, gen)
    if args.window:
        eng.MAX_WINDOW = k       # every window k steps
    torch.cuda.reset_peak_memory_stats()
    eng.warmup()
    eng._admit()
    fn = eng._window if args.window else eng._act_decode
    for _ in range(2):
        fn()
    wall_ms, prof = _timed(fn, reps, profiled)
    wall_ms /= reps * k
    steps = profiled * k
    # device-side events only: a CPU op's device time repeats its kernels'
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, _device_us(e) / 1e3 / steps, e.count // steps)
                      for e in prof.key_averages()
                      if e.device_type == cuda and _device_us(e) > 0),
                     key=lambda r: -r[1])
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_ms = _union_ms(device_events) / steps
    attn = [r for r in kernels if DECODE_ATTN in r[0]]
    attn_ms = _union_ms([e for e in device_events
                         if DECODE_ATTN in e.key]) / steps
    gemm = [r for r in kernels if SMALL_M in r[0]]
    out = {"mode": args.mode, "paged": args.paged, "window": args.window,
           "sparsity": args.sparsity if args.pruned else None,
           "kv_bytes": eng.kv_bytes(), "param_bytes": eng.param_bytes(),
           "wall_ms_per_step": wall_ms, "device_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "decode_tok_per_s": SLOTS / wall_ms * 1e3,
           "small_m_ms_per_step": sum(ms for _, ms, _ in gemm),
           "small_m_calls_per_step": sum(n for *_, n in gemm),
           "decode_attn_ms_per_step": attn_ms,
           "kernels_per_step": len(device_events) / steps,
           "capture_s": eng.stats.get("capture_s"),
           "graph_pool_bytes": getattr(eng, "graph_pool_bytes", None),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    arena = "paged" if args.paged else "contiguous"
    if args.pruned:
        arena += f", pruned at sparsity {args.sparsity}"
    what = (f"decode window of {k} steps" if args.window else
            "decode step (eager)")
    print(f"{ARCH} [{args.mode}, {arena} arena] {what} on "
          f"{torch.cuda.get_device_name(0)}, {SLOTS} slots at prompt "
          f"{PROMPT_LEN}: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms/step, idle share {out['idle_share']:.3f}, "
          f"decode {out['decode_tok_per_s']:.1f} tok/s, "
          f"{out['kernels_per_step']:.1f} kernels/step")
    graphs = getattr(eng, "graphs", None)
    print(f"  graphs: {sorted(graphs) if graphs else 'none (eager window)'}"
          f", capture {out['capture_s']} s, graph pool "
          f"{out['graph_pool_bytes']} B, peak allocated "
          f"{out['peak_bytes']} B")
    print(f"  small-M GEMMs ({SMALL_M}): {out['small_m_ms_per_step']:.4f} "
          f"ms/step of device time, {out['small_m_calls_per_step']} "
          f"calls/step")
    print(f"  decode attention: {attn_ms:.4f} ms/step of device time (the "
          f"union of its kernels), {sum(n for *_, n in attn)} calls/step")
    for name, ms, n in kernels[:12]:
        print(f"  {ms:9.4f} ms/step  {n:5d} calls/step  {name[:90]}")
    for label, family in (("small-M GEMM", gemm), ("decode attention", attn)):
        print(f"  {label} kernels:")
        for name, ms, n in family:
            print(f"  {ms:9.4f} ms/step  {n:5d} calls/step  {name[:90]}")
    return out


if __name__ == "__main__":
    main()

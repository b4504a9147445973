"""Where a decode step's time goes: host wall time per engine decode step
against the device time of the kernels it launched, at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--mode dense|compressed|packed_b4] [--paged]

Serves internlm2-1.8b at full width with every one of its 4 slots holding
a 128-token prompt, then times 8 batched decode steps on the host clock
(each ends in a device sync) and profiles 8 more with `torch.profiler`.
Prints, per step: the wall time, the device busy time (the union of its
kernels' intervals: the decode-attention combine pass starts while its
split kernel runs), the device's idle share, the device ms and calls of
the small-M GEMM kernels (`gemm_small_m`, every decode projection and the
head) and of decode attention (the union of its split and combine
kernels), the top kernels by device time, and every kernel of those two
families by name with its device ms and calls per step. `--paged` serves
from the paged KV arena (bf16 pages of 16 rows). Needs a CUDA device.
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
DECODE_ATTN = "flash_decode"     # the decode-attention kernels' names
SMALL_M = "gemm_small_m"         # the small-M GEMM kernels' names


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=list(WEIGHT_MODES), default="compressed")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV arena")
    args = ap.parse_args(argv)
    gen = 2 * STEPS + 4
    eng, lm = build_engine(ARCH, False, max_slots=SLOTS,
                           max_seq=PROMPT_LEN + gen, device="cuda",
                           paged=args.paged, **WEIGHT_MODES[args.mode])
    for p in synthetic_prompts(lm.cfg, [PROMPT_LEN] * SLOTS):
        eng.submit(p, gen)
    eng.warmup()
    eng._admit()
    for _ in range(2):
        eng._act_decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng._act_decode()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            eng._act_decode()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, _device_us(e) / 1e3 / STEPS, e.count // STEPS)
                      for e in prof.key_averages()
                      if e.device_type == cuda and _device_us(e) > 0),
                     key=lambda r: -r[1])
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_ms = _union_ms(device_events) / STEPS
    attn = [k for k in kernels if DECODE_ATTN in k[0]]
    attn_ms = _union_ms([e for e in device_events
                         if DECODE_ATTN in e.key]) / STEPS
    gemm = [k for k in kernels if SMALL_M in k[0]]
    out = {"mode": args.mode, "paged": args.paged, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "small_m_ms_per_step": sum(ms for _, ms, _ in gemm),
           "small_m_calls_per_step": sum(n for *_, n in gemm),
           "decode_attn_ms_per_step": attn_ms}
    arena = "paged" if args.paged else "contiguous"
    print(f"{ARCH} [{args.mode}, {arena} arena] decode step on "
          f"{torch.cuda.get_device_name(0)}, {SLOTS} slots at prompt "
          f"{PROMPT_LEN}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {out['idle_share']:.3f}")
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

"""Where a decode step's time goes: host wall time per engine decode step
against the device time of the kernels it launched, at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--mode dense|compressed|packed_b4] [--paged]

Serves internlm2-1.8b at full width with every one of its 4 slots holding
a 128-token prompt, then times 8 batched decode steps on the host clock
(each ends in a device sync) and profiles 8 more with `torch.profiler`.
Prints, per step: the wall time, the summed device time of its kernels
(one stream, so their sum is the busy time), the device's idle share, and
the kernels by device time. `--paged` serves from the paged KV arena
(bf16 pages of 16 rows). Needs a CUDA device.
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


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


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
    busy_ms = sum(ms for _, ms, _ in kernels)
    out = {"mode": args.mode, "paged": args.paged, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms}
    arena = "paged" if args.paged else "contiguous"
    print(f"{ARCH} [{args.mode}, {arena} arena] decode step on "
          f"{torch.cuda.get_device_name(0)}, {SLOTS} slots at prompt "
          f"{PROMPT_LEN}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {out['idle_share']:.3f}")
    for name, ms, n in kernels[:12]:
        print(f"  {ms:9.4f} ms/step  {n:5d} calls/step  {name[:90]}")
    return out


if __name__ == "__main__":
    main()

"""Where a GETA train step's time goes, at full width, one step per stage.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.profile_train --families PATH

Trains internlm2-1.8b at full width in bf16 (random weights from seed 0)
on batches of 4 x 512 tokens with the schedule compressed so that the 5
steps cross every stage (warm-up 1, projection 1 x 1, pruning 2 x 1,
cool-down 1). A first pass, from seed 0, runs each step under
`torch.profiler`; a second pass from the same seed times each step on the
host clock (ending in a device sync), with the process's first-launch
costs already paid. Prints, per step: the wall time, the summed device time
of its kernels (one stream, so their sum is the busy time), the device's
idle share, the peak device memory (`torch.cuda.max_memory_allocated`
over the timed step) and the kernels by device time, each kernel's time
summed over all its calls in the step. Kernel families sum the
instantiations of one template by its first argument (`gemm_tc<2` is
every fake-quant decode of the tensor-core GEMM, `gemm_tc<0` every bf16
weight it reads straight from TMA; `bfloat16_copy` every cast to bf16),
and prints the GEMM, fake-quant and cast families. `--out` writes every
kernel and family as JSON. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import torch

from repro_torch.configs import CompressionConfig
from repro_torch.launch.profile_decode import _device_us
from repro_torch.data.synthetic import batch_for
from repro_torch.launch.train import init_geta, make_geta_train_step

ARCH = "internlm2-1.8b"
BATCH, SEQ = 4, 512
SCHEDULE = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
                projection_steps=1, pruning_periods=2, pruning_steps=1,
                cooldown_steps=1)


def _steps(profile: bool):
    """Yield (stage, wall ms, profiler or None, peak GiB) for each of the 5
    steps."""
    comp = CompressionConfig(**SCHEDULE)
    lm, p, q, _, qasso, s = init_geta(ARCH, False, seed=0, comp=comp,
                                      device="cuda")
    step = make_geta_train_step(lm, qasso)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for i in range(qasso.cfg.total_steps):
        b = batch_for(lm.cfg, 0, i, BATCH, SEQ, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = torch.profiler.profile(activities=acts) if profile else None
        t0 = time.perf_counter()
        if prof is not None:
            with prof:
                p, q, s, m = step(p, q, s, b)
                torch.cuda.synchronize()
        else:
            p, q, s, m = step(p, q, s, b)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        yield m["stage"], wall, prof, peak


def family(kernel: str) -> str:
    """A kernel's name up to its first template argument, without the
    return type and namespace: `gemm_tc<2` for every instantiation of
    `gemm_tc<2, ...>`, the bare name of a kernel that is no template, and
    `bfloat16_copy` for every cast to bf16 (`.to(torch.bfloat16)`)."""
    if "bfloat16_copy_kernel" in kernel:
        return "bfloat16_copy"
    kernel = kernel.replace("(anonymous namespace)::", "")
    cut = min(i for i in (kernel.find("<"), kernel.find("("), len(kernel))
              if i >= 0)
    head = kernel[:cut].split()[-1].split("::")[-1]
    if kernel[cut:cut + 1] != "<":
        return head
    return f"{head}<{re.split('[,>]', kernel[cut + 1:])[0].strip()}"


def families_of(kernels) -> dict:
    """{family: {"ms", "calls"}} over (name, ms, calls) kernel rows."""
    families = {}
    for k, ms, n in kernels:
        f = families.setdefault(family(k), {"ms": 0.0, "calls": 0})
        f["ms"] += ms
        f["calls"] += n
    return families


def print_families(i: int, families: dict) -> None:
    """Step i's GEMM, fake-quant and bf16-cast families, largest first."""
    for f, v in sorted(families.items(), key=lambda kv: -kv[1]["ms"]):
        if f.startswith(("gemm_", "fq_", "bfloat16_copy")):
            print(f"step {i} family {f}: {v['ms']:.3f} ms, "
                  f"{v['calls']} calls")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--families", default=None, metavar="JSON",
                    help="print the families of a profile written by --out "
                         "(any checkout's), by this module's `family`; no "
                         "device needed")
    args = ap.parse_args(argv)
    if args.families:
        rows = json.loads(Path(args.families).read_text())["rows"]
        for r in rows:
            print(f"step {r['step']} (stage {r['stage']}): wall "
                  f"{r['wall_ms']:.1f} ms, device busy {r['device_ms']:.1f} "
                  f"ms, idle share {r['idle_share']:.3f}")
            print_families(r["step"], families_of(
                (k["name"], k["ms"], k["calls"]) for k in r["kernels"]))
        return rows
    # the profiled pass first: it also takes the process's first-launch
    # costs, which the timed pass then does not see
    profs = [prof for _, _, prof, _ in _steps(True)]
    torch.cuda.empty_cache()
    walls = [(stage, ms, peak) for stage, ms, _, peak in _steps(False)]
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    name = torch.cuda.get_device_name(0)
    for i, prof in enumerate(profs):
        stage, wall_ms, peak = walls[i]
        kernels = sorted(((e.key, _device_us(e) / 1e3, e.count)
                          for e in prof.key_averages()
                          if e.device_type == cuda and _device_us(e) > 0),
                         key=lambda r: -r[1])
        busy_ms = sum(ms for _, ms, _ in kernels)
        families = families_of(kernels)
        rows.append({"step": i, "stage": stage, "wall_ms": wall_ms,
                     "device_ms": busy_ms,
                     "idle_share": 1.0 - busy_ms / wall_ms,
                     "tokens_per_s": BATCH * SEQ / (wall_ms / 1e3),
                     "peak_gib": peak, "families": families,
                     "kernels": [{"name": k, "ms": ms, "calls": n}
                                 for k, ms, n in kernels]})
        print(f"{ARCH} GETA train step {i} (stage {stage}) on {name}, "
              f"batch {BATCH}x{SEQ}: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms, idle share {rows[-1]['idle_share']:.3f}, "
              f"{rows[-1]['tokens_per_s']:.0f} tok/s, peak {peak:.2f} GiB")
        for k, ms, n in kernels[:10]:
            print(f"  {ms:10.3f} ms  {n:6d} calls  {k[:90]}")
        print_families(i, families)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": name, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()

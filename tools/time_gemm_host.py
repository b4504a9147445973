"""Host time of one `gemm_core.gemm` call at decode shapes, for the
wrapper of any checkout.

    python3 tools/time_gemm_host.py [--src DIR] [--calls N]

Run from the repo root on a CUDA card. Imports `repro_torch` from DIR
(default: this checkout's `src`; for example an unpacked earlier commit's
`src`). For each of internlm2-1.8b's decode projections at M = 4 (bf16 x,
int8 codes under `dequant`, as the compressed engine calls them: wqkv
2048->4096, wo 2048->2048, w1 / w3 2048->8192, w2 8192->2048, the head
2048->92544) it times N calls on the host clock, each from an idle
device queue (a sync before it) to the wrapper's return, so the time is
the wrapper's Python and the launch, not the kernel. Prints the median
and minimum microseconds a call by shape and over all shapes, then a
JSON line of them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"wqkv": (2048, 4096), "wo": (2048, 2048), "w1": (2048, 8192),
          "w2": (8192, 2048), "head": (2048, 92544)}
M = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.kernels import gemm_core as gc
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": args.src, "calls": args.calls, "us": {}}
    every = []
    for name, (K, N) in SHAPES.items():
        codes = torch.randint(-127, 128, (K, N), generator=gen,
                              device="cuda", dtype=torch.int8)
        epi = gc.dequant(torch.full((N,), 0.01, device="cuda"))
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        for _ in range(20):
            gc.gemm(x, codes, epi, out_dtype=torch.bfloat16)
        times = []
        for _ in range(args.calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gc.gemm(x, codes, epi, out_dtype=torch.bfloat16)
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        every += times
        out["us"][name] = [statistics.median(times), min(times)]
        print(f"{name} M={M} K={K} N={N}: median {statistics.median(times):.2f}"
              f" us, min {min(times):.2f} us a call", flush=True)
    out["us"]["all"] = [statistics.median(every), min(every)]
    print(f"all shapes: median {out['us']['all'][0]:.2f} us, min "
          f"{out['us']['all'][1]:.2f} us a call ({args.src}, "
          f"{torch.cuda.get_device_name(0)})")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

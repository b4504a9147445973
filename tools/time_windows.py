"""The engine's decode windows at full width, in every weight mode over
both KV arenas, for the engine of any checkout.

    python3 tools/time_windows.py [--src DIR] [--ks 8,32] [--out PATH]
        [--pruned [--sparsity S]]

Run from the repo root on a CUDA card. Imports `repro_torch` from DIR
(default: this checkout's `src`; for example an unpacked earlier
commit's `src`, whose engine decodes its windows eagerly) and runs this
checkout's `launch/profile_decode.py` in its window mode against it, in
one process: for each of dense, compressed and packed 4-bit weights,
over the contiguous arena and the paged one (bf16 pages of 16 rows), and
each window length K of `--ks`, 4 slots at prompt 128, 8 windows on the
host clock and 8 profiled. `--pruned` adds, after each unpruned row, the
same row on the sliced subnet at magnitude masks of `--sparsity` (this
checkout's engine only). Prints profile_decode's lines per row, then a
table (wall ms, device busy ms, idle share and decode tok/s per step,
capture seconds and graph pool bytes per engine) and, last, a JSON line
of all rows; `--out` also writes them to PATH.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("dense", "compressed", "packed_b4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--ks", default="8,32",
                    help="comma-separated window lengths")
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--pruned", action="store_true",
                    help="also time each row on the sliced subnet")
    ap.add_argument("--sparsity", type=float, default=0.3)
    args = ap.parse_args(argv)
    variants = [[]] + ([["--pruned", "--sparsity", str(args.sparsity)]]
                       if args.pruned else [])
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    spec = importlib.util.spec_from_file_location(
        "profile_decode", ROOT / "src/repro_torch/launch/profile_decode.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; repro_torch from {args.src}")
    rows = []
    for k in (int(x) for x in args.ks.split(",")):
        for mode in MODES:
            for paged in (False, True):
                argv = ["--mode", mode, "--window", str(k)]
                for extra in variants:
                    rows.append(prof.main(argv + extra
                                          + (["--paged"] if paged else [])))
                    gc.collect()
                    torch.cuda.empty_cache()
    print("| K | mode | arena | sparsity | wall ms/step | busy ms/step | idle "
          "| decode tok/s | capture s | graph pool B |")
    for r in rows:
        print(f"| {r['window']} | {r['mode']} | "
              f"{'paged' if r['paged'] else 'contiguous'} | "
              f"{r.get('sparsity') or 0} | "
              f"{r['wall_ms_per_step']:.3f} | {r['device_ms_per_step']:.3f} "
              f"| {r['idle_share']:.3f} | {r['decode_tok_per_s']:.1f} | "
              f"{r['capture_s']} | {r['graph_pool_bytes']} |")
    line = json.dumps({"device": smi, "src": args.src, "rows": rows})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Roofline harness: for every (arch x shape) cell on the one-pod
production mesh (16 x 16, data x model), the three H100 roofline terms of
one rank's step from the meta dry run (`launch.dryrun`). Writes JSON and
a markdown table. The terms are bounds computed for the card, not
measured times. Needs no card: meta tensors hold no data.

Each cell runs at depth 1 and 2 (the layer plan's periods) and is
extrapolated to the config's depth (`analysis.scan_corrected`): every
period runs the same operations, so FLOPs, bytes and wire bytes
extrapolate exactly, and the port counts every layer and scan step, so
there is nothing else to correct; the differencing only saves the CPU
time of a meta pass over every layer. The temp (live-peak) estimate
extrapolates the same way; arg bytes come from the full-depth cell's
records. A GETA train cell is measured in its joint stage.

  PYTHONPATH=src python -m repro_torch.roofline.run [--arch all] \
      [--shape all] [--step geta] [--workers 8] [--out PATH]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import time
import traceback

from repro_torch.configs import SHAPES, all_cells, get_arch
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import layer_plan
from repro_torch.roofline import analysis as RA


def _cost(arch, shape_name, mesh, step, depth, kw) -> RA.CellCost:
    cell, _, _ = DR.build_cell(arch, shape_name, mesh, step, depth=depth,
                               stages=("joint",), **kw)
    stage = next(iter(DR.run(cell).values()))
    return RA.cost_from_dryrun(stage, cell.arg_bytes)


def roofline_cell(arch: str, shape_name: str, mesh, step: str = "geta",
                  mode: str = "tp", serve_quant: str = "qat") -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    _, n_blocks = layer_plan(cfg)
    kw = dict(mode=mode, serve_quant=serve_quant)
    rec = {"arch": arch, "shape": shape_name, "step": step,
           "n_blocks": n_blocks, "mode": mode}
    t0 = time.time()
    try:
        full, _, _ = DR.build_cell(arch, shape_name, mesh, step,
                                   stages=("joint",), **kw)
        arg = full.arg_bytes
        del full
        if n_blocks >= 2:
            c1 = _cost(arch, shape_name, mesh, step, 1, kw)
            c2 = _cost(arch, shape_name, mesh, step, 2, kw)
            cost = RA.scan_corrected(c1, c2, n_blocks)
            cost.temp_bytes = c1.temp_bytes + (n_blocks - 1) * max(
                c2.temp_bytes - c1.temp_bytes, 0.0)
        else:
            cost = _cost(arch, shape_name, mesh, step, None, kw)
        cost.arg_bytes = arg
        row = RA.make_row(arch, shape, "1pod", step, cost,
                          RA.model_flops_for(cfg, shape), mesh.size)
        rec.update(
            ok=True, compute_s=row.compute_s, memory_s=row.memory_s,
            collective_s=row.collective_s, dominant=row.dominant,
            model_flops=row.model_flops, flops_per_dev=cost.flops,
            bytes_per_dev=cost.bytes_accessed,
            wire_bytes_per_dev=cost.wire_bytes,
            hlo_flops_global=row.hlo_flops_global,
            useful_ratio=row.useful_ratio, arg_gb=cost.arg_bytes / 1e9,
            temp_gb=cost.temp_bytes / 1e9, device_gb=row.device_gb,
            coll_counts=row.coll_counts, wall_s=round(time.time() - t0, 1))
    except Exception as e:  # a failing cell is a bug in the system
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-1500:])
    return rec


def to_markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | step | compute s | memory s | coll s | "
           "dominant | MODEL/counted | arg GB | temp GB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['step']} | "
                       f"FAIL: {r.get('error', '')[:60]} | | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['arg_gb']:.1f} "
            f"| {r['temp_gb']:.1f} |")
    return "\n".join(out)


def _one(args):
    arch, shape, step, mode, serve_quant = args
    return roofline_cell(arch, shape, make_production_mesh(), step, mode,
                         serve_quant)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--step", default="geta", choices=["geta", "base"])
    ap.add_argument("--mode", default="tp", choices=["tp", "zero"])
    ap.add_argument("--serve-quant", default="qat",
                    choices=["qat", "prequant"])
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run in this many processes at once")
    ap.add_argument("--out", default="experiments/roofline_torch.json")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch != "all":
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape != "all":
        cells = [c for c in cells if c[1] == args.shape]
    jobs = [(a, s, args.step, args.mode, args.serve_quant) for a, s in cells]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        rows = []
        futures = {pool.submit(_one, job): i for i, job in enumerate(jobs)}
        for fut in concurrent.futures.as_completed(futures):
            r = dict(fut.result(), order=futures[fut])
            rows.append(r)
            if r.get("ok"):
                print(f"[{len(rows):2d}/{len(cells)}] {r['arch']:26s} "
                      f"{r['shape']:12s} c={r['compute_s']:.4f}s "
                      f"m={r['memory_s']:.4f}s w={r['collective_s']:.4f}s "
                      f"dom={r['dominant']:10s} "
                      f"useful={r['useful_ratio']:.2f} "
                      f"gb={r['device_gb']:.1f} ({r['wall_s']} s)",
                      flush=True)
            else:
                print(f"[{len(rows):2d}/{len(cells)}] {r['arch']:26s} "
                      f"{r['shape']:12s} FAIL {r['error']}", flush=True)
    rows.sort(key=lambda r: r.pop("order"))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    with open(args.out.replace(".json", ".md"), "w") as f:
        f.write(to_markdown(rows) + "\n")
    print(f"wrote {args.out}")
    if not all(r.get("ok") for r in rows):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""CLI: `python -m repro_torch.analysis.verify`: run the static contract
checker over the port's serving and training entry-point matrix, on the
CPU (entries run on meta; no card). Port of `repro.analysis.verify`.

    PYTHONPATH=src python -m repro_torch.analysis.verify --fail-on-new

Exit status: 0 unless ``--fail-on-new`` is set and at least one finding
is not suppressed by the baseline (`analysis_baseline_torch.json`).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import passes, registry, report


def build_and_run(groups=None, *, arch: str = registry.ARCH, tp=registry.TP,
                  train: bool = True, smem_budget=None):
    """(engines, traced, findings) for the requested matrix slice."""
    engines, traced = registry.build_serving(groups, arch=arch, tp=tp)
    if train:
        traced.append(registry.build_training(arch=arch))
    findings = passes.run_all(engines, traced, smem_budget=smem_budget)
    return engines, traced, findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description="Static contract checker: identity, arena, "
                    "compile-set, shared-memory and host-data audits over "
                    "every engine and trainer entry point.")
    ap.add_argument("--configs", default=None,
                    help="comma-separated config groups "
                         f"(default: all of {','.join(registry.CONFIGS)})")
    ap.add_argument("--arch", default=registry.ARCH)
    ap.add_argument("--tp", type=int, default=None,
                    help="one tensor-parallel size (default: 1 and 2, the "
                         "second on a meta rank)")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the sharded train-step trace")
    ap.add_argument("--baseline", default=report.DEFAULT_BASELINE)
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 when any finding is not in the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to suppress every current "
                         "finding, then exit 0")
    ap.add_argument("--json", action="store_true",
                    help="print the full machine-readable report")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="override the shared-memory budget a block, bytes")
    args = ap.parse_args(argv)

    groups = args.configs.split(",") if args.configs else None
    tp = registry.TP if args.tp is None else args.tp
    engines, traced, findings = build_and_run(
        groups, arch=args.arch, tp=tp, train=not args.no_train,
        smem_budget=args.smem_budget)

    if args.update_baseline:
        path = report.save_baseline(findings, args.baseline)
        print(f"baseline updated: {path} ({len(findings)} suppressions)")
        return 0

    baseline = report.load_baseline(args.baseline)
    cfg = {"arch": args.arch, "groups": sorted(engines),
           "entries": len(traced),
           "tp": sorted({t.tp for t in traced if t.kind == "serving"}),
           "devices": sorted({t.device for t in traced}),
           "train": not args.no_train}
    rep = report.make_report(findings, baseline, cfg)

    if args.json:
        sys.stdout.write(report.dumps(rep))
    else:
        new, sup = report.split_findings(findings, baseline)
        print(f"analyzed {len(traced)} entries across {len(engines)} "
              f"engines (+train={not args.no_train}) on "
              f"{'/'.join(cfg['devices'])}")
        for f in sorted(findings, key=lambda x: x.fid):
            mark = "SUPPRESSED" if f.fid in baseline else f.severity.upper()
            print(f"  [{mark}] {f.fid}")
            print(f"      {f.message}")
        print(f"{len(findings)} finding(s): {len(new)} new, "
              f"{len(sup)} suppressed")

    new, _ = report.split_findings(findings, baseline)
    if args.fail_on_new and new:
        print(f"FAIL: {len(new)} new finding(s) not in {args.baseline}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Findings, stable IDs, baseline/suppression file, deterministic report.
The port's own copy of `repro.analysis.report`: the same formats, so a
report of the same findings is the same bytes.

A finding is one contract violation located by a pass. Its ID is built
from stable coordinates only — `pass:group:entry:slug` — never from
traversal indices that could shuffle between runs, so the checked-in
baseline (`analysis_baseline_torch.json`) diffs cleanly and CI can fail
on *new* violations while known, justified ones stay suppressed with a
recorded reason.

The report body is fully deterministic: findings sort by ID, every dict
serializes with sorted keys, and nothing time- or host-dependent (no
timestamps, no hostnames, no durations) enters the JSON.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

BASELINE_FORMAT = "repro-analysis-baseline-v1"
REPORT_FORMAT = "repro-analysis-report-v1"
DEFAULT_BASELINE = "analysis_baseline_torch.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    fid: str            # stable id: "pass:group:entry:slug"
    pass_name: str
    group: str          # engine config ("dense", "paged", ...) / "train"
    entry: str          # entry-point name within the group
    message: str
    severity: str = "error"         # "error" | "warning"
    detail: Optional[dict] = None

    def to_json(self) -> dict:
        d = {"id": self.fid, "pass": self.pass_name, "group": self.group,
             "entry": self.entry, "severity": self.severity,
             "message": self.message}
        if self.detail:
            d["detail"] = self.detail
        return d


def make_finding(pass_name: str, group: str, entry: str, slug: str,
                 message: str, severity: str = "error",
                 detail: Optional[dict] = None) -> Finding:
    fid = ":".join((pass_name, group, entry, slug))
    return Finding(fid=fid, pass_name=pass_name, group=group, entry=entry,
                   message=message, severity=severity, detail=detail)


def load_baseline(path: Optional[str] = None) -> dict[str, str]:
    """fid -> justification from the baseline file ({} when absent)."""
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        raw = json.load(f)
    sup = raw.get("suppress", {})
    return {str(k): str(v) for k, v in sup.items()}


def save_baseline(findings: list[Finding], path: str,
                  reason: str = "baselined") -> str:
    """Write every current finding as a suppression (``--update-baseline``).
    An empty finding list writes an empty (all-green) baseline."""
    payload = {"format": BASELINE_FORMAT,
               "suppress": {f.fid: reason
                            for f in sorted(findings, key=lambda x: x.fid)}}
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def split_findings(findings: list[Finding], baseline: dict[str, str]
                   ) -> tuple[list[Finding], list[Finding]]:
    """(new, suppressed) — a finding is suppressed iff its exact ID is in
    the baseline."""
    new = [f for f in findings if f.fid not in baseline]
    sup = [f for f in findings if f.fid in baseline]
    return new, sup


def make_report(findings: list[Finding], baseline: dict[str, str],
                config: dict) -> dict:
    """Deterministic machine-readable report (ordering fixed, no
    timestamps). `config` records what was analyzed — groups, device
    count, budget — so two reports are byte-identical iff the analysis
    saw the same program."""
    new, sup = split_findings(findings, baseline)
    ordered = sorted(findings, key=lambda f: f.fid)
    return {
        "format": REPORT_FORMAT,
        "config": {k: config[k] for k in sorted(config)},
        "counts": {
            "findings": len(findings),
            "new": len(new),
            "suppressed": len(sup),
            "errors": sum(f.severity == "error" for f in findings),
            "warnings": sum(f.severity == "warning" for f in findings),
        },
        "findings": [f.to_json() for f in ordered],
        "new": sorted(f.fid for f in new),
        "suppressed": sorted(f.fid for f in sup),
    }


def dumps(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True) + "\n"

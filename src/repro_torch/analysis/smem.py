"""Pass 4: the shared-memory budget over recorded kernel launches. Port
of `repro.analysis.vmem`.

The byte models live beside the kernels (`kernels.introspect`, fed by the
wrappers' launch records, which the CUDA route launches from), so the
model and the kernel cannot drift; this module turns each recorded
launch's kernels into findings against Hopper's per-block limits
(`introspect.faults`: 232448 shared bytes, at most 48 KB of them static,
1024 threads, a cluster of 8; registers where the record came from the
card). The same model pre-filters the tuner's candidates
(`autotune.smem_filter`), so a plan the checker would reject can never be
recorded as a tuning winner either.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.report import Finding, make_finding
from repro_torch.kernels import autotune, gemm_core, introspect

PASS = "smem"


def launch_slug(launch) -> str:
    """Stable ID slug for one launch: logical shape and epilogue (as the
    reference's tuning key names it), never a traversal index, so the
    same kernel launched from two call sites dedups."""
    if launch.kernel == "gemm_core":
        M, K, N = launch.shape
        bits = launch.kernels[0].query[3] if launch.kernels else 0
        ops = autotune.ops_key(gemm_core.Epilogue(launch.epilogue, (), bits))
        return f"gemm:{M}x{N}x{K}:{ops}"
    if launch.kernel.endswith("decode_attn"):
        B, _, KVh, g, dh = launch.shape
        R = launch.plan[1] if launch.plan else 0
        return f"{launch.kernel}:B{B}h{KVh}g{g}d{dh}c{R}"
    return f"{launch.kernel}:{'x'.join(map(str, launch.shape))}"


def audit_smem(traced_entries, budget: Optional[int] = None
               ) -> list[Finding]:
    findings, seen = [], set()
    for te in traced_entries:
        for launch in te.launches:
            bad = introspect.launch_faults(launch, budget)
            if not bad:
                continue
            slug = launch_slug(launch)
            if (te.group, te.name, slug) in seen:
                continue
            seen.add((te.group, te.name, slug))
            findings.append(make_finding(
                PASS, te.group, te.name, slug,
                f"launch exceeds Hopper's per-block limits: "
                f"{'; '.join(bad)}",
                detail={"faults": bad, "plan": list(launch.plan),
                        "kernels": [k.name for k in launch.kernels]}))
    return findings

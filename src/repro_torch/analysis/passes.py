"""The static contract passes. Port of `repro.analysis.passes`.

1. `audit_identity`: no reduction collective in any entry, serving or
   training: no `all_reduce`, `reduce_scatter` or `all_to_all`, nor their
   functional forms, reached from anywhere. The port's one cross-rank
   operation is the ordered gather (`launch.mesh.Mesh.all_gather`, behind
   `distributed.collectives.ordered_sum` and `distributed.sharding.
   gather_full`): a gather moves bits, and the sum that follows runs in
   rank order on every rank. So a gather is legal in serving too, where
   products sharded on K sum their partials in rank order (ROADMAP,
   "Differences by design"); a `torch.distributed` data movement outside
   that gather is flagged. The reference's `--compiled` scan of the HLO
   has no counterpart: the port has no partitioner that could insert a
   collective after the trace, so what the trace shows is what runs.
2. `audit_arenas` (the counterpart of `audit_sharding_pins`, under its
   finding ids `sharding:...`): every entry that writes an arena or a row
   leaves each of its tensors at the local shape its contract gives
   (`registry.arena_contract`: from the config and `kv_cache_specs`,
   not from the engine) and in the same storage, since the CUDA graphs
   captured those addresses; a fresh allocation is the port's
   `unpinned`, a wrong local shape its `mismatch`.
3. `audit_compile_set`: the reachable decode windows, speculative ks and
   chunk lengths, enumerated from the dispatch-site quantizers
   (`pow2_floor`, `reachable_spec_ks`, `reachable_chunk_shapes`), against
   what `warmup()` prepares (`warmed_window_ks`, `_spec_ks`,
   `chunk_buckets`); the finding ids are the reference's.
4. The shared-memory budget: `analysis.smem`.
5. `audit_constants`: any float64 operation, and any tensor of at least
   2^16 elements an entry builds from host data rather than taking it
   from its arguments or its module's state.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis import trace
from repro_torch.analysis.report import Finding, make_finding

IDENTITY = "identity"
SHARDING = "sharding"
COMPILE_SET = "compile_set"
CONSTANTS = "constants"

# the collectives' names as the mesh logs them (`launch.mesh.Collective`)
# that only move data
_LOGGED_MOVES = frozenset({"all-gather"})


# ------------------------------------------------------ 1: identity audit
def audit_identity(traced_entries) -> list[Finding]:
    findings = []
    for te in traced_entries:
        counted: dict[str, int] = {}
        for call in te.dist_calls:
            if call.name in trace.MOVEMENTS and trace.in_gather(call.path):
                continue    # the ordered gather's own transport
            counted[call.name] = counted.get(call.name, 0) + 1
        for c in te.collectives:
            if c.op not in _LOGGED_MOVES:
                counted[c.op] = counted.get(c.op, 0) + 1
        for name, n in sorted(counted.items()):
            what = ("reduction" if name.replace("-", "_").rstrip("_")
                    in trace.REDUCTIONS else "unordered data movement")
            if te.kind == "training":
                msg = (f"training step contains {n}x `{name}` ({what}): "
                       f"reductions must flow through the ordered gather "
                       f"and a sum in rank order only")
            else:
                msg = (f"serving entry contains {n}x `{name}` ({what}): "
                       f"the only cross-rank operation is the ordered "
                       f"gather, whose sums run in rank order (token "
                       f"identity)")
            findings.append(make_finding(
                IDENTITY, te.group, te.name, name, msg,
                detail={"count": n, "kind": what}))
    return findings


# ----------------------------------------------------- 2: arena audit
def audit_arenas(traced_entries) -> list[Finding]:
    findings = []
    for te in traced_entries:
        if te.expected is None or te.kind != "serving":
            continue
        for key, rec in sorted(te.arenas.items()):
            want = te.expected.get(key, {})
            before, after = rec["before"], rec["after"]
            for leaf in sorted(set(before) | set(after) | set(want)):
                slug = f"{key}.{leaf}"
                got = after.get(leaf)
                if got is None or before.get(leaf) is None or \
                        got[1:] != before[leaf][1:]:
                    findings.append(make_finding(
                        SHARDING, te.group, te.name, f"unpinned.{slug}",
                        f"{key}[{leaf!r}] is not the tensor in the storage "
                        f"it was: the entry allocated it afresh, so a "
                        f"captured graph would write the old storage"))
                elif got[0] != want.get(leaf):
                    findings.append(make_finding(
                        SHARDING, te.group, te.name, f"mismatch.{slug}",
                        f"{key}[{leaf!r}] has shape {list(got[0])} but its "
                        f"contract (kv_cache_specs) says "
                        f"{list(want[leaf]) if leaf in want else None}",
                        detail={"shape": list(got[0]),
                                "contract": list(want.get(leaf) or [])}))
    return findings


# --------------------------------------------------- 3: compile-set audit
def audit_compile_set(engines: dict) -> list[Finding]:
    """Diff the reachable dispatch shapes against the warmup contract, per
    engine. Reachable sets come from the dispatch-site quantizers, the
    warmed ones from the engine's own warmup helpers: independent
    derivations, so a shared bug cannot hide."""
    from repro_torch.launch import scheduler
    from repro_torch.launch.speculative import pow2_floor, reachable_spec_ks

    findings = []
    for group, eng in sorted(engines.items()):
        if eng.draft is not None:
            reach = reachable_spec_ks(eng.draft_k, eng.max_seq)
            warmed = set(eng._spec_ks())
            for k in sorted(reach - warmed):
                findings.append(make_finding(
                    COMPILE_SET, group, "spec", f"k{k}",
                    f"speculative step can dispatch k={k} but warmup only "
                    f"captures {sorted(warmed)}: its first round would "
                    f"capture mid-serve",
                    detail={"reachable": sorted(reach),
                            "warmed": sorted(warmed)}))
        elif not eng._chunk:
            reach = {min(pow2_floor(r), eng.MAX_WINDOW)
                     for r in range(1, eng.max_seq + 1)}
            warmed = set(eng.warmed_window_ks())
            for k in sorted(reach - warmed):
                findings.append(make_finding(
                    COMPILE_SET, group, "decode_window", f"k{k}",
                    f"decode window can dispatch k={k} but warmup only "
                    f"captures {sorted(warmed)}",
                    detail={"reachable": sorted(reach),
                            "warmed": sorted(warmed)}))
        if eng._chunk:
            reach = scheduler.reachable_chunk_shapes(eng.max_seq, eng._chunk)
            warmed = set(scheduler.chunk_buckets(eng._chunk))
            for c in sorted(reach - warmed):
                findings.append(make_finding(
                    COMPILE_SET, group, "prefill_chunk", f"c{c}",
                    f"chunk plan can emit a length-{c} chunk but warmup "
                    f"only prepares buckets {sorted(warmed)}",
                    detail={"reachable": sorted(reach),
                            "warmed": sorted(warmed)}))
    return findings


# -------------------------------------- 5: host-data / float64 audit
def audit_constants(traced_entries, min_elems: int = 1 << 16
                    ) -> list[Finding]:
    findings = []
    for te in traced_entries:
        seen = set()
        for op, shape, dtype, path in te.host_data:
            n = 1
            for d in shape:
                n *= d
            short = dtype.replace("torch.", "")
            slug = "x".join(map(str, shape)) + f"-{short}"
            if n < min_elems or slug in seen:
                continue    # one finding per distinct shape and dtype
            seen.add(slug)
            findings.append(make_finding(
                CONSTANTS, te.group, te.name, f"const-{slug}",
                f"entry builds a {tuple(shape)} {short} tensor from host "
                f"data ({op}) instead of taking it from its arguments or "
                f"module state: it crosses from the host on every call",
                detail={"shape": list(shape), "dtype": short,
                        "path": list(path)}))
        if any("torch.float64" in op.out_dtypes + op.in_dtypes
               for op in te.ops):
            findings.append(make_finding(
                CONSTANTS, te.group, te.name, "f64-widen",
                "entry computes in float64: serving and training math is "
                "f32 or bf16; float64 doubles the bytes and runs off the "
                "tensor cores"))
    return findings


def run_all(engines: dict, traced_entries, *,
            smem_budget: Optional[int] = None,
            const_min_elems: int = 1 << 16) -> list[Finding]:
    from repro_torch.analysis.smem import audit_smem
    findings = []
    findings += audit_identity(traced_entries)
    findings += audit_arenas(traced_entries)
    findings += audit_compile_set(engines)
    findings += audit_smem(traced_entries, budget=smem_budget)
    findings += audit_constants(traced_entries, min_elems=const_min_elems)
    return findings

"""Quantization-Aware Dependency Graph analysis — paper §4, Algorithm 1.

Input: the trace graph of a QADNN (a model whose GraphBuilder trace has had
`attach_weight_quant` / `insert_act_quant` branches grown onto it).

Phase 1 (lines 3-8):  find the root vertex of every *attached branch*
(weight quantization), merge the branch vertices into the root — the merged
vertex absorbs the branch's (d, q_m, t) parameters. This de-duplicates the
shared `d` vertex and eliminates the shape-ambiguous `q_reshape`.

Phase 2 (lines 9-14): find (root, end) pairs of every *inserted branch*
(activation quantization), merge the in-between vertices into the end
vertex, and reconnect root -> merged end to preserve connectivity.

Phase 3 (line 15): run the dependency-graph analysis of OTOv2 [12] on the
cleaned graph to derive the pruning search space: union-find over *channel
spaces* — producers open a space, dimension-preserving ops propagate it,
`add` unions its inputs' spaces, composite vertices contribute their own
structured FamilySpec and tie their boundary axes into the residual space.

Output: `QADG` = (cleaned graph, PruningSpace, quantization sites).

The port's copy of `repro.core.qadg`: the analysis is pure Python over the
graph, so both packages derive the same families, members and sites.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.graph import (ADD_OPS, COMPOSITE_OPS, JOINT_OPS,
                                    PRODUCER_OPS, SINK_OPS, FamilySpec,
                                    TraceGraph, Vertex)
from repro_torch.core.groups import GroupFamily, Member, PruningSpace


@dataclasses.dataclass(frozen=True)
class QuantSite:
    """One parameterized quantizer surviving QADG analysis (a layer index
    i in the paper's set L). Param names address the model pytree."""
    name: str           # qprefix, e.g. "layers.0.mlp.w_in.wq"
    target: str         # vertex id the quantizer is fused into
    kind: str           # "weight" | "act"
    d: str
    q_m: str
    t: str
    # parameters whose values flow through this quantizer (weight quant);
    # empty for activation quantizers.
    quantized_params: tuple[str, ...] = ()


@dataclasses.dataclass
class QADG:
    graph: TraceGraph
    space: PruningSpace
    sites: list[QuantSite]

    def site_by_name(self, name: str) -> QuantSite:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(name)


# --------------------------------------------------------------------------
# Phase 1 + 2: branch merging
# --------------------------------------------------------------------------
def _collect_branch_params(graph: TraceGraph, vids: list[str]) -> dict:
    names = {}
    for vid in vids:
        v = graph.vertices[vid]
        for key in ("d", "q_m", "t"):
            if key in v.params:
                names[key] = v.params[key]
    return names


def merge_attached_branches(graph: TraceGraph) -> list[QuantSite]:
    """Alg 1 lines 3-8. Returns the weight-quant sites.

    Branches are grouped by (root vertex, qprefix): a composite root
    (attention, MoE, ...) carries one attached branch per weight tensor."""
    by_key: dict[tuple[str, str], list[str]] = {}
    for vid, v in graph.vertices.items():
        if v.is_quant and v.meta.get("qbranch") == "attached":
            key = (v.meta["qroot"], v.meta.get("qprefix") or v.meta["qroot"])
            by_key.setdefault(key, []).append(vid)

    sites = []
    for (root_vid, qprefix), branch in sorted(by_key.items()):
        pnames = _collect_branch_params(graph, branch)
        root = graph.vertices[root_vid]
        target = None
        for vid in branch:
            target = target or graph.vertices[vid].meta.get("qtarget")
        # Merge: absorb the branch into the root vertex.
        for vid in branch:
            graph.remove_vertex(vid)
        root.meta.setdefault("quant_weight_params", {})[qprefix] = pnames
        if target is None:
            # plain producer: the weight flows through (biases stay fp)
            wparams = tuple(v for k, v in sorted(root.params.items())
                            if k == "w")
            wparams = wparams or tuple(sorted(root.params.values()))
        else:
            wparams = (target,)
        sites.append(QuantSite(
            name=qprefix, target=root_vid, kind="weight",
            d=pnames["d"], q_m=pnames["q_m"], t=pnames["t"],
            quantized_params=wparams,
        ))
    return sites


def merge_inserted_branches(graph: TraceGraph) -> list[QuantSite]:
    """Alg 1 lines 9-14. Returns the activation-quant sites."""
    by_pair: dict[tuple[str, str], list[str]] = {}
    for vid, v in graph.vertices.items():
        if v.is_quant and v.meta.get("qbranch") == "inserted":
            by_pair.setdefault((v.meta["qroot"], v.meta["qend"]), []).append(vid)

    sites = []
    for (root_vid, end_vid), branch in sorted(by_pair.items()):
        pnames = _collect_branch_params(graph, branch)
        end = graph.vertices[end_vid]
        qprefix = end.meta.get("act_quant")
        for vid in branch:
            graph.remove_vertex(vid)
        # line 13: reconnect root to the merged end vertex.
        if end_vid not in graph.succ[root_vid]:
            graph.connect(root_vid, end_vid)
        end.meta["quant_act_params"] = pnames
        sites.append(QuantSite(
            name=qprefix or f"{end_vid}.aq",
            target=end_vid, kind="act",
            d=pnames["d"], q_m=pnames["q_m"], t=pnames["t"],
        ))
    return sites


# --------------------------------------------------------------------------
# Phase 3: dependency analysis over the cleaned graph (OTOv2-style)
# --------------------------------------------------------------------------
class _UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def make(self, x: int):
        self.parent.setdefault(x, x)

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
        return ra


@dataclasses.dataclass
class _Space:
    sid: int
    dim: Optional[int] = None           # channel count
    producers: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    consumers: list[tuple[str, int, int, str]] = dataclasses.field(
        default_factory=list)           # (param, axis, unit_size, layout)
    aux: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    prunable: bool = True
    tag: str = ""


def dependency_analysis(graph: TraceGraph) -> PruningSpace:
    """OTOv2 [12]-style analysis specialized to the cleaned QADG."""
    uf = _UnionFind()
    spaces: dict[int, _Space] = {}
    out_space: dict[str, int] = {}
    out_mult: dict[str, int] = {}      # flatten factor along the path
    out_layout: dict[str, str] = {}
    next_sid = [0]

    def new_space(dim=None, prunable=True, tag="") -> int:
        sid = next_sid[0]
        next_sid[0] += 1
        uf.make(sid)
        spaces[sid] = _Space(sid, dim=dim, prunable=prunable, tag=tag)
        return sid

    def space(sid: int) -> _Space:
        return spaces[uf.find(sid)]

    def merge_spaces(a: int, b: int) -> int:
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:
            return ra
        sa, sb = spaces[ra], spaces[rb]
        root = uf.union(ra, rb)
        keep, drop = (sa, sb) if root == ra else (sb, sa)
        keep.producers += drop.producers
        keep.consumers += drop.consumers
        keep.aux += drop.aux
        keep.prunable = keep.prunable and drop.prunable
        if keep.dim is None:
            keep.dim = drop.dim
        elif drop.dim is not None and keep.dim != drop.dim:
            raise ValueError(
                f"dependency analysis: tied spaces with dims {keep.dim} != "
                f"{drop.dim} ({keep.tag} vs {drop.tag})")
        del spaces[drop.sid if drop.sid != root else keep.sid]
        return root

    for vid in graph.topo_order():
        v = graph.vertices[vid]
        preds = graph.pred[vid]
        pin = out_space.get(preds[0]) if preds else None

        if v.op == "identity" and not preds:          # model input
            sid = new_space(dim=v.meta.get("dim"), prunable=False, tag=vid)
            out_space[vid] = sid
            out_mult[vid] = 1
            out_layout[vid] = "contiguous"

        elif v.op in PRODUCER_OPS:
            # consume predecessor space along in_axis
            if v.op != "embedding" and pin is not None and v.in_axis is not None:
                space(pin).consumers.append(
                    (v.params["w"], v.in_axis, out_mult[preds[0]],
                     out_layout[preds[0]]))
            sid = new_space(dim=v.meta.get("out_dim"), tag=vid)
            space(sid).producers.append((v.params["w"], v.out_axis))
            if "b" in v.params:
                space(sid).aux.append(
                    (v.params["b"], v.meta.get("bias_axis", 0)))
            if v.meta.get("non_prunable"):
                space(sid).prunable = False
            out_space[vid] = sid
            out_mult[vid] = 1
            out_layout[vid] = "contiguous"

        elif v.op in JOINT_OPS or v.op in ("bn",):
            assert pin is not None, f"{vid}: joint op with no input"
            s = space(pin)
            for key in ("scale", "bias"):
                if key in v.params:
                    # stacked (L, D) norm scales carry the channel on axis 1
                    s.aux.append((v.params[key],
                                  v.meta.get("param_axis", 0)))
            out_space[vid] = pin
            m = out_mult[preds[0]]
            lay = out_layout[preds[0]]
            if "flatten_factor" in v.meta:
                m *= int(v.meta["flatten_factor"])
                lay = v.meta.get("flatten_layout", "interleaved")
            out_mult[vid] = m
            out_layout[vid] = lay

        elif v.op in ADD_OPS:
            sids = [out_space[p] for p in preds]
            sid = sids[0]
            for other in sids[1:]:
                sid = merge_spaces(sid, other)
            out_space[vid] = sid
            out_mult[vid] = out_mult[preds[0]]
            out_layout[vid] = out_layout[preds[0]]

        elif v.op in COMPOSITE_OPS:
            # boundary axes tie into the predecessor (residual) space
            assert pin is not None
            s = space(pin)
            for pname, axis in v.meta.get("in_members", []):
                s.consumers.append((pname, axis, 1, "contiguous"))
            for pname, axis in v.meta.get("resid_members", []):
                s.producers.append((pname, axis))
            out_space[vid] = pin      # composite returns to residual stream
            out_mult[vid] = out_mult[preds[0]]
            out_layout[vid] = out_layout[preds[0]]

        elif v.op in SINK_OPS:
            if pin is not None:
                space(pin).prunable = False
            out_space[vid] = pin if pin is not None else new_space(
                prunable=False, tag=vid)
            out_mult[vid] = out_mult.get(preds[0], 1) if preds else 1
            out_layout[vid] = out_layout.get(preds[0], "contiguous")

        elif v.is_quant:
            raise ValueError(
                f"quant vertex {vid} survived branch merging — run "
                "merge_attached_branches/merge_inserted_branches first")
        else:
            raise ValueError(f"unhandled op {v.op!r} at {vid}")

    # ---- emit families ----
    families: list[GroupFamily] = []
    seen_roots = set()
    for sid in list(spaces):
        root = uf.find(sid)
        if root in seen_roots:
            continue
        seen_roots.add(root)
        s = spaces[root]
        if not s.producers and not s.consumers:
            continue
        if s.dim is None:
            continue
        members = [Member(p, ax, 1, "contiguous") for p, ax in s.producers]
        members += [Member(p, ax, us, lay) for p, ax, us, lay in s.consumers]
        members += [Member(p, ax, 1, "contiguous") for p, ax in s.aux]
        if not members:
            continue
        families.append(GroupFamily(
            name=f"space.{root}.{s.tag or 'anon'}",
            units=s.dim, members=members, prunable=s.prunable,
            kind="channel"))

    # composite vertices contribute their own structured families verbatim
    for vid, v in graph.vertices.items():
        if v.spec is not None:
            sp = v.spec
            families.append(GroupFamily(
                name=sp.name, units=sp.units,
                members=[Member(p, ax, us, "contiguous")
                         for p, ax, us in sp.members],
                prunable=sp.prunable, kind=sp.kind))

    return PruningSpace(families)


# --------------------------------------------------------------------------
# Algorithm 1, end to end
# --------------------------------------------------------------------------
def build_qadg(graph: TraceGraph) -> QADG:
    # NB: no topo validation before merging — attached branches are cyclic
    # by construction (root -> ... -> mul -> root); Alg 1 removes the cycle.
    w_sites = merge_attached_branches(graph)   # lines 3-8
    a_sites = merge_inserted_branches(graph)   # lines 9-14
    graph.validate()                           # acyclic + connected again
    space = dependency_analysis(graph)         # line 15
    return QADG(graph=graph, space=space, sites=w_sites + a_sites)

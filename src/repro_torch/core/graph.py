"""Trace-graph representation of a model, the substrate for QADG (paper §4).

The port's own copy of `repro.core.graph` (pure Python, no tensors). The
model describes its operators explicitly through the `GraphBuilder` API
(`LM.build_graph`), exactly as the JAX package does, so both packages
analyse the same graph and derive the same pruning space. The resulting
graph contains exactly the structures Algorithm 1 operates on:

- ordinary compute vertices (`linear`, `conv`, `norm`, `act`, `add`, ...),
- *attached branches*: the parameterized weight-quantization subgraph
  (`param d/q_m/t -> pow -> clip -> div -> round -> mul`) hanging off a
  weight-carrying vertex,
- *inserted branches*: the activation-quantization subgraph spliced between
  an activation vertex and its consumer,

including the weight-sharing (the same `d` feeding both `div` and `mul`)
and shape-ambiguous (`reshape` broadcast) vertices that break prior
dependency-graph analyses and that Algorithm 1 exists to eliminate.

Composite vertices (`attention`, `moe`, `mamba`, `rwkv_timemix`) carry a
structured pruning spec (head groups / experts / state channels) because
their minimally-removable structure is coarser than a single channel — the
same treatment OTOv2-style analyses give multi-head attention.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable, Optional

# Vertex op taxonomy -------------------------------------------------------
PRODUCER_OPS = {"linear", "conv", "embedding"}
JOINT_OPS = {"norm", "bn", "act", "dropout", "pool", "scale", "rope", "identity"}
ADD_OPS = {"add"}
QUANT_OPS = {"q_param", "q_pow", "q_clip", "q_div", "q_round", "q_mul",
             "q_reshape"}
COMPOSITE_OPS = {"attention", "moe", "mamba", "rwkv_timemix", "rwkv_chanmix",
                 "conv_dw"}
SINK_OPS = {"output", "loss"}


@dataclasses.dataclass
class Vertex:
    vid: str
    op: str
    # parameter names owned by this vertex (entries of the model pytree)
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    # axis of the *weight* along which output channels live (producers)
    out_axis: Optional[int] = None
    # axis of the weight along which input channels live (producers)
    in_axis: Optional[int] = None
    # structured spec for composite vertices (see FamilySpec)
    spec: Optional["FamilySpec"] = None
    # free-form metadata (dims, weight-sharing ids, quant branch tags, ...)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_quant(self) -> bool:
        return self.op in QUANT_OPS


@dataclasses.dataclass
class FamilySpec:
    """Structured pruning spec a composite vertex contributes directly.

    `units`: number of minimally-removable structures (kv-head groups,
    experts, state channels, ...).
    `members`: list of (param_name, axis, unit_size) — the param's `axis`
    has length units * unit_size and unit i owns the contiguous slice
    [i*unit_size, (i+1)*unit_size).
    """
    name: str
    units: int
    members: list[tuple[str, int, int]]
    prunable: bool = True
    kind: str = "composite"  # "channel" | "head_group" | "expert" | ...


class TraceGraph:
    def __init__(self) -> None:
        self.vertices: dict[str, Vertex] = {}
        self.succ: dict[str, list[str]] = {}
        self.pred: dict[str, list[str]] = {}
        self._uid = itertools.count()

    # -- construction ------------------------------------------------------
    def add_vertex(self, v: Vertex) -> Vertex:
        if v.vid in self.vertices:
            raise ValueError(f"duplicate vertex {v.vid}")
        self.vertices[v.vid] = v
        self.succ.setdefault(v.vid, [])
        self.pred.setdefault(v.vid, [])
        return v

    def connect(self, src: str, dst: str) -> None:
        if src not in self.vertices or dst not in self.vertices:
            raise KeyError(f"connect({src!r}, {dst!r}): unknown vertex")
        if dst not in self.succ[src]:
            self.succ[src].append(dst)
            self.pred[dst].append(src)

    def disconnect(self, src: str, dst: str) -> None:
        self.succ[src].remove(dst)
        self.pred[dst].remove(src)

    def remove_vertex(self, vid: str) -> None:
        for s in list(self.succ[vid]):
            self.disconnect(vid, s)
        for p in list(self.pred[vid]):
            self.disconnect(p, vid)
        del self.vertices[vid]
        del self.succ[vid]
        del self.pred[vid]

    def fresh_id(self, prefix: str) -> str:
        return f"{prefix}#{next(self._uid)}"

    # -- queries -----------------------------------------------------------
    def topo_order(self) -> list[str]:
        indeg = {v: len(self.pred[v]) for v in self.vertices}
        stack = [v for v, d in indeg.items() if d == 0]
        out: list[str] = []
        while stack:
            v = stack.pop()
            out.append(v)
            for s in self.succ[v]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
        if len(out) != len(self.vertices):
            raise ValueError("trace graph has a cycle")
        return out

    def quant_vertices(self) -> list[str]:
        return [vid for vid, v in self.vertices.items() if v.is_quant]

    def validate(self) -> None:
        self.topo_order()
        for vid, outs in self.succ.items():
            for o in outs:
                assert vid in self.pred[o], (vid, o)


class GraphBuilder:
    """Fluent API the model zoo uses to declare its trace graph.

    Chains vertices automatically: each call connects the new vertex to the
    `after` vertex (default: the previously added one).
    """

    def __init__(self) -> None:
        self.graph = TraceGraph()
        self._last: Optional[str] = None

    # -- core ops ----------------------------------------------------------
    def _add(self, v: Vertex, after: Optional[str | list[str]]) -> str:
        self.graph.add_vertex(v)
        if after is None and self._last is not None:
            after = self._last
        if after is not None:
            for a in ([after] if isinstance(after, str) else after):
                self.graph.connect(a, v.vid)
        self._last = v.vid
        return v.vid

    def input(self, vid: str = "input") -> str:
        return self._add(Vertex(vid, "identity"), after=[])

    def linear(self, vid: str, w: str, *, bias: str | None = None,
               out_axis: int = 1, in_axis: int = 0,
               after: Optional[str | list[str]] = None, **meta) -> str:
        params = {"w": w}
        if bias:
            params["b"] = bias
        return self._add(Vertex(vid, "linear", params=params,
                                out_axis=out_axis, in_axis=in_axis,
                                meta=meta), after)

    def conv(self, vid: str, w: str, *, bias: str | None = None,
             after=None, **meta) -> str:
        # HWIO layout: out_axis=3, in_axis=2
        params = {"w": w}
        if bias:
            params["b"] = bias
        return self._add(Vertex(vid, "conv", params=params, out_axis=3,
                                in_axis=2, meta=meta), after)

    def embedding(self, vid: str, w: str, *, out_axis: int = 1,
                  after=None, **meta) -> str:
        return self._add(Vertex(vid, "embedding", params={"w": w},
                                out_axis=out_axis, meta=meta), after)

    def norm(self, vid: str, scale: str | None = None,
             bias: str | None = None, after=None, **meta) -> str:
        params = {}
        if scale:
            params["scale"] = scale
        if bias:
            params["bias"] = bias
        return self._add(Vertex(vid, "norm", params=params, meta=meta), after)

    def bn(self, vid: str, scale: str, bias: str, after=None, **meta) -> str:
        return self._add(Vertex(vid, "bn",
                                params={"scale": scale, "bias": bias},
                                meta=meta), after)

    def act(self, vid: str, after=None, **meta) -> str:
        return self._add(Vertex(vid, "act", meta=meta), after)

    def add(self, vid: str, inputs: list[str], **meta) -> str:
        return self._add(Vertex(vid, "add", meta=meta), after=inputs)

    def pool(self, vid: str, after=None, **meta) -> str:
        return self._add(Vertex(vid, "pool", meta=meta), after)

    def output(self, vid: str = "output", after=None) -> str:
        return self._add(Vertex(vid, "output"), after)

    def composite(self, vid: str, op: str, spec: FamilySpec, params: dict,
                  after=None, **meta) -> str:
        assert op in COMPOSITE_OPS, op
        return self._add(Vertex(vid, op, params=params, spec=spec,
                                meta=meta), after)

    # -- quantization branches (paper Fig. 2) ------------------------------
    def attach_weight_quant(self, root_vid: str, qprefix: str,
                            target_param: str | None = None) -> list[str]:
        """Grow the *attached branch* of Fig 2(a) off a weight-carrying root.

        The branch deliberately contains the weight-sharing (`d` feeds both
        q_div and q_mul) and a shape-ambiguous `q_reshape` vertex — the
        structures Algorithm 1 must merge away.

        `target_param`: the parameter flowing through this quantizer; for
        composite roots (attention/moe/...) with several weights, one branch
        is attached per weight, each with its own qprefix.
        Returns the branch vertex ids.
        """
        g = self.graph
        root = g.vertices[root_vid]
        ids = []

        def q(vid_suffix, op, params=None, meta=None):
            vid = f"{qprefix}.{vid_suffix}"
            g.add_vertex(Vertex(vid, op, params=params or {},
                                meta={"qbranch": "attached",
                                      "qroot": root_vid,
                                      "qprefix": qprefix,
                                      "qtarget": target_param,
                                      **(meta or {})}))
            ids.append(vid)
            return vid

        d = q("d", "q_param", {"d": f"{qprefix}.d"})
        qm = q("q_m", "q_param", {"q_m": f"{qprefix}.q_m"})
        t = q("t", "q_param", {"t": f"{qprefix}.t"})
        pw = q("pow", "q_pow")
        cl = q("clip", "q_clip")
        dv = q("div", "q_div")
        rd = q("round", "q_round")
        rs = q("reshape", "q_reshape", meta={"shape_ambiguous": True})
        ml = q("mul", "q_mul")

        # wiring: root -> pow -> clip -> div -> round -> reshape -> mul -> root
        g.connect(root_vid, pw)
        g.connect(t, pw)
        g.connect(pw, cl)
        g.connect(qm, cl)
        g.connect(cl, dv)
        g.connect(d, dv)          # d used here ...
        g.connect(dv, rd)
        g.connect(rd, rs)
        g.connect(rs, ml)
        g.connect(d, ml)          # ... and shared here (weight sharing)
        g.connect(ml, root_vid)   # cycle back: handled/merged by Alg 1
        root.meta.setdefault("weight_quant", []).append(qprefix)
        return ids

    def insert_act_quant(self, root_vid: str, end_vid: str,
                         qprefix: str) -> list[str]:
        """Splice the *inserted branch* of Fig 2(b) between an activation
        (root) and its consumer (end). Returns branch vertex ids."""
        g = self.graph
        ids = []

        def q(vid_suffix, op, params=None, meta=None):
            vid = f"{qprefix}.{vid_suffix}"
            g.add_vertex(Vertex(vid, op, params=params or {},
                                meta={"qbranch": "inserted",
                                      "qroot": root_vid, "qend": end_vid,
                                      **(meta or {})}))
            ids.append(vid)
            return vid

        d = q("d", "q_param", {"d": f"{qprefix}.d"})
        qm = q("q_m", "q_param", {"q_m": f"{qprefix}.q_m"})
        t = q("t", "q_param", {"t": f"{qprefix}.t"})
        pw = q("pow", "q_pow")
        cl = q("clip", "q_clip")
        dv = q("div", "q_div")
        rd = q("round", "q_round")
        ml = q("mul", "q_mul")

        g.disconnect(root_vid, end_vid)
        g.connect(root_vid, pw)
        g.connect(t, pw)
        g.connect(pw, cl)
        g.connect(qm, cl)
        g.connect(cl, dv)
        g.connect(d, dv)
        g.connect(dv, rd)
        g.connect(rd, ml)
        g.connect(d, ml)
        g.connect(ml, end_vid)
        g.vertices[end_vid].meta.setdefault("act_quant", qprefix)
        return ids

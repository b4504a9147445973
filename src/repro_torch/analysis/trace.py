"""Tracing primitives for the static contract checker: the counterpart of
`repro.analysis.jaxpr_utils`.

The reference reads each entry's jaxpr. The port has no trace to read
before running: its entries are eager PyTorch. So `trace_entry` runs one
entry once, on `meta` tensors as the dry run does (`launch.dryrun`:
shapes and dtypes only, no data, no card), under

- a `TorchDispatchMode` (`OpLog`) that records every aten operation with
  its input and output dtypes and its call path, the port's functions on
  the Python stack from the entry down (as `walk_eqns` keeps the path of
  enclosing primitives), and every tensor built from host data
  (`aten.lift_fresh` and its kin: `torch.tensor`, `torch.as_tensor`,
  `torch.from_numpy` inside the entry), and every functional collective
  (the `_c10d_functional` operations);
- `kernels.introspect.record_launches()`, which collects each kernel
  wrapper's launch record;
- `intercept_distributed()`, which records every call that reaches a
  `torch.distributed` collective, with its call path (passing it on to
  the real function only where a process group exists);
- the logging `Mesh` of `launch.mesh.meta_rank`, whose `all_gather` is the
  port's one cross-rank operation: its log holds the entry's collectives.

The arenas and rows an entry writes (`writes`) are recorded before and
after the call: each leaf's shape, tensor identity and storage.

Where an entry cannot run on meta (an operation without a meta kernel, a
value read on the host), it runs on the CPU at the smoke size instead,
on the entry's own example state, and the entry records so (`device`).
With the internlm2-1.8b smoke config every serving entry of the registry
(prefill, prefill_chunk, insert, insert_pages, zero_pages, copy_page,
the eager decode step, each captured window, each speculative round, the
draft's prefill and insert) and the sharded train step run on meta.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import introspect, meta

_PORT = str(Path(__file__).resolve().parents[1])
_HERE = str(Path(__file__).resolve())
# operations that build a tensor from host data
HOST_DATA_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
# torch.distributed's collectives: those that combine values from several
# ranks (a reduction reassociates a float sum), and those that only move
# them
REDUCTIONS = frozenset({
    "all_reduce", "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "_reduce_scatter_base", "all_to_all", "all_to_all_single",
    "all_reduce_coalesced", "reduce_scatter_tensor_coalesced",
    "all_reduce_multigpu"})
MOVEMENTS = frozenset({
    "all_gather", "all_gather_into_tensor", "_all_gather_base",
    "all_gather_object", "broadcast", "gather", "scatter", "send", "recv",
    "isend", "irecv", "all_gather_tensor", "broadcast_object_list"})
_FUNCTIONAL = "torch.distributed._functional_collectives"


@dataclasses.dataclass(frozen=True)
class Op:
    """One aten operation an entry ran."""
    name: str              # e.g. "aten.mm.default"
    in_dtypes: tuple
    out_dtypes: tuple
    path: tuple            # the port's functions on the stack, outermost first


@dataclasses.dataclass(frozen=True)
class DistCall:
    """A call that reached a torch.distributed collective (or its
    functional form): its name and call path."""
    name: str
    path: tuple


@dataclasses.dataclass
class TracedEntry:
    """One entry point, run once: what the passes read."""
    group: str                   # config group ("dense", ...) or "train"
    name: str                    # the entry's name within the group
    kind: str                    # "serving" | "training"
    fn: Callable
    args: tuple
    device: str                  # where it ran: "meta" or "cpu"
    ops: list                    # Op
    dist_calls: list             # DistCall
    host_data: list              # (op name, shape, dtype, path)
    collectives: list            # launch.mesh.Collective from the mesh log
    launches: list               # kernels.meta.Launch
    arenas: dict = dataclasses.field(default_factory=dict)
    # state key -> {"role": (who, layout), "before": {leaf: (shape, id,
    # storage)}, "after": {...}}
    expected: Optional[dict] = None   # state key -> {leaf: local shape}
    tp: int = 1

    @property
    def key(self) -> str:
        return f"{self.group}:{self.name}"


_NAMES: dict = {}       # code object -> its qualname in the port, or ""


def call_path(skip: int = 2) -> tuple:
    """The port's functions on the Python stack, outermost first (this
    module's own frames left out)."""
    out = []
    frame = sys._getframe(skip)
    while frame is not None:
        code = frame.f_code
        name = _NAMES.get(code)
        if name is None:
            f = os.path.abspath(code.co_filename)
            name = _NAMES[code] = (code.co_qualname if f.startswith(_PORT)
                                   and f != _HERE else "")
        if name:
            out.append(name)
        frame = frame.f_back
    return tuple(reversed(out))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def to_meta(tree):
    """`tree` with every tensor replaced by an empty meta tensor of its
    shape, dtype and strides (dicts, lists and tuples rebuilt, anything
    else kept)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


class OpLog(TorchDispatchMode):
    """Records every aten operation (module doc) into `ops`, every tensor
    built from host data into `host_data` and functional collectives into
    `dist_calls`."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []
        self.host_data: list = []
        self.dist_calls: list[DistCall] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        path = call_path()
        name = func.overloadpacket.__name__
        ins = tuple(str(t.dtype) for t in _tensors((args, kwargs)))
        outs = tuple(str(t.dtype) for t in _tensors(out))
        self.ops.append(Op(str(func), ins, outs, path))
        if func.namespace in ("_c10d_functional", "c10d_functional", "c10d"):
            self.dist_calls.append(DistCall(name.rstrip("_"), path))
        if name in HOST_DATA_OPS:
            for t in _tensors(out):
                self.host_data.append((name, tuple(t.shape), str(t.dtype),
                                       path))
        return out


@contextlib.contextmanager
def intercept_distributed(calls: list):
    """While open, every torch.distributed collective (and functional
    collective) the process calls appends a `DistCall` to `calls`; the
    call goes on to the real function only where a process group exists
    (on a meta rank, or none, it does nothing and returns None)."""
    import importlib
    mods = [dist]
    try:
        mods.append(importlib.import_module(_FUNCTIONAL))
    except ImportError:
        pass
    saved = []
    for mod in mods:
        for name in sorted(REDUCTIONS | MOVEMENTS):
            real = getattr(mod, name, None)
            if real is None or not callable(real):
                continue

            def stub(*a, _real=real, _name=name, **k):
                calls.append(DistCall(_name, call_path()))
                if dist.is_available() and dist.is_initialized():
                    return _real(*a, **k)
                return None

            saved.append((mod, name, real))
            setattr(mod, name, stub)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def _leaves(state: dict, key: str) -> dict:
    return {leaf: (tuple(t.shape), id(t), t.untyped_storage()._cdata)
            for leaf, t in state[key].items()}


def run_entry(fn: Callable, args: tuple, writes: dict, mesh=None,
              device: str = "meta") -> dict:
    """Run fn(*args) once, on `device` ("meta": the args converted;
    "cpu": as given), and record it (module doc). Returns the record's
    fields."""
    if device == "meta":
        args = to_meta(args)
    state = args[0] if args and isinstance(args[0], dict) else {}
    arenas = {key: {"role": role, "before": _leaves(state, key)}
              for key, role in writes.items()}
    log_before = len(mesh.log) if mesh is not None and mesh.log is not None \
        else 0
    calls: list = []
    logged = len(meta.LOG)
    try:
        with introspect.record_launches() as launches, \
                intercept_distributed(calls), OpLog() as ops:
            fn(*args)
    finally:
        del meta.LOG[logged:]      # the dry run's log: the records are here
    for key, rec in arenas.items():
        rec["after"] = _leaves(state, key)
    colls = (list(mesh.log[log_before:])
             if mesh is not None and mesh.log is not None else [])
    return dict(args=args, ops=ops.ops, host_data=ops.host_data,
                dist_calls=calls + ops.dist_calls, collectives=colls,
                launches=list(launches), arenas=arenas, device=device)


def trace_entry(group: str, ep: dict, kind: str = "serving", tp: int = 1,
                mesh=None, expected: Optional[dict] = None) -> TracedEntry:
    """Run one entry (`Engine.entry_points()`'s dict: name, fn, args,
    writes) on meta, or, where it cannot run there, on the CPU."""
    writes = ep.get("writes", {})
    try:
        rec = run_entry(ep["fn"], tuple(ep["args"]), writes, mesh, "meta")
    except (NotImplementedError, RuntimeError, TypeError, ValueError):
        rec = run_entry(ep["fn"], tuple(ep["args"]), writes, mesh, "cpu")
    return TracedEntry(group=group, name=ep["name"], kind=kind,
                       fn=ep["fn"], expected=expected, tp=tp, **rec)


def in_gather(path: tuple) -> bool:
    """True when the path passes through the logging mesh's ordered
    gather (`launch.mesh.Mesh.all_gather`)."""
    return "Mesh.all_gather" in path

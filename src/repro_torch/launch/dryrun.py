"""The dry run: one rank's step of every (arch x shape x mesh) cell on the
`meta` device. Port of `repro.launch.dryrun`.

The reference lowers each cell for 512 placeholder devices, compiles it
and reads XLA's cost and memory analyses. The port has no compiler in
the loop: what takes the compile's place is running the step itself, as
the port runs it on one rank, on `meta` tensors, which hold shapes and
dtypes only. Every operation then executes without data and without a
card, and the dry run counts as it goes:

- FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the PyTorch
  operations (convolutions, products, attention), plus the operations
  of each hand-written kernel call, whose meta route records them
  (`kernels.meta`);
- bytes: every operation's meta inputs read once and outputs written
  once (the port runs eagerly, so there is no fusion to discount; views
  and bare allocations move nothing), plus each kernel call's bytes;
- arg bytes: the rank's params, quantizers, optimizer state and batch
  (or caches); temp bytes: the peak of the other live meta tensors,
  tracked from the operations' outputs to their release (an estimate of
  the allocator's peak: it sees no caching or fragmentation);
- collectives: each one a rank makes, with its group size and result
  bytes (`launch.mesh.meta_rank`), and its wire bytes by the ring
  formulas (`roofline.analysis.wire_bytes`);
- kernel launches, by kernel, variant, epilogue and shape.

A rank runs the port's own step. Training: the deterministic sharded GETA
step (`launch.train.make_sharded_geta_train_step`), data parallel over
the pod and data axes with params sharded by the plan and gathered whole
inside the step (the port has no tensor-parallel training; `mode="zero"`
is the FSDP plan), or, with `step="base"`, the base optimizer's step.
The GETA cell runs one step in each QASSO stage (warm-up, projection, a
joint step that recomputes the partition, cool-down), counted apart; the
record's top-level numbers are the joint stage's, the costliest. Serving
(prefill, and decode in the `qat` and `prequant` modes): the dense
families run tensor parallel on `model` as the engine serves them
(`LM.tp`), the others with whole weights, the batch split over the data
axes. The `psum` and `seqshard` values of `serve_attn` pin GSPMD score
layouts, which the port has no counterpart of: they raise ValueError.

QASSO's scalar rules read statistics on the host; on meta they run on
placeholders (`core.qasso._on_host`), so a joint step takes the common
branch. A failing cell is recorded with `ok=False` and its error, and
`main` exits 1.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \
      --shape train_4k --mesh single --depth 1
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import (SHAPES, CompressionConfig, all_cells,
                                 get_arch, get_overrides)
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train as T
from repro_torch.launch.engine import serves_tensor_parallel
from repro_torch.launch.specs import (ArraySpec, batch_specs, decode_specs,
                                      param_specs)
from repro_torch.models.transformer import LM, layer_plan
from repro_torch.optim.base import get_optimizer
from repro_torch.roofline import analysis as RA

_DRYRUN_COMP = CompressionConfig(
    target_sparsity=0.3, bit_lower=4, bit_upper=16, act_quant=False,
    warmup_steps=100, projection_periods=3, projection_steps=100,
    pruning_periods=5, pruning_steps=100, cooldown_steps=500)
STAGES = ("warmup", "projection", "joint", "cooldown")
# operations that allocate without writing, and ones that only relabel
_ALLOCATE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}
_RELABEL = {"detach", "alias", "lift_fresh"}


def _stored_bytes(t: torch.Tensor) -> int:
    """Bytes t's elements occupy, broadcast (stride-0) dims counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class ByteCounter(TorchDispatchMode):
    """Counts the bytes each operation on meta tensors reads and writes,
    and the peak of the live meta bytes its outputs hold (a view keeps its
    base's bytes alive; bytes are released when the last tensor holding
    them is freed)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held = WeakIdKeyDictionary()

    def _hold(self, t: torch.Tensor) -> None:
        if t in self._held:
            return
        base = t._base if t._is_view() else None
        token = self._held.get(base) if base is not None else None
        if token is None:
            token = [0, _stored_bytes(t)]
            self.live += token[1]
            self.peak = max(self.peak, self.live)
        token[0] += 1
        self._held[t] = token
        weakref.finalize(t, self._release, token)

    def _release(self, token) -> None:
        token[0] -= 1
        if token[0] == 0:
            self.live -= token[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in _RELABEL:
            return out
        ins = [t for t in _tensors((args, kwargs)) if t.is_meta]
        outs = [t for t in _tensors(out) if t.is_meta]
        if name not in _ALLOCATE:
            self.bytes += sum(_stored_bytes(t) for t in ins + outs)
        for t in outs:
            if not any(t is i for i in ins):
                self._hold(t)
        return out


def measure(fn: Callable[[], Any], mesh) -> dict:
    """Run fn() (a step on meta tensors) and count what it does: flops,
    bytes, temp_bytes (the live peak beyond its arguments), the
    collectives `mesh` logged, their wire bytes and the kernel launches."""
    log_before = len(mesh.log)
    kmeta.take()
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        out = fn()
        del out
    launches = kmeta.take()
    colls = mesh.log[log_before:]
    counts = collections.Counter(c.op for c in colls)
    return {
        "flops": float(fc.get_total_flops()
                       + sum(x.flops for x in launches)),
        "bytes": float(bc.bytes + sum(x.nbytes for x in launches)),
        "temp_bytes": float(bc.peak),
        "wire_bytes": float(sum(RA.wire_bytes(c.op, c.group, c.nbytes)
                                for c in colls)),
        "collectives": dict(counts),
        "collective_log": [(c.op, str(c.axis), c.group, c.nbytes)
                           for c in colls],
        "launches": launches,
    }


@dataclasses.dataclass
class Cell:
    """One rank's work in a cell: `runs` maps a stage name ("step" for a
    one-stage cell) to a function of no arguments that runs it on meta
    tensors; `args` are the tensors the step takes (params, quantizers,
    optimizer state, batch or caches), on this rank."""
    cfg: Any
    mesh: Any
    runs: dict
    args: Any
    meta: dict

    @property
    def arg_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _tensors(self.args)
                   if t.is_meta)


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _local(recs: dict) -> dict:
    return {k: r.meta() for k, r in recs.items()}


def build_cell(arch: str, shape, mesh, step: str = "geta",
               depth: Optional[int] = None, mode: str = "tp", serve_quant: str = "qat",
               serve_attn: str = "auto", stages: tuple = STAGES,
               smoke: bool = False) -> tuple[Cell, Any, dict]:
    """Build one (arch x shape x mesh) cell for the first rank of `mesh`
    (a `launch.mesh.Mesh`, e.g. `make_production_mesh()`). Returns (cell,
    cfg, meta); nothing runs until a cell's `runs` are called.

    depth: n_blocks (the layer plan's periods); `shape`: a `SHAPES` name or
    a `ShapeConfig`; mode: "tp" or "zero" (FSDP); the port's sharded
    step has no microbatches (ROADMAP item 14b);
    serve_quant: "qat" (the decode step fake-quantizes its weights) or
    "prequant" (frozen x_Q served without quantizers); `stages`: the QASSO
    stages a GETA cell runs; `smoke`: the arch's smoke config."""
    if serve_attn not in ("auto",):
        raise ValueError(
            f"serve_attn={serve_attn!r} pins a GSPMD score layout; the port "
            f"has no GSPMD (ROADMAP, Differences by design)")
    if mode not in ("tp", "zero"):
        raise ValueError(f"mode {mode!r}: tp or zero")
    cfg = get_arch(arch, smoke=smoke)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=len(layer_plan(cfg)[0])
                                  * depth)
    shape = _shape(shape)
    overrides = get_overrides(arch)
    base_opt = overrides.get("base_optimizer", "adamw")
    rank = meshlib.meta_rank(mesh)
    lm = LM(cfg)
    info = {"step": step if shape.kind == "train" else shape.kind,
            "n_devices": mesh.size}

    if shape.kind == "train":
        plan = shlib.make_plan(mesh, fsdp=mode == "zero",
                               overrides=dict(overrides))
        p_recs, p_sh, _ = param_specs(lm, mesh, plan)
        full = {k: r.meta(local=False) for k, r in p_recs.items()}
        batch = _local(batch_specs(cfg, shape, mesh))
        p_sh = {k: shlib.NamedSharding(rank, s.spec)
                for k, s in p_sh.items()}
        info["plan_fallbacks"] = list(plan.fallbacks)
        if step == "geta":
            _, qasso = T.build_geta(lm, _DRYRUN_COMP, lr=3e-4,
                                    base_optimizer=base_opt)
            qparams = lm.init_qparams(full, bits_init=8.0)
            fn, (p_sh, _, s_sh, _) = T.make_sharded_geta_train_step(
                lm, qasso, rank, full, qparams, param_shardings=p_sh)
            params = shlib.place(full, p_sh)
            qstate = shlib.place(qasso.init(full, qparams), s_sh)
            del full
            cfg_q = qasso.cfg
            first = {"warmup": 0, "projection": cfg_q.warmup_end,
                     "joint": cfg_q.projection_end,
                     "cooldown": cfg_q.joint_end}

            def stage(i):
                return lambda: fn(params, qparams,
                                  qstate._replace(step=i), batch)

            runs = {s: stage(first[s]) for s in stages}
            args = (params, qparams, qstate, batch)
        elif step == "base":
            opt = get_optimizer(base_opt)
            params = shlib.place(full, p_sh)
            ostate = opt.init(full)
            # the moments follow their params (`train._on_shards`)
            ostate = (type(ostate)(ostate.count, shlib.place(ostate.m, p_sh),
                                   shlib.place(ostate.v, p_sh))
                      if hasattr(ostate, "m") else
                      shlib.place(ostate, p_sh) if ostate else ostate)
            del full
            if any(s.spec for s in p_sh.values()):
                opt = T._on_shards(opt, p_sh)
            lg = T.make_ordered_loss_grads(
                lm, rank, axis=shlib.batch_spec(rank)[0])

            def base_step():
                whole = shlib.gather_tree(params, p_sh)
                loss, gx, _ = lg(whole, None, batch)
                delta, _ = opt.update(gx, ostate, whole,
                                      torch.tensor(3e-4))
                return shlib.place({k: whole[k] + delta[k] for k in whole},
                                   p_sh), loss

            runs = {"step": base_step}
            args = (params, ostate, batch)
        else:
            raise ValueError(f"step {step!r}: geta or base")
    else:
        tp = serves_tensor_parallel(lm) and mesh.shape.get("model", 1) > 1
        plan = shlib.make_plan(mesh, mode="tp")
        p_recs, _, axes = param_specs(lm)
        if tp:
            specs = shlib.serving_param_specs(
                plan, axes, {k: r.meta(local=False)
                             for k, r in p_recs.items()})
            lm.tp = shlib.TensorParallel(rank, specs)
            params = {k: ArraySpec(r.shape, r.dtype, specs[k], mesh).meta()
                      for k, r in p_recs.items()}
        else:
            params = _local(p_recs)
        info["plan_fallbacks"] = list(plan.fallbacks)
        info["tensor_parallel"] = tp
        qparams = (lm.init_qparams(params, bits_init=8.0)
                   if serve_quant == "qat" else None)
        if shape.kind == "prefill":
            batch = _local(batch_specs(cfg, shape, mesh))
            runs = {"step": lambda: lm.forward(params, qparams,
                                               batch["tokens"],
                                               batch.get("vision_embeds"))}
            args = (params, qparams, batch)
        else:
            d = decode_specs(cfg, shape, mesh)
            if not tp:        # whole KV heads on every rank
                d["caches"] = {k: dataclasses.replace(
                    r, spec=tuple(None if p == "model" else p
                                  for p in r.spec))
                    for k, r in d["caches"].items()}
            caches = _local(d["caches"])
            token, pos = d["token"].meta(), d["pos"].meta()
            runs = {"step": lambda: lm.decode_step(params, qparams, caches,
                                                   token, pos)}
            args = (params, qparams, caches, token, pos)
        info["serve_quant"] = serve_quant
    return Cell(cfg, rank, runs, args, info), cfg, info


def run(cell: Cell) -> dict:
    """Each of the cell's runs measured (`measure`), by stage."""
    return {name: measure(fn, cell.mesh) for name, fn in cell.runs.items()}


def summary(stage: dict) -> dict:
    """A stage's measurement with its launches tallied by kernel."""
    out = {k: v for k, v in stage.items() if k != "launches"}
    out["launches"] = dict(collections.Counter(
        x.kernel + (f".{x.variant}" if x.variant else "")
        + (f".{x.epilogue}" if x.epilogue else "")
        for x in stage["launches"]))
    return out


def run_cell(arch: str, shape_name, mesh, mesh_name: str,
             step: str = "geta", verbose: bool = True, depth: Optional[int] = None,
             **kw) -> dict:
    """One cell's record: per device, the joint stage's (or the one
    step's) flops_per_dev, bytes_per_dev, wire_bytes_per_dev,
    collectives, arg_gb and temp_gb, and every stage's under `stages`."""
    t0 = time.time()
    rec = {"arch": arch, "shape": _shape(shape_name).name, "mesh": mesh_name,
           "step": step, "depth": depth}
    try:
        cell, _, info = build_cell(arch, shape_name, mesh, step,
                                   depth=depth, **kw)
        t_build = time.time() - t0
        stages = run(cell)
        main = stages.get("joint") or next(iter(stages.values()))
        rec.update(
            ok=True, build_s=round(t_build, 2),
            run_s=round(time.time() - t0 - t_build, 2),
            arg_gb=cell.arg_bytes / 1e9, temp_gb=main["temp_bytes"] / 1e9,
            flops_per_dev=main["flops"], bytes_per_dev=main["bytes"],
            wire_bytes_per_dev=main["wire_bytes"],
            collectives=main["collectives"],
            stages={k: {f: v for f, v in summary(s).items()
                        if f != "collective_log"} for k, s in stages.items()},
            fallbacks=[f"{p}:{a}" for p, a, _ in info["plan_fallbacks"]],
            tensor_parallel=info.get("tensor_parallel"))
        if verbose:
            print(f"[ok]   {arch:26s} {rec['shape']:12s} {mesh_name:6s} "
                  f"{step:5s} run={rec['run_s']:6.1f}s "
                  f"dev_mem={(rec['arg_gb'] + rec['temp_gb']):8.2f}GB "
                  f"flops/dev={main['flops']:.3e} "
                  f"wire/dev={main['wire_bytes']:.3e}", flush=True)
    except Exception as e:  # a failing cell is a bug in the system
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch:26s} {rec['shape']:12s} {mesh_name:6s}: "
                  f"{e}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--step", default="geta", choices=["geta", "base"])
    ap.add_argument("--depth", type=int, default=None,
                    help="n_blocks of every cell (default: the config's)")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch != "all":
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape != "all":
        cells = [c for c in cells if c[1] == args.shape]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("1pod", meshlib.make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("2pod", meshlib.make_production_mesh(multi_pod=True)))

    records = [run_cell(arch, shape, mesh, name, args.step, depth=args.depth)
               for name, mesh in meshes for arch, shape in cells]
    n_ok = sum(r["ok"] for r in records)
    print(f"\n{n_ok}/{len(records)} cells ran")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1, default=str)
    print(f"wrote {args.out}")
    if n_ok < len(records):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""GETA training: port of `repro.launch.train`.

The step is the JAX package's: loss -> gradients of (params, qparams) ->
QASSO update. `LM.loss` runs the block projections through the GEMM
kernels' autograd Functions and the quantizers through the fake-quant
kernels; QASSO runs its stage logic on the host. `train_loop(ckpt_dir=)`
checkpoints the whole state and resumes from the newest checkpoint after
a failure (`--ckpt-dir`).

Data parallelism is deterministic (`make_ordered_loss_grads`): the batch
splits into k slices, each slice's gradients are computed apart and
summed in f32 in slice order, on one rank (`grad_slices=k`) or on k ranks
(one slice each, the sum an all-gather and an ordered sum), so a k-rank
step is bitwise the 1-rank step with `grad_slices=k`.
`make_sharded_geta_train_step` runs it on a mesh of ranks with QASSO
replica-consistent; FSDP (`fsdp=True`) keeps each rank's params and
base-optimizer moments as its `embed` shard and gathers them in full
inside the step. `--devices N [--fsdp]` starts N ranks
(`launch.mesh.spawn`).

Runs on CUDA; `--device cpu` runs the plain PyTorch versions of the
kernels instead (as the tests do). Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 5 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --full --steps 5 --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
      --ckpt-dir /path/to/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 10 \
      --devices 4 --fsdp --device cpu
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import (clone_tree, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import CompressionConfig, get_arch, get_overrides
from repro_torch.core.qadg import build_qadg
from repro_torch.core.qasso import QASSO, QASSOConfig, QASSOState
from repro_torch.core.quant import QuantParams
from repro_torch.data.synthetic import batch_for, step_key
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.collectives import ordered_sum
from repro_torch.distributed.fault import FaultConfig, FaultTolerantLoop
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.engine import resolve_device
from repro_torch.models.layers import not_in_this_slice
from repro_torch.models.transformer import LM
from repro_torch.optim.schedules import cosine

F32 = torch.float32


def qasso_config_from(comp: CompressionConfig,
                      base_optimizer: str = "adamw") -> QASSOConfig:
    return QASSOConfig(
        target_sparsity=comp.target_sparsity,
        bit_lower=comp.bit_lower, bit_upper=comp.bit_upper,
        warmup_steps=comp.warmup_steps,
        projection_periods=comp.projection_periods,
        projection_steps=comp.projection_steps,
        bit_reduction=comp.bit_reduction,
        pruning_periods=comp.pruning_periods,
        pruning_steps=comp.pruning_steps,
        cooldown_steps=comp.cooldown_steps,
        base_optimizer=base_optimizer)


def build_geta(lm: LM, comp: CompressionConfig, lr: float,
               base_optimizer: str = "adamw"):
    """(qadg, qasso) for a model — the paper's `geta = GETA(model)`."""
    qadg = build_qadg(lm.build_graph(act_quant=comp.act_quant).graph)
    qcfg = qasso_config_from(comp, base_optimizer)
    qasso = QASSO(qadg.space, qadg.sites, qcfg,
                  cosine(lr, qcfg.total_steps, warmup=qcfg.warmup_steps))
    return qadg, qasso


def loss_and_grads(lm: LM, params: dict, qparams: dict, batch: dict):
    """(loss, gx, gq): the loss and its gradients with respect to every
    floating-point param and every quantizer's (d, q_m, t), in their own
    dtypes; a leaf the loss does not reach gets zeros, as under JAX.
    `qparams=None` trains without quantizers (gq is then empty)."""
    p_leaf = {k: v.detach().requires_grad_(v.is_floating_point())
              for k, v in params.items()}
    q_leaf = {k: QuantParams(*(t.detach().requires_grad_(True)
                               for t in (q.d, q.q_m, q.t)))
              for k, q in (qparams or {}).items()}
    with torch.enable_grad():
        loss = lm.loss(p_leaf, None if qparams is None else q_leaf, batch)
    pk = [k for k, v in p_leaf.items() if v.requires_grad]
    inputs = [p_leaf[k] for k in pk] + [t for q in q_leaf.values()
                                        for t in (q.d, q.q_m, q.t)]
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    gx = dict(zip(pk, grads[:len(pk)]))
    flat = grads[len(pk):]
    gq = {k: QuantParams(*flat[3 * i:3 * i + 3])
          for i, k in enumerate(q_leaf)}
    return loss.detach(), gx, gq


def _accumulate_grads(loss_grad_fn, batch: dict, microbatches: int):
    """Gradients summed over `microbatches` splits of the batch in split
    order into f32 accumulators, then scaled by 1/microbatches (activation
    memory scales with 1/microbatches at fixed batch). Returns (mean loss,
    mean gx, mean gq)."""
    scale = 1.0 / microbatches
    loss_acc = torch.zeros((), dtype=F32)
    gx_acc = gq_acc = None
    for i in range(microbatches):
        mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                           *v.shape[1:])[i] for k, v in batch.items()}
        loss, gx, gq = loss_grad_fn(mb)
        loss_acc = loss_acc + loss.cpu()
        if gx_acc is None:
            gx_acc = {k: torch.zeros(g.shape, dtype=F32, device=g.device)
                      for k, g in gx.items()}
            gq_acc = {k: [torch.zeros((), dtype=F32, device=q.d.device)
                          for _ in range(3)] for k, q in gq.items()}
        for k, g in gx.items():
            gx_acc[k] = gx_acc[k] + g.to(F32)
        for k, q in gq.items():
            gq_acc[k] = [a + b.to(F32)
                         for a, b in zip(gq_acc[k], (q.d, q.q_m, q.t))]
    return (loss_acc * scale, {k: g * scale for k, g in gx_acc.items()},
            {k: QuantParams(*(v * scale for v in q))
             for k, q in gq_acc.items()})


def make_geta_train_step(lm: LM, qasso: QASSO, microbatches: int = 1):
    """The train step: loss -> grads -> QASSO update."""

    def step(params, qparams, qstate, batch):
        def lg(b):
            return loss_and_grads(lm, params, qparams, b)

        if microbatches <= 1:
            loss, gx, gq = lg(batch)
        else:
            loss, gx, gq = _accumulate_grads(lg, batch, microbatches)
        params, qparams, qstate, metrics = qasso.update(
            params, qparams, gx, gq, qstate)
        metrics["loss"] = loss
        return params, qparams, qstate, metrics

    return step


# ------------------------------------------------------- sharded training
def make_ordered_loss_grads(lm, mesh, param_specs_tree=None,
                            grad_slices: Optional[int] = None,
                            axis: str = "data"):
    """lg(params, qparams, batch) -> (loss, gx, gq) with a deterministic
    reduction over the batch: the batch splits into `grad_slices` equal
    slices of whole sequences (default: the mesh's `axis` size; every
    leaf on its first axis: tokens (B, S), codebook frames (B, S, C), a
    vlm batch's patch embeds (B, P, D) with their text), each slice's loss and
    gradients are computed apart and summed in f32 in slice order, then
    scaled by 1/k; gradients come back f32.

    On a 1-rank `axis` the slices run one after the other. On k ranks
    each rank holds one slice (the batch `place`d by `batch_spec`), and
    the sum is an all-gather and an ordered sum (`ordered_sum`): the same
    terms in the same order, so the k-rank step is bitwise the 1-rank
    step with `grad_slices=k`. `param_specs_tree` (name -> spec) gathers
    sharded params in full first (FSDP). `axis` may be a tuple of axes
    (a dry-run rank's pod x data group). Raises unless k equals the
    axis size on more than one rank."""
    dp = mesh.axis_size(axis) if mesh is not None else 1
    k = grad_slices or max(dp, 1)
    if dp > 1 and k != dp:
        raise ValueError(
            f"deterministic grads need one slice per device: "
            f"grad_slices={k} but mesh has {dp} {axis!r} devices")
    scale = 1.0 / k

    def finish(loss, gx, gq):
        return (loss * scale, {n: g * scale for n, g in gx.items()},
                {n: QuantParams(*(t * scale for t in q))
                 for n, q in gq.items()})

    if dp == 1:
        def lg(params, qparams, batch):
            loss = gx = gq = None
            for i in range(k):
                mb = {n: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                      for n, v in batch.items()}
                li, gxi, gqi = loss_and_grads(lm, params, qparams, mb)
                li = li.to(F32)
                gxi = {n: g.to(F32) for n, g in gxi.items()}
                gqi = {n: [t.to(F32) for t in (q.d, q.q_m, q.t)]
                       for n, q in gqi.items()}
                if loss is None:
                    loss, gx, gq = li, gxi, gqi
                    continue
                loss = loss + li
                gx = {n: gx[n] + gxi[n] for n in gx}
                gq = {n: [a + b for a, b in zip(gq[n], gqi[n])] for n in gq}
            return finish(loss, gx, gq)

        return lg

    def lg(params, qparams, batch):
        if param_specs_tree is not None:
            params = {n: shlib.gather_full(w, param_specs_tree.get(n, ()),
                                           mesh)
                      for n, w in params.items()}
        loss, gx, gq = loss_and_grads(lm, params, qparams, batch)
        # the terms cross in their own dtype and widen to f32 in the sum,
        # as the sequential path widens each slice's gradients
        total = lambda t: ordered_sum(t, mesh, axis, F32)
        return finish(total(loss), {n: total(g) for n, g in gx.items()},
                      {n: [total(t) for t in (q.d, q.q_m, q.t)]
                       for n, q in gq.items()})

    return lg


def geta_state_shardings(qasso: QASSO, params, qparams, mesh,
                         param_shardings=None):
    """(param, qparam, QASSOState) sharding trees for the GETA state:
    params follow `param_shardings` (the plan's: FSDP shards the embed
    axis), the base optimizer's moments follow their params, and the
    control plane (quantizers, masks, step, gamma) is replicated, the
    values QASSO must agree on across ranks. A NamedSharding at a node
    covers every leaf below it (`sharding.map_sharded`)."""
    rep = shlib.NamedSharding(mesh, ())
    p_sh = {k: (param_shardings or {}).get(k) or rep for k in params}
    q_sh = {k: rep for k in qparams}
    base = qasso.base.init({})
    if isinstance(base, tuple) and hasattr(base, "m"):      # AdamW
        base_sh = type(base)(None, dict(p_sh), dict(p_sh))
    elif isinstance(base, dict):             # momentum: one moment tree
        base_sh = dict(p_sh)
    else:                                    # sgd: stateless
        base_sh = base
    s_sh = QASSOState(step=None, base=base_sh, redundant=rep, keep_mask=rep,
                      gamma=rep)
    return p_sh, q_sh, s_sh


def _on_shards(base, shardings: dict):
    """The base optimizer `base` run on each rank's shards: the moments of
    a sharded param never leave their rank; `update` takes the full
    gradients and params, cuts this rank's pieces, updates them and
    gathers the deltas whole. The update is elementwise, so the deltas
    are bitwise the full update's."""
    def update(grads, state, params, lr):
        sh = {k: shardings[k] for k in grads}
        delta, state = base.update(shlib.place(grads, sh), state,
                                   shlib.place(params, sh), lr)
        return shlib.gather_tree(delta, sh), state

    return dataclasses.replace(base, update=update)


def make_sharded_geta_train_step(lm, qasso: QASSO, mesh, params, qparams, *,
                                 param_shardings=None,
                                 grad_slices: Optional[int] = None,
                                 deterministic: bool = True,
                                 microbatches: int = 1):
    """The GETA step on a mesh of ranks. Returns (step, (param_sh,
    qparam_sh, qstate_sh, batch_sh)); callers `sharding.place` the initial
    state and each batch with the returned shardings, and step(params,
    qparams, qstate, batch) takes and returns this rank's pieces.

    Gradients come from `make_ordered_loss_grads` (bitwise across mesh
    sizes: a k-rank run equals the 1-rank run with `grad_slices=k`). QASSO
    is replica-consistent by construction: the step gathers the params in
    full (`gather_full`, bitwise) and the gradients are summed in rank
    order, so every statistic that feeds a decision (the Eq 15-17 site
    reductions, the saliency scores) is reduced from the same bits in the
    same order on every rank, as on one rank; every rank takes the same
    decisions and keeps its shard (the tests and the card check hold the
    masks with `collectives.assert_replicated`).
    The base optimizer's moments stay sharded with their params
    (`_on_shards`: only the deltas cross). The batch splits over the
    data-parallel axes of `sharding.batch_spec` ("data", or ("pod",
    "data") on a dry-run rank of a multi-pod mesh). The
    reference's GSPMD step (`deterministic=False`) and its microbatches
    are not ported."""
    if not deterministic or microbatches > 1:
        raise not_in_this_slice(
            "the all-reduce sharded step (deterministic=False, "
            "microbatches)", "ROADMAP Queue 1 item 14b")
    qasso = copy.copy(qasso)        # the caller's keeps its own base
    p_sh, q_sh, s_sh = geta_state_shardings(qasso, params, qparams, mesh,
                                            param_shardings)
    if any(s.spec for s in p_sh.values()):
        qasso.base = _on_shards(qasso.base, p_sh)
    batch_sh = shlib.NamedSharding(mesh, shlib.batch_spec(mesh))
    lg = make_ordered_loss_grads(lm, mesh, grad_slices=grad_slices,
                                 axis=batch_sh.spec[0])

    def step(params, qparams, qstate, batch):
        # the moments stay this rank's (`_on_shards`); the rest of the
        # state is replicated
        full = shlib.gather_tree(params, p_sh)
        loss, gx, gq = lg(full, qparams, batch)
        p, q, s, metrics = qasso.update(full, qparams, gx, gq, qstate)
        metrics["loss"] = loss
        return shlib.place(p, p_sh), q, s, metrics

    return step, (p_sh, q_sh, s_sh, batch_sh)


def default_compression(steps: int) -> CompressionConfig:
    """The JAX train loop's schedule for a run of `steps` steps."""
    return CompressionConfig(
        warmup_steps=max(steps // 10, 2),
        projection_periods=2, projection_steps=max(steps // 10, 2),
        pruning_periods=3, pruning_steps=max(steps // 10, 2),
        cooldown_steps=max(steps // 4, 2))


def init_geta(arch: str, smoke: bool, *, seed: int = 0,
              comp: Optional[CompressionConfig] = None, device=None,
              layers: Optional[int] = None):
    """(lm, params, qparams, qadg, qasso, qstate) as `train_loop` starts
    them: random params from a `torch.Generator` seeded with `seed` on the
    device, 16-bit quantizers, the QADG space and QASSO. `layers` cuts
    the depth to that many layers; every width stays the config's."""
    dev = resolve_device(device)
    cfg = get_arch(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    comp = comp or CompressionConfig()
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(seed))
    qparams = lm.init_qparams(params, bits_init=16.0,
                              act_quant=comp.act_quant)
    base_opt = get_overrides(arch).get("base_optimizer", "adamw")
    qadg, qasso = build_geta(lm, comp, lr=3e-4, base_optimizer=base_opt)
    qadg.space.validate(params)
    return lm, params, qparams, qadg, qasso, qasso.init(params, qparams)


# a schedule whose step 0 is the last joint step: the partition is computed
# and the keep mask frozen in one step
JOINT_STEP0 = CompressionConfig(
    target_sparsity=0.3, warmup_steps=0, projection_periods=0,
    projection_steps=1, pruning_periods=1, pruning_steps=1, cooldown_steps=0)
# one step on two devices from one state: loss and (q_m, t) relative,
# params as max|diff| over max|x| per tensor; d by 1e-2 relative, since
# Eq 17 divides by cos(theta_d) of a masked sum with cancellation, which
# the card sums in another order. Masks must be identical.
STEP_TOLERANCES = {"loss": 1e-5, "params": 1e-4, "d": 1e-2, "q_m": 1e-4,
                   "t": 1e-4}


def step_on_devices(arch: str, devices: list[str], *, seed: int = 0,
                    comp: CompressionConfig = JOINT_STEP0
                    ) -> dict[str, tuple]:
    """The smoke config's step 0 under `comp` (default JOINT_STEP0; with
    `act_quant` it also quantizes the activation sites) on each of
    `devices`, keyed by device: (params, qparams, qstate, metrics). The
    state and the 2 x 16 batch are drawn once on the CPU from `seed` and
    copied to each device, so the runs differ only in where the kernels,
    or their plain versions, run."""
    lm, p0, q0, _, qasso, _ = init_geta(arch, True, seed=seed, comp=comp,
                                        device="cpu")
    tokens = torch.randint(0, lm.cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(seed))
    step = make_geta_train_step(lm, qasso)
    out = {}
    for dev in devices:
        d = resolve_device(dev)
        p = {k: v.to(d) for k, v in p0.items()}
        q = {k: QuantParams(*(t.to(d) for t in (v.d, v.q_m, v.t)))
             for k, v in q0.items()}
        out[dev] = step(p, q, qasso.init(p, q), {"tokens": tokens.to(d)})
    return out


def step_differences(want: tuple, got: tuple) -> dict:
    """How far one step's result `got` lies from `want`, both as
    `step_on_devices` returns them, in STEP_TOLERANCES' terms (d, q_m, t
    over the weight sites), plus `masks`: whether the partition and keep
    masks are identical, and, where there are activation sites (`.aq`),
    their (d, q_m, t) as `act_d`, `act_q_m`, `act_t`, relative."""
    (pw, qw, sw, mw), (pg, qg, sg, mg) = want, got
    cpu = lambda t: t.detach().cpu()
    out = {"loss": abs(float(mg["loss"]) - float(mw["loss"]))
           / abs(float(mw["loss"])),
           "params": max(float((cpu(pg[k]) - cpu(pw[k])).abs().max())
                         / max(float(cpu(pw[k]).abs().max()), 1e-30)
                         for k in pw),
           "masks": all(torch.equal(cpu(sg.redundant[k]), cpu(sw.redundant[k]))
                        and torch.equal(cpu(sg.keep_mask[k]),
                                        cpu(sw.keep_mask[k]))
                        for k in sw.redundant)}
    rel = lambda k, f: (abs(float(getattr(qg[k], f))
                            - float(getattr(qw[k], f)))
                        / abs(float(getattr(qw[k], f))))
    act = [k for k in qw if k.endswith(".aq")]
    for f in ("d", "q_m", "t"):
        out[f] = max(rel(k, f) for k in qw if k not in act)
        if act:
            out[f"act_{f}"] = max(rel(k, f) for k in act)
    return out


def train_loop(arch: str, smoke: bool, steps: int, batch: int, seq: int,
               ckpt_dir: Optional[str] = None, seed: int = 0,
               comp: Optional[CompressionConfig] = None,
               inject_failure_at: Optional[int] = None,
               log_every: int = 10, verbose: bool = True, mesh=None,
               fsdp: bool = False, checkpoint_every: Optional[int] = None,
               device=None, history: list | None = None,
               report: dict | None = None, layers: Optional[int] = None):
    """GETA training. Returns (state, qadg, qasso, losses) with state =
    {"params", "qparams", "qstate", "rng"}: "rng" is the data key of the
    next step (`data.synthetic.step_key`), so the stream of a restored run
    is the saved one. `layers` cuts the depth (widths stay). The loop is
    `run_steps`' (see there for `ckpt_dir`, `checkpoint_every`,
    `inject_failure_at`, `history` and `report`).

    `mesh` (a `launch.mesh.Mesh`, on each of its ranks) trains data
    parallel with the sharded step (`fsdp`: params and moments sharded on
    `embed` over the data axis); every rank draws the same init and batch
    and keeps its pieces, state is this rank's, checkpoints hold the full
    state and a restore places each leaf as the current mesh's shard.
    Every family trains so: an MoE's capacity is per sequence, so a rank's
    slice of whole sequences routes as the whole batch does; a codebook
    batch (B, S, C) and a vlm batch's patch embeds split with their
    sequences."""
    if fsdp and mesh is None:
        raise ValueError("fsdp shards over a mesh: pass mesh= "
                         "(--devices N)")
    comp = comp or default_compression(steps)
    lm, params, qparams, qadg, qasso, qstate = init_geta(
        arch, smoke, seed=seed, comp=comp, device=device, layers=layers)
    dev = params["embed"].device
    step, place_batch, state_sh = make_geta_train_step(lm, qasso), None, None
    if mesh is not None:
        plan = shlib.make_plan(mesh, fsdp=fsdp,
                               overrides=dict(get_overrides(arch)))
        p_sh = plan.shardings(lm.param_axes(),
                              {k: tuple(v.shape) for k, v in params.items()})
        step, (p_sh, q_sh, s_sh, b_sh) = make_sharded_geta_train_step(
            lm, qasso, mesh, params, qparams, param_shardings=p_sh)
        params, qstate = shlib.place(params, p_sh), shlib.place(qstate, s_sh)
        state_sh = {"params": p_sh, "qparams": q_sh, "qstate": s_sh,
                    "rng": shlib.NamedSharding(mesh, ())}
        place_batch = lambda b: shlib.place(b, b_sh)
    initial = {"params": params, "qparams": qparams, "qstate": qstate,
               "rng": step_key(seed, 0)}
    del params, qparams, qstate

    def batch_fn(i, key):
        b = batch_for(lm.cfg, seed, i, batch, seq, device=dev, key=key)
        return b if place_batch is None else place_batch(b)

    state, losses = run_steps(
        step, initial, steps, batch_fn, lambda i: step_key(seed, i),
        ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
        inject_failure_at=inject_failure_at, log_every=log_every,
        verbose=verbose and meshlib.world()[0] == 0, history=history,
        report=report, shardings=state_sh)
    return state, qadg, qasso, losses


def run_steps(step, initial: dict, steps: int, batch_fn, key_fn, *,
              ckpt_dir: Optional[str] = None,
              checkpoint_every: Optional[int] = None,
              inject_failure_at: Optional[int] = None, log_every: int = 10,
              verbose: bool = False, history: list | None = None,
              report: dict | None = None, shardings=None):
    """`steps` train steps from `initial` = {"params", "qparams",
    "qstate", "rng"}: step i draws `batch_fn(i, state["rng"])` and leaves
    rng = `key_fn(i + 1)`. Returns (final state, losses).

    With `ckpt_dir`, a `FaultTolerantLoop` checkpoints the whole state
    every `checkpoint_every` steps (default steps // 4) and, after a
    failure (`inject_failure_at` raises once at that step), restores the
    newest checkpoint, or `initial` if there is none, and replays: the
    final state equals an uninterrupted run's bit for bit, and `losses`
    holds the replayed steps' losses too; `initial` is kept unchanged for
    a restart before any checkpoint (the first step after one steps from
    a copy of the moments, which the update advances in place). Without
    `ckpt_dir` the entries move out of `initial`, which is left empty, so
    nothing holds the first step's tensors once they are replaced.
    `history`, when given, receives each step's metrics as
    Python numbers (stage, loss, lr, sparsity, bits) and its wall time;
    `report`, when given, receives the `RunResult` (with `ckpt_dir`) and
    each save's and restore's seconds. `shardings` (a tree of
    `NamedSharding`s over the state, under a mesh): a save gathers the
    full state and the mesh's first rank writes it; a restore places each
    leaf as this rank's shard."""
    losses = []
    pending_failure = [inject_failure_at]   # one-shot injection
    report = {} if report is None else report
    report.update(save_s=[], restore_s=[])

    def step_fn(state, i):
        if pending_failure[0] is not None and i == pending_failure[0]:
            pending_failure[0] = None
            raise RuntimeError("injected node failure")
        if state is initial:
            # the loop restarts from `initial` if a failure comes before
            # any checkpoint: step from a copy of the moments
            state = dict(state, qstate=state["qstate"]._replace(
                base=clone_tree(state["qstate"].base)))
        b = batch_fn(i, state["rng"])
        t0 = time.perf_counter()
        p, q, s, metrics = step(state["params"], state["qparams"],
                                state["qstate"], b)
        # Python numbers: the loss read syncs the device, so the wall time
        # (and the loop's straggler monitor) times the step's device work
        m = {k: (v if isinstance(v, int) else float(v))
             for k, v in metrics.items()}
        m["wall_s"] = time.perf_counter() - t0
        losses.append(m["loss"])
        if history is not None:
            history.append(m)
        if verbose and i % log_every == 0:
            print(f"step {i:4d} stage={m['stage']} loss={m['loss']:.4f} "
                  f"bits=[{m['bits_min']:.1f},{m['bits_max']:.1f}] "
                  f"sparsity={m['sparsity_hard']:.3f}")
        return {"params": p, "qparams": q, "qstate": s, "rng": key_fn(i + 1)}

    if not ckpt_dir:
        state = dict(initial)
        initial.clear()
        for i in range(steps):
            state = step_fn(state, i)
        return state, losses

    def save_fn(state, i):
        t0 = time.perf_counter()
        if shardings is None:
            save_checkpoint(ckpt_dir, i, state)
        else:
            mesh = shardings["rng"].mesh
            full = shlib.gather_tree(state, shardings)
            if mesh.rank == mesh.ranks[0]:
                save_checkpoint(ckpt_dir, i, full)
            mesh.barrier()
        report["save_s"].append(time.perf_counter() - t0)

    def restore_fn():
        t0 = time.perf_counter()
        out = restore_checkpoint(ckpt_dir, initial, shardings=shardings)
        if out is not None:
            report["restore_s"].append(time.perf_counter() - t0)
        return out

    loop = FaultTolerantLoop(
        FaultConfig(checkpoint_every=checkpoint_every or max(steps // 4, 1)),
        step_fn, save_fn, restore_fn)
    state, result = loop.run(initial, steps)
    report["run_result"] = result
    if verbose:
        print(f"done: {result}")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=None,
                    help="train data parallel on N ranks (processes) of a "
                         "(N, 1) mesh, one batch slice each (gloo on the "
                         "CPU; nccl when each rank has a card, else gloo "
                         "staged through host memory)")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --devices: shard params and optimizer "
                         "moments over the data axis")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.fsdp and not args.devices:
        ap.error("--fsdp shards over ranks: pass --devices N")
    t0 = time.time()
    if args.devices:
        runs = meshlib.spawn(_train_rank, args.devices,
                             str(resolve_device(args.device)), args)
        losses, sp = runs[0]
        if any(r != runs[0] for r in runs[1:]):
            raise AssertionError("the ranks' losses or masks differ")
    else:
        losses, sp = _train_rank(args)
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"final hard sparsity: {sp:.3f}")


def _train_rank(args) -> tuple[list, float]:
    """The CLI's run on this rank (on a mesh of every rank under
    `--devices`): (losses, final hard sparsity)."""
    mesh = meshlib.make_subset_mesh(args.devices) if args.devices else None
    state, _, qasso, losses = train_loop(
        args.arch, args.smoke, args.steps, args.batch, args.seq,
        ckpt_dir=args.ckpt_dir, seed=args.seed, mesh=mesh, fsdp=args.fsdp,
        device=args.device)
    return losses, float(qasso.space.sparsity(state["qstate"].keep_mask))


if __name__ == "__main__":
    main()

"""GETA training on one device: port of `repro.launch.train`.

The step is the JAX package's: loss -> gradients of (params, qparams) ->
QASSO update. `LM.loss` runs the block projections through the GEMM
kernels' autograd Functions and the quantizers through the fake-quant
kernels; QASSO runs its stage logic on the host. `train_loop(ckpt_dir=)`
checkpoints the whole state and resumes from the newest checkpoint after
a failure (`--ckpt-dir`).

Runs on CUDA; `--device cpu` runs the plain PyTorch versions of the
kernels instead (as the tests do). Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 5 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --full --steps 5 --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
      --ckpt-dir /path/to/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import (clone_tree, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import CompressionConfig, get_arch, get_overrides
from repro_torch.core.qadg import build_qadg
from repro_torch.core.qasso import QASSO, QASSOConfig
from repro_torch.core.quant import QuantParams
from repro_torch.data.synthetic import batch_for, step_key
from repro_torch.distributed.fault import FaultConfig, FaultTolerantLoop
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
    """GETA training on one device. Returns (state, qadg, qasso, losses)
    with state = {"params", "qparams", "qstate", "rng"}: "rng" is the data
    key of the next step (`data.synthetic.step_key`), so the stream of a
    restored run is the saved one. `layers` cuts the depth (widths stay).
    The loop is `run_steps`' (see there for `ckpt_dir`,
    `checkpoint_every`, `inject_failure_at`, `history` and `report`)."""
    if mesh is not None or fsdp:
        raise not_in_this_slice("sharded training (--devices, --fsdp)",
                                "ROADMAP Queue 1 item 14")
    comp = comp or default_compression(steps)
    lm, params, qparams, qadg, qasso, qstate = init_geta(
        arch, smoke, seed=seed, comp=comp, device=device, layers=layers)
    dev = params["embed"].device
    initial = {"params": params, "qparams": qparams, "qstate": qstate,
               "rng": step_key(seed, 0)}
    del params, qparams, qstate
    state, losses = run_steps(
        make_geta_train_step(lm, qasso), initial, steps,
        lambda i, key: batch_for(lm.cfg, seed, i, batch, seq, device=dev,
                                 key=key),
        lambda i: step_key(seed, i), ckpt_dir=ckpt_dir,
        checkpoint_every=checkpoint_every,
        inject_failure_at=inject_failure_at, log_every=log_every,
        verbose=verbose, history=history, report=report)
    return state, qadg, qasso, losses


def run_steps(step, initial: dict, steps: int, batch_fn, key_fn, *,
              ckpt_dir: Optional[str] = None,
              checkpoint_every: Optional[int] = None,
              inject_failure_at: Optional[int] = None, log_every: int = 10,
              verbose: bool = False, history: list | None = None,
              report: dict | None = None):
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
    each save's and restore's seconds."""
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
        save_checkpoint(ckpt_dir, i, state)
        report["save_s"].append(time.perf_counter() - t0)

    def restore_fn():
        t0 = time.perf_counter()
        out = restore_checkpoint(ckpt_dir, initial)
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
                    help="data-parallel mesh (not in the port yet)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params/opt-state (not in the port yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    t0 = time.time()
    state, qadg, qasso, losses = train_loop(
        args.arch, args.smoke, args.steps, args.batch, args.seq,
        ckpt_dir=args.ckpt_dir, seed=args.seed, mesh=args.devices,
        fsdp=args.fsdp, device=args.device)
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    sp = float(qasso.space.sparsity(state["qstate"].keep_mask))
    print(f"final hard sparsity: {sp:.3f}")


if __name__ == "__main__":
    main()

"""The paper's experiment runners (Tables 2-5, Fig 4): port of
`benchmarks/geta_experiments.py`, with `benchmarks/run.py`'s paper-table
benches as `main`.

Each runner trains one model with GETA (or its baseline) and returns the
reference's dict (`acc` or `em`, `rel_bops`, and for `run_geta_cnn`
`wall_s`, `sparsity`, `mean_bits`, `loss`), plus what the run did:
`stages`, `losses` and `step_walls` a step, and for the GETA runs
`k_units`, `pruned_units`, `nonzero_pruned` (elements of pruned units
left nonzero), `bits_min` / `bits_max` over the sites, the final bit
range `bit_lower` / `bit_upper_final` and the site counts. A runner is
its training loop (`train_geta`, `train_baseline`) and an evaluation
tail (`cnn_tail`, `bert_tail`: accuracy or exact match on the held-out
batch, `model_bops` and `construct_subnet`), which a test can call on
given params.

The runners take the model: a `CNNSpec` (the reduced `_R` specs below,
or `models.cnn`'s full VGG7, RESNET20, RESNET56) or the `BertEncoder`
sizes (`BERT_R`, the reference's BERT-small, or `BERT_FULL`, the
encoder's defaults). Keyword-only hooks carry the parity tests' inputs:
`init_params` (numpy arrays, e.g. the reference's `init`), `batches` (a
function of the step giving a batch) and `test_batch`; params and
batches cross as numpy since the reference draws from `jax.random`.

Runs on CUDA unless `device="cpu"`; the step runs under
torch.use_deterministic_algorithms, and `_Deterministic` sets the
CUBLAS_WORKSPACE_CONFIG that cuBLAS needs for it. On the card the
fake-quant kernels carry the quantizers; the convolutions and BERT's products are plain
PyTorch, as they are plain XLA in the reference.

  PYTHONPATH=src python -m repro_torch.launch.experiments [--fast] \
      [--only table2] [--spec full|reduced] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.bops import model_bops
from repro_torch.core.qadg import build_qadg
from repro_torch.core.qasso import QASSO, QASSOConfig
from repro_torch.core.quant import bit_width
from repro_torch.core.subnet import construct_subnet
from repro_torch.data.synthetic import image_batch, qa_batch
from repro_torch.launch.engine import resolve_device
from repro_torch.launch.train import loss_and_grads, make_geta_train_step
from repro_torch.models import cnn
from repro_torch.models.bert import BertEncoder
from repro_torch.models.cnn import CNN, CNNSpec
from repro_torch.optim.base import adam
from repro_torch.optim.schedules import constant

# Reduced CNN specs (same family, small widths), the reference's
RESNET20_R = CNNSpec("resnet20-r", "resnet", [8, 16, 32],
                     blocks_per_stage=2)
RESNET56_R = CNNSpec("resnet56-r", "resnet", [8, 16, 32],
                     blocks_per_stage=3)
VGG7_R = CNNSpec("vgg7-r", "vgg", [16, 16, 32, 32, 64, 64], fc_dim=128)
# the BERT encoder sizes: the reference runners' BERT-small, and the
# encoder's defaults (4 layers, d_model 256, d_ff 1024, vocab 8192)
BERT_R = dict(n_layers=2, d_model=64, n_heads=4, d_ff=256, vocab=512)
BERT_FULL: dict = {}
TEST_STEP = {"cnn": 10_000, "bert": 77_000}   # held-out batches' step


def qasso_cfg(steps: int, sparsity: float, b_l=4.0, b_u=16.0,
              skip_stage: Optional[str] = None) -> QASSOConfig:
    """Schedule scaled to `steps`, with optional stage ablation (Fig 4a)."""
    w = max(steps // 10, 1)
    pp, ps = 3, max(steps // 15, 1)
    rp, rs = 4, max(steps // 12, 1)
    cd = max(steps // 4, 1)
    if skip_stage == "warmup":
        w = 0
    if skip_stage == "projection":
        pp = 1
        ps = 1
    if skip_stage == "joint":
        rp, rs = 1, 1
    if skip_stage == "cooldown":
        cd = 1
    return QASSOConfig(
        target_sparsity=sparsity, bit_lower=b_l, bit_upper=b_u,
        warmup_steps=w, projection_periods=pp, projection_steps=ps,
        bit_reduction=min(2.0, (b_u - b_l) / pp),
        pruning_periods=rp, pruning_steps=rs, cooldown_steps=cd,
        base_optimizer="adam", lr_quant=1e-3)


@dataclasses.dataclass
class Trained:
    """A training loop's end: the model, its graph and optimizer, the
    final params, quantizers and QASSO state, and the run's trace."""
    model: Any
    qadg: Any
    qasso: Optional[QASSO]
    params: dict
    qparams: Optional[dict]
    state: Any
    losses: list
    stages: list
    step_walls: list
    wall_s: float


class _Deterministic:
    """torch.use_deterministic_algorithms for the loop (phase 11's rule:
    no atomics in a sum that feeds a QASSO decision), restored after.
    cuBLAS is deterministic only with a fixed workspace, and PyTorch
    refuses its products under this mode unless CUBLAS_WORKSPACE_CONFIG
    says so: it is set here, before the loop's first product, unless the
    caller set it."""

    def __enter__(self):
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)


def _init(model, seed: int, init_params, dev) -> dict:
    if init_params is not None:
        return params_from_numpy(init_params, dev)
    return model.init(torch.Generator(device=dev).manual_seed(seed))


def _on(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def train_geta(model, qparams_bits: float, cfg: QASSOConfig, lr: float,
               batches: Callable[[int], dict], dev, *, seed: int = 0,
               act_quant: bool = False, init_params=None,
               validate: bool = True) -> Trained:
    """The GETA loop of the runners: init, quantizers at `qparams_bits`,
    QADG, QASSO with a constant lr, `cfg.total_steps` steps on
    `batches(i)`."""
    params = _init(model, seed, init_params, dev)
    qparams = model.init_qparams(params, bits_init=qparams_bits,
                                 act_quant=act_quant)
    qadg = build_qadg(model.build_graph(act_quant=act_quant).graph)
    if validate:
        qadg.space.validate(params)
    qasso = QASSO(qadg.space, qadg.sites, cfg, constant(lr))
    state = qasso.init(params, qparams)
    step = make_geta_train_step(model, qasso)
    losses, stages, walls = [], [], []
    with _Deterministic():
        t0 = time.perf_counter()
        for i in range(cfg.total_steps):
            b = _on(batches(i), dev)
            t1 = time.perf_counter()
            params, qparams, state, met = step(params, qparams, state, b)
            losses.append(float(met["loss"]))         # syncs the device
            walls.append(time.perf_counter() - t1)
            stages.append(met["stage"])
        wall = time.perf_counter() - t0
    return Trained(model, qadg, qasso, params, qparams, state, losses,
                   stages, walls, wall)


def train_baseline(model, steps: int, lr: float,
                   batches: Callable[[int], dict], dev, *, seed: int = 0,
                   init_params=None) -> Trained:
    """The uncompressed FP32 baseline: Adam on the loss without
    quantizers."""
    params = _init(model, seed, init_params, dev)
    opt = adam()
    ostate = opt.init(params)
    lr_t = torch.tensor(lr, dtype=torch.float32)
    losses, walls = [], []
    with _Deterministic():
        t0 = time.perf_counter()
        for i in range(steps):
            b = _on(batches(i), dev)
            t1 = time.perf_counter()
            loss, gx, _ = loss_and_grads(model, params, None, b)
            with torch.no_grad():
                delta, ostate = opt.update(gx, ostate, params, lr_t)
                params = {k: params[k] + delta[k] for k in params}
            losses.append(float(loss))
            walls.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
    return Trained(model, None, None, params, None, ostate, losses, [],
                   walls, wall)


def geta_facts(run: Trained) -> dict:
    """What a GETA run did, beside its results: the stages, losses and
    step walls, the units QASSO pruned against its k_units, the elements
    of pruned units left nonzero, the sites' bit range, and the counts of
    weight sites, activation sites and quantized params."""
    qasso, keep = run.qasso, run.state.keep_mask
    elem_keep = qasso._keep_elem_tree(run.params, keep)
    bits = [float(bit_width(q.d, q.q_m, q.t)) for q in run.qparams.values()]
    return {"stages": run.stages, "losses": run.losses,
            "step_walls": run.step_walls, "k_units": qasso.k_units,
            "pruned_units": sum(int(torch.sum(v < 0.5))
                                for v in keep.values()),
            "nonzero_pruned": sum(int(torch.count_nonzero(
                p * (1.0 - elem_keep[k]).to(p.dtype)))
                for k, p in run.params.items()),
            "bits_min": min(bits), "bits_max": max(bits),
            "bit_lower": qasso.cfg.bit_lower,
            "bit_upper_final": qasso.cfg.bit_upper_final,
            "n_weight_sites": len(qasso.weight_sites),
            "n_act_sites": len(qasso.act_sites),
            "n_quantized_params": sum(len(s.quantized_params)
                                      for s in qasso.weight_sites)}


@torch.no_grad()
def cnn_tail(model: CNN, qadg, params: dict, qparams: Optional[dict],
             keep_mask: Optional[dict], test: dict) -> dict:
    """The CNN runners' evaluation: accuracy on `test`, and with
    quantizers rel_bops (per image, weights' and activations' bits; 32
    where a layer has no site) and `construct_subnet`'s sparsity and mean
    bits."""
    out = {"acc": float(model.accuracy(params, qparams, test))}
    if qparams is None:
        out["rel_bops"] = 1.0
        return out
    bops = model_bops(qadg, params, qparams, model.layer_macs(1),
                      masks=keep_mask, act_bits_default=32.0)
    sub = construct_subnet(qadg, params, qparams, keep_mask)
    out.update(rel_bops=bops["rel_bops"], sparsity=sub.meta["sparsity"],
               mean_bits=sub.meta["mean_bits"])
    return out


@torch.no_grad()
def bert_tail(model: BertEncoder, qadg, params: dict, qparams: dict,
              keep_mask: dict, test: dict, seq: int) -> dict:
    """The BERT runners' evaluation: exact match on `test` and rel_bops
    over `seq` tokens."""
    em = float(model.exact_match(params, qparams, test))
    bops = model_bops(qadg, params, qparams, model.layer_macs(1, seq),
                      masks=keep_mask)
    return {"em": em, "rel_bops": bops["rel_bops"]}


def _images(seed: int, batch: int, dev):
    return lambda i: image_batch(seed, i, batch, device=dev)


def run_geta_cnn(spec: CNNSpec, steps=240, batch=64, sparsity=0.35,
                 b_l=4.0, b_u=16.0, act_quant=False, lr=3e-3,
                 skip_stage=None, seed=0, *, device=None, init_params=None,
                 batches=None, test_batch=None) -> dict:
    """GETA on a CNN: accuracy, rel_bops, wall_s, the subnet's sparsity
    and mean bits, the last loss (and `geta_facts`)."""
    dev = resolve_device(device)
    model = CNN(spec)
    cfg = qasso_cfg(steps, sparsity, b_l, b_u, skip_stage)
    run = train_geta(model, b_u, cfg, lr,
                     batches or _images(seed, batch, dev), dev, seed=seed,
                     act_quant=act_quant, init_params=init_params)
    test = _on(test_batch or image_batch(seed + 1, TEST_STEP["cnn"], 256,
                                         device=dev), dev)
    out = cnn_tail(model, run.qadg, run.params, run.qparams,
                   run.state.keep_mask, test)
    out.update(wall_s=run.wall_s, loss=run.losses[-1])
    out.update(geta_facts(run))
    return out


def run_baseline_cnn(spec: CNNSpec, steps=240, batch=64, lr=3e-3, seed=0, *,
                     device=None, init_params=None, batches=None,
                     test_batch=None) -> dict:
    """Uncompressed FP32 baseline: accuracy, rel_bops 1."""
    dev = resolve_device(device)
    model = CNN(spec)
    run = train_baseline(model, steps, lr,
                         batches or _images(seed, batch, dev), dev,
                         seed=seed, init_params=init_params)
    test = _on(test_batch or image_batch(seed + 1, TEST_STEP["cnn"], 256,
                                         device=dev), dev)
    out = cnn_tail(model, None, run.params, None, None, test)
    out.update(wall_s=run.wall_s, losses=run.losses,
               step_walls=run.step_walls)
    return out


def _bert(encoder: Optional[dict], seq: int) -> BertEncoder:
    return BertEncoder(**dict(BERT_R if encoder is None else encoder),
                       max_seq=seq)


def _qa(seed: int, batch: int, seq: int, vocab: int, dev):
    return lambda i: qa_batch(seed, i, batch, seq, vocab, device=dev)


def run_geta_bert(sparsity: float, steps=200, batch=16, seq=64,
                  b_l=4.0, b_u=16.0, seed=0, *, encoder: Optional[dict] = None,
                  device=None, init_params=None, batches=None,
                  test_batch=None) -> dict:
    """GETA joint on the BERT encoder + synthetic QA (Table 3, GETA rows):
    exact match and rel_bops (and `geta_facts`, wall_s). `encoder`: the
    `BertEncoder` sizes (default `BERT_R`)."""
    dev = resolve_device(device)
    model = _bert(encoder, seq)
    cfg = qasso_cfg(steps, sparsity, b_l, b_u)
    run = train_geta(model, 8.0, cfg, 2e-3,
                     batches or _qa(seed, batch, seq, model.V, dev), dev,
                     seed=seed, init_params=init_params)
    test = _on(test_batch or qa_batch(seed + 1, TEST_STEP["bert"], 128, seq,
                                      model.V, device=dev), dev)
    out = bert_tail(model, run.qadg, run.params, run.qparams,
                    run.state.keep_mask, test, seq)
    out.update(wall_s=run.wall_s)
    out.update(geta_facts(run))
    return out


def run_prune_then_ptq_bert(sparsity: float, steps=200, batch=16, seq=64,
                            ptq_bits=8.0, seed=0, *,
                            encoder: Optional[dict] = None, device=None,
                            init_params=None, batches=None,
                            test_batch=None) -> dict:
    """Sequential baseline of Table 3: pruning-aware training (QASSO with
    the bits pinned at 32, so quantization exerts no pressure) then
    post-training quantization of the survivors at `ptq_bits`, no
    retraining: exact match and rel_bops (and `geta_facts` of the
    pruning run, wall_s)."""
    dev = resolve_device(device)
    model = _bert(encoder, seq)
    cfg = qasso_cfg(steps, sparsity, b_l=32.0, b_u=32.0)
    run = train_geta(model, 32.0, cfg, 2e-3,
                     batches or _qa(seed, batch, seq, model.V, dev), dev,
                     seed=seed, init_params=init_params, validate=False)
    ptq = model.init_qparams(run.params, bits_init=ptq_bits)
    test = _on(test_batch or qa_batch(seed + 1, TEST_STEP["bert"], 128, seq,
                                      model.V, device=dev), dev)
    out = bert_tail(model, run.qadg, run.params, ptq, run.state.keep_mask,
                    test, seq)
    out.update(wall_s=run.wall_s)
    out.update(geta_facts(run))
    return out


# ----------------------------------------------------------- the benches
SPECS = {"reduced": {"resnet20": RESNET20_R, "resnet56": RESNET56_R,
                     "vgg7": VGG7_R, "bert": BERT_R},
         "full": {"resnet20": cnn.RESNET20, "resnet56": cnn.RESNET56,
                  "vgg7": cnn.VGG7, "bert": BERT_FULL}}


def _row(name, us, derived):
    print(f"{name},{us:.1f},{derived}", flush=True)


def _us(r: dict, steps: int) -> float:
    return r["wall_s"] / max(steps, 1) * 1e6


def bench_table2_resnet20(spec, dev, fast=False):
    """Table 2: ResNet20/CIFAR10 — GETA structured vs baseline (wt quant)."""
    steps = 120 if fast else 240
    base = run_baseline_cnn(spec["resnet20"], steps=steps, device=dev)
    geta = run_geta_cnn(spec["resnet20"], steps=steps, sparsity=0.35,
                        act_quant=False, device=dev)
    _row("table2_resnet20_baseline", 0.0,
         f"acc={base['acc']:.3f};rel_bops=1.0")
    _row("table2_resnet20_geta", _us(geta, steps),
         f"acc={geta['acc']:.3f};rel_bops={geta['rel_bops']:.4f};"
         f"sparsity={geta['sparsity']:.2f};bits={geta['mean_bits']:.1f}")
    return {"base": base, "geta": geta}


def bench_table4_vgg7(spec, dev, fast=False):
    """Table 4: VGG7/CIFAR10 — weight AND activation quantization."""
    steps = 100 if fast else 200
    base = run_baseline_cnn(spec["vgg7"], steps=steps, device=dev)
    geta = run_geta_cnn(spec["vgg7"], steps=steps, sparsity=0.5,
                        act_quant=True, device=dev)
    _row("table4_vgg7_baseline", 0.0, f"acc={base['acc']:.3f};rel_bops=1.0")
    _row("table4_vgg7_geta_wa", _us(geta, steps),
         f"acc={geta['acc']:.3f};rel_bops={geta['rel_bops']:.4f}")
    return {"base": base, "geta": geta}


def bench_table5_resnet56(spec, dev, fast=False):
    """Table 5 analogue: deeper CNN at two sparsities (40%/50%)."""
    steps = 100 if fast else 200
    out = {}
    for sp in (0.4, 0.5):
        r = run_geta_cnn(spec["resnet56"], steps=steps, sparsity=sp,
                         device=dev)
        _row(f"table5_resnet56_sp{int(sp*100)}", _us(r, steps),
             f"acc={r['acc']:.3f};rel_bops={r['rel_bops']:.4f}")
        out[sp] = r
    return out


def bench_table3_bert(spec, dev, fast=False):
    """Table 3: BERT/SQuAD-style — GETA joint vs prune-then-PTQ."""
    steps = 100 if fast else 200
    sparsities = (0.3, 0.5) if fast else (0.1, 0.3, 0.5, 0.7)
    out = {}
    for sp in sparsities:
        t0 = time.time()
        joint = run_geta_bert(sp, steps=steps, encoder=spec["bert"],
                              device=dev)
        us = (time.time() - t0) / steps * 1e6
        seq = run_prune_then_ptq_bert(sp, steps=steps, encoder=spec["bert"],
                                      device=dev)
        _row(f"table3_bert_sp{int(sp*100)}_geta", us,
             f"em={joint['em']:.3f};rel_bops={joint['rel_bops']:.4f}")
        _row(f"table3_bert_sp{int(sp*100)}_prune_ptq", us,
             f"em={seq['em']:.3f};rel_bops={seq['rel_bops']:.4f}")
        out[sp] = {"joint": joint, "sequential": seq}
    return out


def bench_fig4a_ablation(spec, dev, fast=False):
    """Fig 4a: remove each QASSO stage, measure the accuracy drop."""
    steps = 80 if fast else 160
    full = run_geta_cnn(spec["resnet56"], steps=steps, sparsity=0.35,
                        device=dev)
    _row("fig4a_full", 0.0, f"acc={full['acc']:.3f}")
    out = {"full": full}
    for stage in ("warmup", "projection", "joint", "cooldown"):
        r = run_geta_cnn(spec["resnet56"], steps=steps, sparsity=0.35,
                         skip_stage=stage, device=dev)
        _row(f"fig4a_no_{stage}", 0.0,
             f"acc={r['acc']:.3f};delta={r['acc']-full['acc']:+.3f}")
        out[stage] = r
    return out


def bench_fig4b_frontier(spec, dev, fast=False):
    """Fig 4b: sparsity x bit-range compression frontier."""
    steps = 60 if fast else 120
    grid_sp = (0.3, 0.6) if fast else (0.3, 0.5, 0.7)
    grid_b = ((4, 6),) if fast else ((2, 4), (4, 6), (6, 8))
    out = {}
    for sp in grid_sp:
        for (bl, bu) in grid_b:
            r = run_geta_cnn(spec["resnet56"], steps=steps, sparsity=sp,
                             b_l=float(bl), b_u=float(bu) + 8, device=dev)
            _row(f"fig4b_sp{int(sp*100)}_b{bl}", 0.0,
                 f"acc={r['acc']:.3f};rel_bops={r['rel_bops']:.4f}")
            out[(sp, bl)] = r
    return out


BENCHES = [bench_table2_resnet20, bench_table3_bert, bench_table4_vgg7,
           bench_table5_resnet56, bench_fig4a_ablation, bench_fig4b_frontier]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced step counts and sweeps")
    ap.add_argument("--only", default=None,
                    help="run the benches whose name holds this string")
    ap.add_argument("--spec", default="reduced", choices=["reduced", "full"],
                    help="the reference's _R specs and BERT-small, or the "
                         "full VGG7 / ResNet20 / ResNet56 and BertEncoder()")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    failed = 0
    for fn in BENCHES:
        if args.only and args.only not in fn.__name__:
            continue
        try:
            fn(SPECS[args.spec], dev, fast=args.fast)
        except Exception as e:  # report, keep the harness going
            failed += 1
            _row(fn.__name__ + "_FAILED", 0.0, f"{type(e).__name__}:{e}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

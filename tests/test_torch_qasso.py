"""QASSO (Algorithms 2-4) in the port against the JAX package's.

Parity: the JAX package trains the internlm2 smoke LM through every stage
(warm-up 1, projection 1 x 1, pruning 2 x 1, cool-down 1); before each of
its five steps the whole train state (params, quantizers, AdamW moments,
partition and keep masks) crosses into the port as numpy, the port takes
the same step on the same batch, and the two results must agree:

- partition and keep masks identical (these fixtures have no near-tie
  cutoffs);
- params within 1e-4 of each tensor's max|x| (f32 sums in another order);
- quantizer (q_m, t) within 1e-4 relative, and d within 1e-2 relative:
  Eq 17 divides by cos(theta_d), a masked sum with cancellation.

The rest mirrors `tests/test_qasso.py` on the port alone: the stage
schedule, exact Eq 7b sparsity, Eq 7c bit ranges, exact zeros on pruned
units, frozen quantizers in cool-down, and a falling loss.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import CompressionConfig as JComp
from repro.configs import get_arch as j_get_arch
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.launch import train as JT
from repro.models.transformer import LM as JLM
from repro_torch.configs import CompressionConfig, get_arch
from repro_torch.convert import geta_state_from_numpy
from repro_torch.core import quant as Q
from repro_torch.core.graph import GraphBuilder
from repro_torch.core.qadg import build_qadg
from repro_torch.core.qasso import QASSO, QASSOConfig
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM
from repro_torch.optim.schedules import constant

ARCH = "internlm2-1.8b"
SCHED = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
             projection_steps=1, pruning_periods=2, pruning_steps=1,
             cooldown_steps=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_trajectory():
    """(per-step JAX states before and after, batches) for 5 steps."""
    jlm = JLM(j_get_arch(ARCH, smoke=True))
    comp = JComp(**SCHED)
    qadg, qasso = JT.build_geta(jlm, comp, lr=3e-3)
    params, _ = jlm.init(jax.random.PRNGKey(0))
    qparams = jlm.init_qparams(params, bits_init=16.0)
    state = qasso.init(params, qparams)
    step = jax.jit(JT.make_geta_train_step(jlm, qasso))
    traj = []
    for i in range(qasso.cfg.total_steps):
        batch = j_lm_batch(0, i, 2, 16, jlm.cfg.vocab)
        before = (_np(params), _np(qparams), _np(state))
        params, qparams, state, metrics = step(params, qparams, state, batch)
        traj.append((before, (_np(params), _np(qparams), _np(state)),
                     np.asarray(batch["tokens"]), int(metrics["stage"])))
    return traj


def _port():
    lm = LM(get_arch(ARCH, smoke=True))
    _, qasso = T.build_geta(lm, CompressionConfig(**SCHED), lr=3e-3)
    return lm, qasso


@pytest.mark.parametrize("i", range(5))
def test_one_update_per_stage_matches_jax(jax_trajectory, i):
    (jp, jq, js), (wp, wq, ws), tokens, stage = jax_trajectory[i]
    assert stage == [0, 1, 2, 2, 3][i]
    lm, qasso = _port()
    p, q, s = geta_state_from_numpy(jp, jq, js)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    p2, q2, s2, m = T.make_geta_train_step(lm, qasso)(p, q, s, batch)
    assert m["stage"] == stage and s2.step == i + 1
    for k in ws.redundant:
        np.testing.assert_array_equal(s2.redundant[k].numpy(),
                                      ws.redundant[k], err_msg=k)
        np.testing.assert_array_equal(s2.keep_mask[k].numpy(),
                                      ws.keep_mask[k], err_msg=k)
    for k, w in wp.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(p2[k].float().numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)
    for k, w in wq.items():
        for f, rtol in (("d", 1e-2), ("q_m", 1e-4), ("t", 1e-4)):
            np.testing.assert_allclose(float(getattr(q2[k], f)),
                                       float(getattr(w, f)), rtol=rtol,
                                       err_msg=f"{k}.{f}")
    for k in ws.base.m:
        for got, want in ((s2.base.m[k], ws.base.m[k]),
                          (s2.base.v[k], ws.base.v[k])):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                err_msg=k)


# ------------------------------------------- mirrors of test_qasso.py
def _mlp_problem(seed=0, hidden=32):
    gb = GraphBuilder()
    gb.input("in")
    gb.linear("fc1", "fc1.w", bias="fc1.b", out_dim=hidden)
    gb.act("relu1")
    gb.linear("fc2", "fc2.w", out_dim=8, non_prunable=True)
    gb.output("out")
    gb.attach_weight_quant("fc1", "fc1.w.wq")
    gb.attach_weight_quant("fc2", "fc2.w.wq")
    gb.insert_act_quant("relu1", "fc2", "act1.aq")
    qadg = build_qadg(gb.graph)
    gen = torch.Generator().manual_seed(seed)
    params = {"fc1.w": torch.randn((8, hidden), generator=gen) * 0.3,
              "fc1.b": torch.zeros((hidden,)),
              "fc2.w": torch.randn((hidden, 8), generator=gen) * 0.3}
    qparams = {"fc1.w.wq": Q.init_quant_params(params["fc1.w"], bits=16.0),
               "fc2.w.wq": Q.init_quant_params(params["fc2.w"], bits=16.0),
               "act1.aq": Q.init_quant_params(q_m=4.0, bits=16.0)}
    X = torch.randn((64, 8), generator=gen)
    Y = X @ torch.randn((8, 8), generator=gen)

    def loss_fn(p, q):
        def fq(x, qp):
            return Q.fake_quant(x, qp.d, qp.q_m, qp.t)
        h = torch.relu(X @ fq(p["fc1.w"], q["fc1.w.wq"]) + p["fc1.b"])
        h = fq(h, q["act1.aq"])
        return torch.mean((h @ fq(p["fc2.w"], q["fc2.w.wq"]) - Y) ** 2)

    return qadg, params, qparams, loss_fn


CFG = QASSOConfig(target_sparsity=0.5, bit_lower=4, bit_upper=16,
                  warmup_steps=10, projection_periods=3, projection_steps=6,
                  bit_reduction=2, pruning_periods=4, pruning_steps=8,
                  cooldown_steps=15, base_optimizer="adam", lr_quant=1e-3)


def _grads(loss_fn, params, qparams):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    q = {k: Q.QuantParams(*(t.detach().requires_grad_(True)
                            for t in (v.d, v.q_m, v.t)))
         for k, v in qparams.items()}
    loss = loss_fn(p, q)
    flat = list(p.values()) + [t for v in q.values()
                               for t in (v.d, v.q_m, v.t)]
    g = torch.autograd.grad(loss, flat)
    gx = dict(zip(p, g[:len(p)]))
    gq = {k: Q.QuantParams(*g[len(p) + 3 * i:len(p) + 3 * i + 3])
          for i, k in enumerate(q)}
    return loss.detach(), gx, gq


def run_qasso(cfg=CFG, seed=0, problem=_mlp_problem, snap_at=None):
    """Full-schedule run; returns (qadg, qasso, params, qparams, state,
    history, quantizers after step `snap_at`)."""
    qadg, params, qparams, loss_fn = problem(seed)
    qasso = QASSO(qadg.space, qadg.sites, cfg, constant(5e-3))
    state = qasso.init(params, qparams)
    hist, snap = [], None
    for i in range(cfg.total_steps):
        loss, gx, gq = _grads(loss_fn, params, qparams)
        params, qparams, state, m = qasso.update(params, qparams, gx, gq,
                                                 state)
        hist.append({"stage": m["stage"], "loss": float(loss)})
        if i == snap_at:
            snap = {k: [float(t) for t in (v.d, v.q_m, v.t)]
                    for k, v in qparams.items()}
    return qadg, qasso, params, qparams, state, hist, snap


@pytest.fixture(scope="module")
def mlp_run():
    return run_qasso(snap_at=CFG.joint_end)


def test_stage_schedule(mlp_run):
    stages = [h["stage"] for h in mlp_run[5]]
    assert stages[0] == 0
    assert stages[CFG.warmup_end] == 1
    assert stages[CFG.projection_end] == 2
    assert stages[CFG.joint_end] == 3
    assert sorted(set(stages)) == [0, 1, 2, 3]


def test_exact_sparsity_control(mlp_run):
    qasso, state = mlp_run[1], mlp_run[4]
    sp = float(qasso.space.sparsity(state.keep_mask))
    assert abs(sp - CFG.target_sparsity) <= 1.0 / qasso.total_units + 1e-6


def test_bit_constraints_satisfied(mlp_run):
    qadg, qparams = mlp_run[0], mlp_run[3]
    for s in qadg.sites:
        qp = qparams[s.name]
        b = float(Q.bit_width(qp.d, qp.q_m, qp.t))
        assert CFG.bit_lower - 1e-3 <= b <= CFG.bit_upper_final + 1e-3, \
            (s.name, b)


def test_pruned_units_exactly_zero(mlp_run):
    qasso, params, state = mlp_run[1], mlp_run[2], mlp_run[4]
    fam = qasso.space.prunable_families()[0]
    pruned = torch.nonzero(state.keep_mask[fam.name] < 0.5)[:, 0]
    assert len(pruned) > 0
    assert not params["fc1.w"][:, pruned].any()
    assert not params["fc1.b"][pruned].any()
    assert not params["fc2.w"][pruned, :].any()


def test_loss_decreases_overall(mlp_run):
    hist = mlp_run[5]
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7


def test_quant_params_frozen_in_cooldown(mlp_run):
    qparams, snap = mlp_run[3], mlp_run[6]
    final = {k: [float(t) for t in (v.d, v.q_m, v.t)]
             for k, v in qparams.items()}
    assert final == snap


def test_stage_index_partitions_the_horizon():
    q = QASSO.__new__(QASSO)
    q.cfg = CFG
    stages = [q.stage_index(i) for i in range(CFG.total_steps)]
    edges = [0, CFG.warmup_end, CFG.projection_end, CFG.joint_end,
             CFG.total_steps]
    for s in range(4):
        assert set(stages[edges[s]:edges[s + 1]]) <= {s}
    assert stages == sorted(stages)

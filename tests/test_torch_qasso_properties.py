"""Property-based invariants of the port's quantizer projection and QASSO
(hypothesis), mirroring `tests/test_qasso_properties.py` and the property
tests of `tests/test_quant.py` and `tests/test_qasso.py`:

1. PPSG projection always lands the bit width inside [b_l, b_u], with q_m
   and t untouched, for any quantizer state; the port's projected d is the
   JAX package's within 1e-6 relative (XLA's CPU exp2 is a few ulp off
   at integers, torch's is exact).
2. A live run's projection stage keeps every site inside its period's
   shrinking range.
3. Cool-down hard-zeros exactly the redundant groups, at the Eq 7b count.
4. The stage boundaries partition [0, total_steps).
5. Proposition 5.1: the Eq 16/17 rules give a descent direction.
"""
import dataclasses

import pytest

pytest.importorskip("hypothesis")  # property-based tests; see requirements-dev.txt
import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.graph import GraphBuilder  # noqa: E402
from repro_torch.core.qadg import build_qadg  # noqa: E402
from repro_torch.core.qasso import QASSO, QASSOConfig  # noqa: E402
from test_torch_qasso import _grads, run_qasso  # noqa: E402

f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731


@given(qm=st.floats(0.05, 8.0), t=st.floats(0.2, 3.0),
       bits0=st.floats(1.1, 28.0), b_l=st.floats(2.0, 6.0),
       span=st.floats(1.0, 14.0))
@settings(max_examples=200)
def test_projection_keeps_bits_in_range(qm, t, bits0, b_l, span):
    b_u = b_l + span
    qp = Q.QuantParams(d=Q.step_size_for_bits(f32(qm), f32(t), f32(bits0)),
                       q_m=f32(qm), t=f32(t))
    out = Q.project_step_size(qp, b_l, b_u)
    b = float(Q.bit_width(out.d, out.q_m, out.t))
    assert b_l - 1e-3 <= b <= b_u + 1e-3, (b, b_l, b_u)
    assert torch.equal(out.q_m, qp.q_m) and torch.equal(out.t, qp.t)
    jq = JQ.QuantParams(d=jnp.float32(float(qp.d)), q_m=jnp.float32(qm),
                        t=jnp.float32(t))
    jd = float(JQ.project_step_size(jq, b_l, b_u).d)
    assert float(out.d) == pytest.approx(jd, rel=1e-6)


@given(bits=st.floats(3.0, 12.0))
@settings(max_examples=25, deadline=None)
def test_init_matches_requested_bits(bits):
    w = torch.randn((16, 16), generator=torch.Generator().manual_seed(4))
    qp = Q.init_quant_params(w, bits=bits)
    assert abs(float(Q.bit_width(qp.d, qp.q_m, qp.t)) - bits) < 1e-3


def _tiny_problem(seed=0, hidden=16):
    gb = GraphBuilder()
    gb.input("in")
    gb.linear("fc1", "fc1.w", out_dim=hidden)
    gb.act("relu1")
    gb.linear("fc2", "fc2.w", out_dim=4, non_prunable=True)
    gb.output("out")
    gb.attach_weight_quant("fc1", "fc1.w.wq")
    gb.attach_weight_quant("fc2", "fc2.w.wq")
    qadg = build_qadg(gb.graph)
    gen = torch.Generator().manual_seed(seed)
    params = {"fc1.w": torch.randn((6, hidden), generator=gen) * 0.4,
              "fc2.w": torch.randn((hidden, 4), generator=gen) * 0.4}
    qparams = {k + ".wq": Q.init_quant_params(v, bits=16.0)
               for k, v in params.items()}
    X = torch.randn((32, 6), generator=gen)
    Y = X @ torch.randn((6, 4), generator=gen)

    def loss_fn(p, q):
        def fq(x, qp):
            return Q.fake_quant(x, qp.d, qp.q_m, qp.t)
        h = torch.relu(X @ fq(p["fc1.w"], q["fc1.w.wq"]))
        return torch.mean((h @ fq(p["fc2.w"], q["fc2.w.wq"]) - Y) ** 2)

    return qadg, params, qparams, loss_fn


CFG = QASSOConfig(target_sparsity=0.5, bit_lower=4, bit_upper=16,
                  warmup_steps=4, projection_periods=3, projection_steps=4,
                  bit_reduction=2, pruning_periods=3, pruning_steps=5,
                  cooldown_steps=6, base_optimizer="adam", lr_quant=1e-3)


def test_projection_stage_bits_track_schedule():
    cfg = dataclasses.replace(CFG, cooldown_steps=0, pruning_periods=0)
    trace = []
    qadg, params, qparams, loss_fn = _tiny_problem(0)
    qasso = QASSO(qadg.space, qadg.sites, cfg,
                  lambda s: torch.tensor(5e-3))
    state = qasso.init(params, qparams)
    for i in range(cfg.projection_end):
        _, gx, gq = _grads(loss_fn, params, qparams)
        params, qparams, state, _ = qasso.update(params, qparams, gx, gq,
                                                 state)
        trace.append({s.name: float(Q.bit_width(qparams[s.name].d,
                                                qparams[s.name].q_m,
                                                qparams[s.name].t))
                      for s in qadg.sites})
    for i in range(cfg.warmup_end, cfg.projection_end):
        period = (i - cfg.warmup_end) // cfg.projection_steps
        b_u_eff = max(cfg.bit_upper - cfg.bit_reduction * (period + 1),
                      cfg.bit_lower)
        for site, b in trace[i].items():
            assert cfg.bit_lower - 1e-3 <= b <= b_u_eff + 1e-3, (i, site, b)


@given(seed=st.integers(0, 50), sparsity=st.sampled_from([0.25, 0.5, 0.75]))
@settings(max_examples=5, deadline=None)
def test_cooldown_hard_zeros_exactly_the_redundant_groups(seed, sparsity):
    cfg = dataclasses.replace(CFG, target_sparsity=sparsity)
    qadg, qasso, params, qparams, state, _, _ = run_qasso(cfg, seed,
                                                          _tiny_problem)
    n_pruned = 0
    for fam in qasso.space.prunable_families():
        keep, red = state.keep_mask[fam.name], state.redundant[fam.name]
        assert torch.equal(keep, 1.0 - red)
        n_pruned += int(torch.sum(keep < 0.5))
    assert abs(n_pruned - sparsity * qasso.total_units) <= 1 + 1e-6
    fam = qasso.space.prunable_families()[0]
    keep = state.keep_mask[fam.name]
    pruned = torch.nonzero(keep < 0.5)[:, 0]
    kept = torch.nonzero(keep >= 0.5)[:, 0]
    assert not params["fc1.w"][:, pruned].any()
    assert not params["fc2.w"][pruned, :].any()
    if len(kept):
        assert bool((params["fc1.w"][:, kept].abs().sum(0) > 0).all())


@given(warm=st.integers(0, 30), pp=st.integers(1, 5), ps=st.integers(1, 20),
       P=st.integers(1, 5), ks=st.integers(1, 20), cd=st.integers(0, 30))
@settings(max_examples=100)
def test_stage_boundaries_partition_the_horizon(warm, pp, ps, P, ks, cd):
    cfg = QASSOConfig(warmup_steps=warm, projection_periods=pp,
                      projection_steps=ps, pruning_periods=P,
                      pruning_steps=ks, cooldown_steps=cd)
    q = QASSO.__new__(QASSO)
    q.cfg = cfg
    edges = [0, cfg.warmup_end, cfg.projection_end, cfg.joint_end,
             cfg.total_steps]
    stages = [q.stage_index(i) for i in range(cfg.total_steps)]
    for s in range(4):
        assert all(x == s for x in stages[edges[s]:edges[s + 1]])


@given(n=st.integers(4, 64), seed=st.integers(0, 10_000),
       alpha=st.floats(1e-4, 1e-1), kp=st.integers(1, 50),
       k=st.integers(0, 49))
@settings(max_examples=60, deadline=None)
def test_descent_direction_property(n, seed, alpha, kp, k):
    """Prop 5.1 for the Eq 16/17 rules on the port's clip and residual."""
    k = min(k, kp - 1)
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((n,), generator=gen) * 1.5
    g = torch.randn((n,), generator=gen) + 1e-4
    qm, t = f32(1.0), f32(1.0)
    d0 = Q.step_size_for_bits(qm, t, f32(8.0))
    eta, xi = 0.9, 0.999
    sign = torch.sign(w)
    clipv = (sign * Q.clip_qmt(w.abs(), qm, t)).double().numpy()
    resv = (sign * Q.residual(w.abs(), d0, qm, t)).double().numpy()
    g64 = g.double().numpy()
    n_g, n_clip = np.linalg.norm(g64), np.linalg.norm(clipv)
    cos_g = float(g64 @ clipv) / max(n_g * n_clip, 1e-12)
    if np.mean(np.abs(clipv)) <= 1e-8:
        return
    gamma = (1.0 / (kp - k) if cos_g >= 0
             else -(1 - eta) * alpha * n_g / (cos_g * max(n_clip, 1e-12)))
    n_res = np.linalg.norm(resv)
    cos_d = float(g64 @ resv) / max(n_g * max(n_res, 1e-12), 1e-12)
    if cos_d >= 0:
        s_clip = -alpha * g64 - gamma * clipv
        slack = 1e-6 * (alpha * n_g ** 2 + abs(gamma) * n_g * n_clip)
        assert float(g64 @ s_clip) < -eta * alpha * n_g ** 2 + slack
    else:
        d = -(xi * eta * alpha * n_g) / (gamma * cos_d * max(n_res, 1e-12))
        s_dir = -alpha * g64 - gamma * (clipv + d * resv)
        slack = 1e-6 * (alpha * n_g ** 2
                        + abs(gamma) * n_g * max(n_clip, d * n_res))
        assert float(g64 @ s_dir) < slack

"""QASSO: Quantization-Aware Structured Sparse Optimizer (paper §5, Alg 2-4).

Port of `repro.core.qasso`. Solves

    min f(x, d, q_m, t)
    s.t. Card{g in G : [x]_g = 0} = K          (Eq 7b)
         b_i in [b_l, b_u]  for i in L          (Eq 7c)

through four stages driven by the step counter: warm-up (base optimizer
on everything), projection (PPSG, Alg 3: SGD on (d, q_m, t), then d
projected into the progressively shrinking [b_l, b_u - p*b_r]), joint
(saliency partition G_I / G_R per period; G_R forgets its quantized value
at the Eq 16 rate with the Eq 17 step size, kept feasible by the Alg 4
rescaling) and cool-down (G_R hard-zeroed, quantizers frozen).

The control flow runs on the host: the stage is read from the step
counter (a Python int) once per step, the period-boundary recompute is an
`if`, and the Alg 4 loop is a host loop over 0-d f32 tensors. The seven
Eq 15-17 reductions of a site run block by block over the stacked
(L, ...) tensors in a fixed order and reach the host once per site; the
scalar rules then run on the CPU in f32, as the JAX package runs them on
its device. No reduction uses atomics, so a step on the card is bitwise
reproducible. Element masks stay broadcastable (shaped like a member
axis) instead of being expanded to each parameter's full shape.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import quant as Q
from repro_torch.core.groups import (GroupFamily, Member, PruningSpace,
                                     axis_mask, broadcast_to_axis)
from repro_torch.core.qadg import QuantSite
from repro_torch.core.saliency import (SaliencyConfig,
                                       global_redundancy_partition)
from repro_torch.optim.base import Optimizer, clip_by_global_norm, \
    get_optimizer

_EPS = 1e-12
F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


def _on_host(t: torch.Tensor) -> torch.Tensor:
    """t on the CPU, where the scalar rules run. A meta tensor (the dry
    run, `launch.dryrun`) holds no values: ones stand in for it, so the
    rules run on placeholders and the stage takes its common branch (no
    site in case 0); the device work around them is the same."""
    if t.device.type == "meta":
        return torch.ones(t.shape, dtype=t.dtype)
    return t.cpu()


@dataclasses.dataclass(frozen=True)
class QASSOConfig:
    # Eq 7b / 7c targets
    target_sparsity: float = 0.5          # K, fraction of prunable units
    bit_lower: float = 4.0                # b_l
    bit_upper: float = 16.0               # b_u (initial, before reduction)
    # Alg 2 schedule
    warmup_steps: int = 100               # K_w
    projection_periods: int = 5           # B
    projection_steps: int = 50            # K_b
    bit_reduction: float = 2.0            # b_r
    pruning_periods: int = 5              # P
    pruning_steps: int = 50               # K_p
    cooldown_steps: int = 200
    # Eq 16/17 + Alg 4 constants (paper Appendix B)
    eta: float = 0.9
    xi: float = 0.999
    eps: float = 1e-8
    beta: float = 0.5
    # lrs
    lr_quant: float = 1e-4                # constant for (d, q_m, t)
    base_optimizer: str = "adamw"
    grad_clip: float = 0.0
    saliency: SaliencyConfig = dataclasses.field(
        default_factory=SaliencyConfig)

    @property
    def warmup_end(self) -> int:
        return self.warmup_steps

    @property
    def projection_end(self) -> int:
        return self.warmup_steps + self.projection_periods * self.projection_steps

    @property
    def joint_end(self) -> int:
        return self.projection_end + self.pruning_periods * self.pruning_steps

    @property
    def total_steps(self) -> int:
        return self.joint_end + self.cooldown_steps

    @property
    def bit_upper_final(self) -> float:
        return max(self.bit_upper - self.bit_reduction * self.projection_periods,
                   self.bit_lower)


class QASSOState(NamedTuple):
    step: int                           # host step counter
    base: Any                           # base optimizer state over x
    redundant: dict[str, torch.Tensor]  # per family: 1.0 = in G_R
    keep_mask: dict[str, torch.Tensor]  # per family: 1.0 = kept (hard)
    gamma: torch.Tensor                 # (num_weight_sites,) forget rates


class QASSO:
    """Usage:

        qasso = QASSO(qadg.space, qadg.sites, cfg, lr_schedule)
        state = qasso.init(params, qparams)
        ...
        params, qparams, state, metrics = qasso.update(
            params, qparams, gx, gq, state)

    `update` returns new params and qparams and advances the base
    optimizer's moments in `state` in place (see `optim.base`)."""

    def __init__(self, space: PruningSpace, sites: list[QuantSite],
                 cfg: QASSOConfig,
                 lr_schedule: Callable[[int], torch.Tensor]):
        self.space = space
        self.sites = list(sites)
        self.weight_sites = [s for s in sites if s.kind == "weight"]
        self.act_sites = [s for s in sites if s.kind == "act"]
        self.cfg = cfg
        self.lr_schedule = lr_schedule
        self.base: Optimizer = get_optimizer(cfg.base_optimizer)
        # param -> [(family, member)] covering map (prunable families only)
        self.covering: dict[str, list[tuple[GroupFamily, Member]]] = {}
        for fam in space.prunable_families():
            for m in fam.members:
                self.covering.setdefault(m.param, []).append((fam, m))
        self.total_units = space.total_units()
        self.k_units = int(round(cfg.target_sparsity * self.total_units))
        self.site_of_param = {p: s.name for s in self.weight_sites
                              for p in s.quantized_params}

    # ------------------------------------------------------------------ init
    def init(self, params: dict, qparams: dict) -> QASSOState:
        del qparams
        dev = next(iter(params.values())).device
        fams = self.space.prunable_families()
        return QASSOState(
            step=0,
            base=self.base.init(params),
            redundant={f.name: torch.zeros((f.units,), dtype=F32, device=dev)
                       for f in fams},
            keep_mask={f.name: torch.ones((f.units,), dtype=F32, device=dev)
                       for f in fams},
            gamma=torch.zeros((max(len(self.weight_sites), 1),), dtype=F32))

    # ------------------------------------------------------- mask utilities
    def _elem_mask(self, pname: str, unit_masks: dict, arr: torch.Tensor
                   ) -> torch.Tensor:
        """Elementwise mask for `pname`, broadcastable to its shape: the
        max over covering families (an element is flagged if ANY covering
        unit is flagged), 0 where no prunable family covers it."""
        m = None
        for fam, mem in self.covering.get(pname, []):
            am = axis_mask(unit_masks[fam.name], mem, arr.shape[mem.axis])
            bm = broadcast_to_axis(am, arr.ndim, mem.axis)
            m = bm if m is None else torch.maximum(m, bm)
        if m is None:
            return torch.zeros((), dtype=F32, device=arr.device)
        return m.to(F32)

    def _mask_tree(self, params: dict, unit_masks: dict) -> dict:
        return {p: self._elem_mask(p, unit_masks, arr)
                for p, arr in params.items()}

    def _keep_elem_tree(self, params: dict, keep_units: dict) -> dict:
        """Elementwise keep: an element survives iff ALL covering units are
        kept, i.e. 1 - (any covering unit pruned)."""
        pruned = self._mask_tree(params, {k: 1.0 - v
                                          for k, v in keep_units.items()})
        return {p: 1.0 - m for p, m in pruned.items()}

    # ---------------------------------------------------------- stage bodies
    def _quant_sgd(self, qparams: dict, grads_q: dict) -> dict:
        """Plain SGD with the constant quant lr, positivity-guarded."""
        lr = self.cfg.lr_quant
        out = {}
        for name, qp in qparams.items():
            gq = grads_q[name]
            out[name] = Q.positivity_guard(Q.QuantParams(
                d=qp.d - lr * gq.d, q_m=qp.q_m - lr * gq.q_m,
                t=qp.t - lr * gq.t))
        return out

    def _project_all(self, qparams: dict, b_u_eff) -> dict:
        return {name: Q.project_step_size(qp, self.cfg.bit_lower, b_u_eff)
                for name, qp in qparams.items()}

    @staticmethod
    def _site_stats_chunked(w, g, r, d0, qm, t) -> torch.Tensor:
        """The seven masked reductions of Eqs 15-17 for one weight tensor,
        block by block along the leading (layer) axis of a stacked tensor,
        so temporaries span one layer; summed in layer order."""

        def stats_of(ws, gs, rs):
            ws = ws.to(F32)
            gs = gs.to(F32)
            rs = torch.broadcast_to(rs, ws.shape)
            sign = torch.sign(ws)
            clipv = sign * Q.clip_qmt(ws.abs(), qm, t)
            resv = sign * Q.residual(ws.abs(), d0, qm, t)
            return torch.stack([
                torch.sum(rs * gs * clipv),
                torch.sum(rs * gs * resv),
                torch.sum(rs * torch.square(gs)),
                torch.sum(rs * torch.square(clipv)),
                torch.sum(rs * torch.square(resv)),
                torch.sum(rs * torch.abs(clipv)),
                torch.sum(rs),
            ])

        if w.ndim < 3 or w.shape[0] == 1:
            return stats_of(w, g, r)
        r = torch.broadcast_to(r, w.shape)
        acc = torch.zeros((7,), dtype=F32, device=w.device)
        for i in range(w.shape[0]):
            acc = acc + stats_of(w[i], g[i], r[i])
        return acc

    def _joint_site(self, site: QuantSite, params, grads, qp, red_elem,
                    alpha: torch.Tensor, k_in_period: torch.Tensor):
        """Eq 16 gamma, Eq 17 d and the Alg 4 rescale for one weight site;
        every scalar on the host in f32. Returns (gamma, d_new, case0) as
        0-d CPU tensors."""
        cfg = self.cfg
        d0, qm, t = qp.d, qp.q_m, qp.t
        stats = torch.zeros((7,), dtype=F32, device=d0.device)
        for pname in site.quantized_params:
            stats = stats + self._site_stats_chunked(
                params[pname], grads[pname], red_elem[pname], d0, qm, t)
        (dot_clip, dot_res, n_g2, n_clip2, n_res2, clip_sum,
         cnt) = _on_host(stats).unbind()
        d0, qm, t = _on_host(d0), _on_host(qm), _on_host(t)

        n_g = torch.sqrt(n_g2)
        n_clip = torch.sqrt(n_clip2)
        n_res = torch.sqrt(n_res2)
        clip_mean = clip_sum / torch.clamp_min(cnt, 1.0)
        cos_g = dot_clip / torch.clamp_min(n_g * n_clip, _EPS)
        cos_d = dot_res / torch.clamp_min(n_g * n_res, _EPS)
        has_red = cnt > 0.5
        case0 = has_red & (clip_mean <= cfg.eps)

        # Eq 16
        k_left = torch.clamp_min(cfg.pruning_steps - k_in_period, 1.0)
        gamma_uniform = 1.0 / k_left
        gamma_neg = -(1.0 - cfg.eta) * alpha * n_g / (
            cos_g * torch.clamp_min(n_clip, _EPS))
        gamma = torch.where(case0, 0.0,
                            torch.where(cos_g >= 0, gamma_uniform, gamma_neg))
        gamma = torch.where(has_red, gamma, 0.0)

        # Eq 17
        d_low = Q.step_size_for_bits(qm, t, _f32(cfg.bit_lower))
        d_neg = -(cfg.xi * cfg.eta * alpha * n_g) / (
            torch.clamp_min(gamma, _EPS) * cos_d
            * torch.clamp_min(n_res, _EPS))
        d_new = torch.where(cos_d >= 0, d_low, d_neg)
        d_new = torch.where(has_red & (gamma > 0), d_new, d0)

        # Alg 4: rescale (gamma, d) until b in [b_l, b_u_final]
        b_l, b_u = _f32(cfg.bit_lower), _f32(cfg.bit_upper_final)
        d_new = torch.clamp_min(d_new, 1e-8)
        for _ in range(200):
            b = Q.bit_width(d_new, qm, t)
            if not bool((b > b_u + 1e-6) | (b < b_l - 1e-6)):
                break
            too_high = b > b_u           # too many bits -> d too small
            gamma = torch.where(too_high, cfg.beta * gamma, gamma)
            d_new = torch.where(too_high, d_new / cfg.beta,
                                cfg.beta * d_new)
        return gamma, d_new, case0

    # ------------------------------------------------------------- stages
    def _stage_warmup(self, params, qparams, gx, gq, state, lr, delta):
        new_params = {p: params[p] + delta[p] for p in params}
        return (new_params, self._quant_sgd(qparams, gq), state.redundant,
                state.keep_mask, state.gamma)

    def _stage_projection(self, params, qparams, gx, gq, state, lr, delta):
        cfg = self.cfg
        new_params = {p: params[p] + delta[p] for p in params}
        new_q = self._quant_sgd(qparams, gq)             # Alg 3 line 2
        # progressive range: period p lowers the upper bound by p*b_r
        period = (state.step - cfg.warmup_end) // max(cfg.projection_steps, 1)
        b_u_eff = torch.clamp_min(
            _f32(cfg.bit_upper) - cfg.bit_reduction * (_f32(period) + 1.0),
            cfg.bit_lower)
        new_q = self._project_all(new_q, b_u_eff)         # Alg 3 lines 3-4
        return new_params, new_q, state.redundant, state.keep_mask, \
            state.gamma

    def _stage_joint(self, params, qparams, gx, gq, state, lr, delta):
        cfg = self.cfg
        steps = max(cfg.pruning_steps, 1)
        into = state.step - cfg.projection_end
        k_in_period = _f32(float(into % steps))
        period = into // steps

        # Alg 2 lines 11-12: recompute the partition at a period's start,
        # progressive target round(K * (p+1)/P), sticky across periods
        redundant = state.redundant
        if into % steps == 0:
            n_red = int(torch.round(
                _f32(self.k_units) * (_f32(period) + 1.0)
                / max(cfg.pruning_periods, 1)))
            redundant = global_redundancy_partition(
                self.space, params, gx, n_red, cfg.saliency,
                pinned=state.redundant)

        red_elem = self._mask_tree(params, redundant)
        alpha = lr

        # line 14: (t, q_m) one SGD step (d by Eq 17 below)
        q_sgd = self._quant_sgd(qparams, gq)
        new_q, gammas, site_gamma = {}, [], {}
        for site in self.weight_sites:
            qp_s = Q.QuantParams(d=qparams[site.name].d,
                                 q_m=q_sgd[site.name].q_m,
                                 t=q_sgd[site.name].t)
            gamma, d_new, case0 = self._joint_site(
                site, params, gx, qp_s, red_elem, alpha, k_in_period)
            new_q[site.name] = Q.positivity_guard(Q.QuantParams(
                d=d_new.to(qp_s.d.device), q_m=qp_s.q_m, t=qp_s.t))
            gammas.append(gamma)
            for pname in site.quantized_params:
                site_gamma[pname] = (gamma, bool(case0))
        # act sites: SGD + kept feasible (PPSG on the final range)
        for site in self.act_sites:
            new_q[site.name] = Q.project_step_size(
                q_sgd[site.name], cfg.bit_lower, cfg.bit_upper_final)
        for name in qparams:
            if name not in new_q:
                new_q[name] = q_sgd[name]

        # Eq 8 / Eq 9
        k_left = torch.clamp_min(cfg.pruning_steps - k_in_period, 1.0)
        gamma_plain = 1.0 / k_left
        new_params = {}
        for pname, w in params.items():
            r = red_elem[pname]
            if pname in site_gamma:
                gamma, case0 = site_gamma[pname]
                # x_Q with the *new* step size (Alg 2 line 18)
                qp_n = new_q[self.site_of_param[pname]]
                xq = Q.fake_quant(w, qp_n.d, qp_n.q_m, qp_n.t).to(F32)
                upd = w + delta[pname] - (r * (gamma * xq)).to(w.dtype)
                if case0:
                    upd = torch.where(r > 0.5, 0.0, upd)
            else:
                # non-quantized param: forget the raw value (x_Q := x)
                upd = w + delta[pname] - (r * gamma_plain * w).to(w.dtype)
            new_params[pname] = upd

        # joint end: hard-zero G_R, freeze the keep mask (entering cool-down)
        keep_mask = state.keep_mask
        if state.step == cfg.joint_end - 1:
            keep_mask = {k: 1.0 - redundant[k] for k in keep_mask}
            elem_keep = self._keep_elem_tree(new_params, keep_mask)
            new_params = {p: a * elem_keep[p].to(a.dtype)
                          for p, a in new_params.items()}
        gamma_vec = (torch.stack(gammas) if gammas
                     else torch.zeros((1,), dtype=F32))
        return new_params, new_q, redundant, keep_mask, gamma_vec

    def _stage_cooldown(self, params, qparams, gx, gq, state, lr, delta):
        # line 22: fixed (d*, q_m*, t*); only G_I trains; G_R pinned at 0
        keep_elem = self._keep_elem_tree(params, state.keep_mask)
        new_params = {p: (params[p] + delta[p]) * keep_elem[p].to(
            params[p].dtype) for p in params}
        return new_params, qparams, state.redundant, state.keep_mask, \
            state.gamma

    # -------------------------------------------------------------- update
    def stage_index(self, step: int) -> int:
        cfg = self.cfg
        return (int(step >= cfg.warmup_end) + int(step >= cfg.projection_end)
                + int(step >= cfg.joint_end))

    @torch.no_grad()
    def update(self, params: dict, qparams: dict, gx: dict, gq: dict,
               state: QASSOState):
        cfg = self.cfg
        lr = self.lr_schedule(state.step)
        if cfg.grad_clip > 0:
            gx, _ = clip_by_global_norm(gx, cfg.grad_clip)

        # during cool-down, pruned units must not pollute base-opt moments
        keep_elem = self._keep_elem_tree(params, state.keep_mask)
        gx_eff = {p: gx[p] * keep_elem[p].to(gx[p].dtype) for p in gx}
        delta, base2 = self.base.update(gx_eff, state.base, params, lr)
        del gx_eff

        stage = self.stage_index(state.step)
        body = (self._stage_warmup, self._stage_projection,
                self._stage_joint, self._stage_cooldown)[stage]
        new_params, new_q, redundant, keep_mask, gamma = body(
            params, qparams, gx, gq, state, lr, delta)
        new_state = QASSOState(step=state.step + 1, base=base2,
                               redundant=redundant, keep_mask=keep_mask,
                               gamma=gamma)
        metrics = {"stage": stage, "lr": lr,
                   "sparsity_hard": self.space.sparsity(keep_mask),
                   "sparsity_partition": self.space.sparsity(
                       {k: 1.0 - v for k, v in redundant.items()}),
                   "gamma_mean": torch.mean(gamma)}
        if self.sites:
            bits = torch.stack([Q.bit_width(new_q[s.name].d,
                                            new_q[s.name].q_m,
                                            new_q[s.name].t)
                                for s in self.sites])
            metrics.update(bits_mean=torch.mean(bits),
                           bits_min=torch.min(bits), bits_max=torch.max(bits))
        return new_params, new_q, new_state, metrics

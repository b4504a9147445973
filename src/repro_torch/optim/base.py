"""Optimizers over dicts of tensors, port of `repro.optim.base`.

    opt = adam(b1=0.9, b2=0.999)
    state = opt.init(params)
    delta, state = opt.update(grads, state, params, lr)
    params = {k: params[k] + delta[k] for k in params}

`delta` already includes the -lr factor, so QASSO composes its forget
term onto it. Moments live in f32 for bf16 params. Unlike the JAX
package's pure functions, `update` advances the moment tensors of `state`
IN PLACE (at full width they are 15 GB; a second copy would not fit beside
the step), one parameter at a time, with the JAX package's operation
order. `lr` is a 0-d f32 tensor (see `optim.schedules`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

F32 = torch.float32


def tree_zeros_f32(a: dict) -> dict:
    """f32 optimizer-state zeros whatever the (possibly bf16) param dtype."""
    return {k: torch.zeros(v.shape, dtype=F32, device=v.device)
            for k, v in a.items()}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict, torch.Tensor], tuple[dict, Any]]
    name: str = "opt"


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return {k: (-lr * g.to(F32)).to(params[k].dtype)
                for k, g in grads.items()}, state

    return Optimizer(init, update, "sgd")


def momentum(mu: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_zeros_f32(params)

    def update(grads, state, params, lr):
        delta = {}
        for k, g in grads.items():
            g32 = g.to(F32)
            m = state[k].mul_(mu).add_(g32)
            step_dir = g32 + mu * m if nesterov else m
            delta[k] = (-lr * step_dir).to(params[k].dtype)
        return delta, state

    return Optimizer(init, update, "momentum")


class AdamState(NamedTuple):
    count: int
    m: dict
    v: dict


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = True) -> Optimizer:
    """Adam / AdamW (decoupled=True gives AdamW)."""

    def init(params):
        return AdamState(0, tree_zeros_f32(params), tree_zeros_f32(params))

    def update(grads, state, params, lr):
        count = state.count + 1
        cnt = torch.tensor(float(count), dtype=F32)
        c1 = 1 - b1 ** cnt
        c2 = 1 - b2 ** cnt
        delta = {}
        for k, g in grads.items():
            p = params[k]
            g32 = g.to(F32)
            if weight_decay and not decoupled:
                g32 = g32 + weight_decay * p.to(F32)
            m = state.m[k].mul_(b1).add_((1 - b1) * g32)
            v = state.v[k].mul_(b2).add_((1 - b2) * torch.square(g32))
            d = -lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and decoupled:
                d = d - lr * weight_decay * p.to(F32)
            delta[k] = d.to(p.dtype)
        return delta, AdamState(count, state.m, state.v)

    return Optimizer(init, update, "adamw" if weight_decay else "adam")


def adamw(lr_unused=None, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.01) -> Optimizer:
    return adam(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                decoupled=True)


def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Scale grads to global norm <= max_norm (leaves summed in sorted-key
    order, the JAX package's tree order). Returns f32 grads, as its
    bf16-times-f32 product promotes."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k].to(F32)))
                           for k in sorted(grads)))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return {k: g.to(F32) * scale for k, g in grads.items()}, gnorm


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)

"""Learning-rate schedules (step -> lr) of `repro.optim.schedules`.

Each returns the lr as a 0-d f32 tensor on the CPU, computed in f32 as the
JAX package computes it; the optimizers use it as a scalar operand of
device ops (no host-device copy).
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


def constant(lr: float):
    return lambda step: _f32(lr)


def step_lr(lr: float, step_size: int, gamma: float = 0.1):
    """StepLR of the paper's CNN experiments (Appendix C)."""
    def sched(step):
        k = _f32(float(int(step) // step_size))
        return _f32(lr) * torch.pow(_f32(gamma), k)
    return sched


def cosine(lr: float, total_steps: int, warmup: int = 0,
           min_ratio: float = 0.1):
    def sched(step):
        step = _f32(float(step))
        warm = torch.clamp_max(step / max(warmup, 1), 1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * prog))
        return _f32(lr) * torch.where(step < warmup, warm, cos)
    return sched

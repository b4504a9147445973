"""Fault tolerance and straggler mitigation (host-side control plane), the
port's own copy of `repro.distributed.fault`.

- heartbeat registry: every host posts a monotonic (step, wall-time) beat;
  the monitor flags hosts silent for > `heartbeat_timeout`.
- restart policy: on failure, restore the latest complete checkpoint (its
  manifest is renamed into place only once the write is durable) and
  resume; the data pipeline is seeded by step, so replay is exact.
- straggler mitigation: per-step deadline = median(step_time) *
  `straggler_factor`; a host breaching it `patience` times in a row is
  flagged for replacement (here: recorded).

`FaultTolerantLoop.run` keeps the state it starts from and restarts from
it when a failure comes before any checkpoint. The port's train state
advances in place (QASSO's and AdamW's moments), so a caller whose step
mutates its input must hand `run` a state that the first step does not
touch (`launch.train.run_steps` steps from a copy of the moments).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional


@dataclasses.dataclass
class FaultConfig:
    heartbeat_timeout: float = 60.0
    straggler_factor: float = 2.0
    straggler_patience: int = 3
    checkpoint_every: int = 50
    max_restarts: int = 10


class DeviceLoss(RuntimeError):
    """A device dropped out mid-step (host or interconnect failure)."""


# Runtimes surface device and fabric failures as generic RuntimeErrors;
# these substrings are the stable markers across backends (TPU DATA_LOSS,
# GPU NCCL aborts, device removal).
_DEVICE_LOSS_MARKERS = ("data_loss", "device lost", "device failure",
                        "nccl", "interconnect", "socket closed")


def is_device_loss(exc: BaseException) -> bool:
    """Classify an exception as a device loss (restorable: the surviving
    hosts restart from the latest checkpoint) vs a program bug (which
    also restores, but is worth telling apart in telemetry)."""
    if isinstance(exc, DeviceLoss):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


class HeartbeatRegistry:
    def __init__(self, hosts: list[str], timeout: float):
        self.timeout = timeout
        self.last: dict[str, float] = {h: time.monotonic() for h in hosts}

    def beat(self, host: str, now: Optional[float] = None):
        self.last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last.items() if now - t > self.timeout]


class StragglerMonitor:
    def __init__(self, factor: float, patience: int, window: int = 32):
        self.factor = factor
        self.patience = patience
        self.times: deque[float] = deque(maxlen=window)
        self.strikes: dict[str, int] = {}
        self.flagged: list[str] = []

    def deadline(self) -> float:
        if not self.times:
            return float("inf")
        s = sorted(self.times)
        return s[len(s) // 2] * self.factor

    def record(self, host: str, step_time: float):
        dl = self.deadline()
        self.times.append(step_time)
        if step_time > dl:
            self.strikes[host] = self.strikes.get(host, 0) + 1
            if self.strikes[host] >= self.patience and host not in self.flagged:
                self.flagged.append(host)
        else:
            self.strikes[host] = 0


@dataclasses.dataclass
class RunResult:
    final_step: int
    restarts: int
    stragglers_flagged: list[str]
    device_losses: int = 0


class FaultTolerantLoop:
    """Checkpoint/restart driver around a step function.

    step_fn(state, step) -> state; may raise (injected or real failure).
    save_fn(state, step) / restore_fn() -> (state, step) or None handle
    durability.
    """

    def __init__(self, cfg: FaultConfig, step_fn: Callable,
                 save_fn: Callable, restore_fn: Callable,
                 host: str = "host0"):
        self.cfg = cfg
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.host = host
        self.monitor = StragglerMonitor(cfg.straggler_factor,
                                        cfg.straggler_patience)
        self.heartbeats = HeartbeatRegistry([host], cfg.heartbeat_timeout)

    def run(self, state, total_steps: int) -> tuple[object, RunResult]:
        initial_state = state
        step = 0
        restarts = 0
        device_losses = 0
        while step < total_steps:
            try:
                t0 = time.monotonic()
                state = self.step_fn(state, step)
                self.monitor.record(self.host, time.monotonic() - t0)
                self.heartbeats.beat(self.host)
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.save_fn(state, step)
            except Exception as e:
                # a device loss is the expected fleet event: restore from
                # the latest complete checkpoint instead of crashing
                if is_device_loss(e):
                    device_losses += 1
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                restored = self.restore_fn()
                if restored is None:
                    # no checkpoint yet: restart from the initial state,
                    # not the half-trained one (a stale state at step 0
                    # desyncs everything keyed on the step counter: the
                    # QASSO stage schedule, the data stream, the
                    # checkpointed data key)
                    state = initial_state
                    step = 0
                    continue
                state, step = restored
        return state, RunResult(step, restarts, self.monitor.flagged,
                                device_losses)

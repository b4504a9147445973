"""The port's fault-tolerance control plane (`repro_torch.distributed.
fault`) against the JAX package's (`tests/test_fault_tolerance.py`,
`tests/test_checkpoint_resume.py`): deterministic replay of the data
stream (also through the checkpointed key), recover-and-replay, the
restart limit, stragglers, heartbeats, device losses, and the real train
loop surviving an injected failure. The port's loop and the reference's
run the same step functions to the same result, restart for restart, and
classify the same exceptions as device losses.
"""
import numpy as np
import pytest
import torch

from repro.distributed import fault as JF
from repro_torch.distributed import fault as TF
from repro_torch.data.synthetic import image_batch, lm_batch, step_key
from repro_torch.distributed.fault import (DeviceLoss, FaultConfig,
                                           FaultTolerantLoop,
                                           HeartbeatRegistry, RunResult,
                                           StragglerMonitor, is_device_loss)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops: one intra-op thread, so parallel suite workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def test_data_pipeline_deterministic_replay():
    """batch(seed, step) is a pure function: exact replay after restart;
    the checkpointed key draws the stateless form's batch."""
    b1 = lm_batch(0, 17, 4, 32, 1000)
    assert torch.equal(b1["tokens"], lm_batch(0, 17, 4, 32, 1000)["tokens"])
    assert not torch.equal(b1["tokens"], lm_batch(0, 18, 4, 32, 1000)["tokens"])
    key = step_key(0, 17)
    assert key.dtype == torch.int64 and key.ndim == 0
    assert torch.equal(b1["tokens"],
                       lm_batch(5, 99, 4, 32, 1000, key=key)["tokens"])
    i1, i2 = image_batch(0, 5, 4), image_batch(0, 5, 4)
    assert torch.equal(i1["images"], i2["images"])
    assert torch.equal(i1["labels"], i2["labels"])


class _Clock:
    """A monotonic clock that moves only when a step says so."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now


def _loop_run(fault_mod, fail_at, exc, steps=10, every=3, monkeypatch=None):
    """One loop of `fault_mod` (the port's or the reference's) over a
    step function that adds each step's batch sum, failing once at each
    step of `fail_at` with `exc`; returns (final, result, steps run).
    With `monkeypatch`, the loop reads a clock on which steps 0-5 take 1 s
    and later steps 5 s, so its straggler monitor sees the same times on
    every run."""
    fail_at = list(fail_at)
    trace = []
    clock = _Clock()
    if monkeypatch is not None:
        monkeypatch.setattr(fault_mod, "time", clock)

    def step_fn(state, i):
        if fail_at and i == fail_at[0]:
            fail_at.pop(0)
            raise exc
        trace.append(i)
        clock.now += 1.0 if i <= 5 else 5.0
        return state + float(lm_batch(0, i, 2, 8, 100)["tokens"].sum())

    store = {}
    loop = fault_mod.FaultTolerantLoop(
        fault_mod.FaultConfig(checkpoint_every=every), step_fn,
        lambda s, i: store.__setitem__("ckpt", (s, i)),
        lambda: store.get("ckpt"))
    final, result = loop.run(0.0, steps)
    return final, result, trace


def test_fault_loop_recovers_and_replays():
    """Injected failure -> restore from checkpoint -> identical final state
    to an uninterrupted run (determinism through restarts)."""
    clean, r0, _ = _loop_run(TF, [], None)
    faulty, r1, trace = _loop_run(TF, [7], RuntimeError("injected failure"))
    assert r0.restarts == 0 and r1.restarts == 1
    assert clean == faulty
    assert trace == [0, 1, 2, 3, 4, 5, 6, 6, 7, 8, 9]


@pytest.mark.parametrize("fail_at,exc", [
    ([], None), ([7], RuntimeError("injected failure")),
    ([1], RuntimeError("before any checkpoint")),
    ([4, 4, 8], DeviceLoss("DATA_LOSS: device 2 dropped out of mesh")),
    ([2, 5], RuntimeError("NCCL communicator aborted"))],
    ids=["clean", "after_ckpt", "before_ckpt", "device_loss", "nccl"])
def test_fault_loop_matches_the_reference_loop(fail_at, exc, monkeypatch):
    """Both loops, the same step function, failures and step times: the
    same final state, steps run, restarts, device losses and flagged
    stragglers (the steps after 5 take 5x as long: the host is flagged
    after three of them)."""
    want = _loop_run(JF, fail_at, exc if not isinstance(exc, DeviceLoss)
                     else JF.DeviceLoss(str(exc)), monkeypatch=monkeypatch)
    got = _loop_run(TF, fail_at, exc, monkeypatch=monkeypatch)
    assert got[1].stragglers_flagged == ["host0"]
    assert got[0] == want[0] and got[2] == want[2]
    assert (got[1].final_step, got[1].restarts, got[1].device_losses,
            got[1].stragglers_flagged) == (
        want[1].final_step, want[1].restarts, want[1].device_losses,
        want[1].stragglers_flagged)
    assert isinstance(got[1], RunResult)


def test_fault_loop_gives_up_after_max_restarts():
    def step_fn(state, i):
        raise RuntimeError("permafail")

    loop = FaultTolerantLoop(FaultConfig(max_restarts=2), step_fn,
                             lambda s, i: None, lambda: None)
    with pytest.raises(RuntimeError):
        loop.run(0, 5)


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(factor=2.0, patience=2)
    for _ in range(10):
        mon.record("fast", 0.1)
    mon.record("slow", 1.0)
    mon.record("slow", 1.0)
    assert "slow" in mon.flagged
    assert "fast" not in mon.flagged


def test_heartbeat_timeout():
    reg = HeartbeatRegistry(["a", "b"], timeout=10.0)
    reg.beat("a", now=100.0)
    reg.beat("b", now=100.0)
    assert reg.dead_hosts(now=105.0) == []
    reg.beat("a", now=120.0)
    assert reg.dead_hosts(now=125.0) == ["b"]


def test_device_loss_triggers_restore_not_crash():
    """A simulated device loss mid-step restores from the checkpoint and
    replays to the same final state as an uninterrupted run."""

    def make_run(fail_at):
        def step_fn(state, i):
            if fail_at is not None and i == fail_at[0]:
                fail_at[0] = None
                raise DeviceLoss("DATA_LOSS: device 2 dropped out of mesh")
            return state + float(i) * 0.5

        store = {}
        loop = FaultTolerantLoop(
            FaultConfig(checkpoint_every=3), step_fn,
            lambda s, i: store.__setitem__("ckpt", (s, i)),
            lambda: store.get("ckpt"))
        return loop.run(0.0, 10)

    clean, r0 = make_run(None)
    recovered, r1 = make_run([7])
    assert r0.device_losses == 0
    assert r1.device_losses == 1
    assert r1.restarts == 1
    assert clean == pytest.approx(recovered)


MESSAGES = ["DATA_LOSS: while running replica", "NCCL communicator aborted",
            "device lost", "Device Failure on chip 3", "interconnect down",
            "socket closed by peer", "shape mismatch", "nan loss",
            "CUDA error: an illegal memory access was encountered", ""]


@pytest.mark.parametrize("msg", MESSAGES)
def test_is_device_loss_classification(msg):
    """The port's markers are the reference's: the same verdict on every
    message, for RuntimeError and ValueError alike."""
    for cls in (RuntimeError, ValueError):
        assert is_device_loss(cls(msg)) == JF.is_device_loss(cls(msg)), msg
    assert is_device_loss(DeviceLoss(msg))
    assert not is_device_loss(ValueError("shape mismatch"))


def test_fault_loop_counts_generic_failures_separately():
    """A plain bug still restarts, but is not recorded as a device loss."""
    fail = [2]

    def step_fn(state, i):
        if fail and i == fail[0]:
            fail.pop()
            raise RuntimeError("injected software bug")
        return state + 1

    loop = FaultTolerantLoop(FaultConfig(checkpoint_every=100), step_fn,
                             lambda s, i: None, lambda: None)
    state, result = loop.run(0, 5)
    assert result.restarts == 1
    assert result.device_losses == 0


@pytest.mark.slow
def test_train_loop_end_to_end_with_failure(tmp_path):
    """The real GETA train loop survives an injected node failure."""
    from repro_torch.launch.train import train_loop
    report = {}
    state, qadg, qasso, losses = train_loop(
        "internlm2-1.8b", smoke=True, steps=24, batch=2, seq=16,
        ckpt_dir=str(tmp_path), inject_failure_at=13, verbose=False,
        device="cpu", report=report)
    assert len(losses) >= 24
    assert np.isfinite(losses[-1])
    assert report["run_result"].restarts == 1
    assert len(report["restore_s"]) == 1

"""Step-scheduling policies of the serving engine: port of
`repro.launch.scheduler`.

`Engine.step()` asks its policy for an ordered tuple of actions over the
vocabulary "admit", "handoff", "prefill_chunk", "decode" and runs them.

- `OneShotScheduler`: admit with one-shot full-prompt prefills, then one
  batched decode (or speculative round). The default.
- `ChunkedPrefillScheduler(chunk)`: the prompt is prefilled `chunk` rows
  at a time into a staging row cache (a `PrefillJob`), one chunk per
  step, interleaved with the decode of the active slots; a finished job
  hands its rows off to a free slot through the engine's handoff queue.
  A long prompt then delays decode by one chunk, not one prompt.

A length-S prompt splits into S // C full chunks and a descending
power-of-two decomposition of the remainder, never padded (the rows past
the written prefix stay zero), so every chunk length lies in
`chunk_buckets(C)` = {C} and the powers of two below it, the set the
engine's `warmup()` runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def chunk_plan(s: int, chunk: int) -> list[int]:
    """Chunk lengths for a length-`s` prompt at chunk size `chunk`: full
    chunks first, then the remainder as descending powers of two (21 at
    16 -> [16, 4, 1]). Sums to exactly `s`."""
    if s < 1:
        raise ValueError(f"prompt length must be >= 1, got {s}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    out = [chunk] * (s // chunk)
    r = s % chunk
    while r:
        b = 1 << (r.bit_length() - 1)
        out.append(b)
        r -= b
    return out


def reachable_chunk_shapes(max_prompt: int, chunk: int) -> set[int]:
    """Every chunk length `chunk_plan` emits for some prompt length in
    [1, max_prompt], by enumeration: independent of `chunk_buckets`, so
    the two cannot be wrong in the same way."""
    out: set[int] = set()
    for s in range(1, max_prompt + 1):
        out.update(chunk_plan(s, chunk))
    return out


def chunk_buckets(chunk: int) -> list[int]:
    """Every chunk length `chunk_plan` can emit: {chunk} and the powers of
    two below it, sorted."""
    out = {int(chunk)}
    b = 1
    while b < chunk:
        out.add(b)
        b *= 2
    return sorted(out)


@dataclasses.dataclass
class PrefillJob:
    """A prompt mid-prefill: its staging row cache, the chunk lengths still
    to run, the prompt rows written, and the first generated token once
    the last chunk has run. One job is in flight at a time."""
    req: object                        # engine.Request
    caches: dict                       # the staging row cache
    chunks: list[int]                  # remaining chunk lengths
    done_rows: int = 0                 # prompt rows already written
    first: Optional[int] = None        # set when the last chunk lands


@dataclasses.dataclass(frozen=True)
class OneShotScheduler:
    """The classic engine iteration: admit with one-shot full-prompt
    prefills, then one batched decode (or speculative round)."""
    chunk = None    # not a chunked policy

    def plan_step(self, eng) -> tuple[str, ...]:
        return ("admit", "decode")


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillScheduler:
    """Disaggregated prefill and decode: every step runs at most one
    prefill chunk and one decode batch. Finished prefills wait on the
    engine's handoff queue for a free slot; at most max_slots of them are
    staged at once."""
    chunk: int = 16

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")

    def plan_step(self, eng) -> tuple[str, ...]:
        acts = []
        if eng._handoff:
            acts.append("handoff")
        if eng._prefill_job is not None or (
                eng.queue and len(eng._handoff) < eng.max_slots):
            acts.append("prefill_chunk")
        # decode after a handoff in the same step, so a slot admitted by
        # it does not sit out a step (decode does nothing with no slots)
        if eng.n_active or eng._handoff:
            acts.append("decode")
        return tuple(acts)

"""Step-scheduling policy of the serving engine: port of
`repro.launch.scheduler.OneShotScheduler`. The chunked-prefill policy
comes with ROADMAP Queue 1 item 11."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OneShotScheduler:
    """The classic engine iteration: admit with one-shot full-prompt
    prefills, then one batched decode."""
    chunk = None    # not a chunked policy

    def plan_step(self, eng) -> tuple[str, ...]:
        return ("admit", "decode")

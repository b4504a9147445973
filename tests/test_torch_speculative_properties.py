"""Property-based rollback invariants of the port's speculative engine
(hypothesis), the mirror of `tests/test_speculative_properties.py`.

For drawn request mixes (prompt lengths, budgets, slot pressure, draft
length), after every speculative round both KV arenas hold zeros at and
past every active slot's position, pos and last_tok follow the committed
tokens, and the drained tokens equal the port's plain engine's and the
JAX package's plain engine's on the same weights. The draft is garbage
(another init), so nearly every round rejects at some depth. Runs under
the conftest "repro" derandomized profile; `tests/test_torch_speculative.py`
drives the same `run_rollback_case` over fixed mixes.
"""
import pytest

pytest.importorskip("hypothesis")  # see requirements-dev.txt
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from test_torch_speculative import (  # noqa: E402,F401 (a fixture)
    one_torch_thread, run_rollback_case)


@given(st.data())
@settings(max_examples=10, deadline=None)
def test_rollback_restores_never_drafted_state_random(data):
    n = data.draw(st.integers(1, 3), label="n_requests")
    lens = data.draw(st.lists(st.integers(2, 6), min_size=n, max_size=n),
                     label="prompt_lens")
    gens = data.draw(st.lists(st.integers(1, 8), min_size=n, max_size=n),
                     label="gens")
    draft_k = data.draw(st.sampled_from([1, 2, 4, 8]), label="draft_k")
    run_rollback_case(lens, gens, draft_k)

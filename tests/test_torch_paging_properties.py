"""Property-based invariants of the port's page allocator (hypothesis).

For hypothesis-drawn op scripts (alloc / share / release / flush over a
small pool), `tests/test_torch_paged_kv.py::run_allocator_case` asserts
after every op that no page is handed out while an owner holds it, that
every allocated page reads back zero (released pages stay quarantined
until an explicit flush), and that refcount-shared pages survive any one
owner's release with their contents intact; the JAX package's allocator,
driven by the same script, hands out and releases the same pages.
"""
import pytest

pytest.importorskip("hypothesis")  # property-based tests; see requirements-dev.txt
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.launch import paging as JPG  # noqa: E402
from test_torch_paged_kv import run_allocator_case  # noqa: E402


@given(st.data())
@settings(max_examples=50, deadline=None)
def test_allocator_invariants_random_scripts(data):
    n_pages = data.draw(st.integers(4, 16), label="n_pages")
    n_ops = data.draw(st.integers(1, 30), label="n_ops")
    owners = "abcdef"
    script = []
    for _ in range(n_ops):
        kind = data.draw(st.sampled_from(
            ["alloc", "alloc", "share", "release", "flush"]))
        if kind == "alloc":
            script.append(("alloc", data.draw(st.sampled_from(owners)),
                           data.draw(st.integers(1, n_pages))))
        elif kind == "share":
            script.append(("share", data.draw(st.sampled_from(owners)),
                           data.draw(st.sampled_from(owners))))
        elif kind == "release":
            script.append(("release", data.draw(st.sampled_from(owners))))
        else:
            script.append(("flush",))
    got = run_allocator_case(script, n_pages=n_pages, page_size=4)
    assert got == run_allocator_case(script, n_pages=n_pages, page_size=4,
                                     pg=JPG)

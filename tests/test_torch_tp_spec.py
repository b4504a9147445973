"""The port's tensor-parallel engine in its speculative and chunked
modes against the JAX package's (`tests/test_tp_engine.py`'s two mode
tests; the rest of that file is mirrored in `tests/test_torch_tp_engine.py`,
whose helpers this module shares).

tp 2 and tp 4 on CPU ranks over gloo: a speculative engine (draft k 4)
and a chunked-prefill engine (chunk 8) emit the JAX 1-device engine's
tokens on every rank, the speculative one in rounds and the chunked one
decoding while a prompt is mid-prefill.
"""
import pytest

from repro_torch.launch.mesh import RankPool
from test_torch_tp_engine import check_tokens, serve_all

MODE_CASES = {
    "speculative": ([12, 5], dict(speculative=True, draft_k=4)),
    "chunked": ([12, 5, 21], dict(prefill_chunk=8)),
}


@pytest.fixture(scope="module")
def port_tokens():
    with RankPool(4, "cpu", verbose=False) as pool:
        yield serve_all(pool, MODE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp4_speculative_token_identity(port_tokens, tp):
    for st in check_tokens(port_tokens, "speculative", tp):
        assert st["spec_steps"] > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_tp4_chunked_prefill_token_identity(port_tokens, tp):
    for st in check_tokens(port_tokens, "chunked", tp):
        assert st["decode_steps_mid_prefill"] > 0

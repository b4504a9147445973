"""The port's tensor-parallel engine in its packed and paged modes, and
the serving CLI under `--tp`, against the JAX package's
(`tests/test_tp_engine.py`'s engine cases; the rest of that file is
mirrored in `tests/test_torch_tp_engine.py`, whose helpers this module
shares).

tp 2 and tp 4 on CPU ranks over gloo: an engine serving 4-bit packed
words and one serving the paged arena emit the JAX 1-device engine's
tokens on every rank.
"""
import pytest

from repro_torch.launch import serve as TSV
from repro_torch.launch.mesh import RankPool
from test_torch_tp_engine import check_tokens, serve_all

MODE_CASES = {
    "packed_b4": ([12, 5], dict(packed=True, bits_init=4.0)),
    "paged": ([12, 5], dict(paged=True, page_size=8)),
}


@pytest.fixture(scope="module")
def port_tokens():
    with RankPool(4, "cpu", verbose=False) as pool:
        yield serve_all(pool, MODE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", list(MODE_CASES))
def test_tp4_engine_token_identity(port_tokens, case, tp):
    check_tokens(port_tokens, case, tp)


def test_serve_cli_tp_parity_check(capsys):
    """`serve --smoke --tp 2` starts its own ranks and asserts the tp
    tokens equal the one-rank engine's, reporting the transport."""
    TSV.main(["--smoke", "--tp", "2", "--paged", "--compressed",
              "--prompt-lens", "9,5", "--gen", "4", "--slots", "2",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tp=2 decode token-identical" in out
    assert "gloo, decode eager" in out and "replicated fallbacks: none" in out

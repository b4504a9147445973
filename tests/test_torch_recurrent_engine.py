"""The port's engine on the recurrent mixers (rwkv6, jamba's hybrid plan)
against the JAX package's engine: greedy tokens in dense, int8 and packed
b4, from the contiguous and the paged arena (the paged one without prefix
sharing, which the port refuses on these plans), and `kv_bytes` /
`kv_pool_bytes` of both arenas (paged: the pools pro-rated over the pages
in use, the per-slot state whole, the page table).

The JAX package's PRNGKey(0) params reach the port's `build_engine`
through a patched `LM.init` (helpers shared with
`tests/test_torch_recurrent_serving.py`); each JAX engine runs once per
module.
"""
import pytest

from repro.launch import engine as JE
from repro_torch.core.subnet import tree_bytes
from repro_torch.launch import engine as TE
from test_torch_recurrent_serving import (ARCHS, LENS,  # noqa: F401
                                          MAX_SEQ, PAGED, _assert_tokens,
                                          _drain, _jax, _patch, _prompts,
                                          one_torch_thread)

MODES = {"dense": {}, "compressed": dict(compressed=True),
         "packed_b4": dict(packed=True, bits_init=4.0)}


def _jtokens(arch, **kw):
    """The JAX engine's tokens for `arch` under `build_engine(**kw)`."""
    def run():
        eng, _ = JE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                                 **kw)
        return _drain(eng, _prompts(arch))
    return _jax(("tokens", arch, tuple(sorted(kw.items()))), run)


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(monkeypatch, arch, mode, arena):
    """Every weight mode over both arenas: the port's greedy tokens are
    the JAX engine's (its contiguous arena)."""
    _patch(monkeypatch, arch)
    want = _jtokens(arch, **MODES[mode])
    eng, lm = TE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                              device="cpu", **MODES[mode],
                              **(PAGED if arena == "paged" else {}))
    _assert_tokens(_drain(eng, _prompts(arch)), want,
                   f"{arch} {mode} {arena}")
    assert eng.stats["admitted"] == len(LENS)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_bytes_match_jax(monkeypatch, arch):
    """kv_bytes and kv_pool_bytes of both arenas are the reference's: the
    contiguous arena whole; paged, the pools pro-rated over the pages in
    use plus the per-slot state whole and the page table."""
    _patch(monkeypatch, arch)
    for kw in ({}, dict(paged=True, page_size=4)):
        jeng, _ = JE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                                  quantized=False, **kw)
        eng, _ = TE.build_engine(
            arch, True, max_slots=2, max_seq=MAX_SEQ, quantized=False,
            device="cpu", **kw, **({"prefix_sharing": False} if kw else {}))
        assert eng.kv_bytes() == jeng.kv_bytes(), kw
        assert eng.kv_pool_bytes() == jeng.kv_pool_bytes(), kw
        state = sum(tree_bytes({k: v}) for k, v in eng.caches.items()
                    if k in TE._kv_split(eng.caches)[1])
        assert state > 0 and eng.kv_bytes() >= state

"""The port's MoE serving (grok-1, llama4) against the JAX package's: the
engine in every weight mode over both arenas, and the one-shot prefill
against sequential decode (pruned, speculative and chunked serving:
`tests/test_torch_moe_spec.py`).

The smoke configs are initialised by the JAX package (PRNGKey(0)) and
`LM.init` is patched to hand those params to the port as numpy, so both
packages' `build_engine` serve the same weights; the prompts are the JAX
package's. Greedy tokens must be equal (f32). Each reference engine runs
once per module (`_jax`).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import engine as JE
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import engine as TE
from repro_torch.models.transformer import LM as TLM

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
LENS, GEN = [5, 3, 9], 6
MAX_SEQ = 16
MODES = {"dense": {}, "compressed": dict(compressed=True),
         "packed_b4": dict(packed=True, bits_init=4.0)}

_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _np_params(arch):
    def init():
        params, _ = JLM(jget_arch(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        return {k: np.asarray(v) for k, v in params.items()}
    return _jax(("params", arch), init)


def _patch(monkeypatch, arch):
    """The port's `LM.init` hands over the JAX package's PRNGKey(0)
    params of `arch`."""
    np_params = _np_params(arch)
    monkeypatch.setattr(TLM, "init", lambda self, gen: convert.
                        params_from_numpy(np_params, device=gen.device))


def _prompts(arch):
    return [np.asarray(p) for p in JE.synthetic_prompts(
        jget_arch(arch, smoke=True), LENS)]


def _drain(eng, prompts, gen=GEN):
    rids = [eng.submit(p, gen) for p in prompts]
    eng.warmup()
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def _jtokens(arch, **kw):
    """The JAX engine's tokens for `arch` under `build_engine(**kw)`."""
    def run():
        eng, _ = JE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                                 **kw)
        return _drain(eng, _prompts(arch))
    return _jax(("tokens", arch, tuple(sorted(kw.items()))), run)


def _assert_tokens(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} request {i}")


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(monkeypatch, arch, mode, arena):
    """Every weight mode over both arenas: the port's greedy tokens are
    the JAX engine's (its contiguous arena; the JAX package holds its own
    paged tokens to those). The expert stacks stay dense with their
    fake-quant sites in the compressed modes."""
    _patch(monkeypatch, arch)
    want = _jtokens(arch, **MODES[mode])
    paged = dict(paged=True, page_size=4) if arena == "paged" else {}
    eng, lm = TE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                              device="cpu", **MODES[mode], **paged)
    _assert_tokens(_drain(eng, _prompts(arch)), want,
                   f"{arch} {mode} {arena}")
    if mode != "dense":
        for w in ("router", "we_gate", "we_up", "we_down"):
            name = f"blocks.0.moe.{w}"
            assert name in eng.params and name + ".codes" not in eng.params
            assert name + ".wq" in eng.qparams
        assert "blocks.0.attn.wq.wq" not in eng.qparams
        assert any(k.startswith("blocks.0.attn.wq.") and k != "blocks.0."
                   "attn.wq" for k in eng.params)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_sequential_decode(arch):
    """The full-capacity one-shot prefill equals S sequential decode steps
    (one token never overflows an expert): logits within 1e-4 of their
    range and the written KV rows equal within 1e-5."""
    lm = TLM(get_arch(arch, smoke=True))
    params = convert.params_from_numpy(_np_params(arch))
    qparams = lm.init_qparams(params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, lm.cfg.vocab, (2, 12)))
    c1 = lm.init_cache(2, MAX_SEQ, dtype=torch.float32)
    full, _ = lm.prefill(params, qparams, c1, toks)
    c2 = lm.init_cache(2, MAX_SEQ, dtype=torch.float32)
    steps = []
    for p in range(toks.shape[1]):
        lg, _ = lm.decode_step(params, qparams, c2, toks[:, p:p + 1], p)
        steps.append(lg[:, 0])
    seq = torch.stack(steps, 1)
    span = float(full.max() - full.min())
    assert float((seq - full).abs().max()) <= 1e-4 * span
    for k in c1:
        torch.testing.assert_close(c2[k], c1[k], rtol=0, atol=1e-5)

"""The port's speculative decoding against the JAX package's, on the CPU:
the token-identity matrix, `verify_chunk` and the rollback invariant.

With `tests/test_torch_speculative_engine.py` (the engine's counters,
gates, arenas and the checkpoint pair) it mirrors
`tests/test_speculative.py` (all but its MoE-target test, which
`tests/test_torch_moe_spec.py` mirrors; the gating test keeps its
`draft_k` cases, reaches the window gate by editing a built LM and the
recurrent gate on rwkv6's and jamba's real configs), the
speculative cell of `tests/test_paged_kv.py` and the two speculative
tests of `tests/test_engine.py`; the two files run on separate workers.

The smoke config (2 layers, d_model 128, f32) is initialised by the JAX
package and its params cross to the port as numpy (`LM.init` is patched
to hand them over, so `build_engine` and `build_checkpoint_engines` serve
the same weights on both sides); the prompts are the JAX package's.
Greedy speculative decoding commits only the target's argmaxes, so the
port's tokens must equal the JAX speculative engine's and the JAX plain
engine's in every target x draft x k cell. `verify_chunk` logits agree
with the JAX package's to 1e-5 of the logit range (f32 sums in another
order); `rollback_rows`, `pow2_floor`, `reachable_spec_ks`, `_spec_ks`
and the engine's counters are exactly the JAX package's. The JAX side
runs once per module (`_jax`).

The rollback invariant: after every round, in both arenas, every row at
or past each active slot's position is bitwise zero (`run_rollback_case`,
shared with `tests/test_torch_speculative_properties.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import engine as JE
from repro.launch import speculative as JSP
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.subnet import prepare_serving
from repro_torch.launch import engine as TE
from repro_torch.launch import speculative as TSP
from repro_torch.models.transformer import LM as TLM

ARCH = "internlm2-1.8b"
LENS, GEN = [6, 4], 12          # gen-1 = 11: budgets end mid-draft-window
MAX_SEQ = max(LENS) + GEN
TARGETS = {
    "dense": {},
    "pruned_s50": dict(pruned=True, sparsity=0.5),
    "packed_b4": dict(packed=True, bits_init=4.0),
}
DRAFTS = {
    # s0/b8: the packed subnet is the target's function, ~all accepted
    "faithful": dict(draft_sparsity=0.0, draft_bits=8.0),
    # s50/b2: near-zero acceptance, the most rollback traffic
    "aggressive": dict(draft_sparsity=0.5, draft_bits=2.0),
}
KS = (1, 2, 4, 8)
# the counters both packages keep, held equal run for run
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "prefill_tokens",
            "draft_prefills", "draft_prefill_tokens", "admitted", "evicted",
            "spec_steps", "spec_drafted", "spec_accepted")

_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke config's ops are tiny: one intra-op thread each, so the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(key, fn):
    """The JAX side's result under `key`, computed once per module."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _np_params(seed=0):
    def init():
        params, _ = JLM(jget_arch(ARCH, smoke=True)).init(
            jax.random.PRNGKey(seed))
        return {k: np.asarray(v) for k, v in params.items()}
    return _jax(("params", seed), init)


@pytest.fixture
def jax_weights(monkeypatch):
    """Make the port's `LM.init` hand over the JAX package's PRNGKey(0)
    init params, as numpy, on the generator's device."""
    np_params = _np_params()
    monkeypatch.setattr(TLM, "init", lambda self, gen:
                        convert.params_from_numpy(np_params,
                                                  device=gen.device))
    return np_params


def _prompts(lens=LENS):
    return [np.asarray(p) for p in JE.synthetic_prompts(
        jget_arch(ARCH, smoke=True), list(lens))]


def _drain(eng, prompts, gen):
    rids = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _assert_tokens(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} request {i}")


def _jax_plain(target, lens=LENS, gen=GEN):
    def run():
        eng, _ = JE.build_engine(ARCH, True, max_slots=2,
                                 max_seq=max(lens) + gen, **TARGETS[target])
        return _drain(eng, _prompts(lens), gen)
    return _jax(("plain", target, tuple(lens), gen), run)


def _jax_spec(target, draft):
    def run():
        eng, _ = JE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                                 speculative=True, draft_k=8,
                                 **TARGETS[target], **DRAFTS[draft])
        out = {}
        for k in KS:
            eng.draft_k = k
            out[k] = _drain(eng, _prompts(), GEN)
        return out
    return _jax(("spec", target, draft), run)


# ------------------------------------------------------- identity oracle
@pytest.mark.parametrize("draft_tag", sorted(DRAFTS))
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_speculative_token_identity(jax_weights, target, draft_tag):
    """Every (target x draft x k in {1, 2, 4, 8}) cell emits the JAX
    speculative engine's tokens and the JAX plain engine's; one engine a
    cell pair, k changed between drains."""
    plain, spec = _jax_plain(target), _jax_spec(target, draft_tag)
    eng, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                             speculative=True, draft_k=8, device="cpu",
                             **TARGETS[target], **DRAFTS[draft_tag])
    for k in KS:
        eng.draft_k = k
        got = _drain(eng, _prompts(), GEN)
        what = f"target={target} draft={draft_tag} k={k}"
        _assert_tokens(got, spec[k], what + " vs JAX speculative")
        _assert_tokens(got, plain, what + " vs JAX plain")
    assert set(eng.spec_rounds) <= set(eng._spec_ks())


def test_budget_smaller_than_draft_window(jax_weights):
    """gen 2 leaves one token after admission (every round is the k = 0
    verify); gen 3 rides one k = 1 round. Both emit the plain engines'
    tokens and never overshoot the budget."""
    eng, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                             speculative=True, draft_k=8, device="cpu",
                             **DRAFTS["faithful"])
    for gen in (2, 3):
        got = _drain(eng, _prompts(), gen)
        assert [len(t) for t in got] == [gen] * len(LENS)
        _assert_tokens(got, _jax_plain("dense", gen=gen), f"gen={gen}")
    assert set(eng.spec_rounds) == {0, 1}


def test_verify_chunk_logits_match_jax(jax_weights):
    """verify_chunk at per-slot positions over a prefilled cache: logits
    within 1e-5 of the logit range, the written K/V rows within 1e-5 of
    their range, in each weight mode; `last_logit_only` is the last
    position of the full logits."""
    jlm = JLM(jget_arch(ARCH, smoke=True))
    tlm = TLM(get_arch(ARCH, smoke=True))
    jparams = {k: jnp.asarray(v) for k, v in jax_weights.items()}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (2, 7)).astype(np.int32)
    chunk = rng.integers(0, 512, (2, 4)).astype(np.int32)
    pos = np.array([7, 5], np.int32)
    for mode in ({}, dict(compressed=True),
                 dict(packed=True, bits_init=4.0)):
        from repro.core import subnet as JS
        jp, jq, _ = JS.prepare_serving(jlm, jparams, **mode)
        tp, tq, _ = prepare_serving(
            tlm, convert.params_from_numpy(jax_weights), **mode)
        jc = jlm.init_cache(2, 16, dtype=jnp.float32)
        _, jc = jax.jit(jlm.prefill)(jp, jq, jc, jnp.asarray(toks))
        jlog, jc = jax.jit(jlm.verify_chunk)(jp, jq, jc, jnp.asarray(chunk),
                                             jnp.asarray(pos))
        tc = tlm.init_cache(2, 16, dtype=torch.float32)
        tlm.prefill(tp, tq, tc, torch.from_numpy(toks).long())
        last, _ = tlm.verify_chunk(tp, tq, {k: v.clone() for k, v in
                                            tc.items()},
                                   torch.from_numpy(chunk).long(),
                                   torch.from_numpy(pos),
                                   last_logit_only=True)
        tlog, tc = tlm.verify_chunk(tp, tq, tc,
                                    torch.from_numpy(chunk).long(),
                                    torch.from_numpy(pos))
        want = np.asarray(jlog)
        scale = np.abs(want).max()
        np.testing.assert_allclose(tlog.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=str(mode))
        np.testing.assert_array_equal(last.numpy(), tlog[:, -1:].numpy())
        for k in jc:
            w = np.asarray(jc[k])
            np.testing.assert_allclose(tc[k].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{mode} {k}")


# -------------------------------------------------------------- rollback
_ROLLBACK: dict = {}


def _rollback_engines():
    """A port speculative engine with a garbage draft (the JAX package's
    PRNGKey(7) init: proposals are noise, so nearly every round rejects
    and rolls back) and the plain engines of both packages on the
    PRNGKey(0) target, built once and reused (admission writes whole
    rows, so reuse is the engine's own slot recycling)."""
    if not _ROLLBACK:
        tlm = TLM(get_arch(ARCH, smoke=True))
        target = convert.params_from_numpy(_np_params())
        garbage = convert.params_from_numpy(_np_params(7))
        draft = TSP.build_draft(ARCH, True, garbage, sparsity=0.5, bits=2.0)
        params, qparams, _ = prepare_serving(tlm, target)
        _ROLLBACK["spec"] = TE.Engine(tlm, params, qparams, max_slots=2,
                                      max_seq=16, draft=draft, draft_k=4)
        _ROLLBACK["plain"] = TE.Engine(tlm, params, qparams, max_slots=2,
                                       max_seq=16)
        jlm = JLM(jget_arch(ARCH, smoke=True))
        from repro.core import subnet as JS
        jp, jq, _ = JS.prepare_serving(
            jlm, {k: jnp.asarray(v) for k, v in _np_params().items()})
        _ROLLBACK["jax"] = JE.Engine(jlm, jp, jq, max_slots=2, max_seq=16)
    return _ROLLBACK["spec"], _ROLLBACK["plain"], _ROLLBACK["jax"]


def assert_never_drafted_state(spec) -> None:
    """For every active slot: both arenas' rows at and past pos are
    bitwise zero, and pos / last_tok agree with the committed tokens."""
    for slot, req in enumerate(spec.active):
        if req is None:
            continue
        pos = int(spec.pos[slot])
        # admission emits one token before its row exists: last_tok is
        # fed (and its row written) at pos
        assert pos == req.prompt.size + len(req.tokens) - 1
        assert int(spec.last_tok[slot]) == req.tokens[-1]
        for arena in (spec.caches, spec.dcaches):
            for c in arena.values():
                assert not torch.any(c[:, slot, pos:]), \
                    f"slot {slot}: non-zero rows at or past pos={pos}"


def run_rollback_case(lens, gens, draft_k, jax_plain=True) -> None:
    """Drive one request mix through the garbage-draft engine a round at
    a time, asserting the never-drafted state after every round, then the
    tokens of the port's plain engine and (`jax_plain`) the JAX one's."""
    spec, plain, jeng = _rollback_engines()
    spec.draft_k = draft_k
    prompts = _prompts(lens)
    for p, g in zip(prompts, gens):
        for eng in (spec, plain) + ((jeng,) if jax_plain else ()):
            eng.submit(p, g)
    while spec.pending:
        spec.step()
        assert_never_drafted_state(spec)
    out = spec.run()
    refs = [plain.run()] + ([jeng.run()] if jax_plain else [])
    for ref in refs:
        assert len(out) == len(ref) == len(lens)
        for (_, got), (_, want) in zip(sorted(out.items()),
                                       sorted(ref.items())):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lens,gens,draft_k", [
    ([5], [8], 4),                  # deep rollbacks on one slot
    ([2, 6], [8, 3], 4),            # staggered budgets, mid-flight evict
    ([4, 4, 5], [1, 7, 4], 8),      # queue > slots, k_eff sweeps down
    ([3, 3], [2, 2], 1),            # k_eff in {0, 1} only
])
def test_rollback_restores_never_drafted_state(lens, gens, draft_k):
    run_rollback_case(lens, gens, draft_k)


def test_rollback_rows_unit():
    """rollback_rows zeroes exactly [lo, hi] per slot and nothing else, in
    place, as the JAX package's does."""
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 2)).astype(
        np.float32) + 2.0
    lo, hi = [2, 5, 8], [4, 5, 7]
    c = {"x": torch.from_numpy(x.copy())}
    out = TSP.rollback_rows(c, lo, hi)
    assert out is c
    want = np.asarray(JSP.rollback_rows({"x": jnp.asarray(x)}, lo, hi)["x"])
    np.testing.assert_array_equal(c["x"].numpy(), want)
    for slot, (a, b) in enumerate(zip(lo, hi)):
        keep = np.ones(8, bool)
        keep[a:b + 1] = False            # slot 2: empty range, no-op
        np.testing.assert_array_equal(c["x"][:, slot, keep].numpy(),
                                      x[:, slot, keep])
        assert not c["x"][:, slot, ~keep].any()

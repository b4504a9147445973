"""The port's step scheduler and chunked prefill against the JAX
package's, on the CPU: the mirror of `tests/test_scheduler.py`.

The chunk maths (`chunk_plan`, `chunk_buckets`, `reachable_chunk_shapes`)
is the JAX package's exactly. Chunked prefill stages each prompt through
`LM.verify_chunk` at absolute positions, so its greedy tokens equal the
one-shot engine's and the JAX package's chunked and one-shot engines' on
the same weights (the JAX package's PRNGKey(0) init of the smoke config,
f32, crossed as numpy) and prompts, over the plain, packed, paged and
speculative engines. Decode steps run while a prompt is mid-prefill, the
counters equal the JAX engine's, and `warmup()` and the drain run only
chunk lengths of `chunk_buckets(chunk)`. The window gate is reached on
a sliding-window config, the recurrent gate on rwkv6's and jamba's real
configs. The
JAX side runs once per module (`_jax`).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import engine as JE
from repro.launch import scheduler as JSC
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import engine as TE
from repro_torch.launch import scheduler as TSC
from repro_torch.models.transformer import LM as TLM

ARCH = "internlm2-1.8b"
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "prefill_tokens",
            "prefill_chunks", "chunked_prefills", "decode_steps_mid_prefill",
            "draft_prefills", "admitted", "evicted", "prefix_hits")
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


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's `LM.init` hands over the JAX package's PRNGKey(0) init
    params of the smoke config."""
    def init():
        params, _ = JLM(jget_arch(ARCH, smoke=True)).init(
            jax.random.PRNGKey(0))
        return {k: np.asarray(v) for k, v in params.items()}
    np_params = _jax("params", init)
    monkeypatch.setattr(TLM, "init", lambda self, gen:
                        convert.params_from_numpy(np_params,
                                                  device=gen.device))


def _prompts(lens, seed=0):
    return [np.asarray(p) for p in JE.synthetic_prompts(
        jget_arch(ARCH, smoke=True), list(lens), seed=seed)]


def _serve(pkg, lens, gen, **kw):
    """Tokens (in submission order) and counters of one engine of `pkg`
    (the JAX package's or the port's) on the JAX prompts."""
    if pkg is TE:
        kw["device"] = "cpu"
    eng, _ = pkg.build_engine(ARCH, True, max_seq=max(lens) + gen, **kw)
    rids = [eng.submit(p, gen) for p in _prompts(lens)]
    eng.warmup()
    out = eng.run()
    return [out[r] for r in rids], dict(eng.stats)


# ------------------------------------------------------------ chunk maths
def test_chunk_plan_sums_and_shapes():
    assert TSC.chunk_plan(21, 16) == [16, 4, 1]
    assert TSC.chunk_plan(16, 16) == [16]
    assert TSC.chunk_plan(5, 16) == [4, 1]
    assert TSC.chunk_plan(40, 8) == [8, 8, 8, 8, 8]
    assert TSC.chunk_plan(1, 16) == [1]
    for s in range(1, 70):
        for c in (1, 3, 8, 16, 128):
            plan = TSC.chunk_plan(s, c)
            assert plan == JSC.chunk_plan(s, c)
            assert sum(plan) == s
            assert all(x in TSC.chunk_buckets(c) for x in plan), (s, c, plan)


def test_chunk_plan_validation():
    with pytest.raises(ValueError):
        TSC.chunk_plan(0, 16)
    with pytest.raises(ValueError):
        TSC.chunk_plan(8, 0)


def test_chunk_buckets_and_reachable_shapes():
    assert TSC.chunk_buckets(16) == [1, 2, 4, 8, 16]
    assert TSC.chunk_buckets(12) == [1, 2, 4, 8, 12]
    assert TSC.chunk_buckets(1) == [1]
    for c in (1, 3, 8, 12, 16, 128):
        assert TSC.chunk_buckets(c) == JSC.chunk_buckets(c)
        for mp in (1, 5, 64, 300):
            got = TSC.reachable_chunk_shapes(mp, c)
            assert got == JSC.reachable_chunk_shapes(mp, c)
            assert got <= set(TSC.chunk_buckets(c))
        assert TSC.reachable_chunk_shapes(4 * c, c) == \
            set(TSC.chunk_buckets(c))


def test_chunked_scheduler_validation():
    with pytest.raises(ValueError):
        TSC.ChunkedPrefillScheduler(chunk=0)


# --------------------------------------------------------- token identity
CELLS = {"plain": {}, "packed_b4": dict(packed=True, bits_init=4.0),
         "paged": dict(paged=True, page_size=8),
         "speculative": dict(speculative=True, draft_k=4)}


@pytest.mark.parametrize("cell", list(CELLS))
def test_chunked_prefill_token_identity(jax_weights, cell):
    """Chunked (8) tokens equal the port's one-shot tokens and the JAX
    package's chunked and one-shot tokens; the counters equal the JAX
    chunked engine's."""
    lens, kw = [12, 5, 21], CELLS[cell]
    jbase = _jax(("oneshot", cell), lambda: _serve(JE, lens, 8, **kw))
    jgot = _jax(("chunked", cell), lambda: _serve(JE, lens, 8,
                                                  prefill_chunk=8, **kw))
    base, _ = _serve(TE, lens, 8, **kw)
    got, stats = _serve(TE, lens, 8, prefill_chunk=8, **kw)
    for want in (base, jbase[0], jgot[0]):
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg=f"{cell} {i}")
    assert {k: stats[k] for k in COUNTERS} == \
        {k: jgot[1][k] for k in COUNTERS}


def test_chunked_prefill_chunk_one_token_identity(jax_weights):
    """chunk = 1 is a sequential per-token prefill, the most adversarial
    plan: it still emits the one-shot tokens."""
    jbase = _jax(("oneshot1",), lambda: _serve(JE, [9, 4], 6))
    got, stats = _serve(TE, [9, 4], 6, prefill_chunk=1)
    assert stats["prefill_chunks"] == 13
    for a, b in zip(got, jbase[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunked_handoff_of_one_token_requests_and_prefix_hits(paged):
    """One-token requests finish at the handoff without a slot; on the
    paged arena a repeated prompt skips staging (a prefix-cache hit);
    the tokens are the one-shot engine's."""
    kw = dict(paged=True, page_size=8) if paged else {}
    lens, gens = [9, 9, 5, 9], [1, 6, 6, 6]

    def run(chunk):
        eng, lm = TE.build_engine(ARCH, True, max_slots=2, max_seq=24,
                                  device="cpu", prefill_chunk=chunk, **kw)
        p = TE.synthetic_prompts(lm.cfg, lens, seed=2)
        p[3] = p[1].copy()
        rids = [eng.submit(q, g) for q, g in zip(p, gens)]
        out = eng.run()
        return [out[r] for r in rids], eng.stats

    got, st = run(4)
    want, _ = run(None)
    assert [len(t) for t in got] == gens
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert st["chunked_prefills"] == (3 if paged else 4)
    assert st["prefix_hits"] == (1 if paged else 0)


# ------------------------------------------------------- disaggregation
class _FakeTime:
    """A clock that advances 1 ms a call: the timed sections' stats are
    exact call counts."""
    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 0.001
        return self.t


def test_decode_runs_mid_prefill(monkeypatch):
    monkeypatch.setattr(TE, "time", _FakeTime())
    eng, lm = TE.build_engine(ARCH, True, max_seq=64, prefill_chunk=4,
                              device="cpu")
    prompts = TE.synthetic_prompts(lm.cfg, [4, 33], seed=0)
    eng.submit(prompts[0], 20)    # short prompt: decoding early
    eng.submit(prompts[1], 8)     # long prompt: 9 chunks of prefill
    eng.warmup()
    out = eng.run()
    assert len(out) == 2
    assert eng.stats["prefill_chunks"] >= 9
    assert eng.stats["decode_steps_mid_prefill"] >= 8
    assert eng.stats["chunked_prefills"] == 2
    assert eng.stats["prefills"] == 2
    assert eng.stats["prefill_s"] == pytest.approx(
        0.001 * eng.stats["prefill_chunks"])
    assert eng.stats["decode_s"] == pytest.approx(
        0.001 * eng.stats["decode_steps"])


def test_oneshot_never_decodes_mid_prefill():
    st = {}
    TE.engine_serve(ARCH, True, [12, 5, 21], 8, verbose=False, stats=st,
                    device="cpu")
    assert st["decode_steps_mid_prefill"] == 0
    assert st["prefill_chunks"] == 0
    assert st["chunked_prefills"] == 0


# ----------------------------------------------------- chunk-shape set
def test_chunked_warmup_and_drain_run_only_bucket_shapes(monkeypatch):
    """The counterpart of the JAX compile-set pin: `warmup()` runs one
    chunk of every length of `chunk_buckets(8)` and the drain no other
    length; on the CPU nothing is captured."""
    eng, lm = TE.build_engine(ARCH, True, max_seq=64, prefill_chunk=8,
                              device="cpu")
    seen = []
    real = lm.verify_chunk

    def spy(params, qparams, caches, tokens, pos, **kw):
        seen.append(int(tokens.shape[1]))
        return real(params, qparams, caches, tokens, pos, **kw)

    monkeypatch.setattr(lm, "verify_chunk", spy)
    for p in TE.synthetic_prompts(lm.cfg, [21, 5, 12, 33], seed=0):
        eng.submit(p, 8)
    eng.warmup()
    assert seen == TSC.chunk_buckets(8)
    eng.run()
    assert set(seen) <= set(TSC.chunk_buckets(8))
    assert sum(seen[len(TSC.chunk_buckets(8)):]) == 21 + 5 + 12 + 33
    assert not eng.graphs


# --------------------------------------------------------- policy object
def test_default_scheduler_is_oneshot():
    eng, _ = TE.build_engine(ARCH, True, device="cpu")
    assert isinstance(eng.scheduler, TSC.OneShotScheduler)
    assert eng.scheduler.plan_step(eng) == ("admit", "decode")
    assert eng._chunk is None


class _DecodeTwice:
    """A custom policy: two decode batches a step."""
    chunk = None

    def plan_step(self, eng):
        return ("admit", "decode", "decode")


def test_custom_scheduler_drives_engine():
    eng, lm = TE.build_engine(ARCH, True, device="cpu")
    eng.scheduler = _DecodeTwice()
    for p in TE.synthetic_prompts(lm.cfg, [6, 6], seed=0):
        eng.submit(p, 9)
    while eng.pending:
        eng.step()
    assert len(eng.done) == 2
    assert eng.stats["decode_steps"] >= 8
    ref = TE.engine_serve(ARCH, True, [6, 6], 9, verbose=False,
                          device="cpu")
    for rid, req in eng.done.items():
        np.testing.assert_array_equal(np.asarray(req.tokens, np.int32),
                                      ref[rid])


# ------------------------------------------------------------ gating rails
def test_window_refuses_chunked_engine():
    eng, _ = TE.build_engine(ARCH, True, prefill_chunk=4, device="cpu")
    with pytest.raises(RuntimeError, match="chunked"):
        eng._window()


def test_chunked_refuses_windowed_and_stateful_archs():
    """Chunks go through verify_chunk and take its preconditions: the
    engine refuses ring arenas and recurrent mixers at construction."""
    sched = TSC.ChunkedPrefillScheduler(chunk=4)
    params = TLM(get_arch(ARCH, smoke=True)).init(
        torch.Generator().manual_seed(0))
    wlm = TLM(dataclasses.replace(get_arch(ARCH, smoke=True), window=8))
    with pytest.raises(ValueError, match="window"):
        TE.Engine(wlm, params, None, max_seq=16, scheduler=sched)
    for arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
        rlm = TLM(get_arch(arch, smoke=True))
        rparams = rlm.init(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="attention mixers"):
            TE.Engine(rlm, rparams, None, max_seq=16, scheduler=sched)


def test_pending_tracks_staging():
    eng, lm = TE.build_engine(ARCH, True, prefill_chunk=4, device="cpu")
    assert not eng.pending
    eng.submit(TE.synthetic_prompts(lm.cfg, [9], seed=0)[0], 4)
    assert eng.pending
    eng.step()           # chunk 1 of [4, 4, 1] staged, queue empty
    assert not eng.queue and eng._prefill_job is not None
    assert eng.pending   # mid-prefill work keeps run() draining
    while eng.pending:
        eng.step()
    assert len(eng.done) == 1

"""The port's speculative engine against the JAX package's, on the CPU:
its counters, gates, arenas and the GETA checkpoint pair; the second
half of the mirror of `tests/test_speculative.py` (see
`tests/test_torch_speculative.py`, whose helpers and JAX weights this
file shares), with the speculative cell of `tests/test_paged_kv.py` and
the two speculative tests of `tests/test_engine.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import engine as JE
from repro.launch import speculative as JSP
from repro_torch.configs import get_arch
from repro_torch.core.subnet import tree_bytes
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TSV
from repro_torch.launch import speculative as TSP
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import SubLayer
from test_torch_engine import _example
from test_torch_speculative import (  # noqa: F401 (fixtures)
    ARCH, COUNTERS, DRAFTS, GEN, LENS, MAX_SEQ, _assert_tokens, _drain,
    _jax, _prompts, jax_weights, one_torch_thread)


# ------------------------------------------------------ engine behaviour
def test_spec_slot_reuse_isolated():
    """A request admitted into a recycled slot of a speculative engine
    decodes as if it ran alone, the draft arena's state included."""
    eng, lm = TE.build_engine(ARCH, True, max_slots=1, max_seq=16,
                              speculative=True, draft_k=4, device="cpu",
                              **DRAFTS["aggressive"])
    prompts = TE.synthetic_prompts(lm.cfg, [5, 5, 5])
    want = _drain(eng, prompts[2:], 6)[0]
    got = _drain(eng, prompts, 6)
    np.testing.assert_array_equal(got[2], want)


def test_spec_eviction_mid_draft(jax_weights):
    """Mixed budgets on fewer slots than requests: requests evict between
    rounds and later ones take the freed slots; the tokens equal the plain
    engines' and no slot overshoots its budget; the counters equal the
    JAX speculative engine's."""
    gens = [2, 9, 5]
    prompts = _prompts([4, 4, 4])
    eng, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=16,
                             speculative=True, draft_k=8, device="cpu",
                             **DRAFTS["faithful"])
    plain, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=16,
                               device="cpu")

    def jax_run():
        jeng, _ = JE.build_engine(ARCH, True, max_slots=2, max_seq=16,
                                  speculative=True, draft_k=8,
                                  **DRAFTS["faithful"])
        rids = [jeng.submit(p, g) for p, g in zip(prompts, gens)]
        out = jeng.run()
        return [out[r] for r in rids], dict(jeng.stats)

    jtoks, jstats = _jax(("eviction",), jax_run)
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    prids = [plain.submit(p, g) for p, g in zip(prompts, gens)]
    out, ref = eng.run(), plain.run()
    for i, (r, pr, g) in enumerate(zip(rids, prids, gens)):
        assert len(out[r]) == g
        np.testing.assert_array_equal(out[r], ref[pr])
        np.testing.assert_array_equal(out[r], jtoks[i])
    assert eng.stats["evicted"] == len(gens)
    assert {k: eng.stats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}


@pytest.mark.parametrize("draft", sorted(DRAFTS))
def test_spec_throughput_counts_accepted_not_drafted(jax_weights, draft):
    """decode_tokens (and the headline tok/s) counts committed tokens
    only; rejected drafts show as the spec_drafted - spec_accepted gap;
    every counter and the acceptance rate equal the JAX engine's."""
    def jax_run():
        jeng, _ = JE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                                  speculative=True, draft_k=4,
                                  **DRAFTS[draft])
        _drain(jeng, _prompts(), GEN)
        return dict(jeng.stats), jeng.throughput()["acceptance_rate"]

    jstats, jrate = _jax(("throughput", draft), jax_run)
    eng, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                             speculative=True, draft_k=4, device="cpu",
                             **DRAFTS[draft])
    out = _drain(eng, _prompts(), GEN)
    total = sum(len(t) for t in out)
    # admission emits each request's first token outside decode counting
    assert eng.stats["decode_tokens"] == total - len(LENS)
    assert eng.stats["spec_accepted"] <= eng.stats["spec_drafted"]
    assert eng.stats["spec_steps"] > 0
    th = eng.throughput()
    assert th["accepted_tok_per_s"] == th["decode_tok_per_s"]
    assert 0.0 <= th["acceptance_rate"] <= 1.0
    assert th["acceptance_rate"] == jrate
    assert {k: eng.stats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}


def test_spec_accounting_exact():
    """One slot, faithful draft, prompt 5, budget 7, draft_k 4:
      admit: tokens = [t0]                (not a decode token)
      round 1: remaining 6 -> k 4, all accepted -> commit 5
      round 2: remaining 1 -> k 0 (plain verify) -> commit 1, done."""
    eng, lm = TE.build_engine(ARCH, True, max_slots=1, max_seq=16,
                              speculative=True, draft_k=4, device="cpu",
                              **DRAFTS["faithful"])
    rid = eng.submit(TE.synthetic_prompts(lm.cfg, [5])[0], 7)
    out = eng.run()
    assert len(out[rid]) == 7
    s = eng.stats
    assert s["spec_steps"] == 2
    assert s["decode_steps"] == (4 + 1) + (0 + 1)
    assert s["decode_tokens"] == 6
    assert s["spec_drafted"] == 4
    assert s["spec_accepted"] == 4
    assert eng.throughput()["acceptance_rate"] == 1.0
    assert eng.spec_rounds == {4: 1, 0: 1}


def test_spec_ks_bounded_as_the_jax_warmup_contract():
    """`_spec_ks()` is the JAX engine's, covers `reachable_spec_ks`
    (both packages' enumerations agree), and no workload mix runs a round
    at any other draft length; on the CPU `warmup()` captures nothing."""
    eng, lm = TE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                              speculative=True, draft_k=8, device="cpu",
                              **DRAFTS["aggressive"])
    jeng, _ = JE.build_engine(ARCH, True, max_slots=2, max_seq=MAX_SEQ,
                              speculative=True, draft_k=8,
                              **DRAFTS["aggressive"])
    assert eng._spec_ks() == jeng._spec_ks() == [0, 1, 2, 4, 8]
    for dk in (1, 3, 4, 8, 13):
        for ms in (2, 9, 16, 40):
            want = JSP.reachable_spec_ks(dk, ms)
            assert TSP.reachable_spec_ks(dk, ms) == want
    assert TSP.reachable_spec_ks(8, MAX_SEQ) == set(eng._spec_ks())
    eng.warmup()
    assert not eng.graphs
    prompts = TE.synthetic_prompts(lm.cfg, LENS)
    for gen in (1, 2, 5, 9, GEN):          # every k regime
        _drain(eng, prompts, gen)
    assert set(eng.spec_rounds) == set(eng._spec_ks())


def test_window_raises_on_speculative_engine():
    """A window schedules events assuming one token per slot per step; a
    round commits 1..k+1, so the engine refuses it and `run()` rounds
    through `step()`."""
    eng, lm = TE.build_engine(ARCH, True, max_slots=1, max_seq=16,
                              speculative=True, draft_k=2, device="cpu",
                              **DRAFTS["aggressive"])
    eng.submit(TE.synthetic_prompts(lm.cfg, [4])[0], 4)
    with pytest.raises(RuntimeError, match="one token per slot"):
        eng._window()
    assert len(eng.run()[0]) == 4


def test_spec_rejects_bad_draft_k_and_unrollable_arenas():
    """draft_k outside [1, max_seq) is refused; so are ring arenas (a
    sliding-window config) and recurrent mixers (rwkv6's and jamba's
    real configs), and verify_chunk refuses recurrent mixers. An
    MoE plan (grok-1's one position) verifies: its chunk, routed at full
    capacity, gives the logits and KV rows of sequential decode steps."""
    draft = TSP.build_draft(ARCH, True, sparsity=0.5, bits=2.0)
    lm = TLM(get_arch(ARCH, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    for bad_k in (0, 16):
        with pytest.raises(ValueError, match="draft_k"):
            TE.Engine(lm, params, None, max_seq=16, draft=draft,
                      draft_k=bad_k)
    windowed = TLM(dataclasses.replace(get_arch(ARCH, smoke=True), window=8))
    with pytest.raises(ValueError, match="window"):
        TE.Engine(windowed, params, None, max_seq=16, draft=draft)
    for arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
        recurrent = TLM(get_arch(arch, smoke=True))
        rparams = recurrent.init(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="attention mixers"):
            TE.Engine(recurrent, rparams, None, max_seq=16, draft=draft)
        with pytest.raises(ValueError, match="rolled back"):
            recurrent.verify_chunk(rparams, None, None,
                                   torch.zeros((1, 2), dtype=torch.int64),
                                   torch.zeros((1,), dtype=torch.int64))
    moe = TLM(get_arch("grok-1-314b", smoke=True))
    assert moe.plan == [SubLayer(0, "attn", "moe")]
    mp = moe.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, moe.cfg.vocab, (2, 7),
                         generator=torch.Generator().manual_seed(1))
    chunked = moe.init_cache(2, 16, dtype=torch.float32)
    moe.prefill(mp, None, chunked, toks[:, :3])
    stepped = {k: v.clone() for k, v in chunked.items()}
    logits, _ = moe.verify_chunk(mp, None, chunked, toks[:, 3:], 3)
    steps = [moe.decode_step(mp, None, stepped, toks[:, p:p + 1], p)[0]
             for p in range(3, 7)]
    torch.testing.assert_close(logits, torch.cat(steps, 1), rtol=0,
                               atol=1e-4)
    for k in chunked:
        torch.testing.assert_close(chunked[k], stepped[k], rtol=0, atol=1e-5)


def test_pow2_floor():
    ks = (0, 1, 2, 3, 4, 7, 8, 9, 100)
    assert [TSP.pow2_floor(k) for k in ks] == \
        [JSP.pow2_floor(k) for k in ks] == [0, 1, 2, 2, 4, 4, 8, 8, 64]


# --------------------------------------------- checkpoint-surrogate pair
def test_checkpoint_engines_high_acceptance_and_identity(jax_weights):
    """The GETA deployment pair: the masked checkpoint as target (dense
    fake-quant b8, and int8 codes), its own s50 b8 packed subnet as
    draft: acceptance >= 0.9, tokens the plain engine's and the JAX
    pair's, acceptance the JAX pair's."""
    prompts = _prompts([6, 4])

    def jax_run():
        spec, base, _ = JSP.build_checkpoint_engines(
            ARCH, True, sparsity=0.5, draft_bits=8.0, draft_k=4,
            max_slots=2, max_seq=24)
        return (_drain(spec, prompts, 12), _drain(base, prompts, 12),
                spec.throughput()["acceptance_rate"])

    jspec, jbase, jrate = _jax(("checkpoint",), jax_run)
    _assert_tokens(jspec, jbase, "JAX pair")
    for compressed in (False, True):
        spec, base, _ = TSP.build_checkpoint_engines(
            ARCH, True, sparsity=0.5, draft_bits=8.0, draft_k=4,
            max_slots=2, max_seq=24, device="cpu", compressed=compressed)
        got, want = _drain(spec, prompts, 12), _drain(base, prompts, 12)
        _assert_tokens(got, want, f"compressed={compressed}")
        assert spec.throughput()["acceptance_rate"] >= 0.9
        if not compressed:
            _assert_tokens(got, jspec, "vs the JAX pair")
            assert spec.throughput()["acceptance_rate"] == jrate


# ------------------------------------------------- arenas and counters
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_paged_speculative_token_identical_to_contiguous(kv_bits):
    """The speculative cell of the paged-arena parity: the round runs on
    views gathered from the pools and scatters back the pages it touched,
    so bf16/f32 pages give the contiguous engine's tokens bit for bit;
    int8 pages serve full-length outputs with the same first tokens."""
    def run(paged):
        eng, lm = TE.build_engine(ARCH, True, max_slots=2, max_seq=32,
                                  speculative=True, draft_k=4, device="cpu",
                                  paged=paged, page_size=8,
                                  kv_bits=kv_bits if paged else None)
        prompts = TE.synthetic_prompts(lm.cfg, [5, 9, 17, 3], seed=0)
        for p in prompts:
            eng.submit(p, 8)
        eng.warmup()
        return eng, eng.run()

    _, want = run(False)
    eng, got = run(True)
    assert sorted(got) == sorted(want)
    for rid in want:
        if kv_bits is None:
            np.testing.assert_array_equal(got[rid], want[rid])
        else:
            assert len(got[rid]) == 8 and got[rid][0] == want[rid][0]
    assert eng.stats["evicted"] == 4
    assert eng.stats["draft_prefills"] == 4


def test_paged_speculative_prefix_sharing_keeps_both_pools_in_step():
    """Repeated prompts share pages in both pools: the hits skip both
    prefills, the copy-on-write tail page is copied in both, and the
    tokens equal a run without sharing; a drain leaves no dirty page."""
    def run(sharing):
        eng, lm = TE.build_engine(ARCH, True, max_slots=2, max_seq=32,
                                  speculative=True, draft_k=4, device="cpu",
                                  paged=True, page_size=8,
                                  prefix_sharing=sharing)
        p = TE.synthetic_prompts(lm.cfg, [11, 6], seed=3)
        prompts = [p[0], p[1], p[0].copy(), p[0].copy()]
        for q in prompts:
            eng.submit(q, 6)
        return eng, eng.run()

    eng, got = run(True)
    _, want = run(False)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert eng.stats["prefix_hits"] >= 1
    assert eng.stats["draft_prefills"] == eng.stats["prefills"] == \
        4 - eng.stats["prefix_hits"]
    assert not eng.alloc.take_dirty()


def test_draft_prefill_time_rides_its_own_counters(monkeypatch):
    """The draft's admission prefill is draft work: a clock that ticks 1.0
    a call makes each timed block weigh exactly 1.0, and target and draft
    prefills land in their own counters."""
    import itertools
    import types
    eng, lm = TE.build_engine(ARCH, True, speculative=True, draft_k=2,
                              max_slots=2, max_seq=16, device="cpu")
    for p in TE.synthetic_prompts(lm.cfg, [5, 7]):
        eng.submit(p, 4)
    eng.warmup()
    ticks = itertools.count()
    monkeypatch.setattr(TE, "time", types.SimpleNamespace(
        time=lambda: float(next(ticks))))
    eng.run()
    s = eng.stats
    assert s["prefills"] == 2 and s["prefill_tokens"] == 12
    assert s["draft_prefills"] == 2 and s["draft_prefill_tokens"] == 12
    assert s["prefill_s"] == pytest.approx(2.0)
    assert s["draft_prefill_s"] == pytest.approx(2.0)


def test_kv_bytes_counts_both_arenas():
    """kv_bytes and kv_pool_bytes count the draft's arena too (paged: its
    pools pro-rated like the target's); the JAX engine's draft arena has
    the same bytes."""
    eng, _ = TE.build_engine(ARCH, True, speculative=True, max_slots=2,
                             max_seq=16, device="cpu")
    t, d = tree_bytes(eng.caches), tree_bytes(eng.dcaches)
    assert d > 0
    assert eng.kv_bytes() == t + d == eng.kv_pool_bytes()
    assert eng.serving_meta["kv_bytes"] == eng.kv_bytes()
    assert eng.serving_meta["speculative"]["draft_kv_bytes"] == d
    non, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=16,
                             device="cpu")
    assert non.kv_bytes() == tree_bytes(non.caches)
    jeng, _ = JE.build_engine(ARCH, True, speculative=True, max_slots=2,
                              max_seq=16)
    assert sorted(jeng.dcaches) == sorted(eng.dcaches)
    for k, c in eng.dcaches.items():
        assert tuple(c.shape) == jeng.dcaches[k].shape
    assert eng.kv_bytes() == jeng.kv_bytes()
    paged, _ = TE.build_engine(ARCH, True, speculative=True, max_slots=2,
                               max_seq=16, device="cpu", paged=True,
                               page_size=8)
    pools = tree_bytes(paged.caches) + tree_bytes(paged.dcaches)
    assert paged.kv_pool_bytes() == pools + paged.page_table.nbytes
    assert paged.kv_bytes() < paged.kv_pool_bytes()


# ----------------------------------------------------- CLI and example
@pytest.mark.parametrize("argv,says", [
    (["--speculative", "--draft-k", "4", "--draft-sparsity", "50",
      "--draft-bits", "2"], "speculative decode (draft k=4, s50/b2) "
                            "token-identical"),
    (["--speculative", "--draft-sparsity", "0", "--draft-bits", "8"],
     "acceptance 1.00"),
    (["--paged", "--page-size", "8", "--speculative"],
     "token-identical to the contiguous arena"),
    (["--chunked-prefill", "4", "--prompt-lens", "5,12,9"],
     "chunked prefill (chunk=4) token-identical"),
    (["--chunked-prefill", "4", "--paged", "--page-size", "8",
      "--prompt-lens", "5,12,9"], "decode steps ran mid-prefill")],
    ids=["spec_s50_b2", "spec_faithful", "paged_spec", "chunked",
         "chunked_paged"])
def test_cli_speculative_and_chunked_smoke_on_cpu(argv, says, capsys):
    """`--speculative` and `--chunked-prefill` serve on the CPU and, in
    --smoke mode, assert their tokens identical to the plain engine's;
    `--draft-sparsity` takes a percentage as the reference's CLI does."""
    TSV.main(["--smoke", "--gen", "6", "--slots", "2", "--device", "cpu"]
             + argv)
    assert says in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--speculative", "--draft-sparsity", "0"],
    ["--chunked-prefill", "8", "--paged", "--speculative"]],
    ids=["speculative", "chunked_paged_spec"])
def test_example_serves_speculative_and_chunked_on_cpu(argv, capsys):
    """`examples/serve_engine_torch.py` serves both modes (which raised
    before this slice): the acceptance report (1.00 for a keep-all b8
    draft) and the chunks of the chunked prefill."""
    out = _example().main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "decode on cpu" in text and len(out) == 4
    assert "drafted tokens accepted" in text
    if "--draft-sparsity" in argv:
        assert "(1.00)" in text
    if "--chunked-prefill" in argv:
        assert "chunked@8: 7 chunks" in text

"""The port's paged KV arena against the JAX package's.

Three tiers, as in `tests/test_paged_kv.py`:

  kernel    - `kv_quant_encode` codes and scales bit-equal to JAX's;
              the port's `paged_decode_attn_op` on CPU tensors (its plain
              version) against JAX's op (xla-ref) and the Pallas paged
              kernel in interpret mode, at 1e-5 in f32 (another summation
              order), and bitwise against the contiguous plain version on
              the gathered view for f32 pages.
  allocator - `run_allocator_case` drives the port's `PageAllocator`
              against a simulated pool (no page handed out while held,
              zero before reuse, shared pages survive one owner), and the
              same scripts hand out the same pages as JAX's allocator.
  engine    - on the smoke config with JAX-initialised weights (through
              `repro_torch.convert`): paged engine tokens equal the JAX
              paged engine's and the port's contiguous engine's in the
              dense, compressed and packed_b4 cells (pools agree with
              JAX's at 1e-4 outside the reserved pages); prefix sharing
              skips prefills; quantized pages shrink the pool; a drained
              engine leaves every unowned page zero; an idle slot may
              decode past its page table.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import quant as JQ
from repro.core import subnet as JS
from repro.kernels import decode_attn as JDA
from repro.kernels import ops as JOPS
from repro.launch import paging as JPG
from repro.launch.engine import Engine as JEngine
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import quant as TQ
from repro_torch.core import subnet as TS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TR
from repro_torch.launch import engine as TE
from repro_torch.launch import paging
from repro_torch.launch import serve as TSV
from repro_torch.models.transformer import LM as TLM

ARCH = "internlm2-1.8b"
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = {"dense": dict(quantized=True),
         "compressed": dict(compressed=True),
         "packed_b4": dict(compressed=True, packed=True, bits_init=4.0)}
SLOTS, MAX_SEQ, PAGE = 2, 32, 8


# -------------------------------------------------------------- page codes
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quant_codes_bit_equal_to_jax(bits):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 8, 6)).astype(np.float32)
    x[1, 2] = 0.0                        # a zero row
    x[2, 0, 0] = [3.0, -3.0, 1.5, -1.5, 0.5, -0.5]   # round-half ties
    jc, js = JQ.kv_quant_encode(jnp.asarray(x), bits)
    tc, ts = TQ.kv_quant_encode(torch.from_numpy(x), bits)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.asarray(jc).tobytes() == tc.numpy().tobytes()
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    jy = JQ.kv_quant_decode(jc, js, bits)
    ty = TQ.kv_quant_decode(tc, ts, bits)
    assert np.asarray(jy).tobytes() == ty.numpy().tobytes()
    # decode points are fixed points: re-encoding decoded rows is exact
    c2, s2 = TQ.kv_quant_encode(ty, bits)
    assert torch.equal(c2, tc)


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quant_zero_rows_stay_exact_zero(bits):
    codes, scale = TQ.kv_quant_encode(torch.zeros((2, 4, 8)), bits)
    assert not codes.any() and not scale.any()
    assert not TQ.kv_quant_decode(codes, scale, bits).any()


# ------------------------------------------------------------------ kernel
def _paged_inputs(kv_bits, seed=1):
    """Three slots at positions 5, 17 and 40 (past seq_len), pages in a
    shuffled order, zero where unwritten; numpy, for both packages."""
    B, KVh, g, dh, P, Lp, seq_len = 3, 2, 3, 8, 8, 3, 20
    n_pages = paging.N_RESERVED + B * Lp
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVh, g, dh)).astype(np.float32)
    pos = np.array([5, 17, 40], np.int32)
    pt = np.full((B, Lp), paging.ZERO_PAGE, np.int32)
    free = list(rng.permutation(np.arange(paging.N_RESERVED, n_pages)))
    for b in range(B):
        npp = paging.pages_for_rows(min(int(pos[b]) + 1, seq_len), P)
        pt[b, :npp] = [free.pop() for _ in range(npp)]
    kp = np.zeros((n_pages * P, KVh, dh), np.float32)
    vp = np.zeros((n_pages * P, KVh, dh), np.float32)
    for b in range(B):
        for r in range(min(int(pos[b]) + 1, seq_len)):
            phys = int(pt[b, r // P]) * P + r % P
            kp[phys] = rng.standard_normal((KVh, dh))
            vp[phys] = rng.standard_normal((KVh, dh))
    kp = kp.reshape(n_pages, P, KVh, dh)
    vp = vp.reshape(n_pages, P, KVh, dh)
    kw = {}
    if kv_bits is not None:
        kc, ks = JQ.kv_quant_encode(jnp.asarray(kp), kv_bits)
        vc, vs = JQ.kv_quant_encode(jnp.asarray(vp), kv_bits)
        kp, vp = np.asarray(kc), np.asarray(vc)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    return q, kp, vp, pos, pt, kw, dict(page_size=P, seq_len=seq_len,
                                         kv_bits=kv_bits)


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_paged_decode_attn_matches_jax(kv_bits):
    q, kp, vp, pos, pt, kw, geo = _paged_inputs(kv_bits)
    t = lambda a: torch.from_numpy(np.array(a))
    got = TOPS.paged_decode_attn_op(
        t(q), t(kp), t(vp), t(pos), t(pt), **geo,
        **{k: t(v) for k, v in kw.items()}).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jargs = [jnp.asarray(a) for a in (q, kp, vp, pos, pt)]
    want_ref = np.asarray(JOPS.paged_decode_attn_op(*jargs, **geo, **jkw,
                                                    backend="xla-ref"))
    want_kernel = np.asarray(JDA.paged_decode_attn_pallas(
        *jargs, **geo, **jkw, interpret=True))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_paged_plain_is_contiguous_plain_on_the_gathered_view():
    """fp pages: the paged plain version is bitwise the contiguous one on
    the gathered rows sliced to seq_len (the CUDA kernels hold the same
    contract on the card, `tests/test_torch_gpu.py`)."""
    q, kp, vp, pos, pt, _, geo = _paged_inputs(None)
    q, kp, vp, pos, pt = map(torch.from_numpy, (q, kp, vp, pos, pt))
    rows = lambda pool: pool[pt.long()].reshape(
        pt.shape[0], -1, *pool.shape[2:])[:, :geo["seq_len"]]
    got = TOPS.paged_decode_attn_op(q, kp, vp, pos, pt, **geo)
    assert torch.equal(got, TR.decode_attn_ref(q, rows(kp), rows(vp), pos))


def test_paged_decode_attn_rejects_bad_geometry():
    q, kp, vp, pos, pt, _, geo = _paged_inputs(None)
    q, kp, vp, pos, pt = map(torch.from_numpy, (q, kp, vp, pos, pt))
    with pytest.raises(ValueError, match="seq_len"):
        TOPS.paged_decode_attn_op(q, kp, vp, pos, pt[:, :2], **geo)
    with pytest.raises(ValueError, match="scales"):
        TOPS.paged_decode_attn_op(q, kp.to(torch.int8), vp.to(torch.int8),
                                  pos, pt, **dict(geo, kv_bits=8))


# --------------------------------------------------------------- allocator
def run_allocator_case(script, n_pages=12, page_size=4, pg=paging):
    """Drive `pg.PageAllocator` through an op script against a simulated
    pool, asserting after every op that no page is handed out while an
    owner holds it, that every allocated page reads zero (released pages
    stay quarantined until a flush zeroes them), and that retained pages
    survive any one owner's release. Ops: ("alloc", owner, n), which may
    meet MemoryError when free pages run short; ("share", new, src);
    ("release", owner); ("flush",). Returns the trace of pages handed out
    and released."""
    alloc = pg.PageAllocator(n_pages, page_size)
    pool = np.zeros((n_pages, page_size), np.int64)
    holds: dict = {}
    marker, trace = 0, []
    for op in script:
        if op[0] == "alloc":
            _, owner, n = op
            if owner in holds:
                continue
            if not alloc.can_alloc(n):
                with pytest.raises(MemoryError):
                    alloc.alloc(n)
                continue
            pages = alloc.alloc(n)
            trace.append(("alloc", pages))
            held = {p for pages_ in holds.values() for p, _ in pages_}
            assert not held & set(pages), "page handed out while held"
            assert all(p >= pg.N_RESERVED for p in pages)
            for p in pages:
                assert not pool[p].any(), f"page {p} reused before zeroing"
            marker += 1
            pool[pages] = marker
            holds[owner] = [(p, marker) for p in pages]
        elif op[0] == "share":
            _, new, src = op
            if src not in holds or new in holds:
                continue
            alloc.retain([p for p, _ in holds[src]])
            holds[new] = list(holds[src])
        elif op[0] == "release":
            _, owner = op
            if owner not in holds:
                continue
            dirty = alloc.release([p for p, _ in holds.pop(owner)])
            trace.append(("release", dirty))
            still_held = {p for pages_ in holds.values() for p, _ in pages_}
            assert not set(dirty) & still_held, \
                "shared page quarantined while another owner holds it"
        elif op[0] == "flush":
            dirty = alloc.take_dirty()
            pool[dirty] = 0
            alloc.mark_zeroed(dirty)
        else:
            raise ValueError(op)
        alloc.check()
        for owner, pages_ in holds.items():
            for p, m in pages_:
                assert (pool[p] == m).all(), f"{owner}'s page {p} corrupted"
    alloc.check()
    return trace


SCRIPTS = {
    "reuse_requires_flush": [
        ("alloc", "a", 5), ("alloc", "b", 5),
        ("release", "a"),
        ("alloc", "c", 5),          # free list short: MemoryError, no leak
        ("flush",),
        ("alloc", "c", 5),          # now succeeds, pages read back zero
        ("release", "b"), ("release", "c"), ("flush",),
        ("alloc", "d", 10)],
    "shared_pages_survive_one_owner": [
        ("alloc", "a", 4),
        ("share", "b", "a"), ("share", "c", "a"),
        ("release", "a"), ("flush",),    # b and c still read their marker
        ("release", "b"), ("flush",),
        ("alloc", "d", 6),               # c's 4 pages must not be among d's
        ("release", "c"), ("flush",),
        ("alloc", "e", 10)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_allocator_scripts_match_jax(name):
    got = run_allocator_case(SCRIPTS[name])
    want = run_allocator_case(SCRIPTS[name], pg=JPG)
    assert got == want and got


def test_allocator_rejects_bad_lifecycle_transitions():
    alloc = paging.PageAllocator(8, 4)
    pages = alloc.alloc(2)
    with pytest.raises(ValueError):
        alloc.retain([paging.ZERO_PAGE])        # reserved pages: no refcount
    dirty = alloc.release(pages)
    assert sorted(dirty) == sorted(pages)
    with pytest.raises(ValueError):
        alloc.retain(pages)                     # dirty pages are not live
    with pytest.raises(ValueError):
        alloc.mark_zeroed(pages)                # not taken yet
    assert sorted(alloc.take_dirty()) == sorted(pages)
    alloc.mark_zeroed(pages)
    alloc.check()


def test_prefix_cache_lru_releases_pages():
    alloc = paging.PageAllocator(10, 4)
    cache = paging.PrefixCache(alloc, capacity=2)
    prompts = [np.arange(n, dtype=np.int32) for n in (5, 6, 7)]
    for p in prompts:
        pages = alloc.alloc(2)
        cache.insert(paging.PrefixEntry(
            key=paging.prompt_key(p), prompt_len=p.size,
            full_pages=(pages[0],), tail_page=pages[1], first_token=1))
    assert len(cache) == 2 and cache.lookup(prompts[0]) is None
    assert cache.lookup(prompts[2]).prompt_len == 7
    assert (cache.hits, cache.misses) == (1, 1)
    assert sorted(cache.drop_all()) == [4, 5, 6, 7]
    alloc.check()


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def models():
    cfg = jget_arch(ARCH, smoke=True)
    jlm = JLM(cfg)
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jlm, jparams, TLM(get_arch(ARCH, smoke=True)), np_params


def _serving(models, mode):
    jlm, jparams, tlm, np_params = models
    jp, jq, _ = JS.prepare_serving(jlm, jparams, **MODES[mode])
    tp, tq, _ = TS.prepare_serving(
        tlm, convert.params_from_numpy(np_params), **MODES[mode])
    return jp, jq, tp, tq


def _prompts(lens, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _drain(eng, prompts, gen):
    for p in prompts:
        eng.submit(p, gen)
    return eng.run()


def _port(models, mode, **kw):
    _, _, tp, tq = _serving(models, mode)
    return TE.Engine(models[2], tp, tq, max_slots=SLOTS, max_seq=MAX_SEQ,
                     **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_engine_tokens_match_jax_and_contiguous(models, mode):
    """Four requests on two slots, pages of 8 rows: admission, eviction,
    prefix registration and page reuse all run mid-decode."""
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, mode)
    prompts = _prompts([5, 9, 17, 3])
    kw = dict(max_slots=SLOTS, max_seq=MAX_SEQ)
    jeng = JEngine(jlm, jp, jq, paged=True, page_size=PAGE, **kw)
    teng = TE.Engine(tlm, tp, tq, paged=True, page_size=PAGE, **kw)
    want = _drain(jeng, prompts, 8)
    got = _drain(teng, prompts, 8)
    contiguous = _drain(TE.Engine(tlm, tp, tq, **kw), prompts, 8)
    assert sorted(got) == sorted(want) == sorted(contiguous) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{mode} request {rid}")
        np.testing.assert_array_equal(got[rid], contiguous[rid])
    assert teng.stats["evicted"] == 4 and teng.stats["prefix_hits"] == 0
    # the prefix cache holds the same pages on both sides; outside the
    # reserved pages (idle-slot writes) the pools agree to f32 sum order
    np.testing.assert_array_equal(teng.alloc.refcount, jeng.alloc.refcount)
    for key, pool in teng.caches.items():
        np.testing.assert_allclose(
            pool[:, paging.N_RESERVED:].float().numpy(),
            np.asarray(jeng.caches[key])[:, paging.N_RESERVED:],
            rtol=1e-4, atol=1e-4, err_msg=key)


def test_prefix_sharing_skips_prefills_without_changing_tokens(models):
    """Repeated prompts hit the whole-prompt prefix cache (shared pages,
    copied tail page, memoized first token, no prefill) and emit the token
    stream of a sharing-free engine and of the JAX engine."""
    prompts = _prompts([9, 9, 9, 17])
    prompts[1], prompts[2] = prompts[0].copy(), prompts[0].copy()
    ref = _port(models, "dense", paged=True, page_size=PAGE,
                prefix_sharing=False)
    eng = _port(models, "dense", paged=True, page_size=PAGE)
    want, got = _drain(ref, prompts, 8), _drain(eng, prompts, 8)
    jp, jq, _, _ = _serving(models, "dense")
    jeng = JEngine(models[0], jp, jq, max_slots=SLOTS, max_seq=MAX_SEQ,
                   paged=True, page_size=PAGE)
    jwant = _drain(jeng, prompts, 8)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(got[rid], jwant[rid])
    assert ref.stats["prefills"] == 4 and ref.stats["prefix_hits"] == 0
    assert eng.stats["prefills"] == 2       # 9-token once, 17-token once
    assert eng.stats["prefix_hits"] == 2 == jeng.stats["prefix_hits"]
    # a repeated one-token request is answered from the memo alone
    rid = eng.submit(prompts[0], 1)
    assert eng.run()[rid][0] == want[0][0]
    assert eng.stats["prefills"] == 2 and eng.stats["prefix_hits"] == 3


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantized_pages_shrink_the_pool_and_serve(models, kv_bits):
    """int8 pages take a quarter of the f32 smoke pool's bytes plus
    scales, int4 an eighth; outputs are full length and the first token,
    which comes from the full-precision prefill, is unchanged."""
    prompts = _prompts([5, 9])
    fp = _port(models, "dense", paged=True, page_size=PAGE)
    q = _port(models, "dense", paged=True, page_size=PAGE, kv_bits=kv_bits)
    out_fp, out_q = _drain(fp, prompts, 6), _drain(q, prompts, 6)
    assert q.kv_pool_bytes() < fp.kv_pool_bytes()
    assert all(len(out_q[r]) == 6 for r in out_q)
    for rid in out_fp:
        assert out_q[rid][0] == out_fp[rid][0]


@pytest.mark.parametrize("kv_bits", [None, 4], ids=["fp", "int4"])
def test_drained_engine_leaves_unowned_pages_zero(models, kv_bits):
    """After a drain, every page that is neither reserved nor held reads
    zero in every pool (codes and scales): released pages were zeroed
    before they went back to the free list."""
    eng = _port(models, "compressed", paged=True, page_size=PAGE,
                kv_bits=kv_bits, prefix_sharing=False)
    _drain(eng, _prompts([5, 9, 17, 3, 12]), 6)
    assert eng.alloc.n_live == 0            # sharing off: a drain frees all
    unowned = [p for p in range(paging.N_RESERVED, eng.n_pages)
               if eng.alloc.refcount[p] == 0]
    assert len(unowned) == eng.n_pages - paging.N_RESERVED
    for key, pool in eng.caches.items():
        assert not pool[:, unowned].any(), f"stale rows in {key}"
    # kv_bytes follows allocation: a drained engine pins only the reserved
    # pages and the table, far below the whole pool
    assert eng.kv_bytes() < eng.kv_pool_bytes()


def test_idle_slot_past_its_table_writes_to_trash(models):
    """An idle slot decoding past Lp * P in a window raises nothing (its
    logical page clamps to the table's last entry, a trash page) and the
    live slot's tokens do not change."""
    prompts = _prompts([6])
    want = _drain(_port(models, "dense", paged=True, page_size=PAGE),
                  prompts, 8)
    eng = _port(models, "dense", paged=True, page_size=PAGE)
    eng.pos[1] = eng.Lp * PAGE + 3          # slot 1 stays idle
    got = _drain(eng, prompts, 8)
    np.testing.assert_array_equal(got[0], want[0])
    assert eng.stats["decode_steps"] == 7


def test_init_paged_cache_matches_jax(models):
    jlm, _, tlm, _ = models
    for kv_bits in (None, 8, 4):
        want = jlm.init_paged_cache(SLOTS, 6, PAGE, dtype=jnp.float32,
                                    kv_bits=kv_bits)
        got = tlm.init_paged_cache(6, PAGE, dtype=torch.float32,
                                   kv_bits=kv_bits)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert not got[k].any()
    with pytest.raises(ValueError, match="kv_bits"):
        tlm.init_paged_cache(6, PAGE, kv_bits=2)


def test_paged_engine_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.build_engine(ARCH, True, paged=True)
    eng, _ = TE.build_engine(ARCH, True, paged=True, kv_bits=8,
                             device="cpu", max_seq=8)
    assert eng.paged and eng.caches["blocks.0.k"].dtype == torch.int8
    with pytest.raises(ValueError, match="paged=True"):
        TE.build_engine(ARCH, True, kv_bits=8, device="cpu", max_seq=8)


@pytest.mark.parametrize("argv,expect", [
    (["--paged"], "token-identical to the contiguous arena"),
    (["--compressed", "--paged", "--page-size", "8"],
     "token-identical to the contiguous arena"),
    (["--kv-bits", "4"], "paged@kv4"),
])
def test_cli_paged_smoke_on_cpu(capsys, argv, expect):
    TSV.main(["--smoke", "--prompt-lens", "5,3", "--gen", "4", "--slots",
              "2", "--device", "cpu", *argv])
    assert expect in capsys.readouterr().out

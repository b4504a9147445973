"""The port's sliding-window attention (`cfg.window > 0`) against the JAX
package's, from the mask up to the engine.

No config of the repo sets a window; these tests set the JAX package's
`window` field on internlm2's smoke config (2 layers, d_model 128, f32),
whose PRNGKey(0) params cross to the port as numpy. Each reference result
runs once per module (`_jax`).

- `_causal_mask`; `attention_dense` and `attention_blockwise` at S = 4
  blocks of 4 with a window shorter than a block, equal to one, longer,
  and none: within 1e-6 of the max against the reference (f32 sums in
  another order), and the blockwise path's skipped leading blocks
  bitwise the full scan over every block.
- The mirror of `test_decode_attn.py::
  test_fresh_windowed_cache_masks_unwritten_rows`, and `attn_apply`'s
  ring decode past the wrap against the reference's.
- The LM: prefill then sequential decode past the wrap, and the forward,
  loss and gradients, against the reference; engine tokens (`run()`'s
  decode windows and `step()`) equal to the JAX engine's.
- The refusals: the paged arena, and a prompt longer than the window at
  `submit` (a ValueError naming both lengths before anything is
  admitted), where the JAX engine fails inside its prefill with an
  AssertionError (pinned here as the witness; ROADMAP logs the fault).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_arch as jget_arch
from repro.core import subnet as JS
from repro.launch.engine import Engine as JEngine
from repro.models import layers as JL
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core import subnet as TS
from repro_torch.launch import engine as TE
from repro_torch.launch import train as T
from repro_torch.models import layers as TL
from repro_torch.models.transformer import LM

ARCH = "internlm2-1.8b"
W = 8                       # the smoke config's window in these tests
TOL = 1e-6                  # f32, relative to the largest magnitude

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


def _cfg(get, window=W):
    return dataclasses.replace(get(ARCH, smoke=True), window=window)


def _jmodel():
    def init():
        jlm = JLM(_cfg(jget_arch))
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        return jlm, jp, {k: np.asarray(v) for k, v in jp.items()}
    return _jax("model", init)


def _close(got, want, what="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("sq,sk,q_off,window", [
    (6, 6, 0, 0), (6, 6, 0, 3), (4, 10, 6, 4), (5, 5, 0, 1), (3, 8, 5, 9)])
def test_causal_mask_matches_jax(sq, sk, q_off, window):
    want = np.asarray(JL._causal_mask(sq, sk, q_off, window))
    got = TL._causal_mask(sq, sk, q_off, window).numpy()
    np.testing.assert_array_equal(got, want)


def _qkv(seed, S=16, H=4, KV=2, dh=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, S, n, dh)).astype(np.float32)
            for n in (H, KV, KV)]


@pytest.mark.parametrize("window", [0, 3, 4, 6, 9])
def test_attention_within_window_matches_jax(window):
    """Block 4, S = 16 (4 blocks); windows shorter than a block (3), equal
    to one (4), longer (6, 9), and none: dense and blockwise within 1e-6
    of the reference's max, and of each other."""
    q, k, v = _qkv(window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_d = np.asarray(JL.attention_dense(jq, jk, jv, window=window))
    want_b = np.asarray(JL.attention_blockwise(jq, jk, jv, block=4,
                                               window=window))
    got_d = TL.attention_dense(tq, tk, tv, window=window)
    got_b = TL.attention_blockwise(tq, tk, tv, block=4, window=window)
    _close(got_d, want_d, "dense")
    _close(got_b, want_b, "blockwise")
    _close(got_b, got_d.numpy(), "blockwise vs dense")


@pytest.mark.parametrize("window", [1, 3, 4, 6, 9])
def test_skipped_leading_blocks_are_bitwise_the_full_scan(window):
    """Query block i attends from `first_kv_block(i)` on; scanning every
    block before it as well (the reference's loop) gives the same bits:
    those blocks are masked for every query, and the first block that
    holds a key of the window multiplies what they gathered by 0."""
    q, k, v = map(torch.from_numpy, _qkv(10 + window))
    blk, nb = 4, 4
    qb = q.reshape(2, nb, blk, 2, 2, 8)
    kb = k.reshape(2, nb, blk, 2, 8)
    vb = v.reshape(2, nb, blk, 2, 8)
    skipped = 0
    for i in range(nb):
        j0 = TL.first_kv_block(i, blk, window)
        skipped += j0
        full = TL._attend_q_block(qb[:, i], kb[:, :i + 1], vb[:, :i + 1],
                                  window)
        cut = TL._attend_q_block(qb[:, i], kb[:, j0:i + 1], vb[:, j0:i + 1],
                                 window)
        assert torch.equal(full, cut), (window, i, j0)
    assert skipped > 0


# ------------------------------------------------------------- attn_apply
def _tiny_cfg(window: int) -> ModelConfig:
    return ModelConfig(name="tiny-windowed", family="dense", n_layers=1,
                       d_model=16, n_heads=4, n_kv_heads=2, d_head=4,
                       d_ff=32, vocab=64, window=window, dtype="float32")


def _tiny_params(cfg):
    params, _ = JL.init_attention(jax.random.PRNGKey(0), cfg,
                                  "blocks.0.attn", 0, jnp.float32)
    return convert.params_from_numpy({k: np.asarray(v)
                                      for k, v in params.items()})


def test_fresh_windowed_cache_masks_unwritten_rows():
    """`test_decode_attn.py::test_fresh_windowed_cache_masks_unwritten_rows`:
    before the ring wraps a windowed layer decodes exactly as the
    full-causal one, so the ring's zero rows get no weight."""
    cfgw, cfg0 = _tiny_cfg(6), _tiny_cfg(0)
    params = _tiny_params(cfgw)
    B, KVh, dh = 2, cfgw.n_kv_heads, cfgw.d_head
    ring = [torch.zeros((B, 6, KVh, dh)) for _ in range(2)]
    full = [torch.zeros((B, 12, KVh, dh)) for _ in range(2)]
    gen = torch.Generator().manual_seed(100)
    for t in range(4):
        x = torch.randn((B, 1, cfgw.d_model), generator=gen)
        rope = TL.rope_tables(1, dh, cfgw.rope_theta, offset=t)
        outw, _ = TL.attn_apply(params, None, cfgw, x, rope=rope,
                                prefix="blocks.0.attn", cache=(*ring, t))
        out0, _ = TL.attn_apply(params, None, cfg0, x, rope=rope,
                                prefix="blocks.0.attn", cache=(*full, t))
        np.testing.assert_allclose(outw.numpy(), out0.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"pos {t}")


def test_ring_decode_past_the_wrap_matches_jax():
    """16 decode steps through a 6-row ring at per-slot positions (slot 1
    three steps ahead): each step writes row pos % 6 and attends over the
    rows written, the outputs and the ring within 1e-6 of the reference's
    from the step where it wraps on."""
    cfg = _tiny_cfg(6)
    jcfg = dataclasses.replace(jget_arch(ARCH, smoke=True), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jparams, _ = JL.init_attention(jax.random.PRNGKey(0), jcfg,
                                   "blocks.0.attn", 0, jnp.float32)
    params = _tiny_params(cfg)
    B, KVh, dh = 2, cfg.n_kv_heads, cfg.d_head
    xs = np.random.default_rng(3).standard_normal(
        (16, B, 1, cfg.d_model)).astype(np.float32)
    jring = (jnp.zeros((B, 6, KVh, dh)), jnp.zeros((B, 6, KVh, dh)))
    ring = [torch.zeros((B, 6, KVh, dh)) for _ in range(2)]
    freqs = TL.rope_freqs(dh, cfg.rope_theta, None)
    jstep = jax.jit(lambda x, rope, cache: JL.attn_apply(
        jparams, None, jcfg, x, rope=rope, window=6, prefix="blocks.0.attn",
        cache=cache))
    for t in range(16):
        pos = np.array([t, t + 3])
        ang = torch.from_numpy(pos).float()[:, None] * freqs[None, :]
        rope = (torch.cos(ang)[:, None], torch.sin(ang)[:, None])
        jrope = tuple(jnp.asarray(r.numpy()) for r in rope)
        want, jc = jstep(jnp.asarray(xs[t]), jrope,
                         jring + (jnp.asarray(pos, jnp.int32),))
        jring = (jc[0], jc[1])
        got, _ = TL.attn_apply(params, None, cfg, torch.from_numpy(xs[t]),
                               rope=rope, prefix="blocks.0.attn",
                               cache=(*ring, torch.from_numpy(pos)))
        _close(got, want, f"step {t}")
        _close(ring[0], jring[0], f"ring k at step {t}")
    assert t + 3 >= 2 * 6


# -------------------------------------------------------------------- LM
def test_lm_builds_for_every_arch_and_any_window():
    for arch in ASSIGNED_ARCHS:
        for smoke in (True, False):
            cfg = get_arch(arch, smoke=smoke)
            assert LM(cfg).cfg is cfg
            LM(dataclasses.replace(cfg, window=257))


def test_ring_arena_rows():
    """The ring holds min(max_seq, window) rows, and a one-shot prefill
    must fit it (the reference asserts it; the port raises)."""
    lm = LM(_cfg(get_arch))
    c = lm.init_cache(2, 32, dtype=torch.float32)
    assert c["blocks.0.k"].shape[2] == W
    params = lm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not fit the 8-row ring"):
        lm.prefill(params, None, c, torch.zeros((2, 10), dtype=torch.int64))
    assert lm.init_cache(2, 5, dtype=torch.float32)["blocks.0.k"].shape[2] \
        == 5
    assert LM(_cfg(get_arch, 0)).init_cache(
        2, 32, dtype=torch.float32)["blocks.0.k"].shape[2] == 32


def test_prefill_then_decode_past_the_wrap_matches_jax():
    """A 6-token prefill into the 8-row ring, then 12 decode steps (the
    ring wraps at position 8): every step's logits and the ring within
    1e-5 of the reference's max (f32; the decode runs through the
    decode-attention kernel's plain version here)."""
    jlm, jp, np_params = _jmodel()
    toks = np.random.default_rng(5).integers(0, jlm.cfg.vocab, (2, 18))

    def ref():
        jc = jlm.init_cache(2, 32, dtype=jnp.float32)
        lg, jc = jax.jit(jlm.prefill)(jp, None, jc, jnp.asarray(toks[:, :6]))
        out = [np.asarray(lg)]
        step = jax.jit(jlm.decode_step)
        for p in range(6, 18):
            lg, jc = step(jp, None, jc, jnp.asarray(toks[:, p:p + 1]),
                          jnp.int32(p))
            out.append(np.asarray(lg))
        return out, {k: np.asarray(v) for k, v in jc.items()}

    want, wcache = _jax("prefill_decode", ref)
    lm = LM(_cfg(get_arch))
    params = convert.params_from_numpy(np_params)
    tt = torch.from_numpy(toks)
    cache = lm.init_cache(2, 32, dtype=torch.float32)
    lg, _ = lm.prefill(params, None, cache, tt[:, :6])
    got = [lg]
    for p in range(6, 18):
        got.append(lm.decode_step(params, None, cache, tt[:, p:p + 1], p)[0])
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"logits {i}", tol=1e-5)
    for k, w in wcache.items():
        _close(cache[k], w, k, tol=1e-5)


def test_windowed_forward_loss_and_grads_match_jax():
    """At S = 16 with window 8 the mask bites: logits within 1e-5 of the
    reference's max, the loss within 1e-5 relative, every gradient within
    1e-4 of its max (8-bit quantizers, the weight sites' tolerances of the
    port's other gradient tests)."""
    jlm, jp, np_params = _jmodel()
    toks = np.random.default_rng(6).integers(0, jlm.cfg.vocab, (2, 16))

    def ref():
        jq = jlm.init_qparams(jp)
        batch = {"tokens": jnp.asarray(toks, jnp.int32)}
        logits = jax.jit(jlm.forward)(jp, jq, batch["tokens"])
        jl, (jgx, _) = jax.jit(jax.value_and_grad(jlm.loss, argnums=(0, 1)))(
            jp, jq, batch)
        nowin = jax.jit(JLM(_cfg(jget_arch, 0)).forward)(jp, jq,
                                                         batch["tokens"])
        return (np.asarray(logits), float(jl),
                {k: np.asarray(v) for k, v in jgx.items()},
                {k: tuple(np.asarray(t) for t in (v.d, v.q_m, v.t))
                 for k, v in jq.items()}, np.asarray(nowin))

    logits, jl, jgx, jq, nowin = _jax("grads", ref)
    assert np.abs(logits - nowin).max() > 1e-3     # the window bites
    lm = LM(_cfg(get_arch))
    tp = convert.params_from_numpy(np_params)
    tq = convert.qparams_from_numpy(jq)
    tt = torch.from_numpy(toks)
    _close(lm.forward(tp, tq, tt), logits, "logits", tol=1e-5)
    loss, gx, _ = T.loss_and_grads(lm, tp, tq, {"tokens": tt})
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert set(gx) == set(jgx)
    for k, w in jgx.items():
        _close(gx[k], w, k, tol=1e-4)


# ----------------------------------------------------------------- engine
def _engine():
    """The port's engine on the windowed smoke config, PRNGKey(0) params
    through its prepare_serving (dense fake-quant), 2 slots, max_seq 32."""
    lm = LM(_cfg(get_arch))
    tp, tq, _ = TS.prepare_serving(
        lm, convert.params_from_numpy(_jmodel()[2]))
    return TE.Engine(lm, tp, tq, max_slots=2, max_seq=32)


LENS, GEN = [6, 3, 8], 12


def _prompts():
    return [np.random.default_rng(20 + i).integers(0, 512, n).astype(
        np.int32) for i, n in enumerate(LENS)]


def test_engine_tokens_past_the_wrap_match_jax():
    """Three requests on two slots (request 2 takes a slot request 1
    freed), each decoding 12 tokens past its ring's wrap, dense
    fake-quant: `run()`'s decode windows and repeated `step()` emit the
    JAX engine's tokens."""
    jlm, jp, _ = _jmodel()

    def ref():
        p, q, _ = JS.prepare_serving(jlm, jp)
        je = JEngine(jlm, p, q, max_slots=2, max_seq=32)
        rids = [je.submit(pr, GEN) for pr in _prompts()]
        out = je.run()
        return [np.asarray(out[r]) for r in rids]

    want = _jax("engine", ref)
    eng = _engine()
    rids = [eng.submit(p, GEN) for p in _prompts()]
    eng.warmup()
    out = eng.run()
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(np.asarray(out[r]), w)
    stepper = _engine()
    rids = [stepper.submit(p, GEN) for p in _prompts()]
    while stepper.pending:
        stepper.step()
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(
            np.asarray(stepper.done[r].tokens), w)
    assert stepper.caches["blocks.0.k"].shape[2] == W


def test_paged_arena_refused():
    """The paged arena refuses a ring: at `init_paged_cache`, the engine,
    and `attn_apply`'s paged branch, as the reference's does."""
    lm = LM(_cfg(get_arch))
    params = lm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="window=8"):
        lm.init_paged_cache(8, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="window"):
        TE.Engine(lm, params, None, max_seq=32, paged=True, page_size=4)
    cfg = _tiny_cfg(6)
    pool = torch.zeros((4, 4, cfg.n_kv_heads, cfg.d_head))
    pages = TL.PagedView(torch.zeros((1, 2), dtype=torch.int32), 4, 8)
    with pytest.raises(ValueError, match="paged arena needs full"):
        TL.attn_apply(_tiny_params(cfg), None, cfg,
                      torch.zeros((1, 1, cfg.d_model)),
                      rope=TL.rope_tables(1, cfg.d_head, cfg.rope_theta),
                      prefix="blocks.0.attn", pages=pages,
                      cache=(pool, pool, 0, None, None))


def test_overlong_prompt_refused_at_submit():
    """A 10-token prompt on the window-8 engine: the port's `submit`
    raises a ValueError naming both lengths and queues nothing; the JAX
    engine takes it and fails at the one-shot prefill's assert (10, 8)
    (the reference's fault, logged in ROADMAP)."""
    jlm, jp, np_params = _jmodel()
    prompt = np.arange(10, dtype=np.int32)
    je = JEngine(jlm, jp, None, max_slots=2, max_seq=32)
    je.submit(prompt, 4)
    with pytest.raises(AssertionError, match=r"\(10, 8\)"):
        je.run()
    lm = LM(_cfg(get_arch))
    eng = TE.Engine(lm, convert.params_from_numpy(np_params), None,
                    max_slots=2, max_seq=32)
    with pytest.raises(ValueError, match=r"10 tokens.*window \(8\)"):
        eng.submit(prompt, 4)
    assert not eng.queue and not eng.pending
    eng.submit(prompt[:8], 4)          # a prompt that fits the ring serves
    assert len(eng.run()[0]) == 4

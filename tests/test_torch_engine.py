"""The port's serving slice against the JAX package's, end to end.

The smoke config of the engine tests' arch (2 layers, d_model 128, f32)
is initialised by the JAX package; its params cross to the port through
`repro_torch.convert`, and from there each side runs its own quantizer
init, compression, prefill, decode and continuous-batching engine on the
same prompts. Codes and packed words must be bit-equal, logits agree to
1e-4 (f32 sums in another order), and greedy engine tokens must be equal
in the dense fake-quant, compressed int8 and packed 4-bit modes.

The engine's decode windows (`run()`, one window body over static
buffers; on the card a CUDA graph replay, here the same body run eagerly)
are held to repeated eager `step()` and to the JAX engine over both KV
arenas, the port's `serve_loop` to the JAX `serve_loop` and to the port's
engine, and the rest mirrors `tests/test_engine.py` (its stateful-family
prefill test waits for the other families, which the port raises for;
its speculative tests are mirrored in `tests/test_torch_speculative*.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import subnet as JS
from repro.launch.engine import Engine as JEngine
from repro.launch.serve import serve_loop as jserve_loop
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import subnet as TS
from repro_torch.core.subnet import tree_bytes
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TSV
from repro_torch.models.transformer import LM as TLM

ARCH = "internlm2-1.8b"
MODES = {"dense": dict(quantized=True),
         "compressed": dict(compressed=True),
         "packed_b4": dict(compressed=True, packed=True, bits_init=4.0)}


@pytest.fixture(scope="module")
def models():
    cfg = jget_arch(ARCH, smoke=True)
    jlm = JLM(cfg)
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jlm, jparams, TLM(get_arch(ARCH, smoke=True)), np_params


def _serving(models, mode):
    """Both packages' prepare_serving on the same init params."""
    jlm, jparams, tlm, np_params = models
    jp, jq, _ = JS.prepare_serving(jlm, jparams, **MODES[mode])
    tp, tq, _ = TS.prepare_serving(
        tlm, convert.params_from_numpy(np_params), **MODES[mode])
    return jp, jq, tp, tq


def test_configs_match_reference():
    import dataclasses

    from repro.configs import ASSIGNED_ARCHS
    for arch in ASSIGNED_ARCHS:
        for smoke in (False, True):
            assert (dataclasses.asdict(get_arch(arch, smoke))
                    == dataclasses.asdict(jget_arch(arch, smoke)))


def test_weights_cross_with_convert(models):
    _, jparams, _, np_params = models
    tparams = convert.params_from_numpy(np_params)
    assert sorted(tparams) == sorted(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))
    bf = jnp.asarray(np_params["embed"][:4]).astype(jnp.bfloat16)
    t = convert.tensor_from_numpy(np.asarray(bf))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(bf.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["compressed", "packed_b4"])
def test_compressed_params_bit_equal(models, mode):
    jp, jq, tp, tq = _serving(models, mode)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    # every site executes from codes: no residual quantizer on either side
    assert jq is None and tq is None
    jlm, jparams, tlm, np_params = models
    bits = MODES[mode].get("bits_init", 8.0)
    jinit = jlm.init_qparams(jparams, bits_init=bits)
    tinit = tlm.init_qparams(convert.params_from_numpy(np_params),
                             bits_init=bits)
    assert sorted(tinit) == sorted(jinit)
    for site in jinit:
        for f in ("d", "q_m", "t"):
            assert (np.asarray(getattr(jinit[site], f)).tobytes()
                    == getattr(tinit[site], f).numpy().tobytes())
    if mode == "packed_b4":
        assert any(k.endswith(".packed4") for k in tp)


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_and_decode_logits_match(models, mode):
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, mode)
    toks = np.random.default_rng(1).integers(0, 512, (2, 7)).astype(np.int32)
    jc = jlm.init_cache(2, 16, dtype=jnp.float32)
    jlog, jc = jax.jit(jlm.prefill)(jp, jq, jc, jnp.asarray(toks))
    tc = tlm.init_cache(2, 16, dtype=torch.float32)
    tlog, tc = tlm.prefill(tp, tq, tc, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # the full-sequence forward (no cache) on the same tokens
    jfwd = jax.jit(jlm.forward)(jp, jq, jnp.asarray(toks))
    tfwd = tlm.forward(tp, tq, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tfwd.numpy(), np.asarray(jfwd),
                               rtol=1e-4, atol=1e-4)
    # one decode step with the two rows at different positions
    nxt = np.array([[3], [11]], np.int32)
    pos = np.array([7, 5], np.int32)
    jlog, _ = jax.jit(jlm.decode_step)(jp, jq, jc, jnp.asarray(nxt),
                                      jnp.asarray(pos))
    tlog, _ = tlm.decode_step(tp, tq, tc, torch.from_numpy(nxt).long(),
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_tokens_match_jax_engine(models, mode):
    """Three requests of mixed lengths on two slots, so admission and
    eviction run mid-decode on both sides."""
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, mode)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 3, 9)]
    gen, max_seq = 6, 16
    jeng = JEngine(jlm, jp, jq, max_slots=2, max_seq=max_seq)
    teng = TE.Engine(tlm, tp, tq, max_slots=2, max_seq=max_seq)
    for p in prompts:
        jeng.submit(p, gen)
        teng.submit(p, gen)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{mode} request {rid}")
    assert teng.stats["evicted"] == 3


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.build_engine(ARCH, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.engine_serve(ARCH, True, [4], 2, verbose=False)
    eng, _ = TE.build_engine(ARCH, True, device="cpu", max_seq=8)
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("mode", list(TE.WEIGHT_MODES))
def test_serve_on_devices_serves_the_engine_serve_model(mode):
    """On the CPU the helper draws the weights and prompts `engine_serve`
    draws from the same seed, so it emits the same tokens."""
    kw = TE.WEIGHT_MODES[mode]
    got = TE.serve_on_devices(ARCH, True, [6, 3, 9], 6, ["cpu"],
                              max_slots=2, **kw)
    want = TE.engine_serve(ARCH, True, [6, 3, 9], 6, max_slots=2,
                           verbose=False, device="cpu", **kw)
    assert list(got) == ["cpu"] and sorted(got["cpu"]) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got["cpu"][rid], want[rid])


def test_cli_packed_smoke_on_cpu(capsys):
    TSV.main(["--smoke", "--packed", "--bits", "4", "--prompt-lens", "5,3",
              "--gen", "4", "--slots", "2", "--device", "cpu"])
    assert "token-identical" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [dict(paged=True, tp=2),
                                dict(speculative=True, tp=2),
                                dict(tp=2), dict(prefill_chunk=4, tp=4),
                                dict(pruned=True, tp=2)])
def test_later_modes_raise_naming_their_slice(kw):
    """Tensor-parallel serving takes the MoE family in every mode: grok-1's
    engine builds on rank 0 of a (1, tp) mesh (a layout: building makes no
    collective) with its experts split over the ranks. A tp engine is
    built on the ranks of a group: outside one, build_engine says so."""
    from repro_torch.launch.mesh import Mesh
    kw = dict(kw)
    tp = kw.pop("tp")
    eng, lm = TE.build_engine("grok-1-314b", True, device="cpu",
                              mesh=Mesh(("data", "model"), (1, tp), rank=0),
                              **kw)
    assert lm.tp is not None and eng.serving_meta["tp"]["devices"] == tp
    n_experts = lm.shapes[0].n_experts     # 4, or 2 when pruned at s50
    assert eng.params["blocks.0.moe.we_gate"].shape[1] == n_experts // tp
    assert eng.params["blocks.0.moe.router"].shape[-1] == n_experts
    with pytest.raises(ValueError, match="RankPool"):
        TE.build_engine(ARCH, True, device="cpu", tp=tp, **kw)


@pytest.mark.parametrize("arch", [ARCH, "jamba-1.5-large-398b"])
def test_mesh_engine_takes_the_callers_params(arch):
    """Under a mesh the engine serves this rank's shards and empties the
    params dict it was given (each whole tensor leaves as its shard is
    cut); its shards are those of an engine given a copy."""
    from repro_torch.launch.mesh import Mesh
    lm = TLM(get_arch(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    want = {k: v.clone() for k, v in params.items()}
    mesh = Mesh(("data", "model"), (1, 2), rank=0)
    eng = TE.Engine(lm, params, None, mesh=mesh)
    ref = TE.Engine(TLM(get_arch(arch, smoke=True)), dict(want), None,
                    mesh=mesh)
    assert params == {} and eng.params.keys() == want.keys()
    assert all(torch.equal(eng.params[k], ref.params[k]) for k in want)
    assert sum(v.numel() for v in eng.params.values()) < sum(
        v.numel() for v in want.values())


def test_other_families_raise():
    """The engine serves plain token LMs: codebook and VLM archs raise the
    reference's ValueError at construction (they serve through the static
    loop)."""
    for arch in ("musicgen-large", "internvl2-26b"):
        lm = TLM(get_arch(arch, smoke=True))
        params = lm.init(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="plain token LMs"):
            TE.Engine(lm, params, None)


# ------------------------------------------------------- decode windows
PAGE = 8


def test_warmed_window_ks_match_reference(models):
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, "dense")
    want = JEngine(jlm, jp, jq, max_slots=2, max_seq=16).warmed_window_ks()
    eng = TE.Engine(tlm, tp, tq, max_slots=2, max_seq=16)
    assert eng.warmed_window_ks() == want == [1, 2, 4, 8, 16, 32]
    assert eng.MAX_WINDOW == JEngine.MAX_WINDOW


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("mode", list(MODES))
def test_run_windows_match_repeated_step_and_jax(models, mode, paged):
    """Five requests on two slots with budgets that make windows of 8, 4,
    2 and 1 steps cross admissions and evictions: `run()`'s windows emit
    the tokens of repeated `step()` and of the JAX engine."""
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, mode)
    rng = np.random.default_rng(3)
    lens, gens = (5, 9, 3, 12, 7), (9, 5, 12, 3, 7)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    kw = dict(max_slots=2, max_seq=24)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    jeng = JEngine(jlm, jp, jq, **kw)
    windows = TE.Engine(tlm, tp, tq, **kw)
    steps = TE.Engine(tlm, tp, tq, **kw)
    for eng in (jeng, windows, steps):
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
    want, got, stepped = jeng.run(), windows.run(), steps._drain(steps.step)
    assert sorted(got) == sorted(want) == sorted(stepped) == list(range(5))
    for rid in want:
        assert len(got[rid]) == gens[rid]
        np.testing.assert_array_equal(got[rid], stepped[rid],
                                      err_msg=f"{mode} request {rid}")
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{mode} request {rid}")
    # the windows took fewer, longer decode calls over the same steps
    assert windows.stats["decode_steps"] == steps.stats["decode_steps"]
    assert windows.stats["decode_tokens"] == steps.stats["decode_tokens"]
    assert not windows.graphs          # the CPU runs the body eagerly


def test_cpu_window_body_reads_only_the_static_buffers(models):
    """The window body is one function of the static buffers: written
    from the slot state by `_stage`, its tokens are those of k eager
    steps from the same state."""
    _, _, tlm, _ = models
    _, _, tp, tq = _serving(models, "compressed")
    eng = TE.Engine(tlm, tp, tq, max_slots=2, max_seq=16)
    ref = TE.Engine(tlm, tp, tq, max_slots=2, max_seq=16)
    for e in (eng, ref):
        e.submit(np.arange(5, dtype=np.int32), 6)
        e.submit(np.arange(3, 6, dtype=np.int32), 6)
        e._admit()
    eng._stage()
    assert eng._static["tok"][:, 0].tolist() == eng.last_tok.tolist()
    assert eng._static["pos"].tolist() == eng.pos.tolist() == [5, 3]
    toks = eng._window_body(4).numpy()
    for i in range(4):
        ref._act_decode()
    np.testing.assert_array_equal(toks.T,
                                  [r.tokens[1:5] for r in ref.active])


# ------------------------------------------------------------ serve_loop
@pytest.mark.parametrize("compressed", [False, True],
                         ids=["dense", "compressed"])
def test_engine_matches_static_serve_loop(compressed):
    """The mirror of the reference's acceptance test: the engine emits the
    static lockstep loop's tokens for the same requests, with fewer slots
    than requests, so admission and eviction run mid-decode."""
    batch, prompt_len, gen = 3, 6, 8
    eng, lm = TE.build_engine(ARCH, True, compressed=compressed,
                              max_slots=2, max_seq=prompt_len + gen,
                              device="cpu")
    prompts = TE.synthetic_prompts(lm.cfg, [prompt_len] * batch)
    seq = TSV.serve_loop(ARCH, True, batch, prompt_len, gen,
                         compressed=compressed, verbose=False,
                         prompts=np.stack(prompts), device="cpu")
    for p in prompts:
        eng.submit(p, gen)
    out = eng.run()
    assert sorted(out) == [0, 1, 2] and seq.shape == (batch, gen)
    for rid in out:
        np.testing.assert_array_equal(out[rid], seq[rid],
                                      err_msg=f"request {rid}")
    assert eng.stats["evicted"] == batch
    assert eng.stats["decode_steps"] > gen - 1   # two waves of decode


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_loop_matches_jax_serve_loop(models, mode, monkeypatch):
    """On the JAX package's init weights (its `serve_loop` draws them from
    PRNGKey(0); the port's draws them from `LM.init`, patched to hand over
    the same arrays) both loops emit the same (batch, gen) tokens, and the
    stats count the same decode tokens."""
    *_, np_params = models
    monkeypatch.setattr(TLM, "init", lambda self, gen:
                        convert.params_from_numpy(np_params))
    prompts = np.random.default_rng(4).integers(0, 512, (3, 6)).astype(
        np.int32)
    kw = dict(MODES[mode], verbose=False, prompts=prompts)
    jstats, tstats = {}, {}
    want = np.asarray(jserve_loop(ARCH, True, 3, 6, 7, stats=jstats, **kw))
    got = TSV.serve_loop(ARCH, True, 3, 6, 7, stats=tstats, device="cpu",
                         **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert tstats["tokens"] == jstats["tokens"] == 3 * 6


def test_serve_loop_pruned_raises_and_cli_runs(capsys, models, monkeypatch):
    """`serve_loop(pruned=True)` (which raised before slim serving) decodes
    the sliced subnet: on the JAX package's init weights it emits the JAX
    `serve_loop(pruned=True)`'s tokens at the ragged sparsity 0.3; the
    static CLI runs, pruned too."""
    *_, np_params = models
    with monkeypatch.context() as m:
        m.setattr(TLM, "init", lambda self, gen:
                  convert.params_from_numpy(np_params))
        prompts = np.random.default_rng(5).integers(0, 512, (2, 5)).astype(
            np.int32)
        kw = dict(pruned=True, sparsity=0.3, verbose=False, prompts=prompts)
        want = np.asarray(jserve_loop(ARCH, True, 2, 5, 4, **kw))
        got = TSV.serve_loop(ARCH, True, 2, 5, 4, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    TSV.main(["--static", "--batch", "2", "--prompt-len", "5", "--gen", "3",
              "--compressed", "--device", "cpu"])
    assert "static/compressed on cpu" in capsys.readouterr().out
    TSV.main(["--static", "--batch", "2", "--prompt-len", "5", "--gen", "3",
              "--pruned", "--sparsity", "0.3", "--device", "cpu"])
    assert "static/dense+pruned@0.30 on cpu" in capsys.readouterr().out


def test_make_serve_step_is_the_decode_argmax(models):
    _, _, tlm, _ = models
    _, _, tp, tq = _serving(models, "dense")
    caches = tlm.init_cache(2, 8, dtype=torch.float32)
    tok = torch.tensor([[3], [7]])
    nxt, out = TSV.make_serve_step(tlm)(tp, tq, caches, tok, 0)
    logits, _ = tlm.decode_step(tp, tq, tlm.init_cache(2, 8,
                                                        dtype=torch.float32),
                                tok, 0)
    assert nxt.shape == (2, 1) and out is caches
    np.testing.assert_array_equal(nxt[:, 0].numpy(),
                                  logits[:, -1].argmax(-1).numpy())


# ----------------------------------------- the rest of test_engine.py
def _cpu_engine(models, mode="dense", **kw):
    _, _, tlm, _ = models
    _, _, tp, tq = _serving(models, mode)
    return TE.Engine(tlm, tp, tq, **kw), tlm, tp, tq


def _sequential_prefill(lm, params, qparams, toks, max_seq):
    caches = lm.init_cache(toks.shape[0], max_seq, dtype=torch.float32)
    logits = []
    for p in range(toks.shape[1]):
        lg, caches = lm.decode_step(params, qparams, caches,
                                    toks[:, p:p + 1], p)
        logits.append(lg)
    return torch.cat(logits, dim=1), caches


@pytest.mark.parametrize("mode", ["dense", "compressed"])
def test_prefill_matches_sequential_decode(models, mode):
    _, _, tlm, _ = models
    _, _, tp, tq = _serving(models, mode)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 7)))
    lg_seq, c_seq = _sequential_prefill(tlm, tp, tq, toks, 16)
    lg_pre, c_pre = tlm.prefill(tp, tq, tlm.init_cache(2, 16,
                                                       dtype=torch.float32),
                                toks)
    np.testing.assert_array_equal(lg_pre.argmax(-1).numpy(),
                                  lg_seq.argmax(-1).numpy())
    np.testing.assert_allclose(lg_pre.numpy(), lg_seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    for k in c_seq:
        np.testing.assert_allclose(c_pre[k].numpy(), c_seq[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_engine_mixed_lengths_match_per_request_reference(models):
    """Slots at different positions share one decode step; each request's
    tokens match its own single-request sequential decode."""
    eng, tlm, tp, tq = _cpu_engine(models, max_slots=2, max_seq=16)
    lens, gens = [7, 3, 5, 4], [6, 9, 4, 7]
    prompts = TE.synthetic_prompts(tlm.cfg, lens)
    for p, g in zip(prompts, gens):
        eng.submit(p, g)
    out = eng.run()
    for rid, (p, g) in enumerate(zip(prompts, gens)):
        lg, caches = _sequential_prefill(
            tlm, tp, tq, torch.from_numpy(p[None].astype(np.int64)), 16)
        ref = [int(lg[0, -1].argmax())]
        for q in range(g - 1):
            lg, caches = tlm.decode_step(tp, tq, caches,
                                         torch.tensor([[ref[-1]]]),
                                         len(p) + q)
            ref.append(int(lg[0, -1].argmax()))
        np.testing.assert_array_equal(out[rid], np.asarray(ref, np.int32),
                                      err_msg=f"request {rid}")


def test_engine_slot_reuse_isolated(models):
    """A request admitted into a freed slot decodes as if it had the slot
    from the start."""
    alone, tlm, _, _ = _cpu_engine(models, max_slots=1, max_seq=16)
    prompts = TE.synthetic_prompts(tlm.cfg, [5, 5, 5])
    rid = alone.submit(prompts[2], 6)
    want = alone.run()[rid]
    eng, *_ = _cpu_engine(models, max_slots=1, max_seq=16)
    for p in prompts:
        eng.submit(p, 6)
    np.testing.assert_array_equal(eng.run()[2], want)


def test_engine_admission_guards(models):
    eng, *_ = _cpu_engine(models, max_slots=2, max_seq=8)
    with pytest.raises(ValueError):
        eng.submit(np.arange(6), 4)     # needs 6 + 4 - 1 = 9 rows > 8
    with pytest.raises(ValueError):
        eng.submit(np.arange(3), 0)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,)), 2)
    # a one-token request completes at admission, never holding a slot
    rid = eng.submit(np.arange(4), 1)
    out = eng.run()
    assert len(out[rid]) == 1
    assert eng.stats["decode_steps"] == 0


def test_engine_admits_exact_capacity_request(models):
    eng, tlm, _, _ = _cpu_engine(models, max_slots=1, max_seq=8)
    prompt = TE.synthetic_prompts(tlm.cfg, [5])[0]
    rid = eng.submit(prompt, 4)         # rows needed: 5 + 4 - 1 = 8 == 8
    out = eng.run()
    assert len(out[rid]) == 4
    big, *_ = _cpu_engine(models, max_slots=1, max_seq=16)
    brid = big.submit(prompt, 4)
    np.testing.assert_array_equal(out[rid], big.run()[brid])


def test_engine_admission_guards_one_past_capacity(models):
    eng, tlm, _, _ = _cpu_engine(models, max_slots=1, max_seq=8)
    with pytest.raises(ValueError):
        eng.submit(TE.synthetic_prompts(tlm.cfg, [5])[0], 5)   # 9 rows


def test_run_drains_only_new_completions(models):
    eng, tlm, _, _ = _cpu_engine(models, max_slots=2, max_seq=16)
    prompts = TE.synthetic_prompts(tlm.cfg, [4, 4])
    r0 = eng.submit(prompts[0], 3)
    assert set(eng.run()) == {r0}
    r1 = eng.submit(prompts[1], 3)
    assert set(eng.run()) == {r1}
    assert not eng.done


def test_kv_bytes_counts_the_arena():
    """Contiguous: kv_bytes is the whole arena, and so is the pool; the
    paged engine's pool adds its page table."""
    eng, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=16,
                             device="cpu")
    assert eng.kv_bytes() == tree_bytes(eng.caches) == eng.kv_pool_bytes()
    paged, _ = TE.build_engine(ARCH, True, max_slots=2, max_seq=16,
                               device="cpu", paged=True, page_size=PAGE)
    assert paged.kv_pool_bytes() == (tree_bytes(paged.caches)
                                     + paged.page_table.nbytes)


def test_one_token_request_does_not_stall_the_queue(models):
    eng, tlm, _, _ = _cpu_engine(models, max_slots=1, max_seq=16)
    prompts = TE.synthetic_prompts(tlm.cfg, [4, 4, 4])
    rids = [eng.submit(prompts[0], 1), eng.submit(prompts[1], 8),
            eng.submit(prompts[2], 1)]
    out = eng.run()
    assert [len(out[r]) for r in rids] == [1, 8, 1]


def _example():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_engine_torch.py"
    spec = importlib.util.spec_from_file_location("serve_engine_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--packed", "--bits", "4"],
    ["--paged", "--kv-bits", "8", "--hot-prompt", "--prompt-lens",
     "9,9,9,5", "--gens", "6"]], ids=["packed_b4", "paged_int8_hot"])
def test_example_serves_on_cpu(argv, capsys):
    out = _example().main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "decode on cpu" in text and len(out) == 4
    if "--hot-prompt" in argv:
        assert "2 prefix hits" in text


@pytest.mark.parametrize("argv", [["--pruned", "--tp", "2"],
                                  ["--speculative", "--tp", "2"],
                                  ["--tp", "2"], ["--devices", "4"],
                                  ["--chunked-prefill", "8", "--tp", "2"]])
def test_example_later_modes_raise(argv, monkeypatch):
    """The example serves `--tp` / `--devices` on ranks for the MoE and
    recurrent archs too: it reaches rank start (the start is recorded
    here, no rank runs) with the rank count asked for; a mode one rank
    refuses on a recurrent arch (`--speculative`, `--chunked-prefill`)
    raises that rank's ValueError before any rank starts."""
    from repro_torch.launch import mesh as meshlib
    ex = _example()
    started = []
    monkeypatch.setattr(meshlib, "spawn", lambda fn, world, device, args:
                        started.append((fn, world, args.arch)) or [{}])
    world = 4 if "--devices" in argv else 2
    for arch in ("grok-1-314b", "rwkv6-3b"):
        refused = arch == "rwkv6-3b" and ("--speculative" in argv or
                                          "--chunked-prefill" in argv)
        if refused:
            with pytest.raises(ValueError) as one_rank:
                TE.build_engine(arch, True, device="cpu",
                                speculative="--speculative" in argv,
                                prefill_chunk=8 if "--chunked-prefill" in argv
                                else None)
            with pytest.raises(ValueError, match="recurrent state") as e:
                ex.main(argv + ["--arch", arch, "--device", "cpu"])
            assert str(e.value) == str(one_rank.value)
            continue
        ex.main(argv + ["--arch", arch, "--device", "cpu"])
        assert started[-1] == (ex.serve, world, arch)
    assert len(started) == (1 if "--speculative" in argv
                            or "--chunked-prefill" in argv else 2)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_example_refuses_codebook_and_vlm_archs(arch):
    with pytest.raises(SystemExit, match="plain token LMs"):
        _example().main(["--arch", arch, "--device", "cpu"])

"""Slim (pruned) serving of the port against the JAX package's.

The mirror of `tests/test_slim_serving.py`'s dense-family tests, and of the
pruned cases of `tests/test_packed_serving.py`, with the JAX package as
the oracle: its smoke config (2 layers, d_model 128, 4 heads / 2 KV heads,
d_ff 256, f32) initialised by `LM.init(PRNGKey(0))`, the weights handed to
the port as numpy. On the same weights both packages must pick the same
magnitude keep masks (mask for mask), keep the same units, slice the same
params bit for bit and, in `construct_subnet`, emit the same codes and
bits. The sliced model's logits must agree with the masked dense model's
and with the JAX package's to 2e-4 (f32 sums in another order) and its
greedy tokens must be equal, at sparsity 0.5 (the reference tests'
width, d_ff 128 and one of two KV heads, all 16-byte rows) and at the
ragged 0.3 (d_ff 179: rows of 716 bytes, stored padded to 720).

The MoE slim tests (`test_compress_lm_records_skipped_sites`,
`test_moe_floor_keeps_top_k_experts`) are mirrored in
`tests/test_torch_moe_spec.py`; the stateful-family one
(`test_pruned_decode_stateful_families`) in
`tests/test_torch_recurrent_serving.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import subnet as JS
from repro.core.qadg import build_qadg as jbuild_qadg
from repro.launch import engine as JE
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import subnet as TS
from repro_torch.core.groups import GroupFamily, Member, PruningSpace
from repro_torch.core.qadg import build_qadg
from repro_torch.kernels import gemm_core as TG
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TSV
from repro_torch.models.transformer import LM as TLM

ARCH = "internlm2-1.8b"
SPARSITY = 0.5
RAGGED = 0.3
TOL = 2e-4
MODES = {"dense": dict(quantized=True),
         "compressed": dict(compressed=True),
         "packed_b4": dict(packed=True, bits_init=4.0)}


@pytest.fixture(scope="module")
def models():
    cfg = jget_arch(ARCH, smoke=True)
    assert cfg.dtype == "float32"          # tight parity needs f32 weights
    jlm = JLM(cfg)
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jlm, jparams, np_params


def _tparams(np_params):
    return convert.params_from_numpy(np_params)


def _jmasks(jlm, jparams, sparsity):
    qadg = jbuild_qadg(jlm.build_graph().graph)
    return qadg, JS.magnitude_keep_masks(
        qadg.space, jparams, sparsity, min_keep=JS.default_min_keep(jlm.cfg))


def _tmasks(tlm, tparams, sparsity):
    return TS.resolve_keep_masks(tlm, tparams, sparsity)


def _tlm():
    return TLM(get_arch(ARCH, smoke=True))


def _toks():
    return np.random.default_rng(1).integers(0, 512, (2, 7)).astype(np.int32)


def _jgreedy(lm, p, q, steps=6):
    caches = lm.init_cache(2, 16, dtype=jnp.float32)
    tok = jnp.zeros((2, 1), jnp.int32)
    step = jax.jit(lm.decode_step)
    out = []
    for i in range(steps):
        lg, caches = step(p, q, caches, tok, jnp.int32(i))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok[:, 0]))
    return np.stack(out)


def _tgreedy(lm, p, q, steps=6):
    caches = lm.init_cache(2, 16, dtype=torch.float32)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    out = []
    for i in range(steps):
        lg, caches = lm.decode_step(p, q, caches, tok, i)
        tok = torch.argmax(lg[:, -1], -1)[:, None]
        out.append(tok[:, 0].numpy())
    return np.stack(out)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------- masks and the sliced model
@pytest.mark.parametrize("sparsity", [SPARSITY, RAGGED])
def test_magnitude_masks_kept_units_and_slices_equal_jax(models, sparsity):
    """Mask for mask, kept unit for kept unit and sliced tensor for sliced
    tensor, the port's recipe is the reference's on the same weights; the
    group matrices they score are equal element for element."""
    jlm, jparams, np_params = models
    tlm, tparams = _tlm(), _tparams(np_params)
    jqadg, jm = _jmasks(jlm, jparams, sparsity)
    tqadg, tm = _tmasks(tlm, tparams, sparsity)
    assert sorted(tm) == sorted(jm)
    for fam in tqadg.space.prunable_families():
        np.testing.assert_array_equal(tm[fam.name].numpy(),
                                      np.asarray(jm[fam.name]), fam.name)
        jfam = jqadg.space.by_name[fam.name]
        np.testing.assert_array_equal(
            tqadg.space.group_matrix(tparams, fam).numpy(),
            np.asarray(jqadg.space.group_matrix(jparams, jfam)))
    for name, m in tqadg.space.init_masks().items():
        assert torch.equal(m, torch.ones_like(tm[name]))
    jsliced, jkept = jqadg.space.materialize(jparams, jm)
    tsliced, tkept = tqadg.space.materialize(tparams, tm)
    assert sorted(tkept) == sorted(jkept)
    for fam in jkept:
        np.testing.assert_array_equal(tkept[fam], jkept[fam])
    assert sorted(tsliced) == sorted(jsliced)
    for k in jsliced:
        assert tsliced[k].numpy().tobytes() == np.asarray(
            jsliced[k]).tobytes(), k


def test_construct_subnet_codes_and_bits_equal_jax(models):
    """The paper's deployable artifact: at the quantizers' init (t = 1)
    the codes are the reference's bit for bit, in the same containers,
    with the same per-site bits, kept units and meta."""
    jlm, jparams, np_params = models
    tlm, tparams = _tlm(), _tparams(np_params)
    jqadg, jm = _jmasks(jlm, jparams, RAGGED)
    tqadg, tm = _tmasks(tlm, tparams, RAGGED)
    jsub = JS.construct_subnet(jqadg, jparams, jlm.init_qparams(jparams), jm)
    tsub = TS.construct_subnet(tqadg, tparams, tlm.init_qparams(tparams), tm)
    assert sorted(tsub.int_weights) == sorted(jsub.int_weights)
    for k, v in jsub.int_weights.items():
        a, b = np.asarray(v), tsub.int_weights[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        assert np.asarray(jsub.scales[k]).tobytes() == \
            tsub.scales[k].numpy().tobytes(), k
    assert tsub.bits == jsub.bits
    for fam in jsub.kept_units:
        np.testing.assert_array_equal(tsub.kept_units[fam],
                                      jsub.kept_units[fam])
    assert tsub.meta == jsub.meta
    assert tsub.meta["sparsity"] == pytest.approx(RAGGED, abs=0.02)


# -------------------------------------------------- masked vs sliced parity
@pytest.mark.parametrize("compressed", [False, True],
                         ids=["dense", "compressed"])
def test_lm_masked_vs_sliced_logit_parity(models, compressed):
    """The sliced LM's logits equal the masked dense LM's (the port's own)
    and the JAX package's masked model's, attention heads and MLP units
    pruned, the residual width untouched."""
    jlm, jparams, np_params = models
    tlm, tparams = _tlm(), _tparams(np_params)
    qadg, masks = _tmasks(tlm, tparams, SPARSITY)
    assert {f.kind for f in qadg.space.prunable_families()} == {
        "head_group", "channel"}
    assert all(int(torch.sum(masks[f.name])) < f.units
               for f in qadg.space.prunable_families())
    jqadg, jm = _jmasks(jlm, jparams, SPARSITY)
    toks = _toks()
    jq = jlm.init_qparams(jparams)
    want = jlm.forward(jqadg.space.apply_masks(jparams, jm), jq,
                       jnp.asarray(toks))
    masked = tlm.forward(qadg.space.apply_masks(tparams, masks),
                         tlm.init_qparams(tparams), torch.from_numpy(toks))
    slim = _tlm()
    p, q, meta = TS.prepare_serving(slim, dict(tparams), quantized=True,
                                    compressed=compressed, keep_masks=masks)
    assert meta["sparsity"] == pytest.approx(SPARSITY, abs=0.05)
    assert meta["param_bytes"] < TS.tree_bytes(tparams)
    got = slim.forward(p, q, torch.from_numpy(toks))
    assert got.shape == masked.shape
    _close(got.numpy(), masked.numpy())
    _close(got.numpy(), want)
    assert np.array_equal(got.argmax(-1).numpy(),
                          np.asarray(want).argmax(-1))


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["dense", "compressed"])
def test_lm_masked_vs_sliced_decode_parity(models, compressed):
    """Cached decode through the sliced KV arena: the port's greedy tokens
    equal its masked dense model's and the JAX masked model's."""
    jlm, jparams, np_params = models
    tlm, tparams = _tlm(), _tparams(np_params)
    qadg, masks = _tmasks(tlm, tparams, SPARSITY)
    slim = _tlm()
    p, q, _ = TS.prepare_serving(slim, dict(tparams), quantized=True,
                                 compressed=compressed, keep_masks=masks)
    got = _tgreedy(slim, p, q)
    np.testing.assert_array_equal(
        got, _tgreedy(tlm, qadg.space.apply_masks(tparams, masks),
                      tlm.init_qparams(tparams)))
    jqadg, jm = _jmasks(jlm, jparams, SPARSITY)
    np.testing.assert_array_equal(
        got, _jgreedy(jlm, jqadg.space.apply_masks(jparams, jm),
                      jlm.init_qparams(jparams)))


def test_slim_plan_shapes_and_kv_arena(models):
    """The SlimPlan reports the surviving widths (the reference's), the
    sliced params carry them, and both KV arenas hold the surviving KV
    heads only."""
    jlm, jparams, np_params = models
    cfg = get_arch(ARCH, smoke=True)
    slim = _tlm()
    sliced, plan = TS.prune_lm(slim, _tparams(np_params), sparsity=SPARSITY)
    _, jplan = JS.prune_lm(JLM(jlm.cfg), dict(jparams), sparsity=SPARSITY)
    shp = plan.layer_shapes[0]
    # the port's LayerShapes holds the attention, MLP and MoE fields only
    assert [dataclasses.asdict(s) for s in plan.layer_shapes] == [
        {f: getattr(s, f) for f in dataclasses.asdict(shp)}
        for s in jplan.layer_shapes]
    assert plan.sparsity == jplan.sparsity
    assert slim.slim_plan is plan and slim.shapes == plan.layer_shapes
    assert shp.n_kv_heads < cfg.n_kv_heads and shp.d_ff < cfg.d_ff
    assert shp.n_heads == shp.n_kv_heads * cfg.gqa_group
    assert len(plan.kept_units["blocks.0.attn.kv_groups"]) == shp.n_kv_heads
    assert sliced["blocks.0.attn.wk"].shape[-1] == shp.n_kv_heads * cfg.d_head
    assert sliced["blocks.0.mlp.w_gate"].shape[-1] == shp.d_ff
    full = _tlm().init_cache(2, 16, dtype=torch.float32)
    slimc = slim.init_cache(2, 16, dtype=torch.float32)
    assert TS.tree_bytes(slimc) == \
        TS.tree_bytes(full) * shp.n_kv_heads // cfg.n_kv_heads
    paged = slim.init_paged_cache(6, 8, dtype=torch.float32)
    assert TS.tree_bytes(paged) == TS.tree_bytes(
        _tlm().init_paged_cache(6, 8, dtype=torch.float32)) // 2


def test_prune_then_compress_stacks(models):
    """Compression composes with pruning: codes at the sliced shapes, the
    reference's bit for bit."""
    jlm, jparams, np_params = models
    slim = _tlm()
    tparams = _tparams(np_params)
    qparams = slim.init_qparams(tparams)
    sliced, _ = TS.prune_lm(slim, tparams, sparsity=SPARSITY)
    subnet = TS.compress_lm(slim, sliced, qparams)
    jslim = JLM(jlm.cfg)
    jsliced, _ = JS.prune_lm(jslim, dict(jparams), sparsity=SPARSITY)
    jsub = JS.compress_lm(jslim, jsliced, jlm.init_qparams(jparams))
    assert subnet.int_weights and sorted(subnet.int_weights) == sorted(
        jsub.int_weights)
    for name, codes in subnet.int_weights.items():
        assert codes.shape == sliced[name].shape, name
        assert codes.numpy().tobytes() == np.asarray(
            jsub.int_weights[name]).tobytes(), name


@pytest.mark.parametrize("mode", list(MODES))
def test_ragged_sparsity_logits_and_tokens_match_jax(models, mode):
    """Sparsity 0.3 leaves ragged widths (d_ff 256 -> 179, 2 -> 1 KV head):
    the port's served model, its ragged weights stored with rows padded to
    16 bytes, gives the JAX package's logits at 2e-4 and its greedy
    tokens."""
    jlm, jparams, np_params = models
    jslim, slim = JLM(jlm.cfg), _tlm()
    jp, jq, jmeta = JS.prepare_serving(jslim, dict(jparams),
                                       prune_sparsity=RAGGED, **MODES[mode])
    tp, tq, meta = TS.prepare_serving(slim, _tparams(np_params),
                                      prune_sparsity=RAGGED, **MODES[mode])
    assert slim.shapes[0].d_ff == 179 and slim.shapes[0].n_kv_heads == 1
    assert meta["sparsity"] == jmeta["sparsity"]
    assert meta["param_bytes"] == jmeta["param_bytes"]
    assert sorted(tp) == sorted(jp)
    toks = _toks()
    _close(slim.forward(tp, tq, torch.from_numpy(toks)).numpy(),
           jslim.forward(jp, jq, jnp.asarray(toks)))
    np.testing.assert_array_equal(_tgreedy(slim, tp, tq),
                                  _jgreedy(jslim, jp, jq))


def test_served_weights_are_stored_with_aligned_rows(models):
    """Every served weight whose rows are not 16-byte multiples is a view
    of an allocation with rows padded with zeros to 16 bytes; its values
    are the sliced model's; param_bytes counts the logical tensors and
    param_alloc_bytes the padding beside them."""
    *_, np_params = models
    for mode in MODES:
        slim = _tlm()
        tp, _, meta = TS.prepare_serving(slim, _tparams(np_params),
                                         prune_sparsity=RAGGED,
                                         **MODES[mode])
        padded = 0
        for k, v in tp.items():
            if v.ndim >= 2 and TS._served_weight(k):
                assert (v.stride(-2) * v.element_size()) % 16 == 0, k
                assert v.stride(-1) == 1 and v.data_ptr() % 16 == 0, k
                padded += v.stride(-2) != v.shape[-1]
        assert padded > 0, mode
        assert meta["param_bytes"] == TS.tree_bytes(tp)
        assert meta["param_alloc_bytes"] > meta["param_bytes"]
    w = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
    a = TG.aligned_rows(w)
    assert torch.equal(a, w) and a.stride() == (8, 4, 1)
    assert torch.equal(a._base[..., 3:], torch.zeros((2, 2, 1)))
    assert TG.aligned_rows(a) is a            # padded once, kept as is
    b = TG.aligned_rows(w[..., :2])           # rows 12 bytes apart: copied
    assert torch.equal(b, w[..., :2]) and b.stride() == (8, 4, 1)


# ------------------------------------------------------- engine end to end
@pytest.mark.parametrize("compressed", [False, True],
                         ids=["dense", "compressed"])
def test_engine_pruned_matches_masked_reference(models, compressed,
                                                monkeypatch):
    """Engine decode of the sparsity-0.5 subnet is token-identical to the
    masked dense reference engine and to the JAX pruned engine on the same
    weights, with the KV arena at 1 of 2 KV groups and the block weights
    shrunk by the realized sparsity."""
    *_, np_params = models
    monkeypatch.setattr(TLM, "init", lambda self, gen:
                        _tparams(np_params))
    lens, gen, slots = [6, 4, 5], 7, 2
    max_seq = max(lens) + gen
    eng, lm = TE.build_engine(ARCH, True, compressed=compressed, pruned=True,
                              sparsity=SPARSITY, max_slots=slots,
                              max_seq=max_seq, device="cpu")
    ref, _ = TE.build_masked_reference_engine(
        ARCH, True, sparsity=SPARSITY, max_slots=slots, max_seq=max_seq,
        device="cpu")
    jeng, jlm = JE.build_engine(ARCH, True, compressed=compressed,
                                pruned=True, sparsity=SPARSITY,
                                max_slots=slots, max_seq=max_seq)
    prompts = JE.synthetic_prompts(jlm.cfg, lens)
    for e in (eng, ref, jeng):
        for p in prompts:
            e.submit(p, gen)
    out, want, jout = eng.run(), ref.run(), jeng.run()
    assert sorted(out) == sorted(want) == sorted(jout)
    for rid in want:
        np.testing.assert_array_equal(out[rid], want[rid],
                                      err_msg=f"request {rid}")
        np.testing.assert_array_equal(out[rid], jout[rid],
                                      err_msg=f"request {rid}")
    sp = eng.serving_meta["sparsity"]
    assert sp == jeng.serving_meta["sparsity"]
    blk = lambda e: TS.tree_bytes({k: v for k, v in e.params.items()
                                   if k.startswith("blocks.")})
    assert eng.kv_bytes() == ref.kv_bytes() // 2       # 1 of 2 kv groups
    assert blk(eng) <= blk(ref) * (1.0 - sp) + 2 ** 12
    assert eng.param_bytes() < ref.param_bytes()
    assert eng.serving_meta["kv_bytes"] == eng.kv_bytes()
    assert eng.param_bytes() == jeng.param_bytes()


def test_engine_pruned_slot_reuse_and_mixed_lengths():
    """Continuous batching on the slim shapes: per-slot positions,
    admission into freed slots, mixed budgets."""
    kw = dict(pruned=True, sparsity=SPARSITY, max_slots=1, max_seq=16,
              device="cpu")
    eng, lm = TE.build_engine(ARCH, True, **kw)
    alone, _ = TE.build_engine(ARCH, True, **kw)
    prompts = TE.synthetic_prompts(lm.cfg, [5, 3, 5])
    rid = alone.submit(prompts[2], 6)
    want = alone.run()[rid]
    for p, g in zip(prompts, (4, 6, 6)):
        eng.submit(p, g)
    out = eng.run()
    np.testing.assert_array_equal(out[2], want)
    assert eng.stats["evicted"] == 3


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_pruned_windows_match_steps_and_arenas_agree(arena):
    """At the ragged sparsity, `run()`'s decode windows (the body the card
    captures as graphs, run eagerly here) emit repeated `step()`'s tokens,
    and the paged arena's (bf16-free f32 pages) equal the contiguous
    arena's."""
    kw = dict(pruned=True, sparsity=RAGGED, compressed=True, max_slots=2,
              max_seq=24, device="cpu")
    if arena == "paged":
        kw.update(paged=True, page_size=8)
    windows, lm = TE.build_engine(ARCH, True, **kw)
    steps, _ = TE.build_engine(ARCH, True, **kw)
    contiguous, _ = TE.build_engine(
        ARCH, True, **{k: v for k, v in kw.items()
                       if k not in ("paged", "page_size")})
    prompts = TE.synthetic_prompts(lm.cfg, [5, 9, 3, 12])
    gens = (9, 5, 12, 3)
    for e in (windows, steps, contiguous):
        for p, g in zip(prompts, gens):
            e.submit(p, g)
    got, stepped, want = (windows.run(), steps._drain(steps.step),
                          contiguous.run())
    assert sorted(got) == sorted(stepped) == sorted(want) == list(range(4))
    for rid in want:
        np.testing.assert_array_equal(got[rid], stepped[rid])
        np.testing.assert_array_equal(got[rid], want[rid])
    assert windows.kv_pool_bytes() < TE.build_engine(
        ARCH, True, **{k: v for k, v in kw.items()
                       if k not in ("pruned", "sparsity")})[0].kv_pool_bytes()


def test_keep_masks_imply_pruned_and_report(models, capsys):
    """A mask dict passed to `build_engine` serves the sliced model (it
    would be worse to ignore it or prune under a dense label), and the
    report line names the realized sparsity."""
    *_, np_params = models
    lm = _tlm()
    params = lm.init(torch.Generator().manual_seed(0))
    _, masks = TS.resolve_keep_masks(lm, params, RAGGED)
    eng, elm = TE.build_engine(ARCH, True, keep_masks=masks, device="cpu",
                               max_seq=8, verbose=True)
    assert elm.slim_plan is not None
    assert eng.serving_meta["sparsity"] == pytest.approx(RAGGED, abs=0.02)
    assert "pruned to sparsity 0.30" in capsys.readouterr().out


def test_cli_pruned_smoke_on_cpu(capsys):
    """`--pruned` in --smoke mode asserts the masked-reference identity;
    stacked with --packed and with --paged it asserts those identities on
    the sliced shapes."""
    base = ["--smoke", "--prompt-lens", "5,3", "--gen", "4", "--slots", "2",
            "--device", "cpu", "--pruned", "--sparsity", "0.3"]
    TSV.main(base)
    assert "token-identical to the masked dense reference" in \
        capsys.readouterr().out
    TSV.main(base + ["--packed", "--bits", "4"])
    assert "(pruned @ 0.30)" in capsys.readouterr().out
    TSV.main(base + ["--paged", "--compressed"])
    assert "compressed+pruned@0.30" in capsys.readouterr().out


# ------------------------------------------------------------- satellites
def test_materialize_rejects_out_of_range_layout():
    """A mis-specified layout raises, naming family and member, instead of
    slicing the wrong elements."""
    w = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    fam = GroupFamily("bad.family", 4, [Member("w", 0, unit_size=2)])
    space = PruningSpace([fam])
    mask = torch.ones((4,))
    mask[0] = 0.0
    with pytest.raises(ValueError, match="bad.family.*w"):
        space.materialize({"w": w}, {"bad.family": mask})


def test_derive_slim_plan_validates_kept_units():
    """kept_units inconsistent with the sliced shapes is a hard error."""
    slim = _tlm()
    params = slim.init(torch.Generator().manual_seed(0))
    sliced, plan = TS.prune_lm(slim, params, sparsity=SPARSITY)
    bad = dict(plan.kept_units)
    fam = "blocks.0.attn.kv_groups"
    bad[fam] = bad[fam][:-1] if len(bad[fam]) > 1 else np.array([0, 1])
    with pytest.raises(ValueError, match="kv_groups"):
        TS.derive_slim_plan(slim, sliced, bad)


def test_member_view_matches_jax_on_interleaved_layouts():
    """Both member layouts reshape to (units, -1) as the reference's."""
    from repro.core.groups import Member as JMember
    from repro.core.groups import PruningSpace as JSpace
    arr = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    for layout in ("contiguous", "interleaved"):
        jm, tm = JMember("w", 1, 3, layout), Member("w", 1, 3, layout)
        np.testing.assert_array_equal(
            PruningSpace([]).member_view(torch.from_numpy(arr), tm, 4)
            .numpy(),
            np.asarray(JSpace([]).member_view(jnp.asarray(arr), jm, 4)))


# ------------------------------------ pruned cases of test_packed_serving
def _decode(lm, p, q, steps=4):
    """Greedy-free decode of a fixed token stream; (B, steps, V) logits."""
    caches = lm.init_cache(2, 8, dtype=torch.float32)
    toks = torch.from_numpy(_toks()[:, :steps]).long()
    outs = []
    for i in range(steps):
        lg, caches = lm.decode_step(p, q, caches, toks[:, i:i + 1], i)
        outs.append(lg)
    return torch.cat(outs, dim=1)


def test_packed_pruned_stacking_parity(models):
    """Sliced + packed, the whole GETA deployment artifact: the packed
    decode on pruned shapes matches the unpacked pruned decode (and the
    JAX package's), and the served bytes shrink twice over."""
    jlm, jparams, np_params = models
    lm_a, lm_b = _tlm(), _tlm()
    p_plain, q_plain, meta_plain = TS.prepare_serving(
        lm_a, _tparams(np_params), compressed=True, prune_sparsity=SPARSITY)
    p_packed, q_packed, meta_packed = TS.prepare_serving(
        lm_b, _tparams(np_params), packed=True, prune_sparsity=SPARSITY)
    assert meta_packed["sparsity"] == meta_plain["sparsity"] > 0.2
    assert meta_packed["param_bytes"] <= meta_plain["param_bytes"]
    want = _decode(lm_a, p_plain, q_plain)
    got = _decode(lm_b, p_packed, q_packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1).numpy())
    jlm_b = JLM(jlm.cfg)
    jp, jq, jmeta = JS.prepare_serving(jlm_b, dict(jparams), packed=True,
                                       prune_sparsity=SPARSITY)
    assert jmeta["param_bytes"] == meta_packed["param_bytes"]
    for k in jp:
        assert np.asarray(jp[k]).tobytes() == p_packed[k].numpy().tobytes()


def test_compression_report_explicit_zero_sparsity(models):
    """An explicit sparsity 0 ran the pruning path and says so; a
    compress-only meta claims no sparsity."""
    assert "pruned to sparsity 0.00" in TS.compression_report(
        "arch", {"sparsity": 0.0})
    *_, np_params = models
    lm, params = _tlm(), _tparams(np_params)
    subnet = TS.compress_lm(lm, params, lm.init_qparams(params))
    assert "sparsity" not in subnet.meta
    assert "pruned" not in TS.compression_report("arch", subnet.meta)
    assert TS.compression_report("arch", {"sparsity": 0.3}) == \
        JS.compression_report("arch", {"sparsity": 0.3})


def test_pruned_zero_sparsity_report_via_prepare_serving(models):
    """An all-keep pruning run still reports its 0.00 sparsity line beside
    the served bytes, as the reference's does."""
    jlm, jparams, np_params = models
    _, _, meta = TS.prepare_serving(_tlm(), _tparams(np_params),
                                    compressed=True, prune_sparsity=0.0)
    _, _, jmeta = JS.prepare_serving(JLM(jlm.cfg), dict(jparams),
                                     compressed=True, prune_sparsity=0.0)
    assert meta["sparsity"] == 0.0
    assert "pruned to sparsity 0.00" in TS.compression_report("arch", meta)
    assert meta["param_bytes"] == jmeta["param_bytes"]

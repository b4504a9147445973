"""The port's MoE family (grok-1, llama4) in pruned, compressed,
speculative and chunked serving, against the JAX package's.

The smoke configs are initialised by the JAX package (PRNGKey(0)) and
handed to the port as numpy (`LM.init` patched, helpers shared with
`tests/test_torch_moe_serving.py`); prompts are the JAX package's and
greedy tokens must be equal (f32).

- Pruned serving at sparsity 0.5 with the expert floor is held sliced
  against the JAX package's sliced engine: the masked model routes
  otherwise (a zeroed router column still takes softmax mass, DESIGN.md
  §4.7), so it is no oracle for an MoE.
- Speculative decoding with an MoE target and its own sliced, packed MoE
  draft (`test_speculative.py::test_speculative_token_identity_moe_
  target`: llama4, draft_k 4, s50 b4) and chunked prefill commit the
  plain engine's tokens: `verify_chunk` routes at full capacity, as the
  one-token decode steps it stands in for never drop a token.
- llama4's published two-position plan (`moe.every = 2`) through the
  paged, speculative and chunked engines against the JAX plain engine.
- Mirrors of `test_serving_compressed.py`'s MoE cases and of
  `test_slim_serving.py`'s skipped-sites and expert-floor tests; the MoE
  CLIs on the CPU.
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
from repro_torch.core.qadg import build_qadg
from repro_torch.core.subnet import tree_bytes
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TSV
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM as TLM
from test_torch_moe_serving import (ARCHS, LENS, MAX_SEQ,  # noqa: F401
                                    _assert_tokens, _drain, _jax,
                                    _np_params, _patch, _prompts,
                                    one_torch_thread)

LLAMA4 = "llama4-maverick-400b-a17b"
SPEC = dict(speculative=True, draft_k=4, draft_sparsity=0.5, draft_bits=4.0)


def _jplain(arch, lens=LENS):
    """The JAX plain engine's tokens for `arch` at `lens`."""
    def run():
        eng, _ = JE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ)
        return _drain(eng, _jprompts(arch, lens))
    return _jax(("plain", arch, tuple(lens)), run)


def _jprompts(arch, lens):
    return [np.asarray(p) for p in JE.synthetic_prompts(
        jget_arch(arch, smoke=True), list(lens))]


@pytest.mark.parametrize("arch", ARCHS)
def test_pruned_engine_matches_jax_sliced(monkeypatch, arch):
    """`pruned=True` at sparsity 0.5 with the expert floor
    (`default_min_keep`: never fewer experts than top_k): the slim plan's
    widths, bytes and tokens are the JAX package's sliced engine's."""
    _patch(monkeypatch, arch)
    kw = dict(pruned=True, sparsity=0.5)
    jeng, _ = JE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ, **kw)
    jplan = jeng.lm.slim_plan
    eng, lm = TE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                              device="cpu", **kw)
    plan = lm.slim_plan
    cfg = lm.cfg
    fields = ("d_model", "n_heads", "n_kv_heads", "d_head", "n_experts")
    assert [[getattr(s, f) for f in fields] for s in plan.layer_shapes] == \
        [[getattr(s, f) for f in fields] for s in jplan.layer_shapes]
    assert plan.sparsity == jplan.sparsity
    for j, (sub, shp) in enumerate(zip(lm.plan, plan.layer_shapes)):
        if sub.ffn != "moe":
            continue
        fam = f"blocks.{sub.j}.moe.experts"
        assert cfg.moe.top_k <= shp.n_experts < cfg.moe.n_experts
        assert len(plan.kept_units[fam]) == shp.n_experts
        np.testing.assert_array_equal(plan.kept_units[fam],
                                      jplan.kept_units[fam])
        w = eng.params[f"blocks.{sub.j}.moe.we_gate"]
        assert w.shape[1] == shp.n_experts
    full = TLM(cfg).init_cache(2, MAX_SEQ, dtype=torch.float32)
    assert tree_bytes(eng.caches) == tree_bytes(full) * \
        plan.layer_shapes[0].n_kv_heads // cfg.n_kv_heads
    assert eng.serving_meta["param_bytes"] == sum(
        int(np.prod(v.shape)) * v.dtype.itemsize
        for v in jeng.params.values())
    want = _drain(jeng, _prompts(arch))
    _assert_tokens(_drain(eng, _prompts(arch)), want, f"{arch} pruned")


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_moe_target_tokens(monkeypatch, arch):
    """An MoE target with its s50 b4 MoE draft, draft_k 4: the plain
    engine's tokens and the JAX package's (the mirror is llama4's)."""
    _patch(monkeypatch, arch)
    lens = [5, 3]
    want = _jplain(arch, lens)
    eng, lm = TE.build_engine(arch, True, max_slots=2, max_seq=MAX_SEQ,
                              device="cpu", **SPEC)
    assert any(s.ffn == "moe" for s in eng.draft.lm.plan)
    assert eng.draft.lm.slim_plan is not None
    _assert_tokens(_drain(eng, _jprompts(arch, lens)), want, f"{arch} spec")
    assert eng.stats["spec_steps"] > 0


def test_chunked_prefill_moe_tokens(monkeypatch):
    """llama4 prefilled 2 rows a chunk through `verify_chunk` at full
    capacity: the one-shot engine's tokens and the JAX package's."""
    _patch(monkeypatch, LLAMA4)
    lens = [5, 3]
    eng, _ = TE.build_engine(LLAMA4, True, max_slots=2, max_seq=MAX_SEQ,
                             device="cpu", prefill_chunk=2)
    got = _drain(eng, _jprompts(LLAMA4, lens))
    assert eng.stats["prefill_chunks"] > len(lens)
    _assert_tokens(got, _jplain(LLAMA4, lens), "chunked")


def _two(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            every=2))


@pytest.mark.parametrize("mode", ["paged", "speculative", "chunked"])
def test_two_position_plan_engines(mode):
    """llama4's published plan (a dense MLP at position 0, the MoE at 1)
    on the smoke widths: two KV arenas per engine (one per position), and
    the paged, speculative (an MoE draft of the same plan) and chunked
    engines' tokens equal the JAX plain engine's."""
    jlm = JLM(_two(jget_arch(LLAMA4, smoke=True)))
    prompts = _jprompts(LLAMA4, [5, 3, 9])

    def ref():
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        p, q, _ = JS.prepare_serving(jlm, jp)
        eng = JE.Engine(jlm, p, q, max_slots=2, max_seq=MAX_SEQ)
        return {k: np.asarray(v) for k, v in jp.items()}, _drain(eng, prompts)

    np_params, want = _jax(("two",), ref)
    lm = TLM(_two(get_arch(LLAMA4, smoke=True)))
    params = convert.params_from_numpy(np_params)
    p, q, _ = TS.prepare_serving(lm, params)
    kw = {}
    if mode == "paged":
        kw = dict(paged=True, page_size=4)
    elif mode == "chunked":
        kw = dict(scheduler=TE.ChunkedPrefillScheduler(chunk=2))
    else:
        from repro_torch.launch.speculative import DraftModel
        dlm = TLM(lm.cfg)
        dp, dq, meta = TS.prepare_serving(dlm, params, packed=True,
                                          bits_init=4.0, prune_sparsity=0.5)
        kw = dict(draft=DraftModel(dlm, dp, dq, meta), draft_k=4)
    eng = TE.Engine(lm, p, q, max_slots=2, max_seq=MAX_SEQ, **kw)
    assert {k.split(".")[1] for k in eng.caches} == {"0", "1"}
    _assert_tokens(_drain(eng, prompts), want, f"two-position {mode}")


# ------------------------------- mirrors of test_serving_compressed.py
def _f32_lm(arch):
    lm = TLM(get_arch(arch, smoke=True))
    params = convert.params_from_numpy(_np_params(arch))
    return lm, params, lm.init_qparams(params, bits_init=8.0)


def _decode(lm, params, qparams, steps=4, batch=2):
    caches = lm.init_cache(batch, 16, dtype=torch.float32)
    tok = torch.zeros((batch, 1), dtype=torch.int64)
    outs = []
    for p in range(steps):
        logits, caches = lm.decode_step(params, qparams, caches, tok, p)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        outs.append(logits)
    return torch.cat(outs, dim=1)


def test_construct_subnet_decode_parity_grok():
    """QADG -> keep-all construct_subnet -> servable decode equals the
    dense fake-quant decode within 2e-4: construct_subnet quantizes the
    expert einsum weights too, but the decode reads them dense, so
    servable_params must not emit their codes and residual_qparams must
    keep their fake-quant sites."""
    lm, params, qparams = _f32_lm("grok-1-314b")
    qadg = build_qadg(lm.build_graph().graph)
    subnet = TS.construct_subnet(qadg, params, qparams,
                                 qadg.space.init_masks())
    assert subnet.meta["sparsity"] == pytest.approx(0.0)
    assert "blocks.0.moe.we_gate" in subnet.int_weights
    sp = TS.servable_params(subnet)
    for name in subnet.int_weights:
        assert (name + ".codes" in sp) == (name not in sp)
    dense = _decode(lm, params, qparams)
    comp = _decode(lm, sp, TS.residual_qparams(subnet, qparams))
    torch.testing.assert_close(comp, dense, rtol=2e-4, atol=2e-4)


def test_compress_lm_nonrouted_component_not_dropped():
    """The reference asks `compress_lm(components=("attn", "mlp", "moe"))`;
    the port's compresses every component (it has no `components`), the
    MoE's included, so the same contract is held on its one form: the
    MoE einsum weights stay in the served dict, dense, with their
    fake-quant sites."""
    lm, params, qparams = _f32_lm("grok-1-314b")
    subnet = TS.compress_lm(lm, params, qparams)
    sp = TS.servable_params(subnet)
    moe_names = [n for n in params if ".moe." in n]
    assert moe_names
    for n in moe_names:
        assert n in sp and n + ".codes" not in sp
    rq = TS.residual_qparams(subnet, qparams)
    assert any(s.startswith(moe_names[0].rsplit(".", 1)[0]) for s in rq)
    assert torch.isfinite(_decode(lm, sp, rq, steps=2)).all()


@pytest.mark.parametrize("packed", [False, True])
def test_compress_lm_records_skipped_sites(packed):
    """The router and expert stacks stay dense (the decode runs them as
    plain products), are listed as skipped, equal the JAX package's list,
    and show in the report; the shared expert is compressed."""
    lm, params, qparams = _f32_lm(LLAMA4)
    subnet = TS.compress_lm(lm, params, qparams, packed=packed)
    skipped = subnet.meta["skipped_sites"]
    jlm = JLM(jget_arch(LLAMA4, smoke=True))
    jp = {k: jnp.asarray(v) for k, v in _np_params(LLAMA4).items()}
    jsub = JS.compress_lm(jlm, jp, jlm.init_qparams(jp), packed=packed)
    assert skipped == jsub.meta["skipped_sites"]
    assert skipped and all(".moe." in n and ".shared." not in n
                           for n in skipped)
    assert not any(n in subnet.int_weights for n in skipped)
    assert "blocks.0.moe.shared.w_gate" in subnet.int_weights
    assert sorted(subnet.int_weights) == sorted(jsub.int_weights)
    report = TS.compression_report(LLAMA4, subnet.meta)
    assert f"{len(skipped)} non-routed sites kept dense" in report


def test_moe_floor_keeps_top_k_experts():
    """Magnitude masks never prune the expert family below the router's
    top_k, and pick the JAX package's experts."""
    lm, params, _ = _f32_lm("grok-1-314b")
    qadg = build_qadg(lm.build_graph().graph)
    masks = TS.magnitude_keep_masks(qadg.space, params, 0.95,
                                    min_keep=TS.default_min_keep(lm.cfg))
    jlm = JLM(jget_arch("grok-1-314b", smoke=True))
    jp = {k: jnp.asarray(v) for k, v in _np_params("grok-1-314b").items()}
    jq = jbuild_qadg(jlm.build_graph().graph)
    jmasks = JS.magnitude_keep_masks(jq.space, jp, 0.95,
                                     min_keep=JS.default_min_keep(jlm.cfg))
    experts = [f for f in qadg.space.prunable_families()
               if f.kind == "expert"]
    assert experts
    for fam in experts:
        assert int(torch.sum(masks[fam.name])) == lm.cfg.moe.top_k
        np.testing.assert_array_equal(masks[fam.name].numpy(),
                                      np.asarray(jmasks[fam.name]))


def test_serve_and_train_clis_run_moe_on_cpu(capsys):
    TSV.main(["--arch", "grok-1-314b", "--smoke", "--prompt-lens", "5,3",
              "--gen", "4", "--slots", "2", "--device", "cpu"])
    assert "grok-1-314b [engine/dense on cpu]" in capsys.readouterr().out
    TSV.main(["--arch", LLAMA4, "--smoke", "--speculative", "--draft-k",
              "2", "--prompt-lens", "5,3", "--gen", "4", "--slots", "2",
              "--device", "cpu"])
    assert "token-identical" in capsys.readouterr().out
    TSV.main(["--arch", "grok-1-314b", "--smoke", "--pruned", "--prompt-lens",
              "5,3", "--gen", "4", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no masked-reference check" in out and "pruned@" in out
    T.main(["--arch", "grok-1-314b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "8", "--device", "cpu"])
    assert "trained 2 steps" in capsys.readouterr().out

"""The port's codebook LM (the audio family, musicgen) against the JAX
package's: the (C, Vp, D) embedding summed over codebooks, the untied
(D, C * Vp) head giving one distribution per codebook, and every path the
JAX package runs them on.

musicgen's smoke config (2 layers, d_model 128, 4 MHA heads, 4 codebooks
of vocab 128, f32) is initialised by the JAX package (PRNGKey(0)); its
params cross to the port as numpy through `convert`, and `LM.init` is
patched to hand them over where an entry point draws its own. Each
reference result runs once per module (`_jax`). Tolerances: logits and
the loss within 1e-5 of the largest magnitude (f32 sums in another
order), gradients within 1e-4 of each tensor's largest and quantizer
gradients within 1e-4 relative (the port's other gradient tests'), a GETA
step at `train.STEP_TOLERANCES` with identical masks, tokens identical.

- Params, their shapes and the JAX axes' ranks; the weights crossed.
- `_embed_tokens`, `forward`, `loss`; `loss_and_grads` at 16 bits.
- One GETA step per stage (warm-up, projection, two joint, cool-down)
  from the reference's state (`check_geta_step`: where the reference's
  own step is sensitive, the port is held to its one-ulp witness).
- `prefill` and `decode_step` logits.
- `serve_loop` tokens (frames of C tokens) in dense, compressed, packed
  b4 and pruned (0.3) modes; the compressed head's codes.
- QADG (families, members, sites) and `derive_slim_plan` identical.
- `verify_chunk`'s and the engine's refusals, with the reference's
  messages; the CLI's switch to the static loop.

`tests/test_torch_vision.py` imports the helpers for internvl2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import CompressionConfig as JComp
from repro.core import subnet as JS
from repro.core.qadg import build_qadg as jbuild_qadg
from repro.data.synthetic import batch_for as jbatch_for
from repro.launch import engine as JE
from repro.launch import train as JT
from repro.launch.serve import serve_loop as jserve_loop
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import CompressionConfig, get_arch
from repro_torch.core import subnet as TS
from repro_torch.core.qadg import build_qadg
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TSV
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM

ARCH = "musicgen-large"
TOL = 1e-5
SCHED = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
             projection_steps=1, pruning_periods=2, pruning_steps=1,
             cooldown_steps=1)
MODES = {"dense": {}, "compressed": dict(compressed=True),
         "packed_b4": dict(compressed=True, packed=True, bits_init=4.0),
         "pruned": dict(pruned=True, sparsity=0.3)}

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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmodel(arch):
    """(JAX LM, its PRNGKey(0) params, their axes, the params as numpy)."""
    def init():
        jlm = JLM(jget_arch(arch, smoke=True))
        jp, axes = jlm.init(jax.random.PRNGKey(0))
        return jlm, jp, axes, _np(jp)
    return _jax(("model", arch), init)


def _tparams(arch):
    return convert.params_from_numpy(_jmodel(arch)[3])


def _batch_np(arch, step=0, batch=2, seq=16):
    """The JAX package's `batch_for` as numpy (int64 tokens)."""
    b = _np(jbatch_for(jget_arch(arch, smoke=True), 0, step, batch, seq))
    b["tokens"] = b["tokens"].astype(np.int64)
    return b


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close(got, want, what="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _patch(monkeypatch, arch):
    """The port's `LM.init` hands over the JAX package's PRNGKey(0)
    params of `arch`."""
    np_params = _jmodel(arch)[3]
    monkeypatch.setattr(LM, "init", lambda self, gen: convert.
                        params_from_numpy(np_params, device=gen.device))


def forward_and_loss(arch):
    """The reference's logits and loss on `_batch_np(arch)` (16-bit
    quantizers), and its gradients."""
    def run():
        jlm, jp, _, _ = _jmodel(arch)
        jq = jlm.init_qparams(jp, bits_init=16.0)
        b = jbatch_for(jlm.cfg, 0, 0, 2, 16)
        logits = jax.jit(jlm.forward)(jp, jq, b["tokens"],
                                      b.get("vision_embeds"))
        jl, (jgx, jgq) = jax.jit(jax.value_and_grad(
            jlm.loss, argnums=(0, 1)))(jp, jq, b)
        return (np.asarray(logits), float(jl), _np(jgx),
                {k: tuple(np.asarray(t) for t in (v.d, v.q_m, v.t))
                 for k, v in jgq.items()},
                {k: tuple(np.asarray(t) for t in (v.d, v.q_m, v.t))
                 for k, v in jq.items()})
    return _jax(("loss", arch), run)


def check_forward_loss_and_grads(arch):
    logits, jl, jgx, jgq, jq = forward_and_loss(arch)
    lm = LM(get_arch(arch, smoke=True))
    tp, tq = _tparams(arch), convert.qparams_from_numpy(jq)
    batch = _tbatch(_batch_np(arch))
    _close(lm.forward(tp, tq, batch["tokens"], batch.get("vision_embeds")),
           logits, "logits")
    loss, gx, gq = T.loss_and_grads(lm, tp, tq, batch)
    assert float(loss) == pytest.approx(jl, rel=TOL)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    for k, w in jgx.items():
        _close(gx[k], w, k, tol=1e-4)
    for k, w in jgq.items():
        for f, wf in zip(("d", "q_m", "t"), w):
            assert float(getattr(gq[k], f)) == pytest.approx(
                float(wf), rel=1e-4, abs=1e-12), (k, f)
    return logits


def _jstep(arch):
    """The reference's jitted GETA step under SCHED (compiled once)."""
    def run():
        jlm = _jmodel(arch)[0]
        _, qasso = JT.build_geta(jlm, JComp(**SCHED), lr=3e-3)
        return qasso, jax.jit(JT.make_geta_train_step(jlm, qasso))
    return _jax(("jstep", arch), run)


def geta_trajectory(arch):
    """The reference's five GETA steps through every stage (16-bit init)
    on `batch_for` batches: (state before, state after, batch, stage)."""
    def run():
        jlm, jp, _, _ = _jmodel(arch)
        qasso, step = _jstep(arch)
        params, qparams = jp, jlm.init_qparams(jp, bits_init=16.0)
        state = qasso.init(params, qparams)
        traj = []
        for i in range(qasso.cfg.total_steps):
            batch = jbatch_for(jlm.cfg, 0, i, 2, 16)
            before = (_np(params), _np(qparams), _np(state))
            params, qparams, state, m = step(params, qparams, state, batch)
            traj.append((before, (_np(params), _np(qparams), _np(state),
                                  {"loss": float(m["loss"])}),
                         _np(batch), int(m["stage"])))
        return traj
    return _jax(("geta", arch), run)


def step_witness(arch, i):
    """How far the reference's own step i moves when every weight moves
    by one ulp, the largest of three draws: the params' largest gap
    relative to each tensor's max, and each weight site's d relative."""
    def run():
        step = _jstep(arch)[1]
        before, after, batch, _ = geta_trajectory(arch)[i]
        to_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
        params, d = 0.0, {k: 0.0 for k in after[1]}
        for draw in range(3):
            rng = np.random.default_rng(draw)
            moved = {}
            for k, v in before[0].items():
                way = rng.choice([-np.inf, np.inf], v.shape).astype(v.dtype)
                moved[k] = np.nextafter(v, way)
            gp, gq = step(to_j(moved), to_j(before[1]), to_j(before[2]),
                          to_j(batch))[:2]
            params = max(params, max(
                float(np.abs(np.asarray(gp[k]) - w).max() / np.abs(w).max())
                for k, w in after[0].items()))
            for k, w in after[1].items():
                d[k] = max(d[k], abs(float(gq[k].d) - float(w.d))
                           / abs(float(w.d)))
        return params, d
    return _jax(("witness", arch, i), run)


def check_geta_step(arch, i):
    """Step i from the reference's state before it, with identical masks
    and the loss, q_m and t at STEP_TOLERANCES; the params and each
    site's d at STEP_TOLERANCES or, where the reference's own step moves
    more under a one-ulp move of every weight (`step_witness`), within 4x
    that witness. Two places need it: the first joint step (the
    partition is computed and the redundant groups start their
    projection), where the witness moves the params by ~1e-3 of their
    max, and the projection step after a warm-up that left a site's d at
    its 1e-8 floor, where Eq 17 moves d by up to ~1.5x in the witness."""
    before, after, batch, stage = geta_trajectory(arch)[i]
    assert stage == [0, 1, 2, 2, 3][i]
    lm = LM(get_arch(arch, smoke=True))
    _, qasso = T.build_geta(lm, CompressionConfig(**SCHED), lr=3e-3)
    p, q, s = convert.geta_state_from_numpy(*before)
    batch = dict(batch, tokens=batch["tokens"].astype(np.int64))
    got = T.make_geta_train_step(lm, qasso)(p, q, s, _tbatch(batch))
    assert got[3]["stage"] == stage
    want = (*convert.geta_state_from_numpy(*after[:3]), after[3])
    diff = T.step_differences(want, got)
    assert diff.pop("masks")
    diff.pop("d")
    w_params, w_d = step_witness(arch, i)
    tol = dict(T.STEP_TOLERANCES, params=max(T.STEP_TOLERANCES["params"],
                                             4 * w_params))
    for k, v in diff.items():
        assert v <= tol[k], (k, v, tol[k])
    for site in qasso.weight_sites:
        a, b = float(got[1][site.name].d), float(want[1][site.name].d)
        bound = max(T.STEP_TOLERANCES["d"], 4 * w_d[site.name])
        assert abs(a - b) <= bound * abs(b), (site.name, a, b, bound)


def qadg_key(qadg):
    fams = [(f.name, f.units, [(m.param, m.axis, m.unit_size, m.layout)
                               for m in f.members], f.prunable, f.kind)
            for f in qadg.space.families]
    return (fams, [tuple(vars(s).values()) for s in qadg.sites],
            sorted(qadg.graph.vertices), qadg.space.total_units())


def check_qadg_and_slim_plan(arch):
    jlm, jp, _, _ = _jmodel(arch)
    for aq in (False, True):
        want = jbuild_qadg(jlm.build_graph(act_quant=aq).graph)
        got = build_qadg(LM(get_arch(arch, smoke=True))
                         .build_graph(act_quant=aq).graph)
        assert qadg_key(got) == qadg_key(want)
    _, jplan = JS.prune_lm(JLM(jlm.cfg), dict(jp), sparsity=0.3)
    slim = LM(get_arch(arch, smoke=True))
    _, plan = TS.prune_lm(slim, _tparams(arch), sparsity=0.3)
    fields = list(dataclasses.asdict(plan.layer_shapes[0]))
    assert [dataclasses.asdict(s) for s in plan.layer_shapes] == [
        {f: getattr(s, f) for f in fields} for s in jplan.layer_shapes]
    assert plan.sparsity == jplan.sparsity
    assert sorted(plan.kept_units) == sorted(jplan.kept_units)
    for k, v in jplan.kept_units.items():
        np.testing.assert_array_equal(plan.kept_units[k], np.asarray(v))
    return plan


def serve_tokens(arch, mode, prompts, monkeypatch, gen=6):
    """(JAX serve_loop tokens, the port's) on the same weights and
    prompts."""
    kw = MODES[mode]
    want = _jax(("serve", arch, mode), lambda: np.asarray(jserve_loop(
        arch, True, prompts.shape[0], prompts.shape[1], gen, prompts=prompts,
        verbose=False, **kw)))
    _patch(monkeypatch, arch)
    got = TSV.serve_loop(arch, True, prompts.shape[0], prompts.shape[1], gen,
                         prompts=prompts, verbose=False, device="cpu", **kw)
    return want, got


# ----------------------------------------------------------------- params
def test_params_axes_and_convert():
    """The port draws the reference's shapes ((C, Vp, D) embedding, (D,
    C * Vp) head); the JAX axes name each dim; `convert` carries both
    across bit for bit, generic by key."""
    jlm, jp, axes, np_params = _jmodel(ARCH)
    cfg = get_arch(ARCH, smoke=True)
    C, Vp, D = cfg.num_codebooks, cfg.vocab_padded, cfg.d_model
    tp = LM(cfg).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert tp["embed"].shape == (C, Vp, D) and tp["head"].shape == (D, C * Vp)
    assert all(len(axes[k]) == v.ndim for k, v in jp.items())
    assert axes["embed"] == ("codebooks", "vocab", "embed")
    crossed = convert.params_from_numpy(np_params)
    for k in ("embed", "head"):
        assert crossed[k].numpy().tobytes() == np_params[k].tobytes()
    assert LM(cfg).quant_weight_names()[-1] == jlm.quant_weight_names()[-1] \
        == "head"


def test_embed_tokens_forward_and_loss_match_jax():
    jlm, jp, _, _ = _jmodel(ARCH)
    lm = LM(get_arch(ARCH, smoke=True))
    tokens = _batch_np(ARCH)["tokens"]
    assert tokens.shape == (2, 16, 4)
    want = np.asarray(jlm._embed_tokens(jp, jnp.asarray(tokens)))
    _close(lm._embed_tokens(_tparams(ARCH), torch.from_numpy(tokens)), want,
           "embed")
    logits = check_forward_loss_and_grads(ARCH)
    assert logits.shape == (2, 16, 4, lm.cfg.vocab_padded)


@pytest.mark.parametrize("i", range(5))
def test_geta_step_per_stage_matches_jax(i):
    check_geta_step(ARCH, i)


# ---------------------------------------------------------------- serving
def test_prefill_and_decode_logits_match_jax():
    """An 8-frame prefill, then 4 decode steps of (2, 1, 4) frames: each
    step's (2, 1, 4, Vp) logits against the reference's."""
    jlm, jp, _, _ = _jmodel(ARCH)
    toks = _batch_np(ARCH, step=3, seq=12)["tokens"]

    def ref():
        jc = jlm.init_cache(2, 16, dtype=jnp.float32)
        lg, jc = jax.jit(jlm.prefill)(jp, None, jc, jnp.asarray(toks[:, :8]))
        out = [np.asarray(lg)]
        step = jax.jit(jlm.decode_step)
        for p in range(8, 12):
            lg, jc = step(jp, None, jc, jnp.asarray(toks[:, p:p + 1]),
                          jnp.int32(p))
            out.append(np.asarray(lg))
        return out

    want = _jax("prefill", ref)
    lm = LM(get_arch(ARCH, smoke=True))
    tp, tt = _tparams(ARCH), torch.from_numpy(toks)
    cache = lm.init_cache(2, 16, dtype=torch.float32)
    got = [lm.prefill(tp, None, cache, tt[:, :8])[0]]
    got += [lm.decode_step(tp, None, cache, tt[:, p:p + 1], p)[0]
            for p in range(8, 12)]
    assert got[1].shape == (2, 1, 4, lm.cfg.vocab_padded)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"logits {i}")


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_loop_tokens_match_jax(mode, monkeypatch):
    """The static loop on (2, 5, 4) prompt frames, 6 frames generated:
    the reference's tokens in every weight mode and pruned at 0.3."""
    prompts = _batch_np(ARCH, step=1, seq=5)["tokens"].astype(np.int32)
    want, got = serve_tokens(ARCH, mode, prompts, monkeypatch)
    assert got.shape == want.shape == (2, 6, 4)
    np.testing.assert_array_equal(got, want)


def test_compressed_head_codes_match_jax():
    """The (D, C * Vp) head is a routed site: int8 codes and scales
    bit-equal to the reference's."""
    jlm, jp, _, _ = _jmodel(ARCH)
    jserved, _, _ = JS.prepare_serving(jlm, jp, compressed=True)
    tserved, _, _ = TS.prepare_serving(LM(get_arch(ARCH, smoke=True)),
                                       _tparams(ARCH), compressed=True)
    for k in ("head.codes", "head.scale"):
        assert tserved[k].numpy().tobytes() == np.asarray(
            jserved[k]).tobytes(), k


def test_qadg_and_slim_plan_match_jax():
    plan = check_qadg_and_slim_plan(ARCH)
    assert plan.layer_shapes[0].d_ff < get_arch(ARCH, smoke=True).d_ff


def test_refusals_carry_the_reference_messages():
    jlm, jp, _, _ = _jmodel(ARCH)
    lm = LM(get_arch(ARCH, smoke=True))
    tp = _tparams(ARCH)
    cache = lm.init_cache(1, 8, dtype=torch.float32)
    tok = torch.zeros((1, 2, 4), dtype=torch.int64)
    with pytest.raises(ValueError) as want:
        jlm.verify_chunk(jp, None, jlm.init_cache(1, 8), jnp.zeros(
            (1, 2, 4), jnp.int32), jnp.zeros((1,), jnp.int32))
    with pytest.raises(ValueError) as got:
        lm.verify_chunk(tp, None, cache, tok, 0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JE.Engine(jlm, jp, None)
    with pytest.raises(ValueError) as got:
        TE.Engine(lm, tp, None)
    assert str(got.value) == str(want.value)


def test_cli_switches_to_the_static_loop(capsys):
    TSV.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen", "3",
              "--prompt-len", "4", "--packed", "--bits", "4"])
    out = capsys.readouterr().out
    assert "serving through the static loop" in out
    assert "[static/compressed+packed on cpu]" in out

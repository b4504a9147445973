"""The port's MoE family (grok-1, llama4) against the JAX package's: the
MoE layer, the LM built on it and its QADG (the GETA step:
`tests/test_torch_moe_train.py`).

Both archs' smoke configs (2 layers, d_model 128, f32; grok 4 experts
top-2, llama4 8 experts top-1 with a shared expert) are initialised by
the JAX package and cross to the port as numpy; inputs come from numpy
seeds, and each reference result is computed once per module (`_jax`).

- `moe_apply` agrees with the reference's within 1e-5 at capacity (where
  capacity binds: a dropped (token, k) moves the output by the whole
  expert output, so the agreement pins the same drops), at full capacity,
  with exact router ties (the lower expert first, as `jax.lax.top_k`
  orders them), at a sliced expert count, and raises the same error below
  top_k.
- The LM's params, quantizer sites, layer plan and QADG (families,
  members, units, sites; smoke and FULL configs, graph only) are the
  reference's; the loss within 1e-5 relative, every gradient within 1e-4
  of its max, every quantizer's (d, q_m, t) gradient within 1e-4 relative.
  One exception, of the reference's own making: with top_k = 1 (llama4)
  the renormalised gate is p / p = 1, so the router's true gradient is
  zero and both packages' router gradients are rounding noise (~5e-9
  against ~0.1 for the other weights); they are held below 1e-6 of the
  layer's largest gradient instead.
- Mirrors of `test_arch_smoke.py`'s decode smoke test and its decode-vs-forward parity (capacity factor 8, so the
  forward drops no token), and of `test_qadg.py`'s all-families check;
  the decode smoke test and the all-families check also take the audio
  and vlm archs (`FRONTEND_ARCHS`), whose cases of the reference's tests
  they mirror.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_arch as jget_arch
from repro.core.qadg import build_qadg as jbuild_qadg
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import layers as JL
from repro.models.transformer import LM as JLM
from repro.models.transformer import layer_plan as jlayer_plan
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core.qadg import build_qadg
from repro_torch.data.synthetic import batch_for, lm_batch
from repro_torch.launch import train as T
from repro_torch.models import layers as TL
from repro_torch.models.transformer import LM, layer_plan

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
# the modality-frontend archs, whose cases of the reference's all-family
# smoke tests are mirrored here beside the MoE ones
FRONTEND_ARCHS = ["musicgen-large", "internvl2-26b"]
PRE = "blocks.0.moe"

_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny ops: one intra-op thread each, so parallel suite workers do
    not oversubscribe the cores."""
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


def _q_np(jq):
    return {k: (np.asarray(v.d), np.asarray(v.q_m), np.asarray(v.t))
            for k, v in jq.items()}


def _jmodel(arch):
    """(JAX LM, its PRNGKey(0) params, the same params as numpy)."""
    def init():
        jlm = JLM(jget_arch(arch, smoke=True))
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        return jlm, jp, _np(jp)
    return _jax(("model", arch), init)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items() if k.startswith("blocks.")}


def _x(n=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, n, 128)).astype(np.float32)


# --------------------------------------------------------------- moe_apply
def _sliced(np_params, keep):
    """The MoE weights of layer 0 kept to experts `keep`."""
    lp = _layer(np_params)
    lp[f"{PRE}.router"] = lp[f"{PRE}.router"][:, keep]
    for w in ("we_gate", "we_up", "we_down"):
        lp[f"{PRE}.{w}"] = lp[f"{PRE}.{w}"][keep]
    return lp


def _cases(arch, np_params):
    """case -> (layer-0 params, full_capacity, n_experts or None)."""
    lp = _layer(np_params)
    tied = dict(lp)
    tied[f"{PRE}.router"] = np.zeros_like(lp[f"{PRE}.router"])
    return {"capacity": (lp, False, None), "full_capacity": (lp, True, None),
            "ties": (tied, False, None), "ties_full": (tied, True, None),
            "sliced": (_sliced(np_params, [0, 2, 3]), False, 3)}


def _moe_pair(arch, case):
    jlm, _, np_params = _jmodel(arch)
    lp, full, n_exp = _cases(arch, np_params)[case]
    cfg = get_arch(arch, smoke=True)
    x = _x()

    def ref():
        shp = None if n_exp is None else dataclasses.replace(
            JL.LayerShapes.from_config(jlm.cfg), n_experts=n_exp)
        return np.asarray(JL.moe_apply(
            {k: jnp.asarray(v) for k, v in lp.items()}, None, jlm.cfg,
            jnp.asarray(x), prefix=PRE, full_capacity=full, shapes=shp))

    shp = None if n_exp is None else dataclasses.replace(
        TL.LayerShapes.from_config(cfg), n_experts=n_exp)
    got = TL.moe_apply(params_from_numpy(lp), None, cfg, torch.from_numpy(x),
                       prefix=PRE, full_capacity=full, shapes=shp)
    return _jax(("moe", arch, case), ref), got.numpy(), lp, x, full


def _dropped(arch, lp, x, full):
    """(token, k) assignments the capacity drops, from the port's routing
    (the test's own count, independent of the outputs compared)."""
    cfg = get_arch(arch, smoke=True)
    E, K = lp[f"{PRE}.router"].shape[-1], cfg.moe.top_k
    n = x.shape[1]
    C = n * K if full else max(int(cfg.moe.capacity_factor * n * K / E), 4)
    probs = torch.softmax(torch.from_numpy(x @ lp[f"{PRE}.router"]), -1)
    _, idx = TL.top_k(probs, K)
    counts = [np.bincount(row.reshape(-1), minlength=E)
              for row in idx.numpy()]
    return sum(int(np.clip(c - C, 0, None).sum()) for c in counts)


@pytest.mark.parametrize("case", ["capacity", "full_capacity", "ties",
                                  "ties_full", "sliced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, case):
    want, got, lp, x, full = _moe_pair(arch, case)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    drops = _dropped(arch, lp, x, full)
    if case in ("capacity", "ties"):
        assert drops > 0          # the case exercises the capacity drop
    if full:
        assert drops == 0


def test_top_k_orders_ties_by_index():
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = TL.top_k(p, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3]]
    assert vals.tolist() == np.asarray(jv).tolist()


def test_one_hot_gives_zero_rows_past_its_width():
    idx = torch.tensor([0, 3, 4, 9], dtype=torch.int32)
    got = TL.one_hot(idx, 4, torch.float32)
    want = jax.nn.one_hot(jnp.asarray(idx.numpy()), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2:].sum() == 0


def test_moe_below_top_k_raises_like_jax():
    jlm, _, np_params = _jmodel("grok-1-314b")
    lp = _sliced(np_params, [1])
    cfg = get_arch("grok-1-314b", smoke=True)
    shp = dataclasses.replace(TL.LayerShapes.from_config(cfg), n_experts=1)
    jshp = dataclasses.replace(JL.LayerShapes.from_config(jlm.cfg),
                               n_experts=1)
    with pytest.raises(ValueError, match="top_k") as ei:
        TL.moe_apply(params_from_numpy(lp), None, cfg,
                     torch.from_numpy(_x()), prefix=PRE, shapes=shp)
    with pytest.raises(ValueError) as ej:
        JL.moe_apply({k: jnp.asarray(v) for k, v in lp.items()}, None,
                     jlm.cfg, jnp.asarray(_x()), prefix=PRE, shapes=jshp)
    assert str(ei.value) == str(ej.value)


# ------------------------------------------------------------------ the LM
@pytest.mark.parametrize("smoke", [True, False])
def test_layer_plan_matches_jax_for_every_arch(smoke):
    for arch in ASSIGNED_ARCHS:
        jplan, jn = jlayer_plan(jget_arch(arch, smoke=smoke))
        plan, n = layer_plan(get_arch(arch, smoke=smoke))
        assert n == jn, arch
        assert [vars(s) for s in plan] == [vars(s) for s in jplan], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keys_shapes_and_sites_match_jax(arch):
    jlm, _, np_params = _jmodel(arch)
    lm = LM(get_arch(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in np_params.items()}
    assert {k: str(v.dtype).removeprefix("torch.")
            for k, v in params.items()} == \
        {k: str(v.dtype) for k, v in np_params.items()}
    assert lm.quant_weight_names() == jlm.quant_weight_names()
    assert lm.act_site_names() == jlm.act_site_names()
    assert [vars(s) for s in lm.plan] == [vars(s) for s in jlm.plan]
    assert lm.n_blocks == jlm.n_blocks
    assert lm.shapes[0].n_experts == lm.cfg.moe.n_experts
    if lm.cfg.moe.shared_expert:
        assert f"{PRE}.shared.w_gate" in params
    jq = jlm.init_qparams(_jmodel(arch)[1], act_quant=True)
    got = lm.init_qparams(params_from_numpy(np_params), act_quant=True)
    assert list(got) == list(jq)
    for k, v in jq.items():
        for f in ("d", "q_m", "t"):
            assert getattr(got[k], f).numpy().tobytes() == \
                np.asarray(getattr(v, f)).tobytes(), (k, f)


def _grads_ref(arch, bits):
    def run():
        jlm, jp, _ = _jmodel(arch)
        jq = jlm.init_qparams(jp, bits_init=bits)
        jb = jlm_batch(0, 0, 2, 16, jlm.cfg.vocab)
        logits = jlm.forward(jp, jq, jb["tokens"])
        jl, (jgx, jgq) = jax.value_and_grad(jlm.loss, argnums=(0, 1))(
            jp, jq, jb)
        return (np.asarray(logits), float(jl), _np(jgx),
                {k: _q_np({k: v})[k] for k, v in jgq.items()}, _q_np(jq),
                np.asarray(jb["tokens"]).astype(np.int64))
    return _jax(("grads", arch, bits), run)


def _router_is_noise(arch, name):
    """With top_k = 1 the renormalised gate is p / p = 1: the router (and
    its quantizer) has no true gradient, only rounding noise."""
    return get_arch(arch, smoke=True).moe.top_k == 1 and ".router" in name


@pytest.mark.parametrize("bits", [8.0, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, bits):
    logits, jl, jgx, jgq, jq, tokens = _grads_ref(arch, bits)
    lm = LM(get_arch(arch, smoke=True))
    tp = params_from_numpy(_jmodel(arch)[2])
    tq = qparams_from_numpy(jq)
    got = lm.forward(tp, tq, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), logits, rtol=0,
                               atol=1e-5 * np.abs(logits).max())
    loss, gx, gq = T.loss_and_grads(lm, tp, tq,
                                    {"tokens": torch.from_numpy(tokens)})
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    layer_max = max(float(np.abs(v).max()) for k, v in jgx.items()
                    if k.startswith(PRE))
    for k, want in jgx.items():
        g = gx[k].numpy()
        if _router_is_noise(arch, k):
            assert max(np.abs(g).max(), np.abs(want).max()) \
                <= 1e-6 * layer_max, k
            continue
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    for k, want in jgq.items():
        for f, w in zip(("d", "q_m", "t"), want):
            g = float(getattr(gq[k], f))
            if _router_is_noise(arch, k):
                # the site's sums of a noise gradient: noise themselves
                assert abs(g) <= 1e-6 and abs(float(w)) <= 1e-6, (k, f)
                continue
            assert g == pytest.approx(float(w), rel=1e-4, abs=1e-12), (k, f)
    moe_sites = [k for k in gq if ".moe." in k]
    assert moe_sites and all(f"{PRE}.{w}.wq" in gq for w in
                             ("router", "we_gate", "we_up", "we_down"))


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_qadg_identical_to_jax(arch, smoke, act_quant):
    want = jbuild_qadg(JLM(jget_arch(arch, smoke=smoke))
                       .build_graph(act_quant=act_quant).graph)
    got = build_qadg(LM(get_arch(arch, smoke=smoke))
                     .build_graph(act_quant=act_quant).graph)
    key = lambda space: [(f.name, f.units, [(m.param, m.axis, m.unit_size,
                                             m.layout) for m in f.members],
                          f.prunable, f.kind) for f in space.families]
    assert key(got.space) == key(want.space)
    assert [tuple(vars(s).values()) for s in got.sites] == \
        [tuple(vars(s).values()) for s in want.sites]
    assert sorted(got.graph.vertices) == sorted(want.graph.vertices)
    assert got.space.total_units() == want.space.total_units() > 0
    experts = [f for f in got.space.families if f.kind == "expert"]
    cfg = get_arch(arch, smoke=smoke)
    n_moe = sum(s.ffn == "moe" for s in layer_plan(cfg)[0])
    assert len(experts) == n_moe and all(
        f.units == cfg.moe.n_experts for f in experts)


# -------------------------------------------- mirrors of test_arch_smoke.py
@pytest.mark.parametrize("arch", ARCHS + FRONTEND_ARCHS)
def test_smoke_decode_step(arch):
    cfg = get_arch(arch, smoke=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    caches = lm.init_cache(2, 32, dtype=torch.float32)
    shapes = {k: v.shape for k, v in caches.items()}
    tok_shape = (2, 1, cfg.num_codebooks) if cfg.num_codebooks else (2, 1)
    logits, caches2 = lm.decode_step(params, None, caches,
                                     torch.zeros(tok_shape,
                                                 dtype=torch.int64), 0)
    assert logits.shape[0] == 2 and torch.isfinite(logits).all()
    assert {k: v.shape for k, v in caches2.items()} == shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the teacher-forced forward (no
    quant) when the forward drops no token: capacity factor 8, as the
    reference's hybrid test raises it."""
    cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    lm = LM(cfg)
    params = params_from_numpy(_jmodel(arch)[2])
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 8)))
    full = lm.forward(params, None, toks)
    caches = lm.init_cache(1, 16, dtype=torch.float32)
    outs = []
    for p in range(8):
        lg, caches = lm.decode_step(params, None, caches, toks[:, p:p + 1], p)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS + FRONTEND_ARCHS)
def test_lm_graph_families_valid(arch):
    """`test_qadg.py::test_lm_graph_all_families_valid` for the MoE archs
    on the port's own params."""
    lm = LM(get_arch(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    qadg = build_qadg(lm.build_graph(act_quant=True).graph)
    qadg.space.validate(params)
    assert len(qadg.sites) > 0
    assert qadg.space.total_units() > 0


def test_batch_for_serves_the_moe_family():
    """`batch_for` gives the MoE family the LM stream, and dispatches the
    audio family to codebook frames and the vlm family to `vlm_batch`
    (text of seq - vision_patches tokens and the patch embeddings)."""
    cfg = get_arch("grok-1-314b", smoke=True)
    b = batch_for(cfg, 3, 1, 2, 8)
    assert torch.equal(b["tokens"], lm_batch(3, 1, 2, 8, cfg.vocab)["tokens"])
    audio = get_arch("musicgen-large", smoke=True)
    assert torch.equal(batch_for(audio, 3, 1, 2, 8)["tokens"], lm_batch(
        3, 1, 2, 8, audio.vocab, n_codebooks=audio.num_codebooks)["tokens"])
    vlm = get_arch("internvl2-26b", smoke=True)
    v = batch_for(vlm, 3, 1, 2, 12)
    assert sorted(v) == ["tokens", "vision_embeds"]
    assert v["tokens"].shape == (2, 12 - vlm.vision_patches)

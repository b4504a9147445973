"""The port's recurrent mixers (rwkv6's time-mix and channel-mix, mamba in
jamba's hybrid plan) against the JAX package's: the scans and applies,
the LM built on them, its quantizer sites, caches and QADG (training:
`tests/test_torch_recurrent_train.py`; serving:
`tests/test_torch_recurrent_serving.py`).

Both smoke configs (f32; rwkv6 2 layers, d_model 128, 4 heads of 32, d_ff
448, decay LoRA 8; jamba 4 layers, attention then mamba (Di 256, d_state
8, d_conv 4, dt_rank 8) with MLP then MoE) are initialised by the JAX
package (PRNGKey(0)) and cross to the port as numpy; inputs come from
numpy seeds, and each reference result is computed once per module
(`_jax`). Where a case needs several chunks at a short S, both packages
run a copy of the config with chunk 4 (`_cfg`).

- The scans (`_wkv_scan`, `_mamba_chunk_scan`), the applies and
  `groupnorm_heads` / `_token_shift` agree with the reference within 1e-5
  of the output's largest magnitude, at S = 1, S < chunk and 3 chunks,
  from zero state and from a given one, and at sliced widths. mamba's
  in-chunk `associative_scan` is a sequential recurrence in the port: the
  same function, rounded otherwise; the tolerance covers it.
- A sequence longer than a chunk and not a multiple of it raises
  `ValueError` naming S and the chunk (the reference asserts).
- The LM's params, quantizer sites, caches, layer plan and QADG are the
  reference's.
- Mirrors of `test_arch_smoke.py`'s decode smoke test and
  decode-vs-forward parities for both archs, and of
  `test_qadg.py::test_lm_graph_all_families_valid`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.qadg import build_qadg as jbuild_qadg
from repro.models import layers as JL
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.qadg import build_qadg
from repro_torch.models import layers as TL
from repro_torch.models.transformer import LM, layer_plan

ARCHS = ["rwkv6-3b", "jamba-1.5-large-398b"]
RW, MB = "blocks.0.rwkv", "blocks.1.mamba"     # the layers the applies take
LENGTHS = {"S1": 1, "S3": 3, "S12": 12}        # chunk 4: 1 token, < chunk, 3
TOL = 1e-5

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


def _cfg(get, arch, chunk=None):
    """The smoke config of `arch` from `get` (either package's get_arch),
    its scans' chunk replaced by `chunk` when given."""
    cfg = get(arch, smoke=True)
    if chunk is None:
        return cfg
    sub = "rwkv" if cfg.rwkv is not None else "mamba"
    return dataclasses.replace(
        cfg, **{sub: dataclasses.replace(getattr(cfg, sub), chunk=chunk)})


def _jmodel(arch):
    """(JAX LM, its PRNGKey(0) params, the same params as numpy)."""
    def init():
        jlm = JLM(jget_arch(arch, smoke=True))
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        return jlm, jp, _np(jp)
    return _jax(("model", arch), init)


def _layer(np_params, i=0):
    return {k: v[i] for k, v in np_params.items() if k.startswith("blocks.")}


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------- the scans
def _wkv_inputs(S, state):
    r = _rng(S)
    B, H, dh = 2, 4, 32
    x = [r.standard_normal((B, S, H, dh)).astype(np.float32)
         for _ in range(3)]
    w = r.uniform(0.05, 0.99, (B, S, H, dh)).astype(np.float32)
    u = r.standard_normal((H, dh)).astype(np.float32)
    s0 = (r.standard_normal((B, H, dh, dh)).astype(np.float32) if state
          else np.zeros((B, H, dh, dh), np.float32))
    return (*x, w, u, s0)


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", sorted(LENGTHS.values()))
def test_wkv_scan_matches_jax(S, state):
    args = _wkv_inputs(S, state)
    want = _jax(("wkv", S, state), lambda: _np(JL._wkv_scan(
        *map(jnp.asarray, args), chunk=4)))
    got = TL._wkv_scan(*map(torch.from_numpy, args), chunk=4)
    for g, w, what in zip(got, want, ("y", "state")):
        _close(g, w, what)


def _mamba_scan_inputs(S, state):
    r = _rng(100 + S)
    B, Di, N = 2, 16, 8
    xc = r.standard_normal((B, S, Di)).astype(np.float32)
    dt = r.uniform(0.01, 1.0, (B, S, Di)).astype(np.float32)
    Bc, Cc = (r.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(r.standard_normal((Di, N))).astype(np.float32)
    D = r.standard_normal((Di,)).astype(np.float32)
    h0 = (r.standard_normal((B, Di, N)).astype(np.float32) if state
          else np.zeros((B, Di, N), np.float32))
    return xc, dt, Bc, Cc, A, D, h0


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", sorted(LENGTHS.values()))
def test_mamba_chunk_scan_matches_jax(S, state):
    args = _mamba_scan_inputs(S, state)
    want = _jax(("mscan", S, state), lambda: _np(JL._mamba_chunk_scan(
        *map(jnp.asarray, args), chunk=4)))
    got = TL._mamba_chunk_scan(*map(torch.from_numpy, args), chunk=4)
    for g, w, what in zip(got, want, ("y", "h")):
        _close(g, w, what)


@pytest.mark.parametrize("S", [70, 10])
def test_scans_refuse_the_reference_length_rule(S):
    """Past one chunk a sequence must be a multiple of it: the port raises
    ValueError naming S and the chunk where the reference asserts."""
    wkv = [torch.from_numpy(a) for a in _wkv_inputs(S, False)]
    with pytest.raises(ValueError, match=f"S={S}.*chunks of 4"):
        TL._wkv_scan(*wkv, chunk=4)
    mscan = [torch.from_numpy(a) for a in _mamba_scan_inputs(S, False)]
    with pytest.raises(ValueError, match=f"S={S}.*chunks of 4"):
        TL._mamba_chunk_scan(*mscan, chunk=4)
    with pytest.raises(AssertionError):
        JL._wkv_scan(*map(jnp.asarray, _wkv_inputs(S, False)), chunk=4)
    for ok in (3, 4, 8):
        TL._wkv_scan(*[torch.from_numpy(a) for a in _wkv_inputs(ok, False)],
                     chunk=4)


# --------------------------------------------------------------- the applies
def _x(S, seed=0, D=128):
    return _rng(seed).standard_normal((2, S, D)).astype(np.float32)


def _rwkv_sliced(lp, keep_heads):
    """Layer-0 rwkv params kept to `keep_heads` of 32-wide heads and, for
    the channel-mix, to the first 300 hidden units."""
    cols = np.concatenate([np.arange(h * 32, (h + 1) * 32)
                           for h in keep_heads])
    out = dict(lp)
    for w in ("wr", "wk", "wv", "wg", "decay_w2"):
        out[f"{RW}.{w}"] = lp[f"{RW}.{w}"][:, cols]
    out[f"{RW}.wo"] = lp[f"{RW}.wo"][cols]
    for w in ("decay_w0", "u", "lnx_scale", "lnx_bias"):
        out[f"{RW}.{w}"] = lp[f"{RW}.{w}"][cols]
    out[f"{RW}.cm_k"] = lp[f"{RW}.cm_k"][:, :300]
    out[f"{RW}.cm_v"] = lp[f"{RW}.cm_v"][:300]
    return out


def _rwkv_layer(sliced):
    lp = _layer(_jmodel("rwkv6-3b")[2])
    r = _rng(7)
    # a nonzero bonus and offsets, so every term of the time-mix counts
    lp[f"{RW}.u"] = r.standard_normal(lp[f"{RW}.u"].shape).astype(np.float32)
    lp[f"{RW}.lnx_bias"] = 0.1 * r.standard_normal(
        lp[f"{RW}.lnx_bias"].shape).astype(np.float32)
    return _rwkv_sliced(lp, [0, 2, 3]) if sliced else lp


def _shapes(pkg, cfg, **kw):
    base = pkg.LayerShapes.from_config(cfg)
    return dataclasses.replace(base, **kw) if kw else base


@pytest.mark.parametrize("sliced", [False, True], ids=["full", "sliced"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", sorted(LENGTHS.values()))
def test_rwkv_timemix_matches_jax(S, state, sliced):
    H = 3 if sliced else 4
    lp, x = _rwkv_layer(sliced), _x(S)
    r = _rng(11)
    st = ((r.standard_normal((2, 128)).astype(np.float32),
           r.standard_normal((2, H, 32, 32)).astype(np.float32))
          if state else None)
    kw = {"rwkv_heads": H} if sliced else {}

    def ref():
        cfg = _cfg(jget_arch, "rwkv6-3b", 4)
        return _np(JL.rwkv_timemix_apply(
            _j(lp), None, cfg, jnp.asarray(x), prefix=RW,
            state=None if st is None else tuple(map(jnp.asarray, st)),
            shapes=_shapes(JL, cfg, **kw)))

    want = _jax(("tm", S, state, sliced), ref)
    cfg = _cfg(get_arch, "rwkv6-3b", 4)
    out, new = TL.rwkv_timemix_apply(
        params_from_numpy(lp), None, cfg, torch.from_numpy(x), prefix=RW,
        state=None if st is None else tuple(map(torch.from_numpy, st)),
        shapes=_shapes(TL, cfg, **kw))
    _close(out, want[0], "out")
    _close(new[0], want[1][0], "shift")
    _close(new[1], want[1][1], "wkv")


@pytest.mark.parametrize("sliced", [False, True], ids=["full", "sliced"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", [1, 12])
def test_rwkv_chanmix_matches_jax(S, state, sliced):
    lp, x = _rwkv_layer(sliced), _x(S, seed=3)
    st = _rng(12).standard_normal((2, 128)).astype(np.float32) \
        if state else None
    cfg = _cfg(jget_arch, "rwkv6-3b")
    want = _jax(("cm", S, state, sliced), lambda: _np(JL.rwkv_chanmix_apply(
        _j(lp), None, cfg, jnp.asarray(x), prefix=RW,
        state=None if st is None else jnp.asarray(st))))
    out, new = TL.rwkv_chanmix_apply(
        params_from_numpy(lp), None, _cfg(get_arch, "rwkv6-3b"),
        torch.from_numpy(x), prefix=RW,
        state=None if st is None else torch.from_numpy(st))
    _close(out, want[0], "out")
    _close(new, want[1], "shift")


def _mamba_layer(sliced):
    lp = _layer(_jmodel("jamba-1.5-large-398b")[2])
    if not sliced:
        return lp
    keep = np.arange(0, 256, 2)[:101]           # 101 of 256: ragged
    out = dict(lp)
    for w, ax in (("in_proj_x", 1), ("in_proj_z", 1), ("conv_w", 1),
                  ("x_proj", 0), ("dt_proj", 1), ("dt_bias", 0),
                  ("A_log", 0), ("D", 0), ("out_proj", 0)):
        out[f"{MB}.{w}"] = np.take(lp[f"{MB}.{w}"], keep, axis=ax)
    return out


@pytest.mark.parametrize("sliced", [False, True], ids=["full", "sliced"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", sorted(LENGTHS.values()))
def test_mamba_apply_matches_jax(S, state, sliced):
    Di = 101 if sliced else 256
    lp, x = _mamba_layer(sliced), _x(S, seed=5)
    r = _rng(13)
    st = ((r.standard_normal((2, Di, 8)).astype(np.float32),
           r.standard_normal((2, 3, Di)).astype(np.float32))
          if state else None)
    kw = {"mamba_inner": Di} if sliced else {}

    def ref():
        cfg = _cfg(jget_arch, "jamba-1.5-large-398b", 4)
        return _np(JL.mamba_apply(
            _j(lp), None, cfg, jnp.asarray(x), prefix=MB,
            state=None if st is None else tuple(map(jnp.asarray, st)),
            shapes=_shapes(JL, cfg, **kw)))

    want = _jax(("mamba", S, state, sliced), ref)
    cfg = _cfg(get_arch, "jamba-1.5-large-398b", 4)
    out, new = TL.mamba_apply(
        params_from_numpy(lp), None, cfg, torch.from_numpy(x), prefix=MB,
        state=None if st is None else tuple(map(torch.from_numpy, st)),
        shapes=_shapes(TL, cfg, **kw))
    _close(out, want[0], "out")
    _close(new[0], want[1][0], "h")
    _close(new[1], want[1][1], "conv")


def test_groupnorm_heads_and_token_shift_match_jax():
    r = _rng(21)
    x = (3.0 + r.standard_normal((2, 5, 128))).astype(np.float32)
    scale, bias = (r.standard_normal((128,)).astype(np.float32)
                   for _ in range(2))
    want = JL.groupnorm_heads(*map(jnp.asarray, (x, scale, bias)), 4)
    got = TL.groupnorm_heads(*map(torch.from_numpy, (x, scale, bias)), 4)
    _close(got, want, "groupnorm")
    last = r.standard_normal((2, 128)).astype(np.float32)
    for S in (1, 5):
        xs = x[:, :S]
        for lst in (None, last):
            want = JL._token_shift(jnp.asarray(xs), None if lst is None
                                   else jnp.asarray(lst))
            got = TL._token_shift(torch.from_numpy(xs), None if lst is None
                                  else torch.from_numpy(lst))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ the LM
@pytest.mark.parametrize("arch", ARCHS)
def test_init_keys_shapes_and_sites_match_jax(arch):
    jlm, jp, np_params = _jmodel(arch)
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
    assert [vars(s) for s in lm.shapes] == [vars(s) for s in jlm.shapes]
    jq = jlm.init_qparams(jp, act_quant=True)
    got = lm.init_qparams(params_from_numpy(np_params), act_quant=True)
    assert list(got) == list(jq)
    for k, v in jq.items():
        for f in ("d", "q_m", "t"):
            assert getattr(got[k], f).numpy().tobytes() == \
                np.asarray(getattr(v, f)).tobytes(), (k, f)


def _leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_jax(arch):
    """init_cache and init_paged_cache (bf16 and int8 pages): the
    reference's keys, shapes and dtypes, at full and sliced widths; the
    paged arena's recurrent state is per slot and needs `batch`."""
    jlm = JLM(jget_arch(arch, smoke=True))
    lm = LM(get_arch(arch, smoke=True))
    for sliced in (False, True):
        if sliced:
            kw = ({"rwkv_heads": 3, "cm_hidden": 300} if arch == "rwkv6-3b"
                  else {"mamba_inner": 101, "n_kv_heads": 1, "n_heads": 2})
            for m, pkg in ((jlm, JL), (lm, TL)):
                m.shapes = [dataclasses.replace(
                    pkg.LayerShapes.from_config(m.cfg), **kw)
                    for _ in m.plan]
        assert _leaves(lm.init_cache(2, 16, dtype=torch.float32)) == \
            _leaves(jlm.init_cache(2, 16, dtype=jnp.float32))
        for bits in (None, 8):
            want = jlm.init_paged_cache(3, 6, 4, dtype=jnp.bfloat16,
                                        kv_bits=bits)
            got = lm.init_paged_cache(6, 4, dtype=torch.bfloat16,
                                      kv_bits=bits, batch=3)
            assert _leaves(got) == _leaves(want), (sliced, bits)
    with pytest.raises(ValueError, match="batch="):
        lm.init_paged_cache(6, 4)


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
    kinds = {f.kind for f in got.space.families}
    assert ("state" in kinds) == (arch != "rwkv6-3b")
    assert ("head_group" in kinds) and ("channel" in kinds)


# -------------------------------------------- mirrors of test_arch_smoke.py
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg = get_arch(arch, smoke=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    caches = lm.init_cache(2, 32, dtype=torch.float32)
    shapes = {k: v.shape for k, v in caches.items()}
    logits, caches2 = lm.decode_step(params, None, caches,
                                     torch.zeros((2, 1), dtype=torch.int64),
                                     0)
    assert logits.shape[0] == 2 and torch.isfinite(logits).all()
    assert {k: v.shape for k, v in caches2.items()} == shapes
    assert any(float(v.abs().max()) > 0 for v in caches2.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """`test_decode_matches_forward_rwkv` / `_hybrid`: token-by-token
    decode reproduces the teacher-forced forward (no quant; jamba at
    capacity factor 8, as the reference raises it, so the forward drops
    no token)."""
    cfg = get_arch(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    lm = LM(cfg)
    params = params_from_numpy(_jmodel(arch)[2])
    toks = torch.from_numpy(_rng(1).integers(0, cfg.vocab, (1, 6)))
    full = lm.forward(params, None, toks)
    caches = lm.init_cache(1, 16, dtype=torch.float32)
    outs = [lm.decode_step(params, None, caches, toks[:, p:p + 1], p)[0][:, 0]
            for p in range(6)]
    tol = 2e-3 if cfg.moe is None else 5e-3
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_graph_families_valid(arch):
    """`test_qadg.py::test_lm_graph_all_families_valid` for the recurrent
    archs on the port's own params."""
    lm = LM(get_arch(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    qadg = build_qadg(lm.build_graph(act_quant=True).graph)
    qadg.space.validate(params)
    assert len(qadg.sites) > 0
    assert qadg.space.total_units() > 0


def test_layer_plans_of_the_recurrent_archs():
    assert [vars(s) for s in layer_plan(get_arch("rwkv6-3b"))[0]] == \
        [{"j": 0, "mixer": "rwkv", "ffn": "chanmix"}]
    plan, n = layer_plan(get_arch("jamba-1.5-large-398b"))
    assert n == 9 and [s.mixer for s in plan] == ["attn"] + ["mamba"] * 7
    assert [s.ffn for s in plan] == ["mlp", "moe"] * 4


def test_bf16_forward_without_quantizers_matches_jax():
    """In bf16 without quantizers rwkv6's decay LoRA multiplies its f32
    tanh by a bf16 weight; as JAX promotes the product to f32, so does
    `dense_proj`'s plain path. The logits agree with the reference's bf16
    forward within 2^-5 of their range (bf16 sums in another order)."""
    cfg = dataclasses.replace(get_arch("rwkv6-3b", smoke=True),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jget_arch("rwkv6-3b", smoke=True),
                               dtype="bfloat16")
    toks = _rng(8).integers(0, 512, (2, 8))

    def ref():
        jp, _ = JLM(jcfg).init(jax.random.PRNGKey(0))
        return _np(jp), np.asarray(JLM(jcfg).forward(
            jp, None, jnp.asarray(toks)).astype(jnp.float32))

    np_params, want = _jax("bf16", ref)
    assert np_params["blocks.0.rwkv.decay_w2"].dtype.name == "bfloat16"
    got = LM(cfg).forward(params_from_numpy(np_params), None,
                          torch.from_numpy(toks)).float().numpy()
    span = float(want.max() - want.min())
    assert float(np.abs(got - want).max()) <= 2 ** -5 * span

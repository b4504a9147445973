"""The port's BERT encoder (`repro_torch.models.bert`) against the JAX
package's (`repro.models.bert`), Table 3's substrate.

The JAX package's init params and quantizers and its `qa_batch` cross
as numpy.

- Default widths (4 layers, d_model 256, 4 heads, d_ff 1024, vocab
  8192), batch 2 x 32, with its 8-bit weight quantizers: logits within
  1e-5 of max|y|, the loss within 1e-5 relative, exact match equal, each
  param gradient within 1e-4 of its own max|g| and each weight site's
  (d, q_m, t) gradient within 1e-5 of the sum of its terms' magnitudes.
  Three gradients are zero in exact arithmetic and only roundoff in both
  packages: the key biases' (a softmax ignores a shift shared by a row),
  the span head's bias and the last layer norm's bias (each reaches the
  loss through the head's cotangent summed over positions, and each span
  softmax's probabilities less its one-hot sum to zero); those are held
  within 1e-6 absolute.
- The QADG (head groups, MLP channels, sites) is the JAX package's, with
  and without activation quantizers.
- The QASSO joint update (step 0 of `train.JOINT_STEP0`) on the
  reference harness's reduced encoder with activation quantizers, from
  the reference's state and gradients, at `train.STEP_TOLERANCES` with
  identical masks (the gradients are shared for the reason
  `tests/test_torch_cnn.py` gives: Eq 16's gamma divides by cos_g, which
  can sit near zero).
- `qa_batch`'s markers and span bounds; `attention_dense(causal=False)`,
  `layernorm` and the tanh GELU against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import CompressionConfig as JComp
from repro.core.qadg import build_qadg as j_build_qadg
from repro.data.synthetic import qa_batch as j_qa_batch
from repro.launch import train as JT
from repro.models import bert as JB
from repro.models.layers import attention_dense as j_attention_dense
from repro_torch.convert import (geta_state_from_numpy, params_from_numpy,
                                 qparams_from_numpy)
from repro_torch.core.qadg import build_qadg
from repro_torch.data.synthetic import qa_batch
from repro_torch.launch import train as T
from repro_torch.models import bert as TB
from repro_torch.models.layers import attention_dense

# the reduced encoder of `benchmarks/geta_experiments.py:run_geta_bert`
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=256, vocab=512,
               max_seq=64)
# gradients that are zero in exact arithmetic (roundoff in both packages)
ZERO_GRADS = (".attn.bk", "qa_head.b", "enc.3.ln2.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _q_np(jq):
    return {k: (np.asarray(v.d), np.asarray(v.q_m), np.asarray(v.t))
            for k, v in jq.items()}


def _batch(jb):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in jb.items()}


def _term_scales(w, g, d, q_m, t):
    """The sums of the Eq 4-6 terms' magnitudes (dd, dq_m, dt) in f64,
    the weight's cotangent being its gradient (|w| <= q_m = max|w|)."""
    w, g = np.abs(w.astype(np.float64)), np.abs(g.astype(np.float64))
    d, q_m, t = float(d), float(q_m), float(t)
    inside = w <= q_m
    base = np.where(inside, np.maximum(w, 1e-12), q_m)
    v = np.minimum(w, q_m) ** t / d
    return (float((g * np.abs(np.round(v) - v)).sum()),
            float((g * np.where(inside, 0.0, t * q_m ** (t - 1))).sum()),
            float((g * np.abs(base ** t * np.log(base))).sum()))


def test_apply_loss_grads_and_exact_match_match_jax():
    jm, m = JB.BertEncoder(), TB.BertEncoder()
    jp = jm.init(jax.random.PRNGKey(0))
    jq = jm.init_qparams(jp, bits_init=8.0)
    jb = j_qa_batch(0, 0, 2, 32, jm.V)
    loss_fn = jax.jit(jax.value_and_grad(jm.loss, argnums=(0, 1)))
    jloss, (jgx, jgq) = loss_fn(jp, jq, jb)
    jy = np.asarray(jax.jit(jm.apply)(jp, jq, jb["tokens"]))
    jp_np, jq_np, jgx = _np(jp), _q_np(jq), _np(jgx)
    tp, tq, tb = params_from_numpy(jp_np), qparams_from_numpy(jq_np), \
        _batch(jb)
    y = m.apply(tp, tq, tb["tokens"])
    assert y.shape == (2, 32, 2)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    assert float(m.exact_match(tp, tq, tb)) == float(
        jax.jit(jm.exact_match)(jp, jq, jb))
    loss, gx, gq = T.loss_and_grads(m, tp, tq, tb)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    for k, w in jgx.items():
        atol = 1e-6 if k.endswith(ZERO_GRADS) else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(gx[k].numpy(), w, rtol=0, atol=atol,
                                   err_msg=k)
    for k, v in jgq.items():
        scales = _term_scales(jp_np[k[:-3]], jgx[k[:-3]], *jq_np[k])
        for got, want, scale, f in zip((gq[k].d, gq[k].q_m, gq[k].t),
                                       (v.d, v.q_m, v.t), scales,
                                       "d q_m t".split()):
            assert abs(float(got) - float(want)) <= 1e-5 * scale, (k, f)


def _space_key(space):
    return [(f.name, f.units, [(mb.param, mb.axis, mb.unit_size, mb.layout)
                               for mb in f.members], f.prunable, f.kind)
            for f in space.families]


@pytest.mark.parametrize("act_quant", [False, True], ids=["w", "w_act"])
def test_qadg_identical_to_jax(act_quant):
    jm, m = JB.BertEncoder(), TB.BertEncoder()
    want = j_build_qadg(jm.build_graph(act_quant=act_quant).graph)
    got = build_qadg(m.build_graph(act_quant=act_quant).graph)
    assert _space_key(got.space) == _space_key(want.space)
    assert [tuple(vars(s).values()) for s in got.sites] == \
        [tuple(vars(s).values()) for s in want.sites]
    assert got.space.total_units() == want.space.total_units() > 0
    params = m.init(torch.Generator().manual_seed(0))
    got.space.validate(params)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jax.eval_shape(
            jm.init, jax.random.PRNGKey(0)).items()}
    tq = m.init_qparams(params, act_quant=act_quant)
    assert sorted(tq) == sorted(s.name for s in got.sites)
    assert [vars(a) for a in m.layer_macs(2, 64)] == [
        vars(b) for b in jm.layer_macs(2, 64)]


def test_joint_update_matches_jax_with_act_quant():
    jm, m = JB.BertEncoder(**REDUCED), TB.BertEncoder(**REDUCED)
    comp = T.JOINT_STEP0.__class__(**{**vars(T.JOINT_STEP0),
                                      "act_quant": True})
    _, jqasso = JT.build_geta(jm, JComp(**vars(comp)), lr=3e-4)
    jp = jm.init(jax.random.PRNGKey(0))
    jq = jm.init_qparams(jp, bits_init=16.0, act_quant=True)
    js = jqasso.init(jp, jq)
    jb = j_qa_batch(0, 0, 8, 64, jm.V)
    jloss, (jgx, jgq) = jax.jit(jax.value_and_grad(jm.loss, argnums=(0, 1)))(
        jp, jq, jb)
    wp, wq, ws, jmet = jax.jit(jqasso.update)(jp, jq, jgx, jgq, js)
    want = (*geta_state_from_numpy(_np(wp), _np(wq), _np(ws)),
            {"loss": float(jloss)})

    _, qasso = T.build_geta(m, comp, lr=3e-4)
    p, q, s = geta_state_from_numpy(_np(jp), _np(jq), _np(js))
    loss, _, _ = T.loss_and_grads(m, p, q, _batch(jb))
    p2, q2, s2, met = qasso.update(p, q, params_from_numpy(_np(jgx)),
                                   qparams_from_numpy(_q_np(jgq)), s)
    assert met["stage"] == int(jmet["stage"]) == 2
    diff = T.step_differences(want, (p2, q2, s2, {"loss": float(loss)}))
    assert diff.pop("masks")
    assert any(float(v.sum()) > 0 for v in s2.redundant.values())
    assert "act_d" in diff
    for k, v in diff.items():
        assert v <= T.STEP_TOLERANCES.get(k.removeprefix("act_"), 0), (k, v)


def test_qa_batch_markers_and_spans():
    b = qa_batch(0, 5, 16, 64, 512)
    toks, start, end = b["tokens"], b["start"], b["end"]
    assert toks.shape == (16, 64) and start.shape == end.shape == (16,)
    assert all(t.dtype == torch.int64 for t in (toks, start, end))
    rows = torch.arange(16)
    assert torch.all(toks[rows, start] == 510)
    assert torch.all(toks[rows, end] == 511)
    assert torch.all((start >= 0) & (start < 32))
    assert torch.all((end > start) & (end <= start + 15) & (end <= 63))
    assert int(toks.min()) >= 0 and int(toks.max()) <= 511
    again = qa_batch(0, 5, 16, 64, 512)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(toks, qa_batch(0, 6, 16, 64, 512)["tokens"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv", [4, 2])
def test_attention_dense_matches_jax(causal, kv):
    rng = np.random.default_rng(kv)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, kv, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(j_attention_dense(*map(jnp.asarray, (q, k, v)),
                                        causal=causal))
    got = attention_dense(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if causal:      # the default stays causal
        assert torch.equal(attention_dense(*map(torch.from_numpy, (q, k, v))),
                           got)


def test_layernorm_and_gelu_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32) * 3
    s, b = rng.standard_normal(32).astype(np.float32), \
        rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        TB.layernorm(*map(torch.from_numpy, (x, s, b))).numpy(),
        np.asarray(JB.layernorm(*map(jnp.asarray, (x, s, b)))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-5, atol=1e-6)

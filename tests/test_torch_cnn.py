"""The port's CNN family (`repro_torch.models.cnn`: VGG7, ResNet20/56)
against the JAX package's (`repro.models.cnn`).

The JAX package's init params and quantizers cross as numpy, and so do
the images (NHWC) and labels, made from a seed with numpy.

- Full spec widths, batch 2, 32 x 32: logits without quantizers within
  1e-5 of max|y|; with the train loop's 16-bit weight quantizers the
  loss within 1e-5 relative, each param gradient within 1e-4 of its own
  max|g| and each weight site's (d, q_m, t) gradient within 1e-5 of the
  sum of its terms' magnitudes (the Eq 4-6 sums cancel). This covers the
  stride-2 "SAME" padding and the NHWC flatten order.
- The QADG (families, members, sites) of VGG7, ResNet20 and ResNet56 is
  the JAX package's, with and without activation quantizers.
- With activation quantizers, VGG7 at reduced widths
  (`benchmarks/geta_experiments.py`'s VGG7_R), batch 8: at 6 bits every
  site's rounding of x / d comes out the same in both packages, and the
  port's loss is held within 1e-6 relative, each param gradient within
  1e-4 of its max|g| and each site's (d, q_m, t) gradient, weight and
  activation sites alike, within 1e-5 of the sum of its terms'
  magnitudes. Where a rounding flips, the two packages part: a conv
  output differs between summation orders by ~5e-6, which flips x / d
  of an element that lies that close to a half-integer; the flipped
  activation moves by d, batch norm spreads it over the channel and the
  next sites flip in turn (measured at 8 bits: 1 flip at the second
  site, 2 at the third, 1116 at the sixth; the loss parts by 1.4e-3).
  At the 16-bit init such flips are many: the port's gradients part from
  the reference's by ~10% of their max, and so do the reference's own
  when every image pixel moves by one ulp (the witness); the port is
  held within 4x the witness's gap there.
- The QASSO joint update (step 0 of `train.JOINT_STEP0`: the partition,
  Eq 16-17, the forget step and the hard zeroing) on VGG7_R with
  16-bit activation quantizers, from the reference's state and the
  reference's gradients (at 16 bits the gradients themselves part, as
  above), at `train.STEP_TOLERANCES` with identical masks. A ReLU input
  within 2e-7 of zero flips a whole channel's gradient the same way
  (ResNet20 at 8-bit weights, key 0), and so does a max-pool window
  whose top two inputs lie within the two orders' difference. The
  full-width tests use the JAX package's own init (`init(PRNGKey(0))`,
  eager, as `tests/test_qadg.py` draws it); the same init under
  `jax.jit` moves some weights by an ulp, leaves a first-pool window
  with a top-two gap of 8.9e-7, and there VGG7's 16-bit gradients part
  by 5% (conv2.w).
- `image_batch`'s shapes, dtypes and layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CompressionConfig as JComp
from repro.core.qadg import build_qadg as j_build_qadg
from repro.launch import train as JT
from repro.models import cnn as JC
from repro_torch.convert import (geta_state_from_numpy, params_from_numpy,
                                 qparams_from_numpy)
from repro_torch.core.qadg import build_qadg
from repro_torch.data.synthetic import image_batch
from repro_torch.launch import train as T
from repro_torch.models import cnn as TC

SPECS = {"vgg7": (JC.VGG7, TC.VGG7), "resnet20": (JC.RESNET20, TC.RESNET20),
         "resnet56": (JC.RESNET56, TC.RESNET56)}
# VGG7_R, the reduced widths of `benchmarks/geta_experiments.py`
REDUCED = {"vgg7-r": ("vgg", [16, 16, 32, 32, 64, 64], dict(fc_dim=128))}


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


def _data(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    return x, rng.integers(0, 10, batch).astype(np.int32)


def _reference(name):
    """The JAX model's params, 16-bit weight quantizers, logits without
    quantizers, and loss and gradients with them on a batch of 2."""
    jm = JC.CNN(SPECS[name][0])
    jp = jm.init(jax.random.PRNGKey(0))
    jq = jm.init_qparams(jp, bits_init=16.0)
    x, y = _data(2)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    loss, (gx, gq) = jax.jit(jax.value_and_grad(jm.loss, argnums=(0, 1)))(
        jp, jq, jb)
    return (_np(jp), _q_np(jq),
            np.asarray(jax.jit(jm.apply)(jp, None, jb["images"])),
            float(loss), _np(gx),
            {k: _np((v.d, v.q_m, v.t)) for k, v in gq.items()}, (x, y))


@pytest.mark.parametrize("name", ["vgg7", "resnet20"])
def test_apply_loss_and_grads_match_jax(name):
    jp, jq, jy, jloss, jgx, jgq, (x, y) = _reference(name)
    m = TC.CNN(SPECS[name][1])
    tp, tq = params_from_numpy(jp), qparams_from_numpy(jq)
    batch = {"images": torch.from_numpy(x),
             "labels": torch.from_numpy(y.astype(np.int64))}
    logits = m.apply(tp, None, batch["images"])
    assert logits.shape == (2, 10)
    np.testing.assert_allclose(logits.numpy(), jy, rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    loss, gx, gq = T.loss_and_grads(m, tp, tq, batch)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    for k, w in jgx.items():
        np.testing.assert_allclose(gx[k].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)
    for k, want in jgq.items():
        scales = _term_scales(jp[k[:-3]], jgx[k[:-3]], *jq[k])
        for got, exp, scale, f in zip((gq[k].d, gq[k].q_m, gq[k].t), want,
                                      scales, "d q_m t".split()):
            assert abs(float(got) - float(exp)) <= 1e-5 * scale, (k, f)


def _term_scales(w, g, d, q_m, t):
    """For each of a site's Eq 4-6 sums (dd, dq_m, dt), the sum of its
    terms' magnitudes in f64: the scale two summation orders' difference
    is held against. `w` is the site's input and `g` its cotangent; a
    weight's cotangent is its gradient (the STE passes it: |w| <= q_m =
    max|w|)."""
    w, g = np.abs(w.astype(np.float64)), np.abs(g.astype(np.float64))
    d, q_m, t = float(d), float(q_m), float(t)
    inside = w <= q_m
    base = np.where(inside, np.maximum(w, 1e-12), q_m)
    v = np.minimum(w, q_m) ** t / d
    return (float((g * np.abs(np.round(v) - v)).sum()),
            float((g * np.where(inside, 0.0, t * q_m ** (t - 1))).sum()),
            float((g * np.abs(base ** t * np.log(base))).sum()))


@pytest.mark.parametrize("name", ["vgg7", "resnet20"])
def test_cnn_masks_preserve_forward_of_kept_units(name):
    """Masking all-ones == no-op; with 25% of every family's units pruned
    the masked model runs and the materialized subnet is smaller (the
    functional-subnetwork invariant, `tests/test_qadg.py`)."""
    m = TC.CNN(SPECS[name][1])
    params = m.init(torch.Generator().manual_seed(0))
    qadg = build_qadg(m.build_graph().graph)
    qadg.space.validate(params)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    masks = qadg.space.init_masks()
    y_full = m.apply(params, None, x)
    y_masked = m.apply(qadg.space.apply_masks(params, masks), None, x)
    torch.testing.assert_close(y_full, y_masked, rtol=1e-5, atol=1e-5)
    masks2 = {k: torch.cat([torch.zeros(max(len(v) // 4, 1)),
                            v[max(len(v) // 4, 1):]])
              for k, v in masks.items()}
    y_soft = m.apply(qadg.space.apply_masks(params, masks2), None, x)
    sub, kept = qadg.space.materialize(params, masks2)
    assert sum(v.numel() for v in sub.values()) < sum(
        v.numel() for v in params.values())
    assert torch.isfinite(y_soft).all()


def _space_key(space):
    return [(f.name, f.units, [(mb.param, mb.axis, mb.unit_size, mb.layout)
                               for mb in f.members], f.prunable, f.kind)
            for f in space.families]


@pytest.mark.parametrize("act_quant", [False, True], ids=["w", "w_act"])
@pytest.mark.parametrize("name", ["vgg7", "resnet20", "resnet56"])
def test_qadg_identical_to_jax(name, act_quant):
    """Families (names, units, members with their axes into the HWIO /
    (in, out) layouts, prunable, kind) and quantization sites equal the
    JAX package's; the space validates on the port's params; the
    quantizers' init and the MAC counts are the JAX package's too."""
    js, ts = SPECS[name]
    jm, m = JC.CNN(js), TC.CNN(ts)
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
    assert [vars(a) for a in m.layer_macs(batch=3)] == [
        vars(b) for b in jm.layer_macs(batch=3)]
    jq = jm.init_qparams(jax.tree_util.tree_map(jnp.asarray, {
        k: v.numpy() for k, v in params.items()}), bits_init=16.0,
        act_quant=act_quant)
    tq = m.init_qparams(params, bits_init=16.0, act_quant=act_quant)
    assert list(tq) == list(jq)
    assert sorted(tq) == sorted(s.name for s in got.sites)
    for k, v in jq.items():
        for f in ("d", "q_m", "t"):
            np.testing.assert_allclose(float(getattr(tq[k], f)),
                                       float(getattr(v, f)), rtol=1e-6,
                                       err_msg=f"{k}.{f}")


@pytest.fixture(scope="module")
def vgg7_r():
    """VGG7_R in both packages, the JAX package's eager init, a batch of
    8 and the reference's jitted loss and gradients."""
    kind, widths, kw = REDUCED["vgg7-r"]
    jm = JC.CNN(JC.CNNSpec("vgg7-r", kind, widths, **kw))
    m = TC.CNN(TC.CNNSpec("vgg7-r", kind, widths, **kw))
    return (jm, m, jm.init(jax.random.PRNGKey(0)), _data(8),
            jax.jit(jax.value_and_grad(jm.loss, argnums=(0, 1))))


def _port_grads(m, jp, jq, x, y, monkeypatch):
    """The port's loss and gradients from the reference's params and
    quantizers, and each activation site's input and cotangent."""
    seen, qa = {}, TC._qa

    def recording_qa(h, qparams, site):
        out = qa(h, qparams, site)
        if qparams is not None and site in qparams:
            seen[site] = [h.detach().numpy().copy()]
            out.register_hook(lambda g: seen[site].append(g.numpy().copy()))
        return out

    monkeypatch.setattr(TC, "_qa", recording_qa)
    loss, gx, gq = T.loss_and_grads(
        m, params_from_numpy(_np(jp)), qparams_from_numpy(_q_np(jq)),
        {"images": torch.from_numpy(x),
         "labels": torch.from_numpy(y.astype(np.int64))})
    return float(loss), gx, gq, seen


def _grad_gap(gx, jgx):
    """The largest gradient difference over params, each in units of its
    own max|g|."""
    return max(float(np.abs(np.asarray(gx[k]) - w).max() / np.abs(w).max())
               for k, w in jgx.items())


def test_act_quant_grads_match_jax(vgg7_r, monkeypatch):
    """6-bit weight and activation sites: the same roundings in both
    packages, so the loss within 1e-6 relative, the param gradients
    within 1e-4 of their max and every site's (d, q_m, t) gradient within
    1e-5 of the sum of its terms' magnitudes."""
    jm, m, jp, (x, y), lg = vgg7_r
    jq = jm.init_qparams(jp, bits_init=6.0, act_quant=True)
    jloss, (jgx, jgq) = lg(jp, jq, {"images": jnp.asarray(x),
                                    "labels": jnp.asarray(y)})
    jgx, jq_np = _np(jgx), _q_np(jq)
    loss, gx, gq, seen = _port_grads(m, jp, jq, x, y, monkeypatch)
    assert loss == pytest.approx(float(jloss), rel=1e-6)
    assert _grad_gap({k: v.numpy() for k, v in gx.items()}, jgx) <= 1e-4
    assert sorted(seen) == sorted(k for k in jgq if k.endswith(".aq"))
    assert len(seen) == 7 and all(len(v) == 2 for v in seen.values())
    jp_np = _np(jp)
    for k, v in jgq.items():
        if k.endswith(".aq"):
            scales = _term_scales(*seen[k], *jq_np[k])
        else:
            scales = _term_scales(jp_np[k[:-3]], jgx[k[:-3]], *jq_np[k])
        for got, exp, scale, f in zip((gq[k].d, gq[k].q_m, gq[k].t),
                                      (v.d, v.q_m, v.t), scales,
                                      "d q_m t".split()):
            assert abs(float(got) - float(exp)) <= 1e-5 * scale, (k, f)


def test_act_quant_grads_at_16_bits_part_as_the_reference_does(
        vgg7_r, monkeypatch):
    """16-bit activation sites, where roundings flip between summation
    orders: the reference's gradients part from themselves by more than
    1e-2 of their max when every image pixel moves by one ulp (three
    draws), and the port's part from the reference's by at most 4x the
    largest of those; the loss stays within 1e-5 relative."""
    jm, m, jp, (x, y), lg = vgg7_r
    jq = jm.init_qparams(jp, bits_init=16.0, act_quant=True)
    labels = jnp.asarray(y)
    jloss, (jgx, _) = lg(jp, jq, {"images": jnp.asarray(x),
                                  "labels": labels})
    jgx = _np(jgx)
    witness = []
    for seed in range(3):
        up = np.random.default_rng(seed).random(x.shape) < 0.5
        xw = np.nextafter(x, np.where(up, np.inf, -np.inf).astype(x.dtype))
        _, (wgx, _) = lg(jp, jq, {"images": jnp.asarray(xw),
                                  "labels": labels})
        witness.append(_grad_gap(_np(wgx), jgx))
    loss, gx, _, _ = _port_grads(m, jp, jq, x, y, monkeypatch)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    assert max(witness) > 1e-2
    assert _grad_gap({k: v.numpy() for k, v in gx.items()}, jgx) <= \
        4 * max(witness)


def test_joint_update_matches_jax_with_act_quant(vgg7_r):
    """Step 0 of JOINT_STEP0 with activation quantizers on a batch of 8:
    QASSO's joint update from the reference's state and gradients equals
    the reference's update at STEP_TOLERANCES with identical partition
    and keep masks; the port's own loss on that state agrees within 1e-5
    relative."""
    jm, m, jp, (x, y), lg = vgg7_r
    comp = T.JOINT_STEP0.__class__(**{**vars(T.JOINT_STEP0),
                                      "act_quant": True})
    _, jqasso = JT.build_geta(jm, JComp(**vars(comp)), lr=3e-4)
    jq = jm.init_qparams(jp, bits_init=16.0, act_quant=True)
    js = jqasso.init(jp, jq)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    jloss, (jgx, jgq) = lg(jp, jq, jb)
    wp, wq, ws, jmet = jax.jit(jqasso.update)(jp, jq, jgx, jgq, js)
    want = (*geta_state_from_numpy(_np(wp), _np(wq), _np(ws)),
            {"loss": float(jloss)})

    _, qasso = T.build_geta(m, comp, lr=3e-4)
    p, q, s = geta_state_from_numpy(_np(jp), _np(jq), _np(js))
    loss, _, _ = T.loss_and_grads(m, p, q, {
        "images": torch.from_numpy(x),
        "labels": torch.from_numpy(y.astype(np.int64))})
    gq = qparams_from_numpy(_q_np(jgq))
    p2, q2, s2, met = qasso.update(p, q, params_from_numpy(_np(jgx)), gq, s)
    assert met["stage"] == int(jmet["stage"]) == 2
    got = (p2, q2, s2, {"loss": float(loss)})
    diff = T.step_differences(want, got)
    assert diff.pop("masks")
    assert any(float(v.sum()) > 0 for v in s2.redundant.values())
    assert "act_d" in diff
    for k, v in diff.items():
        assert v <= T.STEP_TOLERANCES.get(k.removeprefix("act_"), 0), (k, v)


def test_image_batch_shapes_and_layout():
    b = image_batch(0, 3, 6)
    assert b["images"].shape == (6, 32, 32, 3)           # NHWC
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int64 and b["labels"].shape == (6,)
    assert int(b["labels"].min()) >= 0 and int(b["labels"].max()) < 10
    again = image_batch(0, 3, 6)
    assert torch.equal(b["images"], again["images"])
    assert not torch.equal(b["images"], image_batch(0, 4, 6)["images"])
    # the class means are fixed across steps and seeds: two images of one
    # class differ by noise only, so their difference has unit variance
    other = image_batch(1, 9, 64)
    lab = int(b["labels"][0])
    same = other["images"][other["labels"] == lab]
    diff = (same[0] - b["images"][0]).flatten()
    assert 1.5 < float(diff.var()) < 2.5                  # 2 x unit noise
    small = image_batch(0, 0, 2, hw=8, classes=3)
    assert small["images"].shape == (2, 8, 8, 3)


@pytest.mark.parametrize("k,stride,hw", [(3, 1, 32), (3, 2, 32), (1, 2, 32),
                                         (3, 2, 16), (3, 2, 7), (1, 1, 5)])
def test_conv2d_pads_same_as_xla(k, stride, hw):
    """"SAME" at stride 2 pads 0 before and 1 after on an even size, as
    XLA does; the output is NHWC and contiguous."""
    rng = np.random.default_rng(k + stride + hw)
    x = rng.standard_normal((2, hw, hw, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 4)).astype(np.float32)
    want = np.asarray(JC.conv2d(jnp.asarray(x), jnp.asarray(w),
                                stride=stride))
    got = TC.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.is_contiguous() and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TC.maxpool(got).numpy(), np.asarray(JC.maxpool(jnp.asarray(want))),
        rtol=1e-5, atol=1e-5)
    s, b = np.linspace(0.5, 2, 4, dtype=np.float32), np.arange(4, dtype=np.float32)
    np.testing.assert_allclose(
        TC.batchnorm(got, torch.from_numpy(s), torch.from_numpy(b)).numpy(),
        np.asarray(JC.batchnorm(jnp.asarray(want), s, b)), rtol=1e-4,
        atol=1e-4)

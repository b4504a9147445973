"""The paper's experiment runners (`repro_torch.launch.experiments`)
against the JAX package's (`benchmarks/geta_experiments.py`).

- `qasso_cfg` field for field, for several step counts and every
  `skip_stage` ablation; the `_R` specs and BERT-small's sizes.
- The CNN runners at RESNET20_R, batch 8, steps=12 (11 QASSO steps, every
  stage), from the reference's init and batches (numpy). The reference
  side is the reference runner's loop built from the reference's own
  pieces (`qasso_cfg`, QADG, QASSO, `model.loss`, `image_batch`), its
  step jitted once and run from the init and from three witnesses: the
  init with one ulp on every weight, each in a random direction. Exact:
  the stages, k_units and the pruned unit count, bits within [b_l,
  b_u_final], no pruned element left nonzero. Held within 4x the
  witnesses' largest gap from the reference (the reference's own spread,
  ROADMAP "Known differences", multi-step trajectories): every step's
  loss, rel_bops and accuracy (mean bits, which needs the reference's
  slow eager `construct_subnet`, is held by the tail test below). The
  baseline's losses and accuracy the same way.
- The CNN evaluation tail (`cnn_tail`) on the reference run's final
  params, quantizers and keep masks: accuracy equal, rel_bops and
  `construct_subnet`'s sparsity and mean bits within 1e-6 relative (f32
  bit widths summed in another order).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import benchmarks.geta_experiments as G                 # noqa: E402
from repro.core.bops import model_bops as j_model_bops  # noqa: E402
from repro.core.qadg import build_qadg as j_build_qadg  # noqa: E402
from repro.core.qasso import QASSO as JQASSO            # noqa: E402
from repro.core.subnet import construct_subnet as j_construct  # noqa: E402
from repro.data.synthetic import image_batch as j_image_batch  # noqa: E402
from repro.models import cnn as JC                      # noqa: E402
from repro.optim.base import adam as j_adam, tree_add   # noqa: E402
from repro.optim.schedules import constant as j_constant  # noqa: E402
from repro_torch.convert import params_from_numpy, qparams_from_numpy  # noqa: E402,E501
from repro_torch.core.qadg import build_qadg            # noqa: E402
from repro_torch.launch import experiments as E         # noqa: E402
from repro_torch.models import cnn as TC                # noqa: E402

STEPS, BATCH, SPARSITY, LR = 12, 8, 0.35, 3e-3
WITNESSES = 3


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


def _images(b):
    return {"images": np.array(b["images"]),
            "labels": np.asarray(b["labels"]).astype(np.int64)}


def _ulp(params, seed):
    rng = np.random.default_rng(seed)
    return {k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, -np.inf,
                                        np.inf).astype(v.dtype))
            for k, v in params.items()}


@pytest.mark.parametrize("steps", [12, 60, 120, 200, 240])
@pytest.mark.parametrize("skip", [None, "warmup", "projection", "joint",
                                  "cooldown"])
def test_qasso_cfg_matches_reference(steps, skip):
    for b_l, b_u in ((4.0, 16.0), (2.0, 12.0), (32.0, 32.0)):
        want = G.qasso_cfg(steps, 0.35, b_l, b_u, skip)
        got = E.qasso_cfg(steps, 0.35, b_l, b_u, skip)
        for f in ("target_sparsity", "bit_lower", "bit_upper",
                  "warmup_steps", "projection_periods", "projection_steps",
                  "bit_reduction", "pruning_periods", "pruning_steps",
                  "cooldown_steps", "eta", "xi", "eps", "beta", "lr_quant",
                  "base_optimizer", "grad_clip", "total_steps",
                  "bit_upper_final"):
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", ["RESNET20_R", "RESNET56_R", "VGG7_R"])
def test_reduced_specs_match_reference(name):
    want, got = getattr(G, name), getattr(E, name)
    for f in ("name", "kind", "widths", "blocks_per_stage", "fc_dim",
              "num_classes", "in_hw"):
        assert getattr(got, f) == getattr(want, f), f


def test_bert_sizes_match_reference_runner():
    import inspect
    src = " ".join(inspect.getsource(G.run_geta_bert).split())
    sizes = ", ".join(f"{k}={v}" for k, v in E.BERT_R.items())
    assert sizes in src


def _ref_cnn(jm, jp, batches, test, *, geta: bool):
    """The reference runner's loop on `spec` from its init and from
    WITNESSES one-ulp inits, one jitted step: per run the losses, stages,
    accuracy (and rel_bops, k_units), the init (numpy), the reference
    run and (model, qadg)."""
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    if geta:
        qadg = j_build_qadg(jm.build_graph(act_quant=False).graph)
        cfg = G.qasso_cfg(STEPS, SPARSITY)
        qasso = JQASSO(qadg.space, qadg.sites, cfg, j_constant(LR))

        @jax.jit
        def step(p, q, s, b):
            loss, (gx, gq) = jax.value_and_grad(jm.loss, argnums=(0, 1))(
                p, q, b)
            return qasso.update(p, q, gx, gq, s) + (loss,)

        def run(p):
            q = jm.init_qparams(p, bits_init=16.0)
            s = qasso.init(p, q)
            losses, stages = [], []
            for i in range(cfg.total_steps):
                p, q, s, met, loss = step(p, q, s, jb[i])
                losses.append(float(loss))
                stages.append(int(met["stage"]))
            return losses, stages, p, q, s
    else:
        qadg = qasso = None
        opt = j_adam()

        @jax.jit
        def step(p, o, b):
            loss, gx = jax.value_and_grad(lambda x: jm.loss(x, None, b))(p)
            delta, o = opt.update(gx, o, p, jnp.float32(LR))
            return tree_add(p, delta), o, loss

        def run(p):
            o = opt.init(p)
            losses = []
            for i in range(STEPS):
                p, o, loss = step(p, o, jb[i])
                losses.append(float(loss))
            return losses, [], p, None, None

    init = _np(jp)
    runs = [run(jp)] + [run(jax.tree_util.tree_map(jnp.asarray,
                                                   _ulp(init, s)))
                        for s in range(WITNESSES)]
    acc = jax.jit(jm.accuracy)
    jt = {k: jnp.asarray(v) for k, v in test.items()}
    results = []
    for losses, stages, p, q, s in runs:
        r = {"losses": losses, "stages": stages,
             "acc": float(acc(p, q, jt))}
        if geta:
            r["rel_bops"] = j_model_bops(qadg, p, q, jm.layer_macs(1),
                                         masks=s.keep_mask)["rel_bops"]
            r["k_units"] = qasso.k_units
        results.append(r)
    return results, init, runs[0], (jm, qadg)


@pytest.fixture(scope="module")
def cnn_runs():
    batches = [_images(j_image_batch(0, i, BATCH)) for i in range(STEPS)]
    test = _images(j_image_batch(1, E.TEST_STEP["cnn"], 256))
    # the reference's init(PRNGKey(0)) under jax.jit (the eager draw takes
    # ~11 s here); both packages start from it
    jm = JC.CNN(G.RESNET20_R)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    geta = _ref_cnn(jm, jp, batches, test, geta=True)
    base = _ref_cnn(jm, jp, batches, test, geta=False)
    return batches, test, geta, base


def _within_spread(got, results, key):
    """|got - ref| <= 4 x the witnesses' largest |witness - ref|."""
    ref = results[0][key]
    spread = max(abs(w[key] - ref) for w in results[1:])
    assert abs(got - ref) <= 4 * spread + 1e-6 * abs(ref), (
        key, got, ref, spread)


def _losses_within_spread(got, results):
    """Each step's loss within 4x the witnesses' running largest gap (the
    first step, before any update, within 1e-5 relative)."""
    ref = results[0]["losses"]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        spread = max(abs(w["losses"][j] - ref[j]) for w in results[1:]
                     for j in range(i + 1))
        assert abs(g - r) <= max(4 * spread, 1e-5 * abs(r)), (i, g, r,
                                                              spread)


def test_geta_cnn_runner_matches_reference(cnn_runs):
    batches, test, (results, init, _, _), _ = cnn_runs
    got = E.run_geta_cnn(E.RESNET20_R, steps=STEPS, batch=BATCH,
                         sparsity=SPARSITY, device="cpu", init_params=init,
                         batches=lambda i: batches[i], test_batch=test)
    ref = results[0]
    assert got["stages"] == ref["stages"] == [0, 1, 1, 1, 2, 2, 2, 2, 3, 3,
                                              3]
    assert got["k_units"] == ref["k_units"] == got["pruned_units"]
    assert got["nonzero_pruned"] == 0
    assert (got["bit_lower"] - 1e-3 <= got["bits_min"]
            and got["bits_max"] <= got["bit_upper_final"] + 1e-3)
    _losses_within_spread(got["losses"], results)
    assert got["loss"] == got["losses"][-1]
    for key in ("acc", "rel_bops"):
        _within_spread(got[key], results, key)
    assert 0.0 < got["rel_bops"] < 1.0
    assert 0.0 < got["sparsity"] and 4.0 <= got["mean_bits"] <= 16.0


def test_baseline_cnn_runner_matches_reference(cnn_runs):
    batches, test, _, (results, init, _, _) = cnn_runs
    got = E.run_baseline_cnn(E.RESNET20_R, steps=STEPS, batch=BATCH,
                             device="cpu", init_params=init,
                             batches=lambda i: batches[i], test_batch=test)
    _losses_within_spread(got["losses"], results)
    _within_spread(got["acc"], results, "acc")
    assert got["rel_bops"] == 1.0


def test_cnn_tail_matches_reference_on_the_same_params(cnn_runs):
    _, test, (results, _, (_, _, p, q, s), (jm, qadg)), _ = cnn_runs
    want_sub = j_construct(qadg, p, q, s.keep_mask).meta
    want_bops = j_model_bops(qadg, p, q, jm.layer_macs(1),
                             masks=s.keep_mask)["rel_bops"]
    model = TC.CNN(TC.CNNSpec(**{f: getattr(G.RESNET20_R, f) for f in (
        "name", "kind", "widths", "blocks_per_stage", "fc_dim")}))
    keep = {k: torch.from_numpy(np.array(v)) for k, v in
            s.keep_mask.items()}
    got = E.cnn_tail(model, build_qadg(model.build_graph().graph),
                     params_from_numpy(_np(p)), qparams_from_numpy(_q_np(q)),
                     keep, {k: torch.from_numpy(v) for k, v in test.items()})
    assert got["acc"] == results[0]["acc"]
    assert got["rel_bops"] == pytest.approx(want_bops, rel=1e-6)
    assert got["sparsity"] == pytest.approx(want_sub["sparsity"], rel=1e-6)
    assert got["mean_bits"] == pytest.approx(want_sub["mean_bits"],
                                             rel=1e-6)

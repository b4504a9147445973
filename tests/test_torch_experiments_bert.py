"""The paper's BERT runners (`repro_torch.launch.experiments`:
`run_geta_bert`, `run_prune_then_ptq_bert`) against the JAX package's
(`benchmarks/geta_experiments.py`), at BERT-small (the reference
runners' encoder), batch 8, seq 64, steps=12 (11 QASSO steps, every
stage), from the reference's init and `qa_batch` batches (numpy).

The reference side is the reference runner's loop built from the
reference's own pieces (`qasso_cfg`, QADG, QASSO, `BertEncoder.loss`,
`qa_batch`), its step jitted once and run from the init and from three
witnesses: the init with one ulp on every weight. Exact: the stages,
k_units and the pruned unit count, no pruned element left nonzero; for
the GETA runner, bits within [b_l, b_u_final]. (The prune-then-PTQ run
pins the range at [32, 32], which the reference's QASSO leaves as SGD
moves d: its sites end near 25.6 bits in both packages, before PTQ at
8.) Held within 4x the witnesses' largest gap from the reference
(ROADMAP "Known differences", multi-step trajectories): every step's
loss, exact match, rel_bops and the sites' bit range. The evaluation
tail (`bert_tail`) on the reference run's final state: exact match
equal, rel_bops within 1e-6 relative.
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
from repro.core.quant import bit_width                  # noqa: E402
from repro.data.synthetic import qa_batch as j_qa_batch  # noqa: E402
from repro.models.bert import BertEncoder as JBert      # noqa: E402
from repro.optim.schedules import constant as j_constant  # noqa: E402
from repro_torch.convert import params_from_numpy, qparams_from_numpy  # noqa: E402,E501
from repro_torch.core.qadg import build_qadg            # noqa: E402
from repro_torch.launch import experiments as E         # noqa: E402
from repro_torch.models.bert import BertEncoder         # noqa: E402

STEPS, BATCH, SEQ, SPARSITY = 12, 8, 64, 0.3
WITNESSES = 3
RUNNERS = {"geta": (E.run_geta_bert, dict(b_l=4.0, b_u=16.0), 8.0),
           "prune_ptq": (E.run_prune_then_ptq_bert, dict(b_l=32.0,
                                                         b_u=32.0), 32.0)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _qa(b):
    return {k: np.array(v).astype(np.int64) for k, v in b.items()}


def _ulp(params, seed):
    rng = np.random.default_rng(seed)
    return {k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, -np.inf,
                                        np.inf).astype(v.dtype))
            for k, v in params.items()}


def _reference(kind, batches, test):
    """The reference runner's loop from its init and WITNESSES one-ulp
    inits: per run, the losses, stages, exact match and rel_bops (after
    PTQ at 8 bits for prune_ptq); the init (numpy); the reference run's
    final (params, eval quantizers, keep masks)."""
    jm = JBert(n_layers=2, d_model=64, n_heads=4, d_ff=256, vocab=512,
               max_seq=SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    _, bounds, bits_init = RUNNERS[kind]
    qadg = j_build_qadg(jm.build_graph().graph)
    cfg = G.qasso_cfg(STEPS, SPARSITY, **bounds)
    qasso = JQASSO(qadg.space, qadg.sites, cfg, j_constant(2e-3))
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jt = {k: jnp.asarray(v) for k, v in test.items()}

    @jax.jit
    def step(p, q, s, b):
        loss, (gx, gq) = jax.value_and_grad(jm.loss, argnums=(0, 1))(p, q, b)
        return qasso.update(p, q, gx, gq, s) + (loss,)

    em_fn = jax.jit(jm.exact_match)

    def run(p):
        q = jm.init_qparams(p, bits_init=bits_init)
        s = qasso.init(p, q)
        losses, stages = [], []
        for i in range(cfg.total_steps):
            p, q, s, met, loss = step(p, q, s, jb[i])
            losses.append(float(loss))
            stages.append(int(met["stage"]))
        bits = [float(bit_width(v.d, v.q_m, v.t)) for v in q.values()]
        if kind == "prune_ptq":
            q = jm.init_qparams(p, bits_init=8.0)
        bops = j_model_bops(qadg, p, q, jm.layer_macs(1, SEQ),
                            masks=s.keep_mask)["rel_bops"]
        return ({"losses": losses, "stages": stages,
                 "em": float(em_fn(p, q, jt)), "rel_bops": bops,
                 "k_units": qasso.k_units, "bits_min": min(bits),
                 "bits_max": max(bits)}, (p, q, s.keep_mask))

    init = _np(jp)
    runs = [run(jp)] + [run(jax.tree_util.tree_map(jnp.asarray,
                                                   _ulp(init, s)))
                        for s in range(WITNESSES)]
    return [r for r, _ in runs], init, runs[0][1]


@pytest.fixture(scope="module")
def data():
    batches = [_qa(j_qa_batch(0, i, BATCH, SEQ, 512)) for i in range(STEPS)]
    test = _qa(j_qa_batch(1, E.TEST_STEP["bert"], 128, SEQ, 512))
    return batches, test


@pytest.fixture(scope="module", params=list(RUNNERS))
def bert_run(request, data):
    return (request.param, *data, *_reference(request.param, *data))


def _spread(results, key):
    ref = results[0][key]
    return max(abs(w[key] - ref) for w in results[1:])


def test_bert_runner_matches_reference(bert_run):
    kind, batches, test, results, init, _ = bert_run
    fn = RUNNERS[kind][0]
    got = fn(SPARSITY, steps=STEPS, batch=BATCH, seq=SEQ, device="cpu",
             init_params=init, batches=lambda i: batches[i],
             test_batch=test)
    ref = results[0]
    assert got["stages"] == ref["stages"] == [0, 1, 1, 1, 2, 2, 2, 2, 3, 3,
                                              3]
    assert got["k_units"] == ref["k_units"] == got["pruned_units"]
    assert got["nonzero_pruned"] == 0
    if kind == "geta":
        assert (got["bit_lower"] - 1e-3 <= got["bits_min"]
                and got["bits_max"] <= got["bit_upper_final"] + 1e-3)
    for i, (g, r) in enumerate(zip(got["losses"], ref["losses"])):
        spread = max(abs(w["losses"][j] - ref["losses"][j])
                     for w in results[1:] for j in range(i + 1))
        assert abs(g - r) <= max(4 * spread, 1e-5 * abs(r)), (i, g, r,
                                                              spread)
    for key in ("em", "rel_bops", "bits_min", "bits_max"):
        assert abs(got[key] - ref[key]) <= (4 * _spread(results, key)
                                            + 1e-6 * abs(ref[key])), key
    assert 0.0 < got["rel_bops"] < 1.0


def test_bert_tail_matches_reference_on_the_same_params(bert_run):
    kind, _, test, results, _, (p, q, keep) = bert_run
    model = BertEncoder(**E.BERT_R, max_seq=SEQ)
    qadg = build_qadg(model.build_graph().graph)
    got = E.bert_tail(
        model, qadg, params_from_numpy(_np(p)),
        qparams_from_numpy({k: (np.asarray(v.d), np.asarray(v.q_m),
                                np.asarray(v.t)) for k, v in q.items()}),
        {k: torch.from_numpy(np.array(v)) for k, v in keep.items()},
        {k: torch.from_numpy(v) for k, v in test.items()}, SEQ)
    assert got["em"] == results[0]["em"]
    assert got["rel_bops"] == pytest.approx(results[0]["rel_bops"],
                                            rel=1e-6)

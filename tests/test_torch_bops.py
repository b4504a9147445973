"""BOPs accounting (`repro_torch.core.bops`) and the global partition on
the CNN substrate, against the JAX package's: mirrors of
`tests/test_distributed.py`'s `test_bops_reduction_from_pruning_and_quant`,
`test_partition_sizes_exact` and `test_partition_pinned_sticky` on VGG7,
and `model_bops` held to the JAX package's `model_bops` within 1e-6
relative on the same params, quantizers (per-site bit widths from 2 to 16,
t != 1, activation sites) and keep masks (a random third of every
family's units pruned), for VGG7, ResNet20 and the BERT encoder.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.bops import model_bops as j_model_bops
from repro.core.qadg import build_qadg as j_build_qadg
from repro.core.quant import QuantParams as JQuantParams
from repro.models import bert as JB
from repro.models import cnn as JC
from repro_torch.core.bops import (LayerMacs, layer_macs_conv,
                                   layer_macs_linear, model_bops)
from repro_torch.core.qadg import build_qadg
from repro_torch.core.quant import init_quant_params
from repro_torch.core.saliency import global_redundancy_partition
from repro_torch.models import bert as TB
from repro_torch.models import cnn as TC


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops: one intra-op thread, so parallel suite workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg7():
    m = TC.CNN(TC.VGG7)
    params = m.init(torch.Generator().manual_seed(0))
    return m, params, build_qadg(m.build_graph().graph)


def test_bops_reduction_from_pruning_and_quant(vgg7):
    m, params, qadg = vgg7
    macs = m.layer_macs(batch=1)
    full = model_bops(qadg, params, m.init_qparams(params, bits_init=32.0),
                      macs)
    assert full["rel_bops"] == pytest.approx(1.0, rel=1e-6)
    assert isinstance(full["bops"], float)
    q8 = m.init_qparams(params, bits_init=8.0)
    quantized = model_bops(qadg, params, q8, macs)
    assert quantized["rel_bops"] == pytest.approx(0.25, rel=1e-2)
    masks = {k: torch.cat([torch.zeros(len(v) // 2), v[len(v) // 2:]])
             for k, v in qadg.space.init_masks().items()}
    pruned = model_bops(qadg, params, q8, macs, masks=masks)
    assert pruned["rel_bops"] < quantized["rel_bops"] * 0.6


@pytest.mark.parametrize("n_red", [0, 7, 100])
def test_partition_sizes_exact(vgg7, n_red):
    _, params, qadg = vgg7
    gen = torch.Generator().manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in params.items()}
    part = global_redundancy_partition(qadg.space, params, grads, n_red)
    assert sum(int(v.sum()) for v in part.values()) == n_red


def test_partition_pinned_sticky(vgg7):
    _, params, qadg = vgg7
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    p1 = global_redundancy_partition(qadg.space, params, grads, 10)
    p2 = global_redundancy_partition(qadg.space, params, grads, 20,
                                     pinned=p1)
    for k in p1:
        # every previously-redundant unit remains redundant
        assert torch.all(p2[k] >= p1[k])
    assert sum(int(v.sum()) for v in p2.values()) == 20


def test_layer_macs_helpers():
    assert layer_macs_linear("fc", (64, 10), 8, "fc.w") == LayerMacs(
        "fc", 8.0 * 64 * 10, "fc.w")
    assert layer_macs_conv("c", (3, 3, 16, 32), (8, 8), 2, "c.w") == \
        LayerMacs("c", 2.0 * 8 * 8 * 9 * 16 * 32, "c.w")


def _models():
    return {"vgg7": (JC.CNN(JC.VGG7), TC.CNN(TC.VGG7),
                     lambda m: m.layer_macs(batch=4)),
            "resnet20": (JC.CNN(JC.RESNET20), TC.CNN(TC.RESNET20),
                         lambda m: m.layer_macs(batch=4)),
            "bert": (JB.BertEncoder(), TB.BertEncoder(),
                     lambda m: m.layer_macs(4, 64))}


@pytest.mark.parametrize("name", ["vgg7", "resnet20", "bert"])
def test_model_bops_matches_jax(name):
    jm, m, macs_of = _models()[name]
    params = m.init(torch.Generator().manual_seed(2))
    qadg = build_qadg(m.build_graph(act_quant=True).graph)
    jqadg = j_build_qadg(jm.build_graph(act_quant=True).graph)
    rng = np.random.default_rng(3)
    qparams = {}
    for site in qadg.sites:
        q_m = 4.0 if site.kind == "act" else float(
            params[site.quantized_params[0]].abs().max())
        qparams[site.name] = init_quant_params(
            q_m=q_m, bits=float(rng.uniform(2.0, 16.0)),
            t=float(rng.uniform(0.8, 1.2)))
    masks = {f.name: torch.from_numpy(
        (rng.uniform(size=f.units) > 0.33).astype(np.float32))
        for f in qadg.space.prunable_families()}
    jq = {k: JQuantParams(*(np.asarray(v.numpy()) for v in (q.d, q.q_m,
                                                             q.t)))
          for k, q in qparams.items()}
    jparams = {k: v.numpy() for k, v in params.items()}
    for kw in ({}, {"masks": masks}):
        got = model_bops(qadg, params, qparams, macs_of(m), **kw)
        want = j_model_bops(jqadg, jparams, jq, macs_of(jm), **{
            k: {f: v.numpy() for f, v in d.items()} for k, d in kw.items()})
        assert got["rel_bops"] < 1.0
        for key in ("bops", "baseline_bops", "rel_bops"):
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
        assert set(got["per_layer"]) == set(want["per_layer"])
        for v, layer in want["per_layer"].items():
            for f in ("macs", "b_w", "b_a", "bops"):
                assert got["per_layer"][v][f] == pytest.approx(
                    layer[f], rel=1e-6), (v, f)

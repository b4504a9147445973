"""The port's QADG (Algorithm 1) and pruning space against the JAX
package's.

`repro_torch.core.graph` / `qadg` are copies of pure-Python modules, so the
internlm2 smoke LM's graph must give the same families (names, units,
members, prunable, kind) and the same quantization sites, with and
without activation quantization. The toy-graph tests mirror
`tests/test_qadg.py`; the pruning-space operations (masks, materialize,
sparsity) are held to the JAX package's on the same numpy params, exactly
(they only select and multiply by 0/1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.qadg import build_qadg as j_build_qadg
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.graph import GraphBuilder
from repro_torch.core.groups import GroupFamily, Member, PruningSpace
from repro_torch.core.qadg import build_qadg
from repro_torch.models.transformer import LM

ARCH = "internlm2-1.8b"


def _space_key(space):
    return [(f.name, f.units, [(m.param, m.axis, m.unit_size, m.layout)
                               for m in f.members], f.prunable, f.kind)
            for f in space.families]


@pytest.mark.parametrize("act_quant", [False, True])
def test_lm_qadg_identical_to_jax(act_quant):
    want = j_build_qadg(JLM(j_get_arch(ARCH, smoke=True))
                        .build_graph(act_quant=act_quant).graph)
    got = build_qadg(LM(get_arch(ARCH, smoke=True))
                     .build_graph(act_quant=act_quant).graph)
    assert _space_key(got.space) == _space_key(want.space)
    assert [tuple(vars(s).values()) for s in got.sites] == \
        [tuple(vars(s).values()) for s in want.sites]
    assert sorted(got.graph.vertices) == sorted(want.graph.vertices)
    assert got.space.total_units() == want.space.total_units() > 0
    kinds = {s.kind for s in got.sites}
    assert kinds == ({"weight", "act"} if act_quant else {"weight"})


def test_lm_space_validates_on_port_params():
    lm = LM(get_arch(ARCH, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    qadg = build_qadg(lm.build_graph(act_quant=True).graph)
    qadg.space.validate(params)
    # the graph carries the MLP activation site only, as the JAX package's
    assert len(qadg.sites) == len(lm.quant_weight_names()) + 1


def test_pruning_space_ops_match_jax():
    """apply_masks / materialize / sparsity on the LM's space."""
    jlm = JLM(j_get_arch(ARCH, smoke=True))
    jp, _ = jlm.init(jax.random.PRNGKey(0))
    jq = j_build_qadg(jlm.build_graph().graph)
    tq = build_qadg(LM(get_arch(ARCH, smoke=True)).build_graph().graph)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(0)
    masks = {f.name: (rng.random(f.units) > 0.4).astype(np.float32)
             for f in jq.space.prunable_families()}
    jm = jq.space.apply_masks(jp, {k: jnp.asarray(v)
                                   for k, v in masks.items()})
    tm = tq.space.apply_masks(tp, {k: torch.from_numpy(v)
                                   for k, v in masks.items()})
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    jsub, jkept = jq.space.materialize(jp, {k: jnp.asarray(v)
                                            for k, v in masks.items()})
    tsub, tkept = tq.space.materialize(tp, {k: torch.from_numpy(v)
                                            for k, v in masks.items()})
    for k in jsub:
        np.testing.assert_array_equal(tsub[k].numpy(), np.asarray(jsub[k]))
    for k in jkept:
        np.testing.assert_array_equal(tkept[k], jkept[k])
    assert float(tq.space.sparsity({k: torch.from_numpy(v)
                                    for k, v in masks.items()})) == \
        pytest.approx(float(jq.space.sparsity(masks)))


# ----------------------------------------------- mirrors of test_qadg.py
def _toy_graph(act_quant=True):
    gb = GraphBuilder()
    gb.input("in")
    gb.conv("conv1", "conv1.w", bias="conv1.b", out_dim=16)
    gb.bn("bn1", "bn1.scale", "bn1.bias")
    gb.act("relu1")
    gb.conv("conv2", "conv2.w", out_dim=16, after="relu1")
    gb.bn("bn2", "bn2.scale", "bn2.bias")
    gb.add("add1", ["bn2", "relu1"])
    gb.act("relu2")
    gb.pool("gap")
    gb.linear("fc", "fc.w", bias="fc.b", out_dim=10, non_prunable=True)
    gb.output("out")
    gb.attach_weight_quant("conv1", "conv1.w.wq")
    gb.attach_weight_quant("conv2", "conv2.w.wq")
    gb.attach_weight_quant("fc", "fc.w.wq")
    if act_quant:
        gb.insert_act_quant("relu1", "conv2", "relu1.aq")
    return gb


def test_attached_branches_merged():
    gb = _toy_graph()
    assert len(gb.graph.quant_vertices()) > 0
    qadg = build_qadg(gb.graph)
    assert len(qadg.graph.quant_vertices()) == 0
    assert sorted(s.kind for s in qadg.sites) == ["act", "weight", "weight",
                                                  "weight"]


def test_inserted_branch_preserves_connectivity():
    qadg = build_qadg(_toy_graph().graph)
    assert "out" in qadg.graph.topo_order()


def test_residual_ties_spaces():
    qadg = build_qadg(_toy_graph().graph)
    fams = qadg.space.prunable_families()
    assert len(fams) == 1
    members = {(m.param, m.axis) for m in fams[0].members}
    assert {("conv1.w", 3), ("conv2.w", 3), ("conv2.w", 2), ("bn1.scale", 0),
            ("fc.w", 0)} <= members


def test_site_targets_weight_only():
    qadg = build_qadg(_toy_graph().graph)
    for s in qadg.sites:
        if s.kind == "weight":
            assert all(p.endswith(".w") for p in s.quantized_params)


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
@pytest.mark.parametrize("units,unit_size,n_zero", [(5, 3, 2), (8, 1, 0),
                                                   (4, 2, 4)])
def test_mask_apply_materialize_consistency(units, unit_size, n_zero, layout):
    fam = GroupFamily("f", units, [Member("w", 0, unit_size, layout)])
    space = PruningSpace([fam])
    w = torch.arange(units * unit_size * 3, dtype=torch.float32).reshape(
        units * unit_size, 3) + 1.0
    space.validate({"w": w})
    mask = torch.ones(units)
    mask[:n_zero] = 0.0
    masked = space.apply_masks({"w": w}, {"f": mask})["w"]
    sub, kept = space.materialize({"w": w}, {"f": mask})
    assert sub["w"].shape[0] == (units - n_zero) * unit_size
    assert torch.equal(sub["w"], masked[masked.abs().sum(1) > 0])
    assert float(space.sparsity({"f": mask})) == pytest.approx(n_zero / units)

"""The port's sharding rules and cross-rank reductions against the JAX
package's (`tests/test_distributed.py`'s 8 sharding and collectives
tests, mirrored), and the port's axes dicts, plans and specs against the
JAX package's for every arch.

The rules read only a mesh's shape, so a `Mesh` of axis names and sizes
stands in for the reference's abstract meshes; the JAX side runs on
`abstract_mesh`, which needs no devices. The collectives run on a
`RankPool` of 4 CPU ranks over gloo (the module's `ranks`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks as R
from repro.configs import _ARCH_MODULES
from repro.configs import get_arch as jget_arch
from repro.configs import get_overrides as jget_overrides
from repro.distributed import collectives as JC
from repro.distributed import sharding as JS
from repro.launch.mesh import abstract_mesh
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_arch, get_overrides
from repro_torch.core.subnet import prepare_serving
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (batch_spec, kv_cache_specs,
                                              local_shard, make_plan,
                                              serving_param_specs)
from repro_torch.launch.mesh import Mesh, RankPool
from repro_torch.models.transformer import LM

ARCHS = sorted(_ARCH_MODULES)


@pytest.fixture(scope="module")
def ranks():
    with RankPool(4, "cpu", verbose=False) as pool:
        yield pool


# ---------------------------------------------- test_distributed mirrors
def test_sharding_plan_divisibility_fallback():
    plan = make_plan(Mesh(("data", "model"), (1, 1)))
    # model axis is size 1 here: every spec must be valid (no exceptions)
    spec = plan.spec_for("w", ("embed", "mlp"), (64, 128))
    assert spec == (None, None)


def test_sharding_plan_records_fallbacks():
    plan = make_plan(Mesh(("data", "model"), (16, 16)))
    spec = plan.spec_for("w", ("embed", "kv_heads"), (64, 24))
    # 24 % 16 != 0 -> fallback recorded, axis replicated
    assert spec == (None, None)
    assert any(a == "kv_heads" for _, a, _ in plan.fallbacks)


def test_fsdp_rules():
    plan = make_plan(Mesh(("pod", "data", "model"), (2, 16, 16)), fsdp=True)
    spec = plan.spec_for("w", ("embed", "mlp"), (8192, 32768))
    assert spec == (("pod", "data"), "model")


def test_arch_overrides_respected():
    plan = make_plan(Mesh(("data", "model"), (16, 16)),
                     overrides={"fsdp": True, "experts_axis": None,
                                "expert_mlp_axis": "model",
                                "base_optimizer": "momentum"})
    spec = plan.spec_for("we", ("experts", "embed", "expert_mlp"),
                         (8, 6144, 32768))
    assert spec == (None, "data", "model")


def test_batch_spec_sp():
    mesh = Mesh(("pod", "data", "model"), (2, 16, 16))
    assert batch_spec(mesh) == (("pod", "data"),)
    assert batch_spec(mesh, shard_seq=True) == (None, ("pod", "data"))


def test_blockwise_quantization_error_bound():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4096,)) * 3)
    codes, scale = C._quantize_blockwise(torch.from_numpy(x.copy()))
    xr = C._dequantize_blockwise(codes, scale)[: x.size].numpy()
    # int8 with per-block max scaling: error <= scale/2 per element
    err = np.abs(x - xr)
    bound = np.repeat(scale.numpy()[:, 0], 256)[: x.size] * 0.5 + 1e-7
    assert np.all(err <= bound)
    # the same codes and scales as the reference's
    jcodes, jscale = JC._quantize_blockwise(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def _collectives(ranks):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    g = (rng.standard_normal(300) * 1e-3).astype(np.float32)
    return x, g, ranks.run(R.collectives_case, x, g)


def test_compressed_psum_semantics(ranks):
    """compressed all-reduce ~= psum within int8 quantization error: on
    one rank (the reference's 1-device case) within 2e-2 and equal to the
    reference's; on 4 ranks within each rank's half-quantum summed, the
    same on every rank; the ordered sum is the rank-order f32 sum."""
    from repro.distributed.collectives import shard_map
    from repro.launch.mesh import make_mesh
    x1 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 512)))
    got = C.compressed_psum(torch.from_numpy(x1[0].copy()),
                            Mesh(("data",), (1,)), "data").numpy()
    np.testing.assert_allclose(got, x1.sum(0), rtol=2e-2, atol=2e-2)
    jout = shard_map(lambda xs: JC.compressed_psum(xs[0], "data"),
                     mesh=make_mesh((1,), ("data",)), in_specs=(P("data"),),
                     out_specs=P(), check_vma=False)(jnp.asarray(x1))
    np.testing.assert_array_equal(got, np.asarray(jout))
    x, _, res = _collectives(ranks)
    want = x[0] + x[1] + x[2] + x[3]
    half_quanta = sum(np.repeat(np.abs(r).reshape(-1, 256).max(1) / 127.0,
                                256) for r in x) / 2
    for psum, osum, _, _ in res:
        assert np.all(np.abs(psum - x.sum(0)) <= half_quanta + 1e-6)
        np.testing.assert_array_equal(psum, res[0][0])
        np.testing.assert_array_equal(osum, want)


def test_error_feedback_accumulates(ranks):
    _, g, res = _collectives(ranks)
    for _, _, mean, ef in res:
        sent = g - ef
        # sent + residual == original (error feedback identity), and every
        # rank sent the same codes, so the mean is what one rank sent
        np.testing.assert_allclose(sent + ef, g, rtol=1e-6)
        np.testing.assert_allclose(mean, sent, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("spec,layout", [
    (("data", None), (4, 1)), ((None, "model"), (1, 4)),
    ((("data", "model"), None), (2, 2)), (("model", "data"), (2, 2))])
def test_local_shard_gather_full_roundtrip(ranks, spec, layout):
    """gather_full(local_shard(x)) is x bit for bit, each rank's piece the
    tile of its linear index over the spec's axes (major first)."""
    shape = (8, 12)
    full = np.arange(96, dtype=np.float32).reshape(shape)
    res = ranks.run(R.shard_roundtrip, shape, spec, layout)
    mesh = Mesh(("data", "model"), layout)
    for r, (piece, back) in enumerate(res):
        mesh.rank = r
        np.testing.assert_array_equal(back, full)
        np.testing.assert_array_equal(
            piece, local_shard(torch.from_numpy(full), spec, mesh).numpy())


# ------------------------------------------- the JAX package's specs
_AXES: dict = {}


def _jax_axes(arch):
    if arch not in _AXES:
        cap: dict = {}

        def f(k):
            p, a = JLM(jget_arch(arch, smoke=True)).init(k)
            cap.update(a)
            return p

        shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
        _AXES[arch] = (cap, {k: tuple(v.shape) for k, v in shapes.items()})
    return _AXES[arch]


def _jspec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_plans_and_specs_match_reference(arch):
    """For the arch's smoke config: `LM.param_axes` equals the JAX init's
    axes dict, and on (1, n) and (n, 1) meshes at n = 2 and 4, modes tp
    and zero, fsdp on and off, every param's spec, the fallbacks, the
    served params' specs and the KV arena's specs equal the JAX
    package's."""
    jaxes, jshapes = _jax_axes(arch)
    lm = LM(get_arch(arch, smoke=True))
    axes = lm.param_axes()
    assert axes == jaxes
    params = lm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == jshapes
    served = {}
    if not (lm.cfg.num_codebooks or lm.cfg.vision_patches):
        served, _, _ = prepare_serving(lm, params, packed=True, bits_init=4.0)
        arena = {k: tuple(v.shape) for k, v in
                 lm.init_cache(2, 16, device="cpu").items()}
    for n in (2, 4):
        for layout in ((1, n), (n, 1)):
            jmesh = abstract_mesh(layout, ("data", "model"))
            mesh = Mesh(("data", "model"), layout)
            for mode in ("tp", "zero"):
                for fsdp in (False, True):
                    kw = dict(fsdp=fsdp, mode=mode,
                              overrides=dict(get_overrides(arch)))
                    jkw = dict(kw, overrides=dict(jget_overrides(arch)))
                    plan, jplan = make_plan(mesh, **kw), JS.make_plan(
                        jmesh, **jkw)
                    assert plan.rules == jplan.rules
                    got = {k: s.spec for k, s in plan.shardings(
                        axes, jshapes).items()}
                    want = {k: _jspec(s.spec) for k, s in jplan.shardings(
                        jaxes, jshapes).items()}
                    assert got == want, (layout, mode, fsdp)
                    assert plan.fallbacks == jplan.fallbacks
                    assert batch_spec(mesh, mode=mode) == _jspec(
                        JS.batch_spec(jmesh, mode=mode))
            if served:
                plan = make_plan(mesh, mode="tp")
                jplan = JS.make_plan(jmesh, mode="tp")
                got = serving_param_specs(plan, axes, served)
                want = JS.serving_param_specs(
                    jplan, jaxes, {k: np.zeros(tuple(v.shape), np.int8)
                                   for k, v in served.items()})
                assert got == {k: _jspec(v) for k, v in want.items()}
                assert plan.fallbacks == jplan.fallbacks
                # the K/V leaves shard as the reference's; the recurrent
                # state, which the reference replicates, shards with its
                # mixer's channels (mamba) or heads (rwkv6) where the
                # model axis divides them
                got = kv_cache_specs(mesh, arena)
                for k, v in JS.kv_cache_specs(jmesh, arena).items():
                    if k.rpartition(".")[2] not in ("h", "conv", "wkv"):
                        assert got[k] == _jspec(v), k
                        continue
                    assert not any(_jspec(v)), k
                    dim = 3 if k.endswith(".conv") else 2
                    shard = layout[1] > 1 and arena[k][dim] % layout[1] == 0
                    assert got[k] == ((None,) * dim + ("model",) if shard
                                      else ()), k

"""The dry run (`repro_torch.launch.dryrun`, `launch.specs`,
`launch.mesh.make_production_mesh`) against the JAX package's
(`repro.launch.specs`, `repro.launch.dryrun`, `tests/test_dryrun_small.py`).

- `param_specs`, `batch_specs` and `decode_specs`: global shapes and
  dtypes equal the reference's with mesh=None for every arch (the port's
  token ids are int64, torch's index dtype, where the reference's are
  int32).
- On the production mesh (16 x 16, data x model): every param's local
  shard shape equals the reference plan's (`NamedSharding.shard_shape`),
  and so does every batch leaf's; the decode records' token and state
  leaves too, and the K/V leaves where the KV heads divide the model axis
  (elsewhere the reference splits d_head, which the port's
  tensor-parallel layers cannot: the port keeps the heads whole).
- The meta dry run of internlm2-1.8b `train_4k` (every QASSO stage) and
  rwkv6-3b `decode_32k` at depth 1 on a (2, 2, 2) pod x data x model
  mesh, with `test_dryrun_small_mesh`'s asserts: flops > 1e9, wire > 0,
  a data-parallel gradient collective present, decode flops > 0; and
  the other cell kinds there (tensor-parallel prefill, prequant decode,
  the base optimizer's step, the FSDP plan).
- The smoke config's GETA step on a 1 x 1 mesh in every stage: the meta
  launch record by (variant, epilogue, K, N) and by (direction, shape)
  equals the kernel wrappers' calls when the same step runs on the CPU.
- Its counted FLOPs: exactly 6 (N_block + N_head) T for the products
  (forward, dx and dw; the smoke config has no remat) plus 12 T S H dh L
  for attention (every row against every column, forward and backward).
  That is 0.857 of `model_flops_for`, which counts 6 N T for the
  embedding too (a lookup does no products) and half the scores (causal).
- `serve_attn` psum / seqshard raise; a failing cell is recorded with
  ok=False.
"""
import collections
import math

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import get_overrides as jget_overrides
from repro.distributed.sharding import make_plan as jmake_plan
from repro.launch import specs as JS
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro.models.transformer import LM as JLM
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_arch,
                                 get_overrides)
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import make_plan
from repro_torch.kernels import fake_quant as fq
from repro_torch.kernels import gemm_core as gc
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM
from repro_torch.roofline import analysis as RA

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int32": torch.int64}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(rec: S.ArraySpec, sds) -> None:
    assert rec.shape == tuple(sds.shape)
    assert rec.dtype == _DT[str(sds.dtype)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_global_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    got, shardings, axes = S.param_specs(LM(cfg))
    want, _, jaxes = JS.param_specs(JLM(jcfg), None)
    assert set(got) == set(want) and axes == jaxes
    assert all(v is None for v in shardings.values())
    for k in want:
        _same(got[k], want[k])
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        if SHAPES[name].kind == "decode":
            d, jd = S.decode_specs(cfg, SHAPES[name]), JS.decode_specs(
                jcfg, JSHAPES[name])
            assert set(d["caches"]) == set(jd["caches"])
            for k in jd["caches"]:
                _same(d["caches"][k], jd["caches"][k])
            _same(d["token"], jd["token"])
            _same(d["pos"], jd["pos"])
        else:
            b = S.batch_specs(cfg, SHAPES[name])
            jb = JS.batch_specs(jcfg, JSHAPES[name])
            assert set(b) == set(jb)
            for k in jb:
                _same(b[k], jb[k])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_local_shards_on_the_production_mesh_match_reference(arch):
    mesh, jmesh = M.make_production_mesh(), jabstract_mesh((16, 16),
                                                           ("data", "model"))
    assert mesh.shape == dict(jmesh.shape)
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    plan = make_plan(mesh, overrides=dict(get_overrides(arch)))
    jplan = jmake_plan(jmesh, overrides=dict(jget_overrides(arch)))
    got, _, _ = S.param_specs(LM(cfg), mesh, plan)
    want, jsh, _ = JS.param_specs(JLM(jcfg), jmesh, jplan)
    for k, sds in want.items():
        assert got[k].local_shape == jsh[k].shard_shape(sds.shape), k
    b = S.batch_specs(cfg, SHAPES["train_4k"], mesh)
    for k, sds in JS.batch_specs(jcfg, JSHAPES["train_4k"], jmesh).items():
        assert b[k].local_shape == sds.sharding.shard_shape(sds.shape), k
    d = S.decode_specs(cfg, SHAPES["decode_32k"], mesh)
    jd = JS.decode_specs(jcfg, JSHAPES["decode_32k"], jmesh)
    for k, sds in jd["caches"].items():
        want_local = sds.sharding.shard_shape(sds.shape)
        rec = d["caches"][k]
        if (k.endswith(".k") or k.endswith(".v")) and sds.shape[3] % 16:
            # the reference splits d_head; the port keeps the heads whole
            assert rec.local_shape == (*want_local[:3], sds.shape[3],
                                       sds.shape[4]), k
        else:
            assert rec.local_shape == want_local, k
    assert d["token"].local_shape == jd["token"].sharding.shard_shape(
        jd["token"].shape)


def test_dryrun_small_mesh():
    mesh = M.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    train = DR.run_cell("internlm2-1.8b", "train_4k", mesh, "2x2x2",
                        depth=1, verbose=False)
    assert train["ok"], train.get("trace")
    assert set(train["stages"]) == set(DR.STAGES)
    for stage in train["stages"].values():
        assert stage["flops"] > 1e9
        assert stage["wire_bytes"] > 0        # DP gradient collectives
        assert any(k in stage["collectives"] for k in (
            "all-reduce", "all-gather", "reduce-scatter"))
    assert train["flops_per_dev"] > 1e9 and train["wire_bytes_per_dev"] > 0
    assert train["arg_gb"] > 0 and train["temp_gb"] > 0
    decode = DR.run_cell("rwkv6-3b", "decode_32k", mesh, "2x2x2", depth=1,
                         verbose=False)
    assert decode["ok"], decode.get("trace")
    assert decode["flops_per_dev"] > 0


@pytest.mark.parametrize("kind,kw", [
    ("prefill", {}), ("decode", {"serve_quant": "prequant"}),
    ("train", {"step": "base"}), ("train", {"mode": "zero"})])
def test_every_cell_kind_runs_on_a_sharded_mesh(kind, kw):
    """The prefill cell (tensor parallel on `model`: its gathers and
    ordered sums logged), the prequant decode cell, the base optimizer's
    step and the FSDP plan, at internlm2-1.8b's full width and depth 1
    (prefill 8 x 4096: the blockwise attention)."""
    mesh = M.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    seq = {"prefill": 4096, "decode": 2048, "train": 512}[kind]
    rec = DR.run_cell("internlm2-1.8b", ShapeConfig(kind, seq, 8, kind),
                      mesh, "2x2x2", depth=1, verbose=False, **kw)
    assert rec["ok"], rec.get("trace")
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    if kind != "decode":
        assert rec["flops_per_dev"] > 1e9 and rec["wire_bytes_per_dev"] > 0
    if kind == "prefill":
        assert rec["tensor_parallel"]


SMOKE_SHAPE = ShapeConfig("smoke", 16, 2, "train")


def _cpu_calls(monkeypatch) -> collections.Counter:
    """Count the kernel wrappers' calls on CPU tensors by the meta
    record's keys."""
    calls = collections.Counter()
    real_gemm, real_fwd, real_bwd = (gc.gemm, fq.fake_quant_fwd,
                                     fq.fake_quant_bwd)

    def gemm(x, w, epi, **kw):
        calls[(gc.variant(x.shape[0], x.dtype), epi.name, x.shape[1],
               w.shape[1])] += 1
        return real_gemm(x, w, epi, **kw)

    def fwd(x, *a):
        calls[("fwd", tuple(x.shape))] += 1
        return real_fwd(x, *a)

    def bwd(x, *a):
        calls[("bwd", tuple(x.shape))] += 1
        return real_bwd(x, *a)

    monkeypatch.setattr(gc, "gemm", gemm)
    monkeypatch.setattr(fq, "fake_quant_fwd", fwd)
    monkeypatch.setattr(fq, "fake_quant_bwd", bwd)
    return calls


def test_meta_launches_equal_the_cpu_calls_of_the_same_step(monkeypatch):
    cell, cfg, _ = DR.build_cell("internlm2-1.8b", SMOKE_SHAPE,
                                 M.abstract_mesh((1, 1), ("data", "model")),
                                 smoke=True)
    stages = DR.run(cell)
    lm, params, qparams, _, qasso, qstate = T.init_geta(
        "internlm2-1.8b", True, comp=DR._DRYRUN_COMP, device="cpu")
    step, _ = T.make_sharded_geta_train_step(
        lm, qasso, M.make_subset_mesh(1), params, qparams)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    first = {"warmup": 0, "projection": qasso.cfg.warmup_end,
             "joint": qasso.cfg.projection_end,
             "cooldown": qasso.cfg.joint_end}
    calls = _cpu_calls(monkeypatch)
    for name in DR.STAGES:
        calls.clear()
        step(params, qparams, qstate._replace(step=first[name]), batch)
        record = kmeta.tally(stages[name]["launches"])
        assert record == calls, name
        assert sum(calls.values()) > 0
    # counted FLOPs (see the module docstring)
    p, _, _ = S.param_specs(LM(cfg))
    n_blk = sum(math.prod(r.shape) for k, r in p.items()
                if k.startswith("blocks.") and len(r.shape) == 3)
    n_head = math.prod(p["head"].shape)
    toks, seq = 2 * 16, 16
    want = (6 * (n_blk + n_head) * toks
            + 12 * toks * seq * cfg.n_heads * cfg.d_head * cfg.n_layers)
    assert not cfg.remat
    for name in DR.STAGES:
        assert stages[name]["flops"] == want, name
    ratio = want / RA.model_flops_for(cfg, SMOKE_SHAPE)
    assert ratio == pytest.approx(0.857, abs=1e-3)


def test_gspmd_pins_raise_and_a_failing_cell_is_recorded():
    mesh = M.make_production_mesh()
    for attn in ("psum", "seqshard"):
        with pytest.raises(ValueError, match="GSPMD"):
            DR.build_cell("internlm2-1.8b", "decode_32k", mesh,
                          serve_attn=attn)
    rec = DR.run_cell("internlm2-1.8b", "decode_32k", mesh, "1pod",
                      verbose=False, serve_attn="psum")
    assert rec["ok"] is False and "GSPMD" in rec["error"]


def test_production_mesh_shapes():
    one, two = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert not one.member and M.meta_rank(two).coords == {
        "pod": 0, "data": 0, "model": 0}
    assert np.prod(M.abstract_mesh((4, 2), ("data", "model")).sizes) == 8

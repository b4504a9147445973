"""The GEMM plan tuner (`repro_torch.kernels.autotune`), on the CPU.

Counterparts of the 8 tests of `tests/test_autotune.py`: the table
round-trips through the ``REPRO_GEMM_TUNE_CACHE`` JSON file, a corrupt or
missing file never breaks a call, candidates are valid plans without
duplicates, the tuner refuses what has no plan (CPU tensors, the SIMT
variant), and a recorded plan is the one the next call takes, shown here
on the meta route's launch record (timing needs the card:
`tests/test_torch_gpu.py`). Beside them: `ops_key` names every epilogue
as the JAX package's does, an empty table leaves every call on its rule's
plan, the small-M key names no epilogue and a column tile looks up with
its full width (`plan_n`).
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import gemm_core as jgc
from repro_torch.kernels import autotune, gemm_core, introspect

SM = introspect.H100_SMS


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    """Every test starts with an empty in-memory table and no cache file;
    opt in per test with monkeypatch.setenv."""
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.clear()
    yield
    autotune.clear()


def _meta_gemm(M, K, N, epi, x_dtype=torch.bfloat16, w_dtype=torch.int8,
               plan_n=None):
    x = torch.empty((M, K), dtype=x_dtype, device="meta")
    w = torch.empty((K, N), dtype=w_dtype, device="meta")
    with introspect.record_launches() as launches:
        gemm_core.gemm(x, w, epi, plan_n=plan_n)
    (launch,) = launches
    return launch


def test_ops_key_names_epilogue():
    scale = torch.ones(8)
    assert autotune.ops_key(gemm_core.none()) == "dense"
    assert autotune.ops_key(gemm_core.col_mask(scale)) == "col_mask"
    assert autotune.ops_key(
        gemm_core.fq_col_mask(1.0, 1.0, 1.0, scale)) == "fake_quant+col_mask"
    # packed streams encode the bit width
    k4 = autotune.ops_key(gemm_core.unpack_dequant(4, scale))
    k8 = autotune.ops_key(gemm_core.unpack_dequant(8, scale))
    assert k4 != k8


def test_ops_key_matches_the_reference():
    """Each epilogue's key is the JAX package's for the same ops."""
    m, s = np.ones(8, np.float32), np.ones(8, np.float32)
    pairs = [(gemm_core.none(), ()),
             (gemm_core.col_mask(torch.ones(8)), (jgc.col_mask(m),)),
             (gemm_core.fake_quant_rhs(0.1, 1.0, 1.0),
              (jgc.fake_quant_rhs(0.1, 1.0, 1.0),)),
             (gemm_core.fq_col_mask(0.1, 1.0, 1.0, torch.ones(8)),
              jgc.fq_mask_ops(0.1, 1.0, 1.0, m)),
             (gemm_core.dequant(torch.ones(8)), (jgc.dequant(s),))]
    pairs += [(gemm_core.unpack_dequant(b, torch.ones(8)),
               (jgc.unpack_dequant(b, s),)) for b in (2, 3, 4, 8)]
    for epi, ops in pairs:
        assert autotune.ops_key(epi) == jat.ops_key(ops), epi.name


def test_record_lookup_roundtrip_in_memory():
    assert autotune.lookup(512, 128, 64, "tc", SM, "dense") is None
    autotune.record(512, 128, 64, "tc", SM, (256,), "dense")
    assert autotune.lookup(512, 128, 64, "tc", SM, "dense") == (256,)
    # a different epilogue, variant or SM count is a distinct key
    assert autotune.lookup(512, 128, 64, "tc", SM, "col_mask") is None
    assert autotune.lookup(512, 128, 64, "small_m", SM) is None
    assert autotune.lookup(512, 128, 64, "tc", 114, "dense") is None
    # no env var: save is a no-op, nothing written anywhere
    assert autotune.save() is None


def test_cache_file_persists_and_reloads(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.record(4, 256, 128, "small_m", SM, (2, 256))
    payload = json.loads(path.read_text())
    assert payload["format"] == "repro-gemm-tune-v1"
    assert payload["blocks"][f"4x256x128|small_m|sm{SM}"] == [2, 256]
    # a fresh process (cleared memory) warms itself from the file
    autotune.clear()
    assert autotune.lookup(4, 256, 128, "small_m", SM) == (2, 256)


def test_corrupt_cache_never_breaks(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text("{ this is not json")
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.clear()
    assert autotune.lookup(8, 128, 64, "small_m", SM) is None
    # and a call still takes its rule's plan and computes
    launch = _meta_gemm(4, 2048, 8192, gemm_core.dequant(torch.ones(8192)))
    assert not launch.tuned
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    w = torch.randn(32, 64, generator=torch.Generator().manual_seed(1))
    y = gemm_core.gemm(x, w, gemm_core.none())
    np.testing.assert_allclose(y.numpy(), x.numpy() @ w.numpy(), rtol=1e-5,
                               atol=1e-5)
    # a file of the wrong shape is as harmless
    path.write_text('["a list"]')
    autotune.clear()
    assert autotune.lookup(8, 128, 64, "small_m", SM) is None


@pytest.mark.parametrize("K", [64, 1000, 2048, 5734, 8192, 32768])
def test_candidate_plans_valid_and_deduped(K):
    cands = autotune.candidate_plans(4, 2048, K, "small_m")
    assert len(cands) == len(set(cands)) >= 1
    for cluster, k_slice in cands:
        # the launcher's preconditions (csrc repro_gemm) and one row of K
        # in every block
        assert 1 <= cluster <= gemm_core.SMALL_M_CLUSTER_MAX
        assert k_slice % 256 == 0
        assert k_slice <= 2048 or k_slice % 2048 == 0
        assert (cluster - 1) * k_slice < K <= cluster * k_slice
    # the rule's own plan is among them
    for N in (256, 2048, 8192):
        rule = gemm_core.small_m_plan(4, N, K, SM)
        assert (rule.cluster, rule.k_slice) in cands
    assert autotune.candidate_plans(512, 2048, K, "tc") == [(128,), (256,)]
    with pytest.raises(ValueError, match="nothing to tune"):
        autotune.candidate_plans(512, 2048, K, "simt")


def test_autotune_refuses_cpu_and_simt():
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    w = torch.zeros((32, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="nothing to tune"):
        autotune.autotune_gemm(x, w, gemm_core.dequant(torch.ones(64)))
    # f32 x past 8 rows: the SIMT variant, which splits nothing
    with pytest.raises(ValueError, match="SIMT"):
        autotune.autotune_gemm(torch.zeros((16, 32)), torch.zeros((32, 64)),
                               gemm_core.none())


def test_smem_filter_rejects_over_budget():
    cands = autotune.candidate_plans(4, 8192, 2048, "small_m")
    epi = gemm_core.dequant(torch.ones(8192))
    fits, rejected = autotune.smem_filter(cands, 4, 8192, 2048, epi,
                                          "small_m", torch.int8)
    assert fits == cands and not rejected
    fits, rejected = autotune.smem_filter(cands, 4, 8192, 2048, epi,
                                          "small_m", torch.int8, budget=1)
    assert not fits and set(rejected) == set(cands)


def test_autotune_records_winner_and_gemm_uses_it(tmp_path, monkeypatch):
    """A recorded winner (as `autotune_gemm` records it) is the plan the
    next call launches: the meta route's record shows it, and the file
    holds it."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    scale = torch.ones(2048)
    rule = _meta_gemm(4, 8192, 2048, gemm_core.dequant(scale))
    assert rule.plan == (128, 8, 1024) and not rule.tuned
    autotune.record(4, 2048, 8192, "small_m", SM, (6, 1536))
    for epi in (gemm_core.dequant(scale), gemm_core.unpack_dequant(4, scale)):
        w_dtype = torch.int8 if epi.name == "dequant" else torch.int32
        K = 8192 if epi.name == "dequant" else 8192 // 8
        x = torch.empty((4, 8192), dtype=torch.bfloat16, device="meta")
        w = torch.empty((K, 2048), dtype=w_dtype, device="meta")
        with introspect.record_launches() as launches:
            gemm_core.gemm(x, w, epi)
        # one plan for every epilogue of the shape: dequant and unpack
        assert launches[0].plan == (128, 6, 1536) and launches[0].tuned
        assert launches[0].kernels[0].grid == (6, 16, 1)
    payload = json.loads(path.read_text())
    assert payload["blocks"][f"4x2048x8192|small_m|sm{SM}"] == [6, 1536]
    # the tensor-core variant: bm from the table
    fq = gemm_core.fake_quant_rhs(0.1, 1.0, 1.0)
    assert _meta_gemm(3072, 6144, 16384, fq, w_dtype=torch.bfloat16
                      ).plan == (256,)
    autotune.record(3072, 16384, 6144, "tc", SM, (128,), "fake_quant")
    tuned = _meta_gemm(3072, 6144, 16384, fq, w_dtype=torch.bfloat16)
    assert tuned.plan == (128,) and tuned.tuned
    assert tuned.kernels[0].grid == (128, 24, 1)


def test_autotune_persist_false_stays_in_memory(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.record(2, 64, 32, "small_m", SM, (1, 256), persist=False)
    assert not path.exists()
    assert autotune.lookup(2, 64, 32, "small_m", SM) == (1, 256)


def test_column_tile_looks_up_its_full_width():
    """`tp_gemm` passes plan_n = N: a tile takes the full-width call's
    tuned split; a tile called without it, its own key."""
    autotune.record(4, 8192, 2048, "small_m", SM, (3, 768))
    epi = gemm_core.dequant(torch.ones(4096))
    tile = _meta_gemm(4, 2048, 4096, epi, plan_n=8192)
    assert tile.plan == (128, 3, 768) and tile.tuned
    own = _meta_gemm(4, 2048, 4096, epi)
    p = gemm_core.small_m_plan(4, 4096, 2048, SM)
    assert not own.tuned and own.plan == (p.strip, p.cluster, p.k_slice)


@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (4, 2048, 8192),
                                   (8, 8192, 2048), (4, 6144, 131072),
                                   (4, 32768, 6144), (12, 2048, 92672),
                                   (512, 2048, 8192), (3072, 6144, 16384)])
def test_empty_table_takes_the_rules_plan(M, K, N):
    epi = gemm_core.fake_quant_rhs(0.1, 1.0, 1.0)
    launch = _meta_gemm(M, K, N, epi, w_dtype=torch.bfloat16)
    assert not launch.tuned
    if M <= gemm_core.SMALL_M_MAX:
        p = gemm_core.small_m_plan(M, N, K, SM)
        assert launch.plan == (p.strip, p.cluster, p.k_slice)
    else:
        assert launch.plan == (gemm_core.tc_block_m(M, N, SM),)


@pytest.mark.parametrize("samples,rule,want", [
    # the fastest's range clears the rule's: it wins
    ({(256,): [3.58, 3.59, 3.60], (128,): [4.94, 4.95, 4.96]}, (128,),
     (256,)),
    # a margin inside the spread: the rule's plan stays
    ({(6, 1536): [0.0240, 0.0242, 0.0270], (8, 1024): [0.0262, 0.0265,
                                                       0.0280]},
     (8, 1024), (8, 1024)),
    # the rule is the fastest
    ({(8, 1024): [0.020, 0.021], (6, 1536): [0.030, 0.031]}, (8, 1024),
     (8, 1024)),
    # the rule's plan is not a candidate: the fastest by median
    ({(6, 1536): [0.025, 0.028], (5, 1792): [0.024, 0.026]}, (8, 1024),
     (5, 1792)),
])
def test_choose_keeps_the_rule_inside_the_spread(samples, rule, want):
    assert autotune.choose(samples, rule) == want


def test_empty_table_without_a_file_is_inactive(tmp_path, monkeypatch):
    """With nothing recorded and no file named, `gemm` builds no key:
    `active()` is false and `lookup` finds nothing; naming a file or
    recording a plan makes it true."""
    assert not autotune.active()
    assert autotune.lookup(4, 2048, 8192, "small_m", SM) is None
    monkeypatch.setenv(autotune.ENV_VAR, str(tmp_path / "tune.json"))
    assert autotune.active()
    monkeypatch.delenv(autotune.ENV_VAR)
    autotune.record(4, 2048, 8192, "small_m", SM, (6, 1536), persist=False)
    assert autotune.active()
    assert autotune.lookup(4, 2048, 8192, "small_m", SM) == (6, 1536)

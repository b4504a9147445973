"""The port's tensor-parallel serving against the JAX package's
(`tests/test_tp_engine.py`: its 16 tests are mirrored here, its engine
cases in the paged and packed modes in `tests/test_torch_tp_modes.py`
and the speculative and chunked ones in `tests/test_torch_tp_spec.py`,
which share this module's helpers), on CPU ranks over gloo.

One `RankPool` of 4 ranks serves the module (`ranks`); a tp-2 case runs
on its first two ranks. Every rank imports only torch and the port
(`tests/torch_ranks.py`); the JAX side runs once per module in this
process, on one device: the oracle for the engine is the JAX package's
1-device `engine_serve` on its own PRNGKey(0) weights and prompts (built,
fed and drained as `engine_serve` does, without its `warmup()`, which
only compiles), which the ranks serve through a patched `LM.init` and
`synthetic_prompts`; they serve every case while the JAX side runs
(`port_tokens`).

- Kernel wrappers: `tp_gemm` (column tiles, every epilogue, packed
  words) and `tp_decode_attn` (KV heads) equal their 1-rank call bit for
  bit on every rank, and raise on a shape the ranks do not divide.
- Specs: `serving_param_specs`, `serving_axes_for`, `kv_cache_specs`.
- Engine: tp 2 and tp 4 tokens equal the JAX 1-device engine's in the
  dense, pruned s50, packed b4, paged, speculative (k 4) and chunked (8)
  cases, on every rank (a product sharded on K sums its partials in
  rank order, which reassociates the 1-rank sum: the tokens hold in f32,
  as the reference's do). At tp 2 a rank's KV is exactly half and its
  params within 0.55 of the whole; at tp 4 the smoke config's 2 KV heads
  do not divide and the arena is whole on every rank; a pruned width the
  ranks do not divide replicates and is recorded.
"""
import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro.configs import get_arch as jget_arch
from repro.launch import engine as JE
from repro.models.transformer import LM as JLM
from repro_torch.distributed.sharding import (kv_cache_specs, make_plan,
                                              serving_axes_for,
                                              serving_param_specs)
from repro_torch.kernels import gemm_core as gc
from repro_torch.launch.mesh import Mesh, RankPool, make_tp_mesh

ARCH = "internlm2-1.8b"
GEN = 8
ENGINE_CASES = {
    "dense": ([12, 5], {}),
    "pruned_s50": ([12, 5], dict(pruned=True, sparsity=0.5)),
}
_JAX: dict = {}


@pytest.fixture(scope="module")
def ranks():
    with RankPool(4, "cpu", verbose=False) as pool:
        yield pool


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _np_params():
    def init():
        params, _ = JLM(jget_arch(ARCH, smoke=True)).init(
            jax.random.PRNGKey(0))
        return {k: np.asarray(v) for k, v in params.items()}
    return _jax("params", init)


def jax_tokens(lens, kw):
    """The JAX package's 1-device engine_serve tokens (without warmup)."""
    eng, lm = JE.build_engine(ARCH, True, max_seq=max(lens) + GEN, **kw)
    for p in JE.synthetic_prompts(lm.cfg, lens):
        eng.submit(p, GEN)
    return eng.run()


def serve_all(ranks, cases):
    """Every case at tp 2 and 4 on the ranks, served while the JAX oracle
    runs here: ({(case, tp): per-rank (tokens, stats)}, {case: JAX
    tokens})."""
    cfg = jget_arch(ARCH, smoke=True)
    prompts = {name: [np.asarray(p) for p in JE.synthetic_prompts(cfg, lens)]
               for name, (lens, _) in cases.items()}
    ranks.submit(R.serve_cases, _np_params(), prompts, GEN, cases)
    want = {name: jax_tokens(lens, kw) for name, (lens, kw) in cases.items()}
    per_rank = ranks.collect()
    return ({key: [r[key] for r in per_rank] for key in per_rank[0]}, want)


@pytest.fixture(scope="module")
def port_tokens(ranks):
    return serve_all(ranks, ENGINE_CASES)


def check_tokens(port_tokens, case, tp):
    got, want = port_tokens
    res = got[(case, tp)]
    for out, st in res[:tp]:
        assert sorted(out) == sorted(want[case])
        for rid in want[case]:
            np.testing.assert_array_equal(out[rid], want[case][rid])
        assert st["tp"]["devices"] == tp and st["tp"]["backend"] == "gloo"
    assert all(r is None for r in res[tp:])
    return [st for _, st in res[:tp]]


# ------------------------------------------------------------ kernel layer
def _rng(seed):
    return np.random.default_rng(seed)


def _same_on_every_rank(res, tp):
    for r in res[:tp]:
        got, want = r
        np.testing.assert_array_equal(got, want)
    assert all(r is None for r in res[tp:])


def test_tp_gemm_dense_exact(ranks):
    rng = _rng(0)
    x = rng.standard_normal((8, 96)).astype(np.float32)
    w = rng.standard_normal((96, 128)).astype(np.float32)
    # column-parallel: each output column is one rank's 1-rank kernel
    _same_on_every_rank(ranks.run(R.tp_gemm_case, 4, x, w, gc.NONE, ()), 4)


def test_tp_gemm_epilogues_exact(ranks):
    rng = _rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    mask = (rng.random(128) > 0.5).astype(np.float32)
    scale = (rng.random(128) + 0.5).astype(np.float32)
    codes = rng.integers(-127, 128, (64, 128)).astype(np.int8)
    fq = tuple(np.float32(v) for v in (0.05, 2.0, 1.0))
    for w_, name, ops in [(w, gc.COL_MASK, (mask,)),
                          (codes, gc.DEQUANT, (scale,)),
                          (w, gc.FAKE_QUANT, fq),
                          (w, gc.FQ_MASK, fq + (mask,))]:
        _same_on_every_rank(ranks.run(R.tp_gemm_case, 4, x, w_, name, ops),
                            4)


def test_tp_gemm_packed_exact(ranks):
    from repro_torch.core.quant import pack_codes
    rng = _rng(2)
    K, N, bits = 64, 128, 4
    x = rng.standard_normal((4, K)).astype(np.float32)
    codes = torch.from_numpy(rng.integers(-8, 8, (K, N)).astype(np.int32))
    packed = pack_codes(codes, bits).numpy()
    scale = (rng.random(N) + 0.5).astype(np.float32)
    _same_on_every_rank(ranks.run(R.tp_gemm_case, 4, x, packed, gc.UNPACK,
                                  (scale,), bits), 4)


def test_tp_gemm_rejects_indivisible_n(ranks):
    assert all("must divide" in m for m in ranks.run(R.tp_rejects, "gemm"))


def test_tp_decode_attn_exact(ranks):
    rng = _rng(3)
    B, S, KVh, dh, g = 2, 32, 4, 16, 2
    q = rng.standard_normal((B, KVh, g, dh)).astype(np.float32)
    k = np.zeros((B, S, KVh, dh), np.float32)
    v = np.zeros((B, S, KVh, dh), np.float32)
    k[:, :20] = rng.standard_normal((B, 20, KVh, dh))
    v[:, :20] = rng.standard_normal((B, 20, KVh, dh))
    pos = np.asarray([19, 11], np.int64)
    _same_on_every_rank(ranks.run(R.tp_decode_case, 4, q, k, v, pos), 4)


def test_tp_decode_attn_rejects_indivisible_heads(ranks):
    assert all("must divide" in m for m in ranks.run(R.tp_rejects, "attn"))


# ----------------------------------------------------------- spec mapping
def test_serving_param_specs_maps_derived_keys():
    plan = make_plan(Mesh(("data", "model"), (1, 4)), mode="tp")
    axes = {"blocks.0.mlp.w1": ("embed", "mlp")}
    params = {"blocks.0.mlp.w1.codes": torch.zeros((128, 256), dtype=torch.int8),
              "blocks.0.mlp.w1.packed4": torch.zeros((16, 256),
                                                     dtype=torch.int32),
              "blocks.0.mlp.w1.scale": torch.zeros((2,)),
              "unrelated": torch.zeros((7,))}
    specs = serving_param_specs(plan, axes, params)
    # codes and packed words shard like the base weight (N on "model");
    # scales and unmapped leaves replicate
    assert specs["blocks.0.mlp.w1.codes"][1] == "model"
    assert specs["blocks.0.mlp.w1.packed4"][1] == "model"
    assert specs["blocks.0.mlp.w1.scale"] in ((), (None,))
    assert specs["unrelated"] in ((), (None,))


def test_serving_axes_for_suffixes():
    axes = {"w": ("embed", "mlp")}
    assert serving_axes_for("w", axes) == ("embed", "mlp")
    assert serving_axes_for("w.codes", axes) == ("embed", "mlp")
    assert serving_axes_for("w.packed4", axes) == ("embed", "mlp")
    assert serving_axes_for("w.scale", axes) == ("layers",)
    assert serving_axes_for("w.other", axes) is None
    assert serving_axes_for("missing.codes", axes) is None


def test_kv_cache_specs_head_axis():
    mesh = Mesh(("data", "model"), (1, 4))
    shapes = {"blocks.0.k": (2, 4, 64, 4, 16),       # KVh=4: shard
              "blocks.0.v": (2, 4, 64, 4, 16),
              "blocks.1.k": (2, 4, 64, 3, 16),       # KVh=3: replicate
              "blocks.0.k_scale": (2, 8, 16, 4),     # paged scale: shard
              # recurrent state shards with its mixer's channels / heads
              "blocks.0.h": (2, 4, 32, 7),           # mamba h: Di
              "blocks.0.conv": (2, 4, 3, 32),        # mamba conv: Di
              "blocks.2.h": (2, 4, 30, 7),           # Di=30: replicate
              "blocks.1.wkv": (2, 4, 8, 16, 16),     # rwkv6 wkv: heads
              "blocks.1.tm_shift": (2, 4, 64)}       # token shift: whole
    specs = kv_cache_specs(mesh, shapes)
    assert specs["blocks.0.k"][3] == "model"
    assert specs["blocks.0.v"][3] == "model"
    assert specs["blocks.1.k"] in ((), (None,) * 5)
    assert specs["blocks.0.k_scale"][3] == "model"
    assert specs["blocks.0.h"] == (None, None, "model")
    assert specs["blocks.0.conv"] == (None, None, None, "model")
    assert specs["blocks.1.wkv"] == (None, None, "model")
    assert specs["blocks.2.h"] in ((), (None,) * 4)
    assert specs["blocks.1.tm_shift"] in ((), (None,) * 3)


# ------------------------------------------------------------ engine layer
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_tp4_engine_token_identity(port_tokens, case, tp):
    check_tokens(port_tokens, case, tp)


def test_tp2_per_device_bytes_shrink(ranks):
    # the smoke arch has 2 KV heads / 4 q heads / 256 mlp / 512 vocab:
    # every projection and the whole arena divide tp=2, so KV halves
    # exactly and params land within a few replicated norm vectors of 1/2
    for b in ranks.run(R.engine_bytes, 2, {})[:2]:
        assert b["param"] / 2 <= b["param_per"] <= 0.55 * b["param"]
        assert b["kv_per"] * 2 == b["kv"]
        assert b["meta"]["replicated_fallbacks"] == []
        assert b["meta"]["decode"] == "eager"


def test_tp4_kv_replicates_when_heads_indivisible(ranks):
    # 2 KV heads % 4 != 0: the arena replicates (per-rank KV share = full)
    # while q-head/mlp/vocab params still shard
    for b in ranks.run(R.engine_bytes, 4, {}):
        assert b["kv_per"] == b["kv"]
        assert b["param_per"] < b["param"]


def test_tp2_paged_per_device_kv_shrink(ranks):
    for b in ranks.run(R.engine_bytes, 2, dict(paged=True,
                                                page_size=8))[:2]:
        assert b["pool_per"] * 2 == b["pool"]


def test_tp4_pruned_fallbacks_recorded(ranks):
    """Sparsity 0.3 leaves d_ff 179 of 256: the MLP weights no longer
    divide 4 ranks and replicate, recorded as fallbacks, as the
    reference records them."""
    for b in ranks.run(R.engine_bytes, 4, dict(pruned=True,
                                                sparsity=0.3)):
        assert any(n.endswith("mlp.w_down") for n in b["fallbacks"])
        assert b["meta"]["replicated_fallbacks"] == b["fallbacks"]


def test_make_tp_mesh_shape(ranks):
    for r, (shape, coords, err) in enumerate(ranks.run(R.mesh_case, 4)):
        assert shape == {"data": 1, "model": 4}
        assert coords == {"data": 0, "model": r}
        assert "requested 5" in err
    with pytest.raises(ValueError):
        make_tp_mesh(2)            # one rank outside a rank group

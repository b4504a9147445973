"""The port's tensor-parallel serving of the recurrent mixers (rwkv6's
heads, jamba's mamba channels and its experts) on CPU ranks over gloo,
against the JAX package's 1-device engine.

One `RankPool` of 4 ranks serves the module, as in
`tests/test_torch_tp_moe.py` (whose helpers this module shares): the
smoke configs' PRNGKey(0) params and prompts are the JAX package's, and
its engines run here while the ranks serve.

- `mamba_apply`, `rwkv_timemix_apply` and `rwkv_chanmix_apply` under `tp`
  (and jamba's `moe_apply`), from a random state, lie within f32
  reassociation of the 1-rank call on every rank, outputs and new state
  (this rank's channels or heads of it), at 1e-5 of their largest
  magnitude: x_proj's (dt_low, B, C), out_proj, wo and cm_v sum their K
  tiles in rank order. A rank holds Di/tp channels and H/tp heads.
- The engine: tp 2 and tp 4 tokens equal the JAX 1-device engine's on
  every rank (f32, greedy), dense, packed b4 and paged (without prefix
  sharing; held to the JAX dense engine, to which the JAX package holds
  its paged engine). A rank's arena holds its channels' and heads'
  state; the token shifts are whole.
- Pruned at sparsity 0.3 (rwkv6 keeps 3 of 4 heads, jamba 179 of 256
  mamba channels): the widths the ranks do not divide replicate, are
  recorded, and the tokens equal the 1-rank port engine's on the same
  weights (which `tests/test_torch_recurrent_serving.py` holds to the
  JAX package's pruned engine).
- What one rank refuses on a recurrent plan, a tensor-parallel engine
  refuses with the same ValueError.
"""
import numpy as np
import pytest

import torch_ranks as R
from repro_torch.launch import engine as TE
from repro_torch.launch.mesh import Mesh
from test_torch_tp_moe import (_np_params, _per_rank, _prompts, GEN,  # noqa
                               jax_tokens, one_torch_thread, ranks)

RWKV, JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
ARCHS = [RWKV, JAMBA]
CASES = {
    "dense": ({}, {}),
    "packed_b4": (dict(packed=True, bits_init=4.0),
                  dict(packed=True, bits_init=4.0)),
    "paged": (dict(paged=True, page_size=8, prefix_sharing=False), {}),
}
PRUNED = dict(pruned=True, sparsity=0.3)
ENGINE = [(tp, arch, name) for arch in ARCHS for name in CASES
          for tp in (2, 4)]
LAYERS = [(tp, arch, kind) for tp in (2, 4)
          for arch, kind in ((JAMBA, "mamba"), (JAMBA, "moe"),
                             (RWKV, "rwkv"), (RWKV, "chanmix"))]
LAYER_TOL = 1e-5


def _states(rng):
    """A random decode state per recurrent sublayer kind (batch 2) at the
    smoke widths: mamba's (h, conv), rwkv6's (shift, wkv) and shift."""
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    return {"mamba": (f(2, 256, 8), f(2, 3, 256)),
            "rwkv": (f(2, 128), f(2, 4, 32, 32)), "chanmix": (f(2, 128),)}


@pytest.fixture(scope="module")
def served(ranks):
    params = {a: _np_params(a) for a in ARCHS}
    prompts = {a: _prompts(a) for a in ARCHS}
    kw = lambda d: tuple(sorted(d.items()))
    cases = [(tp, arch, name, kw(CASES[name][0]))
             for tp, arch, name in ENGINE]
    cases += [(tp, arch, "pruned_s30", kw(PRUNED)) for arch in ARCHS
              for tp in (1, 2, 4)]
    ranks.submit(R.serve_families, params, prompts, GEN, cases)
    for arch in ARCHS:
        for _, jkw in CASES.values():
            jax_tokens(arch, jkw)
    got = ranks.collect()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    layers = ranks.run(R.layer_families, params, x, _states(rng), LAYERS)
    return ({c[:3]: [r.get(c) for r in got] for c in cases},
            {c: [r.get(c) for r in layers] for c in LAYERS})


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: "-".join(map(str, c)))
def test_layers_under_tp_match_one_rank(served, case):
    tp = case[0]
    for err, big, shapes in _per_rank(served[1][case], tp):
        assert err <= LAYER_TOL * big, (err, big)
        local = {k.rpartition(".")[2]: v for k, v in shapes.items()}
        if case[2] == "mamba":
            assert local["conv_w"] == (4, 256 // tp)
            assert shapes["state.0"] == (2, 256 // tp, 8)    # h
            assert shapes["state.1"] == (2, 3, 256 // tp)    # conv
        elif case[2] == "rwkv":
            assert local["u"] == (128 // tp,) and local["wr"] == (128,
                                                                  128 // tp)
            assert shapes["state.0"] == (2, 128)             # token shift
            assert shapes["state.1"] == (2, 4 // tp, 32, 32)  # wkv
        elif case[2] == "chanmix":
            assert local["cm_k"] == (128, 448 // tp)
        else:
            assert local["we_gate"][0] == 4 // tp


@pytest.mark.parametrize("case", ENGINE, ids=lambda c: "-".join(map(str, c)))
def test_engine_tokens_match_jax(served, case):
    tp, arch, name = case
    want = jax_tokens(arch, CASES[name][1])
    for tokens, fallbacks, shapes in _per_rank(served[0][case], tp):
        assert sorted(tokens) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(tokens[rid], want[rid],
                                          err_msg=f"{case} request {rid}")
        if name != "dense":
            continue
        assert fallbacks == []
        if arch == RWKV:
            assert shapes["blocks.0.wkv"][2] == 4 // tp
            assert shapes["blocks.0.tm_shift"][-1] == 128
        else:
            assert shapes["blocks.1.h"][2] == 256 // tp
            assert shapes["blocks.1.conv"][3] == 256 // tp


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_pruned_widths_the_ranks_do_not_divide_replicate(served, arch, tp):
    (one, _, _), = _per_rank(served[0][(1, arch, "pruned_s30")], 1)
    head = "blocks.0.rwkv.u" if arch == RWKV else "blocks.1.mamba.conv_w"
    for tokens, fallbacks, shapes in _per_rank(
            served[0][(tp, arch, "pruned_s30")], tp):
        assert head in fallbacks
        if arch == RWKV:
            assert shapes["blocks.0.wkv"][2] == 3           # whole: 3 heads
        else:
            assert shapes["blocks.1.h"][2] == 179           # whole channels
        assert sorted(tokens) == sorted(one)
        for rid in one:
            np.testing.assert_array_equal(tokens[rid], one[rid])


def _refusal(arch, kind, mesh):
    kw = {"prefix": dict(paged=True), "speculative": dict(speculative=True),
          "chunked": dict(prefill_chunk=8), "prompt": {}}[kind]
    try:
        eng, _ = TE.build_engine(arch, True, device="cpu", mesh=mesh,
                                 max_seq=96, **kw)
        if kind == "prompt":
            eng.submit(np.zeros(70, np.int32), 4)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kind", ["prefix", "speculative", "chunked",
                                  "prompt"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_refuses_what_one_rank_refuses(arch, kind):
    """Paged prefix sharing, speculative decoding, chunked prefill and a
    70-token prompt (past one 64-token scan chunk, not a multiple of it):
    the engine of rank 0 of a (1, 2) mesh raises one rank's ValueError
    (it raises at construction or submit, before any collective)."""
    one = _refusal(arch, kind, None)
    assert one is not None
    assert _refusal(arch, kind, Mesh(("data", "model"), (1, 2),
                                     rank=0)) == one

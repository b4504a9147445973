"""The port's expert-parallel MoE serving (grok-1, llama4) on CPU ranks
over gloo, against the JAX package's 1-device engine.

One `RankPool` of 4 ranks serves the module. The ranks import only torch
and the port (`tests/torch_ranks.py`); the smoke configs' PRNGKey(0)
params and the prompts are the JAX package's, handed over as numpy, and
the JAX side runs here, once per module, while the ranks serve
(`served`). tp-2 cases run two at a time, on ranks (0, 1) and (2, 3).

- `moe_apply` under `tp` (the experts split on the stacks' expert axis,
  the router whole) lies within f32 reassociation of the 1-rank call on
  every rank, at 1e-6 of the output's largest magnitude: the combine's
  partial sums, one a rank, add in rank order, and llama4's shared
  expert sums its w_down K tiles the same way. A rank holds E/tp experts.
- The engine: tp 2 and tp 4 tokens equal the JAX 1-device engine's on
  every rank, in f32 and greedy, dense, pruned s50 (experts pruned),
  packed b4 and paged, and speculative (draft k 4) and chunked (8) at
  tp 2. The pruned and packed cases are held to the JAX engine in the
  same mode; paged, speculative and chunked to its dense engine, whose
  tokens the JAX package holds its own paged, speculative and chunked
  engines to.
- A pruned expert count the ranks do not divide (grok's s50 leaves 2 of
  4 experts at tp 4) replicates the stacks and is recorded.
"""
import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro.configs import get_arch as jget_arch
from repro.launch import engine as JE
from repro.models.transformer import LM as JLM
from repro_torch.launch.mesh import RankPool

GROK, LLAMA4 = "grok-1-314b", "llama4-maverick-400b-a17b"
ARCHS = [GROK, LLAMA4]
LENS, GEN = [12, 5], 6
# case -> (engine keywords, the JAX engine keywords its tokens are held to)
CASES = {
    "dense": ({}, {}),
    "pruned_s50": (dict(pruned=True, sparsity=0.5),
                   dict(pruned=True, sparsity=0.5)),
    "packed_b4": (dict(packed=True, bits_init=4.0),
                  dict(packed=True, bits_init=4.0)),
    "paged": (dict(paged=True, page_size=8), {}),
    "speculative": (dict(speculative=True, draft_k=4, draft_sparsity=0.5,
                         draft_bits=4.0), {}),
    "chunked": (dict(prefill_chunk=8), {}),
}
TP2_ONLY = ("speculative", "chunked")
ENGINE = [(tp, arch, name) for arch in ARCHS for name in CASES
          for tp in (2, 4) if tp == 2 or name not in TP2_ONLY]
LAYERS = [(tp, arch, "moe") for arch in ARCHS for tp in (2, 4)]
LAYER_TOL = 1e-6
_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    with RankPool(4, "cpu", verbose=False) as pool:
        yield pool


def _np_params(arch):
    if ("params", arch) not in _JAX:
        params, _ = JLM(jget_arch(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        _JAX[("params", arch)] = {k: np.asarray(v)
                                  for k, v in params.items()}
    return _JAX[("params", arch)]


def _prompts(arch):
    return [np.asarray(p) for p in JE.synthetic_prompts(
        jget_arch(arch, smoke=True), LENS)]


def jax_tokens(arch, kw: dict) -> dict:
    """The JAX package's 1-device engine tokens (built, fed and drained as
    its `engine_serve` does, without the compile-only warmup)."""
    key = ("tokens", arch, tuple(sorted(kw.items())))
    if key not in _JAX:
        eng, lm = JE.build_engine(arch, True, max_seq=max(LENS) + GEN, **kw)
        for p in JE.synthetic_prompts(lm.cfg, LENS):
            eng.submit(p, GEN)
        _JAX[key] = {int(r): np.asarray(t) for r, t in eng.run().items()}
    return _JAX[key]


@pytest.fixture(scope="module")
def served(ranks):
    """({engine case: per-rank (tokens, fallbacks, shapes)}, {layer case:
    per-rank (err, max, shapes)}); the JAX engines run while the ranks
    serve."""
    params = {a: _np_params(a) for a in ARCHS}
    prompts = {a: _prompts(a) for a in ARCHS}
    cases = [(tp, arch, name, tuple(sorted(CASES[name][0].items())))
             for tp, arch, name in ENGINE]
    ranks.submit(R.serve_families, params, prompts, GEN, cases)
    for arch in ARCHS:
        for _, jkw in CASES.values():
            jax_tokens(arch, jkw)
    got = ranks.collect()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    layers = ranks.run(R.layer_families, params, x, {}, LAYERS)
    return ({c[:3]: [r.get(c) for r in got] for c in cases},
            {c: [r.get(c) for r in layers] for c in LAYERS})


def _per_rank(results, tp):
    """The case's results on its tp ranks (one block of them served it)."""
    done = [r for r in results if r is not None]
    assert len(done) == tp
    return done


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_expert_parallel_matches_one_rank(served, arch, tp):
    E = jget_arch(arch, smoke=True).moe.n_experts
    for err, big, shapes in _per_rank(served[1][(tp, arch, "moe")], tp):
        assert err <= LAYER_TOL * big, (err, big)
        assert shapes["blocks.0.moe.we_gate"][0] == E // tp
        assert shapes["blocks.0.moe.router"] == (128, E)     # whole


@pytest.mark.parametrize("case", ENGINE, ids=lambda c: "-".join(map(str, c)))
def test_engine_tokens_match_jax(served, case):
    tp, arch, name = case
    want = jax_tokens(arch, CASES[name][1])
    for tokens, fallbacks, shapes in _per_rank(served[0][case], tp):
        assert sorted(tokens) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(tokens[rid], want[rid],
                                          err_msg=f"{case} request {rid}")
        if name in ("dense", "paged"):
            E = jget_arch(arch, smoke=True).moe.n_experts
            assert fallbacks == []
            assert shapes["blocks.0.moe.we_gate"][1] == E // tp


@pytest.mark.parametrize("tp", [2, 4])
def test_pruned_expert_shards(served, tp):
    """grok's s50 keeps 2 of 4 experts: at tp 2 a rank holds one; at tp 4
    the ranks do not divide them, the stacks replicate and each is a
    recorded fallback (the router, replicated by the plan, is none)."""
    for _, fallbacks, shapes in _per_rank(
            served[0][(tp, GROK, "pruned_s50")], tp):
        assert shapes["blocks.0.moe.we_gate"][1] == (1 if tp == 2 else 2)
        stacks = {f"blocks.0.moe.{w}" for w in ("we_gate", "we_up",
                                                "we_down")}
        assert stacks <= set(fallbacks) if tp == 4 else \
            not stacks & set(fallbacks)
        assert "blocks.0.moe.router" not in fallbacks

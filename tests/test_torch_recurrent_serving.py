"""The port's serving of the recurrent mixers (rwkv6, jamba's hybrid plan)
against the JAX package's: the one-shot prefill against sequential
decode, pruned and packed serving, the per-slot state across admissions,
and the two refusals the reference's own faults call for.

The smoke configs are initialised by the JAX package (PRNGKey(0)) and
`LM.init` is patched to hand those params to the port as numpy, so both
packages' `build_engine` serve the same weights; the prompts are the JAX
package's. Greedy tokens must be equal (f32). Each reference result runs
once per module (`_jax`).

- Engine tokens against the JAX engine's in every weight mode and arena,
  and the arenas' bytes: `tests/test_torch_recurrent_engine.py`.
- Mirrors of `test_engine.py::
  test_prefill_matches_sequential_decode_stateful_families`,
  `test_slim_serving.py::test_pruned_decode_stateful_families` and
  `::test_compress_lm_records_skipped_sites`, and the rwkv6 cases of
  `test_packed_serving.py::test_packed_decode_matches_unpacked`.
- A slot re-admitted after another occupant emits its solo tokens, on
  both arenas: admission overwrites the state an idle slot's decode
  drifted.
- The reference serves a paged prefix hit on a recurrent plan from the
  previous occupant's state; the port refuses paged prefix sharing on
  such plans with a ValueError, and a paged run without sharing over a
  repeated prompt equals the contiguous run. The reference cannot prefill
  a prompt longer than a chunk that is not a multiple of it; the port's
  `submit` refuses it with a ValueError before anything is admitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import subnet as JS
from repro.launch import engine as JE
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.subnet import (compress_lm, compression_report,
                                     prepare_serving, residual_qparams,
                                     servable_params, tree_bytes)
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TS
from repro_torch.models.transformer import LM as TLM

ARCHS = ["rwkv6-3b", "jamba-1.5-large-398b"]
LENS, GEN = [5, 3, 9], 6
MAX_SEQ = 16
PAGED = dict(paged=True, page_size=4, prefix_sharing=False)

_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _jmodel(arch):
    def init():
        jlm = JLM(jget_arch(arch, smoke=True))
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        return jlm, jp, {k: np.asarray(v) for k, v in jp.items()}
    return _jax(("model", arch), init)


def _patch(monkeypatch, arch):
    """The port's `LM.init` hands over the JAX package's PRNGKey(0)
    params of `arch`."""
    np_params = _jmodel(arch)[2]
    monkeypatch.setattr(TLM, "init", lambda self, gen: convert.
                        params_from_numpy(np_params, device=gen.device))


def _prompts(arch, lens=LENS):
    return [np.asarray(p) for p in JE.synthetic_prompts(
        jget_arch(arch, smoke=True), lens)]


def _drain(eng, prompts, gen=GEN):
    rids = [eng.submit(p, gen) for p in prompts]
    eng.warmup()
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def _assert_tokens(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} request {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_sequential_decode(arch):
    """`test_prefill_matches_sequential_decode_stateful_families`: the
    one-shot prefill leaves exactly the state 6 sequential steps would
    (logits and every state leaf within 1e-4), and its logits are the JAX
    prefill's within 1e-5 of their range."""
    jlm, jp, np_params = _jmodel(arch)
    lm = TLM(get_arch(arch, smoke=True))
    params = convert.params_from_numpy(np_params)
    toks = np.random.default_rng(2).integers(0, lm.cfg.vocab, (2, 6))
    tt = torch.from_numpy(toks)
    c_pre = lm.init_cache(2, MAX_SEQ, dtype=torch.float32)
    lg_pre, _ = lm.prefill(params, None, c_pre, tt)
    c_seq = lm.init_cache(2, MAX_SEQ, dtype=torch.float32)
    steps = [lm.decode_step(params, None, c_seq, tt[:, p:p + 1], p)[0][:, 0]
             for p in range(6)]
    lg_seq = torch.stack(steps, 1)
    assert torch.equal(lg_pre.argmax(-1), lg_seq.argmax(-1))
    torch.testing.assert_close(lg_pre, lg_seq, rtol=1e-4, atol=1e-4)
    for k in c_seq:
        torch.testing.assert_close(c_pre[k], c_seq[k], rtol=1e-4, atol=1e-4,
                                   msg=k)
    want = _jax(("prefill", arch), lambda: np.asarray(jlm.prefill(
        jp, None, jlm.init_cache(2, MAX_SEQ, dtype=jnp.float32),
        jnp.asarray(toks))[0]))
    span = float(want.max() - want.min())
    assert float(np.abs(lg_pre.numpy() - want).max()) <= 1e-5 * span


# ---------------------------------------------------- pruned and compressed
@pytest.mark.parametrize("arch", ARCHS)
def test_pruned_decode_stateful_families(arch):
    """`test_pruned_decode_stateful_families`: the subnet at sparsity 0.4
    decodes at its sliced state widths (the recurrent caches shrink with
    the plan), finite, with the JAX subnet's logits within 1e-5 of their
    range at every step."""
    jlm0, jp, np_params = _jmodel(arch)
    slim = TLM(get_arch(arch, smoke=True))
    p_slim, q_slim, meta = prepare_serving(
        slim, convert.params_from_numpy(np_params), quantized=False,
        prune_sparsity=0.4)
    assert meta["sparsity"] > 0.2
    assert tree_bytes(slim.init_cache(1, 16, dtype=torch.float32)) < \
        tree_bytes(TLM(slim.cfg).init_cache(1, 16, dtype=torch.float32))

    def ref():
        jslim = JLM(jlm0.cfg)
        jps, jqs, _ = JS.prepare_serving(jslim, dict(jp), quantized=False,
                                         prune_sparsity=0.4)
        caches = jslim.init_cache(1, 16, dtype=jnp.float32)
        tok, out = jnp.zeros((1, 1), jnp.int32), []
        for i in range(3):
            lg, caches = jslim.decode_step(jps, jqs, caches, tok,
                                           jnp.int32(i))
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            out.append(np.asarray(lg))
        return [vars(s) for s in jslim.shapes], out

    jshapes, want = _jax(("pruned", arch), ref)
    assert [vars(s) for s in slim.shapes] == jshapes
    caches = slim.init_cache(1, 16, dtype=torch.float32)
    tok = torch.zeros((1, 1), dtype=torch.int64)
    for i in range(3):
        lg, caches = slim.decode_step(p_slim, q_slim, caches, tok, i)
        tok = lg[:, -1].argmax(-1)[:, None]
        assert torch.isfinite(lg).all()
        span = float(want[i].max() - want[i].min())
        assert float(np.abs(lg.numpy() - want[i]).max()) <= 1e-5 * span


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_lm_records_skipped_sites(arch):
    """Non-routed weights (jamba's MoE router and expert stacks) stay
    dense and are recorded as the reference records them; every rwkv6
    site is routed and compressed."""
    jlm, jp, np_params = _jmodel(arch)
    lm = TLM(get_arch(arch, smoke=True))
    params = convert.params_from_numpy(np_params)
    subnet = compress_lm(lm, params, lm.init_qparams(params))
    want = JS.compress_lm(jlm, jp, jlm.init_qparams(jp)).meta["skipped_sites"]
    skipped = subnet.meta["skipped_sites"]
    assert skipped == want
    assert all(".moe." in n for n in skipped)
    assert bool(skipped) == (arch != "rwkv6-3b")
    assert not any(n in subnet.int_weights for n in skipped)
    mixer = "rwkv" if arch == "rwkv6-3b" else "mamba"
    assert any(f".{mixer}." in n for n in subnet.int_weights)
    if skipped:
        report = compression_report(arch, subnet.meta)
        assert f"{len(skipped)} non-routed sites kept dense" in report


@pytest.mark.parametrize("bits_init", [8.0, 4.0], ids=["b8", "b4"])
def test_packed_decode_matches_unpacked(bits_init):
    """The rwkv6 cases of `test_packed_decode_matches_unpacked`: packed
    and unpacked codes decode to logits within 1e-4 and equal argmaxes."""
    lm = TLM(get_arch("rwkv6-3b", smoke=True))
    params = convert.params_from_numpy(_jmodel("rwkv6-3b")[2])
    qparams = lm.init_qparams(params, bits_init=bits_init)
    plain = compress_lm(lm, params, qparams)
    packed = compress_lm(lm, params, qparams, packed=True)
    assert packed.packed_bits
    for name, sb in packed.packed_bits.items():
        assert sb == int(np.ceil(packed.bits[name + ".wq"]))
        assert packed.int_weights[name].dtype == torch.int32

    def decode(p, q):
        caches = lm.init_cache(2, 8, dtype=torch.float32)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, lm.cfg.vocab, (2, 4)))
        return torch.cat([lm.decode_step(p, q, caches, toks[:, i:i + 1],
                                         i)[0] for i in range(4)], 1)

    want = decode(servable_params(plain), residual_qparams(plain, qparams))
    got = decode(servable_params(packed), residual_qparams(packed, qparams))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------------ per-slot recurrence
@pytest.mark.parametrize("arena", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_readmitted_slot_emits_solo_tokens(arch, arena):
    """One slot serves prompts [a, b, a]: the third request starts from
    its own prompt's state, not from what the slot's previous occupant
    (and its idle decode) left, so it emits a's solo tokens; with two
    slots and five requests every request emits its solo tokens."""
    kw = PAGED if arena == "paged" else {}
    a, b = _prompts(arch, [6, 4])

    def serve(prompts, slots):
        eng, _ = TE.build_engine(arch, True, max_slots=slots, max_seq=16,
                                 device="cpu", **kw)
        return _drain(eng, prompts)

    solo_a, solo_b = serve([a], 1)[0], serve([b], 1)[0]
    got = serve([a, b, a], 1)
    _assert_tokens(got, [solo_a, solo_b, solo_a], f"{arch} {arena} 1 slot")
    got = serve([a, b, b, a, a], 2)
    _assert_tokens(got, [solo_a, solo_b, solo_b, solo_a, solo_a],
                   f"{arch} {arena} 2 slots")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefix_sharing_is_refused(arch):
    """Refused, not reproduced: a paged prefix hit skips the prefill that
    sets a slot's recurrent state (the reference then decodes from the
    previous occupant's state). Without sharing, a paged run over a
    repeated prompt equals the contiguous run."""
    with pytest.raises(ValueError, match="prefix_sharing=False") as ei:
        TE.build_engine(arch, True, max_slots=1, max_seq=16, paged=True,
                        device="cpu")
    assert "skips the prefill" in str(ei.value)
    a, b = _prompts(arch, [6, 4])
    out = {}
    for arena, kw in (("contiguous", {}), ("paged", PAGED)):
        eng, _ = TE.build_engine(arch, True, max_slots=1, max_seq=16,
                                 device="cpu", **kw)
        out[arena] = _drain(eng, [a, b, a])
        assert eng.stats["prefix_hits"] == 0
    _assert_tokens(out["paged"], out["contiguous"], f"{arch} paged")


@pytest.mark.parametrize("arch", ARCHS)
def test_submit_refuses_prompts_the_prefill_cannot_take(arch):
    """Past one scan chunk (64) a prompt must be a multiple of it: 70 is
    refused at submission, before anything is queued or admitted; 63, 64
    and 128 are taken."""
    eng, lm = TE.build_engine(arch, True, max_slots=1, max_seq=136,
                              device="cpu")
    with pytest.raises(ValueError, match="S=70"):
        eng.submit(np.zeros(70, np.int32), 2)
    assert not eng.queue and eng.n_active == 0
    for n in (63, 64, 128):
        eng.submit(np.ones(n, np.int32), 2)
    assert len(eng.queue) == 3


def test_serve_cli_serves_recurrent_archs_paged(capsys):
    """`--arch rwkv6-3b --paged` in smoke mode: prefix sharing off (and
    said), paged tokens equal the contiguous arena's."""
    TS.main(["--arch", "rwkv6-3b", "--paged", "--prompt-lens", "6,4",
             "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "without prefix sharing" in out
    assert "token-identical to the contiguous arena" in out

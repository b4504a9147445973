"""The port's serving slice against the JAX package's, end to end.

The smoke config of the engine tests' arch (2 layers, d_model 128, f32)
is initialised by the JAX package; its params cross to the port through
`repro_torch.convert`, and from there each side runs its own quantizer
init, compression, prefill, decode and continuous-batching engine on the
same prompts. Codes and packed words must be bit-equal, logits agree to
1e-4 (f32 sums in another order), and greedy engine tokens must be equal
in the dense fake-quant, compressed int8 and packed 4-bit modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import subnet as JS
from repro.launch.engine import Engine as JEngine
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import subnet as TS
from repro_torch.launch import engine as TE
from repro_torch.launch import serve as TSV
from repro_torch.models.transformer import LM as TLM

ARCH = "internlm2-1.8b"
MODES = {"dense": dict(quantized=True),
         "compressed": dict(compressed=True),
         "packed_b4": dict(compressed=True, packed=True, bits_init=4.0)}


@pytest.fixture(scope="module")
def models():
    cfg = jget_arch(ARCH, smoke=True)
    jlm = JLM(cfg)
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jlm, jparams, TLM(get_arch(ARCH, smoke=True)), np_params


def _serving(models, mode):
    """Both packages' prepare_serving on the same init params."""
    jlm, jparams, tlm, np_params = models
    jp, jq, _ = JS.prepare_serving(jlm, jparams, **MODES[mode])
    tp, tq, _ = TS.prepare_serving(
        tlm, convert.params_from_numpy(np_params), **MODES[mode])
    return jp, jq, tp, tq


def test_configs_match_reference():
    import dataclasses

    from repro.configs import ASSIGNED_ARCHS
    for arch in ASSIGNED_ARCHS:
        for smoke in (False, True):
            assert (dataclasses.asdict(get_arch(arch, smoke))
                    == dataclasses.asdict(jget_arch(arch, smoke)))


def test_weights_cross_with_convert(models):
    _, jparams, _, np_params = models
    tparams = convert.params_from_numpy(np_params)
    assert sorted(tparams) == sorted(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))
    bf = jnp.asarray(np_params["embed"][:4]).astype(jnp.bfloat16)
    t = convert.tensor_from_numpy(np.asarray(bf))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(bf.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["compressed", "packed_b4"])
def test_compressed_params_bit_equal(models, mode):
    jp, jq, tp, tq = _serving(models, mode)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    # every site executes from codes: no residual quantizer on either side
    assert jq is None and tq is None
    jlm, jparams, tlm, np_params = models
    bits = MODES[mode].get("bits_init", 8.0)
    jinit = jlm.init_qparams(jparams, bits_init=bits)
    tinit = tlm.init_qparams(convert.params_from_numpy(np_params),
                             bits_init=bits)
    assert sorted(tinit) == sorted(jinit)
    for site in jinit:
        for f in ("d", "q_m", "t"):
            assert (np.asarray(getattr(jinit[site], f)).tobytes()
                    == getattr(tinit[site], f).numpy().tobytes())
    if mode == "packed_b4":
        assert any(k.endswith(".packed4") for k in tp)


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_and_decode_logits_match(models, mode):
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, mode)
    toks = np.random.default_rng(1).integers(0, 512, (2, 7)).astype(np.int32)
    jc = jlm.init_cache(2, 16, dtype=jnp.float32)
    jlog, jc = jax.jit(jlm.prefill)(jp, jq, jc, jnp.asarray(toks))
    tc = tlm.init_cache(2, 16, dtype=torch.float32)
    tlog, tc = tlm.prefill(tp, tq, tc, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # the full-sequence forward (no cache) on the same tokens
    jfwd = jax.jit(jlm.forward)(jp, jq, jnp.asarray(toks))
    tfwd = tlm.forward(tp, tq, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tfwd.numpy(), np.asarray(jfwd),
                               rtol=1e-4, atol=1e-4)
    # one decode step with the two rows at different positions
    nxt = np.array([[3], [11]], np.int32)
    pos = np.array([7, 5], np.int32)
    jlog, _ = jax.jit(jlm.decode_step)(jp, jq, jc, jnp.asarray(nxt),
                                      jnp.asarray(pos))
    tlog, _ = tlm.decode_step(tp, tq, tc, torch.from_numpy(nxt).long(),
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_tokens_match_jax_engine(models, mode):
    """Three requests of mixed lengths on two slots, so admission and
    eviction run mid-decode on both sides."""
    jlm, _, tlm, _ = models
    jp, jq, tp, tq = _serving(models, mode)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 3, 9)]
    gen, max_seq = 6, 16
    jeng = JEngine(jlm, jp, jq, max_slots=2, max_seq=max_seq)
    teng = TE.Engine(tlm, tp, tq, max_slots=2, max_seq=max_seq)
    for p in prompts:
        jeng.submit(p, gen)
        teng.submit(p, gen)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{mode} request {rid}")
    assert teng.stats["evicted"] == 3


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.build_engine(ARCH, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.engine_serve(ARCH, True, [4], 2, verbose=False)
    eng, _ = TE.build_engine(ARCH, True, device="cpu", max_seq=8)
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("mode", list(TE.WEIGHT_MODES))
def test_serve_on_devices_serves_the_engine_serve_model(mode):
    """On the CPU the helper draws the weights and prompts `engine_serve`
    draws from the same seed, so it emits the same tokens."""
    kw = TE.WEIGHT_MODES[mode]
    got = TE.serve_on_devices(ARCH, True, [6, 3, 9], 6, ["cpu"],
                              max_slots=2, **kw)
    want = TE.engine_serve(ARCH, True, [6, 3, 9], 6, max_slots=2,
                           verbose=False, device="cpu", **kw)
    assert list(got) == ["cpu"] and sorted(got["cpu"]) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got["cpu"][rid], want[rid])


def test_cli_packed_smoke_on_cpu(capsys):
    TSV.main(["--smoke", "--packed", "--bits", "4", "--prompt-lens", "5,3",
              "--gen", "4", "--slots", "2", "--device", "cpu"])
    assert "token-identical" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [dict(paged=True, speculative=True),
                                dict(speculative=True),
                                dict(tp=2), dict(prefill_chunk=4),
                                dict(pruned=True)])
def test_later_modes_raise_naming_their_slice(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        TE.build_engine(ARCH, True, device="cpu", **kw)


def test_other_families_raise():
    with pytest.raises(NotImplementedError, match="family"):
        TLM(get_arch("rwkv6-3b", smoke=True))

"""The port's quantizer against the JAX package's, bit for bit.

Same numpy inputs through `repro.core.quant` and `repro_torch.core.quant`:
clip, fake-quant forward, integer codes, storage containers, packed
storage widths and the packed int32 words must be bit-equal at bits 2, 3,
4 and 8 (the serving widths), including a partial last word at bits 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.core import subnet as JS
from repro_torch.core import quant as TQ
from repro_torch.core import subnet as TS

BITS = [2, 3, 4, 8]


def _weights(seed, shape=(37, 24)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x[0, :3] = 0.0                       # exact zeros keep sign 0
    return x


def _qparams(x, bits, t):
    qm = np.float32(np.abs(x).max() * 0.8)   # some weights clip
    return (JQ.init_quant_params(q_m=qm, bits=float(bits), t=t),
            TQ.init_quant_params(q_m=qm, bits=float(bits), t=t))


def _same(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), np.argwhere(a != b)[:5]


@pytest.mark.parametrize("t", [1.0, 0.7, 1.4])
@pytest.mark.parametrize("bits", BITS)
def test_quantizer_forward_bit_equal(bits, t):
    x = _weights(bits)
    jq, tq = _qparams(x, bits, t)
    for f in ("d", "q_m", "t"):
        _same(getattr(jq, f), getattr(tq, f))
    _same(JQ.bit_width(jq.d, jq.q_m, jq.t), TQ.bit_width(tq.d, tq.q_m, tq.t))
    xa = np.abs(x)
    jc = JQ.clip_qmt(jnp.asarray(xa), jq.q_m, jq.t)
    tc = TQ.clip_qmt(torch.from_numpy(xa), tq.q_m, tq.t)
    if t == 1.0:    # the serving init: a^1 is exact in both
        _same(jc, tc)
    else:
        # torch's and XLA's CPU pow differ in the last ulp for t != 1;
        # the rounded outputs below stay bit-equal on these inputs
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2.4e-7,
                                   atol=0)
    _same(JQ.fake_quant(jnp.asarray(x), jq.d, jq.q_m, jq.t),
          TQ.fake_quant(torch.from_numpy(x), tq.d, tq.q_m, tq.t))


@pytest.mark.parametrize("bits", BITS)
def test_quantize_int_codes_and_container_bit_equal(bits):
    x = _weights(10 + bits)
    jq, tq = _qparams(x, bits, 1.0)
    b = float(JQ.bit_width(jq.d, jq.q_m, jq.t))
    assert b == float(TQ.bit_width(tq.d, tq.q_m, tq.t))
    jc, jd = JQ.quantize_int(jnp.asarray(x), jq, bits=b)
    tc, td = TQ.quantize_int(torch.from_numpy(x), tq, bits=b)
    _same(jc, tc)
    _same(jd, td)
    cmax = 2 ** (int(np.ceil(b)) - 1) - 1
    assert np.abs(tc.numpy()).max() <= cmax
    # the narrow container the codes are stored in
    jstore = np.asarray(jc.astype(JS._storage_dtype(b)))
    tstore = tc.to(TS._storage_dtype(b))
    _same(jstore, tstore)


@pytest.mark.parametrize("b", [1.5, 2.0, 2.01, 3.0, 3.99, 4.0, 4.2, 7.5,
                               8.0, 8.001, 9.0, 15.9, 16.0, 17.0])
def test_storage_widths_match(b):
    assert TQ.packed_storage_bits(b) == JQ.packed_storage_bits(b)
    assert (np.dtype(JS._storage_dtype(b)).itemsize
            == torch.empty((), dtype=TS._storage_dtype(b)).element_size())


@pytest.mark.parametrize("bits_init", BITS)
def test_packed_storage_bits_per_site_match(bits_init):
    """Each site of a weight stack gets the same packed width in both
    packages (the width comes from Eq 3 on the site's own q_m)."""
    rng = np.random.default_rng(bits_init)
    for scale in (0.02, 0.3, 1.0, 7.0):
        w = (rng.standard_normal((2, 16, 8)) * scale).astype(np.float32)
        jq = JQ.init_quant_params(jnp.asarray(w), bits=float(bits_init))
        tq = TQ.init_quant_params(torch.from_numpy(w), bits=float(bits_init))
        jb = float(JQ.bit_width(jq.d, jq.q_m, jq.t))
        tb = float(TQ.bit_width(tq.d, tq.q_m, tq.t))
        assert jb == tb
        assert TQ.packed_storage_bits(tb) == JQ.packed_storage_bits(jb)


@pytest.mark.parametrize("K", [37, 40, 64])
@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_round_trip_bit_equal(bits, K):
    """Words equal JAX's, including the zero-padded partial last word
    (K=37 at bits 3: 10 codes per word, 4 words, 3 pad fields)."""
    rng = np.random.default_rng(K * 10 + bits)
    cmax = 2 ** (bits - 1) - 1
    codes = rng.integers(-cmax, cmax + 1, size=(2, K, 12)).astype(np.float32)
    jw = JQ.pack_codes(jnp.asarray(codes), bits, axis=-2)
    tw = TQ.pack_codes(torch.from_numpy(codes), bits, axis=-2)
    _same(jw, tw)
    assert tw.shape[-2] == -(-K // (32 // bits))
    back = TQ.unpack_codes(tw, bits, K, axis=-2)
    _same(JQ.unpack_codes(jw, bits, K, axis=-2), back)
    np.testing.assert_array_equal(back.numpy(), codes.astype(np.int32))


# ------------------------------------------- the training slice's helpers
@pytest.mark.parametrize("t", [1.0, 0.7])
def test_residual_and_step_bounds_match_jax(t):
    """Eq 14's residual and Alg 3's [d_min, d_max] on the same inputs:
    bit-equal at t = 1; otherwise torch's and XLA's pow differ in the last
    ulp, which reaches the residual as one ulp of x~/d (up to 2^5 = 32 at
    6 bits, an ulp of 3.8e-6), and the bounds within 1e-6 relative."""
    x = np.abs(_weights(11))
    jq, tq = _qparams(x, 6, t)
    want = JQ.residual(jnp.asarray(x), jq.d, jq.q_m, jq.t)
    got = TQ.residual(torch.from_numpy(x), tq.d, tq.q_m, tq.t)
    jb = JQ.step_size_bounds(jq.q_m, jq.t, jnp.float32(4.0), jnp.float32(12))
    tb = TQ.step_size_bounds(tq.q_m, tq.t, torch.tensor(4.0),
                             torch.tensor(12.0))
    if t == 1.0:
        _same(want, got)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=3.9e-6)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_positivity_guard_and_projection_match_jax():
    cases = [(1e-9, 1e-7, 0.01), (0.3, 2.0, 5.0), (2.0, 0.5, 1.0)]
    for d, qm, t in cases:
        jg = JQ.positivity_guard(JQ.QuantParams(*map(jnp.float32, (d, qm, t))))
        tg = TQ.positivity_guard(TQ.QuantParams(*map(
            lambda v: torch.tensor(v, dtype=torch.float32), (d, qm, t))))
        for f in ("d", "q_m", "t"):
            _same(getattr(jg, f), getattr(tg, f))
        jp = JQ.project_step_size(jg, 4.0, 8.0)
        tp = TQ.project_step_size(tg, 4.0, 8.0)
        np.testing.assert_allclose(float(tp.d), float(jp.d), rtol=1e-6)
        assert 4.0 - 1e-3 <= float(TQ.bit_width(tp.d, tp.q_m, tp.t)) \
            <= 8.0 + 1e-3


def test_bit_width_roundtrip():
    """Eq 3 and its inverse agree across the operating range."""
    for bits in (2.0, 4.0, 8.0, 16.0, 32.0):
        for q_m in (0.1, 1.0, 3.7):
            for t in (0.5, 1.0, 1.5):
                f = lambda v: torch.tensor(v, dtype=torch.float32)
                d = TQ.step_size_for_bits(f(q_m), f(t), f(bits))
                assert abs(float(TQ.bit_width(d, f(q_m), f(t))) - bits) < 1e-4

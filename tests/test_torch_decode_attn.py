"""The port's flash-decode attention against the JAX package's.

Same numpy q/k/v/pos through `repro.kernels.ref.decode_attn_ref`, the
Pallas kernel in interpret mode, and `repro_torch.kernels.decode_attn`
on CPU tensors (its plain PyTorch version), at 1e-5 in f32 — including
slots at pos = 0 (one valid row) and pos = S-1 (the whole arena). The
CUDA kernel is held to the plain version in `test_torch_gpu.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attn as JDA
from repro.kernels import ref as JR
from repro_torch.kernels import decode_attn as TDA

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, S, KVh, g, dh, pos, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVh, g, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVh, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVh, dh)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


@pytest.mark.parametrize("shape,pos", [
    ((3, 24, 2, 2, 32), [0, 23, 10]),
    ((4, 40, 1, 4, 16), [39, 0, 7, 64]),     # pos past the arena end
    ((2, 16, 2, 1, 8), [5, 15]),
])
def test_plain_matches_jax_ref_and_pallas(shape, pos):
    q, k, v, p = _inputs(*shape, pos)
    got = TDA.decode_attn(*map(torch.from_numpy, (q, k, v, p))).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    want_ref = np.asarray(JR.decode_attn_ref(*map(jnp.asarray, (q, k, v, p))))
    want_kernel = np.asarray(JDA.decode_attn_pallas(
        *map(jnp.asarray, (q, k, v, p)), chunk=8, interpret=True))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_rows_past_valid_length_are_ignored():
    q, k, v, p = _inputs(2, 12, 2, 2, 8, [3, 11])
    base = TDA.decode_attn(*map(torch.from_numpy, (q, k, v, p)))
    k2, v2 = k.copy(), v.copy()
    k2[0, 4:] = 1e3
    v2[0, 4:] = -1e3
    moved = TDA.decode_attn(*map(torch.from_numpy, (q, k2, v2, p)))
    assert torch.equal(base, moved)

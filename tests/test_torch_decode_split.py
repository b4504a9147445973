"""The split-rows flash-decode algorithm on the CPU, against the JAX package.

`ref.decode_attn_split_ref` and `ref.paged_decode_attn_split_ref` are the
plain PyTorch mirrors of the CUDA kernel's algorithm (per-split max, sum and
unnormalized output, then a fixed-order combine); the card tests and
`chip_smoke.py` hold the kernel to them. Here the mirrors meet the JAX
package on numpy inputs made from a seed:

  - the contiguous mirror against `repro.kernels.ref.decode_attn_ref` and
    the Pallas kernel in interpret mode (`decode_attn_pallas`, chunk 8) at
    1e-5, with slots whose valid rows end at the split edges (R - 1, R,
    R + 1 rows), fill the arena, hold one row, or sit past the arena;
  - the paged mirror against `paged_decode_attn_pallas` in interpret mode
    with bf16, int8 and int4 pages at 1e-5 (the tolerance of
    `tests/test_torch_paged_kv.py`);
  - the result across rows per split (1 split vs 4 vs R = 8) at 1e-6, as
    `tests/test_decode_attn.py` holds the JAX kernel across chunks;
  - `decode_attn.plan_splits`: the splits that hold rows cover exactly
    [0, n_valid) once, and both wrappers plan over the arena length they
    are given (S, or seq_len), so the paged and contiguous plans agree
    whenever seq_len == S.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels import decode_attn as JDA
from repro.kernels import ref as JR
from repro_torch.kernels import decode_attn as TDA
from repro_torch.kernels import ref as TR
from repro_torch.launch import paging

TOL = dict(rtol=1e-5, atol=1e-5)
R = 8


def _inputs(B, S, KVh, g, dh, pos, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVh, g, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVh, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVh, dh)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


def _edges(S):
    """pos of slots with R - 1, R and R + 1 valid rows, a full arena, one
    row, and a slot past the arena's end."""
    return [R - 2, R - 1, R, S - 1, 0, S + 9]


@pytest.mark.parametrize("shape", [(24, 2, 2, 32), (40, 1, 4, 16),
                                   (16, 2, 1, 8)])
def test_split_mirror_matches_jax_ref_and_pallas(shape):
    S = shape[0]
    pos = _edges(S)
    q, k, v, p = _inputs(len(pos), *shape, pos)
    got = TR.decode_attn_split_ref(*map(torch.from_numpy, (q, k, v, p)),
                                   R).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    jargs = [jnp.asarray(a) for a in (q, k, v, p)]
    np.testing.assert_allclose(got, np.asarray(JR.decode_attn_ref(*jargs)),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(JDA.decode_attn_pallas(
        *jargs, chunk=8, interpret=True)), **TOL)


def _paged_inputs(storage, seed=1):
    """Six slots over a shuffled pool, positions at the split edges; numpy
    pools for both packages (bf16 values exact in f32 and converted on
    each side)."""
    B, KVh, g, dh, P, Lp, seq_len = 6, 2, 3, 8, 8, 5, 36
    n_pages = paging.N_RESERVED + B * Lp
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVh, g, dh)).astype(np.float32)
    pos = np.asarray(_edges(seq_len), np.int32)
    pt = np.full((B, Lp), paging.ZERO_PAGE, np.int32)
    free = list(rng.permutation(np.arange(paging.N_RESERVED, n_pages)))
    for b in range(B):
        npp = paging.pages_for_rows(min(int(pos[b]) + 1, seq_len), P)
        pt[b, :npp] = [free.pop() for _ in range(npp)]
    pools = [rng.standard_normal((n_pages, P, KVh, dh)).astype(np.float32)
             for _ in range(2)]
    for pool in pools:
        pool[paging.ZERO_PAGE] = 0.0
    geo = dict(page_size=P, seq_len=seq_len)
    if storage == "bf16":
        pools = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                 for x in pools]
        return q, pools, pos, pt, {}, geo
    bits = int(storage[-1])
    (kc, ks), (vc, vs) = (JQ.kv_quant_encode(jnp.asarray(x), bits)
                          for x in pools)
    return (q, [np.array(kc), np.array(vc)], pos, pt,
            dict(k_scale=np.array(ks), v_scale=np.array(vs)),
            dict(geo, kv_bits=bits))


@pytest.mark.parametrize("storage", ["bf16", "int8", "int4"])
def test_paged_split_mirror_matches_pallas(storage):
    q, (kp, vp), pos, pt, scales, geo = _paged_inputs(storage)
    t = torch.from_numpy
    tk, tv = t(kp), t(vp)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    if storage == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    got = TR.paged_decode_attn_split_ref(
        t(q), tk, tv, t(pos), t(pt), rows_per_split=R, **geo,
        **{k: t(v) for k, v in scales.items()}).numpy()
    want = np.asarray(JDA.paged_decode_attn_pallas(
        jnp.asarray(q), jk, jv, jnp.asarray(pos), jnp.asarray(pt), **geo,
        **{k: jnp.asarray(v) for k, v in scales.items()}, interpret=True))
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_mirror_is_contiguous_mirror_on_the_gathered_rows():
    q, (kp, vp), pos, pt, _, geo = _paged_inputs("bf16")
    q, kp, vp, pos, pt = map(torch.from_numpy, (q, kp, vp, pos, pt))
    got = TR.paged_decode_attn_split_ref(q, kp, vp, pos, pt,
                                         rows_per_split=R, **geo)
    rows = lambda pool: TR.gather_pages(pool, None, pt, **geo)
    want = TR.decode_attn_split_ref(q, rows(kp), rows(vp), pos, R)
    assert torch.equal(got, want)


@pytest.mark.parametrize("paged", [False, True])
def test_split_mirror_is_invariant_across_rows_per_split(paged):
    """1 split (R = 64) vs 4 (R = 16) vs 8 (R = 8) over 64 rows."""
    B, S, KVh, g, dh = 3, 64, 2, 4, 16
    q, k, v, pos = map(torch.from_numpy,
                       _inputs(B, S, KVh, g, dh, [63, 40, 16], seed=13))
    if paged:     # identity page table: the pool is the arena, page-major
        P = 8
        table = torch.arange(B * S // P, dtype=torch.int32).reshape(B, -1)
        pools = [x.reshape(B * S // P, P, KVh, dh) for x in (k, v)]
        run = lambda R_: TR.paged_decode_attn_split_ref(
            q, *pools, pos, table, page_size=P, seq_len=S, rows_per_split=R_)
    else:
        run = lambda R_: TR.decode_attn_split_ref(q, k, v, pos, R_)
    one = run(64).numpy()
    for R_ in (16, 8):
        np.testing.assert_allclose(run(R_).numpy(), one, rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(one, TR.decode_attn_ref(q, k, v, pos).numpy(),
                               **TOL)


@pytest.mark.parametrize("S", [1, 7, 8, 9, 64, 576, 4096])
@pytest.mark.parametrize("rows_per_split", [1, 8, 64, 128])
def test_splits_cover_the_valid_rows_once(S, rows_per_split):
    n_splits, R_ = TDA.plan_splits(S, rows_per_split)
    assert R_ == rows_per_split and n_splits * R_ >= S > (n_splits - 1) * R_
    for pos in (-1, 0, R_ - 2, R_ - 1, R_, S - 1, S + 3):
        n_valid = min(pos + 1, S)
        covered = [r for c in range(n_splits) if c * R_ < n_valid
                   for r in range(c * R_, min((c + 1) * R_, n_valid))]
        assert covered == list(range(max(n_valid, 0)))


@pytest.mark.parametrize("R_", [0, 129])
def test_plan_splits_rejects_what_the_kernel_does_not_take(R_):
    with pytest.raises(ValueError):
        TDA.plan_splits(64, R_)


def test_both_wrappers_plan_over_the_arena_length(monkeypatch):
    """The contiguous wrapper plans over S = k.shape[1], the paged one over
    seq_len: with seq_len == S both ask `plan_splits` the same question
    (and on the card launch the same grid)."""
    asked = []
    real = TDA.plan_splits
    monkeypatch.setattr(TDA, "plan_splits",
                        lambda S, R_=TDA.ROWS_PER_SPLIT: asked.append(
                            (S, R_)) or real(S, R_))
    q, (kp, vp), pos, pt, _, geo = _paged_inputs("bf16")
    q, kp, vp, pos, pt = map(torch.from_numpy, (q, kp, vp, pos, pt))
    rows = lambda pool: TR.gather_pages(pool, None, pt, **geo)
    a = TDA.decode_attn(q, rows(kp), rows(vp), pos, rows_per_split=16)
    b = TDA.paged_decode_attn(q, kp, vp, pos, pt, rows_per_split=16, **geo)
    assert asked == [(geo["seq_len"], 16)] * 2
    assert torch.equal(a, b)

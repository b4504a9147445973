"""The GEMM core's tensor-core variant, on the CPU: its routing, the layouts
it reads in place, and the exact bf16 split of integer codes it relies on.

The card runs the kernel (`test_torch_gpu.py`); here the rule that picks
the variant and the arithmetic it composes are checked:

- `variant`: M <= 8 takes the small-M variant, M > 8 the tensor-core one
  for bf16 x and the SIMT one for f32 x; `operands` reads row-major and
  transposed views in place for the tensor-core variant and row-major
  operands at any row stride for the others, copies what a variant cannot
  read in place (for the tensor-core variant, rows TMA cannot take:
  copied into rows padded to 16 bytes), and takes every width pruning
  leaves (N 5734, 5733, 5735, 1536, 768; K 5734, 2048) in every variant
  and epilogue.
- The split p0 = bf16(v), p1 = bf16(v - p0) is exact for every integer
  |v| < 2^16 (in fact 2^17), and a third piece bf16(v - p0 - p1) makes it
  exact for every integer |v| < 2^24 and every f32 weight: codes of
  quantizers above about 18 bits (warm-up reaches 24.75) included. d *
  (x @ p0 + x @ p1 + x @ p2) on fake-quant codes matches the JAX
  package's `fake_quant_rhs` GEMM (xla-ref) and the port's plain version
  at the card tests' tolerance (rtol 1e-4, atol 1e-4 * max|y|).
- The training ops hand the GEMM `w.T` and `x.T` as views, not copies.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels import gemm_core as JG
from repro_torch.core.quant import QuantParams, quantize_int
from repro_torch.kernels import gemm_core as TG
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref

BF16, F32 = torch.bfloat16, torch.float32


def _split(v, n):
    """The kernel's split of f32 values into n bf16 pieces, each rounded to
    nearest even: p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1)."""
    pieces, rest = [], v
    for _ in range(n):
        pieces.append(rest.to(BF16))
        rest = rest - pieces[-1].to(F32)
    return pieces


@pytest.mark.parametrize("M,dtype,want", [
    (1, BF16, "small_m"), (8, BF16, "small_m"), (8, F32, "small_m"),
    (9, BF16, "tc"), (512, BF16, "tc"), (2048, BF16, "tc"),
    (9, F32, "simt"), (2048, F32, "simt")])
def test_variant_by_m_and_dtype(M, dtype, want):
    assert TG.variant(M, dtype) == want


@pytest.mark.parametrize("M,N,want", [
    (2048, 8192, 256), (2048, 2048, 256), (8192, 2048, 256),
    (512, 2048, 128), (512, 8192, 256), (37, 96, 128), (296, 144, 128)])
def test_tc_block_height_by_waves(M, N, want):
    """256-row blocks where they take fewer waves over 132 SMs than
    128-row ones (each weight tile is decoded half as often), else 128."""
    assert TG.tc_block_m(M, N, 132) == want


def _store(shape, dtype, transposed):
    """A (rows, cols) operand, row-major or the transposed view of a
    row-major (cols, rows) array."""
    rows, cols = shape
    if transposed:
        return torch.zeros((cols, rows), dtype=dtype).T
    return torch.zeros((rows, cols), dtype=dtype)


@pytest.mark.parametrize("x_t", [False, True])
@pytest.mark.parametrize("w_t", [False, True])
def test_tc_reads_views_in_place(x_t, w_t):
    x = _store((64, 256), BF16, x_t)
    w = _store((256, 128), BF16, w_t)
    kind, (xo, lda, xt), (wo, ldb, wt) = TG.operands(x, w, TG.none())
    assert kind == "tc" and (xt, wt) == (x_t, w_t)
    assert xo.data_ptr() == x.data_ptr() and wo.data_ptr() == w.data_ptr()
    assert (lda, ldb) == (64 if x_t else 256, 256 if w_t else 128)


@pytest.mark.parametrize("M,dtype", [(4, BF16), (64, F32)])
def test_other_variants_take_contiguous_copies(M, dtype):
    x = _store((M, 256), dtype, True)
    w = _store((256, 128), dtype, True)
    kind, (xo, lda, xt), (wo, ldb, wt) = TG.operands(x, w, TG.none())
    assert kind == TG.variant(M, dtype) and not (xt or wt)
    assert xo.is_contiguous() and wo.is_contiguous()
    assert (lda, ldb) == (256, 128)


def test_tc_copies_a_layout_without_a_unit_stride():
    x = torch.zeros((64, 512), dtype=BF16)[:, ::2]      # strides (512, 2)
    kind, (xo, lda, xt), _ = TG.operands(x, torch.zeros((256, 128),
                                                        dtype=BF16), TG.none())
    assert kind == "tc" and xo.is_contiguous() and (lda, xt) == (256, False)


@pytest.mark.parametrize("case", ["x_rows_200_bytes", "x_T_rows_200_bytes",
                                  "w_misaligned_base", "w_rows_200_bytes",
                                  "codes_transposed"])
def test_tc_raises_on_what_tma_cannot_take(case):
    """What TMA cannot read in place (rows or a base address off 16
    bytes) no longer raises since the GEMM takes pruned widths: it is
    copied row-major into rows padded to 16 bytes, with the same values.
    Transposed codes, which no variant reads, still raise."""
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen).to(BF16)
    x, w, epi = rand(64, 256), rand(256, 128), TG.none()
    if case == "x_rows_200_bytes":
        x, w = rand(64, 100), rand(100, 128)
    elif case == "x_T_rows_200_bytes":
        x = rand(256, 100).T                              # (100, 256)
    elif case == "w_misaligned_base":
        w = rand(256, 136)[:, 8:]                         # 16 B off, ok
        _, _, (wo, ldb, _) = TG.operands(x, w, epi)
        assert wo.data_ptr() == w.data_ptr() and ldb == 136
        w = rand(256, 136)[:, 4:132]                      # 8 B off
    elif case == "w_rows_200_bytes":
        w = rand(256, 100)
    else:
        w = torch.zeros((128, 256), dtype=torch.int8).T
        with pytest.raises(ValueError):
            TG.operands(x, w, TG.dequant(torch.ones(128)))
        return
    kind, xs, ws = TG.operands(x, w, epi)
    assert kind == "tc"
    bad = "x" if case.startswith("x") else "w"
    for name, t, (got, ld, transposed) in (("x", x, xs), ("w", w, ws)):
        if name != bad:
            assert got.data_ptr() == t.data_ptr()
            continue
        assert got.data_ptr() != t.data_ptr() and not transposed
        assert got.stride() == (ld, 1) and (ld * 2) % 16 == 0
        assert got.data_ptr() % 16 == 0 and torch.equal(got, t)


# the widths pruning leaves at full width: d_ff 8192 at sparsity 0.3 keeps
# 5734 units (w_gate's N, w_down's K), 12 of 16 heads 1536, 6 of 8 KV heads
# 768; 5733 and 5735 the odd neighbours
PRUNED_N = [5734, 5733, 5735, 1536, 768]
PRUNED_K = [5734, 2048]


def _pruned_weights(K, N):
    """(label, weight as `materialize` leaves it: contiguous, epilogue)
    for every epilogue the serving and training paths use."""
    z = torch.zeros(())
    yield "none", torch.empty((K, N), dtype=BF16), TG.none()
    yield "col_mask", torch.empty((K, N), dtype=BF16), TG.col_mask(
        torch.ones(N))
    yield "fake_quant_rhs", torch.empty((K, N), dtype=BF16), \
        TG.fake_quant_rhs(z, z, z)
    yield "fq_col_mask", torch.empty((K, N), dtype=BF16), TG.fq_col_mask(
        z, z, z, torch.ones(N))
    yield "dequant", torch.empty((K, N), dtype=torch.int8), TG.dequant(
        torch.ones(N))
    for bits in (2, 3, 4, 8):
        cpw = 32 // bits
        yield f"unpack_b{bits}", torch.empty((-(-K // cpw), N),
                                             dtype=torch.int32), \
            TG.unpack_dequant(bits, torch.ones(N))


@pytest.mark.parametrize("K", PRUNED_K)
@pytest.mark.parametrize("N", PRUNED_N)
@pytest.mark.parametrize("M,dtype", [(4, BF16), (512, BF16), (64, F32)],
                         ids=["small_m", "tc", "simt"])
def test_operands_take_pruned_widths(M, dtype, N, K):
    """Every variant and epilogue takes the full-width pruned shapes, x and
    w contiguous as `materialize` leaves them: no ValueError. A weight is
    read in place where its rows suit the variant (16-byte rows for the
    tensor-core variant's TMA, rows a multiple of 4 columns apart for the
    others' 4-column loads), else copied into 16-byte rows; stored with
    `aligned_rows`, as `prepare_serving` leaves served weights, it is read
    in place by every variant. x is read in place by the small-M and SIMT
    variants at any row stride, and copied for the tensor-core variant
    when its rows are not 16-byte multiples (K = 5734)."""
    x = torch.empty((M, K), dtype=dtype)
    for label, w, epi in _pruned_weights(K, N):
        for store in (w, TG.aligned_rows(w)):
            kind, (xo, lda, _), (wo, ldb, _) = TG.operands(x, store, epi)
            assert kind == TG.variant(M, dtype), label
            assert wo.shape == store.shape and xo.shape == x.shape
            ld, es = store.stride(0), store.element_size()
            fits = (ld * es) % 16 == 0 if kind == "tc" else ld % 4 == 0
            assert fits or store is w, label
            if fits:
                assert wo.data_ptr() == store.data_ptr() and ldb == ld
            else:
                assert wo.data_ptr() != store.data_ptr(), label
                assert (ldb * es) % 16 == 0 and ldb >= N, label
            if kind != "tc" or (K * x.element_size()) % 16 == 0:
                assert xo.data_ptr() == x.data_ptr() and lda == K
            else:
                assert (lda * 2) % 16 == 0 and lda >= K


@pytest.mark.parametrize("n,limit,zero_below", [(2, 2 ** 16, 257),
                                                (3, 2 ** 24, 2 ** 17)])
def test_bf16_split_is_exact_for_every_code(n, limit, zero_below):
    """n pieces sum to every integer |v| < limit exactly; the last piece is
    zero below `zero_below`, where the kernel skips its pass (one piece
    holds |v| <= 256; two hold |v| < 2^17, whose residual after p0 is an
    integer of at most 256)."""
    for start in range(-limit + 1, limit, 2 ** 21):
        v = torch.arange(start, min(start + 2 ** 21, limit), dtype=F32)
        pieces = _split(v, n)
        assert torch.equal(sum(q.to(F32) for q in pieces), v)
        assert not pieces[-1][v.abs() < zero_below].to(F32).any()
    assert pieces[-1].to(F32).any()
    assert _split(torch.tensor([2.0 ** 17 + 257]), 3)[2].to(F32).item() == 1


@pytest.mark.parametrize("scale", [1e-3, 0.02, 1.0, 3e4, 2.0 ** 60])
def test_three_piece_split_is_exact_for_f32_weights(scale):
    """An f32 weight (24 significand bits) in three bf16 pieces."""
    gen = torch.Generator().manual_seed(int(np.log2(scale) + 100))
    v = torch.randn((1 << 18,), generator=gen) * scale
    pieces = _split(v, 3)
    assert torch.equal(sum(q.to(F32) for q in pieces), v)
    assert pieces[2].to(F32).any()      # two pieces would not do


@pytest.mark.parametrize("bits,t", [(8.0, 1.0), (12.0, 1.0), (12.0, 0.85),
                                    (16.0, 0.85), (20.0, 1.0), (20.0, 0.85),
                                    (24.0, 1.0), (24.75, 0.85)])
def test_split_codes_matmul_matches_jax_and_plain(bits, t):
    """What the kernel computes for fake_quant_rhs: the codes' bf16 pieces
    (a third one for codes of 2^17 and more, quantizers above about 18
    bits) against bf16 x, summed in f32, scaled by d once per output."""
    M, K, N = 37, 160, 96
    rng = np.random.default_rng(int(bits * 10 + t * 100))
    x = rng.standard_normal((M, K)).astype(np.float32)
    x = torch.from_numpy(x).to(BF16).float().numpy()   # bf16-exact inputs
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    qp = JQ.init_quant_params(jnp.asarray(w), bits=bits, t=t)
    d, qm, tt = (torch.from_numpy(np.array(v, np.float32))
                 for v in (qp.d, qp.q_m, qp.t))
    q, _ = quantize_int(torch.from_numpy(w), QuantParams(d, qm, tt), bits)
    pieces = _split(q, 3)
    assert torch.equal(sum(p.to(F32) for p in pieces), q)
    assert (bits <= 8) == (q.abs().max() <= 256)
    assert (bits >= 20) == bool(pieces[2].to(F32).any())
    xt = torch.from_numpy(x)
    got = sum(xt @ p.float() for p in pieces) * torch.clamp_min(d, 1e-12)
    want_jax = np.asarray(JG.gemm(jnp.asarray(x), jnp.asarray(w),
                                  (JG.fake_quant_rhs(qp.d, qp.q_m, qp.t),),
                                  backend="xla-ref"))
    want = ref.fq_matmul_ref(xt, torch.from_numpy(w), d, qm, tt)
    for name, ref_y in (("jax", want_jax), ("plain", want.numpy())):
        np.testing.assert_allclose(got.numpy(), ref_y, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref_y).max(),
                                   err_msg=name)


@pytest.mark.parametrize("op", ["matmul", "masked", "fq", "fq_masked"])
def test_training_backward_passes_views(op, monkeypatch):
    """The backward GEMMs get w.T and x.T as views of the saved tensors
    (the tensor-core variant reads them in place), never copies."""
    M, K, N = 16, 24, 32
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((M, K), generator=gen, requires_grad=True)
    w = torch.randn((K, N), generator=gen, requires_grad=True)
    mask = (torch.arange(N) % 3 > 0).float()
    sc = [torch.tensor(v, requires_grad=True) for v in (0.05, 1.5, 1.0)]
    seen = []
    real = TG.gemm

    def spy(a, b, epi, **kw):
        seen.append((a, b))
        return real(a, b, epi, **kw)

    monkeypatch.setattr(TOPS._gc, "gemm", spy)
    y = {"matmul": lambda: TOPS.matmul_op(x, w),
         "masked": lambda: TOPS.masked_matmul_op(x, w, mask),
         "fq": lambda: TOPS.fq_matmul_op(x, w, *sc),
         "fq_masked": lambda: TOPS.fq_masked_matmul_op(x, w, mask, *sc)}[op]()
    y.sum().backward()
    (_, w_fwd), (_, w_dx), (x_dw, _) = seen
    assert w_fwd.data_ptr() == w.data_ptr() and w_fwd.stride() == (N, 1)
    assert w_dx.data_ptr() == w.data_ptr() and w_dx.stride() == (1, N)
    assert x_dw.data_ptr() == x.data_ptr() and x_dw.stride() == (1, K)

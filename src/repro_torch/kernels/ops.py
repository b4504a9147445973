"""Public kernel entry points.

Each op is one call (or, with a gradient, a few calls) of a kernel wrapper,
which decides by device between the CUDA kernel and its plain PyTorch
version.

The matmul ops on the training path (`matmul_op`, `masked_matmul_op`,
`fq_matmul_op`, `fq_masked_matmul_op`) are `torch.autograd.Function`s
whose backward GEMMs run on the same GEMM core, as `repro.kernels.ops`'s
custom VJPs do: the quantizer stays fused into the dx GEMM's weight load
(`g @ fake_quant(w.T)`), `dwq = x.T @ g` runs with no epilogue and is
written in w's dtype, and the weight cotangent goes through the
fake-quant backward kernel (the STE of Eqs 4-6). The GEMM rounds its f32
sums once to w's dtype, the same bits as an f32 output cast with
`.to(w.dtype)`, the JAX package's cast, so at bf16 the scalar sums change
exactly as there, with no cast pass over the weight. Column masks are
GETA decay schedules, not learned parameters: their cotangent is zero.
`fake_quant_op` is `core.quant.fake_quant`, the same custom-VJP contract.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import fake_quant
from repro_torch.kernels import fake_quant as _fq
from repro_torch.kernels import gemm_core as _gc
from repro_torch.kernels.decode_attn import decode_attn, paged_decode_attn

F32 = torch.float32


def fake_quant_op(x, d, q_m, t) -> torch.Tensor:
    """Differentiable fake-quant through the fused elementwise kernels."""
    return fake_quant(x, d, q_m, t)


def _mask_cols(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """g * mask[None, :] in f32, back in g's dtype."""
    return (g.to(F32) * mask.to(F32).reshape(1, -1)).to(g.dtype)


def _fq_weight_grads(w, d, q_m, t, dwq):
    """Route the weight cotangent dwq (in w's dtype) through the
    quantizer's STE: (dw, dd, dq_m, dt)."""
    dw, dd, dqm, dt = _fq.fake_quant_bwd(w, d, q_m, t, dwq)
    return dw, dd.reshape(d.shape), dqm.reshape(q_m.shape), dt.reshape(t.shape)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gc.gemm(x, w, _gc.none())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _gc.gemm(g, w.T, _gc.none(), out_dtype=x.dtype)
        dw = _gc.gemm(x.T, g, _gc.none(), out_dtype=w.dtype)
        return dx, dw


class _MaskedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mask):
        ctx.save_for_backward(x, w, mask)
        return _gc.gemm(x, w, _gc.col_mask(mask))

    @staticmethod
    def backward(ctx, g):
        x, w, mask = ctx.saved_tensors
        # d/dx [x @ (w*m)] = (g*m) @ w.T ; d/dw = (x.T @ g) * m
        dx = _gc.gemm(_mask_cols(g, mask), w.T, _gc.none(),
                      out_dtype=x.dtype)
        dw = _gc.gemm(x.T, g, _gc.col_mask(mask), out_dtype=w.dtype)
        return dx, dw, torch.zeros_like(mask)


class _FqMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, d, q_m, t):
        ctx.save_for_backward(x, w, d, q_m, t)
        return _gc.gemm(x, w, _gc.fake_quant_rhs(d, q_m, t))

    @staticmethod
    def backward(ctx, g):
        x, w, d, q_m, t = ctx.saved_tensors
        # dx = g @ fake_quant(w).T: fake_quant is elementwise, so the
        # transpose commutes and the quantizer stays in the weight load
        dx = _gc.gemm(g, w.T, _gc.fake_quant_rhs(d, q_m, t),
                      out_dtype=x.dtype)
        dwq = _gc.gemm(x.T, g, _gc.none(), out_dtype=w.dtype)
        return (dx, *_fq_weight_grads(w, d, q_m, t, dwq))


class _FqMaskedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mask, d, q_m, t):
        ctx.save_for_backward(x, w, mask, d, q_m, t)
        return _gc.gemm(x, w, _gc.fq_col_mask(d, q_m, t, mask))

    @staticmethod
    def backward(ctx, g):
        x, w, mask, d, q_m, t = ctx.saved_tensors
        # dx = (g*m) @ fake_quant(w.T); dwq = x.T @ (g*m)
        gm = _mask_cols(g, mask)
        dx = _gc.gemm(gm, w.T, _gc.fake_quant_rhs(d, q_m, t),
                      out_dtype=x.dtype)
        dwq = _gc.gemm(x.T, gm, _gc.none(), out_dtype=w.dtype)
        dw, dd, dqm, dt = _fq_weight_grads(w, d, q_m, t, dwq)
        return dx, dw, torch.zeros_like(mask), dd, dqm, dt


def matmul_op(x, w) -> torch.Tensor:
    """y = x @ w on the GEMM core (differentiable)."""
    return _Matmul.apply(x, w)


def masked_matmul_op(x, w, mask) -> torch.Tensor:
    """y = x @ (w * mask[None, :]) (differentiable; mask cotangent 0)."""
    return _MaskedMatmul.apply(x, w, mask)


def fq_matmul_op(x, w, d, q_m, t) -> torch.Tensor:
    """y = x @ fake_quant(w; d, q_m, t) in one pass over W; backward by
    the STE (Eqs 4-6 for the scalars)."""
    return _FqMatmul.apply(x, w, d, q_m, t)


def fq_masked_matmul_op(x, w, mask, d, q_m, t) -> torch.Tensor:
    """y = x @ (fake_quant(w; d, q_m, t) * mask[None, :]) — the GETA
    joint-stage forward in one pass over W (mask cotangent 0)."""
    return _FqMaskedMatmul.apply(x, w, mask, d, q_m, t)


def quant_matmul_op(x, codes, scale) -> torch.Tensor:
    """y = x @ (codes * scale[None, :]) — int-code serving."""
    return _gc.gemm(x, codes, _gc.dequant(scale))


def packed_quant_matmul_op(x, packed, bits: int, scale) -> torch.Tensor:
    """y = x @ (unpack(packed; bits) * scale[None, :]) — sub-byte serving;
    `packed` is the K-packed int32 word stream of `core.quant.pack_codes`."""
    return _gc.gemm(x, packed, _gc.unpack_dequant(bits, scale))


def decode_attn_op(q, k, v, pos) -> torch.Tensor:
    """Single-query flash-decode attention; see `decode_attn.decode_attn`."""
    return decode_attn(q, k, v, pos)


def paged_decode_attn_op(q, kpool, vpool, pos, page_table, *, page_size,
                         seq_len, kv_bits=None, k_scale=None, v_scale=None
                         ) -> torch.Tensor:
    """Single-query flash-decode attention over the paged KV pool; see
    `decode_attn.paged_decode_attn`."""
    return paged_decode_attn(q, kpool, vpool, pos, page_table,
                             page_size=page_size, seq_len=seq_len,
                             kv_bits=kv_bits, k_scale=k_scale,
                             v_scale=v_scale)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel variant (GEMM epilogue, fake-quant
    direction, page storage)."""
    out = {f"gemm_core.{k}": v for k, v in _gc.gemm.launches.items()}
    out.update({f"fake_quant.{k}": v for k, v in _fq.launches.items()})
    out["decode_attn"] = decode_attn.launches
    out.update({f"paged_decode_attn.{k}": v
                for k, v in paged_decode_attn.launches.items()})
    return out


def reset_launch_counts() -> None:
    for counts in (_gc.gemm.launches, _fq.launches,
                   paged_decode_attn.launches):
        for k in counts:
            counts[k] = 0
    decode_attn.launches = 0

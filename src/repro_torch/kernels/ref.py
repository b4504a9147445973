"""Plain PyTorch versions of the ported kernels.

Each one repeats the composition of its counterpart in `repro.kernels.ref`
(the JAX package's xla-ref backend) op for op: the kernel wrappers take
these for CPU tensors, the CPU tests hold them to JAX, and `chip_smoke.py`
holds each CUDA kernel to them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant import _EPS, clip_qmt, unpack_codes

F32 = torch.float32


def fake_quant_weight(w: torch.Tensor, d: torch.Tensor, q_m: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """The `fake_quant_rhs` epilogue on an f32 weight: Eqs (1)-(2) with the
    kernel's operation order, d * round(clip^t(|w|) / d) * sgn(w)."""
    d = torch.clamp_min(d.to(F32), _EPS)
    xt = clip_qmt(w.abs(), q_m.to(F32), t.to(F32))
    return d * torch.round(xt / d) * torch.sign(w)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain dense y = x @ w at f32 accumulation."""
    return (x.to(F32) @ w.to(F32)).to(x.dtype)


def fq_matmul_ref(x, w, d, q_m, t, *, out_dtype=None) -> torch.Tensor:
    """y = x @ fake_quant(w) — the dense serving projection."""
    wq = fake_quant_weight(w.to(F32), d, q_m, t)
    return (x.to(F32) @ wq).to(out_dtype or x.dtype)


def quant_matmul_ref(x, codes, scale, *, out_dtype=None) -> torch.Tensor:
    """y = x @ (codes * scale[None, :]) — int codes, per-column scales
    (or one scale for every column)."""
    w = codes.to(F32) * scale.to(F32).reshape(1, -1)
    return (x.to(F32) @ w).to(out_dtype or x.dtype)


def packed_quant_matmul_ref(x, packed, bits, scale, *, out_dtype=None
                            ) -> torch.Tensor:
    """y = x @ (unpack(packed; bits) * scale[None, :]) — K-packed int32
    words decoded back to the (K, N) codes first."""
    codes = unpack_codes(packed, bits, x.shape[-1], axis=0)
    return quant_matmul_ref(x, codes, scale, out_dtype=out_dtype)


def decode_attn_ref(q, k, v, pos) -> torch.Tensor:
    """Single-query attention over the slot KV arena.

    q: (B, KVh, g, dh); k/v: (B, S, KVh, dh) with the current token
    written; pos: (B,) int. Row b attends over its min(pos[b] + 1, S)
    written rows. The exact einsum/softmax composition of the JAX
    reference. Returns (B, KVh, g, dh) f32."""
    B, KVh, g, dh = q.shape
    S = k.shape[1]
    pos = pos.to(torch.int64).reshape(-1)
    qh = q.reshape(B, 1, KVh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh.to(F32),
                          k.to(F32)) / math.sqrt(dh)
    valid = (torch.arange(S, device=k.device)[None, :]
             < torch.clamp(pos + 1, max=S)[:, None])
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.tensor(-1e30, dtype=F32, device=k.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(F32))
    return out.reshape(B, KVh, g, dh)

"""Plain PyTorch versions of the ported kernels.

Each one repeats the composition of its counterpart in `repro.kernels.ref`
(the JAX package's xla-ref backend) op for op: the kernel wrappers take
these for CPU tensors, the CPU tests hold them to JAX, and `chip_smoke.py`
holds each CUDA kernel to them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant import (_EPS, clip_qmt, kv_quant_decode,
                                    unpack_codes)

F32 = torch.float32


def fake_quant_fwd_ref(x: torch.Tensor, d: torch.Tensor, q_m: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """Eqs (1)-(2) elementwise in f32, returned in x's dtype: the plain
    version of the fake-quant forward kernel."""
    d32 = torch.clamp_min(d.to(F32), _EPS)
    sign = torch.sign(x).to(F32)
    xt = clip_qmt(x.abs().to(F32), q_m.to(F32), t.to(F32))
    return (d32 * torch.round(xt / d32) * sign).to(x.dtype)


def fake_quant_bwd_ref(x, d, q_m, t, g):
    """STE dx (g inside the clip, 0 outside, in x's dtype) and the three
    scalar sums of Eqs (4)-(6), (dd, dq_m, dt) as f32 0-d tensors, in the
    operation order of `repro.core.quant`'s custom VJP: the plain version
    of the fake-quant backward kernel."""
    x32 = x.to(F32)
    g32 = g.to(F32)
    d32 = torch.clamp_min(d.to(F32), _EPS)
    qm32 = torch.clamp_min(q_m.to(F32), _EPS)
    t32 = t.to(F32)
    ax = x32.abs()
    sign = torch.sign(x32)
    inside = ax <= qm32
    dx = torch.where(inside, g32, 0.0).to(x.dtype)
    v = clip_qmt(ax, qm32, t32) / d32
    dd = torch.sum(g32 * (sign * (torch.round(v) - v)))
    base = torch.where(inside, torch.clamp_min(ax, _EPS), qm32)
    dt = torch.sum(g32 * (sign * torch.pow(base, t32) * torch.log(base)))
    dqm = torch.sum(g32 * torch.where(
        inside, 0.0, sign * t32 * torch.pow(qm32, t32 - 1.0)))
    return dx, dd, dqm, dt


def fake_quant_weight(w: torch.Tensor, d: torch.Tensor, q_m: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """The `fake_quant_rhs` epilogue on an f32 weight: Eqs (1)-(2) with the
    kernel's operation order, d * round(clip^t(|w|) / d) * sgn(w)."""
    d = torch.clamp_min(d.to(F32), _EPS)
    xt = clip_qmt(w.abs(), q_m.to(F32), t.to(F32))
    return d * torch.round(xt / d) * torch.sign(w)


def matmul_ref(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None
               ) -> torch.Tensor:
    """Plain dense y = x @ w at f32 accumulation."""
    return (x.to(F32) @ w.to(F32)).to(out_dtype or x.dtype)


def masked_matmul_ref(x, w, mask, *, out_dtype=None) -> torch.Tensor:
    """y = x @ (w * mask[None, :]) — structured column (group) masking."""
    w32 = w.to(F32) * mask.to(F32).reshape(1, -1)
    return (x.to(F32) @ w32).to(out_dtype or x.dtype)


def fq_matmul_ref(x, w, d, q_m, t, mask=None, *, out_dtype=None
                  ) -> torch.Tensor:
    """y = x @ (fake_quant(w) * mask) in f32 — the dense serving
    projection, and with `mask` the GETA joint-stage forward."""
    wq = fake_quant_weight(w.to(F32), d, q_m, t)
    if mask is not None:
        wq = wq * mask.to(F32).reshape(1, -1)
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


def gather_pages(pool, scale, page_table, page_size: int, seq_len: int,
                 kv_bits=None) -> torch.Tensor:
    """Each slot's rows through its page table, sliced to `seq_len`:
    (B, seq_len, KVh, dh), decoded to f32 when the pool holds codes."""
    pt = page_table.to(torch.int64)
    B, Lp = pt.shape
    pages = pool[pt]                          # (B, Lp, P, KVh, dh*)
    if kv_bits is not None:
        pages = kv_quant_decode(pages, scale[pt], kv_bits)
    return pages.reshape(B, Lp * page_size, *pages.shape[3:])[:, :seq_len]


def paged_decode_attn_ref(q, kpool, vpool, pos, page_table, *, page_size,
                          seq_len, kv_bits=None, k_scale=None, v_scale=None
                          ) -> torch.Tensor:
    """Single-query attention over a paged KV pool.

    kpool/vpool: (n_pages, page_size, KVh, dh) pages, or int8 codes of
    width dh (kv_bits 8) or dh // 2 (kv_bits 4) with per-row f32 scales
    k_scale/v_scale (n_pages, page_size, KVh); page_table: (B, Lp) int
    logical -> physical page map per slot. Gathers each slot's pages,
    decodes them if quantized, and slices the flattened rows to exactly
    `seq_len`, the contiguous arena's length, before `decode_attn_ref`.

    The slice keeps the paged-vs-contiguous token identity: attention
    over Lp * page_size rows need not sum in the same order as over
    seq_len rows, even though the extra rows carry zero probability. With
    it, an unquantized pool's gathered view is the contiguous arena
    (unallocated logical pages alias the zero page, like the arena's zero
    tail) and this reduces to the same composition."""
    if page_table.shape[1] * page_size < seq_len:
        raise ValueError(f"page table covers {page_table.shape[1] * page_size}"
                         f" rows < seq_len {seq_len}")
    return decode_attn_ref(
        q, gather_pages(kpool, k_scale, page_table, page_size, seq_len,
                        kv_bits),
        gather_pages(vpool, v_scale, page_table, page_size, seq_len, kv_bits),
        pos)

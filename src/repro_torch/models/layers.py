"""Layers of the dense GQA LM as plain functions over a flat param dict.

Port of the dense subset of `repro.models.layers`. Conventions follow the
JAX module: `params` is a flat dict[str, Tensor] under the JAX keys, a
per-layer view `lp` indexes the stacked (L, ...) tensors, `qparams` maps
quantizer sites (`<name>.wq`, `<site>.aq`) to `QuantParams`, activations
run in the config's dtype and softmax/norm in f32.

Projections go through `dense_proj`, which routes a weight to the GEMM
kernel whose epilogue decodes it: fake-quant (and the GETA column mask)
for dense weights with a quantizer, dequant for `<name>.codes`,
unpack-dequant for `<name>.packed{bits}`. The training forward is
differentiable: the routed GEMMs and the fake-quant sites are autograd
Functions over the kernels. Full-sequence attention (dense, or blockwise
past `attn_block_threshold`), norms, rope and SiLU are plain PyTorch, as
they were plain XLA in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import (PACKED_STORAGE_BITS, QuantParams,
                                    fake_quant, kv_quant_encode)
from repro_torch.kernels import ops as Kops

# Components whose 2-D weights execute through `dense_proj`.
ROUTED_COMPONENTS = ("attn", "mlp", "mamba", "rwkv", "shared")
# `<name>.packed{bits}` suffixes, widest first, as `compress_lm` emits them.
PACKED_PARAM_BITS = tuple(sorted(PACKED_STORAGE_BITS, reverse=True))


def not_in_this_slice(what: str, where: str) -> NotImplementedError:
    """The error every path the port does not cover yet raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; it comes with {where}")


@dataclasses.dataclass(frozen=True)
class LayerShapes:
    """Physical dims one sublayer executes at: the config's, or a pruned
    subnet's surviving widths (`core.subnet.derive_slim_plan`), which
    `LM.apply_slim_plan` installs. The residual width d_model and d_head
    are never pruned."""
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "LayerShapes":
        return cls(d_model=cfg.d_model, n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                   d_ff=cfg.d_ff)


@dataclasses.dataclass(frozen=True)
class PagedView:
    """How one decode step addresses the paged KV pool.

    `table` is the (B, Lp) int32 logical -> physical page map on the
    device, the same for every layer. `page_size` rows per page;
    `seq_len` is the logical arena length: attention masks and slices to
    exactly this many rows, so an unquantized paged decode is bitwise the
    contiguous arena's; `kv_bits` (None, 8 or 4) selects the quantized
    page store."""
    table: torch.Tensor
    page_size: int
    seq_len: int
    kv_bits: Optional[int] = None


def pick(logits: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """logits[..., index] along the last axis by a masked sum: exact (one
    term is not zero), as the JAX package computes a gold logit, and its
    backward needs no scatter."""
    iota = torch.arange(logits.shape[-1], dtype=index.dtype,
                        device=index.device)
    return torch.sum(torch.where(iota == index[..., None], logits, 0.0),
                     dim=-1)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def qw(params: dict, qparams: Optional[dict], name: str) -> torch.Tensor:
    """Weight fetch through the (optional) parameterized quantizer."""
    w = params[name]
    qp = qparams.get(name + ".wq") if qparams is not None else None
    if qp is not None:
        w = fake_quant(w, qp.d, qp.q_m, qp.t)
    return w


def qa(x: torch.Tensor, qparams: Optional[dict], site: str) -> torch.Tensor:
    """Activation pass through the (optional) parameterized quantizer."""
    qp = qparams.get(site) if qparams is not None else None
    if qp is not None:
        x = fake_quant(x, qp.d, qp.q_m, qp.t)
    return x


def dense_proj(x: torch.Tensor, lp: dict, qp: Optional[dict], name: str, *,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ (T(w) * mask) for one 2-D weight, routed by what the param dict
    holds:

    - `<name>.packed{bits}` + `<name>.scale` -> packed_quant_matmul_op
    - `<name>.codes` + `<name>.scale`       -> quant_matmul_op
    - dense weight with a `<name>.wq` site and a column mask (`mask=`, or
      `<name>.colmask` riding the param dict) -> fq_masked_matmul_op
    - dense weight with a site               -> fq_matmul_op
    - dense weight with a mask only          -> masked_matmul_op
    - dense weight, neither                  -> x @ w (torch.matmul)
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if mask is None:
        mask = lp.get(name + ".colmask")
    for pbits in PACKED_PARAM_BITS:
        packed = lp.get(f"{name}.packed{pbits}")
        if packed is not None:
            y = Kops.packed_quant_matmul_op(x2, packed, pbits,
                                            lp[name + ".scale"])
            return y.reshape(*lead, packed.shape[-1])
    codes = lp.get(name + ".codes")
    if codes is not None:
        y = Kops.quant_matmul_op(x2, codes, lp[name + ".scale"])
        return y.reshape(*lead, codes.shape[-1])
    w = lp[name]
    qpw: Optional[QuantParams] = qp.get(name + ".wq") if qp else None
    if w.ndim != 2 or (qpw is None and mask is None):
        if qpw is not None:
            w = fake_quant(w, qpw.d, qpw.q_m, qpw.t)
        if mask is not None:
            w = w * mask.to(w.dtype)[None, :]
        return x @ w
    if qpw is not None and mask is not None:
        y = Kops.fq_masked_matmul_op(x2, w, mask, qpw.d, qpw.q_m, qpw.t)
    elif qpw is not None:
        y = Kops.fq_matmul_op(x2, w, qpw.d, qpw.q_m, qpw.t)
    else:
        y = Kops.masked_matmul_op(x2, w, mask)
    return y.reshape(*lead, w.shape[-1])


# ------------------------------------------------------------------ norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------- rope
def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     -torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def rope_tables(seq_len: int, d_head: int, theta: float, offset: int = 0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * rope_freqs(d_head, theta, device)[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, dh); cos/sin: (S, dh/2), or (B, S, dh/2) when every
    sequence sits at its own absolute position (per-slot decode)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    if cos.ndim == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
def attention_dense(q, k, v, *, q_offset: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """Full materialized attention, causal unless `causal=False` (the
    BERT encoder). q: (B, Sq, H, dh); k/v: (B, Sk, KV, dh), GQA by
    reshape."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qh = q.reshape(B, Sq, KV, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(dh)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where((ki <= qi)[None, None, None], scores,
                             torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _attend_q_block(q_i: torch.Tensor, k_blocks: torch.Tensor,
                    v_blocks: torch.Tensor) -> torch.Tensor:
    """One query block of `attention_blockwise`: an online softmax over the
    KV blocks at or before it, the last of them the diagonal one. q_i:
    (B, blk, KV, g, dh); k/v_blocks: (B, n, blk, KV, dh). Returns
    (B, blk, KV, g, dh) f32."""
    B, blk, KV, g, dh = q_i.shape
    qf = q_i.to(torch.float32)
    diag = torch.ones((blk, blk), dtype=torch.bool, device=q_i.device).tril()
    m = torch.full((B, KV, g, blk), -1e30, dtype=torch.float32,
                   device=q_i.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, g, blk, dh), dtype=torch.float32,
                      device=q_i.device)
    n = k_blocks.shape[1]
    for j in range(n):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf,
                         k_blocks[:, j].to(torch.float32)) / math.sqrt(dh)
        if j == n - 1:
            s = s.masked_fill(~diag, -1e30)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, v_blocks[:, j].to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4)


def attention_blockwise(q, k, v, *, block: int = 1024) -> torch.Tensor:
    """Flash-style causal attention that never materializes S x S: a loop
    over query blocks, each an online softmax (running max, denominator
    and accumulator) over KV blocks, with `attention_dense`'s -1e30 mask
    and a max(l, 1e-30) guard. Shapes as `attention_dense`; S a multiple
    of `block`.

    The reference also scans the KV blocks after the query block; they
    are fully masked and leave (m, l, acc) exactly as they were, so they
    are skipped here. With grad enabled each query block runs under
    `torch.utils.checkpoint` (non-reentrant), the reference's
    `jax.checkpoint`: the backward recomputes a block's scores instead of
    keeping every score tile of the layer."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    if S % block or k.shape[1] != S:
        raise ValueError(f"attention_blockwise: S={S} (keys {k.shape[1]}) "
                         f"must be a multiple of block={block} and Sq == Sk")
    nb = S // block
    qb = q.reshape(B, nb, block, KV, g, dh)
    kb = k.reshape(B, nb, block, KV, dh)
    vb = v.reshape(B, nb, block, KV, dh)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(nb):
        args = (qb[:, i], kb[:, :i + 1], vb[:, :i + 1])
        outs.append(checkpoint(_attend_q_block, *args, use_reentrant=False)
                    if remat else _attend_q_block(*args))
    return torch.stack(outs, dim=1).reshape(B, S, H, dh).to(q.dtype)


def attention(q, k, v, cfg: ModelConfig, *, q_offset: int = 0
              ) -> torch.Tensor:
    """Blockwise for a long self-attention (S > `attn_block_threshold`, a
    multiple of `attn_block_size`, Sq == Sk), dense otherwise: the
    reference's dispatch."""
    S = q.shape[1]
    if S > cfg.attn_block_threshold and S % cfg.attn_block_size == 0 \
            and q.shape[1] == k.shape[1]:
        return attention_blockwise(q, k, v, block=cfg.attn_block_size)
    return attention_dense(q, k, v, q_offset=q_offset)


def _normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std


def init_attention(gen: torch.Generator, cfg: ModelConfig, prefix: str,
                   n_layers: int, dtype) -> dict:
    D, Q, KVd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    std = D ** -0.5
    L = (n_layers,)
    p = {f"{prefix}.wq": _normal(gen, L + (D, Q), dtype, std),
         f"{prefix}.wk": _normal(gen, L + (D, KVd), dtype, std),
         f"{prefix}.wv": _normal(gen, L + (D, KVd), dtype, std),
         f"{prefix}.wo": _normal(gen, L + (Q, D), dtype, std)}
    if cfg.qkv_bias:
        z = lambda n: torch.zeros(L + (n,), dtype=dtype, device=gen.device)
        p.update({f"{prefix}.bq": z(Q), f"{prefix}.bk": z(KVd),
                  f"{prefix}.bv": z(KVd)})
    return p


def attn_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
               rope: tuple, prefix: str, cache: Optional[tuple] = None,
               q_offset: int = 0, shapes: Optional[LayerShapes] = None,
               chunked: bool = False, pages: Optional[PagedView] = None):
    """Attention sublayer; lp is one layer's view of the params.

    Five branches: the full sequence (no cache), the chunked scoring
    (`chunked`: an S-token chunk mid-sequence, the speculative verify pass
    and chunked prefill; each slot's S K/V rows go to rows
    [pos[b], pos[b] + S) and query i attends over arena rows
    [0, pos[b] + i]), the one-shot prefill (cache and S > 1: the prompt's
    K/V go to rows [0, S) of a zeroed cache and attention runs over the
    prompt itself), the paged decode (`pages` given: the token's K/V row
    goes to its slot's physical row in the shared pools and the
    page-indirect kernel attends through the page table) and the
    contiguous decode (cache and S == 1: the token's K/V go to row `pos`
    of each slot and the flash-decode kernel attends over the arena).
    cache is (k_cache, v_cache, pos) with k/v (B, S_max, KVh, dh) views of
    the stacked arena, or, paged, (k_pool, v_pool, pos, k_scale, v_scale)
    with (n_pages, P, KVh, dh*) pools and (n_pages, P, KVh) scales (None
    unless `pages.kv_bits` is set). Every cache branch writes the cache IN
    PLACE (advanced-index assignment into the view) and returns the same
    tensors. The chunked scoring is plain PyTorch, as the reference's is
    plain XLA. Returns (out, new_cache)."""
    B, S, _ = x.shape
    shapes = shapes or LayerShapes.from_config(cfg)
    H, KVh, dh = shapes.n_heads, shapes.n_kv_heads, shapes.d_head
    q = dense_proj(x, lp, qp, f"{prefix}.wq")
    k = dense_proj(x, lp, qp, f"{prefix}.wk")
    v = dense_proj(x, lp, qp, f"{prefix}.wv")
    if cfg.qkv_bias:
        q = q + lp[f"{prefix}.bq"]
        k = k + lp[f"{prefix}.bk"]
        v = v + lp[f"{prefix}.bv"]
    q = apply_rope(q.reshape(B, S, H, dh), *rope)
    k = apply_rope(k.reshape(B, S, KVh, dh), *rope)
    v = v.reshape(B, S, KVh, dh)

    new_cache = None
    if cache is not None and chunked:
        # full arenas only: a ring write would overwrite rows that a
        # rejected draft could never roll back
        if cfg.window > 0:
            raise ValueError(
                f"{prefix}: chunked cache scoring needs a full (non-ring) "
                f"arena; window={cfg.window} layers overwrite rows on wrap")
        ck, cv, pos = cache
        pos = torch.as_tensor(pos, dtype=torch.int64,
                              device=x.device).reshape(-1).expand(B)
        steps = torch.arange(S, device=x.device)
        # the reference's dynamic_update_slice clamps a chunk that would
        # run past the arena (an idle slot's) back inside it
        start = torch.clamp(pos, max=ck.shape[1] - S)
        rows = start[:, None] + steps[None, :]                 # (B, S)
        slots = torch.arange(B, device=x.device)[:, None]
        ck[slots, rows] = k.to(ck.dtype)
        cv[slots, rows] = v.to(cv.dtype)
        g = H // KVh
        qh = q.reshape(B, S, KVh, g, dh)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qh.to(torch.float32),
                              ck.to(torch.float32)) / math.sqrt(dh)
        valid = (torch.arange(ck.shape[1], device=x.device)[None, None, :]
                 <= pos[:, None, None] + steps[None, :, None])
        # masked_fill, not torch.where with a -1e30 tensor: building that
        # tensor copies from the host, which a CUDA graph capture refuses
        scores = scores.masked_fill(~valid[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs,
                           cv.to(torch.float32)).to(x.dtype)
        new_cache = (ck, cv, pos + S)
    elif cache is not None and S > 1:
        ck, cv, pos = cache
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        out = attention(q, k, v, cfg)
        new_cache = (ck, cv, pos + S)
    elif cache is not None and pages is not None:
        ck, cv, pos, ksc, vsc = cache
        P = pages.page_size
        n_rows = ck.shape[0] * P
        pos = torch.as_tensor(pos, dtype=torch.int64,
                              device=x.device).reshape(-1).expand(B)
        # an idle slot may decode past its table in a window; its table is
        # all trash pages, so clamping the logical page keeps the write in
        # the trash page (the JAX reference wraps it into the zero page)
        page = torch.clamp(pos // P, max=pages.table.shape[1] - 1)
        slots = torch.arange(B, device=x.device)
        phys = pages.table[slots, page].to(torch.int64) * P + pos % P
        rowk, rowv = k[:, 0], v[:, 0]                 # (B, KVh, dh)
        if pages.kv_bits is not None:
            rowk, rsk = kv_quant_encode(rowk, pages.kv_bits)
            rowv, rsv = kv_quant_encode(rowv, pages.kv_bits)
            ksc.view(n_rows, KVh)[phys] = rsk
            vsc.view(n_rows, KVh)[phys] = rsv
        ck.view(n_rows, *ck.shape[2:])[phys] = rowk.to(ck.dtype)
        cv.view(n_rows, *cv.shape[2:])[phys] = rowv.to(cv.dtype)
        out = Kops.paged_decode_attn_op(
            q.reshape(B, KVh, H // KVh, dh), ck, cv, pos, pages.table,
            page_size=P, seq_len=pages.seq_len, kv_bits=pages.kv_bits,
            k_scale=ksc, v_scale=vsc)
        out = out.reshape(B, 1, H, dh).to(x.dtype)
        new_cache = (ck, cv, pos + 1, ksc, vsc)
    elif cache is not None:
        ck, cv, pos = cache
        pos = torch.as_tensor(pos, dtype=torch.int64,
                              device=x.device).reshape(-1).expand(B)
        # an idle slot may sit past the arena's end: clamp its write the
        # way the JAX reference's dynamic_update_slice does
        rows = torch.clamp(pos, max=ck.shape[1] - 1)
        slots = torch.arange(B, device=x.device)
        ck[slots, rows] = k[:, 0].to(ck.dtype)
        cv[slots, rows] = v[:, 0].to(cv.dtype)
        out = Kops.decode_attn_op(q.reshape(B, KVh, H // KVh, dh), ck, cv,
                                  pos)
        out = out.reshape(B, 1, H, dh).to(x.dtype)
        new_cache = (ck, cv, pos + 1)
    else:
        out = attention(q, k, v, cfg, q_offset=q_offset)
    out = qa(out.reshape(B, S, H * dh), qp, f"{prefix}.attn_out.aq")
    return dense_proj(out, lp, qp, f"{prefix}.wo"), new_cache


# -------------------------------------------------------------------- mlp
def init_mlp(gen: torch.Generator, cfg: ModelConfig, prefix: str,
             n_layers: int, dtype) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    L = (n_layers,)
    return {f"{prefix}.w_gate": _normal(gen, L + (D, F), dtype, D ** -0.5),
            f"{prefix}.w_up": _normal(gen, L + (D, F), dtype, D ** -0.5),
            f"{prefix}.w_down": _normal(gen, L + (F, D), dtype, F ** -0.5)}


def mlp_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
              prefix: str) -> torch.Tensor:
    g = dense_proj(x, lp, qp, f"{prefix}.w_gate")
    u = dense_proj(x, lp, qp, f"{prefix}.w_up")
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    h = qa(h, qp, f"{prefix}.mlp_act.aq")
    return dense_proj(h, lp, qp, f"{prefix}.w_down")

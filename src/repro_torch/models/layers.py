"""Layers of the decoder LMs as plain functions over a flat param dict.

Port of the attention, MLP, MoE and recurrent (mamba, rwkv6) layers of
`repro.models.layers`. Conventions follow the
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
past `attn_block_threshold`; masked to the last `cfg.window` keys when
the config sets a sliding window), norms, rope and SiLU are plain
PyTorch, as they were plain XLA in the JAX package; so are the MoE's
router, dispatch and expert products (`moe_apply`), whose weights the LM
fake-quants once per call (their component is not routed), while the
shared expert is an MLP through `dense_proj`.

The recurrent mixers keep the reference's arithmetic: the WKV recurrence
(`_wkv_scan`) and mamba's selective scan (`_mamba_chunk_scan`) are plain
PyTorch, as they are plain XLA `lax.scan`s there (no Pallas kernel was
written for either), while every projection goes through `dense_proj`.
Both scans run per chunk of `chunk` tokens, each chunk under
`torch.utils.checkpoint` when a gradient is taken (the reference's
`jax.checkpoint`), so the backward keeps one state per chunk. Inside a
chunk the per-token transition terms are formed for the whole chunk at
once and only the state update runs token by token (one fused
multiply-add a token); mamba's in-chunk `associative_scan` becomes that
sequential recurrence, the same function rounded otherwise. A prompt
longer than a chunk must be a multiple of it (the reference's rule, which
it asserts): both scans raise `ValueError` naming S and the chunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import (PACKED_STORAGE_BITS, QuantParams,
                                    fake_quant, kv_quant_encode)
from repro_torch.distributed import collectives
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
    are never pruned; `n_experts` counts an MoE's surviving experts,
    `mamba_inner` mamba's inner channels, `rwkv_heads` the time-mix heads
    and `cm_hidden` the channel-mix hidden units."""
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    n_experts: int = 0
    mamba_inner: int = 0
    rwkv_heads: int = 0
    cm_hidden: int = 0

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "LayerShapes":
        return cls(d_model=cfg.d_model, n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                   d_ff=cfg.d_ff,
                   n_experts=cfg.moe.n_experts if cfg.moe else 0,
                   mamba_inner=(cfg.mamba.expand * cfg.d_model
                                if cfg.mamba else 0),
                   rwkv_heads=(cfg.d_model // cfg.rwkv.head_size
                               if cfg.rwkv else 0),
                   cm_hidden=cfg.d_ff)


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
    - dense weight, neither                  -> x @ w (torch.matmul; an
      f32 x on a bf16 weight multiplies in f32, as JAX promotes it)
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
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            return x.to(dt) @ w.to(dt)
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


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head groupnorm (RWKV's ln_x) over x (..., H*dh) in f32, with the
    biased variance `jnp.var` takes: the mean of the squared deviations."""
    shp = x.shape
    x32 = x.to(torch.float32).reshape(*shp[:-1], n_heads, -1)
    xc = x32 - torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(shp)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


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
def _causal_mask(sq: int, sk: int, q_off: int, window: int,
                 device=None) -> torch.Tensor:
    """(sq, sk) bool: query i (at absolute position i + q_off) sees key j
    when j <= i + q_off and, with a sliding window, j > i + q_off -
    window."""
    qi = torch.arange(sq, device=device)[:, None] + q_off
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m = m & (ki > qi - window)
    return m


def attention_dense(q, k, v, *, window: int = 0, q_offset: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """Full materialized attention, causal unless `causal=False` (the
    BERT encoder), within a sliding window of `window` keys when > 0.
    q: (B, Sq, H, dh); k/v: (B, Sk, KV, dh), GQA by reshape."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qh = q.reshape(B, Sq, KV, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(dh)
    if causal:
        mask = _causal_mask(Sq, k.shape[1], q_offset, window, q.device)
        scores = torch.where(mask[None, None, None], scores,
                             torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _attend_q_block(q_i: torch.Tensor, k_blocks: torch.Tensor,
                    v_blocks: torch.Tensor, window: int) -> torch.Tensor:
    """One query block of `attention_blockwise`: an online softmax over the
    KV blocks it attends to, the last of them the diagonal one. q_i:
    (B, blk, KV, g, dh); k/v_blocks: (B, n, blk, KV, dh). A block is
    masked where the causal rule or the window bites (the diagonal, and
    with a window the blocks it reaches into). Returns (B, blk, KV, g, dh)
    f32."""
    B, blk, KV, g, dh = q_i.shape
    qf = q_i.to(torch.float32)
    m = torch.full((B, KV, g, blk), -1e30, dtype=torch.float32,
                   device=q_i.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, g, blk, dh), dtype=torch.float32,
                      device=q_i.device)
    n = k_blocks.shape[1]
    for j in range(n):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf,
                         k_blocks[:, j].to(torch.float32)) / math.sqrt(dh)
        if j == n - 1 or window > 0:
            mask = _causal_mask(blk, blk, (n - 1 - j) * blk, window,
                                q_i.device)
            s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, v_blocks[:, j].to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4)


def first_kv_block(i: int, block: int, window: int) -> int:
    """The first KV block that query block i of `attention_blockwise`
    attends to: 0, or with a window the block holding the earliest key in
    the window of the block's first query (every block before it is
    masked for every query of block i)."""
    if window <= 0:
        return 0
    return max(0, (i * block - window + 1) // block)


def attention_blockwise(q, k, v, *, block: int = 1024,
                        window: int = 0) -> torch.Tensor:
    """Flash-style causal attention that never materializes S x S: a loop
    over query blocks, each an online softmax (running max, denominator
    and accumulator) over KV blocks, with `attention_dense`'s -1e30 mask
    (and its sliding window) and a max(l, 1e-30) guard. Shapes as
    `attention_dense`; S a multiple of `block`.

    The reference scans every KV block for every query block. Those after
    the query block are fully masked and leave (m, l, acc) as they were,
    so they are skipped here. So are those wholly before a window
    (`first_kv_block`): there every score of a row is -1e30, so the row
    keeps m = -1e30 and gathers l and acc from exp(0) = 1 weights, which
    the first block holding a key of the row's window multiplies by
    corr = exp(-1e30 - m) = 0; the result is bitwise the full scan's.
    With grad enabled each query block runs under
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
        j0 = first_kv_block(i, block, window)
        args = (qb[:, i], kb[:, j0:i + 1], vb[:, j0:i + 1], window)
        outs.append(checkpoint(_attend_q_block, *args, use_reentrant=False)
                    if remat else _attend_q_block(*args))
    return torch.stack(outs, dim=1).reshape(B, S, H, dh).to(q.dtype)


def attention(q, k, v, cfg: ModelConfig, *, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """Blockwise for a long self-attention (S > `attn_block_threshold`, a
    multiple of `attn_block_size`, Sq == Sk), dense otherwise: the
    reference's dispatch."""
    S = q.shape[1]
    if S > cfg.attn_block_threshold and S % cfg.attn_block_size == 0 \
            and q.shape[1] == k.shape[1]:
        return attention_blockwise(q, k, v, block=cfg.attn_block_size,
                                   window=window)
    return attention_dense(q, k, v, window=window, q_offset=q_offset)


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


def tp_row_proj(tp, h: torch.Tensor, h_split: bool, lp: dict,
                qp: Optional[dict], name: str) -> torch.Tensor:
    """h @ w for a weight that takes its input on the tensor-parallel
    axis (wo, w_down), on a rank holding `h` whole or as its column tile
    (`h_split`). A weight split on K multiplies this rank's K tile of h
    (for packed words, the rows its words cover, zero-padded past K) and
    the partial products are summed in rank order; a replicated weight
    multiplies the whole h."""
    key = tp.key(lp, name)
    if not tp.split(key, -2):
        return dense_proj(tp.gather(h) if h_split else h, lp, qp, name)
    rows = lp[key].shape[-2]
    cpw = (32 // int(key.rpartition(".packed")[2])
           if ".packed" in key else 1)
    if h_split and h.shape[-1] != rows * cpw:
        h, h_split = tp.gather(h), False
    if not h_split:
        h = tp.tile(h, rows * cpw)
    return tp.sum(dense_proj(h, lp, qp, name))


def tp_col_tile(tp, lp: dict, name: str, y: torch.Tensor) -> torch.Tensor:
    """This rank's column tile of y = x @ w for a weight whose columns lie
    on the tensor-parallel axis: y itself where w's columns are split, its
    tile where w is whole on every rank (a packed or coded width the
    ranks do not divide)."""
    return y if tp.split(tp.key(lp, name), -1) else tp.tile(y)


def _tp_heads(tp, lp: dict, prefix: str, q, k, v, H: int, KVh: int):
    """A rank's q, k, v and head counts under tensor parallelism. When
    the KV heads divide the ranks the arena holds this rank's KVh / tp
    heads (`kv_cache_specs`) and attention runs on its own q and KV
    heads, column tile `index` of each projection; otherwise the arena
    holds every KV head and q, k and v are gathered whole, so each rank
    attends over every head (its q head h needs KV head h // g, which a
    head split would put on another rank). Returns (q, k, v, H, KVh,
    whether the output is this rank's column tile)."""
    split = [tp.split(tp.key(lp, f"{prefix}.{w}"), -1)
             for w in ("wq", "wk", "wv")]
    n = tp.size
    if KVh % n == 0:
        q, k, v = (t if s else tp.tile(t) for t, s in zip((q, k, v), split))
        return q, k, v, H // n, KVh // n, True
    q, k, v = (tp.gather(t) if s else t for t, s in zip((q, k, v), split))
    return q, k, v, H, KVh, False


def attn_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
               rope: tuple, prefix: str, cache: Optional[tuple] = None,
               q_offset: int = 0, shapes: Optional[LayerShapes] = None,
               chunked: bool = False, pages: Optional[PagedView] = None,
               tp=None):
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
    of each slot, or row pos % ring of a sliding-window layer's ring of
    min(max_seq, window) rows, and the flash-decode kernel attends over
    the min(pos + 1, rows) rows written, which is the window once the ring
    has wrapped). The window is `cfg.window`: the full sequence masks
    keys outside it, the one-shot prefill needs the prompt to fit the
    ring, and the chunked scoring and the paged arena refuse it.
    cache is (k_cache, v_cache, pos) with k/v (B, S_max, KVh, dh) views of
    the stacked arena, or, paged, (k_pool, v_pool, pos, k_scale, v_scale)
    with (n_pages, P, KVh, dh*) pools and (n_pages, P, KVh) scales (None
    unless `pages.kv_bits` is set). Every cache branch writes the cache IN
    PLACE (advanced-index assignment into the view) and returns the same
    tensors. The chunked scoring is plain PyTorch, as the reference's is
    plain XLA. `tp` (a `distributed.sharding.TensorParallel`) runs the
    layer on a rank's shards: its heads (`_tp_heads`; the cache then holds
    the rank's KV heads, or all of them) and wo's K tile, whose partial
    products sum over the ranks (`tp_row_proj`). Returns (out,
    new_cache)."""
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
    if tp is not None:
        q, k, v, H, KVh, out_split = _tp_heads(tp, lp, prefix, q, k, v, H,
                                               KVh)
    q = apply_rope(q.reshape(B, S, H, dh), *rope)
    k = apply_rope(k.reshape(B, S, KVh, dh), *rope)
    v = v.reshape(B, S, KVh, dh)

    window = cfg.window
    new_cache = None
    if cache is not None and chunked:
        # full arenas only: a ring write would overwrite rows that a
        # rejected draft could never roll back
        if window > 0:
            raise ValueError(
                f"{prefix}: chunked cache scoring needs a full (non-ring) "
                f"arena; window={window} layers overwrite rows on wrap")
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
        # a ring wraps token by token; the one-shot write keeps positions
        # only while the prompt fits it (the reference asserts this)
        if window > 0 and S > ck.shape[1]:
            raise ValueError(
                f"{prefix}: a one-shot prefill of {S} tokens does not fit "
                f"the {ck.shape[1]}-row ring of window={window}")
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
        out = attention(q, k, v, cfg, window=window)
        new_cache = (ck, cv, pos + S)
    elif cache is not None and pages is not None:
        if window > 0:
            raise ValueError(
                f"{prefix}: the paged arena needs full (non-ring) caches; "
                f"window={window} layers ring-wrap rows")
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
        # a ring writes at pos % rows; in a full arena an idle slot may
        # sit past the end: clamp its write the way the JAX reference's
        # dynamic_update_slice does
        rows = (torch.remainder(pos, ck.shape[1]) if window > 0
                else torch.clamp(pos, max=ck.shape[1] - 1))
        slots = torch.arange(B, device=x.device)
        ck[slots, rows] = k[:, 0].to(ck.dtype)
        cv[slots, rows] = v[:, 0].to(cv.dtype)
        out = Kops.decode_attn_op(q.reshape(B, KVh, H // KVh, dh), ck, cv,
                                  pos)
        out = out.reshape(B, 1, H, dh).to(x.dtype)
        new_cache = (ck, cv, pos + 1)
    else:
        out = attention(q, k, v, cfg, window=window, q_offset=q_offset)
    out = qa(out.reshape(B, S, H * dh), qp, f"{prefix}.attn_out.aq")
    if tp is not None:
        return tp_row_proj(tp, out, out_split, lp, qp,
                           f"{prefix}.wo"), new_cache
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
              prefix: str, tp=None) -> torch.Tensor:
    """SwiGLU MLP; under `tp` on a rank's hidden tile (w_gate and w_up
    split on their columns) with w_down's partial products summed over
    the ranks (`tp_row_proj`)."""
    g = dense_proj(x, lp, qp, f"{prefix}.w_gate")
    u = dense_proj(x, lp, qp, f"{prefix}.w_up")
    split = False
    if tp is not None:
        gs, us = (tp.split(tp.key(lp, f"{prefix}.{w}"), -1)
                  for w in ("w_gate", "w_up"))
        if gs != us:
            g, u = (tp.gather(g) if gs else g), (tp.gather(u) if us else u)
        split = gs and us
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    h = qa(h, qp, f"{prefix}.mlp_act.aq")
    if tp is not None:
        return tp_row_proj(tp, h, split, lp, qp, f"{prefix}.w_down")
    return dense_proj(h, lp, qp, f"{prefix}.w_down")


# -------------------------------------------------------------------- moe
def init_moe(gen: torch.Generator, cfg: ModelConfig, prefix: str,
             n_layers: int, dtype) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    L = (n_layers,)
    p = {f"{prefix}.router": _normal(gen, L + (D, E), dtype, D ** -0.5),
         f"{prefix}.we_gate": _normal(gen, L + (E, D, F), dtype, D ** -0.5),
         f"{prefix}.we_up": _normal(gen, L + (E, D, F), dtype, D ** -0.5),
         f"{prefix}.we_down": _normal(gen, L + (E, F, D), dtype, F ** -0.5)}
    if cfg.moe.shared_expert:
        p.update(init_mlp(gen, cfg, f"{prefix}.shared", n_layers, dtype))
    return p


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: a comparison against an arange, so an index
    outside [0, n) (a token past its expert's capacity) gives a zero row
    where `F.one_hot` would raise, and no host sync enters a CUDA graph."""
    iota = torch.arange(n, dtype=idx.dtype, device=idx.device)
    return (idx[..., None] == iota).to(dtype)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values, and on a
    tie the lower index first (a stable descending sort), which
    `torch.topk` does not promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
              prefix: str, full_capacity: bool = False,
              shapes: Optional[LayerShapes] = None, tp=None) -> torch.Tensor:
    """Top-k token-choice MoE with GShard's grouped einsum dispatch, as the
    reference computes it: one group per sequence with per-group capacity
    C = max(int(cf * n * K / E), 4), or n * K with `full_capacity` (the
    serving semantics of prefill and the chunked verify: no token is
    dropped, as none is in one-token decode). f32 router softmax, top-k
    with the lower expert first on ties, gates renormalised over the k
    picks (floor 1e-9); each (token, k) takes its place in its expert's
    queue from a cumsum over the token-major (n, K) order, and a place at
    or past C drops it (zero gate, zero one-hot row). `dispatch` is built
    in x's dtype, `combine` in f32 and cast to x's dtype before the last
    product; SiLU runs in f32. The shared expert is an MLP through
    `dense_proj` (its sites fuse into the GEMM epilogue).

    Under `tp` with the expert stacks split on their expert axis (dim -3;
    expert parallelism) the router is whole on every rank (`sharding.
    serving_plan`), so every rank builds the same dispatch and combine,
    with C and the queue places of the whole layer; a rank runs only its
    E/tp experts' products (`collectives.moe_ep_slices`) and the combine,
    a product sharded on the expert axis, sums its partials in rank order
    (`tp.sum`). The shared expert takes the MLP's TP path."""
    B, S, D = x.shape
    shapes = shapes or LayerShapes.from_config(cfg)
    E, K = shapes.n_experts, cfg.moe.top_k
    if E < K:
        raise ValueError(f"{prefix}: {E} surviving experts < top_k={K} — "
                         f"the expert family was pruned below the router's "
                         f"top-k (keep at least top_k experts)")
    G, n = B, S
    xg = x.reshape(G, n, D)
    logits = (xg @ qw(lp, qp, f"{prefix}.router")).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (G, n, E)
    gate_vals, gate_idx = top_k(probs, K)                      # (G, n, K)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    C = n * K if full_capacity \
        else max(int(cfg.moe.capacity_factor * n * K / E), 4)

    onehot = one_hot(gate_idx, E, torch.float32)               # (G, n, K, E)
    # the place of each (token, k) in its expert's per-group queue
    flat = onehot.reshape(G, n * K, E)
    pos = torch.cumsum(flat, dim=1).reshape(G, n, K, E) - 1.0
    pos = torch.sum(pos * onehot, dim=-1)                      # (G, n, K)
    keep = (pos < C).to(torch.float32)
    gate_vals = gate_vals * keep

    posoh = one_hot(pos.to(torch.int32), C, x.dtype)           # (G, n, K, C)
    dispatch = torch.einsum("gnke,gnkc->gnec", onehot.to(x.dtype), posoh)
    combine = torch.einsum("gnke,gnkc,gnk->gnec", onehot,
                           posoh.to(torch.float32), gate_vals)

    we_gate, we_up, we_down = (qw(lp, qp, f"{prefix}.{w}")
                               for w in ("we_gate", "we_up", "we_down"))
    ep = tp is not None and tp.split(f"{prefix}.we_gate", -3)
    if ep:
        dispatch, combine = collectives.moe_ep_slices(
            dispatch, combine, we_gate.shape[0], tp.mesh, tp.axis)
    xe = torch.einsum("gnec,gnd->gecd", dispatch, xg)          # (G, E, C, D)
    g = torch.einsum("gecd,edf->gecf", xe, we_gate)
    u = torch.einsum("gecd,edf->gecf", xe, we_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    ye = torch.einsum("gecf,efd->gecd", h, we_down)
    y = torch.einsum("gnec,gecd->gnd", combine.to(x.dtype), ye)
    if ep:
        y = tp.sum(y)
    if cfg.moe.shared_expert:
        y = y + mlp_apply(lp, qp, cfg, x, prefix=f"{prefix}.shared", tp=tp)
    return y.reshape(B, S, D)


# ------------------------------------------------------------- recurrence
def scan_chunk(S: int, chunk: int) -> int:
    """The chunk a scan over S tokens runs with: min(chunk, S), which must
    divide S (the reference's rule). Raises ValueError otherwise."""
    C = min(chunk, S)
    if S < 1 or S % C:
        raise ValueError(
            f"a recurrent scan over S={S} tokens runs in chunks of "
            f"{chunk}: a sequence longer than one chunk must be a multiple "
            f"of it (S={S} is not)")
    return C


def _chunked_scan(step, h, seqs, C: int):
    """Run `step(h, *chunk_of_each_seq) -> (h, out)` over the chunks of
    `seqs` (each (S, ...) time-major), under a non-reentrant checkpoint per
    chunk when a gradient is taken. Returns (h, outs concatenated)."""
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (h, *seqs))
    outs = []
    for c in range(0, seqs[0].shape[0], C):
        args = (h, *(t[c:c + C] for t in seqs))
        h, out = (checkpoint(step, *args, use_reentrant=False) if remat
                  else step(*args))
        outs.append(out)
    return h, outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _stacked(ts: list) -> torch.Tensor:
    """torch.stack(ts), a view when there is one (a decode step's)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xs[t] = x[t-1]; xs[0] = last (or 0)."""
    B, S, D = x.shape
    head = (torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
            if last is None else last[:, None].to(x.dtype))
    if S == 1:
        return head
    return torch.cat([head, x[:, :-1]], dim=1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ------------------------------------------------------------------ mamba
def init_mamba(gen: torch.Generator, cfg: ModelConfig, prefix: str,
               n_layers: int, dtype) -> dict:
    """The reference's mamba params with `in_proj` split into
    `in_proj_x` / `in_proj_z` (as `LM.init` splits it there)."""
    D, mc = cfg.d_model, cfg.mamba
    Di, N = mc.expand * D, mc.d_state
    dtr = mc.dt_rank or D // 16
    L = (n_layers,)
    dev = gen.device
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev))
    return {
        f"{prefix}.in_proj_x": _normal(gen, L + (D, Di), dtype, D ** -0.5),
        f"{prefix}.in_proj_z": _normal(gen, L + (D, Di), dtype, D ** -0.5),
        f"{prefix}.conv_w": _normal(gen, L + (mc.d_conv, Di), dtype, 0.1),
        f"{prefix}.x_proj": _normal(gen, L + (Di, dtr + 2 * N), dtype,
                                    Di ** -0.5),
        f"{prefix}.dt_proj": _normal(gen, L + (dtr, Di), dtype, dtr ** -0.5),
        f"{prefix}.dt_bias": torch.zeros(L + (Di,), dtype=dtype, device=dev),
        f"{prefix}.A_log": a_log.expand(L + (Di, N)).contiguous(),
        f"{prefix}.D": torch.ones(L + (Di,), dtype=torch.float32, device=dev),
        f"{prefix}.out_proj": _normal(gen, L + (Di, D), dtype, Di ** -0.5)}


def _mamba_chunk_scan(xc, dt, Bc, Cc, A, D_vec, h0, chunk: int = 64):
    """Chunked diagonal selective scan:
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ; y_t = <h_t, C_t>
    + D * x_t. xc (B, S, Di) activations; dt (B, S, Di) f32; Bc / Cc
    (B, S, N); A (Di, N) f32; D_vec (Di,) f32; h0 (B, Di, N) f32. The
    (B, C, Di, N) transition terms are formed per chunk only. Returns
    (y (B, S, Di) f32, h_last)."""
    B, S, Di = xc.shape
    C = scan_chunk(S, chunk)
    f32 = torch.float32

    def chunk_step(h, xcc, dtc, bcc, ccc):       # (C, B, ...) each
        x32 = xcc.to(f32)
        dA = torch.exp(dtc[..., None] * A)                  # (C, B, Di, N)
        dBx = (dtc * x32)[..., None] * bcc.to(f32)[:, :, None, :]
        hs = []
        for a_t, b_t in zip(dA.unbind(0), dBx.unbind(0)):
            h = torch.addcmul(b_t, a_t, h)
            hs.append(h)
        y = torch.einsum("cbdn,cbn->cbd", _stacked(hs), ccc.to(f32))
        return h, y + D_vec * x32

    h_last, ys = _chunked_scan(
        chunk_step, h0, [t.transpose(0, 1) for t in (xc, dt, Bc, Cc)], C)
    return ys.transpose(0, 1), h_last


def mamba_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
                prefix: str, state: Optional[tuple] = None,
                shapes: Optional[LayerShapes] = None, tp=None):
    """Selective SSM block; state = (h (B, Di, N) f32, conv (B, K-1, Di))
    for decode, None for a full sequence from zero state. Di comes from
    `shapes`. The depthwise conv sums its K taps in f32 term by term, in
    the reference's order. Returns (out, new_state).

    Under `tp` with the inner channels split (`mamba_inner`; conv_w's
    columns tell) a rank runs on its Di/tp channels: column tiles of
    in_proj_x, in_proj_z and dt_proj, its own conv_w, A_log, D, dt_bias
    and scan, and state leaves of its channels (`kv_cache_specs`).
    x_proj takes K on the inner axis, so (dt_low, B, C) are partial sums,
    summed in rank order: every rank scans with the same B and C.
    out_proj sums its K tiles the same way (`tp_row_proj`); the
    `mamba_out` site is elementwise with scalar (d, q_m, t)."""
    B, S, D = x.shape
    mc = cfg.mamba
    shapes = shapes or LayerShapes.from_config(cfg)
    Di, N, Kc = shapes.mamba_inner, mc.d_state, mc.d_conv
    f32 = torch.float32
    local = tp is not None and tp.split(f"{prefix}.conv_w", -1)
    xi = dense_proj(x, lp, qp, f"{prefix}.in_proj_x")      # (B, S, Di)
    z = dense_proj(x, lp, qp, f"{prefix}.in_proj_z")
    if local:
        xi = tp_col_tile(tp, lp, f"{prefix}.in_proj_x", xi)
        z = tp_col_tile(tp, lp, f"{prefix}.in_proj_z", z)
        Di = xi.shape[-1]
    conv_w = lp[f"{prefix}.conv_w"].to(f32)                  # (K, Di)
    if state is None:
        pad = torch.zeros((B, Kc - 1, Di), dtype=xi.dtype, device=x.device)
        xpad = torch.cat([pad, xi], dim=1)
        new_conv = xpad[:, -(Kc - 1):] if Kc > 1 else pad
    else:
        conv_prev = state[1]
        xpad = torch.cat([conv_prev.to(xi.dtype), xi], dim=1)
        new_conv = xpad[:, -(Kc - 1):] if Kc > 1 else conv_prev
    xc = sum(xpad[:, i:i + S].to(f32) * conv_w[i] for i in range(Kc))
    xc = F.silu(xc).to(x.dtype)
    proj = (tp_row_proj(tp, xc, local, lp, qp, f"{prefix}.x_proj")
            if tp is not None else dense_proj(xc, lp, qp, f"{prefix}.x_proj"))
    dtr = mc.dt_rank or D // 16
    dt_low, Bc, Cc = torch.split(proj, [dtr, N, N], dim=-1)
    dt = dense_proj(dt_low, lp, qp, f"{prefix}.dt_proj")
    if local:
        dt = tp_col_tile(tp, lp, f"{prefix}.dt_proj", dt)
    dt = _softplus(dt.to(f32) + lp[f"{prefix}.dt_bias"].to(f32))  # (B,S,Di)
    A = -torch.exp(lp[f"{prefix}.A_log"].to(f32))            # (Di, N)
    h0 = (torch.zeros((B, Di, N), dtype=f32, device=x.device)
          if state is None else state[0])
    y, h_last = _mamba_chunk_scan(xc, dt, Bc, Cc, A,
                                  lp[f"{prefix}.D"].to(f32), h0,
                                  chunk=mc.chunk)
    y = (y * F.silu(z.to(f32))).to(x.dtype)
    y = qa(y, qp, f"{prefix}.mamba_out.aq")
    if tp is not None:
        return (tp_row_proj(tp, y, local, lp, qp, f"{prefix}.out_proj"),
                (h_last, new_conv))
    out = dense_proj(y, lp, qp, f"{prefix}.out_proj")
    return out, (h_last, new_conv)


# ------------------------------------------------------------------ rwkv6
def init_rwkv(gen: torch.Generator, cfg: ModelConfig, prefix: str,
              n_layers: int, dtype) -> dict:
    """RWKV6 time-mix and channel-mix params under one prefix, as the
    reference's `init_rwkv` keys them."""
    D, Fh = cfg.d_model, cfg.d_ff
    R = cfg.rwkv.decay_lora
    L = (n_layers,)
    dev = gen.device
    std = D ** -0.5

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

    def full(value):
        return torch.full(L + (D,), value, dtype=torch.float32, device=dev)

    return {
        f"{prefix}.mu": uniform(L + (5, D)),
        f"{prefix}.wr": _normal(gen, L + (D, D), dtype, std),
        f"{prefix}.wk": _normal(gen, L + (D, D), dtype, std),
        f"{prefix}.wv": _normal(gen, L + (D, D), dtype, std),
        f"{prefix}.wg": _normal(gen, L + (D, D), dtype, std),
        f"{prefix}.wo": _normal(gen, L + (D, D), dtype, std),
        f"{prefix}.decay_w1": _normal(gen, L + (D, R), dtype, std),
        f"{prefix}.decay_w2": _normal(gen, L + (R, D), dtype, R ** -0.5),
        f"{prefix}.decay_w0": full(-1.0),
        f"{prefix}.u": full(0.0),
        f"{prefix}.lnx_scale": full(1.0),
        f"{prefix}.lnx_bias": full(0.0),
        f"{prefix}.cm_mu": uniform(L + (2, D)),
        f"{prefix}.cm_k": _normal(gen, L + (D, Fh), dtype, std),
        f"{prefix}.cm_v": _normal(gen, L + (Fh, D), dtype, Fh ** -0.5),
        f"{prefix}.cm_r": _normal(gen, L + (D, D), dtype, std)}


def _mixes(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor
           ) -> torch.Tensor:
    """RWKV's token-shift mixes, all rows of mu (n, D) at once: (x32 +
    (xs - x) * mu[i]) in f32, cast to x's dtype; (n, B, S, D). The same
    products and sums as one mix at a time, in fewer kernels."""
    f32 = torch.float32
    dx = (xs - x).to(f32)
    return (x.to(f32) + dx * mu.to(f32)[:, None, None, :]).to(x.dtype)


def _wkv_scan(r, k, v, w, u, s0, chunk: int = 64):
    """The WKV recurrence, chunked: y_t = r_t @ (S_t + u * k_t^T v_t);
    S_{t+1} = diag(w_t) S_t + k_t^T v_t. r, k, v, w (B, S, H, dh); u
    (H, dh); s0 (B, H, dh, dh) f32. Returns (y (B, S, H, dh) f32, s_last)."""
    C = scan_chunk(r.shape[1], chunk)
    uu = u[None, None, :, :, None]

    def chunk_fn(s, rc, kc, vc, wc):             # (C, B, H, dh) each
        kv = kc[..., :, None] * vc[..., None, :]            # (C,B,H,dh,dh)
        states = []
        for w_t, kv_t in zip(wc.unbind(0), kv.unbind(0)):
            states.append(s)
            s = torch.addcmul(kv_t, w_t[..., None], s)
        y = torch.einsum("cbhk,cbhkv->cbhv", rc,
                         _stacked(states) + uu * kv)
        return s, y

    s_last, ys = _chunked_scan(
        chunk_fn, s0,
        [t.transpose(0, 1).to(torch.float32) for t in (r, k, v, w)], C)
    return ys.transpose(0, 1), s_last


def rwkv_timemix_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
                       prefix: str, state: Optional[tuple] = None,
                       shapes: Optional[LayerShapes] = None, tp=None):
    """RWKV6 (Finch) time-mix with data-dependent decay. state =
    (shift_last (B, D) f32, wkv (B, H, dh, dh) f32), None for a full
    sequence from zero state; H is the projections' width over the head
    size (`shapes.rwkv_heads`, or a rank's share). The mixes, the decay
    chain and the gate run in f32, each mix cast to x's dtype before its
    projection. Returns (out, new_state).

    Under `tp` with the heads split (`rwkv_heads`; u's columns tell) a
    rank runs on its H/tp heads: head tiles of wr, wk, wv, wg and
    decay_w2, its own decay_w0, u and lnx_* (the group norm is per head),
    the WKV scan over its heads with a wkv state of its heads; the token
    shift stays whole. wo sums its K tiles in rank order
    (`tp_row_proj`)."""
    B, S, D = x.shape
    rc = cfg.rwkv
    dh = rc.head_size
    f32 = torch.float32
    local = tp is not None and tp.split(f"{prefix}.u", -1)
    xs = _token_shift(x, state[0] if state is not None else None)
    mixed = _mixes(x, xs, lp[f"{prefix}.mu"])                # (5, B, S, D)

    def proj(i: int, w: str) -> torch.Tensor:
        y = dense_proj(mixed[i], lp, qp, f"{prefix}.{w}")
        return tp_col_tile(tp, lp, f"{prefix}.{w}", y) if local else y

    r, k, v, g = (proj(i, w) for i, w in enumerate(("wr", "wk", "wv", "wg")))
    H = r.shape[-1] // dh        # `shapes.rwkv_heads`, or a rank's share
    r, k, v = (t.reshape(B, S, H, dh) for t in (r, k, v))
    g = F.silu(g.to(f32))
    dd = torch.tanh(dense_proj(mixed[4], lp, qp, f"{prefix}.decay_w1")
                    .to(f32))
    dd = dense_proj(dd, lp, qp, f"{prefix}.decay_w2")
    if local:
        dd = tp_col_tile(tp, lp, f"{prefix}.decay_w2", dd)
    dd = dd.to(f32)
    logw = -torch.exp(torch.clamp(
        lp[f"{prefix}.decay_w0"].to(f32) + dd, -8.0, 4.0))
    w = torch.exp(logw).reshape(B, S, H, dh)
    u = lp[f"{prefix}.u"].to(f32).reshape(H, dh)
    s0 = (torch.zeros((B, H, dh, dh), dtype=f32, device=x.device)
          if state is None else state[1])
    y, s_last = _wkv_scan(r, k, v, w, u, s0, chunk=rc.chunk)
    y = groupnorm_heads(y.reshape(B, S, H * dh).to(x.dtype),
                        lp[f"{prefix}.lnx_scale"], lp[f"{prefix}.lnx_bias"],
                        H, cfg.norm_eps)
    y = (y.to(f32) * g).to(x.dtype)
    y = qa(y, qp, f"{prefix}.tm_out.aq")
    if tp is not None:
        out = tp_row_proj(tp, y, local, lp, qp, f"{prefix}.wo")
    else:
        out = dense_proj(y, lp, qp, f"{prefix}.wo")
    return out, (x[:, -1].to(f32), s_last)


def rwkv_chanmix_apply(lp: dict, qp: Optional[dict], cfg: ModelConfig, x, *,
                       prefix: str, state: Optional[torch.Tensor] = None,
                       tp=None):
    """RWKV channel-mix FFN; state = shift_last (B, D) f32. Returns
    (out, new_state). Under `tp` a rank runs its tile of cm_k's hidden
    units (`rwkv_ffn`) and cm_v sums its K tiles in rank order
    (`tp_row_proj`); cm_r's columns lie on `rwkv_heads`, but sigmoid(r)
    multiplies the whole output, so r's tiles are gathered whole."""
    f32 = torch.float32
    xk, xr = _mixes(x, _token_shift(x, state), lp[f"{prefix}.cm_mu"])
    k = torch.square(torch.relu(dense_proj(xk, lp, qp, f"{prefix}.cm_k")
                                .to(f32))).to(x.dtype)
    k = qa(k, qp, f"{prefix}.cm_act.aq")
    r = dense_proj(xr, lp, qp, f"{prefix}.cm_r")
    if tp is None:
        val = dense_proj(k, lp, qp, f"{prefix}.cm_v")
    else:
        val = tp_row_proj(tp, k, tp.split(tp.key(lp, f"{prefix}.cm_k"), -1),
                          lp, qp, f"{prefix}.cm_v")
        if tp.split(tp.key(lp, f"{prefix}.cm_r"), -1):
            r = tp.gather(r)
    r = torch.sigmoid(r.to(f32))
    return (val.to(f32) * r).to(x.dtype), x[:, -1].to(f32)

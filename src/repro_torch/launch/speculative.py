"""Self-speculative decoding from nested GETA subnets: port of
`repro.launch.speculative`.

A GETA run leaves a family of compression points of one model with
shared quantizer scales (`core.subnet.prepare_serving` resolves the
quantizers before slicing). The pruned, packed subnet drafts k tokens
through the small-M GEMM and flash-decode kernels, the target scores all
k+1 positions in one chunked pass (`LM.verify_chunk`), and a leading-match
rule commits the target's argmaxes. The committed tokens are always the
target's, so a weak draft costs speed, never tokens.

Draft and target each own a KV arena shaped by their own widths and share
slot indices and positions. A round writes rows [pos, pos + k] in both;
`rollback_rows` zeroes every row past the accepted prefix in both, which
restores the state of an engine that never drafted: rows past the
written prefix are zero in a full (window == 0) arena, admission writes
whole zeroed rows, and the decode mask never reads past pos.

Every step of a round is a device operation on device tensors (no host
read), so the engine captures one round per draft length k in a CUDA
graph (`Engine.warmup`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.core.subnet import prepare_serving, resolve_keep_masks
from repro_torch.models.transformer import LM


@dataclasses.dataclass
class DraftModel:
    """A servable draft subnet: its own (sliced) LM and the resolved
    (params, qparams) pair. The engine keeps a second KV arena shaped by
    `lm`'s widths for it."""
    lm: LM
    params: dict
    qparams: Optional[dict]
    meta: dict


def build_draft(arch: str, smoke: bool = True,
                checkpoint: Optional[dict] = None, *, sparsity: float = 0.5,
                bits: float = 2.0, packed: bool = True, seed: int = 0,
                device=None) -> DraftModel:
    """The draft subnet of the target's checkpoint params: the same params
    the target serves from (before its `prepare_serving`), sliced at
    magnitude masks of `sparsity` (0 keeps every unit) and packed at
    `bits`. Without `checkpoint`, the params come from `LM.init` with the
    torch generator on `device` (default CPU) seeded by `seed`."""
    lm = LM(get_arch(arch, smoke=smoke))
    if checkpoint is None:
        dev = torch.device("cpu" if device is None else device)
        checkpoint = lm.init(torch.Generator(device=dev).manual_seed(seed))
    params, qparams, meta = prepare_serving(
        lm, checkpoint, compressed=True, packed=packed, bits_init=bits,
        prune_sparsity=(sparsity if sparsity > 0 else None))
    meta.setdefault("sparsity", 0.0)
    meta["draft_bits"] = bits
    return DraftModel(lm=lm, params=params, qparams=qparams, meta=meta)


def pow2_floor(k: int) -> int:
    """Largest power of two <= k (0 for k < 1): the draft-length quantizer
    that keeps the engine's set of captured rounds bounded."""
    k = int(k)
    return 0 if k < 1 else 1 << (k.bit_length() - 1)


def reachable_spec_ks(draft_k: int, max_seq: int) -> set[int]:
    """Every draft length `Engine._spec_round` can run: pow2_floor(min(
    draft_k, remaining - 1)) over every remaining budget in [1, max_seq].
    Enumerated on purpose, independent of `Engine._spec_ks`, which it is
    held against."""
    return {pow2_floor(min(int(draft_k), rem - 1))
            for rem in range(1, int(max_seq) + 1)}


def rollback_rows(caches: dict, lo, hi) -> dict:
    """Zero arena rows s in [lo[b], hi[b]] of every slot b, IN PLACE, and
    return `caches`. Leaves are (n_blocks, slots, S, ...): axis 1 the slot,
    axis 2 the row. lo and hi are (slots,) ints or tensors."""
    for c in caches.values():
        lo_ = torch.as_tensor(lo, dtype=torch.int64,
                              device=c.device).reshape(-1)
        hi_ = torch.as_tensor(hi, dtype=torch.int64,
                              device=c.device).reshape(-1)
        s = torch.arange(c.shape[2], device=c.device)
        stale = (s[None, :] >= lo_[:, None]) & (s[None, :] <= hi_[:, None])
        c.masked_fill_(stale.reshape((1,) + stale.shape
                                     + (1,) * (c.ndim - 3)), 0)
    return caches


def make_spec_step(target_lm: LM, draft_lm: LM):
    """The speculative round over contiguous arenas: k+1 draft decode
    steps (the last writes the k-th proposal's own K/V row, needed when
    every proposal is accepted; its token is dropped), one chunked target
    verify over (last committed token, d_1..d_k), leading-match acceptance
    by a cumulative product, and the rollback of the rows past the
    accepted prefix in both arenas. The arenas are written in place.

    Returns (target argmaxes (B, k+1), n_commit (B,) in [1, k+1], target
    caches, draft caches). k = 0 is a plain one-token verify whose draft
    still steps once, keeping the draft arena in step."""

    def spec_step(tparams, tqparams, dparams, dqparams, tcaches, dcaches,
                  tok, pos, k):
        t, p, drafted = tok, pos, []
        for _ in range(k + 1):
            logits, _ = draft_lm.decode_step(dparams, dqparams, dcaches, t, p)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            drafted.append(nxt)
            t, p = nxt[:, None], p + 1
        proposals = torch.stack(drafted, dim=1)[:, :k]          # (B, k)
        chunk = torch.cat([tok, proposals], dim=1)              # (B, k+1)
        logits, _ = target_lm.verify_chunk(tparams, tqparams, tcaches,
                                           chunk, pos)
        tgt = torch.argmax(logits, dim=-1)                      # (B, k+1)
        acc = torch.cumprod((proposals == tgt[:, :k]).to(torch.int64), dim=1)
        n_commit = 1 + torch.sum(acc, dim=1)
        rollback_rows(tcaches, pos + n_commit, pos + k)
        rollback_rows(dcaches, pos + n_commit, pos + k)
        return tgt, n_commit, tcaches, dcaches

    return spec_step


def build_checkpoint_engines(arch: str, smoke: bool = True, *,
                             sparsity: float = 0.5, draft_bits: float = 8.0,
                             draft_k: int = 4, max_slots: int = 4,
                             max_seq: int = 64, seed: int = 0,
                             compressed: bool = False, device=None,
                             **engine_kw):
    """A target and draft as a trained GETA checkpoint would serve them:
    the magnitude keep-masks at `sparsity` applied to the init params (the
    exact zeros QASSO's cool-down leaves), the target serving that
    checkpoint dense with fake-quant at 8 bits (or, `compressed`, as int8
    codes), the draft its sliced packed subnet at `draft_bits`. Returns
    (speculative engine, plain engine on the same target arrays, lm); on
    `device` (CUDA by default), `engine_kw` to both engines (the paged
    arena's keywords)."""
    from repro_torch.launch.engine import Engine, resolve_device
    dev = resolve_device(device)
    lm = LM(get_arch(arch, smoke=smoke))
    params = lm.init(torch.Generator(device=dev).manual_seed(seed))
    qadg, masks = resolve_keep_masks(lm, params, sparsity)
    ckpt = qadg.space.apply_masks(params, masks)
    draft = build_draft(arch, smoke, ckpt, sparsity=sparsity,
                        bits=draft_bits)
    tparams, tqparams, _ = prepare_serving(lm, ckpt, compressed=compressed)
    kw = dict(max_slots=max_slots, max_seq=max_seq, **engine_kw)
    spec = Engine(lm, tparams, tqparams, draft=draft, draft_k=draft_k, **kw)
    base = Engine(lm, tparams, tqparams, **kw)
    return spec, base, lm

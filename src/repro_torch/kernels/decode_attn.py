"""Single-query flash-decode attention over the contiguous slot KV arena.

Port of `repro.kernels.decode_attn` (the contiguous kernel; the paged one
comes with the paged arena). `decode_attn` decides by device: a CPU
tensor goes to the plain PyTorch version (`ref.decode_attn_ref`); a CUDA
tensor goes to the hand-written kernel in `csrc/decode_attn.cu`, or
raises if the library did not build or the launch failed.

`decode_attn.launches` counts kernel launches; only the CUDA path adds to
it, once per launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref

G_MAX = 8       # query heads per KV head the kernel takes
DH_MAX = 128    # head width the kernel takes


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Attention of one query token per slot over its arena rows.

    q: (B, KVh, g, dh), the token's query heads grouped per KV head.
    k, v: (B, S, KVh, dh) arena rows with the current token written; any
    strides with a unit last stride (a per-layer view of the stacked
    cache is read in place). pos: (B,) int positions; row b attends over
    its min(pos[b] + 1, S) written rows. Returns (B, KVh, g, dh) f32."""
    B, KVh, g, dh = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, KVh, dh) or k.shape != v.shape:
        raise ValueError(f"decode_attn: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return ref.decode_attn_ref(q, k, v, pos)
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError("decode_attn: the kernel takes CUDA tensors on one "
                         "device")
    if k.dtype != v.dtype or k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attn: k/v dtypes {k.dtype}/{v.dtype}")
    if g > G_MAX or dh > DH_MAX or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"decode_attn: the kernel takes g <= {G_MAX}, "
                         f"dh <= {DH_MAX} and unit-stride rows (g={g}, "
                         f"dh={dh})")
    q32 = q.to(torch.float32).contiguous()
    pos32 = pos.to(device=q.device, dtype=torch.int32).reshape(B).contiguous()
    out = torch.empty((B, KVh, g, dh), dtype=torch.float32, device=q.device)
    lib = build.load()
    err = lib.repro_decode_attn(
        q32.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if k.dtype == torch.float32 else 1, pos32.data_ptr(),
        out.data_ptr(), B, S, KVh, g, dh,
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"decode_attn (B={B}, S={S}, KVh={KVh}, g={g})")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0


def bytes_moved(q: torch.Tensor, k: torch.Tensor, pos) -> int:
    """Bytes one call must move at least: q and pos once, the valid K and
    V rows once each, and the f32 output once."""
    B, KVh, g, dh = q.shape
    S = k.shape[1]
    rows = int(torch.clamp(pos.to(torch.int64) + 1, max=S).sum())
    return (q.numel() * q.element_size() + B * 4
            + 2 * rows * KVh * dh * k.element_size() + B * KVh * g * dh * 4)


def flops(q: torch.Tensor, k: torch.Tensor, pos) -> int:
    """q.k and p.v over the valid rows: 4 * rows * KVh * g * dh."""
    B, KVh, g, dh = q.shape
    rows = int(torch.clamp(pos.to(torch.int64) + 1, max=k.shape[1]).sum())
    return 4 * rows * KVh * g * dh

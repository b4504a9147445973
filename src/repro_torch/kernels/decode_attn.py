"""Single-query flash-decode attention over the contiguous slot KV arena
and over the paged KV pool.

Port of `repro.kernels.decode_attn`. `decode_attn` and
`paged_decode_attn` decide by device: a CPU tensor goes to the plain
PyTorch version (`ref.decode_attn_ref`, `ref.paged_decode_attn_ref`); a
CUDA tensor goes to the hand-written kernel in `csrc/decode_attn.cu`
(one split-rows kernel body with two row-addressing policies, then a
combine pass), or raises if the library did not build or the launch
failed; a meta tensor records the launch and computes nothing
(`kernels.meta`: every arena row counts, since meta holds no positions).
Both wrappers take their split plan from `plan_splits`, sized from the
arena length the host knows, never from `pos`.

`decode_attn.launches` counts calls that launched the kernel pair (one
per layer per decode step), and `paged_decode_attn.launches` counts them
by page storage (f32, bf16, int8, int4); only the CUDA path adds to them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, meta, ref

G_MAX = 8       # query heads per KV head the kernel takes
DH_MAX = 128    # head width the kernel takes (a multiple of 4)
ROWS_PER_SPLIT = 64    # arena rows one block of the kernel attends over
R_MAX = 128


def plan_splits(S: int, rows_per_split: int = ROWS_PER_SPLIT
                ) -> tuple[int, int]:
    """The kernel's split plan over an arena of S rows: (n_splits, R).

    Split c covers rows [c * R, min((c + 1) * R, n_valid)) and does no
    work when c * R >= n_valid, so the splits that hold rows are
    0 .. ceil(n_valid / R) - 1 and cover [0, n_valid) once. The plan
    depends only on S and R, which is what keeps the paged kernel bitwise
    the contiguous one when seq_len == S."""
    R = int(rows_per_split)
    if not 1 <= R <= R_MAX or S < 1:
        raise ValueError(f"plan_splits: S={S}, rows_per_split={R} (the "
                         f"kernel takes 1..{R_MAX})")
    return -(-int(S) // R), R


def _kernel_inputs(name, q, pos, B, g, dh):
    """q and pos as the kernel reads them: q bf16 or f32 contiguous, pos
    int32 or int64 on q's device with any stride; no copy when the caller
    hands them so. Raises on what the kernel does not take."""
    if g > G_MAX or dh > DH_MAX or dh % 4:
        raise ValueError(f"{name}: the kernel takes g <= {G_MAX} and dh <= "
                         f"{DH_MAX} a multiple of 4 (g={g}, dh={dh})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.to(torch.float32)
    pos = pos.reshape(B)
    if pos.device != q.device or pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(device=q.device, dtype=torch.int64)
    return q.contiguous(), pos


def _workspace(B, KVh, g, dh, n_splits, device):
    """One allocation: the (B, KVh, g, dh) f32 output, then the per-split
    partials (B, KVh, n_splits, g, dh + 2) the combine pass reads."""
    n_out = B * KVh * g * dh
    ws = torch.empty(n_out + B * KVh * n_splits * g * (dh + 2),
                     dtype=torch.float32, device=device)
    return ws[:n_out].view(B, KVh, g, dh), ws[n_out:]


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor, *, rows_per_split: int = ROWS_PER_SPLIT
                ) -> torch.Tensor:
    """Attention of one query token per slot over its arena rows.

    q: (B, KVh, g, dh), the token's query heads grouped per KV head.
    k, v: (B, S, KVh, dh) arena rows with the current token written; any
    strides with a unit last stride (a per-layer view of the stacked
    cache is read in place). pos: (B,) int positions; row b attends over
    its min(pos[b] + 1, S) written rows. rows_per_split: the kernel's R
    (`plan_splits`). Returns (B, KVh, g, dh) f32."""
    B, KVh, g, dh = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, KVh, dh) or k.shape != v.shape:
        raise ValueError(f"decode_attn: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    n_splits, R = plan_splits(S, rows_per_split)
    if q.device.type == "cpu":
        return ref.decode_attn_ref(q, k, v, pos)
    if q.device.type == "meta":
        full = torch.full((B,), S - 1, dtype=torch.int64)
        meta.record("decode_attn", "", "", (B, S, KVh, g, dh),
                    bytes_moved(q, k, full), flops(q, k, full))
        return torch.empty((B, KVh, g, dh), dtype=torch.float32,
                           device="meta")
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError("decode_attn: the kernel takes CUDA tensors on one "
                         "device")
    if k.dtype != v.dtype or k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attn: k/v dtypes {k.dtype}/{v.dtype}")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode_attn: the kernel takes unit-stride rows")
    q, pos = _kernel_inputs("decode_attn", q, pos, B, g, dh)
    out, part = _workspace(B, KVh, g, dh, n_splits, q.device)
    lib = build.load()
    err = lib.repro_decode_attn(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
        v.data_ptr(), 0 if k.dtype == torch.float32 else 1, pos.data_ptr(),
        int(pos.dtype == torch.int64), pos.stride(0), out.data_ptr(),
        part.data_ptr(), B, S, KVh, g, dh,
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), R, n_splits,
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"decode_attn (B={B}, S={S}, KVh={KVh}, g={g}, R={R})")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0


def tp_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor, *, mesh, axis: str = "model"
                   ) -> torch.Tensor:
    """KV-head-parallel `decode_attn` over the ranks of `mesh`'s `axis`:
    a rank takes its KVh / tp KV heads of k and v (read in place) and
    their query heads of q, runs the kernel on them and the heads are
    gathered, so every rank returns the full (B, KVh, g, dh). Softmax
    normalizes within a head, so each head carries the 1-rank call's
    bits. Raises unless the axis size divides KVh (a rank's q head h
    reads KV head h // g, which a finer split would put elsewhere)."""
    tp = int(mesh.shape[axis])
    KVh = q.shape[1]
    if KVh % tp:
        raise ValueError(f"tp_decode_attn: KVh={KVh} must divide the "
                         f"{axis!r} axis size {tp}")
    n = KVh // tp
    lo = mesh.index(axis) * n
    out = decode_attn(q[:, lo:lo + n], k[:, :, lo:lo + n],
                      v[:, :, lo:lo + n], pos)
    return torch.cat(mesh.all_gather(out, axis), dim=1)


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


# page storage -> the launcher's `kind`
PAGE_KINDS = {"f32": 0, "bf16": 1, "int8": 2, "int4": 3}
_DENSE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def paged_decode_attn(q: torch.Tensor, kpool: torch.Tensor,
                      vpool: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, *, page_size: int,
                      seq_len: int, kv_bits: Optional[int] = None,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      rows_per_split: int = ROWS_PER_SPLIT) -> torch.Tensor:
    """Attention of one query token per slot over its pages.

    q: (B, KVh, g, dh). kpool/vpool: (n_pages, page_size, KVh, dh) f32 or
    bf16 pages, or int8 codes of width dh (kv_bits 8) or dh // 2
    (kv_bits 4, low nibble first) with f32 per-row scales k_scale/v_scale
    (n_pages, page_size, KVh). page_table: (B, Lp) int logical -> physical
    page per slot, Lp * page_size >= seq_len; the kernel trusts every entry
    to be < n_pages. pos: (B,) int; row b attends over its
    min(pos[b] + 1, seq_len) rows. rows_per_split: the kernel's R, planned
    over seq_len as the contiguous kernel plans over S. Returns
    (B, KVh, g, dh) f32."""
    B, KVh, g, dh = q.shape
    P = int(page_size)
    if kv_bits not in (None, 4, 8):
        raise ValueError(f"paged_decode_attn: kv_bits {kv_bits}")
    dhs = dh // 2 if kv_bits == 4 else dh
    shape = (kpool.shape[0], P, KVh, dhs)
    if (tuple(kpool.shape) != shape or tuple(vpool.shape) != shape
            or page_table.ndim != 2 or page_table.shape[0] != B
            or page_table.shape[1] * P < seq_len):
        raise ValueError(
            f"paged_decode_attn: q {tuple(q.shape)}, pools "
            f"{tuple(kpool.shape)}/{tuple(vpool.shape)}, table "
            f"{tuple(page_table.shape)}, page_size {P}, seq_len {seq_len}")
    scales = (k_scale, v_scale) if kv_bits is not None else ()
    if any(s is None or tuple(s.shape) != shape[:3] for s in scales):
        raise ValueError(f"paged_decode_attn: kv_bits={kv_bits} needs "
                         f"scales of shape {shape[:3]}")
    n_splits, R = plan_splits(seq_len, rows_per_split)
    if q.device.type == "cpu":
        return ref.paged_decode_attn_ref(
            q, kpool, vpool, pos, page_table, page_size=P, seq_len=seq_len,
            kv_bits=kv_bits, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "meta":
        full = torch.full((B,), seq_len - 1, dtype=torch.int64)
        kind = f"int{kv_bits}" if kv_bits else _DENSE.get(kpool.dtype, "")
        meta.record("paged_decode_attn", kind, "", (B, seq_len, KVh, g, dh),
                    paged_bytes_moved(q, kpool, full, P, seq_len, kv_bits),
                    paged_flops(q, full, seq_len))
        return torch.empty((B, KVh, g, dh), dtype=torch.float32,
                           device="meta")
    tensors = (kpool, vpool, page_table, *scales)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attn: the kernel takes CUDA tensors "
                         "on one device")
    if kv_bits is None:
        kind = _DENSE.get(kpool.dtype)
        ok = kind is not None and vpool.dtype == kpool.dtype
    else:
        kind = f"int{kv_bits}"
        ok = (kpool.dtype == vpool.dtype == torch.int8
              and all(s.dtype == torch.float32 for s in scales))
    if not ok:
        raise ValueError(f"paged_decode_attn: pools {kpool.dtype}/"
                         f"{vpool.dtype} with kv_bits={kv_bits}")
    if not all(t.is_contiguous() for t in (kpool, vpool, *scales)):
        raise ValueError("paged_decode_attn: the kernel takes contiguous "
                         "pools")
    q, pos = _kernel_inputs("paged_decode_attn", q, pos, B, g, dh)
    table = page_table.to(torch.int32).contiguous()
    out, part = _workspace(B, KVh, g, dh, n_splits, q.device)
    ks, vs = (k_scale.data_ptr(), v_scale.data_ptr()) if scales else (None,
                                                                       None)
    lib = build.load()
    err = lib.repro_paged_decode_attn(
        q.data_ptr(), int(q.dtype == torch.bfloat16), kpool.data_ptr(),
        vpool.data_ptr(), ks, vs, PAGE_KINDS[kind], table.data_ptr(),
        pos.data_ptr(), int(pos.dtype == torch.int64), pos.stride(0),
        out.data_ptr(), part.data_ptr(), B, KVh, g, dh, P, table.shape[1],
        int(seq_len), R, n_splits, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"paged_decode_attn (B={B}, KVh={KVh}, g={g}, P={P}, "
                     f"kv_bits={kv_bits}, R={R})")
    paged_decode_attn.launches[kind] += 1
    return out


paged_decode_attn.launches = dict.fromkeys(PAGE_KINDS, 0)


def paged_bytes_moved(q: torch.Tensor, kpool: torch.Tensor, pos,
                      page_size: int, seq_len: int,
                      kv_bits: Optional[int] = None) -> int:
    """Bytes one paged call must move at least: q and pos once, the table
    entries of the pages that hold valid rows, the valid K and V rows'
    codes once each (and their f32 scales when quantized), and the f32
    output once."""
    B, KVh, g, dh = q.shape
    n = torch.clamp(pos.to(torch.int64) + 1, max=seq_len)
    rows = int(n.sum())
    pages = int(((n + page_size - 1) // page_size).sum())
    row_bytes = KVh * kpool.shape[-1] * kpool.element_size()
    if kv_bits is not None:
        row_bytes += KVh * 4
    return (q.numel() * q.element_size() + B * 4 + pages * 4
            + 2 * rows * row_bytes + B * KVh * g * dh * 4)


def paged_flops(q: torch.Tensor, pos, seq_len: int) -> int:
    """q.k and p.v over the valid rows: 4 * rows * KVh * g * dh."""
    B, KVh, g, dh = q.shape
    rows = int(torch.clamp(pos.to(torch.int64) + 1, max=seq_len).sum())
    return 4 * rows * KVh * g * dh

"""Public kernel entry points of the serving path (forward only: decode
holds no gradients; the autograd Functions come with the training slice).

Each op is one call of a kernel wrapper, which decides by device between
the CUDA kernel and its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gemm_core as _gc
from repro_torch.kernels.decode_attn import decode_attn, paged_decode_attn


def fq_matmul_op(x, w, d, q_m, t) -> torch.Tensor:
    """y = x @ fake_quant(w; d, q_m, t) in one pass over W."""
    return _gc.gemm(x, w, _gc.fake_quant_rhs(d, q_m, t))


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
    """Kernel launches so far, by kernel variant (GEMM epilogue, page
    storage)."""
    out = {f"gemm_core.{k}": v for k, v in _gc.gemm.launches.items()}
    out["decode_attn"] = decode_attn.launches
    out.update({f"paged_decode_attn.{k}": v
                for k, v in paged_decode_attn.launches.items()})
    return out


def reset_launch_counts() -> None:
    for counts in (_gc.gemm.launches, paged_decode_attn.launches):
        for k in counts:
            counts[k] = 0
    decode_attn.launches = 0

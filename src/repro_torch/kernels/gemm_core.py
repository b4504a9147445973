"""The GEMM core with a fused weight-decoding epilogue: y = x @ T(w).

Port of `repro.kernels.gemm_core` for the serving epilogues. The weight
transform T is described by an `Epilogue`:

  fake_quant_rhs(d, q_m, t)   w f32/bf16 (K, N); T = Eqs (1)-(2)
  dequant(scale)              w int codes (K, N); T = codes * scale[n]
  unpack_dequant(bits, scale) w int32 words (ceil(K/cpw), N), cpw codes
                              per word packed along K; T = codes * scale[n]

`gemm` decides by device. A CPU tensor goes to the plain PyTorch version
in `kernels.ref`; a CUDA tensor goes to the hand-written kernel in
`csrc/gemm_core.cu`, or raises if the library did not build or the
launch failed. There is no fallback from one to the other.

`gemm.launches` counts kernel launches: the GEMM kernel per epilogue name,
and the split-K reduce pass (a second launch when a small-M call splits
K) under `reduce_splits`. Only the CUDA path adds to it, once per launch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.quant import codes_per_word
from repro_torch.kernels import build, ref

FAKE_QUANT, DEQUANT, UNPACK = "fake_quant_rhs", "dequant", "unpack_dequant"
REDUCE = "reduce_splits"     # the split-K second pass, for any epilogue
_EPI_CODE = {FAKE_QUANT: 0, DEQUANT: 1, UNPACK: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int16: 3, torch.int32: 4}
SMALL_M_MAX = 8      # rows the kernel's small-M (decode) variant takes
_SMALL_M_BN = 128    # its columns per block ...
_SMALL_M_BK = 128    # ... and K rows per chunk (csrc/gemm_core.cu)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """How the kernel decodes each weight tile after its load.

    operands: (d, q_m, t) 0-d f32 tensors for fake-quant, (scale,) with
    scale of shape (N,), or one value for every column, for dequant and
    unpack_dequant. bits: the packed
    field width for unpack_dequant (2, 3, 4 or 8), else 0."""
    name: str
    operands: tuple
    bits: int = 0

    @property
    def k_pack(self) -> int:
        return codes_per_word(self.bits) if self.name == UNPACK else 1


def fake_quant_rhs(d, q_m, t) -> Epilogue:
    return Epilogue(FAKE_QUANT, (d, q_m, t))


def dequant(scale) -> Epilogue:
    return Epilogue(DEQUANT, (scale,))


def unpack_dequant(bits: int, scale) -> Epilogue:
    bits = int(bits)
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"unpack_dequant bits must be 2, 3, 4 or 8: {bits}")
    return Epilogue(UNPACK, (scale,), bits)


def plain(x, w, epi: Epilogue, out_dtype) -> torch.Tensor:
    """The plain PyTorch version of one kernel call."""
    if epi.name == FAKE_QUANT:
        return ref.fq_matmul_ref(x, w, *epi.operands, out_dtype=out_dtype)
    if epi.name == DEQUANT:
        return ref.quant_matmul_ref(x, w, epi.operands[0],
                                    out_dtype=out_dtype)
    return ref.packed_quant_matmul_ref(x, w, epi.bits, epi.operands[0],
                                       out_dtype=out_dtype)


def k_splits(M: int, N: int, K: int, sm_count: int) -> tuple[int, int]:
    """(splits, chunks_per_split) at small M: how many blocks share one
    column strip's K range (enough for about two blocks per SM) and how
    many 128-row chunks each covers, with no split left empty. The kernel
    launches exactly this grid. Depends on the shape only, never on the
    epilogue, so dequant and unpack_dequant sum in the same order."""
    n_chunks = -(-K // _SMALL_M_BK)
    if M > SMALL_M_MAX:
        return 1, n_chunks
    n_blocks = -(-N // _SMALL_M_BN)
    want = max(1, min(n_chunks, -(-2 * sm_count // n_blocks)))
    per_split = -(-n_chunks // want)
    return -(-n_chunks // per_split), per_split


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def gemm(x: torch.Tensor, w: torch.Tensor, epi: Epilogue, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ T(w) with f32 accumulation, written in `out_dtype` (default
    x's dtype). x: (M, K); w: (K, N), or (ceil(K/cpw), N) int32 words for
    unpack_dequant."""
    M, K = x.shape
    Kw, N = w.shape
    if Kw != -(-K // epi.k_pack):
        raise ValueError(f"gemm {epi.name}: x {tuple(x.shape)} does not "
                         f"match w {tuple(w.shape)} (k_pack {epi.k_pack})")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return plain(x, w, epi, out_dtype)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm: x on {x.device}, w on {w.device}; the "
                         f"kernel takes CUDA tensors on one device")
    for name, dt in (("x", x.dtype), ("out", out_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gemm: {name} dtype {dt} is not f32 or bf16")
    w_ok = {FAKE_QUANT: (torch.float32, torch.bfloat16),
            DEQUANT: (torch.int8, torch.int16, torch.int32),
            UNPACK: (torch.int32,)}[epi.name]
    if w.dtype not in w_ok:
        raise ValueError(f"gemm {epi.name}: w dtype {w.dtype} not in {w_ok}")
    if N % 4 or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"gemm: the kernel loads 4 columns at a time and "
                         f"needs N % 4 == 0 and a contiguous, 16-byte "
                         f"aligned w (N={N})")
    dev = x.device
    x = x.contiguous()
    scale, scale_stride, fq = None, 0, [None, None, None]
    if epi.name == FAKE_QUANT:
        fq = [_scalar(v, dev) for v in epi.operands]
    else:
        scale = torch.as_tensor(epi.operands[0], dtype=torch.float32,
                                device=dev).reshape(-1).contiguous()
        if scale.numel() not in (1, N):
            raise ValueError(f"gemm {epi.name}: scale has {scale.numel()} "
                             f"values for N={N} columns")
        scale_stride = int(scale.numel() == N)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    splits, per_split = k_splits(M, N, K, _sm_count(dev))
    ws = (torch.empty((splits * M * N,), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    lib = build.load()
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.repro_gemm(
        x.data_ptr(), _DTYPE_CODE[x.dtype], w.data_ptr(),
        _DTYPE_CODE[w.dtype], _EPI_CODE[epi.name], epi.bits, ptr(scale),
        scale_stride, *map(ptr, fq), out.data_ptr(), _DTYPE_CODE[out_dtype],
        ptr(ws), M, N, K, splits, per_split,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"gemm {epi.name} (M={M}, N={N}, K={K})")
    gemm.launches[epi.name] += 1
    if splits > 1:
        gemm.launches[REDUCE] += 1
    return out


gemm.launches = {FAKE_QUANT: 0, DEQUANT: 0, UNPACK: 0, REDUCE: 0}


def bytes_moved(M: int, N: int, K: int, x_itemsize: int, w: torch.Tensor,
                out_itemsize: int, epi: Epilogue) -> int:
    """Bytes one call must move at least: x, w and the epilogue operands
    read once, y written once."""
    operands = 3 * 4 if epi.name == FAKE_QUANT else N * 4
    return (M * K * x_itemsize + w.numel() * w.element_size() + operands
            + M * N * out_itemsize)


def flops(M: int, N: int, K: int) -> int:
    return 2 * M * N * K

"""The GEMM core with a fused weight-decoding epilogue: y = x @ T(w).

Port of `repro.kernels.gemm_core`. The weight transform T is described by
an `Epilogue`:

  none()                      w f32/bf16 (K, N); T = w
  col_mask(mask)              w f32/bf16 (K, N); T = w * mask[n]
  fake_quant_rhs(d, q_m, t)   w f32/bf16 (K, N); T = Eqs (1)-(2)
  fq_col_mask(d, q_m, t, mask) T = fake_quant(w) * mask[n] (`fq_mask_ops`)
  dequant(scale)              w int codes (K, N); T = codes * scale[n]
  unpack_dequant(bits, scale) w int32 words (ceil(K/cpw), N), cpw codes
                              per word packed along K; T = codes * scale[n]

The first four serve training: the forward (with or without the GETA
column mask) and the backward GEMMs `g @ T(w.T)` and `x.T @ g`, at
M = B*S tokens or M = K_in. The kernel takes a contiguous w, so the
backward passes `w.T.contiguous()`, the copy XLA materialises before its
`pallas_call` too.

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
from typing import Optional

import torch

from repro_torch.core.quant import codes_per_word
from repro_torch.kernels import build, ref

FAKE_QUANT, DEQUANT, UNPACK = "fake_quant_rhs", "dequant", "unpack_dequant"
NONE, COL_MASK, FQ_MASK = "none", "col_mask", "fq_col_mask"
REDUCE = "reduce_splits"     # the split-K second pass, for any epilogue
_EPI_CODE = {FAKE_QUANT: 0, DEQUANT: 1, UNPACK: 2, NONE: 3, COL_MASK: 4,
             FQ_MASK: 5}
_FLOAT_W = (torch.float32, torch.bfloat16)
_W_DTYPES = {FAKE_QUANT: _FLOAT_W, NONE: _FLOAT_W, COL_MASK: _FLOAT_W,
             FQ_MASK: _FLOAT_W, DEQUANT: (torch.int8, torch.int16, torch.int32),
             UNPACK: (torch.int32,)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int16: 3, torch.int32: 4}
SMALL_M_MAX = 8      # rows the kernel's small-M (decode) variant takes
_SMALL_M_BN = 128    # its columns per block ...
_SMALL_M_BK = 128    # ... and K rows per chunk (csrc/gemm_core.cu)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """How the kernel decodes each weight tile after its load.

    operands: (d, q_m, t) 0-d f32 tensors for fake-quant, (d, q_m, t,
    mask) for fake-quant then column mask, (mask,) of shape (N,) for
    col_mask, () for none, (scale,) with scale of shape (N,), or one value
    for every column, for dequant and unpack_dequant. bits: the packed
    field width for unpack_dequant (2, 3, 4 or 8), else 0."""
    name: str
    operands: tuple
    bits: int = 0

    @property
    def k_pack(self) -> int:
        return codes_per_word(self.bits) if self.name == UNPACK else 1


def none() -> Epilogue:
    return Epilogue(NONE, ())


def col_mask(mask) -> Epilogue:
    return Epilogue(COL_MASK, (mask,))


def fake_quant_rhs(d, q_m, t) -> Epilogue:
    return Epilogue(FAKE_QUANT, (d, q_m, t))


def fq_col_mask(d, q_m, t, mask) -> Epilogue:
    """fake_quant(w) then the column mask, in one pass over W."""
    return Epilogue(FQ_MASK, (d, q_m, t, mask))


def dequant(scale) -> Epilogue:
    return Epilogue(DEQUANT, (scale,))


def unpack_dequant(bits: int, scale) -> Epilogue:
    bits = int(bits)
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"unpack_dequant bits must be 2, 3, 4 or 8: {bits}")
    return Epilogue(UNPACK, (scale,), bits)


def plain(x, w, epi: Epilogue, out_dtype) -> torch.Tensor:
    """The plain PyTorch version of one kernel call."""
    if epi.name in (FAKE_QUANT, FQ_MASK):
        return ref.fq_matmul_ref(x, w, *epi.operands, out_dtype=out_dtype)
    if epi.name == NONE:
        return ref.matmul_ref(x, w, out_dtype=out_dtype)
    if epi.name == COL_MASK:
        return ref.masked_matmul_ref(x, w, epi.operands[0],
                                     out_dtype=out_dtype)
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
    w_ok = _W_DTYPES[epi.name]
    if w.dtype not in w_ok:
        raise ValueError(f"gemm {epi.name}: w dtype {w.dtype} not in {w_ok}")
    if N % 4 or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"gemm: the kernel loads 4 columns at a time and "
                         f"needs N % 4 == 0 and a contiguous, 16-byte "
                         f"aligned w (N={N})")
    dev = x.device
    x = x.contiguous()
    scale, scale_stride, fq = None, 0, [None, None, None]
    col = epi.operands       # (mask,), (scale,) or ()
    if epi.name in (FAKE_QUANT, FQ_MASK):
        fq = [build.device_scalar(v, dev) for v in epi.operands[:3]]
        col = epi.operands[3:]
    if col:
        scale = torch.as_tensor(col[0], dtype=torch.float32,
                                device=dev).reshape(-1).contiguous()
        if scale.numel() not in (1, N):
            raise ValueError(f"gemm {epi.name}: scale has {scale.numel()} "
                             f"values for N={N} columns")
        scale_stride = int(scale.numel() == N)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    splits, per_split = k_splits(M, N, K, build.sm_count(dev))
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


gemm.launches = {name: 0 for name in (*_EPI_CODE, REDUCE)}


def bytes_moved(M: int, N: int, K: int, x_itemsize: int, w: torch.Tensor,
                out_itemsize: int, epi: Epilogue) -> int:
    """Bytes one call must move at least: x, w and the epilogue operands
    read once, y written once."""
    operands = ({FAKE_QUANT: 12, NONE: 0, FQ_MASK: 12 + N * 4}
                .get(epi.name, N * 4))
    return (M * K * x_itemsize + w.numel() * w.element_size() + operands
            + M * N * out_itemsize)


def flops(M: int, N: int, K: int) -> int:
    return 2 * M * N * K

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
M = B*S tokens or M = K_in. They pass the transposed views as they are.

`gemm` decides by device. A CPU tensor goes to the plain PyTorch version
in `kernels.ref`; a CUDA tensor goes to a hand-written kernel in
`csrc/gemm_core.cu`, or raises if the library did not build or the
launch failed; a meta tensor computes nothing and records the launch the
card would make (`kernels.meta`). There is no fallback from one to the
other. On the card, `variant` picks the kernel by M and x's dtype:

  small_m  M <= 8 (decode): one launch; the blocks that split a
           column strip's K range form a thread-block cluster and sum
           their partials over DSMEM in a fixed order (`small_m_plan`)
  tc       M > 8, bf16 x: wgmma tiles fed by TMA, which reads x and w in
           place, row-major or as a transposed view (`x.T`, `w.T`); int
           codes and packed words row-major only.
  simt     M > 8, f32 x: a register-tiled SGEMM (128x128 tiles) in f32
           FMAs (the f32 configuration's 1e-4 card-vs-CPU parity rests on
           it)

Every variant takes any N >= 1 and K >= 1: the widths pruning leaves
(d_ff 8192 at sparsity 0.3 keeps 5734 units) included. The serving path
stores every weight whose rows are not 16-byte multiples with its rows
padded (`aligned_rows`, once, in `core.subnet.prepare_serving`), so the
kernels load it in whole 16-byte chunks and TMA reads it in place. The
wrapper copies into such rows any operand a variant cannot read in place
(`operands`): for the tensor-core variant rows that are not 16-byte
multiples (w_down's input x at K = 5734), for the others a weight whose
rows are not a multiple of 4 columns apart (their 4-column loads); they
read a row-major x at any row stride.

The plan of a call (the small-M split, the tensor-core block height) is
the tuning table's where `kernels.autotune` holds one for the call's key,
else the rule's (`small_m_plan`, `tc_block_m`): `plan` resolves it on
the CUDA and meta routes. `describe` builds the call's launch record
(`kernels.introspect`) from the same functions on every route.

`gemm.launches` counts kernel launches: the GEMM kernel per epilogue name
and per variant (every call is one launch), and under "copies" the
operand copies the wrapper made before a launch. Only the CUDA path adds
to it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import codes_per_word
from repro_torch.kernels import autotune, build, introspect, meta, ref

FAKE_QUANT, DEQUANT, UNPACK = "fake_quant_rhs", "dequant", "unpack_dequant"
NONE, COL_MASK, FQ_MASK = "none", "col_mask", "fq_col_mask"
SMALL_M, TC, SIMT = "small_m", "tc", "simt"     # kernel variants
_EPI_CODE = {FAKE_QUANT: 0, DEQUANT: 1, UNPACK: 2, NONE: 3, COL_MASK: 4,
             FQ_MASK: 5}
_FLOAT_W = (torch.float32, torch.bfloat16)
_W_DTYPES = {FAKE_QUANT: _FLOAT_W, NONE: _FLOAT_W, COL_MASK: _FLOAT_W,
             FQ_MASK: _FLOAT_W, DEQUANT: (torch.int8, torch.int16, torch.int32),
             UNPACK: (torch.int32,)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int16: 3, torch.int32: 4}
SMALL_M_MAX = 8      # rows the kernel's small-M (decode) variant takes
# The small-M variant's constants (csrc/gemm_core.cu, SM_*): columns per
# strip, K-groups per block, K rows of x a block stages at once, and the
# portable thread-block-cluster size
_SMALL_M_BN, SMALL_M_GROUPS, SMALL_M_WINDOW = 128, 32, 2048
SMALL_M_CLUSTER_MAX = 8
_TC_BN = 128         # columns per block of the tensor-core variant
# threads a block of each variant, and the SIMT variant's block tile
SMALL_M_THREADS, _TC_THREADS, _GM_THREADS = 256, 4 * 128 + 32, 256
_GM_BM = _GM_BN = 128
_ROW_ALIGN = 16      # bytes: TMA's row stride, the kernels' chunk


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


@dataclasses.dataclass(frozen=True)
class SmallMPlan:
    """How the small-M kernel shares out one call: `strip` columns per
    block, `cluster` blocks (one thread-block cluster) per strip, block r
    of the cluster summing K rows [r * k_slice, (r + 1) * k_slice)."""
    strip: int
    cluster: int
    k_slice: int

    def group_rows(self, K: int):
        """(rank, group, lo, hi) for every K-group of every block that sums
        rows, as the kernel shares them out: within each window of up to
        2048 rows of its slice, K-group g of 32 sums rows [lo, hi), rg =
        window / 32 of them from g * rg on, in ascending order."""
        win = min(self.k_slice, SMALL_M_WINDOW)
        rg = win // SMALL_M_GROUPS
        for rank in range(self.cluster):
            kb = rank * self.k_slice
            ke = min(K, kb + self.k_slice)
            for wb in range(kb, ke, win):
                we = min(ke, wb + win)
                for g in range(SMALL_M_GROUPS):
                    lo = min(we, wb + g * rg)
                    hi = min(we, lo + rg)
                    if lo < hi:
                        yield rank, g, lo, hi


def small_m_plan(M: int, N: int, K: int, sm_count: int) -> SmallMPlan:
    """The small-M kernel's plan: 128-column strips; the fewest rows per
    K-group (a multiple of 8, up to 64) that keep the blocks (strips x
    cluster) within one per SM and the cluster within 8. Past 16384 rows at
    8 blocks, k_slice is a multiple of the 2048-row window. Every block
    holds a row of K. The kernel launches exactly this grid. Depends on
    the shape and the SM count only, never on the epilogue, so dequant and
    unpack_dequant sum identical codes in the same order."""
    if not (1 <= M <= SMALL_M_MAX and K >= 1 and N >= 1):
        raise ValueError(f"small_m_plan: M={M}, N={N}, K={K}")
    strips = -(-N // _SMALL_M_BN)
    fill = max(sm_count, strips)
    for rows in range(8, SMALL_M_WINDOW // SMALL_M_GROUPS + 1, 8):
        k_slice = SMALL_M_GROUPS * rows
        cluster = -(-K // k_slice)
        if cluster <= SMALL_M_CLUSTER_MAX and strips * cluster <= fill:
            return SmallMPlan(_SMALL_M_BN, cluster, k_slice)
    want = max(1, min(SMALL_M_CLUSTER_MAX, sm_count // strips,
                      -(-K // SMALL_M_WINDOW)))
    k_slice = -(-K // (want * SMALL_M_WINDOW)) * SMALL_M_WINDOW
    return SmallMPlan(_SMALL_M_BN, -(-K // k_slice), k_slice)


def variant(M: int, x_dtype: torch.dtype) -> str:
    """The kernel variant a CUDA call of `gemm` launches (module doc)."""
    if M <= SMALL_M_MAX:
        return SMALL_M
    return TC if x_dtype == torch.bfloat16 else SIMT


def tc_block_m(M: int, N: int, sm_count: int) -> int:
    """Rows per block of the tensor-core variant: 256 when that takes fewer
    waves of blocks over the SMs than 128, else 128. A block decodes each
    weight tile it reads once, so 256 rows halve the decodes; at equal waves
    128 rows spread them over more SMs. The sums do not depend on it."""
    waves = lambda bm: -(-(-(-M // bm) * -(-N // _TC_BN)) // sm_count)
    return 256 if waves(256) < waves(128) else 128


def plan_of(kind: str, plan: tuple):
    """A tuning-table plan as the variant takes it: a `SmallMPlan` from
    (cluster, k_slice), bm from (bm,), None for SIMT."""
    if kind == SMALL_M:
        return SmallMPlan(_SMALL_M_BN, *plan)
    return plan[0] if kind == TC else None


def plan(kind: str, M: int, N: int, K: int, epi: Epilogue, sm_count: int,
         plan_n: Optional[int] = None):
    """(the plan a call launches, whether the tuning table gave it): the
    table's plan for the call's key (`kernels.autotune`), else the rule's,
    `small_m_plan` (planned for `plan_n` columns where given) or
    `tc_block_m`; (None, False) for the SIMT variant."""
    if kind == SIMT:
        return None, False
    n = plan_n or N if kind == SMALL_M else N
    if autotune.active():
        ops = autotune.ops_key(epi) if kind == TC else ""
        hit = autotune.lookup(M, n, K, kind, sm_count, ops)
        if hit is not None:
            return plan_of(kind, hit), True
    return (small_m_plan(M, n, K, sm_count) if kind == SMALL_M
            else tc_block_m(M, N, sm_count)), False


def _tc_kind(epi: Epilogue, w_dtype: torch.dtype) -> int:
    """How the tensor-core variant takes the weight tile (csrc `TcKind`)."""
    if epi.name == UNPACK:
        return introspect.TC_UNPACK
    if epi.name in (FAKE_QUANT, FQ_MASK):
        return introspect.TC_FQ
    if epi.name in (NONE, COL_MASK) and w_dtype == torch.bfloat16:
        return introspect.TC_DIRECT
    return introspect.TC_VALUE


_DTYPE_NAME = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
               torch.int8: "int8_t", torch.int16: "int16_t",
               torch.int32: "int32_t"}


def kernel_of(kind: str, M: int, N: int, K: int, epi: Epilogue,
              w_dtype: torch.dtype, plan_, x_transposed: bool = False,
              w_transposed: bool = False,
              x_dtype: torch.dtype = torch.bfloat16) -> meta.Kernel:
    """The kernel a call of `kind` launches under `plan_` (`plan`): its
    instantiation, grid, block, cluster and shared memory, as
    `csrc/gemm_core.cu`'s launchers set them."""
    epi_code, wt = _EPI_CODE[epi.name], _DTYPE_NAME[w_dtype]
    x_code = _DTYPE_CODE[torch.float32 if kind == SIMT else x_dtype]
    bits = epi.bits
    if kind == SMALL_M:
        mt = introspect.small_m_rows(M)
        return meta.Kernel(
            f"gemm_small_m<{epi_code}, {wt}, {bits}, {mt}>",
            (x_code, _DTYPE_CODE[w_dtype], epi_code, bits, M, plan_.k_slice,
             0, 0, 0), (plan_.cluster, -(-N // _SMALL_M_BN), 1),
            SMALL_M_THREADS, plan_.cluster, 0,
            introspect.small_m_smem(M, plan_.k_slice))
    if kind == TC:
        tk = _tc_kind(epi, w_dtype)
        a_mn, b_mn = int(x_transposed), int(not w_transposed)
        return meta.Kernel(
            f"gemm_tc<{tk}, {wt}, {bits}, {plan_}, {a_mn}, {b_mn}>",
            (x_code, _DTYPE_CODE[w_dtype], epi_code, bits, M, 0, plan_,
             int(x_transposed), int(w_transposed)),
            (-(-N // _TC_BN), -(-M // plan_), 1), _TC_THREADS, 1, 0,
            introspect.tc_smem(tk, w_dtype.itemsize, bits, plan_))
    return meta.Kernel(
        f"gemm_general<{epi_code}, {wt}, {bits}>",
        (x_code, _DTYPE_CODE[w_dtype], epi_code, bits, M, 0, 0, 0, 0),
        (-(-N // _GM_BN), -(-M // _GM_BM), 1), _GM_THREADS, 1,
        introspect.SIMT_SMEM, 0)


def describe(x: torch.Tensor, w: torch.Tensor, epi: Epilogue,
             out_dtype: torch.dtype, plan_n: Optional[int] = None,
             resolved: Optional[tuple] = None) -> meta.Launch:
    """The launch record of `gemm(x, w, epi)`: the kernel, variant,
    epilogue, (M, K, N), bytes and operations, and the plan and kernel
    the CUDA route launches (x and w as that route reads them: in place
    where it can, else row-major copies; `operands`). `resolved` is the
    `plan` result the launch itself takes, where the caller has it; else
    it is resolved here, with the card's SM count for a CUDA tensor and
    the H100's otherwise."""
    M, K = x.shape
    N = w.shape[1]
    kind = variant(M, x.dtype)
    if resolved is None:
        sm = (build.sm_count(x.device) if x.is_cuda else introspect.H100_SMS)
        resolved = plan(kind, M, N, K, epi, sm, plan_n)
    plan_, tuned = resolved
    tc = kind == TC
    x_t = (_in_place(x, tc, _ROW_ALIGN if tc else x.element_size())
           or (None, 0, False))[2]
    w_align = _ROW_ALIGN if tc else min(_ROW_ALIGN, 4 * w.element_size())
    w_t = (_in_place(w, tc, w_align) or (None, 0, False))[2]
    if kind == SMALL_M:
        plan_ints = (plan_.strip, plan_.cluster, plan_.k_slice)
    else:
        plan_ints = () if plan_ is None else (plan_,)
    return meta.launch(
        "gemm_core", kind, epi.name, (M, K, N),
        bytes_moved(M, N, K, x.element_size(), w, out_dtype.itemsize, epi),
        flops(M, N, K), plan=plan_ints,
        kernels=(kernel_of(kind, M, N, K, epi, w.dtype, plan_, x_t, w_t,
                           x.dtype),),
        tuned=tuned, route=x.device.type)


def padded_ld(cols: int, itemsize: int) -> int:
    """The leading dimension of rows of `cols` elements padded to the next
    multiple of 16 bytes."""
    per = _ROW_ALIGN // itemsize
    return -(-cols // per) * per


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """t itself when its rows (the last dim, unit stride) start 16 bytes
    apart on a 16-byte aligned base, else a copy whose rows are padded with
    zeros to the next 16 bytes, viewed at t's shape (`[..., :N]` of the
    padded allocation): the layout the small-M variant loads in whole
    chunks and TMA reads in place. The logical shape and values are t's."""
    cols, es = t.shape[-1], t.element_size()
    if (t.stride(-1) == 1 and (t.stride(-2) * es) % _ROW_ALIGN == 0
            and t.data_ptr() % _ROW_ALIGN == 0):
        return t
    out = torch.zeros((*t.shape[:-1], padded_ld(cols, es)), dtype=t.dtype,
                      device=t.device)
    out[..., :cols] = t
    return out[..., :cols]


def _copied(t: torch.Tensor) -> tuple[torch.Tensor, int, bool]:
    """(copy, ld, False): a row-major copy of the 2-D t in a fresh
    allocation, its rows `padded_ld` elements apart (the padding is
    uninitialised: TMA reads nothing past N or K, and the other variants'
    columns past N are never stored); counted in `gemm.launches["copies"]`
    on the card."""
    if t.is_cuda:
        gemm.launches["copies"] += 1
    rows, cols = t.shape
    ld = padded_ld(cols, t.element_size())
    out = torch.empty((rows, ld), dtype=t.dtype, device=t.device)[:, :cols]
    out.copy_(t)
    return out, ld, False


def _in_place(t: torch.Tensor, transposed_ok: bool, align: int):
    """(t, ld, transposed) if a variant can read t where it lies: row-major
    (strides (ld, 1)) or, where `transposed_ok`, the transposed view of a
    row-major array (strides (1, ld)), its rows a multiple of `align`
    bytes apart on a base so aligned. Else None."""
    rows, cols = t.shape
    s0, s1 = t.stride()
    if s1 == 1 and s0 >= cols:
        ld, transposed = s0, False
    elif transposed_ok and s0 == 1 and s1 >= rows:
        ld, transposed = s1, True
    else:
        return None
    if (ld * t.element_size()) % align or t.data_ptr() % align:
        return None
    return t, ld, transposed


def operands(x: torch.Tensor, w: torch.Tensor, epi: Epilogue):
    """(variant, (x, lda, x_transposed), (w, ldb, w_transposed)): the
    kernel a CUDA call launches and its operands as it reads them, in
    place where the variant can (`_in_place`), else copied into 16-byte
    rows (`_copied`). The tensor-core variant reads x and w with 16-byte
    rows (TMA), row-major or transposed; the others read x row-major at any
    stride and w row-major with rows a multiple of 4 columns apart on a
    base so aligned (their 4-column loads; 16-byte rows load whole
    chunks). Raises on transposed codes, which no variant reads."""
    kind = variant(x.shape[0], x.dtype)
    tc = kind == TC
    x_op = (_in_place(x, tc, _ROW_ALIGN if tc else x.element_size())
            or _copied(x))
    w_align = _ROW_ALIGN if tc else min(_ROW_ALIGN, 4 * w.element_size())
    w_op = _in_place(w, tc, w_align) or _copied(w)
    if w_op[2] and epi.name in (DEQUANT, UNPACK):
        raise ValueError(f"gemm {epi.name}: the codes must be row-major "
                         f"(K, N), not a transposed view")
    return kind, x_op, w_op


def gemm(x: torch.Tensor, w: torch.Tensor, epi: Epilogue, *,
         out_dtype: Optional[torch.dtype] = None,
         plan_n: Optional[int] = None) -> torch.Tensor:
    """y = x @ T(w) with f32 accumulation, written in `out_dtype` (default
    x's dtype). x: (M, K); w: (K, N), or (ceil(K/cpw), N) int32 words for
    unpack_dequant. Either may be a transposed view. `plan_n` plans the
    small-M variant's K split as for a call of that many columns (`tp_gemm`:
    a column shard then sums K in the full-width call's order)."""
    M, K = x.shape
    Kw, N = w.shape
    if Kw != -(-K // epi.k_pack):
        raise ValueError(f"gemm {epi.name}: x {tuple(x.shape)} does not "
                         f"match w {tuple(w.shape)} (k_pack {epi.k_pack})")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        if introspect.recording():
            introspect.note(describe(x, w, epi, out_dtype, plan_n))
        return plain(x, w, epi, out_dtype)
    if x.device.type == "meta" and w.device.type == "meta":
        introspect.note(describe(x, w, epi, out_dtype, plan_n))
        return torch.empty((M, N), dtype=out_dtype, device="meta")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm: x on {x.device}, w on {w.device}; the "
                         f"kernel takes CUDA tensors on one device")
    for name, dt in (("x", x.dtype), ("out", out_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gemm: {name} dtype {dt} is not f32 or bf16")
    w_ok = _W_DTYPES[epi.name]
    if w.dtype not in w_ok:
        raise ValueError(f"gemm {epi.name}: w dtype {w.dtype} not in {w_ok}")
    kind, (x, lda, x_t), (w, ldb, w_t) = operands(x, w, epi)
    dev = x.device
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
    resolved = plan(kind, M, N, K, epi, build.sm_count(dev), plan_n)
    if introspect.recording():
        introspect.note(introspect.on_card(
            describe(x, w, epi, out_dtype, plan_n, resolved)))
    lib = build.load()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan_ = resolved[0]
    if kind == TC:
        err = lib.repro_gemm_tc(
            x.data_ptr(), lda, int(x_t), w.data_ptr(), _DTYPE_CODE[w.dtype],
            ldb, int(w_t), _EPI_CODE[epi.name], epi.bits, ptr(scale),
            scale_stride, *map(ptr, fq), out.data_ptr(),
            _DTYPE_CODE[out_dtype], M, N, K, plan_, stream)
    else:
        cluster = k_slice = 0            # the SIMT variant splits nothing
        if kind == SMALL_M:
            cluster, k_slice = plan_.cluster, plan_.k_slice
        err = lib.repro_gemm(
            x.data_ptr(), _DTYPE_CODE[x.dtype], lda, w.data_ptr(),
            _DTYPE_CODE[w.dtype], ldb, _EPI_CODE[epi.name], epi.bits,
            ptr(scale), scale_stride, *map(ptr, fq), out.data_ptr(),
            _DTYPE_CODE[out_dtype], M, N, K, cluster, k_slice, stream)
    build.check(err, f"gemm {epi.name} {kind} (M={M}, N={N}, K={K})")
    gemm.launches[epi.name] += 1
    gemm.launches[kind] += 1
    return out


gemm.launches = {name: 0 for name in (*_EPI_CODE, SMALL_M, TC, SIMT,
                                      "copies")}


def tp_gemm(x: torch.Tensor, w: torch.Tensor, epi: Epilogue, *, mesh,
            axis: str = "model",
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Column-parallel y = x @ T(w) over the ranks of `mesh`'s `axis`: x
    whole on every rank, w (or its packed words: packing runs along K)
    and every per-column operand (a mask, a scale of N values) cut into
    column tiles, one `gemm` per rank on its tile, the tiles gathered, so
    every rank returns the full (M, N). Each tile plans its K split as the
    full-width call does (`plan_n`), so every column carries the 1-rank
    call's bits. Raises unless the axis size divides N."""
    tp = int(mesh.shape[axis])
    N = w.shape[1]
    if N % tp:
        raise ValueError(f"tp_gemm: N={N} must divide the {axis!r} axis "
                         f"size {tp}")
    n = N // tp
    lo = mesh.index(axis) * n

    def tile(v):
        v = torch.as_tensor(v)
        return v.reshape(-1)[lo:lo + n] if v.numel() == N else v

    ops = epi.operands
    if epi.name in (FAKE_QUANT, FQ_MASK):
        ops = ops[:3] + tuple(tile(v) for v in ops[3:])
    else:
        ops = tuple(tile(v) for v in ops)
    y = gemm(x, w[:, lo:lo + n], dataclasses.replace(epi, operands=ops),
             out_dtype=out_dtype, plan_n=N)
    return torch.cat(mesh.all_gather(y, axis), dim=-1)


def bytes_moved(M: int, N: int, K: int, x_itemsize: int, w: torch.Tensor,
                out_itemsize: int, epi: Epilogue) -> int:
    """Bytes one call must move at least: x, w and the epilogue operands
    read once, y written once."""
    extra = ({FAKE_QUANT: 12, NONE: 0, FQ_MASK: 12 + N * 4}
             .get(epi.name, N * 4))
    return (M * K * x_itemsize + w.numel() * w.element_size() + extra
            + M * N * out_itemsize)


def flops(M: int, N: int, K: int) -> int:
    return 2 * M * N * K

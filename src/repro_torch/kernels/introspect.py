"""Launch introspection, with Hopper's shared-memory budget in place of VMEM.

Port of `repro.kernels.introspect`. The static checker
(`repro_torch.analysis`) and the tuner (`kernels.autotune`) need to know,
for a call of a kernel wrapper, what CUDA launch it makes: the plan, the
grid, the threads a block, the cluster and the shared memory a block, on
any route. Each wrapper (`gemm_core.gemm`, `decode_attn.decode_attn`,
`decode_attn.paged_decode_attn`, `fake_quant.fake_quant_fwd` and
`fake_quant_bwd`) builds that record, a `kernels.meta.Launch`, with the
same functions and the same tuning-table lookup its CUDA route launches
from, on a CUDA tensor, on a CPU tensor (which takes the plain version)
and on a meta tensor (which takes the dry run's route). So the record is
the launch, not a second guess of it.

Recording is off by default and costs one `is None` check a call.
`record_launches()` turns it on for the block:

    with introspect.record_launches() as launches:
        engine_step()
    # launches: [Launch(kernel="gemm_core", ...), ...]

Off the card the SM count that plans the GEMM is the H100's, 132
(`H100_SMS`); on the card it is the device's.

The byte models follow the CUDA sources, one function per kernel family:
`small_m_smem` (`csrc/gemm_core.cu` `sm_smem_bytes`, opted in by
`launch_small_m`), `tc_smem` (`TcTraits::kSmem`, under `TC_SMEM_MAX`),
`SIMT_SMEM` (`gemm_general`'s static `As` and `Bs`), `decode_split_smem`,
`decode_split_static` and `DECODE_COMBINE_SMEM` (`csrc/decode_attn.cu`:
the dynamic K / V tiles and the warps' sums, beside the static score,
max, row and scale arrays that the source's row format keeps; the
combine's static arrays), `FQ_BWD_SMEM` (`csrc/fake_quant.cu`'s
`fq_bwd` fold arrays; the forward holds none). The budget (`faults`) is
Hopper's: at most 232448 bytes a block, of which at most 48 KB static
(more only as opted-in dynamic memory), 1024 threads a block and a
cluster of at most 8 blocks. Registers cannot be modelled off the card:
a record made on the card carries each kernel's `numRegs`
(`card_attributes`, `cudaFuncGetAttributes` through the source's one
attribute function), and only there does the budget hold threads times
registers to the SM's 65536.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

from repro_torch.kernels import meta

H100_SMS = 132                 # SMs of an H100: the off-card plan's count
SMEM_BLOCK_MAX = 232448        # shared bytes a block (227 KB)
SMEM_STATIC_MAX = 48 * 1024    # static shared bytes a block
THREADS_MAX = 1024
CLUSTER_MAX = 8                # the portable thread-block cluster
REGS_PER_SM = 65536

_F32 = 4

_records: Optional[list] = None


@contextlib.contextmanager
def record_launches():
    """Collect the `Launch` of every kernel-wrapper call made inside the
    block, on any route. Reentrant use shares the innermost list."""
    global _records
    prev = _records
    _records = [] if prev is None else prev
    try:
        yield _records
    finally:
        _records = prev


def recording() -> bool:
    return _records is not None


def note(launch: meta.Launch) -> None:
    """A wrapper's call: the meta route's record goes to the dry run's log
    (`meta.LOG`), and every route's to the recording list, if one is
    open."""
    if launch.route == "meta":
        meta.LOG.append(launch)
    if _records is not None:
        _records.append(launch)


# --------------------------------------------------------- byte models
# csrc/gemm_core.cu: the small-M variant's ring (SM_STAGES x SM_LOADS x
# SM_THREADS 16-byte chunks), its K-groups and columns a strip
_SM_RING = 4 * 4 * 256 * 16
_SM_WARPS, _SM_BN, _SM_WINDOW = 8, 128, 2048


def small_m_rows(M: int) -> int:
    """The rows of accumulators (`MT`) the small-M launcher picks."""
    return 4 if M <= 4 else 8


def small_m_smem(M: int, k_slice: int) -> int:
    """`sm_smem_bytes<MT>(win)`: the ring, x's window of win = min(k_slice,
    2048) rows (reused for the warps' partials), the block's partial;
    all dynamic."""
    mt, win = small_m_rows(M), min(k_slice, _SM_WINDOW)
    return _SM_RING + (max(win * mt, _SM_WARPS * mt * _SM_BN)
                       + mt * _SM_BN) * _F32


# the tensor-core variant's weight-tile kinds (csrc `TcKind`)
TC_DIRECT, TC_VALUE, TC_FQ, TC_UNPACK = 0, 1, 2, 3
_TC_BN, _TC_BK, _TC_SUB = 128, 64, 64 * 128


def tc_smem(kind: int, w_itemsize: int, bits: int, bm: int) -> int:
    """`TcTraits<KIND, WT, BITS, BM>::kSmem`: barriers, as many stages of
    x's and the weight's tiles as fit (at most 4), the decoded piece tiles
    and the epilogue's words; all dynamic."""
    cpw = 32 // bits if kind == TC_UNPACK else 1
    raw_rows = (_TC_BK if kind != TC_UNPACK else
                _TC_BK // cpw if _TC_BK % cpw == 0 else _TC_BK // cpw + 2)
    pieces = 1 if kind in (TC_DIRECT, TC_UNPACK) or w_itemsize == 1 else 2
    a_bytes = bm * _TC_BK * 2
    b_bytes = (_TC_BN * _TC_BK * 2 if kind == TC_DIRECT
               else raw_rows * _TC_BN * w_itemsize)
    stage = -(-(a_bytes + b_bytes) // 1024) * 1024
    decoded = 0 if kind == TC_DIRECT else 2 * 2 * pieces * _TC_SUB
    stages = min((SMEM_BLOCK_MAX - 1024 - 256 - decoded) // stage, 4)
    return 1024 + stages * stage + decoded + 256


# gemm_general's static tiles: As[3][128][20] and Bs[2][16][128] floats
SIMT_SMEM = (3 * 128 * 20 + 2 * 16 * 128) * _F32

# csrc/decode_attn.cu: the split kernel's static arrays, as the compiler
# keeps them: the scores ps[8][128] and m_s / l_s[8] always, the rows'
# physical indices phys_s[128] (int64) only on the paged source, the
# rows' scales ks_s / vs_s[128] only for int8 and int4 rows; its warps;
# and the combine's (w_s / l_s[8][256], M_s / L_s[8])
DECODE_WARPS = 4
DECODE_COMBINE_SMEM = (2 * 8 * 256 + 2 * 8) * _F32


def decode_split_static(paged: bool, scaled: bool) -> int:
    return ((8 * 128 + 2 * 8) * _F32 + (128 * 8 if paged else 0)
            + (2 * 128 * _F32 if scaled else 0))


def decode_split_smem(row_bytes: int, g: int, dh: int, R: int) -> int:
    """The split kernel's dynamic bytes: R rows of K and of V at a 16-byte
    pitch, then the warps' (g, dh) f32 P.V sums."""
    pitch = -(-row_bytes // 16) * 16
    return 2 * R * pitch + DECODE_WARPS * g * dh * _F32


# csrc/fake_quant.cu fq_bwd: sh[8][3] floats and the `last` flag
FQ_BWD_SMEM = 8 * 3 * _F32 + 1


# -------------------------------------------------------------- budget
def faults(kernel: meta.Kernel, budget: Optional[int] = None) -> list[str]:
    """What of Hopper's per-block limits `kernel` passes (empty: none).
    `budget`: the shared bytes a block (default `SMEM_BLOCK_MAX`).
    Registers only where the record carries them (the CUDA route)."""
    budget = SMEM_BLOCK_MAX if budget is None else budget
    out = []
    if kernel.smem > budget:
        out.append(f"shared memory {kernel.smem} > {budget} bytes a block")
    if kernel.smem_static > SMEM_STATIC_MAX:
        out.append(f"static shared memory {kernel.smem_static} > "
                   f"{SMEM_STATIC_MAX} bytes")
    if kernel.threads > THREADS_MAX:
        out.append(f"{kernel.threads} threads > {THREADS_MAX} a block")
    if kernel.cluster > CLUSTER_MAX:
        out.append(f"cluster of {kernel.cluster} > {CLUSTER_MAX}")
    if kernel.regs is not None and kernel.regs * kernel.threads > REGS_PER_SM:
        out.append(f"{kernel.threads} threads x {kernel.regs} registers > "
                   f"{REGS_PER_SM}")
    return out


def launch_faults(launch: meta.Launch, budget: Optional[int] = None
                  ) -> list[str]:
    return [f"{k.name}: {f}" for k in launch.kernels
            for f in faults(k, budget)]


def over_budget(launch: meta.Launch, budget: Optional[int] = None) -> bool:
    return bool(launch_faults(launch, budget))


# ------------------------------------------------------------ the card
# the attribute function each source exports, by kernel name prefix
_QUERIES = (("gemm_", "repro_gemm_attributes"),
            ("flash_decode_", "repro_decode_attn_attributes"),
            ("fq_", "repro_fake_quant_attributes"))


@functools.lru_cache(maxsize=None)
def _attributes(name: str, query: tuple) -> tuple:
    import ctypes

    from repro_torch.kernels import build
    fn = next(f for prefix, f in _QUERIES if name.startswith(prefix))
    out = (ctypes.c_int * 4)()
    build.check(getattr(build.load(), fn)(
        *query, ctypes.cast(out, ctypes.c_void_p)), f"{fn}{query} ({name})")
    return tuple(out)


def card_attributes(kernel: meta.Kernel) -> dict:
    """The card's `cudaFuncAttributes` of the instantiation `kernel`
    names, and the dynamic bytes its launcher opts into: `static`
    (sharedSizeBytes), `regs` (numRegs), `max_threads`
    (maxThreadsPerBlock), `dynamic`. Needs the card (builds the library)."""
    static, regs, max_threads, dynamic = _attributes(kernel.name,
                                                     kernel.query)
    return {"static": static, "regs": regs, "max_threads": max_threads,
            "dynamic": dynamic}


def on_card(launch: meta.Launch) -> meta.Launch:
    """`launch` with each kernel's `numRegs` from the card."""
    return dataclasses.replace(launch, kernels=tuple(
        dataclasses.replace(k, regs=card_attributes(k)["regs"])
        for k in launch.kernels))

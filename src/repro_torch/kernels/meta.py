"""The kernel wrappers' meta route: a launch without a device.

A wrapper handed `meta` tensors (the dry run, `launch.dryrun`) computes
nothing and needs no card. It returns empty meta tensors of the shapes
and dtypes its kernel writes, and appends a `Launch` to `LOG`: the
kernel, its variant and epilogue, the shape, and the bytes and
operations the CUDA call would move and do, from the byte and operation
functions that bound the card's rows (`gemm_core.bytes_moved` / `flops`,
`fake_quant.fwd_bytes` / `bwd_bytes`, `decode_attn.bytes_moved` /
`paged_bytes_moved`). The device still decides: a CPU tensor takes the
plain version, a CUDA tensor the kernel, a meta tensor this route. The
wrappers' own launch counts are the card's and stay untouched.

Where the card's work depends on values a meta tensor does not hold
(decode attention's valid rows), the record counts the most the call can
need: every row of the arena.

A `Launch` also carries the launch itself (`kernels.introspect`): the
resolved plan and, for each CUDA kernel of the call, a `Kernel` with its
grid, threads a block, cluster size and shared memory. The wrappers build
it on every route with the functions the CUDA route launches from, so the
meta route's record and `introspect.record_launches()`'s are the launch.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One CUDA kernel of a wrapper call. `name` is the kernel's template
    instantiation as the source writes it; `query` the arguments of its
    source's attribute function (`introspect.card_attributes`), which
    names the same instantiation. `smem_static`: the block's static
    shared arrays; `smem_dynamic`: the dynamic bytes the launcher passes
    (and opts into past 48 KB). `regs`: `numRegs` from the card, on the
    CUDA route only (None elsewhere: registers are not modelled)."""
    name: str
    query: tuple
    grid: tuple
    threads: int
    cluster: int
    smem_static: int
    smem_dynamic: int
    regs: Optional[int] = None

    @property
    def smem(self) -> int:
        """Shared-memory bytes a block: static plus dynamic."""
        return self.smem_static + self.smem_dynamic


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel call the meta route stood in for. `shape`: (M, K, N)
    for the GEMM, x's shape for fake-quant, (B, S, KVh, g, dh) for
    decode attention (S: the arena's rows, or the paged `seq_len`)."""
    kernel: str          # gemm_core | fake_quant.fwd | fake_quant.bwd |
    #                      decode_attn | paged_decode_attn
    variant: str         # gemm: small_m / tc / simt; paged: page storage
    epilogue: str        # gemm: the epilogue's name
    shape: tuple
    nbytes: int
    flops: int
    # the resolved plan: (strip, cluster, k_slice) small-M, (bm,)
    # tensor-core, () SIMT; (n_splits, R) decode attention; (blocks, head)
    # and (rows,) fake-quant forward and backward
    plan: tuple = ()
    kernels: tuple = ()          # Kernel, in launch order
    tuned: bool = False          # the plan came from `kernels.autotune`
    route: str = "meta"          # the device type of the call

    @property
    def key(self) -> tuple:
        """How the card's tallies count the launch: (variant, epilogue, K,
        N) for a GEMM (`chip_smoke.py`'s `_gemm_shape_tally`), (direction,
        shape) for fake-quant, (kernel, variant) otherwise."""
        if self.kernel == "gemm_core":
            return (self.variant, self.epilogue, self.shape[1],
                    self.shape[2])
        if self.kernel.startswith("fake_quant"):
            return (self.kernel.split(".")[1], self.shape)
        return (self.kernel, self.variant)


LOG: list[Launch] = []


def launch(kernel: str, variant: str, epilogue: str, shape, nbytes: int,
           flops: int, **fields) -> Launch:
    """A `Launch` with its counts as ints (`fields`: plan, kernels, tuned,
    route)."""
    return Launch(kernel, variant, epilogue, tuple(int(s) for s in shape),
                  int(nbytes), int(flops), **fields)


def take() -> list[Launch]:
    """The launches recorded since the last `take`, and a fresh log."""
    out = list(LOG)
    LOG.clear()
    return out


def tally(launches) -> collections.Counter:
    """Launches counted by `Launch.key`."""
    return collections.Counter(launch.key for launch in launches)

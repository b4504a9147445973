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
"""
from __future__ import annotations

import collections
import dataclasses


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


def record(kernel: str, variant: str, epilogue: str, shape, nbytes: int,
           flops: int) -> None:
    LOG.append(Launch(kernel, variant, epilogue,
                      tuple(int(s) for s in shape), int(nbytes), int(flops)))


def take() -> list[Launch]:
    """The launches recorded since the last `take`, and a fresh log."""
    out = list(LOG)
    LOG.clear()
    return out


def tally(launches) -> collections.Counter:
    """Launches counted by `Launch.key`."""
    return collections.Counter(launch.key for launch in launches)

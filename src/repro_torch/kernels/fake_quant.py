"""Fake-quant forward and backward kernels (paper Eqs 1-2 and 4-6).

Port of `repro.kernels.fake_quant`. `fake_quant_fwd` and `fake_quant_bwd`
decide by device: a CPU tensor goes to the plain PyTorch versions
(`ref.fake_quant_fwd_ref` / `ref.fake_quant_bwd_ref`); a CUDA tensor goes
to the hand-written kernels in `csrc/fake_quant.cu`, or raises if the
library did not build or the launch failed; a meta tensor records the
launch and computes nothing (`kernels.meta`). There is no fallback.

Each call is one kernel launch. The backward reduces its three scalar
sums without atomics: every block of `BWD_CHUNK` elements writes one
(dd, dq_m, dt) row, and the block that finishes last (picked by a ticket
counter kept here per device and stream) folds the rows in a fixed order,
so the sums are the same bits run to run. The fold order depends on the
element count only (`bwd_rows`), never on the card.

`launches` counts wrapper calls that launched a kernel, by direction.
Only the CUDA path adds to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, meta, ref

FWD, BWD = "fwd", "bwd"
BWD_CHUNK = 8192          # elements per backward block (csrc kChunk)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {FWD: 0, BWD: 0}
_tickets: dict = {}       # (device index, stream) -> int32 counter at 0


def _check_cuda(what: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]};"
                         f" the kernel takes CUDA tensors on one device")
    for t in tensors:
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"{what}: dtype {t.dtype} is not f32 or bf16")


def bwd_rows(n: int) -> int:
    """Blocks of the backward kernel, each one partial-sum row: a function
    of the element count alone."""
    if n <= 0:
        raise ValueError(f"fake_quant_bwd: {n} elements")
    return -(-n // BWD_CHUNK)


def empty_coaligned(x: torch.Tensor) -> torch.Tensor:
    """An uninitialized contiguous tensor like x whose address lies as far
    past a 16-byte boundary as x's, so that one vector loop reads x and
    writes it (x may be a view that starts at any element)."""
    off = x.data_ptr() % 16 // x.element_size()
    if off == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape)


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _tickets[key]


def fake_quant_fwd(x: torch.Tensor, d, q_m, t) -> torch.Tensor:
    """y = d * round(clip^t(|x|) / d) * sgn(x) in x's dtype; any shape."""
    if x.device.type == "cpu":
        return ref.fake_quant_fwd_ref(x, d, q_m, t)
    if x.device.type == "meta":
        meta.record("fake_quant.fwd", "", "", x.shape, fwd_bytes(x), 0)
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    _check_cuda("fake_quant_fwd", x)
    dev = x.device
    x = x.contiguous()
    y = empty_coaligned(x)
    d, q_m, t = (build.device_scalar(v, dev) for v in (d, q_m, t))
    err = build.load().repro_fake_quant_fwd(
        x.data_ptr(), _DTYPE_CODE[x.dtype], y.data_ptr(), x.numel(),
        d.data_ptr(), q_m.data_ptr(), t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fake_quant_fwd (n={x.numel()})")
    launches[FWD] += 1
    return y


def fake_quant_bwd(x: torch.Tensor, d, q_m, t, g: torch.Tensor):
    """(dx in x's dtype, dd, dq_m, dt as f32 0-d tensors) for the
    cotangent g of fake_quant(x; d, q_m, t)."""
    if x.shape != g.shape:
        raise ValueError(f"fake_quant_bwd: x {tuple(x.shape)} vs g "
                         f"{tuple(g.shape)}")
    if x.device.type == "cpu":
        return ref.fake_quant_bwd_ref(x, d, q_m, t, g)
    if x.device.type == "meta":
        meta.record("fake_quant.bwd", "", "", x.shape, bwd_bytes(x, g), 0)
        s = torch.empty((), dtype=torch.float32, device="meta")
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                s, s.clone(), s.clone())
    _check_cuda("fake_quant_bwd", x, g)
    dev = x.device
    n = x.numel()
    rows = torch.empty((bwd_rows(n), 3), dtype=torch.float32, device=dev)
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    sums = torch.empty((3,), dtype=torch.float32, device=dev)
    d, q_m, t = (build.device_scalar(v, dev) for v in (d, q_m, t))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.load().repro_fake_quant_bwd(
        x.data_ptr(), _DTYPE_CODE[x.dtype], g.data_ptr(),
        _DTYPE_CODE[g.dtype], dx.data_ptr(), rows.data_ptr(),
        _ticket(dev, stream).data_ptr(), sums.data_ptr(), n, d.data_ptr(),
        q_m.data_ptr(), t.data_ptr(), stream)
    build.check(err, f"fake_quant_bwd (n={n})")
    launches[BWD] += 1
    return dx, sums[0], sums[1], sums[2]


def sum_scales(x: torch.Tensor, g: torch.Tensor, d, q_m, t) -> list[float]:
    """For each of the backward's three sums (dd, dq_m, dt), the sum over
    elements of |g| times the magnitude of that sum's Eq 4-6 term, in f64
    by blocks of 256 rows: the scale that two summation orders' difference
    is held against."""
    d, qm, t = (float(v) for v in (d, q_m, t))
    out = [0.0, 0.0, 0.0]
    for xr, gr in zip(x.split(256), g.split(256)):
        a, ga = xr.double().abs(), gr.double().abs()
        base = torch.where(a <= qm, a.clamp_min(1e-12), torch.full_like(a, qm))
        out[0] += float((ga * d).sum())
        out[1] += float((ga * torch.where(a <= qm, 0.0,
                                          t * qm ** (t - 1))).sum())
        out[2] += float((ga * (base ** t * base.log()).abs()).sum())
    return out


def fwd_bytes(x: torch.Tensor) -> int:
    """Bytes the forward must move: x read, y written, three scalars."""
    return 2 * x.numel() * x.element_size() + 12


def bwd_bytes(x: torch.Tensor, g: torch.Tensor) -> int:
    """Bytes the backward must move: x and g read, dx written, three
    scalars read and three sums written."""
    return (2 * x.numel() * x.element_size() + g.numel() * g.element_size()
            + 24)

"""Learnable quantization with parameters (d, q_m, t) — paper §3, Eqs (1)-(6).

Port of `repro.core.quant` on torch tensors:

    x~  = sgn(x) * clip_{q_m}^t(|x|)                                (Eq 1)
    x_Q = d * round(x~ / d)                                         (Eq 2)
    b   = log2((q_m)^t / d + 1) + 1                                 (Eq 3)

`fake_quant` is a `torch.autograd.Function` whose backward is the
straight-through estimator: dx passes g inside the clip and 0 outside, and
(d, q_m, t) get the sums of Eqs (4)-(6). Both directions go through
`kernels.fake_quant`, which launches the CUDA kernels for a CUDA tensor
and runs their plain versions (`kernels.ref`) for a CPU one. The PPSG
helpers (`step_size_bounds`, `project_step_size`, `positivity_guard`) and
the Eq 14 `residual` serve QASSO.

Also the deployment containers: clamped integer codes (`quantize_int`),
the K-packed sub-byte int32 word streams (`pack_codes` / `unpack_codes`),
and the per-row int8/int4 codes of the paged KV arena
(`kv_quant_encode` / `kv_quant_decode`).
Every function runs in float32 with the same operation order as the JAX
module, so codes, containers and packed words come out bit-equal to it.
`torch.round` rounds half to even, like `jnp.round`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# Numerical guard: t and q_m pass through powers and logs.
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Per-tensor learnable quantizer: three float32 0-d tensors."""

    d: torch.Tensor     # quantization step size  (> 0)
    q_m: torch.Tensor   # clip maximum            (> 0)
    t: torch.Tensor     # shaping exponent        (> 0), t=1 -> uniform


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def init_quant_params(w: torch.Tensor | None = None, *, q_m=None,
                      bits: float = 32.0, t: float = 1.0) -> QuantParams:
    """Paper Appendix C initialization: t = 1, q_m = max|W|, d chosen so the
    derived bit width equals `bits`."""
    device = w.device if w is not None else None
    if q_m is None:
        if w is None:
            raise ValueError("need either a weight tensor or explicit q_m")
        q_m = torch.clamp_min(w.abs().max().to(torch.float32), 1e-3)
    q_m = _f32(q_m, device)
    t_arr = _f32(t, q_m.device)
    d = step_size_for_bits(q_m, t_arr, _f32(bits, q_m.device))
    return QuantParams(d=d, q_m=q_m, t=t_arr)


def bit_width(d: torch.Tensor, q_m: torch.Tensor, t: torch.Tensor
              ) -> torch.Tensor:
    """Eq (3): b = log2((q_m)^t / d + 1) + 1."""
    peak = torch.pow(torch.clamp_min(q_m, _EPS), t)
    return torch.log2(peak / torch.clamp_min(d, _EPS) + 1.0) + 1.0


def step_size_for_bits(q_m: torch.Tensor, t: torch.Tensor,
                       bits: torch.Tensor) -> torch.Tensor:
    """Invert Eq (3): the d that realizes a given bit width."""
    peak = torch.pow(torch.clamp_min(q_m, _EPS), t)
    return peak / (torch.exp2(bits - 1.0) - 1.0)


def clip_qmt(x_abs: torch.Tensor, q_m: torch.Tensor, t: torch.Tensor
             ) -> torch.Tensor:
    """clip_{q_m}^t(|x|) of Eq (13), in the `power` form: the exp/log form
    rounds differently and flips round ties by a whole step of d."""
    q_m = torch.clamp_min(q_m, _EPS)
    a = torch.minimum(x_abs, q_m)
    return torch.pow(torch.clamp_min(a, _EPS), t) * (x_abs > 0)


def step_size_bounds(q_m: torch.Tensor, t: torch.Tensor, b_l: torch.Tensor,
                     b_u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[d_min, d_max] such that b in [b_l, b_u] (Alg 3 line 3): b falls as
    d grows, so b <= b_u <=> d >= d(b_u) and b >= b_l <=> d <= d(b_l)."""
    return step_size_for_bits(q_m, t, b_u), step_size_for_bits(q_m, t, b_l)


def residual(x_abs: torch.Tensor, d: torch.Tensor, q_m: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """R(x) of Eq (14): round(x~/d) - x~/d for the clipped magnitude."""
    r = clip_qmt(x_abs, q_m, t) / torch.clamp_min(d, _EPS)
    return torch.round(r) - r


class _FakeQuant(torch.autograd.Function):
    """Eqs (1)-(2) forward, STE + Eqs (4)-(6) backward, each one call of
    a `kernels.fake_quant` wrapper."""

    @staticmethod
    def forward(ctx, x, d, q_m, t):
        from repro_torch.kernels import fake_quant as _fq
        ctx.save_for_backward(x, d, q_m, t)
        return _fq.fake_quant_fwd(x, d, q_m, t)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import fake_quant as _fq
        x, d, q_m, t = ctx.saved_tensors
        dx, dd, dqm, dt = _fq.fake_quant_bwd(x, d, q_m, t, g)
        return (dx, dd.reshape(d.shape), dqm.reshape(q_m.shape),
                dt.reshape(t.shape))


def fake_quant(x: torch.Tensor, d, q_m, t) -> torch.Tensor:
    """Differentiable quantize-dequantize with learnable (d, q_m, t):
    x_Q in x's dtype, computed in f32. Scalars that are not tensors
    become f32 tensors on x's device."""
    d, q_m, t = (v if torch.is_tensor(v) else _f32(v, x.device)
                 for v in (d, q_m, t))
    return _FakeQuant.apply(x, d, q_m, t)


def quantize_int(x: torch.Tensor, qp: QuantParams, bits=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Deployment-path quantization: f32 integer-valued codes + scale d.

    Codes are clamped to the symmetric range of the ceil(bits)-wide
    container, ±(2^(ceil(b)-1)-1), so a code that rounds onto 2^(b-1) at
    the bit-constraint boundary cannot wrap in the narrow integer cast.
    `bits` overrides the derived width (default: Eq 3 on `qp`)."""
    d32 = torch.clamp_min(qp.d.to(torch.float32), _EPS)
    sign = torch.sign(x).to(torch.float32)
    xt = clip_qmt(x.abs().to(torch.float32), qp.q_m, qp.t)
    codes = torch.round(xt / d32) * sign
    b = bit_width(qp.d, qp.q_m, qp.t) if bits is None \
        else _f32(bits, codes.device)
    cmax = torch.exp2(torch.ceil(b) - 1.0) - 1.0
    codes = torch.clamp(codes, -cmax, cmax)
    return codes, d32


# ------------------------------------------------------- sub-byte packing
# Storage widths the packed serving path realizes; a learned width between
# two entries rounds up to the next one, widths above 8 stay unpacked.
PACKED_STORAGE_BITS = (2, 3, 4, 8)


def packed_storage_bits(bits: float) -> int | None:
    """Packed container width for a learned bit width, or None if the
    codes need more than 8 bits."""
    nb = int(math.ceil(float(torch.tensor(float(bits), dtype=torch.float32))))
    for cand in PACKED_STORAGE_BITS:
        if nb <= cand:
            return cand
    return None


def codes_per_word(bits: int) -> int:
    if not 2 <= int(bits) <= 8:
        raise ValueError(f"packed bits must be in [2, 8], got {bits}")
    return 32 // int(bits)


def pack_codes(codes: torch.Tensor, bits: int, *, axis: int = 0
               ) -> torch.Tensor:
    """Bit-pack signed integer codes into an int32 word stream.

    Each word holds ``32 // bits`` codes as ``bits``-wide two's-complement
    fields, least-significant field first, packed along `axis` (the GEMM K
    axis for weights). A trailing partial word is zero-padded. The fields
    are disjoint, so the words are an OR over the shifted fields — an
    int32 OR-reduce, because `torch.sum` of int32 widens to int64."""
    bits = int(bits)
    cpw = codes_per_word(bits)
    c = torch.movedim(codes, axis, 0).to(torch.int32)
    pad = (-c.shape[0]) % cpw
    if pad:
        c = torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
    mask = (1 << bits) - 1
    c = (c & mask).reshape((c.shape[0] // cpw, cpw) + tuple(c.shape[1:]))
    words = torch.zeros((c.shape[0],) + tuple(c.shape[2:]), dtype=torch.int32,
                        device=c.device)
    for j in range(cpw):
        # shifting into the sign bit wraps in int32, as the JAX word sum does
        words |= c[:, j] << (j * bits)
    return torch.movedim(words, 0, axis).contiguous()


def unpack_codes(packed: torch.Tensor, bits: int, size: int, *,
                 axis: int = 0) -> torch.Tensor:
    """Invert `pack_codes`: int32 words -> sign-extended int32 codes, the
    zero-filled tail sliced off at `size` codes along `axis`."""
    bits = int(bits)
    cpw = codes_per_word(bits)
    w = torch.movedim(packed.to(torch.int32), axis, 0)
    shifts = (torch.arange(cpw, dtype=torch.int32, device=w.device) * bits
              ).reshape((1, cpw) + (1,) * (w.ndim - 1))
    mask = (1 << bits) - 1
    vals = (w[:, None] >> shifts) & mask
    sgn = 1 << (bits - 1)
    vals = (vals ^ sgn) - sgn
    out = vals.reshape((w.shape[0] * cpw,) + tuple(w.shape[1:]))[:size]
    return torch.movedim(out, 0, axis).contiguous()


# ------------------------------------------------------------ KV page codes
# Storage widths the paged KV arena can hold codes at. Weight containers
# pack along the GEMM K axis into int32 words (`pack_codes`); KV pages pack
# along d_head into int8 bytes, so the kernel's nibble unpack is a shift.
KV_STORAGE_BITS = (4, 8)


def _check_kv_bits(bits) -> int:
    bits = int(bits)
    if bits not in KV_STORAGE_BITS:
        raise ValueError(f"kv bits must be one of {KV_STORAGE_BITS}, "
                         f"got {bits}")
    return bits


def kv_quant_encode(x: torch.Tensor, bits: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric absmax quantization of KV-cache rows.

    x: (..., dh) float rows. Returns (codes int8, scale f32 (...,)) with
    scale = absmax / qmax per row, so every row encodes on its own (a new
    decode row never rescales its page). All-zero rows give codes 0 and
    scale 0, which decode to exact zeros. bits=4 packs code pairs along
    the last axis into (..., dh // 2) bytes, low nibble first."""
    bits = _check_kv_bits(bits)
    qmax = (1 << (bits - 1)) - 1
    x32 = x.to(torch.float32)
    scale = torch.amax(torch.abs(x32), dim=-1) / qmax
    d = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(x32 / d[..., None]), -qmax, qmax
                        ).to(torch.int32)
    if bits == 4:
        if x32.shape[-1] % 2:
            raise ValueError(f"kv bits=4 packs code pairs; d_head="
                             f"{x32.shape[-1]} must be even")
        # the byte (c0 & 0xF) | (c1 & 0xF) << 4, as JAX's int32 -> int8
        # cast wraps it, is the signed value c1 * 16 + (c0 & 0xF), which
        # lies in [-112, 127]: no wrap needed
        codes = (codes[..., 1::2] << 4) | (codes[..., 0::2] & 0xF)
    return codes.to(torch.int8), scale


def kv_quant_decode(codes: torch.Tensor, scale: torch.Tensor, bits: int
                    ) -> torch.Tensor:
    """Invert `kv_quant_encode`: int8 codes and per-row scales to f32 rows
    (exact zeros for zero rows)."""
    bits = _check_kv_bits(bits)
    w = codes.to(torch.int32)
    if bits == 4:
        lo = ((w & 0xF) ^ 8) - 8            # sign-extend the low nibble
        hi = (((w >> 4) & 0xF) ^ 8) - 8     # then the high one
        w = torch.stack([lo, hi], dim=-1).reshape(
            w.shape[:-1] + (w.shape[-1] * 2,))
    return w.to(torch.float32) * scale[..., None].to(torch.float32)


def project_step_size(qp: QuantParams, b_l, b_u) -> QuantParams:
    """PPSG projection (Alg 3 lines 3-4): clamp d into [d_min, d_max].
    Only d moves; q_m and t stay (paper §5.1)."""
    d_min, d_max = step_size_bounds(qp.q_m, qp.t, _f32(b_l, qp.d.device),
                                    _f32(b_u, qp.d.device))
    return QuantParams(d=torch.minimum(torch.maximum(qp.d, d_min), d_max),
                       q_m=qp.q_m, t=qp.t)


def positivity_guard(qp: QuantParams) -> QuantParams:
    """Keep the parameterization in its open domain after an SGD step."""
    return QuantParams(d=torch.clamp_min(qp.d, 1e-8),
                       q_m=torch.clamp_min(qp.q_m, 1e-6),
                       t=torch.clamp(qp.t, 0.05, 4.0))

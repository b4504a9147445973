"""Compressed serving artifacts without pruning: port of the keep-all
subset of `repro.core.subnet`.

`compress_lm` replaces every routed projection weight of an LM with
integer codes plus a scale (or, with `packed=True`, with K-packed sub-byte
int32 word streams); `servable_params` flattens the result into the
`dense_proj` param-dict convention (`<name>.codes` / `<name>.packed{bits}`
+ `<name>.scale`); `prepare_serving` resolves the (params, qparams) pair
every serving entry point decodes with. Codes and packed words are
bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quant import (QuantParams, bit_width, pack_codes,
                                    packed_storage_bits, quantize_int)
from repro_torch.models.layers import ROUTED_COMPONENTS


def tree_bytes(tree: dict) -> int:
    """Bytes a dict of tensors occupies."""
    return sum(t.numel() * t.element_size() for t in tree.values())


def _storage_dtype(bits: float) -> torch.dtype:
    nbits = int(np.ceil(bits))
    if nbits <= 8:
        return torch.int8
    if nbits <= 16:
        return torch.int16
    return torch.int32


@dataclasses.dataclass
class Subnet:
    params: dict[str, torch.Tensor]         # params kept dense
    int_weights: dict[str, torch.Tensor]    # name -> codes or packed words
    scales: dict[str, torch.Tensor]         # name -> step size d
    bits: dict[str, float]                  # site name -> bit width
    kept_units: dict[str, np.ndarray]
    meta: dict[str, Any]
    # name -> packed storage width for entries of `int_weights` that are
    # K-packed int32 word streams; empty for an unpacked subnet
    packed_bits: dict[str, int] = dataclasses.field(default_factory=dict)


def _mean_storage_bits(bits: dict[str, float]) -> float:
    if not bits:
        return 32.0
    return float(np.mean([np.ceil(b) for b in bits.values()]))


def _routed(name: str) -> bool:
    """True if the model executes this weight through `dense_proj`."""
    if name == "head":
        return True
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] in ROUTED_COMPONENTS


def compress_lm(lm, params: dict, qparams: dict, *,
                packed: bool = False) -> Subnet:
    """Quantize an LM's routed projection weights to int codes (keep-all).

    Each site stores its codes in the narrowest int container of its
    learned width; with `packed`, codes of sites at <= 8 bits bit-pack
    along K at the narrowest of (2, 3, 4, 8) that holds them."""
    int_weights: dict[str, torch.Tensor] = {}
    scales: dict[str, torch.Tensor] = {}
    bits: dict[str, float] = {}
    packed_bits: dict[str, int] = {}
    dense = dict(params)
    dense_bytes = quant_bytes = unpacked_bytes = 0
    skipped: list[str] = []
    for name in lm.quant_weight_names():
        site = name + ".wq"
        if name not in params or site not in qparams:
            continue
        if not _routed(name):
            skipped.append(name)
            continue
        qp: QuantParams = qparams[site]
        b = float(bit_width(qp.d, qp.q_m, qp.t))
        codes, d = quantize_int(params[name], qp, bits=b)
        store = codes.to(_storage_dtype(b))
        unpacked_bytes += store.numel() * store.element_size()
        sb = packed_storage_bits(b) if packed else None
        if sb is not None:
            store = pack_codes(codes, sb, axis=-2)
            packed_bits[name] = sb
        int_weights[name] = store
        scales[name] = d
        bits[site] = b
        dense_bytes += params[name].numel() * params[name].element_size()
        quant_bytes += store.numel() * store.element_size()
        dense.pop(name)
    meta = {
        "mean_bits": float(np.mean(list(bits.values()))) if bits else 32.0,
        "mean_storage_bits": _mean_storage_bits(bits),
        "n_sites": len(bits),
        "weight_bytes_dense": dense_bytes,
        "weight_bytes_compressed": quant_bytes,
        "skipped_sites": skipped,
    }
    if packed:
        meta["weight_bytes_unpacked"] = unpacked_bytes
        meta["packed_sites"] = dict(packed_bits)
    return Subnet(params=dense, int_weights=int_weights, scales=scales,
                  bits=bits, kept_units={}, meta=meta,
                  packed_bits=packed_bits)


def residual_qparams(subnet: Subnet, qparams: dict) -> Optional[dict]:
    """Quant sites for the weights the compressed decode keeps dense."""

    def executes_from_codes(site: str) -> bool:
        if not site.endswith(".wq"):
            return False
        name = site[:-len(".wq")]
        return name in subnet.int_weights and _routed(name)

    out = {site: qp for site, qp in qparams.items()
           if not executes_from_codes(site)}
    return out or None


def servable_params(subnet: Subnet) -> dict:
    """Flatten a Subnet into the `dense_proj` param-dict convention: codes
    as `<name>.codes`, packed words as `<name>.packed{bits}`, each with
    `<name>.scale` (one per layer for stacked block weights)."""
    out = dict(subnet.params)
    for name, codes in subnet.int_weights.items():
        if not _routed(name):
            continue
        scale = subnet.scales[name]
        if codes.ndim >= 3 and scale.ndim == 0:
            scale = scale.expand(codes.shape[:1]).clone()
        out.pop(name, None)
        sb = subnet.packed_bits.get(name)
        key = f"{name}.packed{sb}" if sb is not None else name + ".codes"
        out[key] = codes
        out[name + ".scale"] = scale
    return out


def prepare_serving(lm, params: dict, qparams: Optional[dict] = None, *,
                    quantized: bool = True, compressed: bool = False,
                    packed: bool = False, bits_init: float = 8.0
                    ) -> tuple[dict, Optional[dict], dict[str, Any]]:
    """Resolve the (params, qparams, meta) every serving entry point
    decodes with. Dense: quantizer sites applied as fake-quant. Compressed
    (implied by `packed`): routed projections become int codes (packed
    words with `packed`), and `residual_qparams` keeps fake-quant sites
    for the weights that stay dense. Pruned serving comes with slim
    serving (ROADMAP Queue 1 item 8)."""
    compressed = compressed or packed
    if qparams is None and (quantized or compressed):
        qparams = lm.init_qparams(params, bits_init=bits_init)
    if not (quantized or compressed):
        qparams = None
    meta: dict[str, Any] = {}
    if compressed:
        subnet = compress_lm(lm, params, qparams, packed=packed)
        meta.update(subnet.meta)
        params = servable_params(subnet)
        qparams = residual_qparams(subnet, qparams)
    meta["param_bytes"] = tree_bytes(params)
    return params, qparams, meta


def compression_report(arch: str, meta: dict) -> str:
    """One-line summary of a `prepare_serving` meta dict."""
    mib = 2 ** 20
    parts = []
    if meta.get("n_sites"):
        parts.append(f"compressed {meta['n_sites']} sites to "
                     f"{meta['mean_bits']:.1f} mean bits "
                     f"({meta.get('mean_storage_bits', 8.0):.1f} storage) "
                     f"({meta['weight_bytes_dense'] / mib:.1f} MiB -> "
                     f"{meta['weight_bytes_compressed'] / mib:.1f} MiB)")
    if meta.get("packed_sites"):
        parts.append(f"{len(meta['packed_sites'])} sites sub-byte packed "
                     f"({meta['weight_bytes_unpacked'] / mib:.1f} MiB "
                     f"unpacked -> "
                     f"{meta['weight_bytes_compressed'] / mib:.1f} MiB)")
    if meta.get("skipped_sites"):
        parts.append(f"{len(meta['skipped_sites'])} non-routed sites "
                     f"kept dense")
    if "param_bytes" in meta:
        parts.append(f"served params {meta['param_bytes'] / mib:.2f} MiB")
    if "kv_bytes" in meta:
        parts.append(f"KV arena {meta['kv_bytes'] / mib:.2f} MiB")
    return f"{arch}: " + "; ".join(parts or ["no compression applied"])

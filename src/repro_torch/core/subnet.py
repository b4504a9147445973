"""construct_subnet(): the pruned and quantized deployable model, and the
serving artifacts built from it. Port of `repro.core.subnet`.

`construct_subnet` (the paper's Framework Usage line 8) slices away the
pruned units of a trained model (`PruningSpace.materialize`) and turns
every weight site into integer codes at its learned width. For an LM,
`prune_lm` slices it to keep masks (trained, or `magnitude_keep_masks`
at a target sparsity) and installs the `SlimPlan` of the surviving
widths (`derive_slim_plan`, `LM.apply_slim_plan`); `masked_reference_params`
is the same model with the pruned units multiplied by zero instead, the
oracle the sliced model is held to token for token.

`compress_lm` replaces every routed projection weight of an LM with
integer codes plus a scale (or, with `packed=True`, with K-packed sub-byte
int32 word streams); `servable_params` flattens the result into the
`dense_proj` param-dict convention (`<name>.codes` / `<name>.packed{bits}`
+ `<name>.scale`); `prepare_serving` resolves the (params, qparams) pair
every serving entry point decodes with, pruned (`keep_masks`,
`prune_sparsity`) or not. Masks, kept units, sliced params, codes and
packed words are equal to the JAX package's.

Pruned widths leave weights whose rows are not 16-byte multiples (d_ff
8192 at sparsity 0.3 keeps 5734 units). `prepare_serving` stores every
such served weight with its rows padded to 16 bytes
(`kernels.gemm_core.aligned_rows`), once, so the GEMM kernels load it in
whole chunks and TMA reads it in place; its logical shape and values are
unchanged, and `param_bytes` counts the logical tensors as the reference
does (`param_alloc_bytes` counts the allocations beside it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.qadg import QADG, build_qadg
from repro_torch.core.quant import (QuantParams, bit_width, pack_codes,
                                    packed_storage_bits, quantize_int)
from repro_torch.kernels.gemm_core import aligned_rows
from repro_torch.models.layers import (PACKED_PARAM_BITS, ROUTED_COMPONENTS,
                                       LayerShapes)


def tree_bytes(tree: dict) -> int:
    """Bytes a dict of tensors holds: numel x itemsize of each logical
    tensor, the reference's count."""
    return sum(t.numel() * t.element_size() for t in tree.values())


def alloc_bytes(tree: dict) -> int:
    """Bytes the allocations behind a dict of tensors occupy, each storage
    once: `tree_bytes` plus the padding of rows stored 16-byte aligned."""
    seen = {}
    for t in tree.values():
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _storage_dtype(bits: float) -> torch.dtype:
    nbits = int(np.ceil(bits))
    if nbits <= 8:
        return torch.int8
    if nbits <= 16:
        return torch.int16
    return torch.int32


@dataclasses.dataclass
class Subnet:
    params: dict[str, torch.Tensor]         # sliced (or kept dense) params
    int_weights: dict[str, torch.Tensor]    # name -> codes or packed words
    scales: dict[str, torch.Tensor]         # name -> step size d
    bits: dict[str, float]                  # site name -> bit width
    kept_units: dict[str, np.ndarray]       # family -> surviving unit ids
    meta: dict[str, Any]
    # name -> packed storage width for entries of `int_weights` that are
    # K-packed int32 word streams; empty for an unpacked subnet
    packed_bits: dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SlimPlan:
    """Per-sublayer physical shapes of a pruned LM: one `LayerShapes` per
    position-in-period (aligned with `LM.plan`), which `LM.apply_slim_plan`
    installs so prefill, decode and the KV arenas run at the sliced widths.
    Every layer of a stack shares its position's shapes (per-stack
    pruning), so the engine's window graphs stay one set per engine."""
    layer_shapes: list[LayerShapes]
    kept_units: dict[str, np.ndarray]       # family -> surviving unit ids
    sparsity: float                         # realized over prunable units
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def construct_subnet(qadg: QADG, params: dict, qparams: dict,
                     keep_masks: dict) -> Subnet:
    """Slice away the pruned units and quantize every weight site of the
    sliced params to integer codes at its learned width, in the narrowest
    int container that holds them. Returns the Subnet: sliced params,
    codes, scales, per-site bits, kept units and `meta` (realized
    sparsity, mean bits, mean storage bits, site count)."""
    sliced, kept = qadg.space.materialize(params, keep_masks)
    int_weights: dict[str, torch.Tensor] = {}
    scales: dict[str, torch.Tensor] = {}
    bits: dict[str, float] = {}
    for site in qadg.sites:
        qp: QuantParams = qparams[site.name]
        b = float(bit_width(qp.d, qp.q_m, qp.t))
        bits[site.name] = b
        if site.kind != "weight":
            continue
        for pname in site.quantized_params:
            if pname not in sliced:
                continue
            codes, d = quantize_int(sliced[pname], qp, bits=b)
            int_weights[pname] = codes.to(_storage_dtype(b))
            scales[pname] = d
    n_total = qadg.space.total_units()
    n_kept = sum(int(torch.sum(keep_masks[f.name] > 0.5))
                 for f in qadg.space.prunable_families())
    return Subnet(
        params=sliced, int_weights=int_weights, scales=scales, bits=bits,
        kept_units=kept,
        meta={"sparsity": 1.0 - n_kept / max(n_total, 1),
              "mean_bits": (float(np.mean(list(bits.values())))
                            if bits else 32.0),
              "mean_storage_bits": _mean_storage_bits(bits),
              "n_sites": len(qadg.sites)})


def _mean_storage_bits(bits: dict[str, float]) -> float:
    if not bits:
        return 32.0
    return float(np.mean([np.ceil(b) for b in bits.values()]))


# ------------------------------------------------------------- slim plan
def _check_family(kept_units: dict, fam: str, got: int, unit: int = 1,
                  what: str = "") -> None:
    kept = kept_units.get(fam)
    if kept is not None and len(kept) * unit != got:
        raise ValueError(
            f"slim plan: family {fam} keeps {len(kept)} units "
            f"(x{unit}) but the sliced {what or 'param'} has width {got}")


def derive_slim_plan(lm, params: dict, kept_units: dict[str, np.ndarray],
                     sparsity: float = 0.0) -> SlimPlan:
    """The per-sublayer execution shapes of a sliced LM. The sliced
    tensors (`PruningSpace.materialize` output) set each width (surviving
    KV-head groups x gqa_group heads, MLP hidden units, experts, mamba
    inner channels, rwkv6 heads and channel-mix hidden units),
    cross-checked against `kept_units` wherever a family names the axis;
    the residual width is pinned by the non-prunable embed and head and
    stays d_model."""
    cfg = lm.cfg

    def dim(name: str) -> int:
        return int(params[name].shape[-1])

    shapes = []
    for sub in lm.plan:
        pre = f"blocks.{sub.j}"
        kw: dict[str, int] = {}
        if sub.mixer == "attn":
            q_dim, kv_dim = dim(f"{pre}.attn.wq"), dim(f"{pre}.attn.wk")
            if q_dim % cfg.d_head or kv_dim % cfg.d_head:
                raise ValueError(
                    f"{pre}.attn: sliced q/kv widths {q_dim}/{kv_dim} are "
                    f"not multiples of d_head={cfg.d_head}: the kv-group "
                    f"family must remove whole heads")
            kw.update(n_heads=q_dim // cfg.d_head,
                      n_kv_heads=kv_dim // cfg.d_head)
            _check_family(kept_units, f"{pre}.attn.kv_groups",
                          kw["n_heads"], cfg.gqa_group, "wq head count")
        elif sub.mixer == "mamba":
            kw.update(mamba_inner=dim(f"{pre}.mamba.in_proj_x"))
            _check_family(kept_units, f"{pre}.mamba.channels",
                          kw["mamba_inner"], 1, "in_proj_x")
        else:
            hw = dim(f"{pre}.rwkv.wr")
            if hw % cfg.rwkv.head_size:
                raise ValueError(
                    f"{pre}.rwkv: sliced width {hw} is not a multiple of "
                    f"head_size={cfg.rwkv.head_size}")
            kw.update(rwkv_heads=hw // cfg.rwkv.head_size)
            _check_family(kept_units, f"{pre}.rwkv.heads",
                          kw["rwkv_heads"], 1, "wr head count")
        if sub.ffn == "moe":
            kw["n_experts"] = dim(f"{pre}.moe.router")
            _check_family(kept_units, f"{pre}.moe.experts", kw["n_experts"],
                          1, "router")
        elif sub.ffn == "mlp":
            kw["d_ff"] = dim(f"{pre}.mlp.w_gate")
            for fam in kept_units:
                # the MLP hidden space is a generic dependency-analysis
                # family: "space.<sid>.blocks.<j>.mlp.gate"
                if fam.endswith(f".{pre}.mlp.gate"):
                    _check_family(kept_units, fam, kw["d_ff"], 1, "w_gate")
        elif sub.ffn == "chanmix":
            kw["cm_hidden"] = dim(f"{pre}.rwkv.cm_k")
            _check_family(kept_units, f"{pre}.rwkv.cm_hidden",
                          kw["cm_hidden"], 1, "cm_k")
        shapes.append(dataclasses.replace(LayerShapes.from_config(cfg), **kw))
    return SlimPlan(layer_shapes=shapes, kept_units=dict(kept_units),
                    sparsity=float(sparsity))


def default_min_keep(cfg) -> dict[str, int]:
    """Per-family-kind keep floors for serving-side masks: at least one
    unit everywhere, and never fewer experts than the router's top_k."""
    floors = {"head_group": 1, "channel": 1, "state": 1}
    if cfg.moe is not None:
        floors["expert"] = cfg.moe.top_k
    return floors


def magnitude_keep_masks(space, params: dict, sparsity: float, *,
                         min_keep: Optional[dict[str, int]] = None
                         ) -> dict[str, torch.Tensor]:
    """Deterministic keep masks at a target sparsity: per prunable family,
    keep the top-(1-s) units by group L2 magnitude (f32, on the params'
    device), the serving-side stand-in for a trained QASSO mask. Ties
    break by unit index (a stable sort), so the same params always give
    the same masks. The scores reduce each member in chunks
    (`PruningSpace.group_sq_norms`): a full-width expert family needs no
    f32 copy of its stacks. Returns (units,) f32 masks on the params'
    device."""
    min_keep = dict(min_keep or {})
    masks = {}
    for fam in space.prunable_families():
        score = torch.sqrt(space.group_sq_norms(params, fam)).cpu().numpy()
        floor = max(int(min_keep.get(fam.kind, 1)), 1)
        n_keep = int(np.clip(fam.units - round(sparsity * fam.units),
                             floor, fam.units))
        keep = np.sort(np.argsort(-score, kind="stable")[:n_keep])
        m = np.zeros((fam.units,), np.float32)
        m[keep] = 1.0
        dev = params[fam.members[0].param].device
        masks[fam.name] = torch.from_numpy(m).to(dev)
    return masks


def resolve_keep_masks(lm, params: dict, sparsity: float):
    """The one mask recipe of the pruned path and of its masked reference:
    QADG and magnitude masks with the default floors, so both sides
    compare against the same masks. Returns (qadg, masks)."""
    qadg = build_qadg(lm.build_graph().graph)
    masks = magnitude_keep_masks(qadg.space, params, sparsity,
                                 min_keep=default_min_keep(lm.cfg))
    return qadg, masks


def masked_reference_params(lm, params: dict, sparsity: float, *,
                            quantized: bool = True):
    """The dense model with its pruned groups exactly zero, as QASSO's
    cool-down leaves a GETA checkpoint: the pruned path's oracle. The
    quantizers are resolved on the unmasked params, the order
    `prepare_serving` uses, so the scales equal the sliced model's.
    Returns (masked params, qparams)."""
    qparams = lm.init_qparams(params) if quantized else None
    qadg, masks = resolve_keep_masks(lm, params, sparsity)
    return qadg.space.apply_masks(params, masks), qparams


def prune_lm(lm, params: dict, *, keep_masks: Optional[dict] = None,
             sparsity: float = 0.5) -> tuple[dict, SlimPlan]:
    """Slice an LM to its pruned shapes: build the QADG, resolve keep
    masks (`keep_masks`, e.g. QASSO's, or magnitude masks at `sparsity`),
    materialize the sliced params and install the derived SlimPlan on
    `lm` (prefill, decode and the KV arenas then run at the sliced
    widths). Returns (sliced params, plan)."""
    if keep_masks is None:
        qadg, keep_masks = resolve_keep_masks(lm, params, sparsity)
    else:
        qadg = build_qadg(lm.build_graph().graph)
    sliced, kept = qadg.space.materialize(params, keep_masks)
    n_kept = sum(len(v) for v in kept.values())
    realized = 1.0 - n_kept / max(qadg.space.total_units(), 1)
    plan = derive_slim_plan(lm, sliced, kept, sparsity=realized)
    lm.apply_slim_plan(plan)
    return sliced, plan


# --------------------------------------------------------------- serving
def _routed(name: str) -> bool:
    """True if the model executes this weight through `dense_proj`."""
    if name == "head":
        return True
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] in ROUTED_COMPONENTS


def compress_lm(lm, params: dict, qparams: dict, *,
                packed: bool = False) -> Subnet:
    """Quantize an LM's routed projection weights to int codes (keep-all).
    A site the decode cannot run from codes (the MoE router and expert
    stacks) stays dense and is listed in `meta["skipped_sites"]`.

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


def _served_weight(key: str) -> bool:
    """A key of the served dict that a GEMM reads as its weight: a routed
    projection, or its codes or packed words."""
    for suffix in (".codes", *(f".packed{b}" for b in PACKED_PARAM_BITS)):
        if key.endswith(suffix):
            return _routed(key[:-len(suffix)])
    return _routed(key)


def prepare_serving(lm, params: dict, qparams: Optional[dict] = None, *,
                    quantized: bool = True, compressed: bool = False,
                    packed: bool = False, bits_init: float = 8.0,
                    keep_masks: Optional[dict] = None,
                    prune_sparsity: Optional[float] = None
                    ) -> tuple[dict, Optional[dict], dict[str, Any]]:
    """Resolve the (params, qparams, meta) every serving entry point
    decodes with. Dense: quantizer sites applied as fake-quant. Compressed
    (implied by `packed`): routed projections become int codes (packed
    words with `packed`), and `residual_qparams` keeps fake-quant sites
    for the weights that stay dense.

    Pruned: `keep_masks` (a trained QASSO mask dict) or `prune_sparsity`
    (magnitude masks) slices the model first (`prune_lm`, which installs
    the SlimPlan on `lm`). The quantizers are resolved before slicing, so
    the pruned model shares its scales with the masked reference; with
    `compressed` the sliced weights become codes at the pruned shapes.

    Every served weight whose rows are not 16-byte multiples is stored
    with its rows padded (`aligned_rows`): `param_bytes` counts the
    logical tensors, `param_alloc_bytes` the allocations."""
    compressed = compressed or packed
    if qparams is None and (quantized or compressed):
        qparams = lm.init_qparams(params, bits_init=bits_init)
    if not (quantized or compressed):
        qparams = None
    meta: dict[str, Any] = {}
    if keep_masks is not None or prune_sparsity is not None:
        params, plan = prune_lm(lm, params, keep_masks=keep_masks,
                                sparsity=(prune_sparsity or 0.0))
        meta["slim_plan"] = plan
        meta["sparsity"] = plan.sparsity
    if compressed:
        subnet = compress_lm(lm, params, qparams, packed=packed)
        for k, v in subnet.meta.items():
            meta.setdefault(k, v)     # the pruning path's keys win
        params = servable_params(subnet)
        qparams = residual_qparams(subnet, qparams)
    params = {k: aligned_rows(v) if v.ndim >= 2 and _served_weight(k) else v
              for k, v in params.items()}
    meta["param_bytes"] = tree_bytes(params)
    meta["param_alloc_bytes"] = alloc_bytes(params)
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
    # `is not None`: an explicit sparsity 0 ran the pruning path and says
    # so; compress-only metas carry no sparsity key
    if meta.get("sparsity") is not None:
        parts.append(f"pruned to sparsity {meta['sparsity']:.2f}")
    if "param_bytes" in meta:
        parts.append(f"served params {meta['param_bytes'] / mib:.2f} MiB")
    if "kv_bytes" in meta:
        parts.append(f"KV arena {meta['kv_bytes'] / mib:.2f} MiB")
    return f"{arch}: " + "; ".join(parts or ["no compression applied"])

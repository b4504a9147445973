"""BOPs (bit operations) accounting, port of `repro.core.bops` (paper §6).

BOPs of a layer = MACs * b_w * b_a, where b_w / b_a are the weight /
activation bit widths feeding that layer. Structured pruning reduces MACs;
quantization reduces b_w (and b_a when activation quantizers are attached).
Reported relative to the full-precision (32 x 32) baseline, the quantity
in the paper's tables. Every number is a Python float.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.qadg import QADG
from repro_torch.core.quant import bit_width


@dataclasses.dataclass(frozen=True)
class LayerMacs:
    """Static MAC count of one weight-carrying layer at reference input."""
    vertex: str
    macs: float          # full (unpruned) MACs
    weight_param: str    # key into params


def layer_macs_linear(vertex: str, w_shape, tokens: int,
                      weight_param: str) -> LayerMacs:
    in_dim, out_dim = w_shape[-2], w_shape[-1]
    return LayerMacs(vertex, float(tokens) * in_dim * out_dim, weight_param)


def layer_macs_conv(vertex: str, w_shape, out_hw: tuple[int, int],
                    batch: int, weight_param: str) -> LayerMacs:
    kh, kw, cin, cout = w_shape
    return LayerMacs(
        vertex, float(batch) * out_hw[0] * out_hw[1] * kh * kw * cin * cout,
        weight_param)


def model_bops(qadg: QADG, params: dict, qparams: dict,
               layer_macs: list[LayerMacs],
               masks: Optional[dict] = None,
               act_bits_default: float = 32.0,
               weight_bits_default: float = 32.0) -> dict:
    """Absolute and relative BOPs.

    `masks`: per-family keep masks; pruning scales a layer's MACs by
    (kept fraction of its input space) * (kept fraction of its output
    space), derived from the elementwise survival of the weight tensor.
    """
    site_by_target = {}
    for s in qadg.sites:
        site_by_target.setdefault(s.target, {})[s.kind] = s

    def survival(pname: str) -> float:
        if masks is None:
            return 1.0
        frac = 1.0
        for fam in qadg.space.prunable_families():
            for m in fam.members:
                if m.param == pname:
                    keep = masks[fam.name].detach().cpu() > 0.5
                    frac *= float(keep.to(torch.float64).mean())
        return frac

    def bits(site) -> float:
        qp = qparams[site.name]
        return float(bit_width(qp.d, qp.q_m, qp.t))

    total = 0.0
    baseline = 0.0
    per_layer = {}
    for lm in layer_macs:
        sites = site_by_target.get(lm.vertex, {})
        bw = bits(sites["weight"]) if "weight" in sites else \
            weight_bits_default
        ba = bits(sites["act"]) if "act" in sites else act_bits_default
        macs = lm.macs * survival(lm.weight_param)
        bops = macs * bw * ba
        per_layer[lm.vertex] = {"macs": macs, "b_w": bw, "b_a": ba,
                                "bops": bops}
        total += bops
        baseline += lm.macs * 32.0 * 32.0
    return {"bops": total, "baseline_bops": baseline,
            "rel_bops": total / max(baseline, 1.0), "per_layer": per_layer}

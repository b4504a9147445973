"""Carry weights across from the JAX package, as numpy arrays.

Both packages key params the same way (`embed`, `head`, `blocks.0.attn.wq`
stacked (L, K, N), `<name>.codes`, `<name>.packed{bits}`, `<name>.scale`)
and quantizers by site (`<name>.wq`), so a dict converts leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QuantParams


def tensor_from_numpy(arr, device="cpu", dtype=None) -> torch.Tensor:
    """One array to a tensor; bfloat16 (ml_dtypes) arrays keep their bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(np_params: dict, device="cpu", dtype=None
                      ) -> dict[str, torch.Tensor]:
    """A param dict of numpy arrays to tensors on `device`; `dtype` casts
    the floating-point leaves."""
    return {k: tensor_from_numpy(v, device, dtype)
            for k, v in np_params.items()}


def qparams_from_numpy(np_qparams: dict, device="cpu"
                       ) -> dict[str, QuantParams]:
    """Quantizer sites to `QuantParams`; each value carries d, q_m and t as
    attributes (a JAX `QuantParams`) or is a (d, q_m, t) triple."""
    out = {}
    for site, qp in np_qparams.items():
        vals = (qp.d, qp.q_m, qp.t) if hasattr(qp, "q_m") else tuple(qp)
        out[site] = QuantParams(*(
            torch.tensor(np.asarray(v, np.float32), device=device)
            for v in vals))
    return out


def qasso_state_from_numpy(np_state, device="cpu"):
    """A JAX `QASSOState` whose leaves are numpy arrays (step, the base
    optimizer's state: AdamW's (count, m, v), momentum's moment dict or
    SGD's (), redundant, keep_mask, gamma) to the port's `QASSOState`.
    Counters become Python ints; moments, masks and gamma f32 tensors
    (gamma on the CPU, where QASSO's scalar rules run)."""
    from repro_torch.core.qasso import QASSOState
    from repro_torch.optim.base import AdamState

    def tree(d):
        return {k: tensor_from_numpy(v, device) for k, v in d.items()}

    base = np_state.base
    if hasattr(base, "count"):
        base = AdamState(int(np.asarray(base.count)), tree(base.m),
                         tree(base.v))
    elif isinstance(base, dict):
        base = tree(base)
    else:
        base = ()
    return QASSOState(step=int(np.asarray(np_state.step)), base=base,
                      redundant=tree(np_state.redundant),
                      keep_mask=tree(np_state.keep_mask),
                      gamma=tensor_from_numpy(np_state.gamma))


def geta_state_from_numpy(np_params: dict, np_qparams: dict, np_state,
                          device="cpu"):
    """(params, qparams, QASSOState) of the port from a JAX GETA train
    state held as numpy: the one-step parity tests cross every step
    through here."""
    return (params_from_numpy(np_params, device),
            qparams_from_numpy(np_qparams, device),
            qasso_state_from_numpy(np_state, device))

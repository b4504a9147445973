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

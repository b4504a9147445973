"""Group saliency scores (HESSO style), used at Alg 2 line 11.

Port of `repro.core.saliency`. For each minimally-removable unit g the
score mixes three signals, accumulated per member without building the
(units, W) group matrix:

  magnitude   : ||x_g||_2 / sqrt(W)
  cosine      : |cos(x_g, grad_g)|
  first-order : |<grad_g, x_g>|

z-scored per family, then ranked globally. The ranking is a stable
argsort, as `jnp.argsort` is: units with equal scores (the -inf of the
sticky redundant ones) keep their index order, so the masks match the JAX
package's on ties.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.groups import GroupFamily, PruningSpace

_EPS = 1e-12
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SaliencyConfig:
    w_magnitude: float = 1.0
    w_cosine: float = 0.25
    w_taylor: float = 1.0
    normalize: bool = True


def family_scores(space: PruningSpace, family: GroupFamily, params: dict,
                  grads: dict, cfg: SaliencyConfig = SaliencyConfig()
                  ) -> torch.Tensor:
    """(units,) saliency for one family. Higher = more important."""
    u = family.units

    def unit_reduce(val, m):
        """Sum over every axis but the member axis, then fold the units."""
        axes = tuple(i for i in range(val.ndim) if i != m.axis)
        v = torch.sum(val, dim=axes) if axes else val
        if m.unit_size == 1:
            return v
        if m.layout == "contiguous":
            return torch.sum(v.reshape(u, m.unit_size), dim=1)
        return torch.sum(v.reshape(m.unit_size, u), dim=0)

    dev = params[family.members[0].param].device
    dot = torch.zeros((u,), dtype=F32, device=dev)
    x2 = torch.zeros((u,), dtype=F32, device=dev)
    g2 = torch.zeros((u,), dtype=F32, device=dev)
    w = 0
    for m in family.members:
        xv = params[m.param].to(F32)
        gv = grads[m.param].to(F32)
        dot = dot + unit_reduce(xv * gv, m)
        x2 = x2 + unit_reduce(torch.square(xv), m)
        g2 = g2 + unit_reduce(torch.square(gv), m)
        w += xv.numel() // u

    mag = torch.sqrt(x2) / torch.sqrt(torch.tensor(float(max(w, 1)),
                                                   dtype=F32))
    cos = torch.abs(dot) / torch.clamp_min(torch.sqrt(x2 * g2), _EPS)
    taylor = torch.abs(dot)

    def norm(v):
        if not cfg.normalize:
            return v
        return (v - torch.mean(v)) / (torch.std(v, correction=0) + _EPS)

    return (cfg.w_magnitude * norm(mag) + cfg.w_cosine * norm(cos)
            + cfg.w_taylor * norm(taylor))


def global_redundancy_partition(space: PruningSpace, params: dict,
                                grads: dict, n_redundant: int,
                                cfg: SaliencyConfig = SaliencyConfig(),
                                frozen: dict | None = None,
                                pinned: dict | None = None
                                ) -> dict[str, torch.Tensor]:
    """Alg 2 line 12: the `n_redundant` globally lowest-saliency units.

    Returns per-family float masks: 1.0 = redundant (in G_R). `frozen`
    units stay important (+inf score); `pinned` units, redundant in an
    earlier period, stay redundant (-inf score) and count toward
    `n_redundant`."""
    fams = space.prunable_families()
    scores = []
    for fam in fams:
        s = family_scores(space, fam, params, grads, cfg)
        if frozen is not None and fam.name in frozen:
            s = torch.where(frozen[fam.name] > 0.5, torch.inf, s)
        if pinned is not None and fam.name in pinned:
            s = torch.where(pinned[fam.name] > 0.5, -torch.inf, s)
        scores.append(s)
    flat = torch.cat(scores) if scores else torch.zeros((0,))
    # rank 0 = least salient; the inverse permutation of a stable argsort
    order = torch.argsort(flat, stable=True)
    ranks = torch.argsort(order)
    redundant_flat = (ranks < n_redundant).to(F32)
    out, off = {}, 0
    for fam in fams:
        out[fam.name] = redundant_flat[off: off + fam.units]
        off += fam.units
    return out

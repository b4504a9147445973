"""Pruning search space: minimally-removable structures and their masks.

Port of `repro.core.groups` on torch tensors. A `GroupFamily` is a set of
structurally-tied parameter slices; each of its `units` is one minimally
removable structure g in the paper's group set G (Eq 7b counts zeroed
units). Members record how a unit maps into each tied parameter tensor:

    Member(param, axis, unit_size, layout)

- `contiguous`: unit i owns param[..., i*unit_size:(i+1)*unit_size, ...]
  along `axis` (head groups, experts, channel-major flattens).
- `interleaved`: unit i owns every `units`-strided element (channel-last
  spatial flattens: index = spatial * units + i).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Member:
    param: str
    axis: int
    unit_size: int = 1
    layout: str = "contiguous"  # | "interleaved"


@dataclasses.dataclass
class GroupFamily:
    name: str
    units: int
    members: list[Member]
    prunable: bool = True
    kind: str = "channel"  # channel | head_group | expert | state | ...

    def validate(self, params: dict) -> None:
        for m in self.members:
            n = params[m.param].shape[m.axis]
            if n != self.units * m.unit_size:
                raise ValueError(
                    f"family {self.name}: member {m.param} axis {m.axis} has "
                    f"dim {n}, expected units({self.units}) * "
                    f"unit_size({m.unit_size})")


def axis_mask(mask: torch.Tensor, member: Member, axis_len: int
              ) -> torch.Tensor:
    """Expand a (units,) mask to a (axis_len,) per-element mask."""
    if member.layout == "contiguous":
        return torch.repeat_interleave(mask, member.unit_size)[:axis_len]
    # interleaved: [s0u0 s0u1 ... s0u{U-1} s1u0 ...]
    return mask.repeat(member.unit_size)[:axis_len]


def broadcast_to_axis(vec: torch.Tensor, ndim: int, axis: int
                      ) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


class PruningSpace:
    """The pruning search space over the QADNN (paper: parameter groups G)."""

    def __init__(self, families: list[GroupFamily]):
        names = [f.name for f in families]
        if len(names) != len(set(names)):
            raise ValueError("duplicate family names")
        self.families = families
        self.by_name = {f.name: f for f in families}

    def prunable_families(self) -> list[GroupFamily]:
        return [f for f in self.families if f.prunable]

    def init_masks(self, device=None) -> dict:
        """All-keep (units,) f32 masks, one per prunable family."""
        return {f.name: torch.ones((f.units,), dtype=torch.float32,
                                   device=device)
                for f in self.prunable_families()}

    def total_units(self) -> int:
        return sum(f.units for f in self.prunable_families())

    def apply_masks(self, params: dict, masks: dict) -> dict:
        """Multiply every member slice by its unit mask (soft or hard)."""
        out = dict(params)
        for fam in self.prunable_families():
            mask = masks[fam.name]
            for m in fam.members:
                arr = out[m.param]
                am = axis_mask(mask, m, arr.shape[m.axis])
                out[m.param] = arr * broadcast_to_axis(
                    am.to(arr.dtype), arr.ndim, m.axis)
        return out

    def member_view(self, arr: torch.Tensor, member: Member,
                    units: int) -> torch.Tensor:
        """One member tensor as (units, -1): row i is unit i's slice."""
        a = torch.movedim(arr, member.axis, 0)
        n = a.shape[0]
        a = a.reshape(n, -1)
        if member.layout == "contiguous":
            return a.reshape(units, -1)
        a = a.reshape(member.unit_size, units, a.shape[1])
        return torch.movedim(a, 1, 0).reshape(units, -1)

    def group_matrix(self, params: dict, family: GroupFamily
                     ) -> torch.Tensor:
        """(units, W) f32 matrix of every member slice per unit, members
        side by side: the [x]_g view of magnitude scores."""
        return torch.cat([self.member_view(params[m.param].to(torch.float32),
                                           m, family.units)
                          for m in family.members], dim=1)

    def group_sq_norms(self, params: dict, family: GroupFamily
                       ) -> torch.Tensor:
        """(units,) f32 squared L2 norm of each unit's slice over every
        member: the squared row norms of `group_matrix`, reduced member by
        member in chunks of at most 2^26 elements, so that no f32 copy of
        a whole member is made (an expert stack at full width is 1.6e9
        elements a layer)."""
        out = None
        for m in family.members:
            arr = params[m.param]
            dims = [d for d in range(arr.ndim) if d != m.axis]
            sq = torch.zeros(arr.shape[m.axis], dtype=torch.float32,
                             device=arr.device)
            if not dims:
                sq += torch.square(arr.to(torch.float32))
            else:
                split = max(dims, key=lambda d: arr.shape[d])
                step = max(1, (1 << 26) * arr.shape[split] // arr.numel())
                for c in torch.split(arr, step, dim=split):
                    sq += torch.sum(torch.square(c.to(torch.float32)),
                                    dim=dims)
            if m.layout == "contiguous":
                per = sq.reshape(family.units, -1).sum(1)
            else:
                per = sq.reshape(m.unit_size, family.units).sum(0)
            out = per if out is None else out + per
        return out

    def materialize(self, params: dict, masks: dict
                    ) -> tuple[dict, dict[str, np.ndarray]]:
        """construct_subnet(): physically slice away pruned units. Returns
        (sliced params, kept-unit indices per family); members of the same
        param from several families are sliced one after another."""
        kept: dict[str, np.ndarray] = {}
        out = dict(params)
        for fam in self.prunable_families():
            keep_units = np.nonzero(
                np.asarray(masks[fam.name].detach().cpu()) > 0.5)[0]
            kept[fam.name] = keep_units
            for m in fam.members:
                arr = out[m.param]
                axis_len = arr.shape[m.axis]
                if m.layout == "contiguous":
                    elem = (keep_units[:, None] * m.unit_size
                            + np.arange(m.unit_size)[None, :]).reshape(-1)
                else:
                    elem = (np.arange(m.unit_size)[:, None] * fam.units
                            + keep_units[None, :]).reshape(-1)
                if elem.size and int(elem.max()) >= axis_len:
                    raise ValueError(
                        f"family {fam.name}: member {m.param} (axis "
                        f"{m.axis}, layout {m.layout}) maps kept units to "
                        f"element index {int(elem.max())}, but the axis has "
                        f"length {axis_len} — mis-specified units"
                        f"({fam.units}) / unit_size({m.unit_size}) / layout")
                out[m.param] = torch.index_select(
                    arr, m.axis, torch.as_tensor(elem, device=arr.device))
        return out, kept

    def sparsity(self, masks: dict) -> torch.Tensor:
        """Fraction of prunable units currently zeroed (Eq 7b / total)."""
        zeroed = sum(torch.sum(masks[f.name] <= 0.5)
                     for f in self.prunable_families())
        return zeroed / max(self.total_units(), 1)

    def validate(self, params: dict) -> None:
        for f in self.families:
            f.validate(params)

"""Logical-axis sharding rules (DP / FSDP / TP): port of
`repro.distributed.sharding`.

Every parameter carries a tuple of logical axis names (`LM.param_axes`);
a `ShardingPlan` maps logical axes to mesh axes, checking divisibility
and falling back to replication (recorded in `plan.fallbacks`, never
silent) when a dim does not divide. A spec is a tuple with one entry per
dim: None (replicated), a mesh axis name, or a tuple of them (the first
the most significant), as a JAX `PartitionSpec` lists them.

Default layout on a (pod, data, model) mesh:
  batch          -> (pod, data)        data parallel
  vocab*, heads, mlp, experts, ...     tensor parallel on `model`
  embed          -> (pod, data) iff fsdp=True (params and optimizer
                    state sharded over the data axes)

On tensors, `local_shard(x, spec, mesh)` is this rank's piece and
`gather_full(x, spec, mesh)` reassembles it: a tiled all-gather per
sharded dim, minor axis first, in the order of the reference's
`_gather_full`, so the full tensor comes back bit for bit.
`NamedSharding(mesh, spec)` pairs the two for trees (`place`). GSPMD's
`constrain` has no counterpart: nothing partitions the port's programs
but the code that calls these functions.

`TensorParallel` is a served model's layout on the `model` axis, which
the LM's layers read to run on a rank's shards (`models.layers`):
attention heads, MLP hidden units, the vocab, an MoE's experts (expert
parallelism: dim -3 of the expert stacks), mamba's inner channels and
rwkv6's heads and channel-mix hidden units. `serving_plan` is its plan:
the reference's rules with the MoE router replicated, and rwkv6's heads
kept whole on a rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "vocab_out": "model",
    "embed": None,               # -> ("pod", "data") when fsdp
    "q_heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "experts_router": "model",
    "expert_mlp": None,
    "mamba_inner": "model",
    "mamba_inner2": "model",
    "mamba_state": None,
    "mamba_lowrank": None,
    "mamba_lowrank_dt": None,
    "rwkv_heads": "model",
    "rwkv_ffn": "model",
    "lora": None,
    "layers": None,
    "conv_k": None,
    "codebooks": None,
    "mix5": None,
    "mix2": None,
}


def _axes(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


@dataclasses.dataclass
class ShardingPlan:
    mesh: Any                    # anything with a `.shape` axis -> size map
    rules: dict[str, Any]
    fallbacks: list[tuple[str, str, int]]  # (param, axis, dim) replicated
    # logical axis -> the width a leaf's LAST dim on it splits in whole
    # multiples of (rwkv6's head size on `rwkv_heads`: a column tile must
    # not cut a head; a K tile of rows may)
    units: dict[str, int] = dataclasses.field(default_factory=dict)

    def spec_for(self, name: str, logical: tuple[str, ...],
                 shape: tuple[int, ...]) -> tuple:
        parts = []
        used = set()
        for i, (ax_name, dim) in enumerate(zip(logical, shape)):
            mesh_ax = self.rules.get(ax_name)
            if mesh_ax is None:
                parts.append(None)
                continue
            axes = tuple(a for a in _axes(mesh_ax) if a in self.mesh.shape)
            size = math.prod(self.mesh.shape[a] for a in axes)
            unit = self.units.get(ax_name, 1) if i == len(logical) - 1 else 1
            if (size <= 1 or dim % (size * unit) != 0
                    or any(a in used for a in axes)):
                if size > 1:
                    self.fallbacks.append((name, ax_name, dim))
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def shardings(self, params_axes: dict[str, tuple],
                  shapes: dict[str, tuple]) -> dict[str, "NamedSharding"]:
        return {name: NamedSharding(self.mesh,
                                    self.spec_for(name, ax, shapes[name]))
                for name, ax in params_axes.items()}


def make_plan(mesh, *, fsdp: bool = False, overrides: Optional[dict] = None,
              mode: str = "tp") -> ShardingPlan:
    """mode:
      'tp'   — DP over (pod, data), TP on `model` (+ FSDP over the DP axes
               when fsdp=True).
      'zero' — pure data parallelism with ZeRO param sharding: batch over
               every mesh axis, params sharded over (data, model) on their
               embed/vocab axis, no tensor parallelism.
    `overrides` are an arch's rules (`configs.get_overrides`), whose
    `base_optimizer` is not a rule and `fsdp`, `mode`, `experts_axis`,
    `expert_mlp_axis` set the knobs of those names."""
    rules = dict(DEFAULT_RULES)
    overrides = dict(overrides or {})
    overrides.pop("base_optimizer", None)
    if overrides.pop("fsdp", False):
        fsdp = True
    mode = overrides.pop("mode", mode)
    if "experts_axis" in overrides:
        rules["experts"] = overrides.pop("experts_axis")
    if "expert_mlp_axis" in overrides:
        rules["expert_mlp"] = overrides.pop("expert_mlp_axis")
    rules.update(overrides)
    if mode == "zero":
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.shape)
        zero_axes = tuple(a for a in ("data", "model") if a in mesh.shape)
        for k in rules:
            rules[k] = None
        rules["batch"] = all_axes
        rules["embed"] = zero_axes
        rules["vocab"] = zero_axes
        rules["vocab_out"] = None
    elif fsdp:
        rules["embed"] = tuple(a for a in ("pod", "data") if a in mesh.shape)
    rules.setdefault("batch", ("pod", "data"))
    return ShardingPlan(mesh=mesh, rules=rules, fallbacks=[])


def serving_plan(mesh, cfg=None) -> ShardingPlan:
    """The tensor-parallel serving plan (`make_plan(mode="tp")`) with two
    departures from the rules: the MoE router (`experts_router`) stays
    whole on every rank, so every rank and the 1-rank engine pick the same
    experts from the same bits (a column tile of the router product could
    round a near-tie the other way), and, for a config with rwkv6 mixers
    (`cfg.rwkv`), a column tile on `rwkv_heads` holds whole heads (the WKV
    scan and the group norm run per head); a head count the ranks do not
    divide replicates, recorded in `fallbacks`."""
    plan = make_plan(mesh, mode="tp", overrides={"experts_router": None})
    rwkv = getattr(cfg, "rwkv", None)
    if rwkv is not None:
        plan.units["rwkv_heads"] = int(rwkv.head_size)
    return plan


def serving_axes_for(name: str, params_axes: dict[str, tuple]
                     ) -> Optional[tuple]:
    """Logical axes for a served param key: `<w>.codes` and
    `<w>.packed{b}` (K packed, axis order unchanged) take `<w>`'s axes,
    `<w>.scale` ("layers",); dense keys pass through, unknown keys give
    None (replicate)."""
    if name in params_axes:
        return params_axes[name]
    base, _, suffix = name.rpartition(".")
    ax = params_axes.get(base)
    if ax is None:
        return None
    if suffix == "codes" or (suffix.startswith("packed")
                             and suffix[len("packed"):].isdigit()):
        return ax
    if suffix == "scale":
        return ("layers",)
    return None


def serving_param_specs(plan: ShardingPlan, params_axes: dict[str, tuple],
                        params: dict) -> dict[str, tuple]:
    """Specs for a served param dict (dense weights, int codes, packed
    word streams, scales). A leaf whose axes cannot be recovered, or
    whose rank no longer matches them, replicates (`()`); the rest go
    through `spec_for`, so a pruned or packed width that stops dividing
    the mesh replicates, recorded in `plan.fallbacks`."""
    specs = {}
    for name, leaf in params.items():
        ax = serving_axes_for(name, params_axes)
        shape = tuple(leaf.shape)
        if ax is None or len(ax) != len(shape):
            specs[name] = ()
        else:
            specs[name] = plan.spec_for(name, tuple(ax), shape)
    return specs


# a recurrent-state leaf's suffix -> (its rank, the dim of its channels
# or heads): mamba's h (nb, B, Di, N) and conv (nb, B, K-1, Di), rwkv6's
# wkv (nb, B, H, dh, dh)
_STATE_DIMS = {"h": (4, 2), "conv": (4, 3), "wkv": (5, 2)}


def kv_cache_specs(mesh, cache_shapes: dict[str, tuple]) -> dict[str, tuple]:
    """Specs for a KV arena, contiguous or paged: K/V leaves shard their
    KV-head axis (3 in both the (nb, B, S, KVh, dh) arena and the (nb,
    n_pages, P, KVh, dh) pools, and in the (nb, n_pages, P, KVh) scale
    planes) over `model`. Recurrent-state leaves shard with the channels
    and heads of their mixer, as its params do: mamba's h and conv on Di,
    rwkv6's wkv state on its heads; the token shifts (nb, B, D) stay
    whole (the reference replicates every state leaf and lets GSPMD move
    it). A width that does not divide replicates."""
    size = int(mesh.shape.get("model", 1))
    specs: dict[str, tuple] = {}
    for name, shape in cache_shapes.items():
        kv = name.endswith(".k") or name.endswith(".v")
        sc = name.endswith("_scale")
        ndim, dim = _STATE_DIMS.get(name.rpartition(".")[2], (0, 0))
        if kv and len(shape) == 5 or sc and len(shape) == 4:
            ndim, dim = len(shape), 3
        specs[name] = ()
        if size > 1 and ndim == len(shape) and ndim and shape[dim] % size == 0:
            specs[name] = (None,) * dim + ("model",)
    return specs


def batch_spec(mesh, *, shard_seq: bool = False, mode: str = "tp") -> tuple:
    axes = ("pod", "data") if mode != "zero" else ("pod", "data", "model")
    dp = tuple(a for a in axes if a in mesh.shape)
    dp = dp[0] if len(dp) == 1 else dp
    if shard_seq:
        return (None, dp)
    return (dp,)


# --------------------------------------------------------------- tensors
def local_shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's piece of the full tensor x under `spec`: each sharded
    dim cut in equal tiles, tile `mesh.index(axes)` kept (a copy, so the
    full tensor can be freed). A replicated x comes back as is."""
    out = x
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"local_shard: dim {dim} of {tuple(x.shape)} "
                             f"does not divide {n} ranks")
        w = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(axes) * w, w)
    return out if out is x else out.clone()


def gather_full(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from each rank's `local_shard`: every sharded dim
    all-gathered and tiled, minor axis first (pure data movement)."""
    for dim, entry in enumerate(spec):
        for axis in reversed(_axes(entry)):
            if mesh.shape[axis] > 1:
                x = torch.cat(mesh.all_gather(x, axis), dim=dim)
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (jax.sharding.NamedSharding's role)."""
    mesh: Any
    spec: tuple = ()


def map_sharded(fn, tree, shardings):
    """fn(leaf, sharding) over `tree`, `shardings` a tree of the same
    structure whose nodes may stop early: a `NamedSharding` (or None)
    there covers every leaf below it (jax's pytree-prefix rule)."""
    from repro_torch.checkpoint.checkpoint import tree_map
    sh = shardings
    if sh is None or isinstance(sh, NamedSharding):
        return tree_map(lambda x: fn(x, sh), tree)
    if isinstance(tree, dict):
        return {k: map_sharded(fn, v, sh[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_sharded(fn, a, b) for a, b in zip(tree, sh)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_sharded(fn, a, b) for a, b in zip(tree, sh))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: map_sharded(fn, getattr(tree, f.name),
                                                 getattr(sh, f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree, sh)


def place(tree, shardings):
    """Each tensor of `tree` replaced by its local shard under the
    matching `NamedSharding` (`map_sharded`'s prefix rule; None leaves a
    leaf whole)."""
    return map_sharded(
        lambda x, sh: x if sh is None or not isinstance(x, torch.Tensor)
        else local_shard(x, sh.spec, sh.mesh), tree, shardings)


def gather_tree(tree, shardings):
    """The inverse of `place`: every leaf's full tensor (collective: every
    rank of the mesh calls it)."""
    return map_sharded(
        lambda x, sh: x if sh is None or not isinstance(x, torch.Tensor)
        else gather_full(x, sh.spec, sh.mesh), tree, shardings)


# ------------------------------------------------------- tensor parallel
@dataclasses.dataclass
class TensorParallel:
    """A served model's layout on one mesh axis: `specs` maps each served
    param key (stacked, as `serving_param_specs` gives them) to its spec.
    The layers ask whether a weight's columns (dim -1) or rows (dim -2)
    are split, gather column tiles back, cut them, and sum partial
    products in rank order."""
    mesh: Any
    specs: dict
    axis: str = "model"

    @property
    def size(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def index(self) -> int:
        return self.mesh.index(self.axis)

    def split(self, name: str, dim: int) -> bool:
        """Whether the served key `name` is split on `axis` along `dim`
        (negative: from the last dim, so a layer's view of a stacked
        weight asks the same question)."""
        spec = self.specs.get(name, ())
        return -dim <= len(spec) and self.axis in _axes(spec[dim])

    @staticmethod
    def key(lp: dict, name: str) -> str:
        """The key `layers.dense_proj` multiplies by for weight `name`:
        its packed words, its codes, or the dense weight."""
        for k in lp:
            if k.startswith(name + ".packed") and k[len(name) + 7:].isdigit():
                return k
        return name + ".codes" if name + ".codes" in lp else name

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full last dim from every rank's column tile."""
        return torch.cat(self.mesh.all_gather(x, self.axis), dim=-1)

    def tile(self, x: torch.Tensor, width: Optional[int] = None
             ) -> torch.Tensor:
        """This rank's tile of x's last dim: `width` columns from
        index * width (default: an equal share), zero-padded where the
        dim ends first (a K tile of packed words covers whole words)."""
        n = x.shape[-1]
        width = width or n // self.size
        lo = self.index * width
        t = x[..., lo:min(n, lo + width)]
        if t.shape[-1] < width:
            t = torch.nn.functional.pad(t, (0, width - t.shape[-1]))
        return t

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial x, in rank order."""
        from repro_torch.distributed.collectives import ordered_sum
        return ordered_sum(x, self.mesh, self.axis)

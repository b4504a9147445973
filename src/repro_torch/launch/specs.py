"""Shape and dtype records for every (arch x shape) cell: port of
`repro.launch.specs`.

An `ArraySpec` is the port's `jax.ShapeDtypeStruct`: a global shape, a
dtype and, under a mesh, a partition spec (`distributed.sharding`'s
form); `local_shape` is one rank's shard and `meta()` an empty `meta`
tensor of it. Nothing is allocated: the dry run (`launch.dryrun`) runs
one rank's step on those tensors.

Differences from the reference, by design (ROADMAP "Differences by
design"): the token ids are int64, torch's index dtype; the KV cache
shards its KV-head axis over `model` where the heads divide it and is
otherwise whole on every rank (the port's tensor-parallel layers cannot
split d_head, `sharding.kv_cache_specs`); a batch of 1 is whole on every
rank (the port has no sequence-sharded decode); and there is no `seq`
cache layout (a GSPMD pin): the cache shards by KV head only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.models.transformer import LM


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A global shape and dtype, and under `mesh` a partition spec."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple = ()
    mesh: Any = None

    @property
    def local_shape(self) -> tuple:
        """One rank's shard: each dim split by the product of its axes."""
        out = list(self.shape)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            n = math.prod(self.mesh.shape[a] for a in axes)
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {self.shape} does not divide "
                                 f"{n} ranks")
            out[dim] //= n
        return tuple(out)

    def meta(self, local: bool = True) -> torch.Tensor:
        return torch.empty(self.local_shape if local else self.shape,
                           dtype=self.dtype, device="meta")


def _dp(mesh) -> Any:
    """The data-parallel axes of `mesh`: "data", ("pod", "data"), None."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return axes[0] if len(axes) == 1 else (axes or None)


def _float(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None
                ) -> dict[str, ArraySpec]:
    """Training / prefill batch records (the stub modality frontends'
    token frames and patch embeddings included), the batch split over the
    data-parallel axes under a mesh."""
    B, S = shape.global_batch, shape.seq_len
    spec = (shlib.batch_spec(mesh) if mesh is not None
            else ())

    def rec(shp, dt):
        return ArraySpec(tuple(shp), dt, spec + (None,) * (len(shp) - 1)
                         if spec else (), mesh)

    if cfg.family == "audio":
        return {"tokens": rec((B, S, cfg.num_codebooks), torch.int64)}
    if cfg.family == "vlm":
        return {"tokens": rec((B, S - cfg.vision_patches), torch.int64),
                "vision_embeds": rec((B, cfg.vision_patches, cfg.d_model),
                                     _float(cfg))}
    return {"tokens": rec((B, S), torch.int64)}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> dict:
    """serve-step records: one new token per sequence against a seq_len
    KV cache: {"caches": {name: ArraySpec}, "token", "pos"}. Under a mesh
    the batch splits over the data-parallel axes (whole when it is 1) and
    the K/V leaves over `model` by KV head (`sharding.kv_cache_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    lm = LM(cfg)
    caches = lm.init_cache(B, S, dtype=_float(cfg), device="meta")
    dp = _dp(mesh) if mesh is not None and B > 1 else None
    kv = (shlib.kv_cache_specs(mesh, {k: tuple(v.shape)
                                      for k, v in caches.items()})
          if mesh is not None else {})

    def cache_spec(name, t):
        if mesh is None:
            return ArraySpec(tuple(t.shape), t.dtype)
        parts = [None] * t.ndim
        parts[1] = dp                    # (n_blocks, B, ...) every leaf
        if kv.get(name):
            parts[3] = "model"
        return ArraySpec(tuple(t.shape), t.dtype, tuple(parts), mesh)

    tok = (B, 1, cfg.num_codebooks) if cfg.num_codebooks else (B, 1)
    tok_spec = ((dp,) + (None,) * (len(tok) - 1)) if dp else ()
    return {"caches": {k: cache_spec(k, v) for k, v in caches.items()},
            "token": ArraySpec(tok, torch.int64, tok_spec, mesh),
            "pos": ArraySpec((), torch.int64, (), mesh)}


def param_specs(lm: LM, mesh=None, plan: Optional[shlib.ShardingPlan] = None
                ) -> tuple[dict, dict, dict]:
    """(param records, their shardings, logical axes), allocating nothing:
    `LM.init` runs under a fake-tensor mode, which keeps shapes and dtypes
    only. Without a mesh and plan the shardings are None."""
    with FakeTensorMode():
        fake = lm.init(torch.Generator())
    axes = lm.param_axes()
    if mesh is None or plan is None:
        return ({k: ArraySpec(tuple(v.shape), v.dtype)
                 for k, v in fake.items()}, {k: None for k in fake}, axes)
    shardings = plan.shardings(axes, {k: tuple(v.shape)
                                      for k, v in fake.items()})
    recs = {k: ArraySpec(tuple(v.shape), v.dtype, shardings[k].spec, mesh)
            for k, v in fake.items()}
    return recs, shardings, axes

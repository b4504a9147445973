"""Architecture registry: --arch <id> resolution for every entry point.

Each assigned architecture ships its exact published config (FULL), a
reduced same-family smoke config (SMOKE), and per-arch sharding overrides.
The paper's own experiment substrates (VGG7, ResNet20/56, BERT-small) are
registered alongside.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, CompressionConfig, MambaConfig,
                                ModelConfig, MoEConfig, RWKVConfig,
                                RunConfig, ShapeConfig)

_ARCH_MODULES = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
}

ASSIGNED_ARCHS = list(_ARCH_MODULES)


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.SMOKE if smoke else mod.FULL


def get_overrides(name: str) -> dict:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return dict(getattr(mod, "SHARDING_OVERRIDES", {}))


def arch_shapes(name: str) -> list[str]:
    """Shape cells assigned to an arch. long_500k only for sub-quadratic
    families (DESIGN.md §3) — skipped cells are reported as skip(design)."""
    cfg = get_arch(name)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ASSIGNED_ARCHS for s in arch_shapes(a)]


__all__ = [
    "SHAPES", "ShapeConfig", "ModelConfig", "MoEConfig", "MambaConfig",
    "RWKVConfig", "RunConfig", "CompressionConfig", "ASSIGNED_ARCHS",
    "get_arch", "get_overrides", "arch_shapes", "all_cells",
]

"""Config schema: model architecture, input shapes, run/compression options."""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    every: int = 1              # MoE FFN every N layers (others dense MLP)
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert
    impl: str = "einsum"        # "einsum" (baseline) | "alltoall" (shard_map)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> d_model // 16
    chunk: int = 64             # chunked selective-scan block


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64        # rank of the data-dependent decay LoRA
    chunk: int = 64             # chunked wkv block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm_rwkv | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_every: int = 1         # hybrid: 1 attention layer per `attn_every`
    window: int = 0             # sliding-window attention (0 = full causal)
    num_codebooks: int = 0      # audio: EnCodec codebooks
    vision_patches: int = 0     # vlm: stub patch-embedding count
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # attention implementation: "auto" picks blockwise beyond this seq len
    attn_block_threshold: int = 2048
    attn_block_size: int = 512
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def gqa_group(self) -> int:
        return max(self.n_heads // max(self.n_kv_heads, 1), 1)

    @property
    def sub_quadratic(self) -> bool:
        """True when 500k-token decode is feasible (SSM/hybrid/windowed)."""
        return self.family in ("hybrid", "ssm_rwkv") or self.window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_padded
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = self.q_dim * D * 2 + self.kv_dim * D * 2
        mlp = 3 * D * F
        n = emb
        for i in range(L):
            is_attn = (i % self.attn_every == 0) if self.family == "hybrid" \
                else (self.family != "ssm_rwkv")
            if is_attn and self.n_heads:
                n += attn
            if self.family == "hybrid" and not is_attn and self.mamba:
                di = self.mamba.expand * D
                dtr = self.mamba.dt_rank or D // 16
                n += D * 2 * di + di * (dtr + 2 * self.mamba.d_state) \
                    + dtr * di + di * self.mamba.d_state + di * D \
                    + self.mamba.d_conv * di
            if self.family == "ssm_rwkv":
                n += 6 * D * D + 3 * D * F // 2  # time-mix + channel-mix
            if self.moe and (i % self.moe.every == self.moe.every - 1):
                n += self.moe.n_experts * 3 * D * F + D * self.moe.n_experts
                if self.moe.shared_expert:
                    n += 3 * D * F
            elif self.family not in ("ssm_rwkv",):
                n += mlp
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        n_moe_layers = self.n_layers // self.moe.every
        full_expert = self.moe.n_experts * 3 * D * F * n_moe_layers
        active_expert = self.moe.top_k * 3 * D * F * n_moe_layers
        return self.param_count() - full_expert + active_expert


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """GETA knobs surfaced per run (white-box control — Eq 7b/7c)."""
    enabled: bool = True
    target_sparsity: float = 0.3
    bit_lower: float = 4.0
    bit_upper: float = 16.0
    act_quant: bool = False
    warmup_steps: int = 50
    projection_periods: int = 3
    projection_steps: int = 30
    bit_reduction: float = 2.0
    pruning_periods: int = 5
    pruning_steps: int = 30
    cooldown_steps: int = 100


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    base_optimizer: str = "adamw"
    learning_rate: float = 3e-4
    # distribution
    fsdp: bool = False           # shard params/opt-state over the data axes
    remat_policy: str = "dots"   # none | dots | full
    gradient_compression: bool = False
    seed: int = 0

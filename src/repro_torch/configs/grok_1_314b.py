"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2. [hf:xai-org/grok-1; unverified]

FSDP mandatory (314B). 8 experts < 16-way model axis, so EP on the expert
axis is infeasible — experts are instead tensor-parallel on the expert-MLP
hidden dim (32768/16 = 2048 per device)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=32768, vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, every=1))

SMOKE = ModelConfig(
    name="grok-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=512, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, every=1),
    dtype="float32", remat=False)

SHARDING_OVERRIDES = {"fsdp": True, "base_optimizer": "momentum",
                      "experts_axis": None, "expert_mlp_axis": "model"}

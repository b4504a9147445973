"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

FSDP mandatory (400B). Experts sharded on the model axis (EP: 128/16 = 8
experts per group)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, d_head=128, d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, every=2, shared_expert=True))

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=1, every=1, shared_expert=True),
    dtype="float32", remat=False)

SHARDING_OVERRIDES = {"fsdp": True, "base_optimizer": "momentum",
                      "experts_axis": "model"}

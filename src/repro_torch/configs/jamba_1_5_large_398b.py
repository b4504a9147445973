"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

FSDP is mandatory at this scale (398B params); attention layers are full
causal but only 1-in-8 layers attend, so 500k-token decode stays feasible
(sub-quadratic overall — the Mamba state carries the context)."""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=24576, vocab=65536,
    attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=512))

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", n_layers=4, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
    attn_every=2,
    moe=MoEConfig(n_experts=4, top_k=2, every=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
    dtype="float32", remat=False)

SHARDING_OVERRIDES = {"fsdp": True, "base_optimizer": "momentum"}

"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

FULL = ModelConfig(
    name="rwkv6-3b", family="ssm_rwkv", n_layers=32, d_model=2560,
    n_heads=0, n_kv_heads=0, d_head=64, d_ff=8960, vocab=65536,
    rwkv=RWKVConfig(head_size=64, decay_lora=64))

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm_rwkv", n_layers=2, d_model=128,
    n_heads=0, n_kv_heads=0, d_head=32, d_ff=448, vocab=512,
    rwkv=RWKVConfig(head_size=32, decay_lora=8),
    dtype="float32", remat=False)

SHARDING_OVERRIDES = {}

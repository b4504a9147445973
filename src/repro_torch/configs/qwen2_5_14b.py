"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_head=128, d_ff=13824, vocab=152064,
    qkv_bias=True)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
    qkv_bias=True, dtype="float32", remat=False)

SHARDING_OVERRIDES = {}

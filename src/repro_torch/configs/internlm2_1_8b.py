"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_head=128, d_ff=8192, vocab=92544)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
    dtype="float32", remat=False)

SHARDING_OVERRIDES = {}

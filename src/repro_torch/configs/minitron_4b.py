"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_head=128, d_ff=9216, vocab=256000)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=6, n_kv_heads=2, d_head=32, d_ff=288, vocab=512,
    dtype="float32", remat=False)

SHARDING_OVERRIDES = {}

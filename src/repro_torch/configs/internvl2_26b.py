"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 (InternViT + InternLM2). [arXiv:2404.16821; hf]

The InternViT frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings (B, 1024, d_model) prepended to the text."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=16384, vocab=92553,
    vision_patches=1024)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
    vision_patches=8, dtype="float32", remat=False)

SHARDING_OVERRIDES = {}

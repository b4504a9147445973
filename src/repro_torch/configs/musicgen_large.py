"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32 => MHA)
d_ff=8192 vocab=2048, decoder-only over EnCodec tokens (4 codebooks).
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per assignment: input_specs() provides the
4-codebook token frames directly; the model owns the codebook embeddings."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab=2048,
    num_codebooks=4)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_head=32, d_ff=256, vocab=128,
    num_codebooks=4, dtype="float32", remat=False)

SHARDING_OVERRIDES = {}

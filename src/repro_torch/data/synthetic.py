"""Deterministic synthetic batches, port of `repro.data.synthetic`.

Every batch is a function of (seed, step): the same processes as the JAX
package (an LM stream with token t+1 correlated with token t, a QA span
task with planted markers, class-conditional images), drawn from a
`torch.Generator` seeded from (seed, step), and the two stub modality
frontends: frames of codebook tokens for the audio family and patch
embeddings for the vision-language family (`batch_for`). The two
frameworks' generators give different numbers from one seed, so the
parity tests hand the JAX package's batches across as numpy instead.

The train loop checkpoints the next step's data key, `step_key(seed,
step)`: a 0-d int64 tensor holding the generator's seed. A batch drawn
with `key=step_key(seed, step)` equals the stateless form's, so a restored
run replays the exact stream.
"""
from __future__ import annotations

import torch

QA_SEED_OFFSET = 7919
IMAGE_SEED_OFFSET = 104729
IMAGE_MEANS_SEED = 12345
VISION_SEED_OFFSET = 31337


def _seed_of(seed: int, step: int) -> int:
    return (int(seed) * 1_000_003 + int(step)) % (2 ** 63)


def step_key(seed: int, step: int) -> torch.Tensor:
    """The data key of step `step`: the seed of its generator, as a 0-d
    int64 tensor on the CPU (a checkpointable leaf)."""
    return torch.tensor(_seed_of(seed, step), dtype=torch.int64)


def _generator(seed: int, step: int, device, key=None) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed, step) if key is None else int(key))
    return gen


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             n_codebooks: int = 0, device="cpu", key=None) -> dict:
    """{"tokens": (batch, seq) int64, or (batch, seq, n_codebooks) frames}
    with P(next = 31 * prev + 7 mod V) = 0.7 along the sequence, drawn on
    `device`. `key`, when given, replaces the (seed, step) derivation
    (`step_key`)."""
    gen = _generator(seed, step, device, key)
    shape = (batch, seq, n_codebooks) if n_codebooks else (batch, seq)
    base = torch.randint(0, vocab, shape, generator=gen, device=device)
    shifted = torch.roll(base, 1, dims=1)
    mix = torch.rand(shape, generator=gen, device=device) < 0.7
    tokens = torch.where(mix, (shifted * 31 + 7) % vocab, base)
    return {"tokens": tokens}


def qa_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device="cpu") -> dict:
    """SQuAD-style spans: random tokens with the answer's start marked by
    token vocab - 2 and its end by vocab - 1; start in [0, seq // 2), end
    = min(start + length, seq - 1), length in [1, seq // 4). All int64."""
    gen = _generator(seed + QA_SEED_OFFSET, step, device)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    start = torch.randint(0, seq // 2, (batch,), generator=gen,
                          device=device)
    length = torch.randint(1, seq // 4, (batch,), generator=gen,
                           device=device)
    end = torch.clamp_max(start + length, seq - 1)
    rows = torch.arange(batch, device=device)
    tokens[rows, start] = vocab - 2
    tokens[rows, end] = vocab - 1
    return {"tokens": tokens, "start": start, "end": end}


def image_batch(seed: int, step: int, batch: int, hw: int = 32,
                classes: int = 10, device="cpu") -> dict:
    """CIFAR-like images, NHWC f32 (batch, hw, hw, 3): a fixed mean
    pattern per class (from one generator seeded IMAGE_MEANS_SEED) plus
    unit noise; labels int64 in [0, classes)."""
    gen = _generator(seed + IMAGE_SEED_OFFSET, step, device)
    labels = torch.randint(0, classes, (batch,), generator=gen,
                           device=device)
    noise = torch.randn((batch, hw, hw, 3), generator=gen, device=device)
    means = torch.randn((classes, hw, hw, 3), device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            IMAGE_MEANS_SEED)) * 1.5
    return {"images": means[labels] + noise, "labels": labels}


def vlm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
              patches: int, d_model: int, dtype=torch.bfloat16,
              device="cpu", key=None) -> dict:
    """`lm_batch`'s (batch, seq) text and "vision_embeds": (batch,
    patches, d_model) N(0, 0.02^2) patch embeddings in `dtype`, from their
    own generator seeded from (seed + VISION_SEED_OFFSET, step) (`key`
    steers the text only, as in the reference)."""
    out = lm_batch(seed, step, batch, seq, vocab, device=device, key=key)
    gen = _generator(seed + VISION_SEED_OFFSET, step, device)
    out["vision_embeds"] = (torch.randn((batch, patches, d_model),
                                        generator=gen, device=device)
                            * 0.02).to(dtype)
    return out


def batch_for(cfg, seed: int, step: int, batch: int, seq: int,
              device="cpu", key=None) -> dict:
    """Model-family-aware batch builder (the stub modality frontends):
    codebook frames (batch, seq, C) for the audio family, `vlm_batch`
    with seq - vision_patches text tokens for the vlm family, the LM
    stream otherwise. `key` optionally carries the checkpointed data key
    (`lm_batch`)."""
    if cfg.family == "audio":
        return lm_batch(seed, step, batch, seq, cfg.vocab,
                        n_codebooks=cfg.num_codebooks, device=device,
                        key=key)
    if cfg.family == "vlm":
        return vlm_batch(seed, step, batch, seq - cfg.vision_patches,
                         cfg.vocab, cfg.vision_patches, cfg.d_model,
                         dtype=(torch.bfloat16 if cfg.dtype == "bfloat16"
                                else torch.float32),
                         device=device, key=key)
    return lm_batch(seed, step, batch, seq, cfg.vocab, device=device,
                    key=key)

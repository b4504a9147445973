"""Deterministic synthetic LM batches, port of `repro.data.synthetic`.

Every batch is a function of (seed, step): the same structured token
process as the JAX package (token t+1 correlated with token t, so models
measurably learn), drawn from a `torch.Generator` seeded from (seed, step).
The two frameworks' generators give different numbers from one seed, so
the parity tests hand the JAX package's batches across as numpy instead.
"""
from __future__ import annotations

import torch


def _generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device="cpu") -> dict:
    """{"tokens": (batch, seq) int64} with P(next = 31 * prev + 7 mod V)
    = 0.7, drawn on `device`."""
    gen = _generator(seed, step, device)
    base = torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)
    shifted = torch.roll(base, 1, dims=1)
    mix = torch.rand((batch, seq), generator=gen, device=device) < 0.7
    tokens = torch.where(mix, (shifted * 31 + 7) % vocab, base)
    return {"tokens": tokens}


def batch_for(cfg, seed: int, step: int, batch: int, seq: int,
              device="cpu") -> dict:
    """Model-family-aware batch builder: the dense family's LM stream."""
    if cfg.family != "dense":
        from repro_torch.models.layers import not_in_this_slice
        raise not_in_this_slice(f"{cfg.family!r} batches",
                                "ROADMAP Queue 1 item 12 (other families)")
    return lm_batch(seed, step, batch, seq, cfg.vocab, device=device)

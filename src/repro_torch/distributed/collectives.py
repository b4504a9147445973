"""Cross-rank reductions: port of `repro.distributed.collectives`.

Every sum across ranks in the port is `ordered_sum`: an all-gather of
every rank's tensor and a local f32 sum in rank order, so each rank gets
the same bits and a k-rank sum repeats a sequential loop over the same k
terms. It moves k times the bytes of a ring all-reduce; that is the price
of determinism, as in the reference's deterministic step.

Gradient compression (int8 + per-block scales, error feedback):
`compressed_psum` quantizes each rank's tensor to int8 codes with one
f32 scale per block of 256, all-gathers codes and scales (N int8 bytes
on the wire instead of 2N bf16) and sums the dequantized terms in rank
order; `compressed_grad_allreduce` adds the error-feedback residual that
restores convergence.

The reference pins each QASSO statistic to a replicated layout
(`replicate_stats`) because GSPMD may otherwise combine partial sums at
replica-dependent points; the port has no counterpart: its sharded step
computes every statistic locally from tensors that `gather_full` and
`ordered_sum` made bitwise identical on every rank, and
`assert_replicated` checks that claim.

Expert parallelism: the reference pins the dispatched activations (E, C,
D) to `model` (`moe_ep_constraints`) and lets GSPMD lower the MoE's
dispatch and combine to all-to-all. The port has no partitioner: every
rank builds the whole dispatch and combine masks from the same router
bits, `moe_ep_slices` cuts out its experts' columns (no collective), the
expert products run on the rank's experts alone, and each rank's partial
output is summed in rank order (`ordered_sum`).
"""
from __future__ import annotations

from typing import Any

import torch

F32 = torch.float32
BLOCK = 256


def ordered_sum(x: torch.Tensor, mesh, axis: str, dtype=None
                ) -> torch.Tensor:
    """sum over the ranks of `axis` of x, in rank order, accumulated in
    f32 and returned in `dtype` (default x's)."""
    xs = mesh.all_gather(x, axis)
    acc = xs[0].to(F32)
    for t in xs[1:]:
        acc = acc + t.to(F32)
    return acc.to(dtype or x.dtype)


def moe_ep_slices(dispatch: torch.Tensor, combine: torch.Tensor,
                  n_local: int, mesh, axis: str = "model"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's experts' columns of the (G, n, E, C) dispatch and
    combine masks: experts [i * n_local, (i + 1) * n_local) for the rank's
    index i on `axis`. The capacity C and each token's queue place come
    from the whole masks, identical on every rank, so the drops are the
    1-rank call's."""
    lo = mesh.index(axis) * n_local
    return dispatch[:, :, lo:lo + n_local], combine[:, :, lo:lo + n_local]


def assert_replicated(x: torch.Tensor, mesh, what: str = "tensor") -> None:
    """Raise unless x holds the same bits on every rank of `mesh`."""
    for axis in mesh.axis_names:
        xs = mesh.all_gather(x, axis)
        if not all(torch.equal(xs[0], t) for t in xs[1:]):
            raise AssertionError(f"{what} differs across the ranks of "
                                 f"mesh axis {axis!r}")


def _quantize_blockwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (flat, padded to BLOCK) -> (int8 codes, f32 per-block scales)."""
    xb = x.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes, scale.to(F32)


def _dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    return (codes.to(F32) * scale).reshape(-1)


def _padded(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).to(F32)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """int8 all-gather + local ordered sum: a sum of x over the ranks of
    `axis` within the int8 quantization error."""
    codes, scale = _quantize_blockwise(_padded(x))
    all_codes = mesh.all_gather(codes, axis)
    all_scale = mesh.all_gather(scale, axis)
    acc = _dequantize_blockwise(all_codes[0], all_scale[0])
    for c, s in zip(all_codes[1:], all_scale[1:]):
        acc = acc + _dequantize_blockwise(c, s)
    return acc[:x.numel()].reshape(x.shape).to(x.dtype)


def compressed_grad_allreduce(grads: Any, mesh,
                              axis_names: tuple[str, ...] = ("pod", "data"),
                              error_feedback: Any = None
                              ) -> tuple[Any, Any]:
    """Mean of every rank's gradient tree over `axis_names`, each leaf
    sent as int8 codes plus the residual this rank carried (error
    feedback). Returns (mean grads, new residuals): the residual is what
    the codes missed of (gradient + old residual), f32."""
    from repro_torch.checkpoint.checkpoint import tree_flatten, tree_map
    names = tuple(a for a in axis_names if a in mesh.shape)
    k = 1
    for a in names:
        k *= mesh.shape[a]
    if error_feedback is None:
        error_feedback = tree_map(lambda g: torch.zeros_like(g, dtype=F32),
                                  grads)
    efs = iter(tree_flatten(error_feedback)[0])
    new_ef = []

    def one(g):
        target = g.to(F32) + next(efs)
        codes, scale = _quantize_blockwise(_padded(target))
        sent = _dequantize_blockwise(codes, scale)[:g.numel()].reshape(
            g.shape)
        new_ef.append(target - sent)
        for a in names:
            sent = compressed_psum(sent, mesh, a)
        return sent / k

    mean = tree_map(one, grads)
    residuals = iter(new_ef)
    return mean, tree_map(lambda _: next(residuals), grads)

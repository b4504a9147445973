"""The port's blockwise attention against `attention_dense` and the JAX
package's `attention_blockwise`, and the dispatch between the two.

`attention_blockwise` (plain PyTorch; it was never a Pallas kernel) runs
an online softmax over KV blocks inside a loop over query blocks. At a
small block (S = 16, block = 4, f32) its output and its input gradients
must agree with the dense attention and with the JAX function to 1e-5
(the same arithmetic, summed in another order). `attention` takes it
exactly when the reference does: S > attn_block_threshold, S a multiple
of attn_block_size, Sq == Sk. The LM's forward and loss gradients through
it agree with the JAX LM's under the same lowered threshold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models.transformer import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import layers as TL
from repro_torch.models.transformer import LM as TLM

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, S, H, KV, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, dh)).astype(np.float32)
            for n in (H, KV, KV)]


@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4), (6, 2)])
@pytest.mark.parametrize("block", [4, 8])
def test_blockwise_matches_dense_and_jax(H, KV, block):
    q, k, v = _qkv(2, 16, H, KV, 8)
    got = TL.attention_blockwise(*map(torch.from_numpy, (q, k, v)),
                                 block=block).numpy()
    dense = TL.attention_dense(*map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(JL.attention_blockwise(
        *map(jnp.asarray, (q, k, v)), block=block))
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_blockwise_input_gradients_match_dense_and_jax():
    q, k, v = _qkv(2, 16, 4, 2, 8, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    tg = torch.from_numpy(g)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        return [x.numpy() for x in torch.autograd.grad(
            (fn(*ts) * tg).sum(), ts)]

    got = grads(lambda *t: TL.attention_blockwise(*t, block=4))
    dense = grads(TL.attention_dense)
    _, vjp = jax.vjp(lambda *t: JL.attention_blockwise(*t, block=4),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    for name, a, b, c in zip("qkv", got, dense, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
        np.testing.assert_allclose(a, c, err_msg=name, **TOL)


def test_blockwise_checkpoints_each_query_block_only_with_grad(monkeypatch):
    calls = []
    real = TL.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(TL, "checkpoint", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 8))
    TL.attention_blockwise(q, k, v, block=4)
    assert calls == []
    q.requires_grad_(True)
    TL.attention_blockwise(q, k, v, block=4).sum().backward()
    assert calls == [False] * 4
    with torch.no_grad():
        TL.attention_blockwise(q, k, v, block=4)
    assert len(calls) == 4


def test_blockwise_rejects_ragged_sequences():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 12, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple of block"):
        TL.attention_blockwise(q, k, v, block=8)


@pytest.mark.parametrize("S,Sk,blockwise", [
    (16, 16, True),      # S > 8, a multiple of 4, Sq == Sk
    (8, 8, False),       # not past the threshold
    (18, 18, False),     # past it, not a multiple of the block
    (12, 16, False),     # Sq != Sk
    (12, 12, True)])
def test_dispatch_takes_blockwise_exactly_under_the_reference_condition(
        monkeypatch, S, Sk, blockwise):
    cfg = dataclasses.replace(get_arch("internlm2-1.8b", smoke=True),
                              attn_block_threshold=8, attn_block_size=4)
    jcfg = dataclasses.replace(jget_arch("internlm2-1.8b", smoke=True),
                               attn_block_threshold=8, attn_block_size=4)
    taken = []
    for mod, tag in ((TL, "torch"), (JL, "jax")):
        real = mod.attention_blockwise
        monkeypatch.setattr(
            mod, "attention_blockwise",
            lambda *a, real=real, tag=tag, **kw: (taken.append(tag),
                                                  real(*a, **kw))[1])
    q, k, v = _qkv(1, Sk, 4, 2, 8)
    q = q[:, :S]
    TL.attention(*map(torch.from_numpy, (q, k, v)), cfg)
    JL.attention(*map(jnp.asarray, (q, k, v)), jcfg)
    assert taken == (["torch", "jax"] if blockwise else [])


def test_lm_forward_and_loss_grads_through_blockwise_match_jax():
    """The smoke LM with the blockwise threshold lowered to 8 (block 4), on
    16 tokens: logits and the loss's parameter gradients agree with the
    JAX LM's at the same settings."""
    over = dict(attn_block_threshold=8, attn_block_size=4)
    jlm = JLM(dataclasses.replace(jget_arch("internlm2-1.8b", smoke=True),
                                  **over))
    tlm = TLM(dataclasses.replace(get_arch("internlm2-1.8b", smoke=True),
                                  **over))
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    toks = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(
        np.int32)
    want = np.asarray(jlm.forward(jparams, None, jnp.asarray(toks)))
    tparams = convert.params_from_numpy(np_params)
    got = tlm.forward(tparams, None, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    jg = jax.grad(lambda p: jlm.loss(p, None, {"tokens": jnp.asarray(toks)}))(
        jparams)
    leaves = {k: v.requires_grad_(True) for k, v in tparams.items()}
    loss = tlm.loss(leaves, None, {"tokens": torch.from_numpy(toks).long()})
    tg = torch.autograd.grad(loss, list(leaves.values()))
    for (name, _), g in zip(leaves.items(), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)

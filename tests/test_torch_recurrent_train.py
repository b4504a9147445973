"""The port's training of the recurrent mixers (rwkv6, jamba's hybrid
plan) against the JAX package's: the loss and its gradients, the chunk
checkpoints of the scans, and one GETA step with each arch's base
optimizer (AdamW for rwkv6, momentum for jamba).

The smoke configs' PRNGKey(0) params cross to the port as numpy (helpers
shared with `tests/test_torch_recurrent.py`).

- The logits and loss within 1e-5, every gradient within 1e-4 of its
  largest and every quantizer's (d, q_m, t) gradient within 1e-4
  relative, at 8 bits, on the chunk-4 configs over 16 tokens (four chunks
  a scan, each under its checkpoint).
- The per-chunk checkpoints and the per-layer remat recompute the same
  numbers: gradients bitwise equal with and without `cfg.remat`.
- The whole warm-up step (loss, gradients, base optimizer) from the
  reference's state at `train.STEP_TOLERANCES` with identical masks.
- A mirror of `test_arch_smoke.py::test_smoke_forward_and_train_step`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.synthetic import lm_batch as jlm_batch
from repro.launch import train as JT
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_arch, get_overrides
from repro_torch.convert import (geta_state_from_numpy, params_from_numpy,
                                 qparams_from_numpy)
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM
from test_torch_recurrent import (ARCHS, _cfg, _close, _jax,  # noqa: F401
                                  _jmodel, _np, _q_np, _rng,
                                  one_torch_thread)


def _grads_ref(arch, bits):
    """The reference's loss, gradients and logits on the chunk-4 config
    over a 2 x 16 batch: four chunks a scan."""
    def run():
        _, jp, _ = _jmodel(arch)
        jlm = JLM(_cfg(jget_arch, arch, 4))
        jq = jlm.init_qparams(jp, bits_init=bits)
        jb = jlm_batch(0, 0, 2, 16, jlm.cfg.vocab)
        def loss(p, q):
            # the reference's `LM.loss`, with its logits as the aux output
            logits = jlm.forward(p, q, jb["tokens"])
            pred = logits[:, :-1].astype(jnp.float32)
            tgt = jb["tokens"][:, 1:]
            gold = jnp.sum(jnp.where(jnp.arange(pred.shape[-1])
                                     == tgt[..., None], pred, 0.0), -1)
            return jnp.mean(jax.nn.logsumexp(pred, -1) - gold), logits

        (jl, logits), (jgx, jgq) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jp, jq)
        return (np.asarray(logits), float(jl), _np(jgx), _q_np(jgq),
                _q_np(jq), np.asarray(jb["tokens"]).astype(np.int64))
    return _jax(("grads", arch, bits), run)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    logits, jl, jgx, jgq, jq, tokens = _grads_ref(arch, 8.0)
    lm = LM(_cfg(get_arch, arch, 4))
    tp = params_from_numpy(_jmodel(arch)[2])
    tq = qparams_from_numpy(jq)
    got = lm.forward(tp, tq, torch.from_numpy(tokens))
    _close(got, logits, "logits")
    loss, gx, gq = T.loss_and_grads(lm, tp, tq,
                                    {"tokens": torch.from_numpy(tokens)})
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert set(gx) == set(jgx) and set(gq) == set(jgq)
    for k, want in jgx.items():
        np.testing.assert_allclose(gx[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    for k, want in jgq.items():
        for f, w in zip(("d", "q_m", "t"), want):
            assert float(getattr(gq[k], f)) == pytest.approx(
                float(w), rel=1e-4, abs=1e-12), (k, f)
    mixer = "rwkv" if arch == "rwkv6-3b" else "mamba"
    assert any(f".{mixer}." in k for k in gq)


def test_chunk_remat_leaves_gradients_bitwise():
    """The per-chunk checkpoint of the scans (and the per-layer remat
    around it) recomputes the same numbers: gradients bitwise equal with
    and without `cfg.remat`."""
    tp = params_from_numpy(_jmodel("rwkv6-3b")[2])
    toks = torch.from_numpy(_rng(4).integers(0, 512, (2, 12)))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(_cfg(get_arch, "rwkv6-3b", 4), remat=remat)
        out.append(T.loss_and_grads(LM(cfg), tp, None, {"tokens": toks}))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def _geta_ref(arch, comp):
    """The reference's GETA step from its PRNGKey(0) state at 16 bits with
    the arch's base optimizer, as numpy."""
    bo = get_overrides(arch).get("base_optimizer", "adamw")

    def run():
        jlm, jp, _ = _jmodel(arch)
        jq = jlm.init_qparams(jp, bits_init=16.0)
        jb = jlm_batch(0, 0, 2, 16, jlm.cfg.vocab)
        _, jqasso = JT.build_geta(jlm, JT.CompressionConfig(**vars(comp)),
                                  lr=3e-4, base_optimizer=bo)
        js = jqasso.init(jp, jq)
        step = jax.jit(JT.make_geta_train_step(jlm, jqasso))
        wp, wq, ws, jm = step(jp, jq, js, jb)
        return (_np(jp), _q_np(jq), _np(js), (_np(wp), _q_np(wq), _np(ws)),
                float(jm["loss"]), int(jm["stage"]),
                np.asarray(jb["tokens"]).astype(np.int64))
    return bo, _jax(("geta", arch, repr(comp)), run)


@pytest.mark.parametrize("arch", ARCHS)
def test_geta_step_matches_jax(arch):
    """The whole warm-up step (the port's loss, gradients and base
    optimizer update: AdamW for rwkv6, momentum for jamba) from the
    reference's state, at STEP_TOLERANCES with identical masks."""
    comp = T.CompressionConfig(target_sparsity=0.3, warmup_steps=1)
    bo, (jp, jq, js, wstate, wloss, wstage, tokens) = _geta_ref(arch, comp)
    assert wstage == 0
    assert bo == ("adamw" if arch == "rwkv6-3b" else "momentum")
    lm = LM(get_arch(arch, smoke=True))
    _, qasso = T.build_geta(lm, comp, lr=3e-4, base_optimizer=bo)
    p, q, s = geta_state_from_numpy(jp, jq, js)
    got = T.make_geta_train_step(lm, qasso)(
        p, q, s, {"tokens": torch.from_numpy(tokens)})
    diff = T.step_differences((*geta_state_from_numpy(*wstate),
                               {"loss": wloss}), got)
    assert diff.pop("masks")
    for k, v in diff.items():
        assert v <= T.STEP_TOLERANCES[k], (k, v)



@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    comp = T.CompressionConfig(
        target_sparsity=0.4, bit_lower=4, bit_upper=16, act_quant=False,
        warmup_steps=2, projection_periods=1, projection_steps=2,
        bit_reduction=2, pruning_periods=2, pruning_steps=2,
        cooldown_steps=2)
    cfg = get_arch(arch, smoke=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    qparams = lm.init_qparams(params, bits_init=16.0)
    batch = batch_for(cfg, seed=0, step=0, batch=2, seq=16)
    logits = lm.forward(params, qparams, batch["tokens"])
    assert logits.shape == (2, 16, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    base_opt = get_overrides(arch).get("base_optimizer", "adamw")
    qadg, qasso = T.build_geta(lm, comp, lr=1e-3, base_optimizer=base_opt)
    qadg.space.validate(params)
    qstate = qasso.init(params, qparams)
    p2, q2, s2, metrics = T.make_geta_train_step(lm, qasso)(
        params, qparams, qstate, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert s2.step == 1

"""The port's GETA training on the MoE family (grok-1, llama4) against
the JAX package's, with the base optimizer both MoE configs select
(`momentum`): the port's first parity of it.

The smoke configs' PRNGKey(0) params, 16-bit quantizers and an `lm_batch`
cross to the port as numpy (helpers shared with `tests/test_torch_moe.py`).

- The warm-up step (the port's own loss, gradients and momentum update)
  from the reference's state, at `train.STEP_TOLERANCES`.
- The joint step's QASSO update (the partition computed, the keep mask
  frozen) from the reference's state and gradients, at the same
  tolerances with identical masks, except Eq 17's d, which is held
  against the reference's own sensitivity (`_d_witness`).
- llama4's published two-position plan (`moe.every = 2`: a dense MLP,
  then the MoE) on the smoke widths: loss and gradients.
- A mirror of `test_arch_smoke.py::test_smoke_forward_and_train_step` for
  the two archs, and for the audio and vlm archs (`FRONTEND_ARCHS`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import CompressionConfig as JComp
from repro.core.quant import QuantParams as JQP
from repro.data.synthetic import lm_batch as jlm_batch
from repro.launch import train as JT
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_arch, get_overrides
from repro_torch.convert import (geta_state_from_numpy, params_from_numpy,
                                 qparams_from_numpy)
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM
from test_torch_moe import (ARCHS, FRONTEND_ARCHS, _jax,  # noqa: F401
                            _jmodel, _np, _q_np, one_torch_thread)


def _jgrads(arch):
    """The reference's PRNGKey(0) state at 16 bits, a batch and its loss
    and gradients (one jitted pass per arch)."""
    def run():
        jlm, jp, _ = _jmodel(arch)
        jq = jlm.init_qparams(jp, bits_init=16.0)
        jb = jlm_batch(0, 0, 2, 16, jlm.cfg.vocab)
        jl, (jgx, jgq) = jax.jit(jax.value_and_grad(
            jlm.loss, argnums=(0, 1)))(jp, jq, jb)
        return jq, jl, jgx, jgq, jb
    return _jax(("grads16", arch), run)


def _jupdate(arch, comp):
    """(base optimizer, the reference's jitted QASSO update under comp)."""
    bo = get_overrides(arch)["base_optimizer"]

    def run():
        _, jqasso = JT.build_geta(_jmodel(arch)[0], JComp(**vars(comp)),
                                  lr=3e-4, base_optimizer=bo)
        return jqasso, jax.jit(jqasso.update)
    return bo, _jax(("update", arch, repr(comp)), run)


def _geta_pair(arch, comp):
    """The reference's GETA step (`make_geta_train_step`: loss, gradients,
    QASSO update) from its PRNGKey(0) state at 16 bits, as numpy: (base
    optimizer, (params, qparams, state, gx, gq, stepped (params, qparams,
    state), loss, stage, tokens))."""
    bo, (jqasso, update) = _jupdate(arch, comp)

    def ref():
        jp = _jmodel(arch)[1]
        jq, jl, jgx, jgq, jb = _jgrads(arch)
        js = jqasso.init(jp, jq)
        wp, wq, ws, jm = update(jp, jq, jgx, jgq, js)
        return (_np(jp), _q_np(jq), _np(js), _np(jgx), _q_np(jgq),
                (_np(wp), _q_np(wq), _np(ws)), float(jl),
                int(jm["stage"]), np.asarray(jb["tokens"]).astype(np.int64))

    return bo, _jax(("geta", arch, repr(comp)), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_geta_warmup_step_matches_jax(arch):
    """The whole step (the port's loss, gradients and momentum update)
    from the reference's state."""
    comp = T.CompressionConfig(target_sparsity=0.3, warmup_steps=1)
    bo, (jp, jq, js, _, _, wstate, wloss, wstage, tokens) = \
        _geta_pair(arch, comp)
    assert bo == "momentum" and wstage == 0
    lm = LM(get_arch(arch, smoke=True))
    _, qasso = T.build_geta(lm, comp, lr=3e-4, base_optimizer=bo)
    p, q, s = geta_state_from_numpy(jp, jq, js)
    assert isinstance(s.base, dict)            # momentum's moment dict
    got = T.make_geta_train_step(lm, qasso)(
        p, q, s, {"tokens": torch.from_numpy(tokens)})
    diff = T.step_differences((*geta_state_from_numpy(*wstate),
                               {"loss": wloss}), got)
    assert diff.pop("masks")
    for k, v in diff.items():
        assert v <= T.STEP_TOLERANCES[k], (k, v)
    # the moments moved: momentum's state is the step's gradient
    assert any(float(m.abs().max()) > 0 for m in got[2].base.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_geta_joint_update_matches_jax(arch):
    """Step 0 of JOINT_STEP0 (the partition is computed and the keep mask
    frozen): the port's QASSO update with the momentum base from the
    reference's state and gradients, at STEP_TOLERANCES with identical
    partition and keep masks; the port's own loss within 1e-5. Eq 17's d
    divides by cos(theta_d), the cosine of the gradient with the 16-bit
    rounding residuals round(v) - v, and here |cos(theta_d)| is 2e-4 to
    4e-2: an ulp of v (v reaches 32767) moves a residual by ~4e-3, and
    the reference's own d parts by up to 0.59 relative when every weight
    moves by one ulp (`_d_witness`). Each site's d is held within 4x its
    witness (at least 1e-2); the port's largest gap, grok's attn.wq (d
    1.1e-5 -> 0.0517 in the reference, 0.0386 in the port), is 0.25
    against a witness of 0.40."""
    comp = T.JOINT_STEP0
    bo, (jp, jq, js, jgx, jgq, wstate, wloss, wstage, tokens) = \
        _geta_pair(arch, comp)
    assert wstage == 2
    lm = LM(get_arch(arch, smoke=True))
    _, qasso = T.build_geta(lm, comp, lr=3e-4, base_optimizer=bo)
    p, q, s = geta_state_from_numpy(jp, jq, js)
    loss, _, _ = T.loss_and_grads(lm, p, q,
                                  {"tokens": torch.from_numpy(tokens)})
    p2, q2, s2, met = qasso.update(p, q, params_from_numpy(jgx),
                                   qparams_from_numpy(jgq), s)
    assert met["stage"] == 2
    want = (*geta_state_from_numpy(*wstate), {"loss": wloss})
    diff = T.step_differences(want, (p2, q2, s2, {"loss": float(loss)}))
    assert diff.pop("masks")
    assert any(float(v.sum()) > 0 for v in s2.redundant.values())
    for k, v in diff.items():
        if k != "d":
            assert v <= T.STEP_TOLERANCES[k], (k, v)
    witness = _d_witness(arch, comp)
    assert max(witness.values()) > T.STEP_TOLERANCES["d"]
    for site in qasso.weight_sites:
        a, b = float(q2[site.name].d), float(want[1][site.name].d)
        bound = max(T.STEP_TOLERANCES["d"], 4 * witness[site.name])
        assert abs(a - b) <= bound * abs(b), (site.name, a, b, bound)


def _d_witness(arch, comp):
    """Per weight site, how far the reference's own joint update moves d
    (relative) when every weight moves by one ulp: the largest of three
    draws."""
    def run():
        _, (jp, jq, js, jgx, jgq, wstate, *_) = _geta_pair(arch, comp)
        update = _jupdate(arch, comp)[1][1]
        jgq_t = {k: JQP(*(jnp.asarray(x) for x in v)) for k, v in jgq.items()}
        jq_t = {k: JQP(*(jnp.asarray(x) for x in v)) for k, v in jq.items()}
        js_t = jax.tree_util.tree_map(jnp.asarray, js)
        gx = {k: jnp.asarray(v) for k, v in jgx.items()}
        want_d = {k: float(v[0]) for k, v in wstate[1].items()}
        out = {k: 0.0 for k in want_d}
        for seed in range(3):
            rng = np.random.default_rng(seed)
            moved = {k: jnp.asarray(np.nextafter(v, np.where(
                rng.random(v.shape) < 0.5, np.inf, -np.inf).astype(v.dtype)))
                for k, v in jp.items()}
            _, wq, _, _ = update(moved, jq_t, gx, jgq_t, js_t)
            for k, d in want_d.items():
                out[k] = max(out[k], abs(float(wq[k].d) - d) / abs(d))
        return out
    return _jax(("witness", arch, repr(comp)), run)


@pytest.mark.parametrize("arch", ARCHS + FRONTEND_ARCHS)
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
    logits = lm.forward(params, qparams, batch["tokens"],
                        batch.get("vision_embeds"))
    codebooks = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    assert logits.shape == (2, 16) + codebooks + (cfg.vocab_padded,)
    assert torch.isfinite(logits).all()
    base_opt = get_overrides(arch).get("base_optimizer", "adamw")
    qadg, qasso = T.build_geta(lm, comp, lr=1e-3, base_optimizer=base_opt)
    qadg.space.validate(params)
    qstate = qasso.init(params, qparams)
    p2, q2, s2, metrics = T.make_geta_train_step(lm, qasso)(
        params, qparams, qstate, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert s2.step == 1


def test_two_position_plan_matches_jax():
    """llama4's published `every=2` plan (a dense MLP at position 0, the
    MoE at 1) on the smoke widths: the forward over both positions and
    its gradients against the reference's."""
    def two(cfg):
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, every=2))

    arch = "llama4-maverick-400b-a17b"
    jlm = JLM(two(jget_arch(arch, smoke=True)))
    lm = LM(two(get_arch(arch, smoke=True)))
    assert [(s.ffn, s.j) for s in lm.plan] == [("mlp", 0), ("moe", 1)]
    assert lm.n_blocks == 1

    def ref():
        jp, _ = jlm.init(jax.random.PRNGKey(0))
        jq = jlm.init_qparams(jp)
        jb = jlm_batch(0, 0, 2, 16, jlm.cfg.vocab)
        jl, (jgx, _) = jax.jit(jax.value_and_grad(
            jlm.loss, argnums=(0, 1)))(jp, jq, jb)
        return _np(jp), _q_np(jq), float(jl), _np(jgx), \
            np.asarray(jb["tokens"]).astype(np.int64)

    jp, jq, jl, jgx, tokens = _jax(("two",), ref)
    assert {k: tuple(v.shape) for k, v in lm.init(
        torch.Generator().manual_seed(0)).items()} == \
        {k: v.shape for k, v in jp.items()}
    loss, gx, _ = T.loss_and_grads(lm, params_from_numpy(jp),
                                   qparams_from_numpy(jq),
                                   {"tokens": torch.from_numpy(tokens)})
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    for k, want in jgx.items():
        if ".router" in k:
            continue          # top_k = 1: noise (see the module docstring)
        np.testing.assert_allclose(gx[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)

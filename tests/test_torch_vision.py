"""The port's vision-language LM (internvl2) against the JAX package's:
`vision_embeds` (B, P, D), the stub frontend's patch embeddings,
prepended to the text in `forward` and `prefill`, a loss over the text
positions only, and the family's synthetic batches.

internvl2's smoke config (2 layers, d_model 128, 4 heads / 2 KV, vocab
512, 8 patches, f32) is initialised by the JAX package (PRNGKey(0)) and
crosses to the port as numpy; batches are the JAX package's `batch_for`
(patches included). Helpers and tolerances are `test_torch_codebook.py`'s.

- `forward(vision_embeds=)` and the loss, which drops the patch
  positions; `loss_and_grads` at 16 bits.
- `prefill(vision_embeds=)` then `decode_step` against the reference.
- One GETA step per stage from the reference's state.
- Static `serve_loop` tokens (dense, compressed, pruned 0.3); the
  reference serves a vlm's text without its patches, and so does the
  port.
- QADG identity and `derive_slim_plan`.
- The port's own `batch_for` / `vlm_batch` / `lm_batch(n_codebooks=)`
  draws: shapes, dtypes, the text length seq - vision_patches, and
  (seed, step) determinism.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import batch_for, lm_batch, vlm_batch
from repro_torch.launch import train as T
from repro_torch.models.transformer import LM
from test_torch_codebook import (_batch_np, _close, _jax,  # noqa: F401
                                 _jmodel, _tbatch, _tparams,
                                 check_forward_loss_and_grads,
                                 check_geta_step, check_qadg_and_slim_plan,
                                 one_torch_thread, serve_tokens)

ARCH = "internvl2-26b"


def test_forward_and_loss_over_the_text_positions():
    """Logits over patches + text ((2, 8 + 8, Vp)) and every gradient
    against the reference's; the loss is the next-token cross-entropy of
    the text positions alone."""
    logits = check_forward_loss_and_grads(ARCH)
    cfg = get_arch(ARCH, smoke=True)
    P = cfg.vision_patches
    assert logits.shape == (2, P + 8, cfg.vocab_padded)
    lm = LM(cfg)
    b = _tbatch(_batch_np(ARCH))
    assert b["vision_embeds"].shape == (2, P, cfg.d_model)
    got = lm.forward(_tparams(ARCH), None, b["tokens"], b["vision_embeds"])
    text = got[:, P:-1]
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, text.shape[-1]), b["tokens"][:, 1:].reshape(-1))
    loss = lm.loss(_tparams(ARCH), None, b)
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    # without patches the model sees other inputs at every position
    plain = lm.forward(_tparams(ARCH), None, b["tokens"])
    assert plain.shape[1] == 8 and not torch.allclose(plain, got[:, P:])


def test_prefill_with_vision_embeds_then_decode_matches_jax():
    """8 patches + 6 text tokens prefilled (14 cache rows), then 4 decode
    steps: the prefill's last logits and every step's against the
    reference's, and the last step's against `forward` over the whole
    sequence."""
    jlm, jp, _, _ = _jmodel(ARCH)
    b = _batch_np(ARCH, step=2, seq=18)
    toks, vis = b["tokens"], b["vision_embeds"]

    def ref():
        jc = jlm.init_cache(2, 24, dtype=jnp.float32)
        lg, jc = jax.jit(jlm.prefill)(jp, None, jc, jnp.asarray(toks[:, :6]),
                                      jnp.asarray(vis))
        out = [np.asarray(lg)]
        step = jax.jit(jlm.decode_step)
        for i in range(6, 10):
            lg, jc = step(jp, None, jc, jnp.asarray(toks[:, i:i + 1]),
                          jnp.int32(8 + i))
            out.append(np.asarray(lg))
        return out

    want = _jax("vprefill", ref)
    lm = LM(get_arch(ARCH, smoke=True))
    tp = _tparams(ARCH)
    tt, tv = torch.from_numpy(np.array(toks)), torch.from_numpy(np.array(vis))
    cache = lm.init_cache(2, 24, dtype=torch.float32)
    lg, _ = lm.prefill(tp, None, cache, tt[:, :6], vision_embeds=tv)
    assert lg.shape[1] == 14
    got = [lg] + [lm.decode_step(tp, None, cache, tt[:, i:i + 1], 8 + i)[0]
                  for i in range(6, 10)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"logits {i}")
    full = lm.forward(tp, None, tt[:, :10], tv)
    _close(got[-1][:, 0], full[:, -1].numpy(), "decode vs forward", tol=1e-4)


@pytest.mark.parametrize("i", range(5))
def test_geta_step_per_stage_matches_jax(i):
    check_geta_step(ARCH, i)


@pytest.mark.parametrize("mode", ["dense", "compressed", "pruned"])
def test_serve_loop_tokens_match_jax(mode, monkeypatch):
    """The static loop over (2, 5) text prompts, 6 tokens generated."""
    prompts = _batch_np(ARCH, step=1, seq=13)["tokens"].astype(np.int32)
    assert prompts.shape == (2, 5)
    want, got = serve_tokens(ARCH, mode, prompts, monkeypatch)
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_qadg_and_slim_plan_match_jax():
    plan = check_qadg_and_slim_plan(ARCH)
    assert plan.layer_shapes[0].n_kv_heads < 2 or \
        plan.layer_shapes[0].d_ff < 256


def test_port_batches_shapes_dtypes_and_text_length():
    vlm, audio = get_arch(ARCH, smoke=True), get_arch("musicgen-large",
                                                      smoke=True)
    b = batch_for(vlm, 3, 1, 2, 20)
    P = vlm.vision_patches
    assert b["tokens"].shape == (2, 20 - P) and b["tokens"].dtype == \
        torch.int64
    assert b["vision_embeds"].shape == (2, P, vlm.d_model)
    assert b["vision_embeds"].dtype == torch.float32          # smoke f32
    assert 0 < float(b["vision_embeds"].std()) < 0.05
    assert int(b["tokens"].max()) < vlm.vocab
    full = get_arch(ARCH)
    assert batch_for(full, 0, 0, 1, full.vision_patches + 4)[
        "vision_embeds"].dtype == torch.bfloat16
    again = vlm_batch(3, 1, 2, 20 - P, vlm.vocab, P, vlm.d_model,
                      dtype=torch.float32)
    for k in b:
        assert torch.equal(b[k], again[k]), k
    a = batch_for(audio, 3, 1, 2, 12)
    assert a["tokens"].shape == (2, 12, audio.num_codebooks)
    assert torch.equal(a["tokens"], lm_batch(
        3, 1, 2, 12, audio.vocab, n_codebooks=audio.num_codebooks)["tokens"])
    assert int(a["tokens"].max()) < audio.vocab
    assert not torch.equal(a["tokens"], batch_for(audio, 3, 2, 2, 12)[
        "tokens"])
    # the train step takes both families' batches
    for cfg, batch in ((vlm, b), (audio, a)):
        lm = LM(cfg)
        params = lm.init(torch.Generator().manual_seed(0))
        loss, _, _ = T.loss_and_grads(lm, params, None, batch)
        assert np.isfinite(float(loss))

"""Serving CLI of the port: the continuous-batching engine on CUDA, and
the static lockstep loop (`serve_loop`, `--static`) the engine is held
against.

Three weight modes:
  default       dense weights; every block projection decodes through the
                GEMM kernel's fused fake-quant epilogue
  --compressed  int8 codes + per-column scales, through the dequant
                epilogue
  --packed      sub-byte K-packed int32 words (implies --compressed),
                through the unpack-dequant epilogue; `--bits 4` serves a
                4-bit artifact

and two KV arenas: the contiguous one (default) and the paged one
(`--paged`, `--page-size`; `--kv-bits 8|4` stores int8/int4 pages and
implies `--paged`), decoded by the page-indirect flash-decode kernel.
`--pruned --sparsity S` serves the physically sliced subnet at magnitude
masks of sparsity S (surviving KV heads and MLP units: smaller GEMMs and
KV arena) in any of the weight modes and arenas. `--speculative` attaches
a draft (the same init params sliced at `--draft-sparsity`, a percentage
or a fraction, and packed at `--draft-bits`) proposing up to `--draft-k`
tokens a round, which the target verifies in one chunked pass;
`--chunked-prefill C` prefills each prompt C rows at a time between
decode steps. `--tp N` serves tensor-parallel on N ranks (processes,
`launch.mesh`): gloo on the CPU, nccl when each rank has a card, else
gloo with host-staged collectives (ranks sharing one card), where the
decode windows run eagerly; it stacks with every mode above and serves
every arch the engine serves (an MoE's experts, mamba's inner channels
and rwkv6's heads split over the ranks).

`--static` runs `serve_loop`: one fixed batch of `--batch` prompts of
`--prompt-len` tokens in lockstep, prefilled one token per decode step.

Runs on CUDA; `--device cpu` runs the plain PyTorch versions of the
kernels instead (as the tests do). In `--smoke` mode `--chunked-prefill`
asserts chunked tokens equal one-shot tokens (and that decode ran
mid-prefill), `--tp N` asserts the N-rank tokens equal the one-rank
engine's (before every other check, stacking with all of them), `--paged`
(without `--kv-bits`) asserts paged tokens equal
contiguous tokens (stacking with `--speculative`), `--speculative`
asserts speculative tokens equal the plain engine's, `--packed` asserts
packed tokens equal int8 tokens, and `--pruned` alone asserts the pruned
tokens equal the masked dense reference's (not for an MoE arch, whose
masked model routes otherwise: a zeroed router column still takes softmax
mass); each stacks with `--pruned`. `--arch grok-1-314b` and `--arch
llama4-maverick-400b-a17b` serve the MoE family in every mode;
`--arch rwkv6-3b` and `--arch jamba-1.5-large-398b` the recurrent mixers
in every weight mode, both arenas and pruned (their paged arena runs
without prefix sharing, which the CLI prints: a prefix hit would skip the
prefill that sets a slot's recurrent state; speculative decoding and
chunked prefill refuse them). Codebook (`--arch musicgen-large`) and
vision-language (`--arch internvl2-26b`) archs serve through the static
loop in every weight mode and pruned: without `--static` the CLI switches
to it and says so, as the reference does (the engine takes plain token
prompts only).
Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --compressed
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --packed \
      --bits 4 --prompt-lens 12,5 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --kv-bits 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --pruned \
      --sparsity 0.3 --compressed --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --speculative \
      --draft-k 4 --draft-sparsity 50 --draft-bits 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --chunked-prefill 8 --prompt-lens 12,5,21 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --tp 2 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --tp 2 \
      --arch rwkv6-3b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.subnet import compression_report, prepare_serving
from repro_torch.data.synthetic import batch_for
from repro_torch.launch.engine import (_sync, build_masked_reference_engine,
                                       engine_serve, resolve_device,
                                       synthetic_prompts)
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import LM, layer_plan, recurrent_mixers


def make_serve_step(lm: LM):
    """One greedy decode step of a fixed batch: (params, qparams, caches,
    token (B, 1[, C]), pos) -> (next token (B, 1[, C]), caches); with
    codebooks the argmax is taken per codebook."""
    def serve_step(params, qparams, caches, token, pos):
        logits, caches = lm.decode_step(params, qparams, caches, token, pos)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], caches

    return serve_step


def serve_loop(arch: str, smoke: bool, batch: int, prompt_len: int,
               gen: int, seed: int = 0, quantized: bool = True,
               compressed: bool = False, packed: bool = False,
               pruned: bool = False, sparsity: float = 0.5,
               bits_init: float = 8.0, verbose: bool = True,
               stats: dict | None = None, prompts=None,
               device=None, layers: int | None = None) -> np.ndarray:
    """Static lockstep reference, port of `repro.launch.serve.serve_loop`:
    decode `gen` tokens after a sequential per-token prefill; returns the
    (batch, gen) int32 token matrix ((batch, gen, C) frames with
    codebooks). The weights are `build_engine`'s at the same seed (the
    torch RNG on `device`), so the engine is held to this loop on the same
    model. `stats` receives decode-only timing (the prefill has run every
    kernel once) and the served `param_bytes`. `prompts` overrides the
    synthetic (batch, prompt_len[, C]) prompt matrix and sets the length;
    a vlm's synthetic prompts are the prompt_len - vision_patches text
    tokens of its batch, served without the patches, as the reference
    serves them. `pruned`
    decodes the sliced subnet at magnitude masks of `sparsity` (its KV
    arena at the surviving heads). `layers` cuts the depth to that many
    layers (every width stays the config's). Runs on CUDA unless `device`
    says otherwise."""
    dev = resolve_device(device)
    cfg = get_arch(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(seed))
    params, qparams, meta = prepare_serving(
        lm, params, quantized=quantized, compressed=compressed,
        packed=packed, bits_init=bits_init,
        prune_sparsity=(sparsity if pruned else None))
    if (compressed or packed or pruned) and verbose:
        print(compression_report(arch, meta))
    if prompts is None:
        prompts = batch_for(cfg, seed, 0, batch, prompt_len)["tokens"]
        if cfg.family == "vlm":
            prompts = prompts[:, :prompt_len]
    prompt = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=dev)
    batch, prompt_len = prompt.shape[:2]
    caches = lm.init_cache(batch, prompt_len + gen, dtype=dtype_of(cfg),
                           device=dev)
    step = make_serve_step(lm)
    # prefill via sequential decode (the cache-building path)
    for p in range(prompt_len):
        nxt, caches = step(params, qparams, caches, prompt[:, p:p + 1], p)
    out = [nxt]
    _sync(dev)
    t0 = time.time()
    for g in range(gen - 1):
        nxt, caches = step(params, qparams, caches, out[-1], prompt_len + g)
        out.append(nxt)
    _sync(dev)
    dt_s = time.time() - t0
    toks = batch * (gen - 1)
    if stats is not None:
        stats.update(decode_s=dt_s, tokens=toks,
                     tok_per_s=toks / max(dt_s, 1e-9),
                     param_bytes=meta["param_bytes"])
    if verbose:
        mode = "compressed" if (compressed or packed) else "dense"
        if packed:
            mode += "+packed"
        if pruned:
            mode += f"+pruned@{meta['sparsity']:.2f}"
        print(f"{arch} [static/{mode} on {dev}]: generated {toks} tokens "
              f"in {dt_s:.2f}s ({toks / max(dt_s, 1e-9):.1f} tok/s, "
              f"batch={batch})")
    return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


def _assert_same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for rid in want:
        np.testing.assert_array_equal(
            got[rid], want[rid], err_msg=f"{what} (request {rid})")


def pruned_parity_check(arch: str, smoke: bool, prompt_lens: list[int],
                        gen: int, *, sparsity: float, quantized: bool = True,
                        compressed: bool = False, max_slots: int,
                        seed: int = 0, verbose: bool = True,
                        device=None) -> dict:
    """Assert the pruned engine's decode is token-identical to the masked
    dense reference (same seed, masks and quantizer init): a pruned unit
    contributes exact zeros, so slicing it away must not change a greedy
    token. Returns the pruned engine's output."""
    max_seq = max(prompt_lens) + gen
    # `compressed` quantizes the pruned arm, so the reference quantizes too
    ref, lm = build_masked_reference_engine(
        arch, smoke, sparsity=sparsity, quantized=(quantized or compressed),
        max_slots=max_slots, max_seq=max_seq, seed=seed, device=device)
    for p in synthetic_prompts(lm.cfg, prompt_lens, seed):
        ref.submit(p, gen)
    ref.warmup()
    want = ref.run()
    got = engine_serve(arch, smoke, prompt_lens, gen, quantized=quantized,
                       compressed=compressed, pruned=True, sparsity=sparsity,
                       max_slots=max_slots, seed=seed, verbose=verbose,
                       device=device)
    _assert_same(got, want, "pruned decode diverged from the masked "
                            "reference")
    print(f"{arch}: pruned decode (sparsity {sparsity:.2f}) token-identical "
          f"to the masked dense reference over {len(want)} requests")
    return got


def packed_parity_check(arch: str, smoke: bool, prompt_lens: list[int],
                        gen: int, *, pruned: bool = False,
                        sparsity: float = 0.5, bits_init: float = 8.0,
                        max_slots: int, seed: int = 0, verbose: bool = True,
                        device=None) -> dict:
    """Assert the packed engine's decode is token-identical to the
    unpacked int8 path at the same seed and quantizer init: the packing
    round trip is exact and the GEMM sums the decoded weights in the same
    order, so every greedy token must match. Stacks with `pruned` (both
    arms serve the same sliced shapes). Returns the packed engine's
    output."""
    common = dict(compressed=True, pruned=pruned, sparsity=sparsity,
                  bits_init=bits_init, max_slots=max_slots, seed=seed,
                  device=device)
    want = engine_serve(arch, smoke, prompt_lens, gen, verbose=False,
                        **common)
    got = engine_serve(arch, smoke, prompt_lens, gen, packed=True,
                       verbose=verbose, **common)
    _assert_same(got, want, "packed decode diverged from the unpacked int8 "
                            "reference")
    print(f"{arch}: packed decode token-identical to the unpacked int8 "
          f"path over {len(want)} requests"
          + (f" (pruned @ {sparsity:.2f})" if pruned else ""))
    return got


def paged_parity_check(arch: str, smoke: bool, prompt_lens: list[int],
                       gen: int, *, quantized: bool = True,
                       compressed: bool = False, packed: bool = False,
                       pruned: bool = False, sparsity: float = 0.5,
                       bits_init: float = 8.0, speculative: bool = False,
                       draft_k: int = 4, draft_sparsity: float = 0.5,
                       draft_bits: float = 2.0, page_size: int = 16,
                       prefix_sharing: bool = True,
                       max_slots: int, seed: int = 0, verbose: bool = True,
                       device=None) -> dict:
    """Assert the paged engine's decode is token-identical to the
    contiguous arena's on the same weights, prompts and seed, in any of
    the weight modes. The paged arena changes only where KV rows live:
    the page-indirect kernel runs the contiguous kernel's arithmetic in
    its order over the same rows, a speculative round runs on contiguous
    views of the pages of the contiguous arena's shape, and prefix
    sharing reuses only bitwise-equal whole-prompt pages, so every greedy
    token must match. Stacks with `pruned` (the pools take the sliced KV
    heads) and `speculative` (the draft's pools page through the same
    tables). Returns the paged engine's output."""
    common = dict(quantized=quantized, compressed=compressed, packed=packed,
                  pruned=pruned, sparsity=sparsity, bits_init=bits_init,
                  max_slots=max_slots, seed=seed, device=device)
    if speculative:
        common.update(speculative=True, draft_k=draft_k,
                      draft_sparsity=draft_sparsity, draft_bits=draft_bits)
    want = engine_serve(arch, smoke, prompt_lens, gen, verbose=False,
                        **common)
    got = engine_serve(arch, smoke, prompt_lens, gen, verbose=verbose,
                       paged=True, page_size=page_size,
                       prefix_sharing=prefix_sharing, **common)
    _assert_same(got, want, "paged decode diverged from the contiguous "
                            "arena")
    mode = "packed" if packed else "compressed" if compressed else "dense"
    if pruned:
        mode += f"+pruned@{sparsity:.2f}"
    if speculative:
        mode += f"+spec(k={draft_k})"
    print(f"{arch}: paged KV decode (page_size={page_size}) "
          f"token-identical to the contiguous arena over {len(want)} "
          f"requests ({mode})")
    return got


def speculative_parity_check(arch: str, smoke: bool,
                             prompt_lens: list[int], gen: int, *,
                             quantized: bool = True,
                             compressed: bool = False, packed: bool = False,
                             pruned: bool = False, sparsity: float = 0.5,
                             bits_init: float = 8.0, draft_k: int = 4,
                             draft_sparsity: float = 0.5,
                             draft_bits: float = 2.0, max_slots: int,
                             seed: int = 0, verbose: bool = True,
                             device=None) -> dict:
    """Assert the speculative engine's decode is token-identical to the
    plain engine's on the same target weights, prompts and seed: a round
    commits only the target's argmaxes, so any divergence means the
    rollback or the position bookkeeping corrupted an arena. Holds
    exactly where the verify pass and the decode step sum alike (f32, as
    the smoke config runs). Returns the speculative engine's output."""
    common = dict(quantized=quantized, compressed=compressed, packed=packed,
                  pruned=pruned, sparsity=sparsity, bits_init=bits_init,
                  max_slots=max_slots, seed=seed, device=device)
    want = engine_serve(arch, smoke, prompt_lens, gen, verbose=False,
                        **common)
    got = engine_serve(arch, smoke, prompt_lens, gen, verbose=verbose,
                       speculative=True, draft_k=draft_k,
                       draft_sparsity=draft_sparsity, draft_bits=draft_bits,
                       **common)
    _assert_same(got, want, "speculative decode diverged from the "
                            "non-speculative engine")
    print(f"{arch}: speculative decode (draft k={draft_k}, "
          f"s{100 * draft_sparsity:.0f}/b{draft_bits:.0f}) token-identical "
          f"to the non-speculative engine over {len(want)} requests")
    return got


def _tp_label(st: dict) -> str:
    tp = st.get("tp") or {}
    fb = tp.get("replicated_fallbacks") or []
    return (f"{tp.get('backend')}"
            f"{' host-staged' if tp.get('staging') else ''}, decode "
            f"{st.get('decode_mode')}, per-rank param bytes "
            f"{tp.get('param_bytes_per_device')} of {tp.get('param_bytes')},"
            f" kv bytes at build {tp.get('kv_bytes_per_device')} of "
            f"{tp.get('kv_bytes')}; replicated fallbacks: "
            f"{', '.join(fb) if fb else 'none'}")


def tp_parity_check(arch: str, smoke: bool, prompt_lens: list[int],
                    gen: int, *, tp: int, quantized: bool = True,
                    compressed: bool = False, packed: bool = False,
                    pruned: bool = False, sparsity: float = 0.5,
                    bits_init: float = 8.0, speculative: bool = False,
                    draft_k: int = 4, draft_sparsity: float = 0.5,
                    draft_bits: float = 2.0, paged: bool = False,
                    page_size: int = 16, kv_bits: int | None = None,
                    prefix_sharing: bool = True,
                    prefill_chunk: int | None = None, max_slots: int,
                    seed: int = 0, verbose: bool = True,
                    device=None) -> dict:
    """Assert the tensor-parallel engine (tp ranks) emits the one-rank
    engine's tokens on the same weights, prompts and seed, across the
    whole serving stack. Column-parallel products give each column the
    one-rank arithmetic; products sharded on K (wo, w_down) sum their
    partials in rank order, which reassociates the one-rank sum, so the
    check holds where those ulps flip no argmax (f32, as the smoke config
    runs; the reference's check holds as much). Returns the TP engine's
    output and prints its transport, decode mode, per-rank bytes and
    replication fallbacks."""
    common = dict(quantized=quantized, compressed=compressed, packed=packed,
                  pruned=pruned, sparsity=sparsity, bits_init=bits_init,
                  speculative=speculative, draft_k=draft_k,
                  draft_sparsity=draft_sparsity, draft_bits=draft_bits,
                  paged=paged, page_size=page_size, kv_bits=kv_bits,
                  prefix_sharing=prefix_sharing,
                  prefill_chunk=prefill_chunk, max_slots=max_slots,
                  seed=seed, device=device)
    want = engine_serve(arch, smoke, prompt_lens, gen, verbose=False,
                        **common)
    st: dict = {}
    got = engine_serve(arch, smoke, prompt_lens, gen, verbose=verbose,
                       tp=tp, stats=st, **common)
    _assert_same(got, want, f"tp={tp} decode diverged from the "
                            f"single-device engine")
    mode = "packed" if packed else "compressed" if compressed else "dense"
    if pruned:
        mode += f"+pruned@{sparsity:.2f}"
    if paged:
        mode += "+paged"
    if speculative:
        mode += f"+spec(k={draft_k})"
    if prefill_chunk:
        mode += f"+chunked@{prefill_chunk}"
    print(f"{arch}: tp={tp} decode token-identical to the single-device "
          f"engine over {len(want)} requests ({mode}); {_tp_label(st)}")
    return got


def chunked_prefill_parity_check(arch: str, smoke: bool,
                                 prompt_lens: list[int], gen: int, *,
                                 prefill_chunk: int, quantized: bool = True,
                                 compressed: bool = False,
                                 packed: bool = False, pruned: bool = False,
                                 sparsity: float = 0.5,
                                 bits_init: float = 8.0, paged: bool = False,
                                 page_size: int = 16, max_slots: int,
                                 seed: int = 0, verbose: bool = True,
                                 device=None, tp: int = 0) -> dict:
    """Assert the chunked-prefill engine's decode is token-identical to
    the one-shot engine's, and that decode ran while a prompt was
    mid-prefill whenever a later prompt needed several chunks; `tp`
    runs both arms on that many ranks. Returns the chunked engine's
    output."""
    common = dict(quantized=quantized, compressed=compressed, packed=packed,
                  pruned=pruned, sparsity=sparsity, bits_init=bits_init,
                  paged=paged, page_size=page_size, max_slots=max_slots,
                  seed=seed, device=device, tp=tp)
    want = engine_serve(arch, smoke, prompt_lens, gen, verbose=False,
                        **common)
    st: dict = {}
    got = engine_serve(arch, smoke, prompt_lens, gen, verbose=verbose,
                       prefill_chunk=prefill_chunk, stats=st, **common)
    _assert_same(got, want, f"chunked prefill (chunk={prefill_chunk}) "
                            f"diverged from the one-shot engine")
    if len(prompt_lens) > 1 and any(n > prefill_chunk
                                    for n in prompt_lens[1:]):
        # a later prompt took several chunks while request 0 decoded
        assert st["decode_steps_mid_prefill"] > 0, st
    print(f"{arch}: chunked prefill (chunk={prefill_chunk}) "
          f"token-identical to the one-shot engine over {len(want)} "
          f"requests; {st['prefill_chunks']} chunks, "
          f"{st['decode_steps_mid_prefill']} decode steps ran mid-prefill")
    return got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--static", action="store_true", default=False,
                    help="the lockstep serve_loop instead of the "
                         "continuous-batching engine")
    ap.add_argument("--batch", type=int, default=4,
                    help="static mode: lockstep batch size")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="static mode: shared prompt length")
    ap.add_argument("--prompt-lens", default="16,16,16,16",
                    help="comma-separated per-request prompt lengths")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--no-quant", dest="quantized", action="store_false",
                    default=True)
    ap.add_argument("--compressed", action="store_true", default=False,
                    help="decode from int codes through the dequant GEMM "
                         "epilogue (implies quantization)")
    ap.add_argument("--packed", action="store_true", default=False,
                    help="store the codes as sub-byte packed int32 words "
                         "and decode through the unpack-dequant epilogue "
                         "(implies --compressed); in --smoke mode also "
                         "asserts tokens identical to the int8 path")
    ap.add_argument("--bits", type=float, default=8.0,
                    help="quantizer init width (--packed --bits 4 serves a "
                         "4-bit artifact)")
    ap.add_argument("--paged", action="store_true", default=False,
                    help="serve from the paged KV arena (shared page pools "
                         "behind per-slot page tables, prefix sharing); in "
                         "--smoke mode also asserts tokens identical to "
                         "the contiguous arena")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged mode: KV rows per page")
    ap.add_argument("--kv-bits", type=int, choices=(8, 4), default=None,
                    help="paged mode: store pages as int8 or int4 codes "
                         "with per-row scales (implies --paged)")
    ap.add_argument("--pruned", action="store_true", default=False,
                    help="serve the physically sliced subnet at magnitude "
                         "masks of --sparsity (smaller GEMMs and KV arena); "
                         "in --smoke mode alone also asserts tokens "
                         "identical to the masked dense reference")
    ap.add_argument("--sparsity", type=float, default=0.5,
                    help="pruned mode: target fraction of prunable units "
                         "removed")
    ap.add_argument("--speculative", action="store_true", default=False,
                    help="self-speculative decoding: a pruned, packed "
                         "subnet of the same init params drafts up to "
                         "--draft-k tokens a round and the target verifies "
                         "them in one chunked pass; the tokens are always "
                         "the target's (in --smoke mode also asserts them "
                         "identical to the non-speculative engine's)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative mode: most draft proposals a round")
    ap.add_argument("--draft-sparsity", type=float, default=50.0,
                    help="speculative mode: the draft's sparsity, a "
                         "percentage (50) or a fraction (0.5); 0 keeps all "
                         "units (a packed-only draft)")
    ap.add_argument("--draft-bits", type=float, default=2.0,
                    help="speculative mode: the draft's quantizer init "
                         "width (packed storage bits)")
    ap.add_argument("--chunked-prefill", type=int, default=None,
                    metavar="CHUNK",
                    help="prefill each prompt CHUNK rows at a time between "
                         "decode steps (in --smoke mode also asserts tokens "
                         "identical to the one-shot engine's)")
    ap.add_argument("--tp", type=int, default=0,
                    help="serve tensor-parallel on N ranks: params shard by "
                         "attention head, MLP hidden, vocab, expert, mamba "
                         "channel and rwkv head, the KV arena by KV head "
                         "and the recurrent state with its channels; in "
                         "--smoke mode also asserts tokens identical to the "
                         "one-rank engine's")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    prune = dict(pruned=args.pruned, sparsity=args.sparsity)
    cfg = get_arch(args.arch, smoke=args.smoke)
    recurrent = recurrent_mixers(layer_plan(cfg)[0])
    if not args.static and (cfg.num_codebooks or cfg.vision_patches):
        # the engine serves plain token prompts; the reference serves
        # these archs through the lockstep loop
        print(f"{args.arch}: codebook/VLM prompts need a modality frontend "
              f"-- serving through the static loop")
        args.static = True
    if args.static:
        serve_loop(args.arch, args.smoke, args.batch, args.prompt_len,
                   args.gen, quantized=args.quantized,
                   compressed=args.compressed, packed=args.packed,
                   bits_init=args.bits, device=args.device, **prune)
        return
    lens = [int(x) for x in args.prompt_lens.split(",")]
    # --kv-bits quantizes the paged page store: asking for it asks for
    # the paged arena
    args.paged = args.paged or args.kv_bits is not None
    arena = {}
    if args.paged and recurrent:
        # a prefix hit would skip the prefill that sets a slot's state
        arena["prefix_sharing"] = False
        print(f"{args.arch}: paged arena without prefix sharing (the plan "
              f"has {recurrent} mixers, whose per-slot state only a "
              f"prefill sets)")
    # `--draft-sparsity 50` and `--draft-sparsity 0.5` mean the same
    draft_sparsity = (args.draft_sparsity / 100.0
                      if args.draft_sparsity > 1.0 else args.draft_sparsity)
    spec = dict(draft_k=args.draft_k, draft_sparsity=draft_sparsity,
                draft_bits=args.draft_bits)
    weights = dict(quantized=args.quantized, compressed=args.compressed,
                   packed=args.packed, bits_init=args.bits)
    if args.tp > 1 and args.smoke:
        tp_parity_check(args.arch, args.smoke, lens, args.gen, tp=args.tp,
                        speculative=args.speculative, paged=args.paged,
                        page_size=args.page_size, kv_bits=args.kv_bits,
                        prefill_chunk=args.chunked_prefill,
                        max_slots=args.slots, device=args.device,
                        **arena, **weights, **spec, **prune)
        return
    if args.chunked_prefill and args.smoke:
        chunked_prefill_parity_check(
            args.arch, args.smoke, lens, args.gen,
            prefill_chunk=args.chunked_prefill, paged=args.paged,
            page_size=args.page_size, max_slots=args.slots,
            device=args.device, **weights, **prune)
        return
    if args.paged and args.smoke and args.kv_bits is None:
        paged_parity_check(args.arch, args.smoke, lens, args.gen,
                           speculative=args.speculative,
                           page_size=args.page_size, max_slots=args.slots,
                           device=args.device, **arena, **weights, **spec,
                           **prune)
        return
    if args.speculative and args.smoke:
        speculative_parity_check(args.arch, args.smoke, lens, args.gen,
                                 max_slots=args.slots, device=args.device,
                                 **weights, **spec, **prune)
        return
    if args.packed and args.smoke:
        packed_parity_check(args.arch, args.smoke, lens, args.gen,
                            bits_init=args.bits, max_slots=args.slots,
                            device=args.device, **prune)
        return
    moe = cfg.moe is not None
    if args.pruned and args.smoke and moe:
        print(f"{args.arch}: no masked-reference check for a pruned MoE "
              f"(a zeroed router column still takes softmax mass, so the "
              f"masked model routes otherwise than the sliced one)")
    if args.pruned and args.smoke and not args.paged and not moe:
        pruned_parity_check(args.arch, args.smoke, lens, args.gen,
                            sparsity=args.sparsity, quantized=args.quantized,
                            compressed=args.compressed, max_slots=args.slots,
                            device=args.device)
        return
    engine_serve(args.arch, args.smoke, lens, args.gen,
                 max_slots=args.slots, device=args.device, paged=args.paged,
                 page_size=args.page_size, kv_bits=args.kv_bits,
                 speculative=args.speculative, tp=args.tp,
                 prefill_chunk=args.chunked_prefill, **arena, **weights,
                 **(spec if args.speculative else {}), **prune)


if __name__ == "__main__":
    main()

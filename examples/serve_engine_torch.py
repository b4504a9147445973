"""Drive the port's continuous-batching engine over mixed-length requests:
the PyTorch/CUDA twin of `examples/serve_engine.py`.

Submits a handful of requests with different prompt lengths and token
budgets, warms the engine up (on CUDA this captures one CUDA graph per
decode-window length), drains it, and prints each request's generated
tokens plus the throughput counters (decode tok/s, one-shot prefill
tok/s, slot occupancy). `--compressed` serves from int8 codes through the
GEMM kernel's dequant epilogue; `--packed` bit-packs the codes at their
storage width (unpack-dequant epilogue; `--bits 4` serves a 4-bit
artifact). `--paged` swaps the per-slot contiguous KV arena for the paged
one: page-granular KV, identical prompts share refcounted pages and skip
their prefill (`--hot-prompt` sends every request the same prompt; watch
`prefix_hits`), and `--kv-bits 8|4` stores the pages as int8 or int4
codes. `--pruned --sparsity S` serves the physically sliced subnet at
magnitude masks of sparsity S (fewer KV heads and MLP units: smaller
GEMMs and KV arena), in any weight mode and arena. `--speculative`
attaches the self-speculative draft (the same init params sliced to
`--draft-sparsity` and packed at `--draft-bits`) proposing up to
`--draft-k` tokens a round, which the target verifies in one chunked
pass; the report adds the acceptance rate. `--chunked-prefill C`
prefills each prompt C rows at a time between decode steps; the report
adds the chunks and the decode steps that ran mid-prefill. `--tp N`
serves tensor-parallel on N ranks (processes; `--devices N` starts N
ranks and serves at tp N): each holds its shards of the params and the KV
arena (an MoE's experts, mamba's channels and rwkv6's heads included),
every rank emits the same tokens and rank 0 prints; a mode the arch
refuses on one rank (`--speculative` or `--chunked-prefill` on a
recurrent arch) raises its ValueError before any rank starts.
`--arch grok-1-314b` serves the MoE family, `--arch rwkv6-3b` and `--arch
jamba-1.5-large-398b` serve the recurrent mixers; their paged arena runs
without prefix sharing (a prefix hit would skip the prefill that sets a
slot's recurrent state), which the example turns off and prints. Codebook
and VLM archs (`--arch musicgen-large`, `--arch internvl2-26b`) exit with
the engine's refusal: they serve through the static loop
(`python -m repro_torch.launch.serve --arch musicgen-large --smoke
--device cpu`).

Runs on CUDA by default; `--device cpu` runs the kernels' plain PyTorch
versions and decodes its windows eagerly:

    PYTHONPATH=src python examples/serve_engine_torch.py --packed --bits 4 \
        --prompt-lens 16,4,9,12 --gens 24,8,16,12 --slots 2 --device cpu

    PYTHONPATH=src python examples/serve_engine_torch.py --paged \
        --kv-bits 8 --hot-prompt --prompt-lens 16,16,16,9 --gens 12 \
        --slots 2 --device cpu

    PYTHONPATH=src python examples/serve_engine_torch.py --pruned \
        --sparsity 0.3 --compressed --device cpu

    PYTHONPATH=src python examples/serve_engine_torch.py --speculative \
        --draft-k 4 --draft-sparsity 0 --draft-bits 8 --device cpu

    PYTHONPATH=src python examples/serve_engine_torch.py \
        --chunked-prefill 8 --device cpu

    PYTHONPATH=src python examples/serve_engine_torch.py --tp 2 \
        --compressed --device cpu

    PYTHONPATH=src python examples/serve_engine_torch.py --tp 2 \
        --arch grok-1-314b --device cpu
"""
import argparse

from repro_torch.configs import get_arch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.engine import (PLAIN_TOKENS_ONLY, build_engine,
                                       check_modes, resolve_device,
                                       synthetic_prompts)
from repro_torch.models.transformer import LM, layer_plan, recurrent_mixers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--prompt-lens", default="16,4,9,12",
                    help="comma-separated per-request prompt lengths")
    ap.add_argument("--gens", default="24,8,16,12",
                    help="comma-separated per-request token budgets "
                         "(a single value broadcasts)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--no-quant", dest="quant", action="store_false",
                    default=True)
    ap.add_argument("--compressed", action="store_true", default=False,
                    help="decode from int codes (the dequant GEMM "
                         "epilogue) instead of dense weights")
    ap.add_argument("--packed", action="store_true", default=False,
                    help="bit-pack the codes at each site's storage width "
                         "and decode via the unpack-dequant epilogue "
                         "(implies --compressed)")
    ap.add_argument("--bits", type=float, default=8.0,
                    help="quantizer init width (4 serves a 4-bit packed "
                         "artifact)")
    ap.add_argument("--paged", action="store_true", default=False,
                    help="paged KV arena: page-granular allocation and "
                         "whole-prompt prefix sharing")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged mode: KV rows per page")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[4, 8],
                    help="paged mode: int8/int4 page store (implies "
                         "--paged)")
    ap.add_argument("--hot-prompt", action="store_true", default=False,
                    help="requests send prefixes of the first request's "
                         "tokens, so equal lengths share one prompt")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--pruned", action="store_true", default=False,
                    help="serve the physically sliced subnet at magnitude "
                         "masks of --sparsity")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--speculative", action="store_true", default=False,
                    help="draft/verify decoding: a sliced, packed subnet "
                         "of the same init params drafts tokens, the "
                         "target verifies them in one chunked pass")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="most proposals a speculative round")
    ap.add_argument("--draft-sparsity", type=float, default=0.5,
                    help="draft subnet sparsity (0 keeps all units)")
    ap.add_argument("--draft-bits", type=float, default=8.0,
                    help="draft quantizer width (8 tracks the target "
                         "closely; 2 is cheap but rarely accepted)")
    ap.add_argument("--chunked-prefill", type=int, default=None,
                    metavar="CHUNK",
                    help="prefill prompts at most CHUNK rows a step into a "
                         "staging row, so decode runs on mid-prefill")
    ap.add_argument("--tp", type=int, default=0,
                    help="serve tensor-parallel on this many ranks")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to start (serves at --tp, default N)")
    args = ap.parse_args(argv)
    if args.kv_bits is not None:
        args.paged = True
    args.tp = args.tp or args.devices
    if args.tp > 1:
        # a mode one rank refuses fails here, before any rank starts
        check_modes(LM(get_arch(args.arch, smoke=True)),
                    speculative=args.speculative,
                    prefill_chunk=args.chunked_prefill)
        if args.devices and args.devices < args.tp:
            raise SystemExit("--devices must be at least --tp")
        return meshlib.spawn(serve, args.devices or args.tp,
                             str(resolve_device(args.device)), args)[0]
    return serve(args)


def serve(args):
    """The example on this process, or on this rank of a --tp group."""
    say = print if meshlib.world()[0] == 0 else (lambda *a, **k: None)

    lens = [int(x) for x in args.prompt_lens.split(",")]
    gens = [int(x) for x in args.gens.split(",")]
    if len(gens) == 1:
        gens = gens * len(lens)
    if len(gens) != len(lens):
        raise SystemExit("--gens must match --prompt-lens")

    cfg = get_arch(args.arch, smoke=True)
    if cfg.num_codebooks or cfg.vision_patches:
        raise SystemExit(f"{args.arch}: {PLAIN_TOKENS_ONLY}")
    recurrent = recurrent_mixers(layer_plan(cfg)[0])
    if args.paged and recurrent:
        say(f"{args.arch}: paged arena without prefix sharing ({recurrent} "
              f"mixers keep a per-slot state only a prefill sets)")
    eng, lm = build_engine(args.arch, smoke=True, quantized=args.quant,
                           compressed=args.compressed, packed=args.packed,
                           bits_init=args.bits, max_slots=args.slots,
                           max_seq=max(p + g for p, g in zip(lens, gens)),
                           verbose=meshlib.world()[0] == 0,
                           device=args.device,
                           paged=args.paged, page_size=args.page_size,
                           kv_bits=args.kv_bits, pruned=args.pruned,
                           sparsity=args.sparsity,
                           speculative=args.speculative,
                           draft_k=args.draft_k,
                           draft_sparsity=args.draft_sparsity,
                           draft_bits=args.draft_bits, tp=args.tp,
                           prefill_chunk=args.chunked_prefill,
                           prefix_sharing=not (args.paged and recurrent))
    prompts = synthetic_prompts(lm.cfg, lens)
    if args.hot_prompt:
        prompts = [prompts[0][:n].copy() for n in lens]
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.warmup()
    out = eng.run()
    for rid, n, g in zip(rids, lens, gens):
        toks = " ".join(str(t) for t in out[rid][:12])
        more = " ..." if len(out[rid]) > 12 else ""
        say(f"request {rid}: prompt {n} tokens -> {len(out[rid])}/{g} "
              f"generated: {toks}{more}")
    th = eng.throughput()
    s = eng.stats
    line = (f"decode on {eng.device}: {s['decode_tokens']} tokens in "
            f"{s['decode_s']:.2f}s ({th['decode_tok_per_s']:.1f} tok/s, "
            f"occupancy {th['slot_occupancy']:.2f} over {args.slots} "
            f"slots); {'chunked' if args.chunked_prefill else 'one-shot'} "
            f"prefill: {s['prefill_tokens']} tokens "
            f"({th['prefill_tok_per_s']:.1f} tok/s)")
    if eng.graphs:
        kind = "rounds" if eng.draft is not None else "windows"
        line += (f"; {len(eng.graphs)} CUDA graph {kind} captured in "
                 f"{s['capture_s']:.2f}s, replays {dict(eng.replays)}")
    if args.speculative:
        line += (f"; speculative: {s['spec_accepted']}/{s['spec_drafted']} "
                 f"drafted tokens accepted ({th['acceptance_rate']:.2f}) "
                 f"over {s['spec_steps']} rounds")
    if args.chunked_prefill:
        line += (f"; chunked@{args.chunked_prefill}: "
                 f"{s['prefill_chunks']} chunks, "
                 f"{s['decode_steps_mid_prefill']} decode steps "
                 f"mid-prefill")
    if args.paged:
        line += (f"; paged: {s['prefills']} prefills, "
                 f"{s['prefix_hits']} prefix hits, kv_bytes "
                 f"{eng.kv_bytes()} of {eng.kv_pool_bytes()} pooled")
    if eng.mesh is not None:
        line += (f"; tp {eng.mesh.size} over {eng.mesh.backend}, decode "
                 f"{eng.decode_mode}, per-rank param bytes "
                 f"{eng.param_bytes(per_device=True)} of "
                 f"{eng.param_bytes()}")
    say(line)
    return out


if __name__ == "__main__":
    main()

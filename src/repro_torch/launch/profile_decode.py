"""Where a decode step's time goes: host wall time per engine decode step
against the device time of the kernels it launched, at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--mode dense|compressed|packed_b4] [--paged] [--window K]
        [--pruned [--sparsity S]] [--speculative K]
        [--prefill S [--chunk C]]

Serves internlm2-1.8b at full width with every one of its 4 slots holding
a 128-token prompt, then times 8 batched decode steps on the host clock
(each ends in a device sync) and profiles 8 more with `torch.profiler`
(the card's activity only).
Prints, per step: the wall time, the device busy time (the union of its
kernels' intervals: the decode-attention combine pass starts while its
split kernel runs), the device's idle share, the device ms and calls of
the small-M GEMM kernels (`gemm_small_m`, every decode projection and the
head) and of decode attention (the union of its split and combine
kernels), the top kernels by device time, and every kernel of those two
families by name with its device ms and calls per step. `--paged` serves
from the paged KV arena (bf16 pages of 16 rows); `--pruned` serves the
sliced subnet at magnitude masks of `--sparsity` (default 0.3: d_ff 5734,
6 of 8 KV heads). Needs a CUDA device.

Without `--window` the steps are the engine's eager `step()` decodes.
`--window K` times `run()`'s decode windows of K steps instead: the
engine's MAX_WINDOW set to K before `warmup()` and every budget a
multiple of K, 8 windows on the host clock (each ends in its one sync)
and 32 / K more profiled (at least one; a long trace loses events),
reported per step (a window's numbers over K), with
the engine's capture time and graph pool bytes where it captured its
windows as CUDA graphs. The window mode reads only the engine's
`warmup`, `_admit`, `_window` and `MAX_WINDOW`, so pointed at an older
checkout's package (`PYTHONPATH=OTHER/src python
src/repro_torch/launch/profile_decode.py --window 8`) it times that
engine's windows. A short profiler session runs before the engine is
built, so the tracer is up before any graph is captured.

`--speculative K` times the speculative rounds of the checkpoint pair
(`launch.speculative.build_checkpoint_engines`: the target at sparsity
0.5's masks, `--mode` dense or compressed, its s50 subnet packed at
DRAFT_BITS, the faithful draft) with every round at draft length K (a power
of two: budgets long enough that no slot caps it), replaying the round
graphs `warmup()` captured: 8 rounds on the host clock and 8 profiled,
reported per round, with the committed tokens per round and the
tensor-core GEMMs (`gemm_tc`, the verify pass's projections from M = 12)
as their own family. `--prefill S` times the prefill of one S-token
prompt instead, one-shot into a fresh row, or with `--chunk C` one chunk
of C rows (`LM.verify_chunk`) at position S - C of a staging row: eager,
8 calls timed and 8 profiled.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.engine import (WEIGHT_MODES, build_engine,
                                       synthetic_prompts)

ARCH = "internlm2-1.8b"
SLOTS = 4
PROMPT_LEN = 128
STEPS = 8
WINDOWS = 8
PROFILED_STEPS = 32       # window mode: steps of the profiled windows
DRAFT_BITS = 8.0          # speculative mode: the faithful draft's bits
DECODE_ATTN = "flash_decode"     # the decode-attention kernels' names
SMALL_M = "gemm_small_m"         # the small-M GEMM kernels' names
TC = "gemm_tc"                   # the tensor-core GEMM kernels' names
ACTS = [torch.profiler.ProfilerActivity.CUDA]


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _union_ms(events) -> float:
    """Length of the union of the events' [start, end) device intervals."""
    total, covered = 0.0, float("-inf")
    for start, stop in sorted((ev.time_range.start, ev.time_range.end)
                              for ev in events):
        if stop > covered:
            total += stop - max(start, covered)
            covered = stop
    return total / 1e3


def _timed(fn, reps: int, profiled: int) -> tuple[float, object]:
    """(host ms of `reps` calls of fn, each ending in a sync; the profile
    of `profiled` more)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=ACTS) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    return wall_ms, prof


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=list(WEIGHT_MODES), default="compressed")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV arena")
    ap.add_argument("--window", type=int, default=None, metavar="K",
                    help="time run()'s decode windows of K steps")
    ap.add_argument("--pruned", action="store_true",
                    help="serve the sliced subnet at --sparsity")
    ap.add_argument("--sparsity", type=float, default=0.3)
    ap.add_argument("--speculative", type=int, default=None, metavar="K",
                    help="time speculative rounds of draft length K of the "
                         "checkpoint pair")
    ap.add_argument("--prefill", type=int, default=None, metavar="S",
                    help="time the prefill of one S-token prompt")
    ap.add_argument("--chunk", type=int, default=None, metavar="C",
                    help="prefill mode: one chunk of C rows at S - C")
    args = ap.parse_args(argv)
    if args.speculative is not None:
        if args.mode == "packed_b4" or args.window or args.pruned:
            ap.error("--speculative serves the dense or compressed target "
                     "of the checkpoint pair, in rounds, unpruned")
        return _main_speculative(args)
    if args.prefill is not None:
        return _main_prefill(args)
    # an older engine's build_engine may not take the pruned keywords
    prune = (dict(pruned=True, sparsity=args.sparsity) if args.pruned
             else {})
    k = args.window or 1
    with torch.profiler.profile(activities=ACTS):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    reps = WINDOWS if args.window else STEPS
    profiled = max(1, PROFILED_STEPS // k) if args.window else STEPS
    gen = 1 + k * (2 + reps + profiled)
    eng, lm = build_engine(ARCH, False, max_slots=SLOTS,
                           max_seq=PROMPT_LEN + gen, device="cuda",
                           paged=args.paged, **WEIGHT_MODES[args.mode],
                           **prune)
    for p in synthetic_prompts(lm.cfg, [PROMPT_LEN] * SLOTS):
        eng.submit(p, gen)
    if args.window:
        eng.MAX_WINDOW = k       # every window k steps
    torch.cuda.reset_peak_memory_stats()
    eng.warmup()
    eng._admit()
    fn = eng._window if args.window else eng._act_decode
    for _ in range(2):
        fn()
    wall_ms, prof = _timed(fn, reps, profiled)
    wall_ms /= reps * k
    steps = profiled * k
    # device-side events only: a CPU op's device time repeats its kernels'
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, _device_us(e) / 1e3 / steps, e.count // steps)
                      for e in prof.key_averages()
                      if e.device_type == cuda and _device_us(e) > 0),
                     key=lambda r: -r[1])
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_ms = _union_ms(device_events) / steps
    attn = [r for r in kernels if DECODE_ATTN in r[0]]
    attn_ms = _union_ms([e for e in device_events
                         if DECODE_ATTN in e.key]) / steps
    gemm = [r for r in kernels if SMALL_M in r[0]]
    out = {"mode": args.mode, "paged": args.paged, "window": args.window,
           "sparsity": args.sparsity if args.pruned else None,
           "kv_bytes": eng.kv_bytes(), "param_bytes": eng.param_bytes(),
           "wall_ms_per_step": wall_ms, "device_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "decode_tok_per_s": SLOTS / wall_ms * 1e3,
           "small_m_ms_per_step": sum(ms for _, ms, _ in gemm),
           "small_m_calls_per_step": sum(n for *_, n in gemm),
           "decode_attn_ms_per_step": attn_ms,
           "kernels_per_step": len(device_events) / steps,
           "capture_s": eng.stats.get("capture_s"),
           "graph_pool_bytes": getattr(eng, "graph_pool_bytes", None),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    arena = "paged" if args.paged else "contiguous"
    if args.pruned:
        arena += f", pruned at sparsity {args.sparsity}"
    what = (f"decode window of {k} steps" if args.window else
            "decode step (eager)")
    print(f"{ARCH} [{args.mode}, {arena} arena] {what} on "
          f"{torch.cuda.get_device_name(0)}, {SLOTS} slots at prompt "
          f"{PROMPT_LEN}: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms/step, idle share {out['idle_share']:.3f}, "
          f"decode {out['decode_tok_per_s']:.1f} tok/s, "
          f"{out['kernels_per_step']:.1f} kernels/step")
    graphs = getattr(eng, "graphs", None)
    print(f"  graphs: {sorted(graphs) if graphs else 'none (eager window)'}"
          f", capture {out['capture_s']} s, graph pool "
          f"{out['graph_pool_bytes']} B, peak allocated "
          f"{out['peak_bytes']} B")
    print(f"  small-M GEMMs ({SMALL_M}): {out['small_m_ms_per_step']:.4f} "
          f"ms/step of device time, {out['small_m_calls_per_step']} "
          f"calls/step")
    print(f"  decode attention: {attn_ms:.4f} ms/step of device time (the "
          f"union of its kernels), {sum(n for *_, n in attn)} calls/step")
    for name, ms, n in kernels[:12]:
        print(f"  {ms:9.4f} ms/step  {n:5d} calls/step  {name[:90]}")
    for label, family in (("small-M GEMM", gemm), ("decode attention", attn)):
        print(f"  {label} kernels:")
        for name, ms, n in family:
            print(f"  {ms:9.4f} ms/step  {n:5d} calls/step  {name[:90]}")
    return out


def _families(prof, units: int) -> dict:
    """Per unit (step, round or call): the device busy time, the kernels,
    and the device ms and calls of the small-M GEMMs, the tensor-core
    GEMMs and decode attention."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, _device_us(e) / 1e3 / units, e.count // units)
                      for e in prof.key_averages()
                      if e.device_type == cuda and _device_us(e) > 0),
                     key=lambda r: -r[1])
    events = [e for e in prof.events() if e.device_type == cuda]
    fam = {"kernels": kernels, "busy_ms": _union_ms(events) / units,
           "kernels_per_unit": len(events) / units}
    for label, tag in (("small_m", SMALL_M), ("tc", TC),
                       ("decode_attn", DECODE_ATTN)):
        rows = [r for r in kernels if tag in r[0]]
        fam[label + "_ms"] = _union_ms([e for e in events
                                        if tag in e.key]) / units
        fam[label + "_calls"] = sum(n for *_, n in rows)
    return fam


def _report(head: str, unit: str, wall_ms: float, fam: dict) -> None:
    print(f"{head}: wall {wall_ms:.3f} ms/{unit}, device busy "
          f"{fam['busy_ms']:.3f} ms/{unit}, idle share "
          f"{1.0 - fam['busy_ms'] / wall_ms:.3f}, "
          f"{fam['kernels_per_unit']:.1f} kernels/{unit}")
    for label in ("small_m", "tc", "decode_attn"):
        print(f"  {label}: {fam[label + '_ms']:.4f} ms/{unit} of device "
              f"time, {fam[label + '_calls']} calls/{unit}")
    for name, ms, n in fam["kernels"][:12]:
        print(f"  {ms:9.4f} ms/{unit}  {n:5d} calls/{unit}  {name[:90]}")


def _main_speculative(args) -> dict:
    from repro_torch.launch.speculative import build_checkpoint_engines
    k = args.speculative
    with torch.profiler.profile(activities=ACTS):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    gen = 2 + (k + 1) * (3 + STEPS + STEPS) + k
    eng, _, lm = build_checkpoint_engines(
        ARCH, False, sparsity=0.5, draft_bits=DRAFT_BITS, draft_k=k,
        max_slots=SLOTS, max_seq=PROMPT_LEN + gen,
        compressed=args.mode != "dense", device="cuda", paged=args.paged)
    for p in synthetic_prompts(lm.cfg, [PROMPT_LEN] * SLOTS):
        eng.submit(p, gen)
    torch.cuda.reset_peak_memory_stats()
    eng.warmup()
    eng._admit()
    fn = eng._spec_round
    for _ in range(2):
        fn()
    tok0 = eng.stats["decode_tokens"]
    wall_ms, prof = _timed(fn, STEPS, STEPS)
    if set(eng.spec_rounds) != {k}:
        raise RuntimeError(f"rounds ran at draft lengths "
                           f"{dict(eng.spec_rounds)}, not only {k}")
    wall_ms /= STEPS
    committed = (eng.stats["decode_tokens"] - tok0) / (2 * STEPS)
    fam = _families(prof, STEPS)
    out = {"mode": args.mode, "paged": args.paged, "speculative": k,
           "draft_bits": DRAFT_BITS, "wall_ms_per_round": wall_ms,
           "device_ms_per_round": fam["busy_ms"],
           "idle_share": 1.0 - fam["busy_ms"] / wall_ms,
           "committed_per_round": committed,
           "decode_tok_per_s": committed / wall_ms * 1e3,
           "acceptance_rate": eng.throughput()["acceptance_rate"],
           **{key: v for key, v in fam.items() if key != "kernels"},
           "capture_s": eng.stats["capture_s"],
           "graph_pool_bytes": eng.graph_pool_bytes,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    arena = "paged" if args.paged else "contiguous"
    _report(f"{ARCH} [{args.mode} target, draft s50/b"
            f"{DRAFT_BITS:.0f}, {arena} arena] speculative round of "
            f"draft length {k} (graph replay) on "
            f"{torch.cuda.get_device_name(0)}, {SLOTS} slots at prompt "
            f"{PROMPT_LEN}; {committed:.2f} tokens committed a round "
            f"({out['decode_tok_per_s']:.1f} tok/s), acceptance "
            f"{out['acceptance_rate']:.3f}", "round", wall_ms, fam)
    return out


def _main_prefill(args) -> dict:
    S, C = args.prefill, args.chunk
    with torch.profiler.profile(activities=ACTS):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    eng, lm = build_engine(ARCH, False, max_slots=1, max_seq=S + 1,
                           device="cuda", **WEIGHT_MODES[args.mode])
    toks = torch.as_tensor(synthetic_prompts(lm.cfg, [S])[0],
                           dtype=torch.int64, device="cuda")[None]
    p, q = eng._run_params, eng._run_qparams
    if C is None:
        def fn():
            lm.prefill(p, q, eng._fresh_row(), toks, last_logit_only=True)
    else:
        row = eng._fresh_row()
        pos = torch.full((1,), S - C, dtype=torch.int64, device="cuda")

        def fn():
            lm.verify_chunk(p, q, row, toks[:, S - C:], pos,
                            last_logit_only=True)
    with torch.no_grad():
        for _ in range(2):
            fn()
        wall_ms, prof = _timed(fn, STEPS, STEPS)
    wall_ms /= STEPS
    fam = _families(prof, STEPS)
    out = {"mode": args.mode, "prefill": S, "chunk": C,
           "wall_ms_per_call": wall_ms, "device_ms_per_call": fam["busy_ms"],
           "idle_share": 1.0 - fam["busy_ms"] / wall_ms,
           **{key: v for key, v in fam.items() if key != "kernels"}}
    what = (f"one-shot prefill of {S} tokens" if C is None else
            f"one chunk of {C} rows at position {S - C}")
    _report(f"{ARCH} [{args.mode}] {what} (eager) on "
            f"{torch.cuda.get_device_name(0)}", "call", wall_ms, fam)
    return out


if __name__ == "__main__":
    main()


"""Plan tuner for the GEMM core. Port of `repro.kernels.autotune`.

The reference tunes Pallas (bm, bn, bk) blocks. The port's blocks are
fixed by its kernels; what a call may choose is its plan (ROADMAP item
15c):

  tc       rows per block, bm in {128, 256}: a block decodes each weight
           tile it reads once, so 256 rows halve the decodes, while 128
           spread them over more SMs (`gemm_core.tc_block_m` picks by a
           wave count). The sums do not depend on bm: a tuned call is
           bitwise the untuned one.
  small_m  the K split: (cluster, k_slice) of `gemm_core.SmallMPlan`. The
           split fixes the order in which K is summed, so the key names
           no epilogue: one plan serves `dequant` and every
           `unpack_dequant` of a shape alike, and packed tokens still
           equal int8 tokens. `tp_gemm` looks up with the full N
           (`plan_n`), so its columns stay bitwise the 1-rank call's.
  simt     splits nothing; `autotune_gemm` refuses it.

`gemm_core.gemm` consults `lookup` on its CUDA and meta routes (and for
`introspect`'s record on the CPU route) before its rule
(`small_m_plan`, `tc_block_m`). A call made during a CUDA-graph capture
reads the table then; the replays keep the plan captured. With an empty
table every call takes the plan of the rule.

Keys are strings: ``"MxNxK|<epilogue>|tc|sm<count>"`` (the epilogue as
`ops_key` names it, as the reference does) and ``"MxNxK|small_m|sm<count>"``;
N is the local width (`plan_n` where given), and the SM count is the
card's, 132 off the card (`introspect.H100_SMS`). The table persists as
JSON to the file named by ``REPRO_GEMM_TUNE_CACHE`` (format
``"repro-gemm-tune-v1"``; unset: in memory only; a corrupt or missing file
never breaks a call). The variable names only that file: it never picks
a route or a variant, which the device decides.

`autotune_gemm` times the candidates on the card with CUDA events,
records the winner (`choose`: the rule's plan stays unless the fastest
beats it by more than the measured spread) and returns it with every
candidate's median ms; it refuses CPU tensors (the plain version has no
plan) and the SIMT variant.
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Optional, Sequence

ENV_VAR = "REPRO_GEMM_TUNE_CACHE"
FORMAT = "repro-gemm-tune-v1"
TC_HEIGHTS = (128, 256)
_SMALL_M_ROWS = range(8, 65, 8)      # rows per K-group of a tuned split

# key -> the plan as ints: (bm,) or (cluster, k_slice); seeded from the
# cache file on first use
_memory: dict[str, tuple[int, ...]] = {}
_loaded_from: Optional[str] = None


def cache_path() -> Optional[str]:
    return os.environ.get(ENV_VAR) or None


def ops_key(epi) -> str:
    """The epilogue as the reference's key names it: its ops' names in
    application order (`dense` for none)."""
    from repro_torch.kernels import gemm_core as gc
    return {gc.NONE: "dense", gc.FAKE_QUANT: "fake_quant",
            gc.FQ_MASK: "fake_quant+col_mask", gc.COL_MASK: "col_mask",
            gc.DEQUANT: "dequant",
            gc.UNPACK: f"unpack_dequant_b{epi.bits}"}[epi.name]


def key(M: int, N: int, K: int, variant: str, sm_count: int,
        ops: str = "") -> str:
    """The table key of a call (module doc); `ops` only for tc."""
    if variant == "small_m":
        return f"{M}x{N}x{K}|small_m|sm{sm_count}"
    if variant == "tc":
        return f"{M}x{N}x{K}|{ops}|tc|sm{sm_count}"
    raise ValueError(f"variant {variant!r} has no plan to tune")


def clear() -> None:
    """Drop the in-memory table. The file is never deleted."""
    global _loaded_from
    _memory.clear()
    _loaded_from = None


def load(path: Optional[str] = None) -> dict[str, tuple[int, ...]]:
    """Merge the persisted table (if any) into memory and return it."""
    global _loaded_from
    path = path or cache_path()
    if path and os.path.exists(path) and _loaded_from != path:
        try:
            with open(path) as f:
                raw = json.load(f)
            for k, v in raw.get("blocks", {}).items():
                _memory.setdefault(k, tuple(int(b) for b in v))
            _loaded_from = path
        except (json.JSONDecodeError, OSError, TypeError, ValueError,
                AttributeError):
            pass    # a corrupt cache must never break a call
    return dict(_memory)


def save(path: Optional[str] = None) -> Optional[str]:
    path = path or cache_path()
    if not path:
        return None
    payload = {"format": FORMAT,
               "blocks": {k: list(v) for k, v in sorted(_memory.items())}}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def active() -> bool:
    """Whether a call may find a plan: one is in memory or a file is
    named. `gemm_core.plan` asks this before it builds a key."""
    return bool(_memory) or cache_path() is not None


def lookup(M: int, N: int, K: int, variant: str, sm_count: int,
           ops: str = "") -> Optional[tuple[int, ...]]:
    path = cache_path()
    if path is None and not _memory:
        return None
    if path and _loaded_from != path:
        load()
    return _memory.get(key(M, N, K, variant, sm_count, ops))


def record(M: int, N: int, K: int, variant: str, sm_count: int,
           plan: Sequence[int], ops: str = "", *,
           persist: bool = True) -> None:
    _memory[key(M, N, K, variant, sm_count, ops)] = tuple(int(b)
                                                          for b in plan)
    if persist:
        save()


def candidate_plans(M: int, N: int, K: int, variant: str) -> list[tuple]:
    """The plans worth timing (the counterpart of `candidate_blocks`):
    tc, every bm; small_m, every (cluster, k_slice) split with rows per
    K-group a multiple of 8 up to 64 and a cluster of at most 8, and the
    splits past that whose k_slice is a multiple of the 2048-row window,
    without duplicates."""
    from repro_torch.kernels import gemm_core as gc
    if variant == gc.TC:
        return [(bm,) for bm in TC_HEIGHTS]
    if variant != gc.SMALL_M:
        raise ValueError(f"autotune: the {variant} variant splits nothing "
                         f"(nothing to tune)")
    slices = [gc.SMALL_M_GROUPS * rows for rows in _SMALL_M_ROWS]
    slices += [-(-K // (c * gc.SMALL_M_WINDOW)) * gc.SMALL_M_WINDOW
               for c in range(1, gc.SMALL_M_CLUSTER_MAX + 1)]
    out = []
    for k_slice in slices:
        plan = (-(-K // k_slice), k_slice)
        if plan[0] <= gc.SMALL_M_CLUSTER_MAX and plan not in out:
            out.append(plan)
    return out


def smem_filter(candidates, M: int, N: int, K: int, epi, variant: str,
                w_dtype, *, budget: Optional[int] = None):
    """Split candidate plans by `introspect`'s budget before any timing
    (the counterpart of `vmem_filter`): each resolves to the kernel
    `gemm` would launch (`gemm_core.kernel_of`). Returns (fits,
    rejected), `rejected` mapping a plan to its kernel's faults."""
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import introspect
    fits, rejected = [], {}
    for plan in candidates:
        kernel = gc.kernel_of(variant, M, N, K, epi, w_dtype,
                              gc.plan_of(variant, plan))
        bad = introspect.faults(kernel, budget)
        if bad:
            rejected[tuple(plan)] = bad
        else:
            fits.append(tuple(plan))
    return fits, rejected


_SLEEP_CYCLES = 200_000     # ~0.1 ms of device sleep before each timing


def _times_ms(torch, fn, repeats: int, flush) -> list[float]:
    """`repeats` CUDA-event times of fn(), each after L2 is flushed (a
    decode call finds its weights cold) and the device has slept long
    enough for the host to enqueue the call before the start event
    fires."""
    times = []
    for _ in range(max(1, repeats)):
        flush.zero_()
        torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def choose(samples: dict, rule: tuple) -> tuple:
    """The plan to record from each candidate's times: the fastest by
    median, unless the rule's plan is a candidate and the fastest's
    slowest time is not below the rule's fastest. A margin inside the
    measured spread is noise, and a small-M plan fixes the order in which
    K is summed, so recording a noise winner would change the numbers for
    nothing."""
    med = {p: statistics.median(t) for p, t in samples.items()}
    best = min(med, key=med.get)
    if (rule in samples and best != rule
            and max(samples[best]) >= min(samples[rule])):
        return rule
    return best


def autotune_gemm(x, w, epi, *, candidates=None, repeats: int = 3,
                  persist: bool = True, smem_budget: Optional[int] = None,
                  samples: Optional[dict] = None):
    """Time `gemm(x, w, epi)` on the card under each candidate plan (one
    untimed call each, then `repeats` CUDA-event times), record the winner
    (`choose`, against the rule's plan) and return (winner, {plan: median
    ms}); `samples`, where given, receives {plan: [ms, ...]}. The very next
    `gemm` call of this key takes the winner; the file gets it when
    ``REPRO_GEMM_TUNE_CACHE`` is set and `persist`. Candidates over the
    shared-memory budget (`smem_budget`, default `introspect`'s) are
    dropped before any timing. Raises ValueError on CPU tensors and on
    the SIMT variant."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import gemm_core as gc
    M, K = x.shape
    N = w.shape[1]
    variant = gc.variant(M, x.dtype)
    if variant == gc.SIMT:
        raise ValueError("autotune_gemm: the SIMT variant (f32 x, M > 8) "
                         "splits nothing (nothing to tune)")
    if x.device.type != "cuda":
        raise ValueError(f"autotune_gemm times the CUDA kernel's plans; a "
                         f"{x.device.type} tensor takes the plain version, "
                         f"which has no plan (nothing to tune)")
    sm = build.sm_count(x.device)
    ops = ops_key(epi) if variant == gc.TC else ""
    cands = list(candidates or candidate_plans(M, N, K, variant))
    cands, rejected = smem_filter(cands, M, N, K, epi, variant, w.dtype,
                                  budget=smem_budget)
    if not cands:
        raise ValueError(f"every candidate plan exceeds the shared-memory "
                         f"budget ({dict(sorted(rejected.items()))})")
    k = key(M, N, K, variant, sm, ops)
    had = _memory.get(k)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=x.device)
    times = {} if samples is None else samples
    try:
        for plan in cands:
            _memory[k] = plan
            gc.gemm(x, w, epi)                         # untimed
            times[plan] = _times_ms(torch, lambda: gc.gemm(x, w, epi),
                                    repeats, flush)
    finally:
        if had is None:
            _memory.pop(k, None)
        else:
            _memory[k] = had
    if variant == gc.TC:
        rule = (gc.tc_block_m(M, N, sm),)
    else:
        r = gc.small_m_plan(M, N, K, sm)
        rule = (r.cluster, r.k_slice)
    winner = choose({p: times[p] for p in cands}, rule)
    record(M, N, K, variant, sm, winner, ops, persist=persist)
    return winner, {p: statistics.median(times[p]) for p in cands}

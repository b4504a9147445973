"""Tensor parallelism and the sharded GETA step with one card a rank.

    python3 tools/tp_check.py [--ranks N]

Needs N CUDA devices (default: every card): the ranks then talk over
nccl, and the tensor-parallel engine captures its decode windows in CUDA
graphs (`chip_smoke.py` phase 15 runs the same paths with ranks sharing
one card over host-staged gloo, which decodes eagerly). On N ranks, each
on its own card:

1. the smoke config (f32) served at tp N against the 1-rank engine on
   card 0 (weights drawn on the CPU from seed 0): tokens equal;
2. internlm2-1.8b at its published width (bf16) at tp N, dense
   fake-quant, over the contiguous arena, phase 5's 8 prompts of 32-512
   tokens and 64 new each, against the 1-rank engine: the first decode
   step's logits (the bf16 rule, `chip_smoke._logits_held`) and token
   agreement; decode tok/s, step ms, the decode mode (graphs) and per-rank
   bytes beside the 1-rank engine's;
3. internlm2-1.8b at 4 of 24 layers, batch 4 x 512, the DP and FSDP GETA
   steps on N ranks over 3 steps against the 1-rank step with
   grad_slices=N (chip_smoke phase 15c): bitwise, with step walls;
4. grok-1 at 1 of 64 layers (expert parallel: 8 experts, 8 / N a rank)
   and rwkv6-3b at 8 of 32 layers (tensor parallel: 40 heads, 40 / N a
   rank) at their published widths (bf16), dense fake-quant, at tp N
   (chip_smoke phase 15d's configs and 4 requests) against the 1-rank
   engine on card 0: every rank's tokens equal, the first decode step's
   logits by the bf16 rule (rwkv6 within its one-ulp spread where the
   rule fails, as phase 13 holds it), token agreement, the decode mode
   (graphs) and step ms beside the 1-rank engine's eager steps.

Check 4 has not run: no host with several cards has run this script
since it was added (chip_smoke phase 15d runs the same engines with
four ranks sharing one card over host-staged gloo).

Prints the card's name and power limit first, one line a check, and
exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def _serve_rank(tp: int, smoke: bool) -> dict | None:
    """engine_serve at tp on this rank's card: the smoke config from CPU
    drawn weights (f32), or internlm2-1.8b at full width with phase 5's
    prompts and the first step's logits."""
    import torch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import build_engine, synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import LM
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    init = LM.init
    if smoke:
        LM.init = lambda self, gen: {
            k: v.to(gen.device) for k, v in
            init(self, torch.Generator().manual_seed(0)).items()}
        lens, gen = C.SMOKE_TP_LENS, C.SMOKE_TP_GEN
    else:
        lens, gen = C.PROMPT_LENS, C.GEN
    try:
        eng, _ = build_engine(C.ARCH, smoke, max_slots=C.SLOTS,
                              max_seq=max(lens) + gen, mesh=mesh)
    finally:
        LM.init = init
    prompts = synthetic_prompts(get_arch(C.ARCH, smoke=smoke), lens, seed=0)
    out = {"decode_mode": eng.decode_mode, "backend": mesh.backend,
           "param_bytes_per_rank": eng.param_bytes(per_device=True),
           "kv_bytes_per_rank": eng.kv_bytes(per_device=True)}
    if not smoke:
        out["logits"] = C._first_step_logits(torch, eng, prompts,
                                             gen).cpu().numpy()
    else:
        for p in prompts:
            eng.submit(p, gen)
    eng.warmup()
    toks = eng.run()
    out.update(tokens={int(r): t.tolist() for r, t in toks.items()},
               graphs=sorted(eng.graphs), **eng.throughput(),
               decode_s=eng.stats["decode_s"],
               decode_steps=eng.stats["decode_steps"])
    del eng
    torch.cuda.empty_cache()
    return out


def _one_rank(smoke: bool) -> dict:
    """The same on card 0 in this process, one rank."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.engine import build_engine, synthetic_prompts
    from repro_torch.models.transformer import LM
    init = LM.init
    if smoke:
        LM.init = lambda self, gen: {
            k: v.to(gen.device) for k, v in
            init(self, torch.Generator().manual_seed(0)).items()}
        lens, gen = C.SMOKE_TP_LENS, C.SMOKE_TP_GEN
    else:
        lens, gen = C.PROMPT_LENS, C.GEN
    try:
        eng, _ = build_engine(C.ARCH, smoke, max_slots=C.SLOTS,
                              max_seq=max(lens) + gen, device="cuda")
    finally:
        LM.init = init
    prompts = synthetic_prompts(get_arch(C.ARCH, smoke=smoke), lens, seed=0)
    out = {}
    if not smoke:
        out["logits"] = C._first_step_logits(torch, eng, prompts, gen).cpu()
    else:
        for p in prompts:
            eng.submit(p, gen)
    eng.warmup()
    toks = eng.run()
    out.update(tokens={int(r): t.tolist() for r, t in toks.items()},
               **eng.throughput(), decode_s=eng.stats["decode_s"],
               decode_steps=eng.stats["decode_steps"])
    del eng
    torch.cuda.empty_cache()
    return out


def _family_checks(pool, n: int) -> list[str]:
    """Check 4: grok-1 (EP) and rwkv6-3b (TP) at tp n over nccl against
    the 1-rank engine on card 0; returns the failures."""
    import numpy as np
    import torch
    from repro_torch.launch.engine import synthetic_prompts
    failures = []
    for fam in ("grok", "rwkv6"):
        t0 = time.perf_counter()
        prompts = synthetic_prompts(C._tp_family_cfg(fam), C.TP_FAMILY_LENS,
                                    seed=0)
        one = C._tp_family_one(torch, fam, "dense", prompts)
        res = [r for r in pool.run(C._tp_family_rank, fam, "dense", prompts,
                                   n) if r]
        r0 = res[0]
        held, line = C._family_logits_held(
            torch, torch.from_numpy(r0["logits"]), one)
        same = all(r["tokens"] == r0["tokens"] for r in res)
        ok = held and same and not r0["fallbacks"]
        toks = {k: np.asarray(v) for k, v in r0["tokens"].items()}
        steps = max(r0["decode_steps"], 1)
        print(f"[tp check] {fam} at tp={n} ({r0['backend']}, decode "
              f"{r0['decode_mode']}): every rank's tokens "
              f"{'equal' if same else 'DIFFER'}; vs 1 rank: "
              f"{C._agreement(toks, one['tokens'])}; first step {line}; "
              f"step {1e3 * r0['decode_s'] / steps:.2f} ms (1 rank, eager: "
              f"{1e3 * one['decode_s'] / max(one['decode_steps'], 1):.2f} "
              f"ms); shards {r0['shards']} "
              f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{fam} at tp={n}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks, one card each (default: every card)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tp_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    C.phase_device(torch)
    C.phase_build()
    n = args.ranks or torch.cuda.device_count()
    if n < 2 or n > torch.cuda.device_count():
        print(f"tp_check: needs 2 to {torch.cuda.device_count()} ranks, one "
              f"card each (asked {n})", file=sys.stderr)
        return 1
    from repro_torch.launch import mesh as M
    failures = []
    want_smoke = _one_rank(True)
    want_full = _one_rank(False)
    ref = C._tp_train_rank(1, False, n)
    with M.RankPool(n, "cuda") as pool:
        print(f"[tp check] {n} ranks, one card each, over {pool.backend}")
        t0 = time.perf_counter()
        res = [r for r in pool.run(_serve_rank, n, True) if r]
        same = all(r["tokens"] == want_smoke["tokens"] for r in res)
        print(f"[tp check] smoke config (f32) at tp={n}: decode "
              f"{res[0]['decode_mode']}, graphs {res[0]['graphs']}; tokens "
              f"{'equal' if same else 'DIFFER FROM'} the 1-rank engine's on "
              f"every rank ({time.perf_counter() - t0:.1f} s) "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append("smoke tokens")
        t0 = time.perf_counter()
        res = [r for r in pool.run(_serve_rank, n, False) if r]
        r0 = res[0]
        held, line = C._logits_held(torch, torch.from_numpy(r0["logits"]),
                                    want_full["logits"])
        got = {k: np.asarray(v) for k, v in r0["tokens"].items()}
        want = {k: np.asarray(v) for k, v in want_full["tokens"].items()}
        ranks_equal = all(r["tokens"] == r0["tokens"] for r in res)
        ok = held and ranks_equal
        print(f"[tp check] {C.ARCH} full width (bf16) dense at tp={n}: "
              f"{r0['backend']}, decode {r0['decode_mode']}, graphs "
              f"{r0['graphs']}; every rank's tokens "
              f"{'equal' if ranks_equal else 'DIFFER'}; vs 1 rank: "
              f"{C._agreement(got, want)}; first step {line}; decode "
              f"{r0['decode_tok_per_s']:.1f} tok/s, step "
              f"{1e3 * r0['decode_s'] / max(r0['decode_steps'], 1):.2f} ms "
              f"(1 rank: {want_full['decode_tok_per_s']:.1f} tok/s, "
              f"{1e3 * want_full['decode_s'] / max(want_full['decode_steps'], 1):.2f}"
              f" ms); per-rank param_bytes {r0['param_bytes_per_rank']}, "
              f"kv_bytes {r0['kv_bytes_per_rank']} "
              f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("full-width engine")
        for fsdp in (False, True):
            res = [r for r in pool.run(C._tp_train_rank, n, fsdp, n) if r]
            same = all(r[k] == ref[k] for r in res for k in (
                "losses", "params", "masks", "qparams"))
            print(f"[tp check] GETA step on {n} ranks "
                  f"{'FSDP' if fsdp else 'DP'}: "
                  f"{'bitwise equal to' if same else 'DIFFERS FROM'} the "
                  f"1-rank step with grad_slices={n} over "
                  f"{C.TP_TRAIN_STEPS} steps; step walls "
                  f"{[round(w, 2) for w in res[0]['walls']]} s (1 rank: "
                  f"{[round(w, 2) for w in ref['walls']]}), peak "
                  f"{[round(r['peak_bytes'] / 1e9, 2) for r in res]} GB a "
                  f"rank {'ok' if same else 'FAIL'}")
            if not same:
                failures.append(f"{'fsdp' if fsdp else 'dp'} step")
        failures += _family_checks(pool, n)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

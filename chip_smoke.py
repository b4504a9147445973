"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Run from the repo root; needs one CUDA device (Hopper: the kernels build
for sm_90a) and nvcc. It imports nothing of JAX or of the JAX package.
Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: nvcc builds every kernel of the serving path from the sources.
3. Kernels against their plain PyTorch versions on the card, at the
   full-width shapes of internlm2-1.8b's decode (M = 4, 8 slots) and
   prefill (M = 512): the GEMM core's fake_quant_rhs (bf16 weights),
   dequant (int8) and unpack_dequant (bits 2, 3, 4, 8) epilogues over
   K->N = 2048->2048, 2048->1024, 2048->8192, 8192->2048 and 2048->92672,
   flash-decode attention at B = 4, 8 (KVh 8, g 2, dh 128, S 576, bf16
   K/V), and page-indirect flash decode at the same shapes over pages of
   16 rows in a shuffled order, with bf16, int8 and int4 pages. Outputs
   compare in f32 at rtol 1e-4, atol 1e-4 * max|y|; on bf16 pages the
   paged kernel must also equal the contiguous kernel on the gathered
   rows bit for bit. Each case prints the kernel's time, the plain
   version's, one PyTorch library call's (timed only; the port never
   calls it; for the paged kernel SDPA over the already gathered and
   decoded rows, since no single PyTorch call reads pages) and the bound.
4. Correctness: at full width, the compressed model's one-shot prefill of
   a 32-token prompt (plain attention) against 32 sequential decode steps
   (flash-decode kernel); and the smoke config's engine tokens on the
   card against the CPU run of the plain versions.
5. The main path: the continuous-batching engine serving internlm2-1.8b
   at full width in bf16 (24 layers, random weights from a seed) on 4
   slots, 8 requests, in the dense fake-quant, compressed int8 and packed
   4-bit modes. Launch counts are zeroed right before and read right
   after; every kernel of the path must have launched. Packed tokens must
   equal those of an int8 run with the same 4-bit quantizer init.
6. The paged main path: the same engine and requests from the paged KV
   arena (pages of 16 rows). With bf16 pages its tokens must equal phase
   5's in each weight mode; packed 4-bit weights with int8 and with int4
   pages must serve full-length outputs with the bf16 run's first tokens
   from a smaller pool; with 4 of the 8 requests on one prompt, prefix
   sharing must hit at least 3 times and leave the tokens of a run
   without sharing unchanged. Counts are zeroed right before and read
   right after; the page-indirect kernel must launch 24 times (once per
   layer) per decode step, and in every page storage of the path.
7. Two JSON lines: the kernel table, then the device line (last).

Times are CUDA-event medians with the 50 MB L2 flushed before each launch
(each decode-step launch finds its weights cold). Bounds: the larger of
the bytes the call must move over 3.35 TB/s and its operations over
989 TFLOP/s (H100 SXM datasheet: HBM3 and dense bf16 tensor-core peaks).
TF32 is off for every PyTorch matmul here, so plain versions and library
calls run in full f32 (the kernels never use TF32). `--out PATH` also
writes every kernel row and the launch counts to PATH as JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
ARCH = "internlm2-1.8b"
GEMM_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
               (2048, 92672)]
GEMM_MS = [4, 8, 512]
PROMPT_LENS = [64, 128, 256, 512, 96, 200, 32, 384]
GEN = 64
SLOTS = 4
PAGE = 16
SHARED = (1, 3, 5, 7)     # requests that carry request 5's prompt (200
                          # tokens: 12 full pages and a shared tail page)
PAGED_KERNELS = ("paged_decode_attn.bf16", "paged_decode_attn.int8",
                 "paged_decode_attn.int4")
REPORT_SHAPE = (4, 2048, 8192)      # the JSON line's GEMM row: w_gate at decode


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")     # 256 MB > 50 MB L2

    def __call__(self, fn, target_ms: float = 40.0) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        iters = int(min(20, max(3, target_ms / max(once, 1e-3))))
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] nvidia-smi: {line} | torch: {kind}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return kind


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    print(f"[2 build] nvcc built {len(build._sources())} kernel sources "
          f"(sm_90a) in {time.perf_counter() - t0:.2f} s")


def _gemm_cases(torch, K, N, gen):
    """(label, weight tensor, epilogue, dequantized bf16 weight) per
    epilogue, from one random bf16 weight with quantizers at their init."""
    from repro_torch.core.quant import (init_quant_params, pack_codes,
                                        quantize_int)
    from repro_torch.kernels import gemm_core as gc
    w = torch.randn((K, N), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * K ** -0.5
    qp = init_quant_params(w, bits=8.0)
    yield ("fake_quant_rhs", w, gc.fake_quant_rhs(qp.d, qp.q_m, qp.t),
           lambda: gc.ref.fake_quant_weight(w.float(), qp.d, qp.q_m,
                                            qp.t).to(torch.bfloat16))
    codes, d = quantize_int(w, qp, bits=8.0)
    c8 = codes.to(torch.int8)
    yield ("dequant", c8, gc.dequant(d),
           lambda: (c8.float() * d).to(torch.bfloat16))
    del codes
    for bits in (2, 3, 4, 8):
        qb = init_quant_params(w, bits=float(bits))
        cb, db = quantize_int(w, qb, bits=float(bits))
        words = pack_codes(cb, bits, axis=0)
        yield (f"unpack_dequant_b{bits}", words, gc.unpack_dequant(bits, db),
               lambda cb=cb, db=db: (cb * db).to(torch.bfloat16))


def phase_kernels(torch, timer) -> tuple[list, dict, list]:
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failures, report = [], [], {}
    for K, N in GEMM_SHAPES:
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in GEMM_MS}
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            w_lib = dequantized()
            for M in GEMM_MS:
                x = xs[M]
                y = gc.gemm(x, w, epi, out_dtype=torch.float32)
                want = gc.plain(x, w, epi, torch.float32)
                torch.cuda.synchronize()
                err = (y - want).abs().max().item()
                tol = 1e-4 * want.abs().max().item()
                ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                          and torch.isfinite(y).all())
                row = {"kernel": f"gemm_core.{label}", "M": M, "K": K,
                       "N": N, "max_abs_err": err, "atol": tol, "ok": ok}
                row["ms"] = timer(lambda: gc.gemm(x, w, epi,
                                                  out_dtype=torch.float32))
                row["plain_ms"] = timer(lambda: gc.plain(x, w, epi,
                                                         torch.float32))
                row["library_ms"] = timer(lambda: torch.matmul(x, w_lib))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    gc.bytes_moved(M, N, K, 2, w, 4, epi), gc.flops(M, N, K))
                rows.append(row)
                if not ok:
                    failures.append(row)
                print(f"[3 kernels] {row['kernel']:<29} M={M:<3} K={K:<4} "
                      f"N={N:<5} ms={row['ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"library_ms={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"err={err:.2e} tol={tol:.2e} "
                      f"{'ok' if ok else 'FAIL'}")
                if (M, K, N) == REPORT_SHAPE and label in (
                        "fake_quant_rhs", "dequant", "unpack_dequant_b4"):
                    name = ("gemm_core.unpack_dequant"
                            if label.startswith("unpack") else
                            f"gemm_core.{label}")
                    report[name] = row
            del w_lib
        del xs
        torch.cuda.empty_cache()

    S, KVh, g, dh = 576, 8, 2, 128
    for B in (4, 8):
        q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda")
        cache = torch.randn((2, 2, B, S, KVh, dh), generator=gen,
                            device="cuda").to(torch.bfloat16)
        k, v = cache[0, 1], cache[1, 1]         # per-layer views, strided
        pos = torch.tensor([S - 1, 0, 300, 63, 64, 575, 17, 200][:B],
                           dtype=torch.int32, device="cuda")
        y = da.decode_attn(q, k, v, pos)
        want = ref.decode_attn_ref(q, k, v, pos)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                  and torch.isfinite(y).all())
        # library yardstick: SDPA over the same rows, heads expanded for GQA
        ql = q.reshape(B, KVh * g, 1, dh).to(torch.bfloat16)
        kl = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        vl = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        mask = (torch.arange(S, device="cuda")[None, :]
                < torch.clamp(pos.long() + 1, max=S)[:, None])[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = {"kernel": "decode_attn", "B": B, "S": S, "KVh": KVh, "g": g,
               "dh": dh, "max_abs_err": err, "atol": tol, "ok": ok,
               "ms": timer(lambda: da.decode_attn(q, k, v, pos)),
               "plain_ms": timer(lambda: ref.decode_attn_ref(q, k, v, pos)),
               "library_ms": timer(lambda: sdpa(ql, kl, vl, attn_mask=mask))}
        row["bound_ms"], row["bound_by"] = bound_ms(
            da.bytes_moved(q, k, pos), da.flops(q, k, pos))
        rows.append(row)
        if not ok:
            failures.append(row)
        print(f"[3 kernels] decode_attn B={B} S={S} KVh={KVh} g={g} "
              f"dh={dh} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"err={err:.2e} tol={tol:.2e} {'ok' if ok else 'FAIL'}")
        if B == SLOTS:
            report["decode_attn"] = row
        for storage in ("bf16", "int8", "int4"):
            row = _paged_check(torch, timer, gen, B, S, KVh, g, dh, storage)
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            if B == SLOTS:
                report[f"paged_decode_attn.{storage}"] = row
    return rows, report, failures


def _paged_check(torch, timer, gen, B, S, KVh, g, dh, storage) -> dict:
    """The page-indirect kernel on B slots of S rows in pages of PAGE rows,
    each slot's pages in a shuffled order, against its plain version (and,
    on bf16 pages, bitwise against the contiguous kernel on the gathered
    rows)."""
    from repro_torch.core.quant import kv_quant_encode
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ref
    Lp = S // PAGE
    n_pages = 2 + B * Lp
    table = (torch.randperm(n_pages - 2, generator=gen, device="cuda")
             + 2).reshape(B, Lp).to(torch.int32)
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda")
    pools = [torch.randn((n_pages, PAGE, KVh, dh), generator=gen,
                         device="cuda") for _ in range(2)]
    kw = dict(page_size=PAGE, seq_len=S)
    if storage == "bf16":
        kp, vp = (p.to(torch.bfloat16) for p in pools)
    else:
        bits = int(storage[-1])
        (kp, ks), (vp, vs) = (kv_quant_encode(p, bits) for p in pools)
        kw.update(kv_bits=bits, k_scale=ks, v_scale=vs)
    del pools
    pos = torch.tensor([S - 1, 0, 300, 63, 64, 575, 17, 200][:B],
                       dtype=torch.int32, device="cuda")
    y = da.paged_decode_attn(q, kp, vp, pos, table, **kw)
    want = ref.paged_decode_attn_ref(q, kp, vp, pos, table, **kw)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
              and torch.isfinite(y).all())
    # the gathered (and decoded) rows: the contiguous kernel's input on
    # bf16 pages, and the library yardstick's in every storage
    rows_k, rows_v = (ref.gather_pages(pool, kw.get(sc), table, PAGE, S,
                                       kw.get("kv_bits"))
                      for pool, sc in ((kp, "k_scale"), (vp, "v_scale")))
    row = {"kernel": f"paged_decode_attn.{storage}", "B": B, "S": S,
           "P": PAGE, "KVh": KVh, "g": g, "dh": dh, "max_abs_err": err,
           "atol": tol}
    if storage == "bf16":
        contiguous = da.decode_attn(q, rows_k, rows_v, pos)
        torch.cuda.synchronize()
        row["contiguous_max_abs_err"] = (y - contiguous).abs().max().item()
        ok = ok and torch.equal(y, contiguous)
    row["ok"] = ok
    ql = q.reshape(B, KVh * g, 1, dh).to(torch.bfloat16)
    kl, vl = (r.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
              .to(torch.bfloat16) for r in (rows_k, rows_v))
    mask = (torch.arange(S, device="cuda")[None, :]
            < torch.clamp(pos.long() + 1, max=S)[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["ms"] = timer(lambda: da.paged_decode_attn(q, kp, vp, pos, table,
                                                   **kw))
    row["plain_ms"] = timer(lambda: ref.paged_decode_attn_ref(
        q, kp, vp, pos, table, **kw))
    row["library_ms"] = timer(lambda: sdpa(ql, kl, vl, attn_mask=mask))
    row["bound_ms"], row["bound_by"] = bound_ms(
        da.paged_bytes_moved(q, kp, pos, PAGE, S, kw.get("kv_bits")),
        da.paged_flops(q, pos, S))
    bitwise = (f" vs contiguous kernel max|diff|="
               f"{row['contiguous_max_abs_err']:.1e}"
               if storage == "bf16" else "")
    print(f"[3 kernels] paged_decode_attn {storage} B={B} S={S} P={PAGE} "
          f"KVh={KVh} g={g} dh={dh} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} (SDPA on gathered rows) "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={err:.2e} tol={tol:.2e}{bitwise} {'ok' if ok else 'FAIL'}")
    return row


def phase_correctness(torch) -> list[str]:
    """Full-width prefill vs sequential decode, and smoke card vs CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.launch.engine import (WEIGHT_MODES, serve_on_devices,
                                           synthetic_prompts)
    from repro_torch.models.transformer import LM
    failures = []
    lm = LM(get_arch(ARCH))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, qparams, _ = prepare_serving(lm, lm.init(gen), compressed=True)
    prompt = torch.as_tensor(synthetic_prompts(lm.cfg, [32], seed=1)[0],
                             dtype=torch.int64, device="cuda")[None]
    cache = lm.init_cache(1, 32, dtype=torch.bfloat16, device="cuda")
    pre, _ = lm.prefill(params, qparams, cache, prompt)
    cache = lm.init_cache(1, 32, dtype=torch.bfloat16, device="cuda")
    for p in range(32):
        dec, _ = lm.decode_step(params, qparams, cache, prompt[:, p:p + 1], p)
    a, b = pre[0, -1].float(), dec[0, -1].float()
    diff = (a - b).abs().max().item()
    scale = a.abs().max().item()
    top2 = torch.topk(a, 2).values
    same_argmax = int(a.argmax()) == int(b.argmax())
    # bf16 activations through 24 layers, summed in another order
    # (prefill M = 32 vs decode M = 1 tiles): 2^-5 of the logit range
    ok = (same_argmax and diff <= scale / 32
          and bool(torch.isfinite(pre).all() and torch.isfinite(dec).all())
          and pre.shape == (1, 32, lm.cfg.vocab_padded))
    print(f"[4 correctness] full-width compressed prefill vs 32 decode "
          f"steps, last-position logits: max|diff|={diff:.4f} "
          f"max|logit|={scale:.4f} (tol {scale / 32:.4f}), top-2 gap "
          f"{(top2[0] - top2[1]).item():.4f}, argmax "
          f"{int(a.argmax())} vs {int(b.argmax())} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("prefill vs sequential decode")
    del params, qparams, cache, pre, dec
    torch.cuda.empty_cache()

    # the smoke config on both devices from the same weights
    for mode, kw in WEIGHT_MODES.items():
        toks = serve_on_devices(ARCH, True, [6, 3, 9], 6, ["cpu", "cuda"],
                                max_slots=2, **kw)
        cpu, card = toks["cpu"], toks["cuda"]
        ok = all((cpu[r] == card[r]).all() for r in cpu)
        print(f"[4 correctness] smoke config {mode}: card tokens "
              f"{'equal' if ok else 'DIFFER FROM'} the CPU plain versions' "
              f"({sum(len(t) for t in cpu.values())} tokens)")
        if not ok:
            failures.append(f"smoke {mode} card vs cpu")
    return failures


def phase_engine(torch) -> tuple[dict, dict, list[str]]:
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import WEIGHT_MODES, engine_serve
    expect = {"dense": "gemm_core.fake_quant_rhs",
              "compressed": "gemm_core.dequant",
              "packed_b4": "gemm_core.unpack_dequant"}
    failures, outs = [], {}
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        before = ops.launch_counts()
        stats = {}
        t0 = time.perf_counter()
        outs[mode] = engine_serve(ARCH, False, PROMPT_LENS, GEN,
                                  max_slots=SLOTS, verbose=False,
                                  device="cuda", stats=stats, **kw)
        wall = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        toks = outs[mode]
        ok = (len(toks) == len(PROMPT_LENS)
              and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                      for t in toks.values())
              and delta[expect[mode]] > 0 and delta["decode_attn"] > 0
              and delta["gemm_core.reduce_splits"] > 0)
        print(f"[5 engine] {mode}: decode {stats['decode_tok_per_s']:.1f} "
              f"tok/s ({stats['decode_tokens']} tokens in "
              f"{stats['decode_s']:.3f} s, {stats['decode_steps']} steps), "
              f"prefill {stats['prefill_tok_per_s']:.1f} tok/s "
              f"({stats['prefill_tokens']} tokens in "
              f"{stats['prefill_s']:.3f} s), param_bytes "
              f"{stats['param_bytes']}, kv_bytes {stats['kv_bytes']}, "
              f"launches {_nonzero(delta)}, wall {wall:.1f} s "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"engine {mode}")
    counts = ops.launch_counts()
    print(f"[5 engine] main-path launch counts: {_nonzero(counts)}")
    for name in [*expect.values(), "gemm_core.reduce_splits", "decode_attn"]:
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the main path")
    ref_int8 = engine_serve(ARCH, False, PROMPT_LENS, GEN, max_slots=SLOTS,
                            verbose=False, device="cuda", compressed=True,
                            bits_init=4.0)
    same = all((ref_int8[r] == outs["packed_b4"][r]).all() for r in ref_int8)
    print(f"[5 engine] packed 4-bit tokens "
          f"{'equal' if same else 'DIFFER FROM'} the int8 run at the same "
          f"4-bit quantizer init ({len(ref_int8)} requests x {GEN} tokens)")
    if not same:
        failures.append("packed tokens differ from int8 tokens")
    return counts, outs, failures


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _serve_paged(torch, prompts, kw) -> tuple[dict, dict]:
    """One paged engine at full width: build, submit, warm up, drain.
    Returns its tokens and stats, with the page-indirect launches per
    decode step counted over the drain."""
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import build_engine
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda",
                          paged=True, page_size=PAGE, **kw)
    for p in prompts:
        eng.submit(p, GEN)
    eng.warmup()
    before = ops.launch_counts()
    out = eng.run()
    paged = sum(v - before[k] for k, v in ops.launch_counts().items()
                if k.startswith("paged_decode_attn."))
    stats = dict(eng.stats, **eng.throughput(), kv_bytes=eng.kv_bytes(),
                 kv_pool_bytes=eng.kv_pool_bytes(),
                 paged_per_step=paged / max(eng.stats["decode_steps"], 1))
    del eng
    torch.cuda.empty_cache()
    return out, stats


def phase_paged(torch, contiguous: dict) -> tuple[dict, list[str]]:
    """The paged main path at full width (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import WEIGHT_MODES, synthetic_prompts
    failures = []
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    n_layers = get_arch(ARCH).n_layers

    def report(label, out, st, ok):
        full = (len(out) == len(prompts)
                and all(len(t) == GEN for t in out.values()))
        ok = ok and full and st["paged_per_step"] == n_layers
        print(f"[6 paged] {label}: decode {st['decode_tok_per_s']:.1f} tok/s "
              f"({st['decode_tokens']} tokens, {st['decode_steps']} steps), "
              f"prefill {st['prefill_tok_per_s']:.1f} tok/s "
              f"({st['prefills']} prefills, {st['prefix_hits']} prefix "
              f"hits), kv_bytes {st['kv_bytes']}, kv_pool_bytes "
              f"{st['kv_pool_bytes']}, paged_decode_attn launches per "
              f"decode step {st['paged_per_step']:.2f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"paged {label}")

    ops.reset_launch_counts()
    runs = {}
    for mode, kw in WEIGHT_MODES.items():
        out, st = _serve_paged(torch, prompts, kw)
        same = all((out[r] == contiguous[mode][r]).all() for r in out)
        report(f"{mode}, bf16 pages, tokens "
               f"{'equal' if same else 'DIFFER FROM'} the contiguous run's",
               out, st, same)
        runs[mode] = (out, st)
    bf16_out, bf16_st = runs["packed_b4"]
    for bits in (8, 4):
        out, st = _serve_paged(torch, prompts, dict(WEIGHT_MODES["packed_b4"],
                                                    kv_bits=bits))
        first = all(out[r][0] == bf16_out[r][0] for r in out)
        smaller = st["kv_pool_bytes"] < bf16_st["kv_pool_bytes"]
        report(f"packed_b4, int{bits} pages, first tokens "
               f"{'equal' if first else 'DIFFER FROM'} the bf16-page run's, "
               f"pool {st['kv_pool_bytes']} B vs {bf16_st['kv_pool_bytes']} "
               f"B", out, st, first and smaller)
    shared = [prompts[5] if i in SHARED else p for i, p in enumerate(prompts)]
    kw = WEIGHT_MODES["compressed"]
    want, st = _serve_paged(torch, shared, dict(kw, prefix_sharing=False))
    same = all((want[i] == want[SHARED[0]]).all() for i in SHARED)
    report(f"compressed, {len(SHARED)} of {len(shared)} requests on one "
           f"prompt, no prefix sharing: their tokens "
           f"{'agree' if same else 'DIFFER'}", want, st, same)
    got, st = _serve_paged(torch, shared, kw)
    same = all((got[r] == want[r]).all() for r in got)
    report(f"compressed, {len(SHARED)} of {len(shared)} requests on one "
           f"prompt, prefix sharing: tokens "
           f"{'equal' if same else 'DIFFER FROM'} the run without sharing",
           got, st, same and st["prefix_hits"] >= len(SHARED) - 1)
    counts = ops.launch_counts()
    print(f"[6 paged] main-path launch counts: {_nonzero(counts)}")
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", "gemm_core.reduce_splits",
                 *PAGED_KERNELS):
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the paged path")
    if counts["decode_attn"]:
        failures.append("the paged path launched the contiguous kernel")
    return counts, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the kernel rows and launch counts here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # full f32 in every PyTorch matmul and convolution: plain versions and
    # library yardsticks must not round through TF32 (the kernels never do)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    kind = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    rows, report, failures = phase_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()
    failures = [f"{r['kernel']} {r}" for r in failures]
    failures += phase_correctness(torch)
    counts, outs, engine_failures = phase_engine(torch)
    failures += engine_failures
    paged_counts, paged_failures = phase_paged(torch, outs)
    failures += paged_failures

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"device": kind, "rows": rows, "launches": counts,
             "paged_launches": paged_counts}, indent=1))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    attn = ("src/repro_torch/kernels/csrc/decode_attn.cu",
            "src/repro/kernels/decode_attn.py:63")
    paged = ("src/repro_torch/kernels/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:238")
    gemm = ("src/repro_torch/kernels/csrc/gemm_core.cu",
            "src/repro/kernels/gemm_core.py:127")
    kernels = []
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", "decode_attn", *PAGED_KERNELS):
        row = report[name]
        src, replaces = (paged if name in PAGED_KERNELS else
                         attn if name == "decode_attn" else gemm)
        launches = (paged_counts if name in PAGED_KERNELS else counts)[name]
        shape = (f"M={row['M']} K={row['K']} N={row['N']}"
                 + (" bits=4" if "unpack" in name else "")
                 if name.startswith("gemm") else
                 f"B={row['B']} S={row['S']} KVh={row['KVh']} g={row['g']} "
                 f"dh={row['dh']}" + (f" P={row['P']}" if "P" in row else ""))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

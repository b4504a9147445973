"""chip_smoke phase 3's decode-attention rows under both of its timers, for
the kernels of any checkout.

    python3 tools/time_decode_rows.py [--src DIR] [--f32-q] [--out PATH]

Run from the repo root on a CUDA card. Imports `repro_torch` from DIR
(default: this checkout's `src`; for example an unpacked earlier commit's
`src`) and `chip_smoke.Timer` from this checkout. For each of phase 3's
decode shapes (B = 4 and 8 at S = 576, B = 4 at S = 4096; KVh 8, g 2,
dh 128) and each kernel (contiguous bf16 rows; bf16, int8 and int4 pages
of 16 rows), times one call with the L2 flushed before it, once with the
device asleep after the flush (`chip_smoke.SLEEP_CYCLES`, the timer
chip_smoke uses) and once without (no sleep), alternating, and holds the
output to the plain version. Inputs are bf16 q and int64 pos, as the
layers hand them, or with `--f32-q` f32 q and int32 pos. Prints one
line per row and, last, a JSON line of all.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 576), (8, 576), (4, 4096))
KVH, G, DH, PAGE = 8, 2, 128, 16
POS = {576: [575, 0, 300, 63, 64, 575, 17, 200],
       4096: [4095, 1000, 2500, 63]}


def _inputs(gen, B, S, f32_q):
    """q, the contiguous per-layer views k/v, pos, and for each page
    storage the paged call's (pools, table, keywords)."""
    from repro_torch.core.quant import kv_quant_encode
    q = torch.randn((B, KVH, G, DH), generator=gen, device="cuda").to(
        torch.float32 if f32_q else torch.bfloat16)
    cache = torch.randn((2, 2, B, S, KVH, DH), generator=gen,
                        device="cuda").to(torch.bfloat16)
    pos = torch.tensor(POS[S][:B], device="cuda",
                       dtype=torch.int32 if f32_q else torch.int64)
    Lp = S // PAGE
    n_pages = 2 + B * Lp
    table = (torch.randperm(n_pages - 2, generator=gen, device="cuda")
             + 2).reshape(B, Lp).to(torch.int32)
    pools = [torch.randn((n_pages, PAGE, KVH, DH), generator=gen,
                         device="cuda") for _ in range(2)]
    paged = {"bf16": (*(p.to(torch.bfloat16) for p in pools),
                      dict(page_size=PAGE, seq_len=S))}
    for bits in (8, 4):
        (kp, ks), (vp, vs) = (kv_quant_encode(p, bits) for p in pools)
        paged[f"int{bits}"] = (kp, vp, dict(page_size=PAGE, seq_len=S,
                                            kv_bits=bits, k_scale=ks,
                                            v_scale=vs))
    return q, cache[0, 1], cache[1, 1], pos, table, paged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src directory to time")
    ap.add_argument("--f32-q", action="store_true",
                    help="f32 q and int32 pos instead of bf16 and int64")
    ap.add_argument("--out", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_decode_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ref
    print(f"timing {Path(da.__file__).resolve()} on "
          f"{torch.cuda.get_device_name(0)}")
    timers = {"sleep": chip_smoke.Timer(torch),
              "no_sleep": chip_smoke.Timer(torch, sleep_cycles=0)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = [], True
    for B, S in SHAPES:
        q, k, v, pos, table, paged = _inputs(gen, B, S, args.f32_q)
        calls = {"decode_attn": (lambda: da.decode_attn(q, k, v, pos),
                                 lambda: ref.decode_attn_ref(q, k, v, pos))}
        for storage, (kp, vp, kw) in paged.items():
            calls[f"paged_decode_attn.{storage}"] = (
                lambda kp=kp, vp=vp, kw=kw: da.paged_decode_attn(
                    q, kp, vp, pos, table, **kw),
                lambda kp=kp, vp=vp, kw=kw: ref.paged_decode_attn_ref(
                    q, kp, vp, pos, table, **kw))
        for name, (fn, plain) in calls.items():
            y, want = fn(), plain()
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            row = {"kernel": name, "B": B, "S": S,
                   "max_abs_err": (y - want).abs().max().item(),
                   "ok": bool(torch.allclose(y, want, rtol=1e-4,
                                             atol=1e-4 * scale))}
            for label, timer in timers.items():
                row[f"ms_{label}"] = timer(fn)
            for label, timer in reversed(list(timers.items())):
                row[f"ms_{label}_again"] = timer(fn)
            ok = ok and row["ok"]
            rows.append(row)
            print(f"{name:<26} B={B} S={S:<4} ms sleep "
                  f"{row['ms_sleep']:.4f} / {row['ms_sleep_again']:.4f}, "
                  f"no sleep {row['ms_no_sleep']:.4f} / "
                  f"{row['ms_no_sleep_again']:.4f} err "
                  f"{row['max_abs_err']:.2e} "
                  f"{'ok' if row['ok'] else 'FAIL'}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps({"src": args.src, "f32_q": args.f32_q, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""chip_smoke phase 3's small-M and SIMT GEMM rows under its timer, for the
kernels of any checkout.

    python3 tools/time_gemm_rows.py [--src DIR] [--out PATH]

Run from the repo root on a CUDA card. Imports `repro_torch` from DIR
(default: this checkout's `src`; for example an unpacked earlier commit's
`src`) and `chip_smoke`'s timer and weight cases from this checkout. Times,
with the L2 flushed before each call:

- the small-M variant (bf16 x, f32 out) at M = 4 over phase 3's five
  (K, N) shapes for each of its weight cases (fake_quant_rhs on bf16
  weights at t = 1, dequant on int8 codes, unpack_dequant on 2-, 3-, 4-
  and 8-bit words), and at M = 8 for fake_quant_rhs, dequant and
  unpack_dequant b4, beside torch.matmul on the decoded bf16 weight;
- the SIMT variant (f32 x and weights) at M = 2048 over 2048->8192 and
  8192->2048, fake_quant_rhs at t = 1 and t = 0.85 and no epilogue,
  beside f32 torch.matmul on the decoded weight.

Each row also holds the output to the plain version (rtol 1e-4, atol
1e-4 * max|y|) and counts the device kernels of one call from a
profiler trace. Prints one line per row and, last, a JSON line of all.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
M8_CASES = ("fake_quant_rhs", "dequant", "unpack_dequant_b4")
SIMT_SHAPES = ((2048, 8192), (8192, 2048))


def _kernels(fn) -> int:
    """Device kernels of one call of `fn`, from a profiler trace (taken
    again, up to three times, while it recorded no device event at all)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == cuda)
        if n:
            break
    return n


def _row(timer, name, shape, fn, plain, lib, extra=None):
    y, want = fn(), plain()
    again = fn()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    row = {"kernel": name, **shape, **(extra or {}),
           "max_abs_err": (y - want).abs().max().item(),
           "ok": bool(torch.allclose(y, want, rtol=1e-4, atol=1e-4 * scale)
                      and torch.equal(y, again)),
           "ms": timer(fn), "library_ms": timer(lib)}
    row["kernels_per_call"] = _kernels(fn)
    print(f"{name:<29} " + " ".join(f"{k}={v}" for k, v in shape.items())
          + "".join(f" {k}={v}" for k, v in (extra or {}).items())
          + f" ms={row['ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"kernels/call {row['kernels_per_call']} err "
          f"{row['max_abs_err']:.2e} {'ok' if row['ok'] else 'FAIL'}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src directory to time")
    ap.add_argument("--out", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gemm_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import gemm_core as gc
    print(f"timing {Path(gc.__file__).resolve()} on "
          f"{torch.cuda.get_device_name(0)}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32
    rows = []
    for K, N in chip_smoke.GEMM_SHAPES:
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in (4, 8)}
        for label, w, epi, dequantized in chip_smoke._gemm_cases(
                torch, K, N, gen):
            w_lib = dequantized()
            for M in (4, 8) if label in M8_CASES else (4,):
                x = xs[M]
                rows.append(_row(
                    timer, f"gemm_core.{label}", {"M": M, "K": K, "N": N},
                    lambda: gc.gemm(x, w, epi, out_dtype=f32),
                    lambda: gc.plain(x, w, epi, f32),
                    lambda: torch.matmul(x, w_lib)))
            del w_lib
        del xs
        torch.cuda.empty_cache()
    for K, N in SIMT_SHAPES:
        x = torch.randn((2048, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        for label, t in (("fake_quant_rhs", 1.0), ("fake_quant_rhs", 0.85),
                         ("none", 1.0)):
            qp = init_quant_params(w, bits=8.0, t=t)
            epi = (gc.none() if label == "none" else
                   gc.fake_quant_rhs(qp.d, qp.q_m, qp.t))
            w_lib = (w if label == "none" else
                     gc.ref.fake_quant_weight(w, qp.d, qp.q_m, qp.t))
            rows.append(_row(
                timer, f"gemm_core.simt.{label}",
                {"M": 2048, "K": K, "N": N}, lambda: gc.gemm(x, w, epi,
                                                              out_dtype=f32),
                lambda: gc.plain(x, w, epi, f32),
                lambda: torch.matmul(x, w_lib), {"t": t}))
            del w_lib
        del x, w
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps({"src": args.src, "device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

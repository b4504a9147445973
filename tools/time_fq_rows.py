"""chip_smoke phase 3's fake-quant rows under its timer, for the kernels of
any checkout.

    python3 tools/time_fq_rows.py [--src DIR] [--out PATH] [--sass]
                                  [--bf16-only]

Run from the repo root on a CUDA card. Imports `repro_torch` from DIR
(default: this checkout's `src`; for example an unpacked earlier commit's
`src`) and `chip_smoke`'s timer and shapes from this checkout. Times, with
the L2 flushed before each call, the fake-quant forward and backward on
phase 3's shapes (the head, 2048 x 92672, and a w_gate slice, 2048 x
8192) at t = 1 and t = 0.85, with inputs drawn as phase 3 draws them
(x of scale 2048^-1/2, g of 1e-3, q_m at 0.9 max|x|, 8 bits): the forward
on bf16 and f32 x, the backward on bf16 x and g (the train step's), bf16
x with f32 g, and f32 x and g. Each row holds the forward and dx bitwise
to the plain version (err: the forward's max |y - plain|, the backward's
largest sum error over its scale), the three sums within 1e-5 of the sum
of their terms' magnitudes and bitwise on a second call, and counts the
device kernels of one call from a profiler trace. Prints one line per
row and, last, a JSON line of all; exits 1 if a row fails. `--bf16-only`
times only the train step's rows (bf16 x and g).

`--sass` first compiles DIR's `csrc/fake_quant.cu` alone with `nvcc
-Xptxas -v` (registers and spills per kernel) into `build/fq_sass/`,
keeps its `cuobjdump -sass` there (`fake_quant.sass`) and prints, per
kernel, its count of SASS instructions and its most frequent opcodes.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BWD_TYPES = (("bf16", "bf16"), ("bf16", "f32"), ("f32", "f32"))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _row(chip_smoke, timer, name, shape, extra, fn, check):
    ok, err = check()
    row = {"kernel": name, "shape": shape, **extra, "err": err,
           "ok": ok, "ms": timer(fn),
           "kernels_per_call": chip_smoke._kernels_per_call(torch, fn, "")}
    row["ok"] = row["ok"] and row["kernels_per_call"] >= 1
    print(f"{name:<15} {shape[0]}x{shape[1]} "
          + " ".join(f"{k}={v}" for k, v in extra.items())
          + f" ms={row['ms']:.4f} kernels/call {row['kernels_per_call']} "
          f"err {err:.2e} {'ok' if row['ok'] else 'FAIL'}")
    return row


def sass_report(src: Path) -> None:
    """nvcc -Xptxas -v and per-kernel SASS counts of src's fake_quant.cu."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    out = ROOT / "build" / "fq_sass"
    out.mkdir(parents=True, exist_ok=True)
    obj = out / "fake_quant.o"
    nvcc = build.find_nvcc()
    res = subprocess.run(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(build.CSRC / "fake_quant.cu"), "-o", str(obj)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for line in res.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    (out / "fake_quant.sass").write_text(sass)
    ops, name = collections.OrderedDict(), None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if name and m:
            ops[name][m.group(2)] += 1
    for name, c in ops.items():
        print(f"sass {name}: {sum(c.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in c.most_common(24)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src directory to time")
    ap.add_argument("--out", default=None, help="write the rows here")
    ap.add_argument("--sass", action="store_true",
                    help="print ptxas -v and SASS counts of the kernels")
    ap.add_argument("--bf16-only", action="store_true",
                    help="only the rows of bf16 x and g (the train step's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_fq_rows: no CUDA device", file=sys.stderr)
        return 1
    if args.sass:
        sass_report(Path(args.src).resolve())
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import ref
    print(f"timing {Path(fq.__file__).resolve()} on "
          f"{torch.cuda.get_device_name(0)}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, shape in chip_smoke.FQ_SHAPES.items():
        x32 = torch.randn(shape, generator=gen, device="cuda") * shape[0] ** -0.5
        g32 = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        for t in (1.0, 0.85):
            for xt in ("bf16",) if args.bf16_only else ("bf16", "f32"):
                x = x32.to(DTYPES[xt])
                qp = init_quant_params(q_m=x.float().abs().max() * 0.9,
                                       bits=8.0, t=t)
                sc = (qp.d, qp.q_m, qp.t)

                def fwd_check(x=x, sc=sc):
                    y, want = fq.fake_quant_fwd(x, *sc), \
                        ref.fake_quant_fwd_ref(x, *sc)
                    return (torch.equal(y, want),
                            (y.float() - want.float()).abs().max().item())

                rows.append(_row(chip_smoke, timer, "fake_quant.fwd", shape,
                                 {"w": label, "t": t, "x": xt},
                                 lambda x=x, sc=sc: fq.fake_quant_fwd(x, *sc),
                                 fwd_check))
                for bx, bg in BWD_TYPES:
                    if bx != xt or (args.bf16_only and bg != "bf16"):
                        continue
                    g = g32.to(DTYPES[bg])

                    def bwd_check(x=x, g=g, sc=sc):
                        got = fq.fake_quant_bwd(x, *sc, g)
                        again = fq.fake_quant_bwd(x, *sc, g)
                        want = ref.fake_quant_bwd_ref(x, *sc, g)
                        scales = fq.sum_scales(x, g, *sc)
                        serr = max(abs(float(a) - float(b)) / max(s, 1e-30)
                                   for a, b, s in zip(got[1:], want[1:],
                                                      scales))
                        ok = (torch.equal(got[0], want[0]) and serr <= 1e-5
                              and all(torch.equal(a, b)
                                      for a, b in zip(got, again)))
                        return ok, serr

                    rows.append(_row(
                        chip_smoke, timer, "fake_quant.bwd", shape,
                        {"w": label, "t": t, "x": bx, "g": bg},
                        lambda x=x, g=g, sc=sc: fq.fake_quant_bwd(x, *sc, g),
                        bwd_check))
                    del g
                del x
                torch.cuda.empty_cache()
        del x32, g32
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps({"src": args.src, "device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Serving CLI of the port: the continuous-batching engine on CUDA.

Three weight modes:
  default       dense weights; every block projection decodes through the
                GEMM kernel's fused fake-quant epilogue
  --compressed  int8 codes + per-column scales, through the dequant
                epilogue
  --packed      sub-byte K-packed int32 words (implies --compressed),
                through the unpack-dequant epilogue; `--bits 4` serves a
                4-bit artifact

Runs on CUDA; `--device cpu` runs the plain PyTorch versions of the
kernels instead (as the tests do). Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --compressed
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --packed \
      --bits 4 --prompt-lens 12,5 --gen 8 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.engine import engine_serve


def packed_parity_check(arch: str, smoke: bool, prompt_lens: list[int],
                        gen: int, *, bits_init: float = 8.0, max_slots: int,
                        seed: int = 0, verbose: bool = True,
                        device=None) -> dict:
    """Assert the packed engine's decode is token-identical to the
    unpacked int8 path at the same seed and quantizer init: the packing
    round trip is exact and the GEMM sums the decoded weights in the same
    order, so every greedy token must match. Returns the packed engine's
    output."""
    want = engine_serve(arch, smoke, prompt_lens, gen, compressed=True,
                        bits_init=bits_init, max_slots=max_slots, seed=seed,
                        verbose=False, device=device)
    got = engine_serve(arch, smoke, prompt_lens, gen, compressed=True,
                       packed=True, bits_init=bits_init, max_slots=max_slots,
                       seed=seed, verbose=verbose, device=device)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for rid in want:
        np.testing.assert_array_equal(
            got[rid], want[rid],
            err_msg=f"packed decode diverged from the unpacked int8 "
                    f"reference (request {rid})")
    print(f"{arch}: packed decode token-identical to the unpacked int8 "
          f"path over {len(want)} requests")
    return got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
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
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    lens = [int(x) for x in args.prompt_lens.split(",")]
    if args.packed and args.smoke:
        packed_parity_check(args.arch, args.smoke, lens, args.gen,
                            bits_init=args.bits, max_slots=args.slots,
                            device=args.device)
        return
    engine_serve(args.arch, args.smoke, lens, args.gen,
                 quantized=args.quantized, compressed=args.compressed,
                 packed=args.packed, bits_init=args.bits,
                 max_slots=args.slots, device=args.device)


if __name__ == "__main__":
    main()

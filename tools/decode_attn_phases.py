"""Where a block of the split-rows flash-decode kernel spends its cycles.

    python3 tools/decode_attn_phases.py

Run from the repo root on a CUDA card. Builds an instrumented copy of
`src/repro_torch/kernels/csrc/decode_attn.cu` into `build/phases/`: thread 0
of every block of the split kernel records `clock64()` after each phase
and `%globaltimer` at its start and end into a device buffer. The shipped
kernel is not changed. Then one call per case at chip_smoke phase 3's
B = 4 shapes (KVh 8, g 2, dh 128; S = 576 and 4096; bf16 rows, contiguous
and int4 pages), and prints, over the blocks that hold rows, the median
and max cycles of each phase, the block's wall time and when the blocks
started after the first one.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.quant import kv_quant_encode  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn as da  # noqa: E402

SLOTS = 16       # stamps per block: 0-9 clock64, 14-15 globaltimer
STAMPS = [       # (phase ending at the stamp, the source line it follows)
    ("start", "  const int c0 = split * R;"),
    ("pos", "  if (c0 >= n_valid) return;"),
    ("table", "  if constexpr (Src::kPaged) __syncthreads();"),
    ("issue", "  cp_async_commit();\n\n"),
    ("wait K", "  cp_async_wait<1>();\n  __syncthreads();"),
    ("score", "  __syncthreads();\n  // the split's softmax, one warp per "
              "query head"),
    ("softmax, wait V", "  cp_async_wait<0>();\n  __syncthreads();"),
    ("P.V", "            make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);"
            "\n  }\n  __syncthreads();"),
    ("write", "    pb[tid * (dh + 2) + dh + 1] = l_s[tid];\n  }"),
]
PRELUDE = r'''namespace {
__device__ long long g_stamps[1 << 20];
#define BLOCK_ID ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x \
                  + blockIdx.x)
#define STAMP(i, last) do { if (threadIdx.x == 0) { \
  long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_stamps[BLOCK_ID * 16 + (i)] = clock64(); \
  if ((i) == 0) g_stamps[BLOCK_ID * 16 + 15] = t_; \
  if (last) g_stamps[BLOCK_ID * 16 + 14] = t_; } } while (0)
'''
READER = r'''
extern "C" int stamps_read(long long* host, int n) {
  return cudaMemcpyFromSymbol(host, g_stamps, n * sizeof(long long));
}
extern "C" int stamps_clear() {
  void* p;
  const int err = cudaGetSymbolAddress(&p, g_stamps);
  return err ? err : cudaMemset(p, 0, sizeof(g_stamps));
}
'''


def instrumented_source() -> str:
    src = (build.CSRC / "decode_attn.cu").read_text()
    src = src.replace("namespace {\n", PRELUDE, 1)
    for i, (_, anchor) in enumerate(STAMPS):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor for stamp {i} not found once: "
                             f"{anchor!r}")
        last = int(i == len(STAMPS) - 1)
        src = src.replace(anchor, f"{anchor}\n  STAMP({i}, {last});")
    return src + READER


def load() -> ctypes.CDLL:
    out = ROOT / "build" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_attn.cu").write_text(instrumented_source())
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(out / "libphases.so"), str(out / "decode_attn.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out / "libphases.so"))
    for name in ("repro_decode_attn", "repro_paged_decode_attn"):
        fn = getattr(lib, name)
        fn.argtypes = list(build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def report(lib, label, n_blocks) -> None:
    buf = np.zeros(n_blocks * SLOTS, np.int64)
    lib.stamps_read(buf.ctypes.data, buf.size)
    d = buf.reshape(n_blocks, SLOTS)
    work = d[d[:, len(STAMPS) - 1] != 0]
    t0 = d[:, 15][d[:, 15] != 0].min()
    cycles = np.diff(work[:, :len(STAMPS)], axis=1)
    print(f"{label}: {n_blocks} blocks, {len(work)} hold rows; block wall "
          f"us median {np.median(work[:, 14] - work[:, 15]) / 1e3:.2f} max "
          f"{(work[:, 14] - work[:, 15]).max() / 1e3:.2f}; last block ends "
          f"{(work[:, 14].max() - t0) / 1e3:.2f} us after the first starts")
    for i, (name, _) in enumerate(STAMPS[1:]):
        print(f"  {name:16s} cycles median {int(np.median(cycles[:, i])):6d}"
              f" max {int(cycles[:, i].max()):6d}")
    total = work[:, len(STAMPS) - 1] - work[:, 0]
    starts = (work[:, 15] - t0) / 1e3
    print(f"  block total cycles median {int(np.median(total))} max "
          f"{int(total.max())}; starts (us) at quantiles 0/.5/.75/1: "
          f"{np.quantile(starts, [0, .5, .75, 1]).round(2).tolist()}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_attn_phases: needs a CUDA device")
    lib = load()
    build._state["lib"] = lib      # the wrappers launch the copy
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KVh, g, dh, P = 4, 8, 2, 128, 16
    for S, pos in ((576, [575, 0, 300, 63]), (4096, [4095, 1000, 2500, 63])):
        q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda")
        k, v = (torch.randn((B, S, KVh, dh), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        Lp = S // P
        table = (torch.randperm(B * Lp, generator=gen, device="cuda")
                 .reshape(B, Lp).to(torch.int32))
        (kp, ks), (vp, vs) = (kv_quant_encode(torch.randn(
            (B * Lp, P, KVh, dh), generator=gen, device="cuda"), 4)
            for _ in range(2))
        n_blocks = da.plan_splits(S)[0] * KVh * B
        for label, call in (
                (f"contiguous bf16 S={S}", lambda: da.decode_attn(q, k, v, p)),
                (f"paged int4 S={S}", lambda: da.paged_decode_attn(
                    q, kp, vp, p, table, page_size=P, seq_len=S, kv_bits=4,
                    k_scale=ks, v_scale=vs))):
            call()
            call()
            torch.cuda.synchronize()
            lib.stamps_clear()       # the third call's stamps are read
            call()
            torch.cuda.synchronize()
            report(lib, label, n_blocks)


if __name__ == "__main__":
    main()

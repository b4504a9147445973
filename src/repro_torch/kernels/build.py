"""Build the CUDA kernels once with nvcc and load them through ctypes.

Every `csrc/*.cu` compiles to an object in its own nvcc process, all
started together (`csrc/gemm_core.cu`, the longest, in the six parts of
`PARTS`, one process each), and the objects link into one shared library
with a plain C interface:

    <repo>/build/repro_torch/<hash of the sources>/libkernels.so

The hash covers the sources and the flags, so an edited kernel rebuilds
and an unchanged one is loaded as it is. The build happens at the first
kernel launch in a process, never at import, under a file lock
(`fcntl`) on `<hash>.lock`: of several processes that launch a kernel at
once (the ranks of `launch.mesh.RankPool`), one builds and the others
wait and load its library. Only the repo's own sources
are compiled; nothing is downloaded. Kernels allocate nothing: the Python
wrappers allocate outputs and scratch with `torch.empty` and pass raw
device pointers, with the stream from
`torch.cuda.current_stream().cuda_stream`.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# sources compiled in parts, one nvcc process a part: each part's flags
# select its share of the file's kernels (see the file's "Build" note)
PARTS = {"gemm_core.cu": tuple((f"-DREPRO_GEMM_PART={p}",)
                               for p in range(6))}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the exported launchers (see the csrc headers)
SIGNATURES = {
    "repro_gemm": (_P, _I, _LL, _P, _I, _LL, _I, _I, _P, _I, _P, _P, _P,
                   _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_gemm_tc": (_P, _LL, _I, _P, _I, _LL, _I, _I, _I, _P, _I, _P, _P,
                      _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_decode_attn": (_P, _I, _P, _P, _I, _P, _I, _LL, _P, _P, _I, _I,
                          _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I,
                          _F, _P),
    "repro_paged_decode_attn": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _LL,
                                _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _P),
    "repro_fake_quant_fwd": (_P, _I, _P, _LL, _P, _P, _P, _P),
    "repro_fake_quant_bwd": (_P, _I, _P, _I, _P, _P, _P, _P, _LL, _P, _P,
                             _P, _P),
    # each source's kernel attributes (`kernels.introspect`)
    "repro_gemm_attributes": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_decode_attn_attributes": (_I, _I, _I, _I, _I, _I, _P),
    "repro_fake_quant_attributes": (_I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_state: dict = {"lib": None, "error": None}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or "
            "/usr/local/cuda/bin): the CUDA kernels of repro_torch cannot "
            "be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(PARTS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> Path:
    objs, procs = [], []
    for src in _sources():
        for i, flags in enumerate(PARTS.get(src.name, ((),))):
            obj = out_dir / f"{src.stem}.{i}.o"
            objs.append(obj)
            procs.append((f"{src.name} {' '.join(flags)}", subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for what, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{what}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out_dir / f"libkernels.{os.getpid()}.so"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    lib = out_dir / "libkernels.so"
    os.replace(tmp, lib)     # atomic: a reader never sees a partial file
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process. A build
    that failed raises again on every later call, without building
    again."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        if _state["error"] is not None:
            raise RuntimeError(_state["error"])
        out_dir = BUILD_ROOT / source_hash()
        lib_path = out_dir / "libkernels.so"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir.with_suffix(".lock"), "w") as lock:
                # another process may be building: wait for it, then
                # load what it built
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if not lib_path.exists():
                        lib_path = _compile(find_nvcc(), out_dir)
                except RuntimeError as err:
                    _state["error"] = str(err)
                    raise
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(lib_path))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_scalar(v, device):
    """A 0-d f32 tensor on `device`, read by a kernel through its
    pointer."""
    import torch
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")

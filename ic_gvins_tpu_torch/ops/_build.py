"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

All ``csrc/*.cu`` files compile into one shared library for ``sm_90a``
(Hopper) under ``build/`` at the repository root. The library's file name
carries a hash of the sources and flags, so a changed source is rebuilt at
its next use and an unchanged one is loaded as it is. Nothing is built when
the package is imported: the first kernel launch builds. A missing ``nvcc``
or a failed build raises; there is no fallback.

Every entry point has a plain C interface: device pointers and the CUDA
stream as ``c_void_p``, sizes as ``c_int``, and a returned ``cudaError_t``
(0 on success) that ``launch`` turns into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (pointers, sizes, then the stream)
SIGNATURES = {
    "clahe_apply": [_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P],
    "lk_level": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "subpix": [_P, _I, _I, _P, _P, _P, _I, _P],
}

_lib = None
build_seconds = None   # wall time of the last nvcc run in this process
build_log = ""         # nvcc's output (ptxas register / spill report)


def _nvcc():
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library():
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libicgvins_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.icg_error_string.argtypes = [ctypes.c_int]
    lib.icg_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name, *args):
    """Call entry point ``name`` and raise if it returns a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        what = lib.icg_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err} ({what})")


def stream_ptr(t):
    """The current CUDA stream of tensor ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name, *tensors):
    """Validate the tensors a kernel will read: CUDA, one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")

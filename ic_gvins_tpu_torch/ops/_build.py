"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles for ``sm_90a`` (Hopper) in its own
``nvcc`` process, all started together, and the objects link into one
shared library under ``build/`` at the repository root. The library's file
name carries a hash of the sources and flags, so a changed source is rebuilt
at its next use and an unchanged one is loaded as it is. Nothing is built
when the package is imported: the first kernel launch builds. A missing
``nvcc`` or a failed build raises; there is no fallback.

Every entry point has a plain C interface: device pointers and the CUDA
stream as ``c_void_p``, sizes as ``c_int``, and a returned ``cudaError_t``
(0 on success) that ``launch`` turns into an exception. Each takes a world
count B last before the stream: B independent inputs stacked on a leading
axis run in one launch (B = 1 for an unbatched call).
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (pointers, sizes, then the stream)
SIGNATURES = {
    "clahe_apply": [_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _I, _P],
    "lk_pyr": [_P] * 8 + [_I, _I, _I, _P, _P, _P, _I, ctypes.c_float, _I, _P, _P, _P, _I, _I, _P],
    "subpix": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P],
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


def _sources(src_dir):
    return sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))


def _compile(src_dir, so):
    """One nvcc per source of ``src_dir``, all running at once, then one link
    into ``so``."""
    global build_seconds, build_log
    nvcc = _nvcc()
    work = so.parent / f"{so.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in (s for s in _sources(src_dir) if s.suffix == ".cu"):
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            with open(log, "w") as out:
                jobs.append((obj, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=out, stderr=subprocess.STDOUT)))
        codes = [proc.wait() for _, _, proc in jobs]
        build_log = "".join(log.read_text() for _, log, _ in jobs)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({max(codes)}):\n{build_log}")
        tmp = work / so.name
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *[str(o) for o, _, _ in jobs]], capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    finally:
        build_seconds = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)


def load(src_dir=CSRC, out_dir=None):
    """Build the kernels of ``src_dir`` into ``out_dir`` (default ``build/``)
    unless a library of the same sources and flags is there, and bind it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_DIR if out_dir is None else out_dir
    so = out_dir / f"libicgvins_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _compile(src_dir, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.icg_error_string.argtypes = [ctypes.c_int]
    lib.icg_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The port's kernel library (``csrc/``), loaded once per process."""
    global _lib
    if _lib is None:
        _lib = load()
    return _lib


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

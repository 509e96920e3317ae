"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

All sources are compiled at once, one nvcc process each, and the library
name carries a hash of the source, the headers and the flags, so an edited
kernel is rebuilt and an unchanged one is reused. Fast math stays off: the
kernels rely on IEEE division and round-to-nearest-even (``rintf``) to give
the same int8 activation codes as the plain versions.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()``; ``check`` turns a non-zero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("quant_matmul", "wkv7", "v7_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every missing kernel library concurrently; returns the
    library paths. The ptxas report of each build (registers, shared
    memory, spills) is kept beside it as ``<lib>.log``."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = []
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, path, tmp, proc, time.perf_counter()))
    failed = []
    for name, path, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all kernels on
    first use."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.rwkv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def function(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int):
    """C entry ``int fn(void* x n_ptrs, int x n_ints, void* stream)``."""
    key = (lib_name, fn_name)
    if key not in _fns:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(lib_name: str, fn_name: str, code: int) -> None:
    if code != 0:
        msg = library(lib_name).rwkv_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

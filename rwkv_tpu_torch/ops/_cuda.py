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
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("quant_matmul", "wkv7", "v7_decode", "v7_decode_batched", "wkv6", "v6_decode",
           "v5_decode", "v4_decode", "block_matmul", "tp_v7", "tp_v6", "tp_v45")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[tuple, ctypes.CDLL] = {}
_fns: dict[tuple, ctypes._CFuncPtr] = {}
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str, src: Optional[Path]) -> Path:
    return Path(src) if src is not None else CSRC / f"{name}.cu"


def _lib_path(name: str, src: Optional[Path] = None, flags: tuple = ()) -> Path:
    src = _source(name, src)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for f in sorted(src.parent.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(jobs) -> None:
    """Compile (name, src, flags) jobs whose library is missing, one nvcc
    each, all at once. The ptxas report of each build (registers, shared
    memory, spills) is kept beside it as ``<lib>.log``."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src, flags in jobs:
        path = _lib_path(name, src, flags)
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, str(_source(name, src))]
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
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_all() -> dict[str, Path]:
    """Compile every missing kernel library of ``SOURCES`` concurrently;
    returns the library paths."""
    _build([(name, None, ()) for name in SOURCES])
    return {name: _lib_path(name) for name in SOURCES}


def library(name: str, src: Optional[Path] = None, flags: tuple = ()) -> ctypes.CDLL:
    """The loaded library `name`: ``csrc/<name>.cu`` (every kernel of
    ``SOURCES`` is built at once on first use), or another source `src`
    (headers beside it) and extra nvcc `flags`, as the probes build
    timing builds and earlier versions of a kernel."""
    key = (name, None if src is None else str(src), tuple(flags))
    if key not in _libs:
        path = _lib_path(name, src, flags)
        if not path.exists():
            if src is None and not flags and name in SOURCES:
                build_all()
            else:
                _build([(name, src, tuple(flags))])
        lib = ctypes.CDLL(str(path))
        lib.rwkv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_cuda_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def function(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int,
             src: Optional[Path] = None, flags: tuple = ()):
    """C entry ``int fn(void* x n_ptrs, int x n_ints, void* stream)`` of
    ``library(lib_name, src, flags)``."""
    key = (lib_name, fn_name, None if src is None else str(src), tuple(flags))
    if key not in _fns:
        fn = getattr(library(lib_name, src, flags), fn_name)
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

"""ctypes bindings for the port's native host library
(``csrc/host/rwkv_native.cpp``).

Ports ``rwkv_tpu.native``. The library owns the CPU-bound data plane:
ggmf file scanning, multithreaded block quantization, streaming file
requantization and the World trie tokenizer. Everything here has a
pure-Python counterpart (``io/``, ``utils/world_tokenizer.py``) that gives
the same bytes (``tests/test_torch_native.py``).

It is built on first use (or ``python -m rwkv_tpu_torch.native
[--force] [--build-dir DIR]``) with::

    g++ -O3 -std=c++17 -fPIC -shared -pthread \
        -o _build/rwkv_native-<hash>.so csrc/host/rwkv_native.cpp

into ``rwkv_tpu_torch/_build/``; the name carries a hash of the sources
and flags, and the library is written to a temporary file and moved into
place, so processes that build at once do not race. ``is_available()``
says whether it is built (False when the sources are not installed); the
other entry points build it when it is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = _PKG_DIR / "csrc" / "host"
SOURCE = SRC_DIR / "rwkv_native.cpp"
BUILD_DIR = _PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


class _Header(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("magic", "version", "n_vocab", "n_embed", "n_layer", "data_type")]


class _TensorInfo(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 128),
        ("dtype", ctypes.c_uint32),
        ("n_dims", ctypes.c_uint32),
        ("shape", ctypes.c_uint32 * 4),
        ("offset", ctypes.c_uint64),
        ("nbytes", ctypes.c_uint64),
    ]


_lib = None


def lib_path() -> Path:
    """Where the library of the current sources and flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in (SRC_DIR / "rwkv_native.h", SOURCE):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"rwkv_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library with g++ unless it is built; returns its path.
    Raises when g++ fails or is missing."""
    out = lib_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native library build failed (g++ exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rwkv_native_last_error.restype = ctypes.c_char_p
    lib.rwkv_ggmf_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(_Header)]
    lib.rwkv_ggmf_scan.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_TensorInfo), ctypes.c_int64]
    lib.rwkv_ggmf_scan.restype = ctypes.c_int64
    lib.rwkv_quant_row_size.argtypes = [ctypes.c_uint32, ctypes.c_int64]
    lib.rwkv_quant_row_size.restype = ctypes.c_int64
    lib.rwkv_quantize_block_data.argtypes = [
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int]
    lib.rwkv_dequantize_block_data.argtypes = [
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.rwkv_quantize_model_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.rwkv_tokenizer_init.argtypes = [ctypes.c_char_p]
    lib.rwkv_tokenizer_init.restype = ctypes.c_void_p
    lib.rwkv_tokenizer_free.argtypes = [ctypes.c_void_p]
    lib.rwkv_tokenizer_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.rwkv_tokenizer_encode.restype = ctypes.c_int64
    lib.rwkv_tokenizer_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.rwkv_tokenizer_decode.restype = ctypes.c_int64
    return lib


def _load(build_missing: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library; built first when missing and `build_missing`,
    else None."""
    global _lib
    if _lib is None:
        path = lib_path()
        if not path.exists():
            if not build_missing:
                return None
            build()
        _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def is_available() -> bool:
    """Whether the library of the current sources is built. False, not an
    error, when the sources or the library are missing or do not load."""
    try:
        return _load(build_missing=False) is not None
    except OSError:
        return False


def _check(rc, lib):
    if rc != 0:
        raise RuntimeError(lib.rwkv_native_last_error().decode())


def read_header(path: str) -> dict:
    lib = _load()
    hdr = _Header()
    _check(lib.rwkv_ggmf_read_header(path.encode(), ctypes.byref(hdr)), lib)
    return {f: getattr(hdr, f) for f, _ in _Header._fields_}


def scan_tensors(path: str) -> list[dict]:
    lib = _load()
    n = lib.rwkv_ggmf_scan(path.encode(), None, 0)
    if n < 0:
        raise RuntimeError(lib.rwkv_native_last_error().decode())
    infos = (_TensorInfo * n)()
    n2 = lib.rwkv_ggmf_scan(path.encode(), infos, n)
    assert n2 == n
    return [
        {
            "name": i.name.decode(),
            "dtype": i.dtype,
            "shape": tuple(i.shape[: i.n_dims]),
            "offset": i.offset,
            "nbytes": i.nbytes,
        }
        for i in infos
    ]


def quantize_rows(x: np.ndarray, dtype: int, n_threads: int = 0) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    n_threads = n_threads or (os.cpu_count() or 1)
    size = lib.rwkv_quant_row_size(dtype, x.size)
    if size < 0:
        raise ValueError("bad dtype/element count")
    out = np.empty(size, np.uint8)
    _check(
        lib.rwkv_quantize_block_data(
            dtype,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            x.size, n_threads,
        ),
        lib,
    )
    return out


def dequantize_rows(data: np.ndarray, dtype: int, n_elems: int, n_threads: int = 0) -> np.ndarray:
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n_threads = n_threads or (os.cpu_count() or 1)
    out = np.empty(n_elems, np.float32)
    _check(
        lib.rwkv_dequantize_block_data(
            dtype,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_elems, n_threads,
        ),
        lib,
    )
    return out


def quantize_model_file(in_path: str, out_path: str, target_dtype: int,
                        n_threads: int = 0) -> tuple[int, int]:
    """Requantize a ggmf file to `target_dtype` (a ``GgmlDType`` value);
    returns (source bytes, output bytes) of the tensor data."""
    lib = _load()
    n_threads = n_threads or (os.cpu_count() or 1)
    orig = ctypes.c_uint64()
    new = ctypes.c_uint64()
    _check(
        lib.rwkv_quantize_model_file(
            in_path.encode(), out_path.encode(), target_dtype, n_threads,
            ctypes.byref(orig), ctypes.byref(new),
        ),
        lib,
    )
    return orig.value, new.value


class NativeWorldTokenizer:
    """Native trie tokenizer with the same encode/decode surface as
    ``utils.world_tokenizer.WorldTokenizer``."""

    def __init__(self, vocab_path: Optional[str] = None):
        from rwkv_tpu_torch.utils.world_tokenizer import DEFAULT_VOCAB

        lib = _load()
        self._lib = lib
        self._tok = lib.rwkv_tokenizer_init(str(vocab_path or DEFAULT_VOCAB).encode())
        if not self._tok:
            raise RuntimeError(lib.rwkv_native_last_error().decode())

    def __del__(self):
        if getattr(self, "_tok", None):
            self._lib.rwkv_tokenizer_free(self._tok)
            self._tok = None

    def encode_bytes(self, src: bytes) -> list[int]:
        buf = np.frombuffer(src, np.uint8)
        out = np.empty(len(src) + 1, np.int32)
        n = self._lib.rwkv_tokenizer_encode(
            self._tok,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(src),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.size,
        )
        if n < 0:
            raise ValueError(self._lib.rwkv_native_last_error().decode())
        return out[:n].tolist()

    def decode_bytes(self, tokens) -> bytes:
        toks = np.asarray(tokens, np.int32)
        cap = max(16, int(toks.size) * 64)
        out = np.empty(cap, np.uint8)
        n = self._lib.rwkv_tokenizer_decode(
            self._tok,
            toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            toks.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap,
        )
        if n < 0:
            raise ValueError(self._lib.rwkv_native_last_error().decode())
        return out[:n].tobytes()

    def encode(self, s: str) -> list[int]:
        return self.encode_bytes(s.encode("utf-8"))

    def decode(self, tokens) -> str:
        return self.decode_bytes(tokens).decode("utf-8", errors="replace")


def main(argv=None) -> None:
    import argparse

    global BUILD_DIR
    ap = argparse.ArgumentParser(description="Build the native host library.")
    ap.add_argument("--force", action="store_true", help="rebuild even when built")
    ap.add_argument("--build-dir", help=f"where to build (default: {BUILD_DIR})")
    args = ap.parse_args(argv)
    if args.build_dir:
        BUILD_DIR = Path(args.build_dir)
    print(f"native library: {build(force=args.force)}")


if __name__ == "__main__":
    main()

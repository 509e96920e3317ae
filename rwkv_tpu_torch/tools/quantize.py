"""Quantize an FP32/FP16 ggmf model file to a block-quantized format.

    python -m rwkv_tpu_torch.tools.quantize SRC DEST FORMAT [--quiet] [--python]

A port of ``rwkv_tpu.tools.quantize``. It runs the native library's
multithreaded quantizer (``native.quantize_model_file``) when the library
is built, else (or with ``--python``) the port's
``io.quantize.quantize_model_file``; both write files byte-identical to
the JAX package's.
"""

from __future__ import annotations

import argparse
import time

from rwkv_tpu_torch.io.quant import QUANT_FORMATS, dtype_from_name
from rwkv_tpu_torch.io.quantize import quantize_model_file


def main(argv=None):
    p = argparse.ArgumentParser(description="Quantize an RWKV ggmf model file")
    p.add_argument("src_path", help="FP32 or FP16 ggmf model file")
    p.add_argument("dest_path", help="Output quantized ggmf model file")
    p.add_argument("format_name", choices=list(QUANT_FORMATS), help="Target format")
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--python", action="store_true",
        help="Force the pure-Python quantizer (default: native library when built)",
    )
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    native = None
    if not args.python:
        from rwkv_tpu_torch import native as native_mod

        if native_mod.is_available():
            native = native_mod
    if native is not None:
        orig, new = native.quantize_model_file(
            args.src_path, args.dest_path, int(dtype_from_name(args.format_name))
        )
    else:
        orig, new = quantize_model_file(
            args.src_path, args.dest_path, args.format_name, verbose=not args.quiet
        )
    dt = time.perf_counter() - t0
    print(f"Quantized in {dt:.2f}s: {orig / 1048576:.2f} MB -> {new / 1048576:.2f} MB")


if __name__ == "__main__":
    main()

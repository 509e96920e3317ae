"""Quantize an FP32/FP16 ggmf model file to a block-quantized format.

    python -m rwkv_tpu_torch.tools.quantize SRC DEST FORMAT [--quiet]

A port of ``rwkv_tpu.tools.quantize`` over the port's
``io.quantize.quantize_model_file``, whose output files are byte-identical
to the JAX package's. The port has no native quantizer, so the JAX tool's
``--python`` (skip the native one) has no counterpart here.
"""

from __future__ import annotations

import argparse
import time

from rwkv_tpu_torch.io.quant import QUANT_FORMATS
from rwkv_tpu_torch.io.quantize import quantize_model_file


def main(argv=None):
    p = argparse.ArgumentParser(description="Quantize an RWKV ggmf model file")
    p.add_argument("src_path", help="FP32 or FP16 ggmf model file")
    p.add_argument("dest_path", help="Output quantized ggmf model file")
    p.add_argument("format_name", choices=list(QUANT_FORMATS), help="Target format")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    orig, new = quantize_model_file(
        args.src_path, args.dest_path, args.format_name, verbose=not args.quiet
    )
    dt = time.perf_counter() - t0
    print(f"Quantized in {dt:.2f}s: {orig / 1048576:.2f} MB -> {new / 1048576:.2f} MB")


if __name__ == "__main__":
    main()

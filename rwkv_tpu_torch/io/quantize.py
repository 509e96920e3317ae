"""Model file requantization (FP32/FP16 ggmf -> Q-format ggmf).

A copy of ``rwkv_tpu.io.quantize``: its output is byte-identical to the JAX
package's on the same input. Semantics mirror rwkv.cpp's
rwkv_quantize_model_file (rwkv_quantize.inc:16-171):
only 2-D tensors are quantized; the embedding, head, v7 low-rank adapters and
`att.r_k` are kept in their original precision (the skip-list at
rwkv_quantize.inc:1-13); FP16 tensors are converted to FP32 before quantizing.
Output files are byte-identical to the reference's quantizer output.
"""

from __future__ import annotations

from rwkv_tpu_torch.io.ggmf import (
    FILE_VERSION_1,
    GgmfHeader,
    GgmfTensor,
    iter_ggmf_tensors,
    read_ggmf_header,
    write_ggmf_header,
    write_ggmf_tensor,
)
from rwkv_tpu_torch.io.quant import GgmlDType, dtype_from_name, is_quantized, quantize_rows

_SKIP_EXACT = ("emb.weight", "head.weight")
_SKIP_SUBSTRINGS = (
    "att.v1",
    "att.v2",
    "att.g1",
    "att.g2",
    "att.a1",
    "att.a2",
    "att.w1",
    "att.w2",
    "att.r_k",
)


def tensor_needs_quant(name: str) -> bool:
    if name in _SKIP_EXACT:
        return False
    return not any(s in name for s in _SKIP_SUBSTRINGS)


def quantize_model_file(
    in_path: str, out_path: str, format_name: str, verbose: bool = True
) -> tuple[int, int]:
    """Requantize a ggmf model file. Returns (original_bytes, new_bytes)."""
    from rwkv_tpu_torch.io.quant import QUANT_FORMATS, UNSUPPORTED_FORMATS

    if format_name in UNSUPPORTED_FORMATS:
        # Same graceful path the reference takes for names its table maps
        # to GGML_TYPE_UNKNOWN (rwkv_file_format.inc:5-24): a clear
        # unsupported-type error, not a KeyError from the codec table.
        raise ValueError(
            f"Unsupported data type {format_name}: no codec implemented "
            f"(supported: {', '.join(sorted(QUANT_FORMATS))})"
        )
    out_dtype = dtype_from_name(format_name)
    if not is_quantized(out_dtype):
        raise ValueError(f"Output type {format_name} is not a quantized format")

    orig_total = 0
    new_total = 0
    with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
        header = read_ggmf_header(fin)
        in_dtype = header.data_type
        if in_dtype not in (GgmlDType.FP32, GgmlDType.FP16):
            raise ValueError("Input model must be FP32 or FP16")
        out_header = GgmfHeader(
            header.magic, FILE_VERSION_1, header.n_vocab, header.n_embed,
            header.n_layer, out_dtype,
        )
        write_ggmf_header(fout, out_header)

        for t in iter_ggmf_tensors(fin, with_data=True):
            orig_size = t.nbytes
            new_size = orig_size
            if (
                t.dtype in (GgmlDType.FP32, GgmlDType.FP16)
                and len(t.shape) == 2
                and tensor_needs_quant(t.name)
            ):
                # K-quant superblocks need rows divisible by 256 (the
                # ggml_quantize_chunk n_per_row contract the reference
                # inherits, rwkv_quantize.inc:149). Tensors with
                # incompatible rows take the same per-tensor fallback
                # llama.cpp's quantize tool uses: Q4_K -> Q5_0,
                # Q5_K -> Q5_1.
                t_dtype = out_dtype
                row = t.shape[-1]
                if out_dtype == GgmlDType.Q4_K and row % 256:
                    t_dtype = GgmlDType.Q5_0
                elif out_dtype == GgmlDType.Q5_K and row % 256:
                    t_dtype = GgmlDType.Q5_1
                f32 = t.to_f32()
                packed = quantize_rows(f32, t_dtype)
                t = GgmfTensor(t.name, t_dtype, t.shape, packed.tobytes())
                new_size = t.nbytes
                if verbose:
                    from rwkv_tpu_torch.io.quant import dtype_name

                    print(
                        f"{t.name} {list(t.shape)} -> {dtype_name(t_dtype)} "
                        f"{orig_size / 1048576:.2f} MB -> {new_size / 1048576:.2f} MB"
                    )
            write_ggmf_tensor(fout, t)
            orig_total += orig_size
            new_total += new_size

    if verbose:
        print(f"original size  = {orig_total / 1048576:.2f} MB")
        print(f"quantized size = {new_total / 1048576:.2f} MB")
        print(f"compression ratio = {orig_total / max(new_total, 1):.2f}")
    return orig_total, new_total

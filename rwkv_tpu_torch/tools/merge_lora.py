"""Merge a LoRA checkpoint (.pth) into an FP32/FP16 ggmf model file.

    python -m rwkv_tpu_torch.tools.merge_lora SRC {v4,v5.1,v5.2,v6.0} LORA ALPHA DEST

A port of ``rwkv_tpu.tools.merge_lora`` (capability parity with the
reference's python/merge_lora_into_ggml.py): streams tensors from the
source file; a tensor is either wholly REPLACED by a same-named LoRA tensor
(with the converter's per-version preprocessing applied) or updated in
place with `W += B @ A * (alpha / r)`; everything else passes through
untouched. Quantize after merging.

One deliberate difference: the JAX package takes a replaced v6
``time_decay``'s head count from a hint kept in a mutable default argument
(set by an earlier ``time_faaaa`` or ``time_maa_w2`` replacement, in this
call or any earlier one, and None when there was none). Here it comes from
the model tensor being replaced, so the bytes are the JAX package's
wherever its hint holds that tensor's head count.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rwkv_tpu_torch.io.ggmf import (
    GgmfTensor,
    iter_ggmf_tensors,
    read_ggmf_header,
    write_ggmf_header,
    write_ggmf_tensor,
)
from rwkv_tpu_torch.io.quant import GgmlDType
from rwkv_tpu_torch.tools.convert_checkpoint import _exp


def _preprocess_replacement(key: str, t: np.ndarray, arch_version: str,
                            model_shape: tuple) -> np.ndarray:
    """Converter-equivalent preprocessing for a LoRA-provided full tensor
    that replaces the model tensor of shape `model_shape` (see
    ``tools/convert_checkpoint.py``)."""
    t = np.asarray(t, dtype=np.float32)
    if ".time_" in key:
        t = np.squeeze(t)
    if arch_version == "v6.0":
        if ".time_faaaa" in key:
            t = t[..., None]
        if ".time_maa_w1" in key or ".time_decay_w" in key:
            t = t.T
        if ".time_maa_w2" in key:
            t = np.swapaxes(t, 1, 2)
        if ".time_decay" in key and "_w" not in key:
            t = t.reshape(model_shape[0], -1, 1)
    elif arch_version in ("v5.1", "v5.2"):
        if ".time_decay" in key:
            t = _exp(-_exp(t))
            t = t[..., None] if arch_version == "v5.2" else t.reshape(-1, 1, 1)
        if ".time_first" in key:
            t = _exp(t).reshape(-1, 1, 1)
        if ".time_faaaa" in key:
            t = t[..., None]
    elif arch_version == "v4":
        if ".time_decay" in key:
            t = -_exp(t)
    return np.ascontiguousarray(t)


def merge_lora(
    src_path: str,
    arch_version: str,
    lora_path: str,
    lora_alpha: int,
    dest_path: str,
) -> None:
    lora = {
        k: v.float().numpy()
        for k, v in torch.load(lora_path, map_location="cpu", weights_only=True).items()
    }

    with open(src_path, "rb") as fin, open(dest_path, "wb") as fout:
        header = read_ggmf_header(fin)
        if header.data_type not in (GgmlDType.FP32, GgmlDType.FP16):
            raise ValueError("Only FP32 and FP16 source models are supported")
        write_ggmf_header(fout, header)

        for t in iter_ggmf_tensors(fin, with_data=True):
            param = t.to_f32()
            dtype = t.dtype

            if t.name in lora:
                param = _preprocess_replacement(t.name, lora.pop(t.name), arch_version, t.shape)
                if param.shape != t.shape:
                    raise ValueError(
                        f"{t.name}: shape {t.shape} in model vs {param.shape} in LoRA"
                    )
                print(f"Replaced parameter {t.name}")

            base = t.name.replace(".weight", "")
            for suffix in (".weight", ""):
                a_key, b_key = base + ".lora_A" + suffix, base + ".lora_B" + suffix
                if a_key in lora:
                    a, b = lora.pop(a_key), lora.pop(b_key)
                    if b.shape[1] != a.shape[0]:
                        raise ValueError(f"{t.name}: bad LoRA shapes {a.shape}, {b.shape}")
                    r = b.shape[1]
                    param = param + (b @ a) * (lora_alpha / r)
                    print(f"Merged LoRA into parameter {t.name}, lora_r = {r}")
                    break

            if dtype == GgmlDType.FP16:
                data = param.astype(np.float16).tobytes()
            else:
                data = param.astype(np.float32).tobytes()
            write_ggmf_tensor(fout, GgmfTensor(t.name, dtype, t.shape, data))

    for key in lora:
        print(f"WARNING: Unused parameter in LoRA state dict {key}")
    print("Done")


def main(argv=None):
    p = argparse.ArgumentParser(description="Merge a LoRA .pth into a ggmf model file")
    p.add_argument("src_path")
    p.add_argument("rwkv_arch_version", choices=["v4", "v5.1", "v5.2", "v6.0"])
    p.add_argument("lora_path")
    p.add_argument("lora_alpha", type=int)
    p.add_argument("dest_path")
    a = p.parse_args(argv)
    merge_lora(a.src_path, a.rwkv_arch_version, a.lora_path, a.lora_alpha, a.dest_path)


if __name__ == "__main__":
    main()

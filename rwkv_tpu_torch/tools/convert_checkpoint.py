"""Convert an RWKV PyTorch checkpoint (.pth / .safetensors) to `ggmf`.

    python -m rwkv_tpu_torch.tools.convert_checkpoint SRC DEST [FP16|FP32]

A port of ``rwkv_tpu.tools.convert_checkpoint``, which has capability
parity with the reference converter (rwkv.cpp's
python/convert_pytorch_to_ggml.py), including every per-version weight
preprocessing rule, so files produced here load in the port, the JAX
package and the reference engine:

  v4:    time_decay -> -exp(time_decay)
  v5.1:  time_decay -> exp(-exp(.)) reshaped [-1,1,1]; time_first -> exp(.)
         reshaped [-1,1,1]
  v5.2:  time_decay -> exp(-exp(.)) with trailing axis; time_faaaa
         unsqueezed
  v6:    time_faaaa unsqueezed; time_maa_w1/time_decay_w1/w2 transposed;
         time_maa_w2 transposed (1,2); time_decay reshaped [n_head,-1,1]
  v7:    six att.x_* tensors concatenated to att.x_rwkvag; low-rank pairs
         (w1/w2/a1/a2/v1/v2/g1/g2) transposed; block-0 v0/v1/v2 dropped
  all:   '.time_' tensors squeezed; under FP16, 1-D tensors and the listed
         small/special tensors stay FP32.

Implementation is numpy-first: torch deserializes a .pth and computes
``exp`` (byte-identity with the reference, which computes in torch);
``safetensors`` is imported only for a .safetensors checkpoint.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from rwkv_tpu_torch.io.ggmf import (
    FILE_VERSION_1, GGMF_MAGIC, GgmfHeader, GgmfTensor, write_ggmf_header, write_ggmf_tensor,
)
from rwkv_tpu_torch.io.quant import GgmlDType

# Tensors kept in FP32 even when converting to FP16 (reference:128-137).
_FP32_KEEP_SUBSTRINGS = (
    ".time_",
    ".k_k", ".k_a", ".r_k",
    ".x_rwkvag", ".x_k",
    ".w0", ".a0", ".v0",
)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return {k: np.asarray(v) for k, v in load_file(path).items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def _exp(t: np.ndarray) -> np.ndarray:
    """exp() through torch: torch's vectorized expf differs from numpy's by
    1 ulp on some inputs, and byte-identity with the reference converter
    (which computes in torch) requires matching it."""
    return torch.exp(torch.from_numpy(np.ascontiguousarray(t))).numpy()


def detect_checkpoint_version(sd: Dict[str, np.ndarray]) -> str:
    if "blocks.0.att.k_k" in sd:
        return "7.0"
    if "blocks.0.att.time_maa_x" in sd:
        return "6.0"
    if "blocks.0.att.gate.weight" in sd:
        return "5.2"
    if "blocks.0.att.ln_x.weight" in sd:
        return "5.1"
    return "4.0"


def preprocess_state_dict(sd: Dict[str, np.ndarray]) -> tuple[Dict[str, np.ndarray], str]:
    """Apply the per-version on-disk transformations. Returns (tensors in
    write order, version string)."""
    version = detect_checkpoint_version(sd)

    if version == "7.0":
        fused: Dict[str, np.ndarray] = {}
        for k in list(sd.keys()):
            if ".att.x_" in k and k.split(".")[-1] in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g"):
                layer = k.split(".")[1]
                key = f"blocks.{layer}.att.x_rwkvag"
                part = sd.pop(k)
                fused[key] = part if key not in fused else np.concatenate([fused[key], part], axis=0)
        # Rebuild in original order, inserting the fused tensor where the
        # first x_* appeared; order within the file does not matter to
        # loaders (both ours and the reference read by name).
        sd = {**sd, **fused}
        for drop in ("blocks.0.att.v0", "blocks.0.att.v1", "blocks.0.att.v2"):
            sd.pop(drop, None)

    out: Dict[str, np.ndarray] = {}
    n_head = None
    if version == "6.0":
        n_head = sd["blocks.0.att.time_faaaa"].shape[0]

    for k, t in sd.items():
        t = np.asarray(t, dtype=np.float32)
        if ".time_" in k:
            t = np.squeeze(t)

        if version == "7.0":
            if any(s in k for s in (".w1", ".w2", ".a1", ".a2", ".v1", ".v2", ".g1", ".g2")):
                t = t.T
        elif version == "6.0":
            if ".time_faaaa" in k:
                t = t[..., None]
            if ".time_maa_w1" in k or ".time_decay_w" in k:
                t = t.T
            if ".time_maa_w2" in k:
                t = np.swapaxes(t, 1, 2)
            if ".time_decay" in k and "_w" not in k:
                t = t.reshape(n_head, -1, 1)
        elif version in ("5.1", "5.2"):
            if ".time_decay" in k:
                t = _exp(-_exp(t))
                t = t[..., None] if version == "5.2" else t.reshape(-1, 1, 1)
            if ".time_first" in k:
                t = _exp(t).reshape(-1, 1, 1)
            if ".time_faaaa" in k:
                t = t[..., None]
        else:  # v4
            if ".time_decay" in k:
                t = -_exp(t)

        out[k] = np.ascontiguousarray(t)
    return out, version


def convert(src_path: str, dest_path: str, data_type: str = "FP16") -> None:
    is_fp16 = data_type in ("FP16", "float16")
    sd = load_state_dict(src_path)
    emb = sd["emb.weight"]
    n_vocab, n_embed = emb.shape
    n_layer = 0
    while f"blocks.{n_layer}.ln1.weight" in sd:
        n_layer += 1
    assert n_layer > 0, "no blocks.N.ln1.weight found — not an RWKV checkpoint?"

    tensors, version = preprocess_state_dict(sd)
    print(f"Detected RWKV v{version}; n_vocab={n_vocab} n_embed={n_embed} n_layer={n_layer}")

    header = GgmfHeader(
        GGMF_MAGIC, FILE_VERSION_1, n_vocab, n_embed, n_layer,
        GgmlDType.FP16 if is_fp16 else GgmlDType.FP32,
    )
    with open(dest_path, "wb") as f:
        write_ggmf_header(f, header)
        for name, t in tensors.items():
            keep_fp32 = t.ndim == 1 or any(s in name for s in _FP32_KEEP_SUBSTRINGS)
            if is_fp16 and not keep_fp32:
                data = t.astype(np.float16)
                dtype = GgmlDType.FP16
            else:
                data = t
                dtype = GgmlDType.FP32
            write_ggmf_tensor(
                f, GgmfTensor(name, dtype, tuple(t.shape), data.tobytes())
            )
            print(f"Writing {name}, shape {list(t.shape)}, type {dtype.name}")
    print("Done")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("src_path", help="PyTorch .pth or .safetensors checkpoint")
    p.add_argument("dest_path", help="Output ggmf file")
    p.add_argument(
        "data_type", nargs="?", default="FP16",
        choices=["FP16", "FP32", "float16", "float32"],
    )
    args = p.parse_args(argv)
    convert(args.src_path, args.dest_path, args.data_type)


if __name__ == "__main__":
    main()

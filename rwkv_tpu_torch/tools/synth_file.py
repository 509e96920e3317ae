"""Write a synthetic parameter tree as a ggmf model file.

``write_synth_ggmf(cfg, params, path, dtype="FP32")`` writes the tree that
``models.synth.synth_params`` builds in the on-disk layout that
``models.loader.load_params`` (and the JAX package's loader) undoes: the
layout the JAX package's checkpoint converter emits
(``rwkv_tpu/tools/convert_checkpoint.py``). Coefficients the quantizer must
not touch keep the converter's trailing singleton dims (v7 ``x_rwkvag`` as
``[6, 1, C]``, the v5.2/v6 decay and bonus as ``[H, S, 1]``, v5.1's per-head
scalars as ``[H, 1, 1]``), since ``io.quantize.quantize_model_file``
quantizes every 2-D tensor outside its skip list. Under ``dtype="FP16"``
2-D weights are written in float16 and vectors and coefficients in float32,
by the converter's rule.

With ``io.quantize.quantize_model_file`` this makes model files in every
format from a seed, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

from rwkv_tpu_torch.io.ggmf import (
    FILE_VERSION_1, GGMF_MAGIC, GgmfHeader, GgmfTensor, write_ggmf_header, write_ggmf_tensor,
)
from rwkv_tpu_torch.io.quant import GgmlDType
from rwkv_tpu_torch.models.config import ModelConfig

# names the converter keeps in float32 in an FP16 file
_FP32_KEEP = (".time_", ".k_k", ".k_a", ".r_k", ".x_rwkvag", ".x_k", ".w0", ".a0", ".v0")


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().to("cpu").float().numpy()
    return np.ascontiguousarray(t, dtype=np.float32)


def _disk_shape(cfg: ModelConfig, key: str, arr: np.ndarray) -> tuple:
    major, minor = cfg.version_major, cfg.version_minor
    if key == "att.x_rwkvag":
        return (arr.shape[0], 1, arr.shape[-1])
    if key in ("att.time_decay", "att.time_first", "att.time_faaaa"):
        if major == 5 and minor == 1:
            return (arr.shape[0], 1, 1)
        if major in (5, 6):
            return (*arr.shape, 1)
    return arr.shape


def _tensors(cfg: ModelConfig, params: dict):
    yield "emb.weight", _np(params["emb"])
    yield "blocks.0.ln0.weight", _np(params["ln0"][0])
    yield "blocks.0.ln0.bias", _np(params["ln0"][1])
    for i, block in enumerate(params["blocks"]):
        for key, value in block.items():
            arr = _np(value)
            yield f"blocks.{i}.{key}", arr.reshape(_disk_shape(cfg, key, arr))
    yield "ln_out.weight", _np(params["ln_out"][0])
    yield "ln_out.bias", _np(params["ln_out"][1])
    yield "head.weight", _np(params["head"])


def write_synth_ggmf(cfg: ModelConfig, params: dict, path: str, dtype: str = "FP32") -> None:
    """Write `params` (dense tensors or arrays, the synth tree) to `path`
    as a ggmf file in FP32 or FP16."""
    if dtype not in ("FP32", "FP16"):
        raise ValueError(f"dtype must be FP32 or FP16 (quantize the FP32 file), got {dtype!r}")
    fp16 = dtype == "FP16"
    header = GgmfHeader(GGMF_MAGIC, FILE_VERSION_1, cfg.n_vocab, cfg.n_embed, cfg.n_layer,
                        GgmlDType.FP16 if fp16 else GgmlDType.FP32)
    with open(path, "wb") as f:
        write_ggmf_header(f, header)
        for name, arr in _tensors(cfg, params):
            if fp16 and arr.ndim > 1 and not any(s in name for s in _FP32_KEEP):
                t = GgmfTensor(name, GgmlDType.FP16, arr.shape, arr.astype(np.float16).tobytes())
            else:
                t = GgmfTensor(name, GgmlDType.FP32, arr.shape, arr.tobytes())
            write_ggmf_tensor(f, t)

"""ggmf model file -> the port's parameter tree.

Ports ``rwkv_tpu.models.loader.load_params``: one pass over the file.

- 2-D projection weights (``LAYER_WEIGHT_KEYS``) and the head become
  ``ops.parity.Weight`` leaves in the file's precision: dense (float32 or
  float16) or block-quantized (int8 codes, f32 scales, optional mins).
- The embedding keeps the file's float dtype; every other tensor becomes a
  float32 vector or coefficient in its canonical shape (the converter's
  trailing singleton dims, fused ``x_rwkvag`` and per-head reshapes are
  undone here once).

The tree is the one ``models.synth.synth_params`` builds (``emb``, ``ln0``,
``ln_out``, ``head``, ``blocks[i][key]``), so ``ServingModel`` takes either.
All leaves are CPU tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from rwkv_tpu_torch.io.ggmf import GgmfTensor, read_ggmf
from rwkv_tpu_torch.io.quant import GgmlDType, is_quantized
from rwkv_tpu_torch.models.config import ModelConfig, detect_version
from rwkv_tpu_torch.ops.parity import Weight


def _dense(t: GgmfTensor) -> torch.Tensor:
    if t.dtype == GgmlDType.FP16:
        return torch.from_numpy(np.frombuffer(t.data, dtype=np.float16).reshape(t.shape).copy())
    return torch.from_numpy(t.to_f32())


def _weight(t: GgmfTensor) -> Weight:
    if is_quantized(t.dtype):
        return Weight.from_packed(t.data, t.dtype, t.shape)
    return Weight(kind="dense", w=_dense(t))


def _f32(t: GgmfTensor, *shape) -> torch.Tensor:
    arr = t.to_f32()
    return torch.from_numpy(np.ascontiguousarray(arr.reshape(*shape) if shape else arr))


# parameter-name suffixes (after "blocks.N.") that are 2-D projection
# weights consumed by mm(); everything else is a vector or coefficient
LAYER_WEIGHT_KEYS = frozenset({
    "att.key.weight", "att.value.weight", "att.receptance.weight", "att.gate.weight",
    "att.output.weight", "att.time_maa_w1", "att.time_decay_w1", "att.time_decay_w2",
    "att.w1", "att.w2", "att.a1", "att.a2", "att.v1", "att.v2", "att.g1", "att.g2",
    "ffn.key.weight", "ffn.value.weight", "ffn.receptance.weight",
})


def load_params(path: str) -> tuple[ModelConfig, dict[str, Any]]:
    """Load a ggmf model file into (config, parameter tree)."""
    header, tensors = read_ggmf(path, with_data=True)
    by_name = {t.name: t for t in tensors}
    major, minor = detect_version(by_name.keys())
    head_count = head_size = 0
    if major == 7:
        head_count = by_name["blocks.0.att.r_k"].shape[0]
    elif major >= 5:
        head_count = by_name["blocks.0.att.time_decay"].shape[0]
    if head_count:
        head_size = header.n_embed // head_count
    config = ModelConfig(n_vocab=header.n_vocab, n_embed=header.n_embed,
                         n_layer=header.n_layer, version_major=major, version_minor=minor,
                         head_count=head_count, head_size=head_size)
    params: dict[str, Any] = {
        "emb": _dense(by_name["emb.weight"]),
        "ln0": (_f32(by_name["blocks.0.ln0.weight"], -1), _f32(by_name["blocks.0.ln0.bias"], -1)),
        "ln_out": (_f32(by_name["ln_out.weight"], -1), _f32(by_name["ln_out.bias"], -1)),
        "head": _weight(by_name["head.weight"]),
        "blocks": [],
    }
    for i in range(header.n_layer):
        prefix = f"blocks.{i}."
        layer: dict[str, Any] = {}
        for name, t in by_name.items():
            if not name.startswith(prefix):
                continue
            key = name[len(prefix):]
            if key in ("ln0.weight", "ln0.bias"):
                continue
            if key in LAYER_WEIGHT_KEYS:
                layer[key] = _weight(t)
            elif key == "att.x_rwkvag":
                layer[key] = _f32(t, 6, -1)  # fused token-shift mixes [6, 1, C] -> [6, C]
            elif key in ("att.r_k", "att.time_maa_w2"):
                layer[key] = _f32(t)  # [H, S]; [5, C, dim]
            elif key in ("att.time_decay", "att.time_first", "att.time_faaaa"):
                if major == 4 or (major == 5 and minor == 1):
                    layer[key] = _f32(t, -1)  # [C] (v4) or a scalar per head [H] (v5.1)
                else:
                    layer[key] = _f32(t, t.shape[0], -1)  # [H, S]
            else:
                layer[key] = _f32(t, -1)
        params["blocks"].append(layer)
    return config, params

"""Carry weights across from the JAX package.

``params_from_numpy(cfg, tree)`` takes a parameter tree with the structure
of ``rwkv_tpu``'s ``load_params`` / ``synth_params`` output -- ``emb``,
``ln0``, ``ln_out``, ``head`` and ``blocks[i][key]`` -- whose leaves are
numpy arrays (each linear weight as its dense ``[out, in]`` matrix), and
returns the port's parameter tree: the same structure with CPU float32
tensors, as ``rwkv_tpu_torch.models.synth.synth_params`` builds it.
"""

from __future__ import annotations

import numpy as np
import torch

from rwkv_tpu_torch.models.config import ModelConfig


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_numpy(cfg: ModelConfig, tree: dict) -> dict:
    c, vocab = cfg.n_embed, cfg.n_vocab
    emb, head = _tensor(tree["emb"]), _tensor(tree["head"])
    if emb.shape != (vocab, c) or head.shape != (vocab, c):
        raise ValueError(
            f"emb/head must be [{vocab}, {c}]; got {tuple(emb.shape)} and "
            f"{tuple(head.shape)}"
        )
    if len(tree["blocks"]) != cfg.n_layer:
        raise ValueError(
            f"expected {cfg.n_layer} blocks, got {len(tree['blocks'])}"
        )
    return {
        "emb": emb,
        "ln0": tuple(_tensor(x) for x in tree["ln0"]),
        "ln_out": tuple(_tensor(x) for x in tree["ln_out"]),
        "head": head,
        "blocks": [
            {k: _tensor(v) for k, v in blk.items()} for blk in tree["blocks"]
        ],
    }

"""Carry weights across from the JAX package.

``params_from_numpy(cfg, tree)`` takes a parameter tree with the structure
of ``rwkv_tpu``'s ``load_params`` / ``synth_params`` output -- ``emb``,
``ln0``, ``ln_out``, ``head`` and ``blocks[i][key]`` -- whose leaves are
numpy arrays (each linear weight as its dense ``[out, in]`` matrix, or a
file-quantized one as a dict ``{"q", "d", "m", "fmt"}`` of the JAX
``Weight``'s codes ``[out, nb, 32]``, scales and mins ``[out, nb]`` (``m``
None where the format has none) and format name), and returns the port's
parameter tree: the same structure with CPU float32 tensors and
``ops.parity.Weight`` quant leaves, as ``models.synth.synth_params`` and
``models.loader.load_params`` build it. So a tree that the JAX package
loaded from a file crosses over whole.

``mlp_readout_from_jax(params, readout)`` loads the JAX
``MultiLayerReadout``'s parameters (a list of ``(w [in, out], b [out])``
numpy pairs) into the port's ``reservoir.enhanced.MultiLayerReadout``, so
both train from the same start.
"""

from __future__ import annotations

import numpy as np
import torch

from rwkv_tpu_torch.models.config import ModelConfig
from rwkv_tpu_torch.ops.parity import Weight


def _tensor(a):
    if isinstance(a, dict):
        return Weight.from_codes(a["q"], a["d"], a.get("m"), a["fmt"])
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


def mlp_readout_from_jax(params, readout):
    """Copy JAX's MLP readout parameters, ``[(w [in, out], b [out]), ...]``,
    into `readout` (a ``MultiLayerReadout`` of the same sizes, on any
    device) as its ``nn.Linear`` weights [out, in] and biases; returns it,
    ready to predict or to train on."""
    if len(params) != len(readout.layers):
        raise ValueError(f"{len(params)} layers given, the readout has {len(readout.layers)}")
    with torch.no_grad():
        for (w, b), layer in zip(params, readout.layers):
            w = np.asarray(w, dtype=np.float32)
            if w.shape != (layer.in_features, layer.out_features):
                raise ValueError(f"weight {w.shape}, expected "
                                 f"{(layer.in_features, layer.out_features)}")
            layer.weight.copy_(torch.from_numpy(np.array(w.T, order="C")))
            layer.bias.copy_(torch.from_numpy(np.array(b, dtype=np.float32)))
    readout.is_fitted = True
    return readout

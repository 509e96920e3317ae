"""Recurrent-state management.

State is a dict of stacked per-layer tensors. This module defines the blank
state and the lossless conversion to/from the reference's flat FP32 layout:

per layer, v4:   [ffn_xx C][att_xx C][aa C][bb C][pp C]
per layer, v5+:  [ffn_xx C][att_xx C][heads H*S*S]  (heads[h, i, j], i = value
                 dim, j = key dim)
"""

from __future__ import annotations

import numpy as np
import torch

from rwkv_tpu_torch.device import resolve_device
from rwkv_tpu_torch.models.config import ModelConfig

State = dict[str, torch.Tensor]


def init_state(cfg: ModelConfig, device=None) -> State:
    """Blank state for one sequence: arrays [L, ...] on `device`
    (default: the CUDA card; raises when there is none)."""
    dev = resolve_device(device)
    l, c = cfg.n_layer, cfg.n_embed
    state: State = {
        "ffn_xx": torch.zeros((l, c), dtype=torch.float32, device=dev),
        "att_xx": torch.zeros((l, c), dtype=torch.float32, device=dev),
    }
    if cfg.version_major >= 5:
        h, s = cfg.head_count, cfg.head_size
        state["heads"] = torch.zeros((l, h, s, s), dtype=torch.float32, device=dev)
    else:
        state["aa"] = torch.zeros((l, c), dtype=torch.float32, device=dev)
        state["bb"] = torch.zeros((l, c), dtype=torch.float32, device=dev)
        # v4 max-trick accumulator starts at -1e30
        state["pp"] = torch.full((l, c), -1e30, dtype=torch.float32, device=dev)
    return state


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def state_to_flat(cfg: ModelConfig, state: State) -> np.ndarray:
    """Pack the structured state into the reference's flat FP32 layout."""
    l, c = cfg.n_layer, cfg.n_embed
    parts = [_np(state["ffn_xx"]).reshape(l, c), _np(state["att_xx"]).reshape(l, c)]
    if cfg.version_major >= 5:
        parts.append(_np(state["heads"]).reshape(l, -1))
    else:
        parts.extend(_np(state[k]).reshape(l, c) for k in ("aa", "bb", "pp"))
    return np.concatenate(parts, axis=1).reshape(-1)


def state_from_flat(cfg: ModelConfig, flat: np.ndarray, device=None) -> State:
    """Unpack a reference-layout flat state buffer into the structured form
    on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    l, c = cfg.n_layer, cfg.n_embed
    rows = np.asarray(flat, dtype=np.float32).reshape(l, -1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    state: State = {"ffn_xx": t(rows[:, :c]), "att_xx": t(rows[:, c : 2 * c])}
    if cfg.version_major >= 5:
        h, s = cfg.head_count, cfg.head_size
        state["heads"] = t(rows[:, 2 * c :].reshape(l, h, s, s))
    else:
        state["aa"] = t(rows[:, 2 * c : 3 * c])
        state["bb"] = t(rows[:, 3 * c : 4 * c])
        state["pp"] = t(rows[:, 4 * c : 5 * c])
    return state

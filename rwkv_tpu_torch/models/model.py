"""User-facing model API: the ggml-parity engine.

Ports ``rwkv_tpu.models.model.RWKVModel``, the surface of the reference
library's C API (``rwkv_eval`` / ``rwkv_eval_sequence`` /
``rwkv_eval_sequence_in_chunks`` / ``rwkv_init_state``):

- the parameters stay in the file's precision (``models.loader``), and each
  product runs ``ops.parity.mm``: f32 or FP16 weights in float32, quantized
  weights through the ggml-parity matmul (q8_0 / q8_1 / q8_K activations);
- the forward is ``models.graph.forward`` with the exact token recurrences,
  not the prefill kernels;
- state is a dict of tensors on the model's device, with the flat
  conversions of the reference's buffer layout.

The JAX class compiles one function per (T, compute_logits) and caches it
(``_fn`` / ``_jit_cache``); eager PyTorch needs neither, so they are left
out.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rwkv_tpu_torch.device import resolve_device
from rwkv_tpu_torch.models.graph import forward
from rwkv_tpu_torch.models.loader import load_params
from rwkv_tpu_torch.models.state import State, init_state, state_from_flat, state_to_flat
from rwkv_tpu_torch.ops.parity import Weight


def _to(tree, device):
    """The parameter tree with every leaf on `device`."""
    if isinstance(tree, Weight):
        return tree.to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


class RWKVModel:
    def __init__(self, model_path: str, device=None):
        """Load a ggmf file (FP32, FP16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K
        or Q5_K) onto `device` (default: the CUDA card; raises when there
        is none)."""
        self.device = resolve_device(device)
        self.config, params = load_params(model_path)
        self.params = _to(params, self.device)

    # -- metadata (rwkv.h getters) ---------------------------------------
    @property
    def n_vocab(self) -> int:
        return self.config.n_vocab

    @property
    def n_embed(self) -> int:
        return self.config.n_embed

    @property
    def n_layer(self) -> int:
        return self.config.n_layer

    @property
    def state_len(self) -> int:
        return self.config.state_len

    @property
    def logits_len(self) -> int:
        return self.config.n_vocab

    # -- state ------------------------------------------------------------
    def init_state(self) -> State:
        return init_state(self.config, self.device)

    def state_to_flat(self, state: State) -> np.ndarray:
        return state_to_flat(self.config, state)

    def state_from_flat(self, flat: np.ndarray) -> State:
        return state_from_flat(self.config, flat, self.device)

    # -- evaluation -------------------------------------------------------
    def eval(self, token: int, state: Optional[State] = None, compute_logits: bool = True):
        """Process one token (the reference's serial mode)."""
        return self.eval_sequence([token], state, compute_logits)

    def eval_sequence(
        self,
        tokens: Sequence[int],
        state: Optional[State] = None,
        compute_logits: bool = True,
    ):
        """Process a token sequence in one pass (sequence mode). Returns
        (logits [n_vocab] of the last token on the model's device | None,
        state)."""
        if state is None:
            state = self.init_state()
        tokens = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=self.device)
        return forward(self.params, state, tokens, self.config, compute_logits=compute_logits)

    def eval_sequence_in_chunks(
        self,
        tokens: Sequence[int],
        chunk_size: int = 16,
        state: Optional[State] = None,
        compute_logits: bool = True,
    ):
        """Chunked prefill: passes of `chunk_size` tokens (and the
        remainder); logits only on the last chunk."""
        tokens = np.asarray(tokens, dtype=np.int32)
        n = len(tokens)
        if n == 0:
            raise ValueError("Sequence length is 0")
        if state is None:
            state = self.init_state()
        logits = None
        pos = 0
        while pos < n:
            chunk = tokens[pos : pos + chunk_size]
            is_last = pos + chunk_size >= n
            logits, state = self.eval_sequence(
                chunk, state, compute_logits=compute_logits and is_last
            )
            pos += chunk_size
        return logits, state

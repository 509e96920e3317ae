"""Reservoir computing on RWKV: the model's recurrent state is a fixed
"reservoir"; a trainable linear readout maps state activations to outputs.

Ports ``rwkv_tpu.reservoir.reservoir``: the same fit / predict / run /
score surface and the same activation definition (the first `units`
elements of the flat state, i.e. layer 0's FFN token-shift row after each
token). The JAX class runs one compiled scan of single-token forwards; here
one ``graph.forward`` pass over the whole sequence returns layer 0's FFN
rows (``ffn_rows=True``), copied to the host once a sequence. The ridge
readout (``ridge_fit``, ``r2_score``) is the JAX package's numpy float64
code, so equal activations give equal coefficients.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import numpy as np
import torch

from rwkv_tpu_torch.models.graph import forward
from rwkv_tpu_torch.models.model import RWKVModel


def ridge_fit(
    x: np.ndarray, y: np.ndarray, alpha: float, use_bias: bool = True
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Closed-form ridge: W = (X'X + aI)^-1 X'Y, with optional
    (unregularized) intercept via mean-centering. Returns (coef [out, in],
    intercept [out] | None)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if use_bias:
        x_mean = x.mean(axis=0)
        y_mean = y.mean(axis=0)
        xc, yc = x - x_mean, y - y_mean
    else:
        xc, yc = x, y
    gram = xc.T @ xc + alpha * np.eye(x.shape[1])
    coef = np.linalg.solve(gram, xc.T @ yc).T  # [out, in]
    intercept = (y_mean - x_mean @ coef.T) if use_bias else None
    return coef.astype(np.float32), (
        None if intercept is None else intercept.astype(np.float32)
    )


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean(axis=0)) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0


class ReservoirRWKV:
    """Echo State Network with an RWKV reservoir and a trainable readout."""

    def __init__(
        self,
        model: Union[RWKVModel, str],
        units: Optional[int] = None,
        alpha: float = 1e-6,
        use_bias: bool = True,
        dtype: Any = np.float32,
        device=None,
    ):
        """`model` is an ``RWKVModel`` (it keeps its own device) or a ggmf
        path, loaded onto `device` (default: the CUDA card; raises when
        there is none)."""
        self.rwkv_model = model if isinstance(model, RWKVModel) else RWKVModel(model, device)
        self.n_vocab = self.rwkv_model.n_vocab
        self.n_embed = self.rwkv_model.n_embed
        self.n_layer = self.rwkv_model.n_layer

        self.units = units if units is not None else self.n_embed
        if self.units > self.n_embed:
            raise ValueError(
                f"units ({self.units}) cannot exceed model embedding size ({self.n_embed})"
            )
        self.alpha = alpha
        self.use_bias = use_bias
        self.dtype = dtype

        self._is_trained = False
        self._readout_weights: Optional[np.ndarray] = None
        self._readout_bias: Optional[np.ndarray] = None
        self._reservoir_state = None

    # -- reservoir dynamics ----------------------------------------------
    @property
    def is_trained(self) -> bool:
        return self._is_trained

    @property
    def device(self) -> torch.device:
        return self.rwkv_model.device

    def reset_state(self) -> None:
        self._reservoir_state = None

    def _get_reservoir_activations(self, tokens, return_states: bool = False):
        m = self.rwkv_model
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        state = self._reservoir_state if self._reservoir_state is not None else m.init_state()
        if len(tokens):
            toks = torch.as_tensor(tokens.astype(np.int64), device=m.device)
            _, state, rows = forward(m.params, state, toks, m.config, compute_logits=False,
                                     ffn_rows=True)
            acts = rows[:, : self.units].cpu().numpy()
        else:
            acts = np.zeros((0, self.units), np.float32)
        self._reservoir_state = state
        activations = acts.astype(self.dtype)
        if return_states:
            return activations, m.state_to_flat(state)
        return activations

    # -- training / inference --------------------------------------------
    def _collect(self, x, y, warmup: int):
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        all_acts: List[np.ndarray] = []
        all_targets: List[np.ndarray] = []
        is_multi = isinstance(x, list) and len(x) > 0 and isinstance(x[0], (list, np.ndarray))
        if is_multi:
            if len(x) != len(y):
                raise ValueError(f"{len(x)} sequences vs {len(y)} targets")
            for seq, target in zip(x, y):
                self.reset_state()
                acts = self._get_reservoir_activations(seq)[warmup:]
                if len(acts) == 0:
                    continue
                all_acts.append(acts)
                target = np.asarray(target)
                if target.ndim <= 1:
                    all_targets.append(np.repeat(target.reshape(1, -1), len(acts), axis=0))
                else:
                    t = target[warmup:]
                    if len(t) != len(acts):
                        t = np.repeat(target[-1].reshape(1, -1), len(acts), axis=0)
                    all_targets.append(t)
        else:
            self.reset_state()
            acts = self._get_reservoir_activations(x)[warmup:]
            all_acts.append(acts)
            if y.shape[0] == 1:
                all_targets.append(np.repeat(y, len(acts), axis=0))
            else:
                all_targets.append(y[warmup:] if warmup > 0 else y)
        return np.vstack(all_acts), np.vstack(all_targets)

    def fit(self, x, y: np.ndarray, warmup: int = 0) -> "ReservoirRWKV":
        acts, targets = self._collect(x, np.asarray(y), warmup)
        self._readout_weights, self._readout_bias = ridge_fit(
            acts, targets, self.alpha, self.use_bias
        )
        self._is_trained = True
        return self

    def _apply_readout(self, acts: np.ndarray) -> np.ndarray:
        out = acts @ self._readout_weights.T
        if self._readout_bias is not None:
            out = out + self._readout_bias
        if out.ndim > 1 and out.shape[1] == 1:
            out = out.reshape(-1)
        return out

    def predict(self, x, reset_state: bool = True) -> np.ndarray:
        if not self._is_trained:
            raise RuntimeError("Model must be trained before prediction. Call fit() first.")
        if reset_state:
            self.reset_state()
        return self._apply_readout(self._get_reservoir_activations(x))

    def run(self, x, reset_state: bool = True) -> np.ndarray:
        if reset_state:
            self.reset_state()
        return self._get_reservoir_activations(x)

    def score(self, x, y: np.ndarray, warmup: int = 0) -> float:
        if not self._is_trained:
            raise RuntimeError("Model must be trained before scoring. Call fit() first.")
        y = np.asarray(y)
        is_multi = isinstance(x, list) and len(x) > 0 and isinstance(x[0], (list, np.ndarray))
        if is_multi:
            preds, trues = [], []
            for seq, target in zip(x, y):
                pred = self.predict(seq, reset_state=True)[warmup:]
                target = np.asarray(target)
                preds.append(pred)
                if target.ndim <= 1 and (target.ndim == 0 or len(target) != len(pred)):
                    trues.append(np.repeat(np.ravel(target).reshape(1, -1), len(pred), axis=0))
                else:
                    trues.append(target[warmup:] if target.ndim > 1 else target)
            y_pred = np.concatenate([np.atleast_1d(p).reshape(len(p), -1) for p in preds])
            y_true = np.vstack([np.atleast_2d(t) for t in trues])
            if y_true.shape[1] == 1:
                y_true = y_true.reshape(-1)
                y_pred = y_pred.reshape(-1)
        else:
            y_pred = self.predict(x, reset_state=True)[warmup:]
            y_true = y[warmup:]
        return r2_score(y_true, y_pred)

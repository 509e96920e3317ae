"""Enhanced reservoir computing: ESN parameter mapping, advanced readouts,
online learning, hierarchical multi-timescale outputs, chatbot personas.

Ports ``rwkv_tpu.reservoir.enhanced``. The persona presets, the parameter
mapping, ``OnlineLearner`` (SGD and recursive least squares),
``_RidgeReadout``, ``HierarchicalOutput``, the ESN transforms and
``EnhancedReservoirRWKV`` are the JAX package's host numpy code, copied
with its semantics (the leaky integration against the previous call's
whole activation array, the density mask and noise drawn from
``np.random.default_rng(random_seed)`` in the same order). The MLP readout,
trained there with JAX and optax, is an ``nn.Module`` here: ``nn.Linear``
layers, He-normal initialisation from a seeded ``torch.Generator``, and
full-batch ``torch.optim.Adam`` on the mean squared error, on the
reservoir model's device (``convert.mlp_readout_from_jax`` carries JAX's
parameters across).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rwkv_tpu_torch.device import resolve_device
from rwkv_tpu_torch.reservoir.reservoir import ReservoirRWKV, ridge_fit

# ESN parameter -> chatbot persona presets (reference
# enhanced_reservoir.py:58-160 and esn.cpp:192-221).
PERSONA_PRESETS: Dict[str, Dict[str, float]] = {
    "conservative": {
        "spectral_radius": 0.7, "leaking_rate": 0.3,
        "input_scaling": 0.5, "noise_scaling": 0.01, "density": 0.1,
    },
    "balanced": {
        "spectral_radius": 0.9, "leaking_rate": 0.5,
        "input_scaling": 1.0, "noise_scaling": 0.05, "density": 0.1,
    },
    "creative": {
        "spectral_radius": 1.2, "leaking_rate": 0.8,
        "input_scaling": 1.5, "noise_scaling": 0.1, "density": 0.3,
    },
}


class ESNParameterMapping:
    """How classic ESN/ReservoirPy parameters map onto the RWKV engine —
    the documentation object the advanced example walks through (parity
    surface of enhanced_reservoir.py:51-160)."""

    @staticmethod
    def get_parameter_mappings() -> Dict[str, Dict[str, Any]]:
        return {
            "spectral_radius": {
                "reservoirpy_description":
                    "largest eigenvalue of the reservoir weight matrix",
                "rwkv_equivalent":
                    "post-forward scaling of the hidden-state activations",
                "chatbot_persona_effect":
                    "stability vs creativity of responses",
                "implementation":
                    "_apply_esn_transformations scales activations",
                "value_range": (0.1, 1.5),
                "default_value": 0.9,
                "personality_mapping":
                    {"conservative": 0.7, "balanced": 0.9, "creative": 1.2},
            },
            "leaking_rate": {
                "reservoirpy_description":
                    "state decay rate (1 = none, 0 = instant)",
                "rwkv_equivalent":
                    "leaky integration against the previous activation "
                    "(analogous to RWKV's time-mixing EMA)",
                "chatbot_persona_effect":
                    "memory persistence / context retention",
                "implementation":
                    "a*x_t + (1-a)*x_{t-1} over reservoir activations",
                "value_range": (0.1, 1.0),
                "default_value": 1.0,
                "personality_mapping":
                    {"forgetful": 0.3, "balanced": 0.7, "long_memory": 0.95},
            },
            "input_scaling": {
                "reservoirpy_description": "input signal scaling factor",
                "rwkv_equivalent": "activation scaling before the readout",
                "chatbot_persona_effect": "sensitivity to user inputs",
                "implementation": "multiply activations by input_scaling",
                "value_range": (0.1, 2.0),
                "default_value": 1.0,
                "personality_mapping":
                    {"subtle": 0.5, "balanced": 1.0, "sensitive": 1.5},
            },
            "density": {
                "reservoirpy_description":
                    "connectivity density of the reservoir matrix",
                "rwkv_equivalent":
                    "random activation masking (feature sparsity)",
                "chatbot_persona_effect": "feature-interaction complexity",
                "implementation": "bernoulli mask over activation dims",
                "value_range": (0.1, 1.0),
                "default_value": 0.1,
                "personality_mapping":
                    {"focused": 0.05, "balanced": 0.1, "complex": 0.3},
            },
            "bias_scaling": {
                "reservoirpy_description": "reservoir bias magnitude",
                "rwkv_equivalent": "constant offset on activations",
                "chatbot_persona_effect": "baseline activation level",
                "implementation": "add bias_scaling to activations",
                "value_range": (0.0, 1.0),
                "default_value": 0.0,
                "personality_mapping":
                    {"neutral": 0.0, "positive": 0.3, "dynamic": 0.1},
            },
            "noise_scaling": {
                "reservoirpy_description": "gaussian state noise",
                "rwkv_equivalent": "noise injection on activations",
                "chatbot_persona_effect": "response variability",
                "implementation": "add N(0, noise_scaling) to activations",
                "value_range": (0.0, 0.1),
                "default_value": 0.0,
                "personality_mapping":
                    {"deterministic": 0.0, "varied": 0.01, "creative": 0.05},
            },
        }


class MultiLayerReadout(nn.Module):
    """MLP readout trained with Adam on the mean squared error."""

    _ACTIVATIONS = {
        "relu": F.relu,
        "tanh": torch.tanh,
        # jax.nn.gelu's default is the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }

    def __init__(
        self,
        input_size: int,
        output_size: int = 1,
        hidden_layers: Optional[List[int]] = None,
        activation: str = "relu",
        dropout: float = 0.0,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device=None,
    ):
        """The layers live on `device` (default: the CUDA card; raises
        when there is none). `dropout` is kept and unused, as in JAX."""
        super().__init__()
        self.device = resolve_device(device)
        self.input_size = input_size
        self.output_size = output_size
        self.hidden_layers = hidden_layers if hidden_layers is not None else [256, 128]
        self.activation = activation
        self.dropout = dropout
        self.learning_rate = learning_rate
        self.seed = seed
        sizes = [input_size] + list(self.hidden_layers) + [output_size]
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, fan_in, fan_out, device=self.device)
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:  # He-normal, zero biases
                w = torch.randn(layer.in_features, layer.out_features, generator=gen)
                layer.weight.copy_((w * np.sqrt(2.0 / layer.in_features)).T)
                layer.bias.zero_()
        self.is_fitted = False  # JAX's `_params is None`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self._ACTIVATIONS[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        return self.layers[-1](x)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def fit(self, x: np.ndarray, y: np.ndarray, epochs: int = 200):
        x = self._tensor(x)
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        y = self._tensor(y)
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root
        opt = torch.optim.Adam(self.parameters(), lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        for _ in range(epochs):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((self(x) - y) ** 2)
            loss.backward()
            opt.step()
        self.is_fitted = True
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if not self.is_fitted:
            raise RuntimeError("MultiLayerReadout is not trained")
        with torch.no_grad():
            out = self(self._tensor(x)).cpu().numpy()
        return out.reshape(-1) if out.shape[-1] == 1 else out


class OnlineLearner:
    """Incremental readout: SGD (the reference's rule) or true RLS."""

    def __init__(
        self,
        input_size: int,
        output_size: int = 1,
        learning_rate: float = 0.01,
        forgetting_factor: float = 0.99,
        method: str = "sgd",  # 'sgd' | 'rls'
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.input_size = input_size
        self.output_size = output_size
        self.learning_rate = learning_rate
        self.forgetting_factor = forgetting_factor
        self.method = method
        self.weights = rng.standard_normal((input_size, output_size)).astype(np.float32) * 0.01
        self.bias = np.zeros(output_size, np.float32)
        if method == "rls":
            self._p = np.eye(input_size + 1, dtype=np.float64) * 1e3

    def update(self, x: np.ndarray, y: np.ndarray):
        x = np.atleast_2d(np.asarray(x, np.float32))
        y = np.atleast_2d(np.asarray(y, np.float32))
        if self.method == "rls":
            lam = self.forgetting_factor
            for xi, yi in zip(x, y):
                phi = np.concatenate([xi, [1.0]]).astype(np.float64)
                w = np.concatenate([self.weights, self.bias[None, :]], axis=0).astype(np.float64)
                k = self._p @ phi / (lam + phi @ self._p @ phi)
                err = yi - phi @ w
                w = w + np.outer(k, err)
                self._p = (self._p - np.outer(k, phi @ self._p)) / lam
                self.weights = w[:-1].astype(np.float32)
                self.bias = w[-1].astype(np.float32)
        else:
            for xi, yi in zip(x, y):
                xi = xi[None, :]
                err = yi[None, :] - (xi @ self.weights + self.bias)
                self.weights += self.learning_rate * xi.T @ err
                self.bias += self.learning_rate * err.reshape(-1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, np.float32))
        return x @ self.weights + self.bias


class _RidgeReadout:
    def __init__(self, alpha: float = 1e-6, use_bias: bool = True):
        self.alpha = alpha
        self.use_bias = use_bias
        self.coef = None
        self.intercept = None

    def fit(self, x, y):
        y = np.asarray(y)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        self.coef, self.intercept = ridge_fit(np.asarray(x), y, self.alpha, self.use_bias)
        return self

    def predict(self, x):
        out = np.asarray(x) @ self.coef.T
        if self.intercept is not None:
            out = out + self.intercept
        return out.reshape(-1) if out.shape[-1] == 1 else out


class HierarchicalOutput:
    """Multiple readouts at different temporal downsampling scales (an MLP
    readout on `device`)."""

    def __init__(self, input_size: int, output_configs: List[Dict[str, Any]], device=None):
        self.input_size = input_size
        self.output_configs = output_configs
        self.readouts: Dict[str, Dict[str, Any]] = {}
        for i, cfg in enumerate(output_configs):
            rid = f"readout_{i}_{cfg['time_scale']}"
            kind = cfg.get("readout_type", "ridge")
            params = cfg.get("readout_params", {})
            if kind == "ridge":
                model = _RidgeReadout(**params)
            elif kind == "mlp":
                model = MultiLayerReadout(
                    input_size=input_size, output_size=cfg.get("output_size", 1),
                    device=device, **params
                )
            elif kind == "online":
                model = OnlineLearner(
                    input_size=input_size, output_size=cfg.get("output_size", 1), **params
                )
            else:
                raise ValueError(f"Unknown readout type {kind!r}")
            self.readouts[rid] = {"model": model, "config": cfg, "is_trained": False}

    def fit(self, x: np.ndarray, y_dict: Dict[str, np.ndarray]):
        for rid, info in self.readouts.items():
            if rid not in y_dict:
                continue
            scale = info["config"]["time_scale"]
            x_ds = x[::scale]
            y = y_dict[rid]
            model = info["model"]
            if isinstance(model, OnlineLearner):
                for i in range(min(len(x_ds), len(y))):
                    model.update(x_ds[i : i + 1], np.atleast_2d(y)[i : i + 1])
            else:
                n = min(len(x_ds), len(y))
                model.fit(x_ds[:n], np.asarray(y)[:n])
            info["is_trained"] = True

    def predict(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            rid: info["model"].predict(x[:: info["config"]["time_scale"]])
            for rid, info in self.readouts.items()
            if info["is_trained"]
        }


class EnhancedReservoirRWKV(ReservoirRWKV):
    """ReservoirRWKV + ESN parameter transforms, personas, and pluggable
    readouts ('ridge' | 'mlp' | 'online' | 'hierarchical')."""

    def __init__(
        self,
        model,
        units: Optional[int] = None,
        spectral_radius: float = 0.9,
        leaking_rate: float = 1.0,
        input_scaling: float = 1.0,
        density: float = 0.1,
        bias_scaling: float = 0.0,
        noise_scaling: float = 0.0,
        persona_type: str = "balanced",
        readout_type: str = "ridge",
        readout_config: Optional[Dict[str, Any]] = None,
        enable_online_learning: bool = False,
        enable_hierarchical_output: bool = False,
        hierarchical_configs: Optional[List[Dict[str, Any]]] = None,
        random_seed: Optional[int] = 42,
        **kwargs,
    ):
        super().__init__(model, units=units, **kwargs)
        self.spectral_radius = spectral_radius
        self.leaking_rate = leaking_rate
        self.input_scaling = input_scaling
        self.density = density
        self.bias_scaling = bias_scaling
        self.noise_scaling = noise_scaling
        self.persona_type = persona_type
        self._apply_persona()

        self.readout_type = readout_type
        self.readout_config = readout_config or {}
        self.enable_online_learning = enable_online_learning
        self.enable_hierarchical_output = enable_hierarchical_output
        self.custom_readout = None
        self.online_learner = None
        self.hierarchical_output = None

        if readout_type == "mlp":
            rc = self.readout_config
            self.custom_readout = MultiLayerReadout(
                input_size=self.units,
                output_size=rc.get("output_size", 1),
                hidden_layers=rc.get("hidden_layers", [256, 128]),
                activation=rc.get("activation", "relu"),
                device=self.device,
            )
        elif readout_type == "online" or enable_online_learning:
            rc = self.readout_config
            self.online_learner = OnlineLearner(
                input_size=self.units,
                output_size=rc.get("output_size", 1),
                learning_rate=rc.get("learning_rate", 0.01),
                forgetting_factor=rc.get("forgetting_factor", 0.99),
                method=rc.get("method", "sgd"),
            )
        if readout_type == "hierarchical" or enable_hierarchical_output:
            if hierarchical_configs is None:
                hierarchical_configs = [
                    {"output_size": 1, "time_scale": 1, "readout_type": "ridge",
                     "readout_params": {"alpha": 1e-6}},
                    {"output_size": 1, "time_scale": 5, "readout_type": "ridge",
                     "readout_params": {"alpha": 1e-4}},
                ]
            self.hierarchical_output = HierarchicalOutput(self.units, hierarchical_configs,
                                                          self.device)

        self.random_seed = random_seed
        self.random_state = np.random.default_rng(random_seed)
        self._prev_activations: Optional[np.ndarray] = None

    # -- persona / transforms --------------------------------------------
    def _apply_persona(self):
        preset = PERSONA_PRESETS.get(self.persona_type)
        if preset:
            for k, v in preset.items():
                setattr(self, k, v)

    def set_persona(self, persona_type: str):
        self.persona_type = persona_type
        self._apply_persona()

    def reset_state(self) -> None:
        super().reset_state()
        self._prev_activations = None

    def _apply_esn_transformations(self, acts: np.ndarray) -> np.ndarray:
        """ESN parameter mapping onto RWKV activations
        (enhanced_reservoir.py:624-666): spectral-radius scaling, leaky
        integration against the previous activation, input scaling, density
        masking, bias, and noise."""
        acts = acts * self.spectral_radius
        if self.leaking_rate < 1.0:
            prev = (
                self._prev_activations
                if self._prev_activations is not None
                and self._prev_activations.shape == acts.shape
                else np.zeros_like(acts)
            )
            acts = self.leaking_rate * acts + (1.0 - self.leaking_rate) * prev
        self._prev_activations = acts.copy()
        acts = acts * self.input_scaling
        if self.density < 1.0:
            acts = acts * (self.random_state.random(acts.shape) < self.density)
        if self.bias_scaling > 0:
            acts = acts + self.bias_scaling
        if self.noise_scaling > 0:
            acts = acts + self.random_state.normal(0.0, self.noise_scaling, acts.shape)
        return acts.astype(self.dtype)

    def _get_reservoir_activations(self, tokens, return_states: bool = False):
        base = super()._get_reservoir_activations(tokens, return_states)
        if return_states:
            acts, states = base
            return self._apply_esn_transformations(acts), states
        return self._apply_esn_transformations(base)

    # -- training ---------------------------------------------------------
    def fit(self, x, y, warmup: int = 0, hierarchical_targets=None):
        if self.readout_type == "ridge":
            return super().fit(x, y, warmup)
        if y is None and hierarchical_targets is not None:
            # hierarchical-only training: targets come per readout; collect
            # activations alone (reference enhanced_reservoir.py:776-807)
            self.reset_state()
            acts = np.concatenate([
                np.atleast_2d(self._get_reservoir_activations(list(seq)))
                for seq in x
            ])
            targets = None
        else:
            acts, targets = self._collect(x, np.asarray(y), warmup)
        if self.readout_type == "mlp":
            self.custom_readout.fit(acts, targets)
        elif self.readout_type == "online":
            for i in range(len(acts)):
                self.online_learner.update(acts[i : i + 1], targets[i : i + 1])
        elif self.readout_type == "hierarchical":
            y_dict = hierarchical_targets or {
                rid: targets for rid in self.hierarchical_output.readouts
            }
            self.hierarchical_output.fit(acts, y_dict)
        else:
            raise ValueError(f"Unknown readout type {self.readout_type!r}")
        self._is_trained = True
        return self

    def predict(self, x, reset_state: bool = True):
        if self.readout_type == "ridge":
            return super().predict(x, reset_state)
        if not self._is_trained:
            raise RuntimeError("Model must be trained before prediction. Call fit() first.")
        if reset_state:
            self.reset_state()
        acts = self._get_reservoir_activations(x)
        if self.readout_type == "mlp":
            return self.custom_readout.predict(acts)
        if self.readout_type == "online":
            out = self.online_learner.predict(acts)
            return out.reshape(-1) if out.shape[-1] == 1 else out
        return self.hierarchical_output.predict(acts)

    def update_online(self, x: np.ndarray, y: np.ndarray):
        """Online weight update from a TOKEN sequence: drive the reservoir
        and adapt on the last time step's activation (reference
        enhanced_reservoir.py:824-845)."""
        if self.online_learner is None:
            raise RuntimeError("Online learning is not enabled")
        acts = np.atleast_2d(self._get_reservoir_activations(list(np.ravel(x))))
        self.online_learner.update(acts[-1:, :], np.atleast_2d(y))

    def batch_predict(self, sequences: List, reset_state: bool = True) -> List:
        return [self.predict(seq, reset_state=reset_state) for seq in sequences]


def create_chatbot_reservoir(
    model, persona_type: str = "balanced", advanced_features: bool = True, **kwargs
) -> EnhancedReservoirRWKV:
    """Factory for a persona-configured chatbot reservoir
    (enhanced_reservoir.py:940-977)."""
    config = {
        "persona_type": persona_type,
        "readout_type": "hierarchical" if advanced_features else "ridge",
        "enable_online_learning": advanced_features,
        "enable_hierarchical_output": advanced_features,
    }
    config.update(kwargs)
    return EnhancedReservoirRWKV(model, **config)

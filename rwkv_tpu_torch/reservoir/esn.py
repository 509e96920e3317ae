"""ESN configuration and chatbot surface: the reference's ``libesn`` C API
(``esn.h``) and its Python bindings (``esn_cpp.py``): a config struct with
personality presets, reservoir driving, conversation state with turn
tracking, personality switching and online updates.

Ports ``rwkv_tpu.reservoir.esn``. ``ESNChatbot.respond`` runs the port's
``RWKVModel.eval_sequence_in_chunks`` / ``eval`` on the model's device and
``utils.sampling.sample_logits`` with the chatbot's numpy rng; the readout
math lives in ``reservoir.enhanced``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np

from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.reservoir.enhanced import EnhancedReservoirRWKV
from rwkv_tpu_torch.utils.sampling import sample_logits

# Personality presets (esn.cpp:192-221).
PERSONALITY_PRESETS = {
    "conservative": dict(spectral_radius=0.7, leaking_rate=0.3, input_scaling=0.5, noise_scaling=0.01),
    "balanced": dict(spectral_radius=0.9, leaking_rate=0.5, input_scaling=1.0, noise_scaling=0.05),
    "creative": dict(spectral_radius=1.2, leaking_rate=0.8, input_scaling=1.5, noise_scaling=0.1),
}


@dataclass
class ESNConfig:
    """Mirror of `struct esn_config` (esn.h:56-69)."""

    units: int = 0  # 0 = use model n_embed
    spectral_radius: float = 0.9
    leaking_rate: float = 0.5
    input_scaling: float = 1.0
    noise_scaling: float = 0.05
    ridge_alpha: float = 1e-6
    warmup_steps: int = 0
    personality: str = "balanced"
    readout_type: str = "ridge"  # ridge | linear | mlp | online
    online_learning: bool = False
    mlp_hidden_size: int = 128
    learning_rate: float = 0.01


def esn_create_config(personality: str = "balanced", units: int = 0) -> ESNConfig:
    """esn_create_config equivalent (esn.cpp:180-226)."""
    cfg = ESNConfig(units=units, personality=personality)
    preset = PERSONALITY_PRESETS.get(personality)
    if preset:
        cfg = replace(cfg, **preset)
    return cfg


@dataclass
class ConversationState:
    """Mirror of `struct esn_conversation_state` (esn.h:88-95)."""

    turn_count: int = 0
    personality: str = "balanced"
    history_tokens: List[int] = field(default_factory=list)


class ESNChatbot:
    """ESN-flavored chatbot: RWKV generates text; the ESN layer modulates
    sampling by personality and exposes reservoir train/predict (the
    esn_chatbot_* / esn_train / esn_predict surface of esn.h:103-157)."""

    def __init__(self, model, config: Optional[ESNConfig] = None, seed: Optional[int] = None,
                 device=None):
        """`model` is an ``RWKVModel`` or a ggmf path, loaded onto `device`
        (default: the CUDA card)."""
        self.model = model if isinstance(model, RWKVModel) else RWKVModel(model, device)
        self.config = config or esn_create_config()
        units = self.config.units or self.model.n_embed
        readout = "ridge" if self.config.readout_type == "linear" else self.config.readout_type
        self.reservoir = EnhancedReservoirRWKV(
            self.model,
            units=units,
            spectral_radius=self.config.spectral_radius,
            leaking_rate=self.config.leaking_rate,
            input_scaling=self.config.input_scaling,
            noise_scaling=self.config.noise_scaling,
            persona_type=self.config.personality,
            readout_type=readout,
            readout_config={
                "hidden_layers": [self.config.mlp_hidden_size],
                "learning_rate": self.config.learning_rate,
            },
            enable_online_learning=self.config.online_learning,
            alpha=self.config.ridge_alpha,
        )
        self.conversation = ConversationState(personality=self.config.personality)
        self._chat_state = None
        self._chat_logits = None
        self._rng = np.random.default_rng(seed)

    # -- reservoir API (esn_train / esn_predict / esn_run_reservoir) ------
    def train(self, sequences, targets, warmup: Optional[int] = None):
        self.reservoir.fit(
            sequences, np.asarray(targets),
            warmup=self.config.warmup_steps if warmup is None else warmup,
        )
        return self

    def predict(self, tokens):
        return self.reservoir.predict(tokens)

    def run_reservoir(self, tokens):
        return self.reservoir.run(tokens)

    def online_update(self, tokens, target):
        acts = self.reservoir.run(list(tokens), reset_state=True)
        self.reservoir.update_online(acts[-1:], np.atleast_2d(target))

    # -- personality (esn_switch_personality / esn_get_personality) -------
    def switch_personality(self, personality: str) -> None:
        preset = PERSONALITY_PRESETS.get(personality)
        if preset is None:
            raise ValueError(f"Unknown personality {personality!r}")
        self.config = replace(self.config, personality=personality, **preset)
        self.reservoir.set_persona(personality)
        self.conversation.personality = personality

    def get_personality(self) -> str:
        return self.conversation.personality

    # -- chatbot (esn_chatbot_respond / esn_reset_conversation) ----------
    def _sampling_params(self):
        # Personality maps to sampling dynamics: creative = hotter.
        sr = self.config.spectral_radius
        return {
            "temperature": max(0.2, min(1.5, sr)),
            "top_p": 0.5 + 0.3 * (sr - 0.7),
        }

    def respond(self, text: str, encode, decode, max_tokens: int = 100) -> str:
        tokens = encode(text)
        self.conversation.history_tokens += tokens
        self._chat_logits, self._chat_state = self.model.eval_sequence_in_chunks(
            tokens, state=self._chat_state
        )
        params = self._sampling_params()
        out_tokens: List[int] = []
        for _ in range(max_tokens):
            tok = sample_logits(self._chat_logits, rng=self._rng, **params)
            out_tokens.append(tok)
            self._chat_logits, self._chat_state = self.model.eval(tok, self._chat_state)
            piece = decode(out_tokens)
            if piece.endswith("\n\n"):
                break
        self.conversation.history_tokens += out_tokens
        self.conversation.turn_count += 1
        return decode(out_tokens)

    def reset_conversation(self) -> None:
        self.conversation = ConversationState(personality=self.config.personality)
        self._chat_state = None
        self._chat_logits = None
        self.reservoir.reset_state()


def create_chatbot_esn(model, personality: str = "balanced", **kwargs) -> ESNChatbot:
    """Factory mirroring esn_cpp.create_chatbot_esn (esn_cpp.py:408)."""
    return ESNChatbot(model, esn_create_config(personality), **kwargs)

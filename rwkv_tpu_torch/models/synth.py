"""Synthetic model generation: random RWKV parameter trees for any
architecture version, for benchmarks and tests.

Draws from numpy's ``default_rng`` in exactly the order of
``rwkv_tpu.models.synth.synth_params``, so the same seed gives bit-identical
weights in both packages. Leaves are CPU float32 tensors: linear weights
dense ``[out, in]``, norms and coefficients as vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from rwkv_tpu_torch.models.config import ModelConfig


def synth_params(cfg: ModelConfig, seed: int = 0, lora_dim: int = 64) -> dict:
    """Random parameter tree matching `cfg` (see module docstring)."""
    rng = np.random.default_rng(seed)
    c, vocab = cfg.n_embed, cfg.n_vocab
    h, s = cfg.head_count, cfg.head_size
    ffn_mult = 4

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def w(shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[-1]))
        return t(rng.standard_normal(shape, dtype=np.float32) * scale)

    def vec_np(*shape, scale=0.1, offset=0.0):
        return rng.standard_normal(shape, dtype=np.float32) * scale + offset

    def vec(*shape, scale=0.1, offset=0.0):
        return t(vec_np(*shape, scale=scale, offset=offset))

    params = {
        "emb": t(rng.standard_normal((vocab, c), dtype=np.float32) * 0.02),
        "ln0": (vec(c, offset=1.0, scale=0.02), vec(c, scale=0.02)),
        "ln_out": (vec(c, offset=1.0, scale=0.02), vec(c, scale=0.02)),
        "head": w((vocab, c)),
        "blocks": [],
    }

    for i in range(cfg.n_layer):
        lyr = {
            "ln1.weight": vec(c, offset=1.0, scale=0.02),
            "ln1.bias": vec(c, scale=0.02),
            "ln2.weight": vec(c, offset=1.0, scale=0.02),
            "ln2.bias": vec(c, scale=0.02),
            "att.key.weight": w((c, c)),
            "att.value.weight": w((c, c)),
            "att.receptance.weight": w((c, c)),
            "att.output.weight": w((c, c)),
            "ffn.key.weight": w((ffn_mult * c, c)),
            "ffn.value.weight": w((c, ffn_mult * c)),
        }
        major, minor = cfg.version_major, cfg.version_minor
        if major <= 6:
            lyr["ffn.receptance.weight"] = w((c, c))
        if major == 4:
            lyr.update({
                "att.time_mix_k": vec(c, scale=0.2, offset=0.5),
                "att.time_mix_v": vec(c, scale=0.2, offset=0.5),
                "att.time_mix_r": vec(c, scale=0.2, offset=0.5),
                "att.time_first": vec(c, scale=0.3),
                "att.time_decay": t(-np.abs(vec_np(c, scale=1.0)) - 0.1),
                "ffn.time_mix_k": vec(c, scale=0.2, offset=0.5),
                "ffn.time_mix_r": vec(c, scale=0.2, offset=0.5),
            })
        elif major == 5:
            lyr.update({
                "att.time_mix_k": vec(c, scale=0.2, offset=0.5),
                "att.time_mix_v": vec(c, scale=0.2, offset=0.5),
                "att.time_mix_r": vec(c, scale=0.2, offset=0.5),
                "att.ln_x.weight": vec(c, offset=1.0, scale=0.02),
                "att.ln_x.bias": vec(c, scale=0.02),
                "ffn.time_mix_k": vec(c, scale=0.2, offset=0.5),
                "ffn.time_mix_r": vec(c, scale=0.2, offset=0.5),
            })
            if minor >= 2:
                lyr.update({
                    "att.time_faaaa": vec(h, s, scale=0.3),
                    "att.time_decay": t(
                        np.exp(-np.exp(rng.standard_normal((h, s)).astype(np.float32)))
                    ),
                    "att.time_mix_g": vec(c, scale=0.2, offset=0.5),
                    "att.gate.weight": w((c, c)),
                })
            else:
                lyr.update({
                    "att.time_first": t(
                        np.exp(rng.standard_normal(h).astype(np.float32) * 0.3)
                    ),
                    "att.time_decay": t(
                        np.exp(-np.exp(rng.standard_normal(h).astype(np.float32)))
                    ),
                })
        elif major == 6:
            maa_dim = 32
            dec_dim = lora_dim
            lyr.update({
                "att.time_maa_x": vec(c, scale=0.2, offset=0.5),
                "att.time_maa_w": vec(c, scale=0.2, offset=0.5),
                "att.time_maa_k": vec(c, scale=0.2, offset=0.5),
                "att.time_maa_v": vec(c, scale=0.2, offset=0.5),
                "att.time_maa_r": vec(c, scale=0.2, offset=0.5),
                "att.time_maa_g": vec(c, scale=0.2, offset=0.5),
                "att.time_maa_w1": w((5 * maa_dim, c)),
                "att.time_maa_w2": vec(5, c, maa_dim, scale=1.0 / np.sqrt(maa_dim)),
                "att.time_decay": vec(h, s, scale=0.5),
                "att.time_decay_w1": w((dec_dim, c)),
                "att.time_decay_w2": w((c, dec_dim)),
                "att.time_faaaa": vec(h, s, scale=0.3),
                "att.gate.weight": w((c, c)),
                "att.ln_x.weight": vec(c, offset=1.0, scale=0.02),
                "att.ln_x.bias": vec(c, scale=0.02),
                "ffn.time_maa_k": vec(c, scale=0.2, offset=0.5),
                "ffn.time_maa_r": vec(c, scale=0.2, offset=0.5),
            })
        else:  # v7
            d = lora_dim
            lyr.update({
                "att.x_rwkvag": vec(6, c, scale=0.2, offset=0.5),
                "att.w0": vec(c, scale=0.3),
                "att.w1": w((d, c)),
                "att.w2": w((c, d)),
                "att.a0": vec(c, scale=0.3),
                "att.a1": w((d, c)),
                "att.a2": w((c, d)),
                "att.g1": w((d, c)),
                "att.g2": w((c, d)),
                "att.k_k": vec(c, scale=0.3, offset=0.5),
                "att.k_a": vec(c, scale=0.3, offset=0.5),
                "att.r_k": vec(h, s, scale=0.3),
                "att.ln_x.weight": vec(c, offset=1.0, scale=0.02),
                "att.ln_x.bias": vec(c, scale=0.02),
                "ffn.x_k": vec(c, scale=0.2, offset=0.5),
            })
            if i != 0:
                lyr.update({
                    "att.v0": vec(c, scale=0.3),
                    "att.v1": w((d, c)),
                    "att.v2": w((c, d)),
                })
        params["blocks"].append(lyr)
    return params


def synth_config(
    version: str = "7.0",
    n_layer: int = 12,
    n_embed: int = 768,
    n_vocab: int = 65536,
    head_size: int = 64,
) -> ModelConfig:
    major, minor = (int(x) for x in version.split("."))
    if major >= 5:
        head_count = n_embed // head_size
    else:
        head_count = head_size = 0
    return ModelConfig(
        n_vocab=n_vocab,
        n_embed=n_embed,
        n_layer=n_layer,
        version_major=major,
        version_minor=minor,
        head_count=head_count,
        head_size=head_size,
    )

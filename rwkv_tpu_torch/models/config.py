"""Model configuration: architecture version + dimensions.

A copy of ``rwkv_tpu.models.config`` (the port keeps its own copies of the
JAX package's modules). The ggmf format carries no architecture field, so
the version is inferred from which parameter names are present, and head
count/size come from parameter shapes.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    n_vocab: int
    n_embed: int
    n_layer: int
    version_major: int  # 4, 5, 6, 7
    version_minor: int  # 5.1 vs 5.2; 0 otherwise
    head_count: int = 0  # 0 for v4
    head_size: int = 0

    @property
    def version(self) -> str:
        return f"{self.version_major}.{self.version_minor}"

    @property
    def vectors_per_layer(self) -> int:
        """Per-layer state rows of length n_embed in the flat state buffer."""
        return 5 if self.version_major == 4 else 2 + self.head_size

    @property
    def state_len(self) -> int:
        """Total float count of the flat recurrent state."""
        return self.n_embed * self.vectors_per_layer * self.n_layer


def detect_version(param_names) -> tuple[int, int]:
    """Arch-version detection by parameter-name probing."""
    names = set(param_names)
    major, minor = 4, 0
    if "blocks.0.att.ln_x.weight" in names:
        major = 5
        minor = 2 if "blocks.0.att.gate.weight" in names else 1
    if "blocks.0.att.time_maa_x" in names:
        major, minor = 6, 0
    if "blocks.0.att.r_k" in names:
        major, minor = 7, 0
    return major, minor

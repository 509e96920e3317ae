"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    There is no silent CPU fallback: with no card and no explicit device
    this raises, so a run that was meant for the GPU never measures the
    CPU by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

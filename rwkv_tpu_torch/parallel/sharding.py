"""The device mesh of tensor-parallel decode.

Ports ``rwkv_tpu.parallel.sharding.make_mesh``: a ``(data, model)`` mesh
whose ``model`` axis carries the shards of ``ops.megakernel_tp``'s decode
step. JAX's ``Mesh`` is a grid of devices that GSPMD and ``shard_map``
read; here it is the list of the model axis' ``torch.device``\\ s, shard i
on ``devices[i]``. A *virtual* mesh, several shards on one card (or
``"cpu"``), is asked for with ``devices=[...]``, the counterpart of the
JAX tests' forced host device count: every shard's kernel then runs for
real on its own shard of the weights, and the collectives are sums on
that device.

The data axis is not ported: JAX shards only B>1 per-op batches over it
(``shard_serving_params`` / ``shard_serving_state``, the GSPMD per-op
route, ROADMAP queue A item 13).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """``shape`` ``{"data": dp, "model": tp}``; ``devices`` the model axis,
    shard i on ``devices[i]``."""

    shape: dict
    devices: tuple

    @property
    def tp(self) -> int:
        return self.shape["model"]


def make_mesh(dp: int, tp: int, devices=None) -> Mesh:
    """A ``(data=dp, model=tp)`` mesh. By default its shards are the first
    tp distinct visible CUDA cards, and it raises when there are fewer;
    ``devices`` (tp entries, repeats allowed: ``["cuda:0"] * 2`` or
    ``["cpu"] * 2``) names them. dp > 1 raises: the data axis (the sharded
    per-op route for B>1) is not ported."""
    if dp != 1:
        raise NotImplementedError(
            "make_mesh: a data axis (dp > 1) shards B>1 per-op batches, the GSPMD per-op "
            "route that is not ported yet (ROADMAP queue A item 13)")
    if tp < 1:
        raise ValueError(f"make_mesh: tp must be at least 1, got {tp}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < dp * tp:
            raise RuntimeError(
                f"make_mesh: need {dp * tp} CUDA devices, have {n}; pass devices=[...] "
                "for a virtual mesh (several shards on one device)")
        devices = [f"cuda:{i}" for i in range(tp)]
    devs = tuple(same_device(d) for d in devices)
    if len(devs) < dp * tp:
        raise ValueError(f"make_mesh: need {dp * tp} devices, got {len(devs)}")
    return Mesh(shape={"data": dp, "model": tp}, devices=devs[: dp * tp])


def same_device(device) -> torch.device:
    """`device` as a torch.device with a CUDA card's index spelled out
    (``"cuda"`` is card 0), so that two names of one card compare equal."""
    dev = torch.device(device)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev

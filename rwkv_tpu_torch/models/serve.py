"""Serving path for RWKV v4, v5.1, v5.2, v6 and v7 on one GPU.

Ports the serving side of ``rwkv_tpu.models.serve``:

- ``stack_layer_params`` prepares every layer's weights for a precision and
  stacks them ``[L, ...]``: dense f32 or bf16; ``keep-quant`` (a loaded
  file's blocks stay packed, kernel K9; its dense tensors go to bf16);
  ``q8`` (every 2-D weight to per-32-block int8, K9) or ``q8r`` (one scale
  per row, K9's bf16 form); w8a8 (rowwise int8 weights, per-row int8
  activations, kernel K1). Under every packed mode a file-quantized leaf
  keeps its blocks (``PackedQuantWeight.from_weight``) and only dense
  leaves are requantized, as in the JAX package. Projections stay unfused
  under every packed mode, as they do there; dense v7 stacks (f32, bf16)
  are fused (``fuse=True``): r / k / v into ``att.rkv.weight`` and the
  LoRAs into ``att.lora1`` / ``att.lora2``, run by
  ``_v7_fused_projections`` as three batched products. w4a8 runs these
  per-op paths as w8a8, as JAX does; only the decode kernels see int4.
- ``run_blocks`` / ``forward_stacked`` run the layers as a Python loop over
  ``models.graph.att_v7`` / ``ffn_v7`` (v7; the fused products on a
  fused stack), ``att_v6`` / ``ffn_v6`` (v6), ``att_v5`` / ``ffn_v4_v5``
  (v5) or, in ``forward_stacked``'s own loop with the ``aa`` / ``bb`` /
  ``pp`` state, ``att_v4`` / ``ffn_v4_v5`` (v4). The wkv recurrence goes
  through ``ops.chunked.wkv7_auto`` (kernel K2 on the card),
  ``wkv6_auto`` (kernel K5, v6 and v5 with its static decay) or
  ``wkv4_auto`` (a log-depth scan in plain PyTorch for T > 1), at T=1 too.
  ``forward_stacked_trace`` is the scoring pass that also returns the
  state after every position (the speculative commit, every version).
- ``ServingModel`` serves a ggmf file (``models.loader.load_params``) or a
  ``(cfg, params)`` tree: ``prefill`` splits a prompt into
  ``PREFILL_BUCKETS``, ``decode`` runs one step for a batch, ``generate``
  samples, ``score`` / ``score_trace`` give every position's logits (and
  states). With ``megakernel=True`` decode goes through the whole-model
  kernels (w8a8 and w4a8; ``quant``, ``q8`` and ``q8r`` hand them the w8
  pack of the dequantized weights, and ``bf16`` and ``f32`` the bf16 pack
  of the f32 dense weights, as the JAX package does; ``mega_pack_cache``
  keeps the host pack in a file). v7: B=1 through K3
  (one launch with the LM head) when K3 takes the model's shapes, else K4
  and the head; ``mega_min_batch`` <= B <= ``MEGA_MAX_BATCH`` through K4,
  then ``ln_out`` and the per-op head (K1 at M=B under w8a8; the model's
  own bf16 or f32 head under ``bf16`` / ``f32``; the JAX package's batched
  and tiled kernels followed by ``G.mm``). v6, v5 and v4: B=1 through K6,
  K7 or K8 (one launch with the LM head, every form); every B > 1 per-op,
  as in the JAX package, whose v4-v6 kernels are B=1 only. With a
  ``mesh`` (``parallel.sharding.make_mesh``) and ``megakernel=True``, every
  version decodes B=1 tensor-parallel over its shards
  (``ops.megakernel_tp``: K10 / K11 for v7, K12 / K13 for v6, K15 or K14
  and K13's v4/v5 form for v5 and v4; JAX's ``_megatp_fn``), then
  ``ln_out`` and the per-op head; prefill, B>1 and the head are not sharded yet and run per-op
  on the mesh's first device.

State uses the serving layout: ``att_xx`` / ``ffn_xx`` ``[B, L, C]`` and
``heads`` ``[B, L, H, S_i, S_j]`` (v5-v7) or ``aa`` / ``bb`` / ``pp``
``[B, L, C]`` (v4).

One fault of the JAX package is not copied: its ``stack_layer_params``
pads layer 0's v0 / v1 / v2 only when there is a second layer to copy them
from, so a one-layer v7 model raises ``KeyError`` there. Here layer 0 never
reads them, and a one-layer model serves.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from rwkv_tpu_torch.device import resolve_device
from rwkv_tpu_torch.models import graph as G
from rwkv_tpu_torch.models.config import ModelConfig
from rwkv_tpu_torch.models.loader import LAYER_WEIGHT_KEYS, load_params
from rwkv_tpu_torch.models.state import init_state
from rwkv_tpu_torch.ops.kernels import PackedQuantWeight, quantize_q8_serving
from rwkv_tpu_torch.ops.parity import Weight, bmm, layer_norm

# Prefill chunk buckets, largest first; any length is decomposed greedily.
PREFILL_BUCKETS = (256, 64, 16, 4, 1)

# precision -> weight preparation mode (the JAX package's table)
_PRECISIONS = {"f32": "dense", "bf16": "dense", "quant": "keep-quant", "q8": "q8",
               "q8r": "q8r", "w8a8": "w8a8", "w4a8": "w8a8"}

# Largest batch the whole-model decode kernel K4 serves (the JAX package's
# bound for its batched kernels); larger batches take the per-op path.
MEGA_MAX_BATCH = 256


def _densify(w, dtype) -> torch.Tensor:
    """A weight leaf (``Weight`` or dense tensor) -> dense ``[out, in]`` in
    `dtype`, through float32."""
    return (w.dense() if isinstance(w, Weight) else w.float()).to(dtype)


def _prepare_weight(w, dtype, mode: str):
    """Weight leaf (``Weight`` or dense ``[out, in]`` tensor) -> serving form.

    'dense': dense in `dtype`. 'keep-quant': a file-quantized leaf keeps
    its blocks (K9), a dense one goes to `dtype`. 'q8' / 'q8r' / 'w8a8': a
    file-quantized leaf keeps its blocks; a dense one with in % 32 == 0 is
    quantized to per-32-block int8 ('q8'), rowwise int8 ('q8r') or rowwise
    int8 with int8 activations ('w8a8', K1), else stays dense in `dtype`."""
    if isinstance(w, Weight) and w.kind == "quant" and mode != "dense":
        return PackedQuantWeight.from_weight(w)
    if mode in ("q8", "q8r", "w8a8") and w.shape[-1] % 32 == 0:
        return quantize_q8_serving(_densify(w, torch.float32), rowwise=mode != "q8",
                                   int8_act=mode == "w8a8")
    return _densify(w, dtype)


_VERSIONS = (4, 5, 6, 7)


def _stack(leaves):
    if isinstance(leaves[0], PackedQuantWeight):
        return PackedQuantWeight.stack(leaves)
    return torch.stack(leaves)


def _zeros_like(x):
    if isinstance(x, Weight):
        return dataclasses.replace(x, **{f: torch.zeros_like(getattr(x, f))
                                         for f in ("w", "q", "d", "m") if getattr(x, f) is not None})
    return torch.zeros_like(x)


def _to(x, device):
    return x.to(device) if isinstance(x, (torch.Tensor, PackedQuantWeight)) else x


_V7_FUSED_RKV = ("att.receptance.weight", "att.key.weight", "att.value.weight")
_V7_FUSED_LORA1 = ("att.w1", "att.a1", "att.g1", "att.v1")
_V7_FUSED_LORA2 = ("att.w2", "att.a2", "att.g2", "att.v2")


def _fuse_v7(stacked: dict) -> None:
    """JAX's fuse block: r / k / v into ``att.rkv.weight`` ``[L, 3, C, C]``
    and the LoRAs into ``att.lora1`` ``[L, n, d, C]`` (w1, a1, g1, v1) and
    ``att.lora2`` ``[L, n, C, d]`` (w2, a2, g2, v2), where every one of them
    is a dense tensor and the LoRAs share one width. n is 4, or 3 in a
    one-layer model, which has no value-residual LoRA."""
    lora1 = [k for k in _V7_FUSED_LORA1 if k in stacked]
    lora2 = [k for k in _V7_FUSED_LORA2 if k in stacked]
    keys = _V7_FUSED_RKV + tuple(lora1) + tuple(lora2)
    if not all(isinstance(stacked.get(k), torch.Tensor) for k in keys):
        return
    if len({stacked[k].shape for k in lora1}) != 1 or len({stacked[k].shape for k in lora2}) != 1:
        return
    for name, group in (("att.rkv.weight", _V7_FUSED_RKV), ("att.lora1", lora1),
                        ("att.lora2", lora2)):
        stacked[name] = torch.stack([stacked.pop(k) for k in group], dim=1)


def stack_layer_params(
    params: dict, cfg: ModelConfig, dtype=torch.bfloat16, mode: str = "dense", device=None,
    fuse: bool = True,
) -> dict:
    """Prepare and stack per-layer params into ``[L, ...]`` leaves on
    `device` (default: the card). Layer 0's missing v0/v1/v2 are
    zero-padded where a later layer gives their shapes; layer 0 never reads
    them (its value residual is selected away). `fuse`: dense v7 stacks
    get JAX's fused projections (``_fuse_v7``), which ``run_blocks`` runs
    through ``_v7_fused_projections``."""
    dev = resolve_device(device)
    if cfg.version_major not in _VERSIONS:
        raise NotImplementedError(f"the port does not serve RWKV v{cfg.version}")
    blocks = [dict(b) for b in params["blocks"]]
    if cfg.version_major == 7 and len(blocks) > 1:
        for key in ("att.v0", "att.v1", "att.v2"):
            if key not in blocks[0]:
                blocks[0][key] = _zeros_like(blocks[1][key])
    stacked = {}
    for k in sorted(blocks[0].keys()):
        # the leaves the JAX package's synth and loader build as ``Weight``;
        # v6's time_maa_w2 and the v4/v5 decay and bonus vectors stay f32
        if k in LAYER_WEIGHT_KEYS:
            leaves = [_prepare_weight(b[k], dtype, mode) for b in blocks]
        else:
            leaves = [b[k].float() for b in blocks]
        stacked[k] = _to(_stack(leaves), dev)
    if fuse and cfg.version_major == 7:
        _fuse_v7(stacked)
    head = params["head"]
    return {
        "emb": params["emb"].to(dtype).to(dev),
        "ln0": tuple(x.float().to(dev) for x in params["ln0"]),
        "ln_out": tuple(x.float().to(dev) for x in params["ln_out"]),
        "head": _to(_prepare_weight(head, dtype, mode), dev),
        "blocks": stacked,
    }


def _layer(blocks: dict, i: int) -> dict:
    out = {}
    for k, v in blocks.items():
        out[k] = v.map(lambda t: t[i]) if isinstance(v, PackedQuantWeight) else v[i]
    return out


def _v7_fused_projections(layer: dict, xxx: torch.Tensor, v_lora: bool) -> tuple:
    """``graph.v7_projections`` on a fused stack (``_fuse_v7``): r / k / v,
    the LoRA downs and the LoRA ups each as one batched product
    (``ops.parity.bmm``: f32 out, as JAX's ``preferred_element_type=f32``)."""
    lead, c = xxx.shape[1:-1], xxx.shape[-1]
    xr, xw, xk, xv, xa, xg = (xxx[i] for i in range(6))
    rkv = bmm(torch.stack([xr, xk, xv]).reshape(3, -1, c), layer["att.rkv.weight"])
    r, k, v = (rkv[i].reshape(*lead, c) for i in range(3))
    l1 = layer["att.lora1"]  # [n, d, C] (w1, a1, g1(, v1))
    n = 4 if v_lora else 3
    down = bmm(torch.stack([xw, xa, xg, xv][:n]).reshape(n, -1, c), l1[:n])
    act = torch.stack([torch.tanh(down[0]), down[1], torch.sigmoid(down[2]), *down[3:]])
    up = bmm(act, layer["att.lora2"][:n])  # [n, M, C] (w2, a2, g2(, v2))
    w_l, a_l, g = (up[i].reshape(*lead, c) for i in range(3))
    return r, k, v, g, w_l, a_l, up[3].reshape(*lead, c) if v_lora else None


def _att_v7(layer: dict):
    """``graph.att_v7`` with the layer's own products: fused or not."""
    if "att.rkv.weight" in layer:
        return functools.partial(G.att_v7, projections=_v7_fused_projections)
    return G.att_v7


def run_blocks(
    blocks: dict,
    state: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    v_first=None,
    layer_offset: int = 0,
    wkv_fn=None,
):
    """Run stacked ``[Lb, ...]`` blocks over `x` (post-ln0 activations,
    ``[T, ...C]``) as a loop over layers. `layer_offset` is the global index
    of the first layer (v7's value residual selects v at global layer 0).
    Returns (x, v_first, new_state); v5 and v6 pass v_first through. v5+
    only (v4's scalar-state layers run in ``forward_stacked``)."""
    n_local = state["att_xx"].shape[0]
    if v_first is None:
        v_first = torch.zeros_like(x)
    att, ffn, heads = [], [], []
    for i in range(n_local):
        layer = _layer(blocks, i)
        if cfg.version_major == 7:
            dx, att_xx, h, v_first = _att_v7(layer)(
                layer, x, state["att_xx"][i], state["heads"][i], v_first, cfg,
                is_first=(layer_offset + i == 0), wkv_fn=wkv_fn,
            )
            x = x + dx
            dx, ffn_xx = G.ffn_v7(layer, x, state["ffn_xx"][i])
        elif cfg.version_major == 6:
            dx, att_xx, h = G.att_v6(layer, x, state["att_xx"][i], state["heads"][i], cfg,
                                     wkv_fn=wkv_fn)
            x = x + dx
            dx, ffn_xx = G.ffn_v6(layer, x, state["ffn_xx"][i])
        else:
            dx, att_xx, h = G.att_v5(layer, x, state["att_xx"][i], state["heads"][i], cfg,
                                     wkv_fn=wkv_fn)
            x = x + dx
            dx, ffn_xx = G.ffn_v4_v5(layer, x, state["ffn_xx"][i])
        x = x + dx
        att.append(att_xx)
        ffn.append(ffn_xx)
        heads.append(h)
    return x, v_first, {
        "att_xx": torch.stack(att), "ffn_xx": torch.stack(ffn), "heads": torch.stack(heads)
    }


def _forward_v4(blocks: dict, state: dict, x: torch.Tensor):
    """The v4 layers over `x` with the ``aa`` / ``bb`` / ``pp`` state, the
    wkv through ``ops.chunked.wkv4_auto``. Returns (x, new state)."""
    from rwkv_tpu_torch.ops.chunked import wkv4_auto

    keys = ("att_xx", "ffn_xx", "aa", "bb", "pp")
    out = {k: [] for k in keys}
    for i in range(state["att_xx"].shape[0]):
        layer = _layer(blocks, i)
        dx, att_xx, aa, bb, pp = G.att_v4(layer, x, state["att_xx"][i], state["aa"][i],
                                          state["bb"][i], state["pp"][i], wkv_fn=wkv4_auto)
        x = x + dx
        dx, ffn_xx = G.ffn_v4_v5(layer, x, state["ffn_xx"][i])
        x = x + dx
        for k, v in zip(keys, (att_xx, ffn_xx, aa, bb, pp)):
            out[k].append(v)
    return x, {k: torch.stack(v) for k, v in out.items()}


def _wkv_auto(cfg: ModelConfig):
    """The serving path's wkv dispatch, at every T (``ops.chunked``). On the
    card v7 and v5 / v6 run one kernel at T=1 and T>1 (K2, K5), whose
    token recurrence gives a token the same bits at any T below its
    crossover: a pass over a few positions then agrees with the one-token
    decode chain bit for bit (v4's log-depth scan at T>1 does not). On the
    CPU: the JAX package's dispatch (the scan at T=1)."""
    from rwkv_tpu_torch.ops import chunked

    return {7: chunked.wkv7_auto, 6: chunked.wkv6_auto, 5: chunked.wkv6_auto,
            4: chunked.wkv4_auto}[cfg.version_major]


def forward_stacked(
    params: dict,
    state: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    compute_logits=True,
):
    """Forward over stacked params; same math as ``graph.forward``.

    tokens: [T] (state arrays [L, ...]) or [T, B] (time-major batch, state
    arrays [L, B, ...]). compute_logits: True (last position), "all"
    (every position) or False."""
    emb = params["emb"][tokens]
    x = layer_norm(emb.float(), *params["ln0"])
    if cfg.version_major == 4:
        x, new_state = _forward_v4(params["blocks"], state, x)
    else:
        x, _, new_state = run_blocks(params["blocks"], state, x, cfg, wkv_fn=_wkv_auto(cfg))
    logits = None
    if compute_logits == "all":
        logits = G.mm(layer_norm(x, *params["ln_out"]), params["head"])
    elif compute_logits:
        xo = layer_norm(x[-1], *params["ln_out"])
        if xo.ndim == 1:
            logits = G.mm(xo[None, :], params["head"])[0]
        else:
            logits = G.mm(xo, params["head"])
    return logits, new_state


def forward_stacked_trace(params: dict, state: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """Single-sequence scoring pass that returns every position's logits
    and the recurrent state after every position (JAX's
    ``forward_stacked_trace``, all five architectures). tokens [T]; state
    arrays [L, ...]. Returns (logits [T, V], trace) with trace arrays
    ``[L, T, ...]`` (``att_xx``, ``ffn_xx`` and ``heads``, or ``aa`` /
    ``bb`` / ``pp`` for v4): position j holds the state after
    tokens[:j+1], the speculative commit without a replay pass. The
    recurrences run token by token through the serving path's dispatch
    (``_wkv_auto``), so each position's state has the bits a one-token
    decode step gives it."""
    major = cfg.version_major
    x = layer_norm(params["emb"][tokens].float(), *params["ln0"])
    blocks = params["blocks"]
    keys = ("att_xx", "ffn_xx") + (("aa", "bb", "pp") if major == 4 else ("heads",))
    trace = {k: [] for k in keys}
    v_first = torch.zeros_like(x)
    wkv_fn = _wkv_auto(cfg)
    for i in range(state["att_xx"].shape[0]):
        layer = _layer(blocks, i)
        if major == 4:
            dx, *_, (xl, *rec) = G.att_v4(layer, x, state["att_xx"][i], state["aa"][i],
                                         state["bb"][i], state["pp"][i], trace=True,
                                         wkv_fn=wkv_fn)
        elif major in (5, 6):
            att = G.att_v5 if major == 5 else G.att_v6
            dx, _, _, (xl, *rec) = att(layer, x, state["att_xx"][i], state["heads"][i], cfg,
                                       wkv_fn=wkv_fn, trace=True)
        else:
            dx, _, _, v_first, (xl, *rec) = _att_v7(layer)(
                layer, x, state["att_xx"][i], state["heads"][i], v_first, cfg, is_first=i == 0,
                wkv_fn=wkv_fn, trace=True)
        x = x + dx
        # ffn_xx after position t is ln2(x)[t], the ffn's own token shift
        xl2 = layer_norm(x, layer["ln2.weight"], layer["ln2.bias"])
        ffn = G.ffn_v7 if major == 7 else G.ffn_v6 if major == 6 else G.ffn_v4_v5
        dx, _ = ffn(layer, x, state["ffn_xx"][i])
        x = x + dx
        for k, v in zip(keys, (xl, xl2, *rec)):
            trace[k].append(v)
    logits = G.mm(layer_norm(x, *params["ln_out"]), params["head"])
    return logits, {k: torch.stack(v) for k, v in trace.items()}


def _host_pack(params: dict, cfg: ModelConfig, w4: bool, quant: bool, cache=None) -> dict:
    """The decode kernels' host pack (before ``device_pack``): read from the
    file `cache` where it exists, else built (``build_mega_pack*`` of the
    model's version) and, with `cache` given, written there (the JAX
    package's ``mega_pack_cache``). A cached pack that does not fit the
    model or the precision raises ValueError."""
    from rwkv_tpu_torch.ops import megakernel as M

    if cache is not None and os.path.exists(cache):
        pack = M.load_mega_pack(cache)
        err = M.mega_pack_mismatch(pack, cfg, M._form(quant, w4))
        if err:
            raise ValueError(f"mega_pack_cache {os.fspath(cache)}: {err}")
        return pack
    build = {7: M.build_mega_pack, 6: M.build_mega_pack_v6, 5: M.build_mega_pack_v5,
             4: M.build_mega_pack_v4}[cfg.version_major]
    pack = build(params, cfg, w4=w4, quant=quant)
    if cache is not None:
        M.save_mega_pack(cache, pack)
    return pack


def _tp_shape_check(params: dict, cfg: ModelConfig, mesh, w4: bool) -> None:
    """Raise unless ``ops.megakernel_tp`` splits the model over `mesh`."""
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    major, tp = cfg.version_major, mesh.tp
    b0 = params["blocks"][0]
    f_dim = b0["ffn.key.weight"].shape[0]
    if major == 7:
        err = TP.tp_shape_error(cfg, tp, params["blocks"][-1]["att.w1"].shape[0], f_dim, w4)
    elif major == 6:
        err = TP.tp_shape_error_v6(cfg, tp, b0["att.time_maa_w1"].shape[0] // 5,
                                   b0["att.time_decay_w1"].shape[0], f_dim, w4)
    else:
        err = (TP.tp_shape_error_v5 if major == 5 else TP.tp_shape_error_v4)(cfg, tp, f_dim, w4)
    if err:
        raise NotImplementedError(f"mesh with megakernel=True: {err}")


def _tp_packs(base: dict, cfg: ModelConfig, mesh) -> list:
    """The shard packs of ``ops.megakernel_tp`` for `mesh`, cut from the
    host pack `base`."""
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    build_tp = {7: TP.build_mega_pack_tp, 6: TP.build_mega_pack_tp_v6,
                5: TP.build_mega_pack_tp_v5, 4: TP.build_mega_pack_tp_v4}[cfg.version_major]
    return build_tp(base, cfg, mesh)


class ServingModel:
    """RWKV v4 / v5 / v6 / v7 serving engine on one device (B=1 decode
    over the shards of a mesh)."""

    def __init__(
        self,
        source,
        precision: str = "bf16",
        megakernel: bool = False,
        device=None,
        mesh=None,
        mega_pack_cache=None,
    ):
        """source: the path of a ggmf model file (FP32, FP16, Q4_0, Q4_1,
        Q5_0, Q5_1, Q8_0, Q4_K or Q5_K; ``models.loader.load_params``) or
        ``(cfg, params)`` with params in the port's format
        (``models.synth.synth_params``, ``convert.params_from_numpy`` or
        ``load_params``). precision: 'f32' | 'bf16' (dense) | 'quant' (keep
        the file's blocks, K9) | 'q8' (per-32-block int8, K9) | 'q8r'
        (rowwise int8, K9) | 'w8a8' (K1; a file's quantized blocks stay on
        K9) | 'w4a8' (int4 big matrices in the decode kernels; every per-op
        path runs w8a8). megakernel=True routes decode through kernels K3
        and K4 (v7), K6 (v6), K7 (v5) or K8 (v4; see ``decode``), int4
        under w4a8, bf16 under bf16 and f32 (the JAX package's quant=False
        pack; f32 keeps its per-op paths, embedding and B>1 head in f32)
        and int8 otherwise. device: default the CUDA card; raises when
        there is none.

        mesh: a ``parallel.sharding.Mesh`` (``make_mesh(1, tp, ...)``).
        With megakernel=True, B=1 decodes tensor-parallel over its shards
        (``ops.megakernel_tp``: kernels K10 / K11 for v7, K12 / K13 for
        v6, K15 / K13 for v5, K14 / K13 for v4; the int8, int4 or bf16
        pack as above); a model whose shapes do not split over the shards
        raises. Prefill, B>1 decode and the LM
        head are not sharded yet: they run the per-op path on
        ``mesh.devices[0]``, where the state lives too. `device`, if given,
        must be that device.

        mega_pack_cache: the path of a .npz pack cache
        (``ops.megakernel.save_mega_pack``). With megakernel=True an
        existing file is loaded instead of building the host pack (a mesh
        cuts its shard packs from it), and a missing one is written after
        the build. A file of another layout, model or precision raises."""
        if isinstance(source, (str, os.PathLike)):
            cfg, params = load_params(os.fspath(source))
        else:
            cfg, params = source
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")
        if mesh is not None:
            from rwkv_tpu_torch.parallel.sharding import same_device

            if device is not None and same_device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = cfg
        self.precision = precision
        dtype = torch.float32 if precision == "f32" else torch.bfloat16
        self.params = stack_layer_params(params, cfg, dtype, _PRECISIONS[precision], self.device)
        # smallest batch decoded through K4 (the card's crossover against
        # the per-op path is measured by chip_smoke.py); B=1 always takes a
        # kernel route under megakernel=True
        self.mega_min_batch = 2
        self._mega: Optional[dict] = None
        self._mega_tp: Optional[list] = None
        self._mega_k3 = False
        # the decode kernels' pack: int4 big matrices under w4a8, bf16 under
        # bf16 and f32, int8 otherwise
        w4, quant = precision == "w4a8", precision not in ("bf16", "f32")
        if not megakernel:
            return
        if mesh is not None:
            _tp_shape_check(params, cfg, mesh, w4)
        pack = _host_pack(params, cfg, w4, quant, mega_pack_cache)
        if mesh is not None:
            self._mega_tp = _tp_packs(pack, cfg, mesh)
            return
        from rwkv_tpu_torch.ops import megakernel as M

        if cfg.version_major == 6:
            err = M.v6_decode_shape_error(cfg, pack["d_maa"], pack["d_dec"], pack["f_dim"], w4)
        elif cfg.version_major == 5:
            err = M.v5_decode_shape_error(cfg, pack["f_dim"], w4, pack["form"],
                                          4 if pack["has_gate"] else 3)
        elif cfg.version_major == 4:
            err = M.v4_decode_shape_error(cfg, pack["f_dim"], w4, pack["form"])
        else:
            err = M.batched_shape_error(cfg, pack["d_lora"], pack["f_dim"], w4)
        if err:
            raise NotImplementedError(f"megakernel=True: {err}")
        self._mega = M.device_pack(pack, self.params["emb"], self.params["ln0"], self.device)
        if cfg.version_major == 7:
            # static route: K3 for B=1 where it takes the shapes, else K4 + head
            self._mega_k3 = M.decode_shape_error(
                cfg, pack["d_lora"], pack["f_dim"], w4, bf16=not quant) is None

    # -- state -------------------------------------------------------------
    def init_state(self, batch_size: int = 1) -> dict:
        """The blank state of `batch_size` sequences on the model's device
        (under a mesh, its first device: the state is not sharded yet)."""
        one = init_state(self.config, self.device)
        return {k: v[None].repeat(batch_size, *([1] * v.ndim)) for k, v in one.items()}

    # -- steps ---------------------------------------------------------------
    def _batched(self, state: dict, tokens: torch.Tensor, compute_logits=True):
        """tokens [B, T]; state [B, L, ...] -> (logits [B, V] or None, state)."""
        state_lb = {k: v.transpose(0, 1) for k, v in state.items()}
        logits, new_lb = forward_stacked(self.params, state_lb, tokens.T, self.config, compute_logits)
        return logits, {k: v.transpose(0, 1).contiguous() for k, v in new_lb.items()}

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=self.device)

    def decode(self, tokens, state: dict):
        """One decode step for a batch: tokens [B] -> (logits [B, V], state).
        With megakernel=True, v7: B=1 runs kernel K3 when it takes the
        model's shapes, else K4 and the head; mega_min_batch <= B <=
        MEGA_MAX_BATCH runs K4, ln_out and the per-op head (K1 at M=B
        under w8a8). v6, v5
        and v4: B=1 runs kernel K6, K7 or K8. (Plain versions on the CPU.)
        Every other B, and megakernel=False, runs the per-op path."""
        tok = self._tokens(tokens).reshape(-1)
        b = tok.shape[0]
        major = self.config.version_major
        if self._mega_tp is not None and b == 1:
            return self._megatp(state, tok)
        if self._mega is not None and major in (4, 5, 6):
            if b == 1:
                from rwkv_tpu_torch.ops import megakernel as M

                step = {6: M.v6_decode_step, 5: M.v5_decode_step, 4: M.v4_decode_step}[major]
                one = {k: v[0] for k, v in state.items()}
                logits, new = step(self._mega, one, tok, self.config)
                return logits[None], {k: v[None] for k, v in new.items()}
        elif self._mega is not None:
            if b == 1 and self._mega_k3:
                from rwkv_tpu_torch.ops.megakernel import v7_decode_step

                one = {k: v[0] for k, v in state.items()}
                logits, new = v7_decode_step(self._mega, one, tok, self.config)
                return logits[None], {k: v[None] for k, v in new.items()}
            if b == 1 or self.mega_min_batch <= b <= MEGA_MAX_BATCH:
                return self._mega_batched(state, tok)
        return self._batched(state, tok[:, None])

    def _megatp(self, state: dict, tok: torch.Tensor):
        """B=1 through the TP step (JAX's ``_megatp_fn``): ln0 of the token's
        embedding row, the shards' layers, then ln_out and the per-op head
        on the mesh's first device."""
        from rwkv_tpu_torch.ops import megakernel_tp as TP

        step = {7: TP.tp_decode_step, 6: TP.tp_decode_step_v6, 5: TP.tp_decode_step_v5,
                4: TP.tp_decode_step_v4}[self.config.version_major]
        x0 = layer_norm(self.params["emb"][tok[0]].float(), *self.params["ln0"])
        x, new = step(self._mega_tp, {k: v[0] for k, v in state.items()}, x0, self.config)
        xo = layer_norm(x, *self.params["ln_out"])
        logits = G.mm(xo[None, :], self.params["head"])
        return logits, {k: v[None] for k, v in new.items()}

    def _mega_batched(self, state: dict, tok: torch.Tensor):
        """K4 for the layers, then ln_out and the per-op head (K1 at M=B
        under w8a8; the model's bf16 or f32 head under those precisions)."""
        from rwkv_tpu_torch.ops.megakernel import v7_decode_batched

        x, new = v7_decode_batched(self._mega, state, tok, self.config)
        logits = G.mm(layer_norm(x, *self.params["ln_out"]), self.params["head"])
        return logits, new

    def prefill(self, tokens: Sequence[int], state: Optional[dict] = None,
                compute_logits: bool = True):
        """Single-sequence prefill with power-of-two chunk buckets.
        Returns (logits [V] of the last token or None, state [1, L, ...])."""
        if state is None:
            state = self.init_state(1)
        toks = self._tokens(tokens).reshape(-1)
        logits = None
        pos, n = 0, toks.shape[0]
        while pos < n:
            size = next(b for b in PREFILL_BUCKETS if b <= n - pos)
            is_last = pos + size >= n
            logits, state = self._batched(
                state, toks[pos : pos + size][None], compute_logits and is_last
            )
            pos += size
        return (logits[0] if logits is not None else None), state

    def score(self, tokens, state: dict):
        """Every position's logits: tokens [B, t] and state [B, L, ...] ->
        (logits [B, t, V], state after the t tokens). Position i's logits
        predict token i+1 (the speculative verification). One per-op pass
        over all t tokens (K1 / K9 and K2 / K5 on the card)."""
        tok = self._tokens(tokens)
        tok = tok.reshape(1, -1) if tok.ndim < 2 else tok
        logits, new_state = self._batched(state, tok, "all")
        return logits.transpose(0, 1), new_state

    def score_trace(self, tokens, state: dict):
        """Single-sequence scoring with the state after every position:
        tokens [t] and state [1, L, ...] -> (logits [t, V], trace arrays
        [L, t, ...]); see ``forward_stacked_trace`` (every version)."""
        tok = self._tokens(tokens).reshape(-1)
        return forward_stacked_trace(self.params, {k: v[0] for k, v in state.items()}, tok,
                                     self.config)

    def generate(
        self,
        prompt_tokens: Sequence[int],
        n_tokens: int,
        temperature: float = 1.0,
        seed: int = 0,
    ):
        """Prefill, then n_tokens of greedy (temperature <= 0) or
        temperature sampling (a torch.Generator seeded from `seed`), each
        token fed through the per-op path at T=1. Returns (tokens
        np.ndarray [n_tokens], final logits [V], state)."""
        logits, state = self.prefill(prompt_tokens)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        out = []
        for _ in range(n_tokens):
            if temperature <= 0.0:
                tok = torch.argmax(logits).reshape(1)
            else:
                probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            out.append(tok)
            lg, state = self._batched(state, tok[None])
            logits = lg[0]
        toks = torch.cat(out).cpu().numpy() if out else np.zeros((0,), np.int64)
        return toks, logits, state

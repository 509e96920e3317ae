"""Tensor-parallel B=1 decode for RWKV v7, v6, v5 and v4 (kernels K10-K15).

Ports ``rwkv_tpu.ops.megakernel_tp``:
``build_mega_pack_tp`` / ``_v6`` / ``_v5`` / ``_v4`` (the re-layout of a
decode pack into one pack per shard), the shard math of
``_math_helpers``, the per-layer kernels ``_att_layer_call`` /
``_ffn_layer_call`` (v7), ``_att_layer_call_v6`` / ``_ffn_layer_call_v6``
(v6; its gated FFN also serves v4 and v5 through ``mix45``),
``_att_layer_call_v5`` and ``_att_layer_call_v4``, and the steps
``tp_decode_step`` / ``_v6`` / ``_v5`` / ``_v4``. JAX runs the shards under ``shard_map`` over the
``model`` axis of a mesh and joins them with ``lax.psum``; here the layer
loop runs the shards in turn, each on its own device
(``parallel.sharding.Mesh``), and ``all_reduce`` sums their partial
outputs in shard order on shard 0's device, then hands the sum back to
each shard's device (no copy on a one-card mesh).

Sharding (Megatron style, head-aligned, as in JAX): the activations, the
layer norms, the token-shift coefficients and the LoRA down-projections
(v7 lora1; v6 maa1, maa2, dw1) are replicated; the r/k/v(/g) rows, v7's
lora2 rows, v6's dw2, the FFN gate rows (v6, v5, v4), the per-channel
vectors and the wkv head state are split by head block (``c_loc = C /
tp`` channels a shard; v4, whose wkv state is a scalar per channel, by
channel block: its ``aa`` / ``bb`` / ``pp`` columns); ``att.output`` and
``ffn.value`` are split along their contraction, so each shard's product
is a full-C partial that the all-reduce sums. The FFN hidden dim is cut into ``nf`` tiles by JAX's rule
(``_ffn_tiles``: a shard's tile of ``ffn.key`` stays within 4 Mi
values) and each shard holds an interleaved set of hidden rows, its own
``f_loc / nf`` rows of every tile.

Numerics follow JAX's TP kernels, not the single-device ones: each
matvec quantizes its input vector as a whole, and on the split
contractions that input is the shard's *local* slice -- the ``out``
input ``(y * g)[c_loc]`` with the shard's own scale, the FFN hidden per
(shard, tile). So a TP step differs from the single-device kernels by
those scales (JAX's band between them is 1e-1 of the scale).

A shard's pack holds its matrices as named ``[L, ...]`` tensors in the
weight form of the base pack (int8 codes with row scales ``name_d``;
int4 codes two a byte, ``ops.kernels.pack_int4``, under w4a8 -- for the
matrices split along K the 32-code blocks never straddle two shards, so
each shard's bytes are its slice of the packed row; bf16 values), the
replicated vectors in ``rvecs`` ``[L, n, C]`` and its own in ``lvecs``
``[L, m, c_loc]`` (named views into both), and v6's f32 ``maa2``. The
plain versions ``tp_att_layer_ref`` / ``tp_ffn_layer_ref`` / ``_v6_ref``
/ ``tp_att_layer_v5_ref`` / ``_v4_ref`` read those tensors; the wrappers
``tp_att_layer``, ``tp_ffn_layer``, ``tp_att_layer_v6``,
``tp_ffn_layer_v6``, ``tp_att_layer_v5``, ``tp_att_layer_v4`` and
``tp_ffn_layer_v45`` launch ``csrc/tp_v7.cu`` (K10), ``csrc/tp_v6.cu``
(K11, K12, K13 and K13's v4/v5 form, K15) and ``csrc/tp_v45.cu`` (K14)
once on a CUDA pack, counting launches in ``.launches`` /
``.launches_by_form``, and take the plain versions on a CPU pack. All six
run on the shared weight stream; their plans (``tp_v6_stream_plan``) are
held to the kernels' own at a pack's first launch (``tp6_grid``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from rwkv_tpu_torch.ops import _cuda
from rwkv_tpu_torch.ops.kernels import pack_int4, unpack_int4
from rwkv_tpu_torch.ops.megakernel import (
    FORMS, STREAM_MIN_STAGES, _SUFFIX, StreamCopy, _StreamPlan, _cdiv, _count, _form_bytes,
    _grid_blocks, _lanes_for, _matvec, _mix45, _part, _ring, _round_up, _small_form,
    _stream_rows_copies, _win_bytes,
)
from rwkv_tpu_torch.ops.parity import layer_norm

# the shard matrices of a v7 / v6 pack in the JAX package's order, and
# those that hold int4 codes under w4a8
TP_MAT_KEYS = ("rkv", "lora1", "lora2", "out", "fk", "fv")
TP_W4_MATS = ("rkv", "out", "fk", "fv")
TP6_MAT_KEYS = ("rkvg", "maa1", "dw1", "dw2", "out", "fk", "fv", "fr")
TP6_W4_MATS = ("rkvg", "out", "fk", "fv", "fr")
# vector rows of a shard: replicated [L, n, C] and the shard's own
# [L, m, c_loc]; the kernels' RVec / LVec enums match
TP_RVECS = ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias", "ffn.x_k") + tuple(
    f"coeff.{n}" for n in "rwkvag")
TP_LVECS = ("att.w0", "att.a0", "att.v0", "att.k_k", "att.k_a", "att.ln_x.weight",
            "att.ln_x.bias", "r_k")
TP6_RVECS = ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias", "att.time_maa_x",
             "ffn.time_maa_k", "ffn.time_maa_r") + tuple(f"maa5.{n}" for n in "wkvrg")
TP6_LVECS = ("tdecay", "att.ln_x.weight", "att.ln_x.bias", "tf")
# v4 / v5: all five matrices hold int4 codes under w4a8 (att = v4's rkv or
# v5's rkvg); the replicated rows put ln2 and the FFN mixes where K13
# reads them in v6's block (rows 2, 3, 5, 6 of TP6_RVECS), the attention
# mixes k, v, r(, g) around them; v5.2 adds "amix.g"
TP4_MAT_KEYS = ("rkv", "out", "fk", "fv", "fr")
TP5_MAT_KEYS = ("rkvg", "out", "fk", "fv", "fr")
TP45_W4_MATS = ("rkv", "rkvg", "out", "fk", "fv", "fr")
TP4_RVECS = ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias", "amix.k", "fmix.k", "fmix.r",
             "amix.v", "amix.r")
TP5_RVECS = TP4_RVECS + ("amix.g",)
TP4_LVECS = ("td", "tf")
TP5_LVECS = ("td", "tf", "att.ln_x.weight", "att.ln_x.bias")
_W4_MATS = {7: TP_W4_MATS, 6: TP6_W4_MATS, 5: TP45_W4_MATS, 4: TP45_W4_MATS}

# a shard's tile of ffn.key holds at most this many values (JAX's rule)
_FFN_TILE_VALUES = 4 * 1024 * 1024


def _ffn_tiles(c: int, f_loc: int) -> int:
    """nf: the FFN hidden tiles of JAX's ``build_mega_pack_tp`` (the
    smallest count dividing f_loc whose tile of f_loc / nf rows of width c
    stays within 4 Mi values)."""
    nf = 1
    while (f_loc // nf) * c > _FFN_TILE_VALUES or f_loc % nf:
        nf += 1
        if nf > f_loc:
            return f_loc
    return nf


def _dims_error(name: str, cfg, tp: int, f_dim: int, w4: bool, inner=(),
                heads: bool = True) -> Optional[str]:
    """The rules K10-K15 share: heads (unless `heads` is False: v4's
    recurrence has none), channels and the FFN split evenly over tp
    shards; a head size the per-head step takes; rows of K = C, c_loc, the
    FFN tile and `inner` (the LoRA widths) in whole 16-byte chunks (32
    codes under int4)."""
    c, h, s = cfg.n_embed, cfg.head_count, cfg.head_size
    if not heads:
        if tp < 1 or c % tp or f_dim % tp:
            return f"{name}: C ({c}) and F ({f_dim}) must split over tp={tp} shards"
    elif tp < 1 or h % tp or c % tp or f_dim % tp:
        return f"{name}: heads ({h}), C ({c}) and F ({f_dim}) must split over tp={tp} shards"
    elif s <= 0 or 256 % s or s * s // 256 > 16:
        return f"{name} supports head sizes dividing 256 up to 64, got {s}"
    c_loc, f_loc = c // tp, f_dim // tp
    f_tile = f_loc // _ffn_tiles(c, f_loc)
    for what, dim in (("C", c), ("C/tp", c_loc), ("the FFN tile", f_tile)) + tuple(inner):
        if dim % 16:
            return f"{name} needs {what} to be a multiple of 16, got {dim}"
        if w4 and what in ("C", "C/tp", "the FFN tile") and dim % 32:
            return f"{name}: int4 rows need {what} to be a multiple of 32, got {dim}"
    return None


def tp_shape_error(cfg, tp: int, d_lora: int, f_dim: int, w4: bool = False,
                   form: Optional[str] = None) -> Optional[str]:
    """Why K10 / K11 cannot take this v7 model at tp shards, or None (their
    stream plans checked in `form`, by default the int form `w4` names)."""
    if cfg.version_major != 7:
        return "K10 / K11 decode RWKV v7 only"
    return (_dims_error("K10 / K11", cfg, tp, f_dim, w4, (("d_lora", d_lora),))
            or _tp6_plan_error(cfg, tp, f_dim, w4, form, ("att7", "ffn7"), d_lora=d_lora))


def _tp6_plan_error(cfg, tp: int, f_dim: int, w4: bool, form: Optional[str], kinds,
                    d_maa: int = 0, d_dec: int = 0, d_lora: int = 0) -> Optional[str]:
    """Why the stream plan of K12 ("att"), K13 ("ffn"), K15 ("att5"), K10
    ("att7"), K11 ("ffn7") or K14 ("att4") in `kinds` cannot take these
    widths (``tp_v6_stream_plan`` at grid 1, in `form`: by default the int
    form `w4` names), or None."""
    c, f_loc = cfg.n_embed, f_dim // tp
    n_mix = 4 if cfg.version_minor == 2 else 3
    for kind in kinds:
        try:
            tp_v6_stream_plan(form or ("i4" if w4 else "i8"), c, c // tp, f_loc,
                              _ffn_tiles(c, f_loc), d_maa, d_dec, cfg.head_size, 1, kind,
                              n_mix=n_mix, d_lora=d_lora)
        except ValueError as e:
            return str(e)
    return None


def tp_shape_error_v6(cfg, tp: int, d_maa: int, d_dec: int, f_dim: int,
                      w4: bool = False, form: Optional[str] = None) -> Optional[str]:
    """Why K12 / K13 cannot take this v6 model at tp shards, or None (their
    stream plans checked in `form`, by default the int form `w4` names)."""
    if cfg.version_major != 6:
        return "K12 / K13 decode RWKV v6 only"
    if d_maa % 4:
        return f"K12 reads maa2 rows in float4 pieces: d_maa must be a multiple of 4, got {d_maa}"
    return (_dims_error("K12 / K13", cfg, tp, f_dim, w4, (("d_dec", d_dec),))
            or _tp6_plan_error(cfg, tp, f_dim, w4, form, ("att", "ffn"), d_maa, d_dec))


def tp_shape_error_v5(cfg, tp: int, f_dim: int, w4: bool = False,
                      form: Optional[str] = None) -> Optional[str]:
    """Why K15 / K13 cannot take this v5 model at tp shards, or None (their
    stream plans checked in `form`, by default the int form `w4` names)."""
    if cfg.version_major != 5:
        return "K15 / K13 decode RWKV v5 only"
    return (_dims_error("K15 / K13", cfg, tp, f_dim, w4)
            or _tp6_plan_error(cfg, tp, f_dim, w4, form, ("att5", "ffn")))


def tp_shape_error_v4(cfg, tp: int, f_dim: int, w4: bool = False,
                      form: Optional[str] = None) -> Optional[str]:
    """Why K14 / K13 cannot take this v4 model at tp shards, or None: C
    and F split over the shards, no head rule (v4's state is a scalar per
    channel); their stream plans checked in `form`."""
    if cfg.version_major != 4:
        return "K14 / K13 decode RWKV v4 only"
    return (_dims_error("K14 / K13", cfg, tp, f_dim, w4, heads=False)
            or _tp6_plan_error(cfg, tp, f_dim, w4, form, ("ffn", "att4")))


# -- packs --------------------------------------------------------------------


def _shard_pack(base: dict, mats: dict, rvecs: dict, lvecs: dict, device, meta: dict):
    """One shard's pack on `device`: the matrices (int4 ones packed two a
    byte), their scales, the vector blocks and the named views into them."""
    dev = torch.device(device)
    out = dict(meta)
    out["form"], out["w4"], out["quant"] = base["form"], base["w4"], base["quant"]
    for name, (w, d) in mats.items():
        w = pack_int4(w) if base["w4"] and name in _W4_MATS[meta["version"]] else w
        out[name] = w.contiguous().to(dev)
        if d is not None:
            out[name + "_d"] = d.contiguous().to(dev)
    for key, block in (("rvecs", rvecs), ("lvecs", lvecs)):
        out[key] = torch.stack(list(block.values()), dim=1).float().contiguous().to(dev)
        for i, name in enumerate(block):
            out[name] = out[key][:, i]
    return out


def _ffn_shard(base: dict, i: int, tp: int, nf: int):
    """Shard i's FFN matrices: fk rows [L, nf, f_tile, C] (its rows of
    every tile) with scales [L, nf, f_tile], fv [L, nf, C, f_tile] (those
    columns, tile-major) with full row scales [L, C]."""
    L, f_dim, c = base["fk"].shape
    f4 = f_dim // nf
    ft = f4 // tp
    rows = slice(i * ft, (i + 1) * ft)
    fk = base["fk"].reshape(L, nf, f4, c)[:, :, rows]
    fv = base["fv"].reshape(L, c, nf, f4).permute(0, 2, 1, 3)[:, :, :, rows]
    fk_d = base["fk_d"].reshape(L, nf, f4)[:, :, rows] if base["quant"] else None
    return {"fk": (fk, fk_d), "fv": (fv, base.get("fv_d"))}


def _part_rows(t, parts: int, c: int, ch: slice):
    """Rows `ch` of each of the `parts` blocks of C rows of t [L, parts * C,
    ...] -> [L, parts, c_loc, ...]; None (the bf16 form's scales) stays."""
    if t is None:
        return None
    return t.reshape(t.shape[0], parts, c, *t.shape[2:])[:, :, ch]


def _rows(base: dict, name: str, ch: slice):
    """(rows `ch` of matrix `name`, their scales)."""
    d = base.get(name + "_d")
    return base[name][:, ch], None if d is None else d[:, ch]


def _whole(base: dict, name: str):
    """(matrix `name` whole, its scales): replicated, or split along K
    (``out``, whose row scales every shard keeps)."""
    return base[name], base.get(name + "_d")


def build_mega_pack_tp(base: dict, cfg, mesh) -> list:
    """The v7 decode pack ``base`` (``ops.megakernel.build_mega_pack``, on
    the host, int4 codes one a byte) re-laid out for ``mesh.tp`` shards
    (JAX's ``build_mega_pack_tp``): a list of shard packs, shard i on
    ``mesh.devices[i]``, each holding its ``rkv`` rows ``[L, 3, c_loc,
    C]``, the whole ``lora1`` ``[L, 4d, C]``, its ``lora2`` rows ``[L, 4,
    c_loc, d]``, its ``out`` columns ``[L, C, c_loc]``, the FFN of
    ``_ffn_shard``, the scales of those rows (``out_d`` and ``fv_d`` whole),
    ``rvecs`` (``TP_RVECS``) and ``lvecs`` (``TP_LVECS``, its channels).
    Codes, scales and vectors are the base pack's, bit for bit."""
    tp, c = mesh.tp, cfg.n_embed
    d, f_dim = base["d_lora"], base["f_dim"]
    err = tp_shape_error(cfg, tp, d, f_dim, base["w4"], base["form"])
    if err:
        raise ValueError(err)
    c_loc = c // tp
    nf = _ffn_tiles(c, f_dim // tp)
    packs = []
    for i, dev in enumerate(mesh.devices):
        ch = slice(i * c_loc, (i + 1) * c_loc)
        mats = {
            "rkv": (_part_rows(base["rkv"], 3, c, ch), _part_rows(base.get("rkv_d"), 3, c, ch)),
            "lora1": _whole(base, "lora1"),
            "lora2": (_part_rows(base["lora2"], 4, c, ch),
                      _part_rows(base.get("lora2_d"), 4, c, ch)),
            "out": (base["out"][:, :, ch], base.get("out_d")),
            **_ffn_shard(base, i, tp, nf),
        }
        rvecs = {k: base[k] for k in TP_RVECS[:5]}
        rvecs.update({f"coeff.{n}": base["coeff"][:, j] for j, n in enumerate("rwkvag")})
        lvecs = {k: base[k][:, ch] for k in TP_LVECS}
        meta = {"version": 7, "tp": tp, "shard": i, "c_loc": c_loc, "nf": nf, "d_lora": d,
                "f_dim": f_dim}
        packs.append(_shard_pack(base, mats, rvecs, lvecs, dev, meta))
    return packs


def build_mega_pack_tp_v6(base: dict, cfg, mesh) -> list:
    """The v6 decode pack ``base`` (``build_mega_pack_v6``) re-laid out for
    ``mesh.tp`` shards (JAX's ``build_mega_pack_tp_v6``): per shard its
    ``rkvg`` rows ``[L, 4, c_loc, C]``, the whole ``maa1`` ``[L, 5 d_maa,
    C]``, ``dw1`` ``[L, d_dec, C]`` and f32 ``maa2`` ``[L, 5C, d_maa]``, its
    ``dw2`` rows ``[L, c_loc, d_dec]``, ``out`` columns ``[L, C, c_loc]``,
    FFN gate rows ``fr`` ``[L, c_loc, C]`` and the FFN of ``_ffn_shard``,
    with their scales, ``rvecs`` (``TP6_RVECS``) and ``lvecs``
    (``TP6_LVECS``, its channels)."""
    tp, c = mesh.tp, cfg.n_embed
    dm, dd, f_dim = base["d_maa"], base["d_dec"], base["f_dim"]
    err = tp_shape_error_v6(cfg, tp, dm, dd, f_dim, base["w4"], base["form"])
    if err:
        raise ValueError(err)
    c_loc = c // tp
    nf = _ffn_tiles(c, f_dim // tp)
    packs = []
    for i, dev in enumerate(mesh.devices):
        ch = slice(i * c_loc, (i + 1) * c_loc)
        mats = {
            "rkvg": (_part_rows(base["rkvg"], 4, c, ch),
                     _part_rows(base.get("rkvg_d"), 4, c, ch)),
            "maa1": _whole(base, "maa1"),
            "dw1": _whole(base, "dw1"),
            "dw2": _rows(base, "dw2", ch),
            "out": (base["out"][:, :, ch], base.get("out_d")),
            "fr": _rows(base, "fr", ch),
            **_ffn_shard(base, i, tp, nf),
        }
        rvecs = {k: base[k] for k in TP6_RVECS[:7]}
        rvecs.update({f"maa5.{n}": base["maa5"][:, j] for j, n in enumerate("wkvrg")})
        lvecs = {k: base[k][:, ch] for k in TP6_LVECS}
        meta = {"version": 6, "tp": tp, "shard": i, "c_loc": c_loc, "nf": nf, "d_maa": dm,
                "d_dec": dd, "f_dim": f_dim}
        pk = _shard_pack(base, mats, rvecs, lvecs, dev, meta)
        pk["maa2"] = base["maa2"].float().contiguous().to(dev)
        packs.append(pk)
    return packs


def _build_tp45(base: dict, cfg, mesh, version: int) -> list:
    tp, c = mesh.tp, cfg.n_embed
    f_dim = base["f_dim"]
    shape_error = tp_shape_error_v5 if version == 5 else tp_shape_error_v4
    err = shape_error(cfg, tp, f_dim, base["w4"], base["form"])
    if err:
        raise ValueError(err)
    att = "rkvg" if version == 5 else "rkv"
    n_mix = base["amix"].shape[1]
    c_loc = c // tp
    nf = _ffn_tiles(c, f_dim // tp)
    rows = {k: base[k] for k in TP4_RVECS[:4]}
    rows.update({f"fmix.{n}": base["fmix"][:, j] for j, n in enumerate("kr")})
    rows.update({f"amix.{n}": base["amix"][:, j] for j, n in enumerate("kvrg"[:n_mix])})
    rnames = TP5_RVECS if n_mix == 4 else TP4_RVECS
    packs = []
    for i, dev in enumerate(mesh.devices):
        ch = slice(i * c_loc, (i + 1) * c_loc)
        mats = {
            att: (_part_rows(base[att], n_mix, c, ch),
                  _part_rows(base.get(att + "_d"), n_mix, c, ch)),
            "out": (base["out"][:, :, ch], base.get("out_d")),
            "fr": _rows(base, "fr", ch),
            **_ffn_shard(base, i, tp, nf),
        }
        lvecs = {k: base[k][:, ch] for k in (TP5_LVECS if version == 5 else TP4_LVECS)}
        meta = {"version": version, "tp": tp, "shard": i, "c_loc": c_loc, "nf": nf,
                "f_dim": f_dim, "n_mix": n_mix}
        packs.append(_shard_pack(base, mats, {k: rows[k] for k in rnames}, lvecs, dev, meta))
    return packs


def build_mega_pack_tp_v5(base: dict, cfg, mesh) -> list:
    """The v5.1 / v5.2 decode pack ``base`` (``build_mega_pack_v5``)
    re-laid out for ``mesh.tp`` shards (JAX's ``build_mega_pack_tp_v5``):
    per shard its ``rkvg`` rows ``[L, n_mix, c_loc, C]`` (``n_mix`` 3 on
    v5.1, 4 with the gate on v5.2), ``out`` columns ``[L, C, c_loc]``, FFN
    gate rows ``fr`` ``[L, c_loc, C]`` and the FFN of ``_ffn_shard``, with
    their scales, ``rvecs`` (``TP5_RVECS``, v5.1 without "amix.g") and
    ``lvecs`` (``TP5_LVECS``: the decay, bonus and ln_x of its heads)."""
    return _build_tp45(base, cfg, mesh, 5)


def build_mega_pack_tp_v4(base: dict, cfg, mesh) -> list:
    """The v4 decode pack ``base`` (``build_mega_pack_v4``) re-laid out for
    ``mesh.tp`` shards (JAX's ``build_mega_pack_tp_v4``): as
    ``build_mega_pack_tp_v5`` with ``rkv`` rows ``[L, 3, c_loc, C]``,
    ``rvecs`` ``TP4_RVECS`` and ``lvecs`` ``TP4_LVECS`` (time_decay and
    time_first of its channels)."""
    return _build_tp45(base, cfg, mesh, 4)


# -- the shard math (JAX's _math_helpers) ----------------------------------------


def _codes(pack: dict, name: str, layer: int) -> torch.Tensor:
    """Layer `layer` of shard matrix `name` as int8 codes (bf16 values in
    the bf16 form), int4 bytes unpacked."""
    q = pack[name][layer]
    return unpack_int4(q) if pack["w4"] and name in _W4_MATS[pack["version"]] else q


def _mv(pack: dict, name: str, layer: int, x, rows=None):
    """``_matvec`` of x [1, K] against layer `layer` of matrix `name` (its
    leading dims flattened into rows, or part `rows` of them: fv's tile,
    whose row scales are the whole matrix's)."""
    q = _codes(pack, name, layer)
    d = pack.get(name + "_d")
    d = None if d is None else d[layer]
    if rows is not None:
        q = q[rows]
        if d is not None and d.dim() == q.dim():
            d = d[rows]
    return _matvec(q.reshape(-1, q.shape[-1]), None if d is None else d.reshape(-1), x)


def _ffn_out(pack: dict, l: int, hk):
    """The FFN's ``fv`` partial: per tile, its slice of the hidden quantized
    on its own (JAX's ``mv_big`` per tile), accumulated in tile order."""
    nf = pack["nf"]
    ft = hk.shape[-1] // nf
    acc = None
    for t in range(nf):
        y = _mv(pack, "fv", l, hk[:, t * ft : (t + 1) * ft], rows=t)
        acc = y if acc is None else acc + y
    return acc


def _group_norm_heads(y, s: int, eps: float):
    """Per-head normalization of y [h, s] (population variance)."""
    mu = y.mean(-1, keepdim=True)
    yc = y - mu
    var = (yc * yc).mean(-1, keepdim=True)
    return (yc * torch.rsqrt(var + eps)).reshape(1, -1)


def tp_att_layer_ref(pack: dict, l: int, x, att_xx, heads, v_first, first: bool, cfg):
    """Plain PyTorch K10: layer l's v7 attention on one shard (any device;
    JAX's ``_make_att_kernel``). x, att_xx [C]; heads [h_loc, S, S] (i =
    value dim, j = key dim); v_first [c_loc] (unused when `first`). Returns
    (the full-C partial of ``out`` [C], the new att_xx [C], the new heads,
    the new v_first [c_loc])."""
    s = cfg.head_size
    c_loc, d = pack["c_loc"], pack["d_lora"]
    h_loc = c_loc // s

    def vec(key):
        return pack[key][l]

    xl = layer_norm(x.float()[None], vec("ln1.weight"), vec("ln1.bias"))
    sx = att_xx.float()[None] - xl
    xr, xw, xk, xv, xa, xg = (xl + sx * vec(f"coeff.{n}") for n in "rwkvag")
    lora1 = pack["lora1"][l]

    def l1(part, xin):
        rows = slice(part * d, (part + 1) * d)
        dd = pack.get("lora1_d")
        return _matvec(lora1[rows], None if dd is None else dd[l][rows], xin)

    w_dn = torch.tanh(l1(0, xw))
    a_dn = l1(1, xa)
    g_dn = torch.sigmoid(l1(2, xg))
    v_dn = l1(3, xv)
    w_l = _mv(pack, "lora2", l, w_dn, rows=0)
    a_l = _mv(pack, "lora2", l, a_dn, rows=1)
    g = _mv(pack, "lora2", l, g_dn, rows=2)
    vm = _mv(pack, "lora2", l, v_dn, rows=3)
    w_dec = torch.exp(torch.sigmoid(w_l + vec("att.w0")) * -0.606531)
    a_gate = torch.sigmoid(a_l + vec("att.a0"))
    r = _mv(pack, "rkv", l, xr, rows=0)
    k = _mv(pack, "rkv", l, xk, rows=1)
    v = _mv(pack, "rkv", l, xv, rows=2)
    kk = (k * vec("att.k_k")).reshape(h_loc, s)
    kk = kk / torch.clamp(torch.sqrt((kk * kk).sum(-1, keepdim=True)), min=1e-12)
    ka = k * vec("att.k_a")
    k = k + (a_gate * ka - ka)
    if first:
        v_first = v[0]
    else:
        v = v + (v_first[None] - v) * torch.sigmoid(vm + vec("att.v0"))

    r3, w3, k3, v3 = (t.reshape(h_loc, s) for t in (r, w_dec, k, v))
    a3, b3 = -kk, kk * a_gate.reshape(h_loc, s)
    sa = torch.einsum("hij,hj->hi", heads, a3)
    st = (heads * w3[:, None, :] + v3[:, :, None] * k3[:, None, :]
          + sa[:, :, None] * b3[:, None, :])
    y = torch.einsum("hij,hj->hi", st, r3)
    xo = _group_norm_heads(y, s, 64e-5) * vec("att.ln_x.weight") + vec("att.ln_x.bias")
    bonus = (v3 * (k3 * r3 * vec("r_k").reshape(h_loc, s)).sum(-1, keepdim=True)).reshape(1, c_loc)
    xo = (xo + bonus) * g
    return _mv(pack, "out", l, xo)[0], xl[0], st, v_first


def tp_ffn_layer_ref(pack: dict, l: int, x, ffn_xx, cfg):
    """Plain PyTorch K11: layer l's v7 FFN on one shard (JAX's
    ``_make_ffn_kernel``). Returns (the full-C partial [C], the new ffn_xx
    [C])."""
    xl2 = layer_norm(x.float()[None], pack["ln2.weight"][l], pack["ln2.bias"][l])
    xk2 = xl2 + (ffn_xx.float()[None] - xl2) * pack["ffn.x_k"][l]
    hk = torch.square(torch.relu(_mv(pack, "fk", l, xk2)))
    return _ffn_out(pack, l, hk)[0], xl2[0]


def tp_att_layer_v6_ref(pack: dict, l: int, x, att_xx, heads, cfg):
    """Plain PyTorch K12: layer l's v6 attention on one shard (JAX's
    ``_make_att_kernel_v6``): the maa chain replicated (maa2 f32 products),
    the decay LoRA's dw2 rows and the rkvg rows of the shard's channels,
    wkv6 with the time_faaaa bonus, group norm, ln_x, silu gate. Returns
    (the full-C partial [C], the new att_xx [C], the new heads)."""
    s, c = cfg.head_size, cfg.n_embed
    c_loc, dm = pack["c_loc"], pack["d_maa"]
    h_loc = c_loc // s

    def vec(key):
        return pack[key][l]

    xl = layer_norm(x.float()[None], vec("ln1.weight"), vec("ln1.bias"))
    sx = att_xx.float()[None] - xl
    xxx = xl + sx * vec("att.time_maa_x")
    mixdn = torch.tanh(_mv(pack, "maa1", l, xxx))
    m = torch.einsum("scd,sd->sc", pack["maa2"][l].reshape(5, c, dm), mixdn.reshape(5, dm))
    xw, xk, xv, xr, xg = (xl + sx * (vec(f"maa5.{n}") + m[i]) for i, n in enumerate("wkvrg"))
    w_dn = torch.tanh(_mv(pack, "dw1", l, xw))
    w_dec = torch.exp(-torch.exp(_mv(pack, "dw2", l, w_dn) + vec("tdecay")))
    r = _mv(pack, "rkvg", l, xr, rows=0)
    k = _mv(pack, "rkvg", l, xk, rows=1)
    v = _mv(pack, "rkvg", l, xv, rows=2)
    gg = _mv(pack, "rkvg", l, xg, rows=3)
    g = gg * torch.sigmoid(gg)

    r3, k3, v3, w3 = (t.reshape(h_loc, s) for t in (r, k, v, w_dec))
    dot = (r3 * vec("tf").reshape(h_loc, s) * k3).sum(-1, keepdim=True)
    y = torch.einsum("hij,hj->hi", heads, r3) + v3 * dot
    st = heads * w3[:, None, :] + v3[:, :, None] * k3[:, None, :]
    xo = (_group_norm_heads(y, s, 64e-5) * vec("att.ln_x.weight") + vec("att.ln_x.bias")) * g
    return _mv(pack, "out", l, xo)[0], xl[0], st


def tp_ffn_layer_v6_ref(pack: dict, l: int, x, ffn_xx, cfg, mix45: bool = False):
    """Plain PyTorch K13: layer l's gated FFN on one shard (JAX's
    ``_make_ffn_kernel_v6``): the gate rows of the shard's channels with
    sigmoid, the fk rows with relu^2, the fv partial per tile. mix45 (a v4
    / v5 pack): the token-shift mix ``xl * mix + (prev - prev * mix)`` of
    the ``fmix`` rows instead of v6's ``xl + (prev - xl) * maa``. Returns
    (the full-C partial [C], the gate [c_loc], the new ffn_xx [C])."""
    xl2 = layer_norm(x.float()[None], pack["ln2.weight"][l], pack["ln2.bias"][l])
    prev = ffn_xx.float()[None]
    if mix45:
        xk2 = _mix45(xl2, prev, pack["fmix.k"][l])
        xr2 = _mix45(xl2, prev, pack["fmix.r"][l])
    else:
        cfk, cfr = pack["ffn.time_maa_k"][l], pack["ffn.time_maa_r"][l]
        sx2 = prev - xl2
        xk2 = xl2 + sx2 * cfk
        xr2 = xl2 + sx2 * cfr
    rg = torch.sigmoid(_mv(pack, "fr", l, xr2))
    hk = torch.square(torch.relu(_mv(pack, "fk", l, xk2)))
    return _ffn_out(pack, l, hk)[0], rg[0], xl2[0]


def _ffn45_ref(pack: dict, l: int, x, ffn_xx, cfg):
    return tp_ffn_layer_v6_ref(pack, l, x, ffn_xx, cfg, mix45=True)


def _att_mixes(pack: dict, l: int, x, att_xx):
    """ln1(x) [1, C] and the v4 / v5 attention mixes {"k", "v", "r"(,
    "g")} in the reference's op order."""
    xl = layer_norm(x.float()[None], pack["ln1.weight"][l], pack["ln1.bias"][l])
    prev = att_xx.float()[None]
    return xl, {n: _mix45(xl, prev, pack[f"amix.{n}"][l]) for n in "kvrg"[: pack["n_mix"]]}


def tp_att_layer_v5_ref(pack: dict, l: int, x, att_xx, heads, cfg):
    """Plain PyTorch K15: layer l's v5.1 / v5.2 attention on one shard
    (JAX's ``_make_att_kernel_v5``): the mixes k, v, r(, g), each
    quantized as a whole, into the shard's rkvg rows (silu on g), per head
    the wkv step with the static decay and the bonus, group norm (eps
    1e-5), ln_x, the gate. heads [h_loc, S, S] (i = value dim). Returns
    (the full-C partial of ``out`` [C], the new att_xx [C], the new
    heads)."""
    s = cfg.head_size
    h_loc = pack["c_loc"] // s
    xl, mix = _att_mixes(pack, l, x, att_xx)
    r = _mv(pack, "rkvg", l, mix["r"], rows=0)
    k = _mv(pack, "rkvg", l, mix["k"], rows=1)
    v = _mv(pack, "rkvg", l, mix["v"], rows=2)
    r3, k3, v3 = (t.reshape(h_loc, s) for t in (r, k, v))
    dot = (r3 * pack["tf"][l].reshape(h_loc, s) * k3).sum(-1, keepdim=True)
    y = torch.einsum("hij,hj->hi", heads.float(), r3) + v3 * dot
    st = (heads.float() * pack["td"][l].reshape(h_loc, s)[:, None, :]
          + v3[:, :, None] * k3[:, None, :])
    xo = _group_norm_heads(y, s, 1e-5) * pack["att.ln_x.weight"][l] + pack["att.ln_x.bias"][l]
    if "g" in mix:
        gg = _mv(pack, "rkvg", l, mix["g"], rows=3)
        xo = xo * (gg * torch.sigmoid(gg))
    return _mv(pack, "out", l, xo)[0], xl[0], st


def tp_att_layer_v4_ref(pack: dict, l: int, x, att_xx, aa, bb, pp, cfg):
    """Plain PyTorch K14: layer l's v4 attention on one shard (JAX's
    ``_make_att_kernel_v4``): the mixes k, v, r into the shard's rkv rows
    (sigmoid on r), the max-trick wkv on its channels with their aa, bb,
    pp [c_loc], ``xo = r * wkv``. Returns (the full-C partial of ``out``
    [C], the new att_xx [C], the new aa, bb, pp)."""
    from rwkv_tpu_torch.models.graph import _wkv4_step

    xl, mix = _att_mixes(pack, l, x, att_xx)
    r = torch.sigmoid(_mv(pack, "rkv", l, mix["r"], rows=0))
    k = _mv(pack, "rkv", l, mix["k"], rows=1)
    v = _mv(pack, "rkv", l, mix["v"], rows=2)
    wkv, aa, bb, pp = _wkv4_step(pack["tf"][l], pack["td"][l], k[0], v[0], aa.float(), bb.float(),
                                 pp.float())
    return _mv(pack, "out", l, r * wkv)[0], xl[0], aa, bb, pp


# -- the stream plans of K10-K15 (csrc/tp_v6.cu: AttLayout / AttPlan /
# att_copy, FfnLayout / FfnPlan / ffn_copy; csrc/tp_v7.cu: K10's AttLayout /
# AttPlan / att_copy; csrc/tp_v45.cu: Att4Layout / Att4Plan / att4_copy) ----
#
# The shard kernels run on the B=1 decode kernels' input stream
# (csrc/decode_stream.cuh, csrc/tp_stream.cuh; ``ops.megakernel``'s
# ``_StreamPlan`` mirrors its generic parts): each block's rows of each
# phase in whole 4-row groups, cut into pieces of as many rows as fit a stage
# with their row scales' window; phase A's vector rows (and att_in / ffn_in)
# in pieces of ``vec_rows`` rows; per head: K12 its dw2 rows with their
# scales and its four vector slices in one piece, its state in the next;
# K15 its state with its four vector slices in one piece; K10 its state
# with its eight vector slices and v_first in one piece, then its lora2
# rows, ``l2_runs`` runs of S rows with their scales a piece; K14's phase B
# its td at the block's channels, tf and the old aa, bb, pp, ``vec_rows`` a
# piece; the ring the other stream kernels' (about
# ``STREAM_TARGET_STAGES`` stages). The kernels compute the layout on the
# host and each block's plan at its start (the header's ``part``). Copies
# read from layer l's tensor of the shard pack (``pack[array][l]``) or from
# the launch's inputs (``att_in`` / ``ffn_in``, ``heads_in``, ``vf``,
# ``aa_in`` / ``bb_in`` / ``pp_in``), at byte ``offset`` of it.
TP6_STATIC_SMEM = 0  # the stream kernels' static shared memory (the card tests read the kernels')
TP6_MAX_TILES = 32  # K13's and K11's FFN tiles at most (kMaxTiles: one published amax each)
TP6_ATT_AMAX = 8  # K12's / K15's published amax slots behind the scratch
TP7_ATT_AMAX = 4  # K10's (xo's, padded)
TP_KERNEL = {"att": "K12", "ffn": "K13", "att5": "K15", "att7": "K10", "ffn7": "K11",
             "att4": "K14"}
TP_SEGS = {"att": ("vec", "maa1", "maa2", "rkvg", "dw1", "heads", "out"),
           "ffn": ("vec", "fk", "fr", "fv"),
           "att5": ("vec", "rkvg", "heads", "out"),
           "att7": ("vec", "rkv", "lora1", "heads", "out"),
           "ffn7": ("vec", "fk", "fv"),
           "att4": ("vec", "rkv", "vec_b", "out")}
TP_STREAMED = {"att": ("maa1", "maa2", "rkvg", "dw1", "out"), "ffn": ("fk", "fr"),
               "att5": ("rkvg", "out"), "att7": ("rkv", "lora1", "out"), "ffn7": ("fk",),
               "att4": ("rkv", "out")}
# phase A's vector rows in stream order: (array, row of rvecs; None: the whole input)
TP6_ATT_VECS = (("rvecs", 0), ("rvecs", 1), ("rvecs", 4), ("att_in", None))
TP6_FFN_VECS = (("rvecs", 2), ("rvecs", 3), ("rvecs", 5), ("rvecs", 6), ("ffn_in", None))
# K11: ln2 w, b, x_k (TP_RVECS 2-4), ffn_in
TP7_FFN_VECS = (("rvecs", 2), ("rvecs", 3), ("rvecs", 4), ("ffn_in", None))
# K14: ln1 w, b, the mixes k, v, r (TP4_RVECS 4, 7, 8), att_in; phase B's five
# rows (td at the block's channels, tf, aa_in, bb_in, pp_in)
TP4_ATT_VECS = (("rvecs", 0), ("rvecs", 1), ("rvecs", 4), ("rvecs", 7), ("rvecs", 8),
                ("att_in", None))
TP4_VEC_B = 5
# K15: ln1 w, b, att_in, then the mixes k, v, r(, g) (TP5_RVECS rows 4, 7, 8, 9)
TP5_ATT_VECS = (("rvecs", 0), ("rvecs", 1), ("att_in", None), ("rvecs", 4), ("rvecs", 7),
                ("rvecs", 8), ("rvecs", 9))
# K10: ln1 w, b, the six coefficient rows r, w, k, v, a, g (TP_RVECS 5-10), att_in
TP7_ATT_VECS = (("rvecs", 0), ("rvecs", 1)) + tuple(("rvecs", 5 + m) for m in range(6)) + (
    ("att_in", None),)
_TP6_MAA5_ROW = 7  # maa5's first row in rvecs (the window of maa2's rows)
# a head's vector slices in its dw2 piece, as lvecs rows: tdecay, tf, ln_x w, ln_x b
TP6_HEAD_LVECS = (0, 3, 1, 2)


@dataclass(frozen=True)
class TP6StreamPlan(_StreamPlan):
    """The stream plan of K12 ("att"), K13 ("ffn", either mix), K15
    ("att5", ``n_mix`` 3 on v5.1, 4 on v5.2), K10 ("att7", ``d_lora``), K11
    ("ffn7") or K14 ("att4") for one weight form and grid
    (``tp_v6_stream_plan``): the shared-memory layout (activations at
    ``act_off``, mbarriers at ``bar_off``, ``n_stages`` stages of
    ``stage_bytes`` from ``ring_off``; ``smem_bytes`` in all), ``vec_rows``
    vector rows a piece (K10: ``l2_runs`` lora2 runs a piece), and per
    block the rows of each phase and the copies of each piece of its stream
    (one layer; K10's with v_first read, unless ``first``)."""

    HEAD_SEGS = ()

    kind: str
    form: str
    c: int
    c_loc: int
    f_loc: int
    nf: int
    d_maa: int
    d_dec: int
    head_size: int
    blocks: int
    act_off: int
    bar_off: int
    ring_off: int
    stage_bytes: int
    n_stages: int
    smem_bytes: int
    vec_rows: int
    n_mix: int = 0
    d_lora: int = 0
    l2_runs: int = 0
    first: bool = False

    @property
    def SEGS(self) -> tuple:  # noqa: N802 -- _StreamPlan's name
        return TP_SEGS[self.kind]

    @property
    def STREAMED(self) -> tuple:  # noqa: N802
        return TP_STREAMED[self.kind]

    @property
    def n_heads(self) -> int:
        """Heads of the shard (the per-head phase of K10, K12 and K15)."""
        return self.c_loc // self.head_size if self.kind in ("att", "att5", "att7") else 0

    @property
    def vecs(self) -> tuple:
        return {"att": TP6_ATT_VECS, "ffn": TP6_FFN_VECS, "att7": TP7_ATT_VECS,
                "ffn7": TP7_FFN_VECS, "att4": TP4_ATT_VECS,
                "att5": TP5_ATT_VECS[:3 + self.n_mix]}[self.kind]

    def channels(self, block: int) -> tuple:
        """K14: the channels [s0, s1) whose new aa, bb, pp block `block`
        writes (whole 4-channel groups, as the header's ``part`` deals rows)."""
        r = _part(self.c_loc, self.blocks, block, False, 4, False, self.stage_bytes, 1)
        return r.r0, r.r1

    @property
    def head_pieces(self) -> int:
        """Pieces of a head's phase: K12 2, K15 1, K10 its state piece and
        its lora2 pieces."""
        return {"att": 2, "att5": 1, "att7": 1 + _cdiv(4, max(self.l2_runs, 1))}.get(self.kind, 0)

    def _spec(self, name: str) -> tuple:
        """(rows, row bytes, scale window, dealt from the last block, most
        lanes a row)."""
        c, cl, form = self.c, self.c_loc, self.form
        sf, w = _small_form(form), form != "bf16"
        ft = self.f_loc // self.nf if self.nf else 0
        big = _lanes_for(c, form)
        return {"maa1": (5 * self.d_maa, _form_bytes(sf, c), w, False, 32),
                "maa2": (5 * c, 4 * self.d_maa, True, False, 32),
                "rkvg": ((self.n_mix or 4) * cl, _form_bytes(form, c), w, False, big),
                "rkv": (3 * cl, _form_bytes(form, c), w, False, big),
                "lora1": (4 * self.d_lora, _form_bytes(sf, c), w, True, 32),
                "dw1": (self.d_dec, _form_bytes(sf, c), w, True, 32),
                "out": (c, _form_bytes(form, cl), w, False, _lanes_for(cl, form)),
                "fk": (self.f_loc, _form_bytes(form, c), w, False, big),
                "fr": (cl, _form_bytes(form, c), w, True, big),
                "fv": (c, _form_bytes(form, ft), w, False, _lanes_for(ft, form))}[name]

    def _count(self, seg: str, block: int) -> int:
        if seg == "vec":
            return _cdiv(len(self.vecs), self.vec_rows)
        if seg == "vec_b":
            return _cdiv(TP4_VEC_B, self.vec_rows)
        if seg == "heads":
            return self.head_pieces * len(self.block_heads(block))
        return self.nf * self.rows("fv", block).pieces()  # fv: every tile's pieces

    def copies(self, block: int, layer: int, seg: str, idx: int) -> tuple:
        """The copies of piece `idx` of segment `seg` (`layer` unused: the
        offsets are within layer l's tensors)."""
        c, s, w = self.c, self.head_size, self.form != "bf16"
        if seg == "vec":
            run = self.vecs[idx * self.vec_rows:(idx + 1) * self.vec_rows]
            return tuple(StreamCopy(a, 0 if row is None else 4 * row * c, 4 * c, 4 * c * j)
                         for j, (a, row) in enumerate(run))
        if seg == "vec_b":  # row slot j of the piece at 4 c j, as phase A's
            s0, s1 = self.channels(block)
            cl = self.c_loc
            rows = [("lvecs", 4 * s0, 4 * (s1 - s0)), ("lvecs", 4 * cl, 4 * cl),
                    ("aa_in", 0, 4 * cl), ("bb_in", 0, 4 * cl), ("pp_in", 0, 4 * cl)]
            run = rows[idx * self.vec_rows:(idx + 1) * self.vec_rows]
            return tuple(StreamCopy(a, off, n, 4 * c * j)
                         for j, (a, off, n) in enumerate(run) if n > 0)
        if seg == "maa2":
            return _stream_rows_copies(self.rows(seg, block), idx, "maa2", 0,
                                       ("rvecs", 4 * _TP6_MAA5_ROW * c))
        if seg in self.STREAMED:
            return _stream_rows_copies(self.rows(seg, block), idx, seg, 0,
                                       (seg + "_d", 0) if w else None)
        if seg == "fv":
            r = self.rows("fv", block)
            t, k = divmod(idx, r.pieces())
            ft = self.f_loc // self.nf
            return _stream_rows_copies(r, k, "fv", _form_bytes(self.form, t * c * ft),
                                       ("fv_d", 0) if w else None)
        h, k = divmod(idx, self.head_pieces)  # heads
        h = self.block_heads(block)[h]
        state = StreamCopy("heads_in", 4 * h * s * s, 4 * s * s, 0)

        def slices(rows, at):
            return [StreamCopy("lvecs", 4 * (row * self.c_loc + h * s), 4 * s, at + 4 * s * i)
                    for i, row in enumerate(rows)]

        if self.kind == "att5":  # the state, then td, tf, ln_x w, ln_x b
            return tuple([state] + slices(range(len(TP5_LVECS)), 4 * s * s))
        if self.kind == "att7":
            if k == 0:  # the state, its eight slices, v_first where read
                out = [state] + slices(range(len(TP_LVECS)), 4 * s * s)
                if not self.first:
                    out.append(StreamCopy("vf", 4 * h * s, 4 * s,
                                          4 * s * s + 4 * s * len(TP_LVECS)))
                return tuple(out)
            # runs q0 .. q1 - 1 of the lora2 rows (run q: rows q c_loc + h s +
            # [0, s)), then their row scales
            q0 = (k - 1) * self.l2_runs
            q1 = min(q0 + self.l2_runs, 4)
            rb = _form_bytes(_small_form(self.form), self.d_lora)
            out = [StreamCopy("lora2", (q * self.c_loc + h * s) * rb, s * rb, s * rb * (q - q0))
                   for q in range(q0, q1)]
            if w:
                out += [StreamCopy("lora2_d", 4 * (q * self.c_loc + h * s), 4 * s,
                                   s * rb * (q1 - q0) + 4 * s * (q - q0)) for q in range(q0, q1)]
            return tuple(out)
        if k:
            return (state,)
        rb = _form_bytes(_small_form(self.form), self.d_dec)
        out = [StreamCopy("dw2", h * s * rb, s * rb, 0)]
        at = s * rb
        if w:
            out.append(StreamCopy("dw2_d", 4 * h * s, 4 * s, at))
            at += 4 * s
        return tuple(out + slices(TP6_HEAD_LVECS, at))


def _lora2_run(s: int, d: int, form: str) -> int:
    """Bytes of one run of a head's lora2 rows with their scales (K10)."""
    return s * _form_bytes(_small_form(form), d) + (0 if form == "bf16" else 4 * s)


def tp_v6_stream_plan(form: str, c: int, c_loc: int, f_loc: int, nf: int, d_maa: int, d_dec: int,
                      head_size: int, blocks: int, kind: str, n_mix: int = 0,
                      d_lora: int = 0) -> TP6StreamPlan:
    """The stream plan of K12 (`kind` "att"), K13 ("ffn"), K15 ("att5",
    `n_mix` 3 or 4), K10 ("att7", `d_lora`), K11 ("ffn7") or K14 ("att4")
    in weight form `form` ("i8", "i4", "bf16") for a grid of `blocks` on a
    shard of `c_loc` channels and `f_loc` FFN rows in `nf` tiles (the
    kernels' own: ``rwkv_tp_v6_plan``, ``rwkv_tp_v7_plan``,
    ``rwkv_tp_v4_plan``). The ring takes what shared memory is left below
    ``STREAM_SMEM_LIMIT`` after the activations, about
    ``STREAM_TARGET_STAGES`` stages, each at least the largest piece (two
    vector rows; a head's state (K15, K10: with its slices), K12's dw2 piece,
    K10's lora2 run; one row of any matrix with its scale window); raises
    ValueError on widths the kernel refuses: fewer than
    ``STREAM_MIN_STAGES`` stages, under two vector rows a piece, phase A's
    vector pieces (K10: a head's pieces) more than the stages, K13 / K11
    above ``TP6_MAX_TILES`` tiles."""
    s, sf, bf = head_size, _small_form(form), form == "bf16"
    name = TP_KERNEL[kind]
    ft = f_loc // nf if nf > 0 else 0
    bad = [c % 16, c_loc % 16, c_loc > c]
    bad_head = s <= 0 or s % 4 or 256 % s or s * s // 256 > 16 or c_loc % s
    row = max(_form_bytes(form, c), _form_bytes(form, c_loc))
    if kind == "att":
        bad += [bad_head, d_maa % 4, d_dec % 16]
        act_off = 4 * (2 * c + max(8 * s, 5 * d_maa) + 256 + 8 + TP6_ATT_AMAX)
        plan_off = _round_up(act_off + (4 if bf else 1) * 5 * c, 16)
        row = max(row, _form_bytes(sf, c), 4 * d_maa)
        piece = max(8 * c, 4 * s * s, s * _form_bytes(sf, d_dec) + (16 if bf else 20) * s,
                    row + _win_bytes(1))
    elif kind == "att5":
        bad += [bad_head, n_mix not in (3, 4)]
        act_off = 4 * (2 * c + 8 * s + 256 + 8 + TP6_ATT_AMAX)
        plan_off = _round_up(act_off + (4 if bf else 1) * 5 * c, 16)
        piece = max(8 * c, 4 * s * s + 4 * len(TP5_LVECS) * s, row + _win_bytes(1))
    elif kind == "att7":
        bad += [bad_head, d_lora <= 0 or d_lora % 16]
        act_off = _round_up(4 * (2 * c + 10 * s + 256 + 8 + 8), 16)
        plan_off = _round_up(act_off + (4 if bf else 1) * max(6 * c, 4 * d_lora), 16)
        row = max(row, _form_bytes(sf, c))
        piece = max(8 * c, 4 * s * s + 4 * (len(TP_LVECS) + 1) * s,
                    _lora2_run(s, d_lora, form), row + _win_bytes(1))
    elif kind == "att4":
        act_off = _round_up(4 * (2 * c + 256 + 8), 16)
        plan_off = _round_up(act_off + (4 if bf else 1) * 3 * c, 16)
        piece = max(8 * c, row + _win_bytes(1))
    else:
        bad += [nf <= 0 or nf > TP6_MAX_TILES or f_loc % nf or ft % 16]
        act_off = 4 * (2 * c + 256 + 2 * TP6_MAX_TILES + 4)
        plan_off = _round_up(act_off + (4 if bf else 1) * max(2 * c, f_loc), 16)
        piece = max(8 * c, max(_form_bytes(form, c), _form_bytes(form, ft)) + _win_bytes(1))
    if any(bad):
        tiles = f"F/tp={f_loc} in {nf} tiles (at most {TP6_MAX_TILES}, each a multiple of 16)"
        widths = {"att": f"head size {s}, d_maa {d_maa}, d_dec {d_dec}",
                  "att5": f"head size {s}, {n_mix} mixes",
                  "att7": f"head size {s}, d_lora {d_lora}", "att4": "no heads",
                  "ffn": tiles, "ffn7": tiles}[kind]
        raise ValueError(f"{name} cannot take these widths: C={c}, C/tp={c_loc}, {widths}")
    bar_off, ring_off, stage, stages = _ring(plan_off, piece)
    plan = TP6StreamPlan(kind, form, c, c_loc, f_loc, nf, d_maa, d_dec, head_size, blocks,
                         act_off, bar_off, ring_off, stage, stages, ring_off + stages * stage, 0,
                         n_mix if kind == "att5" else 0, d_lora if kind == "att7" else 0)
    plan = dataclasses.replace(plan, vec_rows=min(stage // (4 * c), len(plan.vecs)),
                               l2_runs=min(stage // _lora2_run(s, d_lora, form), 4)
                               if kind == "att7" else 0)
    if (stages < STREAM_MIN_STAGES or plan.vec_rows < 2
            or _cdiv(len(plan.vecs), plan.vec_rows) > stages or plan.head_pieces > stages):
        raise ValueError(f"{name}'s ring holds {stages} stages of {stage} bytes at these widths "
                         f"({plan.vec_rows} vector rows a piece); it needs {STREAM_MIN_STAGES} "
                         "stages of two vector rows, phase A's vector pieces and a head's "
                         "pieces at once")
    return plan


def tp_v6_kernel_plan(form: str, kind: str, c: int, c_loc: int, f_loc: int, nf: int, d_maa: int,
                      d_dec: int, head_size: int, blocks: int, block: int, n_mix: int = 0,
                      d_lora: int = 0) -> tuple:
    """The kernel's own stream plan (the C entries ``rwkv_tp_v6_plan``, K10's
    ``rwkv_tp_v7_plan``, K14's ``rwkv_tp_v4_plan``): (shared bytes, stage
    bytes, stages, block `block`'s pieces of a grid of `blocks`, the
    kernel's static shared bytes, vector rows a piece; K10: lora2 runs a
    piece)."""
    if kind == "att4":
        fn = _cuda.library("tp_v45").rwkv_tp_v4_plan
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * 6)()
        _cuda.check("tp_v45", "rwkv_tp_v4_plan",
                    fn(FORMS.index(form), c, c_loc, blocks, block, out))
        return tuple(out)
    if kind == "att7":
        fn = _cuda.library("tp_v7").rwkv_tp_v7_plan
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * 7)()
        _cuda.check("tp_v7", "rwkv_tp_v7_plan",
                    fn(FORMS.index(form), c, c_loc, head_size, d_lora, blocks, block, out))
        return tuple(out)
    fn = _cuda.library("tp_v6").rwkv_tp_v6_plan
    fn.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 6)()
    k = {"att": 0, "ffn": 1, "ffn7": 4}.get(kind, 2 if n_mix == 3 else 3)
    _cuda.check("tp_v6", "rwkv_tp_v6_plan",
                fn(FORMS.index(form), k, c, c_loc, f_loc, nf, head_size, d_maa, d_dec, blocks,
                   block, out))
    return tuple(out)


def tp_plan_want(plan: TP6StreamPlan, block: int) -> tuple:
    """What ``tp_v6_kernel_plan`` must return for `plan`'s block `block`."""
    want = (plan.smem_bytes, plan.stage_bytes, plan.n_stages, plan.layer_pieces(block),
            TP6_STATIC_SMEM, plan.vec_rows)
    return want + ((plan.l2_runs,) if plan.kind == "att7" else ())


def _tp6_dims(pack: dict, cfg) -> tuple:
    """(c, c_loc, f_loc, nf, d_maa, d_dec, head size) of a shard pack (v4 /
    v5 / v7: no maa / decay LoRA)."""
    return (cfg.n_embed, pack["c_loc"], pack["f_dim"] // pack["tp"], pack["nf"],
            pack.get("d_maa", 0), pack.get("d_dec", 0), cfg.head_size)


def _plan_kind(pack: dict, kind: str) -> str:
    """The plan kind of layer kernel `kind` ("att" or "ffn") on the pack's
    version: K12 / K13 ("att", "ffn"; v4 / v5 "ffn", K13's MIX45 form), K15
    ("att5"), K10 / K11 ("att7", "ffn7"), K14 ("att4")."""
    v = pack["version"]
    if kind == "ffn":
        return "ffn7" if v == 7 else "ffn"
    return {7: "att7", 6: "att", 5: "att5", 4: "att4"}[v]


def tp_pack_plan(pack: dict, kind: str, cfg, blocks: int) -> TP6StreamPlan:
    """The stream plan of layer kernel `kind` ("att" or "ffn") on a shard
    pack of any version."""
    pk = _plan_kind(pack, kind)
    return tp_v6_stream_plan(pack["form"], *_tp6_dims(pack, cfg), blocks, pk,
                             n_mix=pack.get("n_mix", 0) if pk == "att5" else 0,
                             d_lora=pack.get("d_lora", 0) if pk == "att7" else 0)


def _tp6_plan_check(pack: dict, kind: str, cfg, grid: int) -> None:
    """Raises where the kernel's own plan on a grid of `grid` blocks (its
    first and last block) differs from ``tp_v6_stream_plan``: the producer
    and the consumers would walk different pieces."""
    plan = tp_pack_plan(pack, kind, cfg, grid)
    for b in sorted({0, grid - 1}):
        want = tp_plan_want(plan, b)
        got = tp_v6_kernel_plan(pack["form"], plan.kind, *_tp6_dims(pack, cfg), grid, b,
                                n_mix=plan.n_mix, d_lora=plan.d_lora)
        if got != want:
            raise RuntimeError(f"{TP_KERNEL[plan.kind]}'s plan {got} differs from "
                               f"tp_v6_stream_plan's {want} (block {b} of {grid})")


# -- kernels K10-K15 ----------------------------------------------------------------


def _lib_entry(kind: str, pack: dict) -> tuple:
    """(library, C entry) of layer kernel `kind` ("att" or "ffn") for the
    pack's version and form: every FFN and v5's attention (K15, a form of
    K12's kernel) in ``tp_v6``, v4 / v5 on K13's MIX45 instances, v7's
    attention in ``tp_v7``, v4's in ``tp_v45``."""
    v, sfx = pack["version"], _SUFFIX[pack["form"]]
    if kind == "ffn":
        return "tp_v6", f"rwkv_tp_v{45 if v in (4, 5) else v}_ffn" + sfx
    return {7: "tp_v7", 4: "tp_v45"}.get(v, "tp_v6"), f"rwkv_tp_v{v}_att" + sfx


def _layer_ptrs(pack: dict, l: int, names) -> list:
    """Device addresses of layer l of the named shard tensors (0 for a
    scale the bf16 form does not have), cached in the pack: they never
    change."""
    cache = pack.setdefault("_ptrs", {})
    key = (l, names)
    if key not in cache:
        cache[key] = [0 if pack.get(n) is None else pack[n][l].data_ptr() for n in names]
    return cache[key]


def _f32(t, dev):
    return t.to(dev, torch.float32).contiguous()


def _out(out: Optional[dict], key: str, shape, dev):
    t = None if out is None else out.get(key)
    return torch.empty(shape, dtype=torch.float32, device=dev) if t is None else t


_ATT7_MATS = ("rkv", "rkv_d", "lora1", "lora1_d", "lora2", "lora2_d", "out", "out_d",
              "rvecs", "lvecs")
_FFN7_MATS = ("fk", "fk_d", "fv", "fv_d", "rvecs")
_ATT6_MATS = ("rkvg", "rkvg_d", "maa1", "maa1_d", "dw1", "dw1_d", "dw2", "dw2_d", "out",
              "out_d", "maa2", "rvecs", "lvecs")
_FFN6_MATS = ("fr", "fr_d", "fk", "fk_d", "fv", "fv_d", "rvecs")
_ATT5_MATS = ("rkvg", "rkvg_d", "out", "out_d", "rvecs", "lvecs")
_ATT4_MATS = ("rkv", "rkv_d", "out", "out_d", "rvecs", "lvecs")


def tp_att_layer(pack: dict, l: int, x, att_xx, heads, v_first, first: bool, cfg,
                 out: Optional[dict] = None):
    """Layer l's v7 attention on one shard (see ``tp_att_layer_ref``). A
    CUDA pack launches kernel K10 once, writing into the tensors of `out`
    (keys "part", "att_xx", "heads"; allocated where missing); a CPU pack
    takes the plain version. v_first: written by the kernel when `first`,
    read otherwise. The inputs are not modified."""
    if pack["rvecs"].device.type == "cpu":
        return tp_att_layer_ref(pack, l, x, att_xx, heads, v_first, first, cfg)
    grid = tp6_grid(pack, "att", cfg)
    res = tp7_att_launch(tp6_function(pack, "att"), pack, l, x, att_xx, heads, v_first, first,
                         cfg, grid, out)
    _count(tp_att_layer, pack)
    return res


tp_att_layer.launches = 0
tp_att_layer.launches_by_form = dict.fromkeys(FORMS, 0)


def tp_ffn_layer(pack: dict, l: int, x, ffn_xx, cfg, out: Optional[dict] = None):
    """Layer l's v7 FFN on one shard (see ``tp_ffn_layer_ref``). A CUDA
    pack launches kernel K11 once (`out` keys "part", "ffn_xx"); a CPU pack
    takes the plain version."""
    if pack["rvecs"].device.type == "cpu":
        return tp_ffn_layer_ref(pack, l, x, ffn_xx, cfg)
    grid = tp6_grid(pack, "ffn", cfg)
    res = tp7_ffn_launch(tp6_function(pack, "ffn"), pack, l, x, ffn_xx, cfg, grid, out)
    _count(tp_ffn_layer, pack)
    return res


tp_ffn_layer.launches = 0
tp_ffn_layer.launches_by_form = dict.fromkeys(FORMS, 0)


def tp6_grid(pack: dict, kind: str, cfg) -> int:
    """The grid of a stream kernel for a shard pack -- `kind` "att": K10,
    K12, K15 or K14 by the pack's version; "ffn": K11 or K13 --, its own
    plan held to ``tp_v6_stream_plan`` on it at the pack's first launch."""
    key = "_plan_" + kind
    if key not in pack:
        c, c_loc, f_loc, nf, dm, dd, s = _tp6_dims(pack, cfg)
        dims = {"att": (c, c_loc, s, dm, dd), "ffn": (c, f_loc, nf), "ffn7": (c, f_loc, nf),
                "att5": (c, c_loc, s, int(pack.get("n_mix") == 4)),
                "att7": (c, c_loc, s, pack.get("d_lora", 0)),
                "att4": (c, c_loc)}[_plan_kind(pack, kind)]
        lib, name = _lib_entry(kind, pack)
        grid = _grid_blocks(lib, name + "_grid", *dims)
        _tp6_plan_check(pack, kind, cfg, grid)
        pack[key] = grid
    return pack[key]


# argument counts (pointers, ints with the grid) of the stream kernels' C
# entries, by plan kind: K12, K13, K15, K10, K11, K14
TP_ARGS = {"att": (20, 6), "ffn": (13, 5), "att5": (13, 5), "att7": (18, 6), "ffn7": (10, 4),
           "att4": (17, 3)}


def tp6_function(pack: dict, kind: str):
    """The C launch entry of a stream kernel for the pack's form: `kind`
    "att" K10, K12, K15 or K14 by the pack's version; "ffn" K11 or K13 (a
    v4 / v5 pack: its MIX45 form)."""
    lib, name = _lib_entry(kind, pack)
    return _cuda.function(lib, name, *TP_ARGS[_plan_kind(pack, kind)])


def tp7_att_launch(fn, pack: dict, l: int, x, att_xx, heads, v_first, first: bool, cfg,
                   grid: int, out: Optional[dict] = None):
    """One launch of K10's C entry `fn` on a CUDA shard pack over `grid`
    blocks (`out` keys "part", "att_xx", "heads", "scratch"); v_first
    written when `first` (a new tensor), read otherwise. Returns (part,
    att_xx, heads, v_first)."""
    dev = pack["rvecs"].device
    c, s = cfg.n_embed, cfg.head_size
    c_loc, d = pack["c_loc"], pack["d_lora"]
    x, att_xx, heads = _f32(x, dev), _f32(att_xx, dev), _f32(heads, dev)
    if heads.shape != (c_loc // s, s, s):
        raise ValueError(f"heads {tuple(heads.shape)} != {(c_loc // s, s, s)}")
    vf = torch.empty((c_loc,), dtype=torch.float32, device=dev) if first else _f32(v_first, dev)
    part = _out(out, "part", (c,), dev)
    axx = _out(out, "att_xx", (c,), dev)
    new_heads = _out(out, "heads", heads.shape, dev)
    scratch = _out(out, "scratch", (4 * c_loc + 4 * d + TP7_ATT_AMAX,), dev)
    ptrs = [x.data_ptr(), att_xx.data_ptr(), heads.data_ptr(), vf.data_ptr()]
    ptrs += _layer_ptrs(pack, l, _ATT7_MATS)
    ptrs += [part.data_ptr(), axx.data_ptr(), new_heads.data_ptr(), scratch.data_ptr()]
    code = fn(*ptrs, c, c_loc, s, d, int(first), grid, _cuda.stream_ptr(dev))
    if code:
        _cuda.check("tp_v7", _lib_entry("att", pack)[1], code)
    return part, axx, new_heads, vf


def tp7_ffn_launch(fn, pack: dict, l: int, x, ffn_xx, cfg, grid: int,
                   out: Optional[dict] = None):
    """One launch of K11's C entry `fn` on a CUDA v7 shard pack over `grid`
    blocks (`out` keys "part", "ffn_xx", "scratch"); returns (part,
    ffn_xx)."""
    dev = pack["rvecs"].device
    c = cfg.n_embed
    f_loc = pack["f_dim"] // pack["tp"]
    x, ffn_xx = _f32(x, dev), _f32(ffn_xx, dev)
    part = _out(out, "part", (c,), dev)
    fxx = _out(out, "ffn_xx", (c,), dev)
    scratch = _out(out, "scratch", (f_loc,), dev)
    ptrs = [x.data_ptr(), ffn_xx.data_ptr()] + _layer_ptrs(pack, l, _FFN7_MATS)
    ptrs += [part.data_ptr(), fxx.data_ptr(), scratch.data_ptr()]
    code = fn(*ptrs, c, f_loc, pack["nf"], grid, _cuda.stream_ptr(dev))
    if code:
        _cuda.check("tp_v6", _lib_entry("ffn", pack)[1], code)
    return part, fxx


def tp4_att_launch(fn, pack: dict, l: int, x, att_xx, aa, bb, pp, cfg, grid: int,
                   out: Optional[dict] = None):
    """One launch of K14's C entry `fn` on a CUDA v4 shard pack over `grid`
    blocks (`out` keys "part", "att_xx", "aa", "bb", "pp", "scratch"); aa,
    bb, pp: the shard's channels of the state (views at its channel offset
    stay views). Returns (part, att_xx, aa, bb, pp)."""
    dev = pack["rvecs"].device
    c, c_loc = cfg.n_embed, pack["c_loc"]
    x, att_xx = _f32(x, dev), _f32(att_xx, dev)
    cols = [_f32(t, dev) for t in (aa, bb, pp)]
    if any(t.shape != (c_loc,) for t in cols):
        raise ValueError(f"aa / bb / pp {[tuple(t.shape) for t in cols]} != {(c_loc,)}")
    part = _out(out, "part", (c,), dev)
    axx = _out(out, "att_xx", (c,), dev)
    new = [_out(out, k, (c_loc,), dev) for k in ("aa", "bb", "pp")]
    scratch = _out(out, "scratch", (3 * c_loc,), dev)
    ptrs = [x.data_ptr(), att_xx.data_ptr()] + [t.data_ptr() for t in cols]
    ptrs += _layer_ptrs(pack, l, _ATT4_MATS)
    ptrs += [part.data_ptr(), axx.data_ptr()] + [t.data_ptr() for t in new] + [scratch.data_ptr()]
    code = fn(*ptrs, c, c_loc, grid, _cuda.stream_ptr(dev))
    if code:
        _cuda.check("tp_v45", _lib_entry("att", pack)[1], code)
    return (part, axx, *new)


def tp5_att_launch(fn, pack: dict, l: int, x, att_xx, heads, cfg, grid: int,
                   out: Optional[dict] = None):
    """One launch of K15's C entry `fn` on a CUDA v5.1 / v5.2 shard pack
    over `grid` blocks (`out` keys "part", "att_xx", "heads", "scratch");
    returns (part, att_xx, heads)."""
    dev = pack["rvecs"].device
    c, s, c_loc = cfg.n_embed, cfg.head_size, pack["c_loc"]
    x, att_xx, heads = _f32(x, dev), _f32(att_xx, dev), _f32(heads, dev)
    if heads.shape != (c_loc // s, s, s):
        raise ValueError(f"heads {tuple(heads.shape)} != {(c_loc // s, s, s)}")
    part = _out(out, "part", (c,), dev)
    axx = _out(out, "att_xx", (c,), dev)
    new_heads = _out(out, "heads", heads.shape, dev)
    scratch = _out(out, "scratch", (5 * c_loc + TP6_ATT_AMAX,), dev)
    ptrs = [x.data_ptr(), att_xx.data_ptr(), heads.data_ptr()]
    ptrs += _layer_ptrs(pack, l, _ATT5_MATS)
    ptrs += [part.data_ptr(), axx.data_ptr(), new_heads.data_ptr(), scratch.data_ptr()]
    code = fn(*ptrs, c, c_loc, s, int(pack["n_mix"] == 4), grid, _cuda.stream_ptr(dev))
    if code:
        _cuda.check("tp_v6", _lib_entry("att", pack)[1], code)
    return part, axx, new_heads


def tp6_att_launch(fn, pack: dict, l: int, x, att_xx, heads, cfg, grid: int,
                   out: Optional[dict] = None):
    """One launch of K12's C entry `fn` on a CUDA shard pack over `grid`
    blocks (`out` keys "part", "att_xx", "heads", "scratch"); returns
    (part, att_xx, heads)."""
    dev = pack["rvecs"].device
    c, s = cfg.n_embed, cfg.head_size
    c_loc, dm, dd = pack["c_loc"], pack["d_maa"], pack["d_dec"]
    x, att_xx, heads = _f32(x, dev), _f32(att_xx, dev), _f32(heads, dev)
    if heads.shape != (c_loc // s, s, s):
        raise ValueError(f"heads {tuple(heads.shape)} != {(c_loc // s, s, s)}")
    part = _out(out, "part", (c,), dev)
    axx = _out(out, "att_xx", (c,), dev)
    new_heads = _out(out, "heads", heads.shape, dev)
    scratch = _out(out, "scratch", (5 * dm + 5 * c + 5 * c_loc + dd + TP6_ATT_AMAX,), dev)
    ptrs = [x.data_ptr(), att_xx.data_ptr(), heads.data_ptr()]
    ptrs += _layer_ptrs(pack, l, _ATT6_MATS)
    ptrs += [part.data_ptr(), axx.data_ptr(), new_heads.data_ptr(), scratch.data_ptr()]
    code = fn(*ptrs, c, c_loc, s, dm, dd, grid, _cuda.stream_ptr(dev))
    if code:
        _cuda.check("tp_v6", _lib_entry("att", pack)[1], code)
    return part, axx, new_heads


def tp_att_layer_v6(pack: dict, l: int, x, att_xx, heads, cfg, out: Optional[dict] = None):
    """Layer l's v6 attention on one shard (see ``tp_att_layer_v6_ref``). A
    CUDA pack launches kernel K12 once (`out` keys "part", "att_xx",
    "heads"); a CPU pack takes the plain version."""
    if pack["rvecs"].device.type == "cpu":
        return tp_att_layer_v6_ref(pack, l, x, att_xx, heads, cfg)
    grid = tp6_grid(pack, "att", cfg)
    res = tp6_att_launch(tp6_function(pack, "att"), pack, l, x, att_xx, heads, cfg, grid, out)
    _count(tp_att_layer_v6, pack)
    return res


tp_att_layer_v6.launches = 0
tp_att_layer_v6.launches_by_form = dict.fromkeys(FORMS, 0)


def tp_ffn_layer_v6(pack: dict, l: int, x, ffn_xx, cfg, out: Optional[dict] = None):
    """Layer l's gated v6 FFN on one shard (see ``tp_ffn_layer_v6_ref``). A
    CUDA pack launches kernel K13 once (`out` keys "part", "rg",
    "ffn_xx"); a CPU pack takes the plain version."""
    if pack["rvecs"].device.type == "cpu":
        return tp_ffn_layer_v6_ref(pack, l, x, ffn_xx, cfg)
    return _gated_ffn(tp_ffn_layer_v6, pack, l, x, ffn_xx, cfg, out)


tp_ffn_layer_v6.launches = 0
tp_ffn_layer_v6.launches_by_form = dict.fromkeys(FORMS, 0)


def tp_ffn_layer_v45(pack: dict, l: int, x, ffn_xx, cfg, out: Optional[dict] = None):
    """Layer l's gated v4 / v5 FFN on one shard (``tp_ffn_layer_v6_ref``
    with mix45). A CUDA pack launches K13's MIX45 form once (`out` as
    ``tp_ffn_layer_v6``); a CPU pack takes the plain version."""
    if pack["rvecs"].device.type == "cpu":
        return _ffn45_ref(pack, l, x, ffn_xx, cfg)
    return _gated_ffn(tp_ffn_layer_v45, pack, l, x, ffn_xx, cfg, out)


tp_ffn_layer_v45.launches = 0
tp_ffn_layer_v45.launches_by_form = dict.fromkeys(FORMS, 0)


def tp6_ffn_launch(fn, pack: dict, l: int, x, ffn_xx, cfg, grid: int,
                   out: Optional[dict] = None):
    """One launch of K13's C entry `fn` (v6, or its MIX45 form on a v4 / v5
    pack) over `grid` blocks (`out` keys "part", "rg", "ffn_xx",
    "scratch"); returns (part, rg, ffn_xx)."""
    dev = pack["rvecs"].device
    c, c_loc = cfg.n_embed, pack["c_loc"]
    f_loc = pack["f_dim"] // pack["tp"]
    x, ffn_xx = _f32(x, dev), _f32(ffn_xx, dev)
    part = _out(out, "part", (c,), dev)
    rg = _out(out, "rg", (c_loc,), dev)
    fxx = _out(out, "ffn_xx", (c,), dev)
    scratch = _out(out, "scratch", (f_loc,), dev)
    ptrs = [x.data_ptr(), ffn_xx.data_ptr()] + _layer_ptrs(pack, l, _FFN6_MATS)
    ptrs += [part.data_ptr(), rg.data_ptr(), fxx.data_ptr(), scratch.data_ptr()]
    code = fn(*ptrs, c, c_loc, f_loc, pack["nf"], grid, _cuda.stream_ptr(dev))
    if code:
        _cuda.check("tp_v6", _lib_entry("ffn", pack)[1], code)
    return part, rg, fxx


def _gated_ffn(counter, pack: dict, l: int, x, ffn_xx, cfg, out: Optional[dict]):
    """One launch of K13 (v6, or its MIX45 form on a v4 / v5 pack),
    counted in `counter`."""
    grid = tp6_grid(pack, "ffn", cfg)
    res = tp6_ffn_launch(tp6_function(pack, "ffn"), pack, l, x, ffn_xx, cfg, grid, out)
    _count(counter, pack)
    return res


def tp_att_layer_v5(pack: dict, l: int, x, att_xx, heads, cfg, out: Optional[dict] = None):
    """Layer l's v5.1 / v5.2 attention on one shard (see
    ``tp_att_layer_v5_ref``). A CUDA pack launches kernel K15 once (`out`
    keys "part", "att_xx", "heads"); a CPU pack takes the plain version."""
    if pack["rvecs"].device.type == "cpu":
        return tp_att_layer_v5_ref(pack, l, x, att_xx, heads, cfg)
    grid = tp6_grid(pack, "att", cfg)
    res = tp5_att_launch(tp6_function(pack, "att"), pack, l, x, att_xx, heads, cfg, grid, out)
    _count(tp_att_layer_v5, pack)
    return res


tp_att_layer_v5.launches = 0
tp_att_layer_v5.launches_by_form = dict.fromkeys(FORMS, 0)


def tp_att_layer_v4(pack: dict, l: int, x, att_xx, aa, bb, pp, cfg,
                    out: Optional[dict] = None):
    """Layer l's v4 attention on one shard (see ``tp_att_layer_v4_ref``).
    A CUDA pack launches kernel K14 once (`out` keys "part", "att_xx",
    "aa", "bb", "pp"); a CPU pack takes the plain version."""
    if pack["rvecs"].device.type == "cpu":
        return tp_att_layer_v4_ref(pack, l, x, att_xx, aa, bb, pp, cfg)
    grid = tp6_grid(pack, "att", cfg)
    res = tp4_att_launch(tp6_function(pack, "att"), pack, l, x, att_xx, aa, bb, pp, cfg, grid,
                         out)
    _count(tp_att_layer_v4, pack)
    return res


tp_att_layer_v4.launches = 0
tp_att_layer_v4.launches_by_form = dict.fromkeys(FORMS, 0)


# -- the step --------------------------------------------------------------------


def all_reduce(parts: list, devices) -> list:
    """JAX's ``lax.psum`` over the shards: the sum of `parts` (one tensor
    per shard, on ``devices[i]``) in shard order on shard 0's device,
    then on each shard's device (the same tensor where it is shard 0's)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return [acc if torch.device(dev) == acc.device else acc.to(dev) for dev in devices]


def tp_decode_step(packs: list, state: dict, x0: torch.Tensor, cfg, plain: bool = False):
    """One v7 decode step of all layers at B=1 over the shards of `packs`
    (``build_mega_pack_tp``; JAX's ``tp_decode_step``). `state` holds one
    sequence (``att_xx`` / ``ffn_xx`` ``[L, C]``, ``heads`` ``[L, H, S, S]``,
    on shard 0's device), x0 [C] the embedded, ln0-normalized token.
    Returns (x [C] before ln_out, new state on shard 0's device). The
    shards run in turn (K10 / K11 on CUDA packs; plain=True: their plain
    versions on any device), joined by ``all_reduce`` after each attention
    and FFN; v_first stays per shard."""
    fns = (tp_att_layer_ref, tp_ffn_layer_ref) if plain else (tp_att_layer, tp_ffn_layer)
    return _tp_step(packs, state, x0, cfg, _v7_layer, fns, plain)


def tp_decode_step_v6(packs: list, state: dict, x0: torch.Tensor, cfg, plain: bool = False):
    """One v6 decode step over the shards of `packs`
    (``build_mega_pack_tp_v6``; JAX's ``tp_decode_step_v6``), as
    ``tp_decode_step``; the FFN gate rows of each shard are gathered
    before ``x += gate * all_reduce(fv partials)``."""
    fns = ((tp_att_layer_v6_ref, tp_ffn_layer_v6_ref) if plain
           else (tp_att_layer_v6, tp_ffn_layer_v6))
    return _tp_step(packs, state, x0, cfg, _v6_layer, fns, plain)


def tp_decode_step_v5(packs: list, state: dict, x0: torch.Tensor, cfg, plain: bool = False):
    """One v5.1 / v5.2 decode step over the shards of `packs`
    (``build_mega_pack_tp_v5``; JAX's ``tp_decode_step_v5``), as
    ``tp_decode_step_v6``: K15, then K13's MIX45 form (plain=True: their
    plain versions)."""
    fns = ((tp_att_layer_v5_ref, _ffn45_ref) if plain
           else (tp_att_layer_v5, tp_ffn_layer_v45))
    return _tp_step(packs, state, x0, cfg, _v45_layer, fns, plain)


def tp_decode_step_v4(packs: list, state: dict, x0: torch.Tensor, cfg, plain: bool = False):
    """One v4 decode step over the shards of `packs`
    (``build_mega_pack_tp_v4``; JAX's ``tp_decode_step_v4``): `state`
    holds ``att_xx`` / ``ffn_xx`` / ``aa`` / ``bb`` / ``pp`` ``[L, C]``, of
    which shard i owns channels ``[i C/tp, (i+1) C/tp)`` of aa, bb and pp;
    K14, then K13's MIX45 form (plain=True: their plain versions)."""
    fns = ((tp_att_layer_v4_ref, _ffn45_ref) if plain
           else (tp_att_layer_v4, tp_ffn_layer_v45))
    return _tp_step(packs, state, x0, cfg, _v45_layer, fns, plain)


def _tp_step(packs: list, state: dict, x0, cfg, layer_fn, fns, plain: bool):
    devs = [p["rvecs"].device for p in packs]
    home = state["att_xx"].device
    new = {k: torch.empty_like(v) for k, v in state.items()}
    xs = [x0.float().to(d) for d in devs]
    v_first = [None] * len(packs)
    for l in range(cfg.n_layer):
        xs = layer_fn(packs, l, xs, state, new, v_first, devs, home, cfg, fns, plain)
    return xs[0].to(home), new


def _shard_rows(t: torch.Tensor, l: int, i: int, n: int) -> torch.Tensor:
    """Shard i's rows [i n, (i+1) n) of layer l of a state array: its
    heads of ``heads`` [L, H, S, S], its channels of v4's aa / bb / pp."""
    return t[l, i * n : (i + 1) * n]


def _keep(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst := src unless the layer call already wrote it there."""
    if src is not dst:
        dst.copy_(src)


def _call(fn, plain: bool, dev, home, *args, **views):
    """A layer call; a kernel wrapper whose shard lies on the state's
    device writes into `views` of the new state."""
    if plain:
        return fn(*args)
    return fn(*args, out=views if dev == home else {})


def _att_shards(packs, l, xs, state, new, devs, home, cfg, fn, plain, extra, keys=("heads",)):
    """Every shard's attention of layer l, with its part of the sharded
    state `keys` into its slice of `new` and shard 0's att_xx into `new`;
    returns the results (the sharded state follows att_xx in each)."""
    c_loc = packs[0]["c_loc"]
    rows = {k: c_loc // cfg.head_size if k == "heads" else c_loc for k in keys}
    res = []
    for i, (pk, dev) in enumerate(zip(packs, devs)):
        views = {k: _shard_rows(new[k], l, i, rows[k]) for k in keys}
        ins = [_shard_rows(state[k], l, i, rows[k]).to(dev) for k in keys]
        r = _call(fn, plain, dev, home, pk, l, xs[i], state["att_xx"][l].to(dev), *ins, *extra[i],
                  cfg, **views, **({"att_xx": new["att_xx"][l]} if i == 0 else {}))
        for j, k in enumerate(keys):
            _keep(views[k], r[2 + j])
        if i == 0:
            _keep(new["att_xx"][l], r[1])
        res.append(r)
    return res


def _ffn_shards(packs, l, xs, state, new, devs, home, cfg, fn, plain):
    """Every shard's FFN of layer l, shard 0's ffn_xx into `new`; returns
    the results."""
    res = []
    for i, (pk, dev) in enumerate(zip(packs, devs)):
        views = {"ffn_xx": new["ffn_xx"][l]} if i == 0 else {}
        r = _call(fn, plain, dev, home, pk, l, xs[i], state["ffn_xx"][l].to(dev), cfg, **views)
        if i == 0:
            _keep(new["ffn_xx"][l], r[-1])
        res.append(r)
    return res


def _v7_layer(packs, l, xs, state, new, v_first, devs, home, cfg, fns, plain):
    extra = [(v_first[i], l == 0) for i in range(len(packs))]
    res = _att_shards(packs, l, xs, state, new, devs, home, cfg, fns[0], plain, extra)
    for i, r in enumerate(res):
        v_first[i] = r[3]
    xs = [x + a for x, a in zip(xs, all_reduce([r[0] for r in res], devs))]
    res = _ffn_shards(packs, l, xs, state, new, devs, home, cfg, fns[1], plain)
    return [x + f for x, f in zip(xs, all_reduce([r[0] for r in res], devs))]


def _v6_layer(packs, l, xs, state, new, v_first, devs, home, cfg, fns, plain):
    res = _att_shards(packs, l, xs, state, new, devs, home, cfg, fns[0], plain,
                      [()] * len(packs))
    xs = [x + a for x, a in zip(xs, all_reduce([r[0] for r in res], devs))]
    return _gated_ffn_shards(packs, l, xs, state, new, devs, home, cfg, fns[1], plain)


def _v45_layer(packs, l, xs, state, new, v_first, devs, home, cfg, fns, plain):
    keys = ("aa", "bb", "pp") if cfg.version_major == 4 else ("heads",)
    res = _att_shards(packs, l, xs, state, new, devs, home, cfg, fns[0], plain,
                      [()] * len(packs), keys)
    xs = [x + a for x, a in zip(xs, all_reduce([r[0] for r in res], devs))]
    return _gated_ffn_shards(packs, l, xs, state, new, devs, home, cfg, fns[1], plain)


def _gated_ffn_shards(packs, l, xs, state, new, devs, home, cfg, fn, plain):
    """The gated FFN of v6, v5 and v4: every shard's, its gate rows
    gathered in shard order (JAX's all_gather), then x += gate *
    all_reduce(fv partials)."""
    res = _ffn_shards(packs, l, xs, state, new, devs, home, cfg, fn, plain)
    rg = torch.cat([r[1].to(devs[0]) for r in res])
    ffn = all_reduce([r[0] for r in res], devs)
    return [x + rg.to(dev) * f for x, f, dev in zip(xs, ffn, devs)]

"""Whole-model decode steps: v7 at B=1 with the LM head (kernel K3) and
for B sequences without it (kernel K4), and v6, v5 and v4 at B=1 with the
LM head (kernels K6, K7 and K8), w8a8, w4a8 or bf16.

Ports the quantized parts of ``rwkv_tpu.ops.megakernel``: ``_quantize_rows``
(int8 and int4), ``build_mega_pack(quant=True, head=True, w4=...)``,
``v7_decode_megakernel`` (B=1) and, as one function, the three batched
kernels ``v7_decode_megakernel_batched``, ``_batched_packed`` and
``_tiled``. The TPU kernels' VMEM layouts (``[C, 1]`` columns, rowified
packs, head-pair and lane-packed states, split-half nibbles, phase tiles)
are not carried over: the port keeps the serving state layout (heads
``[..., L, H, S_i, S_j]``) and packs each layer's six matrices, their row
scales and its vectors into three flat buffers (``device_pack``). Under
w4a8 the four big matrices (rkv, out, fk, fv) hold int4 codes, two a byte
(``pack_int4``); the LoRA matrices and the head stay int8, as in JAX.

``v7_decode_step`` runs the hand-written cooperative CUDA kernel
``csrc/v7_decode.cu`` (K3) and ``v7_decode_batched`` runs
``csrc/v7_decode_batched.cu`` (K4) on CUDA tensors, counting launches in
their ``.launches``; on CPU tensors they take the plain PyTorch versions
``v7_decode_step_ref`` / ``v7_decode_batched_ref``, which share one layer
loop. Each matvec quantizes its input vector as a whole (amax over all of
it), per sequence, as the TPU kernels do.

The four ``build_mega_pack*`` also take ``quant=False``, the JAX package's
bf16 pack: the
matrices and the head (``headbf16``) rounded to bf16 from the f32 dense
weights, no scales, vectors (and v6's maa2) in f32. The pack records its
weight form in ``pack["form"]`` (``FORMS``: "i8", "i4" or "bf16"); in the
bf16 form each matvec is an f32 product of the f32 input and the bf16 rows
widened to f32 (JAX's ``matv`` with ``quant=False``), and the kernels run
their bf16 form (``csrc/common.cuh``), counted per form in
``.launches_by_form`` beside ``.launches``.

The v6 part ports ``build_mega_pack_v6(quant=True, head=True, w4=...)``
and, as one function, ``v6_decode_megakernel`` and
``v6_decode_megakernel_tiled`` (the TPU splits them only by VMEM size):
``v6_decode_step`` runs ``csrc/v6_decode.cu`` (K6) on CUDA tensors and
``v6_decode_step_ref`` on CPU tensors. Its pack holds eight matrices
(rkvg = r, k, v, g; maa1; dw1; dw2; out; fk; fv; fr), the five big ones
int4 under w4a8, the LoRA ones int8 in both formats, and the maa2
up-projections in float32 (int8, bf16 or TF32 there drift far from the
per-op path).

The v5 and v4 parts port ``build_mega_pack_v5`` / ``build_mega_pack_v4``
(``quant=True, head=True, w4=...``) and, as one function each, the
whole-layer and tiled kernels ``v5_decode_megakernel`` /
``v5_decode_megakernel_tiled`` and ``v4_decode_megakernel`` /
``v4_decode_megakernel_tiled``: ``v5_decode_step`` runs
``csrc/v5_decode.cu`` (K7) and ``v4_decode_step`` runs
``csrc/v4_decode.cu`` (K8) on CUDA tensors, ``v5_decode_step_ref`` /
``v4_decode_step_ref`` on CPU tensors. Their packs hold five matrices
(att = the fused r, k, v(, g) rows; out; fk; fv; fr), all five int4 under
w4a8, and per layer the vector rows ``V45_VEC_KEYS`` followed by the FFN
mixes, the static decay and bonus (v5.1's per-head scalars broadcast over
S), v5's ``ln_x`` and the attention mixes (k, v, r(, g)).

``save_mega_pack`` / ``load_mega_pack`` keep a host pack of any version
and form in one .npz file (the JAX package's pack cache, in the port's own
layout; ``ServingModel(mega_pack_cache=...)``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rwkv_tpu_torch.ops import _cuda
from rwkv_tpu_torch.ops.kernels import (
    int_dot_plain, pack_int4, quantize_act_plain, quantize_rows_np, unpack_int4,
)
from rwkv_tpu_torch.ops.parity import Weight, layer_norm

# per-layer vector rows of the flat pack; the kernels' VecRow enum matches
VEC_KEYS = (
    "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
    "att.w0", "att.a0", "att.v0", "att.k_k", "att.k_a",
    "att.ln_x.weight", "att.ln_x.bias", "ffn.x_k",
)
MAT_KEYS = ("rkv", "lora1", "lora2", "out", "fk", "fv")
# the matrices that hold int4 codes under w4a8 (JAX: every mat but the loras)
W4_MATS = ("rkv", "out", "fk", "fv")
_V7_RKV = ("att.receptance.weight", "att.key.weight", "att.value.weight")
_V7_L1 = ("att.w1", "att.a1", "att.g1", "att.v1")
_V7_L2 = ("att.w2", "att.a2", "att.g2", "att.v2")

# v6: matrices in the JAX package's order, those that hold int4 codes under
# w4a8, per-layer vector rows (the K6 VecRow6 enum matches: these, then
# maa5 w, k, v, r, g, then tdecay and tf)
V6_MAT_KEYS = ("rkvg", "maa1", "dw1", "dw2", "out", "fk", "fv", "fr")
V6_W4_MATS = ("rkvg", "out", "fk", "fv", "fr")
V6_VEC_KEYS = (
    "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
    "att.ln_x.weight", "att.ln_x.bias", "att.time_maa_x",
    "ffn.time_maa_k", "ffn.time_maa_r",
)
_V6_RKVG = ("att.receptance.weight", "att.key.weight", "att.value.weight", "att.gate.weight")
_V6_MAA5 = ("w", "k", "v", "r", "g")


def _np(t) -> np.ndarray:
    """A parameter leaf as host float32 numpy; a ``Weight`` leaf of a loaded
    file densified as the JAX package's ``_np_dense`` does (``q * d``, then
    ``+ m``, in float32)."""
    if isinstance(t, Weight):
        t = t.dense()
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _quantize_rows(w, four: bool = False):
    """[L, N, K] f32 -> (int8 codes [L, N, K], row scales [L, N]): scale
    amax/127, or four=True int4 codes in [-7, 7] with scale amax/7 (stored
    one a byte here; ``device_pack`` packs them two a byte)."""
    q, d = quantize_rows_np(_np(w), 7.0 if four else 127.0)
    return torch.from_numpy(q), torch.from_numpy(d)


# weight forms of a pack: int8 codes, int4 codes (the big matrices under
# w4a8) or bf16 values (quant=False)
FORMS = ("i8", "i4", "bf16")


def _form(quant: bool, w4: bool) -> str:
    return "bf16" if not quant else "i4" if w4 else "i8"


def _pack_mats(pack: dict, mats: dict, w4_mats) -> None:
    """The pack's matrices in its form: codes with row scales (``name`` and
    ``name_d``; int4 values for `w4_mats` under "i4"), or bf16 values
    rounded to nearest even from f32 (as ``jnp.asarray(w, jnp.bfloat16)``)."""
    for name, w in mats.items():
        if pack["form"] == "bf16":
            pack[name] = torch.from_numpy(_np(w)).to(torch.bfloat16)
        else:
            pack[name], pack[name + "_d"] = _quantize_rows(w, pack["w4"] and name in w4_mats)


def _attach_head(pack: dict, params: dict) -> None:
    """The LM head in the pack's form (``head8`` int8 codes with ``head_d``
    in both int forms, or ``headbf16``) and ln_out."""
    if pack["form"] == "bf16":
        pack["headbf16"] = torch.from_numpy(_np(params["head"])).to(torch.bfloat16)
    else:
        q, d = _quantize_rows(_np(params["head"])[None])
        pack["head8"], pack["head_d"] = q[0], d[0]
    pack["ln_out.weight"] = torch.from_numpy(_np(params["ln_out"][0]).copy())
    pack["ln_out.bias"] = torch.from_numpy(_np(params["ln_out"][1]).copy())


def build_mega_pack(params: dict, cfg, w4: bool = False, quant: bool = True) -> dict:
    """The decode kernels' parameter pack with the LM head (the JAX
    package's ``build_mega_pack(quant=quant, w4=w4, head=True)``), built on
    the host from the port's parameter tree (dense ``[out, in]`` weights).

    Matrices are codes ``[L, N, K]`` (int8; int4 values for ``W4_MATS``
    when w4) with row scales ``[L, N]``, or with quant=False bf16 values
    ``[L, N, K]``, fused in the TPU kernel's row order (rkv = r, k, v;
    lora1 / lora2 = w, a, g, v); vectors ``[L, C]``; ``coeff`` ``[L, 6, C]``
    (r, w, k, v, a, g); ``r_k`` ``[L, C]``; ``head8`` ``[V, C]`` (int8 in
    both int formats) with ``head_d`` ``[V]``, or ``headbf16``."""
    if cfg.version_major != 7:
        raise NotImplementedError("the decode kernels are RWKV v7 only")
    c = cfg.n_embed
    blocks = [dict(b) for b in params["blocks"]]
    n_layer = len(blocks)
    # layer 0 has no v0/v1/v2; its value residual is selected away (a
    # one-layer model takes their shapes from w0/w1/w2)
    for key, like in (("att.v0", "att.w0"), ("att.v1", "att.w1"), ("att.v2", "att.w2")):
        if key not in blocks[0]:
            blocks[0][key] = np.zeros_like(_np(blocks[1][key] if n_layer > 1 else blocks[0][like]))

    def stack(keys_or_key):
        if isinstance(keys_or_key, tuple):
            return np.stack([np.concatenate([_np(b[k]) for k in keys_or_key]) for b in blocks])
        return np.stack([_np(b[keys_or_key]) for b in blocks])

    form = _form(quant, w4)
    pack = {
        "quant": quant,
        "w4": form == "i4",
        "form": form,
        "d_lora": _np(blocks[-1]["att.w1"]).shape[0],
        "f_dim": _np(blocks[0]["ffn.key.weight"]).shape[0],
    }
    _pack_mats(pack, {
        "rkv": stack(_V7_RKV),
        "lora1": stack(_V7_L1),
        "lora2": stack(_V7_L2),
        "out": stack("att.output.weight"),
        "fk": stack("ffn.key.weight"),
        "fv": stack("ffn.value.weight"),
    }, W4_MATS)
    for key in VEC_KEYS:
        pack[key] = torch.from_numpy(stack(key).reshape(n_layer, c))
    pack["coeff"] = torch.from_numpy(stack("att.x_rwkvag").reshape(n_layer, 6, c))
    pack["r_k"] = torch.from_numpy(stack("att.r_k").reshape(n_layer, c))
    _attach_head(pack, params)
    return pack


def _layout(pack: dict):
    """(matrix keys, the int4 ones under w4, vector rows, blocks of rows
    after them as (key, rows)) of a v7, v6, v5 or v4 pack's flat buffers."""
    version = pack.get("version")
    if version == 6:
        return V6_MAT_KEYS, V6_W4_MATS, V6_VEC_KEYS, (("maa5", 5), ("tdecay", 1), ("tf", 1))
    if version in (4, 5):
        mats = V5_MAT_KEYS if version == 5 else V4_MAT_KEYS
        return mats, mats, V45_VEC_KEYS, _v45_blocks(pack)
    return MAT_KEYS, W4_MATS, VEC_KEYS, (("coeff", 6), ("r_k", 1))


def device_pack(pack: dict, emb: torch.Tensor, ln0, device) -> dict:
    """`pack` on `device` in the kernels' flat layout: ``mats`` int8
    ``[L, per-layer bytes]`` (v7: rkv|lora1|lora2|out|fk|fv; v6:
    ``V6_MAT_KEYS``; v5 / v4: ``V5_MAT_KEYS`` / ``V4_MAT_KEYS``; the int4
    ones packed by ``pack_int4``; in the bf16 form a bf16 buffer ``[L,
    per-layer values]``, which the kernels read as bytes at twice the
    offsets), ``scales`` f32 ``[L, rows]`` in the same order (v7 9C + 4d +
    F rows; none in the bf16 form), ``vecs`` f32 ``[L, n, C]`` (v7: VEC_KEYS,
    the six coeff rows, r_k -- 19; v6: V6_VEC_KEYS, the five maa5 rows,
    tdecay, tf -- 16; v5 / v4: ``_v45_blocks``) and, for v6, ``maa2``
    f32 ``[L, 5C, d_maa]``. The named tensors of `pack` become views into
    these buffers (the int4 ones as packed bytes ``[L, N, K/2]``), so the
    plain versions read the same memory. `emb` (the serving embedding: bf16
    under the int forms, bf16 or f32 under the bf16 form) and `ln0` ride
    along: the kernels embed the tokens themselves."""
    mat_keys, w4_mats, vec_keys, blocks = _layout(pack)
    n_layer = pack[mat_keys[0]].shape[0]
    dev = torch.device(device)
    w4, quant = pack["w4"], pack["form"] != "bf16"
    out = {k: v for k, v in pack.items() if isinstance(v, (bool, int, str))}
    stored = {k: pack_int4(pack[k]) if w4 and k in w4_mats else pack[k] for k in mat_keys}
    mats = torch.cat([stored[k].reshape(n_layer, -1) for k in mat_keys], dim=1).to(dev)
    scales = torch.cat([pack[k + "_d"] for k in mat_keys], dim=1).to(dev) if quant else None
    vecs = torch.cat(
        [torch.stack([pack[k] for k in vec_keys], dim=1)]
        + [pack[k].reshape(n_layer, rows, -1) for k, rows in blocks],
        dim=1,
    ).to(dev).contiguous()
    out.update(mats=mats, vecs=vecs)
    if quant:
        out["scales"] = scales
    mo = so = 0
    for k in mat_keys:
        n, kb = stored[k].shape[1:]
        out[k] = mats[:, mo : mo + n * kb].unflatten(1, (n, kb))
        if quant:
            out[k + "_d"] = scales[:, so : so + n]
        mo += n * kb
        so += n
    for i, k in enumerate(vec_keys):
        out[k] = vecs[:, i]
    row = len(vec_keys)
    for k, rows in blocks:
        out[k] = vecs[:, row : row + rows] if rows > 1 else vecs[:, row]
        row += rows
    if "maa2" in pack:
        out["maa2"] = pack["maa2"].to(dev).contiguous()
    for k in ("head8", "head_d", "headbf16"):
        if k in pack:
            out[k] = pack[k].to(dev).contiguous()
    out["ln_out"] = torch.stack([pack["ln_out.weight"], pack["ln_out.bias"]]).to(dev)
    out["ln0"] = torch.stack([ln0[0].float(), ln0[1].float()]).to(dev)
    out["emb"] = emb.to(dev).contiguous()
    return out


def _codes(pack: dict, name: str, layer: int, lo=None, hi=None) -> torch.Tensor:
    """Rows [lo, hi) of layer `layer` of matrix `name` as int8 codes [N, K]
    (bf16 values in the bf16 form)."""
    q = pack[name][layer][lo:hi]
    return unpack_int4(q) if pack["w4"] and name in _layout(pack)[1] else q


def _mat(pack: dict, name: str, layer: int, lo=None, hi=None):
    """Rows [lo, hi) of layer `layer` of matrix `name` for ``_matvec``:
    (codes, row scales), or (bf16 rows, None) in the bf16 form."""
    d = pack.get(name + "_d")
    return _codes(pack, name, layer, lo, hi), None if d is None else d[layer][lo:hi]


def _matvec(q, d, x):
    """Matvec of x [B, K] against rows q [N, K]: with row scales d, int8
    codes against x quantized a row at a time as a whole; with d None, bf16
    rows widened to f32 against f32 x (JAX's ``matv`` with quant=False,
    f32 at full precision)."""
    if d is None:
        return x @ q.float().T
    x8, dx = quantize_act_plain(x)
    return int_dot_plain(x8, q) * dx * d


def v7_decode_batched_ref(pack: dict, state: dict, tokens: torch.Tensor, cfg):
    """Plain PyTorch K4 (any device): one decode step of all layers for B
    sequences, no head. `pack` from ``device_pack``; `state` in the serving
    layout (``att_xx`` / ``ffn_xx`` ``[B, L, C]``, ``heads``
    ``[B, L, H, S, S]``); `tokens` [B]. Returns (x [B, C] before ln_out,
    new state). K3's plain version runs the same loop at B=1."""
    h, s = cfg.head_count, cfg.head_size
    c = cfg.n_embed
    d_l = pack["d_lora"]
    rows = pack["emb"][tokens.reshape(-1).to(pack["emb"].device, torch.long)]
    x = layer_norm(rows.float(), pack["ln0"][0], pack["ln0"][1])
    b = x.shape[0]
    att_out, ffn_out, heads_out = [], [], []
    v_first = None
    for l in range(cfg.n_layer):
        def vec(key):
            return pack[key][l]

        def mat(name, part, rows):
            return _mat(pack, name, l, part * rows, (part + 1) * rows)

        xl = layer_norm(x, vec("ln1.weight"), vec("ln1.bias"))
        sx = state["att_xx"][:, l] - xl
        att_out.append(xl)
        cf = pack["coeff"][l]
        xr, xw, xk, xv, xa, xg = (xl + sx * cf[i] for i in range(6))

        r = _matvec(*mat("rkv", 0, c), xr)
        k = _matvec(*mat("rkv", 1, c), xk)
        v = _matvec(*mat("rkv", 2, c), xv)
        w_dn = torch.tanh(_matvec(*mat("lora1", 0, d_l), xw))
        a_dn = _matvec(*mat("lora1", 1, d_l), xa)
        g_dn = torch.sigmoid(_matvec(*mat("lora1", 2, d_l), xg))
        v_dn = _matvec(*mat("lora1", 3, d_l), xv)
        w_l = _matvec(*mat("lora2", 0, c), w_dn)
        a_l = _matvec(*mat("lora2", 1, c), a_dn)
        g = _matvec(*mat("lora2", 2, c), g_dn)
        vmix_l = _matvec(*mat("lora2", 3, c), v_dn)

        w_dec = torch.exp(torch.sigmoid(w_l + vec("att.w0")) * -0.606531)
        a_gate = torch.sigmoid(a_l + vec("att.a0"))
        kk = (k * vec("att.k_k")).reshape(b, h, s)
        kk = kk / torch.clamp(torch.sqrt((kk * kk).sum(-1, keepdim=True)), min=1e-12)
        ka = k * vec("att.k_a")
        k = k + (a_gate * ka - ka)
        if l == 0:
            v_first = v
        else:
            v = v + (v_first - v) * torch.sigmoid(vmix_l + vec("att.v0"))

        r3, w3, k3, v3 = (t.reshape(b, h, s) for t in (r, w_dec, k, v))
        a3, b3 = -kk, kk * a_gate.reshape(b, h, s)
        st = state["heads"][:, l]
        sa = torch.einsum("bhij,bhj->bhi", st, a3)
        st = (st * w3[:, :, None, :] + v3[:, :, :, None] * k3[:, :, None, :]
              + sa[:, :, :, None] * b3[:, :, None, :])
        y = torch.einsum("bhij,bhj->bhi", st, r3)
        heads_out.append(st)
        mu = y.mean(-1, keepdim=True)
        yc = y - mu
        var = (yc * yc).mean(-1, keepdim=True)
        yn = (yc * torch.rsqrt(var + 64e-5)).reshape(b, c)
        xo = yn * vec("att.ln_x.weight") + vec("att.ln_x.bias")
        bonus = (v3 * (k3 * r3 * vec("r_k").reshape(h, s)).sum(-1, keepdim=True)).reshape(b, c)
        xo = (xo + bonus) * g
        x = x + _matvec(*_mat(pack, "out", l), xo)

        xl2 = layer_norm(x, vec("ln2.weight"), vec("ln2.bias"))
        ffn_out.append(xl2)
        xk2 = xl2 + (state["ffn_xx"][:, l] - xl2) * vec("ffn.x_k")
        fk = torch.square(torch.relu(_matvec(*_mat(pack, "fk", l), xk2)))
        x = x + _matvec(*_mat(pack, "fv", l), fk)
    new_state = {
        "att_xx": torch.stack(att_out, dim=1),
        "ffn_xx": torch.stack(ffn_out, dim=1),
        "heads": torch.stack(heads_out, dim=1),
    }
    return x, new_state


def v7_decode_step_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K3 (any device). `pack` from ``device_pack``; `state`
    arrays ``att_xx`` / ``ffn_xx`` ``[L, C]`` and ``heads`` ``[L, H, S, S]``;
    `token` an int tensor of one element. Returns (logits [V], new state)."""
    one = {k: v[None] for k, v in state.items()}
    x, new = v7_decode_batched_ref(pack, one, token.reshape(-1)[:1], cfg)
    return lm_head_ref(pack, x[0]), {k: v[0] for k, v in new.items()}


def lm_head_ref(pack: dict, x: torch.Tensor) -> torch.Tensor:
    """The plain versions' head (the kernels' ``stream::head_phase``):
    ln_out of x [C], quantized as a whole against the int8 head rows, or in
    f32 against the bf16 rows (``headbf16``) -> logits [V]."""
    xo = layer_norm(x[None], pack["ln_out"][0], pack["ln_out"][1])
    if "headbf16" in pack:
        return _matvec(pack["headbf16"], None, xo)[0]
    return _matvec(pack["head8"], pack["head_d"], xo)[0]


def decode_scratch_floats(c: int, d_lora: int, f_dim: int, n_layer: int) -> int:
    """Floats of K3's global scratch (``scratch_floats`` in the source):
    x, r, k, v, the four lora downs, the layer-0 value, xo and the relu^2
    keys in 7C + 4d + F, then ``V7_AMAX_SLOTS`` amax slots a layer of
    `n_layer`."""
    return 7 * c + 4 * d_lora + f_dim + V7_AMAX_SLOTS * n_layer


def _chunks_per_lane(k: int, max_lanes: int = 32, bf16: bool = False) -> int:
    """16-byte chunks each lane reads per int8 (or bf16) weight row of
    width k in the decode kernels' matvec_rows (the largest power-of-two
    lane count up to max_lanes that divides the row's chunks shares a
    row)."""
    chunks = (2 * k if bf16 else k) // 16
    lanes = max_lanes
    while lanes > 1 and chunks % lanes:
        lanes //= 2
    return chunks // lanes


def _common_shape_error(cfg, d_lora: int, f_dim: int, w4: bool) -> Optional[str]:
    s = cfg.head_size
    if cfg.version_major != 7:
        return "the decode kernels are RWKV v7 only"
    if 256 % s or s * s // 256 > 16:
        return f"the decode kernels support head sizes dividing 256 up to 64, got {s}"
    for dim in (cfg.n_embed, d_lora, f_dim):
        if dim % 16:
            return f"the decode kernels need C, d_lora and F to be multiples of 16, got {dim}"
    if w4 and (cfg.n_embed % 32 or f_dim % 32):
        return "int4 rows need C and F to be multiples of 32"
    return None


def decode_shape_error(cfg, d_lora: int, f_dim: int, w4: bool = False, *,
                       bf16: bool = False) -> Optional[str]:
    """Why K3 cannot take this model's shapes, or None. Besides the shared
    rules, a lane of K3 holds its share of a row in registers: at most 8
    16-byte chunks (one round), with 8 lanes a head row (C <= 1024), one a
    d_lora row and 32 an F row (F <= 4096); in the bf16 form (twice the
    bytes a row) at most 16 chunks, two rounds, over the same widths. Wider
    models decode through K4."""
    err = _common_shape_error(cfg, d_lora, f_dim, w4)
    if err:
        return err
    limit = 16 if bf16 else 8
    for dim, lanes in ((cfg.n_embed, 8), (d_lora, 1), (f_dim, 32)):
        if _chunks_per_lane(dim, lanes, bf16) > limit:
            return (f"K3 reads a row of {dim} in at most {limit} 16-byte chunks per lane "
                    f"with {lanes} lanes a row")
    try:
        v7_stream_plan("bf16" if bf16 else "i4" if w4 else "i8", cfg.n_embed, f_dim, d_lora,
                       cfg.head_count, cfg.head_size, cfg.n_vocab, 1)
    except ValueError as e:
        return str(e)
    return None


def batched_shape_error(cfg, d_lora: int, f_dim: int, w4: bool = False) -> Optional[str]:
    """Why K4 cannot take this model's shapes, or None (its matvec walks a
    row of any width; shared memory is checked at launch)."""
    return _common_shape_error(cfg, d_lora, f_dim, w4)


def _grid_blocks(lib_name: str, fn_name: str, *dims: int) -> int:
    """Blocks a cooperative launch uses, from the C entry `fn_name`."""
    fn = getattr(_cuda.library(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int] * len(dims)
    fn.restype = ctypes.c_int
    n = fn(*dims)
    if n < 0:
        _cuda.check(lib_name, fn_name, -n)
    if n == 0:
        raise RuntimeError(f"{lib_name} does not fit on an SM at this model's sizes")
    return n


def _check_pack(pack: dict) -> None:
    dtypes = (torch.bfloat16, torch.float32) if pack["form"] == "bf16" else (torch.bfloat16,)
    if pack["emb"].dtype not in dtypes:
        raise TypeError("the decode kernels embed from a bf16 table (or an f32 one in the "
                        "bf16 form)")


def _emb_f32(pack: dict) -> tuple:
    """The bf16 entries' extra int: whether the embedding table is f32."""
    return (int(pack["emb"].dtype == torch.float32),) if pack["form"] == "bf16" else ()


def _ptr(pack: dict, key: str) -> int:
    """Device address of pack[key]; 0 (null) where the form has no such
    tensor (the bf16 form's scales and head_d)."""
    t = pack.get(key)
    return 0 if t is None else t.data_ptr()


def _head(pack: dict) -> torch.Tensor:
    return pack["headbf16"] if pack["form"] == "bf16" else pack["head8"]


# C entry suffix of each weight form: rwkv_v7_decode, _w4, _bf16, ...
_SUFFIX = {"i8": "", "i4": "_w4", "bf16": "_bf16"}


def _count(fn, pack: dict) -> None:
    """One launch of kernel wrapper `fn` in the pack's form."""
    fn.launches += 1
    fn.launches_by_form[pack["form"]] += 1


def _args(args: tuple, pack: dict) -> tuple:
    """(pointers, ints) of a C entry in the pack's form: the bf16 entries
    take one int more (emb_f32)."""
    return args[0], args[1] + len(_emb_f32(pack))


# argument counts of the C entries rwkv_v7_decode / _w4 (pointers, ints;
# _bf16 one int more)
DECODE_ARGS = (17, 8)


def _k3_entry(pack: dict) -> str:
    return "rwkv_v7_decode" + _SUFFIX[pack["form"]]


def decode_launch(fn, pack: dict, state: dict, token: torch.Tensor, cfg, scratch_extra: int = 0):
    """Check the operands and launch the C entry `fn` (``rwkv_v7_decode``,
    or ``rwkv_v7_decode_w4`` / ``_bf16`` for a w4a8 / bf16 pack) once;
    returns (logits, new state, scratch). `scratch_extra` floats are
    appended to the kernel's scratch (the timing build writes there)."""
    dev = pack["mats"].device
    c, h, s = cfg.n_embed, cfg.head_count, cfg.head_size
    d_l, f, w4 = pack["d_lora"], pack["f_dim"], pack["w4"]
    n_layer, vocab = cfg.n_layer, cfg.n_vocab
    err = decode_shape_error(cfg, d_l, f, w4, bf16=pack["form"] == "bf16")
    if err:
        raise ValueError(err)
    _check_pack(pack)
    token = token.reshape(-1)[:1].to(device=dev, dtype=torch.int32)
    ins = {k: state[k].to(dev, torch.float32).contiguous() for k in ("att_xx", "ffn_xx", "heads")}
    if ins["heads"].shape != (n_layer, h, s, s):
        raise ValueError(f"heads state {tuple(ins['heads'].shape)} != {(n_layer, h, s, s)}")
    outs = {k: torch.empty_like(v) for k, v in ins.items()}
    logits = torch.empty((vocab,), dtype=torch.float32, device=dev)
    # the timing build's stamps go into a zeroed tail; otherwise no fill
    alloc = torch.zeros if scratch_extra else torch.empty
    scratch = alloc((decode_scratch_floats(c, d_l, f, n_layer) + scratch_extra,),
                    dtype=torch.float32, device=dev)
    grid = pack.get("_grid")
    if grid is None:
        grid = pack["_grid"] = _grid_blocks("v7_decode", _k3_entry(pack) + "_grid", c, s, d_l, f)
    code = fn(
        token.data_ptr(), pack["emb"].data_ptr(), pack["ln0"].data_ptr(),
        pack["mats"].data_ptr(), _ptr(pack, "scales"), pack["vecs"].data_ptr(),
        _head(pack).data_ptr(), _ptr(pack, "head_d"), pack["ln_out"].data_ptr(),
        ins["att_xx"].data_ptr(), ins["ffn_xx"].data_ptr(), ins["heads"].data_ptr(),
        outs["att_xx"].data_ptr(), outs["ffn_xx"].data_ptr(), outs["heads"].data_ptr(),
        logits.data_ptr(), scratch.data_ptr(),
        c, h, s, d_l, f, n_layer, vocab, *_emb_f32(pack), grid, _cuda.stream_ptr(dev),
    )
    _cuda.check("v7_decode", _k3_entry(pack), code)
    return logits, outs, scratch


def v7_decode_step(pack: dict, state: dict, token: torch.Tensor, cfg):
    """One decode step at B=1 (see ``v7_decode_step_ref`` for the
    arguments). CUDA tensors launch kernel K3 once; CPU tensors take the
    plain version. The input state is not modified."""
    if pack["mats"].device.type == "cpu":
        return v7_decode_step_ref(pack, state, token, cfg)
    fn = _cuda.function("v7_decode", _k3_entry(pack), *_args(DECODE_ARGS, pack))
    logits, outs, _ = decode_launch(fn, pack, state, token, cfg)
    _count(v7_decode_step, pack)
    return logits, outs


v7_decode_step.launches = 0
v7_decode_step.launches_by_form = dict.fromkeys(FORMS, 0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


# -- K4's launch plan -----------------------------------------------------------
#
# K4 takes each phase's weight rows as the A operand of mma.sync (16 rows
# a tile; int8 m16n8k32 in the int forms, bf16 m16n8k16 in the bf16 form,
# whose f32 inputs split into three bf16 parts) against the batch as N
# (n-tiles of 8 sequences). A phase runs as sweeps, one a matrix: the sweep
# deals its 16-row tiles over the grid's blocks in contiguous runs (lora1
# from the last block down); a block stages its rows and its sequences'
# inputs in shared memory, a K slice a stage (two stages in flight where
# they fit), and sums its warps' products in shared memory before the
# epilogue. The sequences' activations are prepared either (a) by every
# block for all of B, in shared memory, or (b) once a sequence by one warp
# of the grid into a global buffer, behind one more grid barrier a phase;
# in (b) the int forms cut the out and fv tiles' K into parts on blocks of
# their own. ``batched_plan`` chooses; the C entry takes the plan's ints
# and refuses a plan whose shared bytes differ from its own count of them.
K4_SMEM_LIMIT = 232448  # shared memory a block of the H100 may opt into
K4_STATIC_SMEM = 0  # the kernels' static shared memory (the card tests read the kernels')
K4_PLACE_A_MAX_B = 8  # placement (a) up to this B, (b) above (tools/probe_batched.py, PERF.md)
K4_MAX_BATCH = 256  # a tile's n-tiles fit the block's warps (csrc/batch_mma.cuh: kMaxBatch)
K4_MAX_SPLIT = 4  # K parts of an out / fv tile in placement (b), at most (kMaxSplit)
K4_SWEEPS = ("rkv", "lora1", "out", "fk", "fv")
K4_BF16_STEP = 64  # values of K a bf16 step takes (kBf16Step); its K slices are multiples
K4_LEAVES = 4  # partial sums of a bf16 row, its 16-value blocks modulo 4 (kLeaves)


@dataclass(frozen=True)
class BatchedPlan:
    """How one K4 launch runs: ``n_tiles`` n-tiles of 8 sequences (the
    last one padded past B), placement ``place`` ("a" or "b") of the
    activation preparation, ``ring`` stages in flight where a sweep takes
    K in slices, the K slice of each sweep's stage (``K4_SWEEPS`` order;
    codes, K rounded up to 128 being one stage, or in the bf16 form values,
    K rounded up to 64), the dynamic shared bytes ``smem``, the K parts
    each tile of a sweep is cut into (``split``: the int forms' out and fv
    sweeps in placement (b), see ``_k4_split``) and the static shared bytes
    (``static``)."""

    n_tiles: int
    place: str
    ring: int
    k_slice: tuple
    smem: int
    split: tuple = (1,) * 5
    static: int = K4_STATIC_SMEM

    def ints(self) -> tuple:
        """The C entry's plan arguments: place (0 = a), ring, the five K
        slices, the dynamic shared bytes."""
        return (0 if self.place == "a" else 1, self.ring, *self.k_slice, self.smem)


def _k4_sweeps(form: str, c: int, f_dim: int, d_lora: int) -> tuple:
    """Per sweep: (rows, K, rows a part, parts, weight form); each part of
    a sweep's rows reads one input vector (rkv: mixes r, k, v; lora1: w,
    a, g, v). The LoRA is int8 in both int forms."""
    small = "bf16" if form == "bf16" else "i8"
    return ((3 * c, c, c, 3, form), (4 * d_lora, c, d_lora, 4, small), (c, c, c, 1, form),
            (f_dim, c, f_dim, 1, form), (c, f_dim, c, 1, form))


def _k4_split(sweep: int, rows: int, k: int, blocks: int, place: str) -> int:
    """K parts each 16-row tile of sweep `sweep` (``K4_SWEEPS`` index) is
    cut into, its blocks adding their int32 partial sums in global memory
    (csrc/batch_mma.cuh: sweep_split): in placement (b) the out and fv
    sweeps (C / 16 tiles) take every block they can, at most K4_MAX_SPLIT
    and one 128-code step a part; else 1."""
    if place != "b" or K4_SWEEPS[sweep] not in ("out", "fv"):
        return 1
    return max(1, min(blocks // (rows // 16), K4_MAX_SPLIT, _cdiv(k, 128)))


def _k4_code_stride(k: int) -> int:
    """Bytes a staged row of codes takes: whole 128-code steps, plus 16
    bytes that put rows g and g + 1 of a fragment in different banks."""
    return _round_up(k, 128) + 16


def _k4_act_stride(form: str, k: int) -> int:
    """Bytes a staged row of k activations takes: codes, or the bf16
    form's f32 values in whole 64-value steps plus 64 bytes."""
    return 4 * _round_up(k, K4_BF16_STEP) + 64 if form == "bf16" else _k4_code_stride(k)


def _k4_weight_stride(form: str, k: int) -> int:
    """Bytes a staged weight row of k codes takes (int8 as the codes; int4
    rows, k / 2 bytes, padded to 64 mod 128 bytes for the same reason;
    bf16 rows, 2k bytes in whole steps, plus 32)."""
    if form == "bf16":
        return 2 * _round_up(k, K4_BF16_STEP) + 32
    if form != "i4":
        return _k4_code_stride(k)
    half = _round_up(k, 128) // 2
    return half if half % 128 == 64 else half + 64


def _k4_stage_bytes(form_k: str, tiles: int, slots: int, bp: int, k: int, ks: int, place: str,
                    ring: int) -> int:
    """Shared bytes of a sweep's stages: its tiles' weight rows and, in
    placement (b), its slots' input rows, for a K slice of ks codes;
    `ring` stages when K takes more than one slice."""
    stage = tiles * 16 * _k4_weight_stride(form_k, ks)
    if place == "b":
        stage += slots * bp * _k4_act_stride(form_k, ks)
    return stage * (1 if ks >= k else ring)


def _k4_pass_tiles(nt: int) -> int:
    """Tiles a pass of a sweep takes at most: its units (tile x group of 4
    n-tiles) fill the block's 8 warps (csrc/batch_mma.cuh: pass_tiles)."""
    groups = _cdiv(nt, 4)
    return 1 if groups >= 8 else 8 // groups


def batched_plan(form: str, batch: int, c: int, f_dim: int, d_lora: int, *, head_size: int = 64,
                 blocks: int = 132, place: Optional[str] = None) -> BatchedPlan:
    """The launch plan of K4 (`form` "i8", "i4" or "bf16") for `batch`
    sequences at width c, FFN f_dim and LoRA d_lora on a grid of `blocks`
    blocks (one an SM). `place` forces a placement; by default (a) up to
    K4_PLACE_A_MAX_B sequences where it fits, else (b). Each sweep takes
    the largest K slice (a multiple of 128 codes, or of K4_BF16_STEP values
    in the bf16 form) that fits in what the block's other regions leave of
    K4_SMEM_LIMIT - K4_STATIC_SMEM, two stages in flight (``ring``) where
    that fits, else one. Raises ValueError where nothing fits.

    Shared memory, in the kernel's order (all multiples of 16 bytes):
    phase C's scratch (12 S + 264 floats, 4 D codes or, bf16, 4 D floats),
    the int forms' activation scales (6 input vectors x BP floats, BP = 8
    n_tiles) and a sweep's row scales (its most tiles x 16 floats), in (a)
    the warps' sequence rows (8 x C floats) and the prepared inputs (6 x BP
    rows of C, or BP of F: codes, or f32 in the bf16 form), then the work
    region: the largest sweep's stages, which its sums reuse once the last
    stage is read (int32, tiles x 16 x BP; bf16, K4_LEAVES f32 partial sums
    of a pass's tiles).

    The bf16 form keeps its inputs in f32 (4 bytes a value, split into
    bf16 parts in registers as its fragments are loaded), not as three bf16
    parts (6 bytes), and sizes its stages by the tiles of a pass. At C=768,
    B <= 8, placement (a) holds 6 x 8 input rows of 3,136 bytes (150.5 KB)
    beside the sequence rows (24.6 KB) and phase C's 5 KB: 180,256 bytes,
    which leave 52 KB for a sweep's stages (rkv's two 16-row tiles with K
    whole, 50,176 bytes; fv in 768-value slices, two in flight). (a) beat
    (b) there at B = 1 and 8 (tools/probe_batched.py, PERF.md), so the int
    forms' K4_PLACE_A_MAX_B holds for it too. At C=2048 (a)'s inputs alone
    (6 x 8 x 8,256 bytes) pass the limit, so (b) takes every B; (b) stages
    each K slice of the f32 inputs (4 K + 64 bytes a sequence) beside the
    rows: at B=256 a 64-value slice of one tile and one input vector is
    84,480 bytes, two in flight.
    """
    bf16 = form == "bf16"
    if form not in ("i8", "i4", "bf16"):
        raise ValueError(f"batched_plan takes the forms i8, i4 and bf16, got {form!r}")
    if not 1 <= batch <= K4_MAX_BATCH or blocks < 1:
        raise ValueError(f"batched_plan takes 1 <= B <= {K4_MAX_BATCH} and blocks >= 1, got "
                         f"B={batch}, blocks={blocks}")
    nt = _cdiv(batch, 8)
    bp = 8 * nt
    per_pass = _k4_pass_tiles(nt)
    step = K4_BF16_STEP if bf16 else 128
    sweeps = _k4_sweeps(form, c, f_dim, d_lora)
    sizes = []  # per sweep: (most tiles a stage holds, most parts they span)
    most = 0
    for rows, _, _, parts, _ in sweeps:
        tiles = _cdiv(_cdiv(rows, 16), blocks)
        most = max(most, tiles)
        if bf16:
            tiles = min(tiles, per_pass)
        sizes.append((tiles, min(tiles, parts)))
    red = K4_LEAVES * min(most, per_pass) * 16 * bp * 4 if bf16 else most * 16 * bp * 4
    budget = K4_SMEM_LIMIT - K4_STATIC_SMEM
    if place is None:
        order = ("a", "b") if batch <= K4_PLACE_A_MAX_B else ("b",)
    elif place in ("a", "b"):
        order = (place,)
    else:
        raise ValueError(f"place is 'a' or 'b', got {place!r}")
    for pl in order:
        if bf16:
            base = (12 * head_size + 264) * 4 + 16 * d_lora
        else:
            base = ((12 * head_size + 264) * 4 + _round_up(4 * d_lora, 16) + 6 * bp * 4
                    + most * 16 * 4)
        if pl == "a":
            codes = max(6 * bp * _k4_act_stride(form, c), bp * _k4_act_stride(form, f_dim))
            base += 8 * c * 4 + codes
        splits = tuple(1 if bf16 else _k4_split(i, rows, k, blocks, pl)
                       for i, (rows, k, *_) in enumerate(sweeps))
        for ring in (2, 1):
            slices, work = [], red
            for (_, k, _, _, fk), (tiles, slots), sp in zip(sweeps, sizes, splits):
                # the codes (values) of K a block takes
                k = _round_up(k, step) if bf16 else 128 * _cdiv(_cdiv(k, 128), sp)
                ks = _round_up(k, step)

                def need(ks):
                    return max(red, _k4_stage_bytes(fk, tiles, slots, bp, k, ks, pl, ring))

                while ks > step and base + need(ks) > budget:
                    ks -= step
                if base + need(ks) > budget:
                    break
                slices.append(ks)
                work = max(work, need(ks))
            else:
                return BatchedPlan(nt, pl, ring, tuple(slices), base + work, splits)
    raise ValueError(f"K4 has no {form} plan for B={batch} at C={c}, F={f_dim}, D={d_lora} "
                     f"within {K4_SMEM_LIMIT} bytes of shared memory a block")


def batched_scratch_floats(c: int, d_lora: int, f_dim: int, batch: int,
                           codes: bool = True, bf16: bool = False) -> int:
    """Floats of K4's global scratch (see the source): per sequence x, r,
    k, v, v_first, xo (C each), the lora downs (4D) and the relu^2 keys
    (F), array by array with x first; then, with `codes`, placement (b)'s
    inputs: for the int forms the activation scales (6 B floats, rounded
    to 4) and codes (max(6C, F) x B bytes), and the split sweeps' int32
    partial sums (C x 8 ceil(B / 8)) and tickets (C / 16, rounded to 4);
    for the bf16 form (`bf16`) the f32 inputs (max(6C, F) x B floats). The
    timing build's stamps follow."""
    n = (6 * c + 4 * d_lora + f_dim) * batch
    if codes and bf16:
        n += max(6 * c, f_dim) * batch
    elif codes:
        n += _round_up(6 * batch, 4) + _round_up(max(6 * c, f_dim) * batch, 16) // 4
        n += c * 8 * _cdiv(batch, 8) + _round_up(c // 16, 4)
    return n


# argument counts of the C entries rwkv_v7_decode_batched (pointers, ints:
# the dims, w4, the grid, then the plan's eight ints) and _bf16 (emb_f32
# in w4's place); LEGACY_BATCHED_ARGS: an entry of an earlier source that
# takes no plan (the int entry before its tensor-core form, the bf16 entry
# before its own; probe_batched --baseline builds such sources)
BATCHED_ARGS = {"i8": (13, 17), "i4": (13, 17), "bf16": (13, 17)}
LEGACY_BATCHED_ARGS = (13, 9)
# the form argument of the C entries rwkv_v7_decode_batched_static_smem
# and _smem
K4_FORM_CODE = {"i8": 0, "i4": 1, "bf16": 2}


def _k4_entry(pack: dict) -> str:
    return "rwkv_v7_decode_batched" + ("_bf16" if pack["form"] == "bf16" else "")


def k4_function(pack: dict, src=None, flags: tuple = (), legacy: bool = False):
    """K4's C entry for `pack`'s form from csrc (or an earlier source
    `src`, with nvcc `flags`); `legacy`: the entry takes no plan."""
    args = LEGACY_BATCHED_ARGS if legacy else BATCHED_ARGS[pack["form"]]
    if src is None and not flags:
        return _cuda.function("v7_decode_batched", _k4_entry(pack), *args)
    src = src or _cuda.CSRC / "v7_decode_batched.cu"
    return _cuda.function("v7_decode_batched_probe", _k4_entry(pack), *args, src=src,
                          flags=flags)


def k4_plan(pack: dict, batch: int, cfg, grid: int, place: Optional[str] = None):
    """The plan of a launch of `pack` at `batch` on `grid` blocks, cached
    on the pack per (batch, grid, place)."""
    key = (batch, grid, place)
    plans = pack.setdefault("_plans", {})
    if key not in plans:
        plans[key] = batched_plan(pack["form"], batch, cfg.n_embed, pack["f_dim"],
                                  pack["d_lora"], head_size=cfg.head_size, blocks=grid,
                                  place=place)
    return plans[key]


def batched_launch(fn, pack: dict, state: dict, tokens: torch.Tensor, cfg, grid: int,
                   scratch_extra: int = 0, place: Optional[str] = None, legacy: bool = False):
    """Check the operands and launch the C entry `fn`
    (``rwkv_v7_decode_batched``, or ``_bf16`` for a bf16 pack) once on
    `grid` blocks; returns (x, new state, scratch). It passes
    ``k4_plan``'s ints (`place` forces a placement) unless `legacy` (an
    earlier source's entry, which takes none and no input buffer).
    `scratch_extra` floats are appended to the kernel's scratch (the
    timing build writes there)."""
    dev = pack["mats"].device
    c, h, s = cfg.n_embed, cfg.head_count, cfg.head_size
    d_l, f, w4 = pack["d_lora"], pack["f_dim"], pack["w4"]
    n_layer = cfg.n_layer
    err = batched_shape_error(cfg, d_l, f, w4)
    if err:
        raise ValueError(err)
    _check_pack(pack)
    tok = tokens.reshape(-1).to(device=dev, dtype=torch.int32).contiguous()
    b = tok.shape[0]
    ins = {k: state[k].to(dev, torch.float32).contiguous() for k in ("att_xx", "ffn_xx", "heads")}
    for k, shape in (("att_xx", (b, n_layer, c)), ("ffn_xx", (b, n_layer, c)),
                     ("heads", (b, n_layer, h, s, s))):
        if ins[k].shape != shape:
            raise ValueError(f"{k} state {tuple(ins[k].shape)} != {shape}")
    outs = {k: torch.empty_like(v) for k, v in ins.items()}
    plan = () if legacy else k4_plan(pack, b, cfg, grid, place).ints()
    alloc = torch.zeros if scratch_extra else torch.empty
    n_scratch = batched_scratch_floats(c, d_l, f, b, codes=bool(plan),
                                       bf16=pack["form"] == "bf16")
    scratch = alloc((n_scratch + scratch_extra,), dtype=torch.float32, device=dev)
    flag = _emb_f32(pack) or (int(w4),)  # emb_f32 (bf16 entry) or w4
    code = fn(
        tok.data_ptr(), pack["emb"].data_ptr(), pack["ln0"].data_ptr(),
        pack["mats"].data_ptr(), _ptr(pack, "scales"), pack["vecs"].data_ptr(),
        ins["att_xx"].data_ptr(), ins["ffn_xx"].data_ptr(), ins["heads"].data_ptr(),
        outs["att_xx"].data_ptr(), outs["ffn_xx"].data_ptr(), outs["heads"].data_ptr(),
        scratch.data_ptr(),
        c, h, s, d_l, f, n_layer, b, *flag, grid, *plan, _cuda.stream_ptr(dev),
    )
    _cuda.check("v7_decode_batched", _k4_entry(pack), code)
    return scratch[: b * c].view(b, c), outs, scratch


def v7_decode_batched(pack: dict, state: dict, tokens: torch.Tensor, cfg):
    """One decode step for B sequences, no head (see
    ``v7_decode_batched_ref`` for the arguments). CUDA tensors launch
    kernel K4 once; CPU tensors take the plain version. The input state is
    not modified."""
    if pack["mats"].device.type == "cpu":
        return v7_decode_batched_ref(pack, state, tokens, cfg)
    grid = pack.get("_grid_batched")
    if grid is None:
        dims = (cfg.n_embed, cfg.head_size, pack["d_lora"], pack["f_dim"])
        dims += () if pack["form"] == "bf16" else (int(pack["w4"]),)
        grid = pack["_grid_batched"] = _grid_blocks(
            "v7_decode_batched", _k4_entry(pack) + "_grid", *dims)
    x, outs, _ = batched_launch(k4_function(pack), pack, state, tokens, cfg, grid)
    _count(v7_decode_batched, pack)
    return x, outs


v7_decode_batched.launches = 0
v7_decode_batched.launches_by_form = dict.fromkeys(FORMS, 0)


# -- RWKV v6 (Finch): pack, plain version, kernel K6 ---------------------------


def build_mega_pack_v6(params: dict, cfg, w4: bool = False, quant: bool = True) -> dict:
    """K6's parameter pack with the LM head (the JAX package's
    ``build_mega_pack_v6(quant=quant, w4=w4, head=True)``), built on the
    host from the port's parameter tree.

    Matrices (``V6_MAT_KEYS``) are codes ``[L, N, K]`` (int4 values for
    ``V6_W4_MATS`` when w4; maa1, dw1 and dw2 stay int8) with row scales
    ``[L, N]``, or bf16 values with quant=False, fused in the TPU kernel's
    row order (rkvg = r, k, v, g); ``maa2`` f32 ``[L, 5C, d_maa]`` in every
    form (row s*C + c: split s's up-projection, splits w, k, v, r, g);
    vectors ``[L, C]``; ``maa5`` ``[L, 5, C]`` (the five token-shift
    coefficients, w, k, v, r, g); ``tdecay`` and ``tf`` (time_faaaa)
    ``[L, C]``; ``head8`` ``[V, C]`` int8 with ``head_d``, or
    ``headbf16``."""
    if cfg.version_major != 6:
        raise NotImplementedError("build_mega_pack_v6 takes RWKV v6 models")
    c = cfg.n_embed
    blocks = params["blocks"]
    n_layer = len(blocks)

    def stack(keys_or_key):
        if isinstance(keys_or_key, tuple):
            return np.stack([np.concatenate([_np(b[k]) for k in keys_or_key]) for b in blocks])
        return np.stack([_np(b[keys_or_key]) for b in blocks])

    d_maa = _np(blocks[0]["att.time_maa_w1"]).shape[0] // 5
    form = _form(quant, w4)
    pack = {
        "version": 6,
        "quant": quant,
        "w4": form == "i4",
        "form": form,
        "d_maa": d_maa,
        "d_dec": _np(blocks[0]["att.time_decay_w1"]).shape[0],
        "f_dim": _np(blocks[0]["ffn.key.weight"]).shape[0],
    }
    _pack_mats(pack, {
        "rkvg": stack(_V6_RKVG),
        "maa1": stack("att.time_maa_w1"),
        "dw1": stack("att.time_decay_w1"),
        "dw2": stack("att.time_decay_w2"),
        "out": stack("att.output.weight"),
        "fk": stack("ffn.key.weight"),
        "fv": stack("ffn.value.weight"),
        "fr": stack("ffn.receptance.weight"),
    }, V6_W4_MATS)
    pack["maa2"] = torch.from_numpy(stack("att.time_maa_w2").reshape(n_layer, 5 * c, d_maa))
    for key in V6_VEC_KEYS:
        pack[key] = torch.from_numpy(stack(key).reshape(n_layer, c))
    pack["maa5"] = torch.from_numpy(stack(tuple("att.time_maa_" + n for n in _V6_MAA5))
                                    .reshape(n_layer, 5, c))
    pack["tdecay"] = torch.from_numpy(stack("att.time_decay").reshape(n_layer, c))
    pack["tf"] = torch.from_numpy(stack("att.time_faaaa").reshape(n_layer, c))
    _attach_head(pack, params)
    return pack


def v6_decode_layers_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K6 without the head (any device): one v6 decode step
    of all layers at B=1. `pack` from ``device_pack``; `state` arrays
    ``att_xx`` / ``ffn_xx`` ``[L, C]`` and ``heads`` ``[L, H, S, S]``;
    `token` an int tensor of one element. Returns (x [C] before ln_out,
    new state). Each matvec quantizes its input vector as a whole, as
    ``_make_kernel_v6`` does (the bf16 form: f32 products); the maa2
    up-projections are f32 products."""
    h, s = cfg.head_count, cfg.head_size
    c = cfg.n_embed
    dm = pack["d_maa"]
    rows = pack["emb"][token.reshape(-1)[:1].to(pack["emb"].device, torch.long)]
    x = layer_norm(rows.float(), pack["ln0"][0], pack["ln0"][1])  # [1, C]
    att_out, ffn_out, heads_out = [], [], []
    for l in range(cfg.n_layer):
        def vec(key):
            return pack[key][l]

        def mat(name, lo=None, hi=None):
            return _mat(pack, name, l, lo, hi)

        xl = layer_norm(x, vec("ln1.weight"), vec("ln1.bias"))
        sx = state["att_xx"][l] - xl
        att_out.append(xl[0])
        xxx = xl + sx * vec("att.time_maa_x")
        mixdn = torch.tanh(_matvec(*mat("maa1"), xxx))  # [1, 5 dm]
        m = torch.einsum("scd,sd->sc", pack["maa2"][l].reshape(5, c, dm), mixdn.reshape(5, dm))
        cf = pack["maa5"][l]
        xw, xk, xv, xr, xg = (xl + sx * (cf[i] + m[i]) for i in range(5))

        r = _matvec(*mat("rkvg", 0, c), xr)
        k = _matvec(*mat("rkvg", c, 2 * c), xk)
        v = _matvec(*mat("rkvg", 2 * c, 3 * c), xv)
        gg = _matvec(*mat("rkvg", 3 * c, 4 * c), xg)
        g = gg * torch.sigmoid(gg)
        w_dn = torch.tanh(_matvec(*mat("dw1"), xw))
        w_dec = torch.exp(-torch.exp(_matvec(*mat("dw2"), w_dn) + vec("tdecay")))

        r3, k3, v3, w3 = (t.reshape(h, s) for t in (r, k, v, w_dec))
        st = state["heads"][l]
        dot = (r3 * vec("tf").reshape(h, s) * k3).sum(-1, keepdim=True)
        y = torch.einsum("hij,hj->hi", st, r3) + v3 * dot
        heads_out.append(st * w3[:, None, :] + v3[:, :, None] * k3[:, None, :])
        mu = y.mean(-1, keepdim=True)
        yc = y - mu
        var = (yc * yc).mean(-1, keepdim=True)
        yn = (yc * torch.rsqrt(var + 64e-5)).reshape(1, c)
        xo = (yn * vec("att.ln_x.weight") + vec("att.ln_x.bias")) * g
        x = x + _matvec(*mat("out"), xo)

        xl2 = layer_norm(x, vec("ln2.weight"), vec("ln2.bias"))
        ffn_out.append(xl2[0])
        sx2 = state["ffn_xx"][l] - xl2
        xk2 = xl2 + sx2 * vec("ffn.time_maa_k")
        xr2 = xl2 + sx2 * vec("ffn.time_maa_r")
        rg = torch.sigmoid(_matvec(*mat("fr"), xr2))
        hk = torch.square(torch.relu(_matvec(*mat("fk"), xk2)))
        x = x + rg * _matvec(*mat("fv"), hk)
    new_state = {
        "att_xx": torch.stack(att_out),
        "ffn_xx": torch.stack(ffn_out),
        "heads": torch.stack(heads_out),
    }
    return x[0], new_state


def v6_decode_step_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K6 (any device): ``v6_decode_layers_ref``, then ln_out
    and the head. Returns (logits [V], new state)."""
    x, new = v6_decode_layers_ref(pack, state, token, cfg)
    return lm_head_ref(pack, x), new


V6_AMAX_SLOTS = 8  # a layer's published amax: the five mixes, dw1's outputs, xo, relu^2 keys


def v6_scratch_floats(c: int, d_maa: int, d_dec: int, f_dim: int, n_layer: int) -> int:
    """Floats of K6's global scratch (``scratch_floats`` in the source):
    the activations, then ``V6_AMAX_SLOTS`` amax slots a layer."""
    return 12 * c + 5 * d_maa + d_dec + f_dim + V6_AMAX_SLOTS * n_layer


# -- the B=1 decode kernels' stream plans (K6, K7) -------------------------------
#
# K6 and K7 stage every input that does not depend on the token -- weight
# rows with their row scales, the vector rows a phase reads, att_in /
# ffn_in, phase C's state rows and the head's rows (K6 also maa2) -- in a
# ring of shared-memory stages fed by 1-D bulk asynchronous copies, in the
# order the block consumes them (csrc/decode_stream.cuh). ``v6_stream_plan``
# and ``v5_stream_plan`` mirror the kernels' own plans (Layout6 / Plan6 /
# piece_copy in csrc/v6_decode.cu, Layout5 / Plan5 / piece_copy in
# csrc/v5_decode.cu) over the generic parts below (the header's Ring, Rows
# and part): each phase's rows go to the blocks in contiguous ranges of
# whole 4-row groups; a range is cut into pieces of as many whole rows as
# fit a stage, each followed by the 16-byte window of its row scales (or,
# for K6's maa2, of its maa5 coefficients). Every copy is a multiple of 16
# bytes from a 16-byte aligned address.
STREAM_SMEM_LIMIT = 232448  # shared memory a block of the H100 may opt into
STREAM_MAX_STAGES = 16  # stages' mbarriers reserved
STREAM_PLAN_BYTES = 512  # the block's plan in shared memory
STREAM_TARGET_STAGES = 4  # the ring's stages where the largest piece allows
STREAM_MIN_STAGES = 3  # a block holds at most three pieces at once
V6_SMEM_LIMIT = STREAM_SMEM_LIMIT
V6_STATIC_SMEM = 0  # K6's static shared memory (the card tests read the kernel's)
V6_MAX_STAGES = STREAM_MAX_STAGES
V6_MIN_STAGES = STREAM_MIN_STAGES
V6_NUM_VEC = len(V6_VEC_KEYS) + 7  # vector rows a layer: V6_VEC_KEYS, maa5 (5), tdecay, tf
_V6_VEC_ROW = dict({k: i for i, k in enumerate(V6_VEC_KEYS)}, maa5=9, tdecay=14, tf=15)
# the pieces of a layer in stream order (a segment is a run of pieces), then
# those of the head
V6_SEGS = ("ln1", "mix_a", "maa1", "maa2", "rkvg", "dw1", "heads", "out", "ln2", "mix_e",
           "ffn_in", "fk", "fr", "fv")
V6_HEAD_SEGS = ("ln_out", "head")
V6_STREAMED = ("maa1", "maa2", "rkvg", "dw1", "out", "fk", "fr", "fv", "head")


def _form_bytes(form: str, n: int) -> int:
    return n // 2 if form == "i4" else 2 * n if form == "bf16" else n


def _small_form(form: str) -> str:
    return "bf16" if form == "bf16" else "i8"


def v6_mat_offsets(form: str, c: int, d_maa: int, d_dec: int, f_dim: int) -> dict:
    """Byte offsets of a layer's matrices in K6's flat ``mats`` buffer and
    the layer's bytes ("layer"): the kernel's MatOffsets6."""
    sf = _small_form(form)
    sizes = (("rkvg", form, 4 * c * c), ("maa1", sf, 5 * d_maa * c), ("dw1", sf, d_dec * c),
             ("dw2", sf, c * d_dec), ("out", form, c * c), ("fk", form, f_dim * c),
             ("fv", form, c * f_dim), ("fr", form, c * c))
    return _offsets((name, _form_bytes(fm, n)) for name, fm, n in sizes)


def v6_scale_offsets(c: int, d_maa: int, d_dec: int, f_dim: int) -> dict:
    """Float offsets of a layer's row scales in ``scales`` and the layer's
    count ("layer"): the kernel's ScaleOffsets6."""
    return _offsets((("rkvg", 4 * c), ("maa1", 5 * d_maa), ("dw1", d_dec), ("dw2", c),
                     ("out", c), ("fk", f_dim), ("fv", c), ("fr", c)))


def _offsets(sizes) -> dict:
    """Running offsets of (name, size) in order, and their sum ("layer")."""
    out, at = {}, 0
    for name, n in sizes:
        out[name] = at
        at += n
    out["layer"] = at
    return out


@dataclass(frozen=True)
class StreamRows:
    """Rows [r0, r1) of a matrix that one block takes (row bytes ``rb``,
    ``lpr`` lanes a row), ``n`` whole rows a piece; row r0 + j goes to the
    block's lane group j % (8 * 32 / lpr)."""

    r0: int
    r1: int
    n: int
    rb: int
    lpr: int

    def pieces(self) -> int:
        return _cdiv(self.r1 - self.r0, self.n) if self.r1 > self.r0 else 0

    def piece(self, k: int) -> tuple:
        """Rows [c0, c1) of piece k."""
        c0 = self.r0 + k * self.n
        return c0, min(c0 + self.n, self.r1)


@dataclass(frozen=True)
class StreamCopy:
    """One bulk copy: `nbytes` from byte `offset` of the flat tensor
    `array` of a device pack (``mats``, ``scales``, ``vecs``, ``maa2``,
    ``head``, ``head_d``, ``ln_out``) or of the state (``att_in`` /
    ``ffn_in`` = ``att_xx`` / ``ffn_xx``, ``heads_in``), to byte `dst` of
    a stage."""

    array: str
    offset: int
    nbytes: int
    dst: int


def _win_bytes(n: int) -> int:
    """Bytes at most of the scale window of n consecutive rows."""
    return 16 * ((n + 6) // 4)


def _row_lanes(row_bytes: int, max_lpr: int) -> int:
    lpr = max_lpr
    while lpr > 1 and (row_bytes // 16) % lpr:
        lpr //= 2
    return lpr


def _lanes_for(k: int, form: str) -> int:
    """The kernels' ``lanes_for``: lanes of a big matvec's row."""
    want, lanes = _form_bytes(form, k) // 16 // 8, 1
    while lanes < want and lanes < 32:
        lanes *= 2
    return lanes


def _part(n: int, blocks: int, b: int, reverse: bool, row_bytes: int, win: bool,
          stage: int, max_lpr: int) -> StreamRows:
    """Block b's share of n rows (the header's ``part``, whose 32-bit
    arithmetic needs n / 4 * blocks below 2^31)."""
    q, i = n // 4, (blocks - 1 - b if reverse else b)
    if q * blocks >= 1 << 31:
        raise ValueError(f"{n} rows over {blocks} blocks overflow the plans' 32-bit arithmetic")
    rows = stage // row_bytes
    while win and rows > 1 and rows * row_bytes + _win_bytes(rows) > stage:
        rows -= 1
    return StreamRows(4 * (q * i // blocks), 4 * (q * (i + 1) // blocks), rows, row_bytes,
                      _row_lanes(row_bytes, max_lpr))


def _ring(plan_off: int, piece: int) -> tuple:
    """The header's Ring after the block's plan at `plan_off`: (mbarriers'
    offset, ring's offset, stage bytes, stages) -- about
    ``STREAM_TARGET_STAGES`` stages below ``STREAM_SMEM_LIMIT``, each at
    least the largest piece."""
    bar_off = plan_off + STREAM_PLAN_BYTES
    ring_off = _round_up(bar_off + 16 * STREAM_MAX_STAGES, 128)
    ring = max(STREAM_SMEM_LIMIT - ring_off, 0)
    stage = max(_round_up(piece, 16), ring // STREAM_TARGET_STAGES // 16 * 16)
    return bar_off, ring_off, stage, min(ring // stage, STREAM_MAX_STAGES)


def _stream_rows_copies(r: StreamRows, idx: int, array: str, at: int, scale) -> tuple:
    """The copies of piece idx of rows r of the matrix at byte `at` of
    `array`, then (where `scale` = (array, byte offset of the first row's
    float) is given) the 16-byte window of their row floats."""
    c0, c1 = r.piece(idx)
    nbytes = (c1 - c0) * r.rb
    out = [StreamCopy(array, at + c0 * r.rb, nbytes, 0)]
    if scale is not None:
        w0, w1 = c0 & ~3, (c1 + 3) & ~3
        out.append(StreamCopy(scale[0], scale[1] + 4 * w0, 4 * (w1 - w0), nbytes))
    return tuple(out)


class _StreamPlan:
    """What K6's and K7's plans share: a block's rows of each streamed
    matrix (``SEGS`` and ``HEAD_SEGS`` in stream order, ``STREAMED`` the
    segments of matrix rows, ``_spec`` their shapes) and its pieces in
    stream order."""

    SEGS: tuple = ()
    HEAD_SEGS: tuple = ()
    STREAMED: tuple = ()

    def _spec(self, name: str) -> tuple:
        raise NotImplementedError

    def _count(self, seg: str, block: int) -> int:
        """Pieces of a segment that holds no matrix rows."""
        return 1

    def rows(self, name: str, block: int) -> StreamRows:
        """Block `block`'s rows of matrix `name` (``STREAMED``)."""
        n, rb, win, rev, lanes = self._spec(name)
        return _part(n, self.blocks, block, rev, rb, win, self.stage_bytes, lanes)

    def block_heads(self, block: int) -> list:
        """The heads phase C runs on block `block`."""
        return list(range(block, self.n_heads, self.blocks))

    def count(self, seg: str, block: int) -> int:
        if seg in self.STREAMED:
            return self.rows(seg, block).pieces()
        return self._count(seg, block)

    def layer_pieces(self, block: int) -> int:
        return sum(self.count(s, block) for s in self.SEGS)

    def head_pieces(self, block: int) -> int:
        return sum(self.count(s, block) for s in self.HEAD_SEGS)

    def stream(self, block: int, n_layer: int):
        """Block `block`'s pieces in stream order: (layer, segment, index,
        copies); the head's pieces carry layer n_layer."""
        for layer in range(n_layer):
            for seg in self.SEGS:
                for idx in range(self.count(seg, block)):
                    yield layer, seg, idx, self.copies(block, layer, seg, idx)
        for seg in self.HEAD_SEGS:
            for idx in range(self.count(seg, block)):
                yield n_layer, seg, idx, self.copies(block, n_layer, seg, idx)


@dataclass(frozen=True)
class V6StreamPlan(_StreamPlan):
    """K6's stream plan for one weight form and grid (``v6_stream_plan``):
    the shared-memory layout (activations at ``act_off``, mbarriers at
    ``bar_off``, ``n_stages`` stages of ``stage_bytes`` from ``ring_off``;
    ``smem_bytes`` in all) and, per block, the rows of each phase and the
    copies of each piece of its stream."""

    SEGS = V6_SEGS
    HEAD_SEGS = V6_HEAD_SEGS
    STREAMED = V6_STREAMED

    form: str
    c: int
    f_dim: int
    d_maa: int
    d_dec: int
    n_heads: int
    head_size: int
    vocab: int
    blocks: int
    act_off: int
    bar_off: int
    ring_off: int
    stage_bytes: int
    n_stages: int
    smem_bytes: int

    def _spec(self, name: str) -> tuple:
        """(rows, row bytes, scale window, dealt from the last block, most
        lanes a row)."""
        c, f, form = self.c, self.f_dim, self.form
        sf, w = _small_form(form), form != "bf16"
        big = _lanes_for(c, form)
        return {"maa1": (5 * self.d_maa, _form_bytes(sf, c), w, False, 32),
                "maa2": (5 * c, 4 * self.d_maa, True, False, 32),
                "rkvg": (4 * c, _form_bytes(form, c), w, False, big),
                "dw1": (self.d_dec, _form_bytes(sf, c), w, True, 32),
                "out": (c, _form_bytes(form, c), w, False, big),
                "fk": (f, _form_bytes(form, c), w, False, big),
                "fr": (c, _form_bytes(form, c), w, True, big),
                "fv": (c, _form_bytes(form, f), w, False, _lanes_for(f, form)),
                "head": (self.vocab, _form_bytes(sf, c), w, False, 8)}[name]

    def _count(self, seg: str, block: int) -> int:
        return 2 * len(self.block_heads(block)) if seg == "heads" else 1

    def copies(self, block: int, layer: int, seg: str, idx: int) -> tuple:
        """The copies of piece `idx` of segment `seg` of `layer`."""
        c, s, dm = self.c, self.head_size, self.d_maa
        w = self.form != "bf16"
        mo = v6_mat_offsets(self.form, c, dm, self.d_dec, self.f_dim)
        so = v6_scale_offsets(c, dm, self.d_dec, self.f_dim)
        mats = layer * mo["layer"]
        scales = 4 * layer * so["layer"]

        def vec(row: str, at: int = 0) -> int:
            return 4 * ((layer * V6_NUM_VEC + _V6_VEC_ROW[row]) * c + at)

        if seg in V6_STREAMED:
            array, at, scale = {
                "maa2": ("maa2", 4 * layer * 5 * c * dm, ("vecs", vec("maa5"))),
                "head": ("head", 0, ("head_d", 0) if w else None),
            }.get(seg, ("mats", mats + mo.get(seg, 0),
                        ("scales", scales + 4 * so.get(seg, 0)) if w else None))
            return _stream_rows_copies(self.rows(seg, block), idx, array, at, scale)
        if seg == "heads":
            h = self.block_heads(block)[idx // 2]
            if idx % 2:
                return (StreamCopy("heads_in", 4 * (layer * self.n_heads + h) * s * s,
                                   4 * s * s, 0),)
            rb = _form_bytes(_small_form(self.form), self.d_dec)
            out = [StreamCopy("mats", mats + mo["dw2"] + h * s * rb, s * rb, 0)]
            at = s * rb
            if w:
                out.append(StreamCopy("scales", scales + 4 * (so["dw2"] + h * s), 4 * s, at))
                at += 4 * s
            for i, row in enumerate(("tdecay", "tf", "att.ln_x.weight", "att.ln_x.bias")):
                out.append(StreamCopy("vecs", vec(row, h * s), 4 * s, at + 4 * s * i))
            return tuple(out)
        return {
            "ln1": (StreamCopy("vecs", vec("ln1.weight"), 8 * c, 0),),
            "mix_a": (StreamCopy("vecs", vec("att.time_maa_x"), 4 * c, 0),
                      StreamCopy("att_in", 4 * layer * c, 4 * c, 4 * c)),
            "ln2": (StreamCopy("vecs", vec("ln2.weight"), 8 * c, 0),),
            "mix_e": (StreamCopy("vecs", vec("ffn.time_maa_k"), 8 * c, 0),),
            "ffn_in": (StreamCopy("ffn_in", 4 * layer * c, 4 * c, 0),),
            "ln_out": (StreamCopy("ln_out", 0, 8 * c, 0),),
        }[seg]


def v6_stream_plan(form: str, c: int, f_dim: int, d_maa: int, d_dec: int, n_heads: int,
                   head_size: int, vocab: int, blocks: int) -> V6StreamPlan:
    """K6's stream plan in weight form `form` ("i8", "i4", "bf16") for a
    grid of `blocks` (the kernel's Layout6 and Plan6). The ring takes what
    shared memory is left below ``V6_SMEM_LIMIT`` after the activations:
    about ``STREAM_TARGET_STAGES`` stages, each at least the largest piece
    (two vector rows, a head's state or dw2 piece, one row of any matrix
    with its scale window); raises ValueError below ``V6_MIN_STAGES``."""
    s, sf = head_size, _small_form(form)
    floats = 2 * c + max(8 * s, 5 * d_maa) + 256 + 8 + V6_AMAX_SLOTS
    act_off = 4 * floats
    plan_off = _round_up(act_off + (4 if form == "bf16" else 1) * max(5 * c, f_dim), 16)
    piece = max(8 * c, 4 * s * s, s * _form_bytes(sf, d_dec) + (16 if form == "bf16" else 20) * s)
    row = max(_form_bytes(form, c), _form_bytes(form, f_dim), _form_bytes(sf, c), 4 * d_maa)
    bar_off, ring_off, stage, stages = _ring(plan_off, max(piece, row + _win_bytes(1)))
    if stages < V6_MIN_STAGES:
        raise ValueError(f"K6's ring holds {stages} stages of {stage} bytes at these widths, "
                         f"it needs {V6_MIN_STAGES}")
    return V6StreamPlan(form, c, f_dim, d_maa, d_dec, n_heads, head_size, vocab, blocks,
                        act_off, bar_off, ring_off, stage, stages, ring_off + stages * stage)


def v6_decode_shape_error(cfg, d_maa: int, d_dec: int, f_dim: int,
                          w4: bool = False, form: Optional[str] = None) -> Optional[str]:
    """Why K6 cannot take this model's shapes, or None. K6 walks weight
    rows of any width in 16-byte chunks and streams them in 16-byte pieces
    through shared memory (``v6_stream_plan``, checked in `form`: by
    default the int form `w4` names)."""
    s = cfg.head_size
    if cfg.version_major != 6:
        return "K6 decodes RWKV v6 only"
    if 256 % s or s * s // 256 > 16 or s % 4:
        return f"K6 supports head sizes dividing 256 from 4 up to 64, got {s}"
    for dim in (cfg.n_embed, d_dec, f_dim):
        if dim % 16:
            return f"K6 needs C, d_dec and F to be multiples of 16, got {dim}"
    if d_maa % 4:
        return f"K6 reads maa2 rows in float4 pieces: d_maa must be a multiple of 4, got {d_maa}"
    if cfg.n_vocab % 4:
        return ("K6 streams the head's row scales in 16-byte pieces: the vocabulary must be "
                f"a multiple of 4, got {cfg.n_vocab}")
    if w4 and (cfg.n_embed % 32 or f_dim % 32):
        return "int4 rows need C and F to be multiples of 32"
    try:
        v6_stream_plan(form or ("i4" if w4 else "i8"), cfg.n_embed, f_dim, d_maa, d_dec,
                       cfg.head_count, s, cfg.n_vocab, 1)
    except ValueError as e:
        return str(e)
    return None


# argument counts of the C entries rwkv_v6_decode / _w4 (pointers, ints;
# _bf16 one int more)
V6_DECODE_ARGS = (18, 9)


def _k6_entry(pack: dict) -> str:
    return "rwkv_v6_decode" + _SUFFIX[pack["form"]]


def v6_decode_launch(fn, pack: dict, state: dict, token: torch.Tensor, cfg,
                     scratch_extra: int = 0):
    """Check the operands and launch the C entry `fn` (``rwkv_v6_decode``,
    or ``rwkv_v6_decode_w4`` / ``_bf16`` for a w4a8 / bf16 pack) once;
    returns (logits, new state, scratch). `scratch_extra` floats are appended to the kernel's
    scratch (the timing build writes there)."""
    dev = pack["mats"].device
    c, h, s = cfg.n_embed, cfg.head_count, cfg.head_size
    dm, dd, f, w4 = pack["d_maa"], pack["d_dec"], pack["f_dim"], pack["w4"]
    n_layer, vocab = cfg.n_layer, cfg.n_vocab
    err = v6_decode_shape_error(cfg, dm, dd, f, w4, form=pack["form"])
    if err:
        raise ValueError(err)
    if pack.get("version") != 6:
        raise ValueError("K6 needs a v6 pack (build_mega_pack_v6)")
    _check_pack(pack)
    token = token.reshape(-1)[:1].to(device=dev, dtype=torch.int32)
    ins = {k: state[k].to(dev, torch.float32).contiguous() for k in ("att_xx", "ffn_xx", "heads")}
    for k, shape in (("att_xx", (n_layer, c)), ("ffn_xx", (n_layer, c)),
                     ("heads", (n_layer, h, s, s))):
        if ins[k].shape != shape:
            raise ValueError(f"{k} state {tuple(ins[k].shape)} != {shape}")
    outs = {k: torch.empty_like(v) for k, v in ins.items()}
    logits = torch.empty((vocab,), dtype=torch.float32, device=dev)
    alloc = torch.zeros if scratch_extra else torch.empty
    scratch = alloc((v6_scratch_floats(c, dm, dd, f, n_layer) + scratch_extra,),
                    dtype=torch.float32, device=dev)
    grid = pack.get("_grid_v6")
    if grid is None:
        grid = pack["_grid_v6"] = _grid_blocks("v6_decode", _k6_entry(pack) + "_grid",
                                               c, s, dm, dd, f)
    code = fn(
        token.data_ptr(), pack["emb"].data_ptr(), pack["ln0"].data_ptr(),
        pack["mats"].data_ptr(), _ptr(pack, "scales"), pack["vecs"].data_ptr(),
        pack["maa2"].data_ptr(), _head(pack).data_ptr(), _ptr(pack, "head_d"),
        pack["ln_out"].data_ptr(),
        ins["att_xx"].data_ptr(), ins["ffn_xx"].data_ptr(), ins["heads"].data_ptr(),
        outs["att_xx"].data_ptr(), outs["ffn_xx"].data_ptr(), outs["heads"].data_ptr(),
        logits.data_ptr(), scratch.data_ptr(),
        c, h, s, dm, dd, f, n_layer, vocab, *_emb_f32(pack), grid, _cuda.stream_ptr(dev),
    )
    _cuda.check("v6_decode", _k6_entry(pack), code)
    return logits, outs, scratch


def v6_decode_step(pack: dict, state: dict, token: torch.Tensor, cfg):
    """One v6 decode step at B=1 with the head (see ``v6_decode_step_ref``
    for the arguments). CUDA tensors launch kernel K6 once; CPU tensors
    take the plain version. The input state is not modified."""
    if pack["mats"].device.type == "cpu":
        return v6_decode_step_ref(pack, state, token, cfg)
    fn = _cuda.function("v6_decode", _k6_entry(pack), *_args(V6_DECODE_ARGS, pack))
    logits, outs, _ = v6_decode_launch(fn, pack, state, token, cfg)
    _count(v6_decode_step, pack)
    return logits, outs


v6_decode_step.launches = 0
v6_decode_step.launches_by_form = dict.fromkeys(FORMS, 0)


# -- RWKV v5.1 / v5.2 and v4: packs, plain versions, kernels K7 and K8 --------

# matrices in the JAX package's order (all five int4 under w4a8); att is
# the fused projections: v5 r, k, v(, g), v4 r, k, v
V5_MAT_KEYS = ("rkvg", "out", "fk", "fv", "fr")
V4_MAT_KEYS = ("rkv", "out", "fk", "fv", "fr")
# the per-layer vector rows both kernels start with (their VecRow45 enum);
# _v45_blocks gives the rows after them
V45_VEC_KEYS = ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias")
_V45_ATT = ("att.receptance.weight", "att.key.weight", "att.value.weight")


def _v45_blocks(pack: dict) -> tuple:
    """Vector rows after ``V45_VEC_KEYS`` as (key, rows): the FFN mixes
    (k, r), the static decay ``td`` and bonus ``tf`` (``[L, C]``, heads
    flattened), v5's ``ln_x`` weight and bias, then the attention mixes
    (k, v, r(, g))."""
    lnx = (("att.ln_x.weight", 1), ("att.ln_x.bias", 1)) if pack["version"] == 5 else ()
    n_mix = 4 if pack.get("has_gate") else 3
    return (("fmix", 2), ("td", 1), ("tf", 1)) + lnx + (("amix", n_mix),)


def _build_mega_pack_v45(params: dict, cfg, w4: bool, quant: bool, version: int) -> dict:
    c = cfg.n_embed
    blocks = params["blocks"]
    n_layer = len(blocks)
    has_gate = version == 5 and "att.gate.weight" in blocks[0]

    def stack(keys_or_key):
        if isinstance(keys_or_key, tuple):
            return np.stack([np.concatenate([_np(b[k]) for k in keys_or_key]) for b in blocks])
        return np.stack([_np(b[keys_or_key]) for b in blocks])

    form = _form(quant, w4)
    pack = {
        "version": version,
        "quant": quant,
        "w4": form == "i4",
        "form": form,
        "f_dim": _np(blocks[0]["ffn.key.weight"]).shape[0],
    }
    att = _V45_ATT + (("att.gate.weight",) if has_gate else ())
    mats = {
        "rkvg" if version == 5 else "rkv": stack(att),
        "out": stack("att.output.weight"),
        "fk": stack("ffn.key.weight"),
        "fv": stack("ffn.value.weight"),
        "fr": stack("ffn.receptance.weight"),
    }
    _pack_mats(pack, mats, tuple(mats))
    for key in V45_VEC_KEYS:
        pack[key] = torch.from_numpy(stack(key).reshape(n_layer, c))
    mix_names = ("k", "v", "r") + (("g",) if has_gate else ())
    pack["amix"] = torch.from_numpy(stack(tuple("att.time_mix_" + n for n in mix_names))
                                    .reshape(n_layer, len(mix_names), c))
    pack["fmix"] = torch.from_numpy(stack(("ffn.time_mix_k", "ffn.time_mix_r"))
                                    .reshape(n_layer, 2, c))

    def per_channel(key):
        rows = []
        for b in blocks:
            a = _np(b[key])
            if version == 5 and a.ndim == 1:  # 5.1: per-head scalars over S
                a = np.broadcast_to(a[:, None], (cfg.head_count, cfg.head_size))
            rows.append(a.reshape(c))
        return torch.from_numpy(np.stack(rows))

    pack["td"] = per_channel("att.time_decay")
    pack["tf"] = per_channel("att.time_faaaa" if has_gate else "att.time_first")
    if version == 5:
        pack["has_gate"] = has_gate
        for key in ("att.ln_x.weight", "att.ln_x.bias"):
            pack[key] = torch.from_numpy(stack(key).reshape(n_layer, c))
    _attach_head(pack, params)
    return pack


def build_mega_pack_v5(params: dict, cfg, w4: bool = False, quant: bool = True) -> dict:
    """K7's parameter pack with the LM head (the JAX package's
    ``build_mega_pack_v5(quant=quant, w4=w4, head=True)``), built on the
    host from the port's parameter tree. ``has_gate`` (v5.2) is whether the
    layers hold ``att.gate.weight``.

    Matrices (``V5_MAT_KEYS``) are codes ``[L, N, K]`` (int4 values for all
    five when w4) with row scales ``[L, N]``, or bf16 values with
    quant=False, ``rkvg`` fused r, k, v(, g);
    vectors ``[L, C]``; ``amix`` ``[L, 3 or 4, C]`` (k, v, r(, g)); ``fmix``
    ``[L, 2, C]`` (k, r); ``td`` (the decay, already exp(-exp(.)) as
    stored) and ``tf`` (5.2's time_faaaa, 5.1's time_first) ``[L, C]``, 5.1's
    per-head scalars broadcast over S; ``head8`` ``[V, C]`` int8 with
    ``head_d``, or ``headbf16``."""
    if cfg.version_major != 5:
        raise NotImplementedError("build_mega_pack_v5 takes RWKV v5 models")
    return _build_mega_pack_v45(params, cfg, w4, quant, 5)


def build_mega_pack_v4(params: dict, cfg, w4: bool = False, quant: bool = True) -> dict:
    """K8's parameter pack with the LM head (the JAX package's
    ``build_mega_pack_v4(quant=quant, w4=w4, head=True)``): as
    ``build_mega_pack_v5`` with ``rkv`` fused r, k, v, ``amix`` (k, v, r),
    ``td`` = time_decay and ``tf`` = time_first ``[L, C]``, and no ln_x."""
    if cfg.version_major != 4:
        raise NotImplementedError("build_mega_pack_v4 takes RWKV v4 models")
    return _build_mega_pack_v45(params, cfg, w4, quant, 4)


def _mix45(x, prev, coeff):
    """The v4/v5 token-shift mix in the reference's op order."""
    return x * coeff + (prev - prev * coeff)


def _ffn_v45_ref(pack: dict, l: int, x, ffn_in):
    """The v4/v5 FFN of layer l on x [1, C]: (new x, ln2 output)."""
    xl2 = layer_norm(x, pack["ln2.weight"][l], pack["ln2.bias"][l])
    fcf = pack["fmix"][l]
    xk2 = _mix45(xl2, ffn_in, fcf[0])
    xr2 = _mix45(xl2, ffn_in, fcf[1])
    rg = torch.sigmoid(_matvec(*_mat(pack, "fr", l), xr2))
    hk = torch.square(torch.relu(_matvec(*_mat(pack, "fk", l), xk2)))
    return x + rg * _matvec(*_mat(pack, "fv", l), hk), xl2[0]


# the attention mix (amix order k, v, r, g) that feeds each fused
# projection (r, k, v, g)
_ATT_MIX = (2, 0, 1, 3)


def _att_rows_ref(pack: dict, name: str, l: int, xl, prev):
    """The fused attention projections of layer l: the mixes each
    quantized as a whole (bf16 form: in f32), then r, k, v(, g) [1, C]."""
    c = xl.shape[-1]
    cf = pack["amix"][l]
    return [_matvec(*_mat(pack, name, l, i * c, (i + 1) * c), _mix45(xl, prev, cf[_ATT_MIX[i]]))
            for i in range(cf.shape[0])]


def v5_decode_layers_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K7 without the head (any device): one v5.1/v5.2 decode
    step of all layers at B=1. `pack` from ``device_pack``; `state` arrays
    ``att_xx`` / ``ffn_xx`` ``[L, C]`` and ``heads`` ``[L, H, S, S]``;
    `token` an int tensor of one element. Returns (x [C] before ln_out,
    new state). Each matvec quantizes its input vector as a whole, as
    ``_make_kernel_v5`` does."""
    h, s = cfg.head_count, cfg.head_size
    c = cfg.n_embed
    rows = pack["emb"][token.reshape(-1)[:1].to(pack["emb"].device, torch.long)]
    x = layer_norm(rows.float(), pack["ln0"][0], pack["ln0"][1])  # [1, C]
    att_out, ffn_out, heads_out = [], [], []
    for l in range(cfg.n_layer):
        xl = layer_norm(x, pack["ln1.weight"][l], pack["ln1.bias"][l])
        att_out.append(xl[0])
        r, k, v, *gate = _att_rows_ref(pack, "rkvg", l, xl, state["att_xx"][l])
        r3, k3, v3 = (t.reshape(h, s) for t in (r, k, v))
        st = state["heads"][l]
        dot = (r3 * pack["tf"][l].reshape(h, s) * k3).sum(-1, keepdim=True)
        y = torch.einsum("hij,hj->hi", st, r3) + v3 * dot
        heads_out.append(st * pack["td"][l].reshape(h, s)[:, None, :]
                         + v3[:, :, None] * k3[:, None, :])
        mu = y.mean(-1, keepdim=True)
        yc = y - mu
        var = (yc * yc).mean(-1, keepdim=True)
        yn = (yc * torch.rsqrt(var + 1e-5)).reshape(1, c)
        xo = yn * pack["att.ln_x.weight"][l] + pack["att.ln_x.bias"][l]
        if gate:
            xo = xo * (gate[0] * torch.sigmoid(gate[0]))
        x = x + _matvec(*_mat(pack, "out", l), xo)
        x, xl2 = _ffn_v45_ref(pack, l, x, state["ffn_xx"][l])
        ffn_out.append(xl2)
    new_state = {
        "att_xx": torch.stack(att_out),
        "ffn_xx": torch.stack(ffn_out),
        "heads": torch.stack(heads_out),
    }
    return x[0], new_state


def v5_decode_step_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K7 (any device): ``v5_decode_layers_ref``, then
    ln_out and the head. Returns (logits [V], new state)."""
    x, new = v5_decode_layers_ref(pack, state, token, cfg)
    return lm_head_ref(pack, x), new


V4_STATE_KEYS = ("att_xx", "ffn_xx", "aa", "bb", "pp")


def v4_decode_layers_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K8 without the head (any device): one v4 decode step
    of all layers at B=1. `state` arrays ``att_xx`` / ``ffn_xx`` / ``aa`` /
    ``bb`` / ``pp`` ``[L, C]``; otherwise as ``v5_decode_layers_ref``
    (``_make_kernel_v4``'s arithmetic)."""
    from rwkv_tpu_torch.models.graph import _wkv4_step

    rows = pack["emb"][token.reshape(-1)[:1].to(pack["emb"].device, torch.long)]
    x = layer_norm(rows.float(), pack["ln0"][0], pack["ln0"][1])  # [1, C]
    out = {k: [] for k in V4_STATE_KEYS}
    for l in range(cfg.n_layer):
        xl = layer_norm(x, pack["ln1.weight"][l], pack["ln1.bias"][l])
        out["att_xx"].append(xl[0])
        r, k, v = _att_rows_ref(pack, "rkv", l, xl, state["att_xx"][l])
        wkv, aa, bb, pp = _wkv4_step(pack["tf"][l], pack["td"][l], k[0], v[0],
                                     state["aa"][l], state["bb"][l], state["pp"][l])
        for key, val in (("aa", aa), ("bb", bb), ("pp", pp)):
            out[key].append(val)
        x = x + _matvec(*_mat(pack, "out", l), torch.sigmoid(r) * wkv)
        x, xl2 = _ffn_v45_ref(pack, l, x, state["ffn_xx"][l])
        out["ffn_xx"].append(xl2)
    return x[0], {k: torch.stack(v) for k, v in out.items()}


def v4_decode_step_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K8 (any device): ``v4_decode_layers_ref``, then
    ln_out and the head. Returns (logits [V], new state)."""
    x, new = v4_decode_layers_ref(pack, state, token, cfg)
    return lm_head_ref(pack, x), new


V5_AMAX_SLOTS = 2  # a layer's published amax in K7's scratch: xo, the relu^2 keys
V4_AMAX_SLOTS = 1  # a layer's published amax in K8's scratch: the relu^2 keys


def v45_scratch_floats(version: int, c: int, f_dim: int, n_layer: int = 0) -> int:
    """Floats of K7's / K8's global scratch (``scratch_floats`` in the
    sources): v5 x, r|k|v|g, xo, sigmoid(fr), relu^2 keys -- 7C + F --, then
    ``V5_AMAX_SLOTS`` amax slots a layer of `n_layer`; v4 x,
    sigmoid(r)|k|v, sigmoid(fr), relu^2 keys -- 5C + F --, then
    ``V4_AMAX_SLOTS`` a layer, padded to an even count (the timing build's
    8-byte stamps follow)."""
    if version == 5:
        return 7 * c + f_dim + V5_AMAX_SLOTS * n_layer
    slots = V4_AMAX_SLOTS * n_layer
    return 5 * c + f_dim + slots + slots % 2


# -- K7's stream plan (csrc/v5_decode.cu: Layout5, Plan5, piece_copy) -----------
#
# As K6's (``v6_stream_plan``): a block's rows of each phase in pieces with
# their row scales' windows; a phase's vector rows (A: ln1 w, b, the
# attention mixes, att_in; E: ln2 w, b, the FFN mixes k, r, ffn_in) in
# pieces of ``vec_rows`` rows, as many as fit a stage up to
# ``V5_MAX_VEC_ROWS``; a head's state, then its td, tf, ln_x w and b, in
# one piece.
V5_STATIC_SMEM = 0  # K7's static shared memory (the card tests read the kernel's)
V5_MAX_VEC_ROWS = 8  # vector rows a piece at most (kMaxVecRows)
V5_VEC_E = 5  # phase E's vector rows
V5_SEGS = ("vec_a", "att", "heads", "out", "vec_e", "fk", "fr", "fv")
V5_HEAD_SEGS = ("ln_out", "head")
V5_STREAMED = ("att", "out", "fk", "fr", "fv", "head")
_V5_VEC_ROW = {"ln1.weight": 0, "ln1.bias": 1, "ln2.weight": 2, "ln2.bias": 3, "fmix": 4,
               "td": 6, "tf": 7, "att.ln_x.weight": 8, "att.ln_x.bias": 9, "amix": 10}


def v5_mat_offsets(form: str, c: int, f_dim: int, n_att: int) -> dict:
    """Byte offsets of a layer's matrices in K7's / K8's flat ``mats``
    buffer and the layer's bytes ("layer"): the kernels' MatOffsets45
    (``n_att`` fused attention projections)."""
    return _offsets((name, _form_bytes(form, n)) for name, n in (
        ("att", n_att * c * c), ("out", c * c), ("fk", f_dim * c), ("fv", c * f_dim),
        ("fr", c * c)))


def v5_scale_offsets(c: int, f_dim: int, n_att: int) -> dict:
    """Float offsets of a layer's row scales and its count ("layer"): the
    kernels' ScaleOffsets45."""
    return _offsets((("att", n_att * c), ("out", c), ("fk", f_dim), ("fv", c), ("fr", c)))


@dataclass(frozen=True)
class V5StreamPlan(_StreamPlan):
    """K7's stream plan for one weight form, version (``n_att`` = 4 for
    v5.2, 3 for v5.1) and grid (``v5_stream_plan``): the shared-memory
    layout as ``V6StreamPlan``'s, ``vec_rows`` vector rows a piece, and per
    block the rows of each phase and the copies of each piece."""

    SEGS = V5_SEGS
    HEAD_SEGS = V5_HEAD_SEGS
    STREAMED = V5_STREAMED

    form: str
    n_att: int
    c: int
    f_dim: int
    n_heads: int
    head_size: int
    vocab: int
    blocks: int
    act_off: int
    bar_off: int
    ring_off: int
    stage_bytes: int
    n_stages: int
    smem_bytes: int
    vec_rows: int

    def _spec(self, name: str) -> tuple:
        """(rows, row bytes, scale window, dealt from the last block, most
        lanes a row)."""
        c, f, form = self.c, self.f_dim, self.form
        w, big = form != "bf16", _lanes_for(c, form)
        return {"att": (self.n_att * c, _form_bytes(form, c), w, False, big),
                "out": (c, _form_bytes(form, c), w, False, big),
                "fk": (f, _form_bytes(form, c), w, False, big),
                "fr": (c, _form_bytes(form, c), w, True, big),
                "fv": (c, _form_bytes(form, f), w, False, _lanes_for(f, form)),
                "head": (self.vocab, _form_bytes(_small_form(form), c), w, False, 8)}[name]

    def vec_run(self, seg: str) -> tuple:
        """The vector rows of segment "vec_a" / "vec_e" in order, each as
        (array, row key): a pack vector row, att_in or ffn_in."""
        if seg == "vec_a":
            return ((("vecs", "ln1.weight"), ("vecs", "ln1.bias"))
                    + tuple(("vecs", ("amix", m)) for m in range(self.n_att))
                    + (("att_in", None),))
        return (("vecs", "ln2.weight"), ("vecs", "ln2.bias"), ("vecs", ("fmix", 0)),
                ("vecs", ("fmix", 1)), ("ffn_in", None))

    def phase_a_fused(self) -> bool:
        """Whether phase A holds all its vector pieces at once (the kernel's
        ``phase_a_fused``); else it releases ln1's piece after the layer
        norm, at two rows a piece, and holds at most three."""
        return self.count("vec_a", 0) <= self.n_stages

    def _count(self, seg: str, block: int) -> int:
        if seg in ("vec_a", "vec_e"):
            return _cdiv(len(self.vec_run(seg)), self.vec_rows)
        return len(self.block_heads(block)) if seg == "heads" else 1

    def copies(self, block: int, layer: int, seg: str, idx: int) -> tuple:
        """The copies of piece `idx` of segment `seg` of `layer`."""
        c, s = self.c, self.head_size
        w = self.form != "bf16"
        mo = v5_mat_offsets(self.form, c, self.f_dim, self.n_att)
        so = v5_scale_offsets(c, self.f_dim, self.n_att)
        n_vec = _V5_VEC_ROW["amix"] + self.n_att

        def vec(row, at: int = 0) -> int:
            key, m = row if isinstance(row, tuple) else (row, 0)
            return 4 * ((layer * n_vec + _V5_VEC_ROW[key] + m) * c + at)

        if seg in V5_STREAMED:
            if seg == "head":
                array, at, scale = "head", 0, ("head_d", 0) if w else None
            else:
                array, at = "mats", layer * mo["layer"] + mo[seg]
                scale = ("scales", 4 * (layer * so["layer"] + so[seg])) if w else None
            return _stream_rows_copies(self.rows(seg, block), idx, array, at, scale)
        if seg in ("vec_a", "vec_e"):
            run = self.vec_run(seg)[idx * self.vec_rows:(idx + 1) * self.vec_rows]
            return tuple(StreamCopy(a, vec(key) if a == "vecs" else 4 * layer * c, 4 * c,
                                    4 * c * i) for i, (a, key) in enumerate(run))
        if seg == "heads":
            h = self.block_heads(block)[idx]
            out = [StreamCopy("heads_in", 4 * (layer * self.n_heads + h) * s * s, 4 * s * s, 0)]
            for i, row in enumerate(("td", "tf", "att.ln_x.weight", "att.ln_x.bias")):
                out.append(StreamCopy("vecs", vec(row, h * s), 4 * s, 4 * s * s + 4 * s * i))
            return tuple(out)
        return (StreamCopy("ln_out", 0, 8 * c, 0),)  # ln_out


def v5_stream_plan(form: str, c: int, f_dim: int, n_heads: int, head_size: int, vocab: int,
                   blocks: int, n_att: int = 4) -> V5StreamPlan:
    """K7's stream plan in weight form `form` ("i8", "i4", "bf16") for a
    grid of `blocks` and ``n_att`` fused attention projections (4: v5.2, 3:
    v5.1): the kernel's Layout5 and Plan5. The ring takes what shared memory
    is left below ``STREAM_SMEM_LIMIT`` after the activations, about
    ``STREAM_TARGET_STAGES`` stages, each at least the largest piece (two
    vector rows, a head's state with its vector slices, one row of any
    matrix with its scale window); raises ValueError below
    ``STREAM_MIN_STAGES``."""
    s = head_size
    act_off = _round_up(4 * (2 * c + 5 * s + 256 + 8 + V5_AMAX_SLOTS), 16)
    plan_off = _round_up(act_off + (4 if form == "bf16" else 1) * max(4 * c, f_dim), 16)
    piece = max(8 * c, 4 * s * s + 16 * s)
    row = max(_form_bytes(form, c), _form_bytes(form, f_dim), _form_bytes(_small_form(form), c))
    bar_off, ring_off, stage, stages = _ring(plan_off, max(piece, row + _win_bytes(1)))
    plan = V5StreamPlan(form, n_att, c, f_dim, n_heads, head_size, vocab, blocks, act_off,
                        bar_off, ring_off, stage, stages, ring_off + stages * stage,
                        min(stage // (4 * c), V5_MAX_VEC_ROWS))
    if stages < STREAM_MIN_STAGES:
        raise ValueError(f"K7's ring holds {stages} stages of {stage} bytes at these widths, "
                         f"it needs {STREAM_MIN_STAGES}")
    return plan


# -- K8's stream plan (csrc/v4_decode.cu: Layout4, Plan4, piece_copy) ----------
#
# As K7's (``v5_stream_plan``): a block's rows of each phase in pieces with
# their row scales' windows, every matrix's rows with the lanes matvec_grid
# gave them (``_lanes_for``; 8 for the head); each phase's vector rows in
# pieces of ``vec_rows`` rows, as many as fit a stage up to
# ``V4_MAX_VEC_ROWS``: A's ln1 w, b, the attention mixes k, v, r and
# att_in, B's td at the block's channels [s0, s1) (the aa / bb / pp it
# writes), tf and the old aa, bb, pp, E's ln2 w, b, the FFN mixes k, r and
# ffn_in. The head's rows past its last whole 4-row group are the last
# block's, read outside the stream (``head_tail``).
V4_STATIC_SMEM = 0  # K8's static shared memory (the card tests read the kernel's)
V4_MAX_VEC_ROWS = 8  # vector rows a piece at most (kMaxVecRows)
V4_SEGS = ("vec_a", "att", "vec_b", "out", "vec_e", "fk", "fr", "fv")
V4_HEAD_SEGS = ("ln_out", "head")
V4_STREAMED = ("att", "out", "fk", "fr", "fv", "head")
_V4_VEC_ROW = {"ln1.weight": 0, "ln1.bias": 1, "ln2.weight": 2, "ln2.bias": 3, "fmix": 4,
               "td": 6, "tf": 7, "amix": 8}
V4_NUM_VEC = 11  # vector rows a layer: V45_VEC_KEYS, fmix (2), td, tf, amix (3)


@dataclass(frozen=True)
class V4StreamPlan(_StreamPlan):
    """K8's stream plan for one weight form and grid (``v4_stream_plan``):
    the shared-memory layout as ``V5StreamPlan``'s, ``vec_rows`` vector
    rows a piece, and per block the rows of each phase, its state channels
    and the copies of each piece."""

    SEGS = V4_SEGS
    HEAD_SEGS = V4_HEAD_SEGS
    STREAMED = V4_STREAMED

    form: str
    c: int
    f_dim: int
    vocab: int
    blocks: int
    act_off: int
    bar_off: int
    ring_off: int
    stage_bytes: int
    n_stages: int
    smem_bytes: int
    vec_rows: int

    def _spec(self, name: str) -> tuple:
        """(rows, row bytes, scale window, dealt from the last block, most
        lanes a row)."""
        c, f, form = self.c, self.f_dim, self.form
        w, big = form != "bf16", _lanes_for(c, form)
        return {"att": (3 * c, _form_bytes(form, c), w, False, big),
                "out": (c, _form_bytes(form, c), w, False, big),
                "fk": (f, _form_bytes(form, c), w, False, big),
                "fr": (c, _form_bytes(form, c), w, True, big),
                "fv": (c, _form_bytes(form, f), w, False, _lanes_for(f, form)),
                "head": (self.vocab, _form_bytes(_small_form(form), c), w, False, 8)}[name]

    def channels(self, block: int) -> tuple:
        """The channels [s0, s1) whose new aa, bb, pp block `block` writes
        in phase B: whole 4-channel groups, split as evenly as the grid
        allows."""
        r = _part(self.c, self.blocks, block, False, 4, False, self.stage_bytes, 1)
        return r.r0, r.r1

    def vec_run(self, seg: str) -> tuple:
        """The vector rows of segment "vec_a" / "vec_b" / "vec_e" in order,
        each as (array, row key): a pack vector row, a state row of the
        layer (att_in, ffn_in, aa_in, bb_in, pp_in), or B's td slice
        (``("vecs", "td_slice")``)."""
        if seg == "vec_a":
            return ((("vecs", "ln1.weight"), ("vecs", "ln1.bias"))
                    + tuple(("vecs", ("amix", m)) for m in range(3)) + (("att_in", None),))
        if seg == "vec_b":
            return (("vecs", "td_slice"), ("vecs", "tf"), ("aa_in", None), ("bb_in", None),
                    ("pp_in", None))
        return (("vecs", "ln2.weight"), ("vecs", "ln2.bias"), ("vecs", ("fmix", 0)),
                ("vecs", ("fmix", 1)), ("ffn_in", None))

    def _count(self, seg: str, block: int) -> int:
        if seg in ("vec_a", "vec_b", "vec_e"):
            return _cdiv(len(self.vec_run(seg)), self.vec_rows)
        return 1

    def head_tail(self, block: int) -> tuple:
        """The head rows [r0, r1) past its last whole 4-row group that
        block `block` computes outside the stream (the last block's)."""
        r0 = self.vocab & ~3
        return r0, self.vocab if block == self.blocks - 1 else r0

    def copies(self, block: int, layer: int, seg: str, idx: int) -> tuple:
        """The copies of piece `idx` of segment `seg` of `layer`."""
        c = self.c
        w = self.form != "bf16"
        mo = v5_mat_offsets(self.form, c, self.f_dim, 3)
        so = v5_scale_offsets(c, self.f_dim, 3)

        def vec(row, at: int = 0) -> int:
            key, m = row if isinstance(row, tuple) else (row, 0)
            return 4 * ((layer * V4_NUM_VEC + _V4_VEC_ROW[key] + m) * c + at)

        if seg in V4_STREAMED:
            if seg == "head":
                array, at, scale = "head", 0, ("head_d", 0) if w else None
            else:
                array, at = "mats", layer * mo["layer"] + mo[seg]
                scale = ("scales", 4 * (layer * so["layer"] + so[seg])) if w else None
            return _stream_rows_copies(self.rows(seg, block), idx, array, at, scale)
        if seg in ("vec_a", "vec_b", "vec_e"):
            out = []
            first = idx * self.vec_rows
            for i, (array, key) in enumerate(self.vec_run(seg)[first:first + self.vec_rows]):
                if key == "td_slice":
                    s0, s1 = self.channels(block)
                    if s1 > s0:
                        out.append(StreamCopy(array, vec("td", s0), 4 * (s1 - s0), 0))
                    continue
                offset = vec(key) if array == "vecs" else 4 * layer * c
                out.append(StreamCopy(array, offset, 4 * c, 4 * c * i))
            return tuple(out)
        return (StreamCopy("ln_out", 0, 8 * c, 0),)  # ln_out


def v4_stream_plan(form: str, c: int, f_dim: int, vocab: int, blocks: int) -> V4StreamPlan:
    """K8's stream plan in weight form `form` ("i8", "i4", "bf16") for a
    grid of `blocks`: the kernel's Layout4 and Plan4. The ring takes what
    shared memory is left below ``STREAM_SMEM_LIMIT`` after the activations,
    about ``STREAM_TARGET_STAGES`` stages, each at least the largest piece
    (two vector rows, one row of any matrix with its scale window); raises
    ValueError below ``STREAM_MIN_STAGES`` stages or two vector rows a
    piece (phase A holds its vector pieces at once)."""
    act_off = _round_up(4 * (2 * c + 256 + 8 + V4_AMAX_SLOTS), 16)
    plan_off = _round_up(act_off + (4 if form == "bf16" else 1) * max(3 * c, f_dim), 16)
    row = max(_form_bytes(form, c), _form_bytes(form, f_dim), _form_bytes(_small_form(form), c))
    bar_off, ring_off, stage, stages = _ring(plan_off, max(8 * c, row + _win_bytes(1)))
    plan = V4StreamPlan(form, c, f_dim, vocab, blocks, act_off, bar_off, ring_off, stage,
                        stages, ring_off + stages * stage, min(stage // (4 * c), V4_MAX_VEC_ROWS))
    if stages < STREAM_MIN_STAGES:
        raise ValueError(f"K8's ring holds {stages} stages of {stage} bytes at these widths, "
                         f"it needs {STREAM_MIN_STAGES}")
    if plan.vec_rows < 2 or plan.count("vec_a", 0) > stages:
        raise ValueError(f"K8 holds phase A's {plan.count('vec_a', 0)} vector pieces at once, "
                         f"its ring {stages} stages of {plan.vec_rows} rows")
    return plan


# -- K3's stream plan (csrc/v7_decode.cu: Layout7, Plan7, piece_copy) ----------
#
# As K7's (``v5_stream_plan``): a block's rows of each phase in pieces with
# their row scales' windows, every matrix's rows with the lanes
# matvec_grid gave them (32 at most, 8 for the head); phase A's vector rows
# (ln1 w, b, the six mixes, att_in) and E's (ln2 w, b, xk, ffn_in) in
# pieces of ``vec_rows`` rows, as many as fit a stage up to
# ``V7_MAX_VEC_ROWS``; a head's state with its eight vector slices in one
# piece, then its 4 x S lora2 rows (run q: rows q C + h S + [0, S)) in
# pieces of ``l2_runs`` runs with their row scales. The head's rows past
# its last whole 4-row group (V not a multiple of 4) are the last block's,
# read outside the stream (``head_tail``).
V7_STATIC_SMEM = 0  # K3's static shared memory (the card tests read the kernel's)
V7_MAX_VEC_ROWS = 9  # vector rows a piece at most (kMaxVecRows)
V7_AMAX_SLOTS = 6  # published amax a layer: the four lora downs, xo, the relu^2 keys
V7_HV_FLOATS = 10  # per-head vectors in shared memory, S floats each
V7_SEGS = ("vec_a", "rkv", "lora1", "heads", "out", "vec_e", "fk", "fv")
V7_HEAD_SEGS = ("ln_out", "head")
V7_STREAMED = ("rkv", "lora1", "out", "fk", "fv", "head")
# a head's vector slices in its state piece, in order
V7_HEAD_VECS = ("att.w0", "att.a0", "att.v0", "att.k_k", "att.k_a", "att.ln_x.weight",
                "att.ln_x.bias", "r_k")
_V7_VEC_ROW = dict({k: i for i, k in enumerate(VEC_KEYS)}, coeff=len(VEC_KEYS),
                   r_k=len(VEC_KEYS) + 6)
V7_NUM_VEC = len(VEC_KEYS) + 7  # vector rows a layer: VEC_KEYS, the six coeff rows, r_k


def v7_mat_offsets(form: str, c: int, d_lora: int, f_dim: int) -> dict:
    """Byte offsets of a layer's matrices in K3's flat ``mats`` buffer and
    the layer's bytes ("layer"): the kernel's MatOffsets."""
    sf = _small_form(form)
    sizes = (("rkv", form, 3 * c * c), ("lora1", sf, 4 * d_lora * c), ("lora2", sf, 4 * c * d_lora),
             ("out", form, c * c), ("fk", form, f_dim * c), ("fv", form, c * f_dim))
    return _offsets((name, _form_bytes(fm, n)) for name, fm, n in sizes)


def v7_scale_offsets(c: int, d_lora: int, f_dim: int) -> dict:
    """Float offsets of a layer's row scales and its count ("layer"): the
    kernel's ScaleOffsets."""
    return _offsets((("rkv", 3 * c), ("lora1", 4 * d_lora), ("lora2", 4 * c), ("out", c),
                     ("fk", f_dim), ("fv", c)))


@dataclass(frozen=True)
class V7StreamPlan(_StreamPlan):
    """K3's stream plan for one weight form and grid (``v7_stream_plan``):
    the shared-memory layout as ``V5StreamPlan``'s, ``vec_rows`` vector rows
    and ``l2_runs`` lora2 runs a piece, and per block the rows of each phase
    and the copies of each piece."""

    SEGS = V7_SEGS
    HEAD_SEGS = V7_HEAD_SEGS
    STREAMED = V7_STREAMED

    form: str
    c: int
    f_dim: int
    d_lora: int
    n_heads: int
    head_size: int
    vocab: int
    blocks: int
    act_off: int
    bar_off: int
    ring_off: int
    stage_bytes: int
    n_stages: int
    smem_bytes: int
    vec_rows: int
    l2_runs: int

    def _spec(self, name: str) -> tuple:
        """(rows, row bytes, scale window, dealt from the last block, most
        lanes a row)."""
        c, f, form = self.c, self.f_dim, self.form
        sf, w = _small_form(form), form != "bf16"
        return {"rkv": (3 * c, _form_bytes(form, c), w, False, 32),
                "lora1": (4 * self.d_lora, _form_bytes(sf, c), w, True, 32),
                "out": (c, _form_bytes(form, c), w, False, 32),
                "fk": (f, _form_bytes(form, c), w, False, 32),
                "fv": (c, _form_bytes(form, f), w, False, 32),
                "head": (self.vocab, _form_bytes(sf, c), w, False, 8)}[name]

    def vec_run(self, seg: str) -> tuple:
        """The vector rows of segment "vec_a" / "vec_e" in order, each as
        (array, row key): a pack vector row, att_in or ffn_in."""
        if seg == "vec_a":
            return ((("vecs", "ln1.weight"), ("vecs", "ln1.bias"))
                    + tuple(("vecs", ("coeff", m)) for m in range(6)) + (("att_in", None),))
        return (("vecs", "ln2.weight"), ("vecs", "ln2.bias"), ("vecs", "ffn.x_k"),
                ("ffn_in", None))

    def lora2_pieces(self) -> int:
        """Pieces of a head's lora2 rows (after its state piece)."""
        return _cdiv(4, self.l2_runs)

    def _count(self, seg: str, block: int) -> int:
        if seg in ("vec_a", "vec_e"):
            return _cdiv(len(self.vec_run(seg)), self.vec_rows)
        if seg == "heads":
            return len(self.block_heads(block)) * (1 + self.lora2_pieces())
        return 1

    def head_tail(self, block: int) -> tuple:
        """The head rows [r0, r1) past its last whole 4-row group that
        block `block` computes outside the stream (the last block's)."""
        r0 = self.vocab & ~3
        return r0, self.vocab if block == self.blocks - 1 else r0

    def copies(self, block: int, layer: int, seg: str, idx: int) -> tuple:
        """The copies of piece `idx` of segment `seg` of `layer`."""
        c, s, d = self.c, self.head_size, self.d_lora
        w = self.form != "bf16"
        mo = v7_mat_offsets(self.form, c, d, self.f_dim)
        so = v7_scale_offsets(c, d, self.f_dim)

        def vec(row, at: int = 0) -> int:
            key, m = row if isinstance(row, tuple) else (row, 0)
            return 4 * ((layer * V7_NUM_VEC + _V7_VEC_ROW[key] + m) * c + at)

        if seg in V7_STREAMED:
            if seg == "head":
                array, at, scale = "head", 0, ("head_d", 0) if w else None
            else:
                array, at = "mats", layer * mo["layer"] + mo[seg]
                scale = ("scales", 4 * (layer * so["layer"] + so[seg])) if w else None
            return _stream_rows_copies(self.rows(seg, block), idx, array, at, scale)
        if seg in ("vec_a", "vec_e"):
            run = self.vec_run(seg)[idx * self.vec_rows:(idx + 1) * self.vec_rows]
            return tuple(StreamCopy(a, vec(key) if a == "vecs" else 4 * layer * c, 4 * c,
                                    4 * c * i) for i, (a, key) in enumerate(run))
        if seg == "heads":
            per = 1 + self.lora2_pieces()
            h, k = self.block_heads(block)[idx // per], idx % per
            if k == 0:
                out = [StreamCopy("heads_in", 4 * (layer * self.n_heads + h) * s * s, 4 * s * s,
                                  0)]
                for i, row in enumerate(V7_HEAD_VECS):
                    out.append(StreamCopy("vecs", vec(row, h * s), 4 * s, 4 * s * s + 4 * s * i))
                return tuple(out)
            q0 = (k - 1) * self.l2_runs
            runs = range(q0, min(q0 + self.l2_runs, 4))
            rb = _form_bytes(_small_form(self.form), d)
            at = layer * mo["layer"] + mo["lora2"]
            out = [StreamCopy("mats", at + (q * c + h * s) * rb, s * rb, s * rb * j)
                   for j, q in enumerate(runs)]
            if w:
                base = 4 * (layer * so["layer"] + so["lora2"])
                out += [StreamCopy("scales", base + 4 * (q * c + h * s), 4 * s,
                                   s * rb * len(runs) + 4 * s * j) for j, q in enumerate(runs)]
            return tuple(out)
        return (StreamCopy("ln_out", 0, 8 * c, 0),)  # ln_out


def v7_stream_plan(form: str, c: int, f_dim: int, d_lora: int, n_heads: int, head_size: int,
                   vocab: int, blocks: int) -> V7StreamPlan:
    """K3's stream plan in weight form `form` ("i8", "i4", "bf16") for a
    grid of `blocks`: the kernel's Layout7 and Plan7. The ring takes what
    shared memory is left below ``STREAM_SMEM_LIMIT`` after the activations,
    about ``STREAM_TARGET_STAGES`` stages, each at least the largest piece
    (two vector rows, a head's state with its vector slices, one run of its
    lora2 rows, one row of any matrix with its scale window); raises
    ValueError below ``STREAM_MIN_STAGES``, or where the ring cannot hold
    phase A's vector pieces or a head's pieces at once."""
    s, d, w = head_size, d_lora, form != "bf16"
    act_off = _round_up(4 * (2 * c + V7_HV_FLOATS * s + 256 + 8 + V7_AMAX_SLOTS), 16)
    plan_off = _round_up(act_off + (4 if form == "bf16" else 1) * max(6 * c, f_dim, 4 * d), 16)
    l2_run = s * _form_bytes(_small_form(form), d) + (4 * s if w else 0)
    piece = max(8 * c, 4 * s * s + 4 * len(V7_HEAD_VECS) * s, l2_run)
    row = max(_form_bytes(form, c), _form_bytes(form, f_dim), _form_bytes(_small_form(form), c))
    bar_off, ring_off, stage, stages = _ring(plan_off, max(piece, row + _win_bytes(1)))
    plan = V7StreamPlan(form, c, f_dim, d, n_heads, s, vocab, blocks, act_off, bar_off,
                        ring_off, stage, stages, ring_off + stages * stage,
                        min(stage // (4 * c), V7_MAX_VEC_ROWS), min(stage // l2_run, 4))
    if stages < STREAM_MIN_STAGES:
        raise ValueError(f"K3's ring holds {stages} stages of {stage} bytes at these widths, "
                         f"it needs {STREAM_MIN_STAGES}")
    held = max(plan.count("vec_a", 0), 1 + plan.lora2_pieces())
    if held > stages:
        raise ValueError(f"K3 holds {held} pieces at once, its ring {stages} stages")
    return plan


def _v45_dims_error(name: str, cfg, f_dim: int, w4: bool) -> Optional[str]:
    for dim in (cfg.n_embed, f_dim):
        if dim % 16:
            return f"{name} needs C and F to be multiples of 16, got {dim}"
    if w4 and (cfg.n_embed % 32 or f_dim % 32):
        return "int4 rows need C and F to be multiples of 32"
    return None


def v5_decode_shape_error(cfg, f_dim: int, w4: bool = False, form: Optional[str] = None,
                          n_att: int = 4) -> Optional[str]:
    """Why K7 cannot take this model's shapes, or None. K7 walks weight
    rows of any width in 16-byte chunks and streams them in 16-byte pieces
    through shared memory (``v5_stream_plan``, checked in `form`: by default
    the int form `w4` names, with `n_att` attention projections)."""
    s = cfg.head_size
    if cfg.version_major != 5:
        return "K7 decodes RWKV v5 only"
    if s <= 0 or 256 % s or s * s // 256 > 16 or s % 4:
        return f"K7 supports head sizes dividing 256 from 4 up to 64, got {s}"
    err = _v45_dims_error("K7", cfg, f_dim, w4)
    if err:
        return err
    if cfg.n_vocab % 4:
        return ("K7 streams the head's row scales in 16-byte pieces: the vocabulary must be "
                f"a multiple of 4, got {cfg.n_vocab}")
    try:
        v5_stream_plan(form or ("i4" if w4 else "i8"), cfg.n_embed, f_dim, cfg.head_count, s,
                       cfg.n_vocab, 1, n_att)
    except ValueError as e:
        return str(e)
    return None


def v4_decode_shape_error(cfg, f_dim: int, w4: bool = False,
                          form: Optional[str] = None) -> Optional[str]:
    """Why K8 cannot take this model's shapes, or None. K8 walks weight
    rows of any width in 16-byte chunks and streams them in 16-byte pieces
    through shared memory (``v4_stream_plan`` at grid 1, checked in
    `form`: by default the int form `w4` names); any vocabulary (the head's
    rows past the last 4-row group are read outside the stream)."""
    if cfg.version_major != 4:
        return "K8 decodes RWKV v4 only"
    err = _v45_dims_error("K8", cfg, f_dim, w4)
    if err:
        return err
    try:
        v4_stream_plan(form or ("i4" if w4 else "i8"), cfg.n_embed, f_dim, cfg.n_vocab, 1)
    except ValueError as e:
        return str(e)
    return None


# argument counts of the C entries (pointers, ints): rwkv_v5_decode / _w4
# (C, H, S, F, L, V, has_gate, grid) and rwkv_v4_decode / _w4 (C, F, L, V,
# grid); the _bf16 entries take emb_f32 before grid
V5_DECODE_ARGS = (17, 8)
V4_DECODE_ARGS = (21, 5)


def _v45_entry(pack: dict) -> str:
    return f"rwkv_v{pack['version']}_decode" + _SUFFIX[pack["form"]]


def _v45_state_keys(version: int) -> tuple:
    return ("att_xx", "ffn_xx", "heads") if version == 5 else V4_STATE_KEYS


def v45_decode_launch(fn, pack: dict, state: dict, token: torch.Tensor, cfg,
                      scratch_extra: int = 0):
    """Check the operands and launch the C entry `fn` of K7 (a v5 pack) or
    K8 (a v4 pack) once; returns (logits, new state, scratch).
    `scratch_extra` floats are appended to the kernel's scratch (the timing
    build writes there)."""
    dev = pack["mats"].device
    version = pack.get("version")
    if version not in (4, 5) or version != cfg.version_major:
        raise ValueError(f"K7 / K8 need a v5 or v4 pack of this model's version, got {version}")
    c, f, w4 = cfg.n_embed, pack["f_dim"], pack["w4"]
    n_layer, vocab = cfg.n_layer, cfg.n_vocab
    if version == 5:
        err = v5_decode_shape_error(cfg, f, w4, pack["form"], 4 if pack["has_gate"] else 3)
    else:
        err = v4_decode_shape_error(cfg, f, w4, pack["form"])
    if err:
        raise ValueError(err)
    _check_pack(pack)
    token = token.reshape(-1)[:1].to(device=dev, dtype=torch.int32)
    keys = _v45_state_keys(version)
    ins = {k: state[k].to(dev, torch.float32).contiguous() for k in keys}
    for k in keys:
        shape = (n_layer, cfg.head_count, cfg.head_size, cfg.head_size) if k == "heads" else (
            n_layer, c)
        if ins[k].shape != shape:
            raise ValueError(f"{k} state {tuple(ins[k].shape)} != {shape}")
    outs = {k: torch.empty_like(v) for k, v in ins.items()}
    logits = torch.empty((vocab,), dtype=torch.float32, device=dev)
    alloc = torch.zeros if scratch_extra else torch.empty
    scratch = alloc((v45_scratch_floats(version, c, f, n_layer) + scratch_extra,),
                    dtype=torch.float32, device=dev)
    lib = f"v{version}_decode"
    grid = pack.get("_grid_v45")
    if grid is None:
        dims = (c, cfg.head_size, f) if version == 5 else (c, f)
        grid = pack["_grid_v45"] = _grid_blocks(lib, _v45_entry(pack) + "_grid", *dims)
    if version == 4 and pack.get("_plan_v45") != grid:
        _v4_plan_check(pack, cfg, grid)
        pack["_plan_v45"] = grid
    ptrs = [token.data_ptr(), pack["emb"].data_ptr(), pack["ln0"].data_ptr(),
            pack["mats"].data_ptr(), _ptr(pack, "scales"), pack["vecs"].data_ptr(),
            _head(pack).data_ptr(), _ptr(pack, "head_d"), pack["ln_out"].data_ptr()]
    ptrs += [t.data_ptr() for t in [ins[k] for k in keys] + [outs[k] for k in keys]
             + [logits, scratch]]
    if version == 5:
        ints = (c, cfg.head_count, cfg.head_size, f, n_layer, vocab, int(pack["has_gate"]))
    else:
        ints = (c, f, n_layer, vocab)
    code = fn(*ptrs, *ints, *_emb_f32(pack), grid, _cuda.stream_ptr(dev))
    _cuda.check(lib, _v45_entry(pack), code)
    return logits, outs, scratch


def v4_kernel_plan(form: str, c: int, f_dim: int, vocab: int, blocks: int, block: int) -> tuple:
    """K8's own stream plan (the C entry ``rwkv_v4_decode_plan``): (shared
    bytes, stage bytes, stages, block `block`'s pieces a layer and of the
    head of a grid of `blocks`, the kernel's static shared bytes, vector
    rows a piece)."""
    fn = _cuda.library("v4_decode").rwkv_v4_decode_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    _cuda.check("v4_decode", "rwkv_v4_decode_plan",
                fn(FORMS.index(form), c, f_dim, vocab, blocks, block, out))
    return tuple(out)


def _v4_plan_check(pack: dict, cfg, grid: int) -> None:
    """Raises where K8's own plan on a grid of `grid` blocks (its first and
    last block) differs from ``v4_stream_plan``: the producer and the
    consumers would walk different pieces."""
    c, f, vocab = cfg.n_embed, pack["f_dim"], cfg.n_vocab
    plan = v4_stream_plan(pack["form"], c, f, vocab, grid)
    for b in sorted({0, grid - 1}):
        want = (plan.smem_bytes, plan.stage_bytes, plan.n_stages, plan.layer_pieces(b),
                plan.head_pieces(b), V4_STATIC_SMEM, plan.vec_rows)
        got = v4_kernel_plan(pack["form"], c, f, vocab, grid, b)
        if got != want:
            raise RuntimeError(f"K8's plan {got} differs from v4_stream_plan's {want} "
                               f"(block {b} of {grid})")


def _v45_function(pack: dict):
    args = V5_DECODE_ARGS if pack["version"] == 5 else V4_DECODE_ARGS
    return _cuda.function(f"v{pack['version']}_decode", _v45_entry(pack), *_args(args, pack))


def v5_decode_step(pack: dict, state: dict, token: torch.Tensor, cfg):
    """One v5.1/v5.2 decode step at B=1 with the head (see
    ``v5_decode_step_ref`` for the arguments). CUDA tensors launch kernel K7
    once; CPU tensors take the plain version. The input state is not
    modified."""
    if pack["mats"].device.type == "cpu":
        return v5_decode_step_ref(pack, state, token, cfg)
    logits, outs, _ = v45_decode_launch(_v45_function(pack), pack, state, token, cfg)
    _count(v5_decode_step, pack)
    return logits, outs


v5_decode_step.launches = 0
v5_decode_step.launches_by_form = dict.fromkeys(FORMS, 0)


def v4_decode_step(pack: dict, state: dict, token: torch.Tensor, cfg):
    """One v4 decode step at B=1 with the head (see ``v4_decode_step_ref``
    for the arguments). CUDA tensors launch kernel K8 once; CPU tensors
    take the plain version. The input state is not modified."""
    if pack["mats"].device.type == "cpu":
        return v4_decode_step_ref(pack, state, token, cfg)
    logits, outs, _ = v45_decode_launch(_v45_function(pack), pack, state, token, cfg)
    _count(v4_decode_step, pack)
    return logits, outs


v4_decode_step.launches = 0
v4_decode_step.launches_by_form = dict.fromkeys(FORMS, 0)


# -- the pack cache --------------------------------------------------------------
#
# Building a pack quantizes every matrix on the host. save_mega_pack /
# load_mega_pack keep a built host pack (before ``device_pack``) in one .npz
# file, as the JAX package's functions of the same names do: arrays under
# ``arr::<key>``, the pack's scalars under ``__meta__`` as JSON bytes. The
# port's layouts are its own (int4 values one a byte, bf16 as its 16-bit
# pattern), so the meta also names the layout and each array's dtype, and a
# file without that name (the JAX package's, say) is refused.

MEGA_PACK_LAYOUT = "rwkv_tpu_torch.mega_pack/1"


def save_mega_pack(path, pack: dict) -> None:
    """Write a host pack (``build_mega_pack*``) to one .npz file at `path`."""
    import json

    arrays, meta, dtypes = {}, {}, {}
    for k, v in pack.items():
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            dtypes[k] = str(t.dtype).removeprefix("torch.")
            arrays["arr::" + k] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        else:
            meta[k] = v
    meta["__layout__"] = MEGA_PACK_LAYOUT
    meta["__dtypes__"] = dtypes
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_mega_pack(path) -> dict:
    """Read a pack written by ``save_mega_pack``: host tensors in their
    saved dtypes, scalars as Python values. Raises ValueError for a file
    without the port's layout name, or one whose arrays disagree with it."""
    import json

    with np.load(path) as z:
        if "__meta__" not in z.files:
            raise ValueError(f"{path}: not a mega pack (no __meta__)")
        meta = json.loads(bytes(z["__meta__"]).decode())
        layout = meta.pop("__layout__", None)
        if layout != MEGA_PACK_LAYOUT:
            raise ValueError(f"{path}: pack layout {layout!r}, not this package's "
                             f"{MEGA_PACK_LAYOUT!r} (a pack of another layout cannot be read)")
        dtypes = meta.pop("__dtypes__")
        names = {k[len("arr::"):] for k in z.files if k.startswith("arr::")}
        if names != set(dtypes):
            raise ValueError(f"{path}: arrays {sorted(names ^ set(dtypes))} disagree with the meta")
        pack = dict(meta)
        for k, name in dtypes.items():
            t = torch.from_numpy(z["arr::" + k].copy())
            pack[k] = t.view(torch.bfloat16) if name == "bfloat16" else t
            if str(pack[k].dtype).removeprefix("torch.") != name:
                raise ValueError(f"{path}: {k} is {pack[k].dtype}, the meta says {name}")
    return pack


def mega_pack_mismatch(pack: dict, cfg, form: str) -> Optional[str]:
    """Why `pack` cannot serve `cfg` in weight form `form` ("i8", "i4" or
    "bf16"), or None: its version, form, depth, width, vocabulary and (v5)
    gate must be the model's."""
    version = pack.get("version", 7)
    head = pack.get("headbf16", pack.get("head8"))
    got = {"version": version, "form": pack.get("form"),
           "n_layer": pack[_layout(pack)[0][0]].shape[0],
           "n_embed": pack["ln_out.weight"].shape[0],
           "n_vocab": None if head is None else head.shape[0]}
    want = {"version": cfg.version_major, "form": form, "n_layer": cfg.n_layer,
            "n_embed": cfg.n_embed, "n_vocab": cfg.n_vocab}
    if version == 5 == cfg.version_major:
        got["has_gate"], want["has_gate"] = pack.get("has_gate"), cfg.version_minor >= 2
    bad = [f"{k} {got[k]} (the model's {want[k]})" for k in want if got[k] != want[k]]
    return "; ".join(bad) or None

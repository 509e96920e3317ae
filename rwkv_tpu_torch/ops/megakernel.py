"""Whole-model v7 decode step at B=1, w8a8, LM head included (kernel K3).

Ports the w8 parts of ``rwkv_tpu.ops.megakernel``: ``_quantize_rows``,
``build_mega_pack(quant=True, head=True)`` and ``v7_decode_megakernel``.
The TPU kernel's VMEM layouts (``[C, 1]`` columns, ``rowify_mega_pack``, the
head-pair state) are not carried over: the port keeps the serving state
layout (heads ``[L, H, S_i, S_j]``) and packs each layer's six int8
matrices, their row scales and its vectors into three flat buffers
(``device_pack``).

``v7_decode_step`` runs the hand-written cooperative CUDA kernel
``csrc/v7_decode.cu`` on CUDA tensors (counting launches in
``v7_decode_step.launches``) and ``v7_decode_step_ref`` -- the plain
PyTorch version -- on CPU tensors. Each matvec quantizes its input vector
as a whole (amax over all of it), as the TPU kernel does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rwkv_tpu_torch.ops import _cuda
from rwkv_tpu_torch.ops.kernels import int_dot_plain, quantize_act_plain, quantize_rows_np
from rwkv_tpu_torch.ops.parity import layer_norm

# per-layer vector rows of the flat pack; the kernel's VecRow enum matches
VEC_KEYS = (
    "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
    "att.w0", "att.a0", "att.v0", "att.k_k", "att.k_a",
    "att.ln_x.weight", "att.ln_x.bias", "ffn.x_k",
)
MAT_KEYS = ("rkv", "lora1", "lora2", "out", "fk", "fv")
_V7_RKV = ("att.receptance.weight", "att.key.weight", "att.value.weight")
_V7_L1 = ("att.w1", "att.a1", "att.g1", "att.v1")
_V7_L2 = ("att.w2", "att.a2", "att.g2", "att.v2")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _quantize_rows(w):
    """[L, N, K] f32 -> (int8 codes [L, N, K], row scales [L, N]), scale
    amax/127 (the int4 form of the JAX package is not ported yet)."""
    q, d = quantize_rows_np(_np(w))
    return torch.from_numpy(q), torch.from_numpy(d)


def build_mega_pack(params: dict, cfg) -> dict:
    """The decode kernel's w8a8 parameter pack with the LM head (the JAX
    package's ``build_mega_pack(quant=True, head=True)``), built on the host
    from the port's parameter tree (dense ``[out, in]`` weights).

    Matrices are int8 ``[L, N, K]`` with row scales ``[L, N]``, fused in the
    TPU kernel's row order (rkv = r, k, v; lora1 / lora2 = w, a, g, v);
    vectors ``[L, C]``; ``coeff`` ``[L, 6, C]`` (r, w, k, v, a, g);
    ``r_k`` ``[L, C]``; ``head8`` ``[V, C]`` with ``head_d`` ``[V]``."""
    if cfg.version_major != 7:
        raise NotImplementedError("the decode kernel is RWKV v7 only")
    c = cfg.n_embed
    blocks = [dict(b) for b in params["blocks"]]
    n_layer = len(blocks)
    if n_layer > 1:
        # layer 0 has no v0/v1/v2; its value residual is selected away
        for key in ("att.v0", "att.v1", "att.v2"):
            if key not in blocks[0]:
                blocks[0][key] = np.zeros_like(_np(blocks[1][key]))

    def stack(keys_or_key):
        if isinstance(keys_or_key, tuple):
            return np.stack([np.concatenate([_np(b[k]) for k in keys_or_key]) for b in blocks])
        return np.stack([_np(b[keys_or_key]) for b in blocks])

    pack = {
        "quant": True,
        "d_lora": _np(blocks[-1]["att.w1"]).shape[0],
        "f_dim": _np(blocks[0]["ffn.key.weight"]).shape[0],
    }
    mats = {
        "rkv": stack(_V7_RKV),
        "lora1": stack(_V7_L1),
        "lora2": stack(_V7_L2),
        "out": stack("att.output.weight"),
        "fk": stack("ffn.key.weight"),
        "fv": stack("ffn.value.weight"),
    }
    for name, w in mats.items():
        pack[name], pack[name + "_d"] = _quantize_rows(w)
    for key in VEC_KEYS:
        pack[key] = torch.from_numpy(stack(key).reshape(n_layer, c))
    pack["coeff"] = torch.from_numpy(stack("att.x_rwkvag").reshape(n_layer, 6, c))
    pack["r_k"] = torch.from_numpy(stack("att.r_k").reshape(n_layer, c))
    q, d = _quantize_rows(_np(params["head"])[None])
    pack["head8"], pack["head_d"] = q[0], d[0]
    pack["ln_out.weight"] = torch.from_numpy(_np(params["ln_out"][0]).copy())
    pack["ln_out.bias"] = torch.from_numpy(_np(params["ln_out"][1]).copy())
    return pack


def device_pack(pack: dict, emb: torch.Tensor, ln0, device) -> dict:
    """`pack` on `device` in the kernel's flat layout: ``mats`` int8
    ``[L, per-layer bytes]`` (rkv|lora1|lora2|out|fk|fv), ``scales`` f32
    ``[L, 9C + 4d + F]`` in the same order, ``vecs`` f32 ``[L, 19, C]``
    (VEC_KEYS, the six coeff rows, r_k). The named tensors of `pack` become
    views into these buffers, so ``v7_decode_step_ref`` reads the same
    memory. `emb` (the serving embedding, bf16 under w8a8) and `ln0` ride
    along: the kernel embeds the token itself."""
    n_layer = pack["rkv"].shape[0]
    dev = torch.device(device)
    out = {k: pack[k] for k in ("quant", "d_lora", "f_dim")}
    mats = torch.cat([pack[k].reshape(n_layer, -1) for k in MAT_KEYS], dim=1).to(dev)
    scales = torch.cat([pack[k + "_d"] for k in MAT_KEYS], dim=1).to(dev)
    vecs = torch.cat(
        [torch.stack([pack[k] for k in VEC_KEYS], dim=1), pack["coeff"], pack["r_k"][:, None]],
        dim=1,
    ).to(dev).contiguous()
    out.update(mats=mats, scales=scales, vecs=vecs)
    mo = so = 0
    for k in MAT_KEYS:
        n, kk = pack[k].shape[1:]
        out[k] = mats[:, mo : mo + n * kk].unflatten(1, (n, kk))
        out[k + "_d"] = scales[:, so : so + n]
        mo += n * kk
        so += n
    for i, k in enumerate(VEC_KEYS):
        out[k] = vecs[:, i]
    n_vec = len(VEC_KEYS)
    out["coeff"] = vecs[:, n_vec : n_vec + 6]
    out["r_k"] = vecs[:, n_vec + 6]
    out["head8"] = pack["head8"].to(dev).contiguous()
    out["head_d"] = pack["head_d"].to(dev).contiguous()
    out["ln_out"] = torch.stack([pack["ln_out.weight"], pack["ln_out.bias"]]).to(dev)
    out["ln0"] = torch.stack([ln0[0].float(), ln0[1].float()]).to(dev)
    out["emb"] = emb.to(dev).contiguous()
    return out


def _matvec(q, d, x):
    """w8a8 matvec with the whole vector x quantized once."""
    x8, dx = quantize_act_plain(x[None])
    return (int_dot_plain(x8, q) * dx * d)[0]


def v7_decode_step_ref(pack: dict, state: dict, token: torch.Tensor, cfg):
    """Plain PyTorch K3 (any device). `pack` from ``device_pack``; `state`
    arrays ``att_xx`` / ``ffn_xx`` ``[L, C]`` and ``heads`` ``[L, H, S, S]``;
    `token` an int tensor of one element. Returns (logits [V], new state)."""
    h, s = cfg.head_count, cfg.head_size
    c = cfg.n_embed
    d_l = pack["d_lora"]
    row = pack["emb"][token.reshape(-1)[:1].to(pack["emb"].device, torch.long)][0]
    x = layer_norm(row.float(), pack["ln0"][0], pack["ln0"][1])
    att_out, ffn_out, heads_out = [], [], []
    v_first = None
    for l in range(cfg.n_layer):
        def vec(key):
            return pack[key][l]

        rkv, rkv_d = pack["rkv"][l], pack["rkv_d"][l]
        l1, l1_d = pack["lora1"][l], pack["lora1_d"][l]
        l2, l2_d = pack["lora2"][l], pack["lora2_d"][l]

        xl = layer_norm(x, vec("ln1.weight"), vec("ln1.bias"))
        sx = state["att_xx"][l] - xl
        att_out.append(xl)
        cf = pack["coeff"][l]
        xr, xw, xk, xv, xa, xg = (xl + sx * cf[i] for i in range(6))

        r = _matvec(rkv[:c], rkv_d[:c], xr)
        k = _matvec(rkv[c : 2 * c], rkv_d[c : 2 * c], xk)
        v = _matvec(rkv[2 * c :], rkv_d[2 * c :], xv)
        w_dn = torch.tanh(_matvec(l1[:d_l], l1_d[:d_l], xw))
        a_dn = _matvec(l1[d_l : 2 * d_l], l1_d[d_l : 2 * d_l], xa)
        g_dn = torch.sigmoid(_matvec(l1[2 * d_l : 3 * d_l], l1_d[2 * d_l : 3 * d_l], xg))
        v_dn = _matvec(l1[3 * d_l :], l1_d[3 * d_l :], xv)
        w_l = _matvec(l2[:c], l2_d[:c], w_dn)
        a_l = _matvec(l2[c : 2 * c], l2_d[c : 2 * c], a_dn)
        g = _matvec(l2[2 * c : 3 * c], l2_d[2 * c : 3 * c], g_dn)
        vmix_l = _matvec(l2[3 * c :], l2_d[3 * c :], v_dn)

        w_dec = torch.exp(torch.sigmoid(w_l + vec("att.w0")) * -0.606531)
        a_gate = torch.sigmoid(a_l + vec("att.a0"))
        kk = (k * vec("att.k_k")).reshape(h, s)
        kk = kk / torch.clamp(torch.sqrt((kk * kk).sum(-1, keepdim=True)), min=1e-12)
        ka = k * vec("att.k_a")
        k = k + (a_gate * ka - ka)
        if l == 0:
            v_first = v
        else:
            v = v + (v_first - v) * torch.sigmoid(vmix_l + vec("att.v0"))

        r3, w3, k3, v3 = (t.reshape(h, s) for t in (r, w_dec, k, v))
        a3, b3 = -kk, kk * a_gate.reshape(h, s)
        st = state["heads"][l]
        sa = torch.einsum("hij,hj->hi", st, a3)
        st = st * w3[:, None, :] + v3[:, :, None] * k3[:, None, :] + sa[:, :, None] * b3[:, None, :]
        y = torch.einsum("hij,hj->hi", st, r3)
        heads_out.append(st)
        mu = y.mean(-1, keepdim=True)
        yc = y - mu
        var = (yc * yc).mean(-1, keepdim=True)
        yn = (yc * torch.rsqrt(var + 64e-5)).reshape(c)
        xo = yn * vec("att.ln_x.weight") + vec("att.ln_x.bias")
        bonus = (v3 * (k3 * r3 * vec("r_k").reshape(h, s)).sum(-1, keepdim=True)).reshape(c)
        xo = (xo + bonus) * g
        x = x + _matvec(pack["out"][l], pack["out_d"][l], xo)

        xl2 = layer_norm(x, vec("ln2.weight"), vec("ln2.bias"))
        ffn_out.append(xl2)
        xk2 = xl2 + (state["ffn_xx"][l] - xl2) * vec("ffn.x_k")
        fk = torch.square(torch.relu(_matvec(pack["fk"][l], pack["fk_d"][l], xk2)))
        x = x + _matvec(pack["fv"][l], pack["fv_d"][l], fk)
    xo = layer_norm(x, pack["ln_out"][0], pack["ln_out"][1])
    logits = _matvec(pack["head8"], pack["head_d"], xo)
    new_state = {
        "att_xx": torch.stack(att_out),
        "ffn_xx": torch.stack(ffn_out),
        "heads": torch.stack(heads_out),
    }
    return logits, new_state


def decode_scratch_floats(c: int, d_lora: int, f_dim: int) -> int:
    """Floats of K3's global scratch (``scratch_floats`` in the source)."""
    return 7 * c + 4 * d_lora + f_dim


def _chunks_per_lane(k: int, max_lanes: int = 32) -> int:
    """16-byte chunks each lane reads per weight row of width k in the
    decode kernel (its matvec_rows: the largest power-of-two lane count up to
    max_lanes that divides k / 16 shares a row)."""
    chunks = k // 16
    lanes = max_lanes
    while lanes > 1 and chunks % lanes:
        lanes //= 2
    return chunks // lanes


def _grid_blocks(cfg, d_lora: int, f_dim: int) -> int:
    lib = _cuda.library("v7_decode")
    fn = lib.rwkv_v7_decode_grid
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(cfg.n_embed, cfg.head_size, d_lora, f_dim)
    if n < 0:
        _cuda.check("v7_decode", "rwkv_v7_decode_grid", -n)
    if n == 0:
        raise RuntimeError("the decode kernel does not fit on an SM at this model's sizes")
    return n


def decode_launch(fn, pack: dict, state: dict, token: torch.Tensor, cfg, scratch_extra: int = 0):
    """Check the operands and launch the C entry `fn` (``rwkv_v7_decode``)
    once; returns (logits, new state, scratch). `scratch_extra` floats are
    appended to the kernel's scratch (the timing build writes there)."""
    dev = pack["mats"].device
    c, h, s = cfg.n_embed, cfg.head_count, cfg.head_size
    d_l, f = pack["d_lora"], pack["f_dim"]
    n_layer, vocab = cfg.n_layer, cfg.n_vocab
    if 256 % s or s * s // 256 > 16:
        raise ValueError(f"the decode kernel supports head sizes dividing 256 up to 64, got {s}")
    # rows of width C (the head with at most 8 lanes), d_lora (one lane) and F
    for dim, lanes in ((c, 8), (d_l, 1), (f, 32)):
        if dim % 16 or _chunks_per_lane(dim, lanes) > 8:
            raise ValueError(
                f"the decode kernel needs C, d_lora and F to be multiples of 16 that a "
                f"warp reads in at most 8 16-byte chunks per lane; got {dim}")
    if pack["emb"].dtype != torch.bfloat16:
        raise TypeError("the decode kernel embeds from a bf16 table")
    token = token.reshape(-1)[:1].to(device=dev, dtype=torch.int32)
    ins = {k: state[k].to(dev, torch.float32).contiguous() for k in ("att_xx", "ffn_xx", "heads")}
    if ins["heads"].shape != (n_layer, h, s, s):
        raise ValueError(f"heads state {tuple(ins['heads'].shape)} != {(n_layer, h, s, s)}")
    outs = {k: torch.empty_like(v) for k, v in ins.items()}
    logits = torch.empty((vocab,), dtype=torch.float32, device=dev)
    # the timing build's stamps go into a zeroed tail; otherwise no fill
    alloc = torch.zeros if scratch_extra else torch.empty
    scratch = alloc((decode_scratch_floats(c, d_l, f) + scratch_extra,),
                    dtype=torch.float32, device=dev)
    grid = pack.get("_grid")
    if grid is None:
        grid = pack["_grid"] = _grid_blocks(cfg, d_l, f)
    code = fn(
        token.data_ptr(), pack["emb"].data_ptr(), pack["ln0"].data_ptr(),
        pack["mats"].data_ptr(), pack["scales"].data_ptr(), pack["vecs"].data_ptr(),
        pack["head8"].data_ptr(), pack["head_d"].data_ptr(), pack["ln_out"].data_ptr(),
        ins["att_xx"].data_ptr(), ins["ffn_xx"].data_ptr(), ins["heads"].data_ptr(),
        outs["att_xx"].data_ptr(), outs["ffn_xx"].data_ptr(), outs["heads"].data_ptr(),
        logits.data_ptr(), scratch.data_ptr(),
        c, h, s, d_l, f, n_layer, vocab, grid, _cuda.stream_ptr(dev),
    )
    _cuda.check("v7_decode", "rwkv_v7_decode", code)
    return logits, outs, scratch


def v7_decode_step(pack: dict, state: dict, token: torch.Tensor, cfg):
    """One decode step at B=1 (see ``v7_decode_step_ref`` for the
    arguments). CUDA tensors launch kernel K3 once; CPU tensors take the
    plain version. The input state is not modified."""
    if pack["mats"].device.type == "cpu":
        return v7_decode_step_ref(pack, state, token, cfg)
    fn = _cuda.function("v7_decode", "rwkv_v7_decode", 17, 8)
    logits, outs, _ = decode_launch(fn, pack, state, token, cfg)
    v7_decode_step.launches += 1
    return logits, outs


v7_decode_step.launches = 0

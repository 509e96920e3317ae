"""Plain PyTorch forward graph for RWKV v6 and v7.

Ports the v6 and v7 parts of ``rwkv_tpu.models.graph``: the wkv6 and wkv7
recurrences (``wkv6_scan`` / ``wkv7_scan`` and their ``_trace`` forms),
``att_v6`` / ``ffn_v6``, ``att_v7`` / ``ffn_v7`` and ``forward``.
``forward`` is the float32 oracle of the port. State matrices are
``S[h, i, j]`` with i the value dim and j the key dim.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from rwkv_tpu_torch.models.config import ModelConfig
from rwkv_tpu_torch.ops.parity import group_norm, l2_normalize, layer_norm, mm

Params = dict[str, Any]
State = dict[str, torch.Tensor]


def _token_shift(x_ln: torch.Tensor, carry: torch.Tensor):
    """x_prev is the previous token's post-layernorm activation, seeded by
    the carried state row; the new carry is the last token's activation."""
    x_prev = torch.cat([carry[None], x_ln[:-1]], dim=0)
    return x_prev, x_ln[-1]


def _wkv6_step(s, rt, kt, vt, wt, tf):
    """One wkv6 token: the output reads the OLD state plus the tf bonus,
    then the state decays and takes k v^T."""
    y = torch.einsum("...ij,...j->...i", s, rt) + vt * (rt * tf * kt).sum(dim=-1, keepdim=True)
    s = s * wt[..., None, :] + vt[..., :, None] * kt[..., None, :]
    return s, y


def wkv6_scan(s, r, k, v, w, tf):
    """RWKV v5/v6 multi-head linear attention (ggml_rwkv_wkv6 semantics):
      out[h,i]  = sum_j r[h,j] * (tf[h,j]*k[h,j]*v[h,i] + S[h,i,j])
      S'[h,i,j] = S[h,i,j]*w[h,j] + k[h,j]*v[h,i]
    r/k/v: [T, ..., H, S]; w: the same (v6) or [H, S] broadcast (v5);
    tf: [H, S]. Returns (y, final s)."""
    if w.ndim == 2:
        w = w.expand(r.shape)
    ys = []
    for t in range(r.shape[0]):
        s, y = _wkv6_step(s, r[t], k[t], v[t], w[t], tf)
        ys.append(y)
    return torch.stack(ys), s


def wkv6_scan_trace(s, r, k, v, w, tf):
    """wkv6_scan that also returns the state AFTER every step:
    (y [T, ..., H, S], s_all [T, ..., H, S, S])."""
    if w.ndim == 2:
        w = w.expand(r.shape)
    ys, states = [], []
    for t in range(r.shape[0]):
        s, y = _wkv6_step(s, r[t], k[t], v[t], w[t], tf)
        ys.append(y)
        states.append(s)
    return torch.stack(ys), torch.stack(states)


def wkv7_scan(s, r, w, k, v, a, b):
    """RWKV v7 generalized delta rule, one token at a time:
      sa[h,i]   = sum_j a[h,j] * S[h,i,j]
      S'[h,i,j] = S[h,i,j]*w[h,j] + k[h,j]*v[h,i] + sa[h,i]*b[h,j]
      out[h,i]  = sum_j S'[h,i,j] * r[h,j]
    r/w/k/v/a/b: [T, ..., H, S]; s: [..., H, S, S]. Returns (y, final s)."""
    ys = []
    for t in range(r.shape[0]):
        sa = torch.einsum("...ij,...j->...i", s, a[t])
        s = s * w[t][..., None, :] + v[t][..., :, None] * k[t][..., None, :] + sa[..., :, None] * b[t][..., None, :]
        ys.append(torch.einsum("...ij,...j->...i", s, r[t]))
    return torch.stack(ys), s


def wkv7_scan_trace(s, r, w, k, v, a, b):
    """wkv7_scan that also returns the state AFTER every step:
    (y [T, ..., H, S], s_all [T, ..., H, S, S])."""
    ys, states = [], []
    for t in range(r.shape[0]):
        sa = torch.einsum("...ij,...j->...i", s, a[t])
        s = s * w[t][..., None, :] + v[t][..., :, None] * k[t][..., None, :] + sa[..., :, None] * b[t][..., None, :]
        ys.append(torch.einsum("...ij,...j->...i", s, r[t]))
        states.append(s)
    return torch.stack(ys), torch.stack(states)


def att_v6(layer: Params, x, att_xx, heads, cfg: ModelConfig, wkv_fn=None, trace=False):
    """v6 time mix: LoRA-style dynamic five-way token-shift mix and dynamic
    decay, silu gate. `wkv_fn` overrides the recurrence (the prefill
    dispatch ``ops.chunked.wkv6_auto``); trace=True additionally returns
    (xl, heads_all), the per-position recurrent state.

    The ``time_maa_w2`` up-projection is a float32 product (the JAX
    package's f32 HIGHEST einsum): callers on the card keep TF32 off."""
    h, s = cfg.head_count, cfg.head_size
    lead, c = x.shape[:-1], x.shape[-1]
    xl = layer_norm(x, layer["ln1.weight"], layer["ln1.bias"])
    x_prev, new_xx = _token_shift(xl, att_xx)
    sx = x_prev - xl

    xxx = xl + sx * layer["att.time_maa_x"]
    mix = torch.tanh(mm(xxx, layer["att.time_maa_w1"])).reshape(*lead, 5, -1)
    # m[s_idx, ..., c] = sum_d mix[..., s_idx, d] * W2[s_idx, c, d]
    m = torch.einsum("...sd,scd->s...c", mix, layer["att.time_maa_w2"])
    mw, mk_, mv, mr, mg = m[0], m[1], m[2], m[3], m[4]

    xw = (mw + layer["att.time_maa_w"]) * sx + xl
    xk = (mk_ + layer["att.time_maa_k"]) * sx + xl
    xv = (mv + layer["att.time_maa_v"]) * sx + xl
    xr = (mr + layer["att.time_maa_r"]) * sx + xl
    xg = (mg + layer["att.time_maa_g"]) * sx + xl

    r = mm(xr, layer["att.receptance.weight"]).reshape(*lead, h, s)
    k = mm(xk, layer["att.key.weight"]).reshape(*lead, h, s)
    v = mm(xv, layer["att.value.weight"]).reshape(*lead, h, s)
    g = torch.nn.functional.silu(mm(xg, layer["att.gate.weight"]))

    w = mm(torch.tanh(mm(xw, layer["att.time_decay_w1"])), layer["att.time_decay_w2"])
    w = w + layer["att.time_decay"].reshape(-1)
    w = torch.exp(-torch.exp(w)).reshape(*lead, h, s)

    tf = layer["att.time_faaaa"]
    if trace:
        y, heads_all = wkv6_scan_trace(heads, r, k, v, w, tf)
        heads = heads_all[-1]
    else:
        y, heads = (wkv_fn or wkv6_scan)(heads, r, k, v, w, tf)
    xo = group_norm(
        y.reshape(*lead, c), layer["att.ln_x.weight"], layer["att.ln_x.bias"], h, eps=64e-5
    )
    out = mm(xo * g, layer["att.output.weight"])
    if trace:
        return out, new_xx, heads, (xl, heads_all)
    return out, new_xx, heads


def att_v7(
    layer: Params,
    x,
    att_xx,
    heads,
    v_first: Optional[torch.Tensor],
    cfg: ModelConfig,
    is_first: Optional[bool] = None,
    wkv_fn=None,
    trace=False,
):
    """v7 time mix: six-way shift, low-rank w/a/g/v gates, l2-normalized
    kk, cross-layer value residual and the r.k.r_k bonus.

    `is_first`: None for the unrolled path (v_first=None marks layer 0);
    a bool for the stacked serving path, where layer 0's v0/v1/v2 are
    zero-padded and the value residual is computed and selected away, as
    the JAX package's scan over layers does.

    trace=True additionally returns (xl, heads_all), the per-position
    recurrent state."""
    h, s = cfg.head_count, cfg.head_size
    lead, c = x.shape[:-1], x.shape[-1]
    xl = layer_norm(x, layer["ln1.weight"], layer["ln1.bias"])
    x_prev, new_xx = _token_shift(xl, att_xx)
    sx = x_prev - xl

    coeff = layer["att.x_rwkvag"].reshape(6, *([1] * len(lead)), c)
    xxx = xl[None] + sx[None] * coeff  # [6, ..., C]
    xr, xw, xk, xv, xa, xg = (xxx[i] for i in range(6))

    r = mm(xr, layer["att.receptance.weight"])
    g = mm(torch.sigmoid(mm(xg, layer["att.g1"])), layer["att.g2"])
    a = torch.sigmoid(mm(mm(xa, layer["att.a1"]), layer["att.a2"]) + layer["att.a0"])

    w = mm(torch.tanh(mm(xw, layer["att.w1"])), layer["att.w2"]) + layer["att.w0"]
    w = torch.exp(torch.sigmoid(w) * -0.606531)

    k = mm(xk, layer["att.key.weight"])
    kk = l2_normalize((k * layer["att.k_k"]).reshape(*lead, h, s))
    ka = k * layer["att.k_a"]
    k = k + (a * ka - ka)

    v = mm(xv, layer["att.value.weight"])
    if is_first is None:
        if v_first is None:
            v_first = v
        else:
            v = v + (v_first - v) * torch.sigmoid(
                mm(mm(xv, layer["att.v1"]), layer["att.v2"]) + layer["att.v0"]
            )
    else:
        v_mix = v + (v_first - v) * torch.sigmoid(
            mm(mm(xv, layer["att.v1"]), layer["att.v2"]) + layer["att.v0"]
        )
        if is_first:
            v_first = v
        else:
            v = v_mix

    rh = r.reshape(*lead, h, s)
    wh = w.reshape(*lead, h, s)
    kh = k.reshape(*lead, h, s)
    vh = v.reshape(*lead, h, s)
    ah = a.reshape(*lead, h, s)

    if trace:
        y, heads_all = wkv7_scan_trace(heads, rh, wh, kh, vh, -kk, kk * ah)
        heads = heads_all[-1]
    else:
        y, heads = (wkv_fn or wkv7_scan)(heads, rh, wh, kh, vh, -kk, kk * ah)
    xo = group_norm(
        y.reshape(*lead, c), layer["att.ln_x.weight"], layer["att.ln_x.bias"], h, eps=64e-5
    )
    bonus = (vh * (kh * rh * layer["att.r_k"]).sum(dim=-1, keepdim=True)).reshape(*lead, c)
    xo = (xo + bonus) * g
    out = mm(xo, layer["att.output.weight"])
    if trace:
        return out, new_xx, heads, v_first, (xl, heads_all)
    return out, new_xx, heads, v_first


def ffn_v6(layer: Params, x, ffn_xx):
    """v6 channel mix: relu^2 key with a sigmoid receptance gate."""
    xl = layer_norm(x, layer["ln2.weight"], layer["ln2.bias"])
    x_prev, new_xx = _token_shift(xl, ffn_xx)
    sx = x_prev - xl
    xk = sx * layer["ffn.time_maa_k"] + xl
    xr = sx * layer["ffn.time_maa_r"] + xl
    r = torch.sigmoid(mm(xr, layer["ffn.receptance.weight"]))
    k = torch.square(torch.relu(mm(xk, layer["ffn.key.weight"])))
    return r * mm(k, layer["ffn.value.weight"]), new_xx


def ffn_v7(layer: Params, x, ffn_xx):
    """v7 channel mix: relu^2 key, no receptance gate."""
    xl = layer_norm(x, layer["ln2.weight"], layer["ln2.bias"])
    x_prev, new_xx = _token_shift(xl, ffn_xx)
    sx = x_prev - xl
    xk = sx * layer["ffn.x_k"] + xl
    k = torch.square(torch.relu(mm(xk, layer["ffn.key.weight"])))
    return mm(k, layer["ffn.value.weight"]), new_xx


def forward(
    params: Params,
    state: State,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    compute_logits: bool = True,
):
    """One v6 or v7 forward pass over `tokens` [T] with recurrent `state`
    (arrays [L, ...]). Returns (logits [n_vocab] for the last token, or
    None, new state)."""
    major = cfg.version_major
    if major not in (6, 7):
        raise NotImplementedError("the port's forward graph is RWKV v6 and v7 only")
    emb = params["emb"][tokens]
    x = layer_norm(emb.float(), *params["ln0"])

    v_first = None
    new_att_xx, new_ffn_xx, new_heads = [], [], []
    for i, layer in enumerate(params["blocks"]):
        if major == 7:
            dx, att_xx, heads, v_first = att_v7(
                layer, x, state["att_xx"][i], state["heads"][i], v_first, cfg
            )
            x = x + dx
            dx, ffn_xx = ffn_v7(layer, x, state["ffn_xx"][i])
        else:
            dx, att_xx, heads = att_v6(layer, x, state["att_xx"][i], state["heads"][i], cfg)
            x = x + dx
            dx, ffn_xx = ffn_v6(layer, x, state["ffn_xx"][i])
        x = x + dx
        new_heads.append(heads)
        new_att_xx.append(att_xx)
        new_ffn_xx.append(ffn_xx)

    new_state: State = {
        "att_xx": torch.stack(new_att_xx),
        "ffn_xx": torch.stack(new_ffn_xx),
        "heads": torch.stack(new_heads),
    }
    logits = None
    if compute_logits:
        xo = layer_norm(x[-1], *params["ln_out"])
        logits = mm(xo[None, :], params["head"])[0]
    return logits, new_state

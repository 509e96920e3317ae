"""Plain PyTorch forward graph for RWKV v7.

Ports the v7 parts of ``rwkv_tpu.models.graph``: the wkv7 recurrence
(``wkv7_scan`` / ``wkv7_scan_trace``), ``att_v7``, ``ffn_v7`` and
``forward``. ``forward`` is the float32 oracle of the port. State matrices
are ``S[h, i, j]`` with i the value dim and j the key dim.
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
    """One v7 forward pass over `tokens` [T] with recurrent `state`
    (arrays [L, ...]). Returns (logits [n_vocab] for the last token, or
    None, new state)."""
    if cfg.version_major != 7:
        raise NotImplementedError("the port's forward graph is RWKV v7 only")
    emb = params["emb"][tokens]
    x = layer_norm(emb.float(), *params["ln0"])

    v_first = None
    new_att_xx, new_ffn_xx, new_heads = [], [], []
    for i, layer in enumerate(params["blocks"]):
        dx, att_xx, heads, v_first = att_v7(
            layer, x, state["att_xx"][i], state["heads"][i], v_first, cfg
        )
        x = x + dx
        dx, ffn_xx = ffn_v7(layer, x, state["ffn_xx"][i])
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

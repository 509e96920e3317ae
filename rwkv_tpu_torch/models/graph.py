"""Plain PyTorch forward graph for RWKV v4, v5.1, v5.2, v6 and v7.

Ports ``rwkv_tpu.models.graph``: the wkv4, wkv6 and wkv7 recurrences
(``wkv4_scan`` / ``wkv6_scan`` / ``wkv7_scan`` and their ``_trace``
forms), ``att_v4``, ``att_v5`` and ``ffn_v4_v5``, ``att_v6`` / ``ffn_v6``,
``att_v7`` / ``ffn_v7`` and ``forward``. ``forward`` is the float32 oracle
of the port. State matrices are ``S[h, i, j]`` with i the value dim and j
the key dim; v4 carries the scalar ``aa`` / ``bb`` / ``pp`` columns instead.
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


def _mix(x: torch.Tensor, x_prev: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """v4/v5 time mix: x*c + x_prev*(1-c), in the reference's op order
    ``x*c + (x_prev - x_prev*c)`` (a different rounding flips int8 codes
    downstream)."""
    return x * coeff + (x_prev - x_prev * coeff)


def _wkv4_step(tf, td, kt, vt, aa, bb, pp):
    """One wkv4 token with the max-trick: (wkv, aa', bb', pp')."""
    ww = tf + kt
    qq = torch.maximum(pp, ww)
    e1 = torch.exp(pp - qq)
    e2 = torch.exp(ww - qq)
    wkv = (e1 * aa + e2 * vt) / (e1 * bb + e2)
    ww2 = pp + td
    qq2 = torch.maximum(ww2, kt)
    e1b = torch.exp(ww2 - qq2)
    e2b = torch.exp(kt - qq2)
    return wkv, e1b * aa + e2b * vt, e1b * bb + e2b, qq2


def wkv4_scan(tf, td, k, v, aa, bb, pp):
    """RWKV v4 scalar-state wkv with the max-trick for numerical
    stability. k, v: [T, ..., C]; tf/td: [C]; aa/bb/pp: [..., C]. Returns
    (wkv [T, ..., C], aa, bb, pp)."""
    ys = []
    for t in range(k.shape[0]):
        y, aa, bb, pp = _wkv4_step(tf, td, k[t], v[t], aa, bb, pp)
        ys.append(y)
    return torch.stack(ys), aa, bb, pp


def wkv4_scan_trace(tf, td, k, v, aa, bb, pp, wkv_fn=None):
    """wkv4_scan that also returns aa/bb/pp AFTER every step:
    (wkv, aa_all, bb_all, pp_all), each [T, ..., C]. `wkv_fn` (default
    ``wkv4_scan``) runs each token: the serving path passes its own
    dispatch, so that every position's state has the bits its one-token
    decode step gives it."""
    ys, aas, bbs, pps = [], [], [], []
    for t in range(k.shape[0]):
        y, aa, bb, pp = (wkv_fn or wkv4_scan)(tf, td, k[t : t + 1], v[t : t + 1], aa, bb, pp)
        ys.append(y)
        aas.append(aa)
        bbs.append(bb)
        pps.append(pp)
    return torch.cat(ys), torch.stack(aas), torch.stack(bbs), torch.stack(pps)


def _scan_trace(wkv_fn, s, seq, static=()):
    """`wkv_fn` one token at a time from state `s`: the per-token operands
    `seq` ([T, ...], each call a [1, ...] slice) then `static`. Returns
    (y [T, ...], the state after every token [T, ...])."""
    ys, states = [], []
    for t in range(seq[0].shape[0]):
        y, s = wkv_fn(s, *(x[t : t + 1] for x in seq), *static)
        ys.append(y)
        states.append(s)
    return torch.cat(ys), torch.stack(states)


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


def wkv6_scan_trace(s, r, k, v, w, tf, wkv_fn=None):
    """wkv6_scan that also returns the state AFTER every step:
    (y [T, ..., H, S], s_all [T, ..., H, S, S]). `wkv_fn` as in
    ``wkv4_scan_trace`` (default ``wkv6_scan``)."""
    if w.ndim == r.ndim:
        return _scan_trace(wkv_fn or wkv6_scan, s, (r, k, v, w), (tf,))
    return _scan_trace(wkv_fn or wkv6_scan, s, (r, k, v), (w, tf))


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


def wkv7_scan_trace(s, r, w, k, v, a, b, wkv_fn=None):
    """wkv7_scan that also returns the state AFTER every step:
    (y [T, ..., H, S], s_all [T, ..., H, S, S]). `wkv_fn` as in
    ``wkv4_scan_trace`` (default ``wkv7_scan``)."""
    return _scan_trace(wkv_fn or wkv7_scan, s, (r, w, k, v, a, b))


def att_v4(layer: Params, x, att_xx, aa, bb, pp, trace=False, wkv_fn=None):
    """v4 time mix: three-way shift mix, sigmoid receptance multiplying
    the scalar-state wkv before the output projection. `wkv_fn` overrides
    the recurrence (the prefill dispatch ``ops.chunked.wkv4_auto``);
    trace=True additionally returns (xl, aa_all, bb_all, pp_all), the
    recurrence run token by token (through `wkv_fn` where given)."""
    xl = layer_norm(x, layer["ln1.weight"], layer["ln1.bias"])
    x_prev, new_xx = _token_shift(xl, att_xx)

    xk = _mix(xl, x_prev, layer["att.time_mix_k"])
    xv = _mix(xl, x_prev, layer["att.time_mix_v"])
    xr = _mix(xl, x_prev, layer["att.time_mix_r"])

    r = torch.sigmoid(mm(xr, layer["att.receptance.weight"]))
    k = mm(xk, layer["att.key.weight"])
    v = mm(xv, layer["att.value.weight"])

    tf, td = layer["att.time_first"], layer["att.time_decay"]
    if trace:
        wkv, aa_all, bb_all, pp_all = wkv4_scan_trace(tf, td, k, v, aa, bb, pp, wkv_fn)
        out = mm(r * wkv, layer["att.output.weight"])
        return (out, new_xx, aa_all[-1], bb_all[-1], pp_all[-1],
                (xl, aa_all, bb_all, pp_all))
    wkv, aa, bb, pp = (wkv_fn or wkv4_scan)(tf, td, k, v, aa, bb, pp)
    return mm(r * wkv, layer["att.output.weight"]), new_xx, aa, bb, pp


def att_v5(layer: Params, x, att_xx, heads, cfg: ModelConfig, wkv_fn=None, trace=False):
    """v5.1 / v5.2 time mix: the wkv6 recurrence with a static decay. 5.2
    has ``[H, S]`` ``time_faaaa`` and ``time_decay`` (already exp(-exp(.))
    as stored, used as is) and a silu gate; 5.1 per-head scalar
    ``time_first`` / ``time_decay`` broadcast over S and no gate. Group
    norm eps 1e-5. `wkv_fn` and `trace` as in ``att_v6``."""
    h, s = cfg.head_count, cfg.head_size
    lead = x.shape[:-1]
    xl = layer_norm(x, layer["ln1.weight"], layer["ln1.bias"])
    x_prev, new_xx = _token_shift(xl, att_xx)

    xk = _mix(xl, x_prev, layer["att.time_mix_k"])
    xv = _mix(xl, x_prev, layer["att.time_mix_v"])
    xr = _mix(xl, x_prev, layer["att.time_mix_r"])

    r = mm(xr, layer["att.receptance.weight"]).reshape(*lead, h, s)
    k = mm(xk, layer["att.key.weight"]).reshape(*lead, h, s)
    v = mm(xv, layer["att.value.weight"]).reshape(*lead, h, s)

    if cfg.version_minor >= 2:
        g = torch.nn.functional.silu(
            mm(_mix(xl, x_prev, layer["att.time_mix_g"]), layer["att.gate.weight"]))
        tf = layer["att.time_faaaa"]
        td = layer["att.time_decay"]
    else:
        g = None
        tf = layer["att.time_first"][:, None].expand(h, s)
        td = layer["att.time_decay"][:, None].expand(h, s)

    if trace:
        y, heads_all = wkv6_scan_trace(heads, r, k, v, td, tf, wkv_fn)
        heads = heads_all[-1]
    else:
        y, heads = (wkv_fn or wkv6_scan)(heads, r, k, v, td, tf)
    xo = group_norm(
        y.reshape(*lead, cfg.n_embed), layer["att.ln_x.weight"], layer["att.ln_x.bias"], h,
        eps=1e-5,
    )
    if g is not None:
        xo = xo * g
    out = mm(xo, layer["att.output.weight"])
    if trace:
        return out, new_xx, heads, (xl, heads_all)
    return out, new_xx, heads


def att_v6(layer: Params, x, att_xx, heads, cfg: ModelConfig, wkv_fn=None, trace=False):
    """v6 time mix: LoRA-style dynamic five-way token-shift mix and dynamic
    decay, silu gate. `wkv_fn` overrides the recurrence (the prefill
    dispatch ``ops.chunked.wkv6_auto``); trace=True additionally returns
    (xl, heads_all), the per-position recurrent state, the recurrence run
    token by token (through `wkv_fn` where given).

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
        y, heads_all = wkv6_scan_trace(heads, r, k, v, w, tf, wkv_fn)
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


def v7_projections(layer: Params, xxx: torch.Tensor, v_lora: bool) -> tuple:
    """The products of v7's time mix on the six mixes ``xxx`` [6, ..., C]
    (r, w, k, v, a, g): (r, k, v, g, w_l, a_l, vmix_l), w_l / a_l / vmix_l
    the w, a and value-residual LoRAs before their biases (vmix_l None
    without `v_lora`)."""
    xr, xw, xk, xv, xa, xg = (xxx[i] for i in range(6))
    r = mm(xr, layer["att.receptance.weight"])
    g = mm(torch.sigmoid(mm(xg, layer["att.g1"])), layer["att.g2"])
    a_l = mm(mm(xa, layer["att.a1"]), layer["att.a2"])
    w_l = mm(torch.tanh(mm(xw, layer["att.w1"])), layer["att.w2"])
    k = mm(xk, layer["att.key.weight"])
    v = mm(xv, layer["att.value.weight"])
    vmix_l = mm(mm(xv, layer["att.v1"]), layer["att.v2"]) if v_lora else None
    return r, k, v, g, w_l, a_l, vmix_l


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
    projections=v7_projections,
):
    """v7 time mix: six-way shift, low-rank w/a/g/v gates, l2-normalized
    kk, cross-layer value residual and the r.k.r_k bonus.

    `is_first`: None for the unrolled path (v_first=None marks layer 0);
    a bool for the stacked serving path. Layer 0 takes v as the value
    residual and needs no v0/v1/v2 (the JAX package's scan computes its
    residual on zero-padded ones and selects it away), so a one-layer
    model serves too.

    `projections`: ``v7_projections`` or a function of the same contract
    (the serving path's fused products, ``models.serve``).

    trace=True additionally returns (xl, heads_all), the per-position
    recurrent state, the recurrence run token by token (through `wkv_fn`
    where given)."""
    h, s = cfg.head_count, cfg.head_size
    lead, c = x.shape[:-1], x.shape[-1]
    first = v_first is None if is_first is None else is_first
    xl = layer_norm(x, layer["ln1.weight"], layer["ln1.bias"])
    x_prev, new_xx = _token_shift(xl, att_xx)
    sx = x_prev - xl

    coeff = layer["att.x_rwkvag"].reshape(6, *([1] * len(lead)), c)
    xxx = xl[None] + sx[None] * coeff  # [6, ..., C]
    r, k, v, g, w_l, a_l, vmix_l = projections(layer, xxx, not first)
    a = torch.sigmoid(a_l + layer["att.a0"])
    w = torch.exp(torch.sigmoid(w_l + layer["att.w0"]) * -0.606531)

    kk = l2_normalize((k * layer["att.k_k"]).reshape(*lead, h, s))
    ka = k * layer["att.k_a"]
    k = k + (a * ka - ka)

    if first:
        v_first = v
    else:
        v = v + (v_first - v) * torch.sigmoid(vmix_l + layer["att.v0"])

    rh = r.reshape(*lead, h, s)
    wh = w.reshape(*lead, h, s)
    kh = k.reshape(*lead, h, s)
    vh = v.reshape(*lead, h, s)
    ah = a.reshape(*lead, h, s)

    if trace:
        y, heads_all = wkv7_scan_trace(heads, rh, wh, kh, vh, -kk, kk * ah, wkv_fn)
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


def ffn_v4_v5(layer: Params, x, ffn_xx):
    """v4/v5 channel mix: relu^2 key with a sigmoid receptance gate, the
    shift mixes in the reference's op order."""
    xl = layer_norm(x, layer["ln2.weight"], layer["ln2.bias"])
    x_prev, new_xx = _token_shift(xl, ffn_xx)
    xk = _mix(xl, x_prev, layer["ffn.time_mix_k"])
    xr = _mix(xl, x_prev, layer["ffn.time_mix_r"])
    r = torch.sigmoid(mm(xr, layer["ffn.receptance.weight"]))
    k = torch.square(torch.relu(mm(xk, layer["ffn.key.weight"])))
    return r * mm(k, layer["ffn.value.weight"]), new_xx


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
    ffn_rows: bool = False,
):
    """One forward pass over `tokens` [T] with recurrent `state` (arrays
    [L, ...]: v5-v7 ``heads``, v4 ``aa`` / ``bb`` / ``pp``). Returns
    (logits [n_vocab] for the last token, or None, new state).

    With `ffn_rows` it also returns layer 0's post-layernorm FFN input
    rows [T, C]: row t is the ``ffn_xx[0]`` a token-by-token run carries
    after token t (the reservoir's activations), the last row the new
    state's own."""
    major = cfg.version_major
    if major not in (4, 5, 6, 7):
        raise NotImplementedError(f"RWKV v{cfg.version} has no forward graph")
    emb = params["emb"][tokens]
    x = layer_norm(emb.float(), *params["ln0"])

    v_first = None
    rows = None
    new_att_xx, new_ffn_xx = [], []
    new_heads, new_aa, new_bb, new_pp = [], [], [], []
    for i, layer in enumerate(params["blocks"]):
        if major == 7:
            dx, att_xx, heads, v_first = att_v7(
                layer, x, state["att_xx"][i], state["heads"][i], v_first, cfg
            )
            x = x + dx
            dx, ffn_xx = ffn_v7(layer, x, state["ffn_xx"][i])
        elif major == 6:
            dx, att_xx, heads = att_v6(layer, x, state["att_xx"][i], state["heads"][i], cfg)
            x = x + dx
            dx, ffn_xx = ffn_v6(layer, x, state["ffn_xx"][i])
        elif major == 5:
            dx, att_xx, heads = att_v5(layer, x, state["att_xx"][i], state["heads"][i], cfg)
            x = x + dx
            dx, ffn_xx = ffn_v4_v5(layer, x, state["ffn_xx"][i])
        else:
            dx, att_xx, aa, bb, pp = att_v4(
                layer, x, state["att_xx"][i], state["aa"][i], state["bb"][i], state["pp"][i]
            )
            x = x + dx
            dx, ffn_xx = ffn_v4_v5(layer, x, state["ffn_xx"][i])
            new_aa.append(aa)
            new_bb.append(bb)
            new_pp.append(pp)
        if ffn_rows and i == 0:
            # the token shift's input: the last row is ffn_xx's new carry
            rows = layer_norm(x, layer["ln2.weight"], layer["ln2.bias"])
        x = x + dx
        if major >= 5:
            new_heads.append(heads)
        new_att_xx.append(att_xx)
        new_ffn_xx.append(ffn_xx)

    new_state: State = {
        "att_xx": torch.stack(new_att_xx),
        "ffn_xx": torch.stack(new_ffn_xx),
    }
    if major >= 5:
        new_state["heads"] = torch.stack(new_heads)
    else:
        new_state.update(aa=torch.stack(new_aa), bb=torch.stack(new_bb), pp=torch.stack(new_pp))
    logits = None
    if compute_logits:
        xo = layer_norm(x[-1], *params["ln_out"])
        logits = mm(xo[None, :], params["head"])[0]
    if ffn_rows:
        return logits, new_state, rows
    return logits, new_state

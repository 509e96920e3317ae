"""wkv4, wkv6 and wkv7 prefill: chunked plain forms, dispatch, kernels K5
and K2.

Ports ``rwkv_tpu.ops.chunked``'s v4, v5/v6 and v7 parts. ``wkv4_parallel``
is the v4 prefill: a log-depth scan over the tokens in plain PyTorch (the
JAX package's is an XLA associative scan, not a TPU kernel). ``wkv6_chunked`` /
``_chunk_body`` are the wkv5/6 matmul form over chunks of P tokens (exact
per-pair log-space decay ratios), ``wkv7_chunked`` / ``_chunk_body7`` the
wkv7 one (a unit lower triangular solve per chunk,
``torch.linalg.solve_triangular``); they are the plain versions that serve
the CPU. ``wkv6_recurrence`` and ``wkv7_recurrence`` wrap the hand-written
CUDA kernels ``csrc/wkv6.cu`` (K5) and ``csrc/wkv7.cu`` (K2), which run the
token recurrence of ``models.graph.wkv6_scan`` / ``wkv7_scan`` for a whole
sequence in one launch and count their launches in ``.launches``.
"""

from __future__ import annotations

import torch

from rwkv_tpu_torch.ops import _cuda

KERNEL_HEAD_SIZES = (32, 64, 128)


def _chunk_body(s0, r, k, v, lw, tf):
    """One wkv5/6 chunk. Shapes: r/k/v/lw [P, B, H, S]; s0 [B, H, S, S]
    (i = value dim, j = key dim); tf [H, S]. Returns (out [P, B, H, S],
    s_next).

    With W_t the cumulative decay within the chunk, the intra-chunk term
    uses the exact pair ratios W_{t-1} / W_tau in log space; every exponent
    reaching exp() is clamped <= 0, so the form is finite for any decay."""
    lcum = torch.cumsum(lw, dim=0)         # inclusive log-decay products
    lcum_ex = lcum - lw                    # exclusive (through t-1)
    last = lcum[-1]                        # [B, H, S]

    q_state = r * torch.exp(lcum_ex)       # <= |r|; reads S_0
    kappa = k * torch.exp(last - lcum)     # factors <= 1

    p = r.shape[0]
    ldiff = torch.clamp(lcum_ex[:, None] - lcum[None, :], max=0.0)
    att = (r[:, None] * k[None, :] * torch.exp(ldiff)).sum(dim=-1)  # [P, P, B, H]
    att = att.permute(2, 3, 0, 1)          # [B, H, t, u]
    mask = torch.tril(torch.ones((p, p), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(mask, att, torch.zeros((), dtype=att.dtype, device=att.device))

    diag = (r * tf * k).sum(dim=-1, keepdim=True)  # [P, B, H, 1]

    out = (
        torch.einsum("bhtu,ubhi->tbhi", att, v)
        + diag * v
        + torch.einsum("bhij,tbhj->tbhi", s0, q_state)
    )
    s_next = s0 * torch.exp(last)[..., None, :] + torch.einsum("ubhj,ubhi->bhij", kappa, v)
    return out, s_next


def wkv6_chunked(s0, r, k, v, w, tf, chunk_size: int = 16):
    """Chunked wkv5/6, time-major batched: r/k/v [T, B, H, S]; w
    [T, B, H, S] or [H, S] (static, v5); tf [H, S]; s0 [B, H, S, S]. T must
    be a multiple of chunk_size."""
    t = r.shape[0]
    if t % chunk_size:
        raise ValueError(f"T={t} is not a multiple of chunk_size={chunk_size}")
    if w.ndim == 2:
        w = w.expand(r.shape)
    # w = exp(-exp(.)) may underflow to 0; the floor keeps the log finite
    lw = torch.log(torch.clamp(w, min=1e-38))
    s = s0
    outs = []
    for c0 in range(0, t, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        out, s = _chunk_body(s, r[sl], k[sl], v[sl], lw[sl], tf)
        outs.append(out)
    return torch.cat(outs, dim=0), s


def _check_fold(kernel: str, s0, ops, tf=None):
    """Raise unless the folded operands fit kernel K2 / K5: ops [T, BH, S],
    s0 [BH, S, S], tf (K5) [BH, S], S a supported head size."""
    t, bh, s = ops[0].shape
    if s0.shape != (bh, s, s) or (tf is not None and tf.shape != (bh, s)):
        shapes = f"state {tuple(s0.shape)}" + ("" if tf is None else f", tf {tuple(tf.shape)}")
        raise ValueError(f"{shapes} do not match operands [T={t}, BH={bh}, S={s}]")
    for x in ops:
        if x.shape != (t, bh, s):
            raise ValueError(f"operand shape {tuple(x.shape)} != {(t, bh, s)}")
    if s not in KERNEL_HEAD_SIZES:
        raise ValueError(f"the {kernel} kernel supports head sizes {KERNEL_HEAD_SIZES}, got {s}")


def wkv6_recurrence(s0, r, k, v, w, tf):
    """Kernel K5 on CUDA tensors: r/k/v/w [T, BH, S] f32 (a per-token
    decay; v5's static one is broadcast by the caller), tf [BH, S], s0
    [BH, S, S] -> (y [T, BH, S], final state [BH, S, S]). CPU tensors take
    the plain recurrence (``wkv6_recurrence_plain``)."""
    if r.device.type == "cpu":
        return wkv6_recurrence_plain(s0, r, k, v, w, tf)
    ops = [x.float().contiguous() for x in (r, k, v, w)]
    s0 = s0.float().contiguous()
    tf = tf.float().contiguous()
    _check_fold("wkv6", s0, ops, tf)
    if any(x.device != s0.device for x in ops + [tf]) or s0.device.type != "cuda":
        raise ValueError("wkv6 kernel operands must all lie on one CUDA device")
    t, bh, s = ops[0].shape
    y = torch.empty_like(ops[0])
    s_out = torch.empty_like(s0)
    fn = _cuda.function("wkv6", "rwkv_wkv6_seq", 8, 3)
    code = fn(*(x.data_ptr() for x in ops), tf.data_ptr(), s0.data_ptr(), y.data_ptr(),
              s_out.data_ptr(), t, bh, s, _cuda.stream_ptr(s0.device))
    _cuda.check("wkv6", "rwkv_wkv6_seq", code)
    wkv6_recurrence.launches += 1
    return y, s_out


wkv6_recurrence.launches = 0


def wkv6_recurrence_plain(s0, r, k, v, w, tf):
    """The token recurrence K5 computes, in plain PyTorch (any device)."""
    from rwkv_tpu_torch.models.graph import wkv6_scan

    return wkv6_scan(s0, r, k, v, w, tf)


def wkv6_auto(s, r, k, v, w, tf, chunk_size: int = 16):
    """Whole-sequence wkv5/6. Accepts rank-3 ([T, H, S]) or rank-4
    ([T, B, H, S]) operands with state [H, S, S] / [B, H, S, S]; w per
    token like r, or static [H, S] (v5).

    CUDA tensors go to kernel K5 with (B, H) folded into one dim and a
    static w broadcast over the tokens. CPU tensors follow the JAX
    package's dispatch: the chunked form when T is a chunk multiple and
    > 1, the scan otherwise."""
    from rwkv_tpu_torch.models.graph import wkv6_scan

    t = r.shape[0]
    if r.device.type != "cuda" and (t == 1 or t % chunk_size != 0):
        return wkv6_scan(s, r, k, v, w, tf)
    squeeze = r.ndim == 3
    if squeeze:
        r, k, v = r[:, None], k[:, None], v[:, None]
        if w.ndim == 3:
            w = w[:, None]
        s = s[None]
    t_len, bsz, h, s_dim = r.shape
    if r.device.type == "cuda":
        def fold(x):
            return x.reshape(t_len, bsz * h, s_dim)

        y, s2 = wkv6_recurrence(
            s.reshape(bsz * h, s_dim, s_dim), fold(r), fold(k), fold(v),
            fold(w.expand(r.shape)), tf.expand(bsz, h, s_dim).reshape(bsz * h, s_dim),
        )
        y = y.reshape(t_len, bsz, h, s_dim)
        s2 = s2.reshape(bsz, h, s_dim, s_dim)
    else:
        y, s2 = wkv6_chunked(s, r, k, v, w, tf, chunk_size)
    if squeeze:
        return y[:, 0], s2[0]
    return y, s2


def _chunk_body7(s0, r, w, k, v, a, b, lw):
    """One wkv7 chunk. Shapes: r/w/k/v/a/b/lw [P, B, H, S]; s0 [B, H, S, S]
    (i = value dim, j = key dim). Returns (out [P, B, H, S], s_next).

    With the de-decayed state T_t = S_t o 1/W_t (W_t the cumulative decay
    within the chunk), the chunk's self-coupling is the unit lower
    triangular system (I - B_strict) sa = T_0 atil + K_strict v."""
    p = r.shape[0]
    lcum = torch.cumsum(lw, dim=0)
    lcum_ex = lcum - lw

    atil = a * torch.exp(lcum_ex)
    btil = b * torch.exp(-lcum)
    ktil = k * torch.exp(-lcum)
    rhat = r * torch.exp(lcum)

    ones = torch.ones((p, p), dtype=torch.bool, device=r.device)
    strict = torch.tril(ones, diagonal=-1)
    incl = torch.tril(ones)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)

    bmat = torch.where(strict, torch.einsum("tbhj,ubhj->bhtu", atil, btil), zero)
    kmat = torch.where(strict, torch.einsum("tbhj,ubhj->bhtu", atil, ktil), zero)

    rhs = torch.einsum("bhij,tbhj->tbhi", s0, atil) + torch.einsum(
        "bhtu,ubhi->tbhi", kmat, v
    )
    eye = torch.eye(p, dtype=r.dtype, device=r.device)
    sa = torch.linalg.solve_triangular(
        eye - bmat,                 # [B, H, P, P]
        rhs.movedim(0, 2),          # [B, H, P, S]
        upper=False,
        unitriangular=True,
    ).movedim(2, 0)                 # [P, B, H, S]

    br = torch.where(incl, torch.einsum("tbhj,ubhj->bhtu", rhat, btil), zero)
    kr = torch.where(incl, torch.einsum("tbhj,ubhj->bhtu", rhat, ktil), zero)
    out = (
        torch.einsum("bhij,tbhj->tbhi", s0, rhat)
        + torch.einsum("bhtu,ubhi->tbhi", br, sa)
        + torch.einsum("bhtu,ubhi->tbhi", kr, v)
    )
    t_last = (
        s0
        + torch.einsum("ubhi,ubhj->bhij", sa, btil)
        + torch.einsum("ubhi,ubhj->bhij", v, ktil)
    )
    s_next = t_last * torch.exp(lcum[-1])[..., None, :]
    return out, s_next


def wkv7_chunked(s0, r, w, k, v, a, b, chunk_size: int = 16):
    """Chunked wkv7, time-major batched: r/w/k/v/a/b [T, B, H, S];
    s0 [B, H, S, S]. T must be a multiple of chunk_size."""
    t = r.shape[0]
    if t % chunk_size:
        raise ValueError(f"T={t} is not a multiple of chunk_size={chunk_size}")
    lw = torch.log(torch.clamp(w, min=1e-30))
    s = s0
    outs = []
    for c0 in range(0, t, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        out, s = _chunk_body7(s, r[sl], w[sl], k[sl], v[sl], a[sl], b[sl], lw[sl])
        outs.append(out)
    return torch.cat(outs, dim=0), s


def wkv7_recurrence(s0, r, w, k, v, a, b):
    """Kernel K2 on CUDA tensors: r/w/k/v/a/b [T, BH, S] f32, s0
    [BH, S, S] -> (y [T, BH, S], final state [BH, S, S]). CPU tensors take
    the plain recurrence (``wkv7_recurrence_plain``)."""
    if r.device.type == "cpu":
        return wkv7_recurrence_plain(s0, r, w, k, v, a, b)
    ops = [x.float().contiguous() for x in (r, w, k, v, a, b)]
    s0 = s0.float().contiguous()
    _check_fold("wkv7", s0, ops)
    if any(x.device != s0.device for x in ops) or s0.device.type != "cuda":
        raise ValueError("wkv7 kernel operands must all lie on one CUDA device")
    t, bh, s = ops[0].shape
    y = torch.empty_like(ops[0])
    s_out = torch.empty_like(s0)
    fn = _cuda.function("wkv7", "rwkv_wkv7_seq", 9, 3)
    code = fn(*(x.data_ptr() for x in ops), s0.data_ptr(), y.data_ptr(),
              s_out.data_ptr(), t, bh, s, _cuda.stream_ptr(s0.device))
    _cuda.check("wkv7", "rwkv_wkv7_seq", code)
    wkv7_recurrence.launches += 1
    return y, s_out


wkv7_recurrence.launches = 0


def wkv7_recurrence_plain(s0, r, w, k, v, a, b):
    """The token recurrence K2 computes, in plain PyTorch (any device)."""
    from rwkv_tpu_torch.models.graph import wkv7_scan

    return wkv7_scan(s0, r, w, k, v, a, b)


def wkv7_auto(s, r, w, k, v, a, b, chunk_size: int = 16):
    """Whole-sequence wkv7. Accepts rank-3 ([T, H, S]) or rank-4
    ([T, B, H, S]) operands with state [H, S, S] / [B, H, S, S].

    CUDA tensors go to kernel K2 with (B, H) folded into one dim. CPU
    tensors follow the JAX package's dispatch: the chunked form when T is a
    chunk multiple and > 1 (P = 32 from T >= 1024), the scan otherwise."""
    from rwkv_tpu_torch.models.graph import wkv7_scan

    t = r.shape[0]
    squeeze = r.ndim == 3
    if squeeze:
        r, w, k, v, a, b = (x[:, None] for x in (r, w, k, v, a, b))
        s = s[None]
    t_len, bsz, h, s_dim = r.shape
    if r.device.type == "cuda":
        def fold(x):
            return x.reshape(t_len, bsz * h, s_dim)

        y, s2 = wkv7_recurrence(
            s.reshape(bsz * h, s_dim, s_dim),
            fold(r), fold(w), fold(k), fold(v), fold(a), fold(b),
        )
        y = y.reshape(t_len, bsz, h, s_dim)
        s2 = s2.reshape(bsz, h, s_dim, s_dim)
    else:
        if chunk_size == 16 and t >= 1024 and t % 32 == 0:
            chunk_size = 32
        if t == 1 or t % chunk_size != 0:
            y, s2 = wkv7_scan(s, r, w, k, v, a, b)
        else:
            y, s2 = wkv7_chunked(s, r, w, k, v, a, b, chunk_size)
    if squeeze:
        return y[:, 0], s2[0]
    return y, s2


def _wkv4_combine(s1, s2, td):
    """The wkv4 monoid over (P, A, B, n): segment s1 followed by s2. s1's
    normalizer decays n2 more steps, then both renormalize at the max."""
    p1, a1, b1, n1 = s1
    p2, a2, b2, n2 = s2
    p1s = p1 + n2 * td
    p = torch.maximum(p1s, p2)
    e1 = torch.exp(p1s - p)
    e2 = torch.exp(p2 - p)
    return p, e1 * a1 + e2 * a2, e1 * b1 + e2 * b2, n1 + n2


def wkv4_parallel(tf, td, k, v, aa, bb, pp):
    """wkv4 over a whole sequence with the time recurrence as a log-depth
    (Hillis-Steele) inclusive scan of the (P, A, B, n) monoid: ceil(log2 T)
    rounds of whole-tensor ops, not T. Same signature and semantics as
    ``models.graph.wkv4_scan``: k/v [T, ..., C]; tf/td [C]; aa/bb/pp the
    incoming scalar state. Token t reads the EXCLUSIVE prefix (the state
    before it, with the initial state folded in front, decayed t steps)
    and the (tf + k_t, v_t) bonus, as the serial step does; the final
    state folds the decayed initial state into the whole-sequence scan at
    the ``P_all`` normalizer."""
    t = k.shape[0]
    ones = torch.ones_like(k)
    seg = (k, v, ones, ones)  # one token: P = k_t, A = v_t, B = 1, n = 1
    off = 1
    while off < t:
        later = tuple(x[off:] for x in seg)
        earlier = tuple(x[:-off] for x in seg)
        comb = _wkv4_combine(earlier, later, td)
        seg = tuple(torch.cat([x[:off], c]) for x, c in zip(seg, comb))
        off *= 2
    pc, ac, bc, _ = seg

    steps = torch.arange(t, dtype=k.dtype, device=k.device).reshape((t,) + (1,) * (k.ndim - 1))
    pp_t = pp + steps * td  # the initial state's normalizer before each token

    # exclusive prefix: token t reads scan[t - 1] as is (the serial step
    # decays inside the next state update, not between state and output)
    pe = torch.cat([torch.full_like(pc[:1], -1e38), pc[:-1]])
    ae = torch.cat([torch.zeros_like(ac[:1]), ac[:-1]])
    be = torch.cat([torch.zeros_like(bc[:1]), bc[:-1]])

    pm = torch.maximum(pp_t, pe)
    es = torch.exp(pp_t - pm)
    ep = torch.exp(pe - pm)
    at = es * aa + ep * ae
    bt = es * bb + ep * be

    ww = tf + k
    qq = torch.maximum(pm, ww)
    e1 = torch.exp(pm - qq)
    e2 = torch.exp(ww - qq)
    wkv = (e1 * at + e2 * v) / (e1 * bt + e2)

    pp_end = pp + t * td
    p_all = torch.maximum(pp_end, pc[-1])
    es2 = torch.exp(pp_end - p_all)
    ep2 = torch.exp(pc[-1] - p_all)
    return wkv, es2 * aa + ep2 * ac[-1], es2 * bb + ep2 * bc[-1], p_all


def wkv4_auto(tf, td, k, v, aa, bb, pp):
    """Whole-sequence wkv4: the log-depth scan for T > 1, the serial step
    at T = 1 (any device)."""
    from rwkv_tpu_torch.models.graph import wkv4_scan

    if k.shape[0] == 1:
        return wkv4_scan(tf, td, k, v, aa, bb, pp)
    return wkv4_parallel(tf, td, k, v, aa, bb, pp)

"""wkv7 prefill: chunked plain form, dispatch, and kernel K2.

Ports ``rwkv_tpu.ops.chunked``'s v7 parts. ``wkv7_chunked`` /
``_chunk_body7`` are the matmul form over chunks of P tokens (a unit lower
triangular solve per chunk, ``torch.linalg.solve_triangular``); it is the
plain version that serves the CPU. ``wkv7_recurrence`` wraps the
hand-written CUDA kernel ``csrc/wkv7.cu``, which runs the token recurrence
of ``models.graph.wkv7_scan`` for a whole sequence in one launch and counts
its launches in ``wkv7_recurrence.launches``.
"""

from __future__ import annotations

import torch

from rwkv_tpu_torch.ops import _cuda

KERNEL_HEAD_SIZES = (32, 64, 128)


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


def _check_fold(s0, ops):
    t, bh, s = ops[0].shape
    if s0.shape != (bh, s, s):
        raise ValueError(f"state {tuple(s0.shape)} does not match operands [T={t}, BH={bh}, S={s}]")
    for x in ops:
        if x.shape != (t, bh, s):
            raise ValueError(f"operand shape {tuple(x.shape)} != {(t, bh, s)}")
    if s not in KERNEL_HEAD_SIZES:
        raise ValueError(f"the wkv7 kernel supports head sizes {KERNEL_HEAD_SIZES}, got {s}")


def wkv7_recurrence(s0, r, w, k, v, a, b):
    """Kernel K2 on CUDA tensors: r/w/k/v/a/b [T, BH, S] f32, s0
    [BH, S, S] -> (y [T, BH, S], final state [BH, S, S]). CPU tensors take
    the plain recurrence (``wkv7_recurrence_plain``)."""
    if r.device.type == "cpu":
        return wkv7_recurrence_plain(s0, r, w, k, v, a, b)
    ops = [x.float().contiguous() for x in (r, w, k, v, a, b)]
    s0 = s0.float().contiguous()
    _check_fold(s0, ops)
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

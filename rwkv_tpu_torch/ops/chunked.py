"""wkv4, wkv6 and wkv7 prefill: chunked plain forms, dispatch, kernels K5
and K2.

Ports ``rwkv_tpu.ops.chunked``'s v4, v5/v6 and v7 parts. ``wkv4_parallel``
is the v4 prefill: a log-depth scan over the tokens in plain PyTorch (the
JAX package's is an XLA associative scan, not a TPU kernel). ``wkv6_chunked`` /
``_chunk_body`` are the wkv5/6 matmul form over chunks of P tokens (exact
per-pair log-space decay ratios), ``wkv7_chunked`` / ``_chunk_body7`` the
wkv7 one (a unit lower triangular solve per chunk,
``torch.linalg.solve_triangular``); they are the plain versions that serve
the CPU.

``wkv6_recurrence`` and ``wkv7_recurrence`` wrap the hand-written CUDA
kernels ``csrc/wkv6.cu`` (K5) and ``csrc/wkv7.cu`` (K2), one launch a whole
sequence, counted in ``.launches``. Both compute the chunked two-pass form
of the TPU kernels (``wkv7_chunked_pallas``'s grouped body,
``wkv6_chunked_pallas``): pass A builds every (chunk, head) pair's
operators in parallel over the grid, pass B carries the state through the
chunks in order, each block a group of state rows, waiting on a ready flag
a (chunk, head) pair; below a crossover T the same launch runs the token
recurrence, rows split over the grid. ``wkv_chunk_plan`` is their launch
plan (mirrored by the kernels' C entry ``rwkv_wkv_chunk_plan``, compared at
a shape's first launch); ``wkv7_twopass`` and ``wkv6_twopass`` repeat the
kernels' association in plain PyTorch, so that the CPU tests hold their
algebra. ``wkv6_recurrence_plain`` / ``wkv7_recurrence_plain`` (the token
scans) stay the CPU route and the card's yardstick.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

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


# -- kernels K2 / K5: the chunked two-pass form -----------------------------------

WKV_P = 16  # tokens a chunk (csrc/wkv_chunk.cuh kP)
# T below which a launch runs the token recurrence (rows split over the
# grid) instead of the two passes, by kind: (most heads, crossover) in turn;
# past 48 heads (two rows a lane) the recurrence won at every T measured
# (tools/probe_wkv.py --crossover; csrc/wkv_chunk.cuh recurrence_below)
RECURRENCE_BELOW = {7: ((16, 32), (48, 48), (None, 1 << 30)),
                    6: ((16, 48), (48, 64), (None, 1 << 30))}


def recurrence_below(kind: int, bh: int) -> int:
    """The crossover T of K2 (kind 7) / K5 (kind 6) at bh heads."""
    return next(x for most, x in RECURRENCE_BELOW[kind] if most is None or bh <= most)


# shared bytes a block may take with two blocks on an SM (228 KB less 1 KB
# reserved a block, halved) and with one
SMEM_TWO_PER_SM = 115712
SMEM_ONE_PER_SM = 232448
WKV_BAR_BYTES = 64  # the ring's mbarriers, at the start of shared memory
# per kind: operator matrices [P, S] a (chunk, head) pair shares with all
# its row groups, and [P] columns a state row has of its own
_HEAD_MATS = {7: 4, 6: 2}  # wkv7: F, E (as [S, 2P]), btil, ktil; wkv6: rq, kap
_ROW_MATS = {7: 3, 6: 2}   # wkv7: S_loc, v, Y; wkv6: v, Y


class WkvChunkPlan(NamedTuple):
    """Launch plan of K2 / K5 (``wkv_chunk_plan``), field for field the C
    entry ``rwkv_wkv_chunk_plan``'s output."""
    p: int               # tokens a chunk
    recurrent: int       # 1: the token recurrence (t < crossover)
    n_chunks: int        # ceil(t / p) chunks (the last padded with identity tokens); 0 if recurrent
    rows: int            # state rows a pass-B (or recurrence) block carries: a row group
    groups: int          # row groups a head: s // rows
    blocks_per_sm: int   # the two passes: 2 where the shared memory allows, else 1
    grid: int            # blocks of the launch
    stages: int          # pass B's ring of operator stages (0 for the recurrence)
    smem_bytes: int      # dynamic shared memory a block
    scratch_floats: int  # pass A's operators, n_chunks * bh * item_floats
    crossover: int       # the recurrence below this t


def wkv_item_floats(kind: int, s: int) -> int:
    """Floats of one (chunk, head) pair's operators in the scratch: the
    shared part (``_HEAD_MATS`` [P, S] matrices, then e^(lcum_last) [S]),
    then ``_ROW_MATS`` columns of P a state row."""
    return (_HEAD_MATS[kind] + _ROW_MATS[kind]) * WKV_P * s + s


def _pass_a_floats(kind: int, s: int) -> int:
    """Pass A's shared floats: [P, S + 4] buffers (wkv7: lw, lcum, atil,
    btil, ktil, rhat, v, kmat v, F, S_loc; wkv6: lw, r, k, v, then lcum and
    lcex in float64, two buffers each) and [P, P + 1] ones (wkv7: bmat,
    kmat, br, kr, four Neumann buffers; wkv6: att, then diag as one more)."""
    p = WKV_P
    bufs, mats = (10, 8) if kind == 7 else (8, 2)
    return bufs * p * (s + 4) + mats * p * (p + 1)


def _pass_b_floats(kind: int, s: int, rows: int, stages: int) -> int:
    """Pass B's shared floats: the block's state rows [rows, S] and the
    ring's stages (a pair's shared part and the block's rows of its row
    part)."""
    p = WKV_P
    stage = _HEAD_MATS[kind] * p * s + s + rows * _ROW_MATS[kind] * p
    return rows * s + stages * stage


def _recurrence_floats(kind: int, s: int, rows: int) -> int:
    """The recurrence's shared floats: the state rows, two tiles of P
    tokens' operands (wkv7: r, w, k, v, a, b; wkv6: r, k, v, w), tf (K5)."""
    return rows * s + 2 * WKV_P * (6 if kind == 7 else 4) * s + s


def recurrence_rows(s: int, bh: int, sms: int) -> int:
    """The recurrence's rows a block: S / 8 lanes a row over 256 threads,
    so 2048 / S rows at once; twice that (two rows a lane) where a head's
    row groups would need more blocks than the card has SMs."""
    rows = min(s, 2048 // s)
    return 2 * rows if rows < s and bh * (s // rows) > sms else rows


def wkv_chunk_plan(kind: int, t: int, bh: int, s: int, sms: int = 132,
                   below: Optional[int] = None) -> WkvChunkPlan:
    """K2's (kind 7) / K5's (kind 6) launch plan for T = t, BH = bh heads
    of size s on a card of `sms` SMs; `below` overrides the crossover (the
    probes' builds with ``-DRWKV_WKV_BELOW=``).

    Below the crossover: the token recurrence, ``recurrence_rows`` rows
    a block, a block a (head, row group) pair, in an ordinary launch (no
    stages, no scratch). Otherwise the two passes, a cooperative launch:
    pass B's items are (head, row group) pairs, the most row groups a head
    (a power of two, rows >= 8) that keep bh * groups within one block a
    slot; pass A's are (chunk, head) pairs. The grid is both counts' sum,
    at most a block a slot (two an SM where pass B's ring of at least two
    stages fits half an SM's shared memory); the ring takes up to 4 stages."""
    if kind not in (6, 7):
        raise ValueError(f"kind {kind} is neither 6 nor 7")
    if s not in KERNEL_HEAD_SIZES or t < 1 or bh < 1 or sms < 1:
        raise ValueError(f"no wkv{kind} plan for T={t}, BH={bh}, S={s} on {sms} SMs")
    crossover = recurrence_below(kind, bh) if below is None else below
    if t < crossover:
        rows = recurrence_rows(s, bh, sms)
        return WkvChunkPlan(WKV_P, 1, 0, rows, s // rows, 1, bh * (s // rows), 0,
                            WKV_BAR_BYTES + 4 * _recurrence_floats(kind, s, rows), 0, crossover)
    n_chunks = -(-t // WKV_P)
    a_floats = _pass_a_floats(kind, s)
    for bps, budget in ((2, SMEM_TWO_PER_SM), (1, SMEM_ONE_PER_SM)):
        slots = sms * bps
        cap = min(s // 8, max(1, slots // bh))
        groups = 1
        while groups * 2 <= cap:
            groups *= 2
        rows = s // groups
        for stages in (4, 3, 2):
            smem = WKV_BAR_BYTES + 4 * max(a_floats, _pass_b_floats(kind, s, rows, stages))
            if smem <= budget:
                grid = min(slots, n_chunks * bh + bh * groups)
                return WkvChunkPlan(WKV_P, 0, n_chunks, rows, groups, bps, grid, stages,
                                    smem, n_chunks * bh * wkv_item_floats(kind, s), crossover)
    raise ValueError(f"wkv{kind} at S={s}: pass B's ring does not fit a block")


def wkv_kernel_plan(kind: int, t: int, bh: int, s: int, sms: int, lib=None) -> WkvChunkPlan:
    """The kernel's own plan (the C entry ``rwkv_wkv_chunk_plan`` of
    ``csrc/wkv7.cu`` / ``wkv6.cu``, or of the library ``lib`` =
    (source, nvcc flags) a probe built)."""
    src, flags = lib or (None, ())
    fn = _cuda.library(f"wkv{kind}", src, flags).rwkv_wkv_chunk_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(WkvChunkPlan._fields))()
    _cuda.check(f"wkv{kind}", "rwkv_wkv_chunk_plan", fn(kind, t, bh, s, sms, out))
    return WkvChunkPlan(*out)


_checked_plans: set = set()
_ready_flags: dict = {}
_sm_counts: dict = {}


def _flags(device, n: int):
    """The card's ready flags (int32, zeroed once): [0] the launch epoch,
    [1] the blocks done, then a flag a (chunk, head) pair. Each launch
    publishes a pair with the epoch + 1 and its last block advances the
    epoch, so no launch needs them cleared (launches on one stream, as the
    port's are, never overlap); a longer call gets a new, zeroed buffer."""
    buf = _ready_flags.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ready_flags[device] = buf
    return buf


def _wkv_launch(kind: int, ops, s0, tf=None, lib=None, below: Optional[int] = None):
    """One launch of K2 (kind 7: ops r, w, k, v, a, b) or K5 (kind 6: ops
    r, k, v, w and tf) on f32 contiguous [T, BH, S] operands; `lib` /
    `below` select a probe's build and its crossover. Returns (y, state)."""
    s0 = s0.float().contiguous()
    name = f"wkv{kind}"
    _check_fold(name, s0, ops, tf)
    dev = s0.device
    if dev.type != "cuda" or any(x.device != dev for x in ops + ([] if tf is None else [tf])):
        raise ValueError(f"{name} kernel operands must all lie on one CUDA device")
    t, bh, s = ops[0].shape
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    sms = _sm_counts[dev]
    plan = wkv_chunk_plan(kind, t, bh, s, sms, below)
    key = (kind, t, bh, s, sms, lib)
    if key not in _checked_plans:
        got = wkv_kernel_plan(kind, t, bh, s, sms, lib)
        if got != plan:
            raise RuntimeError(f"K{2 if kind == 7 else 5}'s plan {got} differs from "
                               f"wkv_chunk_plan's {plan}")
        _checked_plans.add(key)
    y = torch.empty_like(ops[0])
    s_out = torch.empty_like(s0)
    scratch = torch.empty(max(plan.scratch_floats, 4), dtype=torch.float32, device=dev)
    flags = _flags(dev, 2 + plan.n_chunks * bh)
    ptrs = [x.data_ptr() for x in ops] + ([] if tf is None else [tf.data_ptr()])
    ptrs += [s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), scratch.data_ptr(), flags.data_ptr()]
    src, flags_ = lib or (None, ())
    entry = f"rwkv_{name}_twopass"
    fn = _cuda.function(name, entry, len(ptrs), 4, src, flags_)
    _cuda.check(name, entry, fn(*ptrs, t, bh, s, sms, _cuda.stream_ptr(dev)))
    return y, s_out


def _pad_chunks(x, p: int, fill: float):
    """[T, BH, S] -> [NC, BH, P, S], the last chunk padded with `fill`
    (the identity token: w = 1, every other operand 0)."""
    t, bh, s = x.shape
    nc = -(-t // p)
    if nc * p != t:
        x = torch.cat([x, x.new_full((nc * p - t, bh, s), fill)])
    return x.reshape(nc, p, bh, s).transpose(1, 2)


def wkv7_twopass(s0, r, w, k, v, a, b, chunk_size: int = WKV_P):
    """wkv7 in K2's own association (plain PyTorch, any device): r/w/k/v/a/b
    [T, BH, S], s0 [BH, S, S] -> (y [T, BH, S], final state), any T (the
    last chunk padded with identity tokens).

    Ports ``rwkv_tpu.ops.chunked.wkv7_chunked_twopass``'s pass 1 (the
    de-decayed factors, bmat / kmat, the Neumann inverse) batched over every
    (chunk, head) pair, with K2's association of the rest: F = inv atil,
    S_loc = inv kmat v, E = rhat + br F and Y = br S_loc + kr v (JAX:
    rhat + (br inv) atil and (br inv kmat + kr) v). Pass 2 applies each
    chunk's state map in its rank-2P factors instead of JAX's dense [S, S]
    A and B: out_c = E_c T_c^T + Y_c and
    T_{c+1} = (T_c + (T_c F_c^T + S_loc^T) btil + v^T ktil) diag(e^lcum_last)."""
    t, bh, s = r.shape
    p = chunk_size
    lw = _pad_chunks(torch.log(torch.clamp(w, min=1e-30)), p, 0.0)  # [NC, BH, P, S]
    lcum = torch.cumsum(lw, dim=2)
    a_, b_, k_, r_, v_ = (_pad_chunks(x, p, 0.0) for x in (a, b, k, r, v))
    atil = a_ * torch.exp(lcum - lw)
    btil = b_ * torch.exp(-lcum)
    ktil = k_ * torch.exp(-lcum)
    rhat = r_ * torch.exp(lcum)
    elast = torch.exp(lcum[:, :, -1])                       # [NC, BH, S]

    ones = torch.ones((p, p), dtype=torch.bool, device=r.device)
    strict = torch.tril(ones, diagonal=-1)
    incl = torch.tril(ones)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    eye = torch.eye(p, dtype=r.dtype, device=r.device)

    def nt(x, y, mask):
        return torch.where(mask, x @ y.transpose(-1, -2), zero)

    bmat, kmat = nt(atil, btil, strict), nt(atil, ktil, strict)
    br, kr = nt(rhat, btil, incl), nt(rhat, ktil, incl)
    inv = eye + bmat                     # (I - bmat)^-1 as a finite Neumann product
    bpow = bmat
    for _ in range(max((p - 1).bit_length() - 1, 0)):
        bpow = bpow @ bpow
        inv = inv @ (eye + bpow)
    f_op = inv @ atil                                       # [NC, BH, P, S_j]
    s_loc = inv @ (kmat @ v_)                               # [NC, BH, P, S_i]
    e_op = rhat + br @ f_op                                 # [NC, BH, P, S_j]
    y_op = br @ s_loc + kr @ v_                             # [NC, BH, P, S_i]

    tmat = s0.float()
    outs = []
    for c in range(lw.shape[0]):
        outs.append(e_op[c] @ tmat.transpose(-1, -2) + y_op[c])
        u = tmat @ f_op[c].transpose(-1, -2) + s_loc[c].transpose(-1, -2)   # [BH, S_i, P]
        tmat = (tmat + u @ btil[c] + v_[c].transpose(-1, -2) @ ktil[c]) * elast[c][:, None, :]
    y = torch.stack(outs).transpose(1, 2).reshape(-1, bh, s)[:t]
    return y, tmat


def wkv6_twopass(s0, r, k, v, w, tf, chunk_size: int = WKV_P):
    """wkv5/6 in K5's own association (plain PyTorch, any device): r/k/v/w
    [T, BH, S], tf [BH, S], s0 [BH, S, S] -> (y [T, BH, S], final state),
    any T (identity tokens pad the last chunk).

    Pass 1, batched over every (chunk, head) pair, as ``_wkv6_chunk_kernel``:
    rq = r e^lcex, kap = k e^(last - lcum), the exact per-pair intra-chunk
    weights e^min(lcex_t - lcum_u, 0) for u < t (never a de-decayed factor:
    e^-lcum overflows on v6 decays), Y = att v + diag v; as in K5, lcum and
    lcex are summed in float64, since the exponents are differences of them.
    Pass 2: out_c = rq_c T_c^T + Y_c, T_{c+1} = T_c diag(e^last) + v^T kap."""
    t, bh, s = r.shape
    p = chunk_size
    lw = _pad_chunks(torch.log(torch.clamp(w, min=1e-38)), p, 0.0).double()
    lcum = torch.cumsum(lw, dim=2)
    lcex = lcum - lw
    last = lcum[:, :, -1:]                                  # [NC, BH, 1, S]
    r_, k_, v_ = (_pad_chunks(x, p, 0.0) for x in (r, k, v))
    rq = r_ * torch.exp(lcex.float())
    kap = k_ * torch.exp((last - lcum).float())
    elast = torch.exp(last.float())
    ldiff = torch.clamp((lcex[:, :, :, None] - lcum[:, :, None, :]).float(), max=0.0)  # [.., t, u, S]
    att = (r_[:, :, :, None] * k_[:, :, None, :] * torch.exp(ldiff)).sum(-1)
    strict = torch.tril(torch.ones((p, p), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(strict, att, torch.zeros((), dtype=att.dtype, device=att.device))
    diag = (r_ * tf[:, None, :] * k_).sum(-1, keepdim=True)
    y_op = att @ v_ + diag * v_

    tmat = s0.float()
    outs = []
    for c in range(lw.shape[0]):
        outs.append(rq[c] @ tmat.transpose(-1, -2) + y_op[c])
        tmat = tmat * elast[c] + v_[c].transpose(-1, -2) @ kap[c]
    y = torch.stack(outs).transpose(1, 2).reshape(-1, bh, s)[:t]
    return y, tmat


def wkv6_recurrence(s0, r, k, v, w, tf):
    """Kernel K5 on CUDA tensors: r/k/v/w [T, BH, S] f32 (a per-token
    decay; v5's static one is broadcast by the caller), tf [BH, S], s0
    [BH, S, S] -> (y [T, BH, S], final state [BH, S, S]), the two-pass
    form of ``wkv6_twopass`` (below ``wkv_chunk_plan``'s crossover T the
    token recurrence). No premise on the decay: every exponent the kernel
    takes is <= 0 (exact per-pair ratios, w floored at 1e-38 before its
    log). CPU tensors take the plain recurrence (``wkv6_recurrence_plain``)."""
    if r.device.type == "cpu":
        return wkv6_recurrence_plain(s0, r, k, v, w, tf)
    ops = [x.float().contiguous() for x in (r, k, v, w)]
    tf = tf.float().contiguous()
    y, s_out = _wkv_launch(6, ops, s0, tf)
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
    [BH, S, S] -> (y [T, BH, S], final state [BH, S, S]), the two-pass
    form of ``wkv7_twopass`` (below ``wkv_chunk_plan``'s crossover T the
    token recurrence).

    Premise, as for ``wkv7_chunked_pallas``: v7's decay bound
    w >= exp(-0.606531), so the de-decayed factors k e^(-lcum) and
    b e^(-lcum) stay below e^(0.607 P) (P = 16) in f32. CPU tensors take the
    plain recurrence (``wkv7_recurrence_plain``)."""
    if r.device.type == "cpu":
        return wkv7_recurrence_plain(s0, r, w, k, v, a, b)
    ops = [x.float().contiguous() for x in (r, w, k, v, a, b)]
    y, s_out = _wkv_launch(7, ops, s0)
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

"""K4's launch plan and the operand order of its tensor-core matvec, on
the CPU.

``rwkv_tpu_torch.ops.megakernel.batched_plan`` is the pure function the
int forms of K4 (``csrc/v7_decode_batched.cu``) launch with: the tests
hold its shared bytes within a block's limit at the widths the port
serves, and its n-tiles to the batch. ``emulate_sweep`` replays, in
numpy, the fragments the kernel's sweep (``csrc/batch_mma.cuh``) hands to
``mma.sync.m16n8k32.s8``: each lane's 16 bytes of weight rows g and g + 8
and of sequence g's codes, the int4 unpack into natural K order, K slices
of the plan's size split between the warps of a unit, the ragged last
n-tile; the products are rebuilt from the PTX fragment layout. Its int32
dots must equal, integer for integer, those of K4's plain version
(``v7_decode_batched_ref``'s matvec) and the JAX package's (the int8 dot
and ``_w4_acc`` on its split-half pack).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu_torch.ops import kernels as TK
from rwkv_tpu_torch.ops import megakernel as TM

# (C, F, D): the 169M width and the 1.5B width with synth's LoRA and the
# published one
WIDTHS = {"169M": (768, 3072, 64), "1.5B": (2048, 8192, 64), "1.5B-lora96": (2048, 8192, 96)}


@pytest.mark.parametrize("form", ["i8", "i4"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_plan_fits_a_block_for_every_batch(width, form):
    """Every B in 1..256 (MEGA_MAX_BATCH) has a plan whose shared bytes,
    static included, fit a block; its K slices are whole 128-code steps up
    to each sweep's K; placement (a) only up to K4_PLACE_A_MAX_B."""
    c, f, d = WIDTHS[width]
    ks_max = (c, c, c, c, f)
    for b in range(1, 257):
        p = TM.batched_plan(form, b, c, f, d)
        assert p.smem + p.static <= 232448, (b, p)
        assert p.static == TM.K4_STATIC_SMEM
        assert p.place in ("a", "b") and p.ring in (1, 2)
        assert p.place == "b" or b <= TM.K4_PLACE_A_MAX_B, (b, p)
        assert len(p.k_slice) == len(TM.K4_SWEEPS)
        for ks, k in zip(p.k_slice, ks_max):
            assert ks % 128 == 0 and 128 <= ks <= -(-k // 128) * 128, (b, p)
        assert p.smem % 16 == 0


@pytest.mark.parametrize("batch", [1, 2, 7, 8, 9, 16, 17, 63, 64, 65, 128, 255, 256])
def test_plan_n_tiles_cover_the_batch_exactly(batch):
    p = TM.batched_plan("i8", batch, 768, 3072, 64)
    assert (p.n_tiles - 1) * 8 < batch <= p.n_tiles * 8


def test_plan_placement_follows_the_batch_and_can_be_forced():
    """(a) up to K4_PLACE_A_MAX_B where it fits (at the 1.5B width too,
    its rows then in K slices), (b) above; either may be forced where it
    fits, and (a) stops fitting at the 169M width once B x F codes fill a
    block."""
    assert TM.batched_plan("i8", 8, 768, 3072, 64).place == "a"
    assert TM.batched_plan("i8", 9, 768, 3072, 64).place == "b"
    assert TM.batched_plan("i8", 64, 768, 3072, 64).place == "b"
    p = TM.batched_plan("i8", 1, 2048, 8192, 64)
    assert p.place == "a" and p.k_slice[0] < 2048
    assert TM.batched_plan("i4", 8, 768, 3072, 64, place="b").place == "b"
    assert TM.batched_plan("i8", 32, 768, 3072, 64, place="a").place == "a"
    with pytest.raises(ValueError):
        TM.batched_plan("i8", 64, 768, 3072, 64, place="a")
    with pytest.raises(ValueError):  # the forms are i8, i4 and bf16
        TM.batched_plan("q8", 8, 768, 3072, 64)
    with pytest.raises(ValueError):
        TM.batched_plan("i8", 8, 768, 3072, 64, place="c")
    with pytest.raises(ValueError):  # past MEGA_MAX_BATCH the serving route is per-op
        TM.batched_plan("i8", TM.K4_MAX_BATCH + 1, 768, 3072, 64)


def test_plan_splits_the_out_and_fv_tiles_only_in_placement_b():
    """In (b) the out and fv sweeps' C / 16 tiles are cut into K parts to
    reach the grid's blocks (at most K4_MAX_SPLIT, one 128-code step a
    part); every other sweep, and every sweep in (a), takes K whole."""
    p = TM.batched_plan("i8", 64, 768, 3072, 64)
    assert p.place == "b" and p.split == (1, 1, 2, 1, 2)  # 48 tiles x 2 <= 132 blocks
    assert TM.batched_plan("i8", 8, 768, 3072, 64).split == (1,) * 5  # (a)
    assert TM.batched_plan("i8", 64, 2048, 8192, 64).split == (1,) * 5  # 128 tiles
    assert TM.batched_plan("i8", 64, 128, 512, 32, head_size=32).split == (1, 1, 1, 1, 4)
    for b in (9, 64, 256):
        p = TM.batched_plan("i4", b, 768, 3072, 64)
        for sp, (rows, k) in zip(p.split, ((2304, 768), (256, 768), (768, 768), (3072, 768),
                                           (768, 3072))):
            assert 1 <= sp <= TM.K4_MAX_SPLIT and sp <= k // 128
            assert sp == 1 or rows // 16 * sp <= 132  # a block takes one (tile, part) at most


def test_plan_ints_match_the_c_entry():
    """The int entry takes the dims, w4 and the grid (9 ints), then the
    plan's eight: place, ring, five K slices, the shared bytes; the bf16
    entry the same with emb_f32 in w4's place; an earlier source's entry
    without a plan the first nine alone."""
    p = TM.batched_plan("i4", 17, 768, 3072, 64)
    ints = p.ints()
    assert ints == (1, p.ring, *p.k_slice, p.smem)
    assert TM.BATCHED_ARGS["i8"] == TM.BATCHED_ARGS["i4"] == (13, 9 + len(ints))
    assert TM.BATCHED_ARGS["bf16"] == (13, 9 + len(ints))
    assert TM.LEGACY_BATCHED_ARGS == (13, 9)


@pytest.mark.parametrize("batch", [1, 8, 17, 64])
def test_scratch_holds_the_code_buffer_aligned(batch):
    """The int forms' scratch adds placement (b)'s scales and codes after
    the bf16 form's arrays; the codes start on a 16-byte boundary."""
    c, f, d = 768, 3072, 64
    base = TM.batched_scratch_floats(c, d, f, batch, codes=False)
    assert base == (6 * c + 4 * d + f) * batch
    full = TM.batched_scratch_floats(c, d, f, batch)
    dx = -(-6 * batch // 4) * 4
    assert (base + dx) % 4 == 0
    assert (full - base - dx) * 4 >= max(6 * c, f) * batch


# -- the sweep's fragments ------------------------------------------------------


def _lane_words(rows: np.ndarray, offset: int, nbytes: int) -> np.ndarray:
    """nbytes of each row from `offset` as little-endian 32-bit words."""
    return rows[:, offset:offset + nbytes].copy().view(np.int32).reshape(rows.shape[0], -1)


def _lanes(rows: np.ndarray, row0: int, base: int, nbytes: int) -> np.ndarray:
    """Lane (g = lane / 4, t = lane % 4)'s nbytes of row row0 + g from byte
    base + nbytes t, as int32 words [32, nbytes / 4]."""
    return np.stack([_lane_words(rows[row0 + lane // 4:row0 + lane // 4 + 1],
                                 base + nbytes * (lane % 4), nbytes)[0] for lane in range(32)])


def _unpack_w4_word(w: np.ndarray, hi: bool) -> np.ndarray:
    """w4_lo16 / w4_hi16 of csrc/common.cuh on int32 words: each byte's low
    (high) nibble as an int8 times 16."""
    u = w.view(np.uint32)
    u = u & np.uint32(0xF0F0F0F0) if hi else (u << np.uint32(4)) & np.uint32(0xF0F0F0F0)
    return u.view(np.int32)


def _mma_m16n8k32(a_regs: np.ndarray, b_regs: np.ndarray) -> np.ndarray:
    """mma.sync.m16n8k32.row.col.s32.s8.s8 from the 32 lanes' registers:
    a_regs [32, 4] and b_regs [32, 2] int32 words of four int8 each, laid
    out as the PTX ISA gives them (groupID g = lane / 4, t = lane % 4: a0
    row g, k 4t..4t+3; a1 row g + 8; a2 / a3 the same at k + 16; b0 k
    4t..4t+3 of column g, b1 at k + 16). Returns the 16 x 8 int32 product."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        av = a_regs[lane].astype("<i4").view(np.int8).astype(np.int64).reshape(4, 4)
        bv = b_regs[lane].astype("<i4").view(np.int8).astype(np.int64).reshape(2, 4)
        a[g, 4 * t:4 * t + 4] = av[0]
        a[g + 8, 4 * t:4 * t + 4] = av[1]
        a[g, 16 + 4 * t:16 + 4 * t + 4] = av[2]
        a[g + 8, 16 + 4 * t:16 + 4 * t + 4] = av[3]
        b[4 * t:4 * t + 4, g] = bv[0]
        b[16 + 4 * t:16 + 4 * t + 4, g] = bv[1]
    return a @ b


def emulate_sweep(w_codes: np.ndarray, acts: np.ndarray, w4: bool, ks: int, kw: int,
                  split: int = 1) -> np.ndarray:
    """The int32 sums K4's sweep computes for rows `w_codes` [N, K] (int8
    codes; int4 ones in -8..7 when w4) against `acts` [B, K] int8 codes,
    in the kernel's order: 16-row tiles, each cut into `split` K parts of
    whole 128-code steps (blocks whose partial sums are added), n-tiles of
    8 sequences (the last zero-filled past B), a part's K slices of ks
    codes (zero-filled past the part), 128-code K steps dealt to kw warps
    in turn, and in each step lane (g, t) taking bytes 32t..32t+31 of the
    step from rows g and g + 8 (int4: the 16-byte chunk t of the packed
    row, unpacked) and from sequence g as the four products' registers.
    Returns [N, B] (int4: shifted right by 4, as the kernel does)."""
    n, k = w_codes.shape
    b = acts.shape[0]
    nt = -(-b // 8)
    steps = -(-k // 128)
    kr = -(-k // ks) * ks + 128 * steps
    # the stored rows (int8 codes, or the port's int4 pack) and the codes,
    # zero-filled to whole slices and n-tiles
    stored = TK.pack_int4(w_codes).numpy() if w4 else w_codes
    wbytes = np.zeros((n, kr // 2 if w4 else kr), np.int8)
    wbytes[:, :stored.shape[1]] = stored
    x = np.zeros((8 * nt, kr), np.int8)
    x[:b, :k] = acts
    out = np.zeros((n, 8 * nt), np.int64)
    for tile in range(n // 16):
        rows = wbytes[tile * 16:(tile + 1) * 16]
        for nti in range(nt):
            seqs = x[nti * 8:(nti + 1) * 8]
            part = np.zeros((split, kw, 16, 8), np.int64)  # each block's warps' sums
            for kp in range(split):
                lo, hi = 128 * (steps * kp // split), min(k, 128 * (steps * (kp + 1) // split))
                for k0 in range(lo, hi, ks):
                    for kk in range(-(-min(ks, hi - k0) // 128)):
                        step = k0 + 128 * kk
                        if w4:  # 16 packed bytes a lane, unpacked into 32 codes x 16
                            ra, rb = (_lanes(rows, r0, step // 2, 16) for r0 in (0, 8))
                            ra, rb = (np.concatenate([_unpack_w4_word(w, False),
                                                      _unpack_w4_word(w, True)], 1)
                                      for w in (ra, rb))
                        else:
                            ra, rb = (_lanes(rows, r0, step, 32) for r0 in (0, 8))
                        xs = _lanes(seqs, 0, step, 32)
                        for q in range(4):
                            a_regs = np.stack([ra[:, 2 * q], rb[:, 2 * q], ra[:, 2 * q + 1],
                                               rb[:, 2 * q + 1]], 1)
                            b_regs = np.stack([xs[:, 2 * q], xs[:, 2 * q + 1]], 1)
                            part[kp, kk % kw] += _mma_m16n8k32(a_regs, b_regs)
            # the warps' sums added in shared memory, the blocks' in global
            # memory (integers: any order)
            out[tile * 16:(tile + 1) * 16, nti * 8:(nti + 1) * 8] = part.sum((0, 1))
    assert np.abs(out).max() < 2 ** 31  # the int32 accumulators never wrap
    out = out[:, :b].astype(np.int32)
    return out >> 4 if w4 else out


def _operands(n, k, b, w4, seed):
    rng = np.random.default_rng(seed)
    lim = 7 if w4 else 127
    w = rng.integers(-lim, lim + 1, (n, k)).astype(np.int8)
    x = rng.integers(-127, 128, (b, k)).astype(np.int8)
    return w, x


# (rows, K, B, K slice, warps a unit, K parts): whole and sliced K, K tails
# past the last 128-code step, ragged and whole n-tiles, K steps shared by
# warps, tiles cut into K parts (the split out / fv sweeps)
SWEEP_CASES = [(32, 256, 17, 256, 1, 1), (16, 384, 8, 128, 2, 1), (16, 160, 3, 128, 4, 1),
               (48, 128, 9, 128, 8, 1), (16, 96, 1, 128, 1, 1), (16, 384, 9, 128, 2, 2),
               (32, 416, 17, 256, 1, 3)]


@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("n, k, b, ks, kw, split", SWEEP_CASES)
def test_sweep_fragments_equal_the_plain_and_jax_dots(n, k, b, ks, kw, split, w4):
    w, x = _operands(n, k, b, w4, seed=n + k + b + ks + kw + split + int(w4))
    got = emulate_sweep(w, x, w4, ks, kw, split)
    # K4's plain version: _matvec's exact integer dot on the unpacked codes
    codes = TK.unpack_int4(TK.pack_int4(w)) if w4 else torch.from_numpy(w)
    assert torch.equal(codes, torch.from_numpy(w))
    plain = TK.int_dot_plain(torch.from_numpy(x).float(), codes.float()).T.numpy()
    np.testing.assert_array_equal(got, plain.astype(np.int64))
    # the JAX package's: the int8 dot, or _w4_acc on its split-half pack (16x)
    xt = jnp.asarray(x.T)
    if w4:
        jw = JM._pack_nibbles_split_half(jnp.asarray(w))
        kh = k // 2

        def mm(a, v):
            return jnp.dot(a.astype(jnp.int32), v.astype(jnp.int32))

        ref16 = np.asarray(JM._w4_acc(mm, jw, xt[:kh], xt[kh:]))
        np.testing.assert_array_equal(got * 16, ref16)
    else:
        ref = np.asarray(jnp.dot(jnp.asarray(w, jnp.int32), xt.astype(jnp.int32)))
        np.testing.assert_array_equal(got, ref)


def test_sweep_fragments_see_k_in_natural_order_per_lane():
    """A single nonzero code at K position p reaches exactly the product of
    row r and sequence s with that code: the lanes' K permutation is the
    same for both operands, and int4's unpack keeps natural K order."""
    k, b = 256, 9
    for w4 in (False, True):
        for p in (0, 5, 16, 31, 32, 100, 127, 128, 200, 255):
            w = np.zeros((16, k), np.int8)
            x = np.zeros((b, k), np.int8)
            w[3, p] = 3
            x[8, p] = -5
            got = emulate_sweep(w, x, w4, 128, 2)
            want = np.zeros((16, b), np.int32)
            want[3, 8] = -15
            np.testing.assert_array_equal(got, want, err_msg=f"w4={w4} p={p}")

"""Vectorized CAVLC: every residual block of a slice coded at once — the
port's own copy of x264_tpu/entropy/cavlc_vec.py, the host I16x16 coder
of the synchronous CAVLC overflow path (Encoder._write_i_slice).

The scalar coder (cavlc.py) processes one block at a time; at 1080p that
is ~250k Python block encodes per frame. Here the whole slice's blocks are
coded as NumPy array ops: each block expands to a fixed 34-slot layout of
(value, length) code pairs (length 0 = absent), sequential dependencies
(suffix-length adaptation, zeros-left chain) run as short loops over the
16 level slots / 15 run slots, vectorized across all blocks.

The bitstream is the concatenation of all slots in syntax order, packed by
bitstream.BitWriter.put_codes. It is x264_tpu's host coder, not its device
coder (entropy/device.py): the nC of an I16x16 MB counts only its coded
AC blocks, and the last level-suffix threshold is 0x7FFFFFFF. Held
against x264_tpu's function and the scalar coder by
tests/test_torch_encoder_overflow.py.
"""

from __future__ import annotations

import numpy as np

from . import cavlc_tables as T

# per-block slot layout
N_LEVEL_SLOTS = 16
N_RUN_SLOTS = 15
BLOCK_SLOTS = 1 + 1 + N_LEVEL_SLOTS + 1 + N_RUN_SLOTS  # 34

_CT_INDEX = np.array([0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9, dtype=np.int64)
_NEXT_SUFFIX = np.array([0, 3, 6, 12, 24, 48, 0x7FFFFFFF], dtype=np.int64)


def ue_codes(v):
    """Vectorized unsigned Exp-Golomb -> (value, length)."""
    v = np.asarray(v, dtype=np.int64)
    n = np.int64(1) + np.int64(np.log2(np.maximum(v + 1, 1))).astype(np.int64)
    # bit_length via log2 is fragile at boundaries; do it exactly:
    n = _bitlen(v + 1)
    return v + 1, 2 * n - 1


def se_codes(v):
    v = np.asarray(v, dtype=np.int64)
    m = np.where(v > 0, 2 * v - 1, -2 * v)
    return ue_codes(m)


def _bitlen(x):
    """Exact bit length of positive int64 array."""
    x = np.asarray(x, dtype=np.int64)
    out = np.zeros_like(x)
    v = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        ge = v >= (np.int64(1) << shift)
        out += np.where(ge, shift, 0)
        v = np.where(ge, v >> shift, v)
    return out + (x > 0)


def residual_codes(coeffs: np.ndarray, nc: np.ndarray) -> tuple:
    """Code all residual blocks.

    coeffs: (N, C) int in scan order (C in {4, 15, 16}; pass each category
            separately).
    nc:     (N,) predicted nC; -1 entries select the chroma-DC tables.

    Returns (vals, lens): (N, 34) int64 each, plus totals (N,).
    """
    coeffs = np.asarray(coeffs, dtype=np.int64)
    N, C = coeffs.shape
    nz = coeffs != 0
    total = nz.sum(axis=1)

    vals = np.zeros((N, BLOCK_SLOTS), dtype=np.int64)
    lens = np.zeros((N, BLOCK_SLOTS), dtype=np.int64)

    # ---- reverse-order levels and positions
    pos = np.arange(C, dtype=np.int64)[None, :]
    key = np.where(nz, pos, np.int64(-1))
    order = np.argsort(-key, axis=1, kind="stable")       # nz desc, then zeros
    lvl = np.take_along_axis(coeffs, order, axis=1)       # (N, C)
    pdesc = np.take_along_axis(np.broadcast_to(pos, coeffs.shape), order, axis=1)
    idx = np.arange(C, dtype=np.int64)[None, :]
    in_total = idx < total[:, None]

    # ---- trailing ones
    is_one = (np.abs(lvl) == 1) & in_total
    lead1 = np.cumprod(is_one, axis=1, dtype=np.int64)
    trailing = np.minimum(lead1.sum(axis=1), 3)

    # ---- coeff_token
    cls = np.where(nc < 0, 4, _CT_INDEX[np.clip(nc, 0, 16)])
    tok_idx = (total - 1) * 4 + trailing
    tok = np.where(total[:, None] > 0,
                   T.COEFF_TOKEN[cls, np.clip(tok_idx, 0, 63)],
                   T.COEFF0_TOKEN[cls])
    vals[:, 0], lens[:, 0] = tok[:, 0], tok[:, 1]

    # ---- trailing sign bits (MSB = highest-frequency coefficient)
    signs = (lvl < 0).astype(np.int64)
    sign_bits = np.zeros(N, dtype=np.int64)
    for i in range(3):
        take = i < trailing
        sign_bits = np.where(take, (sign_bits << 1) | signs[:, i], sign_bits)
    vals[:, 1] = sign_bits
    lens[:, 1] = trailing

    # ---- levels (suffix-length chain across the 16 slots)
    suffix = ((total > 10) & (trailing < 3)).astype(np.int64)
    for i in range(N_LEVEL_SLOTS):
        if i >= C:
            break
        active = (idx[0, i] >= trailing) & (i < total)
        level = lvl[:, i]
        orig_abs = np.abs(level)
        first = active & (i == trailing) & (trailing < 3)
        level = np.where(first, level - np.sign(level), level)
        v, l = _level_codes(level, suffix)
        vals[:, 2 + i] = np.where(active, v, 0)
        lens[:, 2 + i] = np.where(active, l, 0)
        new_suffix = np.maximum(suffix, 1)
        new_suffix = np.where(
            (orig_abs > _NEXT_SUFFIX[new_suffix]) & (new_suffix < 6),
            new_suffix + 1, new_suffix)
        suffix = np.where(active, new_suffix, suffix)

    # ---- total_zeros
    last = pdesc[:, 0]                                     # highest nz pos
    total_zeros = last + 1 - total
    tz_needed = (total > 0) & (total < C)
    is_dc = nc < 0
    tz_idx = np.clip(total - 1, 0, 14)
    tz = np.where(is_dc[:, None],
                  T.TOTAL_ZEROS_DC[np.clip(total - 1, 0, 2),
                                   np.clip(total_zeros, 0, 3)],
                  T.TOTAL_ZEROS[tz_idx, np.clip(total_zeros, 0, 15)])
    vals[:, 18] = np.where(tz_needed, tz[:, 0], 0)
    lens[:, 18] = np.where(tz_needed, tz[:, 1], 0)

    # ---- run_before chain
    runs = pdesc[:, :-1] - pdesc[:, 1:] - 1                # (N, C-1)
    zeros_left = total_zeros.copy()
    for i in range(min(N_RUN_SLOTS, C - 1)):
        active = (i < total - 1) & (zeros_left > 0)
        zl = np.clip(zeros_left - 1, 0, 6)
        r = np.clip(runs[:, i], 0, 14)
        rb = T.RUN_BEFORE[zl, r]
        vals[:, 19 + i] = np.where(active, rb[:, 0], 0)
        lens[:, 19 + i] = np.where(active, rb[:, 1], 0)
        zeros_left = np.where(active, zeros_left - runs[:, i], zeros_left)

    return vals, lens, total


def _level_codes(level, suffix):
    """Vectorized level coding (mirrors cavlc._write_level)."""
    abs_level = np.abs(level)
    lc = abs_level * 2 - 2 + (level < 0)

    msk = (np.int64(1) << suffix) - 1
    direct = (lc >> suffix) < 14
    esc19 = (~direct) & (suffix == 0) & (lc < 30)
    esc15 = (~direct) & (suffix > 0) & ((lc >> suffix) == 14)

    v_direct = (np.int64(1) << suffix) | (lc & msk)
    l_direct = (lc >> suffix) + 1 + suffix
    v_19 = (np.int64(1) << 4) | np.clip(lc - 14, 0, 15)
    l_19 = np.full_like(lc, 19)
    v_15 = v_direct
    l_15 = 15 + suffix

    # large escape: prefix p = bitlen(lc2 + 4096) + 2, suffix p-3 bits
    lc2 = lc - (np.int64(15) << suffix) - np.where(suffix == 0, 15, 0)
    lc2 = np.maximum(lc2, 0)
    p = _bitlen(lc2 + 4096) + 2
    sfx = lc2 + 4096 - (np.int64(1) << (p - 3))
    v_esc = (np.int64(1) << (p - 3)) | sfx
    l_esc = 2 * p - 2

    v = np.where(direct, v_direct,
                 np.where(esc19, v_19, np.where(esc15, v_15, v_esc)))
    l = np.where(direct, l_direct,
                 np.where(esc19, l_19, np.where(esc15, l_15, l_esc)))
    return v, l


# ---------------------------------------------------------------------------
# Slice-level assembly
# ---------------------------------------------------------------------------

def _nc_map(count_map):
    """Predicted nC at every block position from the coded-count map
    (x264_mb_predict_non_zero_code semantics, common/macroblock.h)."""
    a = np.full_like(count_map, -1)
    a[:, 1:] = count_map[:, :-1]      # left neighbor
    b = np.full_like(count_map, -1)
    b[1:, :] = count_map[:-1, :]      # top neighbor
    both = (a >= 0) & (b >= 0)
    return np.where(both, (a + b + 1) >> 1,
                    np.where(a >= 0, a, np.where(b >= 0, b, 0)))


def i16_slice_codes(out: dict, mb_w: int, mb_h: int):
    """Build the (value, length) code planes for a whole I16x16 CAVLC slice
    from the device pipeline outputs. Returns flat (vals, lens)."""
    from .. import tables

    luma_dc = np.asarray(out["luma_dc"])      # (mbh, mbw, 16)
    luma_ac = np.asarray(out["luma_ac"])      # (mbh, mbw, 16z, 16)
    chroma_dc = np.asarray(out["chroma_dc"])  # (mbh, mbw, 2, 4)
    chroma_ac = np.asarray(out["chroma_ac"])  # (mbh, mbw, 2, 4, 16)
    mode16 = np.asarray(out["mode16"])
    modec = np.asarray(out["modec"])
    nmb = mb_h * mb_w
    R = np.asarray(tables.LUMA4x4_RASTER_OF_Z)

    cbp_luma = np.any(luma_ac[..., 1:] != 0, axis=(-2, -1))
    cnz_ac = np.any(chroma_ac[..., 1:] != 0, axis=(-2, -1))
    cnz_dc = np.any(chroma_dc != 0, axis=-1)
    cbp_chroma = np.where(cnz_ac.any(-1), 2, np.where(cnz_dc.any(-1), 1, 0))

    # ---- coded-count maps -> nC per block
    counts_z = np.count_nonzero(luma_ac[..., 1:], axis=-1)
    counts_z = np.where(cbp_luma[..., None], counts_z, 0)
    counts_raster = np.zeros_like(counts_z)
    counts_raster[..., R] = counts_z
    lmap = counts_raster.reshape(mb_h, mb_w, 4, 4).swapaxes(1, 2) \
        .reshape(mb_h * 4, mb_w * 4)
    nc_l_raster = _nc_map(lmap).reshape(mb_h, 4, mb_w, 4).swapaxes(1, 2) \
        .reshape(mb_h, mb_w, 16)
    nc_l = nc_l_raster[..., R]                 # z-scan order

    ccounts = np.count_nonzero(chroma_ac[..., 1:], axis=-1)
    ccounts = np.where((cbp_chroma == 2)[..., None, None], ccounts, 0)
    nc_c = np.zeros((mb_h, mb_w, 2, 4), dtype=np.int64)
    for ch in range(2):
        cmap = ccounts[..., ch, :].reshape(mb_h, mb_w, 2, 2).swapaxes(1, 2) \
            .reshape(mb_h * 2, mb_w * 2)
        nc_c[..., ch, :] = _nc_map(cmap).reshape(mb_h, 2, mb_w, 2) \
            .swapaxes(1, 2).reshape(mb_h, mb_w, 4)

    # ---- residual codes per category
    dc_v, dc_l, _ = residual_codes(luma_dc.reshape(nmb, 16),
                                   nc_l[..., 0].reshape(nmb))
    ac_v, ac_l, _ = residual_codes(luma_ac[..., 1:].reshape(nmb * 16, 15),
                                   nc_l.reshape(nmb * 16))
    cdc_v, cdc_l, _ = residual_codes(chroma_dc.reshape(nmb * 2, 4),
                                     np.full(nmb * 2, -1, dtype=np.int64))
    cac_v, cac_l, _ = residual_codes(chroma_ac[..., 1:].reshape(nmb * 8, 15),
                                     nc_c.reshape(nmb * 8))

    # ---- conditional presence
    ac_l = ac_l.reshape(nmb, 16, BLOCK_SLOTS) \
        * cbp_luma.reshape(nmb, 1, 1)
    cdc_l = cdc_l.reshape(nmb, 2, BLOCK_SLOTS) \
        * (cbp_chroma > 0).reshape(nmb, 1, 1)
    cac_l = cac_l.reshape(nmb, 8, BLOCK_SLOTS) \
        * (cbp_chroma == 2).reshape(nmb, 1, 1)

    # ---- MB header codes
    mb_type = 1 + mode16 + 4 * cbp_chroma + 12 * cbp_luma.astype(np.int64)
    h_v = np.zeros((nmb, 3), dtype=np.int64)
    h_l = np.zeros((nmb, 3), dtype=np.int64)
    h_v[:, 0], h_l[:, 0] = ue_codes(mb_type.reshape(nmb))
    h_v[:, 1], h_l[:, 1] = ue_codes(modec.reshape(nmb))
    h_v[:, 2], h_l[:, 2] = se_codes(np.zeros(nmb, dtype=np.int64))  # dqp

    vals = np.concatenate([
        h_v,
        dc_v.reshape(nmb, BLOCK_SLOTS),
        ac_v.reshape(nmb, 16 * BLOCK_SLOTS),
        cdc_v.reshape(nmb, 2 * BLOCK_SLOTS),
        cac_v.reshape(nmb, 8 * BLOCK_SLOTS)], axis=1)
    lens = np.concatenate([
        h_l,
        dc_l.reshape(nmb, BLOCK_SLOTS),
        ac_l.reshape(nmb, 16 * BLOCK_SLOTS),
        cdc_l.reshape(nmb, 2 * BLOCK_SLOTS),
        cac_l.reshape(nmb, 8 * BLOCK_SLOTS)], axis=1)
    return vals.ravel(), lens.ravel()

"""CAVLC entropy coding (encoder/cavlc.c, common/vlc.c) — the port's own
copy of x264_tpu/entropy/cavlc.py, the scalar host coder that
cavlc_vec.py vectorises.

Host-side implementation operating on the per-MB coefficient/nnz arrays
produced by the frame pipelines. Layout of inputs per macroblock
(all zig-zag scanned already):

  luma_dc   (16,)      i16x16 DC after 4x4 Hadamard
  luma_ac   (16, 16)   per 4x4 block; for i16x16 entry 0 is unused (AC
                       blocks code positions 1..15)
  chroma_dc (2, 4)     per channel, 2x2 DC in spec scan order
  chroma_ac (2, 4, 16) per channel/block, entry 0 unused (AC)

The residual coder is block_residual_write_cavlc (encoder/cavlc.c:115)
including the escape/suffix-length adaptation (encoder/cavlc.c:63-113).
"""

from __future__ import annotations

import numpy as np

from . import cavlc_tables as T
from .bitstream import BitWriter

# ctxBlockCat analogues (count limits)
LUMA_DC = "luma_dc"      # 16 coeffs
LUMA_AC = "luma_ac"      # 15 coeffs
LUMA_4x4 = "luma_4x4"    # 16 coeffs
CHROMA_DC = "chroma_dc"  # 4 coeffs
CHROMA_AC = "chroma_ac"  # 15 coeffs

_CT_INDEX = np.array([0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3])
_NEXT_SUFFIX = (0, 3, 6, 12, 24, 48, 0xFFFF)


def nc_class(nc: int) -> int:
    """coeff_token table selector: 0..3 for nC>=0, 4 for chroma DC."""
    if nc < 0:
        return 4
    return int(_CT_INDEX[min(nc, 16)])


def write_block_residual(bs: BitWriter, coeffs, nc: int,
                         high_profile: bool = True) -> int:
    """Encode one residual block; returns total_coeff (the value cached as
    non_zero_count for neighbor nC context).

    coeffs: 1-D array in scan order (zeros included), length 4/15/16.
    nc: the predicted nC (or -1 for chroma DC).
    """
    coeffs = np.asarray(coeffs)
    nz_pos = np.nonzero(coeffs)[0]
    total = len(nz_pos)
    cls = nc_class(nc)
    if total == 0:
        v, l = T.COEFF0_TOKEN[cls]
        bs.put(int(v), int(l))
        return 0

    last = int(nz_pos[-1])
    levels = coeffs[nz_pos][::-1].astype(np.int64)  # reverse scan order
    # runs[i] = zeros between reverse-order coefficient i and the next one
    # (x264_coeff_level_run, common/quant.c); the run below the lowest
    # nz coefficient is implied by total_zeros and never written.
    runs = (-np.diff(nz_pos[::-1]) - 1).astype(np.int64)  # length total-1
    total_zeros = last + 1 - total

    # trailing ones: up to 3 leading (in reverse order) levels with |l|==1
    trailing = 0
    while trailing < min(3, total) and abs(int(levels[trailing])) == 1:
        trailing += 1

    v, l = T.COEFF_TOKEN[cls][(total - 1) * 4 + trailing]
    bs.put(int(v), int(l))

    suffix_length = 1 if (total > 10 and trailing < 3) else 0

    if trailing:
        sign_bits = 0
        for i in range(trailing):
            sign_bits = (sign_bits << 1) | (1 if levels[i] < 0 else 0)
        bs.put(sign_bits, trailing)

    for i in range(trailing, total):
        level = int(levels[i])
        orig_abs = abs(level)
        if i == trailing and trailing < 3:
            # first coded level can't be +-1 here; save one index. The
            # suffix-length adaptation still uses the ORIGINAL level
            # (val vs val_original, encoder/cavlc.c:160-170).
            level -= 1 if level > 0 else -1
        suffix_length = _write_level(bs, level, suffix_length, high_profile,
                                     update_abs=orig_abs)

    if total < len(coeffs):
        if nc < 0:
            v, l = T.TOTAL_ZEROS_DC[total - 1][total_zeros]
        else:
            v, l = T.TOTAL_ZEROS[total - 1][total_zeros]
        bs.put(int(v), int(l))

    zeros_left = total_zeros
    for i in range(total - 1):
        if zeros_left <= 0:
            break
        zl = min(zeros_left - 1, 6)
        v, l = T.RUN_BEFORE[zl][int(runs[i])]
        bs.put(int(v), int(l))
        zeros_left -= int(runs[i])
    return total


def _write_level(bs: BitWriter, level: int, suffix_length: int,
                 high_profile: bool, update_abs: int | None = None) -> int:
    """Level coding + suffix-length adaptation
    (block_residual_write_cavlc_escape, encoder/cavlc.c:63).
    update_abs: magnitude used for the suffix-length update (differs from
    |level| only for the first coded level after trailing ones)."""
    abs_level = abs(level)
    if update_abs is None:
        update_abs = abs_level
    level_code = abs_level * 2 - 2 + (1 if level < 0 else 0)

    if (level_code >> suffix_length) < 14:
        prefix = level_code >> suffix_length
        bs.put((1 << suffix_length) | (level_code & ((1 << suffix_length) - 1)),
               prefix + 1 + suffix_length)
    elif suffix_length == 0 and level_code < 30:
        # prefix 14 + 4-bit FLC suffix (x264_init_vlc_tables, vlc.c:893)
        bs.put((1 << 4) | (level_code - 14), 19)
    elif suffix_length > 0 and (level_code >> suffix_length) == 14:
        bs.put((1 << suffix_length) | (level_code & ((1 << suffix_length) - 1)),
               15 + suffix_length)
    else:
        level_prefix = 15
        level_code -= 15 << suffix_length
        if suffix_length == 0:
            level_code -= 15
        if level_code >= (1 << 12):
            if high_profile:
                # NB: the reference uses a strict '>' here
                # (encoder/cavlc.c:87), which mis-encodes the single value
                # level_code == 1<<(prefix-3); '>=' matches the spec decoder
                # for all values (difference unreachable with 8-bit input).
                while level_code >= (1 << (level_prefix - 3)):
                    level_code -= 1 << (level_prefix - 3)
                    level_prefix += 1
            else:
                level_code = (1 << 12) - 2 + (level_code & 1)
        bs.put(1, level_prefix + 1)
        bs.put(level_code & ((1 << (level_prefix - 3)) - 1), level_prefix - 3)

    if suffix_length == 0:
        suffix_length = 1
    if update_abs > _NEXT_SUFFIX[suffix_length] and suffix_length < 6:
        suffix_length += 1
    return suffix_length


def write_mb_i16x16(bs: BitWriter, slice_type_offset: int, pred16: int,
                    chroma_pred: int, cbp_luma: int, cbp_chroma: int,
                    qp_delta: int, luma_dc, luma_ac, chroma_dc, chroma_ac,
                    nc_luma, nc_chroma, high_profile: bool = True):
    """I_16x16 macroblock syntax (x264_macroblock_write_cavlc,
    encoder/cavlc.c:375-607, I_16x16 branch).

    nc_luma: (16,) predicted nC per luma 4x4 block (z-scan order);
             nc_luma[0] is also used for the luma DC block.
    nc_chroma: (2, 4) per channel/block.
    Returns nothing; nnz caching is done by the caller (it owns the maps).
    """
    bs.ue(slice_type_offset + 1 + pred16 + cbp_chroma * 4
          + (12 if cbp_luma else 0))
    bs.ue(chroma_pred)

    # qp delta (suppressed for fully-empty i16x16, cavlc_qp_delta logic
    # handled by caller passing qp_delta=0 in that case)
    _write_qp_delta(bs, qp_delta)

    write_block_residual(bs, luma_dc, int(nc_luma[0]), high_profile)
    if cbp_luma:
        for i in range(16):
            write_block_residual(bs, luma_ac[i][1:], int(nc_luma[i]),
                                 high_profile)
    _write_chroma_residual(bs, cbp_chroma, chroma_dc, chroma_ac, nc_chroma,
                           high_profile)


def _write_qp_delta(bs: BitWriter, dqp: int):
    if dqp:
        if dqp < -26:
            dqp += 52
        elif dqp > 25:
            dqp -= 52
    bs.se(dqp)


def _write_chroma_residual(bs: BitWriter, cbp_chroma, chroma_dc, chroma_ac,
                           nc_chroma, high_profile):
    if cbp_chroma:
        write_block_residual(bs, chroma_dc[0], -1, high_profile)
        write_block_residual(bs, chroma_dc[1], -1, high_profile)
        if cbp_chroma & 0x2:
            for ch in range(2):
                for i in range(4):
                    write_block_residual(bs, chroma_ac[ch][i][1:],
                                         int(nc_chroma[ch][i]), high_profile)

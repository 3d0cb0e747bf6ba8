"""Spec constant tables + derived quantization tables.

Re-derivation of the H.264 quantization/scan constants used by the encoder.
Semantics follow the reference's table builder (common/set.c:68-174
``x264_cqm_init``) and the H.264 spec; everything here is plain NumPy and is
computed once at import / encoder-open time, then moved on-device as needed.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Scan orders (frame/progressive). Raster index = 4*row + col.
# Spec 8.5.6 zig-zag scan (equivalently common/dct.c:430 scan tables,
# accounting for this codebase's spec-oriented coefficient layout).
# ---------------------------------------------------------------------------

ZIGZAG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                   dtype=np.int32)

# 8x8 zig-zag (spec Figure 8-9); raster index = 8*row + col.
ZIGZAG8 = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

# Luma 4x4 block scan inside a macroblock ("z-order": 8x8 quadrant, then
# 4x4 within), as in the spec's 4x4 luma blkIdx ordering. Entry i gives
# (block_x, block_y) in units of 4 pixels.
LUMA4x4_BLOCK_XY = np.array(
    [(0, 0), (1, 0), (0, 1), (1, 1),
     (2, 0), (3, 0), (2, 1), (3, 1),
     (0, 2), (1, 2), (0, 3), (1, 3),
     (2, 2), (3, 2), (2, 3), (3, 3)], dtype=np.int32)

# raster position (4*by+bx) of z-scan block i  (block_idx_xy_1d analogue)
LUMA4x4_RASTER_OF_Z = np.array([4 * by + bx for (bx, by) in LUMA4x4_BLOCK_XY],
                               dtype=np.int32)

# chroma / generic 2x2-of-4x4 block order within an 8x8: raster
CHROMA_BLOCK_XY = np.array([(0, 0), (1, 0), (0, 1), (1, 1)], dtype=np.int32)

# ---------------------------------------------------------------------------
# Quantization scale constants (spec Table derived; identical numbers appear
# at common/set.c:24-66).
# ---------------------------------------------------------------------------

_DEQUANT4_SCALE = np.array([
    [10, 13, 16],
    [11, 14, 18],
    [13, 16, 20],
    [14, 18, 23],
    [16, 20, 25],
    [18, 23, 29]], dtype=np.int64)

_QUANT4_SCALE = np.array([
    [13107, 8066, 5243],
    [11916, 7490, 4660],
    [10082, 6554, 4194],
    [9362, 5825, 3647],
    [8192, 5243, 3355],
    [7282, 4559, 2893]], dtype=np.int64)

_QUANT8_SCAN = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                        dtype=np.int64)

_DEQUANT8_SCALE = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43]], dtype=np.int64)

_QUANT8_SCALE = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640]], dtype=np.int64)

# CQM list indices (common/common.h CQM_* enum semantics)
CQM_4IY, CQM_4PY, CQM_4IC, CQM_4PC = 0, 1, 2, 3
CQM_8IY, CQM_8PY = 0, 1

QP_MAX = 51


def _rounded_shift(x, s):
    """SHIFT macro of common/set.c:23 — rounded >> for s>0, << for s<0."""
    x = np.asarray(x, dtype=np.int64)
    if s > 0:
        return (x + (1 << (s - 1))) >> s
    if s == 0:
        return x
    return x << (-s)


def _rounded_div(n, d):
    return (n + (d >> 1)) // d


class QuantTables:
    """All per-QP quant/dequant tables (common/set.c:68 ``x264_cqm_init``).

    Built for a given set of scaling lists (default: flat 16) and deadzones.
    Arrays:
      quant4_mf   (4, 52, 16)  uint16-ranged multipliers
      quant4_bias (4, 52, 16)  deadzone offsets
      dequant4_mf (4, 6, 16)
      unquant4_mf (4, 52, 16)  exact inverse scale for trellis/RDO
      quant8_mf / quant8_bias (2, 52, 64), dequant8_mf (2, 6, 64)
    """

    def __init__(self, luma_deadzone_inter: int = 21, luma_deadzone_intra: int = 11,
                 scaling_list4=None, scaling_list8=None):
        # deadzone per CQM list, as common/set.c:77-80 (intra luma, inter
        # luma, intra chroma, inter chroma)
        deadzone = [32 - luma_deadzone_intra, 32 - luma_deadzone_inter,
                    32 - 11, 32 - 21]

        if scaling_list4 is None:
            scaling_list4 = np.full((4, 16), 16, dtype=np.int64)
        if scaling_list8 is None:
            scaling_list8 = np.full((2, 64), 16, dtype=np.int64)
        self.scaling_list4 = np.asarray(scaling_list4, dtype=np.int64)
        self.scaling_list8 = np.asarray(scaling_list8, dtype=np.int64)

        # position class j for each of the 16 coefficients: (x&1)+(y&1)
        idx = np.arange(16)
        j4 = (idx & 1) + ((idx >> 2) & 1)
        def_dequant4 = _DEQUANT4_SCALE[:, j4]          # (6,16)
        def_quant4 = _QUANT4_SCALE[:, j4]              # (6,16)

        idx8 = np.arange(64)
        j8 = _QUANT8_SCAN[((idx8 >> 1) & 12) | (idx8 & 3)]
        def_dequant8 = _DEQUANT8_SCALE[:, j8]          # (6,64)
        def_quant8 = _QUANT8_SCALE[:, j8]              # (6,64)

        # fold in scaling lists (common/set.c:130-139)
        self.dequant4_mf = np.empty((4, 6, 16), dtype=np.int64)
        quant4_mf6 = np.empty((4, 6, 16), dtype=np.int64)
        for l in range(4):
            self.dequant4_mf[l] = def_dequant4 * self.scaling_list4[l]
            quant4_mf6[l] = _rounded_div(def_quant4 * 16, self.scaling_list4[l])
        self.dequant8_mf = np.empty((2, 6, 64), dtype=np.int64)
        quant8_mf6 = np.empty((2, 6, 64), dtype=np.int64)
        for l in range(2):
            self.dequant8_mf[l] = def_dequant8 * self.scaling_list8[l]
            quant8_mf6[l] = _rounded_div(def_quant8 * 16, self.scaling_list8[l])

        # per-QP tables (common/set.c:142-164)
        self.quant4_mf = np.empty((4, 52, 16), dtype=np.int64)
        self.quant4_bias = np.empty((4, 52, 16), dtype=np.int64)
        self.unquant4_mf = np.empty((4, 52, 16), dtype=np.int64)
        self.quant8_mf = np.empty((2, 52, 64), dtype=np.int64)
        self.quant8_bias = np.empty((2, 52, 64), dtype=np.int64)
        self.unquant8_mf = np.empty((2, 52, 64), dtype=np.int64)
        for q in range(52):
            for l in range(4):
                base = quant4_mf6[l, q % 6]
                mf = _rounded_shift(base, q // 6 - 1)
                self.quant4_mf[l, q] = mf
                self.unquant4_mf[l, q] = (1 << (q // 6 + 15 + 8)) // base
                self.quant4_bias[l, q] = np.minimum(
                    _rounded_div(deadzone[l] << 10, mf), (1 << 15) // mf)
            for l in range(2):
                base = quant8_mf6[l, q % 6]
                mf = _rounded_shift(base, q // 6)
                self.quant8_mf[l, q] = mf
                self.unquant8_mf[l, q] = (1 << (q // 6 + 16 + 8)) // base
                self.quant8_bias[l, q] = np.minimum(
                    _rounded_div(deadzone[l] << 10, mf), (1 << 15) // mf)


# default tables used by CQP paths; custom CQMs construct their own
DEFAULT_QUANT = QuantTables()

# ---------------------------------------------------------------------------
# Chroma QP mapping (spec Table 8-15)
# ---------------------------------------------------------------------------

_CHROMA_QP_TAIL = np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                            37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
                           dtype=np.int32)

CHROMA_QP_TABLE = np.concatenate(
    [np.arange(30, dtype=np.int32), _CHROMA_QP_TAIL])


def chroma_qp(qp_luma: int, chroma_qp_offset: int = 0) -> int:
    q = int(np.clip(qp_luma + chroma_qp_offset, 0, 51))
    return int(CHROMA_QP_TABLE[q])


# ---------------------------------------------------------------------------
# Lambda tables (encoder/analyse.c:140-158 semantics):
# lambda = pow(2, (qp-12)/6) rounded; lambda2 for SSD-domain RD.
# ---------------------------------------------------------------------------

LAMBDA_TABLE = np.array(
    [max(1, int(round(2.0 ** ((q - 12) / 6.0)))) for q in range(52)],
    dtype=np.int32)

LAMBDA2_TABLE = np.array(
    [max(1, int(round((2.0 ** ((q - 12) / 6.0)) ** 2 * 0.9))) for q in range(52)],
    dtype=np.int32)


# ---------------------------------------------------------------------------
# Deblocking filter tables (spec Tables 8-16 / 8-17; the same constants
# appear as i_alpha_table / i_beta_table / i_tc0_table in common/frame.c:376).
# Indexed by clip(indexA/indexB, 0, 51); out-of-range clamping reproduces the
# reference's +-12 padded tables.
# ---------------------------------------------------------------------------

ALPHA_TABLE = np.array(
    [0] * 16 +
    [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
     40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182,
     203, 226, 255, 255], dtype=np.int32)

BETA_TABLE = np.array(
    [0] * 16 +
    [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
     11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32)

# TC0_TABLE[indexA][bS] for bS in 0..3 (column 0 unused, kept 0; the
# reference keeps -1 there and relies on tc<0 => skip, we mask on bS>0).
TC0_TABLE = np.array(
    [[0, 0, 0, 0]] * 17 + [
        [0, 0, 0, 1], [0, 0, 0, 1], [0, 0, 0, 1], [0, 0, 0, 1],
        [0, 0, 1, 1], [0, 0, 1, 1], [0, 1, 1, 1], [0, 1, 1, 1],
        [0, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1, 2], [0, 1, 1, 2],
        [0, 1, 1, 2], [0, 1, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3],
        [0, 2, 2, 3], [0, 2, 2, 4], [0, 2, 3, 4], [0, 2, 3, 4],
        [0, 3, 3, 5], [0, 3, 4, 6], [0, 3, 4, 6], [0, 4, 5, 7],
        [0, 4, 5, 8], [0, 4, 6, 9], [0, 5, 7, 10], [0, 6, 8, 11],
        [0, 6, 8, 13], [0, 7, 10, 14], [0, 8, 11, 16], [0, 9, 12, 18],
        [0, 10, 13, 20], [0, 11, 15, 23], [0, 13, 17, 25]],
    dtype=np.int32)

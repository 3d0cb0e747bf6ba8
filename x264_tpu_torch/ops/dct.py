"""H.264 4x4 integer transforms, batched over leading dims (int32,
bit-exact) — plain PyTorch twins of x264_tpu/ops/dct.py.

Forward/inverse 4x4 core transform and the 4x4 / 2x2 DC Hadamards
(common/dct.c:39-235, encoder/macroblock.c:30-86), in the spec
orientation: coefficients are indexed [row][col] with Y[0][1] the
horizontal frequency. The inverse transform runs rows first, then
columns, as the spec orders the truncating (>>1) passes. The 8x8 pair
(High profile, common/dct.c:239-345) keeps the reference's pass orders:
the forward transform truncates its intermediates, so it runs columns
first, then rows; the inverse runs rows, then columns.
"""

from __future__ import annotations

import torch

I32 = torch.int32

# forward core-transform matrix (spec 8.5.12 derivation)
_CF4 = ((1, 1, 1, 1), (2, 1, -1, -2), (1, -1, -1, 1), (1, -2, 2, -1))
# 4x4 Hadamard (luma DC), symmetric
_H4 = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))
_H2 = ((1, 1), (1, -1))


def _mat(m, like):
    return torch.tensor(m, dtype=I32, device=like.device)


def _mm(a, b):
    # exact in int32: CPU matmul supports integers; CUDA does not, so
    # the product runs as an explicit sum over the inner dim
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2, dtype=I32)


def dct4x4(diff):
    """Forward 4x4 transform Y = C d C^T of (..., 4, 4) residuals
    (sub4x4_dct, common/dct.c:122)."""
    c = _mat(_CF4, diff)
    return _mm(_mm(c, diff.to(I32)), c.T)


def _idct4_1d(s):
    """Spec 8.5.12.2 1-D inverse butterfly along the last axis."""
    x0, x1, x2, x3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    e0 = x0 + x2
    e1 = x0 - x2
    e2 = (x1 >> 1) - x3
    e3 = x1 + (x3 >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)


def idct4x4(coef):
    """Inverse 4x4 transform -> residual incl. (x+32)>>6 (add4x4_idct,
    common/dct.c:175, minus the final add+clip)."""
    t = _idct4_1d(coef.to(I32))                                   # rows
    t = _idct4_1d(t.transpose(-1, -2)).transpose(-1, -2)          # columns
    return (t + 32) >> 6


def hadamard4x4_fwd(dc):
    """Forward 4x4 Hadamard for I16x16 luma DC with (x+1)>>1
    (dct4x4dc, common/dct.c:39)."""
    h = _mat(_H4, dc)
    return (_mm(_mm(h, dc.to(I32)), h) + 1) >> 1


def hadamard4x4_inv(dc):
    """Inverse 4x4 Hadamard (idct4x4dc, common/dct.c:73); no scaling."""
    h = _mat(_H4, dc)
    return _mm(_mm(h, dc.to(I32)), h)


def hadamard2x2(dc):
    """2x2 Hadamard of (..., 2, 2) chroma DC, forward and inverse
    (dct2x2dc / idct_dequant_2x2_dc, encoder/macroblock.c:30-86)."""
    h = _mat(_H2, dc)
    return _mm(_mm(h, dc.to(I32)), h)


# ----------------------------------------------------------------------
# 8x8 transform (High profile) - common/dct.c:239-345
# ----------------------------------------------------------------------

def _dct8_1d(s):
    """1-D 8-point forward transform along the last axis (DCT8_1D,
    common/dct.c:239)."""
    x = [s[..., i] for i in range(8)]
    s07, s16, s25, s34 = x[0] + x[7], x[1] + x[6], x[2] + x[5], x[3] + x[4]
    a0, a1, a2, a3 = s07 + s34, s16 + s25, s07 - s34, s16 - s25
    d07, d16, d25, d34 = x[0] - x[7], x[1] - x[6], x[2] - x[5], x[3] - x[4]
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    return torch.stack([a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1),
                        a5 + (a6 >> 2), a0 - a1, a6 - (a5 >> 2),
                        (a2 >> 1) - a3, (a4 >> 2) - a7], dim=-1)


def dct8x8(diff):
    """Forward 8x8 transform of (..., 8, 8) residuals (sub8x8_dct8,
    common/dct.c:266): columns first, then rows."""
    t = _dct8_1d(diff.to(I32).transpose(-1, -2)).transpose(-1, -2)
    return _dct8_1d(t)


def _idct8_1d(s):
    """1-D 8-point inverse butterfly along the last axis (IDCT8_1D,
    common/dct.c:297; spec 8.5.12.3)."""
    x = [s[..., i] for i in range(8)]
    a0, a2 = x[0] + x[4], x[0] - x[4]
    a4, a6 = (x[2] >> 1) - x[6], (x[6] >> 1) + x[2]
    b0, b2, b4, b6 = a0 + a6, a2 + a4, a2 - a4, a0 - a6
    a1 = -x[3] + x[5] - x[7] - (x[7] >> 1)
    a3 = x[1] + x[7] - x[3] - (x[3] >> 1)
    a5 = -x[1] + x[7] + x[5] + (x[5] >> 1)
    a7 = x[3] + x[5] + x[1] + (x[1] >> 1)
    b1, b3 = (a7 >> 2) + a1, a3 + (a5 >> 2)
    b5, b7 = (a3 >> 2) - a5, a7 - (a1 >> 2)
    return torch.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1,
                        b4 - b3, b2 - b5, b0 - b7], dim=-1)


def idct8x8(coef):
    """Inverse 8x8 transform -> residual, with the rounding +32 folded
    into coef[0][0] and the final >> 6 (add8x8_idct8, common/dct.c:324,
    minus the add and clip): rows first, then columns."""
    c = coef.to(I32).clone()
    c[..., 0, 0] += 32
    t = _idct8_1d(c)                                              # rows
    t = _idct8_1d(t.transpose(-1, -2)).transpose(-1, -2)          # columns
    return t >> 6

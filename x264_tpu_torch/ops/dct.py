"""H.264 4x4 integer transforms, batched over leading dims (int32,
bit-exact) — plain PyTorch twins of x264_tpu/ops/dct.py.

Forward/inverse 4x4 core transform and the 4x4 / 2x2 DC Hadamards
(common/dct.c:39-235, encoder/macroblock.c:30-86), in the spec
orientation: coefficients are indexed [row][col] with Y[0][1] the
horizontal frequency. The inverse transform runs rows first, then
columns, as the spec orders the truncating (>>1) passes. The 8x8 pair
belongs to the I8x8 / P slices and is not ported yet.
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

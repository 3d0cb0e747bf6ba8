"""Batched pixel metrics (common/pixel.c) — plain PyTorch twins of
x264_tpu/ops/pixel.py: SATD, SA8D (the I8x8 mode cost and the 8x8
transform choice), the psy-RD AC energy, and the SSIM sum of the frame
metrics.

SATD keeps the reference's summation structure: the 2-D 4x4 Hadamard
abs-sum per 4x4 block, halved (>>1) per 8x4 unit (x264_pixel_satd_8x4,
common/pixel.c:211) or per 4x4 block for 4-wide shapes
(x264_pixel_satd_4x4, common/pixel.c:187), then summed.
"""

from __future__ import annotations

import numpy as np
import torch

from .dct import _H4, _mat, _mm

I32 = torch.int32
F32 = torch.float32


def _tile44(x):
    """(..., H, W) -> (..., H//4, W//4, 4, 4)."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 4, 4, w // 4, 4).transpose(-3, -2)


def satd(a, b):
    """x264-equivalent SATD over (..., H, W) blocks, H % 4 == W % 4 == 0."""
    d = a.to(I32) - b.to(I32)
    h = _mat(_H4, d)
    s44 = _mm(_mm(h, _tile44(d)), h).abs().sum((-2, -1), dtype=I32)
    w4 = a.shape[-1] // 4
    if w4 % 2 == 0:
        pair = s44.reshape(*s44.shape[:-1], w4 // 2, 2).sum(-1, dtype=I32)
        return (pair >> 1).sum((-2, -1), dtype=I32)
    return (s44 >> 1).sum((-2, -1), dtype=I32)


def _build_h8():
    """The 8x8 Sylvester Hadamard matrix."""
    h = np.array([[1]])
    for _ in range(3):
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.int32)


H8 = _build_h8()


def _abs_had8_sum(d, dims):
    """sum |H8 d H8| over the last two axes and `dims` more."""
    h = torch.as_tensor(H8, device=d.device)
    return _mm(_mm(h, d), h).abs().sum(dims, dtype=I32)


def sa8d_8x8(a, b):
    """8x8 SA8D of (..., 8, 8) blocks: the abs-sum of the 2-D 8x8
    Hadamard of the difference, (+2) >> 2 (x264_pixel_sa8d_8x8,
    common/pixel.c:256-295)."""
    return (_abs_had8_sum(a.to(I32) - b.to(I32), (-2, -1)) + 2) >> 2


def sa8d_16x16(a, b):
    """16x16 SA8D of (..., 16, 16) blocks: the four 8x8 Hadamard abs-sums
    added first, then one (+2) >> 2 (x264_pixel_sa8d_16x16,
    common/pixel.c:297)."""
    d = a.to(I32) - b.to(I32)
    *lead, _, _ = d.shape
    t = d.reshape(*lead, 2, 8, 2, 8).transpose(-3, -2)
    return (_abs_had8_sum(t, (-4, -3, -2, -1)) + 2) >> 2


def ac_energy(tiles):
    """AC complexity of (..., 16, 16) tiles for the MB-level psy-RD term
    (the PIXEL_16x16 branch of ssd_plane, encoder/rdo.c:122-125):
    SATD(pix, 0) - (pixel_sum >> 1), int32."""
    return satd(tiles, torch.zeros_like(tiles)) \
        - (tiles.to(I32).sum((-2, -1), dtype=I32) >> 1)


# ssim_c1/c2 constants of ssim_end1 (common/pixel.c:464-466)
SSIM_C1 = int(.01 * .01 * 255 * 255 * 64 + .5)
SSIM_C2 = int(.03 * .03 * 255 * 255 * 64 * 63 + .5)


def ssim_sum(a, b):
    """x264 SSIM over overlapped 4x4 blocks (ssim_4x4x2_core + ssim_end1,
    common/pixel.c:435-513) of two (H, W) planes; callers pass the
    2-pixel-offset region (encoder/encoder.c:1048-1055). Returns the
    float32 sum of per-position SSIM; int32 sums exactly as ssim_end1,
    float only for the final ratio."""
    h, w = a.shape
    hb, wb = h // 4, w // 4
    a4 = a[:hb * 4, :wb * 4].to(I32).reshape(hb, 4, wb, 4)
    b4 = b[:hb * 4, :wb * 4].to(I32).reshape(hb, 4, wb, 4)
    s1 = a4.sum((1, 3), dtype=I32)
    s2 = b4.sum((1, 3), dtype=I32)
    ss = (a4 * a4).sum((1, 3), dtype=I32) + (b4 * b4).sum((1, 3), dtype=I32)
    s12 = (a4 * b4).sum((1, 3), dtype=I32)

    def quad(x):
        return x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]

    f1, f2, fss, f12 = quad(s1), quad(s2), quad(ss), quad(s12)
    vars_ = fss * 64 - f1 * f1 - f2 * f2
    covar = f12 * 64 - f1 * f2
    num = (2 * f1 * f2 + SSIM_C1).to(F32) * (2 * covar + SSIM_C2).to(F32)
    den = (f1 * f1 + f2 * f2 + SSIM_C1).to(F32) * (vars_ + SSIM_C2).to(F32)
    return (num / den).sum()

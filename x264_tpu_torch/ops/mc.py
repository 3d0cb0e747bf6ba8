"""Motion compensation (common/mc.c) — plain PyTorch twins of
x264_tpu/ops/mc.py's pad_plane, hpel_planes, mc_luma and mc_chroma, and
the wrapper of the half-pel filter's CUDA kernel (csrc/mc.cu, kernel K9).

The reference serves a quarter-pel luma position as the rounding average
of two samples of its four half-pel planes [fpel, h, v, c] (mc_luma with
the hpel_ref0/1 tables, common/mc.c:157-186) and chroma by the 1/8-pel
bilinear filter (mc_chroma, common/mc.c:205). Planes are edge-padded by
PAD = 32 luma / 16 chroma samples (common/frame.h:27-31), which equals
the spec's per-tap coordinate clamping.

At subme 1 every MV is full-pel and luma reads plane 0, the padded
reference itself, so the half-pel planes are not built. At subme 2-5
hpel_planes (K9) builds them once per reference frame, and the sub-pel
search (ops/me.py) and the partitioned fetch of kernel K6
(csrc/inter.cu) read them; mc_luma and mc_chroma are K6's and K12's
plain building blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda

I32 = torch.int32

PAD = 32          # luma padding; chroma uses PAD // 2

# qpel phase -> source planes (common/mc.c:157-158); plane order
# 0 = fpel, 1 = h, 2 = v, 3 = c. _HPEL_REF1 is pre-fixed so that phases
# with no averaging (qpel_idx & 5 == 0) average a sample with itself.
_HPEL_REF0 = np.array([0, 1, 1, 1, 0, 1, 1, 1, 2, 3, 3, 3, 0, 1, 1, 1],
                      dtype=np.int32)
_r1 = np.array([0, 0, 0, 0, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2],
               dtype=np.int32)
_HPEL_REF1 = np.where(np.arange(16) & 5, _r1, _HPEL_REF0).astype(np.int32)


def pad_plane(plane, pad: int = PAD):
    """Edge-replicate by `pad` on every side (x264_frame_expand_border,
    common/frame.c:240)."""
    h, w = plane.shape
    rows = torch.arange(-pad, h + pad, device=plane.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=plane.device).clamp(0, w - 1)
    return plane[rows][:, cols]


def _tap6(a, dim: int):
    """Unrounded 6-tap (1, -5, 20, 20, -5, 1) at the half positions along
    `dim`; the length shrinks by 5."""
    ln = a.shape[dim] - 5
    s = lambda k: a.narrow(dim, k, ln)
    return s(0) + s(5) - 5 * (s(1) + s(4)) + 20 * (s(2) + s(3))


def hpel_planes_plain(padded):
    """Plain version of K9: (Hp, Wp) padded plane -> (4, Hp, Wp) int32
    stack [fpel, h, v, c] (hpel_filter, common/mc.c:133-155; spec
    8.4.2.2.1). The input is edge-padded by 3 more samples; h and v round
    their taps by (x + 16) >> 5, and c filters the *unrounded* vertical
    taps horizontally, (x + 512) >> 10; all three clip to 0..255."""
    padded = padded.to(I32)
    p = pad_plane(padded, 3)
    hp, wp = padded.shape
    h = ((_tap6(p, 1)[3:3 + hp, 1:1 + wp] + 16) >> 5).clamp(0, 255)
    v_ext = _tap6(p, 0)[1:1 + hp]                  # (hp, wp + 6)
    v = ((v_ext[:, 3:3 + wp] + 16) >> 5).clamp(0, 255)
    c = ((_tap6(v_ext, 1)[:, 1:1 + wp] + 512) >> 10).clamp(0, 255)
    return torch.stack([padded, h, v, c])


def hpel_planes(padded):
    """K9 `hpel_planes`: the half-pel planes of a padded reference.

    Replaces x264_tpu/ops/mc.py:hpel_planes. On a CUDA tensor it runs
    csrc/mc.cu (one launch; each CTA stages a 32x32 tile and its 3-sample
    apron in shared memory); on a CPU tensor the plain version. Arguments
    and result as hpel_planes_plain."""
    if padded.device.type == "cpu":
        return hpel_planes_plain(padded)
    hp, wp = padded.shape
    cuda.check(padded, (hp, wp), I32, "padded")
    out = torch.empty((4, hp, wp), dtype=I32, device=padded.device)
    cuda.launch("mc", "hpel_planes", "ppiip", padded.data_ptr(),
                out.data_ptr(), hp, wp, cuda.stream(padded.device))
    hpel_planes.launches += 1
    return out


hpel_planes.launches = 0


def ds_start(start, dim: int, size: int):
    """The start jax.lax.dynamic_slice uses for a slice of `size` of an
    axis of `dim`: a negative start counts from the end once, then the
    start is clamped so that the slice fits."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def blocks(stack, p, y0, x0, bh: int, bw: int):
    """(bh, bw) blocks of a (P, Hp, Wp) stack at per-block (plane, y, x)
    starts, each start taken as dynamic_slice takes it (ds_start).
    Returns (*y0.shape, bh, bw)."""
    P, hp, wp = stack.shape
    dev = stack.device
    p = ds_start(p, P, 1).long()
    y0 = ds_start(y0, hp, bh)
    x0 = ds_start(x0, wp, bw)
    rows = (y0[..., None] + torch.arange(bh, device=dev)).long()
    cols = (x0[..., None] + torch.arange(bw, device=dev)).long()
    return stack[p[..., None, None], rows[..., :, None], cols[..., None, :]]


def mc_luma(planes, ys, xs, mvs, bh: int, bw: int, ref_sel=None):
    """Batched quarter-pel luma fetch (mc_luma, common/mc.c:160).

    planes: (P, Hp, Wp) half-pel stack of hpel_planes (P = 4; a
    full-pel-only caller may pass P = 1: every full-pel MV reads plane
    0) or, with ref_sel, the (4 * n_refs, Hp, Wp) concatenation of each
    reference's stack, ref_sel (...,) then each block's reference (the
    multi-reference fetch of x264_mb_mc, common/macroblock.c:1122).
    ys / xs: (...,) block top-left in unpadded coordinates; mvs: (..., 2)
    quarter-pel (x, y). Returns (..., bh, bw) int32."""
    mvx, mvy = mvs[..., 0], mvs[..., 1]
    fx, fy = mvx & 3, mvy & 3
    qidx = ((fy << 2) + fx).long()
    iy = ys + (mvy >> 2) + PAD
    ix = xs + (mvx >> 2) + PAD
    dev = planes.device
    p0 = torch.as_tensor(_HPEL_REF0, device=dev)[qidx]
    p1 = torch.as_tensor(_HPEL_REF1, device=dev)[qidx]
    if ref_sel is not None:
        p0 = p0 + 4 * ref_sel
        p1 = p1 + 4 * ref_sel
    a = blocks(planes, p0, iy + (fy == 3), ix, bh, bw)
    b = blocks(planes, p1, iy, ix + (fx == 3), bh, bw)
    return (a + b + 1) >> 1


def avg(a, b):
    """Rounding average of two predictions (pixel_avg, common/mc.c:34; the
    bipred weight 32 of weighted_bipred_idc 0)."""
    return (a + b + 1) >> 1


def mc_chroma(padded, ys, xs, mvs, bh: int, bw: int, ref_sel=None):
    """Batched 1/8-pel bilinear chroma fetch (mc_chroma, common/mc.c:205).
    padded: a chroma plane padded by PAD // 2 or, with ref_sel (...,),
    the (n_refs, Hc, Wc) stack of each reference's; ys / xs block
    top-left in unpadded chroma coordinates; mvs: (..., 2) the luma
    quarter-pel MV read as chroma eighth-pel. Returns (..., bh, bw)
    int32."""
    cpad = PAD // 2
    mvx, mvy = mvs[..., 0], mvs[..., 1]
    d8x, d8y = (mvx & 7)[..., None, None], (mvy & 7)[..., None, None]
    iy = ys + (mvy >> 3) + cpad
    ix = xs + (mvx >> 3) + cpad
    if ref_sel is None:
        padded, ref_sel = padded[None], torch.zeros_like(iy)
    s = blocks(padded, ref_sel, iy, ix, bh + 1, bw + 1)
    s00, s01 = s[..., :bh, :bw], s[..., :bh, 1:]
    s10, s11 = s[..., 1:, :bw], s[..., 1:, 1:]
    return ((8 - d8x) * (8 - d8y) * s00 + d8x * (8 - d8y) * s01
            + (8 - d8x) * d8y * s10 + d8x * d8y * s11 + 32) >> 6

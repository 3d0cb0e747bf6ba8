"""Lowres lookahead costs for scenecut — plain PyTorch twin of
x264_tpu/encoder/lookahead.py (lowres_planes, intra_cost_plane,
inter_cost_plane, frame_costs_fused, analyse_fused) and the wrappers of
its CUDA kernels K14 and K15 (csrc/lookahead.cu).

The reference estimates frame coding costs on half-resolution planes
(x264_slicetype_mb_cost, encoder/slicetype.c:43-256): per 8x8 lowres
block min(inter ME cost, intra cost), summed over the interior blocks,
and the scenecut rule reads the sums (slicetype.c:437-474; the bias
ramp lives in ratecontrol.py). x264_tpu's form is kept:
  - inter: a dense (2r+1)^2 full-pel SAD search with the penalty
    se_bits(dx) + se_bits(dy) - 2 + 5 * (mv != 0), then a 3x3 half-pel
    SATD re-score through the exact phase planes (slicetype.c:168-172);
  - intra: min of the DC / H / V SATD + 5 (slicetype.c:196-231);
  - the sums cover blocks [1:-1, 1:-1] when both sides exceed 2 blocks
    (slicetype.c:243-247).
"""

from __future__ import annotations

import torch

from .. import cuda
from ..ops import mc as omc
from ..ops import me as ome
from ..ops import pixel as opix

I32 = torch.int32

INTRA_PENALTY = 5        # slicetype.c:196 intra_penalty
NONZERO_MV_PENALTY = 5   # slicetype.c:170-171 (cost -= 2; += 5 if mv)


def block_grid(h: int, w: int):
    """(bh, bw): the 8x8 lowres blocks of an h x w frame, as x264_tpu's
    RateControl.analyse_frame sizes them."""
    return (h // 2 + 7) // 8, (w // 2 + 7) // 8


# --------------------------------------------------------------- K14
def lowres_planes_plain(y, h: int, w: int):
    """Plain version of K14: the four phase-shifted lowres planes of the
    first h x w samples of the luma plane y (x264_frame_init_lowres,
    common/mc.c:306-357): plane[2*pv+ph](i, j) averages the 2x2 at
    (2i+pv, 2j+ph) of the luma edge-padded by one, so a lowres half-pel
    shift is exact. Returns (4, h//2, w//2) int32, order [00, 0h, v0, vh]."""
    he, we = h & ~1, w & ~1
    p = y[:he, :we].to(I32)
    pp = torch.cat([p, p[-1:]], 0)
    pp = torch.cat([pp, pp[:, -1:]], 1)

    def ds(pv: int, ph: int):
        q = pp[pv:pv + he, ph:ph + we]
        return (q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2]
                + q[1::2, 1::2] + 2) >> 2

    return torch.stack([ds(0, 0), ds(0, 1), ds(1, 0), ds(1, 1)])


def lowres_planes(y, h: int, w: int):
    """K14 `lowres_planes`. Replaces x264_tpu/encoder/lookahead.py:
    lowres_planes. y: an int32 luma plane whose first h rows and w
    columns are the frame (the encoder's MB-aligned upload). On CUDA
    tensors it runs csrc/lookahead.cu, one thread per output sample; on
    CPU tensors the plain version. Returns (4, h//2, w//2) int32."""
    if y.device.type == "cpu":
        return lowres_planes_plain(y, h, w)
    if y.dim() != 2 or y.shape[0] < h or y.shape[1] < w:
        raise ValueError(f"lowres_planes: a plane of at least {h}x{w} "
                         f"expected, got {tuple(y.shape)}")
    cuda.check(y, y.shape, I32, "y")
    out = torch.empty((4, h // 2, w // 2), dtype=I32, device=y.device)
    cuda.launch("lookahead", "lowres_planes", "piiipp", y.data_ptr(),
                y.shape[1], h, w, out.data_ptr(), cuda.stream(y.device))
    lowres_planes.launches += 1
    return out


lowres_planes.launches = 0


# --------------------------------------------------------------- K15
def _pad8(low, bh: int, bw: int):
    """Edge-pad a lowres plane to (bh*8, bw*8)."""
    h, w = low.shape
    rows = torch.arange(bh * 8, device=low.device).clamp(max=h - 1)
    cols = torch.arange(bw * 8, device=low.device).clamp(max=w - 1)
    return low[rows][:, cols]


def _edge_pad(p, r: int):
    """Edge-pad a plane by r on every side."""
    h, w = p.shape
    rows = (torch.arange(-r, h + r, device=p.device)).clamp(0, h - 1)
    cols = (torch.arange(-r, w + r, device=p.device)).clamp(0, w - 1)
    return p[rows][:, cols]


def intra_cost_plane(low, bh: int, bw: int):
    """Per-8x8-block lowres intra cost: min(DC, H, V) SATD + 5 (the 8x8c
    prediction ladder of slicetype.c:196-231), with x264_tpu's neighbour
    rows from a roll of the padded plane, masked at row and column 0.
    low: (h, w) int32. Returns (bh, bw) int32."""
    p = _pad8(low, bh, bw)
    tiles = p.reshape(bh, 8, bw, 8).transpose(1, 2)
    top = torch.roll(p, 1, 0)[0::8].reshape(bh, bw, 8)
    left = torch.roll(p, 1, 1)[:, 0::8].reshape(bh, 8, bw).transpose(1, 2)
    dev = low.device
    has_top = (torch.arange(bh, device=dev) > 0)[:, None, None]
    has_left = (torch.arange(bw, device=dev) > 0)[None, :, None]
    tsum = top.sum(-1, keepdim=True, dtype=I32)
    lsum = left.sum(-1, keepdim=True, dtype=I32)
    dc = torch.where(has_top & has_left, (tsum + lsum + 8) >> 4,
                     torch.where(has_top, (tsum + 4) >> 3,
                                 torch.where(has_left, (lsum + 4) >> 3,
                                             128)))
    s_dc = opix.satd(tiles, dc[..., None].expand(tiles.shape))
    s_v = torch.where(has_top[..., 0],
                      opix.satd(tiles, top[:, :, None, :].expand(tiles.shape)),
                      1 << 28)
    s_h = torch.where(has_left[..., 0],
                      opix.satd(tiles, left[..., None].expand(tiles.shape)),
                      1 << 28)
    return (torch.minimum(s_dc, torch.minimum(s_v, s_h))
            + INTRA_PENALTY).to(I32)


def mv_penalty(r: int, device):
    """(dx, dy) of each full-pel candidate in x264_tpu's order (dy outer,
    dx inner) and its penalty se_bits(dx) + se_bits(dy) - 2 + 5 * (mv != 0)."""
    d = torch.arange(-r, r + 1, dtype=I32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dx, dy = dx.reshape(-1), dy.reshape(-1)
    pen = ome.se_bits(dx) + ome.se_bits(dy) - 2 \
        + torch.where((dx != 0) | (dy != 0), NONZERO_MV_PENALTY, 0)
    return dx, dy, pen.to(I32)


def inter_cost_plane(low, ref_planes, bh: int, bw: int, r: int):
    """Per-8x8-block lowres inter cost: every (dx, dy) in [-r, r]^2 as a
    whole-plane SAD (argmin, first index on ties), then the half-pel 3x3
    SATD re-score of the winner through the phase planes, read from one
    9x9 window per block started as dynamic_slice starts it (ops/mc.py:
    ds_start), a later candidate winning only on a strict <.
    low: (h, w) current plane 0; ref_planes: (4, h, w) the reference's.
    Returns (cost (bh, bw) int32, mv (bh, bw, 2) half-pel lowres (x, y))."""
    cur = _pad8(low, bh, bw)
    H, W = bh * 8, bw * 8
    refs = torch.stack([_edge_pad(_pad8(ref_planes[k], bh, bw), r)
                        for k in range(4)])
    dx, dy, pen = mv_penalty(r, low.device)
    sads = torch.stack([
        (cur - refs[0, r + int(y):r + int(y) + H, r + int(x):r + int(x) + W])
        .abs().reshape(bh, 8, bw, 8).sum((1, 3), dtype=I32)
        for x, y in zip(dx.tolist(), dy.tolist())])
    best = (sads + pen[:, None, None]).argmin(0)
    mvx, mvy, pen_b = dx[best], dy[best], pen[best]
    cur_tiles = cur.reshape(bh, 8, bw, 8).transpose(1, 2)
    dev = low.device
    by = torch.arange(bh, dtype=I32, device=dev)[:, None] * 8 + mvy - 1 + r
    bx = torch.arange(bw, dtype=I32, device=dev)[None, :] * 8 + mvx - 1 + r
    win = torch.stack([omc.blocks(refs, torch.full_like(by, k), by, bx, 9, 9)
                       for k in range(4)], 2)          # (bh, bw, 4, 9, 9)
    best_cost = best_mv = None
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            plane = (oy & 1) * 2 + (ox & 1)
            r0, c0 = (oy >> 1) + 1, (ox >> 1) + 1
            c = opix.satd(cur_tiles,
                          win[:, :, plane, r0:r0 + 8, c0:c0 + 8]) + pen_b
            mv = torch.stack([mvx * 2 + ox, mvy * 2 + oy], -1)
            if best_cost is None:
                best_cost, best_mv = c, mv
            else:
                upd = c < best_cost
                best_cost = torch.where(upd, c, best_cost)
                best_mv = torch.where(upd[..., None], mv, best_mv)
    return best_cost.to(I32), best_mv.to(I32)


def _inner(bh: int, bw: int):
    return (slice(1, -1), slice(1, -1)) if min(bh, bw) > 2 \
        else (slice(None), slice(None))


def lowres_cost_plain(lows, prev, bh: int, bw: int, r: int):
    """Plain version of K15 (frame_costs_fused, and analyse_fused's first
    frame): lows / prev the (4, h, w) planes of this frame and of the one
    before (None for the first). Returns (sums (2,) int32 = [icost sum,
    sum of min(pcost, icost)] over the interior blocks ([s, s] for the
    first frame), icost (bh, bw), pcost (bh, bw) or None)."""
    icost = intra_cost_plane(lows[0], bh, bw)
    ic = icost[_inner(bh, bw)]
    isum = ic.sum(dtype=I32)
    if prev is None:
        return torch.stack([isum, isum]), icost, None
    pcost, _ = inter_cost_plane(lows[0], prev, bh, bw, r)
    psum = torch.minimum(pcost[_inner(bh, bw)], ic).sum(dtype=I32)
    return torch.stack([isum, psum]), icost, pcost


def lowres_cost(lows, prev, bh: int, bw: int, r: int):
    """K15 `lowres_cost`. Replaces x264_tpu/encoder/lookahead.py:
    intra_cost_plane, inter_cost_plane, frame_costs_fused and
    analyse_fused's sums. On CUDA tensors it runs csrc/lookahead.cu, one
    CTA per 8x8 lowres block in one launch, the sums by integer atomics;
    on CPU tensors the plain version. Arguments and results as
    lowres_cost_plain."""
    if lows.device.type == "cpu":
        return lowres_cost_plain(lows, prev, bh, bw, r)
    dev = lows.device
    cuda.check(lows, lows.shape, I32, "lows")
    if lows.dim() != 3 or lows.shape[0] != 4:
        raise ValueError(f"lowres_cost: (4, h, w) planes expected, got "
                         f"{tuple(lows.shape)}")
    if prev is not None:
        cuda.check(prev, lows.shape, I32, "prev")
    _, h2, w2 = lows.shape
    icost = torch.empty((bh, bw), dtype=I32, device=dev)
    pcost = torch.empty((bh, bw), dtype=I32, device=dev) \
        if prev is not None else None
    sums = torch.empty(2, dtype=I32, device=dev)
    cuda.launch("lookahead", "lowres_cost", "ppiiiiiippp" + "p",
                lows.data_ptr(), 0 if prev is None else prev.data_ptr(),
                h2, w2, bh, bw, r, int(min(bh, bw) <= 2), icost.data_ptr(),
                0 if pcost is None else pcost.data_ptr(), sums.data_ptr(),
                cuda.stream(dev))
    lowres_cost.launches += 1
    return sums, icost, pcost


lowres_cost.launches = 0


def analyse(y, h: int, w: int, prev, r: int):
    """One lookahead step (x264_tpu analyse_fused): the lowres planes of
    the h x w frame in y (K14) and its two cost sums against the previous
    frame's planes prev, or [s, s] without one (K15). Returns (lows,
    sums (2,) int32), both on y's device."""
    lows = lowres_planes(y, h, w)
    bh, bw = block_grid(h, w)
    sums, _, _ = lowres_cost(lows, prev, bh, bw, r)
    return lows, sums

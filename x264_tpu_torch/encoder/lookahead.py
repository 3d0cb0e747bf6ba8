"""Lowres lookahead costs for scenecut and b-adapt — plain PyTorch twin of
x264_tpu/encoder/lookahead.py (lowres_plane, lowres_planes,
frame_cost_sums, intra_cost_plane,
inter_cost_plane, frame_costs_fused, analyse_fused, _fetch_blocks,
badapt_first_fused, badapt_ext_fused, b_seed_mvs_fused, b_cost_fused)
and the wrappers of its CUDA kernels K14, K15 (csrc/lookahead.cu) and
K21 (csrc/badapt.cu).

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


def lowres_plane(y):
    """The half-resolution plane alone (x264_tpu's jitted lowres_plane,
    lookahead.py:41): the 2x2 rounded mean of the (H & ~1, W & ~1) luma
    y (uint8 or int32, (H, W)), which is K14's phase-00 plane; on a CUDA
    tensor it runs K14 (lowres_planes) and keeps that plane. Returns
    (H // 2, W // 2) int32."""
    h, w = y.shape
    return lowres_planes(y.to(I32).contiguous(), h, w)[0]


def frame_cost_sums(icost, pcost=None):
    """The interior-block sums of lowres cost planes (x264_tpu's
    frame_cost_sums, lookahead.py:231; slicetype.c:243-247 leaves the
    border ring out of i_cost_est where both sides exceed 2 blocks):
    (icost sum, the sum of min(pcost, icost), or the icost sum again
    without pcost), as Python ints of the int32 sums."""
    inner = _inner(*icost.shape)
    ic = icost[inner]
    isum = int(ic.sum(dtype=I32))
    if pcost is None:
        return isum, isum
    return isum, int(torch.minimum(pcost[inner], ic).sum(dtype=I32))


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


# ---------------------------------------------------------------- b-adapt
# x264_slicetype_analyse B_ADAPT_FAST greedy (slicetype.c:545-573): the
# reference's untuned threshold
INTER_THRESH = 300
# the sums of lowres_bcost, in order
(BC_P0, BC_P1, BC_B, BC_INTRA0, BC_INTRA1, BC_NBLK) = range(6)


def fetch_blocks(planes, mv_hp, bh: int, bw: int, r: int):
    """(bh, bw, 8, 8) predictions at half-pel lowres MVs through the exact
    phase planes (x264_tpu lookahead._fetch_blocks): the full-pel part
    mv >> 1 (floored) clipped to [-r, r], the plane (mvy & 1) * 2 +
    (mvx & 1), samples clamped into the plane (what _pad8 and the edge pad
    of r + 1 make of it)."""
    h, w = planes.shape[1:]
    dev = planes.device
    mvx, mvy = mv_hp[..., 0], mv_hp[..., 1]
    ph = ((mvy & 1) * 2 + (mvx & 1)).long()
    by = torch.arange(bh, device=dev)[:, None] * 8 + (mvy >> 1).clamp(-r, r)
    bx = torch.arange(bw, device=dev)[None, :] * 8 + (mvx >> 1).clamp(-r, r)
    i8 = torch.arange(8, device=dev)
    rows = (by[..., None] + i8).clamp(0, h - 1).long()
    cols = (bx[..., None] + i8).clamp(0, w - 1).long()
    return planes[ph[..., None, None], rows[..., :, None], cols[..., None, :]]


def lowres_bcost_plain(lows, ref0, ref1, bh: int, bw: int, r: int,
                       bi: bool):
    """Plain version of K21: the lowres costs of one frame (its planes
    lows) against one or two references (the (4, h, w) planes ref0, and
    ref1 or None), as x264_tpu's b-adapt programs take them
    (lookahead.py:272-371): per 8x8 block the intra cost i, the inter
    costs c0 / c1 and MVs mv0 / mv1 (inter_cost_plane), and with bi the
    bi-average candidate: the SATD of the rounding average of the two
    fetched predictions plus the four se_bits of the MVs. Returns (sums
    (6,) int32 over the interior blocks: [sum min(c0, i), sum min(c1, i),
    sum min(c0, c1, bi, i), count(i < c0), count(i < c1), the block
    count], mv0, mv1 or None), entries without ref1 or bi 0."""
    low = lows[0]
    inner = _inner(bh, bw)
    i_ = intra_cost_plane(low, bh, bw)
    c0, mv0 = inter_cost_plane(low, ref0, bh, bw, r)
    z = torch.zeros((), dtype=I32, device=low.device)
    s1 = s2 = n1 = z
    mv1 = None
    if ref1 is not None:
        c1, mv1 = inter_cost_plane(low, ref1, bh, bw, r)
        s1 = torch.minimum(c1, i_)[inner].sum(dtype=I32)
        n1 = (i_ < c1)[inner].sum(dtype=I32)
        if bi:
            pa = fetch_blocks(ref0, mv0, bh, bw, r)
            pb = fetch_blocks(ref1, mv1, bh, bw, r)
            cur = _pad8(low, bh, bw).reshape(bh, 8, bw, 8).transpose(1, 2)
            pen = (ome.se_bits(mv0[..., 0]) + ome.se_bits(mv0[..., 1])
                   + ome.se_bits(mv1[..., 0]) + ome.se_bits(mv1[..., 1]))
            bic = opix.satd(cur, (pa + pb + 1) >> 1) + pen
            s2 = torch.minimum(torch.minimum(c0, c1),
                               torch.minimum(bic, i_))[inner].sum(dtype=I32)
    pc = torch.minimum(c0, i_)[inner]
    sums = torch.stack([pc.sum(dtype=I32), s1, s2,
                        (i_ < c0)[inner].sum(dtype=I32), n1,
                        torch.tensor(pc.numel(), dtype=I32,
                                     device=low.device)]).to(I32)
    return sums, mv0, mv1


def lowres_bcost(lows, ref0, ref1, bh: int, bw: int, r: int, bi: bool,
                 want_mv: bool = False):
    """K21 `lowres_bcost`. Replaces x264_tpu/encoder/lookahead.py:
    _fetch_blocks and the block costs and sums of badapt_first_fused,
    badapt_ext_fused, b_seed_mvs_fused and b_cost_fused. On CUDA tensors
    it runs csrc/badapt.cu, one CTA per 8x8 lowres block in one launch
    (K15's device code: lowres.cuh), the interior sums by integer atomics;
    on CPU tensors the plain version. want_mv: write the MV fields (else
    the kernel leaves them out and mv0 / mv1 are None). Returns as
    lowres_bcost_plain."""
    if lows.device.type == "cpu":
        sums, mv0, mv1 = lowres_bcost_plain(lows, ref0, ref1, bh, bw, r, bi)
        return (sums, mv0, mv1) if want_mv else (sums, None, None)
    dev = lows.device
    cuda.check(lows, lows.shape, I32, "lows")
    if lows.dim() != 3 or lows.shape[0] != 4:
        raise ValueError(f"lowres_bcost: (4, h, w) planes expected, got "
                         f"{tuple(lows.shape)}")
    cuda.check(ref0, lows.shape, I32, "ref0")
    if ref1 is not None:
        cuda.check(ref1, lows.shape, I32, "ref1")
    elif bi:
        raise ValueError("lowres_bcost: the bi candidate needs ref1")
    _, h2, w2 = lows.shape
    sums = torch.empty(6, dtype=I32, device=dev)
    mv0 = mv1 = None
    if want_mv:
        mv0 = torch.empty((bh, bw, 2), dtype=I32, device=dev)
        if ref1 is not None:
            mv1 = torch.empty((bh, bw, 2), dtype=I32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    cuda.launch("badapt", "lowres_bcost", "pppiiiiiiippp" + "p",
                lows.data_ptr(), ref0.data_ptr(), ptr(ref1), h2, w2, bh, bw,
                r, int(min(bh, bw) <= 2), int(bi), sums.data_ptr(),
                ptr(mv0), ptr(mv1), cuda.stream(dev))
    lowres_bcost.launches += 1
    return sums, mv0, mv1


lowres_bcost.launches = 0


def badapt_first(lows1, lows2, planes0, bh: int, bw: int, r: int):
    """x264_tpu's badapt_first_fused (the first-B test, slicetype.c:
    546-556) through two K21 launches: the first queued candidate against
    the last reference and the new frame (with the bi candidate), and the
    new frame against the candidate and the reference. Returns (5,) int32
    [cost1p0, cost2p0, cost1b1, cost2p1, n_intra2]."""
    a, _, _ = lowres_bcost(lows1, planes0, lows2, bh, bw, r, True)
    b, _, _ = lowres_bcost(lows2, lows1, planes0, bh, bw, r, False)
    return torch.stack([a[BC_P0], b[BC_P0], a[BC_B], b[BC_P1],
                        b[BC_INTRA1]])


def badapt_ext(lows_f, planes0, bh: int, bw: int, r: int):
    """x264_tpu's badapt_ext_fused (the run-extension test,
    slicetype.c:563-572): (3,) int32 [pcost, n_intra, n_blocks]."""
    s, _, _ = lowres_bcost(lows_f, planes0, None, bh, bw, r, False)
    return torch.stack([s[BC_P0], s[BC_INTRA0], s[BC_NBLK]])


def b_seed_mvs(lows_b, planes_l0, planes_l1, bh: int, bw: int, r: int):
    """x264_tpu's b_seed_mvs_fused: a B candidate's lowres MV fields
    against both lists, times 4 (a lowres half-pel is a full-res pel):
    (mv_l0, mv_l1), each (bh, bw, 2) int32 quarter-pel seeds."""
    _, mv0, mv1 = lowres_bcost(lows_b, planes_l0, planes_l1, bh, bw, r,
                               False, want_mv=True)
    return mv0 * 4, mv1 * 4


def b_cost(lows_b, planes_l0, planes_l1, bh: int, bw: int, r: int):
    """x264_tpu's b_cost_fused (the b-adapt 2 path search's cost pair):
    (2,) int32 [cost as a B between the lists, cost as a P from l0]."""
    s, _, _ = lowres_bcost(lows_b, planes_l0, planes_l1, bh, bw, r, True)
    return torch.stack([s[BC_B], s[BC_P0]])

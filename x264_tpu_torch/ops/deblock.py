"""In-loop deblocking filter — plain PyTorch twin of
x264_tpu/ops/deblock.py and the wrapper of its CUDA kernel
(csrc/deblock.cu, kernel K2).

The reference filters macroblocks in raster order, vertical edges then
horizontal edges per MB (x264_frame_deblock_row, common/frame.c:621):
each MB's filter reads pixels its left, top and top-right neighbours'
filters already changed. MB (x, y) depends on {(x-1, y), (x, y-1),
(x+1, y-1)}, so the slope-2 diagonals d = x + 2y (254 at 1080p) are the
widest order that keeps the result: MB (x, y)'s top-edge filter reads
the columns that MB (x+1, y-1)'s left-edge filter wrote on diagonal
d - 1. The plain version walks these diagonals; the kernel walks MB rows,
each MB waiting for the row above to pass its top-right neighbour, which
is the same partial order. The boundary strengths (bS) and alpha / beta
/ tc0 depend only on the per-4x4 qp / intra / nnz / ref / mv maps
(DEBLOCK_STRENGTH, common/frame.c:697-742).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from .. import tables

I32 = torch.int32


def _tab(t, device):
    return torch.as_tensor(np.asarray(t, np.int32), device=device)


def _edge_params(qp_p, qp_q, bs, alpha_off, beta_off):
    """alpha / beta / tc0 of edges with the given side QPs and bS."""
    dev = qp_p.device
    qp_avg = (qp_p + qp_q + 1) >> 1
    ia = (qp_avg + alpha_off).clamp(0, 51).long()
    alpha = _tab(tables.ALPHA_TABLE, dev)[ia]
    beta = _tab(tables.BETA_TABLE, dev)[(qp_avg + beta_off).clamp(0, 51).long()]
    tc0 = _tab(tables.TC0_TABLE, dev)[ia, bs.clamp(max=3).long()]
    return alpha, beta, tc0


def _strengths(shift, intra4, nnz4, ref4, mv4, ref4_l1, mv4_l1, is_b,
               mb_edge):
    """bS on the 4x4 edge grid; shift(a) gives the p-side (left / above)
    value. Entries whose p side falls outside the frame are masked by
    the caller."""
    any_intra = shift(intra4) | intra4
    nz = (shift(nnz4) != 0) | (nnz4 != 0)

    def mv_differ(rp, rq, mp, mq):
        return ((rp != rq) | ((mp[..., 0] - mq[..., 0]).abs() >= 4)
                | ((mp[..., 1] - mq[..., 1]).abs() >= 4))

    mvd = mv_differ(shift(ref4), ref4, shift(mv4), mv4)
    if is_b:
        mvd = mvd | mv_differ(shift(ref4_l1), ref4_l1, shift(mv4_l1),
                              mv4_l1)
    return torch.where(any_intra, torch.where(mb_edge, 4, 3),
                       torch.where(nz, 2, torch.where(mvd, 1, 0))).to(I32)


def _luma_filter(win, bs, tc0, alpha, beta, enable):
    """Filter across one luma edge. win: (K, 16, 8) lines
    [p3 p2 p1 p0 q0 q1 q2 q3]; bs / tc0: (K, 16); alpha / beta /
    enable: (K, 1). Returns the filtered window."""
    p3, p2, p1, p0, q0, q1, q2, q3 = win.unbind(-1)
    fsf = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
           & ((q1 - q0).abs() < beta) & (bs > 0) & enable)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    avg01 = (p0 + q0 + 1) >> 1
    clip = lambda x, t: torch.maximum(torch.minimum(x, t), -t)
    np1 = p1 + clip(((p2 + avg01) >> 1) - p1, tc0)
    nq1 = q1 + clip(((q2 + avg01) >> 1) - q1, tc0)
    tc = tc0 + ap.to(I32) + aq.to(I32)
    delta = clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc)
    normal = [p2, torch.where(ap, np1, p1), (p0 + delta).clamp(0, 255),
              (q0 - delta).clamp(0, 255), torch.where(aq, nq1, q1), q2]
    short = (p0 - q0).abs() < ((alpha >> 2) + 2)
    wide_p, wide_q = short & ap, short & aq
    strong = [torch.where(wide_p, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                          p2),
              torch.where(wide_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1),
              torch.where(wide_p,
                          (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                          (2 * p1 + p0 + q1 + 2) >> 2),
              torch.where(wide_q,
                          (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                          (2 * q1 + q0 + p1 + 2) >> 2),
              torch.where(wide_q, (p0 + q0 + q1 + q2 + 2) >> 2, q1),
              torch.where(wide_q, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                          q2)]
    is4 = bs == 4
    out = [torch.where(fsf, torch.where(is4, s, n), o)
           for s, n, o in zip(strong, normal, [p2, p1, p0, q0, q1, q2])]
    return torch.stack([p3] + out + [q3], -1)


def _chroma_filter(win, bs, tc, alpha, beta, enable):
    """win: (K, 8, 4) lines [p1 p0 q0 q1]; tc already includes the +1."""
    p1, p0, q0, q1 = win.unbind(-1)
    fsf = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
           & ((q1 - q0).abs() < beta) & (bs > 0) & enable)
    delta = torch.maximum(torch.minimum(
        (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc), -tc)
    is4 = bs == 4
    out_p0 = torch.where(fsf, torch.where(is4, (2 * p1 + p0 + q1 + 2) >> 2,
                                          (p0 + delta).clamp(0, 255)), p0)
    out_q0 = torch.where(fsf, torch.where(is4, (2 * q1 + q0 + p1 + 2) >> 2,
                                          (q0 - delta).clamp(0, 255)), q0)
    return torch.stack([p1, out_p0, out_q0, q1], -1)


def _mb_meta(a, mb_h, mb_w, vertical: bool):
    """(H4, W4) edge-grid map -> (mb_h, mb_w, edge, segment)."""
    t = a.reshape(mb_h, 4, mb_w, 4)
    return t.permute(0, 2, 3, 1) if vertical else t.permute(0, 2, 1, 3)


def deblock_frame_plain(mb_h: int, mb_w: int, y, u, v, qp_mb, intra_mb,
                        nnz4, ref4, mv4, ref4_l1, mv4_l1, is_b: bool,
                        alpha_off: int, beta_off: int,
                        chroma_qp_offset: int, t8_mb=None):
    """Plain version of K2; the arguments of x264_tpu's deblock_frame.

    y: (mb_h*16, mb_w*16) int32; u / v chroma planes; qp_mb / intra_mb:
    (mb_h, mb_w); nnz4 / ref4: (mb_h*4, mb_w*4); mv4: (mb_h*4, mb_w*4, 2)
    in quarter-pel; *_l1 the same for B slices; alpha_off / beta_off the
    full offsets (twice the slice header's). Returns new (y, u, v)."""
    dev = y.device
    H4, W4 = mb_h * 4, mb_w * 4
    rep = lambda a: a.repeat_interleave(4, 0).repeat_interleave(4, 1)
    intra4 = rep(intra_mb.bool())
    qp4 = rep(qp_mb.to(I32))
    qpc4 = _tab(tables.CHROMA_QP_TABLE, dev)[
        (qp4 + chroma_qp_offset).clamp(0, 51).long()]
    x4 = torch.arange(W4, device=dev)
    y4 = torch.arange(H4, device=dev)
    left = lambda a: torch.roll(a, 1, 1)
    up = lambda a: torch.roll(a, 1, 0)
    maps = (intra4, nnz4, ref4, mv4, ref4_l1, mv4_l1, is_b)
    bs_v = _strengths(left, *maps, (x4 % 4 == 0)[None, :])
    bs_v = torch.where((x4 == 0)[None, :], 0, bs_v)
    bs_h = _strengths(up, *maps, (y4 % 4 == 0)[:, None])
    bs_h = torch.where((y4 == 0)[:, None], 0, bs_h)
    if t8_mb is not None:
        # luma edges inside 8x8 transform blocks are not filtered (spec
        # 8.7, transform_size_8x8_flag)
        t84 = rep(t8_mb.bool())
        bs_v = torch.where(t84 & ((x4 % 4 == 1) | (x4 % 4 == 3))[None, :],
                           0, bs_v)
        bs_h = torch.where(t84 & ((y4 % 4 == 1) | (y4 % 4 == 3))[:, None],
                           0, bs_h)
    ep = lambda qp, sh, bs: _edge_params(sh(qp), qp, bs, alpha_off, beta_off)
    av, bv, tv = ep(qp4, left, bs_v)
    ah, bh, th = ep(qp4, up, bs_h)
    avc, bvc, tvc = ep(qpc4, left, bs_v)
    ahc, bhc, thc = ep(qpc4, up, bs_h)
    m = {k: _mb_meta(a, mb_h, mb_w, k.endswith("v") or k.endswith("vc"))
         for k, a in dict(bs_v=bs_v, tv=tv, av=av, bv=bv, bs_h=bs_h, th=th,
                          ah=ah, bh=bh, tvc=tvc + 1, avc=avc, bvc=bvc,
                          thc=thc + 1, ahc=ahc, bhc=bhc).items()}

    # planes padded by 4 on top / left: MB (x, y)'s patch with its 4-px
    # halo starts at (16y, 16x) of the padded luma plane
    pad = lambda p: torch.nn.functional.pad(p.to(I32), (4, 0, 4, 0))
    yp, up_, vp = pad(y), pad(u), pad(v)
    r20 = torch.arange(20, device=dev)
    r12 = torch.arange(12, device=dev)

    def luma_edges(patch, bs, tc, al, be, first_ok, ok):
        for e in range(4):
            en = (first_ok if e == 0 else ok)[:, None]
            win = _luma_filter(patch[:, 4:20, 4 * e:4 * e + 8],
                               bs[:, e].repeat_interleave(4, -1),
                               tc[:, e].repeat_interleave(4, -1),
                               al[:, e, :1], be[:, e, :1], en)
            patch[:, 4:20, 4 * e:4 * e + 8] = win
        return patch

    def chroma_edges(patch, bs, tc, al, be, first_ok, ok):
        for e in range(2):
            en = (first_ok if e == 0 else ok)[:, None]
            win = _chroma_filter(patch[:, 4:12, 4 * e + 2:4 * e + 6],
                                 bs[:, 2 * e].repeat_interleave(2, -1),
                                 tc[:, 2 * e].repeat_interleave(2, -1),
                                 al[:, 2 * e, :1], be[:, 2 * e, :1], en)
            patch[:, 4:12, 4 * e + 2:4 * e + 6] = win
        return patch

    for d in range(mb_w + 2 * mb_h - 2):
        ys = torch.arange(mb_h, device=dev)
        xs = d - 2 * ys
        ok = (xs >= 0) & (xs < mb_w)
        ys, xs = ys[ok], xs[ok]
        if ys.numel() == 0:
            continue
        valid = torch.ones_like(ys, dtype=torch.bool)
        ok_v0, ok_h0 = xs > 0, ys > 0
        g = {k: a[ys, xs] for k, a in m.items()}
        rows = (16 * ys)[:, None, None] + r20[None, :, None]
        cols = (16 * xs)[:, None, None] + r20[None, None, :]
        patch = yp[rows, cols]
        patch = luma_edges(patch, g["bs_v"], g["tv"], g["av"], g["bv"],
                           ok_v0, valid)
        patch = luma_edges(patch.transpose(1, 2), g["bs_h"], g["th"],
                           g["ah"], g["bh"], ok_h0, valid).transpose(1, 2)
        yp[rows, cols] = patch
        rows = (8 * ys)[:, None, None] + r12[None, :, None]
        cols = (8 * xs)[:, None, None] + r12[None, None, :]
        for cp in (up_, vp):
            patch = cp[rows, cols]
            patch = chroma_edges(patch, g["bs_v"], g["tvc"], g["avc"],
                                 g["bvc"], ok_v0, valid)
            patch = chroma_edges(patch.transpose(1, 2), g["bs_h"], g["thc"],
                                 g["ahc"], g["bhc"], ok_h0,
                                 valid).transpose(1, 2)
            cp[rows, cols] = patch
    return (yp[4:, 4:].contiguous(), up_[4:, 4:].contiguous(),
            vp[4:, 4:].contiguous())


# ---------------------------------------------------------------- K2
_DEBLOCK_TAB = {}


def _deblock_tab(device):
    """ALPHA / BETA / TC0 / CHROMA_QP tables as the kernel reads them:
    52 + 52 + 52*4 + 52 int32."""
    if device not in _DEBLOCK_TAB:
        tab = np.concatenate([tables.ALPHA_TABLE, tables.BETA_TABLE,
                              tables.TC0_TABLE.ravel(),
                              tables.CHROMA_QP_TABLE]).astype(np.int32)
        _DEBLOCK_TAB[device] = torch.as_tensor(tab, device=device)
    return _DEBLOCK_TAB[device]


_WAVEFRONT = {}


def _wavefront(device, stream: int, mb_h: int):
    """The kernel's int32 scratch on `device` for launches on `stream`:
    mb_h row counters, then the row ticket (the entry point clears them
    on the stream before its launch, so calls on one stream may share
    it)."""
    key = (str(device), stream)
    t = _WAVEFRONT.get(key)
    if t is None or t.numel() < mb_h + 1:
        t = _WAVEFRONT[key] = torch.empty(mb_h + 1, dtype=I32, device=device)
    return t


def deblock_frame(mb_h: int, mb_w: int, y, u, v, qp_mb, intra_mb, nnz4,
                  ref4, mv4, ref4_l1, mv4_l1, is_b: bool, alpha_off: int,
                  beta_off: int, chroma_qp_offset: int, t8_mb=None):
    """K2 `deblock_diag`: deblock a frame.

    Replaces x264_tpu/ops/deblock.py:deblock_frame. On CUDA tensors it
    filters y / u / v IN PLACE (and returns them) in one launch of
    csrc/deblock.cu: a CTA an MB row, each MB after the row above has
    passed its top-right neighbour. The kernel derives bS and alpha /
    beta / tc0 from the maps itself, takes bS 0 on the inner luma edges 1
    and 3 of the MBs t8_mb marks (the 8x8 transform) and, in a B slice
    (is_b), compares the L1 refs and MVs too. On CPU tensors it runs the
    plain version, which returns new planes."""
    if y.device.type == "cpu":
        return deblock_frame_plain(mb_h, mb_w, y, u, v, qp_mb, intra_mb,
                                   nnz4, ref4, mv4, ref4_l1, mv4_l1, is_b,
                                   alpha_off, beta_off, chroma_qp_offset,
                                   t8_mb)
    dev = y.device
    H, W, H4, W4 = mb_h * 16, mb_w * 16, mb_h * 4, mb_w * 4
    cuda.check(y, (H, W), I32, "y")
    cuda.check(u, (H // 2, W // 2), I32, "u")
    cuda.check(v, (H // 2, W // 2), I32, "v")
    cuda.check(qp_mb, (mb_h, mb_w), I32, "qp_mb")
    cuda.check(intra_mb, (mb_h, mb_w), torch.bool, "intra_mb")
    cuda.check(nnz4, (H4, W4), I32, "nnz4")
    cuda.check(ref4, (H4, W4), I32, "ref4")
    cuda.check(mv4, (H4, W4, 2), I32, "mv4")
    ptrs = [t.data_ptr() for t in (y, u, v, qp_mb, intra_mb, nnz4, ref4,
                                   mv4)]
    if is_b:
        cuda.check(ref4_l1, (H4, W4), I32, "ref4_l1")
        cuda.check(mv4_l1, (H4, W4, 2), I32, "mv4_l1")
        ptrs += [ref4_l1.data_ptr(), mv4_l1.data_ptr()]
    else:
        ptrs += [0, 0]
    ptrs.append(_deblock_tab(dev).data_ptr())
    if t8_mb is not None:
        cuda.check(t8_mb, (mb_h, mb_w), torch.bool, "t8_mb")
        ptrs.append(t8_mb.data_ptr())
    else:
        ptrs.append(0)
    # the kernel moves the planes in 16-byte vectors and reads each MV as
    # one 8-byte pair
    for t, what, align in ((y, "y", 16), (u, "u", 16), (v, "v", 16),
                           (mv4, "mv4", 8), (mv4_l1, "mv4_l1", 8)):
        if (is_b or what != "mv4_l1") and t.data_ptr() % align:
            raise ValueError(f"{what}: must start {align}-byte aligned")
    stream = cuda.stream(dev)
    ptrs.append(_wavefront(dev, stream, mb_h).data_ptr())
    cuda.launch("deblock", "deblock_frame", "p" * 13 + "iiiii" + "p",
                *ptrs, mb_h, mb_w, alpha_off, beta_off, chroma_qp_offset,
                stream)
    deblock_frame.launches += 1
    deblock_frame.launches_t8 += int(t8_mb is not None)
    deblock_frame.launches_b += int(is_b)
    return y, u, v


# launches, and those of them with a t8_mb map and with B-slice maps
deblock_frame.launches = deblock_frame.launches_t8 = \
    deblock_frame.launches_b = 0

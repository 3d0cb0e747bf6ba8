"""Full-pel motion estimation — plain PyTorch twin of x264_tpu/ops/me.py
(se_bits, mv_cost_bits, _half_plane, hier_search) and the wrapper of its
CUDA kernel (csrc/me.cu, kernel K5).

The reference walks its DIA / HEX / UMH patterns MB by MB
(x264_me_search_ref, encoder/me.c:156). x264_tpu re-expresses the UMH
idea densely for every MB at once: an exhaustive SAD search on half-
resolution planes, then three small full-resolution windows around the
coarse winner, the predictor and the zero vector. The MV cost is lambda
times the se-Golomb length of the quarter-pel mvd against a per-MB
predictor (the previous frame's MV field).
"""

from __future__ import annotations

import torch

from .. import cuda
from .mc import PAD, blocks, pad_plane

I32 = torch.int32

# the three refinement windows of stage 2: (centre, half-width m)
WINDOW_M = (3, 2, 1)


def se_bits(v):
    """Bit length of the signed Exp-Golomb code of v (bs_size_se)."""
    m = torch.where(v > 0, 2 * v - 1, -2 * v).to(I32)
    n = m + 1
    bl = torch.zeros_like(n)
    for shift in (16, 8, 4, 2, 1):
        ge = n >= (1 << shift)
        bl = bl + torch.where(ge, shift, 0)
        n = torch.where(ge, n >> shift, n)
    return (2 * (bl + 1) - 1).to(I32)


def mv_cost_bits(mv, mvp):
    """Total se-Golomb bits of the mvd (both components), qpel units."""
    d = mv - mvp
    return se_bits(d[..., 0]) + se_bits(d[..., 1])


def _half_plane(p):
    """2x downsample by the rounded 2x2 mean (the lowres filter of
    x264_frame_init_lowres, common/mc.c:306)."""
    h, w = p.shape
    h2, w2 = h // 2 * 2, w // 2 * 2
    q = p[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).to(I32)
    return (q.sum((1, 3), dtype=I32) + 2) >> 2


def _win_slices(arr2d, by, bx, wy: int, wx: int):
    """Per-MB (wy, wx) windows of arr2d at starts (by, bx), each start
    taken as jax.lax.dynamic_slice takes it (mc.ds_start).
    Returns (*by.shape, wy, wx)."""
    return blocks(arr2d[None], torch.zeros_like(by), by, bx, wy, wx)


def coarse_range(me_range: int) -> int:
    """Half-resolution search radius of stage 1."""
    return min((me_range + 1) // 2 + 1, PAD // 2)


def hier_search_plain(cur, ref_pad, mb_h: int, mb_w: int, me_range: int,
                      lam: int, mvp_qpel):
    """Plain version of K5. cur: (mb_h*16, mb_w*16) int32; ref_pad: the
    reference luma edge-padded by PAD; mvp_qpel: (mb_h, mb_w, 2) qpel
    predictor of the MV cost. Returns (mv_qpel (mb_h, mb_w, 2) full-pel
    MVs in qpel units, sad (mb_h, mb_w)), both int32."""
    H, W = mb_h * 16, mb_w * 16
    R = me_range
    dev = cur.device
    cur = cur.to(I32)
    ref_pad = ref_pad.to(I32)
    cur_tiles = cur.reshape(mb_h, 16, mb_w, 16).transpose(1, 2)

    # ---- stage 1: dense coarse search on half-res planes; candidates
    # in (dy outer, dx inner) order, argmin takes the first minimum
    ref_q = _half_plane(ref_pad[PAD:PAD + H, PAD:PAD + W])
    cur_q = _half_plane(cur)
    rq = coarse_range(R)
    Hq, Wq = H // 2, W // 2
    ref_qp = pad_plane(ref_q, rq)
    sads_q, cand = [], []
    for dy in range(-rq, rq + 1):
        for dx in range(-rq, rq + 1):
            s = ref_qp[rq + dy:rq + dy + Hq, rq + dx:rq + dx + Wq]
            sads_q.append((cur_q - s).abs().reshape(mb_h, 8, mb_w, 8)
                          .sum((1, 3), dtype=I32))
            cand.append((dx, dy))
    cand_q = torch.tensor(cand, dtype=I32, device=dev)
    bits_q = mv_cost_bits(cand_q[:, None, None, :] * 8, mvp_qpel[None])
    cost_q = torch.stack(sads_q) * 4 + lam * bits_q
    mv_coarse = cand_q[cost_q.argmin(0)] * 2            # fpel

    # ---- stage 2: windowed full-res refinement around the coarse
    # winner, the rounded predictor and zero
    ys = torch.arange(mb_h, dtype=I32, device=dev)[:, None] * 16
    xs = torch.arange(mb_w, dtype=I32, device=dev)[None, :] * 16

    def window_sads(center, m):
        lim = min(R, PAD - m - 1)
        c = center.clamp(-lim, lim)
        wn = 16 + 2 * m
        win = _win_slices(ref_pad, ys + c[..., 1] - m + PAD,
                          xs + c[..., 0] - m + PAD, wn, wn)
        sads, mvs = [], []
        for oy in range(2 * m + 1):
            for ox in range(2 * m + 1):
                sads.append((cur_tiles - win[..., oy:oy + 16, ox:ox + 16])
                            .abs().sum((-2, -1), dtype=I32))
                mvs.append(c + torch.tensor([ox - m, oy - m], dtype=I32,
                                            device=dev))
        return sads, mvs

    sads, mvs = [], []
    for center, m in zip((mv_coarse, (mvp_qpel + 2) >> 2,
                          torch.zeros_like(mv_coarse)), WINDOW_M):
        s, v = window_sads(center, m)
        sads += s
        mvs += v
    sads = torch.stack(sads)                         # (NC, mb_h, mb_w)
    mvq = torch.stack(mvs) * 4
    best = (sads + lam * mv_cost_bits(mvq, mvp_qpel[None])).argmin(0)
    best_mv = mvq.gather(0, best[None, ..., None].expand(1, -1, -1, 2))[0]
    best_sad = sads.gather(0, best[None])[0]
    return best_mv, best_sad


# ---------------------------------------------------------------- K5
def hier_search(cur, ref_pad, mb_h: int, mb_w: int, me_range: int,
                lam: int, mvp_qpel):
    """K5 `me_hier`: the hierarchical full-pel search of every MB.

    Replaces x264_tpu/ops/me.py:hier_search. On CUDA tensors it runs
    csrc/me.cu (one launch builds both half-res planes, one CTA per MB
    then runs the coarse search and the 83 window candidates); on CPU
    tensors the plain version. Arguments and results as
    hier_search_plain."""
    if cur.device.type == "cpu":
        return hier_search_plain(cur, ref_pad, mb_h, mb_w, me_range, lam,
                                 mvp_qpel)
    dev = cur.device
    H, W = mb_h * 16, mb_w * 16
    cuda.check(cur, (H, W), I32, "cur")
    cuda.check(ref_pad, (H + 2 * PAD, W + 2 * PAD), I32, "ref_pad")
    cuda.check(mvp_qpel, (mb_h, mb_w, 2), I32, "mvp_qpel")
    half = torch.empty((2, H // 2, W // 2), dtype=I32, device=dev)
    mv = torch.empty((mb_h, mb_w, 2), dtype=I32, device=dev)
    sad = torch.empty((mb_h, mb_w), dtype=I32, device=dev)
    cuda.launch("me", "me_hier", "ppppppiiiiip", cur.data_ptr(),
                ref_pad.data_ptr(), mvp_qpel.data_ptr(), half.data_ptr(),
                mv.data_ptr(), sad.data_ptr(), mb_h, mb_w, me_range, PAD,
                lam, cuda.stream(dev))
    hier_search.launches += 2          # half-res planes, search
    return mv, sad


hier_search.launches = 0

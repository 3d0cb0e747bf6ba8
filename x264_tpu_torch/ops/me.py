"""Motion estimation — plain PyTorch twin of x264_tpu/ops/me.py (se_bits,
mv_cost_bits, _half_plane, fullpel_search, hier_search,
subpel_refine_blocks, subpel_refine, partition_fullpel, chroma_rerank)
and the wrappers of its CUDA kernels: K5 and K29 (csrc/me.cu) and
K10-K12 (csrc/subpel.cu).

The reference walks its DIA / HEX / UMH patterns MB by MB
(x264_me_search_ref, encoder/me.c:156). x264_tpu re-expresses the UMH
idea densely for every MB at once: an exhaustive SAD search on half-
resolution planes, then three small full-resolution windows around the
coarse winner, the predictor and the zero vector. The MV cost is lambda
times the se-Golomb length of the quarter-pel mvd against a per-MB
predictor (the previous frame's MV field).

At subme >= 2 the full-pel winner is refined over the half-pel stack of
ops/mc.py:hpel_planes, SATD-scored (refine_subpel, encoder/me.c:680): 9
half-pel candidates at subme 2-3, all 49 quarter-pel candidates within
+-3 at subme >= 4. The 16x8 / 8x16 / 8x8 partitions search a 7x7
full-pel window around the 16x16 winner, then refine the same way; at
subme >= 5 a 5-point quarter-pel diamond re-ranks the 16x16 winner with
the chroma SATD added (b_chroma_me, encoder/me.c:61-66).
"""

from __future__ import annotations

import torch

from .. import cuda
from . import mc as omc
from . import pixel as opix
from .mc import PAD, blocks, pad_plane

I32 = torch.int32

# the three refinement windows of stage 2: (centre, half-width m)
WINDOW_M = (3, 2, 1)
# partition_fullpel's window half-width and the order of its outputs:
# 16x8 top / bottom, 8x16 left / right, then the P8x8 quadrants
PART_M = 3
PART_KEYS = ("t", "b", "l", "r", "q0", "q1", "q2", "q3")
# chroma_rerank's quarter-pel diamond, in update order
DIAMOND = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
# the partition layouts K10 refines after partition_fullpel: (block
# height, width, the blocks' (dy, dx) in the MB, their rows of
# partition_fullpel's result)
PART_LAYOUTS = ((8, 16, ((0, 0), (8, 0)), (0, 2)),
                (16, 8, ((0, 0), (0, 8)), (2, 4)),
                (8, 8, ((0, 0), (0, 8), (8, 0), (8, 8)), (4, 8)))


def _ptr(t) -> int:
    """A tensor's device pointer, or 0 (null) for None."""
    return 0 if t is None else t.data_ptr()


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


# ---------------------------------------------------------------- K29
def fullpel_search_plain(cur, ref_pad, mb_h: int, mb_w: int, me_range: int,
                         lam: int, mvp_qpel, pad: int = PAD):
    """Plain version of K29: the exhaustive full-pel search over the
    (2R+1)^2 displacements of every 16x16 MB (x264_tpu's fullpel_search).

    cur: (16 mb_h, 16 mb_w) int32; ref_pad: the edge-padded reference
    (16 mb_h + 2 pad, 16 mb_w + 2 pad); mvp_qpel: (mb_h, mb_w, 2) quarter-
    pel predictors (x, y) of the lam * bits MV cost. Each candidate's rows
    and columns start where dynamic_slice puts them (mc.ds_start of
    pad + dy and pad + dx), so beyond the pad the SAD is the clamped
    window's. Returns (mv_qpel (mb_h, mb_w, 2) int32 as (x, y), the
    winner's SAD (mb_h, mb_w) int32); the first candidate in dy-major,
    dx-minor order wins ties."""
    H, W = mb_h * 16, mb_w * 16
    dev = cur.device
    cur = cur.to(I32)
    ref = ref_pad.to(I32)
    d = torch.arange(-me_range, me_range + 1, dtype=I32, device=dev)
    n = d.shape[0]
    rs = omc.ds_start(pad + d, ref.shape[0], H).tolist()
    cols = (omc.ds_start(pad + d, ref.shape[1], W)[:, None]
            + torch.arange(W, device=dev)).long()            # (n, W)
    sads = []
    for r0 in rs:
        s = ref[r0:r0 + H][:, cols]                          # (H, n, W)
        diff = (cur[:, None, :] - s).abs()
        sads.append(diff.reshape(mb_h, 16, n, mb_w, 16)
                    .sum((1, 4), dtype=I32).permute(1, 0, 2))
    sads = torch.stack(sads).reshape(n * n, mb_h, mb_w)      # dy major
    cand = torch.stack([d.repeat(n), d.repeat_interleave(n)], -1) * 4
    bits = mv_cost_bits(cand[:, None, None, :], mvp_qpel.to(I32)[None])
    best = (sads + lam * bits).argmin(0)
    return cand[best], sads.gather(0, best[None])[0]


def fullpel_search(cur, ref_pad, mb_h: int, mb_w: int, me_range: int,
                   lam: int, mvp_qpel, pad: int = PAD):
    """K29 `fullpel_search`: the exhaustive full-pel search of every MB.

    Replaces x264_tpu/ops/me.py:fullpel_search (reached through
    tools/profile_stages.py). On CUDA tensors it runs csrc/me.cu, one
    launch with a 256-thread CTA per MB; on CPU tensors the plain
    version. Arguments and results as fullpel_search_plain."""
    if cur.device.type == "cpu":
        return fullpel_search_plain(cur, ref_pad, mb_h, mb_w, me_range, lam,
                                    mvp_qpel, pad)
    dev = cur.device
    H, W = mb_h * 16, mb_w * 16
    cuda.check(cur, (H, W), I32, "cur")
    cuda.check(ref_pad, (H + 2 * pad, W + 2 * pad), I32, "ref_pad")
    cuda.check(mvp_qpel, (mb_h, mb_w, 2), I32, "mvp_qpel")
    mv = torch.empty((mb_h, mb_w, 2), dtype=I32, device=dev)
    sad = torch.empty((mb_h, mb_w), dtype=I32, device=dev)
    cuda.launch("me", "fullpel_search", "pppppiiiiip", cur.data_ptr(),
                ref_pad.data_ptr(), mvp_qpel.data_ptr(), mv.data_ptr(),
                sad.data_ptr(), mb_h, mb_w, me_range, pad, lam,
                cuda.stream(dev))
    fullpel_search.launches += 1
    return mv, sad


fullpel_search.launches = 0


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


# ---------------------------------------------------------------- K10
def subpel_offsets(steps):
    """The candidate offsets (dx, dy) in qpel of a sub-pel refinement, dy
    outer and dx inner (argmin keeps the first of equal costs): (2,) the
    9 half-pel ones (subme 2-3), (2, 1) all 49 within +-3 (subme >= 4)."""
    steps = tuple(steps)
    if steps == (2,):
        return [(dx, dy) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
    if steps == (2, 1):
        return [(dx, dy) for dy in range(-3, 4) for dx in range(-3, 4)]
    raise ValueError(f"sub-pel steps {steps}: expected (2,) or (2, 1)")


def subpel_refine_blocks_plain(cur, planes, mv_qpel, lam: int, mvp_qpel,
                               ys, xs, bh: int, bw: int, steps,
                               ref_sel=None):
    """Plain version of K10 (refine_subpel, encoder/me.c:680).

    cur: the (H, W) source plane; the blocks are its (bh, bw) blocks at
    top-left (ys, xs), any leading shape. planes: the (4, Hp, Wp) half-pel
    stack; mv_qpel: the blocks' full-pel MVs in qpel units; mvp_qpel their
    predictors. Every candidate of a block shares one full-pel start, so
    one (bh + 3, bw + 3) window of each plane (its start taken as
    dynamic_slice takes it) serves them all; a candidate's prediction is
    the rounding average of two plane samples (the hpel_ref0/1 scheme of
    mc_luma). Cost SATD + lam * mv bits; the first minimum wins. With
    ref_sel (the blocks' shape: each block's reference) planes is the
    (4 * n_refs, Hp, Wp) concatenation of each reference's stack and a
    block reads the four planes of its own. Returns (mv, satd) at the
    refined position, int32."""
    dev = planes.device
    cur_blocks = blocks(cur.to(I32)[None], torch.zeros_like(ys), ys, xs,
                        bh, bw)
    by = ys + (mv_qpel[..., 1] >> 2) - 1 + PAD
    bx = xs + (mv_qpel[..., 0] >> 2) - 1 + PAD
    base = torch.zeros_like(by) if ref_sel is None else 4 * ref_sel
    win = [blocks(planes, base + k, by, bx, bh + 3, bw + 3)
           for k in range(4)]
    satds, mvs = [], []
    for ox, oy in subpel_offsets(steps):
        fx, fy = ox & 3, oy & 3
        q = (fy << 2) | fx
        p0, p1 = int(omc._HPEL_REF0[q]), int(omc._HPEL_REF1[q])
        iy, ix = 1 + (oy >> 2), 1 + (ox >> 2)
        ay = iy + (fy == 3)
        bx1 = ix + (fx == 3)
        a = win[p0][..., ay:ay + bh, ix:ix + bw]
        b = win[p1][..., iy:iy + bh, bx1:bx1 + bw]
        satds.append(opix.satd(cur_blocks, (a + b + 1) >> 1))
        mvs.append(mv_qpel + torch.tensor([ox, oy], dtype=I32, device=dev))
    satd = torch.stack(satds)
    mvs = torch.stack(mvs)
    best = (satd + lam * mv_cost_bits(mvs, mvp_qpel[None])).argmin(0)
    best_mv = mvs.gather(0, best[None, ..., None].expand(
        1, *best.shape, 2))[0]
    return best_mv, satd.gather(0, best[None])[0]


def subpel_refine_blocks(cur, planes, mv_qpel, lam: int, mvp_qpel, ys, xs,
                         bh: int, bw: int, steps, ref_sel=None):
    """K10 `subpel_refine`: the sub-pel refinement of a batch of blocks.

    Replaces x264_tpu/ops/me.py:subpel_refine_blocks (and subpel_refine,
    its 16x16 case). On CUDA tensors it runs csrc/subpel.cu, one warp per
    block: its four (bh + 3, bw + 3) plane windows sit in shared memory
    and its lanes score the 9 or 49 candidates from there (with ref_sel
    from its block's reference's four planes); on CPU tensors the plain
    version. Arguments and results as subpel_refine_blocks_plain."""
    if cur.device.type == "cpu":
        return subpel_refine_blocks_plain(cur, planes, mv_qpel, lam,
                                          mvp_qpel, ys, xs, bh, bw, steps,
                                          ref_sel)
    dev = cur.device
    n_cand = len(subpel_offsets(steps))
    if (bh, bw) not in ((16, 16), (8, 16), (16, 8), (8, 8)):
        raise ValueError(f"subpel_refine: block {bh}x{bw} not supported")
    H, W = cur.shape
    lead = tuple(ys.shape)
    cuda.check(cur, (H, W), I32, "cur")
    n_refs = 1 if ref_sel is None else planes.shape[0] // 4
    cuda.check(planes, (4 * n_refs, H + 2 * PAD, W + 2 * PAD), I32,
               "planes")
    checks = [(mv_qpel, lead + (2,), "mv_qpel"),
              (mvp_qpel, lead + (2,), "mvp_qpel"), (ys, lead, "ys"),
              (xs, lead, "xs")]
    if ref_sel is not None:
        checks.append((ref_sel, lead, "ref_sel"))
    for t, shape, name in checks:
        cuda.check(t, shape, I32, name)
    n = ys.numel()
    mv = torch.empty(lead + (2,), dtype=I32, device=dev)
    satd = torch.empty(lead, dtype=I32, device=dev)
    cuda.launch("subpel", "subpel_refine", "ppppppppp" + "iiiiiii" + "p",
                cur.data_ptr(), planes.data_ptr(), mv_qpel.data_ptr(),
                mvp_qpel.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                _ptr(ref_sel), mv.data_ptr(), satd.data_ptr(), n, H, W, bh,
                bw, lam, int(n_cand == 49), cuda.stream(dev))
    subpel_refine_blocks.launches += 1
    subpel_refine_blocks.launches_ref2 += int(ref_sel is not None)
    return mv, satd


# launches, and those of them with a reference per block
subpel_refine_blocks.launches = subpel_refine_blocks.launches_ref2 = 0


def subpel_refine_parts_plain(cur, planes, mv_parts, lam: int, mvp_qpel,
                              steps, ref_sel=None):
    """Plain version of subpel_refine_parts: subpel_refine_blocks_plain
    once per layout, on the layout's rows of mv_parts, every block of an
    MB with the MB's predictor and reference."""
    nk, mb_h, mb_w = mv_parts.shape[:3]
    out = []
    for bh, bw, offs, (a, b) in PART_LAYOUTS[:nk // 4 + 1]:
        n = len(offs)
        ys, xs = block_origins(mb_h, mb_w, offs, cur.device)
        sel = None if ref_sel is None \
            else ref_sel.expand(n, mb_h, mb_w).contiguous()
        out.append(subpel_refine_blocks_plain(
            cur, planes, mv_parts[a:b], lam,
            mvp_qpel.expand(n, mb_h, mb_w, 2).contiguous(), ys, xs, bh, bw,
            steps, sel))
    return out


def subpel_refine_parts(cur, planes, mv_parts, lam: int, mvp_qpel, steps,
                        ref_sel=None):
    """K10 on the partition layouts of a P frame in one launch.

    mv_parts: partition_fullpel's (nk, mb_h, mb_w, 2) result (nk 4: the
    16x8 and 8x16 blocks; 8: the P8x8 quadrants too), each row refined as
    the PART_LAYOUTS layout it belongs to; mvp_qpel (mb_h, mb_w, 2) and
    ref_sel (mb_h, mb_w) or None: each MB's, for every block of it.
    Returns [(mv, satd)] per layout, each as subpel_refine_blocks returns
    it for the layout's (n, mb_h, mb_w) blocks. On CUDA tensors
    csrc/subpel.cu's subpel_refine_parts, every layout's blocks in one
    launch, a CTA's shape taken from its index; on CPU tensors the plain
    version."""
    if cur.device.type == "cpu":
        return subpel_refine_parts_plain(cur, planes, mv_parts, lam,
                                         mvp_qpel, steps, ref_sel)
    nk, mb_h, mb_w = mv_parts.shape[:3]
    dev = cur.device
    n_cand = len(subpel_offsets(steps))
    if nk not in (4, 8):
        raise ValueError(f"subpel_refine_parts: {nk} partition rows")
    H, W = mb_h * 16, mb_w * 16
    cuda.check(cur, (H, W), I32, "cur")
    n_refs = 1 if ref_sel is None else planes.shape[0] // 4
    cuda.check(planes, (4 * n_refs, H + 2 * PAD, W + 2 * PAD), I32,
               "planes")
    cuda.check(mv_parts, (nk, mb_h, mb_w, 2), I32, "mv_parts")
    cuda.check(mvp_qpel, (mb_h, mb_w, 2), I32, "mvp_qpel")
    if ref_sel is not None:
        cuda.check(ref_sel, (mb_h, mb_w), I32, "ref_sel")
    mv = torch.empty((nk, mb_h, mb_w, 2), dtype=I32, device=dev)
    satd = torch.empty((nk, mb_h, mb_w), dtype=I32, device=dev)
    cuda.launch("subpel", "subpel_refine_parts", "ppppppp" + "iiiii" + "p",
                cur.data_ptr(), planes.data_ptr(), mv_parts.data_ptr(),
                mvp_qpel.data_ptr(), _ptr(ref_sel), mv.data_ptr(),
                satd.data_ptr(), mb_h, mb_w, nk, lam, int(n_cand == 49),
                cuda.stream(dev))
    subpel_refine_parts.launches += 1
    subpel_refine_parts.launches_ref2 += int(ref_sel is not None)
    return [(mv[a:b], satd[a:b])
            for _, _, _, (a, b) in PART_LAYOUTS[:nk // 4 + 1]]


# launches, and those of them with a reference per MB
subpel_refine_parts.launches = subpel_refine_parts.launches_ref2 = 0


def mb_origins(mb_h: int, mb_w: int, device):
    """Top-left pixel (ys, xs) of every MB, (mb_h, mb_w) int32 each."""
    ys = torch.arange(mb_h, dtype=I32, device=device)[:, None] * 16
    xs = torch.arange(mb_w, dtype=I32, device=device)[None, :] * 16
    return (ys.expand(mb_h, mb_w).contiguous(),
            xs.expand(mb_h, mb_w).contiguous())


def block_origins(mb_h: int, mb_w: int, offs, device):
    """Stacked top-left (ys, xs) of one block per (dy, dx) in offs inside
    every MB: (len(offs), mb_h, mb_w) int32 each."""
    ys, xs = mb_origins(mb_h, mb_w, device)
    return (torch.stack([ys + dy for dy, _ in offs]),
            torch.stack([xs + dx for _, dx in offs]))


def subpel_refine(cur, planes, mv_qpel, lam: int, mvp_qpel, steps,
                  ref_sel=None):
    """The 16x16 case of subpel_refine_blocks: every MB of the (H, W)
    source plane `cur`, MVs and predictors (mb_h, mb_w, 2), ref_sel
    (mb_h, mb_w) each MB's reference or None."""
    ys, xs = mb_origins(*mv_qpel.shape[:2], cur.device)
    return subpel_refine_blocks(cur, planes, mv_qpel, lam, mvp_qpel, ys, xs,
                                16, 16, steps, ref_sel)


# ---------------------------------------------------------------- K11
def partition_fullpel_plain(cur, ref_pad, mv16_qpel, lam: int, mvp_qpel,
                            me_range: int, with_8x8: bool, ref_sel=None):
    """Plain version of K11: the best full-pel MVs of the 16x8 and 8x16
    partitions (and, with_8x8, of the four 8x8 quadrants) of every MB,
    searched in a 7x7 window around the 16x16 full-pel winner (the
    reference seeds its partition searches from the MB result,
    encoder/analyse.c:1274-1404). The centre clamps to
    +-min(R, PAD - 4); each offset's |diff| is reduced into the partition
    sums, and each sum takes the first minimum of sad + lam * mv bits
    against mvp_qpel. cur: (H, W); ref_pad the padded reference luma or,
    with ref_sel (mb_h, mb_w) each MB's reference, the (n_refs, Hp, Wp)
    stack of the padded references; mv16_qpel / mvp_qpel (mb_h, mb_w, 2).
    Returns (4 or 8, mb_h, mb_w, 2) qpel MVs in PART_KEYS order."""
    mb_h, mb_w = mv16_qpel.shape[:2]
    dev = cur.device
    m = PART_M
    ys, xs = mb_origins(mb_h, mb_w, dev)
    cur_tiles = cur.to(I32).reshape(mb_h, 16, mb_w, 16).transpose(1, 2)
    lim = min(me_range, PAD - m - 1)
    c = (mv16_qpel >> 2).clamp(-lim, lim)
    wn = 16 + 2 * m
    if ref_sel is None:
        ref_pad, ref_sel = ref_pad[None], torch.zeros_like(ys)
    win = blocks(ref_pad.to(I32), ref_sel, ys + c[..., 1] - m + PAD,
                 xs + c[..., 0] - m + PAD, wn, wn)
    sums = {k: [] for k in PART_KEYS[:8 if with_8x8 else 4]}
    for oy in range(2 * m + 1):
        for ox in range(2 * m + 1):
            d = (cur_tiles - win[..., oy:oy + 16, ox:ox + 16]).abs()
            hs = d.reshape(mb_h, mb_w, 2, 8, 2, 8).sum((-3, -1), dtype=I32)
            sums["t"].append(hs[..., 0, :].sum(-1, dtype=I32))
            sums["b"].append(hs[..., 1, :].sum(-1, dtype=I32))
            sums["l"].append(hs[..., :, 0].sum(-1, dtype=I32))
            sums["r"].append(hs[..., :, 1].sum(-1, dtype=I32))
            if with_8x8:
                for k in range(4):
                    sums[f"q{k}"].append(hs[..., k >> 1, k & 1])
    offs = torch.tensor([(ox, oy) for oy in range(-m, m + 1)
                         for ox in range(-m, m + 1)], dtype=I32, device=dev)
    mvs = (c[None] + offs[:, None, None, :]) * 4
    bits = lam * mv_cost_bits(mvs, mvp_qpel[None])
    out = []
    for k, s in sums.items():
        best = (torch.stack(s) + bits).argmin(0)
        out.append(mvs.gather(0, best[None, ..., None].expand(
            1, mb_h, mb_w, 2))[0])
    return torch.stack(out)


def partition_fullpel(cur, ref_pad, mv16_qpel, lam: int, mvp_qpel,
                      me_range: int, with_8x8: bool, ref_sel=None):
    """K11 `part_fullpel`: the full-pel partition search of every MB.

    Replaces x264_tpu/ops/me.py:partition_fullpel. On CUDA tensors it
    runs csrc/subpel.cu, one CTA per MB with the 22x22 window and the
    16x16 source in shared memory (with ref_sel the window of the MB's
    reference in the stack); on CPU tensors the plain version. Arguments
    and result as partition_fullpel_plain."""
    if cur.device.type == "cpu":
        return partition_fullpel_plain(cur, ref_pad, mv16_qpel, lam,
                                       mvp_qpel, me_range, with_8x8, ref_sel)
    dev = cur.device
    mb_h, mb_w = mv16_qpel.shape[:2]
    H, W = mb_h * 16, mb_w * 16
    cuda.check(cur, (H, W), I32, "cur")
    pad_shape = (H + 2 * PAD, W + 2 * PAD)
    if ref_sel is not None:
        pad_shape = (ref_pad.shape[0],) + pad_shape
        cuda.check(ref_sel, (mb_h, mb_w), I32, "ref_sel")
    cuda.check(ref_pad, pad_shape, I32, "ref_pad")
    cuda.check(mv16_qpel, (mb_h, mb_w, 2), I32, "mv16_qpel")
    cuda.check(mvp_qpel, (mb_h, mb_w, 2), I32, "mvp_qpel")
    nk = 8 if with_8x8 else 4
    out = torch.empty((nk, mb_h, mb_w, 2), dtype=I32, device=dev)
    cuda.launch("subpel", "part_fullpel", "pppppp" + "iiiiii" + "p",
                cur.data_ptr(), ref_pad.data_ptr(), mv16_qpel.data_ptr(),
                mvp_qpel.data_ptr(), _ptr(ref_sel), out.data_ptr(), mb_h,
                mb_w, me_range, PAD, lam, nk, cuda.stream(dev))
    partition_fullpel.launches += 1
    partition_fullpel.launches_ref2 += int(ref_sel is not None)
    return out


# launches, and those of them with a reference per MB
partition_fullpel.launches = partition_fullpel.launches_ref2 = 0


# ---------------------------------------------------------------- K12
def chroma_rerank_plain(cur, planes, cur_u, cur_v, cu_pad, cv_pad, mv_qpel,
                        lam: int, mvp_qpel, center_satd, ref_sel=None):
    """Plain version of K12 (b_chroma_me: the refine_subpel chroma term,
    encoder/me.c:61-66, which the reference applies in its 4-neighbour
    qpel diamond at subme >= 5): the five candidates of DIAMOND around
    the sub-pel winner, each scored luma SATD + U / V SATD (through
    mc_luma and mc_chroma) + lam * mv bits, in order with a strict <.
    The centre's luma SATD is center_satd (K10's). Returns (mv, the
    *luma* SATD at the chosen MV): the kept cost stays in luma units, a
    deviation x264_tpu documents and the port keeps. cur / cur_u /
    cur_v: the source planes; cu_pad / cv_pad the chroma references
    padded by PAD // 2; mv_qpel, mvp_qpel (mb_h, mb_w, 2). With ref_sel
    (mb_h, mb_w) each MB's reference, planes / cu_pad / cv_pad are the
    stacks of mc_luma / mc_chroma's multi-reference fetch."""
    mb_h, mb_w = mv_qpel.shape[:2]
    dev = cur.device
    ys, xs = mb_origins(mb_h, mb_w, dev)
    tiles = lambda p, n: p.to(I32).reshape(mb_h, n, mb_w, n).transpose(1, 2)
    ct, cu, cv = tiles(cur, 16), tiles(cur_u, 8), tiles(cur_v, 8)
    best_cost = best_mv = best_l = None
    for ox, oy in DIAMOND:
        mv = mv_qpel + torch.tensor([ox, oy], dtype=I32, device=dev)
        if ox == 0 and oy == 0:
            lsatd = center_satd
        else:
            lsatd = opix.satd(ct, omc.mc_luma(planes, ys, xs, mv, 16, 16,
                                              ref_sel))
        csatd = (opix.satd(cu, omc.mc_chroma(cu_pad, ys >> 1, xs >> 1, mv,
                                             8, 8, ref_sel))
                 + opix.satd(cv, omc.mc_chroma(cv_pad, ys >> 1, xs >> 1, mv,
                                               8, 8, ref_sel)))
        cost = lsatd + csatd + lam * mv_cost_bits(mv, mvp_qpel)
        if best_cost is None:
            best_cost, best_mv, best_l = cost, mv, lsatd
        else:
            upd = cost < best_cost
            best_cost = torch.where(upd, cost, best_cost)
            best_mv = torch.where(upd[..., None], mv, best_mv)
            best_l = torch.where(upd, lsatd, best_l)
    return best_mv, best_l


def chroma_rerank(cur, planes, cur_u, cur_v, cu_pad, cv_pad, mv_qpel,
                  lam: int, mvp_qpel, center_satd, ref_sel=None):
    """K12 `chroma_rerank`: the chroma-ME re-rank of every MB.

    Replaces x264_tpu/ops/me.py:chroma_rerank. The candidates' phases vary
    per MB, so on CUDA tensors csrc/subpel.cu fetches each MB's five luma
    and chroma predictions into shared memory (one CTA per MB) and scores
    them there (with ref_sel from the MB's reference's planes); on CPU
    tensors the plain version. Arguments and results as
    chroma_rerank_plain."""
    if cur.device.type == "cpu":
        return chroma_rerank_plain(cur, planes, cur_u, cur_v, cu_pad,
                                   cv_pad, mv_qpel, lam, mvp_qpel,
                                   center_satd, ref_sel)
    dev = cur.device
    mb_h, mb_w = mv_qpel.shape[:2]
    H, W = mb_h * 16, mb_w * 16
    n_refs = 1 if ref_sel is None else planes.shape[0] // 4
    cshape = (H // 2 + PAD, W // 2 + PAD)
    if ref_sel is not None:
        cshape = (n_refs,) + cshape
    checks = [(cur, (H, W), "cur"),
              (planes, (4 * n_refs, H + 2 * PAD, W + 2 * PAD), "planes"),
              (cur_u, (H // 2, W // 2), "cur_u"),
              (cur_v, (H // 2, W // 2), "cur_v"),
              (cu_pad, cshape, "cu_pad"), (cv_pad, cshape, "cv_pad"),
              (mv_qpel, (mb_h, mb_w, 2), "mv_qpel"),
              (mvp_qpel, (mb_h, mb_w, 2), "mvp_qpel"),
              (center_satd, (mb_h, mb_w), "center_satd")]
    if ref_sel is not None:
        checks.append((ref_sel, (mb_h, mb_w), "ref_sel"))
    for t, shape, name in checks:
        cuda.check(t, shape, I32, name)
    mv = torch.empty((mb_h, mb_w, 2), dtype=I32, device=dev)
    satd = torch.empty((mb_h, mb_w), dtype=I32, device=dev)
    cuda.launch("subpel", "chroma_rerank", "p" * 12 + "iii" + "p",
                cur.data_ptr(), planes.data_ptr(), cur_u.data_ptr(),
                cur_v.data_ptr(), cu_pad.data_ptr(), cv_pad.data_ptr(),
                mv_qpel.data_ptr(), mvp_qpel.data_ptr(),
                center_satd.data_ptr(), _ptr(ref_sel), mv.data_ptr(),
                satd.data_ptr(), mb_h, mb_w, lam, cuda.stream(dev))
    chroma_rerank.launches += 1
    chroma_rerank.launches_ref2 += int(ref_sel is not None)
    return mv, satd


# launches, and those of them with a reference per MB
chroma_rerank.launches = chroma_rerank.launches_ref2 = 0

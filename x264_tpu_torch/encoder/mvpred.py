"""Exact MV prediction over the final block-level maps — plain PyTorch
twin of x264_tpu/encoder/mvpred.py (median3, _pad_maps, _gather,
_predict, _slots_16x16, predict_16x16, predict_pskip, predict_16x8,
predict_8x16, predict_p8x8, spatial_direct).

The reference predicts MVs through its per-MB neighbour cache
(x264_mb_predict_mv_16x16 / _pskip, common/macroblock.c:28-153). Once a
frame's MVs are final, prediction becomes gathers on 4x4-granular maps:

  ref4: (4*mb_h, 4*mb_w) int32 reference index per 4x4 block (-1 intra;
        the pad ring supplies -2, "unavailable")
  mv4:  (4*mb_h, 4*mb_w, 2) int32 qpel MV per 4x4 block (0 for intra)

A is the left block, B the top, C the top-right (top + partition
width), D the top-left; C falls back to D where C is unavailable, or
where the scan8 cache slot is not written yet in raster order (the
bottom 16x8 partition's C, common/macroblock.c:41-45). In the port the
same rules run in kernel K8's first pass (csrc/cabac_ops.cu).
"""

from __future__ import annotations

import torch

I32 = torch.int32


def median3(a, b, c):
    return a + b + c - torch.minimum(a, torch.minimum(b, c)) \
        - torch.maximum(a, torch.maximum(b, c))


def _pad_maps(ref4, mv4):
    """1-ring pad: outside the frame = ref -2, mv 0."""
    h, w = ref4.shape
    refp = torch.full((h + 2, w + 2), -2, dtype=I32, device=ref4.device)
    refp[1:-1, 1:-1] = ref4
    mvp = torch.zeros((h + 2, w + 2, 2), dtype=I32, device=mv4.device)
    mvp[1:-1, 1:-1] = mv4
    return refp, mvp


def _gather(refp, mvp, r, c):
    """(ref, mv) at block coords (r, c) of the unpadded grid; r / c may
    be -1 or one past the end (the pad ring)."""
    return refp[r + 1, c + 1], mvp[r + 1, c + 1]


def _predict(ref_a, mv_a, ref_b, mv_b, ref_c, mv_c, i_ref):
    """The median / count rule (x264_mb_predict_mv_16x16 tail)."""
    cnt = ((ref_a == i_ref).to(I32) + (ref_b == i_ref).to(I32)
           + (ref_c == i_ref).to(I32))
    med = median3(mv_a, mv_b, mv_c)
    only = torch.where((ref_a == i_ref)[..., None], mv_a,
                       torch.where((ref_b == i_ref)[..., None], mv_b, mv_c))
    a_only = (ref_b == -2) & (ref_c == -2) & (ref_a != -2)
    return torch.where((cnt > 1)[..., None], med,
                       torch.where((cnt == 1)[..., None], only,
                                   torch.where(a_only[..., None], mv_a,
                                               med)))


def _grid(mb_h: int, mb_w: int, device):
    """Top-left 4x4-block coordinates of every MB, (mb_h, mb_w) each."""
    gy = torch.arange(mb_h, device=device)[:, None] * 4
    gx = torch.arange(mb_w, device=device)[None, :] * 4
    return gy.expand(mb_h, mb_w), gx.expand(mb_h, mb_w)


def _slots_16x16(refp, mvp, mb_h: int, mb_w: int):
    gy, gx = _grid(mb_h, mb_w, refp.device)
    ref_a, mv_a = _gather(refp, mvp, gy, gx - 1)
    ref_b, mv_b = _gather(refp, mvp, gy - 1, gx)
    ref_c, mv_c = _gather(refp, mvp, gy - 1, gx + 4)
    ref_d, mv_d = _gather(refp, mvp, gy - 1, gx - 1)
    use_d = ref_c == -2
    ref_c = torch.where(use_d, ref_d, ref_c)
    mv_c = torch.where(use_d[..., None], mv_d, mv_c)
    return ref_a, mv_a, ref_b, mv_b, ref_c, mv_c


def predict_16x16(ref4, mv4, i_ref=0):
    """MVP of whole-MB partitions (x264_mb_predict_mv_16x16).
    Returns (mb_h, mb_w, 2)."""
    mb_h, mb_w = ref4.shape[0] // 4, ref4.shape[1] // 4
    refp, mvp = _pad_maps(ref4, mv4)
    return _predict(*_slots_16x16(refp, mvp, mb_h, mb_w), i_ref)


def predict_pskip(ref4, mv4):
    """P_Skip MV (x264_mb_predict_mv_pskip): zero where A or B is
    unavailable or is a zero-MV ref-0 block, else the 16x16 prediction."""
    mb_h, mb_w = ref4.shape[0] // 4, ref4.shape[1] // 4
    refp, mvp = _pad_maps(ref4, mv4)
    gy, gx = _grid(mb_h, mb_w, refp.device)
    ref_a, mv_a = _gather(refp, mvp, gy, gx - 1)
    ref_b, mv_b = _gather(refp, mvp, gy - 1, gx)
    a_zero = (ref_a == 0) & (mv_a == 0).all(-1)
    b_zero = (ref_b == 0) & (mv_b == 0).all(-1)
    force0 = (ref_a == -2) | (ref_b == -2) | a_zero | b_zero
    mvp16 = predict_16x16(ref4, mv4)
    return torch.where(force0[..., None], 0, mvp16)


def _c_or_d(refp, mvp, r, c, rd, cd):
    """The C slot at (r, c), or D at (rd, cd) where C is unavailable."""
    ref_c, mv_c = _gather(refp, mvp, r, c)
    ref_d, mv_d = _gather(refp, mvp, rd, cd)
    use_d = ref_c == -2
    return (torch.where(use_d, ref_d, ref_c),
            torch.where(use_d[..., None], mv_d, mv_c))


def predict_16x8(ref4, mv4, i_ref=0):
    """MVPs of the two 16x8 partitions (x264_mb_predict_mv D_16x8: part 0
    takes B outright when its reference matches, part 1 takes A).
    Returns (mvp0, mvp1), each (mb_h, mb_w, 2)."""
    mb_h, mb_w = ref4.shape[0] // 4, ref4.shape[1] // 4
    refp, mvp = _pad_maps(ref4, mv4)
    gy, gx = _grid(mb_h, mb_w, refp.device)
    ref_a, mv_a, ref_b, mv_b, ref_c, mv_c = _slots_16x16(refp, mvp, mb_h,
                                                         mb_w)
    med0 = _predict(ref_a, mv_a, ref_b, mv_b, ref_c, mv_c, i_ref)
    mvp0 = torch.where((ref_b == i_ref)[..., None], mv_b, med0)
    # part 1 (rows 2-3): A = (gy+2, gx-1); B = (gy+1, gx) inside the MB;
    # its C slot is never written in raster order, so C = D = (gy+1, gx-1)
    ref_a1, mv_a1 = _gather(refp, mvp, gy + 2, gx - 1)
    ref_b1, mv_b1 = _gather(refp, mvp, gy + 1, gx)
    ref_c1, mv_c1 = _gather(refp, mvp, gy + 1, gx - 1)
    med1 = _predict(ref_a1, mv_a1, ref_b1, mv_b1, ref_c1, mv_c1, i_ref)
    mvp1 = torch.where((ref_a1 == i_ref)[..., None], mv_a1, med1)
    return mvp0, mvp1


def predict_8x16(ref4, mv4, i_ref=0):
    """MVPs of the two 8x16 partitions (x264_mb_predict_mv D_8x16: part 0
    takes A outright when its reference matches, part 1 takes C).
    Returns (mvp0, mvp1)."""
    mb_h, mb_w = ref4.shape[0] // 4, ref4.shape[1] // 4
    refp, mvp = _pad_maps(ref4, mv4)
    gy, gx = _grid(mb_h, mb_w, refp.device)
    # part 0 (columns 0-1): C = (gy-1, gx+2) in the MB above
    ref_a, mv_a = _gather(refp, mvp, gy, gx - 1)
    ref_b, mv_b = _gather(refp, mvp, gy - 1, gx)
    ref_c, mv_c = _c_or_d(refp, mvp, gy - 1, gx + 2, gy - 1, gx - 1)
    med0 = _predict(ref_a, mv_a, ref_b, mv_b, ref_c, mv_c, i_ref)
    mvp0 = torch.where((ref_a == i_ref)[..., None], mv_a, med0)
    # part 1 (columns 2-3): A = (gy, gx+1) inside the MB; C the top-right
    # slot (gy-1, gx+4), D = (gy-1, gx+1)
    ref_a1, mv_a1 = _gather(refp, mvp, gy, gx + 1)
    ref_b1, mv_b1 = _gather(refp, mvp, gy - 1, gx + 2)
    ref_c1, mv_c1 = _c_or_d(refp, mvp, gy - 1, gx + 4, gy - 1, gx + 1)
    med1 = _predict(ref_a1, mv_a1, ref_b1, mv_b1, ref_c1, mv_c1, i_ref)
    mvp1 = torch.where((ref_c1 == i_ref)[..., None], mv_c1, med1)
    return mvp0, mvp1


def predict_p8x8(ref4, mv4, i_ref=0):
    """MVPs of the four 8x8 sub-blocks of a P_8x8 MB (x264_mb_predict_mv
    with i_width 2 at scan8 0 / 2 / 8 / 10: the median rule, no
    directional early-outs). In-MB neighbours are earlier sub-blocks
    only; sub-block 3's C slot is never written, so it takes D. Returns
    four (mb_h, mb_w, 2) tensors in quadrant order TL, TR, BL, BR."""
    mb_h, mb_w = ref4.shape[0] // 4, ref4.shape[1] // 4
    refp, mvp = _pad_maps(ref4, mv4)
    gy, gx = _grid(mb_h, mb_w, refp.device)
    out = []
    for k, (oy, ox) in enumerate(((0, 0), (0, 2), (2, 0), (2, 2))):
        by, bx = gy + oy, gx + ox
        ref_a, mv_a = _gather(refp, mvp, by, bx - 1)
        ref_b, mv_b = _gather(refp, mvp, by - 1, bx)
        if k == 3:
            ref_c, mv_c = _gather(refp, mvp, by - 1, bx - 1)
        else:
            ref_c, mv_c = _c_or_d(refp, mvp, by - 1, bx + 2, by - 1, bx - 1)
        out.append(_predict(ref_a, mv_a, ref_b, mv_b, ref_c, mv_c, i_ref))
    return out


def spatial_direct(ref4_l0, mv4_l0, ref4_l1, mv4_l1, col_ref4, col_mv4):
    """Spatial-direct derivation of B_Direct_16x16 / B_SKIP
    (x264_mb_predict_mv_direct16x16_spatial, common/mb.c; spec 8.4.1.2.2
    with direct_8x8_inference_flag 1) on the B frame's per-list 4x4 maps,
    with col_ref4 / col_mv4 the colocated (L0) maps of RefPicList1[0].

    Each list's reference is the unsigned MIN3 of the A / B / C slots'
    (a negative one sorts last; -1 where none is usable) and its MV the
    16x16 median rule at that reference; where neither list has one, both
    take reference 0 and the zero MV. The colocated low-motion override
    tests the corner 4x4 block of each 8x8 quadrant (refCol 0 and |mvCol|
    <= 1 qpel). Returns per-MB (dref0, dref1, dmv0, dmv1, uniform):
    uniform where all four quadrants derive the same MV pair, the only
    form the encoder codes as direct."""
    mb_h, mb_w = ref4_l0.shape[0] // 4, ref4_l0.shape[1] // 4
    big = 1 << 20

    def list_ref_mv(ref4, mv4):
        refp, mvp = _pad_maps(ref4, mv4)
        ra, mva, rb, mvb, rc, mvc = _slots_16x16(refp, mvp, mb_h, mb_w)
        un = lambda r: torch.where(r < 0, big, r)
        r = torch.minimum(torch.minimum(un(ra), un(rb)), un(rc))
        ref = torch.where(r >= big, -1, r).to(I32)
        mv = _predict(ra, mva, rb, mvb, rc, mvc, ref)
        return ref, torch.where((ref >= 0)[..., None], mv, 0)

    dref0, dmv0 = list_ref_mv(ref4_l0, mv4_l0)
    dref1, dmv1 = list_ref_mv(ref4_l1, mv4_l1)
    both_neg = (dref0 < 0) & (dref1 < 0)
    dref0 = torch.where(both_neg, 0, dref0).to(I32)
    dref1 = torch.where(both_neg, 0, dref1).to(I32)
    dmv0 = torch.where(both_neg[..., None], 0, dmv0)
    dmv1 = torch.where(both_neg[..., None], 0, dmv1)
    gy, gx = _grid(mb_h, mb_w, ref4_l0.device)
    zs = []
    for dy, dx in ((0, 0), (0, 3), (3, 0), (3, 3)):
        cr = col_ref4[gy + dy, gx + dx]
        cmv = col_mv4[gy + dy, gx + dx]
        zs.append((cr == 0) & (cmv[..., 0].abs() <= 1)
                  & (cmv[..., 1].abs() <= 1))
    z = torch.stack(zs)
    # the both-unavailable branch returns before the colocated test
    z_all = z.all(0) & ~both_neg
    z_any = z.any(0) & ~both_neg
    would_change = ((dref0 == 0) & (dmv0 != 0).any(-1)) \
        | ((dref1 == 0) & (dmv1 != 0).any(-1))
    uniform = ~would_change | z_all | ~z_any
    dmv0 = torch.where((z_all & (dref0 == 0))[..., None], 0, dmv0).to(I32)
    dmv1 = torch.where((z_all & (dref1 == 0))[..., None], 0, dmv1).to(I32)
    return dref0, dref1, dmv0, dmv1, uniform

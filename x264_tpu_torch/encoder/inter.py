"""P-frame encode — plain PyTorch twin of x264_tpu/encoder/inter.py's
P path at subme 1-9 (make_qtab_p, inter_luma_residual, encode_p_body)
and the wrappers of its CUDA kernels K6 (csrc/inter.cu), K13
(csrc/rdcost.cu) and K7 (csrc/intra_p.cu).

The reference's per-MB P path (x264_macroblock_analyse P branch,
encoder/analyse.c:1077-1519, and x264_macroblock_encode,
encoder/macroblock.c:475) is staged as x264_tpu stages it:

1. full-pel hierarchical ME of every MB at once, seeded by the previous
   frame's MV field (ops/me.py, kernel K5); at subme >= 2 the half-pel
   planes of the reference (K9), the sub-pel refinement of the 16x16 MV
   (K10) and, at subme >= 5, the chroma-ME re-rank (K12);
1b. at subme >= 2 with partitions on: the 16x8 / 8x16 / 8x8 full-pel
   window search (K11), the sub-pel refinement of every partition (K10),
   and the partition type of least SATD + lambda * bits cost;
2. the inter residual of every MB at once, since inter prediction reads
   only the reference: the partitioned quarter-pel luma fetch, the
   1/8-pel chroma fetch, 4x4 DCT, P-matrix quant, DCT decimation,
   reconstruction and, with the 8x8 transform, the 8x8 luma residual and
   (below subme 6) the SA8D-against-SATD transform choice (K6); at subme
   >= 6 (the RD ladder) the whole-MB inter RD cost, true SSD + lambda2 *
   estimated CABAC bits with the psy-RD term, and with the 8x8 transform
   the RD choice between the two luma codings (K13);
3. intra-in-P by bounded-depth sweeps: the I16 + chroma intra path of
   every MB against the inter reconstruction, the intra / inter
   decision (SATD + lambda * bits below subme 6, the RD costs of both
   sides at subme >= 6), demotion of intra chains deeper than K_SWEEPS,
   and two re-evaluations that make the kept chains exact (K7);
4. the syntax maps: exact MV prediction of every partition, P_Skip, the
   mvds and the per-4x4 nnz / ref / mv / mvd maps (kernel K8's first
   pass, entropy/cabac_planes.py).

This slice has one reference and one QP per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from .. import tables
from ..entropy import cabac_planes
from ..ops import dct as odct
from ..ops import mc as omc
from ..ops import me as ome
from ..ops import pixel as opix
from ..ops import predict as opred
from ..ops import quant as oquant
from ..ops import rdcost as ordc
from . import intra
from . import mvpred
from .intra import _BIG, _blocks4, _pick, _unblocks4, _zig

I32 = torch.int32

# lambda multiplier penalising the bigger intra mb_type ue() in P slices
INTRA_PEN_BITS = 7
# intra-in-P sweeps: intra chains deeper than this demote to inter
K_SWEEPS = 3

# key order of the packed inter table csrc/inter.cu reads
QTAB_P_VEC_KEYS = ("py_mf", "py_bias", "py_dmf", "pc_mf", "pc_bias",
                   "pc_dmf")
QTAB_P_SCALAR_KEYS = ("py_qpdiv6", "pc_dmf0", "pc_mf_dc", "pc_bias_dc",
                      "pc_qpdiv6")
# the 8x8-transform tables (CQM_8PY, 64 entries each), packed last
QTAB_P_VEC8_KEYS = ("p8_mf", "p8_bias", "p8_dmf")
# K6's t8 argument: no 8x8 transform; the SA8D choice made in K6 (below
# subme 6); both codings written for K13's RD choice (subme >= 6)
T8_OFF, T8_SA8D, T8_RD = 0, 1, 2


def make_qtab_p(qp_y: int, qp_c: int, device,
                qt: tables.QuantTables | None = None,
                rd_idc: int | None = None, f_psy_rd: float = 0.0) -> dict:
    """The intra tables (y_ / c_) plus the inter ones (py_ / pc_): CQM_4PY
    / CQM_4PC with the inter deadzone (x264_cqm_init, common/set.c:68),
    and p8_ from CQM_8PY for the 8x8 transform.

    rd_idc: the RD ladder's tables too (subme >= 6), as x264_tpu's
    Encoder._qtab_p builds them from i_cabac_init_idc = rd_idc: rdbits
    (the bit costs of every category at qp_y, rdcost.make_rdbits), rdtab
    (the same packed for the kernels), rd_lam2 = float32(lambda2_f8(qp_y))
    and, where f_psy_rd > 0 (psy on), psy_rd = float32(f_psy_rd *
    lambda(qp_y)); the two floats are Python floats holding float32
    values."""
    qt = qt or tables.DEFAULT_QUANT
    out = intra.make_qtab(qp_y, qp_c, device, qt)
    a = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    py, pc = tables.CQM_4PY, tables.CQM_4PC
    out.update(
        p8_mf=a(qt.quant8_mf[tables.CQM_8PY, qp_y]),
        p8_bias=a(qt.quant8_bias[tables.CQM_8PY, qp_y]),
        p8_dmf=a(qt.dequant8_mf[tables.CQM_8PY, qp_y % 6]),
        py_mf=a(qt.quant4_mf[py, qp_y]),
        py_bias=a(qt.quant4_bias[py, qp_y]),
        py_dmf=a(qt.dequant4_mf[py, qp_y % 6]),
        py_qpdiv6=a(qp_y // 6),
        pc_mf=a(qt.quant4_mf[pc, qp_c]),
        pc_bias=a(qt.quant4_bias[pc, qp_c]),
        pc_dmf=a(qt.dequant4_mf[pc, qp_c % 6]),
        pc_dmf0=a(qt.dequant4_mf[pc, qp_c % 6][0]),
        pc_mf_dc=a(qt.quant4_mf[pc, qp_c][0] >> 1),
        pc_bias_dc=a(qt.quant4_bias[pc, qp_c][0] << 1),
        pc_qpdiv6=a(qp_c // 6),
    )
    if rd_idc is not None:
        out["rdbits"] = ordc.make_rdbits(qp_y, rd_idc, device, qt)
        out["rdtab"] = ordc.pack_rdbits(out["rdbits"])
        out["rd_lam2"] = float(np.float32(ordc.lambda2_f8(qp_y)))
        if f_psy_rd > 0:
            out["psy_rd"] = float(np.float32(
                f_psy_rd * float(tables.LAMBDA_TABLE[qp_y])))
    return out


def pack_qtab_p(qtab: dict) -> torch.Tensor:
    """The inter tables as the one int32 vector csrc/inter.cu reads."""
    return torch.cat(
        [qtab[k].reshape(-1).to(I32) for k in QTAB_P_VEC_KEYS]
        + [qtab[k].reshape(1).to(I32) for k in QTAB_P_SCALAR_KEYS]
        + [qtab[k].reshape(-1).to(I32) for k in QTAB_P_VEC8_KEYS])


def _tiles(plane, n: int):
    """(mb_h*n, mb_w*n) -> (mb_h*mb_w, n, n) in raster MB order."""
    h, w = plane.shape
    return plane.to(I32).reshape(h // n, n, w // n, n).transpose(1, 2) \
        .reshape(-1, n, n)


def _untiles(tiles, mb_h: int, mb_w: int):
    n = tiles.shape[-1]
    return tiles.reshape(mb_h, mb_w, n, n).transpose(1, 2) \
        .reshape(mb_h * n, mb_w * n)


def inter_luma_residual(fenc, pred, qtab, decimate: bool = False):
    """Inter 16x16 luma residual of K MBs: 16 4x4 DCT blocks, P-matrix
    quant (x264_macroblock_encode P path, encoder/macroblock.c:538-616).
    decimate: an 8x8 group scoring < 4 is zeroed, and the whole MB when
    the total scores < 6 (encoder/macroblock.c:700-730).
    fenc / pred: (K, 16, 16). Returns (recon (K,16,16), blocks_z
    (K,16,16) zig-zag in z-scan block order, cbp_bits (K,))."""
    K, dev = fenc.shape[0], fenc.device
    zig = _zig(dev)
    coef = odct.dct4x4(_blocks4(fenc - pred, 4))       # (K,4,4,4,4)
    lv = oquant.quant(coef.reshape(K, 16, 16), qtab["py_mf"],
                      qtab["py_bias"])                 # raster blocks
    if decimate:
        s = oquant.decimate_score(lv[..., zig])        # (K,16)
        # raster block (row, col) -> 8x8 group (row // 2, col // 2)
        g = s.reshape(K, 2, 2, 2, 2).sum((-3, -1))     # (K,2,2)
        kill_g = (g < 4) | (g.sum((-2, -1)) < 6)[:, None, None]
        kill = kill_g.repeat_interleave(2, -2).repeat_interleave(2, -1)
        lv = torch.where(kill.reshape(K, 16, 1), 0, lv)
    grp = (lv != 0).any(-1).reshape(K, 2, 2, 2, 2).any(-3).any(-1)
    w = torch.tensor([[1, 2], [4, 8]], dtype=I32, device=dev)
    cbp_bits = (grp * w).sum((-2, -1), dtype=I32)
    deq = oquant.dequant(lv, qtab["py_dmf"], qtab["py_qpdiv6"], 4)
    res = odct.idct4x4(deq.reshape(K, 4, 4, 4, 4))
    recon = (pred + _unblocks4(res, 4)).clamp(0, 255)
    zorder = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    return recon, lv[:, zorder][:, :, zig], cbp_bits


def inter_luma_residual8(fenc, pred, qtab, decimate: bool = False):
    """Inter 16x16 luma residual with the 8x8 transform of K MBs
    (x264_macroblock_encode's b_transform_8x8 branch,
    encoder/macroblock.c:538-558): four 8x8 DCT blocks, CQM_8PY quant.
    decimate: an 8x8 block scoring < 4 on DECIMATE_TAB8 is zeroed, and
    the whole MB when the total scores < 6 (encoder/macroblock.c:
    643-667). fenc / pred: (K, 16, 16). Returns (recon (K,16,16),
    blocks8_z (K,4,64) in 8x8 scan order, 2x2 raster block order,
    cbp_bits (K,))."""
    K, dev = fenc.shape[0], fenc.device
    blocks = (fenc - pred).reshape(K, 2, 8, 2, 8).transpose(2, 3)
    lv = oquant.quant(odct.dct8x8(blocks).reshape(K, 4, 64), qtab["p8_mf"],
                      qtab["p8_bias"])
    zig8 = torch.as_tensor(tables.ZIGZAG8, device=dev).long()
    if decimate:
        sc = oquant.decimate_score(lv[..., zig8], oquant.DECIMATE_TAB8)
        kill = (sc < 4) | (sc.sum(-1) < 6)[:, None]
        lv = torch.where(kill[..., None], 0, lv)
    nz = (lv != 0).any(-1)
    cbp_bits = (nz * torch.tensor([1, 2, 4, 8], device=dev)).sum(
        -1, dtype=I32)
    deq = oquant.dequant(lv, qtab["p8_dmf"], qtab["py_qpdiv6"], 6)
    res = odct.idct8x8(deq.reshape(K, 2, 2, 8, 8)).transpose(2, 3) \
        .reshape(K, 16, 16)
    recon = (pred + res).clamp(0, 255)
    return recon, lv[..., zig8], cbp_bits


# ---------------------------------------------------------------- K6
# 4x4 cell (row, col) -> its 8x8 quadrant (TL, TR, BL, BR)
QUAD_OF_CELL = ((0, 0, 1, 1), (0, 0, 1, 1), (2, 2, 3, 3), (2, 2, 3, 3))
# partition type -> its partitions as (top, left, height, width) in the MB
PART_RECTS = (((0, 0, 16, 16),),
              ((0, 0, 8, 16), (8, 0, 8, 16)),
              ((0, 0, 16, 8), (0, 8, 16, 8)),
              ((0, 0, 8, 8), (0, 8, 8, 8), (8, 0, 8, 8), (8, 8, 8, 8)))


def _quad(top: int, left: int) -> int:
    return 2 * (top >= 8) + (left >= 8)


def partition_preds(planes, refu_pad, refv_pad, ptype, mv_quad):
    """The inter predictions of every MB (x264_mb_mc, common/macroblock.c:
    1122), as x264_tpu's stage 2 builds them: each partition of each
    layout fetched as one block (mc_luma over the half-pel stack, mc_chroma
    at half the size), the layout picked by ptype (0 16x16, 1 16x8, 2 8x16,
    3 8x8). mv_quad: (mb_h, mb_w, 4, 2) the MV of each 8x8 quadrant; a
    partition takes the MV of its top-left quadrant. Returns (pred_y
    (mb_h,mb_w,16,16), pred_u, pred_v (mb_h,mb_w,8,8))."""
    mb_h, mb_w = ptype.shape
    ys, xs = ome.mb_origins(mb_h, mb_w, planes.device)
    out = None
    for pt, rects in enumerate(PART_RECTS):
        if pt and not (ptype == pt).any():
            continue
        py = torch.empty((mb_h, mb_w, 16, 16), dtype=I32, device=ys.device)
        pu, pv = (torch.empty((mb_h, mb_w, 8, 8), dtype=I32,
                              device=ys.device) for _ in range(2))
        for top, left, bh, bw in rects:
            mv = mv_quad[:, :, _quad(top, left)]
            py[:, :, top:top + bh, left:left + bw] = omc.mc_luma(
                planes, ys + top, xs + left, mv, bh, bw)
            for pc, cpad in ((pu, refu_pad), (pv, refv_pad)):
                pc[:, :, top // 2:(top + bh) // 2,
                   left // 2:(left + bw) // 2] = omc.mc_chroma(
                    cpad, (ys + top) >> 1, (xs + left) >> 1, mv, bh // 2,
                    bw // 2)
        if out is None:
            out = [py, pu, pv]
        else:
            m = (ptype == pt)[..., None, None]
            out = [torch.where(m, new, old) for new, old in
                   zip((py, pu, pv), out)]
    return out


def p_inter_mb_plain(mb_h: int, mb_w: int, y, u, v, planes, refu_pad,
                     refv_pad, ptype, mv_quad, qtab, decimate: bool,
                     t8: int = T8_OFF):
    """Plain version of K6: stage 2 of encode_p_body.

    y / u / v: the MB-aligned source planes; planes: the (P, Hp, Wp)
    half-pel stack of the reference luma (P = 1, the padded plane alone,
    where every MV is full-pel); refu_pad / refv_pad the chroma padded by
    PAD // 2; ptype (mb_h, mb_w) the partition type and mv_quad
    (mb_h, mb_w, 4, 2) the quadrant MVs (partition_preds); t8: T8_OFF,
    T8_SA8D (the 8x8 luma residual too, and the transform of each MB by
    sa8d_16x16 < satd of its prediction, x264_mb_analyse_transform,
    encoder/analyse.c:2109) or T8_RD (both luma residuals, for K13).
    Returns dict(recon_y / _u / _v planes, blocks_z (mb_h,mb_w,16,16), cbp
    (mb_h,mb_w), chroma_dc (mb_h,mb_w,2,4), chroma_ac (mb_h,mb_w,2,4,16));
    with T8_SA8D also blocks8_z (mb_h,mb_w,4,64) and t8_sel (mb_h,mb_w)
    bool, recon_y / blocks_z / cbp then being the chosen coding's
    (blocks_z zero where the 8x8 transform is chosen); with T8_RD also
    blocks8_z, recon8_y (the 8x8 coding's plane) and cbp8, recon_y /
    blocks_z / cbp staying the 4x4 coding's."""
    nK = mb_h * mb_w
    preds = [p.reshape(nK, *p.shape[2:]) for p in
             partition_preds(planes, refu_pad, refv_pad, ptype, mv_quad)]
    pred_y, preds_c = preds[0], preds[1:]
    fenc_c = [_tiles(u, 8), _tiles(v, 8)]
    fenc = _tiles(y, 16)
    ry, blocks_z, cbp = inter_luma_residual(fenc, pred_y, qtab, decimate)
    extra = {}
    if t8 != T8_OFF:
        ry8, blocks8_z, cbp8 = inter_luma_residual8(fenc, pred_y, qtab,
                                                    decimate)
        grid = lambda t: t.reshape(mb_h, mb_w, *t.shape[1:])
        extra["blocks8_z"] = grid(blocks8_z)
        if t8 == T8_SA8D:
            sel = opix.sa8d_16x16(fenc, pred_y) < opix.satd(fenc, pred_y)
            ry = torch.where(sel[:, None, None], ry8, ry)
            blocks_z = torch.where(sel[:, None, None], 0, blocks_z)
            cbp = torch.where(sel, cbp8, cbp)
            extra["t8_sel"] = grid(sel)
        else:
            extra.update(recon8_y=_untiles(ry8, mb_h, mb_w),
                         cbp8=grid(cbp8))
    ac_kill = None
    if decimate:
        # joint two-channel chroma AC decimation (encoder/macroblock.c:
        # 320-332): a score < 7 zeroes the AC of both channels
        csc = sum(oquant.decimate_score(
            intra.chroma_ac_scan(f, p, qtab, "pc")[..., 1:]).sum(-1)
            for f, p in zip(fenc_c, preds_c))
        ac_kill = csc < 7
    ch = [intra.chroma_residual(f, p, qtab, "pc", ac_kill)
          for f, p in zip(fenc_c, preds_c)]
    return dict(
        recon_y=_untiles(ry, mb_h, mb_w),
        recon_u=_untiles(ch[0][0], mb_h, mb_w),
        recon_v=_untiles(ch[1][0], mb_h, mb_w),
        blocks_z=blocks_z.reshape(mb_h, mb_w, 16, 16),
        cbp=cbp.reshape(mb_h, mb_w),
        chroma_dc=torch.stack([ch[0][1], ch[1][1]], 1).reshape(mb_h, mb_w,
                                                               2, 4),
        chroma_ac=torch.stack([ch[0][2], ch[1][2]], 1).reshape(mb_h, mb_w,
                                                               2, 4, 16),
        **extra)


def p_inter_mb(mb_h: int, mb_w: int, y, u, v, planes, refu_pad, refv_pad,
               ptype, mv_quad, qtab, decimate: bool, t8: int = T8_OFF):
    """K6 `p_inter_mb`: the inter residual path of every MB.

    Replaces x264_tpu/ops/mc.py:mc_luma and mc_chroma (the partitioned
    fetch of encode_p_body's stage 2, inter.py:420-494),
    x264_tpu/encoder/inter.py:inter_luma_residual (with decimation),
    inter_luma_residual8 and the SA8D transform choice (t8) and the
    chroma half of stage 2. On CUDA tensors it runs csrc/inter.cu, one
    CTA per MB over the whole frame in one launch; on CPU tensors the
    plain version. Arguments and results as p_inter_mb_plain."""
    if y.device.type == "cpu":
        return p_inter_mb_plain(mb_h, mb_w, y, u, v, planes, refu_pad,
                                refv_pad, ptype, mv_quad, qtab, decimate, t8)
    dev = y.device
    H, W, P = mb_h * 16, mb_w * 16, omc.PAD
    n_planes = planes.shape[0]
    for t, shape, name in (
            (y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
            (v, (H // 2, W // 2), "v"),
            (planes, (n_planes, H + 2 * P, W + 2 * P), "planes"),
            (refu_pad, (H // 2 + P, W // 2 + P), "refu_pad"),
            (refv_pad, (H // 2 + P, W // 2 + P), "refv_pad"),
            (ptype, (mb_h, mb_w), "ptype"),
            (mv_quad, (mb_h, mb_w, 4, 2), "mv_quad")):
        cuda.check(t, shape, I32, name)
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    o = dict(recon_y=e(H, W), recon_u=e(H // 2, W // 2),
             recon_v=e(H // 2, W // 2), blocks_z=e(mb_h, mb_w, 16, 16),
             cbp=e(mb_h, mb_w), chroma_dc=e(mb_h, mb_w, 2, 4),
             chroma_ac=e(mb_h, mb_w, 2, 4, 16))
    # the 8x8 outputs (null pointers where absent)
    if t8 == T8_SA8D:
        o.update(blocks8_z=e(mb_h, mb_w, 4, 64),
                 t8_sel=e(mb_h, mb_w, dt=torch.bool))
    elif t8 == T8_RD:
        o.update(blocks8_z=e(mb_h, mb_w, 4, 64), recon8_y=e(H, W),
                 cbp8=e(mb_h, mb_w))
    ptr = lambda k: o[k].data_ptr() if k in o else 0
    ins = (y, u, v, planes, refu_pad, refv_pad, ptype, mv_quad,
           pack_qtab_p(qtab))
    cuda.launch("inter", "p_inter_mb", "p" * 20 + "iiiii" + "p",
                *[t.data_ptr() for t in ins],
                *[ptr(k) for k in ("recon_y", "recon_u", "recon_v",
                                   "blocks_z", "cbp", "chroma_dc",
                                   "chroma_ac", "blocks8_z", "t8_sel",
                                   "recon8_y", "cbp8")],
                mb_h, mb_w, n_planes, int(decimate), int(t8),
                cuda.stream(dev))
    p_inter_mb.launches += 1
    p_inter_mb.launches_t8_sa8d += int(t8 == T8_SA8D)
    p_inter_mb.launches_t8_rd += int(t8 == T8_RD)
    return o


# launches, and those of them in each t8 mode
p_inter_mb.launches = p_inter_mb.launches_t8_sa8d = \
    p_inter_mb.launches_t8_rd = 0


# ---------------------------------------------------------------- K13
def header_bits(ptype, mv_quad, mvp_seed):
    """The RD ladder's mode / ref / mvd header bits of each MB's inter
    choice (one reference: no ref_idx bits): the mvd bits of the first
    partition (quadrant 0's MV) + 4, and for 16x8 / 8x16 those of the
    second (quadrant 2 / quadrant 1) + 2; P8x8 the four quadrants' + 9."""
    bits = lambda k: ome.mv_cost_bits(mv_quad[:, :, k], mvp_seed)
    p1 = torch.where((ptype == 1)[..., None], mv_quad[:, :, 2],
                     mv_quad[:, :, 1])
    hdr = bits(0) + 4 + torch.where(
        ptype != 0, ome.mv_cost_bits(p1, mvp_seed) + 2, 0)
    return torch.where(ptype == 3, bits(0) + bits(1) + bits(2) + bits(3) + 9,
                       hdr).to(I32)


def rd_inter_plain(mb_h: int, mb_w: int, y, u, v, it: dict, ptype, mv_quad,
                   mvp_seed, qtab):
    """Plain version of K13: the whole-MB inter RD cost of the RD ladder
    (x264_rd_cost_mb, encoder/rdo.c:139), as x264_tpu's encode_p_body
    builds rd_cost_inter (inter.py:498-548, 568-594) with one reference.

    it: K6's outputs (recon_y / _u / _v, blocks_z, cbp, chroma_dc,
    chroma_ac; with the 8x8 transform, K6 at T8_RD, also recon8_y,
    blocks8_z and cbp8); y / u / v the source planes; ptype, mv_quad,
    mvp_seed as K6 and the ME take them; qtab with make_qtab_p's RD
    tables. Returns (rd_cost_inter (mb_h, mb_w) float32, ce_psy (mb_h,
    mb_w) int32, the source's psy AC energy) and, with the 8x8 transform,
    a third item: the chosen luma coding, dict(recon_y, blocks_z (zero
    where 8x8), cbp, t8_sel (mb_h, mb_w) bool), picked per MB by
    x264_mb_analyse_transform_rd's ssd8 + lam2 * bits8 < ssd4 + lam2 *
    bits4 (strictly; encoder/analyse.c:2127), each ssd with its psy term.
    The float steps run in x264_tpu's order:
    ((ssd + psy * |ac_energy(recon) - ce_psy|) + (ssd_u + ssd_v))
    + lam2 * (((bits + cbits) + cdcb) + 256 * hdr_bits)."""
    nK = mb_h * mb_w
    rb, lam2 = qtab["rdbits"], qtab["rd_lam2"]
    psy = qtab.get("psy_rd")
    f = lambda t: t.to(torch.float32)
    yt = _tiles(y, 16)
    ce_psy = opix.ac_energy(yt)

    def luma_ssd(recon):
        rt = _tiles(recon, 16)
        ssd = ordc.ssd_tiles(yt, rt)
        if psy is not None:
            ssd = ssd + psy * (f(opix.ac_energy(rt)) - f(ce_psy)).abs()
        return ssd

    bits = ordc.residual_bits_i32(it["blocks_z"].reshape(-1, 16),
                                  rb["cat2"]).reshape(nK, 16).sum(-1)
    ssd = luma_ssd(it["recon_y"])
    t8 = "recon8_y" in it
    if t8:
        bits8 = ordc.residual_bits_i32(it["blocks8_z"].reshape(-1, 64),
                                       rb["cat5"]).reshape(nK, 4).sum(-1)
        ssd8 = luma_ssd(it["recon8_y"])
        sel = (ssd8 + lam2 * f(bits8)) < (ssd + lam2 * f(bits))
        bits = torch.where(sel, bits8, bits)
        ssd = torch.where(sel, ssd8, ssd)
        grid = lambda t: t.reshape(mb_h, mb_w, *t.shape[1:])
        choice = dict(
            recon_y=_untiles(torch.where(sel[:, None, None],
                                         _tiles(it["recon8_y"], 16),
                                         _tiles(it["recon_y"], 16)),
                             mb_h, mb_w),
            blocks_z=torch.where(grid(sel)[..., None, None], 0,
                                 it["blocks_z"]),
            cbp=torch.where(grid(sel), it["cbp8"], it["cbp"]),
            t8_sel=grid(sel))
    cbits = ordc.residual_bits_i32(it["chroma_ac"].reshape(-1, 16)[:, 1:],
                                   rb["cat4"]).reshape(nK, 8).sum(-1)
    cdcb = ordc.residual_bits_i32(it["chroma_dc"].reshape(-1, 4),
                                  rb["cat3"]).reshape(nK, 2).sum(-1)
    chroma_ssd = (ordc.ssd_tiles(_tiles(u, 8), _tiles(it["recon_u"], 8))
                  + ordc.ssd_tiles(_tiles(v, 8), _tiles(it["recon_v"], 8)))
    hdr = header_bits(ptype, mv_quad, mvp_seed).reshape(nK)
    cost = (ssd + chroma_ssd) \
        + lam2 * (((f(bits) + f(cbits)) + f(cdcb)) + 256.0 * f(hdr))
    out = (cost.reshape(mb_h, mb_w), ce_psy.reshape(mb_h, mb_w))
    return out + (choice,) if t8 else out


def rd_inter(mb_h: int, mb_w: int, y, u, v, it: dict, ptype, mv_quad,
             mvp_seed, qtab):
    """K13 `rd_inter`: the inter RD cost of every MB.

    Replaces the RD stages of x264_tpu/encoder/inter.py:encode_p_body
    that price the inter choice (inter.py:498-548, 568-594:
    rdcost.residual_bits_f8 of the luma (cat 2, and cat 5 for the 8x8
    coding), chroma AC and chroma DC levels, rdcost.ssd_tiles,
    pixel.ac_energy of the psy term, the header bits, and with the 8x8
    transform the RD choice between the two luma codings). On CUDA
    tensors it runs csrc/rdcost.cu, one CTA per MB in one launch; on CPU
    tensors the plain version. Arguments and results as rd_inter_plain."""
    if y.device.type == "cpu":
        return rd_inter_plain(mb_h, mb_w, y, u, v, it, ptype, mv_quad,
                              mvp_seed, qtab)
    dev = y.device
    H, W = mb_h * 16, mb_w * 16
    t8 = "recon8_y" in it
    checks = [
        (y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
        (v, (H // 2, W // 2), "v"), (it["recon_y"], (H, W), "recon_y"),
        (it["recon_u"], (H // 2, W // 2), "recon_u"),
        (it["recon_v"], (H // 2, W // 2), "recon_v"),
        (it["blocks_z"], (mb_h, mb_w, 16, 16), "blocks_z"),
        (it["chroma_dc"], (mb_h, mb_w, 2, 4), "chroma_dc"),
        (it["chroma_ac"], (mb_h, mb_w, 2, 4, 16), "chroma_ac"),
        (ptype, (mb_h, mb_w), "ptype"),
        (mv_quad, (mb_h, mb_w, 4, 2), "mv_quad"),
        (mvp_seed, (mb_h, mb_w, 2), "mvp_seed"),
        (qtab["rdtab"], (ordc.RD_CATS * ordc.RD_CAT_STRIDE,), "rdtab")]
    if t8:
        checks += [(it["recon8_y"], (H, W), "recon8_y"),
                   (it["blocks8_z"], (mb_h, mb_w, 4, 64), "blocks8_z"),
                   (it["cbp"], (mb_h, mb_w), "cbp"),
                   (it["cbp8"], (mb_h, mb_w), "cbp8")]
    for t, shape, name in checks:
        cuda.check(t, shape, I32, name)
    cost = torch.empty((mb_h, mb_w), dtype=torch.float32, device=dev)
    ce_psy = torch.empty((mb_h, mb_w), dtype=I32, device=dev)
    psy = qtab.get("psy_rd")
    ins = (y, u, v, it["recon_y"], it["recon_u"], it["recon_v"],
           it["blocks_z"], it["chroma_dc"], it["chroma_ac"], ptype, mv_quad,
           mvp_seed, qtab["rdtab"], cost, ce_psy)
    if t8:
        choice = dict(recon_y=torch.empty((H, W), dtype=I32, device=dev),
                      blocks_z=torch.empty((mb_h, mb_w, 16, 16), dtype=I32,
                                           device=dev),
                      cbp=torch.empty((mb_h, mb_w), dtype=I32, device=dev),
                      t8_sel=torch.empty((mb_h, mb_w), dtype=torch.bool,
                                         device=dev))
        t8_ptrs = [t.data_ptr() for t in (
            it["recon8_y"], it["blocks8_z"], it["cbp"], it["cbp8"],
            *choice.values())]
    else:
        t8_ptrs = [0] * 8
    # psy off runs as psy 0: ssd4 + 0 * |...| is ssd4 exactly
    cuda.launch("rdcost", "rd_inter", "p" * 23 + "iiffi" + "p",
                *[t.data_ptr() for t in ins], *t8_ptrs, mb_h, mb_w,
                qtab["rd_lam2"], 0.0 if psy is None else psy, int(t8),
                cuda.stream(dev))
    rd_inter.launches += 1
    rd_inter.launches_t8 += int(bool(t8))
    return (cost, ce_psy, choice) if t8 else (cost, ce_psy)


# launches, and those of them with the transform choice
rd_inter.launches = rd_inter.launches_t8 = 0


# ---------------------------------------------------------------- K7
def _up(a, fill=0):
    """Shift an MB grid down one row (row 0 = fill)."""
    return torch.cat([torch.full_like(a[:1], fill), a[:-1]], 0)


def _lf(a, fill=0):
    """Shift an MB grid right one column (column 0 = fill)."""
    return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], 1)


def resolve_intra(choose):
    """The decision pass's demotion: an intra MB stays intra only if its
    left / top / top-left intra dependency chain resolves within
    K_SWEEPS sweeps (x264_tpu encode_p_body stage 3)."""
    resolved = ~choose
    for _ in range(K_SWEEPS):
        resolved = resolved | (choose & _up(resolved, True)
                               & _lf(resolved, True)
                               & _up(_lf(resolved, True), True))
    return choose & resolved


def rd_cost_intra(fenc, fu, fv, lp: dict, cu, cv, qtab, ce_psy):
    """The RD cost of sweep 0's intra candidates (x264_tpu encode_p_body,
    inter.py:677-699): issd + lam2 * (ibits + 256 * 9), where ibits are
    the CABAC bits of the luma DC (cat 0), luma AC (cat 1), chroma AC (cat
    4) and chroma DC (cat 3) levels and issd = ((ssd_y + ssd_u) + ssd_v)
    + psy * |ac_energy(recon) - ce_psy| in float32, in that order. fenc /
    fu / fv: (K, 16, 16) / (K, 8, 8) source tiles; lp, cu, cv: the
    luma_i16_path and chroma_residual results; ce_psy (K,) from K13.
    Returns (K,) float32."""
    K = fenc.shape[0]
    rb, lam2 = qtab["rdbits"], qtab["rd_lam2"]
    psy = qtab.get("psy_rd")
    bits = ordc.residual_bits_i32
    ibits = (bits(lp["dc_z"], rb["cat0"])
             + bits(lp["ac_z"].reshape(-1, 16)[:, 1:], rb["cat1"])
             .reshape(K, 16).sum(-1)
             + bits(torch.cat([cu[2], cv[2]], 1).reshape(-1, 16)[:, 1:],
                    rb["cat4"]).reshape(K, 8).sum(-1)
             + bits(torch.cat([cu[1], cv[1]], 1).reshape(-1, 4),
                    rb["cat3"]).reshape(K, 2).sum(-1))
    issd = (ordc.ssd_tiles(fenc, lp["recon"]) + ordc.ssd_tiles(fu, cu[0])
            + ordc.ssd_tiles(fv, cv[0]))
    if psy is not None:
        issd = issd + psy * (opix.ac_energy(lp["recon"]).to(torch.float32)
                             - ce_psy.to(torch.float32)).abs()
    return issd + lam2 * (ibits.to(torch.float32) + 256.0 * 9)


def intra_in_p_plain(mb_h: int, mb_w: int, y, u, v, inter_y, inter_u,
                     inter_v, cost_inter, qtab, lam: int, decimate: bool,
                     rd=None):
    """Plain version of K7: stage 3 of encode_p_body.

    Sweep 0 runs the I16 + chroma intra path of every MB with neighbours
    from the inter reconstruction (inter_y / _u / _v planes); an MB goes
    intra where its cost + lam * INTRA_PEN_BITS < cost_inter or, under the
    RD ladder (rd = (rd_cost_inter, ce_psy) from K13, with qtab's RD
    tables), where its RD cost cost_i_rd < rd_cost_inter
    (x264_intra_rd, encoder/analyse.c:845; rd_cost_intra); unless its
    intra chain is deeper than K_SWEEPS. Sweeps 1 and 2 re-run the path
    with the sweep-0 modes against the merged reconstruction. Returns
    dict(recon_y / _u / _v (merged planes), intra_mb (mb_h,mb_w) bool,
    and the intra syntax planes, zero on inter MBs: mode16, modec,
    luma_dc (mb_h,mb_w,16), luma_ac (mb_h,mb_w,16,16), chroma_dc
    (mb_h,mb_w,2,4), chroma_ac (mb_h,mb_w,2,4,16))."""
    dev = y.device
    nK = mb_h * mb_w
    grid = lambda t: t.reshape(mb_h, mb_w, *t.shape[1:])
    fenc, fu, fv = _tiles(y, 16), _tiles(u, 8), _tiles(v, 8)
    gy = torch.arange(mb_h, device=dev)[:, None].expand(mb_h, mb_w)
    gx = torch.arange(mb_w, device=dev)[None, :].expand(mb_h, mb_w)
    ht, hl = (gy > 0).reshape(nK), (gx > 0).reshape(nK)
    inter_t = [grid(_tiles(p, n)) for p, n in
               ((inter_y, 16), (inter_u, 8), (inter_v, 8))]

    def nbrs(t):
        n = t.shape[-1] - 1
        return (_up(t)[:, :, n, :].reshape(nK, n + 1),
                _lf(t)[:, :, :, n].reshape(nK, n + 1),
                _lf(_up(t))[:, :, n, n].reshape(nK))

    def eval_intra(ty, tu, tv, mode_sel, cmode_sel):
        lp = intra.luma_i16_path(fenc, *nbrs(ty), ht, hl, qtab, lam,
                                 mode_sel=mode_sel, decimate=decimate)
        pu = opred.predict_8x8c(*nbrs(tu), ht, hl)
        pv = opred.predict_8x8c(*nbrs(tv), ht, hl)
        if cmode_sel is None:
            ccost = torch.where(opred.mode_available_8x8c(ht, hl),
                                opix.satd(fu[:, None], pu)
                                + opix.satd(fv[:, None], pv), _BIG)
            cmode = ccost.argmin(-1).to(I32)
        else:
            cmode = cmode_sel
        cu = intra.chroma_residual(fu, _pick(pu, cmode), qtab, "c")
        cv = intra.chroma_residual(fv, _pick(pv, cmode), qtab, "c")
        return lp, cmode, cu, cv

    state = inter_t
    intra_mb = mode_fix = cmode_fix = None
    for _ in range(K_SWEEPS):
        lp, cmode, cu, cv = eval_intra(*state, mode_fix, cmode_fix)
        if mode_fix is None:
            mode_fix, cmode_fix = lp["mode"], cmode
            if rd is None:
                choose = (lp["cost"] + lam * INTRA_PEN_BITS
                          < cost_inter.reshape(nK)).reshape(mb_h, mb_w)
            else:
                choose = rd_cost_intra(fenc, fu, fv, lp, cu, cv, qtab,
                                       rd[1].reshape(nK)).reshape(
                    mb_h, mb_w) < rd[0]
            intra_mb = resolve_intra(choose)
        m = intra_mb[..., None, None]
        state = [torch.where(m, grid(new), old) for new, old in
                 zip((lp["recon"], cu[0], cv[0]), inter_t)]

    z = lambda t: torch.where(
        intra_mb.reshape(mb_h, mb_w, *([1] * (t.dim() - 2))), t, 0)
    return dict(
        recon_y=_untiles(state[0], mb_h, mb_w),
        recon_u=_untiles(state[1], mb_h, mb_w),
        recon_v=_untiles(state[2], mb_h, mb_w),
        intra_mb=intra_mb,
        mode16=z(grid(lp["mode"])), modec=z(grid(cmode)),
        luma_dc=z(grid(lp["dc_z"])), luma_ac=z(grid(lp["ac_z"])),
        chroma_dc=z(grid(torch.stack([cu[1], cv[1]], 1))),
        chroma_ac=z(grid(torch.stack([cu[2], cv[2]], 1))))


def intra_in_p(mb_h: int, mb_w: int, y, u, v, inter_y, inter_u, inter_v,
               cost_inter, qtab, lam: int, decimate: bool, rd=None):
    """K7 `intra_in_p`: stage 3 of the P encode.

    Replaces the intra-in-P sweeps of x264_tpu/encoder/inter.py:
    encode_p_body (eval_intra with luma_i16_path, predict_8x8c and
    chroma_residual; the decision, SATD-based or, under the RD ladder,
    on the RD costs of both sides with the psy term, inter.py:671-701;
    and the resolved fixpoint). On CUDA tensors it runs
    csrc/intra_p.cu: sweep 0 over every MB (with the intra RD cost under
    rd), the decision with the demotion of deep chains, then sweeps 1
    and 2 (4 launches, one CTA per MB each); on CPU tensors the plain
    version. Arguments and results as intra_in_p_plain."""
    if y.device.type == "cpu":
        return intra_in_p_plain(mb_h, mb_w, y, u, v, inter_y, inter_u,
                                inter_v, cost_inter, qtab, lam, decimate, rd)
    dev = y.device
    H, W = mb_h * 16, mb_w * 16
    for t, shape, name in (
            (y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
            (v, (H // 2, W // 2), "v"), (inter_y, (H, W), "inter_y"),
            (inter_u, (H // 2, W // 2), "inter_u"),
            (inter_v, (H // 2, W // 2), "inter_v"),
            (cost_inter, (mb_h, mb_w), "cost_inter")):
        cuda.check(t, shape, I32, name)
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    o = dict(recon_y=e(H, W), recon_u=e(H // 2, W // 2),
             recon_v=e(H // 2, W // 2),
             intra_mb=e(mb_h, mb_w, dt=torch.bool),
             mode16=e(mb_h, mb_w), modec=e(mb_h, mb_w),
             luma_dc=e(mb_h, mb_w, 16), luma_ac=e(mb_h, mb_w, 16, 16),
             chroma_dc=e(mb_h, mb_w, 2, 4),
             chroma_ac=e(mb_h, mb_w, 2, 4, 16))
    scratch = (e(H, W), e(H // 2, W // 2), e(H // 2, W // 2), e(mb_h, mb_w))
    ins = (y, u, v, inter_y, inter_u, inter_v, cost_inter,
           intra.pack_qtab(qtab))
    if rd is None:
        rd_ptrs, lam2, psy = (0, 0, 0, 0), 0.0, 0.0
    else:
        rd_cost, ce_psy = rd
        cuda.check(rd_cost, (mb_h, mb_w), torch.float32, "rd_cost_inter")
        cuda.check(ce_psy, (mb_h, mb_w), I32, "ce_psy")
        cuda.check(qtab["rdtab"], (ordc.RD_CATS * ordc.RD_CAT_STRIDE,), I32,
                   "rdtab")
        cost_i_rd = e(mb_h, mb_w, dt=torch.float32)      # sweep 0's
        rd_ptrs = (rd_cost.data_ptr(), ce_psy.data_ptr(),
                   qtab["rdtab"].data_ptr(), cost_i_rd.data_ptr())
        lam2, psy = qtab["rd_lam2"], qtab.get("psy_rd", 0.0)
    cuda.launch("intra_p", "intra_in_p", "p" * 26 + "iiiiff" + "p",
                *[t.data_ptr() for t in ins], *[o[k].data_ptr() for k in o],
                *[t.data_ptr() for t in scratch], *rd_ptrs, mb_h, mb_w, lam,
                int(decimate), lam2, psy, cuda.stream(dev))
    intra_in_p.launches += 4           # sweep 0, decision, sweeps 1 and 2
    return o


intra_in_p.launches = 0


# ------------------------------------------------------------ the body
def _block_origins(mb_h: int, mb_w: int, offs, device):
    """Stacked top-left (ys, xs) of one block per (dy, dx) in offs inside
    every MB: (len(offs), mb_h, mb_w) int32 each."""
    ys, xs = ome.mb_origins(mb_h, mb_w, device)
    return (torch.stack([ys + dy for dy, _ in offs]),
            torch.stack([xs + dx for _, dx in offs]))


# the batched partition refinements of stage 1b: (block height, width,
# the blocks' offsets in the MB, their rows of partition_fullpel's result)
PART_LAYOUTS = ((8, 16, ((0, 0), (8, 0)), (0, 2)),
                (16, 8, ((0, 0), (0, 8)), (2, 4)),
                (8, 8, ((0, 0), (0, 8), (8, 0), (8, 8)), (4, 8)))
# lambda * bits of each layout's mb_type beyond the 16x16's one bit: ue(1)
# and ue(2) of 16x8 / 8x16 are 3 bits, P8x8's ue(3) 5 bits plus four
# one-bit sub_mb_types
PART_TYPE_BITS = (3, 3, 9)


def partition_search(y, ref_pad, planes, mv_fp, mv16, cost16, lam: int,
                     mvp_seed, me_range: int, steps, p8x8: bool):
    """Stage 1b (inter_p16x8 / p8x16 / p8x8, encoder/analyse.c:1222-1404):
    the full-pel window search of the partitions (K11), one batched
    sub-pel refinement per layout (K10), and each MB's partition type of
    least cost among [16x16, 16x8, 8x16, 8x8]. Returns (ptype, cost_inter,
    mv_quad (mb_h, mb_w, 4, 2) the MV of each 8x8 quadrant)."""
    mb_h, mb_w = mv_fp.shape[:2]
    pf = ome.partition_fullpel(y, ref_pad, mv_fp, lam, mvp_seed, me_range,
                               p8x8)
    costs, mvs = [cost16], []
    for (bh, bw, offs, (a, b)), extra in zip(
            PART_LAYOUTS[:3 if p8x8 else 2], PART_TYPE_BITS):
        ys, xs = _block_origins(mb_h, mb_w, offs, y.device)
        mvp = mvp_seed.expand(len(offs), mb_h, mb_w, 2).contiguous()
        mv, satd = ome.subpel_refine_blocks(y, planes, pf[a:b], lam, mvp,
                                            ys, xs, bh, bw, steps)
        costs.append(satd.sum(0, dtype=I32) + lam * (
            ome.mv_cost_bits(mv, mvp).sum(0, dtype=I32) + extra))
        mvs.append(mv)
    costs = torch.stack(costs)
    ptype = costs.argmin(0).to(I32)
    cost_inter = costs.gather(0, ptype[None].long())[0]
    # quadrant MVs of each layout: 16x8 [t t b b], 8x16 [l r l r]; no
    # index tensor, whose copy to the card would block the host
    layouts = [mv16[:, :, None].expand(mb_h, mb_w, 4, 2),
               mvs[0].repeat_interleave(2, 0).permute(1, 2, 0, 3),
               mvs[1].repeat(2, 1, 1, 1).permute(1, 2, 0, 3)]
    if p8x8:
        layouts.append(mvs[2].permute(1, 2, 0, 3))
    mv_quad = layouts[0]
    for pt in range(1, len(layouts)):
        mv_quad = torch.where((ptype == pt)[..., None, None], layouts[pt],
                              mv_quad)
    return ptype, cost_inter, mv_quad.contiguous()


def encode_p_front(mb_h: int, mb_w: int, me_range: int, y, u, v, ref_y,
                   ref_u, ref_v, qtab, lam: int, mvp_seed, decimate: bool,
                   subpel_steps=(), parts: bool = False, p8x8: bool = False,
                   chroma_me: bool = False, rd: bool = False,
                   t8: bool = False) -> dict:
    """Stages 1-3 of the P encode through kernels K5 and K9-K12 (ME), K6,
    K13 (under rd) and K7, and the merges of stage 4 (plain tensor glue).
    All planes int32 and MB-aligned; ref_* the deblocked reference
    reconstruction; mvp_seed (mb_h, mb_w, 2) the qpel ME predictors.
    subpel_steps: () at subme 1, (2,) at subme 2-3, (2, 1) at subme >= 4;
    parts / p8x8: the 16x8 / 8x16 and 8x8 partitions (only with sub-pel
    steps, as in x264_tpu); chroma_me: the chroma re-rank of subme >= 5;
    rd: the RD ladder of subme >= 6 (qtab with make_qtab_p's RD tables);
    t8: the adaptive 8x8 transform (the choice by SA8D in K6, or by RD in
    K13). Returns the merged syntax planes, the merged pre-deblock
    reconstruction, the 16x16 MV (me_mv), the partition type and the
    quadrant MVs; with t8 also t8_sel (each MB's transform choice) and
    luma8_z (the 8x8 coding's levels of every MB)."""
    ref_pad = omc.pad_plane(ref_y.to(I32))
    refu_pad = omc.pad_plane(ref_u.to(I32), omc.PAD // 2)
    refv_pad = omc.pad_plane(ref_v.to(I32), omc.PAD // 2)
    mv_fp, sad = ome.hier_search(y, ref_pad, mb_h, mb_w, me_range, lam,
                                 mvp_seed)
    if subpel_steps:
        planes = omc.hpel_planes(ref_pad)
        mv, satd = ome.subpel_refine(y, planes, mv_fp, lam, mvp_seed,
                                     subpel_steps)
        if chroma_me:
            mv, satd = ome.chroma_rerank(y, planes, u, v, refu_pad,
                                         refv_pad, mv, lam, mvp_seed, satd)
    else:          # subme 1: full-pel only, plane 0 alone
        planes, mv, satd = ref_pad[None], mv_fp, sad
    cost16 = satd + lam * (ome.mv_cost_bits(mv, mvp_seed) + 1)
    if parts and subpel_steps:
        ptype, cost_inter, mv_quad = partition_search(
            y, ref_pad, planes, mv_fp, mv, cost16, lam, mvp_seed, me_range,
            subpel_steps, p8x8)
    else:
        ptype = torch.zeros((mb_h, mb_w), dtype=I32, device=y.device)
        cost_inter = cost16
        mv_quad = mv[:, :, None].expand(mb_h, mb_w, 4, 2).contiguous()
    it = p_inter_mb(mb_h, mb_w, y, u, v, planes, refu_pad, refv_pad, ptype,
                    mv_quad, qtab, decimate,
                    (T8_RD if rd else T8_SA8D) if t8 else T8_OFF)
    rd_costs = None
    if rd:
        rd_costs = rd_inter(mb_h, mb_w, y, u, v, it, ptype, mv_quad,
                            mvp_seed, qtab)
        if t8:                 # the RD choice between the two codings
            it = {**it, **rd_costs[2]}
            rd_costs = rd_costs[:2]
    ip = intra_in_p(mb_h, mb_w, y, u, v, it["recon_y"], it["recon_u"],
                    it["recon_v"], cost_inter, qtab, lam, decimate, rd_costs)
    im = ip["intra_mb"]
    luma_blocks = torch.where(im[..., None, None], ip["luma_ac"],
                              it["blocks_z"])
    chroma_dc = torch.where(im[..., None, None], ip["chroma_dc"],
                            it["chroma_dc"])
    chroma_ac = torch.where(im[..., None, None, None], ip["chroma_ac"],
                            it["chroma_ac"])
    cbp_i16 = (ip["luma_ac"] != 0).any(-1).any(-1)
    cbp_luma_bits = torch.where(im, torch.where(cbp_i16, 15, 0),
                                it["cbp"]).to(I32)
    cnz_ac = (chroma_ac != 0).reshape(mb_h, mb_w, -1).any(-1)
    cnz_dc = (chroma_dc != 0).reshape(mb_h, mb_w, -1).any(-1)
    cbp_chroma = torch.where(cnz_ac, 2, torch.where(cnz_dc, 1, 0)).to(I32)
    out = dict(recon_y=ip["recon_y"], recon_u=ip["recon_u"],
               recon_v=ip["recon_v"], intra_mb=im, mode16=ip["mode16"],
               modec=ip["modec"], luma_dc=ip["luma_dc"],
               luma_blocks=luma_blocks, chroma_dc=chroma_dc,
               chroma_ac=chroma_ac, cbp_luma_bits=cbp_luma_bits,
               cbp_chroma=cbp_chroma, me_mv=mv, ptype=ptype,
               mv_quad=mv_quad)
    if t8:
        out.update(t8_sel=it["t8_sel"], luma8_z=it["blocks8_z"])
    return out


def p_maps_plain(front: dict, mb_h: int, mb_w: int) -> dict:
    """Stage 4's syntax maps (plain half of kernel K8's first pass): the
    final per-4x4 ref / mv maps (intra: ref -1, mv 0), exact MV
    prediction on them (predict_16x16, predict_pskip and, per partition,
    predict_16x8 / predict_8x16 / predict_p8x8), P_Skip (ptype 0 only),
    the mvds (mvd, mvd1 of the second 16x8 / 8x16 partition, mvd_sub of
    the 8x8 sub-blocks) and their per-4x4 map (0 on skip and intra MBs),
    and the nnz map the deblocker and the cbf contexts read. With the 8x8
    transform (front holds t8_sel and luma8_z) also t8_mb, the effective
    map: the 8x8 choice of inter MBs that are not skipped and have coded
    luma (an MB without coded luma decodes as 4x4); each 4x4 cell of such
    an MB carries its 8x8 block's count in nnz4."""
    dev = front["intra_mb"].device
    im = front["intra_mb"]
    im1, im2 = im[..., None], im[..., None, None]
    pt = torch.where(im, 0, front["ptype"]).to(I32)
    mv = torch.where(im1, 0, front["me_mv"]).to(I32)
    mvq = torch.where(im2, 0, front["mv_quad"]).to(I32)
    rep = lambda t: t.repeat_interleave(4, 0).repeat_interleave(4, 1)
    ref4 = rep(torch.where(im, -1, 0).to(I32))
    quad = torch.as_tensor(QUAD_OF_CELL, device=dev).long()
    mv4 = mvq[:, :, quad].transpose(1, 2).reshape(mb_h * 4, mb_w * 4, 2)
    mvp16 = mvpred.predict_16x16(ref4, mv4)
    mv_skip = mvpred.predict_pskip(ref4, mv4)
    mvp_t, mvp_b = mvpred.predict_16x8(ref4, mv4)
    mvp_l, mvp_r = mvpred.predict_8x16(ref4, mv4)
    mvp_sub = torch.stack(mvpred.predict_p8x8(ref4, mv4), 2)
    is1, is2, is8 = (pt == 1)[..., None], (pt == 2)[..., None], pt == 3
    mv_p0 = mvq[:, :, 0]
    mv_p1 = torch.where(is1, mvq[:, :, 2], mvq[:, :, 1])
    mvd = torch.where(is1, mv_p0 - mvp_t,
                      torch.where(is2, mv_p0 - mvp_l, mv - mvp16))
    mvd1 = torch.where(is1, mv_p1 - mvp_b, torch.where(is2, mv_p1 - mvp_r, 0))
    mvd = torch.where(im1 | is8[..., None], 0, mvd).to(I32)
    mvd1 = torch.where(is8[..., None], 0, mvd1).to(I32)
    mvd_sub = torch.where(is8[..., None, None], mvq - mvp_sub, 0).to(I32)
    mv_sub = torch.where(is8[..., None, None], mvq, 0).to(I32)
    cbp_l = front["cbp_luma_bits"]
    skip = ~im & (pt == 0) & (cbp_l == 0) & (front["cbp_chroma"] == 0) \
        & (mv == mv_skip).all(-1)
    # per-4x4 mvd: the second partition's cells take mvd1, P8x8's cells
    # their sub-block's mvd_sub; skip and intra MBs cache 0
    br = torch.arange(4, device=dev)
    in_p1 = ((pt == 1)[..., None, None] & (br[:, None] >= 2)) \
        | ((pt == 2)[..., None, None] & (br[None, :] >= 2))
    mvd_blk = torch.where(in_p1[..., None], mvd1[:, :, None, None],
                          mvd[:, :, None, None])
    mvd_blk = torch.where(is8[..., None, None, None], mvd_sub[:, :, quad],
                          mvd_blk)
    mvd_blk = torch.where((skip | im)[..., None, None, None], 0, mvd_blk)
    mvd4 = mvd_blk.transpose(1, 2).reshape(mb_h * 4, mb_w * 4, 2).to(I32)
    nnz_cnt = (front["luma_blocks"] != 0).sum(-1, dtype=I32)   # z-scan
    grp = torch.arange(16, dtype=I32, device=dev) // 4
    blk_coded = (cbp_l[..., None] >> grp) & 1
    nnz_z = nnz_cnt * blk_coded
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    nnz_r = torch.zeros_like(nnz_z)
    nnz_r[..., R] = nnz_z
    t8 = {}
    if "t8_sel" in front:
        t8_mb = front["t8_sel"] & ~im & ~skip & (cbp_l > 0)
        cnt8 = (front["luma8_z"] != 0).sum(-1, dtype=I32)      # (h, w, 4)
        cell = torch.as_tensor(cabac_planes.CELL_8X8, device=dev).long()
        nnz_r = torch.where(t8_mb[..., None], cnt8[..., cell], nnz_r)
        t8["t8_mb"] = t8_mb
    nnz4 = nnz_r.reshape(mb_h, mb_w, 4, 4).transpose(1, 2) \
        .reshape(mb_h * 4, mb_w * 4)
    return dict(mv=mv, mvd=mvd, mvd1=mvd1, ptype=pt, mv_sub=mv_sub,
                mvd_sub=mvd_sub, mvd4=mvd4, skip=skip, nnz4=nnz4, ref4=ref4,
                mv4=mv4, **t8)


def encode_p_body(mb_h: int, mb_w: int, me_range: int, y, u, v, ref_y,
                  ref_u, ref_v, qtab, lam: int, mvp_seed, decimate: bool,
                  subpel_steps=(), parts: bool = False, p8x8: bool = False,
                  chroma_me: bool = False, rd: bool = False,
                  t8: bool = False) -> dict:
    """One P frame (pre-deblock) with the keys of x264_tpu's
    encode_p_body(subpel_steps, parts, p8x8, chroma_me, n_refs=1, t8, rd,
    qp_map=None): stages 1-3 (encode_p_front) and the syntax maps
    (p_maps_plain). The card's pipeline runs the maps inside kernel K8
    instead (entropy/cabac_planes.py:cabac_p_ops)."""
    front = encode_p_front(mb_h, mb_w, me_range, y, u, v, ref_y, ref_u,
                           ref_v, qtab, lam, mvp_seed, decimate,
                           subpel_steps, parts, p8x8, chroma_me, rd, t8)
    out = dict(front, **p_maps_plain(front, mb_h, mb_w))
    for k in ("me_mv", "mv_quad", "t8_sel"):
        out.pop(k, None)
    # without the 8x8 transform its fields stay zero, as the reference
    # field does with one reference
    z = lambda *s, dt=I32: torch.zeros(s, dtype=dt, device=y.device)
    if not t8:
        out.update(t8_mb=z(mb_h, mb_w, dt=torch.bool),
                   luma8_z=z(mb_h, mb_w, 4, 64))
    out["ref_idx"] = z(mb_h, mb_w)
    return out

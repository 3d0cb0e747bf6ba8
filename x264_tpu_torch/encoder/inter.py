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

With --ref 2 (L0[1], the reference before the last) stage 1 runs K5
against both references, picks each MB's reference at full-pel, and
every later kernel fetches from it (x264_tpu's ref_sel); every partition
of an MB carries its reference. The QP is the frame's or, under variance
AQ, each MB's own (qp_map): K6 and K7 then read the MB's rows of the
52-QP stacks of encoder/aq.py:qtab_stacks (K6 the inter tables, K7 the
intra ones), while lambda and the RD tables stay the frame's. With the
CABAC trellis (analyse.i_trellis) the inter residual's quant is the
trellis (ops/trellis.py; in K6 csrc/trellis.cuh), with the frame QP's
consts (trellis_consts) or the MB's rows of the 52-QP stacks
(trellis_stacks); the intra-in-P sweeps keep the deadzone quant.
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
from ..ops import trellis as otrellis
from . import intra
from . import mvpred
from .intra import _BIG, _blocks4, _pick, _q16, _qc, _unblocks4, _zig

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
QTABP_LAYOUT = ((QTAB_P_VEC_KEYS, 16), (QTAB_P_SCALAR_KEYS, 1),
                (QTAB_P_VEC8_KEYS, 64))
QTABP_INTS = sum(len(keys) * n for keys, n in QTABP_LAYOUT)
# K6's t8 argument: no 8x8 transform; the SA8D choice made in K6 (below
# subme 6); both codings written for K13's RD choice (subme >= 6)
T8_OFF, T8_SA8D, T8_RD = 0, 1, 2


# the trellis consts of the inter residual in qtab (key, category, CQM
# list), in the order K6's table packs them (csrc/trellis.cuh's TR_CAT*):
# luma 4x4, chroma AC, chroma DC, luma 8x8
TRELLIS_QTAB = (("trellis", 2, tables.CQM_4PY),
                ("trellis_pc", 4, tables.CQM_4PC),
                ("trellis_pc_dc", 3, tables.CQM_4PC),
                ("trellis8", 5, tables.CQM_8PY))
K6_TRELLIS_INTS = sum(otrellis.trellis_ints(int(otrellis.CAT_C[c]))
                      for _, c, _ in TRELLIS_QTAB)


def trellis_consts(qp_y: int, qp_c: int, cabac_init_idc: int, device,
                   qt: tables.QuantTables | None = None) -> dict:
    """The trellis consts of a P frame at one QP (x264_tpu's
    Encoder._qtab_p, core.py:808-816): the luma categories at qp_y, the
    chroma ones with qp_c's quant tables and lambda2, every category's
    CABAC states at the slice QP qp_y; and trellis_tab, the four packed
    as K6 reads them."""
    out = {}
    for key, cat, lst in TRELLIS_QTAB:
        q = qp_y if cat in (2, 5) else qp_c
        out[key] = otrellis._as_torch(otrellis.make_consts(
            q, cat, lst, False, cabac_init_idc, qt=qt, state_qp=qp_y), device)
    out["trellis_tab"] = torch.cat([otrellis.pack_trellis(out[k], device)
                                    for k, _, _ in TRELLIS_QTAB])
    return out


def trellis_stacks(cabac_init_idc: int, chroma_qp_offset: int, device,
                   qt: tables.QuantTables | None = None) -> dict:
    """The trellis consts under a QP map (x264_tpu's _trellis_full,
    core.py:791-807): each category's make_consts_all_qp stack (each row
    with its own QP's states and lambda2), trellis_qpc_of (52,) the
    chroma QP row of each luma QP, CHROMA_QP_TABLE[clip(q +
    chroma_qp_offset, 0, 51)], and trellis_tab (52, K6_TRELLIS_INTS): row
    q packs the luma categories at q and the chroma ones at q's chroma
    QP, so that K6 reads an MB's row by its luma QP."""
    qc = torch.as_tensor(np.asarray(tables.CHROMA_QP_TABLE, np.int64)[
        np.clip(np.arange(52) + chroma_qp_offset, 0, 51)], device=device)
    out = dict(trellis_qpc_of=qc)
    packs = []
    for key, cat, lst in TRELLIS_QTAB:
        out[key] = otrellis._as_torch(otrellis.make_consts_all_qp(
            cat, lst, False, cabac_init_idc, qt=qt), device)
        pk = otrellis.pack_trellis(out[key], device)
        packs.append(pk if cat in (2, 5) else pk[qc])
    out["trellis_tab"] = torch.cat(packs, 1).contiguous()
    return out


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
    return intra.pack_rows(qtab, QTABP_LAYOUT)


def mb_rows(qtab: dict, qp_map, inter_tabs: bool) -> dict:
    """qtab with the per-MB rows of the flat (nK,) MBs of qp_map from its
    52-QP stack ("aq_stack_p" inter, "aq_stack" intra) in place of the
    frame's tables."""
    flat = qp_map.reshape(-1).long()
    if inter_tabs:
        return {**qtab, **intra.unpack_rows(qtab["aq_stack_p"][flat],
                                            QTABP_LAYOUT)}
    return {**qtab, **intra.unpack_qtab(qtab["aq_stack"][flat])}


def _tiles(plane, n: int):
    """(mb_h*n, mb_w*n) -> (mb_h*mb_w, n, n) in raster MB order."""
    h, w = plane.shape
    return plane.to(I32).reshape(h // n, n, w // n, n).transpose(1, 2) \
        .reshape(-1, n, n)


def _untiles(tiles, mb_h: int, mb_w: int):
    n = tiles.shape[-1]
    return tiles.reshape(mb_h, mb_w, n, n).transpose(1, 2) \
        .reshape(mb_h * n, mb_w * n)


def inter_luma_residual(fenc, pred, qtab, decimate: bool = False,
                        lossless: bool = False, nr_offset=None):
    """Inter 16x16 luma residual of K MBs: 16 4x4 DCT blocks, P-matrix
    quant (x264_macroblock_encode P path, encoder/macroblock.c:538-616).
    decimate: an 8x8 group scoring < 4 is zeroed, and the whole MB when
    the total scores < 6 (encoder/macroblock.c:700-730).
    fenc / pred: (K, 16, 16). Returns (recon (K,16,16), blocks_z
    (K,16,16) zig-zag in z-scan block order, cbp_bits (K,)). lossless:
    the transform bypass (x264_tpu inter.py:106-117), the residual
    samples as levels, the recon the source. nr_offset: (16,) the noise
    reduction's offsets (x264_tpu inter.py:119-121), which shrink every
    AC coefficient before the quant; the result then also holds the
    pre-shrink |coef| (K, 16, 16), raster blocks, raster positions: K26's
    input (ops/quant.py:nr_sums)."""
    K, dev = fenc.shape[0], fenc.device
    zig = _zig(dev)
    zorder = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    w = torch.tensor([[1, 2], [4, 8]], dtype=I32, device=dev)
    if lossless:
        lv = _blocks4(fenc - pred, 4).reshape(K, 16, 16)
        grp = (lv != 0).any(-1).reshape(K, 2, 2, 2, 2).any(-3).any(-1)
        return (fenc.clamp(0, 255), lv[:, zorder][:, :, zig],
                (grp * w).sum((-2, -1), dtype=I32))
    coef = odct.dct4x4(_blocks4(fenc - pred, 4))       # (K,4,4,4,4)
    nr_abs = None
    if nr_offset is not None:
        nr_abs = coef.reshape(K, 16, 16).abs()
        coef = oquant.nr_shrink(coef.reshape(K, 16, 16), nr_offset) \
            .reshape(coef.shape)
    if qtab.get("trellis") is not None:
        # the CABAC trellis in place of the deadzone quant (x264_tpu
        # inter.py:123-133; x264_quant_4x4's b_trellis switch,
        # encoder/macroblock.c:87-95): cat 2 in zig-zag, then decimation
        lv = otrellis.trellis_scan_plain(
            coef.reshape(K * 16, 16)[:, zig], qtab["trellis"],
            intra._trellis_rows(qtab, "trellis_qp", 16))
        lv = lv[:, torch.argsort(zig)].reshape(K, 16, 16)
    else:
        lv = oquant.quant(coef.reshape(K, 16, 16), _q16(qtab["py_mf"]),
                          _q16(qtab["py_bias"]))       # raster blocks
    if decimate:
        s = oquant.decimate_score(lv[..., zig])        # (K,16)
        # raster block (row, col) -> 8x8 group (row // 2, col // 2)
        g = s.reshape(K, 2, 2, 2, 2).sum((-3, -1))     # (K,2,2)
        kill_g = (g < 4) | (g.sum((-2, -1)) < 6)[:, None, None]
        kill = kill_g.repeat_interleave(2, -2).repeat_interleave(2, -1)
        lv = torch.where(kill.reshape(K, 16, 1), 0, lv)
    grp = (lv != 0).any(-1).reshape(K, 2, 2, 2, 2).any(-3).any(-1)
    cbp_bits = (grp * w).sum((-2, -1), dtype=I32)
    deq = oquant.dequant(lv, _q16(qtab["py_dmf"]), _qc(qtab["py_qpdiv6"], 2),
                         4)
    res = odct.idct4x4(deq.reshape(K, 4, 4, 4, 4))
    recon = (pred + _unblocks4(res, 4)).clamp(0, 255)
    out = (recon, lv[:, zorder][:, :, zig], cbp_bits)
    return out if nr_abs is None else out + (nr_abs,)


def inter_luma_residual8(fenc, pred, qtab, decimate: bool = False,
                         nr_offset=None):
    """Inter 16x16 luma residual with the 8x8 transform of K MBs
    (x264_macroblock_encode's b_transform_8x8 branch,
    encoder/macroblock.c:538-558): four 8x8 DCT blocks, CQM_8PY quant.
    decimate: an 8x8 block scoring < 4 on DECIMATE_TAB8 is zeroed, and
    the whole MB when the total scores < 6 (encoder/macroblock.c:
    643-667). fenc / pred: (K, 16, 16). Returns (recon (K,16,16),
    blocks8_z (K,4,64) in 8x8 scan order, 2x2 raster block order,
    cbp_bits (K,)); with nr_offset (64,) (x264_tpu inter.py:178-180) the
    coefficients are shrunk first and the result also holds their
    pre-shrink |coef| (K, 4, 64)."""
    K, dev = fenc.shape[0], fenc.device
    blocks = (fenc - pred).reshape(K, 2, 8, 2, 8).transpose(2, 3)
    coef = odct.dct8x8(blocks).reshape(K, 4, 64)
    nr_abs = None
    if nr_offset is not None:
        nr_abs = coef.abs()
        coef = oquant.nr_shrink(coef, nr_offset)
    zig8 = torch.as_tensor(tables.ZIGZAG8, device=dev).long()
    if qtab.get("trellis8") is not None:
        # the 8x8 trellis (x264_tpu inter.py:182-192): cat 5 in ZIGZAG8;
        # it is the decimation itself, so none follows
        # (encoder/macroblock.c:630)
        lv = otrellis.trellis_scan_plain(
            coef.reshape(K * 4, 64)[:, zig8], qtab["trellis8"],
            intra._trellis_rows(qtab, "trellis_qp", 4))
        lv = lv[:, torch.argsort(zig8)].reshape(K, 4, 64)
        decimate = False
    else:
        lv = oquant.quant(coef, _q16(qtab["p8_mf"]), _q16(qtab["p8_bias"]))
    if decimate:
        sc = oquant.decimate_score(lv[..., zig8], oquant.DECIMATE_TAB8)
        kill = (sc < 4) | (sc.sum(-1) < 6)[:, None]
        lv = torch.where(kill[..., None], 0, lv)
    nz = (lv != 0).any(-1)
    cbp_bits = (nz * torch.tensor([1, 2, 4, 8], device=dev)).sum(
        -1, dtype=I32)
    deq = oquant.dequant(lv, _q16(qtab["p8_dmf"]), _qc(qtab["py_qpdiv6"], 2),
                         6)
    res = odct.idct8x8(deq.reshape(K, 2, 2, 8, 8)).transpose(2, 3) \
        .reshape(K, 16, 16)
    recon = (pred + res).clamp(0, 255)
    out = (recon, lv[..., zig8], cbp_bits)
    return out if nr_abs is None else out + (nr_abs,)


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


def partition_preds(planes, refu_pad, refv_pad, ptype, mv_quad,
                    ref_sel=None):
    """The inter predictions of every MB (x264_mb_mc, common/macroblock.c:
    1122), as x264_tpu's stage 2 builds them: each partition of each
    layout fetched as one block (mc_luma over the half-pel stack, mc_chroma
    at half the size), the layout picked by ptype (0 16x16, 1 16x8, 2 8x16,
    3 8x8). mv_quad: (mb_h, mb_w, 4, 2) the MV of each 8x8 quadrant; a
    partition takes the MV of its top-left quadrant. ref_sel: (mb_h, mb_w)
    each MB's reference (every partition carries it), the planes then the
    multi-reference stacks of mc_luma / mc_chroma. Returns (pred_y
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
                planes, ys + top, xs + left, mv, bh, bw, ref_sel)
            for pc, cpad in ((pu, refu_pad), (pv, refv_pad)):
                pc[:, :, top // 2:(top + bh) // 2,
                   left // 2:(left + bw) // 2] = omc.mc_chroma(
                    cpad, (ys + top) >> 1, (xs + left) >> 1, mv, bh // 2,
                    bw // 2, ref_sel)
        if out is None:
            out = [py, pu, pv]
        else:
            m = (ptype == pt)[..., None, None]
            out = [torch.where(m, new, old) for new, old in
                   zip((py, pu, pv), out)]
    return out


def p_inter_mb_plain(mb_h: int, mb_w: int, y, u, v, planes, refu_pad,
                     refv_pad, ptype, mv_quad, qtab, decimate: bool,
                     t8: int = T8_OFF, qp_map=None, ref_sel=None,
                     lossless: bool = False, nr_offset4=None,
                     nr_offset8=None):
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
    blocks_z / cbp staying the 4x4 coding's. qp_map: (mb_h, mb_w) per-MB
    QPs (variance AQ), each MB's inter tables then the rows of qtab's
    "aq_stack_p". ref_sel: (mb_h, mb_w) each MB's reference under two
    references, planes / refu_pad / refv_pad then partition_preds'
    stacks. lossless: the transform bypass of the luma and chroma
    residuals (the caller turns decimation off). nr_offset4 / nr_offset8:
    (16,) / (64,) int32 offsets of the noise reduction (x264_denoise_dct)
    on the 4x4 / 8x8 luma coefficients of every MB; the result then also
    holds nr_sum4 / nr_sum8, the (16,) / (64,) float32 sums of their
    pre-shrink |coef| in x264_tpu's order (ops/quant.py:nr_sums_plain)."""
    nK = mb_h * mb_w
    if qp_map is not None:
        qtab = mb_rows(qtab, qp_map, True)
        if "trellis_qpc_of" in qtab:
            # each MB's rows of the 52-QP trellis stacks (x264_tpu
            # inter.py:258-261): luma by qp_map, chroma by its chroma QP
            rows = qp_map.reshape(-1).long()
            qtab.update(trellis_qp=rows,
                        trellis_qpc=qtab["trellis_qpc_of"][rows])
    preds = [p.reshape(nK, *p.shape[2:]) for p in
             partition_preds(planes, refu_pad, refv_pad, ptype, mv_quad,
                             ref_sel)]
    pred_y, preds_c = preds[0], preds[1:]
    fenc_c = [_tiles(u, 8), _tiles(v, 8)]
    fenc = _tiles(y, 16)
    grid = lambda t: t.reshape(mb_h, mb_w, *t.shape[1:])
    r4 = inter_luma_residual(fenc, pred_y, qtab, decimate, lossless,
                             nr_offset4)
    ry, blocks_z, cbp = r4[:3]
    extra = {}
    if nr_offset4 is not None:
        extra["nr_sum4"] = oquant.nr_sums_plain(grid(r4[3]))
    if t8 != T8_OFF:
        r8 = inter_luma_residual8(fenc, pred_y, qtab, decimate, nr_offset8)
        ry8, blocks8_z, cbp8 = r8[:3]
        if nr_offset8 is not None:
            extra["nr_sum8"] = oquant.nr_sums_plain(grid(r8[3]))
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
    ch = [intra.chroma_residual(f, p, qtab, "pc", ac_kill, lossless)
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
               ptype, mv_quad, qtab, decimate: bool, t8: int = T8_OFF,
               qp_map=None, ref_sel=None, lossless: bool = False,
               nr_offset4=None, nr_offset8=None):
    """K6 `p_inter_mb`: the inter residual path of every MB.

    Replaces x264_tpu/ops/mc.py:mc_luma and mc_chroma (the partitioned
    fetch of encode_p_body's stage 2, inter.py:420-494),
    x264_tpu/encoder/inter.py:inter_luma_residual (with decimation),
    inter_luma_residual8 and the SA8D transform choice (t8) and the
    chroma half of stage 2, with per-MB tables under a QP map, the
    lossless bypass (inter.py:106-117, chroma intra.py:172-181) and the
    noise reduction's shrink (inter.py:119-121, :178-180; its sums then
    come from K26, ops/quant.py:nr_sums). On CUDA tensors it runs
    csrc/inter.cu, one CTA per MB over the whole frame in one launch
    (under two references each CTA fetches from its MB's reference); on
    CPU tensors the plain version. Arguments and results as
    p_inter_mb_plain."""
    if y.device.type == "cpu":
        return p_inter_mb_plain(mb_h, mb_w, y, u, v, planes, refu_pad,
                                refv_pad, ptype, mv_quad, qtab, decimate, t8,
                                qp_map, ref_sel, lossless, nr_offset4,
                                nr_offset8)
    dev = y.device
    H, W, P = mb_h * 16, mb_w * 16, omc.PAD
    n_planes = planes.shape[0]
    cshape = (H // 2 + P, W // 2 + P)
    checks = [(y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
              (v, (H // 2, W // 2), "v"),
              (planes, (n_planes, H + 2 * P, W + 2 * P), "planes"),
              (ptype, (mb_h, mb_w), "ptype"),
              (mv_quad, (mb_h, mb_w, 4, 2), "mv_quad")]
    if ref_sel is not None:
        # the stacks of both references: 4 half-pel planes each
        if n_planes != 8:
            raise ValueError("p_inter_mb: two references take the 8 "
                             "half-pel planes of both")
        n_planes, cshape = 4, (2,) + cshape
        checks.append((ref_sel, (mb_h, mb_w), "ref_sel"))
    checks += [(refu_pad, cshape, "refu_pad"), (refv_pad, cshape, "refv_pad")]
    for t, shape, name in checks:
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
    if qp_map is None:
        tab, qp_ptr = pack_qtab_p(qtab), 0
    else:
        tab = qtab["aq_stack_p"]
        cuda.check(tab, (52, QTABP_INTS), I32, "aq_stack_p")
        cuda.check(qp_map, (mb_h, mb_w), I32, "qp_map")
        qp_ptr = qp_map.data_ptr()
    # the trellis's table: the frame's, or under a QP map the 52-QP stack
    trellis = qtab.get("trellis_tab")
    if trellis is not None:
        cuda.check(trellis, (K6_TRELLIS_INTS,) if qp_map is None
                   else (52, K6_TRELLIS_INTS), I32, "trellis_tab")
    # the noise reduction: the offsets in, each block's pre-shrink |coef|
    # out for K26 (the 8x8 ones only with the 8x8 transform)
    nr = {}
    for key, off, shape in (("nr_sum4", nr_offset4, (16, 16)),
                            ("nr_sum8", nr_offset8 if t8 != T8_OFF else None,
                             (4, 64))):
        if off is not None:
            cuda.check(off, shape[-1:], I32, key)
            nr[key] = (off, e(mb_h, mb_w, *shape))
    nr_ptr = lambda key, i: nr[key][i].data_ptr() if key in nr else 0
    ins = (y, u, v, planes, refu_pad, refv_pad, ptype, mv_quad, tab)
    cuda.launch("inter", "p_inter_mb", "p" * 27 + "i" * 6 + "p",
                *[t.data_ptr() for t in ins],
                *[ptr(k) for k in ("recon_y", "recon_u", "recon_v",
                                   "blocks_z", "cbp", "chroma_dc",
                                   "chroma_ac", "blocks8_z", "t8_sel",
                                   "recon8_y", "cbp8")],
                qp_ptr, 0 if trellis is None else trellis.data_ptr(),
                0 if ref_sel is None else ref_sel.data_ptr(),
                nr_ptr("nr_sum4", 0), nr_ptr("nr_sum8", 0),
                nr_ptr("nr_sum4", 1), nr_ptr("nr_sum8", 1), mb_h, mb_w,
                n_planes, int(decimate), int(t8), int(lossless),
                cuda.stream(dev))
    for key, (_, coef_abs) in nr.items():
        o[key] = oquant.nr_sums(coef_abs)
    p_inter_mb.launches += 1
    p_inter_mb.launches_nr += int(nr_offset4 is not None)
    p_inter_mb.launches_lossless += int(lossless)
    p_inter_mb.launches_ref2 += int(ref_sel is not None)
    p_inter_mb.launches_trellis += int(trellis is not None)
    p_inter_mb.launches_t8_sa8d += int(t8 == T8_SA8D)
    p_inter_mb.launches_t8_rd += int(t8 == T8_RD)
    p_inter_mb.launches_aq += int(qp_map is not None)
    return o


# launches, and those of them in each t8 mode, with a QP map, with the
# trellis, with two references, with the noise reduction and with the
# lossless bypass
p_inter_mb.launches = p_inter_mb.launches_t8_sa8d = \
    p_inter_mb.launches_t8_rd = p_inter_mb.launches_aq = \
    p_inter_mb.launches_trellis = p_inter_mb.launches_ref2 = \
    p_inter_mb.launches_nr = p_inter_mb.launches_lossless = 0


# ---------------------------------------------------------------- K13
def header_bits(ptype, mv_quad, mvp_seed, ref_sel=None):
    """The RD ladder's mode / ref / mvd header bits of each MB's inter
    choice (x264_tpu inter.py:583-590): the mvd bits of the first
    partition (quadrant 0's MV) + 4, and for 16x8 / 8x16 those of the
    second (quadrant 2 / quadrant 1) + 2; P8x8 the four quadrants' + 9.
    ref_sel: each MB's reference under two references, whose ref_idx
    costs one bit a partition on reference 1 (ref_bits)."""
    rb = 0 if ref_sel is None else ref_sel
    bits = lambda k: ome.mv_cost_bits(mv_quad[:, :, k], mvp_seed)
    p1 = torch.where((ptype == 1)[..., None], mv_quad[:, :, 2],
                     mv_quad[:, :, 1])
    hdr = bits(0) + 4 + rb + torch.where(
        ptype != 0, ome.mv_cost_bits(p1, mvp_seed) + 2 + rb, 0)
    return torch.where(ptype == 3, bits(0) + bits(1) + bits(2) + bits(3) + 9
                       + 4 * rb, hdr).to(I32)


def rd_inter_plain(mb_h: int, mb_w: int, y, u, v, it: dict, ptype, mv_quad,
                   mvp_seed, qtab, ref_sel=None):
    """Plain version of K13: the whole-MB inter RD cost of the RD ladder
    (x264_rd_cost_mb, encoder/rdo.c:139), as x264_tpu's encode_p_body
    builds rd_cost_inter (inter.py:498-548, 568-594); ref_sel, each MB's
    reference under two references, adds its ref_idx bits to the header.

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
    hdr = header_bits(ptype, mv_quad, mvp_seed, ref_sel).reshape(nK)
    cost = (ssd + chroma_ssd) \
        + lam2 * (((f(bits) + f(cbits)) + f(cdcb)) + 256.0 * f(hdr))
    out = (cost.reshape(mb_h, mb_w), ce_psy.reshape(mb_h, mb_w))
    return out + (choice,) if t8 else out


def rd_inter(mb_h: int, mb_w: int, y, u, v, it: dict, ptype, mv_quad,
             mvp_seed, qtab, ref_sel=None):
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
                              mvp_seed, qtab, ref_sel)
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
    if ref_sel is not None:
        checks.append((ref_sel, (mb_h, mb_w), "ref_sel"))
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
    cuda.launch("rdcost", "rd_inter", "p" * 24 + "iiffi" + "p",
                *[t.data_ptr() for t in ins], *t8_ptrs,
                0 if ref_sel is None else ref_sel.data_ptr(), mb_h, mb_w,
                qtab["rd_lam2"], 0.0 if psy is None else psy, int(t8),
                cuda.stream(dev))
    rd_inter.launches += 1
    rd_inter.launches_t8 += int(bool(t8))
    rd_inter.launches_ref2 += int(ref_sel is not None)
    return (cost, ce_psy, choice) if t8 else (cost, ce_psy)


# launches, and those of them with the transform choice and with two
# references
rd_inter.launches = rd_inter.launches_t8 = rd_inter.launches_ref2 = 0


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
                     rd=None, qp_map=None, intra_mb=None,
                     decide_only: bool = False, lossless: bool = False):
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
    (mb_h,mb_w,2,4), chroma_ac (mb_h,mb_w,2,4,16)). qp_map: (mb_h, mb_w)
    per-MB QPs (variance AQ), each MB's intra tables then the rows of
    qtab's "aq_stack". lossless: the I16 and chroma paths take the
    transform bypass (x264_tpu inter.py:634, :654); the decision keeps its
    SATD costs.

    The B frame's two uses (x264_tpu encode_b_body): decide_only returns
    sweep 0's decision alone, the intra_mb (mb_h, mb_w) bool plane (stage
    3); intra_mb given fixes the decision, and the three sweeps run with
    sweep 0 choosing the modes (stage 3.7, cost_inter unused)."""
    dev = y.device
    nK = mb_h * mb_w
    if qp_map is not None:
        qtab = mb_rows(qtab, qp_map, False)
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
                                 mode_sel=mode_sel, decimate=decimate,
                                 lossless=lossless)
        pu = opred.predict_8x8c(*nbrs(tu), ht, hl)
        pv = opred.predict_8x8c(*nbrs(tv), ht, hl)
        if cmode_sel is None:
            ccost = torch.where(opred.mode_available_8x8c(ht, hl),
                                opix.satd(fu[:, None], pu)
                                + opix.satd(fv[:, None], pv), _BIG)
            cmode = ccost.argmin(-1).to(I32)
        else:
            cmode = cmode_sel
        cu = intra.chroma_residual(fu, _pick(pu, cmode), qtab, "c",
                                   lossless=lossless)
        cv = intra.chroma_residual(fv, _pick(pv, cmode), qtab, "c",
                                   lossless=lossless)
        return lp, cmode, cu, cv

    state = inter_t
    mode_fix = cmode_fix = None
    for _ in range(K_SWEEPS):
        lp, cmode, cu, cv = eval_intra(*state, mode_fix, cmode_fix)
        if mode_fix is None:
            mode_fix, cmode_fix = lp["mode"], cmode
            if intra_mb is None:
                if rd is None:
                    choose = (lp["cost"] + lam * INTRA_PEN_BITS
                              < cost_inter.reshape(nK)).reshape(mb_h, mb_w)
                else:
                    choose = rd_cost_intra(fenc, fu, fv, lp, cu, cv, qtab,
                                           rd[1].reshape(nK)).reshape(
                        mb_h, mb_w) < rd[0]
                intra_mb = resolve_intra(choose)
                if decide_only:
                    return intra_mb
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


# the widest frame K7's decision takes (csrc/intra_p.cu MAX_MB_W)
MAX_MB_W = 512


def _check_intra_args(mb_h: int, mb_w: int, y, u, v, inter_y, inter_u,
                      inter_v, cost_inter=None) -> None:
    """Raise unless K7's planes are contiguous int32 CUDA tensors of the
    frame's shapes, the inter planes 16-byte aligned (the merge copies
    them 4 samples a thread), and the frame is at most MAX_MB_W MBs
    wide."""
    if mb_w > MAX_MB_W:
        raise ValueError(f"K7 takes frames up to {MAX_MB_W} MBs wide, got "
                         f"{mb_w}")
    H, W = mb_h * 16, mb_w * 16
    for t, shape, name in (
            (y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
            (v, (H // 2, W // 2), "v"), (inter_y, (H, W), "inter_y"),
            (inter_u, (H // 2, W // 2), "inter_u"),
            (inter_v, (H // 2, W // 2), "inter_v"),
            (cost_inter, (mb_h, mb_w), "cost_inter")):
        if t is not None:
            cuda.check(t, shape, I32, name)
    if any(t.data_ptr() % 16 for t in (inter_y, inter_u, inter_v)):
        raise ValueError("K7: the inter planes must start 16-byte aligned")


def intra_in_p(mb_h: int, mb_w: int, y, u, v, inter_y, inter_u, inter_v,
               cost_inter, qtab, lam: int, decimate: bool, rd=None,
               qp_map=None, lossless: bool = False):
    """K7 `intra_in_p`: stage 3 of the P encode.

    Replaces the intra-in-P sweeps of x264_tpu/encoder/inter.py:
    encode_p_body (eval_intra with luma_i16_path, predict_8x8c and
    chroma_residual; the decision, SATD-based or, under the RD ladder,
    on the RD costs of both sides with the psy term, inter.py:671-701;
    and the resolved fixpoint; the lossless bypass of the I16 and chroma
    paths, inter.py:634, :654). On CUDA tensors it runs
    csrc/intra_p.cu: sweep 0 over every MB (with the intra RD cost under
    rd), the decision a thread an MB, which lists the intra MBs on the
    card and gives the others the inter recon and zero syntax, then
    sweeps 1 and 2 over that list alone (4 launches, no host sync), with
    per-MB tables under a QP map; on CPU tensors the plain version.
    Frames up to MAX_MB_W MBs wide. Arguments and results as
    intra_in_p_plain."""
    if y.device.type == "cpu":
        return intra_in_p_plain(mb_h, mb_w, y, u, v, inter_y, inter_u,
                                inter_v, cost_inter, qtab, lam, decimate, rd,
                                qp_map, lossless=lossless)
    _check_intra_args(mb_h, mb_w, y, u, v, inter_y, inter_u, inter_v,
                      cost_inter)
    dev = y.device
    H, W = mb_h * 16, mb_w * 16
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    o = dict(recon_y=e(H, W), recon_u=e(H // 2, W // 2),
             recon_v=e(H // 2, W // 2),
             intra_mb=e(mb_h, mb_w, dt=torch.bool),
             mode16=e(mb_h, mb_w), modec=e(mb_h, mb_w),
             luma_dc=e(mb_h, mb_w, 16), luma_ac=e(mb_h, mb_w, 16, 16),
             chroma_dc=e(mb_h, mb_w, 2, 4),
             chroma_ac=e(mb_h, mb_w, 2, 4, 16))
    # plane B of the sweeps, sweep 0's costs, the intra list
    scratch = (e(H, W), e(H // 2, W // 2), e(H // 2, W // 2), e(mb_h, mb_w),
               e(mb_h * mb_w + 1))
    if qp_map is None:
        tab, qp_ptr = intra.pack_qtab(qtab), 0
    else:
        tab = qtab["aq_stack"]
        cuda.check(tab, (52, intra.QTAB_INTS), I32, "aq_stack")
        cuda.check(qp_map, (mb_h, mb_w), I32, "qp_map")
        qp_ptr = qp_map.data_ptr()
    ins = (y, u, v, inter_y, inter_u, inter_v, cost_inter, tab)
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
    cuda.launch("intra_p", "intra_in_p", "p" * 28 + "iiiiffi" + "p",
                *[t.data_ptr() for t in ins], *[o[k].data_ptr() for k in o],
                *[t.data_ptr() for t in scratch], *rd_ptrs, qp_ptr, mb_h,
                mb_w, lam, int(decimate), lam2, psy, int(lossless),
                cuda.stream(dev))
    intra_in_p.launches += 4           # sweep 0, decision, sweeps 1 and 2
    intra_in_p.launches_aq += 4 * int(qp_map is not None)
    intra_in_p.launches_lossless += 4 * int(lossless)
    return o


# launches, and those of them with a QP map and with the lossless bypass
intra_in_p.launches = intra_in_p.launches_aq = \
    intra_in_p.launches_lossless = 0


# ------------------------------------------------------------ the body
# the partition refinements of stage 1b (ops/me.py)
PART_LAYOUTS = ome.PART_LAYOUTS
# lambda * bits of each layout's mb_type beyond the 16x16's one bit: ue(1)
# and ue(2) of 16x8 / 8x16 are 3 bits, P8x8's ue(3) 5 bits plus four
# one-bit sub_mb_types
PART_TYPE_BITS = (3, 3, 9)


def partition_search(y, ref_pad, planes, mv_fp, mv16, cost16, lam: int,
                     mvp_seed, me_range: int, steps, p8x8: bool,
                     ref_sel=None):
    """Stage 1b (inter_p16x8 / p8x16 / p8x8, encoder/analyse.c:1222-1404):
    the full-pel window search of the partitions (K11), the sub-pel
    refinement of every layout in one K10 launch, and each MB's partition
    type of least cost among [16x16, 16x8, 8x16, 8x8]. ref_sel: each MB's
    reference under two references (ref_pad / planes then the stacks of
    both), which every partition of the MB carries and pays one ref_idx
    bit for on reference 1. Returns (ptype, cost_inter, mv_quad (mb_h,
    mb_w, 4, 2) the MV of each 8x8 quadrant)."""
    mb_h, mb_w = mv_fp.shape[:2]
    pf = ome.partition_fullpel(y, ref_pad, mv_fp, lam, mvp_seed, me_range,
                               p8x8, ref_sel)
    costs, mvs = [cost16], []
    for (mv, satd), extra in zip(
            ome.subpel_refine_parts(y, planes, pf, lam, mvp_seed, steps,
                                    ref_sel), PART_TYPE_BITS):
        n = mv.shape[0]
        bits = ome.mv_cost_bits(mv, mvp_seed).sum(0, dtype=I32) + extra
        if ref_sel is not None:
            bits = bits + n * ref_sel
        costs.append(satd.sum(0, dtype=I32) + lam * bits)
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


def merge_intra(ip: dict, it: dict, mb_h: int, mb_w: int) -> dict:
    """The merged syntax planes of a P or B frame (x264_tpu stage 3's
    tail): the intra sweeps' planes ip where intra_mb, the inter
    residual's it elsewhere, and the coded block patterns of both."""
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
    return dict(recon_y=ip["recon_y"], recon_u=ip["recon_u"],
                recon_v=ip["recon_v"], intra_mb=im, mode16=ip["mode16"],
                modec=ip["modec"], luma_dc=ip["luma_dc"],
                luma_blocks=luma_blocks, chroma_dc=chroma_dc,
                chroma_ac=chroma_ac, cbp_luma_bits=cbp_luma_bits,
                cbp_chroma=cbp_chroma)


def encode_p_front(mb_h: int, mb_w: int, me_range: int, y, u, v, ref_y,
                   ref_u, ref_v, qtab, lam: int, mvp_seed, decimate: bool,
                   subpel_steps=(), parts: bool = False, p8x8: bool = False,
                   chroma_me: bool = False, rd: bool = False,
                   t8: bool = False, qp_map=None, ref2=None,
                   lossless: bool = False, nr_offset4=None,
                   nr_offset8=None, ref_prepadded: bool = False) -> dict:
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
    luma8_z (the 8x8 coding's levels of every MB). qp_map: per-MB QPs
    (variance AQ) for K6 and K7, qtab then holding the 52-QP stacks
    "aq_stack_p" and "aq_stack". ref2: the older reference L0[1] as (y,
    u, v) for two references (x264_tpu's n_refs=2, inter.py:275-292): K5
    runs against each, each MB takes the reference of least SAD + lambda *
    (MV bits + its ref_idx bit) at full-pel (ties stay on reference 0),
    and every later kernel fetches from the MB's reference (the result's
    ref_sel, (mb_h, mb_w) int32). lossless: the transform bypass of K6 and
    K7, with decimation and the RD ladder off (x264_tpu inter.py:497-498).
    nr_offset4 / nr_offset8: the noise reduction's offsets for K6 (the
    8x8's with t8); the result then holds nr_sum4 / nr_sum8 (K26).
    ref_prepadded: the reference planes (and ref2's) already carry their
    PAD (luma) / PAD // 2 (chroma) border, whose top and bottom rows are
    a neighbour band's real rows in the MB-row sharded path (K28,
    parallel/rows.py; x264_tpu inter.py:270-316), so no pad is added."""
    decimate = decimate and not lossless
    rd = rd and not lossless

    def pad(t, n=omc.PAD):
        return t.to(I32) if ref_prepadded else omc.pad_plane(t.to(I32), n)

    ref_pad = pad(ref_y)
    refu_pad = pad(ref_u, omc.PAD // 2)
    refv_pad = pad(ref_v, omc.PAD // 2)
    mv_fp, sad = ome.hier_search(y, ref_pad, mb_h, mb_w, me_range, lam,
                                 mvp_seed)
    sel, ref_bits = None, 0
    if ref2 is not None:
        ref2_pad = pad(ref2[0])
        mv_fp2, sad2 = ome.hier_search(y, ref2_pad, mb_h, mb_w, me_range,
                                       lam, mvp_seed)
        c_r0 = sad + lam * ome.mv_cost_bits(mv_fp, mvp_seed)
        c_r1 = sad2 + lam * (ome.mv_cost_bits(mv_fp2, mvp_seed) + 1)
        sel = ref_bits = (c_r1 < c_r0).to(I32)
        mv_fp = torch.where((sel == 1)[..., None], mv_fp2, mv_fp)
        sad = torch.where(sel == 1, sad2, sad)
        # the stacks both references are read through
        refu_pad, refv_pad = (
            torch.stack([c, pad(r, omc.PAD // 2)])
            for c, r in ((refu_pad, ref2[1]), (refv_pad, ref2[2])))
        ref_pad = torch.stack([ref_pad, ref2_pad])
    if subpel_steps or sel is not None:
        planes = omc.hpel_planes(ref_pad) if sel is None else torch.cat(
            [omc.hpel_planes(ref_pad[0]), omc.hpel_planes(ref_pad[1])])
    else:          # subme 1, one reference: full-pel only, plane 0 alone
        planes = ref_pad[None]
    if subpel_steps:
        mv, satd = ome.subpel_refine(y, planes, mv_fp, lam, mvp_seed,
                                     subpel_steps, sel)
        if chroma_me:
            mv, satd = ome.chroma_rerank(y, planes, u, v, refu_pad,
                                         refv_pad, mv, lam, mvp_seed, satd,
                                         sel)
    else:
        mv, satd = mv_fp, sad
    cost16 = satd + lam * (ome.mv_cost_bits(mv, mvp_seed) + 1 + ref_bits)
    if parts and subpel_steps:
        ptype, cost_inter, mv_quad = partition_search(
            y, ref_pad, planes, mv_fp, mv, cost16, lam, mvp_seed, me_range,
            subpel_steps, p8x8, sel)
    else:
        ptype = torch.zeros((mb_h, mb_w), dtype=I32, device=y.device)
        cost_inter = cost16
        mv_quad = mv[:, :, None].expand(mb_h, mb_w, 4, 2).contiguous()
    it = p_inter_mb(mb_h, mb_w, y, u, v, planes, refu_pad, refv_pad, ptype,
                    mv_quad, qtab, decimate,
                    (T8_RD if rd else T8_SA8D) if t8 else T8_OFF, qp_map,
                    ref_sel=sel, lossless=lossless, nr_offset4=nr_offset4,
                    nr_offset8=nr_offset8 if t8 else None)
    rd_costs = None
    if rd:
        rd_costs = rd_inter(mb_h, mb_w, y, u, v, it, ptype, mv_quad,
                            mvp_seed, qtab, ref_sel=sel)
        if t8:                 # the RD choice between the two codings
            it = {**it, **rd_costs[2]}
            rd_costs = rd_costs[:2]
    ip = intra_in_p(mb_h, mb_w, y, u, v, it["recon_y"], it["recon_u"],
                    it["recon_v"], cost_inter, qtab, lam, decimate, rd_costs,
                    qp_map, lossless=lossless)
    out = dict(merge_intra(ip, it, mb_h, mb_w), me_mv=mv, ptype=ptype,
               mv_quad=mv_quad)
    for k in ("nr_sum4", "nr_sum8"):
        if k in it:
            out[k] = it[k]
    if t8:
        out.update(t8_sel=it["t8_sel"], luma8_z=it["blocks8_z"])
    if sel is not None:
        out["ref_sel"] = sel
    return out


def p_maps_plain(front: dict, mb_h: int, mb_w: int) -> dict:
    """Stage 4's syntax maps (plain half of kernel K8's first pass): the
    final per-4x4 ref / mv maps (intra: ref -1, mv 0), exact MV
    prediction on them (predict_16x16, predict_pskip and, per partition,
    predict_16x8 / predict_8x16 / predict_p8x8, each with the MB's own
    reference as i_ref), P_Skip (ptype 0 on reference 0 only),
    the mvds (mvd, mvd1 of the second 16x8 / 8x16 partition, mvd_sub of
    the 8x8 sub-blocks) and their per-4x4 map (0 on skip and intra MBs),
    and the nnz map the deblocker and the cbf contexts read. With the 8x8
    transform (front holds t8_sel and luma8_z) also t8_mb, the effective
    map: the 8x8 choice of inter MBs that are not skipped and have coded
    luma (an MB without coded luma decodes as 4x4); each 4x4 cell of such
    an MB carries its 8x8 block's count in nnz4. Under two references
    (front holds ref_sel) ref_idx is each MB's reference (0 on intra MBs)
    and ref4 carries it."""
    dev = front["intra_mb"].device
    im = front["intra_mb"]
    im1, im2 = im[..., None], im[..., None, None]
    pt = torch.where(im, 0, front["ptype"]).to(I32)
    mv = torch.where(im1, 0, front["me_mv"]).to(I32)
    mvq = torch.where(im2, 0, front["mv_quad"]).to(I32)
    rep = lambda t: t.repeat_interleave(4, 0).repeat_interleave(4, 1)
    ref_idx = torch.zeros((mb_h, mb_w), dtype=I32, device=dev)
    if "ref_sel" in front:
        ref_idx = torch.where(im, 0, front["ref_sel"]).to(I32)
    ref4 = rep(torch.where(im, -1, ref_idx).to(I32))
    quad = torch.as_tensor(QUAD_OF_CELL, device=dev).long()
    mv4 = mvq[:, :, quad].transpose(1, 2).reshape(mb_h * 4, mb_w * 4, 2)
    mvp16 = mvpred.predict_16x16(ref4, mv4, ref_idx)
    mv_skip = mvpred.predict_pskip(ref4, mv4)
    mvp_t, mvp_b = mvpred.predict_16x8(ref4, mv4, ref_idx)
    mvp_l, mvp_r = mvpred.predict_8x16(ref4, mv4, ref_idx)
    mvp_sub = torch.stack(mvpred.predict_p8x8(ref4, mv4, ref_idx), 2)
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
    # P_Skip implies ref_idx 0 (spec 8.4.1.1): a ref-1 MB never skips
    skip = ~im & (pt == 0) & (cbp_l == 0) & (front["cbp_chroma"] == 0) \
        & (ref_idx == 0) & (mv == mv_skip).all(-1)
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
                mv4=mv4, ref_idx=ref_idx, **t8)


def encode_p_body(mb_h: int, mb_w: int, me_range: int, y, u, v, ref_y,
                  ref_u, ref_v, qtab, lam: int, mvp_seed, decimate: bool,
                  subpel_steps=(), parts: bool = False, p8x8: bool = False,
                  chroma_me: bool = False, rd: bool = False,
                  t8: bool = False, qp_map=None, ref2=None,
                  lossless: bool = False, nr_offset4=None,
                  nr_offset8=None) -> dict:
    """One P frame (pre-deblock) with the keys of x264_tpu's
    encode_p_body(subpel_steps, parts, lossless, p8x8, chroma_me, n_refs,
    t8, rd, qp_map), n_refs 2 where ref2 (L0[1] as (y, u, v)) is given,
    lossless gating decimation and RD off, and with nr_offset4 / 8 the
    noise reduction (qtab's nr_offset4 / 8, and nr_sum4 / 8 out): stages
    1-3 (encode_p_front) and the syntax maps (p_maps_plain). The card's
    pipeline runs the maps inside kernel K8 instead
    (entropy/cabac_planes.py:cabac_p_ops)."""
    front = encode_p_front(mb_h, mb_w, me_range, y, u, v, ref_y, ref_u,
                           ref_v, qtab, lam, mvp_seed, decimate,
                           subpel_steps, parts, p8x8, chroma_me, rd, t8,
                           qp_map, ref2, lossless, nr_offset4, nr_offset8)
    out = dict(front, **p_maps_plain(front, mb_h, mb_w))
    for k in ("me_mv", "mv_quad", "t8_sel", "ref_sel"):
        out.pop(k, None)
    # without the 8x8 transform its fields stay zero, as the reference
    # field does with one reference
    z = lambda *s, dt=I32: torch.zeros(s, dtype=dt, device=y.device)
    if not t8:
        out.update(t8_mb=z(mb_h, mb_w, dt=torch.bool),
                   luma8_z=z(mb_h, mb_w, 4, 64))
    return out


# ------------------------------------------------------------ B frames
# The B frame of x264_tpu's encode_b_body (inter.py:866-1224), the B
# ladder of x264_mb_analyse_b (encoder/analyse.c b16x16:1549,
# direct:1515): 16x16 L0 / L1 / BI, B_Direct_16x16 / B_SKIP by spatial
# direct, and I16x16, one reference per list, at the frame's QP (x264_tpu
# runs B frames without AQ). Staged as x264_tpu stages it:
# 1. ME on each list with its own seed (K5, K9, K10);
# 1'-2. the L0 / L1 / BI predictions, the mode decision and residual pass 1
#    (K22 pass 1);
# 3. the intra decision against pass 1's reconstruction (K7, two launches);
# 3.5. spatial direct: the provisional derivation, its cost, and the exact
#    slope-2 wavefront that commits it (K23);
# 3.6. residual pass 2 on the final prediction (K22 pass 2);
# 3.7. the three intra sweeps against pass 2's reconstruction (K7, three
#    launches);
# 4. the per-list maps, MV prediction, skip and the op stream (K24).
# B slices always decimate (b_decimate, encoder/macroblock.c:479).

# lambda * bits of the B mb_types beyond the MV bits: L0 / L1 ue(1) and
# ue(2) are 3 bits, BI ue(3) 5
B_TYPE_BITS = (3, 3, 5)


def _exp4(a):
    """MB grid -> 4x4-block grid."""
    return a.repeat_interleave(4, 0).repeat_interleave(4, 1)


def b_list_fetch(ref_y, ref_u, ref_v, ref_prepadded: bool = False):
    """One list's reference as the B stages read it: (the half-pel stack of
    the luma padded by PAD (K9), the chroma padded by PAD // 2); with
    ref_prepadded the planes carry their border already (K28)."""
    if ref_prepadded:
        ref_pad, cu, cv = (t.to(I32) for t in (ref_y, ref_u, ref_v))
    else:
        ref_pad = omc.pad_plane(ref_y.to(I32))
        cu, cv = (omc.pad_plane(t.to(I32), omc.PAD // 2)
                  for t in (ref_u, ref_v))
    return (omc.hpel_planes(ref_pad), cu, cv), ref_pad


def _b_preds(fetch, mv, mb_h: int, mb_w: int):
    """One list's 16x16 luma and 8x8 chroma predictions of every MB at the
    per-MB MVs mv (mb_h, mb_w, 2)."""
    planes, cu, cv = fetch
    ys, xs = ome.mb_origins(mb_h, mb_w, planes.device)
    return (omc.mc_luma(planes, ys, xs, mv, 16, 16),
            omc.mc_chroma(cu, ys >> 1, xs >> 1, mv, 8, 8),
            omc.mc_chroma(cv, ys >> 1, xs >> 1, mv, 8, 8))


def _b_residual(mb_h: int, mb_w: int, y, u, v, preds, qtab, ac_decim: bool):
    """The inter residual of the B predictions preds = (luma (mb_h, mb_w,
    16, 16), u, v (mb_h, mb_w, 8, 8)): luma with decimation, chroma with
    the joint AC decimation where ac_decim (pass 2; pass 1 has none)."""
    nK = mb_h * mb_w
    py, pu, pv = (p.reshape(nK, *p.shape[2:]) for p in preds)
    fenc_c = [_tiles(u, 8), _tiles(v, 8)]
    ry, blocks_z, cbp = inter_luma_residual(_tiles(y, 16), py, qtab, True)
    ac_kill = None
    if ac_decim:
        ac_kill = sum(oquant.decimate_score(
            intra.chroma_ac_scan(f, p, qtab, "pc")[..., 1:]).sum(-1)
            for f, p in zip(fenc_c, (pu, pv))) < 7
    ch = [intra.chroma_residual(f, p, qtab, "pc", ac_kill)
          for f, p in zip(fenc_c, (pu, pv))]
    return dict(
        recon_y=_untiles(ry, mb_h, mb_w),
        recon_u=_untiles(ch[0][0], mb_h, mb_w),
        recon_v=_untiles(ch[1][0], mb_h, mb_w),
        blocks_z=blocks_z.reshape(mb_h, mb_w, 16, 16),
        cbp=cbp.reshape(mb_h, mb_w),
        chroma_dc=torch.stack([ch[0][1], ch[1][1]], 1).reshape(mb_h, mb_w,
                                                               2, 4),
        chroma_ac=torch.stack([ch[0][2], ch[1][2]], 1).reshape(mb_h, mb_w,
                                                               2, 4, 16))


def _pick_pred(p0, p1, use0, use1):
    """The B prediction: the rounding average where both lists are used,
    else the one list's (use0 / use1 (mb_h, mb_w) bool)."""
    bi = (use0 & use1)[..., None, None]
    return torch.where(bi, omc.avg(p0, p1),
                       torch.where(use0[..., None, None], p0, p1))


def b_inter_mb_plain(mb_h: int, mb_w: int, y, u, v, fetch0, fetch1, qtab,
                     mv0, mv1, satd=None, seeds=None, lam: int = 0,
                     refs=None) -> dict:
    """Plain version of K22, the inter residual of a B frame, in its two
    passes (x264_tpu encode_b_body).

    Pass 1 (satd = (satd0, satd1) and seeds = (seed0, seed1) given; mv0 /
    mv1 each list's ME result): the L0 / L1 / BI predictions, the decision
    argmin(satd + lam * (mv bits + 3 | 3 | 5)) (ties to L0, then L1, BI
    the rounding average's SATD with both lists' MV bits) and the
    residual of the chosen prediction, decimated, chroma without the AC
    decimation (stages 1-2, inter.py:935-963). Returns dict(bmode,
    cost_inter (mb_h, mb_w), recon_y / _u / _v).
    Pass 2 (refs = (r0, r1), the final per-MB references, -1 where a list
    is unused; mv0 / mv1 the final per-MB MVs): the final prediction and
    its residual with the joint chroma AC decimation (stage 3.6,
    inter.py:1103-1135). Returns the keys of p_inter_mb_plain without the
    8x8 transform.
    fetch0 / fetch1: each list's (half-pel stack, padded u, padded v)."""
    a, b = _b_preds(fetch0, mv0, mb_h, mb_w), _b_preds(fetch1, mv1, mb_h,
                                                        mb_w)
    if refs is not None:
        use0, use1 = refs[0] >= 0, refs[1] >= 0
        preds = [_pick_pred(p, q, use0, use1) for p, q in zip(a, b)]
        return _b_residual(mb_h, mb_w, y, u, v, preds, qtab, True)
    nK = mb_h * mb_w
    satd_bi = opix.satd(_tiles(y, 16), omc.avg(a[0], b[0]).reshape(
        nK, 16, 16)).reshape(mb_h, mb_w)
    bits0 = ome.mv_cost_bits(mv0, seeds[0])
    bits1 = ome.mv_cost_bits(mv1, seeds[1])
    costs = torch.stack([satd[0] + lam * (bits0 + B_TYPE_BITS[0]),
                         satd[1] + lam * (bits1 + B_TYPE_BITS[1]),
                         satd_bi + lam * (bits0 + bits1 + B_TYPE_BITS[2])])
    bmode = costs.argmin(0).to(I32)
    use0, use1 = bmode != 1, bmode != 0
    preds = [_pick_pred(p, q, use0, use1) for p, q in zip(a, b)]
    out = _b_residual(mb_h, mb_w, y, u, v, preds, qtab, False)
    return dict(bmode=bmode, cost_inter=costs.amin(0).to(I32),
                recon_y=out["recon_y"], recon_u=out["recon_u"],
                recon_v=out["recon_v"])


def b_inter_mb(mb_h: int, mb_w: int, y, u, v, fetch0, fetch1, qtab, mv0,
               mv1, satd=None, seeds=None, lam: int = 0, refs=None) -> dict:
    """K22 `b_inter_mb`: the inter residual of every MB of a B frame, pass
    1 or pass 2 (see b_inter_mb_plain).

    Replaces x264_tpu/ops/mc.py:mc_luma / mc_chroma / avg as
    encode_b_body calls them, the BI SATD and the B mode decision
    (inter.py:923-951), and inter_luma_residual and chroma_residual on the
    chosen (pass 1, inter.py:958-963) or final (pass 2, :1103-1135)
    prediction, with the trellis where qtab has it. On CUDA tensors it
    runs csrc/inter.cu's B kernel, one CTA per MB in one launch; on CPU
    tensors the plain version. Arguments and results as
    b_inter_mb_plain."""
    if y.device.type == "cpu":
        return b_inter_mb_plain(mb_h, mb_w, y, u, v, fetch0, fetch1, qtab,
                                mv0, mv1, satd, seeds, lam, refs)
    dev = y.device
    H, W, P = mb_h * 16, mb_w * 16, omc.PAD
    pass2 = refs is not None
    checks = [(y, (H, W), "y"), (u, (H // 2, W // 2), "u"),
              (v, (H // 2, W // 2), "v"), (mv0, (mb_h, mb_w, 2), "mv0"),
              (mv1, (mb_h, mb_w, 2), "mv1")]
    for k, f in enumerate((fetch0, fetch1)):
        checks += [(f[0], (4, H + 2 * P, W + 2 * P), f"planes{k}"),
                   (f[1], (H // 2 + P, W // 2 + P), f"cu{k}"),
                   (f[2], (H // 2 + P, W // 2 + P), f"cv{k}")]
    if pass2:
        checks += [(refs[k], (mb_h, mb_w), f"r{k}") for k in (0, 1)]
    else:
        checks += [(satd[k], (mb_h, mb_w), f"satd{k}") for k in (0, 1)]
        checks += [(seeds[k], (mb_h, mb_w, 2), f"seed{k}") for k in (0, 1)]
    for t, shape, name in checks:
        cuda.check(t, shape, I32, name)
    e = lambda *s: torch.empty(s, dtype=I32, device=dev)
    # pass 1 writes the residual planes too, into scratch
    o = dict(recon_y=e(H, W), recon_u=e(H // 2, W // 2),
             recon_v=e(H // 2, W // 2), blocks_z=e(mb_h, mb_w, 16, 16),
             cbp=e(mb_h, mb_w), chroma_dc=e(mb_h, mb_w, 2, 4),
             chroma_ac=e(mb_h, mb_w, 2, 4, 16))
    if not pass2:
        o.update(bmode=e(mb_h, mb_w), cost_inter=e(mb_h, mb_w))
    ptr = lambda k: o[k].data_ptr() if k in o else 0
    # the frame QP's trellis table, or under AQ the 52-QP stack's row of
    # the frame QP (x264_tpu's constant row maps; Encoder._qtab_b)
    trellis = qtab.get("trellis_tab_b", qtab.get("trellis_tab"))
    if trellis is not None:
        cuda.check(trellis, (K6_TRELLIS_INTS,), I32, "trellis_tab")
    ins = [y, u, v, *fetch0, *fetch1, mv0, mv1]
    ins += list(refs) + [None] * 4 if pass2 else [None, None] + list(
        satd) + list(seeds)
    cuda.launch("inter", "b_inter_mb", "p" * 28 + "iii" + "p",
                *[0 if t is None else t.data_ptr() for t in ins],
                pack_qtab_p(qtab).data_ptr(),
                0 if trellis is None else trellis.data_ptr(),
                *[ptr(k) for k in ("recon_y", "recon_u", "recon_v",
                                   "blocks_z", "cbp", "chroma_dc",
                                   "chroma_ac", "bmode", "cost_inter")],
                mb_h, mb_w, lam, cuda.stream(dev))
    b_inter_mb.launches += 1
    b_inter_mb.launches_trellis += int(trellis is not None)
    if not pass2:
        o = {k: o[k] for k in ("bmode", "cost_inter", "recon_y", "recon_u",
                               "recon_v")}
    return o


# launches, and those of them with the trellis
b_inter_mb.launches = b_inter_mb.launches_trellis = 0


def intra_in_b_decide(mb_h: int, mb_w: int, y, u, v, inter_y, inter_u,
                      inter_v, cost_inter, qtab, lam: int):
    """K7's B decision (x264_tpu encode_b_body stage 3, inter.py:965-1026):
    sweep 0's I16 + chroma path of every MB against residual pass 1's
    reconstruction, an MB going intra where its cost + lam *
    INTRA_PEN_BITS < cost_inter unless its chain is deeper than K_SWEEPS.
    On CUDA tensors csrc/intra_p.cu's sweep-0 kernel (its costs alone)
    and decision kernel (2 launches); on CPU tensors
    intra_in_p_plain(decide_only=True). Returns intra_mb (mb_h, mb_w)
    bool."""
    if y.device.type == "cpu":
        return intra_in_p_plain(mb_h, mb_w, y, u, v, inter_y, inter_u,
                                inter_v, cost_inter, qtab, lam, True,
                                decide_only=True)
    _check_intra_args(mb_h, mb_w, y, u, v, inter_y, inter_u, inter_v,
                      cost_inter)
    dev = y.device
    intra_mb = torch.empty((mb_h, mb_w), dtype=torch.bool, device=dev)
    cost_i = torch.empty((mb_h, mb_w), dtype=I32, device=dev)
    tab = intra.pack_qtab(qtab)
    cuda.launch("intra_p", "intra_in_b_decide", "p" * 10 + "iii" + "p",
                *[t.data_ptr() for t in (y, u, v, inter_y, inter_u, inter_v,
                                         cost_inter)],
                tab.data_ptr(), intra_mb.data_ptr(),
                cost_i.data_ptr(), mb_h, mb_w, lam, cuda.stream(dev))
    intra_in_b_decide.launches += 2     # sweep 0, decision
    return intra_mb


intra_in_b_decide.launches = 0


def intra_in_b_sweeps(mb_h: int, mb_w: int, y, u, v, inter_y, inter_u,
                      inter_v, intra_mb, qtab, lam: int) -> dict:
    """K7's B sweeps (x264_tpu encode_b_body stage 3.7, inter.py:
    1137-1160): with the decision intra_mb fixed, three sweeps of the
    intra MBs against residual pass 2's reconstruction, the first choosing
    the I16 and chroma modes, the next two keeping them. On CUDA tensors
    csrc/intra_p.cu: the merge, which lists the intra MBs on the card,
    then the three sweeps over that list alone (4 launches); on CPU
    tensors intra_in_p_plain(intra_mb=...). Returns as intra_in_p_plain."""
    if y.device.type == "cpu":
        return intra_in_p_plain(mb_h, mb_w, y, u, v, inter_y, inter_u,
                                inter_v, None, qtab, lam, True,
                                intra_mb=intra_mb)
    _check_intra_args(mb_h, mb_w, y, u, v, inter_y, inter_u, inter_v)
    cuda.check(intra_mb, (mb_h, mb_w), torch.bool, "intra_mb")
    dev = y.device
    H, W = mb_h * 16, mb_w * 16
    e = lambda *s: torch.empty(s, dtype=I32, device=dev)
    o = dict(recon_y=e(H, W), recon_u=e(H // 2, W // 2),
             recon_v=e(H // 2, W // 2), intra_mb=intra_mb,
             mode16=e(mb_h, mb_w), modec=e(mb_h, mb_w),
             luma_dc=e(mb_h, mb_w, 16), luma_ac=e(mb_h, mb_w, 16, 16),
             chroma_dc=e(mb_h, mb_w, 2, 4),
             chroma_ac=e(mb_h, mb_w, 2, 4, 16))
    # plane B of the sweeps, the intra list
    scratch = (e(H, W), e(H // 2, W // 2), e(H // 2, W // 2),
               e(mb_h * mb_w + 1))
    tab = intra.pack_qtab(qtab)
    cuda.launch("intra_p", "intra_in_b_sweeps", "p" * 21 + "iii" + "p",
                *[t.data_ptr() for t in (y, u, v, inter_y, inter_u,
                                         inter_v)],
                tab.data_ptr(),
                *[o[k].data_ptr() for k in o],
                *[t.data_ptr() for t in scratch], mb_h, mb_w, lam,
                cuda.stream(dev))
    intra_in_b_sweeps.launches += 4     # the merge, three sweeps
    return o


intra_in_b_sweeps.launches = 0


def b_direct_plain(mb_h: int, mb_w: int, y, fetch0, fetch1, intra_mb,
                   bmode, mv0, mv1, cost_inter, col_ref4, col_mv4, lam: int):
    """Plain version of K23, stage 3.5 of the B frame (x264_tpu
    encode_b_body, inter.py:1028-1101): the chosen-mode per-MB config
    (each list's reference 0 where the mode uses it, else -1 and MV 0;
    intra MBs use neither), spatial direct derived from it (provisional),
    its prediction's SATD + lam, want = inter MBs where that is below
    cost_inter; then the exact slope-2 wavefront: diagonal d = 2y + x in
    order re-derives spatial direct from the current maps and commits it
    on its MBs that want it and derive a quadrant-uniform config. Returns
    (r0, r1 (mb_h, mb_w), m0, m1 (mb_h, mb_w, 2), direct_mb (mb_h, mb_w)
    bool)."""
    dev = y.device
    use0 = ~intra_mb & (bmode != 1)
    use1 = ~intra_mb & (bmode != 0)
    r0 = torch.where(use0, 0, -1).to(I32)
    r1 = torch.where(use1, 0, -1).to(I32)
    m0 = torch.where(use0[..., None], mv0, 0).to(I32)
    m1 = torch.where(use1[..., None], mv1, 0).to(I32)
    derive = lambda a, b, c, d: mvpred.spatial_direct(
        _exp4(a), _exp4(c), _exp4(b), _exp4(d), col_ref4, col_mv4)
    d0, d1, dm0, dm1, _ = derive(r0, r1, m0, m1)
    p0 = _b_preds(fetch0, dm0, mb_h, mb_w)[0]
    p1 = _b_preds(fetch1, dm1, mb_h, mb_w)[0]
    nK = mb_h * mb_w
    dcost = opix.satd(_tiles(y, 16), _pick_pred(p0, p1, d0 >= 0, d1 >= 0)
                      .reshape(nK, 16, 16)).reshape(mb_h, mb_w) + lam
    want = ~intra_mb & (dcost < cost_inter)
    gy = torch.arange(mb_h, device=dev)[:, None]
    gx = torch.arange(mb_w, device=dev)[None, :]
    diag = 2 * gy + gx
    direct = torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
    for d in range(2 * mb_h + mb_w - 1):
        e0, e1, em0, em1, uni = derive(r0, r1, m0, m1)
        m = want & uni & (diag == d)
        r0 = torch.where(m, e0, r0)
        r1 = torch.where(m, e1, r1)
        m0 = torch.where(m[..., None], em0, m0)
        m1 = torch.where(m[..., None], em1, m1)
        direct = direct | m
    return r0, r1, m0, m1, direct


def b_direct(mb_h: int, mb_w: int, y, fetch0, fetch1, intra_mb, bmode, mv0,
             mv1, cost_inter, col_ref4, col_mv4, lam: int):
    """K23 `b_direct`: B_SKIP / B_Direct_16x16 selection of a B frame.

    Replaces x264_tpu/encoder/mvpred.py:spatial_direct as
    encode_b_body's stage 3.5 calls it, the direct prediction's SATD and
    `want`, and the lax.scan over the slope-2 diagonals that commits the
    exact derivation (inter.py:1028-1101). On CUDA tensors it runs
    csrc/direct.cu: one launch of one CTA per MB for the provisional
    derivation and its cost, then one persistent CTA that walks the
    diagonals in order, re-deriving only the committing diagonal (each MB
    reads only lower diagonals, so the result is the scan's). On CPU
    tensors the plain version. Arguments and results as
    b_direct_plain."""
    if y.device.type == "cpu":
        return b_direct_plain(mb_h, mb_w, y, fetch0, fetch1, intra_mb,
                              bmode, mv0, mv1, cost_inter, col_ref4,
                              col_mv4, lam)
    dev = y.device
    H, W, P = mb_h * 16, mb_w * 16, omc.PAD
    for t, shape, name in (
            (y, (H, W), "y"), (fetch0[0], (4, H + 2 * P, W + 2 * P),
                               "planes0"),
            (fetch1[0], (4, H + 2 * P, W + 2 * P), "planes1"),
            (bmode, (mb_h, mb_w), "bmode"), (mv0, (mb_h, mb_w, 2), "mv0"),
            (mv1, (mb_h, mb_w, 2), "mv1"),
            (cost_inter, (mb_h, mb_w), "cost_inter"),
            (col_ref4, (mb_h * 4, mb_w * 4), "col_ref4"),
            (col_mv4, (mb_h * 4, mb_w * 4, 2), "col_mv4")):
        cuda.check(t, shape, I32, name)
    cuda.check(intra_mb, (mb_h, mb_w), torch.bool, "intra_mb")
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    r0, r1, m0, m1 = e(mb_h, mb_w), e(mb_h, mb_w), e(mb_h, mb_w, 2), \
        e(mb_h, mb_w, 2)
    direct = e(mb_h, mb_w, dt=torch.bool)
    want = e(mb_h, mb_w, dt=torch.bool)
    cuda.launch("direct", "b_direct", "p" * 16 + "iii" + "p",
                *[t.data_ptr() for t in (y, fetch0[0], fetch1[0], intra_mb,
                                         bmode, mv0, mv1, cost_inter,
                                         col_ref4, col_mv4, r0, r1, m0, m1,
                                         direct, want)],
                mb_h, mb_w, lam, cuda.stream(dev))
    b_direct.launches += 2
    return r0, r1, m0, m1, direct


b_direct.launches = 0


def encode_b_front(mb_h: int, mb_w: int, me_range: int, y, u, v, l0, l1,
                   qtab, lam: int, mvp_seed, mvp_seed_l1, col_ref4, col_mv4,
                   subpel_steps=(2, 1), ref_prepadded: bool = False) -> dict:
    """Stages 1-3.7 of a B frame through K5, K9, K10 (per list), K22, K7,
    K23, K22 and K7 again, and the merge (plain tensor glue). y / u / v
    the MB-aligned source planes, l0 / l1 each list's deblocked
    reconstruction (y, u, v); mvp_seed / mvp_seed_l1 each list's qpel ME
    predictors; col_ref4 / col_mv4 the colocated L0 maps of the L1
    reference. Returns the merged planes of merge_intra and bmode (the
    pre-intra mode), direct_mb and the final per-MB config r0, r1, m0,
    m1. ref_prepadded: l0 / l1 carry their border already, as
    encode_p_front takes it (x264_tpu inter.py:909-922)."""
    seeds = (mvp_seed, mvp_seed_l1)
    fetch, mvs, satds = [], [], []
    for ref, seed in zip((l0, l1), seeds):
        f, ref_pad = b_list_fetch(*ref, ref_prepadded=ref_prepadded)
        mv_fp, sad = ome.hier_search(y, ref_pad, mb_h, mb_w, me_range, lam,
                                     seed)
        if subpel_steps:
            mv, satd = ome.subpel_refine(y, f[0], mv_fp, lam, seed,
                                         subpel_steps)
        else:
            mv, satd = mv_fp, sad
        fetch.append(f)
        mvs.append(mv)
        satds.append(satd)
    p1 = b_inter_mb(mb_h, mb_w, y, u, v, *fetch, qtab, *mvs, satd=satds,
                    seeds=seeds, lam=lam)
    intra_mb = intra_in_b_decide(mb_h, mb_w, y, u, v, p1["recon_y"],
                                 p1["recon_u"], p1["recon_v"],
                                 p1["cost_inter"], qtab, lam)
    r0, r1, m0, m1, direct = b_direct(mb_h, mb_w, y, *fetch, intra_mb,
                                      p1["bmode"], *mvs, p1["cost_inter"],
                                      col_ref4, col_mv4, lam)
    it = b_inter_mb(mb_h, mb_w, y, u, v, *fetch, qtab, m0, m1,
                    refs=(r0, r1))
    ip = intra_in_b_sweeps(mb_h, mb_w, y, u, v, it["recon_y"], it["recon_u"],
                           it["recon_v"], intra_mb, qtab, lam)
    return dict(merge_intra(ip, it, mb_h, mb_w), bmode=p1["bmode"],
                direct_mb=direct, r0=r0, r1=r1, m0=m0, m1=m1)


def b_maps_plain(front: dict, mb_h: int, mb_w: int) -> dict:
    """Stage 4's maps of a B frame (plain half of K24's pass A; x264_tpu
    encode_b_body, inter.py:1174-1224): the syntax flags use_l0 / use_l1
    (explicit modes only: direct and skip code no mvd), the per-list 4x4
    ref / mv maps (intra: ref -1, MV 0), each list's 16x16 MV prediction
    and mvd and their 4x4 maps, B_SKIP (direct without coded residual),
    and the nnz map. Returns dict(use_l0, use_l1, mvd_l0, mvd_l1, mvd4_l0,
    mvd4_l1, skip, nnz4, ref4, mv4, ref4_l1, mv4_l1)."""
    im, dm, bm = front["intra_mb"], front["direct_mb"], front["bmode"]
    use_l0 = ~im & ~dm & (bm != 1)
    use_l1 = ~im & ~dm & (bm != 0)
    out = dict(use_l0=use_l0, use_l1=use_l1)
    for k, (r, m, use) in enumerate(((front["r0"], front["m0"], use_l0),
                                     (front["r1"], front["m1"], use_l1))):
        ref4 = _exp4(torch.where(im, -1, r).to(I32))
        mv4 = _exp4(m).to(I32)
        mvd = torch.where(use[..., None],
                          m - mvpred.predict_16x16(ref4, mv4), 0).to(I32)
        sfx = "_l1" if k else ""
        out.update({f"ref4{sfx}": ref4, f"mv4{sfx}": mv4,
                    f"mvd_l{k}": mvd, f"mvd4_l{k}": _exp4(mvd)})
    cbp_l = front["cbp_luma_bits"]
    out["skip"] = dm & (cbp_l == 0) & (front["cbp_chroma"] == 0)
    dev = im.device
    nnz_cnt = (front["luma_blocks"] != 0).sum(-1, dtype=I32)
    nnz_z = nnz_cnt * ((cbp_l[..., None]
                        >> (torch.arange(16, dtype=I32, device=dev) // 4))
                       & 1)
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    nnz_r = torch.zeros_like(nnz_z)
    nnz_r[..., R] = nnz_z
    out["nnz4"] = nnz_r.reshape(mb_h, mb_w, 4, 4).transpose(1, 2) \
        .reshape(mb_h * 4, mb_w * 4)
    return out


def encode_b_body_plain(mb_h: int, mb_w: int, me_range: int, y, u, v, l0,
                        l1, qtab, lam: int, mvp_seed, mvp_seed_l1, col_ref4,
                        col_mv4, subpel_steps=(2, 1)) -> dict:
    """One B frame (pre-deblock) on CPU tensors, with the keys of
    x264_tpu's encode_b_body: stages 1-3.7 (encode_b_front, whose
    wrappers run their plain versions on the CPU) and stage 4's maps
    (b_maps_plain). The card's pipeline runs the maps inside K24
    (entropy/cabac_planes.py:cabac_b_ops)."""
    front = encode_b_front(mb_h, mb_w, me_range, y, u, v, l0, l1, qtab, lam,
                           mvp_seed, mvp_seed_l1, col_ref4, col_mv4,
                           subpel_steps)
    maps = b_maps_plain(front, mb_h, mb_w)
    im = front["intra_mb"]
    out = {k: v for k, v in front.items()
           if k not in ("r0", "r1", "m0", "m1")}
    out.update(maps, bmode=torch.where(im, -1, front["bmode"]).to(I32),
               mv=front["m0"])
    return out

"""All-intra (I16x16 + I4x4 + I8x8 + chroma) frame encode - plain
PyTorch twin of x264_tpu/encoder/intra.py and the wrapper of its CUDA
kernel (csrc/intra.cu, kernel K1).

The reference encodes macroblocks in raster order because intra
prediction reads the reconstruction of the left / top neighbours
(x264_slice_write, encoder/encoder.c:1141). Macroblocks on one
anti-diagonal (x + y = d) have no mutual dependency, so both versions
walk the 187 diagonals of a 1080p frame in order and encode every MB of
a diagonal together: predictions, SATD mode decision, DCT, quant,
dequant, IDCT and reconstruction (x264_mb_analyse_intra,
encoder/analyse.c:612; x264_mb_encode_i16x16 / _i4x4 / _i8x8 /
_8x8_chroma, encoder/macroblock.c:116-364). The I8x8 ladder's edge
filter reads the bottom row of the top-right MB, which the x + y
wavefront has not coded yet, so with I8x8 on both walk the 254 slope-2
diagonals d = x + 2y instead (the reference's own frame-thread offset).

This slice runs the I16x16 + I4x4 (+ I8x8) ladder at one frame QP;
lossless bypass and per-MB (AQ) tables come with later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from .. import cuda
from ..ops import dct as odct
from ..ops import pixel as opix
from ..ops import predict as opred
from ..ops import quant as oquant

I32 = torch.int32

# ue() bit cost of the I16x16 mode index (x264_mb_analyse_intra's
# lambda * bs_size_ue term, encoder/analyse.c:677)
_MODE_BITS_16 = (1, 3, 3, 5)
_BIG = 1 << 28
# z-scan blocks whose top-right samples are not yet decoded: the spec
# substitutes t3 (8.3.1.2.1); z 5's top-right lies in the top-right MB,
# which the anti-diagonal wavefront has not coded: DDL/VL are never
# chosen there
_TR_SUBST_Z = (3, 7, 11, 13, 15)
_TR_MASK_Z = (5,)
_I4_COST_BITS = 24   # mb-level signalling cost (x264_mb_analyse_intra)

# key order of the packed table the kernel reads (csrc/intra.cu QTab)
QTAB_VEC_KEYS = ("y_mf", "y_bias", "y_dmf", "c_mf", "c_bias", "c_dmf")
QTAB_SCALAR_KEYS = ("y_dmf0", "y_mf_dc", "y_bias_dc", "y_qpdiv6",
                    "c_dmf0", "c_mf_dc", "c_bias_dc", "c_qpdiv6")
# the I8x8 tables (CQM_8IY, 64 entries each), packed after the scalars
QTAB_VEC8_KEYS = ("y8_mf", "y8_bias", "y8_dmf")


def make_qtab(qp_y: int, qp_c: int, device,
              qt: tables.QuantTables | None = None) -> dict:
    """Per-QP table slices of the intra encode (x264_tpu make_qtab): luma
    from CQM_4IY, chroma from CQM_4IC; DC multipliers mf[0] >> 1 and
    bias[0] << 1 (encoder/macroblock.c:282); the I8x8 tables from
    CQM_8IY."""
    qt = qt or tables.DEFAULT_QUANT
    a = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    y, c = tables.CQM_4IY, tables.CQM_4IC
    return dict(
        y_mf=a(qt.quant4_mf[y, qp_y]),
        y_bias=a(qt.quant4_bias[y, qp_y]),
        y_dmf=a(qt.dequant4_mf[y, qp_y % 6]),
        y_dmf0=a(qt.dequant4_mf[y, qp_y % 6][0]),
        y_mf_dc=a(qt.quant4_mf[y, qp_y][0] >> 1),
        y_bias_dc=a(qt.quant4_bias[y, qp_y][0] << 1),
        y_qpdiv6=a(qp_y // 6),
        c_mf=a(qt.quant4_mf[c, qp_c]),
        c_bias=a(qt.quant4_bias[c, qp_c]),
        c_dmf=a(qt.dequant4_mf[c, qp_c % 6]),
        c_dmf0=a(qt.dequant4_mf[c, qp_c % 6][0]),
        c_mf_dc=a(qt.quant4_mf[c, qp_c][0] >> 1),
        c_bias_dc=a(qt.quant4_bias[c, qp_c][0] << 1),
        c_qpdiv6=a(qp_c // 6),
        y8_mf=a(qt.quant8_mf[tables.CQM_8IY, qp_y]),
        y8_bias=a(qt.quant8_bias[tables.CQM_8IY, qp_y]),
        y8_dmf=a(qt.dequant8_mf[tables.CQM_8IY, qp_y % 6]),
    )


def pack_qtab(qtab: dict) -> torch.Tensor:
    """The qtab as the one int32 vector csrc/intra_mb.cuh's QTab reads (6
    x 16 vectors, 8 scalars, then 3 x 64 for I8x8)."""
    return torch.cat([qtab[k].reshape(-1).to(I32) for k in QTAB_VEC_KEYS]
                     + [qtab[k].reshape(1).to(I32) for k in QTAB_SCALAR_KEYS]
                     + [qtab[k].reshape(-1).to(I32) for k in QTAB_VEC8_KEYS])


def _blocks4(block, n):
    """(..., n*4, n*4) -> (..., n, n, 4, 4) raster block order."""
    s = block.shape[:-2]
    return block.reshape(*s, n, 4, n, 4).transpose(-3, -2)


def _unblocks4(blocks, n):
    s = blocks.shape[:-4]
    return blocks.transpose(-3, -2).reshape(*s, n * 4, n * 4)


def _pick(preds, mode):
    """preds (K, M, h, w), mode (K,) -> (K, h, w)."""
    idx = mode.long()[:, None, None, None].expand(-1, 1, *preds.shape[2:])
    return preds.gather(1, idx)[:, 0]


def _zig(device):
    return torch.as_tensor(tables.ZIGZAG4, device=device).long()


def luma_i16_path(fenc, top, left, topleft, has_top, has_left, qtab, lam,
                  mode_sel=None, decimate: bool = False):
    """I16x16 luma for a batch of MBs: mode decision + residual +
    reconstruction (x264_mb_analyse_intra + x264_mb_encode_i16x16).
    mode_sel: (K,) fixed modes instead of the SATD decision (cost is then
    0); decimate: the P-slice AC decimation (a total score15 < 6 zeroes
    every AC level, encoder/macroblock.c:193-241).
    Returns dict(cost, mode, recon, dc_z (K,16), ac_z (K,16,16), cbp)."""
    K, dev = fenc.shape[0], fenc.device
    zig = _zig(dev)
    preds = opred.predict_16x16(top, left, topleft, has_top, has_left)
    if mode_sel is None:
        avail = opred.mode_available_16x16(has_top, has_left)
        cost = opix.satd(fenc[:, None], preds) \
            + lam * torch.tensor(_MODE_BITS_16, dtype=I32, device=dev)
        cost = torch.where(avail, cost, torch.full_like(cost, _BIG))
        best_cost = cost.min(-1).values
        mode = cost.argmin(-1).to(I32)
    else:
        mode = mode_sel.to(I32)
        best_cost = torch.zeros(K, dtype=I32, device=dev)
    pred = _pick(preds, mode)

    coef = odct.dct4x4(_blocks4(fenc - pred, 4))       # (K,4,4,4,4)
    dc_raster = coef[..., 0, 0].clone()                # (K,4,4)
    ac = coef.clone()
    ac[..., 0, 0] = 0
    ac_lv = oquant.quant(ac.reshape(K, 16, 16), qtab["y_mf"],
                         qtab["y_bias"]).reshape(K, 4, 4, 4, 4)
    if decimate:
        s = oquant.decimate_score(ac_lv.reshape(K, 16, 16)[..., zig][..., 1:])
        ac_lv = torch.where((s.sum(-1) < 6)[:, None, None, None, None], 0,
                            ac_lv)
    cbp_luma = (ac_lv != 0).any(-1).any(-1).any(-1).any(-1)   # (K,)
    ac_deq = oquant.dequant(ac_lv.reshape(K, 16, 16), qtab["y_dmf"],
                            qtab["y_qpdiv6"], 4).reshape(K, 4, 4, 4, 4)
    dc_lv = oquant.quant_dc(odct.hadamard4x4_fwd(dc_raster),
                            qtab["y_mf_dc"], qtab["y_bias_dc"])
    dc_rec = oquant.dequant_4x4_dc(odct.hadamard4x4_inv(dc_lv),
                                   qtab["y_dmf0"], qtab["y_qpdiv6"])
    ac_deq[..., 0, 0] = dc_rec
    full = odct.idct4x4(ac_deq)
    dconly = ((dc_rec + 32) >> 6)[..., None, None].expand_as(full)
    res = torch.where(cbp_luma[:, None, None, None, None], full, dconly)
    recon = (pred + _unblocks4(res, 4)).clamp(0, 255)

    zorder = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    ac_z = ac_lv.reshape(K, 16, 16)[:, zorder][:, :, zig]
    dc_z = dc_lv.reshape(K, 16)[:, zig]
    return dict(cost=best_cost, mode=mode, recon=recon, dc_z=dc_z,
                ac_z=ac_z, cbp=cbp_luma)


def _chroma_ac_levels(fencc, cpred, qtab, pfx: str):
    """DCT of the 2x2 chroma 4x4 blocks and the quantised AC levels with
    the `pfx` ("c" intra, "pc" inter) tables: (coef, ac levels)."""
    K = fencc.shape[0]
    ccoef = odct.dct4x4(_blocks4(fencc - cpred, 2))    # (K,2,2,4,4)
    cac = ccoef.clone()
    cac[..., 0, 0] = 0
    cac_lv = oquant.quant(cac.reshape(K, 4, 16), qtab[f"{pfx}_mf"],
                          qtab[f"{pfx}_bias"]).reshape(K, 2, 2, 4, 4)
    return ccoef, cac_lv


def chroma_ac_scan(fencc, cpred, qtab, pfx: str = "pc"):
    """Quantised chroma AC levels in zig-zag scan, (K, 4, 16): the input
    of the joint two-channel decimation decision
    (encoder/macroblock.c:320-332)."""
    K = fencc.shape[0]
    _, cac_lv = _chroma_ac_levels(fencc, cpred, qtab, pfx)
    return cac_lv.reshape(K, 4, 16)[..., _zig(fencc.device)]


def chroma_residual(fencc, cpred, qtab, pfx: str = "c", ac_kill=None):
    """Chroma 8x8 residual path of one channel for a batch of MBs
    (x264_mb_encode_8x8_chroma, encoder/macroblock.c:272), with the
    `pfx` tables ("c" intra, "pc" inter). ac_kill: optional (K,) bool
    zeroing the AC levels (the joint chroma decimation of inter MBs).
    Returns (recon, dc (K,4) in [c00,c01,c10,c11] order, ac (K,4,16)
    zig-zag)."""
    K, zig = fencc.shape[0], _zig(fencc.device)
    ccoef, cac_lv = _chroma_ac_levels(fencc, cpred, qtab, pfx)
    if ac_kill is not None:
        cac_lv = torch.where(ac_kill[:, None, None, None, None], 0, cac_lv)
    cdc = ccoef[..., 0, 0]
    cnz_ac = (cac_lv != 0).reshape(K, -1).any(-1)
    cac_deq = oquant.dequant(cac_lv.reshape(K, 4, 16), qtab[f"{pfx}_dmf"],
                             qtab[f"{pfx}_qpdiv6"], 4).reshape(K, 2, 2, 4, 4)
    cdc_lv = oquant.quant_dc(odct.hadamard2x2(cdc), qtab[f"{pfx}_mf_dc"],
                             qtab[f"{pfx}_bias_dc"])
    cdc_rec = oquant.dequant_2x2_dc(odct.hadamard2x2(cdc_lv),
                                    qtab[f"{pfx}_dmf0"],
                                    qtab[f"{pfx}_qpdiv6"])
    cac_deq[..., 0, 0] = cdc_rec
    cfull = odct.idct4x4(cac_deq)
    cdconly = ((cdc_rec + 32) >> 6)[..., None, None].expand_as(cfull)
    cres = torch.where(cnz_ac[:, None, None, None, None], cfull, cdconly)
    crecon = (cpred + _unblocks4(cres, 2)).clamp(0, 255)
    return crecon, cdc_lv.reshape(K, 4), cac_lv.reshape(K, 4, 16)[..., zig]


def luma_i4_path(fenc, top_row, topleft_px, left_col, nbr_modes_top,
                 nbr_modes_left, has_top, has_left, qtab, lam):
    """I4x4 luma: 16 blocks in z-scan order, each reading the recon of
    the blocks before it, batched over MBs (x264_mb_analyse_intra i4x4
    ladder, encoder/analyse.c:707-843 + x264_mb_encode_i4x4).
    Returns dict(cost, modes (K,4,4) raster, blocks_z (K,16,16),
    recon (K,16,16), cbp_bits (K,))."""
    K, dev = fenc.shape[0], fenc.device
    zig = _zig(dev)
    ext = torch.zeros((K, 17, 21), dtype=I32, device=dev)
    ext[:, 0, 0] = topleft_px
    ext[:, 0, 1:17] = top_row
    ext[:, 0, 17:21] = top_row[:, 15:16]
    ext[:, 1:17, 0] = left_col
    modes_r = torch.full((K, 4, 4), 2, dtype=I32, device=dev)
    total_cost = torch.zeros(K, dtype=I32, device=dev)
    blocks_z = torch.zeros((K, 16, 16), dtype=I32, device=dev)
    nnz_z = torch.zeros((K, 16), dtype=I32, device=dev)
    mode_ids = torch.arange(9, dtype=I32, device=dev)
    ones = torch.ones_like(has_top)

    for z in range(16):
        bx, by = (int(v) for v in tables.LUMA4x4_BLOCK_XY[z])
        t = ext[:, 4 * by, 1 + 4 * bx:5 + 4 * bx]
        tl = ext[:, 4 * by, 4 * bx]
        left = ext[:, 1 + 4 * by:5 + 4 * by, 4 * bx]
        if z in _TR_SUBST_Z or z in _TR_MASK_Z:
            tr = t[:, 3:4].expand(K, 4)
        else:
            tr = ext[:, 4 * by, 5 + 4 * bx:9 + 4 * bx]
        ht = has_top if by == 0 else ones
        hl = has_left if bx == 0 else ones
        preds = opred.predict_4x4(left, tl, t, tr, ht, hl)   # (K,9,4,4)
        avail = opred.mode_available_4x4(ht, hl)
        if z in _TR_MASK_Z:
            avail = avail.clone()
            avail[:, 3] = False
            avail[:, 7] = False
        lmode = modes_r[:, by, bx - 1] if bx > 0 else nbr_modes_left[:, by]
        tmode = modes_r[:, by - 1, bx] if by > 0 else nbr_modes_top[:, bx]
        mpm = torch.minimum(lmode, tmode)

        fb = fenc[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        bits = torch.where(mode_ids[None, :] == mpm[:, None], 1, 4).to(I32)
        cost = torch.where(avail, opix.satd(fb[:, None], preds) + lam * bits,
                           torch.full((K, 9), _BIG, dtype=I32, device=dev))
        mode = cost.argmin(-1).to(I32)
        total_cost = total_cost + cost.min(-1).values
        pred = _pick(preds, mode)

        lv = oquant.quant(odct.dct4x4(fb - pred).reshape(K, 16),
                          qtab["y_mf"], qtab["y_bias"])
        deq = oquant.dequant(lv, qtab["y_dmf"], qtab["y_qpdiv6"], 4)
        rec = (pred + odct.idct4x4(deq.reshape(K, 4, 4))).clamp(0, 255)
        ext[:, 1 + 4 * by:5 + 4 * by, 1 + 4 * bx:5 + 4 * bx] = rec
        modes_r[:, by, bx] = mode
        blocks_z[:, z] = lv[:, zig]
        nnz_z[:, z] = (lv != 0).sum(-1, dtype=I32)

    # an 8x8 group with no nonzero level is not coded; its levels are
    # already zero, so the recon needs no re-walk (nothing is dropped
    # that the decoder would see)
    cbp8 = nnz_z.reshape(K, 4, 4).sum(-1) > 0
    cbp_bits = (cbp8 * torch.tensor([1, 2, 4, 8], device=dev)).sum(
        -1, dtype=I32)
    return dict(cost=total_cost + lam * _I4_COST_BITS, modes=modes_r,
                blocks_z=blocks_z, recon=ext[:, 1:17, 1:17],
                cbp_bits=cbp_bits)


# mb-level signalling cost of I8x8 (mb_type bin + transform flag + the
# shorter mode list; x264_tpu intra.py _I8_COST_BITS)
_I8_COST_BITS = 10


def luma_i8_path(fenc, top_row, topleft_px, left_col, tr8, nbr_modes_top,
                 nbr_modes_left, has_top, has_left, has_tr, qtab, lam):
    """I8x8 luma: four 8x8 blocks in z order, each reading the recon of
    the blocks before it, batched over MBs (x264_mb_analyse_intra i8x8
    ladder, encoder/analyse.c:683-706, and x264_mb_encode_i8x8,
    encoder/macroblock.c:158). Each block filters its edges
    (predict_8x8_filter), scores the nine modes as SA8D + lam * (1 if
    most probable else 4), then runs the 8x8 DCT, the CQM_8IY quant,
    the dequant at shift base 6 and the IDCT.

    fenc: (K,16,16); top_row / left_col: (K,16) neighbour-MB recon;
    topleft_px: (K,); tr8: (K,8) the top-right MB's bottom row;
    nbr_modes_top / left: (K,4) the neighbours' 4x4-grid modes.
    Returns dict(cost (+ lam * 10), modes (K,2,2), blocks8_z (K,4,64) in
    8x8 scan order, recon (K,16,16), cbp_bits (K,))."""
    K, dev = fenc.shape[0], fenc.device
    zig8 = torch.as_tensor(tables.ZIGZAG8, device=dev).long()
    ext = torch.zeros((K, 17, 25), dtype=I32, device=dev)
    ext[:, 0, 0] = topleft_px
    ext[:, 0, 1:17] = top_row
    ext[:, 0, 17:25] = tr8
    ext[:, 1:17, 0] = left_col
    modes8 = torch.full((K, 2, 2), 2, dtype=I32, device=dev)
    total_cost = torch.zeros(K, dtype=I32, device=dev)
    blocks8_z = torch.zeros((K, 4, 64), dtype=I32, device=dev)
    mode_ids = torch.arange(9, dtype=I32, device=dev)
    # per block (z order) the availability (ht, hl, htl, htr) of its edges:
    # block 1's top-right is the top-right MB's bottom row, which exists
    # only under the slope-2 wavefront; block 3's top-right is not decoded
    # yet on either side, so it is always replaced
    ones, zeros = torch.ones_like(has_top), torch.zeros_like(has_top)
    flags = ((has_top, has_left, has_top & has_left, has_top),
             (has_top, ones, has_top, has_tr),
             (ones, has_left, has_left, ones),
             (ones, ones, ones, zeros))
    for z, (by, bx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        ht, hl, htl, htr = flags[z]
        r0, c0 = 8 * by, 8 * bx
        lf, tlf, tf = opred.predict_8x8_filter(
            ext[:, r0 + 1:r0 + 9, c0], ext[:, r0, c0],
            ext[:, r0, c0 + 1:c0 + 9], ext[:, r0, c0 + 9:c0 + 17],
            ht, hl, htl, htr)
        preds = opred.predict_8x8(lf, tlf, tf, ht, hl)       # (K,9,8,8)
        avail = opred.mode_available_8x8(ht, hl, htl)
        lmode = modes8[:, by, bx - 1] if bx else nbr_modes_left[:, 2 * by]
        tmode = modes8[:, by - 1, bx] if by else nbr_modes_top[:, 2 * bx]
        mpm = torch.minimum(lmode, tmode)
        fb = fenc[:, r0:r0 + 8, c0:c0 + 8]
        bits = torch.where(mode_ids[None, :] == mpm[:, None], 1, 4).to(I32)
        cost = torch.where(avail, opix.sa8d_8x8(fb[:, None], preds)
                           + lam * bits, _BIG)
        mode = cost.argmin(-1).to(I32)
        total_cost = total_cost + cost.min(-1).values
        pred = _pick(preds, mode)
        lv = oquant.quant(odct.dct8x8(fb - pred).reshape(K, 64),
                          qtab["y8_mf"], qtab["y8_bias"])
        deq = oquant.dequant(lv, qtab["y8_dmf"], qtab["y_qpdiv6"], 6)
        rec = (pred + odct.idct8x8(deq.reshape(K, 8, 8))).clamp(0, 255)
        ext[:, r0 + 1:r0 + 9, c0 + 1:c0 + 9] = rec
        modes8[:, by, bx] = mode
        blocks8_z[:, z] = lv[:, zig8]
    cbp8 = (blocks8_z != 0).any(-1)                         # (K,4)
    cbp_bits = (cbp8 * torch.tensor([1, 2, 4, 8], device=dev)).sum(
        -1, dtype=I32)
    return dict(cost=total_cost + lam * _I8_COST_BITS, modes=modes8,
                blocks8_z=blocks8_z, recon=ext[:, 1:17, 1:17],
                cbp_bits=cbp_bits)


def diagonals(mb_h: int, mb_w: int, i8x8: bool):
    """The wavefront: for each diagonal in order, the first MB row on it
    and how many MBs it holds; x + y = d, or x + 2y = d with I8x8 (the
    top-right MB is then coded before the MB that reads it)."""
    out = []
    if i8x8:
        for d in range(mb_w + 2 * mb_h - 2):
            y0, y1 = max(0, (d - (mb_w - 1) + 1) // 2), min(mb_h - 1, d // 2)
            out.append((d, y0, y1 - y0 + 1))
    else:
        for d in range(mb_h + mb_w - 1):
            y0, y1 = max(0, d - (mb_w - 1)), min(mb_h - 1, d)
            out.append((d, y0, y1 - y0 + 1))
    return out


def encode_i16_frame_plain(mb_h: int, mb_w: int, y, u, v, qtab, lam: int,
                           i8x8: bool = False):
    """Plain version of K1: the wavefront over whole diagonals.

    y: (mb_h*16, mb_w*16) int32; u, v: (mb_h*8, mb_w*8) int32; qtab from
    make_qtab on the same device; lam: the frame's lambda; i8x8: the I8x8
    ladder too (slope-2 diagonals). Returns the dict of x264_tpu's
    encode_i16_frame(..., i4x4=True, i8x8=i8x8): recon planes and the
    per-MB syntax planes, with t8_mb and luma8_z (mb_h,mb_w,4,64) when
    i8x8 is on (an I8x8 MB keeps i4_mb, I_NxN; its four 8x8 modes fill
    the 4x4 mode grid)."""
    dev = y.device
    ty = torch.zeros((mb_h, mb_w, 16, 16), dtype=I32, device=dev)
    tu = torch.zeros((mb_h, mb_w, 8, 8), dtype=I32, device=dev)
    tv = torch.zeros_like(tu)
    y_t = y.to(I32).reshape(mb_h, 16, mb_w, 16).transpose(1, 2)
    u_t = u.to(I32).reshape(mb_h, 8, mb_w, 8).transpose(1, 2)
    v_t = v.to(I32).reshape(mb_h, 8, mb_w, 8).transpose(1, 2)
    z = lambda *s: torch.zeros(s, dtype=I32, device=dev)
    out = dict(mode16=z(mb_h, mb_w), modec=z(mb_h, mb_w),
               luma_dc=z(mb_h, mb_w, 16), luma_ac=z(mb_h, mb_w, 16, 16),
               chroma_dc=z(mb_h, mb_w, 2, 4),
               chroma_ac=z(mb_h, mb_w, 2, 4, 16),
               i4_mb=torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev),
               i4_modes=torch.full((mb_h, mb_w, 4, 4), 2, dtype=I32,
                                   device=dev),
               cbp_luma_bits=z(mb_h, mb_w))
    if i8x8:
        out["t8_mb"] = torch.zeros((mb_h, mb_w), dtype=torch.bool,
                                   device=dev)
        out["luma8_z"] = z(mb_h, mb_w, 4, 64)

    for d, y0, n in diagonals(mb_h, mb_w, i8x8):
        ys = torch.arange(y0, y0 + n, device=dev)
        xs = d - (2 if i8x8 else 1) * ys
        ym, xm = (ys - 1).clamp(min=0), (xs - 1).clamp(min=0)
        has_top, has_left = ys > 0, xs > 0

        fenc = y_t[ys, xs]
        top = ty[ym, xs, 15, :]
        left = ty[ys, xm, :, 15]
        topleft = ty[ym, xm, 15, 15]
        lp = luma_i16_path(fenc, top, left, topleft, has_top, has_left,
                           qtab, lam)
        two = torch.full((ys.shape[0], 4), 2, dtype=I32, device=dev)
        nmt = torch.where(has_top[:, None], out["i4_modes"][ym, xs, 3, :],
                          two)
        nml = torch.where(has_left[:, None], out["i4_modes"][ys, xm, :, 3],
                          two)
        lp4 = luma_i4_path(fenc, top, topleft, left, nmt, nml, has_top,
                           has_left, qtab, lam)
        use_i4 = lp4["cost"] < lp["cost"]
        sel = use_i4[:, None, None]
        recon = torch.where(sel, lp4["recon"], lp["recon"])
        luma_ac = torch.where(sel, lp4["blocks_z"], lp["ac_z"])
        luma_dc = torch.where(use_i4[:, None], 0, lp["dc_z"])
        cbp = torch.where(use_i4, lp4["cbp_bits"],
                          torch.where(lp["cbp"], 15, 0).to(I32))
        modes = torch.where(sel, lp4["modes"], 2)
        if i8x8:
            # I8x8 takes the MB only when strictly below the best of I16
            # and I4; block 1 reads the top-right MB's bottom row
            xp = (xs + 1).clamp(max=mb_w - 1)
            has_tr = (ys > 0) & (xs < mb_w - 1)
            lp8 = luma_i8_path(fenc, top, topleft, left, ty[ym, xp, 15, 0:8],
                               nmt, nml, has_top, has_left, has_tr, qtab,
                               lam)
            use_i8 = lp8["cost"] < torch.minimum(lp["cost"], lp4["cost"])
            sel8 = use_i8[:, None, None]
            recon = torch.where(sel8, lp8["recon"], recon)
            luma_ac = torch.where(sel8, 0, luma_ac)
            luma_dc = torch.where(use_i8[:, None], 0, luma_dc)
            cbp = torch.where(use_i8, lp8["cbp_bits"], cbp)
            rep8 = lp8["modes"].repeat_interleave(2, 1) \
                .repeat_interleave(2, 2)
            modes = torch.where(sel8, rep8, modes)
            use_i4 = use_i4 | use_i8          # i4_mb means I_NxN
            out["t8_mb"][ys, xs] = use_i8
            out["luma8_z"][ys, xs] = torch.where(use_i8[:, None, None],
                                                 lp8["blocks8_z"], 0)
        ty[ys, xs] = recon
        out["luma_ac"][ys, xs] = luma_ac
        out["luma_dc"][ys, xs] = luma_dc
        out["cbp_luma_bits"][ys, xs] = cbp
        out["i4_modes"][ys, xs] = modes
        out["i4_mb"][ys, xs] = use_i4
        out["mode16"][ys, xs] = lp["mode"]

        cp = []
        for t_ref, c_t in ((tu, u_t), (tv, v_t)):
            fencc = c_t[ys, xs]
            cpreds = opred.predict_8x8c(t_ref[ym, xs, 7, :],
                                        t_ref[ys, xm, :, 7],
                                        t_ref[ym, xm, 7, 7],
                                        has_top, has_left)
            cp.append((fencc, cpreds, opix.satd(fencc[:, None], cpreds)))
        cavail = opred.mode_available_8x8c(has_top, has_left)
        ccost = cp[0][2] + cp[1][2]
        cmode = torch.where(cavail, ccost, _BIG).argmin(-1).to(I32)
        out["modec"][ys, xs] = cmode
        for ch, ((fencc, cpreds, _), t_ref) in enumerate(zip(cp, (tu, tv))):
            rec, dc, ac = chroma_residual(fencc, _pick(cpreds, cmode), qtab)
            t_ref[ys, xs] = rec
            out["chroma_dc"][ys, xs, ch] = dc
            out["chroma_ac"][ys, xs, ch] = ac

    untile = lambda t: t.transpose(1, 2).reshape(
        mb_h * t.shape[2], mb_w * t.shape[3])
    return dict(recon_y=untile(ty), recon_u=untile(tu), recon_v=untile(tv),
                **out)


# ---------------------------------------------------------------- K1
_PRED_TAB = {}


def _pred_tab(device, size: int):
    """The 4x4 (size 4) or 8x8 (size 8) predictor gather tables
    (ops/predict.py) on `device`, as the kernel reads them: 9 * n * 3
    indices, then 9 * n * 3 weights."""
    key = (str(device), size)
    if key not in _PRED_TAB:
        idx, wgt = (opred.P4_IDX, opred.P4_WGT) if size == 4 \
            else (opred.P8_IDX, opred.P8_WGT)
        tab = np.concatenate([idx.ravel(), wgt.ravel()])
        _PRED_TAB[key] = torch.as_tensor(tab.astype(np.int32), device=device)
    return _PRED_TAB[key]


def encode_i16_frame(mb_h: int, mb_w: int, y, u, v, qtab, lam: int,
                     i8x8: bool = False):
    """K1 `intra_diag`: the intra encode of one frame.

    Replaces x264_tpu/encoder/intra.py:encode_i16_frame (with i4x4=True,
    i8x8 as given, lossless=False). On a CUDA tensor it launches
    csrc/intra.cu once per wavefront diagonal (mb_h + mb_w - 1 launches,
    or mb_w + 2 * mb_h - 2 with I8x8; one CTA per MB of the diagonal); on
    a CPU tensor it runs the plain version. Inputs and outputs as
    encode_i16_frame_plain."""
    if y.device.type == "cpu":
        return encode_i16_frame_plain(mb_h, mb_w, y, u, v, qtab, lam, i8x8)
    dev = y.device
    H, W = mb_h * 16, mb_w * 16
    cuda.check(y, (H, W), I32, "y")
    cuda.check(u, (H // 2, W // 2), I32, "u")
    cuda.check(v, (H // 2, W // 2), I32, "v")
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    o = dict(recon_y=e(H, W), recon_u=e(H // 2, W // 2),
             recon_v=e(H // 2, W // 2), mode16=e(mb_h, mb_w),
             modec=e(mb_h, mb_w), luma_dc=e(mb_h, mb_w, 16),
             luma_ac=e(mb_h, mb_w, 16, 16), chroma_dc=e(mb_h, mb_w, 2, 4),
             chroma_ac=e(mb_h, mb_w, 2, 4, 16),
             i4_mb=e(mb_h, mb_w, dt=torch.bool),
             i4_modes=e(mb_h, mb_w, 4, 4), cbp_luma_bits=e(mb_h, mb_w))
    if i8x8:
        o.update(t8_mb=e(mb_h, mb_w, dt=torch.bool),
                 luma8_z=e(mb_h, mb_w, 4, 64))
    t8_ptrs = (o["t8_mb"].data_ptr(), o["luma8_z"].data_ptr()) if i8x8 \
        else (0, 0)
    ins = (y, u, v, pack_qtab(qtab), _pred_tab(dev, 4), _pred_tab(dev, 8))
    keys = [k for k in o if k not in ("t8_mb", "luma8_z")]
    ptrs = [t.data_ptr() for t in ins] + [o[k].data_ptr() for k in keys]
    stream = cuda.stream(dev)
    for d, _, _ in diagonals(mb_h, mb_w, i8x8):
        cuda.launch("intra", "intra_diag", "p" * 20 + "iiiii" + "p",
                    *ptrs, *t8_ptrs, mb_h, mb_w, d, lam, int(i8x8), stream)
        encode_i16_frame.launches += 1
        encode_i16_frame.launches_i8x8 += int(i8x8)
    return o


# launches, and those of them with the I8x8 ladder
encode_i16_frame.launches = encode_i16_frame.launches_i8x8 = 0

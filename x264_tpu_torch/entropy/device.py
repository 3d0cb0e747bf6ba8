"""CAVLC code planes and bit packing of I, P and B slices — plain PyTorch
twin of x264_tpu/entropy/device.py and the wrappers of its CUDA kernels
(csrc/cavlc.cu, kernels K18, K19 and K25).

The plain version codes a whole slice into fixed per-MB (value, length)
slot planes (a zero length where a syntax element is absent) and packs
them MSB-first into big-endian 32-bit words at their prefix-sum bit
offsets (pack_codes). The kernels code each MB's live codes directly at
its offset: one pass counts the MB's bits, a scan gives the offsets, a
second pass writes. Both follow x264_tpu's semantics where they differ
from the host coder (cavlc.py) or the spec: the level chain's
_NEXT_SUFFIX, the nC counts over all 16 slots of intra AC blocks, the I16
luma DC taking block 0's nC, mb_qp_delta as se(dqp) without a mod-52
fold (x264_macroblock_write_cavlc, encoder/cavlc.c:115-620, and the
mb_skip_run of x264_slice_write, encoder/encoder.c:1184-1192).

Words travel as int32 bit patterns; the host views them as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from .. import tables
from . import cavlc_tables as T

I32 = torch.int32
I64 = torch.int64

N_LEVEL_SLOTS = 16
N_RUN_SLOTS = 15
BLOCK_SLOTS = 1 + 1 + N_LEVEL_SLOTS + 1 + N_RUN_SLOTS  # 34

_CT_INDEX = np.array([0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9, dtype=np.int32)
_NEXT_SUFFIX = np.array([0, 3, 6, 12, 24, 48, 0x7FFFFFF], dtype=np.int32)
P_HDR_SLOTS = 21
B_HDR_SLOTS = 9


def _t(x, dev):
    return torch.as_tensor(np.asarray(x, np.int64), device=dev)


def bitlen(x):
    """Exact bit length of non-negative values (0 for x <= 0)."""
    x = x.to(I64)
    out = torch.zeros_like(x)
    v = x
    for shift in (16, 8, 4, 2, 1):
        ge = v >= (1 << shift)
        out = out + torch.where(ge, shift, 0)
        v = torch.where(ge, v >> shift, v)
    return out + (x > 0).to(I64)


def ue_codes(v):
    """Unsigned Exp-Golomb (bs_write_ue) -> (value, length)."""
    v = v.to(I64)
    return v + 1, 2 * bitlen(v + 1) - 1


def se_codes(v):
    v = v.to(I64)
    return ue_codes(torch.where(v > 0, 2 * v - 1, -2 * v))


def _level_codes(level, suffix):
    """Level coding (block_residual_write_cavlc levels, encoder/cavlc.c):
    the direct form, the 19-bit escape at suffix 0, the 15 + suffix form
    and the long escape."""
    lc = level.abs() * 2 - 2 + (level < 0).to(I64)
    msk = (1 << suffix) - 1
    direct = (lc >> suffix) < 14
    esc19 = ~direct & (suffix == 0) & (lc < 30)
    esc15 = ~direct & (suffix > 0) & ((lc >> suffix) == 14)
    v_direct = (1 << suffix) | (lc & msk)
    l_direct = (lc >> suffix) + 1 + suffix
    v_19 = 16 | (lc - 14).clamp(0, 15)
    lc2 = (lc - (15 << suffix) - torch.where(suffix == 0, 15, 0)).clamp(min=0)
    p = bitlen(lc2 + 4096) + 2
    v_esc = (1 << (p - 3)) | (lc2 + 4096 - (1 << (p - 3)))
    v = torch.where(direct, v_direct, torch.where(
        esc19, v_19, torch.where(esc15, v_direct, v_esc)))
    ln = torch.where(direct, l_direct, torch.where(
        esc19, 19, torch.where(esc15, 15 + suffix, 2 * p - 2)))
    return v, ln


def residual_codes(coeffs, nc):
    """Code residual blocks (block_residual_write_cavlc,
    encoder/cavlc.c:115), batched. coeffs: (N, C) in scan order, C in
    {4, 15, 16}; nc: (N,) predicted nC, -1 selecting the chroma-DC
    tables. Returns (vals, lens): (N, 34) int64 slots: coeff_token, the
    trailing-one signs, 16 levels, total_zeros, 15 run_befores."""
    dev = coeffs.device
    coeffs = coeffs.to(I64)
    nc = nc.to(I64)
    N, C = coeffs.shape
    nz = coeffs != 0
    total = nz.sum(1)
    pos = torch.arange(C, device=dev).expand(N, C)
    key = torch.where(nz, pos, -1)
    order = torch.argsort(-key, dim=1, stable=True)
    lvl = torch.gather(coeffs, 1, order)
    pdesc = torch.gather(pos, 1, order)
    in_total = pos < total[:, None]
    is_one = ((lvl.abs() == 1) & in_total).to(I64)
    trailing = torch.cumprod(is_one, 1).sum(1).clamp(max=3)

    cls = torch.where(nc < 0, 4, _t(_CT_INDEX, dev)[nc.clamp(0, 16)])
    tok_idx = ((total - 1) * 4 + trailing).clamp(0, 63)
    ctok = _t(T.COEFF_TOKEN, dev)[cls, tok_idx]
    tok = torch.where((total > 0)[:, None], ctok, _t(T.COEFF0_TOKEN, dev)[cls])
    vals, lens = [tok[:, 0]], [tok[:, 1]]

    signs = (lvl < 0).to(I64)
    sign_bits = torch.zeros(N, dtype=I64, device=dev)
    for i in range(3):
        sign_bits = torch.where(i < trailing, (sign_bits << 1) | signs[:, i],
                                sign_bits)
    vals.append(sign_bits)
    lens.append(trailing)

    suffix = ((total > 10) & (trailing < 3)).to(I64)
    lvl_v = torch.zeros((N, N_LEVEL_SLOTS), dtype=I64, device=dev)
    lvl_l = torch.zeros_like(lvl_v)
    nxt = _t(_NEXT_SUFFIX, dev)
    for i in range(min(N_LEVEL_SLOTS, C)):
        active = (i >= trailing) & (i < total)
        level = lvl[:, i]
        orig_abs = level.abs()
        first = active & (i == trailing) & (trailing < 3)
        level = torch.where(first, level - level.sign(), level)
        v, ln = _level_codes(level, suffix)
        lvl_v[:, i] = torch.where(active, v, 0)
        lvl_l[:, i] = torch.where(active, ln, 0)
        new = suffix.clamp(min=1)
        new = torch.where((orig_abs > nxt[new]) & (new < 6), new + 1, new)
        suffix = torch.where(active, new, suffix)
    vals.append(lvl_v)
    lens.append(lvl_l)

    total_zeros = pdesc[:, 0] + 1 - total
    tz_needed = (total > 0) & (total < C)
    tz = torch.where(
        (nc < 0)[:, None],
        _t(T.TOTAL_ZEROS_DC, dev)[(total - 1).clamp(0, 2),
                                  total_zeros.clamp(0, 3)],
        _t(T.TOTAL_ZEROS, dev)[(total - 1).clamp(0, 14),
                               total_zeros.clamp(0, 15)])
    vals.append(torch.where(tz_needed, tz[:, 0], 0))
    lens.append(torch.where(tz_needed, tz[:, 1], 0))

    runs = pdesc[:, :-1] - pdesc[:, 1:] - 1
    run_v = torch.zeros((N, N_RUN_SLOTS), dtype=I64, device=dev)
    run_l = torch.zeros_like(run_v)
    zeros_left = total_zeros
    rb_tab = _t(T.RUN_BEFORE, dev)
    for i in range(min(N_RUN_SLOTS, C - 1)):
        active = (i < total - 1) & (zeros_left > 0)
        rb = rb_tab[(zeros_left - 1).clamp(0, 6), runs[:, i].clamp(0, 14)]
        run_v[:, i] = torch.where(active, rb[:, 0], 0)
        run_l[:, i] = torch.where(active, rb[:, 1], 0)
        zeros_left = torch.where(active, zeros_left - runs[:, i], zeros_left)
    vals.append(run_v)
    lens.append(run_l)
    cat = lambda parts: torch.cat([p[:, None] if p.dim() == 1 else p
                                   for p in parts], 1)
    return cat(vals), cat(lens)


# ---------------------------------------------------------------------------
# nC prediction maps
# ---------------------------------------------------------------------------

def nc_map(count_map):
    """Predicted nC per block position from a coded-count grid
    (x264_mb_predict_non_zero_code semantics, common/macroblock.h): the
    rounded mean of the left and top counts, the one available, or 0;
    -1 marks a neighbour outside the frame."""
    a = torch.full_like(count_map, -1)
    a[:, 1:] = count_map[:, :-1]
    b = torch.full_like(count_map, -1)
    b[1:, :] = count_map[:-1, :]
    return torch.where((a >= 0) & (b >= 0), (a + b + 1) >> 1,
                       torch.where(a >= 0, a, torch.where(b >= 0, b, 0)))


def _z_order(raster, dev):
    return raster[..., torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z,
                                       device=dev).long()]


def _luma_nc(counts_z, mb_h: int, mb_w: int):
    """nC of every luma 4x4 block, (nmb, 16) in z order, from the coded
    counts (nmb, 16) in z order."""
    dev = counts_z.device
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    raster = torch.zeros_like(counts_z)
    raster[:, R] = counts_z
    grid = raster.reshape(mb_h, mb_w, 4, 4).transpose(1, 2) \
        .reshape(mb_h * 4, mb_w * 4)
    return nc_map(grid).reshape(mb_h, 4, mb_w, 4).transpose(1, 2) \
        .reshape(mb_h * mb_w, 16)[:, R]


def _chroma_nc(ccounts, mb_h: int, mb_w: int):
    """nC of the chroma AC blocks, (nmb, 2, 4), from counts (nmb, 2, 4)."""
    out = []
    for ch in range(2):
        cmap = ccounts[:, ch].reshape(mb_h, mb_w, 2, 2).transpose(1, 2) \
            .reshape(mb_h * 2, mb_w * 2)
        out.append(nc_map(cmap).reshape(mb_h, 2, mb_w, 2).transpose(1, 2)
                   .reshape(mb_h * mb_w, 4))
    return torch.stack(out, 1)


def i4_pred_mode_codes(i4_mb, i4_modes, mb_h: int, mb_w: int):
    """Per-block intra-4x4 pred mode (value, length) slots in z-scan
    order (prev_intra4x4_pred_mode syntax, encoder/cavlc.c:395-404).
    i4_mb: (mbh, mbw) bool; i4_modes: (mbh, mbw, 4, 4) raster grid with
    2 for non-I4x4 MBs. Returns (vals, lens): (nmb, 16)."""
    nmb = mb_h * mb_w
    grid = i4_modes.to(I64).transpose(1, 2).reshape(mb_h * 4, mb_w * 4)
    lg = torch.full_like(grid, 2)
    lg[:, 1:] = grid[:, :-1]
    tg = torch.full_like(grid, 2)
    tg[1:, :] = grid[:-1, :]
    mpm = torch.minimum(lg, tg)
    eq = grid == mpm
    vals_r = torch.where(eq, 1, grid - (grid > mpm).to(I64))
    lens_r = torch.where(eq, 1, 4)
    to_z = lambda g: _z_order(g.reshape(mb_h, 4, mb_w, 4).transpose(1, 2)
                              .reshape(nmb, 16), grid.device)
    return to_z(vals_r), to_z(lens_r) * i4_mb.reshape(nmb, 1).to(I64)


def _dqp(out: dict, nmb: int, dev):
    dqp = out.get("dqp")
    return torch.zeros(nmb, dtype=I64, device=dev) if dqp is None \
        else dqp.reshape(nmb).to(I64)


def i16_code_planes(out: dict, mb_h: int, mb_w: int):
    """Code planes of a whole intra CAVLC slice (I16x16 and I4x4 MBs) from
    the intra wavefront's outputs (x264_macroblock_write_cavlc intra
    branches, encoder/cavlc.c:383-430,560-620); `out` holds i4_mb and
    i4_modes, as K1 gives them (the port codes intra with I4x4). Returns
    flat (vals, lens) int64."""
    dev = out["mode16"].device
    nmb = mb_h * mb_w
    luma_dc = out["luma_dc"].to(I64)
    luma_ac = out["luma_ac"].to(I64)
    chroma_dc = out["chroma_dc"].to(I64)
    chroma_ac = out["chroma_ac"].to(I64)

    i4_mb = out["i4_mb"]
    cbp_l_bits = out["cbp_luma_bits"].to(I64)
    i4f = i4_mb.reshape(nmb)
    cbp_lf = cbp_l_bits.reshape(nmb)
    cbp_luma16 = ~i4_mb & (cbp_l_bits > 0)

    cnz_ac = (chroma_ac[..., 1:] != 0).any(-1).any(-1)
    cnz_dc = (chroma_dc != 0).any(-1)
    cbp_chroma = torch.where(cnz_ac.any(-1), 2,
                             torch.where(cnz_dc.any(-1), 1, 0)).to(I64)
    cbp_cf = cbp_chroma.reshape(nmb)

    grp = torch.arange(16, device=dev) // 4
    blk_coded = ((cbp_lf[:, None] >> grp) & 1) > 0             # (nmb, 16)
    counts_z = (luma_ac != 0).sum(-1).reshape(nmb, 16) * blk_coded
    nc_l = _luma_nc(counts_z, mb_h, mb_w)
    ccounts = (chroma_ac[..., 1:] != 0).sum(-1).reshape(nmb, 2, 4) \
        * (cbp_cf == 2)[:, None, None]
    nc_c = _chroma_nc(ccounts, mb_h, mb_w)

    dc_v, dc_l = residual_codes(luma_dc.reshape(nmb, 16), nc_l[:, 0])
    ac_v, ac_l = residual_codes(luma_ac[..., 1:].reshape(nmb * 16, 15),
                                nc_l.reshape(nmb * 16))
    f_v, f_l = residual_codes(luma_ac.reshape(nmb * 16, 16),
                              nc_l.reshape(nmb * 16))
    sel4 = i4f.repeat_interleave(16)[:, None]
    blk_v = torch.where(sel4, f_v, ac_v).reshape(nmb, 16, BLOCK_SLOTS)
    blk_l = torch.where(sel4, f_l, ac_l).reshape(nmb, 16, BLOCK_SLOTS)
    cdc_v, cdc_l = residual_codes(chroma_dc.reshape(nmb * 2, 4),
                                  torch.full((nmb * 2,), -1, device=dev))
    cac_v, cac_l = residual_codes(chroma_ac[..., 1:].reshape(nmb * 8, 15),
                                  nc_c.reshape(nmb * 8))
    blk_l = blk_l * blk_coded[..., None]
    dc_l = dc_l * (~i4f)[:, None]
    cdc_l = cdc_l.reshape(nmb, 2, BLOCK_SLOTS) * (cbp_cf > 0)[:, None, None]
    cac_l = cac_l.reshape(nmb, 8, BLOCK_SLOTS) * (cbp_cf == 2)[:, None, None]

    # mb_type: I_4x4 = ue(0); I16x16 = ue(1 + pred + 4*cbpc + 12*cbpl)
    mb_type16 = 1 + out["mode16"].to(I64) + 4 * cbp_chroma \
        + 12 * cbp_luma16.to(I64)
    v0, l0 = ue_codes(torch.where(i4_mb, 0, mb_type16).reshape(nmb))
    v1, l1 = ue_codes(out["modec"].reshape(nmb))
    cbp_code = _t(T.CBP_TO_GOLOMB_INTRA, dev)[cbp_cf * 16 + cbp_lf]
    v2, l2 = ue_codes(cbp_code)
    # mb_qp_delta: always for I16; only with a coded cbp for I4x4
    has_dqp = ~i4f | (cbp_lf > 0) | (cbp_cf > 0)
    qv, ql = se_codes(_dqp(out, nmb, dev))
    pm_v, pm_l = i4_pred_mode_codes(i4_mb, out["i4_modes"], mb_h, mb_w)

    col = lambda x: x[:, None]
    vals = torch.cat([col(v0), pm_v, col(v1), col(v2), col(qv),
                      dc_v, blk_v.reshape(nmb, -1),
                      cdc_v.reshape(nmb, -1), cac_v.reshape(nmb, -1)], 1)
    lens = torch.cat([col(l0), pm_l, col(l1),
                      col(torch.where(i4f, l2, 0)),
                      col(torch.where(has_dqp, ql, 0)),
                      dc_l, blk_l.reshape(nmb, -1), cdc_l.reshape(nmb, -1),
                      cac_l.reshape(nmb, -1)], 1)
    return vals.reshape(-1), lens.reshape(-1)


def _residual_planes(out: dict, mb_h: int, mb_w: int):
    """The residual code slots of every MB of a P or B slice: luma DC of
    I16 MBs, the 16 luma blocks (I16 AC or inter 4x4, coded per the cbp),
    chroma DC and AC, each block's nC from the count maps. Returns (vals,
    lens), each (nmb, 27 * BLOCK_SLOTS) int64."""
    dev = out["intra_mb"].device
    nmb = mb_h * mb_w
    intra = out["intra_mb"].reshape(nmb)
    cbp_l = out["cbp_luma_bits"].reshape(nmb).to(I64)
    cbp_c = out["cbp_chroma"].reshape(nmb).to(I64)
    luma_blocks = out["luma_blocks"].reshape(nmb, 16, 16).to(I64)
    luma_dc = out["luma_dc"].reshape(nmb, 16).to(I64)
    chroma_dc = out["chroma_dc"].reshape(nmb, 2, 4).to(I64)
    chroma_ac = out["chroma_ac"].reshape(nmb, 2, 4, 16).to(I64)
    # per-4x4 coded-block flags (z-scan): intra AC all-or-nothing, inter
    # per 8x8 group
    grp = torch.arange(16, device=dev) // 4
    blk_coded = torch.where(intra[:, None], (cbp_l > 0)[:, None],
                            ((cbp_l[:, None] >> grp) & 1) > 0)
    counts_z = (luma_blocks != 0).sum(-1) * blk_coded
    nc_l = _luma_nc(counts_z, mb_h, mb_w)
    ccounts = (chroma_ac != 0).sum(-1) * (cbp_c == 2)[:, None, None]
    nc_c = _chroma_nc(ccounts, mb_h, mb_w)

    ac_v, ac_l = residual_codes(luma_blocks[:, :, 1:].reshape(nmb * 16, 15),
                                nc_l.reshape(nmb * 16))
    f_v, f_l = residual_codes(luma_blocks.reshape(nmb * 16, 16),
                              nc_l.reshape(nmb * 16))
    sel = intra.repeat_interleave(16)[:, None]
    blk_v = torch.where(sel, ac_v, f_v).reshape(nmb, 16, BLOCK_SLOTS)
    blk_l = torch.where(sel, ac_l, f_l).reshape(nmb, 16, BLOCK_SLOTS) \
        * blk_coded[..., None]
    dc_v, dc_l = residual_codes(luma_dc, nc_l[:, 0])
    dc_l = dc_l * intra[:, None]
    cdc_v, cdc_l = residual_codes(chroma_dc.reshape(nmb * 2, 4),
                                  torch.full((nmb * 2,), -1, device=dev))
    cdc_l = cdc_l.reshape(nmb, 2, BLOCK_SLOTS) * (cbp_c > 0)[:, None, None]
    cac_v, cac_l = residual_codes(chroma_ac[..., 1:].reshape(nmb * 8, 15),
                                  nc_c.reshape(nmb * 8))
    cac_l = cac_l.reshape(nmb, 8, BLOCK_SLOTS) * (cbp_c == 2)[:, None, None]
    vals = torch.cat([dc_v, blk_v.reshape(nmb, -1), cdc_v.reshape(nmb, -1),
                      cac_v.reshape(nmb, -1)], 1)
    lens = torch.cat([dc_l, blk_l.reshape(nmb, -1), cdc_l.reshape(nmb, -1),
                      cac_l.reshape(nmb, -1)], 1)
    return vals, lens


def _skip_runs(coded):
    """The skipped MBs right before each MB (the mb_skip_run a coded MB
    carries)."""
    idx = torch.arange(coded.numel(), device=coded.device)
    coded_idx = torch.where(coded, idx, -1)
    prev_coded = torch.cat([torch.full((1,), -1, device=coded.device),
                            torch.cummax(coded_idx, 0).values[:-1]])
    return idx - prev_coded - 1


def _with_tail(h_v, h_l, res_v, res_l, coded):
    """The header and residual slots of each MB (none for skipped MBs) and
    the trailing skip run after the last coded MB, flat."""
    nmb = coded.numel()
    vals = torch.cat([h_v, res_v], 1).reshape(-1)
    lens = (torch.cat([h_l, res_l], 1) * coded[:, None].to(I64)).reshape(-1)
    idx = torch.arange(nmb, device=coded.device)
    tail = nmb - 1 - torch.where(coded, idx, -1).max()
    tv, tl = ue_codes(tail.reshape(1))
    return torch.cat([vals, tv]), torch.cat([lens, torch.where(tail > 0, tl,
                                                               0)])


def p_code_planes(out: dict, mb_h: int, mb_w: int, n_refs: int = 1):
    """Code planes of a whole P slice (CAVLC) from the P encode's outputs
    (x264_macroblock_write_cavlc P branch, encoder/cavlc.c:288-430, and
    the skip-run ue of x264_slice_write, encoder/encoder.c:1184-1192).
    `out` keys, all (mb_h, mb_w, ...): intra_mb, skip, mode16, modec,
    luma_dc (16), luma_blocks (16, 16), chroma_dc (2, 4), chroma_ac (2, 4,
    16), cbp_luma_bits, cbp_chroma, ptype, mvd, mvd1 (2), mvd_sub (4, 2),
    under AQ dqp, and with n_refs 2 ref_idx: each partition then codes
    ref_idx_l0 te(v), with two active references the single bit !ref
    (spec 7.3.5.1, all ref_idx before all mvd; encoder/cavlc.c:330).
    Returns flat (vals, lens) int64, the trailing skip run last."""
    dev = out["intra_mb"].device
    nmb = mb_h * mb_w
    intra = out["intra_mb"].reshape(nmb)
    coded = ~out["skip"].reshape(nmb)
    cbp_l = out["cbp_luma_bits"].reshape(nmb).to(I64)
    cbp_c = out["cbp_chroma"].reshape(nmb).to(I64)
    mvd = out["mvd"].reshape(nmb, 2).to(I64)
    mvd1 = out["mvd1"].reshape(nmb, 2).to(I64)
    mvd_sub = out["mvd_sub"].reshape(nmb, 4, 2).to(I64)
    mode16 = out["mode16"].reshape(nmb).to(I64)
    modec = out["modec"].reshape(nmb).to(I64)
    ptype = out["ptype"].reshape(nmb).to(I64)
    res_v, res_l = _residual_planes(out, mb_h, mb_w)

    # ------------------------------------------------ MB header slots
    p8 = ptype == 3
    h_v = torch.zeros((nmb, P_HDR_SLOTS), dtype=I64, device=dev)
    h_l = torch.zeros_like(h_v)
    h_v[:, 0], h_l[:, 0] = ue_codes(_skip_runs(coded))
    # mb_type: P_L0 ue(partition 0/1/2), P_8x8 ue(3); intra I16 offset 5
    i16_type = 5 + 1 + mode16 + 4 * cbp_c + 12 * (cbp_l > 0).to(I64)
    h_v[:, 1], h_l[:, 1] = ue_codes(torch.where(intra, i16_type, ptype))
    cv, cl = ue_codes(modec)
    h_v[:, 2], h_l[:, 2] = cv, torch.where(intra, cl, 0)
    # sub_mb_type x4 (P_L0_8x8 only: ue(0), one '1' bit each)
    h_v[:, 3:7] = 1
    h_l[:, 3:7] = (~intra & p8).to(I64)[:, None]
    # slots 7-10: ref_idx of the first partition, the second (16x8 /
    # 8x16) or sub 1, subs 2-3 (empty with one reference); then their mvds
    act = [~intra, ~intra & (ptype > 0), ~intra & p8, ~intra & p8]
    if n_refs > 1:
        ref_idx = out["ref_idx"].reshape(nmb).to(I64)
        for k in range(4):
            h_v[:, 7 + k] = 1 - ref_idx
            h_l[:, 7 + k] = act[k].to(I64)
    mvd_k = [torch.where(p8[:, None], mvd_sub[:, 0], mvd),
             torch.where(p8[:, None], mvd_sub[:, 1], mvd1),
             mvd_sub[:, 2], mvd_sub[:, 3]]
    for k in range(4):
        for comp in range(2):
            mv_, ml_ = se_codes(mvd_k[k][:, comp])
            h_v[:, 11 + 2 * k + comp] = mv_
            h_l[:, 11 + 2 * k + comp] = torch.where(act[k], ml_, 0)
    bv, bl = ue_codes(_t(T.CBP_TO_GOLOMB_INTER, dev)[cbp_c * 16 + cbp_l])
    h_v[:, 19], h_l[:, 19] = bv, torch.where(intra, 0, bl)
    has_dqp = intra | (cbp_l > 0) | (cbp_c > 0)
    qv, ql = se_codes(_dqp(out, nmb, dev))
    h_v[:, 20], h_l[:, 20] = qv, torch.where(has_dqp, ql, 0)
    return _with_tail(h_v, h_l, res_v, res_l, coded)


# ---------------------------------------------------------------------------
# Bit packing
# ---------------------------------------------------------------------------

def _i32_bits(x):
    """int64 holding a uint32 value -> the int32 with its bit pattern."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def pack_codes(vals, lens, capacity_words: int):
    """Pack (value, length <= 32) codes MSB-first into big-endian 32-bit
    words, by scatter-add (the codes' bit ranges are disjoint, so add ==
    or). Returns (words: (capacity_words,) int32 bit patterns, nbits:
    int32 0-d). Codes past the capacity are dropped; the caller checks
    nbits <= 32 * capacity_words."""
    dev = vals.device
    lens = lens.reshape(-1).to(I64)
    vals = vals.reshape(-1).to(I64)
    mask = torch.where(lens >= 32, 0xFFFFFFFF, (1 << lens.clamp(max=31)) - 1)
    v = vals & mask
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    w0 = starts >> 5
    end_bit = (starts & 31) + lens
    spills = end_bit > 32
    sh_hi = torch.where(spills, end_bit - 32, 32 - end_bit).clamp(0, 31)
    c0 = torch.where(lens > 0, torch.where(spills, v >> sh_hi,
                                           (v << sh_hi) & 0xFFFFFFFF), 0)
    sh_lo = (64 - end_bit).clamp(1, 31)
    c1 = torch.where(spills, (v << sh_lo) & 0xFFFFFFFF, 0)
    out = torch.zeros(capacity_words, dtype=I64, device=dev)
    for w, c in ((w0, c0), (w0 + 1, c1)):
        keep = w < capacity_words
        out.index_add_(0, w[keep], c[keep])
    nbits = ends[-1] if ends.numel() else torch.zeros((), dtype=I64,
                                                      device=dev)
    return _i32_bits(out), nbits.to(I32)


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    """32-bit big-endian words -> byte string of ceil(nbits / 8) bytes."""
    nbytes = (int(nbits) + 7) // 8
    return np.asarray(words).view(np.uint32).astype(">u4").tobytes()[:nbytes]


HDR_SLOTS = 96   # fixed slot count for slice-header codes


def header_slots(bitwriter) -> tuple[np.ndarray, np.ndarray]:
    """Export a host BitWriter's queued codes as fixed-size (vals, lens)
    int32 arrays for the device packer, splitting any code > 24 bits."""
    vals, lens = [], []
    for v, ln in zip(bitwriter._vals, bitwriter._lens):
        while ln > 24:
            hi = ln - 24
            vals.append((v >> 24) & ((1 << hi) - 1))
            lens.append(hi)
            v &= (1 << 24) - 1
            ln = 24
        vals.append(v)
        lens.append(ln)
    if len(vals) > HDR_SLOTS:
        raise ValueError(f"slice header too long: {len(vals)} codes")
    out_v = np.zeros(HDR_SLOTS, np.int32)
    out_l = np.zeros(HDR_SLOTS, np.int32)
    out_v[:len(vals)] = vals
    out_l[:len(lens)] = lens
    return out_v, out_l


def _slice_words(vals, lens, hdr_vals, hdr_lens, cap_words: int):
    """Header slots, the slice's code planes and the rbsp stop bit,
    packed."""
    dev = vals.device
    h = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(I64)
    one = torch.ones(1, dtype=I64, device=dev)
    return pack_codes(torch.cat([h(hdr_vals), vals, one]),
                      torch.cat([h(hdr_lens), lens, one]), cap_words)


def cavlc_i_slice_plain(out: dict, mb_h: int, mb_w: int, hdr_vals,
                        hdr_lens, cap_words: int):
    """Plain version of K18: i16_code_planes between the header slots and
    the stop bit, then pack_codes."""
    return _slice_words(*i16_code_planes(out, mb_h, mb_w), hdr_vals,
                        hdr_lens, cap_words)


def cavlc_p_slice_plain(front: dict, maps: dict, mb_h: int, mb_w: int,
                        hdr_vals, hdr_lens, cap_words: int, n_refs: int = 1):
    """Plain version of K19: p_code_planes of the merged front and pass-A
    maps (with K17's dqp under AQ) between the header slots and the stop
    bit, then pack_codes."""
    return _slice_words(*p_code_planes({**front, **maps}, mb_h, mb_w,
                                       n_refs),
                        hdr_vals, hdr_lens, cap_words)


def b_code_planes(out: dict, mb_h: int, mb_w: int):
    """Code planes of a whole B slice (CAVLC) from the B encode's outputs
    (x264_macroblock_write_cavlc B branch, encoder/cavlc.c:485-560, and
    the B_SKIP run ue of x264_slice_write): per coded MB the skip run,
    mb_type ue (B_Direct_16x16 0, B_L0 / L1 / Bi_16x16 1 / 2 / 3, I16x16
    23 + its I type), the intra chroma mode, the mvds of L0 then L1 (se,
    each where its list is used), the inter cbp, mb_qp_delta se(0) and
    the residual; the trailing skip run last. `out` keys as p_code_planes'
    but ptype / mvd*, plus direct_mb, bmode, use_l0, use_l1, mvd_l0 and
    mvd_l1. Returns flat (vals, lens) int64."""
    dev = out["intra_mb"].device
    nmb = mb_h * mb_w
    intra = out["intra_mb"].reshape(nmb)
    coded = ~out["skip"].reshape(nmb)
    direct = out["direct_mb"].reshape(nmb)
    cbp_l = out["cbp_luma_bits"].reshape(nmb).to(I64)
    cbp_c = out["cbp_chroma"].reshape(nmb).to(I64)
    mode16 = out["mode16"].reshape(nmb).to(I64)
    modec = out["modec"].reshape(nmb).to(I64)
    bmode = out["bmode"].reshape(nmb).to(I64)
    use = (out["use_l0"].reshape(nmb), out["use_l1"].reshape(nmb))
    mvds = (out["mvd_l0"].reshape(nmb, 2).to(I64),
            out["mvd_l1"].reshape(nmb, 2).to(I64))
    res_v, res_l = _residual_planes(out, mb_h, mb_w)
    h_v = torch.zeros((nmb, B_HDR_SLOTS), dtype=I64, device=dev)
    h_l = torch.zeros_like(h_v)
    h_v[:, 0], h_l[:, 0] = ue_codes(_skip_runs(coded))
    i16_type = 23 + 1 + mode16 + 4 * cbp_c + 12 * (cbp_l > 0).to(I64)
    b_type = torch.where(direct, 0, bmode.clamp(0, 2) + 1)
    h_v[:, 1], h_l[:, 1] = ue_codes(torch.where(intra, i16_type, b_type))
    cv, cl = ue_codes(modec)
    h_v[:, 2], h_l[:, 2] = cv, torch.where(intra, cl, 0)
    for k in range(2):
        for comp in range(2):
            mv_, ml_ = se_codes(mvds[k][:, comp])
            h_v[:, 3 + 2 * k + comp] = mv_
            h_l[:, 3 + 2 * k + comp] = torch.where(use[k], ml_, 0)
    bv, bl = ue_codes(_t(T.CBP_TO_GOLOMB_INTER, dev)[cbp_c * 16 + cbp_l])
    h_v[:, 7], h_l[:, 7] = bv, torch.where(intra, 0, bl)
    has_dqp = intra | (cbp_l > 0) | (cbp_c > 0)
    qv, ql = se_codes(torch.zeros(nmb, dtype=I64, device=dev))
    h_v[:, 8], h_l[:, 8] = qv, torch.where(has_dqp, ql, 0)
    return _with_tail(h_v, h_l, res_v, res_l, coded)


def cavlc_b_slice_plain(front: dict, maps: dict, mb_h: int, mb_w: int,
                        hdr_vals, hdr_lens, cap_words: int):
    """Plain version of K25: b_code_planes of the merged front and pass-A
    maps between the header slots and the stop bit, then pack_codes."""
    return _slice_words(*b_code_planes({**front, **maps}, mb_h, mb_w),
                        hdr_vals, hdr_lens, cap_words)


# ---------------------------------------------------------------- kernels
# The tables of csrc/cavlc.cu, one flat int32 array; the offsets are its
# T_* constants
TABLE_PARTS = (("T_COEFF0", T.COEFF0_TOKEN), ("T_COEFF", T.COEFF_TOKEN),
               ("T_TZ", T.TOTAL_ZEROS), ("T_TZ_DC", T.TOTAL_ZEROS_DC),
               ("T_RUN", T.RUN_BEFORE), ("T_CBP_I", T.CBP_TO_GOLOMB_INTRA),
               ("T_CBP_P", T.CBP_TO_GOLOMB_INTER),
               ("T_CT_INDEX", _CT_INDEX), ("T_NEXT_SUFFIX", _NEXT_SUFFIX))


def table_offsets() -> dict:
    offs, at = {}, 0
    for name, arr in TABLE_PARTS:
        offs[name] = at
        at += np.asarray(arr).size
    offs["T_SIZE"] = at
    return offs


_TABLES: dict = {}


def _device_tables(dev) -> torch.Tensor:
    key = str(dev)
    if key not in _TABLES:
        flat = np.concatenate([np.asarray(a, np.int64).ravel()
                               for _, a in TABLE_PARTS]).astype(np.int32)
        _TABLES[key] = torch.as_tensor(flat, device=dev)
    return _TABLES[key]


def _header_args(hdr_vals, hdr_lens):
    hv = np.ascontiguousarray(hdr_vals, dtype=np.int32)
    hl = np.ascontiguousarray(hdr_lens, dtype=np.int32)
    if hv.shape != (HDR_SLOTS,) or hl.shape != (HDR_SLOTS,):
        raise ValueError(f"header slots: expected ({HDR_SLOTS},) each")
    return hv, hl


def _launch_slice(fn: str, planes: list, mb_h: int, mb_w: int, hdr_vals,
                  hdr_lens, cap_words: int):
    """Launch csrc/cavlc.cu's `fn` (the memset of the words, the count
    grids, the bit-count pass, the scan and the write pass) on the planes'
    device; planes: the input pointers in the entry point's order (0 for
    an absent dqp plane)."""
    dev = next(p for p in planes if torch.is_tensor(p)).device
    nmb = mb_h * mb_w
    hv, hl = _header_args(hdr_vals, hdr_lens)
    e = lambda n: torch.empty(n, dtype=I32, device=dev)
    lcount, ccount = e(nmb * 16), e(nmb * 8)
    mb_bits, offsets, nbits = e(nmb), e(nmb + 1), e(1)
    words = e(cap_words)
    ptrs = [p.data_ptr() if torch.is_tensor(p) else 0 for p in planes]
    cuda.launch("cavlc", fn, "p" * (len(ptrs) + 9) + "iii" + "p", *ptrs,
                _device_tables(dev).data_ptr(), hv.ctypes.data,
                hl.ctypes.data, lcount.data_ptr(), ccount.data_ptr(),
                mb_bits.data_ptr(), offsets.data_ptr(), words.data_ptr(),
                nbits.data_ptr(), mb_h, mb_w, cap_words, cuda.stream(dev))
    return words, nbits.reshape(())


def cavlc_i_slice(out: dict, mb_h: int, mb_w: int, hdr_vals, hdr_lens,
                  cap_words: int):
    """K18 `cavlc_i_slice`: the packed CAVLC words of an intra slice.

    Replaces x264_tpu/entropy/device.py:i16_code_planes (with
    residual_codes, nc_map, i4_pred_mode_codes, ue/se_codes) and
    pack_codes, as x264_tpu/encoder/pipeline.py:encode_i16_idr calls them:
    the slice header's slots (header_slots, host numpy arrays), the MBs'
    codes from K1's syntax planes (and K17's dqp under variance AQ) and
    the rbsp stop bit. On CUDA tensors it runs csrc/cavlc.cu: the count
    grids, a bit-count pass (one thread per MB), K3's exclusive scan and
    a write pass at each MB's offset; on CPU tensors the plain version.
    Returns (words int32 (cap_words,), nbits int32 0-d, the stop bit
    included); words past the capacity are dropped, as pack_codes
    drops them."""
    if out["mode16"].device.type == "cpu":
        return cavlc_i_slice_plain(out, mb_h, mb_w, hdr_vals, hdr_lens,
                                   cap_words)
    shapes = dict(mode16=((mb_h, mb_w), I32), modec=((mb_h, mb_w), I32),
                  i4_mb=((mb_h, mb_w), torch.bool),
                  i4_modes=((mb_h, mb_w, 4, 4), I32),
                  cbp_luma_bits=((mb_h, mb_w), I32),
                  luma_dc=((mb_h, mb_w, 16), I32),
                  luma_ac=((mb_h, mb_w, 16, 16), I32),
                  chroma_dc=((mb_h, mb_w, 2, 4), I32),
                  chroma_ac=((mb_h, mb_w, 2, 4, 16), I32))
    aq = "dqp" in out
    if aq:
        shapes["dqp"] = ((mb_h, mb_w), I32)
    for k, (shape, dt) in shapes.items():
        cuda.check(out[k], shape, dt, k)
    planes = [out[k] for k in list(shapes)[:9]] + [out["dqp"] if aq else 0]
    ret = _launch_slice("cavlc_i_slice", planes, mb_h, mb_w, hdr_vals,
                        hdr_lens, cap_words)
    cavlc_i_slice.launches += 4        # counts, bit counts, scan, write
    cavlc_i_slice.launches_aq += 4 * int(aq)
    return ret


# launches, and those of them with mb_qp_delta planes
cavlc_i_slice.launches = cavlc_i_slice.launches_aq = 0


def cavlc_p_slice(front: dict, maps: dict, mb_h: int, mb_w: int, hdr_vals,
                  hdr_lens, cap_words: int, n_refs: int = 1):
    """K19 `cavlc_p_slice`: the packed CAVLC words of a P slice.

    Replaces x264_tpu/entropy/device.py:p_code_planes and pack_codes, as
    x264_tpu/encoder/pipeline.py:encode_p calls them: the header slots,
    each coded MB's mb_skip_run, mb_type, chroma pred mode, sub_mb_types,
    with n_refs 2 each partition's ref_idx bit, mvds, inter cbp,
    mb_qp_delta and residual, the trailing skip run and the stop bit.
    `front` holds encoder/inter.py:encode_p_front's planes, `maps` pass
    A's (cabac_planes.p_maps: skip, ptype, mvd, mvd1, mvd_sub, ref_idx;
    dqp under AQ). On CUDA tensors it runs csrc/cavlc.cu as K18 does; on
    CPU tensors the plain version. Returns as cavlc_i_slice."""
    if front["intra_mb"].device.type == "cpu":
        return cavlc_p_slice_plain(front, maps, mb_h, mb_w, hdr_vals,
                                   hdr_lens, cap_words, n_refs)
    f_shapes = dict(intra_mb=((mb_h, mb_w), torch.bool),
                    mode16=((mb_h, mb_w), I32), modec=((mb_h, mb_w), I32),
                    cbp_luma_bits=((mb_h, mb_w), I32),
                    cbp_chroma=((mb_h, mb_w), I32),
                    luma_dc=((mb_h, mb_w, 16), I32),
                    luma_blocks=((mb_h, mb_w, 16, 16), I32),
                    chroma_dc=((mb_h, mb_w, 2, 4), I32),
                    chroma_ac=((mb_h, mb_w, 2, 4, 16), I32))
    m_shapes = dict(skip=((mb_h, mb_w), torch.bool),
                    ptype=((mb_h, mb_w), I32), mvd=((mb_h, mb_w, 2), I32),
                    mvd1=((mb_h, mb_w, 2), I32),
                    mvd_sub=((mb_h, mb_w, 4, 2), I32))
    aq, refs = "dqp" in maps, n_refs > 1
    if aq:
        m_shapes["dqp"] = ((mb_h, mb_w), I32)
    if refs:
        m_shapes["ref_idx"] = ((mb_h, mb_w), I32)
    for src, shapes in ((front, f_shapes), (maps, m_shapes)):
        for k, (shape, dt) in shapes.items():
            cuda.check(src[k], shape, dt, k)
    planes = [front[k] for k in f_shapes] \
        + [maps[k] for k in ("skip", "ptype", "mvd", "mvd1", "mvd_sub")] \
        + [maps["dqp"] if aq else 0, maps["ref_idx"] if refs else 0]
    ret = _launch_slice("cavlc_p_slice", planes, mb_h, mb_w, hdr_vals,
                        hdr_lens, cap_words)
    cavlc_p_slice.launches += 4        # counts, bit counts, scan, write
    cavlc_p_slice.launches_aq += 4 * int(aq)
    cavlc_p_slice.launches_ref2 += 4 * int(refs)
    return ret


# launches, and those of them with mb_qp_delta planes and with the
# ref_idx bit of two references
cavlc_p_slice.launches = cavlc_p_slice.launches_aq = \
    cavlc_p_slice.launches_ref2 = 0


def cavlc_b_slice(front: dict, maps: dict, mb_h: int, mb_w: int, hdr_vals,
                  hdr_lens, cap_words: int):
    """K25 `cavlc_b_slice`: the packed CAVLC words of a B slice.

    Replaces x264_tpu/entropy/device.py:b_code_planes and pack_codes, as
    x264_tpu/encoder/pipeline.py:encode_b calls them: the header slots,
    each coded MB's B_SKIP run, mb_type, chroma pred mode, the mvds of L0
    and L1, inter cbp, mb_qp_delta 0 and residual, the trailing skip run
    and the stop bit. `front` holds encoder/inter.py:encode_b_front's
    planes, `maps` K24's pass A's (cabac_planes.b_maps: skip, use_l0,
    use_l1, mvd_l0, mvd_l1). On CUDA tensors it runs csrc/cavlc.cu as
    K19 does, on the same device functions; on CPU tensors the plain
    version. Returns as cavlc_i_slice."""
    if front["intra_mb"].device.type == "cpu":
        return cavlc_b_slice_plain(front, maps, mb_h, mb_w, hdr_vals,
                                   hdr_lens, cap_words)
    g, g2 = (mb_h, mb_w), (mb_h, mb_w, 2)
    f_shapes = dict(intra_mb=(g, torch.bool), mode16=(g, I32),
                    modec=(g, I32), cbp_luma_bits=(g, I32),
                    cbp_chroma=(g, I32), luma_dc=((mb_h, mb_w, 16), I32),
                    luma_blocks=((mb_h, mb_w, 16, 16), I32),
                    chroma_dc=((mb_h, mb_w, 2, 4), I32),
                    chroma_ac=((mb_h, mb_w, 2, 4, 16), I32),
                    direct_mb=(g, torch.bool), bmode=(g, I32))
    m_shapes = dict(skip=(g, torch.bool), use_l0=(g, torch.bool),
                    use_l1=(g, torch.bool), mvd_l0=(g2, I32),
                    mvd_l1=(g2, I32))
    for src, shapes in ((front, f_shapes), (maps, m_shapes)):
        for k, (shape, dt) in shapes.items():
            cuda.check(src[k], shape, dt, k)
    planes = [front[k] for k in f_shapes] + [maps[k] for k in m_shapes]
    ret = _launch_slice("cavlc_b_slice", planes, mb_h, mb_w, hdr_vals,
                        hdr_lens, cap_words)
    cavlc_b_slice.launches += 4        # counts, bit counts, scan, write
    return ret


cavlc_b_slice.launches = 0

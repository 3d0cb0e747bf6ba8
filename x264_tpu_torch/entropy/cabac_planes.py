"""CABAC bin-operation streams of I and P slices — plain PyTorch twin of
x264_tpu/entropy/cabac_planes.py (i16_slice_ops, p_slice_ops,
compact_ops) and the wrappers of its CUDA kernels (csrc/cabac_ops.cu,
kernels K3 and K8).

The MB syntax of a whole slice becomes a stream of packed bin ops in
syntax order; the serial arithmetic coder (native/cabac.c) consumes it.
The plain version builds JAX's fixed per-MB slot planes (a pad op where
a bin is absent) and compacts them; the kernel emits each MB's live ops
directly. Context indices and binarizations follow spec 9.3.2 / 9.3.3
as realised in encoder/cabac.c (x264_cabac_mb_type:64,
cbf_ctxidxinc:508, block_residual_write_cabac:584).

Op packing (uint32, carried as int32 bit patterns): kind << 29 | b << 17
| a (see entropy/cabac.py). The port codes I16x16 + I4x4 + I8x8 MBs, and
in P slices P_L0 16x16 / 16x8 / 8x16, P_8x8 (L0 8x8 sub-blocks), P_Skip
and I16x16 MBs with one reference, with or without the 8x8 transform
(transform_size_8x8_flag and the cat-5 luma blocks), at one QP (every
mb_qp_delta 0) or, under variance AQ, with the mb_qp_delta values of
encoder/aq.py:dqp_syntax (out["dqp"], out["dqp_prev_nz"]); ref_idx comes
with a later slice.
"""

from __future__ import annotations

import torch

from .. import cuda
from .. import tables
from .cabac import HW_A_BITS

I32 = torch.int32
I64 = torch.int64

(KIND_DECISION, KIND_BYPASS, KIND_UE, KIND_TERMINAL, KIND_PAD, KIND_ONES,
 KIND_SIGMAP, KIND_LEVEL) = range(8)
PAD_OP = KIND_PAD << 29

# op-stream capacity per MB: an I MB emits at most 537 live ops (header
# 8, pred modes 64, header2 10, luma DC 18, 16 luma blocks of 18, chroma
# DC 2 x 6, chroma AC 8 x 17, terminal 1), as x264_tpu sizes it; a P MB
# at most 508, a P_8x8 one (skip 1, mb_type 3, sub_mb_type 4, four mvds
# of 2 x 7, cbp 6, dqp 1; 16 luma blocks of 18, chroma 148, terminal 1).
# With the 8x8 transform the flag adds one op and the four cat-5 blocks
# (4 x 68, at most 4 sigmap parts and 64 levels each) replace the 288 of
# the sixteen 4x4 blocks, so the bound holds; two references add at most
# two ref_idx bins a partition (8 for P_8x8)
OPS_PER_MB = 560


def capacity(nmb: int) -> int:
    return nmb * OPS_PER_MB + 4096


def op(kind: int, a, b):
    """Pack ops elementwise into int64 (the uint32 value)."""
    return (kind << 29) | (torch.as_tensor(b).to(I64) << 17) \
        | torch.as_tensor(a).to(I64)


def _sel(active, ops):
    return torch.where(active, ops, torch.full_like(ops, PAD_OP))


def residual_block_ops(coeffs, cat: int, cbf_ctx, coded):
    """Packed ops of N residual blocks (block_residual_write_cabac,
    encoder/cabac.c:584): coded_block_flag, one KIND_SIGMAP op carrying
    the significance mask (bits i < C-1) and b = cat | last << 3, then one
    KIND_LEVEL op per nonzero coefficient in reverse scan order
    (a = |level| - 1, b = sign). coeffs: (N, C) in scan order; cbf_ctx:
    (N,) the 2*nzb + nza increment; coded: (N,) bool. Returns (N, 2 + C)
    int64 slot planes."""
    N, C = coeffs.shape
    dev = coeffs.device
    coeffs = coeffs.to(I64)
    nz = coeffs != 0
    total = nz.sum(1)
    has = total > 0
    pos = torch.arange(C, device=dev)
    last = torch.where(nz, pos, -1).max(1).values
    slots = [_sel(coded, op(KIND_DECISION, 85 + 4 * cat + cbf_ctx, has))]
    write_res = coded & has
    mask = (nz[:, :C - 1].to(I64) << pos[:C - 1]).sum(1)
    slots.append(_sel(write_res, op(KIND_SIGMAP, mask, cat | (last << 3))))
    order = torch.argsort(-torch.where(nz, pos, -1), dim=1, stable=True)
    lvl = coeffs.gather(1, order)
    for j in range(C):
        l = lvl[:, j]
        slots.append(_sel(write_res & (j < total),
                          op(KIND_LEVEL, (l.abs() - 1).clamp(max=0x1FFFF),
                             l < 0)))
    return torch.stack(slots, 1)


def residual_block_ops8(coeffs, coded):
    """Packed ops of N luma 8x8 residual blocks (ctxBlockCat 5,
    block_residual_write_cabac's 8x8 branch, encoder/cabac.c:769): no
    coded_block_flag (the CBP covers it); the 63-bit significance mask
    crosses as four KIND_SIGMAP parts of 16 bits (b = 5 | last << 3 |
    part << 9) that the host coder joins, then one KIND_LEVEL op per
    nonzero coefficient in reverse scan order. coeffs: (N, 64) in 8x8
    scan order; coded: (N,) bool. Returns (N, 68) int64 slot planes."""
    N, C = coeffs.shape
    dev = coeffs.device
    coeffs = coeffs.to(I64)
    nz = coeffs != 0
    total = nz.sum(1)
    pos = torch.arange(C, device=dev)
    last = torch.where(nz, pos, -1).max(1).values
    write_res = coded & (total > 0)
    nzb = nz[:, :C - 1].to(I64)
    slots = []
    for part in range(4):
        lo, hi = 16 * part, min(16 * part + 16, C - 1)
        mask = (nzb[:, lo:hi] << pos[:hi - lo]).sum(1)
        slots.append(_sel(write_res, op(KIND_SIGMAP, mask,
                                        5 | (last << 3) | (part << 9))))
    order = torch.argsort(-torch.where(nz, pos, -1), dim=1, stable=True)
    lvl = coeffs.gather(1, order)
    for j in range(C):
        l = lvl[:, j]
        slots.append(_sel(write_res & (j < total),
                          op(KIND_LEVEL, (l.abs() - 1).clamp(max=0x1FFFF),
                             l < 0)))
    return torch.stack(slots, 1)


def dqp_slots(out: dict, has_dqp, nmb: int) -> list:
    """mb_qp_delta bins (x264_cabac_mb_qp_delta, encoder/cabac.c:271;
    x264_tpu cabac_planes._dqp_slots): without out["dqp"] one 0 bin at
    ctx 60; with it the mapped-unary value (dqp > 0: 2 dqp - 1, else
    -2 dqp, folded mod 52) at ctxs [60 + c0, 62, 63, 63 ...], c0 the
    previous MB's nonzero-delta flag. Returns 1 or 4 (nmb,) slot planes."""
    dqp = out.get("dqp")
    if dqp is None:
        return [_sel(has_dqp, op(KIND_DECISION, 60, 0))]
    d = dqp.reshape(nmb).to(I64)
    c0 = out["dqp_prev_nz"].reshape(nmb).to(I64)
    val = torch.where(d > 0, 2 * d - 1, -2 * d)
    val = torch.where((val >= 51) & (val != 52), 103 - val, val)
    return [_sel(has_dqp, op(KIND_DECISION, 60 + c0, val > 0)),
            _sel(has_dqp & (val >= 1), op(KIND_DECISION, 62, val > 1)),
            _sel(has_dqp & (val >= 3),
                 op(KIND_ONES, 63, (val - 2).clamp(0, 4095))),
            _sel(has_dqp & (val >= 2), op(KIND_DECISION, 63, 0))]


def _nbr_grids(flag_map, unavail: int):
    """(left, top) neighbour values on a grid; outside the frame =
    unavail."""
    a = torch.full_like(flag_map, unavail)
    a[:, 1:] = flag_map[:, :-1]
    b = torch.full_like(flag_map, unavail)
    b[1:, :] = flag_map[:-1, :]
    return a, b


def _z_of(grid, mb_h, mb_w, R):
    """(mb_h*4, mb_w*4) block grid -> (nmb, 16) in z-scan order."""
    return grid.reshape(mb_h, 4, mb_w, 4).transpose(1, 2) \
        .reshape(mb_h * mb_w, 16)[:, R]


def i4_pred_mode_ops(i4_mb, i4_modes, mb_h: int, mb_w: int, i8_mb=None):
    """Intra 4x4 pred-mode bins in z-scan order, 4 slots per block
    (x264_cabac_mb_intra4x4_pred_mode, encoder/cabac.c:199): prev flag at
    ctx 68, then the 3-bit remainder at ctx 69. i8_mb (optional) marks
    I8x8 MBs: 4 more blocks each, on the same contexts, read at the
    top-left 4x4 cell of each 8x8 block of the mode grid (which holds the
    replicated 8x8 modes, spec 8.3.2.1)."""
    nmb = mb_h * mb_w
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z,
                        device=i4_modes.device).long()
    grid = i4_modes.transpose(1, 2).reshape(mb_h * 4, mb_w * 4).to(I64)
    lg, tg = _nbr_grids(grid, 2)
    mpm = torch.minimum(lg, tg)
    eq = _z_of(grid == mpm, mb_h, mb_w, R)
    rem = _z_of(grid - (grid > mpm).to(I64), mb_h, mb_w, R)
    i4f = i4_mb.reshape(nmb)
    slots = []
    for i in range(16):
        slots.append(_sel(i4f, op(KIND_DECISION, 68, eq[:, i])))
        for k in range(3):
            slots.append(_sel(i4f & ~eq[:, i],
                              op(KIND_DECISION, 69, (rem[:, i] >> k) & 1)))
    if i8_mb is not None:
        t8f = i8_mb.reshape(nmb)
        for z in (0, 4, 8, 12):     # the z index of cells 0, 2, 8, 10
            slots.append(_sel(t8f, op(KIND_DECISION, 68, eq[:, z])))
            for k in range(3):
                slots.append(_sel(t8f & ~eq[:, z],
                                  op(KIND_DECISION, 69, (rem[:, z] >> k) & 1)))
    return torch.stack(slots, 1)


def i16_slice_ops(out: dict, mb_h: int, mb_w: int, t8_mode: bool = False):
    """Packed op planes of a whole intra CABAC slice (I16x16 + I4x4 +
    I8x8), in syntax order (x264_macroblock_write_cabac intra paths,
    encoder/cabac.c:781-1025, plus the end_of_slice terminal after every
    MB but the last). `out` holds the syntax planes of the intra encode
    (t8_mb / luma8_z where I8x8 ran); t8_mode: the PPS enables the 8x8
    transform, so every I_NxN MB carries transform_size_8x8_flag.
    Returns the flat int64 slot stream."""
    nmb = mb_h * mb_w
    dev = out["mode16"].device
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    luma_dc = out["luma_dc"].reshape(nmb, 16)
    luma_ac = out["luma_ac"].reshape(nmb, 16, 16)
    chroma_dc = out["chroma_dc"].reshape(nmb, 2, 4)
    chroma_ac = out["chroma_ac"].reshape(nmb, 2, 4, 16)
    mode16 = out["mode16"].reshape(nmb).to(I64)
    modec = out["modec"].reshape(mb_h, mb_w).to(I64)
    i4_mb = out["i4_mb"].reshape(mb_h, mb_w)
    cbp_l_bits = out["cbp_luma_bits"].reshape(mb_h, mb_w).to(I64)
    i4f = i4_mb.reshape(nmb)
    cbp_lf = cbp_l_bits.reshape(nmb)
    cbp_luma16 = ~i4f & (cbp_lf > 0)
    # I8x8: i4_mb means I_NxN, t8_mb the 8x8 transform
    t8_mb = out.get("t8_mb")
    if t8_mb is None:
        t8_mb = torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
    t8_mb = t8_mb.reshape(mb_h, mb_w)
    t8f = t8_mb.reshape(nmb)

    cnz_ac = (chroma_ac[..., 1:] != 0).reshape(nmb, -1).any(1)
    cnz_dc = (chroma_dc != 0).reshape(nmb, -1).any(1)
    cbp_chroma = torch.where(cnz_ac, 2, torch.where(cnz_dc, 1, 0)).to(I64)

    ymb, xmb = torch.meshgrid(torch.arange(mb_h, device=dev),
                              torch.arange(mb_w, device=dev), indexing="ij")
    avail_l = (xmb > 0).reshape(nmb)
    avail_t = (ymb > 0).reshape(nmb)

    # mb_type: ctxInc counts the available non-I4x4 neighbours
    ni4_l, ni4_t = _nbr_grids((~i4_mb).to(I64), 0)
    ctx_mbtype = 3 + (avail_l & (ni4_l.reshape(nmb) > 0)).to(I64) \
        + (avail_t & (ni4_t.reshape(nmb) > 0)).to(I64)
    term = torch.full((nmb,), KIND_TERMINAL << 29, dtype=I64, device=dev)
    # transform_size_8x8_flag of I_NxN MBs, ctx 399 + the left and top
    # MBs' flags (x264_cabac_mb_transform_size, encoder/cabac.c:369)
    t8l, t8t = _nbr_grids(t8_mb.to(I64), 0)
    tflag = _sel(i4f, op(KIND_DECISION, (399 + t8l + t8t).reshape(nmb), t8f)) \
        if t8_mode else torch.full((nmb,), PAD_OP, dtype=I64, device=dev)
    header1 = torch.stack([
        op(KIND_DECISION, ctx_mbtype, ~i4f),
        tflag,
        _sel(~i4f, term),
        _sel(~i4f, op(KIND_DECISION, 6, cbp_luma16)),
        _sel(~i4f, op(KIND_DECISION, 7, cbp_chroma > 0)),
        _sel(~i4f & (cbp_chroma > 0),
             op(KIND_DECISION, 8, cbp_chroma == 2)),
        _sel(~i4f, op(KIND_DECISION, 9, mode16 >> 1)),
        _sel(~i4f, op(KIND_DECISION, 10, mode16 & 1))], 1)

    pm_ops = i4_pred_mode_ops(i4_mb & ~t8_mb, out["i4_modes"], mb_h, mb_w,
                              i8_mb=t8_mb)

    cm_l, cm_t = _nbr_grids(modec, 0)
    cctx = (64 + (cm_l != 0).to(I64) + (cm_t != 0).to(I64)).reshape(nmb)
    cm = modec.reshape(nmb)
    h2 = [op(KIND_DECISION, cctx, cm > 0),
          _sel(cm > 0, op(KIND_DECISION, 67, cm > 1)),
          _sel(cm > 1, op(KIND_DECISION, 67, cm > 2))]
    # coded_block_pattern for I_4x4 (x264_cabac_mb_cbp_luma / _chroma)
    cb = cbp_l_bits
    cbl_l, cbl_t = _nbr_grids(cb, -1)
    ctxs = (76 - ((cbl_l >> 1) & 1) - ((cbl_t >> 1) & 2),
            76 - (cb & 1) - ((cbl_t >> 2) & 2),
            76 - ((cbl_l >> 3) & 1) - ((cb << 1) & 2),
            76 - ((cb >> 2) & 1) - (cb & 2))
    for k, cx in enumerate(ctxs):
        h2.append(_sel(i4f, op(KIND_DECISION, cx.reshape(nmb),
                               (cbp_lf >> k) & 1)))
    cbc_l, cbc_t = _nbr_grids(cbp_chroma.reshape(mb_h, mb_w), -1)
    c0 = 77 + (cbc_l > 0).to(I64) + 2 * (cbc_t > 0).to(I64)
    c1 = 81 + (cbc_l == 2).to(I64) + 2 * (cbc_t == 2).to(I64)
    h2.append(_sel(i4f, op(KIND_DECISION, c0.reshape(nmb), cbp_chroma > 0)))
    h2.append(_sel(i4f & (cbp_chroma > 0),
                   op(KIND_DECISION, c1.reshape(nmb), cbp_chroma == 2)))
    # mb_qp_delta (x264_cabac_mb_qp_delta, encoder/cabac.c:271)
    has_dqp = ~i4f | (cbp_lf > 0) | (cbp_chroma > 0)
    h2.extend(dqp_slots(out, has_dqp, nmb))
    header2 = torch.stack(h2, 1)

    # coded_block_flag neighbour contexts (cbf_ctxidxinc,
    # encoder/cabac.c:508); outside the frame counts as coded (I slice)
    dc_nz = ((luma_dc != 0).any(-1).reshape(mb_h, mb_w) & ~i4_mb).to(I64)
    a, b = _nbr_grids(dc_nz, 1)
    ctx_dc = (2 * b + a).reshape(nmb)
    grp = torch.arange(16, device=dev) // 4
    blk_coded = ((cbp_lf[:, None] >> grp) & 1) > 0          # (nmb,16) z
    counts_z = ((luma_ac != 0).any(-1) & blk_coded).to(I64)
    counts_raster = torch.zeros_like(counts_z)
    counts_raster[:, R] = counts_z
    luma8_z = out.get("luma8_z")
    if luma8_z is not None:
        # an I8x8 MB shows each 8x8 block's coded status on its four 4x4
        # cells
        c8 = (luma8_z.reshape(nmb, 4, 64) != 0).any(-1).to(I64)
        cell = torch.as_tensor(CELL_8X8, device=dev).long()
        counts_raster = torch.where(t8f[:, None], c8[:, cell], counts_raster)
    lmap = counts_raster.reshape(mb_h, mb_w, 4, 4).transpose(1, 2) \
        .reshape(mb_h * 4, mb_w * 4)
    a, b = _nbr_grids(lmap, 1)
    ctx_ac = _z_of(2 * b + a, mb_h, mb_w, R)
    ctx_cdc, ctx_cac = [], []
    for ch in range(2):
        dcm = (chroma_dc[:, ch] != 0).any(-1).reshape(mb_h, mb_w).to(I64)
        a, b = _nbr_grids(dcm, 1)
        ctx_cdc.append((2 * b + a).reshape(nmb))
        acm = (chroma_ac[:, ch, :, 1:] != 0).any(-1).to(I64) \
            .reshape(mb_h, mb_w, 2, 2).transpose(1, 2) \
            .reshape(mb_h * 2, mb_w * 2)
        a, b = _nbr_grids(acm, 1)
        ctx_cac.append((2 * b + a).reshape(mb_h, 2, mb_w, 2).transpose(1, 2)
                       .reshape(nmb, 4))
    ctx_cdc = torch.stack(ctx_cdc, 1)
    ctx_cac = torch.stack(ctx_cac, 1)

    # residual blocks: I16 = DC cat 0 + AC cat 1; I4x4 = cat 2
    dc_ops = residual_block_ops(luma_dc, 0, ctx_dc, ~i4f)
    ac15 = residual_block_ops(luma_ac[..., 1:].reshape(nmb * 16, 15), 1,
                              ctx_ac.reshape(nmb * 16),
                              (~i4f & (cbp_lf > 0)).repeat_interleave(16))
    full16 = residual_block_ops(luma_ac.reshape(nmb * 16, 16), 2,
                                ctx_ac.reshape(nmb * 16),
                                (i4f & ~t8f).repeat_interleave(16)
                                & blk_coded.reshape(nmb * 16))
    ac15p = torch.cat([ac15, torch.full((nmb * 16, 1), PAD_OP, dtype=I64,
                                        device=dev)], 1)
    blk_ops = torch.where(i4f.repeat_interleave(16)[:, None], full16,
                          ac15p).reshape(nmb, -1)
    if luma8_z is not None:
        blk_ops = _with_blocks8(blk_ops, luma8_z, t8f, cbp_lf)
    cdc_ops = residual_block_ops(chroma_dc.reshape(nmb * 2, 4), 3,
                                 ctx_cdc.reshape(nmb * 2),
                                 (cbp_chroma > 0).repeat_interleave(2))
    cac_ops = residual_block_ops(chroma_ac[..., 1:].reshape(nmb * 8, 15), 4,
                                 ctx_cac.reshape(nmb * 8),
                                 (cbp_chroma == 2).repeat_interleave(8))
    is_last = torch.arange(nmb, device=dev) == nmb - 1
    return torch.cat([header1, pm_ops, header2, dc_ops, blk_ops,
                      cdc_ops.reshape(nmb, -1), cac_ops.reshape(nmb, -1),
                      _sel(~is_last, term)[:, None]], 1).reshape(-1)


# the 8x8 block (z order) of each raster 4x4 cell of an MB
CELL_8X8 = (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3)


def _with_blocks8(blk_ops, luma8_z, t8f, cbp_lf):
    """The luma slot region of 8x8-transform MBs: their four cat-5 blocks
    (those whose CBP bit is set) in place of the sixteen 4x4 blocks, the
    rest of the region padded."""
    nmb = t8f.shape[0]
    cbp8 = ((cbp_lf[:, None] >> torch.arange(4, device=t8f.device)) & 1) > 0
    ops8 = residual_block_ops8(luma8_z.reshape(nmb * 4, 64),
                               t8f.repeat_interleave(4)
                               & cbp8.reshape(nmb * 4)).reshape(nmb, -1)
    pad8 = torch.full((nmb, blk_ops.shape[1] - ops8.shape[1]), PAD_OP,
                      dtype=I64, device=t8f.device)
    return torch.where(t8f[:, None], torch.cat([ops8, pad8], 1), blk_ops)


def compact_ops(ops_flat, cap: int):
    """Drop pad ops, keeping order. Returns (int32 ops of length cap,
    zero past the count; int32 count)."""
    live = ops_flat[(ops_flat >> 29) != KIND_PAD]
    n = live.numel()
    if n > cap:
        raise RuntimeError(f"CABAC op stream overflowed ({n} > {cap})")
    res = torch.zeros(cap, dtype=I32, device=ops_flat.device)
    res[:n] = torch.where(live >= 1 << 31, live - (1 << 32), live).to(I32)
    return res, torch.tensor(n, dtype=I32, device=ops_flat.device)


# ---------------------------------------------------------------- K27
# The halfword transfer format: entropy/cabac.py's HW_A_BITS, whose
# unpack_hw inverts it.


def hw_cap(cap_hw: int) -> int:
    """The halfword capacity as x264_tpu keeps it: even, for the pairs."""
    return cap_hw + (cap_hw & 1)


def hw_pack_plain(ops, n_ops, cap_hw: int):
    """Plain version of K27, x264_tpu's hw_pack bit for bit: the first
    n_ops of the compacted op stream ops (int32 bit patterns of uint32)
    as halfwords at the exclusive scan of their counts (1, or 3 for an
    extended op), those at or past hw_cap(cap_hw) dropped, the rest zero.
    Returns (int32 words (hw_cap(cap_hw) // 2,), two halfwords a word,
    low first; int32 0-d n_hw, the full count even past capacity)."""
    cap_hw = hw_cap(cap_hw)
    dev = ops.device
    o = ops.to(I64) & 0xFFFFFFFF
    kind = o >> 29
    a = o & 0x1FFFF
    b = (o >> 17) & 0xFFF
    valid = torch.arange(o.shape[0], device=dev) < torch.as_tensor(
        n_ops, device=dev)
    abits = torch.tensor(HW_A_BITS, dtype=I64, device=dev)[kind]
    small = (a < (1 << abits)) & (b < (1 << (12 - abits)))
    hw0 = torch.where(small, (kind << 12) | (b << abits) | a,
                      0x8000 | (kind << 12) | b)
    nhw = torch.where(valid, torch.where(small, 1, 3), 0)
    off = torch.cumsum(nhw, 0) - nhw
    ext = valid & ~small
    buf = torch.zeros(cap_hw + 1, dtype=I64, device=dev)
    for mask, pos, val in ((valid, off, hw0), (ext, off + 1, a & 0x7FFF),
                           (ext, off + 2, a >> 15)):
        # x264_tpu's .at[].set(mode="drop"): an index at or past cap_hw
        # goes to the spare slot, which is cut
        buf[torch.where(mask & (pos < cap_hw), pos, cap_hw)] = val
    pairs = buf[:cap_hw].reshape(-1, 2)
    words = pairs[:, 0] | (pairs[:, 1] << 16)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(I32)
    return words, nhw.sum().to(I32)


def hw_pack(ops, n_ops, cap_hw: int):
    """K27 `hw_pack`: the halfword packing of a compacted op stream.

    Replaces x264_tpu/entropy/cabac_planes.py:hw_pack (cabac_planes.py:455),
    which every CABAC band program of x264_tpu/parallel/rows.py runs on
    its compact_ops output. ops: int32 (N,) from K3 / K8 / K24, n_ops
    their int32 0-d live count on the device. On CUDA tensors it runs
    csrc/hwpack.cu (pass one sums each CTA's halfwords, one CTA scans the
    sums, pass two writes each op's halfwords at its offset), reading
    n_ops on the device, so the host never waits; on CPU tensors the
    plain version. Returns as hw_pack_plain, except that on the card the
    words past the live prefix ((n_hw + 1) // 2 of them; an odd count's
    spare high halfword is written 0) are unspecified."""
    if ops.device.type == "cpu":
        return hw_pack_plain(ops, n_ops, cap_hw)
    cap_hw = hw_cap(cap_hw)
    n = ops.shape[0]
    cuda.check(ops, (n,), I32, "ops")
    n_ops = torch.as_tensor(n_ops, device=ops.device)
    cuda.check(n_ops, (), I32, "n_ops")
    nblk = (n + HW_OPS_PER_CTA - 1) // HW_OPS_PER_CTA
    sums = torch.empty(nblk + 1, dtype=I32, device=ops.device)
    words = torch.empty(cap_hw // 2, dtype=I32, device=ops.device)
    cuda.launch("hwpack", "hw_pack", "ppppiii" + "p", ops.data_ptr(),
                n_ops.data_ptr(), sums.data_ptr(), words.data_ptr(), n,
                nblk, cap_hw, cuda.stream(ops.device))
    hw_pack.launches += 1 + 2 * (nblk > 0)   # count, scan, write; no ops: scan
    return words, sums[nblk]           # the scan leaves the total last


hw_pack.launches = 0
# ops a CTA of csrc/hwpack.cu takes (256 threads of 8)
HW_OPS_PER_CTA = 2048


def i_slice_ops_plain(out: dict, mb_h: int, mb_w: int,
                      t8_mode: bool = False):
    """Plain version of K3: compact_ops(i16_slice_ops(out, t8_mode))."""
    return compact_ops(i16_slice_ops(out, mb_h, mb_w, t8_mode),
                       capacity(mb_h * mb_w))


# mvd unary context ladder (x264_cabac_mb_mvd_cpn, encoder/cabac.c):
# ctx offsets of the unary bins 1..8 past the component base (40 x, 47 y)
_MVD_TERM_OFF = (0, 3, 4, 5, 6, 6, 6, 6, 6)


def _mvd_component_ops(mvd_c, base: int, inc, active):
    """The 8 slots of one component's UEG3 mvd binarization
    (x264_cabac_mb_mvd_cpn, encoder/cabac.c:444). mvd_c / inc / active:
    (N,). Returns a list of 8 int64 op tensors."""
    a = mvd_c.abs().to(I64)
    term_off = torch.tensor(_MVD_TERM_OFF, dtype=I64, device=a.device)
    ones = (torch.minimum(a - 1, torch.full_like(a, 8)) - 3).clamp(0, 5)
    return [
        _sel(active, op(KIND_DECISION, base + inc, a > 0)),
        _sel(active & (a >= 2), op(KIND_DECISION, base + 3, 1)),
        _sel(active & (a >= 3), op(KIND_DECISION, base + 4, 1)),
        _sel(active & (a >= 4), op(KIND_DECISION, base + 5, 1)),
        _sel(active & (ones > 0), op(KIND_ONES, base + 6, ones)),
        _sel(active & (a >= 1) & (a < 9),
             op(KIND_DECISION, base + term_off[a.clamp(0, 8)], 0)),
        _sel(active & (a >= 9), op(KIND_UE, (a - 9).clamp(min=0), 3)),
        _sel(active & (a >= 1), op(KIND_BYPASS, mvd_c < 0, 1)),
    ]


def _cbf_ctx_from_grid(grid, intra_cur_grid):
    """coded_block_flag ctxIdxInc on a block grid: the neighbours'
    nonzero flags, where outside the frame resolves to the current MB's
    intra flag (the 0x7f / 0x80 masking of cbf_ctxidxinc,
    encoder/cabac.c:508)."""
    a, b = _nbr_grids(grid, 2)
    ia = torch.where(a == 2, intra_cur_grid, a)
    ib = torch.where(b == 2, intra_cur_grid, b)
    return 2 * ib + ia


def p_slice_ops(out: dict, mb_h: int, mb_w: int, n_refs: int = 1,
                t8_mode: bool = False):
    """Packed op planes of a whole P CABAC slice (x264_macroblock_write_
    cabac P branch + x264_cabac_mb_skip, encoder/cabac.c:300-306,
    781-1025) for P_L0 16x16 / 16x8 / 8x16, P_8x8 (L0 8x8 sub-blocks),
    P_Skip and I16x16 MBs; n_refs: the active L0 references, with 2 each
    partition codes its ref_idx (out then holds ref_idx and ref4);
    t8_mode: the PPS enables the 8x8 transform (out then holds t8_mb and
    luma8_z), so inter MBs with coded luma carry transform_size_8x8_flag
    and the 8x8-transform MBs their cat-5 blocks. `out` holds the keys of
    encoder/inter.py:encode_p_body. Returns the flat int64 slot
    stream."""
    nmb = mb_h * mb_w
    dev = out["intra_mb"].device
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    intra = out["intra_mb"].reshape(mb_h, mb_w)
    skip = out["skip"].reshape(mb_h, mb_w)
    cbp_l = out["cbp_luma_bits"].reshape(mb_h, mb_w).to(I64)
    cbp_c = out["cbp_chroma"].reshape(mb_h, mb_w).to(I64)
    luma_blocks = out["luma_blocks"].reshape(nmb, 16, 16)
    luma_dc = out["luma_dc"].reshape(nmb, 16)
    chroma_dc = out["chroma_dc"].reshape(nmb, 2, 4)
    chroma_ac = out["chroma_ac"].reshape(nmb, 2, 4, 16)
    mvd = out["mvd"].reshape(nmb, 2).to(I64)
    mvd1 = out["mvd1"].reshape(nmb, 2).to(I64)
    mvd_sub = out["mvd_sub"].reshape(nmb, 4, 2).to(I64)
    ptype_g = out["ptype"].reshape(mb_h, mb_w)
    ptype_f = ptype_g.reshape(nmb)
    mode16 = out["mode16"].reshape(nmb).to(I64)
    modec = torch.where(intra, out["modec"].reshape(mb_h, mb_w), 0).to(I64)
    mvd4 = out["mvd4"].to(I64)
    intra_f, skip_f = intra.reshape(nmb), skip.reshape(nmb)
    coded = ~skip_f
    inter_f = coded & ~intra_f
    cbp_lf, cbp_cf = cbp_l.reshape(nmb), cbp_c.reshape(nmb)
    dec = lambda ctx, b: op(KIND_DECISION, ctx, b)

    # mb_skip_flag (ctx 11 + non-skip neighbours), then mb_type
    # (x264_cabac_mb_type P branch, encoder/cabac.c:86-113): P_L0 16x16 =
    # (14,0)(15,0)(16,0), 16x8 = (14,0)(15,1)(17,1), 8x16 =
    # (14,0)(15,1)(17,0), P_8x8 = (14,0)(15,0)(16,1); intra prefix (14,1)
    # + I16 suffix
    p8_f = ptype_f == 3
    split = (ptype_f == 1) | (ptype_f == 2)
    a, b = _nbr_grids((~skip).to(I64), 0)
    slots = [dec((11 + a + b).reshape(nmb), skip_f),
             _sel(coded, dec(14, intra_f)),
             _sel(inter_f, dec(15, split)),
             _sel(inter_f & ~split, dec(16, p8_f)),
             _sel(inter_f & split, dec(17, ptype_f == 1)),
             _sel(intra_f, dec(17, 1)),
             _sel(intra_f, torch.full((nmb,), KIND_TERMINAL << 29,
                                      dtype=I64, device=dev)),
             _sel(intra_f, dec(18, cbp_lf > 0)),
             _sel(intra_f, dec(19, cbp_cf > 0)),
             _sel(intra_f & (cbp_cf > 0), dec(19, cbp_cf == 2)),
             _sel(intra_f, dec(20, mode16 >> 1)),
             _sel(intra_f, dec(20, mode16 & 1))]
    # intra chroma pred mode
    cm_l, cm_t = _nbr_grids(modec, 0)
    cctx = (64 + (cm_l != 0).to(I64) + (cm_t != 0).to(I64)).reshape(nmb)
    cm = modec.reshape(nmb)
    slots += [_sel(intra_f, dec(cctx, cm > 0)),
              _sel(intra_f & (cm > 0), dec(67, cm > 1)),
              _sel(intra_f & (cm > 1), dec(67, cm > 2))]
    # sub_mb_type x4 (x264_cabac_mb_sub_p_partition: D_L0_8x8 is one '1'
    # bin at ctx 21; encoder/cabac.c:309-312,877-880)
    slots += [_sel(inter_f & p8_f, dec(21, 1))] * 4
    # A partition's first 4x4 block: part 0 at (4Y, 4X); part 1 at (4Y+2,
    # 4X) for 16x8, (4Y, 4X+2) for 8x16 and P8x8 sub-block 1; sub-blocks 2
    # / 3 at (4Y+2, 4X) / (4Y+2, 4X+2)
    r1 = torch.where(ptype_g == 1, 2, 0)
    c1 = torch.where((ptype_g == 2) | (ptype_g == 3), 2, 0)
    parts = ((torch.where(p8_f[:, None], mvd_sub[:, 0], mvd), inter_f, 0, 0),
             (torch.where(p8_f[:, None], mvd_sub[:, 1], mvd1),
              inter_f & (ptype_f != 0), r1, c1),
             (mvd_sub[:, 2], inter_f & p8_f, 2, 0),
             (mvd_sub[:, 3], inter_f & p8_f, 2, 2))
    gy = torch.arange(mb_h, device=dev)[:, None] * 4
    gx = torch.arange(mb_w, device=dev)[None, :] * 4
    pos = [((gy + dr).expand(mb_h, mb_w), (gx + dc).expand(mb_h, mb_w))
           for _, _, dr, dc in parts]
    if n_refs > 1:
        # ref_idx_l0 per partition (x264_cabac_mb_ref, encoder/cabac.c:
        # 228-246): ctx 54 + (refA > 0) + 2 * (refB > 0) from the
        # partition's left / top 4x4 slots of ref4 (the current MB's
        # own cells included; -1 outside the frame), then a 0 at ctx 58
        # after a 1. Every partition carries the MB's reference
        ref_idx = out["ref_idx"].reshape(nmb)
        ref4p = torch.nn.functional.pad(out["ref4"], (1, 1, 1, 1),
                                        value=-1)
        for (_, act, _, _), (r, c) in zip(parts, pos):
            rctx = 54 + (ref4p[r + 1, c] > 0).to(I64) \
                + 2 * (ref4p[r, c + 1] > 0).to(I64)
            slots += [_sel(act, dec(rctx.reshape(nmb), ref_idx > 0)),
                      _sel(act & (ref_idx > 0), dec(58, 0))]
    # mvd per partition in syntax order; ctxInc from the partition's left
    # / top 4x4 neighbours' |mvd| (x264_cabac_mb_mvd_cpn amvd,
    # encoder/cabac.c:397-401)
    amvd = [_nbr_grids(mvd4[..., comp].abs(), 0) for comp in (0, 1)]
    for (mvdp, act, _, _), (r, c) in zip(parts, pos):
        for comp, base in ((0, 40), (1, 47)):
            ma, mb_ = amvd[comp]
            am = (ma[r, c] + mb_[r, c]).reshape(nmb)
            inc = (am > 2).to(I64) + (am > 32).to(I64)
            slots += _mvd_component_ops(mvdp[:, comp], base, inc, act)
    # coded_block_pattern (x264_cabac_mb_cbp_luma / _chroma)
    cbp_all = torch.where(skip, 0, cbp_l)
    cbl_l, cbl_t = _nbr_grids(cbp_all, -1)
    ctxs = (76 - ((cbl_l >> 1) & 1) - ((cbl_t >> 1) & 2),
            76 - (cbp_all & 1) - ((cbl_t >> 2) & 2),
            76 - ((cbl_l >> 3) & 1) - ((cbp_all << 1) & 2),
            76 - ((cbp_all >> 2) & 1) - (cbp_all & 2))
    for k, cx in enumerate(ctxs):
        slots.append(_sel(inter_f, dec(cx.reshape(nmb), (cbp_lf >> k) & 1)))
    cbc_l, cbc_t = _nbr_grids(torch.where(skip, 0, cbp_c), -1)
    c0 = 77 + (cbc_l > 0).to(I64) + 2 * (cbc_t > 0).to(I64)
    c1 = 81 + (cbc_l == 2).to(I64) + 2 * (cbc_t == 2).to(I64)
    slots += [_sel(inter_f, dec(c0.reshape(nmb), cbp_cf > 0)),
              _sel(inter_f & (cbp_cf > 0), dec(c1.reshape(nmb), cbp_cf == 2))]
    # transform_size_8x8_flag of inter MBs with coded luma (ctx 399 + the
    # left and top MBs' flags; encoder/cabac.c:975-977 and :369)
    t8_f = torch.zeros(nmb, dtype=torch.bool, device=dev)
    if t8_mode:
        t8_g = out["t8_mb"].reshape(mb_h, mb_w)
        t8_f = t8_g.reshape(nmb)
        t8l, t8t = _nbr_grids(t8_g.to(I64), 0)
        slots.append(_sel(inter_f & (cbp_lf > 0),
                          dec((399 + t8l + t8t).reshape(nmb), t8_f)))
    # mb_qp_delta
    has_dqp = coded & (intra_f | (cbp_lf > 0) | (cbp_cf > 0))
    slots.extend(dqp_slots(out, has_dqp, nmb))
    header = torch.stack(slots, 1)

    # residual cbf contexts (cbf_ctxidxinc, encoder/cabac.c:508)
    intra_i = intra.to(I64)
    intra4 = intra_i.repeat_interleave(4, 0).repeat_interleave(4, 1)
    intra2 = intra_i.repeat_interleave(2, 0).repeat_interleave(2, 1)
    dcflag = (intra & (luma_dc != 0).any(-1).reshape(mb_h, mb_w)).to(I64)
    a, b = _nbr_grids(dcflag, 1)
    ctx_dc = (2 * b + a).reshape(nmb)
    grp_bit = (cbp_lf[:, None] >> (torch.arange(16, device=dev) // 4)) & 1
    ctx_ac = _cbf_ctx_from_grid((out["nnz4"] > 0).to(I64), intra4) \
        .reshape(mb_h, 4, mb_w, 4).transpose(1, 2).reshape(nmb, 16)[:, R]
    ctx_cdc, ctx_cac = [], []
    for ch in range(2):
        dcm = ((cbp_c > 0) & (chroma_dc[:, ch] != 0).any(-1)
               .reshape(mb_h, mb_w)).to(I64)
        ctx_cdc.append(_cbf_ctx_from_grid(dcm, intra_i).reshape(nmb))
        acm = ((chroma_ac[:, ch, :, 1:] != 0).any(-1)
               & (cbp_cf == 2)[:, None]).to(I64) \
            .reshape(mb_h, mb_w, 2, 2).transpose(1, 2) \
            .reshape(mb_h * 2, mb_w * 2)
        ctx_cac.append(_cbf_ctx_from_grid(acm, intra2)
                       .reshape(mb_h, 2, mb_w, 2).transpose(1, 2)
                       .reshape(nmb, 4))
    ctx_cdc = torch.stack(ctx_cdc, 1)
    ctx_cac = torch.stack(ctx_cac, 1)

    # residual blocks: I16 = DC cat 0 + AC cat 1; inter = cat 2
    dc_ops = residual_block_ops(luma_dc, 0, ctx_dc, intra_f)
    ac15 = residual_block_ops(luma_blocks[..., 1:].reshape(nmb * 16, 15), 1,
                              ctx_ac.reshape(nmb * 16),
                              (intra_f & (cbp_lf > 0)).repeat_interleave(16))
    full16 = residual_block_ops(luma_blocks.reshape(nmb * 16, 16), 2,
                                ctx_ac.reshape(nmb * 16),
                                (inter_f & ~t8_f).repeat_interleave(16)
                                & (grp_bit > 0).reshape(nmb * 16))
    ac15p = torch.cat([ac15, torch.full((nmb * 16, 1), PAD_OP, dtype=I64,
                                        device=dev)], 1)
    blk_ops = torch.where(intra_f.repeat_interleave(16)[:, None], ac15p,
                          full16).reshape(nmb, -1)
    if t8_mode:
        blk_ops = _with_blocks8(blk_ops, out["luma8_z"], t8_f, cbp_lf)
    cdc_ops = residual_block_ops(chroma_dc.reshape(nmb * 2, 4), 3,
                                 ctx_cdc.reshape(nmb * 2),
                                 (coded & (cbp_cf > 0)).repeat_interleave(2))
    cac_ops = residual_block_ops(chroma_ac[..., 1:].reshape(nmb * 8, 15), 4,
                                 ctx_cac.reshape(nmb * 8),
                                 (coded & (cbp_cf == 2)).repeat_interleave(8))
    is_last = torch.arange(nmb, device=dev) == nmb - 1
    term = torch.full((nmb,), KIND_TERMINAL << 29, dtype=I64, device=dev)
    return torch.cat([header, dc_ops, blk_ops, cdc_ops.reshape(nmb, -1),
                      cac_ops.reshape(nmb, -1), _sel(~is_last, term)[:, None]],
                     1).reshape(-1)


# ---------------------------------------------------------------- K3
def i_slice_ops(out: dict, mb_h: int, mb_w: int, t8_mode: bool = False):
    """K3 `cabac_i_ops`: the compacted op stream of an intra slice.

    Replaces x264_tpu/entropy/cabac_planes.py:i16_slice_ops followed by
    compact_ops (t8_mode: the transform flag of I_NxN MBs; `out` holds
    t8_mb / luma8_z where I8x8 ran, and under variance AQ K17's dqp and
    dqp_prev_nz planes, whose mb_qp_delta bins the MBs then carry). On
    CUDA tensors it runs
    csrc/cabac_ops.cu's three kernels: one thread per MB emits the MB's
    live ops and counts them, one CTA scans the counts, and a scatter
    packs the dense stream. Returns (ops int32 (capacity,), n_ops int32
    0-d tensor); entries at and past n_ops are unspecified on the card
    (zero in the plain version). On CPU tensors it runs the plain
    version."""
    if out["mode16"].device.type == "cpu":
        return i_slice_ops_plain(out, mb_h, mb_w, t8_mode)
    dev = out["mode16"].device
    nmb = mb_h * mb_w
    shapes = dict(mode16=((mb_h, mb_w), I32), modec=((mb_h, mb_w), I32),
                  i4_mb=((mb_h, mb_w), torch.bool),
                  i4_modes=((mb_h, mb_w, 4, 4), I32),
                  cbp_luma_bits=((mb_h, mb_w), I32),
                  luma_dc=((mb_h, mb_w, 16), I32),
                  luma_ac=((mb_h, mb_w, 16, 16), I32),
                  chroma_dc=((mb_h, mb_w, 2, 4), I32),
                  chroma_ac=((mb_h, mb_w, 2, 4, 16), I32))
    i8 = "t8_mb" in out
    if i8:
        shapes.update(t8_mb=((mb_h, mb_w), torch.bool),
                      luma8_z=((mb_h, mb_w, 4, 64), I32))
    aq = "dqp" in out
    if aq:
        shapes.update(dqp=((mb_h, mb_w), I32),
                      dqp_prev_nz=((mb_h, mb_w), torch.bool))
    for k, (shape, dt) in shapes.items():
        cuda.check(out[k], shape, dt, k)
    ptr = lambda k: out[k].data_ptr() if k in shapes else 0
    ptrs = [ptr(k) for k in (*list(shapes)[:9], "t8_mb", "luma8_z", "dqp",
                             "dqp_prev_nz")]
    scratch = torch.empty(nmb * OPS_PER_MB, dtype=I32, device=dev)
    counts = torch.empty(nmb, dtype=I32, device=dev)
    offsets = torch.empty(nmb + 1, dtype=I32, device=dev)
    ops = torch.empty(capacity(nmb), dtype=I32, device=dev)
    cuda.launch("cabac_ops", "cabac_i_ops", "p" * 17 + "iii" + "p",
                *ptrs, scratch.data_ptr(), counts.data_ptr(),
                offsets.data_ptr(), ops.data_ptr(), mb_h, mb_w, int(t8_mode),
                cuda.stream(dev))
    i_slice_ops.launches += 3          # emit, scan, scatter
    i_slice_ops.launches_t8 += 3 * int(t8_mode)
    i_slice_ops.launches_aq += 3 * int(aq)
    return ops, offsets[nmb]


# launches, and those of them in t8_mode and with mb_qp_delta planes
i_slice_ops.launches = i_slice_ops.launches_t8 = i_slice_ops.launches_aq = 0


# ---------------------------------------------------------------- K8
def has_dqp_p(maps: dict, front: dict):
    """The P MBs that code mb_qp_delta: not skipped, and intra or with
    coded luma or chroma (x264_tpu pipeline.encode_p_cabac)."""
    return ~maps["skip"] & (front["intra_mb"] | (front["cbp_luma_bits"] > 0)
                            | (front["cbp_chroma"] > 0))


def cabac_p_ops_plain(front: dict, mb_h: int, mb_w: int,
                      t8_mode: bool = False, aq=None, n_refs: int = 1):
    """Plain version of K8: the syntax maps of encoder/inter.py's
    p_maps_plain, under variance AQ (aq = (qp_map, slice_qp)) the dqp
    planes of encoder/aq.py:dqp_syntax, then compact_ops(p_slice_ops(...)).
    Returns (maps, ops, n_ops) with maps = dict(mv, mvd, mvd1, ptype,
    mv_sub, mvd_sub, mvd4, skip, nnz4, ref4, mv4, ref_idx, t8_mb with
    t8_mode, and with aq dqp, dqp_prev_nz and qp_eff, the QPs the MBs
    decode with)."""
    from ..encoder.inter import p_maps_plain
    maps = p_maps_plain(front, mb_h, mb_w)
    if aq is not None:
        from ..encoder.aq import dqp_syntax_plain
        maps["dqp"], maps["qp_eff"], maps["dqp_prev_nz"] = dqp_syntax_plain(
            aq[0], has_dqp_p(maps, front), aq[1])
    ops, n = compact_ops(p_slice_ops({**front, **maps}, mb_h, mb_w, n_refs,
                                     t8_mode=t8_mode),
                         capacity(mb_h * mb_w))
    return maps, ops, n


def _launch_p_maps(front: dict, mb_h: int, mb_w: int, t8_mode: bool):
    """Launch K8's pass A (csrc/cabac_ops.cu cabac_p_maps) on CUDA tensors;
    returns its maps as p_maps_plain does."""
    dev = front["intra_mb"].device
    shapes = dict(intra_mb=((mb_h, mb_w), torch.bool),
                  me_mv=((mb_h, mb_w, 2), I32),
                  ptype=((mb_h, mb_w), I32),
                  mv_quad=((mb_h, mb_w, 4, 2), I32),
                  cbp_luma_bits=((mb_h, mb_w), I32),
                  cbp_chroma=((mb_h, mb_w), I32),
                  luma_blocks=((mb_h, mb_w, 16, 16), I32))
    if t8_mode:
        shapes.update(t8_sel=((mb_h, mb_w), torch.bool),
                      luma8_z=((mb_h, mb_w, 4, 64), I32))
    if "ref_sel" in front:
        shapes["ref_sel"] = ((mb_h, mb_w), I32)
    for k, (shape, dt) in shapes.items():
        cuda.check(front[k], shape, dt, k)
    fp = lambda k: front[k].data_ptr() if k in shapes else 0
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    maps = dict(skip=e(mb_h, mb_w, dt=torch.bool), mv=e(mb_h, mb_w, 2),
                mvd=e(mb_h, mb_w, 2), mvd1=e(mb_h, mb_w, 2),
                ptype=e(mb_h, mb_w), mv_sub=e(mb_h, mb_w, 4, 2),
                mvd_sub=e(mb_h, mb_w, 4, 2), mvd4=e(mb_h * 4, mb_w * 4, 2),
                nnz4=e(mb_h * 4, mb_w * 4), ref4=e(mb_h * 4, mb_w * 4),
                mv4=e(mb_h * 4, mb_w * 4, 2), ref_idx=e(mb_h, mb_w))
    if t8_mode:
        maps["t8_mb"] = e(mb_h, mb_w, dt=torch.bool)
    mp = lambda k: maps[k].data_ptr() if k in maps else 0
    cuda.launch("cabac_ops", "cabac_p_maps", "p" * 23 + "ii" + "p",
                *[fp(k) for k in ("intra_mb", "me_mv", "ptype", "mv_quad",
                                  "cbp_luma_bits", "cbp_chroma",
                                  "luma_blocks", "t8_sel", "luma8_z",
                                  "ref_sel")],
                *[mp(k) for k in ("skip", "mv", "mvd", "mvd1", "ptype",
                                  "mv_sub", "mvd_sub", "mvd4", "nnz4",
                                  "ref4", "mv4", "t8_mb", "ref_idx")],
                mb_h, mb_w, cuda.stream(dev))
    return maps


def p_maps(front: dict, mb_h: int, mb_w: int) -> dict:
    """K8's pass A alone (`cabac_p_maps`), for the CAVLC P slice: the MV
    prediction of every partition, P_Skip, the mvds and the 4x4 maps of
    encoder/inter.py:p_maps_plain, its plain version, which runs on CPU
    tensors. Replaces the stage-4 map derivation of
    x264_tpu/encoder/inter.py:encode_p_body (inter.py:733-842) with
    encoder/mvpred.py's predictors; under two references (front holds
    ref_sel) each MB predicts with its own reference as i_ref. One
    launch, counted here; the CABAC path's pass A counts under
    cabac_p_ops."""
    if front["intra_mb"].device.type == "cpu":
        from ..encoder.inter import p_maps_plain
        return p_maps_plain(front, mb_h, mb_w)
    maps = _launch_p_maps(front, mb_h, mb_w, False)
    p_maps.launches += 1
    p_maps.launches_ref2 += int("ref_sel" in front)
    return maps


# launches, and those of them with two references
p_maps.launches = p_maps.launches_ref2 = 0


def cabac_p_ops(front: dict, mb_h: int, mb_w: int, n_refs: int = 1,
                t8_mode: bool = False, aq=None):
    """K8 `cabac_p_ops`: stage 4 of the P encode and the compacted CABAC
    op stream of the P slice.

    Replaces x264_tpu/encoder/mvpred.py:predict_16x16 / predict_pskip /
    predict_16x8 / predict_8x16 / predict_p8x8, the skip / mvd / map
    derivation of encoder/inter.py:encode_p_body (stage 4, with t8_mb and
    the 8x8 nnz cells) and x264_tpu/entropy/cabac_planes.py:p_slice_ops
    followed by compact_ops. `front` holds the merged planes of
    encoder/inter.py:encode_p_front (with t8_sel and luma8_z where
    t8_mode). aq = (qp_map, slice_qp) under variance AQ: K17 runs between
    the passes on the skip flags pass A found, and the MBs carry their
    mb_qp_delta. On CUDA tensors it runs csrc/cabac_ops.cu: pass A (one
    thread per MB: the MV prediction of every partition, skip, the mvds,
    t8_mb and the 4x4 maps), pass B (one thread per MB emits its live
    ops), then K3's exclusive scan and scatter; on CPU tensors the plain
    version. n_refs 2 (front then holds ref_sel): pass A predicts each MB
    with its own reference and keeps reference-1 MBs from P_Skip, pass B
    codes each partition's ref_idx bins before its mvds. Returns as
    cabac_p_ops_plain; ops entries at and past n_ops are unspecified on
    the card."""
    if front["intra_mb"].device.type == "cpu":
        return cabac_p_ops_plain(front, mb_h, mb_w, t8_mode, aq, n_refs)
    dev = front["intra_mb"].device
    nmb = mb_h * mb_w
    shapes = dict(mode16=((mb_h, mb_w), I32), modec=((mb_h, mb_w), I32),
                  luma_dc=((mb_h, mb_w, 16), I32),
                  chroma_dc=((mb_h, mb_w, 2, 4), I32),
                  chroma_ac=((mb_h, mb_w, 2, 4, 16), I32))
    for k, (shape, dt) in shapes.items():
        cuda.check(front[k], shape, dt, k)
    maps = _launch_p_maps(front, mb_h, mb_w, t8_mode)
    fp = lambda k: front[k].data_ptr() if t8_mode or k != "luma8_z" else 0
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    mp = lambda k: maps[k].data_ptr() if k in maps else 0
    stream = cuda.stream(dev)
    if aq is not None:
        from ..encoder.aq import dqp_syntax
        maps["dqp"], maps["qp_eff"], maps["dqp_prev_nz"] = dqp_syntax(
            aq[0], has_dqp_p(maps, front), aq[1])
    scratch = e(nmb * OPS_PER_MB)
    counts, offsets = e(nmb), e(nmb + 1)
    ops = e(capacity(nmb))
    refs = n_refs > 1
    cuda.launch("cabac_ops", "cabac_p_emit", "p" * 26 + "iii" + "p",
                fp("intra_mb"), mp("skip"), mp("ptype"),
                *[fp(k) for k in ("mode16", "modec", "cbp_luma_bits",
                                  "cbp_chroma", "luma_dc", "luma_blocks",
                                  "chroma_dc", "chroma_ac")],
                *[mp(k) for k in ("mvd", "mvd1", "mvd_sub", "mvd4", "nnz4",
                                  "t8_mb")],
                fp("luma8_z"), mp("dqp"), mp("dqp_prev_nz"),
                mp("ref4") if refs else 0, mp("ref_idx") if refs else 0,
                scratch.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
                ops.data_ptr(), mb_h, mb_w, int(t8_mode), stream)
    cabac_p_ops.launches += 4          # pass A, pass B, scan, scatter
    cabac_p_ops.launches_t8 += 4 * int(t8_mode)
    cabac_p_ops.launches_aq += 4 * int(aq is not None)
    cabac_p_ops.launches_ref2 += 4 * int(refs)
    return maps, ops, offsets[nmb]


# launches, and those of them in t8_mode, with mb_qp_delta planes and
# with two references
cabac_p_ops.launches = cabac_p_ops.launches_t8 = cabac_p_ops.launches_aq = \
    cabac_p_ops.launches_ref2 = 0


# ---------------------------------------------------------------- K24
def b_slice_ops(out: dict, mb_h: int, mb_w: int, t8_mode: bool = False):
    """Packed op planes of a whole B CABAC slice (x264_macroblock_write_
    cabac B branch, x264_cabac_mb_type's B table and x264_cabac_mb_skip,
    encoder/cabac.c:123-190, 300-306): B_SKIP by the skip flag (ctx 24 +
    the non-skip neighbours), B_Direct_16x16 as the single mb_type bin 0,
    then B_L0 / B_L1 / B_Bi_16x16 with their mvds per list and I16x16;
    t8_mode: the PPS enables the 8x8 transform, and inter MBs with coded
    luma code transform_size_8x8_flag 0 (B MBs keep the 4x4 transform);
    mb_qp_delta is 0 (x264_tpu's B frames run at the frame QP). `out`
    holds the keys of encoder/inter.py:encode_b_body_plain. Returns the
    flat int64 slot stream."""
    nmb = mb_h * mb_w
    dev = out["intra_mb"].device
    R = torch.as_tensor(tables.LUMA4x4_RASTER_OF_Z, device=dev).long()
    intra = out["intra_mb"].reshape(mb_h, mb_w)
    skip = out["skip"].reshape(mb_h, mb_w)
    direct = out["direct_mb"].reshape(mb_h, mb_w)
    cbp_l = out["cbp_luma_bits"].reshape(mb_h, mb_w).to(I64)
    cbp_c = out["cbp_chroma"].reshape(mb_h, mb_w).to(I64)
    luma_blocks = out["luma_blocks"].reshape(nmb, 16, 16)
    luma_dc = out["luma_dc"].reshape(nmb, 16)
    chroma_dc = out["chroma_dc"].reshape(nmb, 2, 4)
    chroma_ac = out["chroma_ac"].reshape(nmb, 2, 4, 16)
    mode16 = out["mode16"].reshape(nmb).to(I64)
    modec = torch.where(intra, out["modec"].reshape(mb_h, mb_w), 0).to(I64)
    bmode = out["bmode"].reshape(nmb)
    intra_f, skip_f = intra.reshape(nmb), skip.reshape(nmb)
    direct_f = direct.reshape(nmb)
    coded = ~skip_f
    interc_f = coded & ~intra_f            # codes cbp / residual
    expl_f = interc_f & ~direct_f          # codes mb_type bins 1+ / mvds
    cbp_lf, cbp_cf = cbp_l.reshape(nmb), cbp_c.reshape(nmb)
    dec = lambda ctx, b: op(KIND_DECISION, ctx, b)

    a, b = _nbr_grids((~skip).to(I64), 0)
    slots = [dec((24 + a + b).reshape(nmb), skip_f)]
    # mb_type, the D_16x16 rows of the B table: B_Direct_16x16 {0}; L0
    # {1,0,0}, L1 {1,0,1}, Bi {1,1,0,0,0,0}; the intra prefix
    # {1,1,1,1,0,1} and the I16 suffix at ctxs 32-35. Bin 0's ctx counts
    # the available neighbours that are neither B_SKIP nor direct
    a, b = _nbr_grids((~(skip | direct)).to(I64), 0)
    is_bi = expl_f & (bmode == 2)
    slots += [_sel(coded, dec((27 + a + b).reshape(nmb), ~direct_f)),
              _sel(coded & ~direct_f, dec(30, intra_f | is_bi)),
              _sel(expl_f & ~is_bi, dec(32, bmode == 1)),
              _sel(is_bi, dec(31, 0)), _sel(is_bi, dec(32, 0)),
              _sel(is_bi, dec(32, 0)), _sel(is_bi, dec(32, 0)),
              _sel(intra_f, dec(31, 1)), _sel(intra_f, dec(32, 1)),
              _sel(intra_f, dec(32, 0)), _sel(intra_f, dec(32, 1)),
              _sel(intra_f, dec(32, 1)),
              _sel(intra_f, torch.full((nmb,), KIND_TERMINAL << 29,
                                       dtype=I64, device=dev)),
              _sel(intra_f, dec(33, cbp_lf > 0)),
              _sel(intra_f, dec(34, cbp_cf > 0)),
              _sel(intra_f & (cbp_cf > 0), dec(34, cbp_cf == 2)),
              _sel(intra_f, dec(35, mode16 >> 1)),
              _sel(intra_f, dec(35, mode16 & 1))]
    cm_l, cm_t = _nbr_grids(modec, 0)
    cctx = (64 + (cm_l != 0).to(I64) + (cm_t != 0).to(I64)).reshape(nmb)
    cm = modec.reshape(nmb)
    slots += [_sel(intra_f, dec(cctx, cm > 0)),
              _sel(intra_f & (cm > 0), dec(67, cm > 1)),
              _sel(intra_f & (cm > 1), dec(67, cm > 2))]
    # the mvds of L0 then L1; ctxInc from the same list's |mvd| of the
    # left and top 4x4 neighbours
    for k in (0, 1):
        mvdp = out[f"mvd_l{k}"].reshape(nmb, 2).to(I64)
        act = out[f"use_l{k}"].reshape(nmb)
        mvd4 = out[f"mvd4_l{k}"].to(I64)
        for comp, base in ((0, 40), (1, 47)):
            ma, mb_ = _nbr_grids(mvd4[..., comp].abs(), 0)
            am = (ma[0::4, 0::4] + mb_[0::4, 0::4]).reshape(nmb)
            inc = (am > 2).to(I64) + (am > 32).to(I64)
            slots += _mvd_component_ops(mvdp[:, comp], base, inc, act)
    # coded_block_pattern of the inter MBs
    cbl_l, cbl_t = _nbr_grids(cbp_l, -1)
    ctxs = (76 - ((cbl_l >> 1) & 1) - ((cbl_t >> 1) & 2),
            76 - (cbp_l & 1) - ((cbl_t >> 2) & 2),
            76 - ((cbl_l >> 3) & 1) - ((cbp_l << 1) & 2),
            76 - ((cbp_l >> 2) & 1) - (cbp_l & 2))
    for k, cx in enumerate(ctxs):
        slots.append(_sel(interc_f, dec(cx.reshape(nmb), (cbp_lf >> k) & 1)))
    cbc_l, cbc_t = _nbr_grids(cbp_c, -1)
    c0 = 77 + (cbc_l > 0).to(I64) + 2 * (cbc_t > 0).to(I64)
    c1 = 81 + (cbc_l == 2).to(I64) + 2 * (cbc_t == 2).to(I64)
    slots += [_sel(interc_f, dec(c0.reshape(nmb), cbp_cf > 0)),
              _sel(interc_f & (cbp_cf > 0), dec(c1.reshape(nmb),
                                                 cbp_cf == 2))]
    if t8_mode:
        slots.append(_sel(interc_f & (cbp_lf > 0), dec(399, 0)))
    has_dqp = coded & (intra_f | (cbp_lf > 0) | (cbp_cf > 0))
    slots.append(_sel(has_dqp, dec(60, 0)))
    header = torch.stack(slots, 1)

    # residual cbf contexts and blocks, as p_slice_ops without t8
    intra_i = intra.to(I64)
    intra4 = intra_i.repeat_interleave(4, 0).repeat_interleave(4, 1)
    intra2 = intra_i.repeat_interleave(2, 0).repeat_interleave(2, 1)
    dcflag = (intra & (luma_dc != 0).any(-1).reshape(mb_h, mb_w)).to(I64)
    a, b = _nbr_grids(dcflag, 1)
    ctx_dc = (2 * b + a).reshape(nmb)
    grp_bit = (cbp_lf[:, None] >> (torch.arange(16, device=dev) // 4)) & 1
    ctx_ac = _cbf_ctx_from_grid((out["nnz4"] > 0).to(I64), intra4) \
        .reshape(mb_h, 4, mb_w, 4).transpose(1, 2).reshape(nmb, 16)[:, R]
    ctx_cdc, ctx_cac = [], []
    for ch in range(2):
        dcm = ((cbp_c > 0) & (chroma_dc[:, ch] != 0).any(-1)
               .reshape(mb_h, mb_w)).to(I64)
        ctx_cdc.append(_cbf_ctx_from_grid(dcm, intra_i).reshape(nmb))
        acm = ((chroma_ac[:, ch, :, 1:] != 0).any(-1)
               & (cbp_cf == 2)[:, None]).to(I64) \
            .reshape(mb_h, mb_w, 2, 2).transpose(1, 2) \
            .reshape(mb_h * 2, mb_w * 2)
        ctx_cac.append(_cbf_ctx_from_grid(acm, intra2)
                       .reshape(mb_h, 2, mb_w, 2).transpose(1, 2)
                       .reshape(nmb, 4))
    ctx_cdc = torch.stack(ctx_cdc, 1)
    ctx_cac = torch.stack(ctx_cac, 1)
    dc_ops = residual_block_ops(luma_dc, 0, ctx_dc, intra_f)
    ac15 = residual_block_ops(luma_blocks[..., 1:].reshape(nmb * 16, 15), 1,
                              ctx_ac.reshape(nmb * 16),
                              (intra_f & (cbp_lf > 0)).repeat_interleave(16))
    full16 = residual_block_ops(luma_blocks.reshape(nmb * 16, 16), 2,
                                ctx_ac.reshape(nmb * 16),
                                interc_f.repeat_interleave(16)
                                & (grp_bit > 0).reshape(nmb * 16))
    ac15p = torch.cat([ac15, torch.full((nmb * 16, 1), PAD_OP, dtype=I64,
                                        device=dev)], 1)
    blk_ops = torch.where(intra_f.repeat_interleave(16)[:, None], ac15p,
                          full16).reshape(nmb, -1)
    cdc_ops = residual_block_ops(chroma_dc.reshape(nmb * 2, 4), 3,
                                 ctx_cdc.reshape(nmb * 2),
                                 (cbp_cf > 0).repeat_interleave(2))
    cac_ops = residual_block_ops(chroma_ac[..., 1:].reshape(nmb * 8, 15), 4,
                                 ctx_cac.reshape(nmb * 8),
                                 (cbp_cf == 2).repeat_interleave(8))
    is_last = torch.arange(nmb, device=dev) == nmb - 1
    term = torch.full((nmb,), KIND_TERMINAL << 29, dtype=I64, device=dev)
    return torch.cat([header, dc_ops, blk_ops, cdc_ops.reshape(nmb, -1),
                      cac_ops.reshape(nmb, -1), _sel(~is_last, term)[:, None]],
                     1).reshape(-1)


def cabac_b_ops_plain(front: dict, mb_h: int, mb_w: int,
                      t8_mode: bool = False):
    """Plain version of K24: the maps of encoder/inter.py's b_maps_plain,
    then compact_ops(b_slice_ops(...)). Returns (maps, ops, n_ops)."""
    from ..encoder.inter import b_maps_plain
    maps = b_maps_plain(front, mb_h, mb_w)
    ops, n = compact_ops(b_slice_ops({**front, **maps}, mb_h, mb_w, t8_mode),
                         capacity(mb_h * mb_w))
    return maps, ops, n


def cabac_b_ops(front: dict, mb_h: int, mb_w: int, t8_mode: bool = False):
    """K24 `cabac_b_ops`: stage 4 of the B encode and the compacted CABAC
    op stream of the B slice.

    Replaces the map derivation of x264_tpu/encoder/inter.py:
    encode_b_body's stage 4 (inter.py:1174-1224, with mvpred.py's
    predict_16x16 per list) and x264_tpu/entropy/cabac_planes.py:
    b_slice_ops followed by compact_ops. `front` holds the planes of
    encoder/inter.py:encode_b_front. On CUDA tensors it runs
    csrc/cabac_ops.cu: pass A (one thread per MB: each list's maps, MV
    prediction and mvd, the skip flag and nnz4), pass B (one thread per
    MB emits its live ops), then K3's scan and scatter; on CPU tensors the
    plain version. Returns as cabac_b_ops_plain; ops entries at and past
    n_ops are unspecified on the card."""
    if front["intra_mb"].device.type == "cpu":
        return cabac_b_ops_plain(front, mb_h, mb_w, t8_mode)
    dev = front["intra_mb"].device
    nmb = mb_h * mb_w
    shapes = dict(intra_mb=((mb_h, mb_w), torch.bool),
                  direct_mb=((mb_h, mb_w), torch.bool),
                  bmode=((mb_h, mb_w), I32), r0=((mb_h, mb_w), I32),
                  r1=((mb_h, mb_w), I32), m0=((mb_h, mb_w, 2), I32),
                  m1=((mb_h, mb_w, 2), I32),
                  cbp_luma_bits=((mb_h, mb_w), I32),
                  cbp_chroma=((mb_h, mb_w), I32),
                  luma_blocks=((mb_h, mb_w, 16, 16), I32),
                  mode16=((mb_h, mb_w), I32), modec=((mb_h, mb_w), I32),
                  luma_dc=((mb_h, mb_w, 16), I32),
                  chroma_dc=((mb_h, mb_w, 2, 4), I32),
                  chroma_ac=((mb_h, mb_w, 2, 4, 16), I32))
    for k, (shape, dt) in shapes.items():
        cuda.check(front[k], shape, dt, k)
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    maps = dict(use_l0=e(mb_h, mb_w, dt=torch.bool),
                use_l1=e(mb_h, mb_w, dt=torch.bool),
                mvd_l0=e(mb_h, mb_w, 2), mvd_l1=e(mb_h, mb_w, 2),
                mvd4_l0=e(mb_h * 4, mb_w * 4, 2),
                mvd4_l1=e(mb_h * 4, mb_w * 4, 2),
                skip=e(mb_h, mb_w, dt=torch.bool), nnz4=e(mb_h * 4, mb_w * 4),
                ref4=e(mb_h * 4, mb_w * 4), mv4=e(mb_h * 4, mb_w * 4, 2),
                ref4_l1=e(mb_h * 4, mb_w * 4),
                mv4_l1=e(mb_h * 4, mb_w * 4, 2))
    scratch = e(nmb * OPS_PER_MB)
    counts, offsets = e(nmb), e(nmb + 1)
    ops = e(capacity(nmb))
    cuda.launch("cabac_ops", "cabac_b_ops", "p" * 31 + "iii" + "p",
                *[front[k].data_ptr() for k in shapes],
                *[maps[k].data_ptr() for k in maps],
                scratch.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
                ops.data_ptr(), mb_h, mb_w, int(t8_mode), cuda.stream(dev))
    cabac_b_ops.launches += 4          # pass A, pass B, scan, scatter
    return maps, ops, offsets[nmb]


cabac_b_ops.launches = 0

# front planes K24's pass A reads, in its entry points' order
B_MAPS_IN = ("intra_mb", "direct_mb", "bmode", "r0", "r1", "m0", "m1",
             "cbp_luma_bits", "cbp_chroma", "luma_blocks")


def b_maps(front: dict, mb_h: int, mb_w: int) -> dict:
    """K24's pass A alone (`cabac_b_maps`), for the CAVLC B slice: each
    list's 4x4 ref / mv maps, 16x16 MV prediction and mvd, use_l0 /
    use_l1, B_SKIP and nnz4 of encoder/inter.py:b_maps_plain, its plain
    version, which runs on CPU tensors. Replaces the stage-4 map
    derivation of x264_tpu/encoder/inter.py:encode_b_body (inter.py:
    1174-1224) as x264_tpu/encoder/pipeline.py:encode_b runs it. One
    launch, counted here; the CABAC path's pass A counts under
    cabac_b_ops."""
    if front["intra_mb"].device.type == "cpu":
        from ..encoder.inter import b_maps_plain
        return b_maps_plain(front, mb_h, mb_w)
    dev = front["intra_mb"].device
    g, g2 = (mb_h, mb_w), (mb_h, mb_w, 2)
    shapes = dict(intra_mb=(g, torch.bool), direct_mb=(g, torch.bool),
                  bmode=(g, I32), r0=(g, I32), r1=(g, I32), m0=(g2, I32),
                  m1=(g2, I32), cbp_luma_bits=(g, I32),
                  cbp_chroma=(g, I32),
                  luma_blocks=((mb_h, mb_w, 16, 16), I32))
    for k, (shape, dt) in shapes.items():
        cuda.check(front[k], shape, dt, k)
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    maps = dict(use_l0=e(*g, dt=torch.bool), use_l1=e(*g, dt=torch.bool),
                mvd_l0=e(*g2), mvd_l1=e(*g2),
                mvd4_l0=e(mb_h * 4, mb_w * 4, 2),
                mvd4_l1=e(mb_h * 4, mb_w * 4, 2),
                skip=e(*g, dt=torch.bool), nnz4=e(mb_h * 4, mb_w * 4),
                ref4=e(mb_h * 4, mb_w * 4), mv4=e(mb_h * 4, mb_w * 4, 2),
                ref4_l1=e(mb_h * 4, mb_w * 4),
                mv4_l1=e(mb_h * 4, mb_w * 4, 2))
    cuda.launch("cabac_ops", "cabac_b_maps", "p" * 22 + "ii" + "p",
                *[front[k].data_ptr() for k in B_MAPS_IN],
                *[maps[k].data_ptr() for k in maps], mb_h, mb_w,
                cuda.stream(dev))
    b_maps.launches += 1
    return maps


b_maps.launches = 0

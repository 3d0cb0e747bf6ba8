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
and I16x16 MBs with one reference, at one QP, with or without the 8x8
transform (transform_size_8x8_flag and the cat-5 luma blocks); ref_idx
and mb_qp_delta values from AQ come with later slices.
"""

from __future__ import annotations

import torch

from .. import cuda
from .. import tables

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
# the sixteen 4x4 blocks, so the bound holds
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
    # mb_qp_delta = 0 (one QP per slice; x264_cabac_mb_qp_delta,
    # encoder/cabac.c:271)
    has_dqp = ~i4f | (cbp_lf > 0) | (cbp_chroma > 0)
    h2.append(_sel(has_dqp, op(KIND_DECISION, 60, 0)))
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
    P_Skip and I16x16 MBs with one reference and one QP; t8_mode: the PPS
    enables the 8x8 transform (out then holds t8_mb and luma8_z), so
    inter MBs with coded luma carry transform_size_8x8_flag and the
    8x8-transform MBs their cat-5 blocks. `out` holds the keys of
    encoder/inter.py:encode_p_body. Returns the flat int64 slot
    stream."""
    if n_refs != 1:
        raise NotImplementedError(
            "multiple references in P slices come with a later slice of "
            "the port")
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
    # mvd per partition in syntax order; ctxInc from the partition's left
    # / top 4x4 neighbours' |mvd| (x264_cabac_mb_mvd_cpn amvd,
    # encoder/cabac.c:397-401). A partition's first 4x4 block: part 0 at
    # (4Y, 4X); part 1 at (4Y+2, 4X) for 16x8, (4Y, 4X+2) for 8x16 and
    # P8x8 sub-block 1; sub-blocks 2 / 3 at (4Y+2, 4X) / (4Y+2, 4X+2)
    amvd = [_nbr_grids(mvd4[..., comp].abs(), 0) for comp in (0, 1)]
    r1 = torch.where(ptype_g == 1, 2, 0)
    c1 = torch.where((ptype_g == 2) | (ptype_g == 3), 2, 0)
    parts = ((torch.where(p8_f[:, None], mvd_sub[:, 0], mvd), inter_f, 0, 0),
             (torch.where(p8_f[:, None], mvd_sub[:, 1], mvd1),
              inter_f & (ptype_f != 0), r1, c1),
             (mvd_sub[:, 2], inter_f & p8_f, 2, 0),
             (mvd_sub[:, 3], inter_f & p8_f, 2, 2))
    gy = torch.arange(mb_h, device=dev)[:, None] * 4
    gx = torch.arange(mb_w, device=dev)[None, :] * 4
    for mvdp, act, dr, dc in parts:
        r, c = (gy + dr).expand(mb_h, mb_w), (gx + dc).expand(mb_h, mb_w)
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
    # mb_qp_delta = 0 (one QP per slice)
    has_dqp = coded & (intra_f | (cbp_lf > 0) | (cbp_cf > 0))
    slots.append(_sel(has_dqp, dec(60, 0)))
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
    t8_mb / luma8_z where I8x8 ran). On CUDA tensors it runs
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
    for k, (shape, dt) in shapes.items():
        cuda.check(out[k], shape, dt, k)
    ptrs = [out[k].data_ptr() for k in shapes]
    if not i8:
        ptrs += [0, 0]
    scratch = torch.empty(nmb * OPS_PER_MB, dtype=I32, device=dev)
    counts = torch.empty(nmb, dtype=I32, device=dev)
    offsets = torch.empty(nmb + 1, dtype=I32, device=dev)
    ops = torch.empty(capacity(nmb), dtype=I32, device=dev)
    cuda.launch("cabac_ops", "cabac_i_ops", "p" * 15 + "iii" + "p",
                *ptrs, scratch.data_ptr(), counts.data_ptr(),
                offsets.data_ptr(), ops.data_ptr(), mb_h, mb_w, int(t8_mode),
                cuda.stream(dev))
    i_slice_ops.launches += 3          # emit, scan, scatter
    i_slice_ops.launches_t8 += 3 * int(t8_mode)
    return ops, offsets[nmb]


# launches, and those of them in t8_mode
i_slice_ops.launches = i_slice_ops.launches_t8 = 0


# ---------------------------------------------------------------- K8
def cabac_p_ops_plain(front: dict, mb_h: int, mb_w: int,
                      t8_mode: bool = False):
    """Plain version of K8: the syntax maps of encoder/inter.py's
    p_maps_plain, then compact_ops(p_slice_ops(...)). Returns (maps,
    ops, n_ops) with maps = dict(mv, mvd, mvd1, ptype, mv_sub, mvd_sub,
    mvd4, skip, nnz4, ref4, mv4, and t8_mb with t8_mode)."""
    from ..encoder.inter import p_maps_plain
    maps = p_maps_plain(front, mb_h, mb_w)
    ops, n = compact_ops(p_slice_ops({**front, **maps}, mb_h, mb_w,
                                     t8_mode=t8_mode),
                         capacity(mb_h * mb_w))
    return maps, ops, n


def cabac_p_ops(front: dict, mb_h: int, mb_w: int, n_refs: int = 1,
                t8_mode: bool = False):
    """K8 `cabac_p_ops`: stage 4 of the P encode and the compacted CABAC
    op stream of the P slice.

    Replaces x264_tpu/encoder/mvpred.py:predict_16x16 / predict_pskip /
    predict_16x8 / predict_8x16 / predict_p8x8, the skip / mvd / map
    derivation of encoder/inter.py:encode_p_body (stage 4, with t8_mb and
    the 8x8 nnz cells) and x264_tpu/entropy/cabac_planes.py:p_slice_ops
    followed by compact_ops. `front` holds the merged planes of
    encoder/inter.py:encode_p_front (with t8_sel and luma8_z where
    t8_mode). On CUDA tensors it runs csrc/cabac_ops.cu: pass A (one
    thread per MB: the MV prediction of every partition, skip, the mvds,
    t8_mb and the 4x4 maps), pass B (one thread per MB emits its live
    ops), then K3's exclusive scan and scatter; on CPU tensors the plain
    version. Multiple references raise. Returns as cabac_p_ops_plain;
    ops entries at and past n_ops are unspecified on the card."""
    if n_refs != 1:
        raise NotImplementedError(
            "multiple references in P slices come with a later slice of "
            "the port")
    if front["intra_mb"].device.type == "cpu":
        return cabac_p_ops_plain(front, mb_h, mb_w, t8_mode)
    dev = front["intra_mb"].device
    nmb = mb_h * mb_w
    shapes = dict(intra_mb=((mb_h, mb_w), torch.bool),
                  me_mv=((mb_h, mb_w, 2), I32),
                  ptype=((mb_h, mb_w), I32),
                  mv_quad=((mb_h, mb_w, 4, 2), I32),
                  mode16=((mb_h, mb_w), I32), modec=((mb_h, mb_w), I32),
                  cbp_luma_bits=((mb_h, mb_w), I32),
                  cbp_chroma=((mb_h, mb_w), I32),
                  luma_dc=((mb_h, mb_w, 16), I32),
                  luma_blocks=((mb_h, mb_w, 16, 16), I32),
                  chroma_dc=((mb_h, mb_w, 2, 4), I32),
                  chroma_ac=((mb_h, mb_w, 2, 4, 16), I32))
    if t8_mode:
        shapes.update(t8_sel=((mb_h, mb_w), torch.bool),
                      luma8_z=((mb_h, mb_w, 4, 64), I32))
    for k, (shape, dt) in shapes.items():
        cuda.check(front[k], shape, dt, k)
    ins = [front[k].data_ptr() for k in shapes]
    if not t8_mode:
        ins += [0, 0]
    e = lambda *s, dt=I32: torch.empty(s, dtype=dt, device=dev)
    maps = dict(skip=e(mb_h, mb_w, dt=torch.bool), mv=e(mb_h, mb_w, 2),
                mvd=e(mb_h, mb_w, 2), mvd1=e(mb_h, mb_w, 2),
                ptype=e(mb_h, mb_w), mv_sub=e(mb_h, mb_w, 4, 2),
                mvd_sub=e(mb_h, mb_w, 4, 2), mvd4=e(mb_h * 4, mb_w * 4, 2),
                nnz4=e(mb_h * 4, mb_w * 4), ref4=e(mb_h * 4, mb_w * 4),
                mv4=e(mb_h * 4, mb_w * 4, 2))
    if t8_mode:
        maps["t8_mb"] = e(mb_h, mb_w, dt=torch.bool)
    outs = [maps[k].data_ptr() for k in maps]
    if not t8_mode:
        outs.append(0)
    scratch = e(nmb * OPS_PER_MB)
    counts, offsets = e(nmb), e(nmb + 1)
    ops = e(capacity(nmb))
    cuda.launch("cabac_ops", "cabac_p_ops", "p" * 30 + "iii" + "p",
                *ins, *outs, scratch.data_ptr(), counts.data_ptr(),
                offsets.data_ptr(), ops.data_ptr(), mb_h, mb_w, int(t8_mode),
                cuda.stream(dev))
    cabac_p_ops.launches += 4          # pass A, pass B, scan, scatter
    cabac_p_ops.launches_t8 += 4 * int(t8_mode)
    return maps, ops, offsets[nmb]


# launches, and those of them in t8_mode
cabac_p_ops.launches = cabac_p_ops.launches_t8 = 0

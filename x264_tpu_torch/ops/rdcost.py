"""Batched RD-cost machinery (the x264_rd_cost_mb role, encoder/rdo.c:
139-244) — plain PyTorch twin of x264_tpu/ops/rdcost.py.

A candidate mode is priced as ssd + lambda2 * bits, where the bits of its
residual levels come from the slice-initial CABAC states
(``trellis.make_consts``): the significance and last flags in scan order,
then the levels in reverse scan order through the 8-node context machine.
Every table entry and every ``trellis._ue_big_f8`` is an integer in 1/256-bit
units, so the sums here run in int32 and turn into float32 once; that
equals x264_tpu's float32 sums while a block's total stays below 2^24.
The CUDA kernels K13 (csrc/rdcost.cu) and K7 (csrc/intra_p.cu) run the
same walk from csrc/rdcost.cuh on the packed tables of ``pack_rdbits``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from . import trellis as otrellis

I32 = torch.int32
F32 = torch.float32

RD_CATS = 6
# int32 layout of one category in the packed table csrc/rdcost.cuh reads:
# sig (C, 2) at 0, last (C, 2) at 128, l1 (8, 2) at 256, unary (8, 15) at
# 272 (C <= 64)
RD_SIG, RD_LAST, RD_L1, RD_UNARY, RD_CAT_STRIDE = 0, 128, 256, 272, 392


def make_rdbits(qp: int, cabac_init_idc: int, device,
                qt: tables.QuantTables | None = None) -> dict:
    """{"cat0".."cat5": {sig, last, l1, unary}} as int32 tensors: the bit
    costs of make_consts(qp, cat, CQM_4PY (CQM_8PY for cat 5), P slice,
    cabac_init_idc), as x264_tpu's Encoder._qtab_p builds its rdbits."""
    out = {}
    for c in range(RD_CATS):
        lst = tables.CQM_8PY if c == 5 else tables.CQM_4PY
        k = otrellis.make_consts(qp, c, lst, False, cabac_init_idc, qt=qt)
        out[f"cat{c}"] = {n: torch.as_tensor(k[n].astype(np.int32),
                                             device=device)
                          for n in ("sig", "last", "l1", "unary")}
    return out


def pack_rdbits(rdbits: dict) -> torch.Tensor:
    """The six categories' bit tables as one int32 vector of
    RD_CATS * RD_CAT_STRIDE entries (the layout csrc/rdcost.cuh reads)."""
    dev = rdbits["cat0"]["sig"].device
    out = torch.zeros(RD_CATS * RD_CAT_STRIDE, dtype=I32, device=dev)
    for c in range(RD_CATS):
        base = c * RD_CAT_STRIDE
        for name, off in (("sig", RD_SIG), ("last", RD_LAST), ("l1", RD_L1),
                          ("unary", RD_UNARY)):
            t = rdbits[f"cat{c}"][name].reshape(-1).to(I32)
            out[base + off:base + off + t.numel()] = t
    return out


def residual_bits_i32(lv_scan, tc):
    """Estimated CABAC bits (1/256 units, int32) to code each block's
    levels. lv_scan: (N, C) signed levels in scan order; tc: one category
    of make_rdbits. An all-zero block costs 0 (the caller charges the
    coded_block_flag / CBP). Mirrors block_residual_write_cabac
    (encoder/cabac.c:584-781): sig flags for scan positions <= last
    (capped at C-2), last flags at the significant ones, then the levels
    in reverse scan order through the 8-node context machine."""
    N, C = lv_scan.shape
    dev = lv_scan.device
    lv_scan = lv_scan.to(I32)
    nz = lv_scan != 0
    pos = torch.arange(C, dtype=I32, device=dev)
    last = torch.where(nz, pos, -1).amax(1)
    sig, lastt = tc["sig"].to(I32), tc["last"].to(I32)
    bits = torch.zeros(N, dtype=I32, device=dev)
    for i in range(C - 1):
        on = i <= last
        nz_i = nz[:, i]
        bits = bits + torch.where(on, sig[i, nz_i.long()], 0)
        bits = bits + torch.where(on & nz_i, lastt[i, (last == i).long()], 0)
    trans = torch.as_tensor(otrellis.NODE_TRANS, device=dev).long()
    l1, unary = tc["l1"].to(I32), tc["unary"].to(I32)
    node = torch.zeros(N, dtype=torch.long, device=dev)
    sign_f8 = 1 << otrellis.CABAC_SIZE_BITS
    for i in range(C - 1, -1, -1):
        lv = lv_scan[:, i].abs()
        nz_i = lv > 0
        prefix = (lv - 1).clamp(0, 14)
        gt1 = (prefix > 0).long()
        big = torch.where(lv >= 15,
                          otrellis._ue_big_f8((lv - 15).clamp(min=0)), 0)
        step = l1[node, gt1] + torch.where(
            gt1 == 1, unary[node, prefix.long()] + big, sign_f8)
        bits = bits + torch.where(nz_i, step, 0)
        node = torch.where(nz_i, trans[gt1, node], node)
    return bits


def residual_bits_f8(lv_scan, tc):
    """residual_bits_i32 as float32, the type x264_tpu returns (N,)."""
    return residual_bits_i32(lv_scan, tc).to(F32)


def ssd_i32(a_tiles, b_tiles):
    """Per-tile SSD over (..., H, W) tiles, int32."""
    d = a_tiles.to(I32) - b_tiles.to(I32)
    return (d * d).sum((-2, -1), dtype=I32)


def ssd_tiles(a_tiles, b_tiles):
    """Per-tile SSD over (..., H, W) tiles -> float32 (exact below 2^24,
    which a 16x16 tile of 8-bit samples never reaches)."""
    return ssd_i32(a_tiles, b_tiles).to(F32)


def lambda2_f8(qp: int) -> float:
    """RD lambda2 such that cost = ssd + bits_f8 * this: x264_lambda2_tab =
    lambda^2 * .9 * 256 (encoder/analyse.c:151-158) over 256, in Python
    double."""
    lam = float(tables.LAMBDA_TABLE[qp])
    return 0.9 * lam * lam / 256.0

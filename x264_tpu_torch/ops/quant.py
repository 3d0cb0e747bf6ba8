"""Quantization / dequantization, batched, bit-exact (common/quant.c:33-178)
— plain PyTorch twins of x264_tpu/ops/quant.py.

Every function takes int32 coefficient tensors with arbitrary leading
dims and per-call tables that broadcast against them. The scalar shift
parameters (qp // 6) are Python ints or 0-d tensors.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def quant(coef, mf, bias):
    """Deadzone quantization (QUANT_ONE, common/quant.c:33):
    level = sign(c) * ((bias + |c|) * mf >> 16)."""
    coef = coef.to(I32)
    mag = ((bias + coef.abs()) * mf) >> 16
    return torch.where(coef >= 0, mag, -mag)


def dequant(level, dmf, qp_div6, shift_base: int):
    """dequant_4x4 (common/quant.c:76-146): i_qbits = qp/6 - shift_base,
    left shift when non-negative, rounded right shift otherwise."""
    qbits = int(qp_div6) - shift_base
    prod = level.to(I32) * dmf
    if qbits >= 0:
        return prod << qbits
    return (prod + (1 << (-qbits - 1))) >> -qbits


def quant_dc(coef, mf0, bias0):
    """quant_4x4_dc / quant_2x2_dc (common/quant.c:58-74); callers pass
    mf0 = mf[0] >> 1 and bias0 = bias[0] << 1 (encoder/macroblock.c:282)."""
    return quant(coef, mf0, bias0)


def dequant_4x4_dc(level, dmf0, qp_div6):
    """dequant_4x4_dc (common/quant.c:148), after the inverse Hadamard:
    i_qbits = qp/6 - 6."""
    qbits = int(qp_div6) - 6
    level = level.to(I32)
    if qbits >= 0:
        return level * (dmf0 << qbits)
    return (level * dmf0 + (1 << (-qbits - 1))) >> -qbits


def dequant_2x2_dc(hadamard_out, dmf0, qp_div6):
    """Chroma DC dequant after the inverse 2x2 Hadamard
    (idct_dequant_2x2_dc, encoder/macroblock.c:53-60):
    (x * dmf) >> (5 - qp/6), dmf pre-shifted when qp/6 > 5; no rounding."""
    qbits = int(qp_div6) - 5
    dmf_eff = dmf0 << max(qbits, 0)
    return (hadamard_out.to(I32) * dmf_eff) >> max(-qbits, 0)


# decimate-score run-cost tables (x264_decimate_table4 / 8,
# common/quant.c:203-210)
DECIMATE_TAB4 = (3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
DECIMATE_TAB8 = (3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,
                 1, 1, 1, 1, 1, 1, 1, 1) + (0,) * 40


def decimate_score(levels_scan, table=DECIMATE_TAB4):
    """Batched x264_decimate_score_internal (common/quant.c:212-241): per
    block, 9 if any |level| > 1, else the sum over nonzero coefficients
    of table[zeros since the previous nonzero]. levels_scan: (..., C)
    int32 in scan order. Returns (...,) int32; a zero block scores 0."""
    C = levels_scan.shape[-1]
    dev = levels_scan.device
    nz = levels_scan != 0
    pos = torch.arange(C, dtype=I32, device=dev)
    marks = torch.where(nz, pos, torch.full_like(pos, -1))
    before = torch.full((*marks.shape[:-1], 1), -1, dtype=I32, device=dev)
    prev_nz = torch.cat([before, torch.cummax(marks, -1).values[..., :-1]],
                        -1)
    run = (pos - prev_nz - 1).clamp(0, C - 1)
    tab = torch.tensor(table[:C], dtype=I32, device=dev)
    score = torch.where(nz, tab[run.long()], 0).sum(-1, dtype=I32)
    big = (levels_scan.abs() > 1).any(-1)
    return torch.where(big, 9, score).to(I32)

"""Quantization / dequantization, batched, bit-exact (common/quant.c:33-178)
— plain PyTorch twins of x264_tpu/ops/quant.py.

Every function takes int32 coefficient tensors with arbitrary leading
dims and per-call tables that broadcast against them. The shift
parameters (qp // 6) are Python ints or 0-d tensors at one QP, or int32
tensors that broadcast against the levels where the QP varies by MB
(variance AQ); both shift directions are then computed and selected.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda

I32 = torch.int32


def quant(coef, mf, bias):
    """Deadzone quantization (QUANT_ONE, common/quant.c:33):
    level = sign(c) * ((bias + |c|) * mf >> 16)."""
    coef = coef.to(I32)
    mag = ((bias + coef.abs()) * mf) >> 16
    return torch.where(coef >= 0, mag, -mag)


def _per_mb(qp_div6) -> bool:
    return isinstance(qp_div6, torch.Tensor) and qp_div6.dim() > 0


def _rshift_round(x, qbits):
    """x >> -qbits with rounding where qbits < 0, else x << qbits; qbits
    an int32 tensor that broadcasts against x."""
    neg = (-qbits).clamp(min=0)
    half = torch.where(qbits < 0, torch.ones_like(neg) << (neg - 1).clamp(
        min=0), 0)
    return torch.where(qbits >= 0, x << qbits.clamp(min=0), (x + half) >> neg)


def dequant(level, dmf, qp_div6, shift_base: int):
    """dequant_4x4 (common/quant.c:76-146): i_qbits = qp/6 - shift_base,
    left shift when non-negative, rounded right shift otherwise."""
    prod = level.to(I32) * dmf
    if _per_mb(qp_div6):
        return _rshift_round(prod, qp_div6 - shift_base)
    qbits = int(qp_div6) - shift_base
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
    level = level.to(I32)
    if _per_mb(qp_div6):
        qbits = qp_div6 - 6
        return torch.where(qbits >= 0, level * (dmf0 << qbits.clamp(min=0)),
                           _rshift_round(level * dmf0, qbits))
    qbits = int(qp_div6) - 6
    if qbits >= 0:
        return level * (dmf0 << qbits)
    return (level * dmf0 + (1 << (-qbits - 1))) >> -qbits


def dequant_2x2_dc(hadamard_out, dmf0, qp_div6):
    """Chroma DC dequant after the inverse 2x2 Hadamard
    (idct_dequant_2x2_dc, encoder/macroblock.c:53-60):
    (x * dmf) >> (5 - qp/6), dmf pre-shifted when qp/6 > 5; no rounding."""
    if _per_mb(qp_div6):
        qbits = qp_div6 - 5
        return (hadamard_out.to(I32) * (dmf0 << qbits.clamp(min=0))) \
            >> (-qbits).clamp(min=0)
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


# ------------------------------------------------------- noise reduction
# The window of the tree reduction that XLA's CPU compiler gives a
# float32 reduce (its TreeReductionRewriter): a reduced dimension longer
# than this is cut into windows of this many rows
XLA_TREE_WINDOW = 32


def _xla_plan(d0: int, d1: int):
    """One level of XLA's tree reduction over the two MB-grid dimensions of
    a (d0, d1, nblk, N) reduce: for each, (window, low padding, windows).
    A dimension longer than XLA_TREE_WINDOW is zero-padded to a multiple
    of it, floor(pad / 2) rows first, and cut into windows; a shorter one
    is one window."""
    out = []
    for n in (d0, d1):
        if n <= XLA_TREE_WINDOW:
            out.append((n, 0, 1))
        else:
            pad = -n % XLA_TREE_WINDOW
            out.append((XLA_TREE_WINDOW, pad // 2,
                        (n + pad) // XLA_TREE_WINDOW))
    return out


def nr_sums_plain(a):
    """Plain version of K26: the per-position float32 sums of a (d0, d1,
    nblk, N) int32 tensor of |coef| over its first three dimensions, with
    position 0 forced to 0 - the sums of x264_tpu's ops/quant.py denoise,
    ``a.astype(f32).reshape(-1, N).sum(axis=0)`` on the (mb_h, mb_w, nblk,
    N) coefficients of encode_p_body, added in the order XLA's CPU
    backend (jax 0.9) adds them. Where a grid side passes 32, its
    tree-reduction rewrite makes the reduce a reduce-window over (32, 32,
    nblk, 1) windows of the zero-padded grid (_xla_plan), each summed in
    row-major order from 0, and a last reduce over the (A, B) window
    partials (_combine). Below 2^24 every order gives the same bits; above
    it this one is x264_tpu's. A grid of at most 32 x 32 MBs is one
    reduce, which XLA vectorises in an order this sequential sum does
    not copy: there the sums agree while they stay below 2^24 (some 1,000
    blocks of |coef| ~ 16,000), which covers the frames such a grid
    holds unless their residual is extreme. Returns (N,) float32."""
    x = a.to(torch.float32)
    n = x.shape[-1]
    if max(x.shape[0], x.shape[1]) <= XLA_TREE_WINDOW:
        s = _seq_sum(x.reshape(1, -1, n))[0]
    else:
        while max(x.shape[0], x.shape[1]) > XLA_TREE_WINDOW:
            (w0, p0, n0), (w1, p1, n1) = _xla_plan(x.shape[0], x.shape[1])
            x = torch.nn.functional.pad(
                x, (0, 0, 0, 0, p1, n1 * w1 - x.shape[1] - p1,
                    p0, n0 * w0 - x.shape[0] - p0))
            x = x.reshape(n0, w0, n1, w1, x.shape[2], n) \
                .permute(0, 2, 1, 3, 4, 5).reshape(n0, n1, -1, n)
            x = _seq_sum(x)[:, :, None]
        s = _combine(x[:, :, 0])
    s[0] = 0.0
    return s


def _combine(p):
    """The last reduce of XLA's tree over the (A, B, N) window partials,
    as its CPU code generator emits it (read from the optimised LLVM IR
    of the fusion): in row-major order from 0, except where B is 2 and A
    is 2 or 4, where LLVM vectorises the A rows into lanes (each lane
    0 + p[a, 0] + p[a, 1]) and reduces the lanes by halving ((l0 + l1),
    or (l0 + l2) + (l1 + l3))."""
    A, B = p.shape[:2]
    if B == 2 and A in (2, 4):
        lanes = [(p[a, 0] + 0.0) + p[a, 1] for a in range(A)]
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [lanes[i] + lanes[i + h] for i in range(h)]
        return lanes[0].clone()
    return _seq_sum(p.reshape(1, A * B, -1))[0]


def _seq_sum(x):
    """(..., M, N) float32 -> (..., N): the M rows added one after another
    from 0, each addition rounded to float32."""
    s = torch.zeros((*x.shape[:-2], x.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for i in range(x.shape[-2]):
        s = s + x[..., i, :]
    return s


def nr_shrink(coef, offset):
    """x264_denoise_dct's shrink (common/quant.c:180): every AC
    coefficient's |c| drops by its position's offset, floored at 0, the
    sign kept; position 0 passes through. coef (..., N), offset (N,)."""
    shrunk = (coef.abs() - offset).clamp(min=0) * torch.sign(coef)
    shrunk[..., 0] = coef[..., 0]
    return shrunk


def denoise_plain(coef, offset):
    """x264_tpu's ops/quant.py denoise on (d0, d1, nblk, N) coefficients:
    (the shrunk coefficients, the (N,) float32 sums of the pre-shrink
    |coef| in XLA's order, nr_sums_plain)."""
    return nr_shrink(coef, offset), nr_sums_plain(coef.abs())


def nr_sums(a):
    """K26 `nr_sums`: the noise-reduction sums of a (d0, d1, nblk, N) int32
    tensor of |coef| (K6's NR branch writes them, d0 x d1 the MB grid).

    Replaces the reduction of x264_tpu/ops/quant.py:120 denoise. On a CUDA
    tensor it runs csrc/nr.cu, one launch (one CTA per window of the tree
    and then one CTA for the last reduce, in XLA's order, nr_sums_plain);
    on a CPU tensor the plain version. Grids whose sides pass 32 * 32 MBs
    (16384 samples) would need a second level of the tree and raise."""
    if a.device.type == "cpu":
        return nr_sums_plain(a)
    d0, d1, nblk, n = a.shape
    cuda.check(a, (d0, d1, nblk, n), I32, "nr |coef|")
    if (nblk, n) not in ((16, 16), (4, 64)):
        raise ValueError("nr_sums: the kernel takes 16 blocks of 16 or 4 "
                         "blocks of 64 coefficients an MB")
    (w0, p0, n0), (w1, p1, n1) = _xla_plan(d0, d1)
    if max(n0, n1) > XLA_TREE_WINDOW:
        raise ValueError("nr_sums: an MB grid side past 1024 needs a second "
                         "level of XLA's tree")
    part = torch.empty((n0 * n1, n), dtype=torch.float32, device=a.device)
    out = torch.empty(n, dtype=torch.float32, device=a.device)
    cuda.launch("nr", "nr_sums", "ppp" + "i" * 10 + "p", a.data_ptr(),
                part.data_ptr(), out.data_ptr(), d0, d1, nblk, n, w0, p0, n0,
                w1, p1, n1, cuda.stream(a.device))
    nr_sums.launches += 1
    return out


nr_sums.launches = 0


def nr_weight2():
    """The dct4 / dct8 weight2 tables (common/dct.h FIX8 class patterns)
    of the noise-reduction offset update (x264_tpu quant.nr_weight2).
    Returns ((16,), (64,)) int64 raster-order weights."""
    w4c = np.array([800, 320, 128], np.int64)          # FIX8 3.125/1.25/0.5
    i = np.arange(16)
    j4 = (i & 1) + ((i >> 2) & 1)
    w8c = np.array([256, 201, 656, 227, 410, 363], np.int64)
    pat = np.array([[0, 3, 4, 3], [3, 1, 5, 1],
                    [4, 5, 2, 5], [3, 1, 5, 1]])
    y8, x8 = np.mgrid[0:8, 0:8]
    j8 = pat[y8 % 4, x8 % 4].ravel()
    return w4c[j4], w8c[j8]

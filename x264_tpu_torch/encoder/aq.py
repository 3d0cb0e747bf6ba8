"""Adaptive quantisation (variance AQ) and the per-MB QP plumbing — plain
PyTorch twin of x264_tpu/encoder/aq.py and the wrappers of its CUDA
kernels K16 `aq_qp_map` and K17 `dqp_syntax` (csrc/aq.cu).

x264_adaptive_quant_frame (encoder/ratecontrol.c:231-249): per MB the
energy is the sum of the pixel variances of the Y 16x16 and U / V 8x8
blocks, and the MB's QP is clip(round(frame_qp + strength * 1.0397 *
(log2(energy) - 14.427)), qp_min, qp_max). The per-MB QP picks each MB's
quant / dequant tables, feeds the deblocking QP map and adds the
mb_qp_delta syntax; MBs that code no mb_qp_delta inherit the previous
QP (spec 7.4.5), which dqp_syntax carries forward.

The QP map must equal x264_tpu's bit for bit, and x264_tpu computes it in
float32 on XLA's CPU backend: a Cephes polynomial log (not correctly
rounded, so no library log reproduces it) whose multiply-adds the x86
backend contracts into FMAs, and the log2 scale, the -14.427 offset, the
strength product and the frame QP contracted into two more FMAs. The
plain version replays that sequence step by step (xla_log_f32, fma_f32);
K16 runs the same sequence with explicit round-to-nearest intrinsics.

The 52-QP table stacks (qtab_stacks) hold, for every luma QP, the packed
intra table of csrc/intra_mb.cuh's QTab and the packed inter table of
csrc/inter.cu's QTabP, with the chroma rows of that QP's chroma QP; K1,
K6 and K7 read an MB's row by its QP (x264_tpu's qtab_rows as a read).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from .. import tables
from ..ops.fma import fma_f32
from . import inter as einter
from . import intra as eintra

I32 = torch.int32
F32 = torch.float32


def _f32(bits: int) -> float:
    """The float32 of an IEEE bit pattern, as a Python float."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# XLA's CPU float32 log (its Cephes polynomial; csrc/aq.cu's constants)
LOG_P = tuple(_f32(b) for b in (
    0x3d9021bb, 0xbdebd1b8, 0x3def251a, 0xbdfe5d4f, 0x3e11e9bf, 0xbe2aae50,
    0x3e4cceac, 0xbe7ffffc, 0x3eaaaaaa))
LOG_Q1, LOG_Q2 = _f32(0xb95e8083), _f32(0x3f318000)
SQRT_HALF = _f32(0x3f3504f3)
INV_LN2 = _f32(0x3fb8aa3b)          # float32(1 / ln 2), XLA's log2 scale
AQ_OFFSET = _f32(0xc166d4fe)        # float32(-14.427)
AQ_SCALE = float(np.float32(1.0397))


def xla_log_f32_plain(x):
    """XLA's CPU float32 log of x >= 1 (float32 tensor), bit for bit:
    the exponent split at sqrt(1/2), then the Cephes polynomial in the
    FMA-contracted form the x86 backend emits (the zero / infinity / NaN
    fix-ups are left out)."""
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = LOG_P
    x = torch.clamp(x.to(F32), min=_f32(0x00800000))
    b = x.view(I32)
    emm0 = ((b >> 23) & 0x1FF) - 127
    fr = ((b & -2139095041) | 1056964608).view(F32)
    e = 1.0 + emm0.to(F32)
    m = fr < SQRT_HALF
    t = fr - 1.0
    e = e - m.to(F32)
    t = t + torch.where(m, fr, torch.zeros_like(fr))
    x2 = t * t
    x3 = x2 * t
    y, y1, y2 = fma_f32(t, p0, p1), fma_f32(t, p3, p4), fma_f32(t, p6, p7)
    y, y1, y2 = fma_f32(y, t, p2), fma_f32(y1, t, p5), fma_f32(y2, t, p8)
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, LOG_Q1 * e)
    r = fma_f32(torch.full_like(x2, -0.5), x2, t) + y
    return fma_f32(LOG_Q2, e, r)


def xla_log_f32(x):
    """XLA's CPU float32 log of x >= 1: on a CUDA tensor csrc/aq.cu's
    device log (the one K16 runs), on a CPU tensor xla_log_f32_plain."""
    if x.device.type == "cpu":
        return xla_log_f32_plain(x)
    cuda.check(x, (x.numel(),), F32, "x")
    out = torch.empty_like(x)
    cuda.launch("aq", "aq_log", "ppip", x.data_ptr(), out.data_ptr(),
                x.numel(), cuda.stream(x.device))
    return out


def xla_log2_f32(x):
    """jnp.log2 of x >= 1 on XLA's CPU backend: log(x) * float32(1/ln 2),
    rounded once (alone it is not contracted)."""
    return xla_log_f32(x) * INV_LN2


# ------------------------------------------------------------ tables
def full_tables(qt: tables.QuantTables, device) -> dict:
    """The full per-QP quant tables as int32 tensors (x264_tpu
    aq.full_tables): q4 / q8 mf and bias (n_cqm, 52, n), the dequant
    multipliers (n_cqm, 6, n) and the chroma QP table."""
    a = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    return dict(q4_mf=a(qt.quant4_mf), q4_bias=a(qt.quant4_bias),
                dq4_mf=a(qt.dequant4_mf), q8_mf=a(qt.quant8_mf),
                q8_bias=a(qt.quant8_bias), dq8_mf=a(qt.dequant8_mf),
                cqp=a(tables.CHROMA_QP_TABLE))


def qtab_rows(full: dict, qp_map, qpc_map, intra_cqm: bool,
              inter_tabs: bool = False) -> dict:
    """Per-MB qtab rows (x264_tpu aq.qtab_rows): the keys the residual
    paths read, 16 / 64-wide tables of shape (*lead, 16 | 64) and per-MB
    scalars (*lead,), gathered by the luma QP map and the chroma QP map
    (intra or inter CQMs; inter_tabs: the py_ / pc_ / p8_ names)."""
    iy = tables.CQM_4IY if intra_cqm else tables.CQM_4PY
    ic = tables.CQM_4IC if intra_cqm else tables.CQM_4PC
    q4, b4, d4 = full["q4_mf"], full["q4_bias"], full["dq4_mf"]
    qm, qc = qp_map.long(), qpc_map.long()
    y, c = ("py", "pc") if inter_tabs else ("y", "c")
    out = {f"{y}_mf": q4[iy][qm], f"{y}_bias": b4[iy][qm],
           f"{y}_dmf": d4[iy][qm % 6], f"{y}_qpdiv6": (qm // 6).to(I32),
           f"{c}_mf": q4[ic][qc], f"{c}_bias": b4[ic][qc],
           f"{c}_dmf": d4[ic][qc % 6], f"{c}_qpdiv6": (qc // 6).to(I32),
           f"{c}_dmf0": d4[ic][qc % 6, 0], f"{c}_mf_dc": q4[ic][qc, 0] >> 1,
           f"{c}_bias_dc": b4[ic][qc, 0] << 1}
    if not inter_tabs:
        out.update(y_dmf0=d4[iy][qm % 6, 0], y_mf_dc=q4[iy][qm, 0] >> 1,
                   y_bias_dc=b4[iy][qm, 0] << 1,
                   y8_mf=full["q8_mf"][tables.CQM_8IY][qm],
                   y8_bias=full["q8_bias"][tables.CQM_8IY][qm],
                   y8_dmf=full["dq8_mf"][tables.CQM_8IY][qm % 6])
    else:
        out.update(p8_mf=full["q8_mf"][tables.CQM_8PY][qm],
                   p8_bias=full["q8_bias"][tables.CQM_8PY][qm],
                   p8_dmf=full["dq8_mf"][tables.CQM_8PY][qm % 6])
    return out


def qtab_stacks(full: dict, chroma_qp_offset: int) -> dict:
    """The 52-QP stacks K1 / K6 / K7 read by an MB's QP, from the full
    tables (full_tables): row q of "intra" (52, QTAB_INTS) packs
    qtab_rows at luma QP q with the intra CQMs as csrc/intra_mb.cuh's
    QTab, row q of "inter" (52, QTABP_INTS) those with the inter CQMs as
    csrc/inter.cu's QTabP; the chroma rows at q's chroma QP,
    CHROMA_QP_TABLE[clip(q + chroma_qp_offset, 0, 51)]. One row per luma
    QP carries both."""
    qs = torch.arange(52, device=full["cqp"].device)
    qc = full["cqp"][(qs + chroma_qp_offset).clamp(0, 51)]
    pack = lambda rows, layout: torch.cat(
        [rows[k].reshape(52, -1) for keys, _ in layout for k in keys], 1)
    return dict(intra=pack(qtab_rows(full, qs, qc, True), eintra.QTAB_LAYOUT),
                inter=pack(qtab_rows(full, qs, qc, False, True),
                           einter.QTABP_LAYOUT))


# ---------------------------------------------------------------- K16
def aq_scale(strength: float) -> float:
    """float32(strength) * float32(1.0397), rounded to float32: the
    factor x264_tpu computes first (strength * 1.0397 * (...))."""
    return float(np.float32(strength) * np.float32(AQ_SCALE))


def _var(t, logn: int):
    """ss - s^2 / 2^logn in float32 over the (mb_h, mb_w, n, n) tiles t:
    the sums of squares in int32 blocks of 64 samples, then as float32
    (all exact below 2^24), s * s rounded to float32, the scale exact."""
    s = t.sum((-2, -1), dtype=I32).to(F32)
    ss = (t * t).reshape(*t.shape[:-2], -1, 64).sum(-1, dtype=I32) \
        .to(F32).sum(-1)
    return ss - (s * s) / float(1 << logn)


def qp_map_from_planes_plain(y, u, v, mb_h: int, mb_w: int, qp: int,
                             strength: float, qp_min: int, qp_max: int,
                             chroma_qp_offset: int):
    """Plain version of K16: the per-MB luma and chroma QP maps (x264_tpu
    aq.qp_map_from_planes on the tiles of the MB-aligned int32 planes y /
    u / v) as x264_tpu computes them inside its jitted pipelines. Returns
    (qp_map, qpc_map), (mb_h, mb_w) int32 each."""
    tile = lambda p, n: p.to(I32).reshape(mb_h, n, mb_w, n).transpose(1, 2)
    energy = (_var(tile(y, 16), 8) + _var(tile(u, 8), 6)) \
        + _var(tile(v, 8), 6)
    energy = torch.clamp(energy, min=1.0)
    a = fma_f32(xla_log_f32_plain(energy), INV_LN2, AQ_OFFSET)
    q = fma_f32(aq_scale(strength), a, float(qp))
    qp_map = torch.round(q).clamp(qp_min, qp_max).to(I32)
    cqp = torch.as_tensor(np.asarray(tables.CHROMA_QP_TABLE, np.int32),
                          device=y.device)
    return qp_map, cqp[(qp_map + chroma_qp_offset).clamp(0, 51).long()]


def qp_map_from_planes(y, u, v, mb_h: int, mb_w: int, qp: int,
                       strength: float, qp_min: int, qp_max: int,
                       chroma_qp_offset: int):
    """K16 `aq_qp_map`: the per-MB QP maps of variance AQ.

    Replaces x264_tpu/encoder/aq.py:qp_map_from_planes (with the tiling
    of pipeline._aq_maps). On CUDA tensors it runs csrc/aq.cu, one warp
    per MB in one launch; on CPU tensors the plain version. Arguments and
    results as qp_map_from_planes_plain."""
    if y.device.type == "cpu":
        return qp_map_from_planes_plain(y, u, v, mb_h, mb_w, qp, strength,
                                        qp_min, qp_max, chroma_qp_offset)
    dev = y.device
    cuda.check(y, (mb_h * 16, mb_w * 16), I32, "y")
    cuda.check(u, (mb_h * 8, mb_w * 8), I32, "u")
    cuda.check(v, (mb_h * 8, mb_w * 8), I32, "v")
    qp_map = torch.empty((mb_h, mb_w), dtype=I32, device=dev)
    qpc_map = torch.empty_like(qp_map)
    cuda.launch("aq", "aq_qp_map", "pppiiifiiippp", y.data_ptr(),
                u.data_ptr(), v.data_ptr(), mb_h, mb_w, int(qp),
                aq_scale(strength), int(qp_min), int(qp_max),
                int(chroma_qp_offset), qp_map.data_ptr(), qpc_map.data_ptr(),
                cuda.stream(dev))
    qp_map_from_planes.launches += 1
    return qp_map, qpc_map


qp_map_from_planes.launches = 0


# ---------------------------------------------------------------- K17
def dqp_syntax_plain(qp_map, has_dqp, slice_qp: int):
    """Plain version of K17 (x264_tpu aq.dqp_syntax): the raster forward
    fill. qp_map (mb_h, mb_w) int32, has_dqp (mb_h, mb_w) bool (the MBs
    that code mb_qp_delta). Returns (dqp, qp_eff (the QP each MB decodes
    with, which deblocking reads), prev_nz (the previous MB in raster
    order coded a nonzero delta)), each (mb_h, mb_w)."""
    shape = qp_map.shape
    q = qp_map.reshape(-1).to(I32)
    hd = has_dqp.reshape(-1)
    n = q.shape[0]
    idx = torch.where(hd, torch.arange(n, dtype=I32, device=q.device), -1)
    last_incl = torch.cummax(idx, 0).values
    prev_idx = torch.cat([last_incl.new_full((1,), -1), last_incl[:-1]])
    prev_qp = torch.where(prev_idx >= 0, q[prev_idx.clamp(min=0).long()],
                          slice_qp)
    dqp = torch.where(hd, q - prev_qp, 0).to(I32)
    qp_eff = torch.where(last_incl >= 0, q[last_incl.clamp(min=0).long()],
                         slice_qp).to(I32)
    prev_nz = torch.cat([torch.zeros(1, dtype=torch.bool, device=q.device),
                         (dqp != 0)[:-1]])
    return dqp.reshape(shape), qp_eff.reshape(shape), prev_nz.reshape(shape)


def dqp_syntax(qp_map, has_dqp, slice_qp: int):
    """K17 `dqp_syntax`: the mb_qp_delta values, the effective QP map and
    the delta context flags of a frame.

    Replaces x264_tpu/encoder/aq.py:dqp_syntax. On CUDA tensors it runs
    csrc/aq.cu, one CTA with a block-wide max scan; on CPU tensors the
    plain version. Arguments and results as dqp_syntax_plain."""
    if qp_map.device.type == "cpu":
        return dqp_syntax_plain(qp_map, has_dqp, slice_qp)
    dev = qp_map.device
    shape = tuple(qp_map.shape)
    cuda.check(qp_map, shape, I32, "qp_map")
    cuda.check(has_dqp, shape, torch.bool, "has_dqp")
    dqp, qp_eff = (torch.empty(shape, dtype=I32, device=dev)
                   for _ in range(2))
    prev_nz = torch.empty(shape, dtype=torch.bool, device=dev)
    cuda.launch("aq", "dqp_syntax", "ppiipppp", qp_map.data_ptr(),
                has_dqp.data_ptr(), qp_map.numel(), int(slice_qp),
                dqp.data_ptr(), qp_eff.data_ptr(), prev_nz.data_ptr(),
                cuda.stream(dev))
    dqp_syntax.launches += 1
    return dqp, qp_eff, prev_nz


dqp_syntax.launches = 0

"""Batched intra predictors (common/predict.c:52-498), int32 bit-exact —
plain PyTorch twins of x264_tpu/ops/predict.py.

Every mode is computed for a whole batch of blocks at once; the mode
decision is an argmin over masked costs. Neighbour context arrives as
``top`` (row above), ``left`` (column to the left), ``topleft`` and the
availability flags; outputs of unavailable modes are garbage the caller
masks by cost.

Mode numbering is the bitstream's:
  I16x16: 0=V 1=H 2=DC 3=Plane
  Chroma: 0=DC 1=H 2=V 3=Plane
  I4x4:   0=V 1=H 2=DC 3=DDL 4=DDR 5=VR 6=HD 7=VL 8=HU
The 8x8 luma predictors belong to I8x8 and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def _bcast_row(v, n):
    return v.unsqueeze(-2).expand(*v.shape[:-1], n, n)


def _bcast_col(v, n):
    return v.unsqueeze(-1).expand(*v.shape[:-1], n, n)


def _dc_fill(dc, n):
    return dc[..., None, None].expand(*dc.shape, n, n)


def _plane(a, b, c, n: int, centre: int):
    x = torch.arange(n, dtype=I32, device=a.device)
    p = (a[..., None, None] + b[..., None, None] * (x[None, :] - centre)
         + c[..., None, None] * (x[:, None] - centre) + 16) >> 5
    return p.clamp(0, 255)


def predict_16x16(top, left, topleft, has_top, has_left):
    """All four I16x16 predictions. top/left: (..., 16); topleft: (...);
    has_*: (...) bool. Returns (..., 4, 16, 16) int32
    (predict_16x16_dc*/v/h/p, common/predict.c:52-167)."""
    top, left = top.to(I32), left.to(I32)
    topleft = topleft.to(I32)
    st = top.sum(-1, dtype=I32)
    sl = left.sum(-1, dtype=I32)
    dc = torch.where(has_top & has_left, (st + sl + 16) >> 5,
                     torch.where(has_left, (sl + 8) >> 4,
                                 torch.where(has_top, (st + 8) >> 4,
                                             torch.full_like(st, 128))))
    lext = torch.cat([topleft[..., None], left], -1)
    text = torch.cat([topleft[..., None], top], -1)
    i = torch.arange(8, device=top.device)
    w = (i + 1).to(I32)
    hh = (w * (text[..., 9 + i] - text[..., 7 - i])).sum(-1, dtype=I32)
    vv = (w * (lext[..., 9 + i] - lext[..., 7 - i])).sum(-1, dtype=I32)
    a = 16 * (left[..., 15] + top[..., 15])
    b = (5 * hh + 32) >> 6
    c = (5 * vv + 32) >> 6
    return torch.stack([_bcast_row(top, 16), _bcast_col(left, 16),
                        _dc_fill(dc, 16), _plane(a, b, c, 16, 7)], dim=-3)


def predict_8x8c(top, left, topleft, has_top, has_left):
    """All four chroma 8x8 predictions [DC, H, V, Plane], (..., 4, 8, 8)
    (predict_8x8c_dc*/h/v/p, common/predict.c:176-295)."""
    top, left = top.to(I32), left.to(I32)
    topleft = topleft.to(I32)
    s0 = top[..., 0:4].sum(-1, dtype=I32)
    s1 = top[..., 4:8].sum(-1, dtype=I32)
    s2 = left[..., 0:4].sum(-1, dtype=I32)
    s3 = left[..., 4:8].sum(-1, dtype=I32)
    both = torch.stack([(s0 + s2 + 4) >> 3, (s1 + 2) >> 2,
                        (s3 + 2) >> 2, (s1 + s3 + 4) >> 3], -1)
    onlyl = torch.stack([(s2 + 2) >> 2, (s2 + 2) >> 2,
                         (s3 + 2) >> 2, (s3 + 2) >> 2], -1)
    onlyt = torch.stack([(s0 + 2) >> 2, (s1 + 2) >> 2,
                         (s0 + 2) >> 2, (s1 + 2) >> 2], -1)
    ht, hl = has_top[..., None], has_left[..., None]
    quad = torch.where(ht & hl, both,
                       torch.where(hl, onlyl,
                                   torch.where(ht, onlyt,
                                               torch.full_like(both, 128))))
    q = quad.reshape(*quad.shape[:-1], 2, 2)
    dcp = q.repeat_interleave(4, -1).repeat_interleave(4, -2)
    lext = torch.cat([topleft[..., None], left], -1)
    text = torch.cat([topleft[..., None], top], -1)
    i = torch.arange(4, device=top.device)
    w = (i + 1).to(I32)
    hh = (w * (text[..., 5 + i] - text[..., 3 - i])).sum(-1, dtype=I32)
    vv = (w * (lext[..., 5 + i] - lext[..., 3 - i])).sum(-1, dtype=I32)
    a = 16 * (left[..., 7] + top[..., 7])
    b = (17 * hh + 16) >> 5
    c = (17 * vv + 16) >> 5
    return torch.stack([dcp, _bcast_col(left, 8), _bcast_row(top, 8),
                        _plane(a, b, c, 8, 3)], dim=-3)


def mode_available_16x16(has_top, has_left):
    """(..., 4) bool mask over [V, H, DC, Plane]."""
    return torch.stack([has_top, has_left, torch.ones_like(has_top),
                        has_top & has_left], -1)


def mode_available_8x8c(has_top, has_left):
    """(..., 4) bool mask over [DC, H, V, Plane]."""
    return torch.stack([torch.ones_like(has_top), has_left, has_top,
                        has_top & has_left], -1)


# ---------------------------------------------------------------------------
# 4x4 luma prediction (common/predict.c:310-498; spec 8.3.1.2)
#
# All nine modes are one gather over the 13-entry edge vector
# e = [l3 l2 l1 l0 lt t0 t1 t2 t3 t4 t5 t6 t7] with per-position weights:
# F2(a,b,c) = (a+2b+c+2)>>2 -> (1,2,1); F1(a,b) = (2a+2b+2)>>2 -> (2,2,0);
# copy v = (4v+2)>>2 -> (4,0,0). DC depends on availability and is
# patched separately. The CUDA intra kernel reads the same two tables.
# ---------------------------------------------------------------------------

def _build_4x4_tables():
    L = lambda i: 3 - i
    T = lambda i: 5 + i
    LT = 4
    idx = np.zeros((9, 4, 4, 3), np.int32)
    wgt = np.zeros((9, 4, 4, 3), np.int32)

    def setp(m, x, y, *spec):
        if len(spec) == 1:                       # copy
            idx[m, y, x] = (spec[0],) * 3
            wgt[m, y, x] = (4, 0, 0)
        elif len(spec) == 2:                     # F1
            idx[m, y, x] = (spec[0], spec[1], spec[0])
            wgt[m, y, x] = (2, 2, 0)
        else:                                    # F2
            idx[m, y, x] = spec
            wgt[m, y, x] = (1, 2, 1)

    for x in range(4):
        for y in range(4):
            setp(0, x, y, T(x))                  # V
            setp(1, x, y, L(y))                  # H
            setp(2, x, y, T(0))                  # DC placeholder
            i = x + y                            # DDL
            if i < 6:
                setp(3, x, y, T(i), T(i + 1), T(i + 2))
            else:
                setp(3, x, y, T(6), T(7), T(7))
            d = x - y                            # DDR
            setp(4, x, y, LT + d - 1, LT + d, LT + d + 1)
    vr = {(0, 3): (L(2), L(1), L(0)), (0, 2): (L(1), L(0), LT),
          (0, 1): (L(0), LT, T(0)), (1, 3): (L(0), LT, T(0)),
          (0, 0): (LT, T(0)), (1, 2): (LT, T(0)),
          (1, 1): (LT, T(0), T(1)), (2, 3): (LT, T(0), T(1)),
          (1, 0): (T(0), T(1)), (2, 2): (T(0), T(1)),
          (2, 1): (T(0), T(1), T(2)), (3, 3): (T(0), T(1), T(2)),
          (2, 0): (T(1), T(2)), (3, 2): (T(1), T(2)),
          (3, 1): (T(1), T(2), T(3)), (3, 0): (T(2), T(3))}
    hd = {(0, 3): (L(2), L(3)), (1, 3): (L(1), L(2), L(3)),
          (0, 2): (L(1), L(2)), (2, 3): (L(1), L(2)),
          (1, 2): (L(0), L(1), L(2)), (3, 3): (L(0), L(1), L(2)),
          (0, 1): (L(0), L(1)), (2, 2): (L(0), L(1)),
          (1, 1): (LT, L(0), L(1)), (3, 2): (LT, L(0), L(1)),
          (0, 0): (LT, L(0)), (2, 1): (LT, L(0)),
          (1, 0): (T(0), LT, L(0)), (3, 1): (T(0), LT, L(0)),
          (2, 0): (T(1), T(0), LT), (3, 0): (T(2), T(1), T(0))}
    vl = {(0, 0): (T(0), T(1)), (0, 1): (T(0), T(1), T(2)),
          (1, 0): (T(1), T(2)), (0, 2): (T(1), T(2)),
          (1, 1): (T(1), T(2), T(3)), (0, 3): (T(1), T(2), T(3)),
          (2, 0): (T(2), T(3)), (1, 2): (T(2), T(3)),
          (2, 1): (T(2), T(3), T(4)), (1, 3): (T(2), T(3), T(4)),
          (3, 0): (T(3), T(4)), (2, 2): (T(3), T(4)),
          (3, 1): (T(3), T(4), T(5)), (2, 3): (T(3), T(4), T(5)),
          (3, 2): (T(4), T(5)), (3, 3): (T(4), T(5), T(6))}
    hu = {(0, 0): (L(0), L(1)), (1, 0): (L(0), L(1), L(2)),
          (2, 0): (L(1), L(2)), (0, 1): (L(1), L(2)),
          (3, 0): (L(1), L(2), L(3)), (1, 1): (L(1), L(2), L(3)),
          (2, 1): (L(2), L(3)), (0, 2): (L(2), L(3)),
          (3, 1): (L(2), L(3), L(3)), (1, 2): (L(2), L(3), L(3)),
          (3, 2): (L(3),), (1, 3): (L(3),), (0, 3): (L(3),),
          (2, 2): (L(3),), (2, 3): (L(3),), (3, 3): (L(3),)}
    for m, tab in ((5, vr), (6, hd), (7, vl), (8, hu)):
        for (x, y), s in tab.items():
            setp(m, x, y, *s)
    return idx, wgt


P4_IDX, P4_WGT = _build_4x4_tables()


def predict_4x4(left, topleft, top, topright, has_top, has_left):
    """All nine 4x4 predictions, (..., 9, 4, 4). left: (..., 4) l0..l3
    top to bottom; top: t0..t3; topright: t4..t7 (callers substitute t3
    where the top-right is unavailable, spec 8.3.1.2.1)."""
    e = torch.cat([left.to(I32).flip(-1), topleft.to(I32)[..., None],
                   top.to(I32), topright.to(I32)], -1)
    idx = torch.as_tensor(P4_IDX, device=e.device).long()
    wgt = torch.as_tensor(P4_WGT, device=e.device)
    g = e[..., idx]                                       # (..., 9,4,4,3)
    p = ((g * wgt).sum(-1, dtype=I32) + 2) >> 2
    st = top.to(I32).sum(-1, dtype=I32)
    sl = left.to(I32).sum(-1, dtype=I32)
    dc = torch.where(has_top & has_left, (st + sl + 4) >> 3,
                     torch.where(has_left, (sl + 2) >> 2,
                                 torch.where(has_top, (st + 2) >> 2,
                                             torch.full_like(st, 128))))
    p[..., 2, :, :] = dc[..., None, None]
    return p


def mode_available_4x4(has_top, has_left):
    """(..., 9) mask over [V H DC DDL DDR VR HD VL HU]
    (predict_4x4_mode_available semantics)."""
    ht, hl = has_top, has_left
    both = ht & hl
    return torch.stack([ht, hl, torch.ones_like(ht), ht, both, both, both,
                        ht, hl], -1)

"""The per-frame device pipelines of CABAC IDR and P frames.

The PyTorch re-expression of x264_tpu/encoder/pipeline.py's
encode_i16_idr_cabac and encode_p_cabac, with or without the 8x8
transform and I8x8. IDR: the intra wavefront (K1),
the CABAC op stream (K3), the in-loop deblocking filter (K2) and the
frame metrics (K4). P: full-pel motion estimation (K5); at subme >= 2
the half-pel planes (K9), the sub-pel refinement (K10), the chroma-ME
re-rank (K12, subme >= 5) and the partition search (K11, then K10 per
layout); the inter residual (K6), at subme >= 6 the inter RD cost (K13),
intra-in-P (K7, with the RD decision at subme >= 6), the syntax maps and
op stream (K8), then K2 with the P maps and K4. Everything is queued on
the device's current stream; only the op stream and one small int32
vector cross to the host
(x264_slice_write, encoder/encoder.c:1141, plus x264_frame_deblock_row
and the stats of encoder/encoder.c:1034-1056).
"""

from __future__ import annotations

import torch

from ..entropy import cabac_planes
from ..ops import deblock as odeblock
from . import inter
from . import intra
from . import stats as estats

I32 = torch.int32

_ZERO_MAPS: dict = {}


def _zero_maps(mb_h: int, mb_w: int, device):
    """All-intra deblock inputs: intra flags, zero nnz / ref / mv maps."""
    key = (mb_h, mb_w, str(device))
    if key not in _ZERO_MAPS:
        z4 = torch.zeros((mb_h * 4, mb_w * 4), dtype=I32, device=device)
        _ZERO_MAPS[key] = (
            torch.ones((mb_h, mb_w), dtype=torch.bool, device=device), z4,
            torch.zeros((mb_h * 4, mb_w * 4, 2), dtype=I32, device=device))
    return _ZERO_MAPS[key]


def host32_pack(first, oy, ou, ov, ry, ru, rv, crop_w: int, crop_h: int,
                with_metrics: bool):
    """Everything the host needs per frame in one int32 vector:
    [first..., ssd_y, ssd_u, ssd_v, ssim] with the float32 metrics
    bit-cast to int32 (x264_tpu pipeline.host32_pack); the metrics come
    from K4."""
    dev = oy.device
    head = torch.stack([torch.as_tensor(x, device=dev).to(I32).reshape(())
                        for x in first])
    if with_metrics:
        m = estats.frame_metrics(oy, ou, ov, ry, ru, rv, crop_w, crop_h)
    else:
        m = torch.zeros(4, dtype=torch.float32, device=dev)
    return torch.cat([head, m.view(I32)])


def encode_i16_idr_cabac(mb_h: int, mb_w: int, deblock_on: bool, y, u, v,
                         qtab: dict, lam: int, qp: int, alpha_off: int,
                         beta_off: int, chroma_qp_offset: int,
                         crop_w: int, crop_h: int, with_metrics: bool,
                         t8: bool = False, i8x8: bool = False) -> dict:
    """One IDR frame, CABAC entropy. y / u / v: int32 MB-aligned planes on
    the device; crop_w x crop_h the output size the metrics cover; t8: the
    PPS enables the 8x8 transform (the flag of I_NxN MBs); i8x8: the I8x8
    ladder (slope-2 wavefront; its MBs' inner 8x8 edges stay unfiltered).
    Returns dict(recon_y/u/v (deblocked when deblock_on), ops (int32 op
    stream, the first n_ops live), host32 = [n_ops, nmb, 0, ssd_y, ssd_u,
    ssd_v, ssim], and with i8x8 t8_mb, the I8x8 MBs)."""
    out = intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab, lam, i8x8)
    ops, n_ops = cabac_planes.i_slice_ops(out, mb_h, mb_w, t8)
    ry, ru, rv = out["recon_y"], out["recon_u"], out["recon_v"]
    if deblock_on:
        intra_mb, z4, zmv = _zero_maps(mb_h, mb_w, y.device)
        qp_mb = torch.full((mb_h, mb_w), qp, dtype=I32, device=y.device)
        ry, ru, rv = odeblock.deblock_frame(
            mb_h, mb_w, ry, ru, rv, qp_mb, intra_mb, z4, z4, zmv, z4, zmv,
            False, alpha_off, beta_off, chroma_qp_offset,
            out["t8_mb"] if i8x8 else None)
    h32 = host32_pack([n_ops, mb_h * mb_w, 0], y, u, v, ry, ru, rv,
                      crop_w, crop_h, with_metrics)
    ret = dict(recon_y=ry, recon_u=ru, recon_v=rv, ops=ops, host32=h32)
    if i8x8:
        ret["t8_mb"] = out["t8_mb"]
    return ret


def encode_p_cabac(mb_h: int, mb_w: int, me_range: int, deblock_on: bool,
                   y, u, v, ref_y, ref_u, ref_v, qtab: dict, lam: int,
                   qp: int, alpha_off: int, beta_off: int,
                   chroma_qp_offset: int, mvp_seed, crop_w: int,
                   crop_h: int, with_metrics: bool, decimate: bool,
                   subpel_steps=(), parts: bool = False, p8x8: bool = False,
                   chroma_me: bool = False, rd: bool = False,
                   t8: bool = False) -> dict:
    """One P frame at subme 1-9 with one reference, CABAC entropy. y / u
    / v: int32 MB-aligned source planes; ref_*: the deblocked reference;
    mvp_seed: (mb_h, mb_w, 2) qpel ME predictors (the previous P frame's
    MV field); subpel_steps / parts / p8x8 / chroma_me / rd / t8 as
    inter.encode_p_front takes them. Returns dict(recon_y/u/v (deblocked
    when deblock_on), ops, host32 = [n_ops, n_intra, n_skip, ssd_y,
    ssd_u, ssd_v, ssim], mv (the frame's final 16x16 MV field, the next
    frame's seed), ptype (the final partition types), and with t8 t8_mb,
    the MBs coded with the 8x8 transform)."""
    front = inter.encode_p_front(mb_h, mb_w, me_range, y, u, v, ref_y,
                                 ref_u, ref_v, qtab, lam, mvp_seed, decimate,
                                 subpel_steps, parts, p8x8, chroma_me, rd,
                                 t8)
    maps, ops, n_ops = cabac_planes.cabac_p_ops(front, mb_h, mb_w,
                                                t8_mode=t8)
    ry, ru, rv = front["recon_y"], front["recon_u"], front["recon_v"]
    if deblock_on:
        _, z4, zmv = _zero_maps(mb_h, mb_w, y.device)
        qp_mb = torch.full((mb_h, mb_w), qp, dtype=I32, device=y.device)
        ry, ru, rv = odeblock.deblock_frame(
            mb_h, mb_w, ry, ru, rv, qp_mb, front["intra_mb"], maps["nnz4"],
            maps["ref4"], maps["mv4"], z4, zmv, False, alpha_off, beta_off,
            chroma_qp_offset, maps.get("t8_mb"))
    h32 = host32_pack([n_ops, front["intra_mb"].sum(), maps["skip"].sum()],
                      y, u, v, ry, ru, rv, crop_w, crop_h, with_metrics)
    ret = dict(recon_y=ry, recon_u=ru, recon_v=rv, ops=ops, host32=h32,
               mv=maps["mv"], ptype=maps["ptype"])
    if t8:
        ret["t8_mb"] = maps["t8_mb"]
    return ret

"""The per-frame device pipelines of IDR, P and B frames, CABAC or CAVLC.

The PyTorch re-expression of x264_tpu/encoder/pipeline.py's
encode_i16_idr_cabac, encode_p_cabac and encode_b_cabac, with or without
the 8x8 transform and I8x8, and of its CAVLC encode_i16_idr, encode_p
and encode_b, where K18 / K19 / K25 code the packed slice words in place
of the op streams of K3 / K8 / K24 (a P frame runs K8's pass A alone for
its maps, a B frame K24's). P frames take one reference or two (L0[1],
the reference before the last, where ref2 is given). IDR:
the intra wavefront (K1), the CABAC op stream (K3), the in-loop
deblocking filter (K2) and the frame metrics (K4). P: full-pel motion
estimation (K5); at subme >= 2 the half-pel planes (K9), the sub-pel
refinement (K10), the chroma-ME re-rank (K12, subme >= 5) and the
partition search (K11, then K10 per layout); the inter residual (K6), at
subme >= 6 the inter RD cost (K13), intra-in-P (K7, with the RD decision
at subme >= 6), the syntax maps and op stream (K8), then K2 with the P
maps and K4. B (CABAC): ME per list (K5, K9, K10), K22's two passes,
K7's B decision and sweeps, K23's spatial direct, K24, K2 with both
lists' maps and K4, at the frame QP. Under variance AQ the IDR and P
pipelines start with the per-MB QP map of the source planes (K16); K1,
K6 and K7 read each MB's tables at its QP, K17 derives the mb_qp_delta
planes that K3 / K8 code and the effective QP map that K2 filters with
(x264_tpu's _encode_i16_aq, _aq_maps and encode_p_cabac's AQ path).
At CQP 0 (lossless) K1, K6 and K7 take the transform bypass; with the
noise reduction a P frame's K6 shrinks its inter luma coefficients by
the host's offsets and K26 sums their |coef| for the host's next update.
Everything is queued on the device's current stream; only the op stream
(or the slice words) and one small int32 vector cross to the host
(x264_slice_write, encoder/encoder.c:1141, plus x264_frame_deblock_row
and the stats of encoder/encoder.c:1034-1056).
"""

from __future__ import annotations

import torch

from ..entropy import cabac_planes
from ..entropy import device as edev
from ..ops import deblock as odeblock
from . import aq as eaq
from . import inter
from . import intra
from . import stats as estats

I32 = torch.int32

# bitstream capacity per MB, in bits, of the CAVLC word buffer (as
# x264_tpu sizes it; the host raises if a slice exceeds it)
CAP_BITS_PER_MB = 4800


def capacity_words(nmb: int) -> int:
    return (nmb * CAP_BITS_PER_MB + edev.HDR_SLOTS * 32 + 4096) // 32


def cabac_capacity_hw(nmb: int) -> int:
    """Halfword capacity of a packed op stream (K27, x264_tpu's
    cabac_capacity_hw): 3 halfwords for each op of the op buffer, the worst
    case, so the packed words stay 1.5x the op buffer."""
    return 3 * cabac_planes.capacity(nmb)


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


def _aq_map(aq, y, u, v, mb_h: int, mb_w: int, qp: int,
            chroma_qp_offset: int):
    """K16's luma QP map under aq = (strength, qp_min, qp_max), or None."""
    if aq is None:
        return None
    return eaq.qp_map_from_planes(y, u, v, mb_h, mb_w, qp, *aq,
                                  chroma_qp_offset)[0]


def _intra_front(mb_h: int, mb_w: int, y, u, v, qtab: dict, lam: int,
                 qp: int, chroma_qp_offset: int, i8x8: bool, aq,
                 lossless: bool, i4x4: bool):
    """K16 under AQ, K1 (with or without the I4x4 ladder), then K17 under
    AQ (x264_tpu's _encode_i16_aq): returns (K1's planes, with dqp /
    dqp_prev_nz under AQ, and the QP map the MBs decode with)."""
    qp_map = _aq_map(aq, y, u, v, mb_h, mb_w, qp, chroma_qp_offset)
    out = intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab, lam, i8x8,
                                 qp_map, lossless, i4x4)
    qp_mb = torch.full((mb_h, mb_w), qp, dtype=I32, device=y.device)
    if qp_map is not None:
        # an I_NxN MB without coded residual codes no mb_qp_delta
        cnz = (out["chroma_ac"][..., 1:] != 0).flatten(2).any(-1) \
            | (out["chroma_dc"] != 0).flatten(2).any(-1)
        has_dqp = ~out["i4_mb"] | (out["cbp_luma_bits"] > 0) | cnz
        out["dqp"], qp_mb, out["dqp_prev_nz"] = eaq.dqp_syntax(
            qp_map, has_dqp, qp)
    return out, qp_mb


def _intra_tail(mb_h: int, mb_w: int, out: dict, qp_mb, deblock_on: bool,
                alpha_off: int, beta_off: int, chroma_qp_offset: int,
                i8x8: bool):
    """K2 on the IDR's recon (when deblock_on) -> (ry, ru, rv)."""
    ry, ru, rv = out["recon_y"], out["recon_u"], out["recon_v"]
    if deblock_on:
        intra_mb, z4, zmv = _zero_maps(mb_h, mb_w, ry.device)
        ry, ru, rv = odeblock.deblock_frame(
            mb_h, mb_w, ry, ru, rv, qp_mb, intra_mb, z4, z4, zmv, z4, zmv,
            False, alpha_off, beta_off, chroma_qp_offset,
            out["t8_mb"] if i8x8 else None)
    return ry, ru, rv


def encode_i16_idr_cabac(mb_h: int, mb_w: int, deblock_on: bool, y, u, v,
                         qtab: dict, lam: int, qp: int, alpha_off: int,
                         beta_off: int, chroma_qp_offset: int,
                         crop_w: int, crop_h: int, with_metrics: bool,
                         t8: bool = False, i8x8: bool = False,
                         aq=None, lossless: bool = False, *,
                         i4x4: bool) -> dict:
    """One IDR frame, CABAC entropy. y / u / v: int32 MB-aligned planes on
    the device; crop_w x crop_h the output size the metrics cover; t8: the
    PPS enables the 8x8 transform (the flag of I_NxN MBs); i8x8: the I8x8
    ladder (slope-2 wavefront; its MBs' inner 8x8 edges stay unfiltered);
    i4x4: the I4x4 ladder (analyse.intra & ANALYSE_I4x4; off under
    --partitions none).
    Returns dict(recon_y/u/v (deblocked when deblock_on), ops (int32 op
    stream, the first n_ops live), host32 = [n_ops, nmb, 0, ssd_y, ssd_u,
    ssd_v, ssim], and with i8x8 t8_mb, the I8x8 MBs). aq: variance AQ
    as (strength, qp_min, qp_max), qtab then holding the 52-QP stack
    "aq_stack"; the result then also holds dqp and qp_eff (mb_h, mb_w),
    the mb_qp_delta values and the QPs the MBs decode with. lossless: the
    transform bypass (QP 0 under CQP)."""
    out, qp_mb = _intra_front(mb_h, mb_w, y, u, v, qtab, lam, qp,
                              chroma_qp_offset, i8x8, aq, lossless, i4x4)
    ops, n_ops = cabac_planes.i_slice_ops(out, mb_h, mb_w, t8)
    ry, ru, rv = _intra_tail(mb_h, mb_w, out, qp_mb, deblock_on, alpha_off,
                             beta_off, chroma_qp_offset, i8x8)
    h32 = host32_pack([n_ops, mb_h * mb_w, 0], y, u, v, ry, ru, rv,
                      crop_w, crop_h, with_metrics)
    ret = dict(recon_y=ry, recon_u=ru, recon_v=rv, ops=ops, host32=h32)
    if i8x8:
        ret["t8_mb"] = out["t8_mb"]
    if aq is not None:
        ret.update(dqp=out["dqp"], qp_eff=qp_mb)
    return ret


def encode_i16_idr(mb_h: int, mb_w: int, deblock_on: bool, y, u, v,
                   qtab: dict, lam: int, qp: int, hdr_vals, hdr_lens,
                   alpha_off: int, beta_off: int, chroma_qp_offset: int,
                   crop_w: int, crop_h: int, with_metrics: bool,
                   aq=None, lossless: bool = False, *,
                   i4x4: bool) -> dict:
    """One IDR frame, CAVLC entropy (x264_tpu's encode_i16_idr): K16 under
    AQ, K1 (I16x16, and I4x4 where i4x4), K17 under AQ, K18 (the slice
    header's slots hdr_vals / hdr_lens, from
    entropy/device.py:header_slots, the MBs' codes and the stop bit), K2
    and K4. Returns dict(recon_y/u/v, words
    (int32 bit patterns, capacity_words(nmb) of them, the first
    ceil(nbits / 32) live), host32 = [nbits, nmb, 0, ssd_y, ssd_u, ssd_v,
    ssim], mode16, modec, and under aq dqp and qp_eff); lossless as
    encode_i16_idr_cabac's."""
    out, qp_mb = _intra_front(mb_h, mb_w, y, u, v, qtab, lam, qp,
                              chroma_qp_offset, False, aq, lossless, i4x4)
    words, nbits = edev.cavlc_i_slice(out, mb_h, mb_w, hdr_vals, hdr_lens,
                                      capacity_words(mb_h * mb_w))
    ry, ru, rv = _intra_tail(mb_h, mb_w, out, qp_mb, deblock_on, alpha_off,
                             beta_off, chroma_qp_offset, False)
    h32 = host32_pack([nbits, mb_h * mb_w, 0], y, u, v, ry, ru, rv,
                      crop_w, crop_h, with_metrics)
    ret = dict(recon_y=ry, recon_u=ru, recon_v=rv, words=words, host32=h32,
               mode16=out["mode16"], modec=out["modec"])
    if aq is not None:
        ret.update(dqp=out["dqp"], qp_eff=qp_mb)
    return ret


def encode_p_cabac(mb_h: int, mb_w: int, me_range: int, deblock_on: bool,
                   y, u, v, ref_y, ref_u, ref_v, qtab: dict, lam: int,
                   qp: int, alpha_off: int, beta_off: int,
                   chroma_qp_offset: int, mvp_seed, crop_w: int,
                   crop_h: int, with_metrics: bool, decimate: bool,
                   subpel_steps=(), parts: bool = False, p8x8: bool = False,
                   chroma_me: bool = False, rd: bool = False,
                   t8: bool = False, aq=None, ref2=None,
                   lossless: bool = False, nr_offset4=None,
                   nr_offset8=None, ref_prepadded: bool = False) -> dict:
    """One P frame at subme 1-9, CABAC entropy. y / u / v: int32
    MB-aligned source planes; ref_*: the deblocked reference (L0[0]);
    ref2: L0[1] as (y, u, v) for two references, or None;
    mvp_seed: (mb_h, mb_w, 2) qpel ME predictors (the previous P frame's
    MV field); subpel_steps / parts / p8x8 / chroma_me / rd / t8 as
    inter.encode_p_front takes them. Returns dict(recon_y/u/v (deblocked
    when deblock_on), ops, host32 = [n_ops, n_intra, n_skip, ssd_y,
    ssd_u, ssd_v, ssim], mv (the frame's final 16x16 MV field, the next
    frame's seed), ptype (the final partition types), ref4 / mv4 (the
    final 4x4 L0 maps, the colocated maps of the B frames that take this
    frame as their L1 reference), and with t8 t8_mb,
    the MBs coded with the 8x8 transform). aq: variance AQ as (strength,
    qp_min, qp_max), qtab then holding the stacks "aq_stack" and
    "aq_stack_p"; the result then also holds dqp and qp_eff. lossless:
    the transform bypass (decimation and RD off). nr_offset4 / nr_offset8:
    the noise reduction's (16,) / (64,) int32 offsets on the device (the
    8x8's with t8); the result then also holds nr_sum4 / nr_sum8, the
    float32 |coef| sums of x264_tpu's encode_p_cabac. ref_prepadded: the
    references carry their border (an MB-row band's, K28), as
    inter.encode_p_front takes it."""
    qp_map = _aq_map(aq, y, u, v, mb_h, mb_w, qp, chroma_qp_offset)
    front = inter.encode_p_front(mb_h, mb_w, me_range, y, u, v, ref_y,
                                 ref_u, ref_v, qtab, lam, mvp_seed, decimate,
                                 subpel_steps, parts, p8x8, chroma_me, rd,
                                 t8, qp_map, ref2, lossless, nr_offset4,
                                 nr_offset8, ref_prepadded)
    maps, ops, n_ops = cabac_planes.cabac_p_ops(
        front, mb_h, mb_w, 1 if ref2 is None else 2, t8_mode=t8,
        aq=None if qp_map is None else (qp_map, qp))
    qp_mb = maps["qp_eff"] if qp_map is not None else torch.full(
        (mb_h, mb_w), qp, dtype=I32, device=y.device)
    ry, ru, rv = front["recon_y"], front["recon_u"], front["recon_v"]
    if deblock_on:
        _, z4, zmv = _zero_maps(mb_h, mb_w, y.device)
        ry, ru, rv = odeblock.deblock_frame(
            mb_h, mb_w, ry, ru, rv, qp_mb, front["intra_mb"], maps["nnz4"],
            maps["ref4"], maps["mv4"], z4, zmv, False, alpha_off, beta_off,
            chroma_qp_offset, maps.get("t8_mb"))
    h32 = host32_pack([n_ops, front["intra_mb"].sum(), maps["skip"].sum()],
                      y, u, v, ry, ru, rv, crop_w, crop_h, with_metrics)
    ret = dict(recon_y=ry, recon_u=ru, recon_v=rv, ops=ops, host32=h32,
               mv=maps["mv"], ptype=maps["ptype"], ref4=maps["ref4"],
               mv4=maps["mv4"], ref_idx=maps["ref_idx"])
    if t8:
        ret["t8_mb"] = maps["t8_mb"]
    if qp_map is not None:
        ret.update(dqp=maps["dqp"], qp_eff=qp_mb)
    return _with_nr(ret, front)


def _with_nr(ret: dict, front: dict) -> dict:
    """ret with the noise reduction's sums of front, where it has them."""
    ret.update({k: front[k] for k in ("nr_sum4", "nr_sum8") if k in front})
    return ret


def _b_deblock(mb_h: int, mb_w: int, front: dict, maps: dict, qp: int,
               deblock_on: bool, alpha_off: int, beta_off: int,
               chroma_qp_offset: int):
    """K2 with both lists' maps on a B frame's recon at the frame QP (when
    deblock_on) -> (ry, ru, rv)."""
    ry, ru, rv = front["recon_y"], front["recon_u"], front["recon_v"]
    if deblock_on:
        qp_mb = torch.full((mb_h, mb_w), qp, dtype=I32, device=ry.device)
        ry, ru, rv = odeblock.deblock_frame(
            mb_h, mb_w, ry, ru, rv, qp_mb, front["intra_mb"], maps["nnz4"],
            maps["ref4"], maps["mv4"], maps["ref4_l1"], maps["mv4_l1"], True,
            alpha_off, beta_off, chroma_qp_offset)
    return ry, ru, rv


def encode_b_cabac(mb_h: int, mb_w: int, me_range: int, deblock_on: bool,
                   y, u, v, l0, l1, qtab: dict, lam: int, qp: int,
                   alpha_off: int, beta_off: int, chroma_qp_offset: int,
                   mvp_seed, mvp_seed_l1, col_ref4, col_mv4, crop_w: int,
                   crop_h: int, with_metrics: bool, subpel_steps=(2, 1),
                   t8: bool = False, ref_prepadded: bool = False) -> dict:
    """One B frame with CABAC entropy (x264_tpu's encode_b_cabac): the B
    body through inter.encode_b_front (K5, K9, K10 per list, K22, K7,
    K23, K22, K7), K24's maps and op stream, K2 with both lists' maps and
    K4, at the frame QP. l0 / l1: each list's deblocked reconstruction
    (y, u, v); mvp_seed / mvp_seed_l1 each list's qpel ME predictors;
    col_ref4 / col_mv4 the colocated L0 maps of the L1 reference; t8: the
    PPS enables the 8x8 transform (B MBs code the flag 0). Returns
    dict(recon_y/u/v, ops, host32 = [n_ops, n_intra, n_skip, ssd_y,
    ssd_u, ssd_v, ssim], intra_mb, bmode). ref_prepadded: l0 / l1 carry
    their border (an MB-row band's, K28)."""
    front = inter.encode_b_front(mb_h, mb_w, me_range, y, u, v, l0, l1, qtab,
                                 lam, mvp_seed, mvp_seed_l1, col_ref4,
                                 col_mv4, subpel_steps, ref_prepadded)
    maps, ops, n_ops = cabac_planes.cabac_b_ops(front, mb_h, mb_w, t8)
    ry, ru, rv = _b_deblock(mb_h, mb_w, front, maps, qp, deblock_on,
                            alpha_off, beta_off, chroma_qp_offset)
    h32 = host32_pack([n_ops, front["intra_mb"].sum(), maps["skip"].sum()],
                      y, u, v, ry, ru, rv, crop_w, crop_h, with_metrics)
    return dict(recon_y=ry, recon_u=ru, recon_v=rv, ops=ops, host32=h32,
                intra_mb=front["intra_mb"], bmode=front["bmode"])


def encode_p(mb_h: int, mb_w: int, me_range: int, deblock_on: bool, y, u, v,
             ref_y, ref_u, ref_v, qtab: dict, lam: int, qp: int, hdr_vals,
             hdr_lens, alpha_off: int, beta_off: int, chroma_qp_offset: int,
             mvp_seed, crop_w: int, crop_h: int, with_metrics: bool,
             decimate: bool, subpel_steps=(), parts: bool = False,
             p8x8: bool = False, chroma_me: bool = False, rd: bool = False,
             aq=None, ref2=None, lossless: bool = False,
             nr_offset4=None, ref_prepadded: bool = False) -> dict:
    """One P frame at subme 1-9, CAVLC entropy (x264_tpu's encode_p): K16
    under AQ, encode_p_front as encode_p_cabac runs it without the 8x8
    transform (ref2: L0[1] for two references), K8's pass A alone
    (cabac_planes.p_maps), K17 under AQ, K19 (header slots, the MBs'
    codes, the trailing skip run, the stop bit), K2 with pass A's maps and
    K4. Returns dict(recon_y/u/v, words, host32 = [nbits, n_intra,
    n_skip, ssd_y, ssd_u, ssd_v, ssim], mv, ptype, ref4 / mv4 / ref_idx,
    and under aq dqp and qp_eff, with nr_offset4 nr_sum4); lossless and
    nr_offset4 and ref_prepadded as encode_p_cabac takes them."""
    qp_map = _aq_map(aq, y, u, v, mb_h, mb_w, qp, chroma_qp_offset)
    front = inter.encode_p_front(mb_h, mb_w, me_range, y, u, v, ref_y,
                                 ref_u, ref_v, qtab, lam, mvp_seed, decimate,
                                 subpel_steps, parts, p8x8, chroma_me, rd,
                                 False, qp_map, ref2, lossless, nr_offset4,
                                 ref_prepadded=ref_prepadded)
    maps = cabac_planes.p_maps(front, mb_h, mb_w)
    qp_mb = torch.full((mb_h, mb_w), qp, dtype=I32, device=y.device)
    if qp_map is not None:
        maps["dqp"], qp_mb, _ = eaq.dqp_syntax(
            qp_map, cabac_planes.has_dqp_p(maps, front), qp)
    words, nbits = edev.cavlc_p_slice(front, maps, mb_h, mb_w, hdr_vals,
                                      hdr_lens, capacity_words(mb_h * mb_w),
                                      1 if ref2 is None else 2)
    ry, ru, rv = front["recon_y"], front["recon_u"], front["recon_v"]
    if deblock_on:
        _, z4, zmv = _zero_maps(mb_h, mb_w, y.device)
        ry, ru, rv = odeblock.deblock_frame(
            mb_h, mb_w, ry, ru, rv, qp_mb, front["intra_mb"], maps["nnz4"],
            maps["ref4"], maps["mv4"], z4, zmv, False, alpha_off, beta_off,
            chroma_qp_offset)
    h32 = host32_pack([nbits, front["intra_mb"].sum(), maps["skip"].sum()],
                      y, u, v, ry, ru, rv, crop_w, crop_h, with_metrics)
    ret = dict(recon_y=ry, recon_u=ru, recon_v=rv, words=words, host32=h32,
               mv=maps["mv"], ptype=maps["ptype"], ref4=maps["ref4"],
               mv4=maps["mv4"], ref_idx=maps["ref_idx"])
    if aq is not None:
        ret.update(dqp=maps["dqp"], qp_eff=qp_mb)
    return _with_nr(ret, front)


def encode_b(mb_h: int, mb_w: int, me_range: int, deblock_on: bool, y, u, v,
             l0, l1, qtab: dict, lam: int, qp: int, hdr_vals, hdr_lens,
             alpha_off: int, beta_off: int, chroma_qp_offset: int, mvp_seed,
             mvp_seed_l1, col_ref4, col_mv4, crop_w: int, crop_h: int,
             with_metrics: bool, subpel_steps=(2, 1)) -> dict:
    """One B frame with CAVLC entropy (x264_tpu's encode_b): the B body
    through inter.encode_b_front as encode_b_cabac runs it, K24's pass A
    alone (cabac_planes.b_maps), K25 (header slots, the MBs' codes, the
    trailing skip run, the stop bit), K2 with both lists' maps and K4, at
    the frame QP. Arguments as encode_b_cabac's, with the header slots of
    encode_p. Returns dict(recon_y/u/v, words, host32 = [nbits, n_intra,
    n_skip, ssd_y, ssd_u, ssd_v, ssim], intra_mb, bmode)."""
    front = inter.encode_b_front(mb_h, mb_w, me_range, y, u, v, l0, l1, qtab,
                                 lam, mvp_seed, mvp_seed_l1, col_ref4,
                                 col_mv4, subpel_steps)
    maps = cabac_planes.b_maps(front, mb_h, mb_w)
    words, nbits = edev.cavlc_b_slice(front, maps, mb_h, mb_w, hdr_vals,
                                      hdr_lens, capacity_words(mb_h * mb_w))
    ry, ru, rv = _b_deblock(mb_h, mb_w, front, maps, qp, deblock_on,
                            alpha_off, beta_off, chroma_qp_offset)
    h32 = host32_pack([nbits, front["intra_mb"].sum(), maps["skip"].sum()],
                      y, u, v, ry, ru, rv, crop_w, crop_h, with_metrics)
    return dict(recon_y=ry, recon_u=ru, recon_v=rv, words=words, host32=h32,
                intra_mb=front["intra_mb"], bmode=front["bmode"])

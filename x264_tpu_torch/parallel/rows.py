"""MB-row sharding: one H.264 slice per band of MB rows, each band on a
device of its own, with the reference halo copied between the bands
(x264_tpu/parallel/rows.py, ported).

The design is x264_tpu's, which re-expresses the reference's slice
threading (doc/threads.txt:1-8) and its frame-thread row contract
(i_mv_range_thread, encoder/encoder.c:557-578):

- each band is an independent slice: no intra prediction, MV prediction
  or skip run crosses a band edge, each band's CABAC contexts start
  afresh (spec 9.3.1), and the slice header disables deblocking across
  slice edges (disable_deblocking_filter_idc 2), so the bands are exactly
  parallel and the stream is conformant;
- motion search on a band reads reference rows beyond it: each band gets
  a 32-row luma (16-row chroma) halo of real rows from its neighbours'
  deblocked reconstructions, replicated at the frame's top and bottom
  (halo_extend, kernel K28), and the ME window (me_range <= 24 plus the
  interpolation margin) never leaves it.

Where x264_tpu runs one shard_map program over a mesh of devices and
moves the halo with ppermute, the port loops over the bands on a list of
devices (band_devices, the counterpart of make_rows_mesh): the strips go
to the band's device with non-blocking copies (peer to peer between
cards) and every band's kernels are queued on its device's current
stream, so nothing in the loop waits on the host and bands on separate
cards overlap. The band bodies are the port's unsharded pipelines
(encoder/pipeline.py) at the band's geometry, with exactly the options
x264_tpu's band programs pass, which are fewer than its unsharded
pipelines take: no chroma ME, no I8x8, no QP map in the I bands, the
partitions always on, and in the CAVLC P band no decimation, RD, P8x8 or
8x8 transform. A CABAC band's op stream is halfword-packed on the device
(K27, entropy/cabac_planes.py:hw_pack) before it crosses to the host.
"""

from __future__ import annotations

import contextlib

import torch

from .. import cuda
from ..encoder import pipeline
from ..entropy import cabac_planes
from ..ops import mc as omc

I32 = torch.int32

# the halo of a luma plane; chroma carries half
HALO = omc.PAD


def band_devices(devices, n: int) -> list:
    """The devices of n bands: the first n of the encoder's list
    (x264_tpu's make_rows_mesh, rows.py:49, over jax.devices()[:n]). A
    device may repeat, as XLA's forced host device count repeats one
    host."""
    return [torch.device(d) for d in list(devices)[:n]]


def split_rows(t, devs, rows: int) -> list:
    """The bands of a row-major tensor (rows of it each), each on its
    band's device (a non-blocking copy, or the slice itself where the
    device is the tensor's own)."""
    return [t[k * rows:(k + 1) * rows].to(d, non_blocking=True)
            for k, d in enumerate(devs)]


def on_device(dev):
    """dev as the current device (where the CUDA runtime launches), or
    nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


# --------------------------------------------------------------- K28
def halo_extend_plain(planes, above, below):
    """Plain version of K28: one band's (y, u, v) with the neighbours'
    strips above / below (each (y, u, v) of HALO / HALO // 2 rows, or
    None at the frame's top / bottom, where the band's own edge row is
    replicated), then HALO / HALO // 2 edge-replicated columns each side
    (x264_tpu's _halo_extend then its horizontal pad, rows.py:57-73,
    154-163). Returns the int32 padded planes."""
    out = []
    for i, p in enumerate(planes):
        h = HALO if i == 0 else HALO // 2
        p = p.to(I32)
        top = p[:1].expand(h, -1) if above is None else above[i].to(I32)
        bot = p[-1:].expand(h, -1) if below is None else below[i].to(I32)
        ext = torch.cat([top, p, bot])
        out.append(torch.cat([ext[:, :1].expand(-1, h), ext,
                              ext[:, -1:].expand(-1, h)], 1))
    return tuple(out)


def halo_extend(planes, above, below):
    """K28 `halo_extend`: one band's padded reference planes.

    Replaces the device half of x264_tpu/parallel/rows.py:_halo_extend
    (rows.py:57) and _ext_refs (rows.py:154). planes: the band's int32
    (y, u, v) recon, (band*16, W) and (band*8, W/2); above / below: the
    neighbour bands' strips on the same device (HALO and HALO // 2 rows),
    or None at the frame's edge. On CUDA tensors one launch of
    csrc/halo.cu writes the three planes; on CPU tensors the plain
    version. Returns ((band*16 + 64, W + 64), and twice (band*8 + 32,
    W/2 + 32)) int32."""
    y = planes[0]
    if y.device.type == "cpu":
        return halo_extend_plain(planes, above, below)
    hb, w = y.shape
    shapes = ((hb, w), (hb // 2, w // 2), (hb // 2, w // 2))
    for i, (p, s) in enumerate(zip(planes, shapes)):
        cuda.check(p, s, I32, f"band plane {i}")
        for what, strip in (("above", above), ("below", below)):
            if strip is not None:
                h = HALO if i == 0 else HALO // 2
                cuda.check(strip[i], (h, s[1]), I32, f"{what} strip {i}")
    outs = tuple(torch.empty((s[0] + 2 * h, s[1] + 2 * h), dtype=I32,
                             device=y.device)
                 for s, h in zip(shapes, (HALO, HALO // 2, HALO // 2)))
    ptr = lambda strip, i: 0 if strip is None else strip[i].data_ptr()
    args = []
    for i in range(3):
        args += [planes[i].data_ptr(), ptr(above, i), ptr(below, i),
                 outs[i].data_ptr()]
    cuda.launch("halo", "halo_extend", "p" * 12 + "iii" + "p", *args, hb, w,
                HALO, cuda.stream(y.device))
    halo_extend.launches += 1
    return outs


halo_extend.launches = 0


def ext_refs(ref_bands, k: int, dev):
    """Band k's padded planes of one reference held as per-band (y, u, v)
    on the bands' devices (x264_tpu's _ext_refs): the neighbours' edge
    strips cross to dev, then K28."""
    n = len(ref_bands)

    def strips(j, rows):
        return tuple(p[rows(h)].to(dev, non_blocking=True).contiguous()
                     for p, h in zip(ref_bands[j],
                                     (HALO, HALO // 2, HALO // 2)))

    above = None if k == 0 else strips(k - 1, lambda h: slice(-h, None))
    below = None if k == n - 1 else strips(k + 1, lambda h: slice(0, h))
    return halo_extend(tuple(p.contiguous() for p in ref_bands[k]), above,
                       below)


# ------------------------------------------------------ the band programs
def _packed(out: dict, band: int, mb_w: int) -> dict:
    """A CABAC band's result: its recon, the K27 halfword words of its op
    stream and their count, and its [n_intra, n_skip]."""
    words, n_hw = cabac_planes.hw_pack(
        out["ops"], out["host32"][0],
        pipeline.cabac_capacity_hw(band * mb_w))
    return dict(recon=(out["recon_y"], out["recon_u"], out["recon_v"]),
                words=words, count=n_hw, mbs=out["host32"][1:3])


def _words(out: dict) -> dict:
    """A CAVLC band's result: its recon, packed words and bit count, and
    its [n_intra, n_skip]."""
    return dict(recon=(out["recon_y"], out["recon_u"], out["recon_v"]),
                words=out["words"], count=out["host32"][0],
                mbs=out["host32"][1:3])


# Every band program takes first: the bands' devices, the band's MB rows,
# mb_w, whether to deblock, each band's (y, u, v) source and tables on its
# device, lambda, the QP and the deblock offsets (alpha, beta, chroma QP).
def encode_i_rows_cabac(devs, band: int, mb_w: int, deblock_on: bool, src,
                        qtabs, lam: int, qp: int, alpha_off: int,
                        beta_off: int, chroma_qp_offset: int, i4x4: bool,
                        t8_mode: bool = False) -> list:
    """An IDR frame as len(devs) band CABAC slices (x264_tpu's
    encode_i_rows_cabac, rows.py:319): each band on its device runs K1
    (I16x16, and I4x4 where i4x4; no I8x8, no QP map), K3 (t8_mode: the
    PPS's transform flag of I_NxN MBs), K2 and K27. Returns a dict per
    band: recon, words, count (n_hw), mbs."""
    res = []
    for k, d in enumerate(devs):
        with on_device(d):
            out = pipeline.encode_i16_idr_cabac(
                band, mb_w, deblock_on, *src[k], qtabs[k], lam, qp,
                alpha_off, beta_off, chroma_qp_offset, 0, 0, False,
                t8=t8_mode, i4x4=i4x4)
            res.append(_packed(out, band, mb_w))
    return res


def encode_i_rows(devs, band: int, mb_w: int, deblock_on: bool, src, qtabs,
                  lam: int, qp: int, alpha_off: int, beta_off: int,
                  chroma_qp_offset: int, i4x4: bool, hdrs) -> list:
    """An IDR frame as band CAVLC slices (x264_tpu's encode_i_rows,
    rows.py:374): K1 (I4x4 where i4x4), K18 (hdrs: each band's header
    slots), K2. Returns a dict per band: recon, words, count (nbits),
    mbs."""
    res = []
    for k, d in enumerate(devs):
        with on_device(d):
            out = pipeline.encode_i16_idr(
                band, mb_w, deblock_on, *src[k], qtabs[k], lam, qp,
                *hdrs[k], alpha_off, beta_off, chroma_qp_offset, 0, 0, False,
                i4x4=i4x4)
            res.append(_words(out))
    return res


def encode_p_rows_cabac(devs, band: int, mb_w: int, deblock_on: bool, src,
                        qtabs, lam: int, qp: int, alpha_off: int,
                        beta_off: int, chroma_qp_offset: int, me_range: int,
                        subpel_steps, ref, seeds, ref2=None,
                        t8: bool = False, decimate: bool = False,
                        rd: bool = False, p8x8: bool = False,
                        aq=None) -> list:
    """A P frame as band CABAC slices (x264_tpu's encode_p_rows_cabac,
    rows.py:244): each band pads its reference (and L0[1], ref2) with the
    neighbours' halo (K28) and runs the P pipeline at its geometry with
    the partitions, t8 / decimate / rd / p8x8 as given, no chroma ME, and
    under variance AQ (aq as pipeline.encode_p_cabac takes it) its own QP
    map and mb_qp_delta, whose forward fill starts at the slice QP; then
    K27. ref / ref2: the references as per-band (y, u, v); seeds: each
    band's ME predictors. Returns a dict per band: recon, words, count,
    mbs, mv, and the band's L0 maps ref4 / mv4, which a later B frame's
    spatial direct reads as its colocated maps (x264_tpu's band program
    returns none, so its B bands read all-intra maps where a decoder
    reads these: ROADMAP §3)."""
    res = []
    for k, d in enumerate(devs):
        with on_device(d):
            out = pipeline.encode_p_cabac(
                band, mb_w, me_range, deblock_on, *src[k],
                *ext_refs(ref, k, d), qtabs[k], lam, qp, alpha_off, beta_off,
                chroma_qp_offset, seeds[k], 0, 0, False, decimate,
                subpel_steps, parts=True, p8x8=p8x8, rd=rd, t8=t8, aq=aq,
                ref2=None if ref2 is None else ext_refs(ref2, k, d),
                ref_prepadded=True)
            res.append(dict(_packed(out, band, mb_w), mv=out["mv"],
                            ref4=out["ref4"], mv4=out["mv4"]))
    return res


def encode_p_rows(devs, band: int, mb_w: int, deblock_on: bool, src, qtabs,
                  lam: int, qp: int, alpha_off: int, beta_off: int,
                  chroma_qp_offset: int, me_range: int, subpel_steps, ref,
                  seeds, hdrs) -> list:
    """A P frame as band CAVLC slices (x264_tpu's encode_p_rows,
    rows.py:126): K28, then the P pipeline with the partitions and
    nothing else (no decimation, RD, P8x8, 8x8 transform or QP map,
    rows.py:92-95), K8's pass A, K19 (hdrs: each band's header slots) and
    K2. Returns a dict per band: recon, words, count (nbits), mbs, mv."""
    res = []
    for k, d in enumerate(devs):
        with on_device(d):
            out = pipeline.encode_p(
                band, mb_w, me_range, deblock_on, *src[k],
                *ext_refs(ref, k, d), qtabs[k], lam, qp, *hdrs[k],
                alpha_off, beta_off, chroma_qp_offset, seeds[k], 0, 0, False,
                False, subpel_steps, parts=True, ref_prepadded=True)
            res.append(dict(_words(out), mv=out["mv"]))
    return res


def encode_b_rows_cabac(devs, band: int, mb_w: int, deblock_on: bool, src,
                        qtabs, lam: int, qp: int, alpha_off: int,
                        beta_off: int, chroma_qp_offset: int, me_range: int,
                        subpel_steps, l0, l1, seeds, seeds_l1, col_ref4,
                        col_mv4, t8: bool = False) -> list:
    """A B frame as band CABAC slices (x264_tpu's encode_b_rows_cabac,
    rows.py:434): both lists' halos (K28), the B pipeline at the band's
    geometry (spatial direct band-local, as the slice rules have it), K2
    with both lists' maps and K27. l0 / l1: per-band (y, u, v); seeds /
    seeds_l1 / col_ref4 / col_mv4: per band. Returns a dict per band:
    recon, words, count, mbs."""
    res = []
    for k, d in enumerate(devs):
        with on_device(d):
            out = pipeline.encode_b_cabac(
                band, mb_w, me_range, deblock_on, *src[k],
                ext_refs(l0, k, d), ext_refs(l1, k, d), qtabs[k], lam, qp,
                alpha_off, beta_off, chroma_qp_offset, seeds[k], seeds_l1[k],
                col_ref4[k], col_mv4[k], 0, 0, False, subpel_steps, t8=t8,
                ref_prepadded=True)
            res.append(_packed(out, band, mb_w))
    return res

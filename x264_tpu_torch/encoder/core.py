"""Encoder orchestration — the analogue of encoder/encoder.c, ported from
x264_tpu/encoder/core.py for CABAC IDR and P frames at constant QP.

Open / encode / close lifecycle (x264_encoder_open:623,
x264_encoder_encode:1362, x264_encoder_close:1878): parameter
validation, headers, the frame-type decision (an IDR every i_keyint_max
frames, and at a scene cut found by the lowres lookahead once
i_keyint_min frames have passed; P frames between; no B frames),
dispatch of each frame's device work to the current CUDA stream, and the
host tail — CABAC arithmetic coding of the device-produced op stream,
NAL assembly, rate control and statistics. The DPB is the one deblocked
reconstruction of the last frame, kept on the device with its MV field,
which seeds the next P frame's motion search.

With i_frame_parallel > 1 the output is delayed (x264_encoder_encode's
contract: a call may return no frame; flush() drains): frame N's kernels
are queued, its op stream and metrics vector start a non-blocking copy
into pinned host memory ordered by a CUDA event, and the host CABAC of
an earlier frame runs while the card works. P frame N reads frame N-1's
deblocked reconstruction on the same stream, so the pipe needs no
further synchronisation. With the scenecut lookahead on, the frame type
must be known before the frame is queued: the frame's planes cross to
the card on a stream of their own, the lookahead kernels run there, and
the host waits for that stream alone before it reads their two sums; the
encoder's stream waits on an event after the upload.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import tables
from ..entropy import cabac as ecabac
from ..entropy import cabac_tables as ctab
from ..entropy.bitstream import BitWriter, nal_unit, NAL_SLICE, NAL_SLICE_IDR
from ..headers import PPS, SPS, SLICE_I, SLICE_P, SliceHeader, sei_version
from ..params import (ANALYSE_I4x4, ANALYSE_I8x8, ANALYSE_PSUB16x16,
                      EncoderParams)
from . import inter
from . import intra
from . import pipeline
from . import ratecontrol as rcmod
from . import stats as estats


def pad_plane(plane: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Edge-replicate to MB-aligned size (expand_border_mod16,
    common/frame.c:310-330)."""
    h, w = plane.shape
    out = np.empty((target_h, target_w), dtype=plane.dtype)
    out[:h, :w] = plane
    if w < target_w:
        out[:h, w:] = plane[:, w - 1:w]
    if h < target_h:
        out[h:, :] = out[h - 1:h, :]
    return out


class Frame:
    """A picture in planar 8-bit 4:2:0 (x264_picture_t analogue): numpy
    arrays on input; device tensors in an EncodedFrame's recon."""

    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v

    @property
    def shape(self):
        return self.y.shape


class EncodedFrame:
    def __init__(self, payload: bytes, frame_type: str, recon: Frame,
                 bits: int, display_idx: int = -1):
        self.payload = payload
        self.frame_type = frame_type
        self.recon = recon
        self.bits = bits
        self.display_idx = display_idx


def _check_slice(p: EncoderParams, p_frames: bool) -> None:
    """Raise on every parameter outside this slice of the port; p_frames:
    whether the stream will hold P frames (i_keyint_max > 1, or a forced
    P), which this slice encodes at subme 1-9 (with the 16x8 / 8x16 /
    P8x8 partitions, chroma ME and, at subme >= 6, the RD ladder with
    psy-RD, where the parameters ask for them), with one reference and
    the scenecut lookahead or a fixed GOP, with or without the 8x8
    transform and I8x8."""
    a, rc = p.analyse, p.rc
    later = [
        (p_frames and p.i_frame_reference >= 2,
         "multiple references (ref >= 2)", "a later slice"),
        (p.i_bframe > 0, "B frames", "the B slice"),
        (not p.b_cabac, "CAVLC", "the CAVLC slice"),
        (rc.i_qp_constant == 0, "lossless (qp 0)", "a later slice"),
        (not a.intra & ANALYSE_I4x4, "intra without I4x4", "a later slice"),
        (a.i_trellis > 0, "trellis", "the trellis slice"),
        (p.i_mb_row_shards > 1, "MB-row sharding", "the multi-GPU slice"),
        (a.i_noise_reduction > 0, "noise reduction", "a later slice"),
        (p.i_cqm_preset != 0, "custom quant matrices", "a later slice"),
        (rc.i_vbv_max_bitrate > 0 or rc.i_vbv_buffer_size > 0, "VBV",
         "the rate-control slice"),
    ]
    for bad, what, when in later:
        if bad:
            raise NotImplementedError(
                f"{what} is not in this slice of the port; it comes with "
                f"{when}")


class Encoder:
    """x264_encoder_open / encode / close for CABAC IDR + P frames at
    constant QP. device: "cuda" (the default, which needs a card) or
    "cpu", where every kernel runs its plain PyTorch version."""

    def __init__(self, params: EncoderParams, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: Encoder runs on the card by default; "
                    "pass device='cpu' for the plain PyTorch versions")
            device = "cuda"
        self.device = torch.device(device)
        self.params = params.validate()
        p = self.params
        _check_slice(p, p.i_keyint_max > 1)
        self.rc = rcmod.RateControl(p)
        self.qt = tables.QuantTables(
            luma_deadzone_inter=p.analyse.i_luma_deadzone[0],
            luma_deadzone_intra=p.analyse.i_luma_deadzone[1])
        self.sps = SPS.from_params(p)
        self.pps = PPS.from_params(p)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.poc = 0
        self.frame_count = 0
        self._disp_abs = 0
        self._qtab_cache: dict = {}
        self._qtab_p_cache: dict = {}
        # DPB: the deblocked reconstruction of the last frame and the MV
        # field that seeds the next P frame's ME (both on the device)
        self._ref = None
        self._prev_mv = None
        self._gop_pos = 0
        self._since_idr = 0
        self._disp_since_idr = 0
        # the lowres lookahead: at CQP only for scenecut detection
        self._analyse_lowres = (p.i_scenecut_threshold > 0
                                and p.i_keyint_max > 1)
        self._la_stream = torch.cuda.Stream(self.device) \
            if self._analyse_lowres and self.device.type == "cuda" else None
        # ME window clamped so every candidate stays inside the PAD=32
        # frame border, as x264_tpu clamps it
        self._me_range = min(p.analyse.i_me_range, 24)
        self._decimate = bool(p.analyse.b_dct_decimate)
        # the subme ladder, as x264_tpu sets it: 1 full-pel, 2-3 half-pel,
        # 4-9 half- then quarter-pel; the 16x8 / 8x16 / P8x8 partitions
        # with PSUB16x16 (they need sub-pel steps); chroma ME at subme >= 5;
        # the RD mode decision at subme >= 6 (lossless, which turns it off
        # in x264_tpu, is refused)
        sp = p.analyse.i_subpel_refine
        self._subpel = () if sp <= 1 else ((2,) if sp <= 3 else (2, 1))
        self._parts = bool(p.analyse.inter & ANALYSE_PSUB16x16)
        self._p8x8 = self._parts
        self._chroma_me = bool(p.analyse.b_chroma_me and sp >= 5)
        self._rd = sp >= 6
        # the adaptive 8x8 transform (High profile) and, in I slices, the
        # I8x8 ladder, which validate() keeps only with CABAC + 8x8dct
        self._t8 = bool(p.analyse.b_transform_8x8)
        self._i8x8 = bool(p.analyse.intra & ANALYSE_I8x8)
        self.stats = estats.Stats(
            p.i_width, p.i_height, p.i_fps_num / max(1, p.i_fps_den),
            b_psnr=p.analyse.b_psnr, b_ssim=p.analyse.b_ssim)
        self._with_metrics = bool(p.analyse.b_psnr or p.analyse.b_ssim)
        self._pending: list = []
        self._delay = max(0, p.i_frame_parallel - 1)

    def reconfig(self, new_params: EncoderParams) -> None:
        raise NotImplementedError("reconfig comes with a later slice of "
                                  "the port")

    # ------------------------------------------------------------- headers
    def headers(self) -> bytes:
        """x264_encoder_headers: SPS + PPS + version SEI NALs
        (encoder/encoder.c:880-910 + x264_sei_version_write)."""
        return (self.sps.write() + self.pps.write()
                + sei_version(self.params.to_string()))

    # ------------------------------------------------------------- encode
    def encode(self, frame: Frame, forced_type: str | None = None,
               forced_qp: int | None = None) -> EncodedFrame | None:
        """x264_encoder_encode: the frame type (an IDR at GOP start, or at
        a scene cut the lookahead finds once i_keyint_min frames have
        passed since the last IDR; else P; forced_type "I" / "IDR" / "P"
        overrides it). With i_frame_parallel > 1 this queues the frame
        and returns an earlier one (or None while the pipe fills);
        flush() drains."""
        p = self.params
        if forced_type not in (None, "I", "IDR", "P"):
            raise NotImplementedError(f"forced {forced_type} frames come "
                                      "with the B slice of the port")
        if forced_type == "P":
            _check_slice(p, True)
        planes = self._pad_input(frame)
        scenecut = False
        if self._analyse_lowres:
            scenecut = self._scenecut(planes[0], frame)
        if forced_type in ("I", "IDR"):
            is_idr = True
        elif forced_type == "P" and self._ref is not None:
            is_idr = False
        else:
            is_idr = (self._gop_pos == 0 or self._ref is None
                      or p.i_keyint_max == 1
                      or (scenecut and self._since_idr >= p.i_keyint_min))
        disp_poc = 2 * self._disp_since_idr
        disp = self._disp_abs
        self._disp_abs += 1
        self._advance_gop(is_idr)
        self._submit_ip(frame, planes, is_idr, forced_qp,
                        0 if is_idr else disp_poc, disp)
        if len(self._pending) > self._delay:
            return self._finalize(self._pending.pop(0))
        return None

    def _scenecut(self, y, frame: Frame) -> bool:
        """The lookahead's verdict on this frame (RateControl.analyse_frame)
        from its luma y on the device; on the card on the lookahead's own
        stream, which the upload already ran on."""
        h, w = frame.y.shape
        with (torch.cuda.stream(self._la_stream) if self._la_stream
              is not None else contextlib.nullcontext()):
            return self.rc.analyse_frame(y, h, w, self._since_idr)["scenecut"]

    def _advance_gop(self, to_idr: bool) -> None:
        """Display-order GOP bookkeeping."""
        if to_idr:
            self._gop_pos = 0
            self._since_idr = 0
            self._disp_since_idr = 0
        self._gop_pos = (self._gop_pos + 1) % max(1, self.params.i_keyint_max)
        self._since_idr += 1
        self._disp_since_idr += 1

    def _submit_ip(self, frame: Frame, planes, is_idr: bool, forced_qp,
                   poc: int, disp: int) -> None:
        """Queue one reference frame (IDR or P) in encode order; planes:
        its MB-aligned planes on the device (_pad_input)."""
        qp = self.rc.start("I" if is_idr else "P",
                           frame_idx=self.frame_count)
        if forced_qp is not None:
            qp = max(0, min(51, int(forced_qp)))
            self.rc.last_qp = qp
        self.poc = poc
        pend = self._submit_idr(frame, planes, qp) if is_idr \
            else self._submit_p(frame, planes, qp)
        pend.update(frame=frame, qp=qp, disp=disp,
                    ftype="IDR" if is_idr else "P")
        self.frame_count += 1
        self._start_fetch(pend)
        self._pending.append(pend)

    def _qtab(self, qp: int, qp_c: int) -> dict:
        key = (qp, qp_c)
        if key not in self._qtab_cache:
            self._qtab_cache[key] = intra.make_qtab(qp, qp_c, self.device,
                                                    self.qt)
        return self._qtab_cache[key]

    def _qtab_p(self, qp: int, qp_c: int) -> dict:
        key = (qp, qp_c)
        if key not in self._qtab_p_cache:
            a = self.params.analyse
            self._qtab_p_cache[key] = inter.make_qtab_p(
                qp, qp_c, self.device, self.qt,
                rd_idc=self.params.i_cabac_init_idc if self._rd else None,
                f_psy_rd=a.f_psy_rd if a.b_psy else 0.0)
        return self._qtab_p_cache[key]

    def _pad_input(self, frame: Frame):
        """MB-aligned int32 planes on the device. On the card the bytes
        cross from pinned memory without blocking the host; with the
        lookahead on they cross on its stream, which the encoder's stream
        then waits for (an event, not a host wait)."""
        p = self.params
        mb_w, mb_h = p.mb_width, p.mb_height
        planes = [pad_plane(np.asarray(a, np.uint8), mb_h * s, mb_w * s)
                  for a, s in ((frame.y, 16), (frame.u, 8), (frame.v, 8))]
        if self.device.type == "cpu":
            return [torch.from_numpy(a).to(torch.int32) for a in planes]
        main = torch.cuda.current_stream(self.device)
        up = self._la_stream or main
        out = []
        with torch.cuda.stream(up):
            for a in planes:
                staged = torch.empty(a.shape, dtype=torch.uint8,
                                     pin_memory=True)
                staged.numpy()[:] = a
                out.append(staged.to(self.device, non_blocking=True)
                           .to(torch.int32))
        if up is not main:
            main.wait_stream(up)
            for t in out:
                t.record_stream(main)
        return out

    def _slice_header(self, qp: int, slice_type: int) -> SliceHeader:
        p = self.params
        return SliceHeader(
            slice_type=slice_type, frame_num=self.frame_num,
            idr_pic_id=self.idr_pic_id if slice_type == SLICE_I else -1,
            poc_lsb=self.poc % (1 << self.sps.log2_max_poc_lsb),
            qp=qp, pic_init_qp=self.pps.pic_init_qp,
            disable_deblock=0 if p.b_deblocking_filter else 1,
            alpha_c0_offset=p.i_deblocking_filter_alphac0,
            beta_offset=p.i_deblocking_filter_beta,
            cabac=p.b_cabac, num_ref_idx_l0=1, num_ref_idx_l1=1,
            num_ref_idx_override=False,
            log2_max_frame_num=self.sps.log2_max_frame_num,
            log2_max_poc_lsb=self.sps.log2_max_poc_lsb)

    def _cabac_header(self, qp: int, slice_type: int,
                      nal_ref_idc: int) -> bytearray:
        """Slice header bytes + cabac_alignment_one_bit (spec 7.3.4),
        built at submit time while frame_num / POC / idr_pic_id hold this
        frame's values."""
        hdr = BitWriter()
        self._slice_header(qp, slice_type).write_rbsp(
            hdr, nal_ref_idc=nal_ref_idc)
        pad = (-hdr.bit_pos) % 8
        if pad:
            hdr.put((1 << pad) - 1, pad)
        return bytearray(hdr.pack())

    def _submit_idr(self, frame: Frame, planes, qp: int) -> dict:
        p = self.params
        mb_w, mb_h = p.mb_width, p.mb_height
        y, u, v = planes
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        # an IDR resets frame_num, POC (spec 7.4.3) and the ME seed field
        self.frame_num = 0
        self.poc = 0
        self._prev_mv = None
        hdr_bytes = self._cabac_header(qp, SLICE_I, 3)
        out = pipeline.encode_i16_idr_cabac(
            mb_h, mb_w, bool(p.b_deblocking_filter), y, u, v,
            self._qtab(qp, qp_c), int(tables.LAMBDA_TABLE[qp]), qp,
            2 * p.i_deblocking_filter_alphac0,
            2 * p.i_deblocking_filter_beta, p.analyse.i_chroma_qp_offset,
            crop_w=p.i_width, crop_h=p.i_height,
            with_metrics=self._with_metrics, t8=self._t8, i8x8=self._i8x8)
        recon = self._finish_frame(out, frame)
        self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        return dict(out=out, hdr_bytes=hdr_bytes, recon=recon,
                    nmb=mb_h * mb_w, slice_is_i=True,
                    nal_type=NAL_SLICE_IDR, nal_ref_idc=3)

    def _submit_p(self, frame: Frame, planes, qp: int) -> dict:
        """One P frame against the DPB (x264_encoder_encode P path):
        subme 1-9, one reference, CABAC."""
        p = self.params
        mb_w, mb_h = p.mb_width, p.mb_height
        y, u, v = planes
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        mvp_seed = self._prev_mv if self._prev_mv is not None \
            else torch.zeros((mb_h, mb_w, 2), dtype=torch.int32,
                             device=self.device)
        hdr_bytes = self._cabac_header(qp, SLICE_P, 2)
        out = pipeline.encode_p_cabac(
            mb_h, mb_w, self._me_range, bool(p.b_deblocking_filter), y, u, v,
            *self._ref, self._qtab_p(qp, qp_c), int(tables.LAMBDA_TABLE[qp]),
            qp, 2 * p.i_deblocking_filter_alphac0,
            2 * p.i_deblocking_filter_beta, p.analyse.i_chroma_qp_offset,
            mvp_seed, crop_w=p.i_width, crop_h=p.i_height,
            with_metrics=self._with_metrics, decimate=self._decimate,
            subpel_steps=self._subpel, parts=self._parts, p8x8=self._p8x8,
            chroma_me=self._chroma_me, rd=self._rd, t8=self._t8)
        self._prev_mv = out["mv"]
        return dict(out=out, hdr_bytes=hdr_bytes,
                    recon=self._finish_frame(out, frame), nmb=mb_h * mb_w,
                    slice_is_i=False, nal_type=NAL_SLICE, nal_ref_idc=2)

    def _finish_frame(self, out: dict, frame: Frame) -> Frame:
        """Update the DPB and crop the recon view (x264_reference_update,
        encoder/encoder.c:1059)."""
        self._ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        self.frame_num = (self.frame_num + 1) \
            % (1 << self.sps.log2_max_frame_num)
        crop = lambda t, a: t[:a.shape[0], :a.shape[1]]
        return Frame(crop(out["recon_y"], frame.y),
                     crop(out["recon_u"], frame.u),
                     crop(out["recon_v"], frame.v))

    def _start_fetch(self, pend: dict) -> None:
        """Queue the d2h of this frame's op stream and host32 vector right
        behind its kernels: non-blocking copies into pinned memory and a
        CUDA event that _finalize waits on."""
        out = pend["out"]
        if self.device.type == "cpu":
            pend["fetch"] = (None, out["ops"], out["host32"])
            return
        ops_h = torch.empty(out["ops"].shape, dtype=torch.int32,
                            pin_memory=True)
        h32_h = torch.empty(out["host32"].shape, dtype=torch.int32,
                            pin_memory=True)
        ops_h.copy_(out["ops"], non_blocking=True)
        h32_h.copy_(out["host32"], non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        pend["fetch"] = (done, ops_h, h32_h)

    def flush(self) -> list:
        """Drain delayed frames (the pic_in=NULL flush loop contract,
        x264.c:870-873)."""
        out = []
        while self._pending:
            out.append(self._finalize(self._pending.pop(0)))
        return out

    def _cabac_payload(self, pend: dict, ops: np.ndarray) -> bytes:
        """Arithmetic coding of the device-produced op stream
        (x264_slice_write CABAC branch, encoder/encoder.c:1155-1199)."""
        hdr_bytes = pend["hdr_bytes"]
        states = ctab.init_states(pend["slice_is_i"], pend["qp"],
                                  self.params.i_cabac_init_idc)
        payload, fixup = ecabac.encode_ops(states, ops, hdr_bytes[-1])
        hdr_bytes[-1] = fixup
        return nal_unit(pend["nal_type"], pend["nal_ref_idc"],
                        bytes(hdr_bytes) + payload)

    def _finalize(self, pend: dict) -> EncodedFrame:
        """Host tail of one frame: wait for its copies, entropy-code, RC
        accounting and stats (x264_encoder_frame_end,
        encoder/encoder.c:1705)."""
        done, ops_t, h32_t = pend["fetch"]
        if done is not None:
            done.synchronize()
        h32 = h32_t.numpy()
        n_ops = int(h32[0])
        ops = ops_t.numpy()[:n_ops].view(np.uint32)
        payload = self._cabac_payload(pend, ops)
        bits = len(payload) * 8
        ftype, nmb = pend["ftype"], pend["nmb"]
        if ftype == "P":
            n_intra, n_skip = int(h32[1]), int(h32[2])
            counts = (n_intra, nmb - n_intra - n_skip, n_skip)
        else:
            counts = (nmb, 0, 0)
        self.rc.end("I" if ftype == "IDR" else ftype, bits, pend["qp"],
                    counts)
        metrics = None
        if self._with_metrics:
            metrics = tuple(float(x) for x in h32[3:7].view(np.float32))
        self.stats.add_frame(ftype, bits, pend["qp"], metrics, counts)
        return EncodedFrame(payload, ftype, pend["recon"], bits, pend["disp"])

    def close(self) -> dict:
        """x264_encoder_close: emit the global stats report
        (encoder/encoder.c:1878-2080) and return it as a dict."""
        self.rc.write_stats()
        summary = self.stats.summary()
        if self.params.i_log_level >= 1 and summary:
            from .. import log as xlog
            for line in self.stats.report_lines():
                xlog.log(xlog.LOG_INFO, line)
        return summary

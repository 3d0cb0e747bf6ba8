"""Encoder orchestration — the analogue of encoder/encoder.c, ported from
x264_tpu/encoder/core.py for IDR, P and B frames, CABAC or CAVLC, with
one or two L0 references in the P frames (--ref 2; deeper lists clamp to
2, as x264_tpu's validate() does), at constant QP, CRF or 1-pass ABR,
with or without variance AQ, and with or without the CABAC trellis
(--trellis 1 / 2) in the inter residual; with flat, JVT or custom quant
matrices (--cqm), the noise reduction (--nr) and the lossless transform
bypass (CQP 0). MB-row sharding (i_mb_row_shards > 1) encodes unsharded
where the host has one device, as x264_tpu does.

Open / encode / close lifecycle (x264_encoder_open:623,
x264_encoder_encode:1362, x264_encoder_close:1878): parameter
validation, headers, the frame-type decision (an IDR every i_keyint_max
frames, and at a scene cut found by the lowres lookahead once
i_keyint_min frames have passed; P frames between, or with i_bframe > 0
runs of up to i_bframe B frames, each run encoded after the P that
closes it, typed by b-adapt 0 / 1 / 2 on the lowres costs of K21),
dispatch of each frame's device work to the current CUDA stream, and the
host tail — CABAC arithmetic coding of the device-produced op stream (or,
under CAVLC, the device-packed slice words taken as they are), NAL
assembly, rate control and statistics. The DPB is the deblocked
reconstructions of the last two references (a B frame's L0 and L1; with
--ref 2 a P frame's L0[0] and L0[1], PicNum-descending), kept
on the device with the last P's MV field, which seeds the next P frame's
motion search, and the last reference's 4x4 L0 maps, the colocated maps
of spatial direct.

With i_frame_parallel > 1 the output is delayed (x264_encoder_encode's
contract: a call may return no frame; flush() drains): frame N's kernels
are queued, its op stream (or slice words) and metrics vector start a
non-blocking copy into pinned host memory ordered by a CUDA event, and
the host tail of an earlier frame runs while the card works. P frame N
reads frame N-1's deblocked reconstruction on the same stream, so the
pipe needs no further synchronisation. With the lowres lookahead on
(scenecut, and CRF / ABR, whose frame QP reads the lookahead's P cost),
the frame type and QP must be known before the frame is queued: the
frame's planes cross to the card on a stream of their own, the lookahead
kernels run there, and the host waits for that stream alone before it
reads their two sums; the encoder's stream waits on an event after the
upload. Rate control starts each frame when it is queued and ends it
when its bits are known, at the same points of the pipe as x264_tpu, so
the QPs that depend on earlier frames' sizes are the same at every
i_frame_parallel.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .. import cqm as xcqm
from .. import log as xlog
from .. import tables
from ..entropy import cabac as ecabac
from ..entropy import cabac_tables as ctab
from ..entropy import cavlc_vec
from ..entropy import device as edev
from ..entropy.bitstream import BitWriter, nal_unit, NAL_SLICE, NAL_SLICE_IDR
from ..headers import (PPS, SPS, SLICE_B, SLICE_I, SLICE_P, SliceHeader,
                       sei_version)
from ..ops import quant as oquant
from ..parallel import rows as prows
from ..params import (ANALYSE_I4x4, ANALYSE_I8x8, ANALYSE_PSUB16x16,
                      AQ_NONE, B_ADAPT_NONE, B_ADAPT_TRELLIS, RC_CQP,
                      EncoderParams)
from . import aq as eaq
from . import inter
from . import intra
from . import lookahead
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


class Queued(NamedTuple):
    """A frame waiting in the B queue: its MB-aligned planes on the device,
    forced QP, display POC and index, and lowres planes (b-adapt)."""
    frame: Frame
    planes: list
    forced_qp: int | None
    poc: int
    disp: int
    lows: object = None


class EncodedFrame:
    def __init__(self, payload: bytes, frame_type: str, recon: Frame,
                 bits: int, display_idx: int = -1):
        self.payload = payload
        self.frame_type = frame_type
        self.recon = recon
        self.bits = bits
        self.display_idx = display_idx


def _check_slice(p: EncoderParams) -> None:
    """Raise on every parameter outside this slice of the port, which
    encodes P frames at subme 1-9 (with the 16x8 / 8x16 / P8x8
    partitions, chroma ME and, at subme >= 6, the RD ladder with psy-RD,
    where the parameters ask for them), with one or two references and
    the scenecut lookahead or a fixed GOP, with or without the 8x8
    transform and I8x8 (which validate() turns off without CABAC), with
    or without I4x4 in the I slices, CABAC or CAVLC, at constant QP
    (lossless at QP 0), CRF or 1-pass ABR, with or without variance AQ
    (VBV and 2-pass replay are refused here and by
    RateControl), with or without the CABAC trellis, the noise reduction
    and custom quant matrices; and B frames (i_bframe 1-3, b-adapt 0 / 1
    / 2) with CABAC or CAVLC. MB-row sharding is checked by the Encoder,
    which knows its devices."""
    rc = p.rc
    later = [
        (rc.i_vbv_max_bitrate > 0 or rc.i_vbv_buffer_size > 0,
         "VBV (with its row rate control)", "the VBV slice"),
        (rc.b_stat_read, "2-pass replay", "the 2-pass slice"),
    ]
    for bad, what, when in later:
        if bad:
            raise NotImplementedError(
                f"{what} is not in this slice of the port; it comes with "
                f"{when}")


def _host_prefix(t, n: int) -> np.ndarray:
    """The first n entries of a 1-D int32 tensor on the host (from a card,
    a blocking copy of those alone)."""
    return t[:n].cpu().numpy()


def _aligned(hdr: BitWriter) -> bytearray:
    """A CABAC slice header's bytes: its bits and the
    cabac_alignment_one_bits up to the byte (spec 7.3.4)."""
    pad = (-hdr.bit_pos) % 8
    if pad:
        hdr.put((1 << pad) - 1, pad)
    return bytearray(hdr.pack())


class Encoder:
    """x264_encoder_open / encode / close for IDR, P (one or two
    references) and B frames, CABAC or CAVLC, at constant QP, CRF or
    1-pass ABR, with or without variance AQ, the CABAC trellis, the noise
    reduction and custom quant matrices, and lossless at CQP 0. device: a
    device ("cuda", "cuda:1", or "cpu", where every kernel runs its plain
    PyTorch version) or a sequence of them, one for each band of MB rows
    (i_mb_row_shards > 1; a device may repeat); the first is the main
    device, where the lookahead, rate control's inputs, the recon of each
    EncodedFrame and the metrics live. The default, None, is every
    visible card (it needs one)."""

    def __init__(self, params: EncoderParams, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: Encoder runs on the card by default; "
                    "pass device='cpu' for the plain PyTorch versions")
            device = [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
        elif isinstance(device, (str, torch.device)):
            device = [device]
        self.devices = [torch.device(d) for d in device]
        if not self.devices:
            raise ValueError("Encoder: an empty device list")
        self.device = self.devices[0]
        self.params = params.validate()
        p = self.params
        _check_slice(p)
        # before the SPS: a band split that does not divide the MB rows
        # pads the coded height, which the SPS must give
        self._check_shards(p)
        self.rc = rcmod.RateControl(p)
        # the quant tables of the CQM preset (flat, JVT, or the custom
        # lists of p.cqm / psz_cqm_file), read by every table builder
        sl4, sl8 = xcqm.scaling_lists(p.i_cqm_preset, p.cqm)
        self.qt = tables.QuantTables(
            luma_deadzone_inter=p.analyse.i_luma_deadzone[0],
            luma_deadzone_intra=p.analyse.i_luma_deadzone[1],
            scaling_list4=sl4, scaling_list8=sl8)
        # lossless: the transform bypass (qpprime_y_zero_transform_bypass,
        # encoder/macroblock.c:415-474) in K1, K6 and K7
        self._lossless = (p.rc.i_rc_method == RC_CQP
                          and p.rc.i_qp_constant == 0)
        self.sps = SPS.from_params(p)
        self.pps = PPS.from_params(p)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.poc = 0
        self.frame_count = 0
        self._disp_abs = 0
        self._qtab_cache: dict = {}
        self._qtab_p_cache: dict = {}
        # variance AQ: each MB's QP from K16, its tables read from the
        # 52-QP stacks, built once and kept on the device
        self._aq = None
        if p.rc.i_aq_mode != AQ_NONE:
            self._aq = (float(np.float32(p.rc.f_aq_strength)),
                        int(p.rc.i_qp_min), int(p.rc.i_qp_max))
            self._aq_stacks = eaq.qtab_stacks(
                eaq.full_tables(self.qt, self.device),
                p.analyse.i_chroma_qp_offset)
        # DPB: the deblocked reconstruction of the last reference and the
        # one before it (a B frame's L1 and L0), the MV field that seeds
        # the next P frame's ME and the last reference's 4x4 L0 maps (the
        # colocated maps of spatial direct), all on the device
        self._ref = None
        self._prev_ref = None
        self._ref_maps = None
        self._prev_mv = None
        # B frames: up to i_bframe non-reference frames wait in _bqueue
        # (Queued) until their L1 reference is queued; with b-adapt the
        # lowres planes of the last two references (_la_ref_lows,
        # _la_prev_lows) type and seed them
        self._bframes = p.i_bframe
        self._bqueue: list = []
        self._badapt = (self._bframes > 0
                        and p.i_bframe_adaptive != B_ADAPT_NONE)
        self._badapt2 = (self._bframes > 0
                         and p.i_bframe_adaptive == B_ADAPT_TRELLIS)
        self._la_ref_lows = self._la_prev_lows = None
        self._la_bh, self._la_bw = p.mb_height, p.mb_width
        self._la_r = max(4, min(12, p.analyse.i_me_range // 2))
        self._gop_pos = 0
        self._since_idr = 0
        self._disp_since_idr = 0
        # the lowres lookahead: the frame complexity of CRF / ABR, and the
        # scenecut detection
        self._analyse_lowres = (p.rc.i_rc_method != RC_CQP
                                or (p.i_scenecut_threshold > 0
                                    and p.i_keyint_max > 1))
        self._la_stream = torch.cuda.Stream(self.device) \
            if ((self._analyse_lowres or self._badapt)
                and self.device.type == "cuda") else None
        # ME window clamped so every candidate stays inside the PAD=32
        # frame border, as x264_tpu clamps it
        self._me_range = min(p.analyse.i_me_range, 24)
        self._decimate = bool(p.analyse.b_dct_decimate)
        # the subme ladder, as x264_tpu sets it: 1 full-pel, 2-3 half-pel,
        # 4-9 half- then quarter-pel; the 16x8 / 8x16 / P8x8 partitions
        # with PSUB16x16 (they need sub-pel steps); chroma ME at subme >= 5;
        # the RD mode decision at subme >= 6, off when lossless
        sp = p.analyse.i_subpel_refine
        self._subpel = () if sp <= 1 else ((2,) if sp <= 3 else (2, 1))
        self._parts = bool(p.analyse.inter & ANALYSE_PSUB16x16)
        self._p8x8 = self._parts
        self._chroma_me = bool(p.analyse.b_chroma_me and sp >= 5)
        self._rd = sp >= 6 and not self._lossless
        # CABAC (the host codes the device's op stream) or CAVLC (K18 /
        # K19 pack the slice words on the device)
        self._cabac = bool(p.b_cabac)
        # the adaptive 8x8 transform (High profile) and, in I slices, the
        # I8x8 ladder, which validate() keeps only with CABAC + 8x8dct
        self._t8 = bool(p.analyse.b_transform_8x8)
        # the CABAC trellis of the P frames' inter residual; x264_tpu reads
        # only whether i_trellis is set, so 1 and 2 encode alike (validate()
        # turns it off without CABAC); its 52-QP stacks are built once
        self._trellis = bool(p.analyse.i_trellis and p.b_cabac)
        self._trellis_full = None
        self._i8x8 = bool(p.analyse.intra & ANALYSE_I8x8)
        # the I4x4 ladder of the I slices (x264_tpu's _i4x4, core.py:93-94;
        # off under --partitions none, x264's ultrafast)
        self._i4x4 = bool(p.analyse.intra & ANALYSE_I4x4)
        # the noise reduction (x264_denoise_dct, common/quant.c:180, and
        # x264_noise_reduction_update, encoder/macroblock.c:890): per
        # position offsets shrink the P frames' inter luma coefficients;
        # the host updates them from each P frame's |coef| sums
        self._nr = int(p.analyse.i_noise_reduction)
        if self._nr and (self._bands is not None or self._lossless):
            xlog.log(xlog.LOG_INFO, "noise reduction is off in the "
                     "sharded/lossless paths")
            self._nr = 0
        if self._nr:
            self._nr_w = oquant.nr_weight2()
            self._nr_sum = [np.zeros(16, np.float64), np.zeros(64, np.float64)]
            self._nr_cnt = [0.0, 0.0]
            self._nr_off = [np.zeros(16, np.int32), np.zeros(64, np.int32)]
        self.stats = estats.Stats(
            p.i_width, p.i_height, p.i_fps_num / max(1, p.i_fps_den),
            b_psnr=p.analyse.b_psnr, b_ssim=p.analyse.b_ssim)
        self._with_metrics = bool(p.analyse.b_psnr or p.analyse.b_ssim)
        self._pending: list = []
        self._delay = max(0, p.i_frame_parallel - 1)
        if self._bands is not None and not self._cabac:
            self._delay = 0      # sharded CAVLC finalizes synchronously
        self._dev_tabs: dict = {}
        self._col_intra: dict = {}
        # the synchronous CAVLC IDR's branch ("fits", "retry" without
        # I4x4, or "host", the host coder) at i_frame_parallel 1; and
        # whether the host coder codes a lossless frame's bypass levels.
        # x264_tpu codes its transformed levels under the bypass SPS, which
        # decode to other pictures than its recon (ROADMAP §3); the port
        # codes the levels its recon was made from
        self.last_idr_branch = None
        self._host_bypass = self._lossless

    def _check_shards(self, p: EncoderParams) -> None:
        """MB-row sharding (x264_tpu core.py:149-175): min(shards, the
        devices) bands, fewer while a band would hold under 2 MB rows (the
        32-row halo must come from one neighbour); the coded height is
        padded to a multiple of the bands (rows hidden by the SPS crop),
        with x264_tpu's log line. On one band the encode runs unsharded,
        with x264_tpu's line. Sets _bands (the bands' devices, or None)
        and _n_shards."""
        self._bands, self._n_shards = None, 1
        if p.i_mb_row_shards <= 1:
            return
        n = min(p.i_mb_row_shards, len(self.devices))
        mb_h0 = (p.i_height + 15) // 16
        while n > 1 and ((mb_h0 + (-mb_h0 % n)) // n) * 16 < 32:
            n -= 1
        if n > 1:
            p.i_mb_height_pad = -mb_h0 % n
            if p.i_mb_height_pad and p.i_log_level >= 2:
                xlog.log(xlog.LOG_INFO,
                         f"padding coded height by {p.i_mb_height_pad} MB "
                         f"rows so {mb_h0} rows split across {n} bands "
                         "(cropped by the SPS window)")
            self._bands = prows.band_devices(self.devices, n)
            self._n_shards = n
        elif p.i_log_level >= 2:
            xlog.log(xlog.LOG_INFO, "mb-row sharding unavailable "
                     f"(shards={p.i_mb_row_shards}, "
                     f"mb_h={mb_h0}); encoding unsharded")

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
        passed since the last IDR; else P, or with i_bframe > 0 a B
        candidate that waits for its L1 reference; forced_type "I" /
        "IDR" / "P" overrides it, "B" leaves the choice to the encoder as
        x264_tpu does). With i_frame_parallel > 1, or with B frames, this
        queues the frame and returns an earlier one (or None while the
        pipe fills); flush() drains."""
        p = self.params
        if forced_type not in (None, "I", "IDR", "P", "B"):
            raise ValueError(f"unknown frame type {forced_type!r}")
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
        item = Queued(frame, planes, forced_qp, disp_poc, disp)
        if self._bframes == 0:
            self._advance_gop(is_idr)
            self._submit_ip(frame, planes, is_idr, forced_qp,
                            0 if is_idr else disp_poc, disp)
        elif is_idr:
            # an IDR closes the GOP: the newest queued candidate becomes a
            # P and the rest its B run (slicetype.c:597-635)
            self._flush_bqueue()
            self._advance_gop(True)
            self._submit_ip(frame, planes, True, forced_qp, 0, disp)
        elif forced_type == "P" or (not self._badapt2
                                    and len(self._bqueue) >= self._bframes):
            self._submit_ip(frame, planes, False, forced_qp, disp_poc, disp)
            self._advance_gop(False)
            self._submit_bqueue()
        elif self._badapt2 and self._ref is not None:
            self._badapt2_step(item)
            self._advance_gop(False)
        elif self._badapt and self._ref is not None:
            self._badapt_step(item)
            self._advance_gop(False)
        else:
            self._bqueue.append(item)
            self._advance_gop(False)
        if len(self._pending) > self._delay:
            return self._finalize(self._pending.pop(0))
        return None

    def _la_ctx(self):
        """The lookahead's stream (on the card), where the lowres kernels
        run and whose sums the host waits for alone."""
        return (torch.cuda.stream(self._la_stream)
                if self._la_stream is not None else contextlib.nullcontext())

    def _host_ints(self, t) -> list:
        """A small int32 tensor's values on the host; on the card through
        a pinned buffer, waiting for the lookahead's stream alone."""
        if t.device.type == "cpu":
            return [int(x) for x in t]
        host = torch.empty(t.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return [int(x) for x in host.numpy()]

    def _lowres(self, y, frame: Frame):
        """The lowres planes of a frame for b-adapt (x264_tpu's _lowres):
        K14 on its luma plane already on the device."""
        h, w = frame.y.shape
        with self._la_ctx():
            return lookahead.lowres_planes(y, h, w)

    def _badapt_step(self, item) -> None:
        """One b-adapt 1 greedy step (slicetype.c:545-573, x264_tpu's
        _badapt_step) on K21's lowres costs: this frame extends the B run,
        closes it as a P, or, at the first test, the queued candidate
        becomes a P."""
        lows = self._lowres(item.planes[0], item.frame)
        item = item._replace(lows=lows)
        q = self._bqueue
        if not q or self._la_ref_lows is None:
            q.append(item)
            return
        bh, bw, r = self._la_bh, self._la_bw, self._la_r
        if len(q) == 1:
            with self._la_ctx():
                cost1p0, cost2p0, cost1b1, cost2p1, n_intra2 = \
                    self._host_ints(lookahead.badapt_first(
                        q[0].lows, lows, self._la_ref_lows, bh, bw, r))
            nblk = (bh - 2) * (bw - 2) if min(bh, bw) > 2 else bh * bw
            if (n_intra2 > nblk // 2
                    or cost1p0 + cost2p0 < cost1b1 + cost2p1):
                # the candidate becomes a P; this frame starts the next
                # run's queue (slicetype.c no_b_frames)
                self._submit_queued(q.pop(0))
                q.append(item)
                return
        j = len(q) + 1
        with self._la_ctx():
            pcost, n_intra, nblk = self._host_ints(lookahead.badapt_ext(
                lows, self._la_ref_lows, bh, bw, r))
        pthresh = max(lookahead.INTER_THRESH
                      - (50 - self.params.i_bframe_bias) * (j - 1),
                      lookahead.INTER_THRESH // 10)
        if pcost > pthresh * nblk or n_intra > nblk // 3:
            self._submit_queued(item)
            self._submit_bqueue()
        else:
            q.append(item)

    def _badapt2_step(self, item) -> None:
        """b-adapt 2 (x264_tpu's _badapt2_step): queue up to i_bframe + 1
        undecided frames, then search the window's paths and commit the
        first segment."""
        q = self._bqueue
        q.append(item._replace(lows=self._lowres(item.planes[0], item.frame)))
        if self._la_ref_lows is None:
            self._submit_queued(q.pop(0))
            return
        if len(q) <= self._bframes:
            return
        self._badapt2_decide()

    def _badapt2_decide(self) -> None:
        """The cheapest segmentation of the queued window into B runs each
        closed by a P, by summed lowres costs (x264_slicetype_path,
        slicetype.c:395-434, as x264_tpu's _badapt2_decide: the paths in
        its order, the first of the least cost); the first segment is
        encoded."""
        q = self._bqueue
        bh, bw, r = self._la_bh, self._la_bw, self._la_r
        memo: dict = {}

        def est(m: int, a: int, j: int):
            """[B cost of q[m] between the anchors, P cost from a]; a = -1
            is the last reference."""
            if (m, a, j) not in memo:
                al = self._la_ref_lows if a < 0 else q[a].lows
                with self._la_ctx():
                    memo[(m, a, j)] = self._host_ints(lookahead.b_cost(
                        q[m].lows, al, q[j].lows, bh, bw, r))
            return memo[(m, a, j)]

        def paths(n: int):
            """Segment lengths: k Bs then a P, k <= i_bframe."""
            if n == 0:
                yield []
                return
            for k in range(min(n, self._bframes + 1)):
                for rest in paths(n - k - 1):
                    yield [k] + rest

        best_cost = best_path = None
        for path in paths(len(q)):
            cost, anchor, idx = 0, -1, 0
            for k in path:
                jp = idx + k
                for m in range(idx, jp):
                    cost += est(m, anchor, jp)[0]
                cost += est(jp, anchor, jp)[1]
                anchor, idx = jp, jp + 1
            if best_cost is None or cost < best_cost:
                best_cost, best_path = cost, path
        k = best_path[0]
        seg, rest = q[:k + 1], q[k + 1:]
        self._bqueue = seg[:-1]
        self._submit_queued(seg[-1])
        self._submit_bqueue()
        self._bqueue = rest

    def _submit_bqueue(self) -> None:
        """Encode the queued candidates as the B run between the two
        references just queued, in display order (x264_tpu's
        _submit_bqueue): the ME seeds are the candidates' lowres MV fields
        against both references (K21, slicetype.c:153-166) where b-adapt
        has them, else the P's MV field scaled by the distance."""
        q, self._bqueue = self._bqueue, []
        span = len(q) + 1
        main = torch.cuda.current_stream(self.device) \
            if self._la_stream is not None else None
        for i, g in enumerate(q):
            seeds = None
            if (g.lows is not None and self._la_prev_lows is not None
                    and self._la_ref_lows is not None):
                with self._la_ctx():
                    seeds = lookahead.b_seed_mvs(
                        g.lows, self._la_prev_lows, self._la_ref_lows,
                        self._la_bh, self._la_bw, self._la_r)
                if main is not None:
                    main.wait_stream(self._la_stream)
                    for t in seeds:
                        t.record_stream(main)
            self._submit_b(g, i + 1, span, seeds)

    def _flush_bqueue(self) -> None:
        """Close the GOP: the newest queued candidate becomes the P (an
        IDR when there is no reference yet), the earlier ones its B run."""
        if not self._bqueue:
            return
        self._submit_queued(self._bqueue.pop(), is_idr=self._ref is None)
        self._submit_bqueue()

    def _submit_queued(self, q: Queued, is_idr: bool = False) -> None:
        """Queue a waiting frame as a reference (a P, or an IDR, whose POC
        is 0)."""
        self._submit_ip(q.frame, q.planes, is_idr, q.forced_qp,
                        0 if is_idr else q.poc, q.disp, lows=q.lows)

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
                   poc: int, disp: int, lows=None) -> None:
        """Queue one reference frame (IDR or P) in encode order; planes:
        its MB-aligned planes on the device (_pad_input); lows: its lowres
        planes where b-adapt made them, which then become the L1 side of
        the next B run."""
        if self._badapt:
            self._la_prev_lows = self._la_ref_lows
            self._la_ref_lows = lows if lows is not None \
                else self._lowres(planes[0], frame)
        self._submit("IDR" if is_idr else "P", frame, forced_qp, poc, disp,
                     lambda qp: self._submit_idr(frame, planes, qp) if is_idr
                     else self._submit_p(frame, planes, qp))

    def _submit_b(self, q: Queued, d0: int, span: int, seeds) -> None:
        """Queue one B frame in encode order, d0 frames after its L0
        reference in a run spanning span frames (x264_tpu's
        _submit_b_disp)."""
        self._submit("B", q.frame, q.forced_qp, q.poc, q.disp,
                     lambda qp: self._encode_b(q.frame, q.planes, qp, d0,
                                               span, seeds))

    def _submit(self, ftype: str, frame: Frame, forced_qp, poc: int,
                disp: int, encode) -> None:
        """The frame's QP from rate control (or forced_qp), its device
        work through encode(qp), and its copies to the host queued."""
        qp = self.rc.start("I" if ftype == "IDR" else ftype,
                           frame_idx=self.frame_count)
        if forced_qp is not None:
            qp = max(0, min(51, int(forced_qp)))
            self.rc.last_qp = qp
        self.poc = poc
        pend = encode(qp)
        pend.update(frame=frame, qp=qp, disp=disp, ftype=ftype,
                    rc_rceq=self.rc.last_rceq, rc_satd=self.rc.last_satd)
        self.frame_count += 1
        self._start_fetch(pend)
        self._pending.append(pend)

    def _qtab(self, qp: int, qp_c: int) -> dict:
        key = (qp, qp_c)
        if key not in self._qtab_cache:
            qt = intra.make_qtab(qp, qp_c, self.device, self.qt)
            if self._aq is not None:
                qt["aq_stack"] = self._aq_stacks["intra"]
            self._qtab_cache[key] = qt
        return self._qtab_cache[key]

    def _qtab_p(self, qp: int, qp_c: int) -> dict:
        key = (qp, qp_c)
        if key not in self._qtab_p_cache:
            p = self.params
            a = p.analyse
            qt = inter.make_qtab_p(
                qp, qp_c, self.device, self.qt,
                rd_idc=p.i_cabac_init_idc if self._rd else None,
                f_psy_rd=a.f_psy_rd if a.b_psy else 0.0)
            if self._aq is not None:
                qt.update(aq_stack=self._aq_stacks["intra"],
                          aq_stack_p=self._aq_stacks["inter"])
            if self._trellis:
                # the trellis consts of the inter residual (x264_tpu's
                # _qtab_p, core.py:783-816): under AQ the 52-QP stacks,
                # built once, else the frame QP's
                if self._aq is not None:
                    if self._trellis_full is None:
                        self._trellis_full = inter.trellis_stacks(
                            p.i_cabac_init_idc, a.i_chroma_qp_offset,
                            self.device, self.qt)
                    qt.update(self._trellis_full)
                else:
                    qt.update(inter.trellis_consts(
                        qp, qp_c, p.i_cabac_init_idc, self.device, self.qt))
            self._qtab_p_cache[key] = qt
        return self._qtab_p_cache[key]

    def _qtab_b(self, qp: int, qp_c: int) -> dict:
        """A B frame's tables: the P tables at its QP; under AQ with the
        trellis the 52-QP trellis stacks read at the frame QP for every MB
        (x264_tpu's constant row maps, core.py:1303-1310; B frames run
        without AQ)."""
        qt = self._qtab_p(qp, qp_c)
        if self._aq is None or not self._trellis:
            return qt
        key = ("B", qp, qp_c)
        if key not in self._qtab_p_cache:
            rows = torch.full((self.params.mb_height * self.params.mb_width,),
                              qp, dtype=torch.int64, device=self.device)
            self._qtab_p_cache[key] = dict(
                qt, trellis_qp=rows, trellis_qpc=qt["trellis_qpc_of"][rows],
                trellis_tab_b=qt["trellis_tab"][qp].contiguous())
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

    def _slice_header(self, qp: int, slice_type: int,
                      n_ref_l0: int = 1) -> SliceHeader:
        """n_ref_l0: the L0 references this slice uses; where it differs
        from the PPS's count (the first P after an IDR, and every B slice,
        under --ref 2) num_ref_idx_active_override says so
        (x264_slice_header_init, encoder/encoder.c:721-727)."""
        p = self.params
        return SliceHeader(
            slice_type=slice_type, frame_num=self.frame_num,
            idr_pic_id=self.idr_pic_id if slice_type == SLICE_I else -1,
            poc_lsb=self.poc % (1 << self.sps.log2_max_poc_lsb),
            qp=qp, pic_init_qp=self.pps.pic_init_qp,
            disable_deblock=0 if p.b_deblocking_filter else 1,
            alpha_c0_offset=p.i_deblocking_filter_alphac0,
            beta_offset=p.i_deblocking_filter_beta,
            cabac=p.b_cabac, num_ref_idx_l0=n_ref_l0, num_ref_idx_l1=1,
            num_ref_idx_override=(slice_type != SLICE_I
                                  and n_ref_l0 != self.pps.num_ref_idx_l0),
            log2_max_frame_num=self.sps.log2_max_frame_num,
            log2_max_poc_lsb=self.sps.log2_max_poc_lsb)

    def _cabac_header(self, qp: int, slice_type: int, nal_ref_idc: int,
                      n_ref_l0: int = 1) -> bytearray:
        """Slice header bytes + cabac_alignment_one_bit (spec 7.3.4),
        built at submit time while frame_num / POC / idr_pic_id hold this
        frame's values."""
        hdr = BitWriter()
        self._slice_header(qp, slice_type, n_ref_l0).write_rbsp(
            hdr, nal_ref_idc=nal_ref_idc)
        return _aligned(hdr)

    def _band_headers(self, qp: int, slice_type: int, nal_ref_idc: int,
                      n_ref_l0: int = 1) -> list:
        """Each band's slice header (x264_tpu's _band_headers and
        _band_cabac_headers, core.py:905-952): the frame's, but for
        first_mb_in_slice and disable_deblocking_filter_idc 2 (the bands
        filter alone); CABAC: the bytes with the alignment bits, CAVLC:
        the slots of K18 / K19."""
        p = self.params
        band = p.mb_height // self._n_shards
        out = []
        for k in range(self._n_shards):
            sh = self._slice_header(qp, slice_type, n_ref_l0)
            sh.first_mb = k * band * p.mb_width
            sh.disable_deblock = 2 if p.b_deblocking_filter else 1
            hdr = BitWriter()
            sh.write_rbsp(hdr, nal_ref_idc=nal_ref_idc)
            out.append(_aligned(hdr) if self._cabac
                       else edev.header_slots(hdr))
        return out

    def _cavlc_header(self, qp: int, slice_type: int, nal_ref_idc: int,
                      n_ref_l0: int = 1):
        """The slice header as the (value, length) slots K18 / K19 / K25
        write first (entropy/device.py:header_slots), built at submit
        time."""
        hdr = BitWriter()
        self._slice_header(qp, slice_type, n_ref_l0).write_rbsp(
            hdr, nal_ref_idc=nal_ref_idc)
        return edev.header_slots(hdr)

    def _submit_idr(self, frame: Frame, planes, qp: int) -> dict:
        p = self.params
        mb_w, mb_h = p.mb_width, p.mb_height
        y, u, v = planes
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        # an IDR resets frame_num, POC (spec 7.4.3) and the ME seed field
        self.frame_num = 0
        self.poc = 0
        self._prev_mv = None
        pend = dict(nmb=mb_h * mb_w, slice_is_i=True,
                    nal_type=NAL_SLICE_IDR, nal_ref_idc=3)
        if self._bands is not None:
            return self._idr_done(self._submit_idr_rows(frame, planes, qp,
                                                        pend))
        args = (mb_h, mb_w, bool(p.b_deblocking_filter), y, u, v,
                self._qtab(qp, qp_c), int(tables.LAMBDA_TABLE[qp]), qp)
        tail = (2 * p.i_deblocking_filter_alphac0,
                2 * p.i_deblocking_filter_beta, p.analyse.i_chroma_qp_offset)
        kw = dict(crop_w=p.i_width, crop_h=p.i_height,
                  with_metrics=self._with_metrics, aq=self._aq)
        kw["lossless"] = self._lossless
        if self._cabac:
            pend["hdr_bytes"] = self._cabac_header(qp, SLICE_I, 3)
            out = pipeline.encode_i16_idr_cabac(
                *args, *tail, t8=self._t8, i8x8=self._i8x8, **kw,
                i4x4=self._i4x4)
        else:
            hdr = self._cavlc_header(qp, SLICE_I, 3)
            out = pipeline.encode_i16_idr(*args, *hdr, *tail, **kw,
                                          i4x4=self._i4x4)
            if self._delay == 0:
                out = self._cavlc_idr_sync(out, args, hdr, tail, pend)
        pend.update(out=out, recon=self._finish_frame(out, frame))
        return self._idr_done(pend)

    def _cavlc_idr_sync(self, out: dict, args: tuple, hdr: tuple,
                        tail: tuple, pend: dict) -> dict:
        """x264_tpu's synchronous CAVLC IDR at i_frame_parallel 1
        (core.py:1170-1194): where the slice passes the device word
        buffer, re-run the I pipeline without I4x4 and, as x264_tpu calls
        it, without the crop, the metrics and the QP map; where that still
        passes it, code the slice on the host (_write_i_slice) from K1's
        planes without I4x4 at the frame QP, and keep the retry's recon
        and counts. Returns the pipeline output the frame keeps; the host
        coder's NAL goes to pend["payload"]. (x264 instead grows its
        buffer, x264_bitstream_check_buffer.)"""
        cap_bits = pipeline.capacity_words(pend["nmb"]) * 32
        nbits = int(out["host32"][0])
        self.last_idr_branch = "fits"
        if nbits > cap_bits and self._i4x4:
            out = pipeline.encode_i16_idr(*args, *hdr, *tail, 0, 0, False,
                                          lossless=self._lossless,
                                          i4x4=False)
            nbits = int(out["host32"][0])
            self.last_idr_branch = "retry"
        if nbits > cap_bits:
            mb_h, mb_w, _, y, u, v, qtab, lam, qp = args
            planes = intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab, lam,
                                            lossless=self._host_bypass,
                                            i4x4=False)
            pend["payload"] = self._write_i_slice(planes, qp)
            self.last_idr_branch = "host"
        return out

    def _write_i_slice(self, planes: dict, qp: int) -> bytes:
        """Entropy-code one I16x16 slice on the host (x264_tpu's
        _write_i_slice, core.py:1469, CAVLC path): the slice header, then
        entropy/cavlc_vec.py's codes of K1's planes (I16x16 MBs, no
        mb_qp_delta), the stop bit."""
        p = self.params
        bs = BitWriter()
        self._slice_header(qp, SLICE_I).write_rbsp(bs, nal_ref_idc=3)
        keys = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac", "mode16",
                "modec")
        vals, lens = cavlc_vec.i16_slice_codes(
            {k: planes[k].cpu().numpy() for k in keys}, p.mb_width,
            p.mb_height)
        bs.put_codes(vals, lens)
        bs.rbsp_trailing()
        return nal_unit(NAL_SLICE_IDR, 3, bs.pack())

    def _idr_done(self, pend: dict) -> dict:
        """An IDR empties the DPB (spec 8.2.5.1): the reference before it
        is never a B frame's L0; the next IDR takes the next id."""
        self._prev_ref = None
        self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        return pend

    def _submit_p(self, frame: Frame, planes, qp: int) -> dict:
        """One P frame against the DPB (x264_encoder_encode P path):
        subme 1-9, CABAC or CAVLC. With --ref 2, L0 = [_ref, _prev_ref]
        (PicNum-descending) once two references exist; the first P after
        an IDR runs with one, through the slice header's override."""
        p = self.params
        mb_w, mb_h = p.mb_width, p.mb_height
        if self._bands is not None:
            return self._submit_p_rows(frame, planes, qp)
        y, u, v = planes
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        mvp_seed = self._prev_mv if self._prev_mv is not None \
            else torch.zeros((mb_h, mb_w, 2), dtype=torch.int32,
                             device=self.device)
        args = (mb_h, mb_w, self._me_range, bool(p.b_deblocking_filter), y,
                u, v, *self._ref, self._qtab_p(qp, qp_c),
                int(tables.LAMBDA_TABLE[qp]), qp)
        tail = (2 * p.i_deblocking_filter_alphac0,
                2 * p.i_deblocking_filter_beta, p.analyse.i_chroma_qp_offset,
                mvp_seed)
        n_refs = 2 if (p.i_frame_reference >= 2
                       and self._prev_ref is not None) else 1
        kw = dict(crop_w=p.i_width, crop_h=p.i_height,
                  with_metrics=self._with_metrics, decimate=self._decimate,
                  subpel_steps=self._subpel, parts=self._parts,
                  p8x8=self._p8x8, chroma_me=self._chroma_me, rd=self._rd,
                  aq=self._aq, ref2=self._prev_ref if n_refs == 2 else None,
                  lossless=self._lossless, **self._nr_kw())
        pend = dict(nmb=mb_h * mb_w, slice_is_i=False, nal_type=NAL_SLICE,
                    nal_ref_idc=2)
        if self._cabac:
            pend["hdr_bytes"] = self._cabac_header(qp, SLICE_P, 2, n_refs)
            out = pipeline.encode_p_cabac(*args, *tail, t8=self._t8, **kw)
        else:
            out = pipeline.encode_p(
                *args, *self._cavlc_header(qp, SLICE_P, 2, n_refs), *tail,
                **kw)
        self._prev_mv = out["mv"]
        pend.update(out=out, recon=self._finish_frame(out, frame))
        return pend

    def _encode_b(self, frame: Frame, planes, qp: int, d0: int, span: int,
                  seeds) -> dict:
        """One non-reference B frame between _prev_ref (L0) and _ref (L1),
        CABAC or CAVLC, one reference a list (x264_tpu's _submit_b; under
        --ref 2 its header overrides the PPS's L0 count to one): seeds =
        (L0, L1) lowres MV fields,
        or None for the last P's MV field scaled by d0 / span (floor
        division, as x264_tpu's); the colocated maps are _ref's L0 maps,
        all intra after an IDR."""
        p = self.params
        mb_w, mb_h = p.mb_width, p.mb_height
        if self._bands is not None:
            return self._submit_b_rows(frame, planes, qp, d0, span, seeds)
        y, u, v = planes
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        if seeds is not None:
            mvp_seed, mvp_seed_l1 = seeds
        else:
            pmv = self._prev_mv if self._prev_mv is not None \
                else torch.zeros((mb_h, mb_w, 2), dtype=torch.int32,
                                 device=self.device)
            mvp_seed = torch.div(pmv * d0, span, rounding_mode="floor")
            mvp_seed_l1 = torch.div(-(pmv * (span - d0)), span,
                                    rounding_mode="floor")
        if self._ref_maps is not None:
            col_ref4, col_mv4 = self._ref_maps
        else:
            col_ref4 = torch.full((mb_h * 4, mb_w * 4), -1, dtype=torch.int32,
                                  device=self.device)
            col_mv4 = torch.zeros((mb_h * 4, mb_w * 4, 2), dtype=torch.int32,
                                  device=self.device)
        pend = dict(nmb=mb_h * mb_w, slice_is_i=False, nal_type=NAL_SLICE,
                    nal_ref_idc=0)
        args = (mb_h, mb_w, self._me_range, bool(p.b_deblocking_filter), y, u,
                v, self._prev_ref, self._ref, self._qtab_b(qp, qp_c),
                int(tables.LAMBDA_TABLE[qp]), qp)
        tail = (2 * p.i_deblocking_filter_alphac0,
                2 * p.i_deblocking_filter_beta, p.analyse.i_chroma_qp_offset,
                mvp_seed, mvp_seed_l1, col_ref4, col_mv4, p.i_width,
                p.i_height, self._with_metrics)
        if self._cabac:
            pend["hdr_bytes"] = self._cabac_header(qp, SLICE_B, 0)
            out = pipeline.encode_b_cabac(*args, *tail,
                                          subpel_steps=self._subpel,
                                          t8=self._t8)
        else:
            out = pipeline.encode_b(*args, *self._cavlc_header(qp, SLICE_B, 0),
                                    *tail, subpel_steps=self._subpel)
        pend.update(out=out, recon=self._finish_frame(out, frame, False))
        return pend

    def _finish_frame(self, out: dict, frame: Frame,
                      is_ref: bool = True) -> Frame:
        """Update the DPB and crop the recon view (x264_reference_update,
        encoder/encoder.c:1059). A B frame (not a reference) leaves the
        DPB and frame_num alone."""
        if is_ref:
            self._prev_ref = self._ref
            self._ref = (out["recon_y"], out["recon_u"], out["recon_v"])
            self._ref_maps = (out["ref4"], out["mv4"]) if "ref4" in out \
                else None
            self.frame_num = (self.frame_num + 1) \
                % (1 << self.sps.log2_max_frame_num)
        crop = lambda t, a: t[:a.shape[0], :a.shape[1]]
        return Frame(crop(out["recon_y"], frame.y),
                     crop(out["recon_u"], frame.u),
                     crop(out["recon_v"], frame.v))

    # ------------------------------------------------------- the band path
    # MB-row sharding (x264_tpu core.py:905-1121): each band of
    # mb_height / n rows one slice, run by parallel/rows.py on its device;
    # the DPB keeps each reference's recon as per-band planes, and the last
    # P's MV field and 4x4 L0 maps (the B frames' colocated maps) as
    # per-band grids, each on its band's device. x264_tpu's band programs
    # return no maps, so its sharded B frames read all-intra ones where a
    # decoder reads the P frame's (colZeroFlag) and its stream can decode
    # to other pictures than its recons (ROADMAP §3); the port keeps them.
    def _tabs_on(self, qt: dict, dev) -> dict:
        """qt (built on the main device) with its tensors on dev, kept."""
        if dev == self.device:
            return qt
        key = (id(qt), str(dev))
        if key not in self._dev_tabs:
            self._dev_tabs[key] = (qt, {
                k: v.to(dev) if torch.is_tensor(v) else v
                for k, v in qt.items()})
        return self._dev_tabs[key][1]

    def _band_rows(self) -> int:
        return self.params.mb_height // self._n_shards

    def _band_split(self, t, scale: int) -> list:
        """A main-device tensor of the MB grid (scale 1), the 4x4 grid (4)
        or a plane (16 / 8 rows an MB) cut into its bands, each on its
        band's device."""
        return prows.split_rows(t, self._bands, self._band_rows() * scale)

    def _band_src(self, planes) -> list:
        """Each band's (y, u, v) source on its device."""
        return list(zip(*(self._band_split(t, s)
                          for t, s in zip(planes, (16, 8, 8)))))

    def _band_args(self, qt: dict, planes, qp: int) -> tuple:
        """The arguments every band program takes first (parallel/rows.py):
        the bands, their geometry, the deblock switch, each band's source
        and tables (qt's) on its device, lambda, QP and the offsets."""
        p = self.params
        return (self._bands, self._band_rows(), p.mb_width,
                bool(p.b_deblocking_filter), self._band_src(planes),
                [self._tabs_on(qt, d) for d in self._bands],
                int(tables.LAMBDA_TABLE[qp]), qp,
                2 * p.i_deblocking_filter_alphac0,
                2 * p.i_deblocking_filter_beta, p.analyse.i_chroma_qp_offset)

    def _submit_idr_rows(self, frame: Frame, planes, qp: int,
                         pend: dict) -> dict:
        """An IDR frame's bands (x264_tpu's _encode_idr_rows,
        core.py:954): CABAC or CAVLC."""
        p = self.params
        args = self._band_args(self._qtab(qp, tables.chroma_qp(
            qp, p.analyse.i_chroma_qp_offset)), planes, qp)
        hdrs = self._band_headers(qp, SLICE_I, 3)
        if self._cabac:
            res = prows.encode_i_rows_cabac(*args, self._i4x4,
                                            t8_mode=self._t8)
        else:
            res = prows.encode_i_rows(*args, self._i4x4, hdrs)
        return self._rows_pend(pend, res, hdrs, frame, planes, True)

    def _submit_p_rows(self, frame: Frame, planes, qp: int) -> dict:
        """A P frame's bands (x264_tpu's _encode_p_rows, core.py:1016):
        CABAC with one or two references, the 8x8 transform, the RD
        ladder, P8x8 and AQ as the encoder has them; CAVLC (one
        reference, validate() keeps it so) with the partitions alone."""
        p = self.params
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        qt = self._qtab_p(qp, qp_c)
        n_refs = 2 if (p.i_frame_reference >= 2 and self._cabac
                       and self._prev_ref is not None) else 1
        args = (*self._band_args(qt, planes, qp), self._me_range,
                self._subpel, self._ref, self._prev_mv or self._zero_mvs())
        pend = dict(nmb=p.mb_height * p.mb_width, slice_is_i=False,
                    nal_type=NAL_SLICE, nal_ref_idc=2)
        hdrs = self._band_headers(qp, SLICE_P, 2, n_refs)
        if self._cabac:
            res = prows.encode_p_rows_cabac(
                *args, ref2=self._prev_ref if n_refs == 2 else None,
                t8=self._t8, decimate=self._decimate, rd=self._rd,
                p8x8=self._p8x8, aq=self._aq)
        else:
            res = prows.encode_p_rows(*args, hdrs)
        self._prev_mv = [r["mv"] for r in res]
        return self._rows_pend(pend, res, hdrs, frame, planes, True)

    def _submit_b_rows(self, frame: Frame, planes, qp: int, d0: int,
                       span: int, seeds) -> dict:
        """A B frame's bands (x264_tpu's _encode_b_rows, core.py:1072):
        the seeds as _encode_b takes them, per band; each band's colocated
        maps from the L1 P frame's band (all intra after an IDR); under AQ
        the P tables without the trellis (x264_tpu's band B stays on the
        deadzone quant there, core.py:1093-1097)."""
        p = self.params
        qp_c = tables.chroma_qp(qp, p.analyse.i_chroma_qp_offset)
        qt = self._qtab_p(qp, qp_c)
        if self._aq is not None and "trellis_tab" in qt:
            key = ("B rows", qp, qp_c)
            if key not in self._qtab_p_cache:
                self._qtab_p_cache[key] = {
                    k: v for k, v in qt.items() if not k.startswith("trellis")}
            qt = self._qtab_p_cache[key]
        if seeds is not None:
            s0, s1 = (self._band_split(t, 1) for t in seeds)
        else:
            pmv = self._prev_mv or self._zero_mvs()
            s0 = [torch.div(m * d0, span, rounding_mode="floor") for m in pmv]
            s1 = [torch.div(-(m * (span - d0)), span, rounding_mode="floor")
                  for m in pmv]
        col = self._ref_maps or [self._col_maps(d) for d in self._bands]
        res = prows.encode_b_rows_cabac(
            *self._band_args(qt, planes, qp), self._me_range, self._subpel,
            self._prev_ref, self._ref, s0, s1, [c[0] for c in col],
            [c[1] for c in col], t8=self._t8)
        pend = dict(nmb=p.mb_height * p.mb_width, slice_is_i=False,
                    nal_type=NAL_SLICE, nal_ref_idc=0)
        return self._rows_pend(pend, res, self._band_headers(qp, SLICE_B, 0),
                               frame, planes, False)

    def _zero_mvs(self) -> list:
        """Each band's zero MV field (the ME seeds after an IDR)."""
        return [torch.zeros((self._band_rows(), self.params.mb_width, 2),
                            dtype=torch.int32, device=d) for d in self._bands]

    def _col_maps(self, dev):
        """A band's all-intra colocated maps (ref -1, MV 0) on dev."""
        key = str(dev)
        if key not in self._col_intra:
            g = (self._band_rows() * 4, self.params.mb_width * 4)
            self._col_intra[key] = (
                torch.full(g, -1, dtype=torch.int32, device=dev),
                torch.zeros((*g, 2), dtype=torch.int32, device=dev))
        return self._col_intra[key]

    def _rows_pend(self, pend: dict, res: list, hdrs: list, frame: Frame,
                   planes, is_ref: bool) -> dict:
        """The bands' results as one frame: the recon gathered on the main
        device (the EncodedFrame's, and K4's input: row 24), and one int32
        vector for the host, [each band's count (CABAC halfwords or CAVLC
        bits), n_intra, n_skip, ssd_y, ssd_u, ssd_v, ssim]; the DPB keeps
        the per-band recon and L0 maps."""
        p = self.params
        main = self.device
        with prows.on_device(main):
            full = [torch.cat([r["recon"][i].to(main, non_blocking=True)
                               for r in res]) for i in range(3)]
            head = [torch.stack([r["count"].to(main, non_blocking=True)
                                 for r in res]),
                    torch.stack([r["mbs"].to(main, non_blocking=True)
                                 for r in res]).sum(0).to(torch.int32)]
            if self._with_metrics:
                head.append(estats.frame_metrics(
                    *planes, *full, p.i_width, p.i_height).view(torch.int32))
        if is_ref:
            self._prev_ref = self._ref
            self._ref = [r["recon"] for r in res]
            self._ref_maps = [(r["ref4"], r["mv4"]) for r in res] \
                if "ref4" in res[0] else None
            self.frame_num = (self.frame_num + 1) \
                % (1 << self.sps.log2_max_frame_num)
        crop = lambda t, a: t[:a.shape[0], :a.shape[1]]
        pend.update(bands=res, hdrs=hdrs, out=dict(host32=torch.cat(head)),
                    recon=Frame(*(crop(t, a) for t, a in
                                  zip(full, (frame.y, frame.u, frame.v)))))
        return pend

    def _rows_payload(self, pend: dict, h32) -> bytes:
        """The bands' NALs (x264_tpu's _rows_cabac_payload and
        _assemble_band_nals, core.py:1412-1440, 923-935): each band's live
        prefix crosses to the host behind its count; CABAC: the halfwords
        unpacked and coded with fresh contexts, CAVLC: the words taken as
        they are. A band past its buffer raises."""
        nmb = pend["nmb"] // self._n_shards
        nals = []
        for k, (r, hdr) in enumerate(zip(pend["bands"], pend["hdrs"])):
            n = int(h32[k])
            if self._cabac:
                if n > pipeline.cabac_capacity_hw(nmb):
                    raise RuntimeError(
                        f"band {k} CABAC ops overflowed ({n} halfwords)")
                ops = ecabac.unpack_hw(_host_prefix(r["words"], (n + 1) // 2),
                                       n)
                nals.append(self._cabac_payload(dict(pend, hdr_bytes=hdr),
                                                ops))
            else:
                if n > pipeline.capacity_words(nmb) * 32:
                    raise RuntimeError(f"slice {k} overflowed the device "
                                       f"pack buffer ({n})")
                nals.append(nal_unit(pend["nal_type"], pend["nal_ref_idc"],
                                     edev.words_to_bytes(_host_prefix(
                                         r["words"], (n + 31) // 32), n)))
        return b"".join(nals)

    def _nr_kw(self) -> dict:
        """The noise reduction's offsets for this P frame, on the device
        (x264_tpu's _nr_kw, core.py:733-742): the 8x8's with the 8x8
        transform; on the card they cross from pinned memory without
        blocking the host."""
        if not self._nr:
            return {}
        offs = self._nr_off if self._t8 else self._nr_off[:1]
        return {f"nr_offset{n}": self._to_device(o)
                for n, o in zip((4, 8), offs)}

    def _to_device(self, a: np.ndarray):
        """A small int32 array on the device, queued on the current stream
        from pinned memory on the card."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(a, np.int32))
        staged = torch.empty(a.shape, dtype=torch.int32, pin_memory=True)
        staged.numpy()[:] = a
        return staged.to(self.device, non_blocking=True)

    def _nr_update(self, s4, s8, nmb: int) -> None:
        """x264_noise_reduction_update (encoder/macroblock.c:890-911), as
        x264_tpu's _nr_update (core.py:744-762) replays it in float64: add
        the frame's float32 |coef| sums, count nmb * blocks per MB, halve
        both past the cap (2^18 for 4x4, 2^16 for 8x8), and set each
        offset to (nr * count + sum / 2) // (sum * weight2 / 256 + 1),
        clipped to [0, 65535]."""
        for cat, (s, blocks, cap) in enumerate(
                ((s4, 16, 1 << 18), (s8, 4, 1 << 16))):
            if s is None:
                continue
            self._nr_sum[cat] += np.asarray(s, np.float64)
            self._nr_cnt[cat] += nmb * blocks
            if self._nr_cnt[cat] > cap:
                self._nr_sum[cat] *= 0.5
                self._nr_cnt[cat] *= 0.5
            w = self._nr_w[cat]
            off = ((self._nr * self._nr_cnt[cat] + self._nr_sum[cat] / 2)
                   // (self._nr_sum[cat] * w / 256 + 1))
            self._nr_off[cat] = np.clip(off, 0, 65535).astype(np.int32)

    def _start_fetch(self, pend: dict) -> None:
        """Queue the d2h of this frame's op stream (CAVLC: its slice
        words, the whole buffer, since nbits is not known on the host yet),
        host32 vector and, with the noise reduction, its |coef| sums right
        behind its kernels: non-blocking copies into pinned memory and a
        CUDA event that _finalize waits on."""
        out = pend["out"]
        # a band frame's words cross later, each band's live prefix alone;
        # a host-coded IDR's payload is ready
        body = None if "bands" in pend or "payload" in pend \
            else out["ops"] if self._cabac else out["words"]
        nr = [out.get(k) for k in ("nr_sum4", "nr_sum8")]
        if self.device.type == "cpu":
            pend["fetch"] = (None, body, out["host32"], nr)
            return
        ops_h = None
        if body is not None:
            ops_h = torch.empty(body.shape, dtype=torch.int32,
                                pin_memory=True)
            ops_h.copy_(body, non_blocking=True)
        h32_h = torch.empty(out["host32"].shape, dtype=torch.int32,
                            pin_memory=True)
        h32_h.copy_(out["host32"], non_blocking=True)
        nr_h = []
        for t in nr:
            if t is not None:
                h = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t = h
            nr_h.append(t)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        pend["fetch"] = (done, ops_h, h32_h, nr_h)

    def flush(self) -> list:
        """Drain delayed frames (the pic_in=NULL flush loop contract,
        x264.c:870-873); the newest queued B candidate becomes a P."""
        self._flush_bqueue()
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

    def _cavlc_payload(self, pend: dict, words: np.ndarray,
                       nbits: int) -> bytes:
        """The NAL of a device-packed CAVLC slice (x264_slice_write CAVLC
        branch, encoder/encoder.c:1141-1199): the first ceil(nbits / 8)
        bytes of its words. A slice past the word buffer raises, as
        x264_tpu's pipelined path and its P and B slices do; only an IDR
        at i_frame_parallel 1 retries without I4x4 and then takes the host
        coder (_cavlc_idr_sync)."""
        cap_words = pipeline.capacity_words(pend["nmb"])
        if nbits > cap_words * 32:
            raise RuntimeError(
                f"slice overflowed the device pack buffer ({nbits} bits); "
                f"as in x264_tpu, only an IDR at i_frame_parallel 1 retries "
                f"without I4x4 and falls back to the host coder")
        return nal_unit(pend["nal_type"], pend["nal_ref_idc"],
                        edev.words_to_bytes(words[:(nbits + 31) // 32],
                                            nbits))

    def _finalize(self, pend: dict) -> EncodedFrame:
        """Host tail of one frame: wait for its copies, entropy-code (CABAC)
        or take the packed words (CAVLC), RC accounting and stats
        (x264_encoder_frame_end, encoder/encoder.c:1705)."""
        done, body_t, h32_t, nr = pend["fetch"]
        if done is not None:
            done.synchronize()
        h32 = h32_t.numpy()
        ftype, nmb = pend["ftype"], pend["nmb"]
        if self._nr and ftype == "P":
            # the offsets of the P frames submitted after this point
            # (x264_tpu's _finalize, core.py:677-684)
            self._nr_update(*[None if t is None else t.numpy() for t in nr],
                            nmb)
        # h32: the count(s) (one a band), n_intra, n_skip, the metrics
        o = self._n_shards if "bands" in pend else 1
        if "bands" in pend:
            payload = self._rows_payload(pend, h32)
        elif "payload" in pend:
            payload = pend["payload"]
        elif self._cabac:
            ops = body_t.numpy()[:int(h32[0])].view(np.uint32)
            payload = self._cabac_payload(pend, ops)
        else:
            payload = self._cavlc_payload(pend, body_t.numpy(), int(h32[0]))
        bits = len(payload) * 8
        if ftype in ("P", "B"):
            n_intra, n_skip = int(h32[o]), int(h32[o + 1])
            counts = (n_intra, nmb - n_intra - n_skip, n_skip)
        else:
            counts = (nmb, 0, 0)
        self.rc.end("I" if ftype == "IDR" else ftype, bits, pend["qp"],
                    counts, rceq=pend["rc_rceq"], satd=pend["rc_satd"])
        metrics = None
        if self._with_metrics:
            metrics = tuple(float(x)
                            for x in h32[o + 2:o + 6].view(np.float32))
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

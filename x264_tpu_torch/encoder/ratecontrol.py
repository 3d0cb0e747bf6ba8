"""Rate control, constant-QP subset — the analogue of
encoder/ratecontrol.c as x264_tpu/encoder/ratecontrol.py implements it.

This slice ports CQP for I and P frames: the frame QP (x264_ratecontrol_start,
encoder/ratecontrol.c:789, CQP branch), the lowres lookahead and the
scenecut decision (analyse_frame, x264_tpu ratecontrol.py:185-229), the
post-frame accounting (x264_ratecontrol_end:1077-1133) and the 2-pass
stats file write (:1094-1116). CRF / ABR, VBV and 2-pass replay come
with later slices and raise NotImplementedError.
"""

from __future__ import annotations

import os
import time

import torch

from ..params import EncoderParams, RC_CQP
from . import lookahead


class RateControlEntry:
    """One frame of RC state (a stats-file line)."""

    def __init__(self, frame_type: str, tex_bits: int = 0, misc_bits: int = 0,
                 qp: float = 0.0, cplx: float = 0.0, imb: int = 0,
                 pmb: int = 0, smb: int = 0):
        self.frame_type = frame_type
        self.tex_bits = tex_bits
        self.mv_bits = 0
        self.misc_bits = misc_bits
        self.qp = qp
        self.cplx = cplx
        self.imb, self.pmb, self.smb = imb, pmb, smb


class RateControl:
    """x264_ratecontrol_new / start / end, constant QP."""

    def __init__(self, params: EncoderParams):
        if params.rc.i_rc_method != RC_CQP:
            raise NotImplementedError(
                "CRF/ABR rate control (with AQ) comes with a later slice of "
                "the port; use constant QP")
        if params.rc.b_stat_read:
            raise NotImplementedError("2-pass replay comes with a later "
                                      "slice of the port")
        self.p = params
        self.last_qp = params.rc.i_qp_constant
        self.last_rceq = 1.0
        self.last_satd = 0.0
        self.total_bits = 0
        self.frame_count = 0
        self.entries: list[RateControlEntry] = []
        # lowres state for scenecut (the device lookahead), the range from
        # the unclamped i_me_range as x264_tpu takes it
        self._prev_low = None
        self._lowres_range = max(4, min(12, params.analyse.i_me_range // 2))
        # host seconds spent waiting for the lookahead's sums
        self.lookahead_wait_s = 0.0

    def analyse_frame(self, y, h: int, w: int,
                      gop_size: int | None = None) -> dict:
        """Lowres costs and the scenecut decision for the incoming frame
        (x264_tpu RateControl.analyse_frame): the lookahead kernels on the
        luma y (the first h x w samples of an int32 plane on the device),
        on the current stream, then the scenecut rule of
        encoder/slicetype.c:437-474 with its distance-adaptive bias.
        gop_size: frames since the last IDR (None: the largest bias). On
        the card the host reads the two sums through a pinned buffer and
        waits for the current stream only. Returns {'scenecut': bool,
        'icost': float, 'pcost': float}."""
        lows, sums_d = lookahead.analyse(y, h, w, self._prev_low,
                                         self._lowres_range)
        if sums_d.device.type == "cpu":
            isum, psum = (int(x) for x in sums_d)
        else:
            host = torch.empty(2, dtype=torch.int32, pin_memory=True)
            host.copy_(sums_d, non_blocking=True)
            t = time.perf_counter()
            torch.cuda.current_stream(sums_d.device).synchronize()
            self.lookahead_wait_s += time.perf_counter() - t
            isum, psum = (int(x) for x in host.numpy())
        out = {"scenecut": False, "icost": float(isum), "pcost": float(psum)}
        if self._prev_low is not None:
            # bias ramp (scenecut, slicetype.c:445-462)
            t_max = self.p.i_scenecut_threshold / 100.0
            kmin = max(1, self.p.i_keyint_min)
            kmax = max(kmin + 1, self.p.i_keyint_max)
            t_min = t_max * kmin / (kmax * 4.0)
            if gop_size is None or gop_size > kmax:
                bias = t_max
            elif gop_size < kmin / 4:
                bias = t_min / 4
            elif gop_size <= kmin:
                bias = t_min * gop_size / kmin
            else:
                bias = t_min + (t_max - t_min) * (gop_size - kmin) \
                    / (kmax - kmin)
            if isum > 0 and psum >= (1.0 - bias) * isum:
                out["scenecut"] = True
        self._prev_low = lows
        return out

    def start(self, frame_type: str, frame_idx: int | None = None) -> int:
        """The frame QP: i_qp_constant for every I and P frame (the
        reference's CQP with the ip offset kept flat, as x264_tpu keeps
        it, x264_tpu/encoder/ratecontrol.py:252-264)."""
        if frame_type not in ("I", "P"):
            raise NotImplementedError(f"{frame_type} frames come with the "
                                      "B slice of the port")
        qp = max(0, min(51, self.p.rc.i_qp_constant))
        self.last_qp = qp
        return int(qp)

    def end(self, frame_type: str, bits: int, qp: int, mb_counts=None,
            header_bits: int = 0):
        """Post-frame accounting (x264_ratecontrol_end)."""
        self.total_bits += bits
        self.frame_count += 1
        imb, pmb, smb = (int(x) for x in (mb_counts or (0, 0, 0)))
        self.entries.append(RateControlEntry(
            frame_type, tex_bits=bits - header_bits, misc_bits=header_bits,
            qp=qp, cplx=max(self.last_satd, 1.0), imb=imb, pmb=pmb,
            smb=smb))

    def write_stats(self):
        """Atomic stats-file write (x264_ratecontrol_end:1094-1116 line
        format; .temp + rename per x264_ratecontrol_delete:729-758)."""
        if not self.p.rc.b_stat_write:
            return
        path = self.p.rc.psz_stat_out
        tmp = path + ".temp"
        with open(tmp, "w") as f:
            f.write(f"#options: {self.p.to_string()}\n")
            for i, e in enumerate(self.entries):
                f.write(f"in:{i} out:{i} type:{e.frame_type} q:{e.qp:.2f} "
                        f"tex:{e.tex_bits} mv:{e.mv_bits} "
                        f"misc:{e.misc_bits} imb:{e.imb} pmb:{e.pmb} "
                        f"smb:{e.smb} cplx:{e.cplx:.0f};\n")
        os.replace(tmp, path)

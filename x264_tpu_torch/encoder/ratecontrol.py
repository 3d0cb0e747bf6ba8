"""Rate control — the analogue of encoder/ratecontrol.c as
x264_tpu/encoder/ratecontrol.py implements it, for I, P and B frames
(B: the CQP pb offset, the last P qscale times pb_factor under CRF / ABR).

This slice ports constant QP, CRF (constant rate factor) and 1-pass ABR
with overflow compensation, with zones: the qp <-> qscale mapping
(encoder/ratecontrol.c:148-166), the frame-size predictors (:1265-1278),
the rate-factor core of get_qscale / rate_estimate_qscale (:1169-1196,
:1396-1592), the lowres lookahead and the scenecut decision (analyse_frame,
x264_tpu ratecontrol.py:185-229, whose P cost is the frame complexity CRF
and ABR read), the post-frame accounting (x264_ratecontrol_end:1077-1133)
and the 2-pass stats file write (:1094-1116). Every float step is a
Python double in x264_tpu's order, so the frame QPs are the same. VBV
(with its row-RC) and 2-pass replay come with later slices and raise
NotImplementedError.
"""

from __future__ import annotations

import math
import os
import time

import torch

from ..params import EncoderParams, RC_CQP, RC_CRF
from . import lookahead


def qp2qscale(qp: float) -> float:
    """encoder/ratecontrol.c:148-152."""
    return 0.85 * pow(2.0, (qp - 12.0) / 6.0)


def qscale2qp(qscale: float) -> float:
    """encoder/ratecontrol.c:154-158."""
    return 12.0 + 6.0 * math.log2(qscale / 0.85)


class Predictor:
    """bits ~= coeff * satd / qscale, an exponentially decayed least-squares
    fit (encoder/ratecontrol.c:1265-1278)."""

    def __init__(self, coeff: float = 0.75):
        self.coeff = coeff
        self.count = 1.0
        self.decay = 0.5

    def predict(self, qscale: float, satd: float) -> float:
        return self.coeff / self.count * satd / qscale

    def update(self, bits: float, qscale: float, satd: float):
        if satd <= 0 or bits <= 0:
            return
        new_coeff = bits * qscale / satd
        self.count *= self.decay
        self.coeff *= self.decay
        self.count += 1.0
        self.coeff += new_coeff


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
    """x264_ratecontrol_new / start / end: constant QP, CRF or 1-pass
    ABR. One instance per encode."""

    def __init__(self, params: EncoderParams):
        p, rc = params, params.rc
        if rc.i_vbv_max_bitrate > 0 or rc.i_vbv_buffer_size > 0:
            raise NotImplementedError(
                "VBV (with its row rate control) comes with the VBV slice "
                "of the port")
        if rc.b_stat_read:
            raise NotImplementedError("2-pass replay comes with the 2-pass "
                                      "slice of the port")
        self.p = p
        self.method = rc.i_rc_method
        self.fps = p.i_fps_num / max(1, p.i_fps_den)
        self.nmb = p.mb_width * p.mb_height
        self.qcomp = rc.f_qcompress
        self.qp_min, self.qp_max = rc.i_qp_min, rc.i_qp_max
        self.ip_offset = 6.0 * math.log2(rc.f_ip_factor)
        self.bitrate = rc.i_bitrate * 1000.0
        self.last_qp = rc.i_qp_constant
        # ABR / CRF seeds (x264_ratecontrol_new:350-382; ABR_INIT_QP is
        # rf_constant under CRF, 24 otherwise)
        self._abr_init_qp = (rc.f_rf_constant if self.method == RC_CRF
                             else 24.0)
        self.accum_p_norm = 0.01
        self.accum_p_qp = self._abr_init_qp * self.accum_p_norm
        self.cplxr_sum = 0.01 * pow(7.0e5, self.qcomp) * math.sqrt(self.nmb)
        self.wanted_bits_window = max(self.bitrate / self.fps, 1.0)
        self.lstep = pow(2.0, rc.i_qp_step / 6.0)
        self.last_qscale = qp2qscale(self._abr_init_qp)
        self.last_qscale_for = {t: qp2qscale(self._abr_init_qp)
                                for t in ("I", "P", "B")}
        self.last_non_b_type = "P"
        self.last_rceq = 1.0
        # complexity accumulators (rate_estimate_qscale:1443-1450)
        self.short_term_cplxsum = 0.0
        self.short_term_cplxcount = 0.0
        self.total_bits = 0
        self.frame_count = 0      # frames completed (end() calls)
        self._started = 0
        # zones (encoder/ratecontrol.c:601-715): (start, end, kind, value),
        # kind "q" forces the QP, "b" divides the qscale by a factor
        self.zones: list[tuple] = []
        # the CRF rate factor (x264_ratecontrol_new:267, CRF branch)
        base_cplx = self.nmb * (80 if p.i_bframe == 0 else 120)
        self.rate_factor_constant = (pow(base_cplx, 1.0 - self.qcomp)
                                     / qp2qscale(rc.f_rf_constant))
        # cbr_decay (ratecontrol.c:290, 328-329) is 1.0 without VBV
        self.cbr_decay = 1.0
        self.pred = {"I": Predictor(), "P": Predictor(), "B": Predictor()}
        self.last_satd = 0.0
        self.frame_cplx = 0.0
        self.entries: list[RateControlEntry] = []
        # lowres state for complexity and scenecut (the device lookahead),
        # the range from the unclamped i_me_range as x264_tpu takes it
        self._prev_low = None
        self._lowres_range = max(4, min(12, p.analyse.i_me_range // 2))
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
        self.frame_cplx = max(out["pcost"], 1.0)
        return out

    def _get_zone(self, frame_idx: int):
        """The last zone that covers frame_idx (get_zone,
        ratecontrol.c:741-752)."""
        hit = None
        for z in self.zones:
            if z[0] <= frame_idx <= z[1]:
                hit = z
        return hit

    def start(self, frame_type: str, satd: float | None = None,
              frame_idx: int | None = None) -> int:
        """The frame QP (x264_ratecontrol_start:789 and
        rate_estimate_qscale:1396). frame_type "I", "P" or "B"; satd: the
        frame's complexity (default: the lookahead's last P cost)."""
        if frame_idx is None:
            frame_idx = self._started
        self._started += 1
        if satd is None:
            satd = self.frame_cplx
        self.last_satd = max(satd, 1.0)
        zone = self._get_zone(frame_idx)

        if self.method == RC_CQP:
            # one QP for I and P (x264_tpu keeps the ip offset flat at CQP);
            # B frames take the pb_factor offset (qp_constant[SLICE_TYPE_B],
            # ratecontrol.c:357-360)
            qp = self.p.rc.i_qp_constant
            if frame_type == "B":
                qp += round(6.0 * math.log2(abs(self.p.rc.f_pb_factor)))
            if zone is not None and zone[2] == "q":
                qp = max(0, min(51, int(zone[3])))
            qp = max(0, min(51, qp))
            self.last_qp = qp
            return int(qp)

        if frame_type == "B":
            # B frames ride the last P qscale times pb_factor
            # (rate_estimate_qscale B branch, ratecontrol.c:1419-1452)
            q = self.last_qscale_for["P"] * abs(self.p.rc.f_pb_factor)
            q = max(qp2qscale(self.qp_min), min(qp2qscale(self.qp_max), q))
            self.last_qscale_for["B"] = q
            qp = int(round(qscale2qp(q)))
            qp = max(self.qp_min, min(self.qp_max, qp))
            self.last_qp = qp
            return qp

        # blurred complexity (rate_estimate_qscale:1443-1450)
        self.short_term_cplxsum *= 0.5
        self.short_term_cplxcount *= 0.5
        self.short_term_cplxsum += self.last_satd
        self.short_term_cplxcount += 1.0
        blurred = self.short_term_cplxsum / self.short_term_cplxcount
        self.last_rceq = pow(blurred, 1.0 - self.qcomp)

        overflow = 1.0
        if self.method == RC_CRF:
            q = self.last_rceq / self.rate_factor_constant
        else:  # 1-pass ABR (rate_estimate_qscale:1528-1572)
            q = self.last_rceq / (self.wanted_bits_window / self.cplxr_sum)
            wanted = self.frame_count * self.bitrate / self.fps
            if wanted > 0:
                abr_buffer = 2.0 * self.p.rc.f_rate_tolerance \
                    * self.bitrate \
                    * max(1.0, math.sqrt(self.frame_count / 25.0))
                overflow = min(2.0, max(0.5, 1.0 + (self.total_bits
                                                    - wanted) / abr_buffer))
                q *= overflow

        # bitrate-factor zone (get_qscale, ratecontrol.c:1186-1194)
        if zone is not None and zone[2] == "b":
            q /= float(zone[3])

        if frame_type == "I" and self.p.i_keyint_max > 1 \
                and self.last_non_b_type != "I":
            # I frames track the decayed average P QP / ip_factor
            # (rate_estimate_qscale:1574-1578)
            q = qp2qscale(self.accum_p_qp / self.accum_p_norm)
            q /= abs(self.p.rc.f_ip_factor)
        elif self.frame_count > 0:
            # asymmetric clip against the last qscale of the same type
            # (:1580-1592)
            lmin_t = self.last_qscale_for[frame_type] / self.lstep
            lmax_t = self.last_qscale_for[frame_type] * self.lstep
            if overflow > 1.1 and self.frame_count > 3:
                lmax_t *= self.lstep
            elif overflow < 0.9:
                lmin_t /= self.lstep
            q = max(lmin_t, min(lmax_t, q))
        elif self.method == RC_CRF:
            q = qp2qscale(self._abr_init_qp) / abs(self.p.rc.f_ip_factor)

        # q= zones force the QP outright (zone->b_force_qp)
        if zone is not None and zone[2] == "q":
            q = qp2qscale(float(zone[3]))

        q = max(qp2qscale(self.qp_min), min(qp2qscale(self.qp_max), q))
        self.last_qscale_for[frame_type] = self.last_qscale = q
        if self.frame_count == 0:
            self.last_qscale_for["P"] = q
        qp = int(round(qscale2qp(q)))
        qp = max(self.qp_min, min(self.qp_max, qp))
        self.last_qp = qp
        return qp

    def _accum_p_update(self, qp: float, frame_type: str):
        """accum_p_qp_update (ratecontrol.c:776-786): the decayed average
        of P-equivalent QPs, the I-frame quant base."""
        self.accum_p_qp *= 0.95
        self.accum_p_norm *= 0.95
        self.accum_p_norm += 1.0
        self.accum_p_qp += qp + (self.ip_offset if frame_type == "I"
                                 else 0.0)

    def end(self, frame_type: str, bits: int, qp: int, mb_counts=None,
            header_bits: int = 0, rceq: float | None = None,
            satd: float | None = None):
        """Post-frame accounting (x264_ratecontrol_end:1077-1133):
        cplxr_sum accumulates bits * qscale / rceq and wanted_bits_window
        the per-frame target (cbr_decay 1.0 without VBV). rceq / satd: the
        values of this frame's start(), which the frame pipeline may have
        overwritten since."""
        self.total_bits += bits
        qscale = qp2qscale(qp)
        if rceq is None:
            rceq = self.last_rceq
        if satd is None:
            satd = self.last_satd
        if self.method != RC_CQP:
            div = max(rceq, 1e-9)
            if frame_type == "B":
                div *= abs(self.p.rc.f_pb_factor)
            self.cplxr_sum += bits * qscale / div
            self.cplxr_sum *= self.cbr_decay
            self.wanted_bits_window += self.bitrate / self.fps
            self.wanted_bits_window *= self.cbr_decay
            if frame_type != "B":
                self._accum_p_update(qp, frame_type)
        if frame_type != "B":
            self.last_non_b_type = frame_type
        self.frame_count += 1
        self.pred[frame_type if frame_type in self.pred else "P"].update(
            bits, qscale, satd)
        imb, pmb, smb = (int(x) for x in (mb_counts or (0, 0, 0)))
        self.entries.append(RateControlEntry(
            frame_type, tex_bits=bits - header_bits, misc_bits=header_bits,
            qp=qp, cplx=satd, imb=imb, pmb=pmb, smb=smb))

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

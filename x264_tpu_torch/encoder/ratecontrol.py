"""Rate control, constant-QP subset — the analogue of
encoder/ratecontrol.c as x264_tpu/encoder/ratecontrol.py implements it.

This slice ports CQP for I and P frames: the frame QP (x264_ratecontrol_start,
encoder/ratecontrol.c:789, CQP branch), the post-frame accounting
(x264_ratecontrol_end:1077-1133) and the 2-pass stats file write
(:1094-1116). CRF / ABR, VBV, scenecut analysis and 2-pass replay come
with later slices and raise NotImplementedError.
"""

from __future__ import annotations

import os

from ..params import EncoderParams, RC_CQP


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

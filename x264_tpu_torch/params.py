"""Encoder parameters — the analogue of x264_param_t (x264.h:152-295) with
the validation/clamping rules of x264_validate_parameters
(encoder/encoder.c:335-606) and the string option parser of
x264_param_parse (common/common.c).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# analyse.inter partition flags (x264.h X264_ANALYSE_*)
ANALYSE_I4x4 = 0x0001
ANALYSE_I8x8 = 0x0002
ANALYSE_PSUB16x16 = 0x0010
ANALYSE_PSUB8x8 = 0x0020
ANALYSE_BSUB16x16 = 0x0100

# ME methods (X264_ME_*)
ME_DIA, ME_HEX, ME_UMH, ME_ESA, ME_TESA = 0, 1, 2, 3, 4
ME_NAMES = ["dia", "hex", "umh", "esa", "tesa"]

# direct MV prediction modes
DIRECT_NONE, DIRECT_SPATIAL, DIRECT_TEMPORAL, DIRECT_AUTO = 0, 1, 2, 3

# rate-control methods (X264_RC_*)
RC_CQP, RC_CRF, RC_ABR = 0, 1, 2

# AQ
AQ_NONE, AQ_VARIANCE = 0, 1

# b-adapt
B_ADAPT_NONE, B_ADAPT_FAST, B_ADAPT_TRELLIS = 0, 1, 2

# slice types
TYPE_AUTO, TYPE_IDR, TYPE_I, TYPE_P, TYPE_BREF, TYPE_B = 0, 1, 2, 3, 4, 5

PROFILE_BASELINE, PROFILE_MAIN, PROFILE_HIGH = 66, 77, 100
PROFILE_HIGH444 = 144     # lossless transform bypass lives here


@dataclass
class AnalyseParams:
    """x264.h:232-262 (analyse struct); defaults common/common.c:110-144."""
    intra: int = ANALYSE_I4x4 | ANALYSE_I8x8
    inter: int = ANALYSE_I4x4 | ANALYSE_I8x8 | ANALYSE_PSUB16x16 | ANALYSE_BSUB16x16
    b_transform_8x8: bool = True
    b_weighted_bipred: bool = True
    i_direct_mv_pred: int = DIRECT_SPATIAL
    i_chroma_qp_offset: int = 0
    i_me_method: int = ME_HEX
    i_me_range: int = 16
    i_mv_range: int = -1           # auto from level
    i_mv_range_thread: int = -1    # auto
    i_subpel_refine: int = 6       # subme: 1-9
    b_chroma_me: bool = True
    b_mixed_references: bool = False
    i_trellis: int = 0
    b_fast_pskip: bool = True
    b_dct_decimate: bool = True
    i_noise_reduction: int = 0
    f_psy_rd: float = 1.0
    f_psy_trellis: float = 0.0
    b_psy: bool = True
    i_luma_deadzone: tuple = (21, 11)   # {inter, intra}
    b_psnr: bool = True
    b_ssim: bool = True


@dataclass
class RCParams:
    """x264.h:264-292 (rc struct); defaults common/common.c:84-109."""
    i_rc_method: int = RC_CRF
    i_qp_constant: int = 26
    i_qp_min: int = 10
    i_qp_max: int = 51
    i_qp_step: int = 4
    i_bitrate: int = 0
    f_rf_constant: float = 23.0
    f_rate_tolerance: float = 1.0
    i_vbv_max_bitrate: int = 0
    i_vbv_buffer_size: int = 0
    f_vbv_buffer_init: float = 0.9
    f_ip_factor: float = 1.4
    f_pb_factor: float = 1.3
    i_aq_mode: int = AQ_VARIANCE
    f_aq_strength: float = 1.0
    b_stat_write: bool = False
    psz_stat_out: str = "x264_tpu_2pass.log"
    b_stat_read: bool = False
    psz_stat_in: str = "x264_tpu_2pass.log"
    f_qcompress: float = 0.6
    f_qblur: float = 0.5
    f_complexity_blur: float = 20.0


@dataclass
class EncoderParams:
    """Top-level parameters (x264_param_t, x264.h:152-295)."""
    # stream geometry
    i_width: int = 0
    i_height: int = 0
    i_csp: str = "i420"
    # frame-type decision
    i_keyint_max: int = 250
    i_keyint_min: int = 25
    i_scenecut_threshold: int = 40
    i_bframe: int = 0
    i_bframe_adaptive: int = B_ADAPT_FAST
    i_bframe_bias: int = 0
    b_bframe_pyramid: bool = False
    i_frame_reference: int = 1
    i_dpb_size: int = 1
    # features
    b_cabac: bool = True
    i_cabac_init_idc: int = 0
    b_deblocking_filter: bool = True
    i_deblocking_filter_alphac0: int = 0
    i_deblocking_filter_beta: int = 0
    b_interlaced: bool = False
    # quality
    i_level_idc: int = -1         # auto
    analyse: AnalyseParams = field(default_factory=AnalyseParams)
    rc: RCParams = field(default_factory=RCParams)
    # timing
    i_fps_num: int = 25
    i_fps_den: int = 1
    # parallelism (TPU): number of chips to shard MB rows across, and
    # frames in flight (the analogue of i_threads frame pipelining)
    i_mb_row_shards: int = 1
    i_frame_parallel: int = 1
    # internal: extra bottom MB rows so mb_height divides the shard
    # count (set by Encoder from the actual device count; the rows are
    # edge-replicated content hidden by the SPS crop window)
    i_mb_height_pad: int = 0
    b_deterministic: bool = True
    # custom quantization matrices (x264_param_t i_cqm_preset /
    # psz_cqm_file / cqm_* fields; common/set.c:244 parser)
    i_cqm_preset: int = 0         # cqm.CQM_FLAT
    psz_cqm_file: str = ""
    cqm: dict = field(default_factory=dict)  # raster-order lists
    # VUI (x264_param_t vui struct, x264.h:186-199)
    vui_sar_width: int = 0
    vui_sar_height: int = 0
    vui_i_vidformat: int = 5      # undefined
    vui_b_fullrange: bool = False
    vui_i_colorprim: int = 2      # undefined
    vui_i_transfer: int = 2
    vui_i_colmatrix: int = 2
    vui_i_chroma_loc: int = 0
    # logging
    i_log_level: int = 2

    # ------------------------------------------------------------------
    def validate(self) -> "EncoderParams":
        """Clamp/fix parameters (x264_validate_parameters,
        encoder/encoder.c:335-606). Returns self (mutated)."""
        if self.i_width <= 0 or self.i_height <= 0:
            raise ValueError(f"invalid size {self.i_width}x{self.i_height}")
        if self.i_width % 2 or self.i_height % 2:
            raise ValueError("width/height must be even for i420")

        self.i_cabac_init_idc = _clip(self.i_cabac_init_idc, 0, 2)

        # custom quantization matrices (x264_cqm_parse_file,
        # common/set.c:244)
        self.i_cqm_preset = _clip(self.i_cqm_preset, 0, 2)
        if self.psz_cqm_file:
            from . import cqm as xcqm
            with open(self.psz_cqm_file) as fh:
                self.cqm = xcqm.parse_jm_file(fh.read())
            self.i_cqm_preset = xcqm.CQM_CUSTOM

        rc = self.rc
        rc.i_qp_constant = _clip(rc.i_qp_constant, 0, 51)
        rc.i_qp_min = min(rc.i_qp_min, rc.i_qp_constant)
        rc.i_qp_max = _clip(rc.i_qp_max, rc.i_qp_min, 51)
        if rc.i_rc_method == RC_ABR and rc.i_bitrate <= 0:
            raise ValueError("ABR rate control requires a bitrate")
        if rc.i_vbv_max_bitrate > 0 and rc.i_vbv_buffer_size <= 0:
            rc.i_vbv_buffer_size = rc.i_vbv_max_bitrate
        rc.i_aq_mode = _clip(rc.i_aq_mode, 0, 1)
        if (rc.i_aq_mode != AQ_NONE and self.i_mb_row_shards > 1
                and not self.b_cabac):
            # the sharded CAVLC packer has no dqp/AQ plumbing (the
            # CABAC band path composes with AQ — bands are slices, so
            # each gets its own dqp forward-fill origin)
            self._log("AQ not in the sharded CAVLC path, disabling")
            rc.i_aq_mode = AQ_NONE
        if rc.i_rc_method == RC_CQP:
            rc.i_aq_mode = AQ_NONE
            if rc.i_qp_constant == 0:
                # lossless: transform bypass (encoder/encoder.c:392-406)
                self.analyse.b_transform_8x8 = False
                self.analyse.i_trellis = 0
                if self.i_bframe > 0:
                    self._log("lossless with B-frames not yet supported; "
                              "using --bframes 0")
                    self.i_bframe = 0
                if self.i_mb_row_shards > 1:
                    self._log("lossless with MB-row sharding not yet "
                              "supported; encoding unsharded")
                    self.i_mb_row_shards = 1

        a = self.analyse
        if a.b_transform_8x8 and not self.b_cabac:
            # the 8x8 path emits CABAC cat-5 residual ops; the CAVLC
            # interleave (x264_zigzag_interleave) is not built yet
            self._log("8x8 transform requires CABAC here, disabling")
            a.b_transform_8x8 = False
        if a.intra & ANALYSE_I8x8 and not (
                self.b_cabac and a.b_transform_8x8
                and self.i_mb_row_shards <= 1):
            # I8x8 rides the CABAC cat-5 residual path; the sharded
            # I-band kernel doesn't take the slope-2 wavefront yet
            self._log("I8x8 needs CABAC + 8x8 transform, unsharded; "
                      "disabling", once="i8x8")
            a.intra &= ~ANALYSE_I8x8
        # P/B-slice intra stays I16x16-only (encoder/inter.py intra
        # demotion path) — I8x8 applies to I slices
        a.inter &= ~ANALYSE_I8x8
        if a.inter & ANALYSE_PSUB8x8:
            self._log("sub-8x8 partitions (p4x4/p8x4/4x8) not built; "
                      "using 8x8 sub-blocks only", once="psub8")
            a.inter &= ~ANALYSE_PSUB8x8
        a.i_me_method = _clip(a.i_me_method, ME_DIA, ME_TESA)
        a.i_subpel_refine = _clip(a.i_subpel_refine, 1, 9)
        if a.i_subpel_refine < 6 and a.f_psy_rd > 0:
            # psy-RD needs the RD ladder's true-distortion comparison
            # (x264_validate_parameters: subme<6 zeroes psy)
            a.f_psy_rd = 0.0
        if not a.b_psy:
            a.f_psy_rd = a.f_psy_trellis = 0.0
        a.i_me_range = _clip(a.i_me_range, 4, 64)
        if a.i_mv_range <= 0:
            a.i_mv_range = 512  # level 4+ default; level logic narrows this
        a.i_trellis = _clip(a.i_trellis, 0, 2)
        if a.i_trellis and not self.b_cabac:
            # trellis optimizes the CABAC bit cost model; CAVLC gets
            # the deadzone quant (x264_validate_parameters semantics)
            self._log("trellis requires CABAC, disabling")
            a.i_trellis = 0

        # knobs with no TPU counterpart: every one either acts, is
        # clamped, or logs that it does nothing (the validate-and-log
        # contract of x264_validate_parameters)
        if self.b_interlaced:
            self._log("interlaced coding not supported; using "
                      "progressive", once="interlaced")
            self.b_interlaced = False
        # noise reduction (x264_denoise_dct): clamp as the reference
        a.i_noise_reduction = _clip(a.i_noise_reduction, 0, 1 << 16)
        if a.b_mixed_references:
            self._log("mixed references not implemented (one ref per "
                      "MB); ignoring", once="mixedref")
            a.b_mixed_references = False
        if not a.b_fast_pskip:
            # the batched pipeline always derives P_SKIP exactly after
            # full analysis — there is no early-skip shortcut to turn
            # off, so no-fast-pskip is already the behavior
            self._log("fast_pskip has no effect (skip is derived "
                      "exactly in the batched path)", once="pskip")
        if (a.b_chroma_me and a.i_subpel_refine >= 5
                and self.i_mb_row_shards > 1):
            self._log("chroma ME not in the sharded path; sub-pel "
                      "search scores luma only there", once="chromame")
        if not self.b_deterministic:
            self._log("encoding is always deterministic on this "
                      "backend; ignoring --non-deterministic",
                      once="determ")
            self.b_deterministic = True

        self.i_frame_reference = _clip(self.i_frame_reference, 1, 16)
        self.i_dpb_size = max(self.i_dpb_size, self.i_frame_reference)
        if self.i_frame_reference > 2:
            # 2 L0 references supported (per-MB ref choice + ref_idx
            # syntax); deeper DPBs not yet
            # (x264_validate_parameters clamp contract, encoder.c:335)
            self._log("using --ref 2 (deeper reference lists not yet "
                      "implemented)")
            self.i_frame_reference = 2
        if (self.i_frame_reference > 1 and self.i_mb_row_shards > 1
                and not self.b_cabac):
            self._log("multi-ref in the sharded CAVLC path not yet "
                      "supported; using --ref 1")
            self.i_frame_reference = 1

        self.i_bframe = _clip(self.i_bframe, 0, 16)
        if self.i_bframe > 3:
            # current B support: runs of up to 3 non-reference Bs
            # between references (no B-pyramid)
            self._log("using --bframes 3 (longer runs need B-pyramid)")
            self.i_bframe = 3
        if (self.i_bframe > 0 and self.i_mb_row_shards > 1
                and not self.b_cabac):
            self._log("B-frames in the sharded CAVLC path not "
                      "supported; using --bframes 0")
            self.i_bframe = 0
        if self.i_bframe == 0:
            self.b_bframe_pyramid = False
        self.i_keyint_max = max(self.i_keyint_max, 1)
        self.i_keyint_min = _clip(self.i_keyint_min, 1, self.i_keyint_max // 2 + 1)
        self.i_mb_row_shards = max(1, self.i_mb_row_shards)
        self.i_frame_parallel = max(1, self.i_frame_parallel)
        # the shard pad is derived (Encoder init, from the device
        # count); re-validation recomputes it from scratch
        self.i_mb_height_pad = 0
        if a.i_me_method != ME_ESA and a.i_me_method != ME_TESA:
            # the TPU pipeline always runs the dense (ESA-endpoint)
            # search: pattern walks (dia/hex/umh) are latency-bound
            # scalar control flow with no TPU win; log so --me is not
            # silently dead (validate-and-log contract)
            self._log(f"me method '{ME_NAMES[a.i_me_method]}' maps to the "
                      "dense TPU search (esa-equivalent)", once="me")
        return self

    _logged_once: set = None

    def _log(self, msg: str, once: str | None = None):
        if self.i_log_level >= 2:
            if once is not None:
                if EncoderParams._logged_once is None:
                    EncoderParams._logged_once = set()
                if once in EncoderParams._logged_once:
                    return
                EncoderParams._logged_once.add(once)
            from . import log as xlog
            xlog.log(xlog.LOG_INFO, msg)

    # ------------------------------------------------------------------
    @property
    def mb_width(self) -> int:
        return (self.i_width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.i_height + 15) // 16 + self.i_mb_height_pad

    def profile(self) -> int:
        """Minimum profile for the enabled feature set
        (x264_sps_init logic, encoder/set.c:77-110)."""
        if self.rc.i_rc_method == RC_CQP and self.rc.i_qp_constant == 0:
            return PROFILE_HIGH444    # qpprime_y_zero_transform_bypass
        if self.analyse.b_transform_8x8 or self.i_cqm_preset != 0:
            return PROFILE_HIGH
        if self.b_cabac or self.i_bframe > 0:
            return PROFILE_MAIN
        return PROFILE_BASELINE

    # ------------------------------------------------------------------
    _OPT_ALIASES = {
        "qp": ("rc.i_qp_constant", int),
        "crf": ("rc.f_rf_constant", float),
        "bitrate": ("rc.i_bitrate", int),
        "keyint": ("i_keyint_max", int),
        "min-keyint": ("i_keyint_min", int),
        "bframes": ("i_bframe", int),
        "b-adapt": ("i_bframe_adaptive", int),
        "ref": ("i_frame_reference", int),
        "cabac": ("b_cabac", lambda v: bool(int(v))),
        "deblock": ("b_deblocking_filter", lambda v: bool(int(v))),
        "subme": ("analyse.i_subpel_refine", int),
        "me": ("analyse.i_me_method", lambda v: ME_NAMES.index(v)),
        "merange": ("analyse.i_me_range", int),
        "trellis": ("analyse.i_trellis", int),
        "8x8dct": ("analyse.b_transform_8x8", lambda v: bool(int(v))),
        "aq-mode": ("rc.i_aq_mode", int),
        "aq-strength": ("rc.f_aq_strength", float),
        "fps": ("i_fps_num", int),
        "psy-rd": ("analyse.f_psy_rd", float),
        "b-bias": ("i_bframe_bias", int),
        "dct-decimate": ("analyse.b_dct_decimate",
                         lambda v: bool(int(v))),
        "fast-pskip": ("analyse.b_fast_pskip", lambda v: bool(int(v))),
        "cqm": ("i_cqm_preset",
                lambda v: {"flat": 0, "jvt": 1}[v]),
        "cqmfile": ("psz_cqm_file", str),
        "psnr": ("analyse.b_psnr", lambda v: bool(int(v))),
        "ssim": ("analyse.b_ssim", lambda v: bool(int(v))),
        "ipratio": ("rc.f_ip_factor", float),
        "pbratio": ("rc.f_pb_factor", float),
        "chroma-qp-offset": ("analyse.i_chroma_qp_offset", int),
        "qpmin": ("rc.i_qp_min", int),
        "qpmax": ("rc.i_qp_max", int),
        "qpstep": ("rc.i_qp_step", int),
        "ratetol": ("rc.f_rate_tolerance", float),
        "qcomp": ("rc.f_qcompress", float),
        "vbv-maxrate": ("rc.i_vbv_max_bitrate", int),
        "vbv-bufsize": ("rc.i_vbv_buffer_size", int),
        "vbv-init": ("rc.f_vbv_buffer_init", float),
        "level": ("i_level_idc", int),
        "scenecut": ("i_scenecut_threshold", int),
        "nr": ("analyse.i_noise_reduction", int),
        "interlaced": ("b_interlaced", lambda v: bool(int(v))),
        "fullrange": ("vui_b_fullrange", lambda v: v in ("1", "on")),
        "videoformat": ("vui_i_vidformat", int),
        "colorprim": ("vui_i_colorprim", int),
        "transfer": ("vui_i_transfer", int),
        "colormatrix": ("vui_i_colmatrix", int),
        "chromaloc": ("vui_i_chroma_loc", int),
    }

    def parse(self, name: str, value: str) -> "EncoderParams":
        """String option parsing (x264_param_parse, common/common.c)."""
        if name not in self._OPT_ALIASES:
            raise KeyError(f"unknown option: {name}")
        path, conv = self._OPT_ALIASES[name]
        obj = self
        parts = path.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], conv(value))
        if name == "qp":
            self.rc.i_rc_method = RC_CQP
        if name == "bitrate":
            self.rc.i_rc_method = RC_ABR
        return self

    def to_string(self) -> str:
        """Option serialization (x264_param2string) for the SEI / stats
        header."""
        a, rc = self.analyse, self.rc
        return (f"cabac={int(self.b_cabac)} ref={self.i_frame_reference} "
                f"deblock={int(self.b_deblocking_filter)} "
                f"me={ME_NAMES[a.i_me_method]} subme={a.i_subpel_refine} "
                f"psy_rd={a.f_psy_rd:g} "
                f"8x8dct={int(a.b_transform_8x8)} trellis={a.i_trellis} "
                f"decimate={int(a.b_dct_decimate)} "
                f"nr={a.i_noise_reduction} cqm={self.i_cqm_preset} "
                f"bframes={self.i_bframe} b_adapt={self.i_bframe_adaptive} "
                f"keyint={self.i_keyint_max} "
                f"rc={['cqp','crf','abr'][rc.i_rc_method]} "
                f"qp={rc.i_qp_constant} aq={rc.i_aq_mode}:{rc.f_aq_strength}")


def _clip(x, lo, hi):
    return max(lo, min(hi, x))


def preset_defaults() -> EncoderParams:
    """The reference's built-in defaults (common/common.c:39-144) — the
    'preset medium equivalent' named in BASELINE.md."""
    return EncoderParams()

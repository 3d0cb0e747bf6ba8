"""SPS / PPS / slice-header generation (encoder/set.c:77-470,
encoder/encoder.c:84-300) and the H.264 level table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .entropy.bitstream import (BitWriter, nal_unit, NAL_SPS, NAL_PPS,
                                NAL_SEI, NAL_SLICE_IDR, NAL_SLICE)
from .params import EncoderParams, PROFILE_BASELINE, PROFILE_MAIN, PROFILE_HIGH

SLICE_P, SLICE_B, SLICE_I = 0, 1, 2


# H.264 level table (encoder/set.c:507-526): level_idc, mbps, frame_size(MBs),
# dpb(bytes), bitrate(kbit), cpb(kbit), mv_range, min_comp_ratio, frame_only
LEVELS = [
    (10, 1485, 99, 152064, 64, 175, 64, 2, 1),
    (11, 3000, 396, 345600, 192, 500, 128, 2, 1),
    (12, 6000, 396, 912384, 384, 1000, 128, 2, 1),
    (13, 11880, 396, 912384, 768, 2000, 128, 2, 1),
    (20, 11880, 396, 912384, 2000, 2000, 128, 2, 1),
    (21, 19800, 792, 1824768, 4000, 4000, 256, 2, 0),
    (22, 20250, 1620, 3110400, 4000, 4000, 256, 2, 0),
    (30, 40500, 1620, 3110400, 10000, 10000, 256, 2, 0),
    (31, 108000, 3600, 6912000, 14000, 14000, 512, 4, 0),
    (32, 216000, 5120, 7864320, 20000, 20000, 512, 4, 0),
    (40, 245760, 8192, 12582912, 20000, 25000, 512, 4, 0),
    (41, 245760, 8192, 12582912, 50000, 62500, 512, 2, 0),
    (42, 522240, 8704, 13369344, 50000, 62500, 512, 2, 0),
    (50, 589824, 22080, 42393600, 135000, 135000, 512, 2, 0),
    (51, 983040, 36864, 70778880, 240000, 240000, 512, 2, 0),
]


def auto_level(params: EncoderParams) -> int:
    """Pick the smallest level whose frame-size/mbps limits fit
    (x264_validate_levels spirit, encoder/set.c:535)."""
    mbs = params.mb_width * params.mb_height
    mbps = mbs * params.i_fps_num // max(1, params.i_fps_den)
    dpb = mbs * 384 * max(1, params.i_frame_reference)
    for (lev, l_mbps, l_fs, l_dpb, *_rest) in LEVELS:
        if mbs <= l_fs and mbps <= l_mbps and dpb <= l_dpb:
            return lev
    return 51


@dataclass
class SPS:
    """Sequence parameter set (x264_sps_t, common/set.h; init logic of
    x264_sps_init, encoder/set.c:77)."""
    profile_idc: int = PROFILE_HIGH
    level_idc: int = 30
    sps_id: int = 0
    log2_max_frame_num: int = 9   # i_keyint driven in reference; 9 is safe
    poc_type: int = 0
    log2_max_poc_lsb: int = 10
    num_ref_frames: int = 1
    mb_width: int = 0
    mb_height: int = 0
    crop_right: int = 0
    crop_bottom: int = 0
    qpprime_y_zero_transform_bypass: bool = False
    direct8x8_inference: bool = True
    fps_num: int = 0          # VUI timing (0 = no VUI)
    fps_den: int = 1
    # VUI (x264_sps_init vui section, encoder/set.c:146-212)
    sar_width: int = 0        # 0 = unspecified (no aspect_ratio_info)
    sar_height: int = 0
    vidformat: int = 5        # unspecified
    fullrange: bool = False
    colorprim: int = 2        # unspecified
    transfer: int = 2
    colmatrix: int = 2
    chroma_loc: int = 0
    num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 1
    mv_range: int = 512

    @classmethod
    def from_params(cls, p: EncoderParams) -> "SPS":
        level = p.i_level_idc if p.i_level_idc > 0 else auto_level(p)
        return cls(
            profile_idc=p.profile(),
            level_idc=level,
            num_ref_frames=max(p.i_frame_reference,
                               1 + (1 if p.i_bframe else 0)),
            mb_width=p.mb_width,
            mb_height=p.mb_height,
            crop_right=p.mb_width * 16 - p.i_width,
            crop_bottom=p.mb_height * 16 - p.i_height,
            qpprime_y_zero_transform_bypass=(
                p.rc.i_rc_method == 0 and p.rc.i_qp_constant == 0),
            fps_num=p.i_fps_num,
            fps_den=p.i_fps_den,
            sar_width=p.vui_sar_width,
            sar_height=p.vui_sar_height,
            vidformat=p.vui_i_vidformat,
            fullrange=p.vui_b_fullrange,
            colorprim=p.vui_i_colorprim,
            transfer=p.vui_i_transfer,
            colmatrix=p.vui_i_colmatrix,
            chroma_loc=p.vui_i_chroma_loc,
            num_reorder_frames=1 if p.i_bframe else 0,
            max_dec_frame_buffering=max(
                p.i_frame_reference, 1 + (1 if p.i_bframe else 0)),
            mv_range=max(p.analyse.i_mv_range, 64),
        )

    def write(self) -> bytes:
        """x264_sps_write (encoder/set.c:214)."""
        bs = BitWriter()
        bs.put(self.profile_idc, 8)
        bs.bit(self.profile_idc == PROFILE_BASELINE)  # constraint_set0
        bs.bit(self.profile_idc <= PROFILE_MAIN)      # constraint_set1
        bs.bit(0)                                     # constraint_set2
        bs.put(0, 5)                                  # reserved
        bs.put(self.level_idc, 8)
        bs.ue(self.sps_id)
        if self.profile_idc >= PROFILE_HIGH:
            bs.ue(1)   # chroma_format_idc 4:2:0
            bs.ue(0)   # bit_depth_luma_minus8
            bs.ue(0)   # bit_depth_chroma_minus8
            bs.bit(self.qpprime_y_zero_transform_bypass)
            bs.bit(0)  # seq_scaling_matrix_present
        bs.ue(self.log2_max_frame_num - 4)
        bs.ue(self.poc_type)
        if self.poc_type == 0:
            bs.ue(self.log2_max_poc_lsb - 4)
        bs.ue(self.num_ref_frames)
        bs.bit(0)  # gaps_in_frame_num_value_allowed
        bs.ue(self.mb_width - 1)
        bs.ue(self.mb_height - 1)
        bs.bit(1)  # frame_mbs_only
        bs.bit(self.direct8x8_inference)
        crop = self.crop_right or self.crop_bottom
        bs.bit(bool(crop))
        if crop:
            bs.ue(0)
            bs.ue(self.crop_right // 2)
            bs.ue(0)
            bs.ue(self.crop_bottom // 2)
        if self.fps_num > 0:
            # full VUI (x264_sps_write VUI section, encoder/set.c:
            # 285-362: SAR, signal type, chroma loc, timing, bitstream
            # restriction; the 2009 reference writes no HRD either)
            bs.bit(1)   # vui_parameters_present
            have_sar = self.sar_width > 0 and self.sar_height > 0
            bs.bit(int(have_sar))   # aspect_ratio_info_present
            if have_sar:
                SAR_IDC = {(1, 1): 1, (12, 11): 2, (10, 11): 3,
                           (16, 11): 4, (40, 33): 5, (24, 11): 6,
                           (20, 11): 7, (32, 11): 8, (80, 33): 9,
                           (18, 11): 10, (15, 11): 11, (64, 33): 12,
                           (160, 99): 13}
                idc = SAR_IDC.get((self.sar_width, self.sar_height))
                if idc is not None:
                    bs.put(idc, 8)
                else:
                    bs.put(255, 8)      # Extended_SAR
                    bs.put(self.sar_width, 16)
                    bs.put(self.sar_height, 16)
            bs.bit(0)   # overscan_info_present
            color_desc = (self.colorprim != 2 or self.transfer != 2
                          or self.colmatrix != 2)
            signal_type = (self.vidformat != 5 or self.fullrange
                           or color_desc)
            bs.bit(int(signal_type))  # video_signal_type_present
            if signal_type:
                bs.put(self.vidformat, 3)
                bs.bit(int(self.fullrange))
                bs.bit(int(color_desc))
                if color_desc:
                    bs.put(self.colorprim, 8)
                    bs.put(self.transfer, 8)
                    bs.put(self.colmatrix, 8)
            bs.bit(int(self.chroma_loc != 0))  # chroma_loc_info_present
            if self.chroma_loc != 0:
                bs.ue(self.chroma_loc)
                bs.ue(self.chroma_loc)
            bs.bit(1)   # timing_info_present
            bs.put(self.fps_den, 32)       # num_units_in_tick
            bs.put(self.fps_num * 2, 32)   # time_scale
            bs.bit(1)   # fixed_frame_rate
            bs.bit(0)   # nal_hrd_parameters_present
            bs.bit(0)   # vcl_hrd_parameters_present
            bs.bit(0)   # pic_struct_present
            bs.bit(1)   # bitstream_restriction (as the reference,
                        # encoder/set.c:202)
            bs.bit(1)   # motion_vectors_over_pic_boundaries
            bs.ue(0)    # max_bytes_per_pic_denom
            bs.ue(0)    # max_bits_per_mb_denom
            log2mv = max(1, (self.mv_range * 4 - 1).bit_length())
            bs.ue(min(log2mv, 16))   # log2_max_mv_length_horizontal
            bs.ue(min(log2mv, 16))   # log2_max_mv_length_vertical
            bs.ue(self.num_reorder_frames)
            bs.ue(self.max_dec_frame_buffering)
        else:
            bs.bit(0)   # vui_parameters_present
        bs.rbsp_trailing()
        return nal_unit(NAL_SPS, 3, bs.pack())


@dataclass
class PPS:
    """Picture parameter set (x264_pps_init/x264_pps_write,
    encoder/set.c:367-470)."""
    pps_id: int = 0
    sps_id: int = 0
    cabac: bool = False
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control: bool = True
    transform_8x8_mode: bool = False
    profile_idc: int = PROFILE_HIGH
    cqm_preset: int = 0
    scaling4: object = None       # (4,16) raster [4IY,4PY,4IC,4PC]
    scaling8: object = None       # (2,64) raster [8IY,8PY]

    @classmethod
    def from_params(cls, p: EncoderParams) -> "PPS":
        from . import cqm as xcqm
        sl4, sl8 = xcqm.scaling_lists(p.i_cqm_preset, p.cqm)
        return cls(
            cabac=p.b_cabac,
            num_ref_idx_l0=p.i_frame_reference,
            num_ref_idx_l1=1,
            pic_init_qp=p.rc.i_qp_constant if p.rc.i_rc_method == 0 else 26,
            chroma_qp_index_offset=p.analyse.i_chroma_qp_offset,
            transform_8x8_mode=p.analyse.b_transform_8x8,
            profile_idc=p.profile(),
            cqm_preset=p.i_cqm_preset,
            scaling4=sl4, scaling8=sl8,
        )

    def write(self) -> bytes:
        bs = BitWriter()
        bs.ue(self.pps_id)
        bs.ue(self.sps_id)
        bs.bit(self.cabac)
        bs.bit(0)  # pic_order_present
        bs.ue(0)   # num_slice_groups - 1
        bs.ue(self.num_ref_idx_l0 - 1)
        bs.ue(self.num_ref_idx_l1 - 1)
        bs.bit(0)  # weighted_pred
        bs.put(0, 2)  # weighted_bipred_idc
        bs.se(self.pic_init_qp - 26)
        bs.se(0)   # pic_init_qs - 26
        bs.se(self.chroma_qp_index_offset)
        bs.bit(self.deblocking_filter_control)
        bs.bit(0)  # constrained_intra_pred
        bs.bit(0)  # redundant_pic_cnt_present
        if self.transform_8x8_mode or self.cqm_preset != 0:
            bs.bit(self.transform_8x8_mode)
            bs.bit(self.cqm_preset != 0)  # pic_scaling_matrix_present
            if self.cqm_preset != 0:
                # spec list order IntraY, IntraCb, (Cr=Cb), InterY,
                # InterCb, (Cr=Cb) [+ 8x8 IntraY, InterY]
                # (x264_pps_write, encoder/set.c:449-466)
                from . import cqm as xcqm
                from . import tables as _t
                s4, s8 = self.scaling4, self.scaling8
                xcqm.write_scaling_list(bs, s4[_t.CQM_4IY],
                                        xcqm.JVT_4IY, xcqm.JVT_4IY, 16)
                xcqm.write_scaling_list(bs, s4[_t.CQM_4IC],
                                        s4[_t.CQM_4IY], xcqm.JVT_4IY, 16)
                bs.bit(0)   # Cr falls back to Cb
                xcqm.write_scaling_list(bs, s4[_t.CQM_4PY],
                                        xcqm.JVT_4PY, xcqm.JVT_4PY, 16)
                xcqm.write_scaling_list(bs, s4[_t.CQM_4PC],
                                        s4[_t.CQM_4PY], xcqm.JVT_4PY, 16)
                bs.bit(0)   # Cr falls back to Cb
                if self.transform_8x8_mode:
                    xcqm.write_scaling_list(bs, s8[_t.CQM_8IY],
                                            xcqm.JVT_8IY, xcqm.JVT_8IY,
                                            64)
                    xcqm.write_scaling_list(bs, s8[_t.CQM_8PY],
                                            xcqm.JVT_8PY, xcqm.JVT_8PY,
                                            64)
            bs.se(self.chroma_qp_index_offset)  # second_chroma_qp_offset
        bs.rbsp_trailing()
        return nal_unit(NAL_PPS, 3, bs.pack())


@dataclass
class SliceHeader:
    """Slice header (x264_slice_header_init/_write,
    encoder/encoder.c:84-300)."""
    slice_type: int = SLICE_I
    first_mb: int = 0
    pps_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = -1      # >= 0 for IDR slices
    poc_lsb: int = 0
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    cabac_init_idc: int = 0
    qp: int = 26
    pic_init_qp: int = 26
    disable_deblock: int = 1  # disable_deblocking_filter_idc
    alpha_c0_offset: int = 0  # in units of /2 already applied by caller
    beta_offset: int = 0
    num_ref_idx_override: bool = False
    cabac: bool = False
    log2_max_frame_num: int = 9
    log2_max_poc_lsb: int = 10

    def write_rbsp(self, bs: BitWriter, nal_ref_idc: int):
        bs.ue(self.first_mb)
        bs.ue(self.slice_type + 5)  # "all slices same type" variant
        bs.ue(self.pps_id)
        bs.put(self.frame_num, self.log2_max_frame_num)
        if self.idr_pic_id >= 0:
            bs.ue(self.idr_pic_id)
        bs.put(self.poc_lsb, self.log2_max_poc_lsb)
        if self.slice_type == SLICE_B:
            bs.bit(1)  # direct_spatial_mv_pred_flag (spatial, x264 default)
        if self.slice_type in (SLICE_P, SLICE_B):
            bs.bit(self.num_ref_idx_override)
            if self.num_ref_idx_override:
                bs.ue(self.num_ref_idx_l0 - 1)
                if self.slice_type == SLICE_B:
                    bs.ue(self.num_ref_idx_l1 - 1)
        if self.slice_type != SLICE_I:
            bs.bit(0)  # ref_pic_list_reordering_l0
        if self.slice_type == SLICE_B:
            bs.bit(0)  # ref_pic_list_reordering_l1
        if nal_ref_idc != 0:
            if self.idr_pic_id >= 0:
                bs.bit(0)  # no_output_of_prior_pics
                bs.bit(0)  # long_term_reference_flag
            else:
                bs.bit(0)  # adaptive_ref_pic_marking_mode
        if self.cabac and self.slice_type != SLICE_I:
            bs.ue(self.cabac_init_idc)
        bs.se(self.qp - self.pic_init_qp)
        bs.ue(self.disable_deblock)
        if self.disable_deblock != 1:
            bs.se(self.alpha_c0_offset)
            bs.se(self.beta_offset)


def sei_version(param_string: str) -> bytes:
    """x264-style version SEI: user_data_unregistered (payload type 5)
    carrying a UUID + encoder description (x264_sei_version_write,
    encoder/set.c:473). Stripped by the regression comparison, present
    for stream provenance."""
    uuid = bytes([0xdc, 0x45, 0xe9, 0xbd, 0xe6, 0xd9, 0x48, 0xb7,
                  0x96, 0x2c, 0xd8, 0x20, 0xd9, 0x23, 0xee, 0xef])
    text = (f"x264_tpu - TPU-native H.264 encoder - options: "
            f"{param_string}").encode() + b"\x00"
    payload = uuid + text
    bs = BitWriter()
    bs.put(5, 8)                      # payload type: user_data_unregistered
    size = len(payload)
    while size >= 255:
        bs.put(255, 8)
        size -= 255
    bs.put(size, 8)
    for b in payload:
        bs.put(b, 8)
    bs.rbsp_trailing()
    return nal_unit(NAL_SEI, 0, bs.pack())

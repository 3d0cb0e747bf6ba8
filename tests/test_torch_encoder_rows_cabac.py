"""MB-row sharding against x264_tpu, Encoder level, CABAC: the composed
case of tests/test_rows_sharded.py's test_sharded_cabac_composed_b_aq_t8
(two references, B runs of 2 at b-adapt 0, variance AQ under CRF, the
8x8 transform, subme 5, a pipe 2 deep: all three CABAC band programs, K27
and K28's plain versions), 4 bands of 2 MB rows, held as
test_torch_encoder_rows.py holds its CAVLC case."""

import test_torch_encoder_rows as base
from x264_tpu_torch.parallel import rows as trows


def test_cabac_composed_b_aq_t8_ref2():
    def make(cls):
        p = cls(i_width=base.W, i_height=base.H, b_cabac=True,
                i_log_level=0, i_keyint_max=8, i_mb_row_shards=4,
                i_frame_reference=2,
                i_bframe=2, i_scenecut_threshold=0, i_frame_parallel=2)
        p.i_bframe_adaptive = 0
        p.rc.i_aq_mode = 1
        p.analyse.b_transform_8x8 = True
        p.analyse.i_subpel_refine = 5
        return p

    launches = trows.halo_extend.launches
    (jh, jout, jsum, jqps), (th, tout, tsum, tqps), tenc = \
        base._both(make, base._clip(6), 4)
    assert tenc._aq is not None and tenc._t8 and not tenc._i8x8
    assert trows.halo_extend.launches == launches   # plain on the CPU
    assert th == jh
    assert [t.frame_type for t in tout] == ["IDR", "P", "B", "B", "P", "B"]
    assert tqps == jqps
    base._same_frames(jout, tout, 4)
    assert tsum["mb_pct"] == jsum["mb_pct"]
    base._decodes(th, tout)

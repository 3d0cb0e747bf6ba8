"""MB-row sharding against x264_tpu, Encoder level, the uneven split of
tests/test_rows_sharded.py's test_sharded_uneven_mb_height_pads (64x138:
9 MB rows over 4 bands, 3 rows of pad, CABAC at CQP 26). x264_tpu builds
its SPS before it sets the pad, so its SPS gives the unpadded height and
its stream does not decode (that test fails); the port builds the SPS
after the pad: every slice NAL and recon equals x264_tpu's, the SPS
differs only by the height and crop fields the pad sets, and
tests/refdec decodes the port's stream to its recons."""

import x264_tpu_torch
from x264_tpu_torch.headers import SPS as TSPS
from refdec.decoder import decode_annexb
import test_torch_encoder_rows as base


def test_uneven_split_pads_before_the_sps():
    w, h = 64, 138

    def make(cls):
        p = cls(i_width=w, i_height=h, b_cabac=True, i_log_level=0,
                i_keyint_max=8, i_mb_row_shards=4)
        p.rc.i_rc_method = 0
        p.rc.i_qp_constant = 26
        return p

    (jh, jout, _, jqps), (th, tout, _, tqps), tenc = \
        base._both(make, base._uneven_clip(w, h), 4)
    p = tenc.params
    assert p.i_mb_height_pad == 3 and p.mb_height == 12
    assert tqps == jqps
    base._same_frames(jout, tout, 4)
    # the SPS differs only by the pad: built without it, it is x264_tpu's
    jn, tn = base._nals(jh), base._nals(th)
    assert tn[1:] == jn[1:] and tn[0] != jn[0]
    unpadded = make(x264_tpu_torch.EncoderParams).validate()
    assert unpadded.i_mb_height_pad == 0
    assert base._nals(TSPS.from_params(unpadded).write()) == jn[:1]
    base._decodes(th, tout)
    assert decode_annexb(th + tout[0].payload)[0].y.shape == (h, w)

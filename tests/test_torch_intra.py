"""The port's plain intra encode (I16x16 + I4x4 + chroma wavefront)
against x264_tpu's encode_i16_frame(..., i4x4=True, lossless=False,
i8x8=False) on the same seeded planes and the same quant tables, carried
across with convert.qtab_from_numpy. Every output array must be exactly
equal; so must the port's own make_qtab."""

import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import intra as jintra
from x264_tpu_torch import convert
from x264_tpu_torch.encoder import intra as tintra

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def planes(mb_h, mb_w, seed):
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx // 3 + yy // 2) % 220 + rng.integers(0, 36, (h, w))) \
        .clip(0, 255).astype(np.int32)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    v = (128 + rng.integers(-20, 20, (h // 2, w // 2))).astype(np.int32)
    return y, u, v


@pytest.mark.parametrize("mb_h,mb_w,qp", [(4, 5, 18), (4, 5, 26),
                                          (4, 5, 38), (3, 7, 18),
                                          (3, 7, 26), (3, 7, 38)])
def test_intra_frame_matches_jax(mb_h, mb_w, qp):
    y, u, v = planes(mb_h, mb_w, qp + mb_w)
    qp_c = tables.chroma_qp(qp)
    lam = int(tables.LAMBDA_TABLE[qp])
    jq = jintra.make_qtab(qp, qp_c)
    jo = jintra.encode_i16_frame(mb_h, mb_w, y, u, v, jq, lam, True, False,
                                 False)
    tq = convert.qtab_from_numpy({k: np.asarray(a) for k, a in jq.items()},
                                 "cpu")
    own = tintra.make_qtab(qp, qp_c, "cpu")
    assert own.keys() == tq.keys()
    for k in tq:
        assert torch.equal(own[k], tq[k]), k
    to = tintra.encode_i16_frame(mb_h, mb_w, torch.from_numpy(y),
                                 torch.from_numpy(u), torch.from_numpy(v),
                                 tq, lam)
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                      err_msg=k)

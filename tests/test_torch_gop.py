"""Row 26a, the GOP-parallel intra batch: the port's encode_gop_intra on
a device list (["cpu"] * 2, the plain version of K1's frame axis)
against x264_tpu's encode_gop_intra on make_gop_mesh(2) over
tests/conftest.py's virtual CPU devices: every (N, ...) output exactly
equal; an N that the devices do not divide raises in both packages;
without a card gop_devices raises."""

import jax
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import intra as jintra
from x264_tpu.parallel import mesh as jmesh
from x264_tpu_torch import tables as ttables
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.parallel import mesh as tmesh

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

MB_H, MB_W = 2, 3


def _batch(n, seed=3):
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    ys = np.stack([((xx * (t + 1) + yy * 2) % 230 + rng.integers(0, 30, (h, w)))
                   for t in range(n)]).clip(0, 255).astype(np.int32)
    us = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.int32)
    vs = (128 + rng.integers(-30, 30, (n, h // 2, w // 2))).astype(np.int32)
    return ys, us, vs


@pytest.mark.parametrize("qp", [26, 34])
def test_gop_batch_matches_jax(qp):
    assert len(jax.devices()) >= 2
    ys, us, vs = _batch(4, qp)
    lam = int(tables.LAMBDA_TABLE[qp])
    jo = jmesh.encode_gop_intra(jmesh.make_gop_mesh(2), MB_H, MB_W, ys, us,
                                vs, jintra.make_qtab(qp, tables.chroma_qp(qp)),
                                np.int32(lam))
    tq = tintra.make_qtab(qp, ttables.chroma_qp(qp), "cpu")
    to = tmesh.encode_gop_intra(["cpu"] * 2, MB_H, MB_W, ys, us, vs, tq, lam)
    assert set(to) == set(jo)
    for k in jo:
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                      err_msg=k)
    assert not to["i4_mb"].any()
    # the batch is K1 without I4x4 frame by frame
    one = tintra.encode_i16_frame(MB_H, MB_W, *(torch.from_numpy(a[1])
                                                for a in (ys, us, vs)),
                                  tq, lam, i4x4=False)
    for k in one:
        assert torch.equal(to[k][1], one[k]), k


def test_gop_batch_that_does_not_divide_raises():
    ys, us, vs = _batch(3)
    lam = int(tables.LAMBDA_TABLE[26])
    with pytest.raises(ValueError):
        jmesh.encode_gop_intra(jmesh.make_gop_mesh(2), MB_H, MB_W, ys, us,
                               vs, jintra.make_qtab(26, 26), np.int32(lam))
    with pytest.raises(ValueError, match="equal chunks"):
        tmesh.encode_gop_intra(["cpu"] * 2, MB_H, MB_W, ys, us, vs,
                               tintra.make_qtab(26, 26, "cpu"), lam)
    # one device takes them all, a device may repeat
    out = tmesh.encode_gop_intra(["cpu"] * 3, MB_H, MB_W, ys, us, vs,
                                 tintra.make_qtab(26, 26, "cpu"), lam)
    assert out["recon_y"].shape == (3, MB_H * 16, MB_W * 16)


def test_gop_devices_need_a_card():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in tmesh.gop_devices(1))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.gop_devices()

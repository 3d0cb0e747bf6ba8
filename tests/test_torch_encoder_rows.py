"""MB-row sharding against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device=["cpu"] * n) against x264_tpu.Encoder(p)
with the same i_mb_row_shards on the virtual CPU devices of
tests/conftest.py, on tests/test_rows_sharded.py's clips (128x128, 4
bands of 2 MB rows). The port must give the same headers, frame types,
frame QPs, band NALs (one slice a band), recons and mb_pct, and
tests/refdec must decode its stream to its recons. This file holds the
helpers and CAVLC, 4 bands, CQP 26, IPPP (x264_tpu's encode_i_rows /
encode_p_rows); test_torch_encoder_rows_cabac.py the composed CABAC case
and test_torch_encoder_rows_uneven.py the uneven split, one
configuration a file (each takes some 150-180 s of one worker, nearly all
x264_tpu compiling its band programs)."""

import numpy as np
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.bits import split_annexb
from refdec.decoder import decode_annexb

torch.set_num_threads(1)

W, H = 128, 128


def _clip(n: int, w: int = W, h: int = H, seed: int = 3):
    """tests/test_rows_sharded.py's make_frames: a panning texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    return [(((tex[2 * t:2 * t + h, 3 * t:3 * t + w] + xx // 5) % 256)
             .astype(np.uint8),
             ((xx[::2, ::2] + 3 * t) % 256).astype(np.uint8),
             ((yy[::2, ::2] - 2 * t) % 256).astype(np.uint8))
            for t in range(n)]


def _uneven_clip(w: int, h: int):
    """tests/test_rows_sharded.py's uneven clip."""
    rng = np.random.default_rng(5)
    tex = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    return [((tex[2 * t:2 * t + h, 3 * t:3 * t + w] % 256).astype(np.uint8),
             ((tex[:h // 2, :w // 2] + t) % 256).astype(np.uint8),
             ((tex[1:1 + h // 2, 1:1 + w // 2] - t) % 256).astype(np.uint8))
            for t in range(4)]


def _run(enc, frames, frame_cls):
    head, out = enc.headers(), []
    for f in frames:
        o = enc.encode(frame_cls(*f))
        if o is not None:
            out.append(o)
    out += enc.flush()
    return head, out, enc.close(), [e.qp for e in enc.rc.entries]


def _both(make, frames, n: int):
    """(x264_tpu's run, the port's run on n CPU devices)."""
    jenc = x264_tpu.Encoder(make(x264_tpu.EncoderParams))
    assert jenc._rows_mesh is not None and jenc._n_shards == n
    tenc = x264_tpu_torch.Encoder(make(x264_tpu_torch.EncoderParams),
                                  device=["cpu"] * n)
    assert tenc._n_shards == n and len(tenc._bands) == n
    return _run(jenc, frames, JFrame), \
        _run(tenc, frames, x264_tpu_torch.Frame), tenc


def _nals(stream: bytes):
    return [bytes(n) for n in split_annexb(stream)]


def _same_frames(jout, tout, n_bands: int):
    assert [t.frame_type for t in tout] == [j.frame_type for j in jout]
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert len(_nals(t.payload)) == n_bands, i
        assert _nals(t.payload) == _nals(j.payload), i
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy(),
                                          err_msg=f"frame {i} {pl}")


def _decodes(head: bytes, tout):
    decoded = decode_annexb(head + b"".join(t.payload for t in tout))
    assert len(decoded) == len(tout)
    for d, t in zip(decoded, tout):          # both in decode order
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))


def test_cavlc_four_bands_ippp():
    def make(cls):
        p = cls(i_width=W, i_height=H, b_cabac=False, i_log_level=0,
                i_keyint_max=8, i_mb_row_shards=4)
        p.rc.i_rc_method = 0
        p.rc.i_qp_constant = 26
        return p

    (jh, jout, jsum, jqps), (th, tout, tsum, tqps), tenc = \
        _both(make, _clip(4), 4)
    assert tenc._delay == 0 and not tenc._cabac
    assert th == jh
    assert [t.frame_type for t in tout] == ["IDR", "P", "P", "P"]
    assert tqps == jqps
    _same_frames(jout, tout, 4)
    assert tsum["mb_pct"] == jsum["mb_pct"]
    _decodes(th, tout)

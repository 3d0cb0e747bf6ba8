"""Lossless (CQP 0, the qpprime_y_zero_transform_bypass) against
x264_tpu, Encoder level: the whole x264_tpu_torch.Encoder(p,
device="cpu") (the plain versions of K1's, K6's and K7's bypass
branches) against x264_tpu.Encoder(p) on tests/test_lossless.py's 96x80
clip (IDR then P frames), under CABAC and CAVLC: the SPS takes profile
144 with the bypass flag, every reconstruction equals its source, the
bytes equal x264_tpu's frame by frame, and tests/refdec decodes the
port's stream to the source."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.bits import split_annexb, unescape
from refdec.decoder import decode_annexb, parse_sps

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N = 96, 80, 4


def _clip():
    """tests/test_lossless.py's clip: a noisy sinusoid that moves, and
    chroma ramps."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (120 + 70 * np.sin(yy / 13.0) + 50 * np.cos(xx / 11.0)
            + rng.normal(0, 9, (H, W))).clip(0, 255).astype(np.uint8)
    out = []
    for t in range(N):
        y = np.roll(base, (t, 2 * t), axis=(0, 1))
        u = ((xx[::2, ::2] + 7 * t) % 256).astype(np.uint8)
        v = ((yy[::2, ::2] * 2 - t) % 256).astype(np.uint8)
        out.append((y, u, v))
    return out


def _params(cls, cabac):
    p = cls(i_width=W, i_height=H, b_cabac=cabac, i_log_level=0,
            i_keyint_max=16, i_scenecut_threshold=0)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 0
    return p


@pytest.mark.parametrize("cabac", [True, False])
def test_lossless_matches_jax(cabac):
    frames = _clip()
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, cabac))
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams,
                                          cabac), device="cpu")
    assert tenc._lossless and not tenc._rd
    head = tenc.headers()
    assert head == jenc.headers()
    sps = [parse_sps(unescape(n[1:])) for n in split_annexb(head)
           if n[0] & 31 == 7]
    assert len(sps) == 1 and sps[0].profile_idc == 144
    assert tenc.sps.qpprime_y_zero_transform_bypass
    out = []
    for f in frames:
        j = jenc.encode(JFrame(*f))
        t = tenc.encode(x264_tpu_torch.Frame(*f))
        assert t.frame_type == j.frame_type
        assert t.payload == j.payload
        for pl, src in zip("yuv", f):
            np.testing.assert_array_equal(getattr(t.recon, pl).numpy(),
                                          src.astype(np.int32))
        out.append(t)
    assert [t.frame_type for t in out] == ["IDR", "P", "P", "P"]
    decoded = decode_annexb(head + b"".join(t.payload for t in out))
    assert len(decoded) == N
    for d, f in zip(decoded, frames):
        for pl, src in zip("yuv", f):
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64), src.astype(np.int64))

"""Two references against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) with
--ref 3 (which validate() clamps to 2, as x264_tpu's does) in a CABAC
stream at x264_tpu's defaults (CRF 23 with variance AQ, subme 6 with
psy-RD) without the 8x8 transform, with --trellis 1 and one B frame
between references (b-adapt 0), i_frame_parallel 3, over eight
94x70 frames (not MB-aligned) of a flash sequence: a textured picture
whose middle band cycles through two noise patterns every two frames, so
that each P frame finds the band in the reference two P frames back,
L0[1]. The first P after the IDR runs with one reference (its slice
header overrides the PPS's two), the B slices override to one. Every
header, payload, recon, frame type, display index and frame QP must be
equal; tests/refdec must decode the port's stream to the port's recons
(in decode order), with MBs on reference 1 (ref_idx_l0 1 in the decoded
maps); PSNR within 1e-3 dB and SSIM within 1e-5. The CAVLC counterpart
is tests/test_torch_encoder_cavlc_b.py, which shares this file's frames
and checks. Most of the time is x264_tpu compiling its IDR, P (one and
two references) and B programs."""

import numpy as np
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.bits import split_annexb
from refdec.decoder import Decoder

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N = 94, 70, 8


def flash_frames():
    """A static texture under a little noise; rows 16-47 carry one of two
    noise patterns, pattern (t // 2) % 2 at frame t."""
    rng = np.random.default_rng(29)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 128 + 50 * np.sin(yy / 6.0) * np.cos(xx / 9.0)
    pat = [rng.integers(0, 256, (32, W)) for _ in range(2)]
    cy, cx = np.mgrid[0:(H + 1) // 2, 0:(W + 1) // 2]
    out = []
    for t in range(N):
        y = base + rng.integers(0, 4, (H, W))
        y[16:48] = pat[(t // 2) % 2]
        u = 120 + (cx + cy) % 16
        v = 136 - (cy * 2) % 11
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


def multiref_params(cls, cabac: bool, ref: int, frame_parallel: int):
    """x264_tpu's defaults with --ref `ref`, one B frame (b-adapt 0) and,
    under CABAC, --trellis 1 without the 8x8 transform (whose 8x8 trellis
    x264_tpu takes minutes to compile; tests/test_torch_encoder_trellis.py
    holds it at one reference)."""
    p = cls(i_width=W, i_height=H, i_log_level=0, b_cabac=cabac,
            i_frame_reference=ref, i_bframe=1,
            i_frame_parallel=frame_parallel)
    p.i_bframe_adaptive = 0
    p.analyse.i_trellis = int(cabac)
    p.analyse.b_transform_8x8 = False
    return p


def _run(enc, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in flash_frames()]
    out = [e for e in out if e is not None] + enc.flush()
    return head, out, enc.close(), [e.qp for e in enc.rc.entries]


def check_against_jax(cabac: bool, ref: int, frame_parallel: int):
    """Both Encoders on the flash frames; everything must be equal, and the
    port's stream must decode to its recons with MBs on reference 1."""
    mk = lambda cls: multiref_params(cls, cabac, ref, frame_parallel)
    jh, jout, jsum, jqps = _run(x264_tpu.Encoder(mk(x264_tpu.EncoderParams)),
                                JFrame)
    tenc = x264_tpu_torch.Encoder(mk(x264_tpu_torch.EncoderParams),
                                  device="cpu")
    assert tenc.params.i_frame_reference == 2
    assert tenc._cabac == cabac and tenc._trellis == cabac and tenc._aq
    th, tout, tsum, tqps = _run(tenc, x264_tpu_torch.Frame)
    types = [t.frame_type for t in tout]
    assert th == jh
    assert types == [j.frame_type for j in jout]
    assert [t.display_idx for t in tout] == [j.display_idx for j in jout]
    assert tqps == jqps
    assert "B" in types and types.count("P") >= 3, types
    for j, t in zip(jout, tout):
        assert t.payload == j.payload, (t.frame_type, t.display_idx)
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    dec = Decoder()
    on_ref1 = 0
    for nal in split_annexb(th + b"".join(t.payload for t in tout)):
        n = len(dec.frames)
        dec.decode_nal(nal)
        if len(dec.frames) > n:
            on_ref1 += int((dec.last_pic["ref_f"] == 1).sum())
    assert len(dec.frames) == N
    for d, t in zip(dec.frames, tout):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))
    assert on_ref1 > 0, "no MB took the older reference"
    for k in ("y", "u", "v", "avg", "global"):
        assert abs(tsum["psnr"][k] - jsum["psnr"][k]) <= 1e-3
    assert abs(tsum["ssim_y"] - jsum["ssim_y"]) <= 1e-5
    assert tsum["frame_types"] == jsum["frame_types"]
    assert tsum["mb_pct"] == jsum["mb_pct"]


def test_ref3_clamped_cabac_b_trellis_matches_jax():
    check_against_jax(cabac=True, ref=3, frame_parallel=3)

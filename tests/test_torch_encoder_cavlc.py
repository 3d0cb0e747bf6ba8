"""The CAVLC slice against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") (the plain versions of K18 / K19
and of K8's pass A) against x264_tpu.Encoder(p) with b_cabac off, over
94x70 frames (not MB-aligned): x264_tpu's defaults otherwise (CRF 23
with variance AQ, subme 6 with psy-RD, scenecut 40, keyint 250, which
validate() runs without 8x8dct and I8x8 under CAVLC) with keyint_min 2,
IPPP on a picture that pans and then cuts, at i_frame_parallel 1 and 3;
all-intra (keyint 1) at the same defaults, which reuses x264_tpu's
compiled IDR program; and all-intra at CQP 26 with deblocking at
i_frame_parallel 3 (bench.py's CAVLC line). The port must agree frame by
frame: equal headers (the PPS with entropy_coding_mode_flag 0), frame
types, per-frame QPs, payloads, recons and mb_pct, PSNR within 1e-3 dB
and SSIM within 1e-5, and tests/refdec decoding the port's stream to the
port's recon."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.bits import split_annexb, unescape
from refdec.decoder import decode_annexb, parse_pps

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N, CUT = 94, 70, 6, 3


def _frames():
    """Frames 0-2: a flat left half beside a noisy texture, panning two
    samples a frame; frames 3-5: a smooth ramp crossed by a noisy band."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H + 8, 0:W + 16]
    tex = np.where(xx < (W + 16) // 2, 96,
                   ((xx * 7 + yy * 3) % 61) * 3 + rng.integers(0, 60,
                                                               xx.shape))
    ramp = 30 + xx + 2 * yy + np.where((yy // 12) % 3 == 1,
                                       rng.integers(0, 90, xx.shape), 0)
    cy, cx = np.mgrid[0:(H + 1) // 2, 0:(W + 1) // 2]
    out = []
    for t in range(N):
        src = tex if t < CUT else ramp
        y = src[4:4 + H, 2 * t:2 * t + W] + rng.integers(0, 3, (H, W))
        u = 128 + (cx + 2 * t) // 4 if t < CUT else 90 + cy
        v = 128 - (cy + t) // 4 if t < CUT else 160 - cx
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


def _params(cls, mode, frame_parallel):
    """x264_tpu's defaults without CABAC (keyint_min 2): IPPP ("ippp"),
    all-intra ("intra"), or all-intra at CQP 26 ("cqp")."""
    p = cls(i_width=W, i_height=H, i_log_level=0, b_cabac=False,
            i_frame_parallel=frame_parallel)
    p.i_keyint_min = 2
    if mode != "ippp":
        p.i_keyint_max = 1
    if mode == "cqp":
        p.rc.i_rc_method = 0
        p.rc.i_qp_constant = 26
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close(), [e.qp for e in enc.rc.entries]


@pytest.mark.parametrize("mode,frame_parallel",
                         [("ippp", 1), ("ippp", 3), ("intra", 1),
                          ("cqp", 3)])
def test_cavlc_matches_jax(mode, frame_parallel):
    frames = _frames()
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, mode,
                                    frame_parallel))
    assert not (jenc._t8 or jenc._i8x8)
    jh, jout, jsum, jqps = _run(jenc, frames, JFrame)
    tenc = x264_tpu_torch.Encoder(
        _params(x264_tpu_torch.EncoderParams, mode, frame_parallel),
        device="cpu")
    th, tout, tsum, tqps = _run(tenc, frames, x264_tpu_torch.Frame)
    assert th == jh
    pps = [parse_pps(unescape(n[1:])) for n in split_annexb(th)
           if n[0] & 31 == 8]
    assert len(pps) == 1 and pps[0].cabac == 0
    types = ["IDR" if mode != "ippp" or i in (0, CUT) else "P"
             for i in range(N)]
    assert [j.frame_type for j in jout] == types
    assert [t.frame_type for t in tout] == types
    assert tqps == jqps
    for j, t in zip(jout, tout):
        assert t.payload == j.payload
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    decoded = decode_annexb(th + b"".join(t.payload for t in tout))
    assert len(decoded) == N
    for d, t in zip(decoded, tout):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))
    for k in ("y", "u", "v", "avg", "global"):
        assert abs(tsum["psnr"][k] - jsum["psnr"][k]) <= 1e-3
    assert abs(tsum["ssim_y"] - jsum["ssim_y"]) <= 1e-5
    assert tsum["mb_pct"] == jsum["mb_pct"]

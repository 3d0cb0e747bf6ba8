"""The B slice against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) with B
frames in CABAC streams, over eight 94x70 frames (not MB-aligned) of a
noisy texture that pans, with chroma that drifts, in three
configurations, each run once per module:
  (a) CQP 26, i_bframe 2, b-adapt 0 (fixed runs), i_frame_parallel 1, an
      IDR forced at frame 5 (the queued candidate becomes a P first);
  (b) x264_tpu's defaults (CRF 23 with variance AQ, 8x8dct in the I / P
      frames, subme 6 with psy-RD, scenecut 40) with i_bframe 3 (b-adapt
      1, the fast greedy) and keyint_min 2, a scene cut at frame 5,
      i_frame_parallel 3, ending in flush() with B candidates queued;
  (c) the defaults with i_bframe 3, b-adapt 2 (the path search) and
      --trellis 1 (the B frames' trellis then reads the 52-QP stacks at
      the frame QP).
Every payload, recon, frame type, display index and frame QP must be
equal, the headers too; tests/refdec must decode the port's stream to the
port's recon (in decode order); PSNR within 1e-3 dB and SSIM within
1e-5. Most of the time is x264_tpu compiling its IDR, P and B
programs."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N, CUT = 94, 70, 8, 5


def _frames():
    """Frames 0-4: a noisy texture panning two samples a frame; frames
    5-7: a smooth ramp with a noisy band (a scene cut), panning too."""
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:H + 8, 0:W + 24]
    tex = (128 + 50 * np.sin(yy / 6.0) * np.cos(xx / 9.0)
           + rng.integers(0, 40, xx.shape))
    ramp = 30 + xx + 2 * yy + np.where((yy // 12) % 3 == 1,
                                       rng.integers(0, 90, xx.shape), 0)
    cy, cx = np.mgrid[0:(H + 1) // 2, 0:(W + 1) // 2]
    out = []
    for t in range(N):
        src = tex if t < CUT else ramp
        y = src[4:4 + H, 2 * t:2 * t + W] + rng.integers(0, 6, (H, W))
        u = 120 + (cx + t) % 24 if t < CUT else 90 + cy
        v = 136 - (cy + t) // 3 if t < CUT else 160 - cx
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


CONFIGS = {
    "a_cqp_fixed": dict(bframes=2, adapt=0, depth=1, cqp=26, trellis=0,
                        force_idr=CUT),
    "b_defaults_badapt1": dict(bframes=3, adapt=1, depth=3, cqp=None,
                               trellis=0, force_idr=None),
    "c_badapt2_trellis": dict(bframes=3, adapt=2, depth=1, cqp=None,
                              trellis=1, force_idr=None),
}


def _params(cls, c):
    p = cls(i_width=W, i_height=H, i_log_level=0,
            i_frame_parallel=c["depth"], i_bframe=c["bframes"])
    p.i_bframe_adaptive = c["adapt"]
    p.i_keyint_min = 2
    p.analyse.i_trellis = c["trellis"]
    if c["cqp"] is not None:
        p.rc.i_rc_method = 0
        p.rc.i_qp_constant = c["cqp"]
    return p


def _run(enc, c, frame_cls):
    head = enc.headers()
    out = []
    for i, f in enumerate(_frames()):
        ef = enc.encode(frame_cls(*f), forced_type="IDR"
                        if i == c["force_idr"] else None)
        if ef is not None:
            out.append(ef)
    queued = len(enc._bqueue)
    out += enc.flush()
    return head, out, enc.close(), [e.qp for e in enc.rc.entries], queued


_REFS: dict = {}


def _reference(name):
    if name not in _REFS:
        c = CONFIGS[name]
        _REFS[name] = _run(x264_tpu.Encoder(_params(x264_tpu.EncoderParams,
                                                    c)), c, JFrame)
    return _REFS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_b_frames_match_jax(name):
    c = CONFIGS[name]
    jh, jout, jsum, jqps, jq = _reference(name)
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, c),
                                  device="cpu")
    th, tout, tsum, tqps, tq = _run(tenc, c, x264_tpu_torch.Frame)
    types = [t.frame_type for t in tout]
    assert th == jh
    assert types == [j.frame_type for j in jout]
    assert [t.display_idx for t in tout] == [j.display_idx for j in jout]
    assert tqps == jqps and tq == jq
    assert "B" in types, types
    # IDRs at display frame 0 and at the cut (forced, or found) only
    assert sorted(t.display_idx for t in tout if t.frame_type == "IDR") \
        == [0, CUT]
    if name.startswith("b_"):
        assert tq > 0                     # flush() drained a queued run
    for j, t in zip(jout, tout):
        assert t.payload == j.payload, (t.frame_type, t.display_idx)
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
    assert tsum["frame_types"] == jsum["frame_types"]
    assert tsum["mb_pct"] == jsum["mb_pct"]

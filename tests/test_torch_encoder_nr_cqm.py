"""The noise reduction with the JVT quant matrices against x264_tpu,
Encoder level (configuration A): the whole
x264_tpu_torch.Encoder(p, device="cpu") (K6's NR branch and K26 through
their plain versions) against x264_tpu.Encoder(p) with CABAC, --nr 250,
--cqm jvt, the 8x8 transform with I8x8, --trellis 1, CRF 23 with variance
AQ (x264_tpu's defaults otherwise, keyint_min 2) and i_frame_parallel 2,
over six 94x70 frames with a cut at frame 3. The port must agree frame
by frame: equal headers (the PPS carries the JVT scaling lists), frame
types, QPs, payloads and recons, the same NR offsets as x264_tpu after
every frame the pipe returns (a P frame's update runs when it is
finalized, so with the pipe two deep a P frame is queued with the
offsets of the P frames finished before it), and tests/refdec decoding
the port's stream to the port's recon."""

import numpy as np
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.bits import split_annexb, unescape
from refdec.decoder import decode_annexb, parse_pps

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N, CUT = 94, 70, 6, 3
TYPES = ["IDR", "P", "P", "IDR", "P", "P"]


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
        y = src[4:4 + H, 2 * t:2 * t + W] + rng.integers(0, 9, (H, W))
        u = 128 + (cx + 2 * t) // 4 if t < CUT else 90 + cy
        v = 128 - (cy + t) // 4 if t < CUT else 160 - cx
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


def _params(cls):
    p = cls(i_width=W, i_height=H, i_log_level=0, i_frame_parallel=2,
            i_cqm_preset=1)
    p.i_keyint_min = 2
    p.analyse.i_noise_reduction = 250
    p.analyse.i_trellis = 1
    return p


def _run(enc, frames, frame_cls):
    """Encode; after each returned frame, the encoder's NR offsets."""
    head, out, offs = enc.headers(), [], []
    for f in frames:
        o = enc.encode(frame_cls(*f))
        if o is not None:
            out.append(o)
            offs.append([a.copy() for a in enc._nr_off])
    for o in enc.flush():
        out.append(o)
        offs.append([a.copy() for a in enc._nr_off])
    return head, out, offs, [e.qp for e in enc.rc.entries]


def test_nr_jvt_cqm_matches_jax():
    frames = _frames()
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams))
    assert jenc._nr and jenc._t8 and jenc._i8x8 and jenc._aq
    jh, jout, joffs, jqps = _run(jenc, frames, JFrame)
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams),
                                  device="cpu")
    for a, b in (("quant4_mf", "quant4_mf"), ("dequant8_mf", "dequant8_mf")):
        np.testing.assert_array_equal(getattr(tenc.qt, a),
                                      getattr(jenc.qt, b))
    th, tout, toffs, tqps = _run(tenc, frames, x264_tpu_torch.Frame)
    assert th == jh
    pps = [parse_pps(unescape(n[1:])) for n in split_annexb(th)
           if n[0] & 31 == 8]
    assert len(pps) == 1
    assert [j.frame_type for j in jout] == TYPES
    assert [t.frame_type for t in tout] == TYPES
    assert tqps == jqps
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t.payload == j.payload, i
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    # the offsets move (the update ran) and agree after every frame
    assert any(o[0].any() for o in toffs) and any(o[1].any() for o in toffs)
    for jo, to in zip(joffs, toffs):
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jenc._nr_sum[0], tenc._nr_sum[0])
    np.testing.assert_array_equal(jenc._nr_sum[1], tenc._nr_sum[1])
    decoded = decode_annexb(th + b"".join(t.payload for t in tout))
    assert len(decoded) == N
    for d, t in zip(decoded, tout):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))

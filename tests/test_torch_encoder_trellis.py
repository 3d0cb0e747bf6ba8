"""The trellis slice against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) at
x264_tpu's defaults (CRF 23 with variance AQ, 8x8dct with I8x8, subme 6
with psy-RD, scenecut 40, keyint 250) with the CABAC trellis on
(analyse.i_trellis 1), over four 94x70 frames of a textured picture that
pans. The P frames' inter residual then quantises through the trellis
with each MB's rows of the 52-QP const stacks. The port must agree with
x264_tpu frame by frame with i_frame_parallel 1 and 3, and with
i_trellis 2, which x264_tpu encodes as 1 (it reads only whether the
trellis is on; the SEI's option string differs in that digit): equal
headers, frame types, per-frame QPs, payloads, recons and mb_pct,
tests/refdec decoding the port's stream to the port's recon, PSNR within
1e-3 dB and SSIM within 1e-5. Under CRF the frame QPs depend on the
pipe's depth, so x264_tpu runs at the same i_frame_parallel; both runs
reuse one set of compiled programs, which is most of this file's time."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.decoder import decode_annexb
from x264_tpu_torch.ops import trellis as otrellis

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N = 94, 70, 4


def _frames():
    """A noisy texture beside a smooth ramp, panning three samples a
    frame, with chroma that drifts."""
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:H + 8, 0:W + 16]
    src = np.where(xx < (W + 16) // 2, 40 + xx + yy,
                   ((xx * 5 + yy * 3) % 53) * 4 + rng.integers(0, 50,
                                                               xx.shape))
    cy, cx = np.mgrid[0:(H + 1) // 2, 0:(W + 1) // 2]
    out = []
    for t in range(N):
        y = src[4:4 + H, 3 * t:3 * t + W] + rng.integers(0, 4, (H, W))
        u = 120 + (cx + 3 * t) % 24
        v = 136 - (cy + t) // 3
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


def _defaults(cls, frame_parallel, trellis):
    p = cls(i_width=W, i_height=H, i_log_level=0,
            i_frame_parallel=frame_parallel)
    p.analyse.i_trellis = trellis
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close(), [e.qp for e in enc.rc.entries]


_REFS: dict = {}


def _reference(frame_parallel):
    """x264_tpu's run with i_trellis 1 (cached for the module)."""
    if frame_parallel not in _REFS:
        jenc = x264_tpu.Encoder(_defaults(x264_tpu.EncoderParams,
                                          frame_parallel, 1))
        assert jenc._aq and jenc._t8 and jenc._i8x8 and jenc._rd
        _REFS[frame_parallel] = _run(jenc, _frames(), JFrame)
    return _REFS[frame_parallel]


@pytest.mark.parametrize("frame_parallel,trellis", [(1, 1), (3, 1), (1, 2)])
def test_trellis_defaults_match_jax(frame_parallel, trellis, monkeypatch):
    jh, jout, jsum, jqps = _reference(frame_parallel)
    assert [j.frame_type for j in jout] == ["IDR"] + ["P"] * (N - 1)
    calls = []
    scan = otrellis.trellis_scan_plain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return scan(*a, **k)

    monkeypatch.setattr(otrellis, "trellis_scan_plain", spy)
    tenc = x264_tpu_torch.Encoder(
        _defaults(x264_tpu_torch.EncoderParams, frame_parallel, trellis),
        device="cpu")
    assert tenc._trellis and tenc._aq is not None
    th, tout, tsum, tqps = _run(tenc, _frames(), x264_tpu_torch.Frame)
    # each P frame's four categories ran through the trellis: luma 4x4
    # and 8x8, and per chroma channel the AC of the decimation scan and
    # the AC and DC of the residual
    assert {s[1] for s in calls} == {16, 15, 4, 64}
    assert len(calls) == 8 * (N - 1)
    assert th.replace(b"trellis=2", b"trellis=1") == jh
    assert [t.frame_type for t in tout] == [j.frame_type for j in jout]
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

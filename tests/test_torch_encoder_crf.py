"""The CRF / ABR + variance-AQ slice against x264_tpu, Encoder level: the
whole x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p)
at x264_tpu's own defaults (CRF 23, variance AQ at strength 1.0, 8x8dct
with I8x8, subme 6 with psy-RD, scenecut 40, keyint 250) with keyint_min
2, and at 1-pass ABR at a bitrate that moves the QP from frame to frame,
over six 94x70 frames (not MB-aligned: the first cropped IPPP test of the
port): a picture with a flat half and a textured half that pans, then a
cut to a ramp with a noisy band. The port must agree with x264_tpu frame
by frame with i_frame_parallel 1 and 3: equal headers, frame types,
per-frame QPs, payloads, recons and mb_pct, tests/refdec decoding the
port's stream to the port's recon, PSNR within 1e-3 dB and SSIM within
1e-5; the per-MB QPs of the frames must spread over at least 4. Under
CRF / ABR the frame QPs depend on the pipe's depth (a frame's QP reads
the sizes of the frames finished before it is queued), so x264_tpu runs
at the same i_frame_parallel; every run reuses the same compiled
programs (the frame QP is traced), so they compile once in this file."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.decoder import decode_annexb
from x264_tpu_torch.encoder import pipeline

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N, CUT = 94, 70, 6, 3
TYPES = ["IDR", "P", "P", "IDR", "P", "P"]
ABR_KBPS = 40


def _frames():
    """Frames 0-2: a flat left half beside a noisy texture, panning two
    samples a frame; frames 3-5: a smooth ramp crossed by a noisy band,
    panning too."""
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


def _params(cls, frame_parallel, mode):
    """x264_tpu's defaults (CRF 23 with variance AQ), or 1-pass ABR at
    ABR_KBPS, with keyint_min 2."""
    p = cls(i_width=W, i_height=H, i_log_level=0,
            i_frame_parallel=frame_parallel)
    p.i_keyint_min = 2
    if mode == "abr":
        p.rc.i_rc_method = 2
        p.rc.i_bitrate = ABR_KBPS
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close(), [e.qp for e in enc.rc.entries]


_REFS: dict = {}


def _reference(mode, frame_parallel):
    """x264_tpu's run of this configuration (cached for the module)."""
    key = (mode, frame_parallel)
    if key not in _REFS:
        jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams,
                                        frame_parallel, mode))
        assert jenc._aq and jenc._t8 and jenc._i8x8 and jenc._rd
        _REFS[key] = _run(jenc, _frames(), JFrame)
    return _REFS[key]


@pytest.mark.parametrize("mode,frame_parallel",
                         [("crf", 1), ("crf", 3), ("abr", 3)])
def test_crf_abr_aq_matches_jax(mode, frame_parallel, monkeypatch):
    jh, jout, jsum, jqps = _reference(mode, frame_parallel)
    assert [j.frame_type for j in jout] == TYPES
    # the per-MB QPs the port's frames decode with
    qps = []
    for name in ("encode_i16_idr_cabac", "encode_p_cabac"):
        fn = getattr(pipeline, name)

        def spy(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            qps.append(out["qp_eff"].clone())
            return out

        monkeypatch.setattr(pipeline, name, spy)
    tenc = x264_tpu_torch.Encoder(
        _params(x264_tpu_torch.EncoderParams, frame_parallel, mode),
        device="cpu")
    th, tout, tsum, tqps = _run(tenc, _frames(), x264_tpu_torch.Frame)
    assert th == jh
    assert [t.frame_type for t in tout] == TYPES
    assert tqps == jqps
    if mode == "abr":
        assert len(set(tqps[1:CUT])) > 1 or len(set(tqps[CUT + 1:])) > 1, \
            tqps
    assert len(qps) == N
    assert max(int(q.max() - q.min()) for q in qps) >= 4
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
    assert tsum["frame_types"] == jsum["frame_types"] == {"IDR": 2, "P": 4}
    assert tsum["mb_pct"] == jsum["mb_pct"]

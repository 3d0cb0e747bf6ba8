"""The 8x8-transform slice against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) at
x264_tpu's defaults at CQP 26 (the 8x8 transform with I8x8 in the IDRs,
subme 6 with psy-RD 1.0 and the RD transform choice, scenecut 40, keyint
250) with keyint_min 2, and at subme 5 (the SA8D transform choice), over
six 80x64 frames: three of a directional gradient under blocky noise that
pans, then a cut to a smooth ramp that pans too. x264_tpu calls the cut itself
(IDRs at frames 0 and 3), some IDR MBs take I8x8 and some P MBs the 8x8
transform, which the test asserts. The port must agree with x264_tpu
frame by frame with i_frame_parallel 1 and 3: equal headers, frame types,
payloads, recons and mb_pct, tests/refdec decoding the port's stream to
the port's recon, PSNR within 1e-3 dB and SSIM within 1e-5. x264_tpu runs
once per configuration (its output does not depend on i_frame_parallel),
so each of its programs compiles once in this file."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.decoder import decode_annexb
from x264_tpu_torch.encoder import intra
from x264_tpu_torch.entropy import cabac_planes

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N, CUT = 80, 64, 6, 3
TYPES = ["IDR", "P", "P", "IDR", "P", "P"]


def _frames():
    """Frames 0-2: a directional gradient under 8x8-blocky noise (detail
    enough to beat I16, smooth enough that 8x8 beats 4x4; as
    tests/test_i8x8.py builds it), panning two samples a frame; frames
    3-5: a smooth ramp under light blocky noise, far from the first
    picture, panning too."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H + 8, 0:W + 16]
    low = np.kron(rng.integers(-20, 20, ((H + 8) // 8 + 1, (W + 16) // 8 + 1)),
                  np.ones((8, 8)))[:H + 8, :W + 16]
    tex = ((yy * 2 + xx * 3) // 2) % 256 + low
    ramp = 40 + 2 * xx + yy + low // 4
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        src = tex if t < CUT else ramp
        y = src[4:4 + H, 2 * t:2 * t + W] + rng.integers(0, 3, (H, W))
        u = 128 + (cx + 2 * t) // 4 if t < CUT else 90 + cy
        v = 128 - (cy + t) // 4 if t < CUT else 160 - cx
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


def _params(cls, frame_parallel, subme):
    """x264_tpu's defaults at CQP 26 (8x8dct, I8x8, psy-RD 1.0, scenecut
    40, keyint 250) at `subme`, with keyint_min 2."""
    p = cls(i_width=W, i_height=H, i_keyint_max=250, i_log_level=0,
            i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 26
    p.analyse.i_subpel_refine = subme
    p.i_keyint_min = 2
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close()


@pytest.fixture(scope="module", params=[6, 5], ids=["subme6", "subme5"])
def reference(request):
    """x264_tpu's run at this subme, once for the module."""
    subme = request.param
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, 1, subme))
    assert jenc._t8 and jenc._i8x8 and jenc._rd == (subme >= 6)
    return subme, _run(jenc, _frames(), JFrame)


@pytest.mark.parametrize("frame_parallel", [1, 3])
def test_t8_ippp_matches_jax(reference, frame_parallel, monkeypatch):
    subme, (jh, jout, jsum) = reference
    assert [j.frame_type for j in jout] == TYPES
    # count the port's I8x8 MBs and 8x8-transform P MBs as they pass
    seen = {"i8x8": 0, "t8": 0}
    encode_i, p_ops = intra.encode_i16_frame, cabac_planes.cabac_p_ops

    def intra_seen(*a, **k):
        out = encode_i(*a, **k)
        seen["i8x8"] += int(out["t8_mb"].sum())
        return out

    def p_ops_seen(*a, **k):
        out = p_ops(*a, **k)
        seen["t8"] += int(out[0]["t8_mb"].sum())
        return out

    monkeypatch.setattr(intra, "encode_i16_frame", intra_seen)
    monkeypatch.setattr(cabac_planes, "cabac_p_ops", p_ops_seen)
    tenc = x264_tpu_torch.Encoder(
        _params(x264_tpu_torch.EncoderParams, frame_parallel, subme),
        device="cpu")
    assert tenc._t8 and tenc._i8x8 and tenc._rd == (subme >= 6)
    th, tout, tsum = _run(tenc, _frames(), x264_tpu_torch.Frame)
    assert seen["i8x8"] > 0 and seen["t8"] > 0, seen
    assert th == jh
    assert [t.frame_type for t in tout] == TYPES
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

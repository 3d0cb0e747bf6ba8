"""The subme-6 + scenecut slice against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) at
subme 6 (the RD ladder with psy-RD 1.0), scenecut 40, keyint 250,
keyint_min 2, one reference, no B frames, no 8x8dct, over eight 80x64
frames: four of a textured picture that pans, then a cut to an unrelated
smooth picture that pans too. x264_tpu itself calls the cut (an IDR at
frame 4), and the port must agree with it frame by frame, with
i_frame_parallel 1 and 3: equal headers, frame types, payloads, recons
and mb_pct, tests/refdec decoding the port's stream to the port's recon,
PSNR within 1e-3 dB and SSIM within 1e-5. The JAX programs compile once
in this file."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N, CUT = 80, 64, 8, 4


def _frames():
    """Frames 0-3: a noisy texture panning one sample a frame; frames 4-7:
    a smooth ramp with light noise (cheap to intra-code, far from the
    texture), panning too."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H + 8, 0:W + 8]
    tex = ((xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
           + rng.integers(0, 40, xx.shape))
    ramp = 40 + 2 * xx + yy
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        src = tex if t < CUT else ramp
        y = src[4:4 + H, t % 8:t % 8 + W] + rng.integers(0, 3, (H, W))
        u = 128 + (cx + t) % 30 - 15 if t < CUT else 90 + cy
        v = 128 - (cy + t) % 30 + 15 if t < CUT else 160 - cx
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


def _params(cls, frame_parallel):
    """x264_tpu's defaults at CQP 26 without the 8x8 transform: subme 6,
    psy-RD 1.0, scenecut 40, keyint 250, with keyint_min 2."""
    p = cls(i_width=W, i_height=H, i_keyint_max=250, i_log_level=0,
            i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 26
    p.analyse.b_transform_8x8 = False
    p.analyse.i_subpel_refine = 6
    p.i_scenecut_threshold = 40
    p.i_keyint_min = 2
    p.i_frame_reference = 1
    p.i_bframe = 0
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close()


@pytest.mark.parametrize("frame_parallel", [1, 3])
def test_rd_scenecut_ippp_matches_jax(frame_parallel):
    frames = _frames()
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, frame_parallel))
    jh, jout, jsum = _run(jenc, frames, JFrame)
    types = ["IDR", "P", "P", "P", "IDR", "P", "P", "P"]
    # x264_tpu calls the cut itself, at subme 6 with psy on
    assert [j.frame_type for j in jout] == types
    assert jenc._rd and jenc._qtab_p_cache and all(
        "psy_rd" in q for q in jenc._qtab_p_cache.values())
    tenc = x264_tpu_torch.Encoder(
        _params(x264_tpu_torch.EncoderParams, frame_parallel), device="cpu")
    th, tout, tsum = _run(tenc, frames, x264_tpu_torch.Frame)
    assert tenc._rd and tenc._analyse_lowres
    assert th == jh
    assert [t.frame_type for t in tout] == types
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
    assert tsum["frame_types"] == jsum["frame_types"] == {"IDR": 2, "P": 6}
    assert tsum["mb_pct"] == jsum["mb_pct"]

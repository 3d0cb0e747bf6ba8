"""The whole slices: x264_tpu_torch.Encoder(p, device="cpu") against
x264_tpu.Encoder(p) for all-intra (keyint 1), CQP 26, CABAC, no 8x8
transform, deblocking and PSNR / SSIM on, with i_frame_parallel 1 and 3,
at 80x64 and at a cropped 68x52, and once with nonzero deblocking and
chroma QP offsets; and for IPPP (keyint 3, scenecut 0, subme 1, one
reference, no B frames) at 80x64 over five frames, IDR P P IDR P, with
i_frame_parallel 1 and 3. Headers, every payload, every frame type and
every recon must be equal;
tests/refdec must decode the port's stream to the port's recon; PSNR
must agree within 1e-3 dB and SSIM within 1e-5."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _frames(w, h, n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        y = ((xx // 3 + yy // 2) % 220 + rng.integers(0, 36, (h, w))) \
            .clip(0, 255).astype(np.uint8)
        u = (128 + (xx[::2, ::2] % 40) - 20
             + rng.integers(0, 8, (h // 2, w // 2))).astype(np.uint8)
        v = (128 - (yy[::2, ::2] % 40) + 20).astype(np.uint8)
        out.append((y, u, v))
    return out


def _params(cls, w, h, frame_parallel, offsets):
    p = cls(i_width=w, i_height=h, i_keyint_max=1, i_log_level=0,
            i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 26
    p.analyse.b_transform_8x8 = False
    (p.i_deblocking_filter_alphac0, p.i_deblocking_filter_beta,
     p.analyse.i_chroma_qp_offset) = offsets
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close()


# (deblock alpha/c0 offset, beta offset, chroma QP offset)
FLAT, OFFSET = (0, 0, 0), (-2, 1, 2)


@pytest.mark.parametrize("w,h,frame_parallel,offsets", [
    (80, 64, 1, FLAT), (80, 64, 3, FLAT), (68, 52, 1, FLAT),
    (68, 52, 3, FLAT), (68, 52, 3, OFFSET)],
    ids=["80x64-fp1", "80x64-fp3", "68x52-fp1", "68x52-fp3",
         "68x52-fp3-offsets"])
def test_slice_matches_jax(w, h, frame_parallel, offsets):
    frames = _frames(w, h, 2, w + frame_parallel)
    jh, jout, jsum = _run(
        x264_tpu.Encoder(_params(x264_tpu.EncoderParams, w, h,
                                 frame_parallel, offsets)), frames, JFrame)
    th, tout, tsum = _run(
        x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, w, h,
                                       frame_parallel, offsets),
                               device="cpu"),
        frames, x264_tpu_torch.Frame)
    assert th == jh
    assert len(tout) == len(jout) == 2
    for j, t in zip(jout, tout):
        assert t.payload == j.payload
        assert t.frame_type == j.frame_type == "IDR"
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    decoded = decode_annexb(th + b"".join(t.payload for t in tout))
    assert len(decoded) == 2
    for d, t in zip(decoded, tout):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))
    for k in ("y", "u", "v", "avg", "global"):
        assert abs(tsum["psnr"][k] - jsum["psnr"][k]) <= 1e-3
    assert abs(tsum["ssim_y"] - jsum["ssim_y"]) <= 1e-5
    assert tsum["frames"] == 2 and tsum["frame_types"] == {"IDR": 2}


def _pan_frames(w, h, n, seed):
    """A static texture under noise that moves two pixels a frame: the P
    frames find their motion, and the noise keeps a residual."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx // 3 + yy // 2) % 200
    noise = rng.integers(0, 24, (h + 8, w + 2 * n + 8))
    return [((base + noise[t % 4:t % 4 + h, 2 * t:2 * t + w])
             .clip(0, 255).astype(np.uint8),
             (128 + (xx[::2, ::2] + t) % 40 - 20).astype(np.uint8),
             (128 - (yy[::2, ::2] % 40) + 20).astype(np.uint8))
            for t in range(n)]


def _ippp_params(cls, w, h, frame_parallel):
    """The IPPP slice: fixed GOP (keyint 3, so a second IDR comes),
    scenecut 0, subme 1, one reference, no B frames."""
    p = _params(cls, w, h, frame_parallel, FLAT)
    p.i_keyint_max = 3
    p.i_scenecut_threshold = 0
    p.analyse.i_subpel_refine = 1
    p.i_frame_reference = 1
    p.i_bframe = 0
    return p


@pytest.mark.parametrize("frame_parallel", [1, 3])
def test_ippp_slice_matches_jax(frame_parallel):
    w, h = 80, 64
    frames = _pan_frames(w, h, 5, 1)
    jh, jout, jsum = _run(
        x264_tpu.Encoder(_ippp_params(x264_tpu.EncoderParams, w, h,
                                      frame_parallel)), frames, JFrame)
    th, tout, tsum = _run(
        x264_tpu_torch.Encoder(_ippp_params(x264_tpu_torch.EncoderParams, w,
                                            h, frame_parallel),
                               device="cpu"),
        frames, x264_tpu_torch.Frame)
    assert th == jh
    types = ["IDR", "P", "P", "IDR", "P"]
    assert [t.frame_type for t in tout] == [j.frame_type for j in jout] \
        == types
    for j, t in zip(jout, tout):
        assert t.payload == j.payload
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    decoded = decode_annexb(th + b"".join(t.payload for t in tout))
    assert len(decoded) == 5
    for d, t in zip(decoded, tout):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))
    for k in ("y", "u", "v", "avg", "global"):
        assert abs(tsum["psnr"][k] - jsum["psnr"][k]) <= 1e-3
    assert abs(tsum["ssim_y"] - jsum["ssim_y"]) <= 1e-5
    assert tsum["frame_types"] == jsum["frame_types"] == {"IDR": 2, "P": 3}
    assert tsum["mb_pct"] == jsum["mb_pct"]
    # P frames cost far fewer bytes than the IDRs here
    assert max(len(t.payload) for t in tout if t.frame_type == "P") \
        < min(len(t.payload) for t in tout if t.frame_type == "IDR")

"""Intra without I4x4 against x264_tpu, Encoder level: the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) with
the partition flags x264_tpu's CLI sets (cli.py:185-208):
--partitions none (analyse.intra = inter = 0; x264's ultrafast preset)
under CAVLC at its ultrafast settings (CRF 23 without AQ, no deblock,
subme 1, no 8x8dct, scenecut 0) and under CABAC at CQP 26 with
deblocking; and --partitions i8x8 (I8x8 without I4x4, held against
I16x16 alone, and no P partitions) at x264_tpu's CRF 23 with variance
AQ and the 8x8 transform, subme 1. Over 62x46 frames (not MB-aligned)
of a panning texture: equal headers, frame types, payloads and recons,
and tests/refdec decoding the port's stream to the port's recons."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.params import ANALYSE_I8x8
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H = 62, 46


def _frames(n):
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:H + 8, 0:W + 2 * n]
    low = np.kron(rng.integers(-25, 25, ((H + 8) // 8 + 1, (W + 2 * n) // 8
                                         + 1)), np.ones((8, 8)))
    tex = ((xx * 3 + yy * 2) // 2 % 200 + low[:H + 8, :W + 2 * n]
           + rng.integers(0, 30, xx.shape))
    cy, cx = np.mgrid[0:(H + 1) // 2, 0:(W + 1) // 2]
    return [tuple(np.clip(c, 0, 255).astype(np.uint8) for c in (
        tex[4:4 + H, 2 * t:2 * t + W], 128 + (cx + 2 * t) // 3 - 10,
        100 + (cy * 5) % 60)) for t in range(n)]


def _params(cls, mode):
    p = cls(i_width=W, i_height=H, i_log_level=0, i_keyint_max=30,
            i_scenecut_threshold=0)
    p.analyse.i_subpel_refine = 1
    if mode == "i8x8":
        # x264_tpu's defaults (CRF 23 + AQ, CABAC, 8x8dct) at subme 1
        p.analyse.inter = ANALYSE_I8x8
        p.analyse.intra = ANALYSE_I8x8
        return p
    p.analyse.inter = p.analyse.intra = 0
    p.analyse.b_transform_8x8 = False
    if mode == "none_cavlc":
        # x264's ultrafast as x264_tpu takes it
        p.b_cabac = False
        p.b_deblocking_filter = False
        p.rc.i_aq_mode = 0
    else:
        p.rc.i_rc_method = 0
        p.rc.i_qp_constant = 26
    return p


@pytest.mark.parametrize("mode,n", [("none_cavlc", 4), ("none_cabac", 3),
                                    ("i8x8", 3)])
def test_partitions_match_jax(mode, n, monkeypatch):
    frames = _frames(n)
    # count the port's I4x4 and I8x8 MBs as they pass
    seen = {"i4": 0, "i8": 0}
    run = tintra.encode_i16_frame

    def intra_seen(*a, **k):
        out = run(*a, **k)
        i8 = out.get("t8_mb", torch.zeros_like(out["i4_mb"]))
        seen["i8"] += int(i8.sum())
        seen["i4"] += int((out["i4_mb"] & ~i8).sum())
        return out

    monkeypatch.setattr(tintra, "encode_i16_frame", intra_seen)
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, mode))
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams,
                                          mode), device="cpu")
    assert not tenc._i4x4 and tenc._i8x8 == (mode == "i8x8")
    assert not tenc._parts and tenc._cabac == (mode != "none_cavlc")
    head = tenc.headers()
    assert head == jenc.headers()
    out = []
    for f in frames:
        j = jenc.encode(JFrame(*f))
        t = tenc.encode(x264_tpu_torch.Frame(*f))
        assert (j is None) == (t is None)
        if t is None:
            continue
        assert t.frame_type == j.frame_type
        assert t.payload == j.payload
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
        out.append(t)
    assert [t.frame_type for t in out] == ["IDR"] + ["P"] * (n - 1)
    assert seen["i4"] == 0 and (seen["i8"] > 0) == (mode == "i8x8"), seen
    decoded = decode_annexb(head + b"".join(t.payload for t in out))
    assert len(decoded) == n
    for d, t in zip(decoded, out):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))
    jenc.close()
    tenc.close()

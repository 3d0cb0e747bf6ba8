"""The subme 2-5 slice against x264_tpu: encode_p_body at subme 5 with
the 16x8 / 8x16 / P8x8 partitions and chroma ME at 4x5 MBs, on content
where every partition type wins somewhere (and a few MBs go intra); and
the whole x264_tpu_torch.Encoder(p, device="cpu") against
x264_tpu.Encoder(p) for IPPP (keyint 3, scenecut 0, one reference, no B
frames) at subme 2 and subme 5 with i_frame_parallel 1 and 3, over five
80x64 frames (IDR P P IDR P) whose regions move by different sub-pel
amounts. Every integer output, header, payload and recon must be equal,
tests/refdec must decode the port's stream to the port's recon, PSNR
must agree within 1e-3 dB and SSIM within 1e-5. Each JAX program is
compiled once per configuration in this file."""

import functools

import jax
import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu import tables
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder.core import Frame as JFrame
from x264_tpu_torch import convert
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import pipeline as tpipe
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
QP = 26
MB_H, MB_W = 4, 5
# partition type -> its partitions as (top, left, height, width)
RECTS = tinter.PART_RECTS


def _texture(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
            + rng.integers(0, 40, (h, w))).clip(0, 255)


def _p_inputs(seed):
    """A textured reference; the source cut from it partition by
    partition, each partition of each MB (of a random layout) moved by
    its own whole- or half-pel displacement, two MBs a smooth ramp that
    the reference cannot predict."""
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    big = _texture(rng, h + 16, w + 16)
    half = (big + np.roll(big, -1, 1) + 1) // 2
    ref = big[8:8 + h, 8:8 + w]
    y = np.empty((h, w), np.int64)
    for my in range(MB_H):
        for mx in range(MB_W):
            for top, left, bh, bw in RECTS[rng.integers(0, 4)]:
                dy, dx = rng.integers(-5, 6, 2)
                src = half if rng.random() < 0.5 else big
                y0, x0 = 8 + my * 16 + top + dy, 8 + mx * 16 + left + dx
                y[my * 16 + top:my * 16 + top + bh,
                  mx * 16 + left:mx * 16 + left + bw] = \
                    src[y0:y0 + bh, x0:x0 + bw]
    y = y + rng.integers(-2, 3, (h, w))
    yy, xx = np.mgrid[0:16, 0:16]
    for my, mx in ((1, 1), (3, 4)):
        y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = 60 + 4 * xx + 3 * yy
    ref_u = rng.integers(60, 200, (h // 2, w // 2))
    ref_v = rng.integers(60, 200, (h // 2, w // 2))
    u, v = np.roll(ref_u, (1, 1), (0, 1)), np.roll(ref_v, (1, 0), (0, 1))
    mvp = rng.integers(-8, 9, (MB_H, MB_W, 2))
    return [np.clip(a, 0, 255).astype(np.int32)
            for a in (y, u, v, ref, ref_u, ref_v)] + [mvp.astype(np.int32)]


@pytest.fixture(scope="module")
def jax_p_body():
    """x264_tpu's encode_p_body at subme 5 (quarter-pel steps, partitions
    with P8x8, chroma ME), compiled once."""
    return jax.jit(functools.partial(
        jinter.encode_p_body, MB_H, MB_W, 16, subpel_steps=(2, 1),
        parts=True, n_refs=1, t8=False, rd=False, decimate=True, p8x8=True,
        chroma_me=True))


def test_encode_p_body_subme5_matches_jax(jax_p_body):
    y, u, v, ry, ru, rv, mvp = _p_inputs(0)
    lam = int(tables.LAMBDA_TABLE[QP])
    jq = jinter.make_qtab_p(QP, tables.chroma_qp(QP))
    tq = convert.qtab_p_from_numpy({k: np.asarray(a) for k, a in jq.items()},
                                   "cpu")
    jo = {k: np.asarray(a) for k, a in
          jax_p_body(y, u, v, ry, ru, rv, jq, lam, mvp).items()}
    to = tinter.encode_p_body(MB_H, MB_W, 16, T(y), T(u), T(v), T(ry),
                              T(ru), T(rv), tq, lam, T(mvp), True, (2, 1),
                              True, True, True)
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k].numpy(), err_msg=k)
    # not vacuous: every partition type, intra MBs, fractional MVs
    pt = to["ptype"].numpy()[~to["intra_mb"].numpy()]
    assert (np.bincount(pt, minlength=4) > 0).all()
    assert to["intra_mb"].numpy().any()
    assert (to["mv4"].numpy() & 3).any()


def _moving_frames(w, h, n, seed):
    """Regions that move by different sub-pel amounts: each 8x8 block
    drifts by its MB's velocity, or by its partition's (a random layout
    per MB), in half-pels a frame; a half-pel position is the rounded
    average of the two whole-pel ones. Chroma drifts by whole samples."""
    rng = np.random.default_rng(seed)
    m = 24
    big = _texture(rng, h + 2 * m, w + 2 * m)
    vel = np.zeros((h // 8, w // 8, 2), np.int64)
    for my in range(h // 16):
        for mx in range(w // 16):
            for top, left, bh, bw in RECTS[rng.integers(0, 4)]:
                vel[(my * 16 + top) // 8:(my * 16 + top + bh) // 8,
                    (mx * 16 + left) // 8:(mx * 16 + left + bw) // 8] = \
                    rng.integers(-3, 4, 2)
    yy, xx = np.mgrid[0:h // 2, 0:w // 2]
    frames = []
    for t in range(n):
        y = np.empty((h, w), np.int64)
        for by in range(h // 8):
            for bx in range(w // 8):
                iy, fy = divmod(int(vel[by, bx, 0]) * t, 2)
                ix, fx = divmod(int(vel[by, bx, 1]) * t, 2)
                y0, x0 = m + by * 8 + iy, m + bx * 8 + ix
                s = big[y0:y0 + 9, x0:x0 + 9]
                s = (s[:, :8] + s[:, fx:fx + 8] + 1) // 2
                s = (s[:8] + s[fy:fy + 8] + 1) // 2
                y[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = s
        y = (y + rng.integers(-2, 3, (h, w))).clip(0, 255)
        u = 128 + (xx + t) % 40 - 20 + rng.integers(0, 4, (h // 2, w // 2))
        v = 128 - (yy + t) % 40 + 20
        frames.append(tuple(a.clip(0, 255).astype(np.uint8)
                            for a in (y, u, v)))
    return frames


def _params(cls, subme, frame_parallel):
    """IPPP at keyint 3 (a second IDR comes), scenecut 0, one reference,
    no B frames, the default partitions and chroma ME, no 8x8dct."""
    p = cls(i_width=80, i_height=64, i_keyint_max=3, i_log_level=0,
            i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = QP
    p.analyse.b_transform_8x8 = False
    p.i_scenecut_threshold = 0
    p.analyse.i_subpel_refine = subme
    p.i_frame_reference = 1
    p.i_bframe = 0
    return p


def _run(enc, frames, frame_cls):
    head = enc.headers()
    out = [enc.encode(frame_cls(*f)) for f in frames]
    out = [o for o in out if o is not None] + enc.flush()
    return head, out, enc.close()


@pytest.mark.parametrize("subme,frame_parallel", [(2, 1), (2, 3), (5, 1),
                                                  (5, 3)])
def test_subpel_ippp_matches_jax(subme, frame_parallel, monkeypatch):
    frames = _moving_frames(80, 64, 5, subme)
    jh, jout, jsum = _run(
        x264_tpu.Encoder(_params(x264_tpu.EncoderParams, subme,
                                 frame_parallel)), frames, JFrame)
    ptypes = []
    encode_p = tpipe.encode_p_cabac
    monkeypatch.setattr(tpipe, "encode_p_cabac", lambda *a, **k: (
        lambda o: ptypes.append(o["ptype"]) or o)(encode_p(*a, **k)))
    th, tout, tsum = _run(
        x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, subme,
                                       frame_parallel), device="cpu"),
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
    # the P frames split MBs into partitions
    assert len(ptypes) == 3
    assert any((pt != 0).any() for pt in ptypes)

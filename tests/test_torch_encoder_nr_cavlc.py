"""The noise reduction with a custom quant matrix under CAVLC against
x264_tpu, Encoder level (configuration B): the whole
x264_tpu_torch.Encoder(p, device="cpu") against x264_tpu.Encoder(p) with
b_cabac off, --nr 250, custom lists read from a JM-format file, CQP 26,
one reference and i_frame_parallel 3, over six 94x70 frames with an IDR
at frame 3: with the pipe three deep, a P frame is queued with the
offsets of the P frames finished before it (the delayed update). The
port must agree frame by frame: headers (the PPS's scaling lists),
frame types, payloads and recons, the NR offsets after every returned
frame, and tests/refdec closure.

The same parameters at i_mb_row_shards 2 hold the one-device fallback:
x264_tpu, with jax.devices giving it one device, logs "mb-row sharding
unavailable ..." and encodes unsharded; the port, on its one device,
must log the same line and give the same bytes (x264_tpu's programs are
the ones of the first run, compiled once in this file)."""

import jax
import numpy as np
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu import log as jlog
from x264_tpu.encoder.core import Frame as JFrame
from x264_tpu_torch import log as tlog
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H, N = 94, 70, 6
TYPES = ["IDR", "P", "P", "IDR", "P", "P"]
SECTIONS = (("INTRA4X4_LUMA", 16), ("INTRA4X4_CHROMA", 16),
            ("INTER4X4_LUMA", 16), ("INTER4X4_CHROMA", 16))


def _frames():
    """A textured picture that pans with fresh noise each frame."""
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:H + 8, 0:W + 16]
    tex = ((xx * 5 + yy * 9) % 71) * 3 + rng.integers(0, 50, xx.shape)
    cy, cx = np.mgrid[0:(H + 1) // 2, 0:(W + 1) // 2]
    out = []
    for t in range(N):
        y = tex[4:4 + H, 2 * t:2 * t + W] + rng.integers(0, 12, (H, W))
        u = 120 + (cx + 2 * t) // 3 + rng.integers(0, 4, cx.shape)
        v = 140 - (cy + t) // 3
        out.append(tuple(np.clip(c, 0, 255).astype(np.uint8)
                         for c in (y, u, v)))
    return out


def _cqm_file(path):
    rng = np.random.default_rng(4)
    lines = []
    for name, n in SECTIONS:
        vals = rng.integers(4, 64, n)
        vals[0] = 1
        lines += [f"{name} =", ", ".join(str(v) for v in vals)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _params(cls, cqm, shards=1):
    p = cls(i_width=W, i_height=H, i_log_level=2, b_cabac=False,
            i_frame_parallel=3, i_keyint_max=3, i_scenecut_threshold=0,
            i_frame_reference=1, i_bframe=0, i_mb_row_shards=shards,
            psz_cqm_file=cqm)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 26
    p.analyse.i_noise_reduction = 250
    return p


def _run(enc, frames, frame_cls):
    head, out, offs = enc.headers(), [], []
    for f in frames:
        o = enc.encode(frame_cls(*f))
        if o is not None:
            out.append(o)
            offs.append(enc._nr_off[0].copy())
    for o in enc.flush():
        out.append(o)
        offs.append(enc._nr_off[0].copy())
    return head, out, offs


def _logged(pkg_log, make):
    """(the object make() returns, the info lines logged meanwhile)"""
    lines = []
    pkg_log.set_log_callback(lambda lvl, msg: lines.append(msg))
    try:
        return make(), lines
    finally:
        pkg_log.set_log_callback(None)


def test_nr_custom_cqm_cavlc_and_shard_fallback(tmp_path, monkeypatch):
    frames = _frames()
    cqm = _cqm_file(tmp_path / "m.cfg")
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, cqm))
    assert jenc._nr and not jenc._t8
    jh, jout, joffs = _run(jenc, frames, JFrame)
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, cqm),
                                  device="cpu")
    th, tout, toffs = _run(tenc, frames, x264_tpu_torch.Frame)
    assert th == jh
    assert [j.frame_type for j in jout] == TYPES
    assert [t.frame_type for t in tout] == TYPES
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t.payload == j.payload, i
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    assert any(o.any() for o in toffs)
    for jo, to in zip(joffs, toffs):
        np.testing.assert_array_equal(jo, to)
    decoded = decode_annexb(th + b"".join(t.payload for t in tout))
    assert len(decoded) == N
    for d, t in zip(decoded, tout):
        for pl in "yuv":
            np.testing.assert_array_equal(
                np.asarray(getattr(d, pl), np.int64),
                getattr(t.recon, pl).numpy().astype(np.int64))

    # i_mb_row_shards 2 on one device: the fallback line and the same bytes
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
    jenc2, jlines = _logged(jlog, lambda: x264_tpu.Encoder(
        _params(x264_tpu.EncoderParams, cqm, shards=2)))
    assert jenc2._rows_mesh is None and jenc2._nr
    tenc2, tlines = _logged(tlog, lambda: x264_tpu_torch.Encoder(
        _params(x264_tpu_torch.EncoderParams, cqm, shards=2), device="cpu"))
    want = "mb-row sharding unavailable (shards=2, mb_h=5); " \
        "encoding unsharded"
    assert want in jlines and want in tlines
    jh2, jout2, _ = _run(jenc2, frames, JFrame)
    th2, tout2, _ = _run(tenc2, frames, x264_tpu_torch.Frame)
    assert th2 == jh2
    assert [t.payload for t in tout2] == [j.payload for j in jout2]
    assert [t.payload for t in tout2] == [t.payload for t in tout]

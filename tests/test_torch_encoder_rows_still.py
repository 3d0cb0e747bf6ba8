"""MB-row sharding against x264_tpu, Encoder level: B frames whose
colocated blocks are still (a panning block over a still noise
background, CABAC at CQP 26, B runs of 2 at b-adapt 0, 4 bands of 2 MB
rows). x264_tpu's band programs return no colocated maps, so its sharded
B frames' spatial direct reads all-intra ones where a decoder reads the
L1 P frame's (colZeroFlag), and tests/refdec decodes some of its B
frames to other pictures than its recons. The port keeps each band P
frame's maps: its stream decodes to its recons, its I and P frames equal
x264_tpu's, and with the band maps dropped its whole stream is
x264_tpu's, so the maps are the only difference."""

import numpy as np
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder.core import Frame as JFrame
from x264_tpu_torch.parallel import rows as trows
import test_torch_encoder_rows as base

W = H = 128


def _still_clip(n: int):
    rng = np.random.default_rng(1)
    tex = rng.integers(0, 256, (H + 64, W + 64)).astype(np.uint8)
    bg = rng.integers(0, 256, (H, W)).astype(np.uint8)
    out = []
    for t in range(n):
        y = bg.copy()
        y[32:96, 16:112] = tex[2 * t:2 * t + 64, 3 * t:3 * t + 96]
        out.append((y, np.full((H // 2, W // 2), 120, np.uint8),
                    np.full((H // 2, W // 2), 130, np.uint8)))
    return out


def _make(cls):
    p = cls(i_width=W, i_height=H, b_cabac=True, i_log_level=0,
            i_keyint_max=8, i_mb_row_shards=4, i_bframe=2,
            i_scenecut_threshold=0)
    p.i_bframe_adaptive = 0
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = 26
    p.analyse.i_subpel_refine = 5
    return p


def _mis_decoded(head: bytes, out, plane) -> list:
    dec = base.decode_annexb(head + b"".join(o.payload for o in out))
    return [i for i, (d, o) in enumerate(zip(dec, out))
            if any((np.asarray(getattr(d, pl)) != plane(getattr(o.recon, pl)))
                   .any() for pl in "yuv")]


def test_b_frames_read_the_bands_colocated_maps(monkeypatch):
    frames = _still_clip(7)
    jh, jout, _, jqps = base._run(x264_tpu.Encoder(_make(
        x264_tpu.EncoderParams)), frames, JFrame)

    def port():
        return base._run(x264_tpu_torch.Encoder(
            _make(x264_tpu_torch.EncoderParams), device=["cpu"] * 4),
            frames, x264_tpu_torch.Frame)

    th, tout, _, tqps = port()
    types = [t.frame_type for t in tout]
    assert types == ["IDR", "P", "B", "B", "P", "B", "B"]
    assert th == jh and tqps == jqps
    ref = [i for i, t in enumerate(types) if t != "B"]
    base._same_frames([jout[i] for i in ref], [tout[i] for i in ref], 4)
    base._decodes(th, tout)
    bad = _mis_decoded(jh, jout, np.asarray)
    assert bad and all(types[i] == "B" for i in bad)
    assert any(jout[i].payload != tout[i].payload for i in bad)

    # the band P frames' maps dropped: x264_tpu's all-intra ones, its bytes
    def no_maps(*a, **k):
        return [{key: v for key, v in r.items() if key not in ("ref4", "mv4")}
                for r in p_rows(*a, **k)]

    p_rows = trows.encode_p_rows_cabac
    monkeypatch.setattr(trows, "encode_p_rows_cabac", no_maps)
    th2, tout2, _, _ = port()
    assert th2 == jh
    base._same_frames(jout, tout2, 4)
    assert _mis_decoded(th2, tout2, torch.Tensor.numpy) == bad

"""The scenecut lookahead of the subme-6 slice against x264_tpu, function
level: lowres_planes and intra_cost_plane at odd and even frame sizes,
inter_cost_plane at r = 4 and r = 8 (every block, the border blocks whose
half-pel window dynamic_slice wraps included), analyse_fused's two sums on
the first frame and against a previous one, and RateControl.analyse_frame's
scenecut verdicts over a sequence with one cut, at every regime of the
bias ramp. Exact throughout; inputs from numpy seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder import lookahead as jla
from x264_tpu.encoder import ratecontrol as jrc
from x264_tpu_torch.encoder import lookahead as tla
from x264_tpu_torch.encoder import ratecontrol as trc

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a, np.int32))


def _texture(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
            + rng.integers(0, 40, (h, w))).clip(0, 255)


def _pair(seed, h, w, dy, dx):
    """A textured previous frame and the current one moved by (dy, dx)
    full-resolution samples, with light noise."""
    rng = np.random.default_rng(seed)
    big = _texture(rng, h + 64, w + 64)
    prev = big[32:32 + h, 32:32 + w]
    cur = big[32 - dy:32 - dy + h, 32 - dx:32 - dx + w] \
        + rng.integers(-2, 3, (h, w))
    return [np.clip(a, 0, 255).astype(np.uint8) for a in (prev, cur)]


@pytest.mark.parametrize("h,w", [(64, 80), (70, 94), (69, 95)])
def test_lowres_and_intra_planes_match_jax(h, w):
    y = np.random.default_rng(h).integers(0, 256, (h, w)).astype(np.uint8)
    want = np.asarray(jla.lowres_planes(jnp.asarray(y)))
    # from an MB-aligned upload, whose first h x w samples are the frame
    padded = np.pad(y, ((0, -h % 16), (0, -w % 16)), mode="edge")
    got = tla.lowres_planes(T(padded), h, w)
    np.testing.assert_array_equal(want, got.numpy())
    bh, bw = tla.block_grid(h, w)
    np.testing.assert_array_equal(
        np.asarray(jla.intra_cost_plane(jnp.asarray(want[0]), bh, bw)),
        tla.intra_cost_plane(got[0], bh, bw).numpy())


@pytest.mark.parametrize("r", [4, 8])
def test_inter_cost_plane_matches_jax(r):
    """The current lowres plane is the previous one moved down-right by r
    samples with its edge repeated. At r = 4 the blocks of row 0 and
    column 0 find their match at -r, where the half-pel window starts at
    -1 (dynamic_slice counts it from the end, then clamps); at r = 8 their
    8 rows or columns are all the repeated edge."""
    h, w = 64, 80
    prev, _ = _pair(r, h, w, 0, 0)
    lp = np.asarray(jla.lowres_planes(jnp.asarray(prev)))
    rows = np.maximum(np.arange(h // 2) - r, 0)
    cols = np.maximum(np.arange(w // 2) - r, 0)
    lc = lp[0][rows][:, cols]
    bh, bw = tla.block_grid(h, w)
    jc, jm = jla.inter_cost_plane(jnp.asarray(lc), jnp.asarray(lp), bh, bw, r)
    tc, tm = tla.inter_cost_plane(T(lc), T(lp), bh, bw, r)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    # the wrapped window occurred: border blocks at full-pel -r
    if r == 4:
        assert (tm[0, :, 1] <= -7).any() and (tm[:, 0, 0] <= -7).any()


@pytest.mark.parametrize("motion", [(2, -4), (30, -30)])
def test_analyse_fused_sums_match_jax(motion):
    h, w = 70, 94
    prev, cur = _pair(1, h, w, *motion)
    bh, bw = tla.block_grid(h, w)
    jl0, js0 = jla.analyse_fused(jnp.asarray(prev.ravel()), h, w, None,
                                 None, bh, bw, 8)
    tl0, ts0 = tla.analyse(T(prev), h, w, None, 8)
    np.testing.assert_array_equal(np.asarray(jl0), tl0.numpy())
    np.testing.assert_array_equal(np.asarray(js0), ts0.numpy())
    assert ts0[0] == ts0[1] > 0
    _, js1 = jla.analyse_fused(jnp.asarray(cur.ravel()), h, w, jl0, True,
                               bh, bw, 8)
    _, ts1 = tla.analyse(T(cur), h, w, tl0, 8)
    np.testing.assert_array_equal(np.asarray(js1), ts1.numpy())
    assert ts1[1] <= ts1[0]


def _params(cls):
    p = cls(i_width=80, i_height=64, i_keyint_max=12, i_log_level=0)
    p.rc.i_rc_method = 0
    p.i_keyint_min = 4
    return p.validate()


def test_analyse_frame_verdicts_match_jax():
    """Frames 0-4 pan one picture, frame 5 cuts to another, frames 6-7 pan
    that one; each frame is analysed at every regime of the bias ramp
    (gop_size None, below kmin / 4, up to kmin, between kmin and kmax,
    beyond kmax) from the same previous frame."""
    rng = np.random.default_rng(5)
    a, b = _texture(rng, 96, 112), 255 - _texture(rng, 96, 112)
    frames = [np.clip((a if t < 5 else b)[t:t + 64, 2 * t:2 * t + 80]
                      + rng.integers(0, 20, (64, 80)), 0, 255)
              .astype(np.uint8) for t in range(8)]
    gops = (None, 0, 2, 4, 8, 13)
    verdicts = {}
    for g in gops:
        jr = jrc.RateControl(_params(x264_tpu.EncoderParams))
        tr = trc.RateControl(_params(x264_tpu_torch.EncoderParams))
        for t, f in enumerate(frames):
            jo = jr.analyse_frame(f, gop_size=g)
            to = tr.analyse_frame(T(f), 64, 80, g)
            assert to == {k: jo[k] for k in ("scenecut", "icost", "pcost")}
            verdicts[g, t] = to["scenecut"]
    assert not any(verdicts[g, 0] for g in gops)
    # the cut is called at every bias; the pans at none but the largest
    assert all(verdicts[g, 5] for g in gops)
    assert not any(verdicts[g, t] for g in gops if g is not None
                   and g <= 4 for t in (1, 2, 3, 4, 6, 7))

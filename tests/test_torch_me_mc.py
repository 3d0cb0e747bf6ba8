"""The port's full-pel motion search, motion-compensation fetches and DCT
decimation score against x264_tpu's: hier_search on a displaced
reference (and with predictors beyond the window clamp), mc_luma at
full-pel over a real hpel_planes stack, mc_chroma at all 64 eighth-pel
phases, and decimate_score. Inputs are made with numpy from a seed and
fed to both packages; every output is an integer and must be exactly
equal."""

import numpy as np
import pytest
import torch

from x264_tpu.ops import mc as jmc
from x264_tpu.ops import me as jme
from x264_tpu.ops import quant as jquant
from x264_tpu_torch.ops import mc as tmc
from x264_tpu_torch.ops import me as tme
from x264_tpu_torch.ops import quant as tquant

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _planes(mb_h, mb_w, seed, shift):
    """A textured reference and the current frame: the reference moved by
    `shift` (dy, dx) plus noise."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[0:h, 0:w]
    ref = ((xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
           + rng.integers(0, 40, (h, w))).clip(0, 255)
    cur = (np.roll(ref, shift, (0, 1)) + rng.integers(-4, 5, (h, w))) \
        .clip(0, 255)
    return cur.astype(np.int32), ref.astype(np.int32)


@pytest.mark.parametrize("shift,mvp_kind,R,flat", [
    ((3, -5), "random", 16, False), ((-7, 9), "zero", 16, False),
    ((1, 2), "beyond_clamp", 16, False), ((2, -3), "random", 4, False),
    ((-9, 6), "random", 24, False), ((0, 0), "zero", 16, True),
    ((0, 0), "random", 24, True)],
    ids=["shift0-random", "shift1-zero", "shift2-beyond_clamp", "r4",
         "r24", "flat-r16", "flat-r24"])
def test_hier_search_matches_jax(shift, mvp_kind, R, flat):
    """R 4, 16 and 24 (the coarse radius rq 3, 9 and 13); on a flat
    reference every candidate's SAD is equal and the cost ties between
    MVs of equal bits, where the first in x264_tpu's order wins."""
    mb_h, mb_w, lam = 3, 4, 4
    cur, ref = _planes(mb_h, mb_w, 11, shift)
    if flat:
        ref = np.full_like(ref, 117)
    rng = np.random.default_rng(5)
    mvp = {"random": rng.integers(-40, 41, (mb_h, mb_w, 2)),
           "zero": np.zeros((mb_h, mb_w, 2)),
           # (mvp + 2) >> 2 far past +-min(R, PAD - m - 1): the window
           # centre clamps
           "beyond_clamp": rng.choice([-1, 1], (mb_h, mb_w, 2))
           * rng.integers(100, 160, (mb_h, mb_w, 2))}[mvp_kind] \
        .astype(np.int32)
    ref_pad = np.asarray(jmc.pad_plane(ref))
    jmv, jsad = jme.hier_search(cur, ref_pad, mb_h, mb_w, R, lam, mvp)
    tmv, tsad = tme.hier_search(T(cur), tmc.pad_plane(T(ref)), mb_h, mb_w,
                                R, lam, T(mvp))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsad), tsad.numpy())
    assert (tmv.numpy() % 4 == 0).all()          # full-pel, in qpel units
    if flat:
        return
    # the search beats the zero vector on the displaced frame
    zero_sad = np.abs(cur - ref).reshape(mb_h, 16, mb_w, 16).sum((1, 3))
    assert tsad.numpy().sum() < zero_sad.sum()


def test_se_bits_and_mv_cost_match_jax():
    v = np.arange(-300, 301, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(jme.se_bits(v)),
                                  tme.se_bits(T(v)).numpy())
    rng = np.random.default_rng(2)
    mv, mvp = rng.integers(-200, 200, (2, 50, 2)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jme.mv_cost_bits(mv, mvp)),
                                  tme.mv_cost_bits(T(mv), T(mvp)).numpy())


def test_pad_plane_matches_jax():
    rng = np.random.default_rng(3)
    p = rng.integers(0, 256, (24, 40)).astype(np.int32)
    for pad in (tmc.PAD, tmc.PAD // 2):
        np.testing.assert_array_equal(np.asarray(jmc.pad_plane(p, pad)),
                                      tmc.pad_plane(T(p), pad).numpy())


def test_mc_luma_fullpel_matches_jax():
    rng = np.random.default_rng(4)
    h, w, n = 48, 64, 40
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    stack = np.asarray(jmc.hpel_planes(jmc.pad_plane(ref)))
    ys = rng.integers(0, h // 16, n).astype(np.int32) * 16
    xs = rng.integers(0, w // 16, n).astype(np.int32) * 16
    # full-pel MVs, some far enough out that the fetch start clamps
    mvs = (rng.integers(-60, 61, (n, 2)) * 4).astype(np.int32)
    for bh, bw in ((16, 16), (8, 8)):
        j = np.asarray(jmc.mc_luma(stack, ys, xs, mvs, bh, bw))
        t4 = tmc.mc_luma(T(stack), T(ys), T(xs), T(mvs), bh, bw)
        t1 = tmc.mc_luma(T(stack[:1]), T(ys), T(xs), T(mvs), bh, bw)
        np.testing.assert_array_equal(j, t4.numpy())
        np.testing.assert_array_equal(j, t1.numpy())


def test_mc_chroma_all_eighth_pel_phases_match_jax():
    rng = np.random.default_rng(6)
    h, w = 32, 40
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    padded = np.asarray(jmc.pad_plane(ref, jmc.PAD // 2))
    phases = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1) \
        .reshape(64, 2)
    whole = rng.integers(-24, 25, (64, 2))
    mvs = (whole * 8 + phases).astype(np.int32)   # luma qpel = chroma 1/8
    ys = rng.integers(0, h // 8, 64).astype(np.int32) * 8
    xs = rng.integers(0, w // 8, 64).astype(np.int32) * 8
    j = np.asarray(jmc.mc_chroma(padded, ys, xs, mvs, 8, 8))
    t = tmc.mc_chroma(T(padded), T(ys), T(xs), T(mvs), 8, 8)
    np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("C", [15, 16])
def test_decimate_score_matches_jax(C):
    rng = np.random.default_rng(C)
    lv = rng.choice([-2, -1, 0, 0, 0, 0, 0, 1, 2], (400, C)) \
        * (rng.random((400, 1)) < 0.9)
    lv = np.where(rng.random((400, 1)) < 0.5, np.clip(lv, -1, 1), lv) \
        .astype(np.int32)
    j = np.asarray(jquant.decimate_score(lv, jquant.DECIMATE_TAB4))
    t = tquant.decimate_score(T(lv))
    np.testing.assert_array_equal(j, t.numpy())
    assert tquant.DECIMATE_TAB4 == tuple(jquant.DECIMATE_TAB4)
    assert (j == 9).any() and (j == 0).any() and ((j > 0) & (j < 9)).any()

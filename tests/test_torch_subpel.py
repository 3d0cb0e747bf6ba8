"""The port's sub-pel motion search against x264_tpu's: hpel_planes on a
padded plane whose taps overshoot both ends of 0..255, the batched
sub-pel refinement at the half-pel (2,) and quarter-pel (2, 1) ladders
for 16x16, 16x8, 8x16 and 8x8 blocks (on content with flat blocks, where
many candidates tie and the candidate order decides) and on the
partition layouts of a P frame at once (subpel_refine_parts), the full-pel
partition search with and without the 8x8 quadrants, and the chroma-ME
re-rank. Inputs are made with numpy from a seed and fed to both
packages; every output is an integer and must be exactly equal."""

import numpy as np
import pytest
import torch

from x264_tpu.ops import mc as jmc
from x264_tpu.ops import me as jme
from x264_tpu_torch.ops import mc as tmc
from x264_tpu_torch.ops import me as tme

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
MB_H, MB_W = 3, 4
LAM = 4


def _content(seed, flat):
    """A reference with texture and the source: the reference moved by a
    non-integer amount (a half-pel average of two shifts) plus noise. Or,
    flat: 8x8 blocks of one value with a few bright dots, and the source
    the reference itself, so that flat blocks tie at SATD 0 over many
    candidates."""
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    if flat:
        ref = np.repeat(np.repeat(rng.choice([40, 41, 120, 200],
                                             (h // 8, w // 8)), 8, 0), 8, 1)
        ref = np.where(rng.random((h, w)) < 0.02, 255, ref)
    else:
        ref = ((xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
               + rng.integers(0, 40, (h, w)))
    ref = ref.clip(0, 255)
    if flat:
        return ref.astype(np.int32), ref.astype(np.int32)
    cur = (np.roll(ref, (2, -3), (0, 1)) + np.roll(ref, (2, -2), (0, 1)) + 1) \
        // 2 + rng.integers(-3, 4, (h, w))
    return cur.clip(0, 255).astype(np.int32), ref.astype(np.int32)


def _planes(ref):
    pad = np.asarray(jmc.pad_plane(ref))
    return pad, np.asarray(jmc.hpel_planes(pad))


def test_hpel_planes_matches_jax_and_clips():
    rng = np.random.default_rng(1)
    # alternating extremes: the 6-tap overshoots below 0 and above 255
    p = np.where(rng.random((40, 52)) < 0.5, 0, 255)
    p[::3] = rng.integers(0, 256, (p[::3].shape))
    j = np.asarray(jmc.hpel_planes(p.astype(np.int32)))
    t = tmc.hpel_planes(T(p))
    np.testing.assert_array_equal(j, t.numpy())
    assert (j[1:] == 0).any() and (j[1:] == 255).any()


# (bh, bw) -> the block offsets inside the MB that x264_tpu refines
LAYOUTS = {(16, 16): [(0, 0)], (8, 16): [(0, 0), (8, 0)],
           (16, 8): [(0, 0), (0, 8)],
           (8, 8): [(0, 0), (0, 8), (8, 0), (8, 8)]}
# the partition layouts in the order of partition_fullpel's rows
LAYOUTS_PARTS = ((8, 16), (16, 8), (8, 8))


@pytest.mark.parametrize("steps", [(2,), (2, 1)], ids=["hpel", "qpel"])
@pytest.mark.parametrize("bh,bw", list(LAYOUTS), ids=lambda v: str(v))
@pytest.mark.parametrize("flat", [False, True], ids=["texture", "flat"])
def test_subpel_refine_blocks_matches_jax(steps, bh, bw, flat):
    cur, ref = _content(bh * 3 + bw, flat)
    _, planes = _planes(ref)
    rng = np.random.default_rng(bw)
    offs = LAYOUTS[(bh, bw)]
    n = len(offs)
    gy = np.arange(MB_H)[:, None] * 16 + np.zeros((1, MB_W), int)
    gx = np.arange(MB_W)[None, :] * 16 + np.zeros((MB_H, 1), int)
    ys = np.stack([gy + oy for oy, _ in offs]).astype(np.int32)
    xs = np.stack([gx + ox for _, ox in offs]).astype(np.int32)
    mv = (rng.integers(-1 if flat else -3, 2 if flat else 4,
                       (n, MB_H, MB_W, 2)) * 4).astype(np.int32)
    mvp = rng.integers(-12, 13, (n, MB_H, MB_W, 2)).astype(np.int32)
    cur_blocks = np.stack([cur[y:y + bh, x:x + bw] for y, x in
                           zip(ys.reshape(-1), xs.reshape(-1))]) \
        .reshape(n, MB_H, MB_W, bh, bw)
    jmv, jsatd = jme.subpel_refine_blocks(cur_blocks, planes, mv, LAM, mvp,
                                          ys, xs, bh, bw, steps)
    tmv, tsatd = tme.subpel_refine_blocks(T(cur), T(planes), T(mv), LAM,
                                          T(mvp), T(ys), T(xs), bh, bw, steps)
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())
    frac = tmv.numpy() & 3
    assert (frac != 0).any()                     # sub-pel winners exist
    if steps == (2,):
        assert (frac % 2 == 0).all()             # half-pel only
    if flat:
        # ties: the flat blocks' candidates share one SATD, so the order
        # and the mv bits decide
        assert (tsatd.numpy() == 0).any()


@pytest.mark.parametrize("p8x8", [False, True], ids=["parts4", "parts8"])
def test_subpel_refine_parts_matches_jax(p8x8):
    """The one-launch partition refinement's CPU path (the plain version
    once per layout) against x264_tpu's subpel_refine_blocks on each
    layout's rows, every block of an MB with the MB's predictor."""
    cur, ref = _content(5, False)
    _, planes = _planes(ref)
    rng = np.random.default_rng(5)
    nk = 8 if p8x8 else 4
    mv = (rng.integers(-3, 4, (nk, MB_H, MB_W, 2)) * 4).astype(np.int32)
    mvp = rng.integers(-12, 13, (MB_H, MB_W, 2)).astype(np.int32)
    got = tme.subpel_refine_parts(T(cur), T(planes), T(mv), LAM, T(mvp),
                                  (2, 1))
    assert len(got) == nk // 4 + 1
    row = 0
    for (bh, bw), (tmv, tsatd) in zip(LAYOUTS_PARTS, got):
        offs = LAYOUTS[(bh, bw)]
        n = len(offs)
        gy = np.arange(MB_H)[:, None] * 16 + np.zeros((1, MB_W), int)
        gx = np.arange(MB_W)[None, :] * 16 + np.zeros((MB_H, 1), int)
        ys = np.stack([gy + oy for oy, _ in offs]).astype(np.int32)
        xs = np.stack([gx + ox for _, ox in offs]).astype(np.int32)
        cur_blocks = np.stack([cur[y:y + bh, x:x + bw] for y, x in
                               zip(ys.reshape(-1), xs.reshape(-1))]) \
            .reshape(n, MB_H, MB_W, bh, bw)
        jmv, jsatd = jme.subpel_refine_blocks(
            cur_blocks, planes, mv[row:row + n], LAM,
            np.broadcast_to(mvp, (n, MB_H, MB_W, 2)), ys, xs, bh, bw, (2, 1))
        np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
        np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())
        row += n


def test_subpel_refine_16x16_matches_jax():
    cur, ref = _content(7, False)
    _, planes = _planes(ref)
    rng = np.random.default_rng(7)
    mv = (rng.integers(-2, 3, (MB_H, MB_W, 2)) * 4).astype(np.int32)
    mvp = rng.integers(-9, 10, (MB_H, MB_W, 2)).astype(np.int32)
    tiles = cur.reshape(MB_H, 16, MB_W, 16).swapaxes(1, 2)
    jmv, jsatd = jme.subpel_refine(tiles, planes, mv, LAM, mvp, (2, 1))
    tmv, tsatd = tme.subpel_refine(T(cur), T(planes), T(mv), LAM, T(mvp),
                                   (2, 1))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())


@pytest.mark.parametrize("with_8x8", [False, True])
@pytest.mark.parametrize("mv_kind", ["near", "beyond_clamp"])
def test_partition_fullpel_matches_jax(with_8x8, mv_kind):
    cur, ref = _content(3, False)
    # per-quadrant motion: each 8x8 quadrant of the source comes from
    # its own displacement of the reference
    rng = np.random.default_rng(3)
    for qy in range(0, MB_H * 16, 8):
        for qx in range(0, MB_W * 16, 8):
            dy, dx = rng.integers(-3, 4, 2)
            ys = np.clip(np.arange(qy, qy + 8) + dy, 0, MB_H * 16 - 1)
            xs = np.clip(np.arange(qx, qx + 8) + dx, 0, MB_W * 16 - 1)
            cur[qy:qy + 8, qx:qx + 8] = ref[np.ix_(ys, xs)]
    ref_pad, _ = _planes(ref)
    R = 16
    if mv_kind == "near":
        mv16 = rng.integers(-2, 3, (MB_H, MB_W, 2)) * 4
    else:
        mv16 = rng.choice([-1, 1], (MB_H, MB_W, 2)) * 4 * 40 + 1
    mv16 = mv16.astype(np.int32)
    mvp = rng.integers(-20, 21, (MB_H, MB_W, 2)).astype(np.int32)
    tiles = cur.reshape(MB_H, 16, MB_W, 16).swapaxes(1, 2)
    j = jme.partition_fullpel(tiles, ref_pad, mv16, LAM, mvp, R,
                              with_8x8=with_8x8)
    t = tme.partition_fullpel(T(cur), T(ref_pad), T(mv16), LAM, T(mvp), R,
                              with_8x8)
    keys = tme.PART_KEYS[:8 if with_8x8 else 4]
    assert tuple(j.keys()) == keys and t.shape[0] == len(keys)
    for k, tk in zip(keys, t):
        np.testing.assert_array_equal(np.asarray(j[k]), tk.numpy(),
                                      err_msg=k)
    # the partitions chose different MVs within an MB
    assert (t[0] != t[1]).any() and (t[2] != t[3]).any()


def test_chroma_rerank_matches_jax():
    cur, ref = _content(11, False)
    _, planes = _planes(ref)
    rng = np.random.default_rng(11)
    h, w = MB_H * 8, MB_W * 8
    ref_u = rng.integers(0, 256, (h, w))
    ref_v = (ref_u // 2 + rng.integers(0, 90, (h, w))).clip(0, 255)
    cur_u = (np.roll(ref_u, (1, -1), (0, 1)) + rng.integers(-6, 7, (h, w))) \
        .clip(0, 255).astype(np.int32)
    cur_v = np.roll(ref_v, (1, 0), (0, 1)).astype(np.int32)
    cu_pad = np.asarray(jmc.pad_plane(ref_u.astype(np.int32), jmc.PAD // 2))
    cv_pad = np.asarray(jmc.pad_plane(ref_v.astype(np.int32), jmc.PAD // 2))
    mv = rng.integers(-9, 10, (MB_H, MB_W, 2)).astype(np.int32)
    mvp = rng.integers(-9, 10, (MB_H, MB_W, 2)).astype(np.int32)
    tiles = cur.reshape(MB_H, 16, MB_W, 16).swapaxes(1, 2)
    ut = cur_u.reshape(MB_H, 8, MB_W, 8).swapaxes(1, 2)
    vt = cur_v.reshape(MB_H, 8, MB_W, 8).swapaxes(1, 2)
    ys = (np.arange(MB_H)[:, None] * 16 + np.zeros((1, MB_W), int)) \
        .astype(np.int32)
    xs = (np.arange(MB_W)[None, :] * 16 + np.zeros((MB_H, 1), int)) \
        .astype(np.int32)
    from x264_tpu.ops import pixel as jpix
    center = np.asarray(jpix.satd(tiles, jmc.mc_luma(planes, ys, xs, mv, 16,
                                                     16)))
    jmv, jsatd = jme.chroma_rerank(tiles, planes, ut, vt, cu_pad, cv_pad, mv,
                                   LAM, mvp, center_satd=center)
    tmv, tsatd = tme.chroma_rerank(T(cur), T(planes), T(cur_u), T(cur_v),
                                   T(cu_pad), T(cv_pad), T(mv), LAM, T(mvp),
                                   T(center))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())
    assert (tmv.numpy() != mv).any()             # the chroma term moved some

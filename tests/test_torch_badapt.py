"""The b-adapt lookahead of the B slice against x264_tpu, function level:
the four lowres programs that type B frames and seed their motion search
(badapt_first_fused, badapt_ext_fused, b_seed_mvs_fused, b_cost_fused),
each through the plain version of K21 (lowres_bcost_plain), and
_fetch_blocks, at a lowres size with border blocks (whose MVs reach the
clip at +-r and the edge of the plane), at an odd frame size (edge-padded
blocks) and on a frame of 2 x 2 blocks (no border ring left out). Exact
throughout; inputs from numpy seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from x264_tpu.encoder import lookahead as jla
from x264_tpu_torch.encoder import lookahead as tla

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a, np.int32))


def _texture(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
            + rng.integers(0, 40, (h, w))).clip(0, 255)


def _clip(seed, h, w, shifts):
    """Full-resolution luma frames of one texture moved by each (dy, dx),
    with light noise, and their lowres planes (x264_tpu's)."""
    rng = np.random.default_rng(seed)
    big = _texture(rng, h + 128, w + 128)
    out = []
    for dy, dx in shifts:
        f = big[64 - dy:64 - dy + h, 64 - dx:64 - dx + w] \
            + rng.integers(-3, 4, (h, w))
        f = np.clip(f, 0, 255).astype(np.uint8)
        out.append(np.asarray(jla.lowres_planes(jnp.asarray(f))))
    return out


SIZES = [(64, 96, 4, 0), (70, 94, 8, 1), (32, 32, 4, 2)]


@pytest.mark.parametrize("h,w,r,seed", SIZES)
def test_badapt_programs_match_jax(h, w, r, seed):
    """A pan of 3 / 5 samples a frame, then a jump of 2 r: the lowres MVs
    reach +-r and the fetched blocks the plane's edge."""
    l0, l1, l2, l3 = _clip(seed, h, w, [(0, 0), (3, 5), (6, 10),
                                        (6 + 4 * r, 10 - 4 * r)])
    bh, bw = (h + 15) // 16, (w + 15) // 16
    J = lambda *a: [np.asarray(x) for x in a]
    jf = np.asarray(jla.badapt_first_fused(jnp.asarray(l1), jnp.asarray(l2),
                                           jnp.asarray(l0), bh, bw, r))
    np.testing.assert_array_equal(
        jf, tla.badapt_first(T(l1), T(l2), T(l0), bh, bw, r).numpy())
    for a, b in ((l2, l0), (l3, l1)):
        je = np.asarray(jla.badapt_ext_fused(jnp.asarray(a), jnp.asarray(b),
                                             bh, bw, r))
        np.testing.assert_array_equal(
            je, tla.badapt_ext(T(a), T(b), bh, bw, r).numpy())
    for b, p0, p1 in ((l1, l0, l2), (l2, l0, l3)):
        js = J(*jla.b_seed_mvs_fused(jnp.asarray(b), jnp.asarray(p0),
                                     jnp.asarray(p1), bh, bw, r))
        ts = tla.b_seed_mvs(T(b), T(p0), T(p1), bh, bw, r)
        for j, t in zip(js, ts):
            np.testing.assert_array_equal(j, t.numpy())
        jc = np.asarray(jla.b_cost_fused(jnp.asarray(b), jnp.asarray(p0),
                                         jnp.asarray(p1), bh, bw, r))
        np.testing.assert_array_equal(
            jc, tla.b_cost(T(b), T(p0), T(p1), bh, bw, r).numpy())
    # the border blocks' MVs reach the clip at the jump
    _, m0, _ = tla.lowres_bcost_plain(T(l3), T(l1), None, bh, bw, r, False)
    assert (m0.abs() >= 2 * r - 1).any()


def test_fetch_blocks_match_jax():
    """_fetch_blocks at half-pel MVs beyond the clip in every direction
    and in every phase."""
    h, w, r = 35, 47, 4
    bh, bw = (2 * h + 15) // 16, (2 * w + 15) // 16
    rng = np.random.default_rng(5)
    planes = rng.integers(0, 256, (4, h, w)).astype(np.int32)
    mv = rng.integers(-4 * r, 4 * r + 1, (bh, bw, 2)).astype(np.int32)
    want = np.asarray(jla._fetch_blocks(jnp.asarray(planes), jnp.asarray(mv),
                                        bh, bw, r))
    np.testing.assert_array_equal(
        want, tla.fetch_blocks(T(planes), T(mv), bh, bw, r).numpy())

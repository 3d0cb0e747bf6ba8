"""Rows 26b, 15c and 18c against x264_tpu: the plain versions of K29
fullpel_search (R = 4, and R = 40 past the 32-sample pad, where
dynamic_slice clamps the windows; on noise, on a flat reference where
the SADs tie, with a nonzero predictor), K30 hadamard_ac (8x8, 16x16,
8x16 and 16x8 tiles with leading shapes, pixels, residuals and values
whose sums wrap int32), lowres_plane and frame_cost_sums. Every output
is integer and must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu.encoder import lookahead as jla
from x264_tpu.ops import mc as jmc
from x264_tpu.ops import me as jme
from x264_tpu.ops import pixel as jpix
from x264_tpu_torch.encoder import lookahead as tla
from x264_tpu_torch.ops import mc as tmc
from x264_tpu_torch.ops import me as tme
from x264_tpu_torch.ops import pixel as tpix

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

MB_H, MB_W = 2, 3


def _cur_ref(seed, flat):
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    cur = ((xx * 5 + yy * 3) % 200 + rng.integers(0, 50, (h, w))) \
        .astype(np.int32)
    ref = np.full_like(cur, 77) if flat \
        else np.roll(cur, (2, -3), (0, 1)) + rng.integers(0, 6, (h, w))
    return cur, ref.astype(np.int32)


# one jitted search per range, as x264_tpu's callers run it
_JIT = {}


def _jax_fullpel(cur, ref_pad, r, lam, mvp):
    if r not in _JIT:
        _JIT[r] = jax.jit(lambda c, p, l, m: jme.fullpel_search(
            c, p, MB_H, MB_W, r, l, m))
    return _JIT[r](cur, ref_pad, jnp.int32(lam), mvp)


@pytest.mark.parametrize("r,flat,mvp_seed,lam", [
    (4, False, None, 4), (4, True, 1, 4), (40, False, 2, 4),
    (40, True, 3, 4), (40, False, -160, 3000), (40, False, 160, 3000)])
def test_fullpel_search_matches_jax(r, flat, mvp_seed, lam):
    """mvp_seed: a seed of random predictors, or one far predictor (+-160
    qpel, +-40 samples) that a large lambda makes win, so that the
    winner's SAD is read at the clamped (and, for negative starts,
    end-counted) window."""
    cur, ref = _cur_ref(r + int(flat), flat)
    mvp = np.zeros((MB_H, MB_W, 2), np.int32) if mvp_seed is None else \
        np.full((MB_H, MB_W, 2), mvp_seed, np.int32) if abs(mvp_seed) > 100 \
        else np.random.default_rng(mvp_seed).integers(
            -60, 60, (MB_H, MB_W, 2)).astype(np.int32)
    ref_pad = np.array(jmc.pad_plane(jnp.asarray(ref)))
    assert ref_pad.shape == (MB_H * 16 + 64, MB_W * 16 + 64)
    tpad = tmc.pad_plane(torch.from_numpy(ref))
    assert torch.equal(tpad, torch.from_numpy(ref_pad))
    jmv, jsad = _jax_fullpel(cur, ref_pad, r, lam, mvp)
    tmv, tsad = tme.fullpel_search(torch.from_numpy(cur), tpad, MB_H, MB_W,
                                   r, lam, torch.from_numpy(mvp))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsad), tsad.numpy())
    if flat:
        # every candidate of an MB ties on its SAD: the MV cost decides
        flat_sad = np.abs(cur - 77).reshape(MB_H, 16, MB_W, 16).sum((1, 3))
        np.testing.assert_array_equal(tsad.numpy(), flat_sad)
    assert tmv.abs().max() <= 4 * r
    if lam > 100:
        assert (tmv == mvp_seed).all()


@pytest.mark.parametrize("shape", [(3, 8, 8), (2, 5, 16, 16), (7, 8, 16),
                                   (4, 16, 8), (16, 16)])
def test_hadamard_ac_matches_jax(shape):
    rng = np.random.default_rng(len(shape) + shape[-1] + shape[-2])
    cases = [rng.integers(0, 256, shape), rng.integers(-255, 256, shape),
             np.full(shape, 255), np.indices(shape).sum(0) % 2 * 255,
             rng.integers(-(1 << 28), 1 << 28, shape)]
    for pix in cases:
        pix = pix.astype(np.int32)
        ja, jb = jax.jit(jpix.hadamard_ac)(pix)
        ta, tb = tpix.hadamard_ac(torch.from_numpy(pix))
        assert ta.shape == shape[:-2] and tb.shape == shape[:-2]
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("h,w", [(32, 48), (31, 47), (18, 40)])
def test_lowres_plane_and_cost_sums_match_jax(h, w):
    rng = np.random.default_rng(h + w)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(jla.lowres_plane(y)),
                                  tla.lowres_plane(torch.from_numpy(y)).numpy())
    for bh, bw in ((h // 8 or 1, w // 8 or 1), (2, 5), (4, 3)):
        ic = rng.integers(0, 5000, (bh, bw)).astype(np.int32)
        pc = rng.integers(0, 5000, (bh, bw)).astype(np.int32)
        for p in (None, pc):
            want = jla.frame_cost_sums(jnp.asarray(ic), None if p is None
                                       else jnp.asarray(p))
            got = tla.frame_cost_sums(torch.from_numpy(ic), None if p is None
                                      else torch.from_numpy(p))
            assert got == want and all(type(v) is int for v in got)

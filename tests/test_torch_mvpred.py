"""The port's exact MV prediction (predict_16x16, predict_pskip, the
partition predictors predict_16x8 / predict_8x16 / predict_p8x8, and
median3) against x264_tpu/encoder/mvpred.py on random per-4x4 ref / mv
maps: intra blocks (ref -1), a second reference, zero MVs that force
P_Skip to zero, and frames of one MB row or column, where the left, top
and top-right neighbours fall outside the frame. Every output is an
integer and must be exactly equal."""

import numpy as np
import pytest
import torch

from x264_tpu.encoder import mvpred as jmv
from x264_tpu_torch.encoder import mvpred as tmv

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _maps(mb_h, mb_w, seed, refs, per_mb):
    """ref4 / mv4 maps; per_mb: constant over each MB's 16 blocks, as the
    16x16-only P slice makes them."""
    rng = np.random.default_rng(seed)
    h, w = (mb_h, mb_w) if per_mb else (mb_h * 4, mb_w * 4)
    ref = rng.choice(refs, (h, w))
    mv = rng.integers(-6, 7, (h, w, 2)) * rng.choice([0, 1, 4], (h, w, 1))
    mv = np.where((ref == -1)[..., None], 0, mv)
    if per_mb:
        ref = ref.repeat(4, 0).repeat(4, 1)
        mv = mv.repeat(4, 0).repeat(4, 1)
    return ref.astype(np.int32), mv.astype(np.int32)


@pytest.mark.parametrize("mb_h,mb_w,refs,per_mb", [
    (5, 7, (-1, 0), True), (5, 7, (-1, 0, 0, 0), True),
    (4, 6, (-1, 0, 1), False), (1, 6, (-1, 0), True), (6, 1, (-1, 0), True),
    (1, 1, (0,), True)],
    ids=["slice", "mostly-inter", "two-refs-4x4", "one-row", "one-column",
         "one-mb"])
def test_predictors_match_jax(mb_h, mb_w, refs, per_mb):
    for seed in range(3):
        ref4, mv4 = _maps(mb_h, mb_w, seed, refs, per_mb)
        j16 = np.asarray(jmv.predict_16x16(ref4, mv4))
        jsk = np.asarray(jmv.predict_pskip(ref4, mv4))
        t16 = tmv.predict_16x16(T(ref4), T(mv4))
        tsk = tmv.predict_pskip(T(ref4), T(mv4))
        np.testing.assert_array_equal(j16, t16.numpy())
        np.testing.assert_array_equal(jsk, tsk.numpy())
        if 1 in refs:
            np.testing.assert_array_equal(
                np.asarray(jmv.predict_16x16(ref4, mv4, 1)),
                tmv.predict_16x16(T(ref4), T(mv4), 1).numpy())


@pytest.mark.parametrize("mb_h,mb_w,refs", [
    (5, 7, (-1, 0)), (4, 6, (-1, 0, 0, 0, 1)), (1, 5, (-1, 0)),
    (5, 1, (-1, 0)), (1, 1, (0,))],
    ids=["4x4-maps", "two-refs", "one-row", "one-column", "one-mb"])
def test_partition_predictors_match_jax(mb_h, mb_w, refs):
    for seed in range(3):
        ref4, mv4 = _maps(mb_h, mb_w, seed, refs, False)
        for i_ref in sorted({0, *refs} - {-1}):
            for jf, tf in ((jmv.predict_16x8, tmv.predict_16x8),
                           (jmv.predict_8x16, tmv.predict_8x16),
                           (jmv.predict_p8x8, tmv.predict_p8x8)):
                j = jf(ref4, mv4, i_ref)
                t = tf(T(ref4), T(mv4), i_ref)
                assert len(j) == len(t)
                for a, b in zip(j, t):
                    np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                                  err_msg=jf.__name__)


def test_median3_matches_jax():
    rng = np.random.default_rng(9)
    a, b, c = rng.integers(-20, 21, (3, 500)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jmv.median3(a, b, c)),
                                  tmv.median3(T(a), T(b), T(c)).numpy())

"""The port's plain deblocking filter against x264_tpu's deblock_frame:
an all-intra frame (the slice's maps) and random qp / intra / nnz / ref /
mv maps, with and without the 8x8-transform edge rule. Planes must be
exactly equal."""

import numpy as np
import pytest
import torch

from x264_tpu.ops import deblock as jdeblock
from x264_tpu_torch.ops import deblock as tdeblock

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

MB_H, MB_W = 4, 5


def _case(kind, rng):
    h4, w4 = MB_H * 4, MB_W * 4
    y = (rng.integers(0, 256, (MB_H * 16, MB_W * 16)) // 8 + 100
         + np.arange(MB_W * 16)[None, :] // 3).astype(np.int32)
    u = (rng.integers(0, 256, (MB_H * 8, MB_W * 8)) // 10 + 120) \
        .astype(np.int32)
    v = (rng.integers(0, 256, (MB_H * 8, MB_W * 8)) // 10 + 100) \
        .astype(np.int32)
    z4 = np.zeros((h4, w4), np.int32)
    zmv = np.zeros((h4, w4, 2), np.int32)
    if kind == "intra":
        qp = np.full((MB_H, MB_W), 26, np.int32)
        maps = (np.ones((MB_H, MB_W), bool), z4, z4, zmv)
    else:
        qp = rng.integers(20, 46, (MB_H, MB_W)).astype(np.int32)
        maps = (rng.random((MB_H, MB_W)) < 0.3,
                rng.integers(0, 2, (h4, w4)).astype(np.int32),
                rng.integers(0, 2, (h4, w4)).astype(np.int32),
                rng.integers(-8, 8, (h4, w4, 2)).astype(np.int32))
    t8 = (rng.random((MB_H, MB_W)) < 0.5) if kind == "random_t8" else None
    return (y, u, v), (qp, *maps, z4, zmv, False, -2, 2, 1), t8


@pytest.mark.parametrize("kind", ["intra", "random", "random_t8"])
def test_deblock_matches_jax(kind):
    planes, args, t8 = _case(kind, np.random.default_rng(len(kind)))
    jo = jdeblock.deblock_frame(MB_H, MB_W, *planes, *args, t8_mb=t8)
    th = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    to = tdeblock.deblock_frame(MB_H, MB_W, *map(th, planes), *map(th, args),
                                t8_mb=th(t8))
    for j, t, src in zip(jo, to, planes):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
        assert (t.numpy() != src).any()          # the filter acted

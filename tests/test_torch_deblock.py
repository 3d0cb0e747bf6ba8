"""The port's plain deblocking filter against x264_tpu's deblock_frame:
an all-intra frame (the slice's maps) and random qp / intra / nnz / ref /
mv maps, with and without the 8x8-transform edge rule, also one MB row
and one MB column wide, and a B slice's maps (random L1 refs and MVs).
Planes must be exactly equal."""

import numpy as np
import pytest
import torch

from x264_tpu.ops import deblock as jdeblock
from x264_tpu_torch.ops import deblock as tdeblock

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

MB_H, MB_W = 4, 5


def _case(kind, rng, mb_h=MB_H, mb_w=MB_W):
    h4, w4 = mb_h * 4, mb_w * 4
    y = (rng.integers(0, 256, (mb_h * 16, mb_w * 16)) // 8 + 100
         + np.arange(mb_w * 16)[None, :] // 3).astype(np.int32)
    u = (rng.integers(0, 256, (mb_h * 8, mb_w * 8)) // 10 + 120) \
        .astype(np.int32)
    v = (rng.integers(0, 256, (mb_h * 8, mb_w * 8)) // 10 + 100) \
        .astype(np.int32)
    z4 = np.zeros((h4, w4), np.int32)
    zmv = np.zeros((h4, w4, 2), np.int32)
    if kind == "intra":
        qp = np.full((mb_h, mb_w), 26, np.int32)
        maps = (np.ones((mb_h, mb_w), bool), z4, z4, zmv)
    else:
        qp = rng.integers(20, 46, (mb_h, mb_w)).astype(np.int32)
        maps = (rng.random((mb_h, mb_w)) < 0.3,
                rng.integers(0, 2, (h4, w4)).astype(np.int32),
                rng.integers(0, 2, (h4, w4)).astype(np.int32),
                rng.integers(-8, 8, (h4, w4, 2)).astype(np.int32))
    t8 = (rng.random((mb_h, mb_w)) < 0.5) if kind == "random_t8" else None
    l1 = (z4, zmv, False)
    if kind == "b":
        l1 = (rng.integers(-1, 1, (h4, w4)).astype(np.int32),
              rng.integers(-8, 8, (h4, w4, 2)).astype(np.int32), True)
    return (y, u, v), (qp, *maps, *l1, -2, 2, 1), t8


@pytest.mark.parametrize("kind,mb_h,mb_w", [
    *(pytest.param(k, MB_H, MB_W, id=k)
      for k in ("intra", "random", "random_t8")),
    *(pytest.param(k, h, w, id=f"{k}-{h}x{w}")
      for h, w in ((1, 7), (6, 1)) for k in ("random", "random_t8")),
    pytest.param("b", MB_H, MB_W, id="b")])
def test_deblock_matches_jax(kind, mb_h, mb_w):
    planes, args, t8 = _case(kind, np.random.default_rng(len(kind)), mb_h,
                             mb_w)
    jo = jdeblock.deblock_frame(mb_h, mb_w, *planes, *args, t8_mb=t8)
    th = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    to = tdeblock.deblock_frame(mb_h, mb_w, *map(th, planes), *map(th, args),
                                t8_mb=th(t8))
    for j, t, src in zip(jo, to, planes):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
        assert (t.numpy() != src).any()          # the filter acted

"""The noise reduction of the port against x264_tpu: denoise_plain (the
shrink and the float32 |coef| sums) against x264_tpu.ops.quant.denoise,
nr_weight2, the host's offset update (Encoder._nr_update) against
x264_tpu's over several frames that cross both caps, and the inter luma
residuals (4x4 and 8x8) with offsets against x264_tpu's, at a grid where
the sums of every position pass 2^24, so that the order of the float32
additions decides the bits: the port replays the order of XLA's CPU
backend (a tree of 32 x 32-MB windows, ops/quant.py:nr_sums_plain) and
must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu import tables
from x264_tpu.encoder import inter as jinter
from x264_tpu.ops import quant as jquant
from x264_tpu_torch import convert
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.ops import quant as tquant

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


@pytest.mark.parametrize("shape,n", [((5, 6, 16), 16), ((35, 37, 16), 16),
                                     ((36, 40, 4), 64), ((3, 70, 4), 64),
                                     ((100, 40, 4), 64), ((68, 120, 16), 16),
                                     ((68, 120, 4), 64)])
def test_denoise_plain_matches_jax(shape, n):
    """Grids below, across and at odd multiples of XLA's 32-row window
    (window grids 1x1, 2x2 and 4x2, whose last reduce XLA vectorises,
    1x3, and 3x4 at 1080p's 68x120 MBs), with coefficients large enough
    that the sums pass 2^24 where the grid is large."""
    rng = np.random.default_rng(sum(shape) + n)
    coef = (rng.integers(-20000, 20000, (*shape, n))
            * (rng.random((*shape, n)) < 0.7)).astype(np.int32)
    off = rng.integers(0, 3000, n).astype(np.int32)
    jc, js = jax.jit(jquant.denoise)(coef, off)
    tc, ts = tquant.denoise_plain(T(coef), T(off))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if shape[0] * shape[1] > 1000:
        assert np.asarray(js).max() > 2 ** 24


def test_nr_weight2():
    for a, b in zip(tquant.nr_weight2(), jquant.nr_weight2()):
        np.testing.assert_array_equal(a, b)


def _encoders(nr):
    """x264_tpu's and the port's encoders with --nr nr, unopened on any
    device work (the constructors build tables only)."""
    mk = lambda cls: cls(i_width=1920, i_height=1080, i_log_level=0)
    jp, tp = mk(x264_tpu.EncoderParams), mk(x264_tpu_torch.EncoderParams)
    for p in (jp, tp):
        p.analyse.i_noise_reduction = nr
    return x264_tpu.Encoder(jp), x264_tpu_torch.Encoder(tp, device="cpu")


def test_nr_update_matches_jax():
    """Eight 1080p P frames of sums (130,560 4x4 blocks a frame: the 4x4
    count passes its 2^18 cap at the third, the 8x8's 2^16 at the second),
    from a state carried over with convert.nr_state_from_numpy."""
    jenc, tenc = _encoders(250)
    nmb = 8160
    rng = np.random.default_rng(5)
    jenc._nr_sum = [rng.random(16) * 1e6, rng.random(64) * 1e5]
    jenc._nr_cnt = [1000.0, 500.0]
    jenc._nr_off = [np.zeros(16, np.int32), np.zeros(64, np.int32)]
    for k, v in convert.nr_state_from_numpy(jenc._nr_sum, jenc._nr_cnt,
                                            jenc._nr_off).items():
        setattr(tenc, k, v)
    for f in range(8):
        s4 = (rng.random(16) * 2 ** 26).astype(np.float32)
        s8 = (rng.random(64) * 2 ** 25).astype(np.float32) if f % 3 else None
        s4[0] = 0
        jenc._nr_update(s4, s8, nmb)
        tenc._nr_update(s4, s8, nmb)
        for cat in (0, 1):
            np.testing.assert_array_equal(tenc._nr_off[cat],
                                          jenc._nr_off[cat])
            np.testing.assert_array_equal(tenc._nr_sum[cat],
                                          jenc._nr_sum[cat])
            assert tenc._nr_cnt[cat] == jenc._nr_cnt[cat]
    assert all(o.any() for o in tenc._nr_off)


MB_H, MB_W = 68, 70


def _jax_residuals(fenc, pred, off4, off8):
    qt = jinter.make_qtab_p(26, tables.chroma_qp(26))

    def f(fe, pr, o4, o8):
        q = dict(qt, nr_offset4=o4, nr_offset8=o8)
        r4 = jinter.inter_luma_residual(fe, pr, q, decimate=True)
        r8 = jinter.inter_luma_residual8(fe, pr, q, decimate=True)
        return r4, r8, q["nr_sum4"], q["nr_sum8"]

    return jax.jit(f)(fenc, pred, off4, off8), qt


def test_inter_residuals_with_offsets_match_jax():
    """Max-range residuals over a 68x70-MB grid (a 3 x 3 tree of XLA
    windows, padded 14 + 14 and 13 + 13): every 4x4 sum and some 8x8 sums
    pass 2^24, and the order shows in their low bits."""
    rng = np.random.default_rng(3)
    fenc = rng.integers(0, 256, (MB_H, MB_W, 16, 16)).astype(np.int32)
    pred = np.where(rng.random(fenc.shape) < 0.5, 0, 255).astype(np.int32)
    off4 = rng.integers(0, 400, 16).astype(np.int32)
    off8 = rng.integers(0, 400, 64).astype(np.int32)
    (r4, r8, js4, js8), jqt = _jax_residuals(fenc, pred, off4, off8)
    tq = convert.qtab_p_from_numpy({k: np.asarray(a) for k, a in jqt.items()},
                                   "cpu")
    fe, pr = T(fenc.reshape(-1, 16, 16)), T(pred.reshape(-1, 16, 16))
    t4 = tinter.inter_luma_residual(fe, pr, tq, True, nr_offset=T(off4))
    t8 = tinter.inter_luma_residual8(fe, pr, tq, True, nr_offset=T(off8))
    for j, t in zip(r4, t4[:3]):
        np.testing.assert_array_equal(np.asarray(j).reshape(t.shape),
                                      t.numpy())
    for j, t in zip(r8, t8[:3]):
        np.testing.assert_array_equal(np.asarray(j).reshape(t.shape),
                                      t.numpy())
    grid = lambda a: a.reshape(MB_H, MB_W, *a.shape[1:])
    ts4 = tquant.nr_sums_plain(grid(t4[3]))
    ts8 = tquant.nr_sums_plain(grid(t8[3]))
    assert np.asarray(js4)[1:].min() > 2 ** 24
    assert np.asarray(js8).max() > 2 ** 24
    np.testing.assert_array_equal(ts4.numpy(), np.asarray(js4))
    np.testing.assert_array_equal(ts8.numpy(), np.asarray(js8))
    # a sequential sum of the same |coef| differs: the order matters here
    seq = grid(t4[3]).to(torch.float32).reshape(-1, 16)
    acc = torch.zeros(16)
    for row in seq:
        acc = acc + row
    acc[0] = 0
    assert not torch.equal(acc, ts4)

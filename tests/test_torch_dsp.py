"""The port's plain DSP building blocks against x264_tpu's jnp functions:
transforms, quantisation, intra predictors, SATD and the SSIM sum, on
seeded integer inputs. Every integer output must be exactly equal; the
SSIM sum (float32, summed in another order) within relative 1e-6."""

import numpy as np
import pytest
import torch

from x264_tpu.ops import dct as jdct
from x264_tpu.ops import pixel as jpix
from x264_tpu.ops import predict as jpred
from x264_tpu.ops import quant as jquant
from x264_tpu_torch.ops import dct as tdct
from x264_tpu_torch.ops import pixel as tpix
from x264_tpu_torch.ops import predict as tpred
from x264_tpu_torch.ops import quant as tquant

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _t(a):
    return torch.from_numpy(np.array(a))


def _dct(rng):
    d = rng.integers(-255, 256, (7, 4, 4)).astype(np.int32)
    c = rng.integers(-2000, 2000, (7, 4, 4)).astype(np.int32)
    dc2 = rng.integers(-4000, 4000, (7, 2, 2)).astype(np.int32)
    _eq(jdct.dct4x4(d), tdct.dct4x4(_t(d)))
    _eq(jdct.idct4x4(c), tdct.idct4x4(_t(c)))
    _eq(jdct.hadamard4x4_fwd(c), tdct.hadamard4x4_fwd(_t(c)))
    _eq(jdct.hadamard4x4_inv(c), tdct.hadamard4x4_inv(_t(c)))
    _eq(jdct.hadamard2x2(dc2), tdct.hadamard2x2(_t(dc2)))


def _quant(rng):
    from x264_tpu import tables
    qt = tables.DEFAULT_QUANT
    c = rng.integers(-9000, 9000, (5, 16)).astype(np.int32)
    for qp in (0, 13, 26, 38, 51):
        mf = np.asarray(qt.quant4_mf[0, qp], np.int32)
        bias = np.asarray(qt.quant4_bias[0, qp], np.int32)
        dmf = np.asarray(qt.dequant4_mf[0, qp % 6], np.int32)
        lv = np.asarray(jquant.quant(c, mf, bias))
        _eq(lv, tquant.quant(_t(c), _t(mf), _t(bias)))
        _eq(jquant.dequant(lv, dmf, qp // 6, 4),
            tquant.dequant(_t(lv), _t(dmf), qp // 6, 4))
        _eq(jquant.quant_dc(c, mf[0] >> 1, bias[0] << 1),
            tquant.quant_dc(_t(c), int(mf[0] >> 1), int(bias[0] << 1)))
        _eq(jquant.dequant_4x4_dc(lv, dmf[0], qp // 6),
            tquant.dequant_4x4_dc(_t(lv), int(dmf[0]), qp // 6))
        _eq(jquant.dequant_2x2_dc(lv, dmf[0], qp // 6),
            tquant.dequant_2x2_dc(_t(lv), int(dmf[0]), qp // 6))


def _flags(rng, k):
    return (rng.random(k) < 0.6, rng.random(k) < 0.6)


def _predict16(rng):
    k = 12
    top, left = (rng.integers(0, 256, (k, 16)).astype(np.int32)
                 for _ in range(2))
    tl = rng.integers(0, 256, k).astype(np.int32)
    ht, hl = _flags(rng, k)
    _eq(jpred.predict_16x16(top, left, tl, ht, hl),
        tpred.predict_16x16(_t(top), _t(left), _t(tl), _t(ht), _t(hl)))
    _eq(jpred.mode_available_16x16(ht, hl),
        tpred.mode_available_16x16(_t(ht), _t(hl)))


def _predict8c(rng):
    k = 12
    top, left = (rng.integers(0, 256, (k, 8)).astype(np.int32)
                 for _ in range(2))
    tl = rng.integers(0, 256, k).astype(np.int32)
    ht, hl = _flags(rng, k)
    _eq(jpred.predict_8x8c(top, left, tl, ht, hl),
        tpred.predict_8x8c(_t(top), _t(left), _t(tl), _t(ht), _t(hl)))
    _eq(jpred.mode_available_8x8c(ht, hl),
        tpred.mode_available_8x8c(_t(ht), _t(hl)))


def _predict4(rng):
    k = 12
    left, top, tr = (rng.integers(0, 256, (k, 4)).astype(np.int32)
                     for _ in range(3))
    tl = rng.integers(0, 256, k).astype(np.int32)
    ht, hl = _flags(rng, k)
    _eq(jpred.predict_4x4(left, tl, top, tr, ht, hl),
        tpred.predict_4x4(_t(left), _t(tl), _t(top), _t(tr), _t(ht), _t(hl)))
    _eq(jpred.mode_available_4x4(ht, hl),
        tpred.mode_available_4x4(_t(ht), _t(hl)))


def _satd(rng):
    for n in (16, 8, 4):
        a = rng.integers(0, 256, (6, 1, n, n)).astype(np.int32)
        b = rng.integers(0, 256, (6, 4, n, n)).astype(np.int32)
        _eq(jpix.satd(a, b), tpix.satd(_t(a), _t(b)))


def _ssim(rng):
    a = rng.integers(0, 256, (42, 58)).astype(np.int32)
    b = np.clip(a + rng.integers(-12, 13, a.shape), 0, 255).astype(np.int32)
    j = float(jpix.ssim_sum(a, b))
    t = float(tpix.ssim_sum(_t(a), _t(b)))
    assert abs(j - t) <= 1e-6 * abs(j)


FAMILIES = dict(dct=_dct, quant=_quant, predict16=_predict16,
                predict8c=_predict8c, predict4=_predict4, satd=_satd,
                ssim=_ssim)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dsp_matches_jax(family):
    FAMILIES[family](np.random.default_rng(sorted(FAMILIES).index(family)))

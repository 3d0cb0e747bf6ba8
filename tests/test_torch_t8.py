"""The 8x8 transform's plain PyTorch functions against x264_tpu's, on
seeded numpy inputs, with exact equality: dct8x8 / idct8x8 on residuals
of +-255, sa8d_8x8 / sa8d_16x16, predict_8x8_filter / predict_8x8 /
mode_available_8x8 under every availability set, the I8x8 ladder
luma_i8_path, the whole I8x8 frame one MB wide, inter_luma_residual8
with and without decimation, the
cat-5 op slots residual_block_ops8 (with a block whose last coefficient
is at 63), the 8x8 decimation score and the deblocking filter with the
t8_mb map of an I8x8 frame."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables as jtables
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import intra as jintra
from x264_tpu.entropy import cabac_planes as jcp
from x264_tpu.ops import dct as jdct
from x264_tpu.ops import deblock as jdeblock
from x264_tpu.ops import pixel as jpix
from x264_tpu.ops import predict as jpred
from x264_tpu.ops import quant as jquant
from x264_tpu_torch import tables
from x264_tpu_torch.encoder import inter, intra, pipeline
from x264_tpu_torch.entropy import cabac_planes
from x264_tpu_torch.ops import dct, deblock, pixel, predict, quant

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

QP = 26


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_dct8_pair_matches_jax():
    rng = np.random.default_rng(0)
    d = rng.integers(-255, 256, (64, 8, 8)).astype(np.int32)
    d[0], d[1] = 255, -255                          # the extremes
    _eq(jdct.dct8x8(d), dct.dct8x8(torch.from_numpy(d)))
    c = np.array(jdct.dct8x8(d))
    _eq(jdct.idct8x8(c), dct.idct8x8(torch.from_numpy(c)))
    assert not (np.asarray(jdct.idct8x8(c)) == 0).all()


def test_sa8d_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (16, 16, 16))
    b = rng.integers(0, 256, (16, 16, 16))
    b[0] = a[0]                                     # a zero difference
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _eq(jpix.sa8d_16x16(a, b), pixel.sa8d_16x16(ta, tb))
    _eq(jpix.sa8d_8x8(a[:, 3:11, 5:13], b[:, :8, :8]),
        pixel.sa8d_8x8(ta[:, 3:11, 5:13], tb[:, :8, :8]))


def test_predict_8x8_under_every_availability_set():
    """The 8x8 filter, the nine predictions and the mode mask for all 16
    (ht, hl, htl, htr) sets, each on 8 random edge vectors."""
    rng = np.random.default_rng(2)
    sets = np.array(list(itertools.product((False, True), repeat=4)))
    flags = np.repeat(sets, 8, axis=0).T                # 4 x 128
    n = flags.shape[1]
    left, top, tr = (rng.integers(0, 256, (n, 8)).astype(np.int32)
                     for _ in range(3))
    tl = rng.integers(0, 256, n).astype(np.int32)
    jf = jpred.predict_8x8_filter(left, tl, top, tr, *map(jnp.asarray, flags))
    th = [torch.from_numpy(f) for f in flags]
    tf = predict.predict_8x8_filter(*map(torch.from_numpy, (left, tl, top,
                                                           tr)), *th)
    for j, t in zip(jf, tf):
        _eq(j, t)
    _eq(jpred.predict_8x8(*jf, flags[0], flags[1]),
        predict.predict_8x8(*tf, th[0], th[1]))
    _eq(jpred.mode_available_8x8(flags[0], flags[1], flags[2]),
        predict.mode_available_8x8(th[0], th[1], th[2]))
    assert (np.asarray(jpred._P8_IDX) == predict.P8_IDX).all()
    assert (np.asarray(jpred._P8_WGT) == predict.P8_WGT).all()


def test_qtabs_carry_the_8x8_tables():
    jq = jinter.make_qtab_p(QP, jtables.chroma_qp(QP))
    tq = inter.make_qtab_p(QP, tables.chroma_qp(QP), "cpu")
    for k in intra.QTAB_VEC8_KEYS + inter.QTAB_P_VEC8_KEYS:
        _eq(jq[k], tq[k])


@pytest.mark.parametrize("qp", [20, 32])
def test_luma_i8_path_matches_jax(qp):
    """Sixteen MBs with every combination of top / left / top-right
    availability, on blocky gradients that I8x8 fits."""
    rng = np.random.default_rng(qp)
    K = 16
    yy, xx = np.mgrid[0:16, 0:16]
    fenc = np.stack([((yy * (k % 4) + xx * (k // 4)) * 3 + 40
                      + np.kron(rng.integers(-20, 20, (2, 2)),
                                np.ones((8, 8), np.int64))) % 256
                     for k in range(K)]).astype(np.int32)
    top, left = (rng.integers(0, 256, (K, 16)).astype(np.int32)
                 for _ in range(2))
    tl = rng.integers(0, 256, K).astype(np.int32)
    tr8 = rng.integers(0, 256, (K, 8)).astype(np.int32)
    nmt, nml = (rng.integers(0, 9, (K, 4)).astype(np.int32)
                for _ in range(2))
    ht, hl, htr = (np.arange(K) % 2 == 1, np.arange(K) // 2 % 2 == 1,
                   np.arange(K) // 4 % 2 == 1)
    htr = htr & ht
    lam = int(jtables.LAMBDA_TABLE[qp])
    jq = jintra.make_qtab(qp, jtables.chroma_qp(qp))
    j = jintra.luma_i8_path(fenc, top, tl, left, tr8, nmt, nml, ht, hl, htr,
                            jq, lam)
    tq = intra.make_qtab(qp, tables.chroma_qp(qp), "cpu")
    t = intra.luma_i8_path(*map(torch.from_numpy, (fenc, top, tl, left, tr8,
                                                   nmt, nml, ht, hl, htr)),
                           tq, lam)
    for key in j:
        _eq(j[key], t[key])
    assert (np.asarray(j["cbp_bits"]) > 0).any()


def test_i8x8_frame_one_mb_wide_matches_jax():
    """The whole I8x8 frame (I4x4 and I8x8 ladders) one MB wide: block 1
    never has a top-right, and every other slope-2 diagonal is empty."""
    mb_h, mb_w, qp = 4, 1, 38
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:mb_h * 16, 0:mb_w * 16]
    y = ((yy * 2 + xx * 3) // 2 % 256
         + np.kron(rng.integers(-20, 20, (mb_h * 2, mb_w * 2)),
                   np.ones((8, 8), np.int64))).clip(0, 255).astype(np.int32)
    u = (128 + xx[::2, ::2] // 4).astype(np.int32)
    v = (128 - yy[::2, ::2] // 4).astype(np.int32)
    lam = int(jtables.LAMBDA_TABLE[qp])
    j = jintra.encode_i16_frame(mb_h, mb_w, y, u, v,
                                jintra.make_qtab(qp, jtables.chroma_qp(qp)),
                                lam, True, False, True)
    t = intra.encode_i16_frame(mb_h, mb_w, *map(torch.from_numpy, (y, u, v)),
                               intra.make_qtab(qp, tables.chroma_qp(qp),
                                               "cpu"), lam, True)
    assert set(t) == set(j)
    for key in j:
        _eq(j[key], t[key])
    assert t["t8_mb"].any()


@pytest.mark.parametrize("decimate", [False, True])
def test_inter_luma_residual8_matches_jax(decimate):
    """Small residuals, so that decimation zeroes some 8x8 blocks and
    whole MBs and keeps others."""
    rng = np.random.default_rng(7)
    K = 24
    pred = rng.integers(20, 236, (K, 16, 16)).astype(np.int32)
    amp = np.repeat([1, 3, 6, 20], K // 4)[:, None, None]
    fenc = np.clip(pred + rng.integers(-1, 2, (K, 16, 16)) * amp
                   * (rng.random((K, 16, 16)) < 0.2), 0, 255).astype(np.int32)
    jq = jinter.make_qtab_p(QP, jtables.chroma_qp(QP))
    j = jinter.inter_luma_residual8(fenc, pred, jq, decimate=decimate)
    tq = inter.make_qtab_p(QP, tables.chroma_qp(QP), "cpu")
    t = inter.inter_luma_residual8(torch.from_numpy(fenc),
                                   torch.from_numpy(pred), tq, decimate)
    for a, b in zip(j, t):
        _eq(a, b)
    cbp = np.asarray(j[2])
    assert (cbp > 0).any() and (cbp < 15).any()


def test_decimate_score8_matches_jax():
    rng = np.random.default_rng(8)
    lv = (rng.integers(-1, 2, (64, 64)) * (rng.random((64, 64)) < 0.1)) \
        .astype(np.int32)
    lv[0, 5] = 2                                   # scores 9
    _eq(jquant.decimate_score(lv, jquant.DECIMATE_TAB8),
        quant.decimate_score(torch.from_numpy(lv), quant.DECIMATE_TAB8))


def test_residual_block_ops8_matches_jax():
    rng = np.random.default_rng(9)
    c = (rng.integers(-70, 71, (12, 64)) * (rng.random((12, 64)) < 0.3)) \
        .astype(np.int32)
    c[0] = 0                                       # empty
    c[1, 63] = -5                                  # last at 63
    c[2, :] = 0
    c[2, 62] = 200000                              # a clamped level
    coded = np.arange(12) % 5 != 4
    j = np.asarray(jcp.residual_block_ops8(c, coded)).astype(np.int64)
    t = cabac_planes.residual_block_ops8(torch.from_numpy(c),
                                         torch.from_numpy(coded))
    np.testing.assert_array_equal(j & 0xFFFFFFFF, t.numpy() & 0xFFFFFFFF)


def test_deblock_with_an_i8x8_map_matches_jax():
    """The deblocking filter of an IDR coded with I8x8: its t8_mb map
    takes bS 0 on the inner luma edges of those MBs."""
    mb_h, mb_w = 3, 4
    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:mb_h * 16, 0:mb_w * 16]
    y = (((yy * 2 + xx * 3) // 2) % 256 + np.kron(
        rng.integers(-20, 20, (mb_h * 2, mb_w * 2)),
        np.ones((8, 8), np.int64))).clip(0, 255).astype(np.int32)
    u = (128 + xx[::2, ::2] // 4).astype(np.int32)
    v = (128 - yy[::2, ::2] // 4).astype(np.int32)
    q = intra.make_qtab(34, tables.chroma_qp(34), "cpu")
    out = intra.encode_i16_frame_plain(mb_h, mb_w, *map(torch.from_numpy,
                                                        (y, u, v)), q,
                                       int(tables.LAMBDA_TABLE[34]), True)
    t8 = out["t8_mb"]
    assert t8.any() and not t8.all()
    im, z4, zmv = pipeline._zero_maps(mb_h, mb_w, "cpu")
    qp = torch.full((mb_h, mb_w), 34, dtype=torch.int32)
    args = (qp, im, z4, z4, zmv, z4, zmv, False, 0, 0, 0)
    src = [out[k] for k in ("recon_y", "recon_u", "recon_v")]
    t = deblock.deblock_frame(mb_h, mb_w, *src, *args, t8_mb=t8)
    j = jdeblock.deblock_frame(mb_h, mb_w, *(a.numpy() for a in src),
                               *(a.numpy() if torch.is_tensor(a) else a
                                 for a in args), t8_mb=t8.numpy())
    for a, b in zip(j, t):
        _eq(a, b)
    no_t8 = deblock.deblock_frame(mb_h, mb_w, *src, *args)
    assert not torch.equal(no_t8[0], t[0])          # the rule acted

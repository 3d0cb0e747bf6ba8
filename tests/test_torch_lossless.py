"""The lossless transform bypass (qpprime_y_zero_transform_bypass) of the
port's plain paths against x264_tpu's: luma_i16_path, luma_i4_path,
chroma_residual (intra "c" and inter "pc" tables) and the inter luma
residual at QP 0 on seeded blocks (the levels are the residual samples,
up to +-255, the recon the source), and the whole intra frame
(encode_i16_frame with lossless=True, I16x16 + I4x4 + chroma). Every
output must be exactly equal, and every recon must equal its source."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import intra as jintra
from x264_tpu_torch import convert
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import intra as tintra

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
K = 24


def _qtabs():
    jq = jinter.make_qtab_p(0, tables.chroma_qp(0))
    return jq, convert.qtab_p_from_numpy(
        {k: np.asarray(a) for k, a in jq.items()}, "cpu")


def _blocks(seed, n=16):
    """K source blocks, half noise over the whole range and half a smooth
    ramp, with their neighbours and availability flags."""
    rng = np.random.default_rng(seed)
    fenc = rng.integers(0, 256, (K, n, n))
    ramp = (np.add.outer(np.arange(n), np.arange(n)) * 7 + 20) % 256
    fenc[K // 2:] = ramp + rng.integers(0, 3, (K - K // 2, n, n))
    top = rng.integers(0, 256, (K, n))
    left = rng.integers(0, 256, (K, n))
    tl = rng.integers(0, 256, K)
    ht = np.arange(K) % 3 != 0
    hl = np.arange(K) % 4 != 1
    return fenc.clip(0, 255), top, left, tl, ht, hl


def _eq(j, t, what):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=what)


def test_i16_lossless_matches_jax():
    fenc, top, left, tl, ht, hl = _blocks(1)
    jq, tq = _qtabs()
    lam = int(tables.LAMBDA_TABLE[0])
    j = jintra.luma_i16_path(jnp.asarray(fenc), jnp.asarray(top),
                             jnp.asarray(left), jnp.asarray(tl),
                             jnp.asarray(ht), jnp.asarray(hl), jq, lam,
                             True)
    t = tintra.luma_i16_path(T(fenc), T(top), T(left), T(tl),
                             torch.from_numpy(ht), torch.from_numpy(hl), tq,
                             lam, lossless=True)
    for k in ("cost", "mode", "recon", "dc_z", "ac_z", "cbp"):
        _eq(j[k], t[k], k)
    _eq(fenc, t["recon"], "recon == source")
    assert t["ac_z"].abs().max() > 100


def test_i4_lossless_matches_jax():
    fenc, top, left, tl, ht, hl = _blocks(2)
    jq, tq = _qtabs()
    lam = int(tables.LAMBDA_TABLE[0])
    rng = np.random.default_rng(7)
    nmt, nml = rng.integers(0, 9, (K, 4)), rng.integers(0, 9, (K, 4))
    j = jintra.luma_i4_path(jnp.asarray(fenc), jnp.asarray(top),
                            jnp.asarray(tl), jnp.asarray(left),
                            jnp.asarray(nmt), jnp.asarray(nml),
                            jnp.asarray(ht), jnp.asarray(hl), jq, lam, True)
    t = tintra.luma_i4_path(T(fenc), T(top), T(tl), T(left), T(nmt), T(nml),
                            torch.from_numpy(ht), torch.from_numpy(hl), tq,
                            lam, lossless=True)
    for k in ("cost", "modes", "blocks_z", "recon", "cbp_bits"):
        _eq(j[k], t[k], k)
    _eq(fenc, t["recon"], "recon == source")


@pytest.mark.parametrize("pfx", ["c", "pc"])
def test_chroma_lossless_matches_jax(pfx):
    rng = np.random.default_rng(3)
    fencc = rng.integers(0, 256, (K, 8, 8))
    cpred = rng.integers(0, 256, (K, 8, 8))
    jq, tq = _qtabs()
    jr, jdc, jac, _, _ = jintra.chroma_residual(
        jnp.asarray(fencc), jnp.asarray(cpred), jq, pfx, True)
    tr, tdc, tac = tintra.chroma_residual(T(fencc), T(cpred), tq, pfx,
                                          lossless=True)
    for j, t, k in ((jr, tr, "recon"), (jdc, tdc, "dc"), (jac, tac, "ac")):
        _eq(j, t, k)
    _eq(fencc, tr, "recon == source")


def test_inter_luma_lossless_matches_jax():
    rng = np.random.default_rng(4)
    fenc = rng.integers(0, 256, (4, 6, 16, 16))
    pred = rng.integers(0, 256, (4, 6, 16, 16))
    pred[0, :3] = fenc[0, :3]            # MBs with no residual at all
    jq, tq = _qtabs()
    j = jinter.inter_luma_residual(jnp.asarray(fenc), jnp.asarray(pred), jq,
                                   True, decimate=False)
    t = tinter.inter_luma_residual(T(fenc.reshape(-1, 16, 16)),
                                   T(pred.reshape(-1, 16, 16)), tq,
                                   lossless=True)
    for jj, tt, k in zip(j, t, ("recon", "blocks_z", "cbp")):
        np.testing.assert_array_equal(np.asarray(jj).reshape(tt.shape),
                                      tt.numpy(), err_msg=k)
    assert (t[2][:3] == 0).all() and (t[2][3:] == 15).all()


@pytest.mark.parametrize("mb_h,mb_w", [(4, 5), (3, 7)])
def test_intra_frame_lossless_matches_jax(mb_h, mb_w):
    rng = np.random.default_rng(mb_w)
    h, w = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx // 3 + yy // 2) % 220 + rng.integers(0, 36, (h, w))) \
        .clip(0, 255).astype(np.int32)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    v = (128 + rng.integers(-20, 20, (h // 2, w // 2))).astype(np.int32)
    lam = int(tables.LAMBDA_TABLE[0])
    jq = jintra.make_qtab(0, tables.chroma_qp(0))
    jo = jintra.encode_i16_frame(mb_h, mb_w, y, u, v, jq, lam, True, True,
                                 False)
    tq = convert.qtab_from_numpy({k: np.asarray(a) for k, a in jq.items()},
                                 "cpu")
    to = tintra.encode_i16_frame(mb_h, mb_w, T(y), T(u), T(v), tq, lam,
                                 lossless=True)
    assert to.keys() == jo.keys()
    for k in jo:
        _eq(jo[k], to[k], k)
    for src, k in ((y, "recon_y"), (u, "recon_u"), (v, "recon_v")):
        _eq(src, to[k], k + " == source")
    assert to["i4_mb"].any()

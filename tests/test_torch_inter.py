"""The port's plain P-frame encode against x264_tpu/encoder/inter.py at
subme 1: make_qtab_p (and convert.qtab_p_from_numpy), the inter luma
residual with and without DCT decimation, the inter ("pc") chroma
residual with the joint two-channel AC decimation, and encode_p_body
with the slice's flags (subpel_steps=(), parts=False, n_refs=1,
t8=False, rd=False, qp_map=None, decimate=True) at 4x5 MBs, once on a
reference that keeps the MBs inter and once on one that sends them intra
with chains deeper than the three sweeps. Inputs are made with numpy
from a seed and fed to both packages; every output is an integer and
must be exactly equal."""

import functools

import jax
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import intra as jintra
from x264_tpu.encoder import inter as jinter
from x264_tpu.ops import quant as jquant
from x264_tpu_torch import convert
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.ops import quant as tquant

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
QP = 26
MB_H, MB_W = 4, 5


def _qtabs(qp):
    qp_c = tables.chroma_qp(qp)
    jq = jinter.make_qtab_p(qp, qp_c)
    return jq, convert.qtab_p_from_numpy(
        {k: np.asarray(a) for k, a in jq.items()}, "cpu")


@pytest.mark.parametrize("qp", [12, 26, 40])
def test_make_qtab_p_matches_jax(qp):
    _, tq = _qtabs(qp)
    own = tinter.make_qtab_p(qp, tables.chroma_qp(qp), "cpu")
    assert own.keys() == tq.keys()
    for k in tq:
        assert torch.equal(own[k], tq[k]), k


def _tiles(n, size, seed, spread):
    """fenc / pred tile pairs whose residual is small (spread), so that
    the decimation rules decide many blocks."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(20, 236, (n, size, size))
    fenc = pred + rng.integers(-spread, spread + 1, (n, size, size)) \
        * (rng.random((n, 1, 1)) < 0.8)
    return fenc.clip(0, 255).astype(np.int32), pred.astype(np.int32)


# (qp, residual spread) pairs at which the decimation rules decide a
# good share of the blocks, and not all of them
DECIMATING = [(20, 4), (26, 9)]


@pytest.mark.parametrize("decimate", [False, True])
@pytest.mark.parametrize("qp,spread", DECIMATING)
def test_inter_luma_residual_matches_jax(decimate, qp, spread):
    jq, tq = _qtabs(qp)
    fenc, pred = _tiles(48, 16, qp, spread)
    j = jinter.inter_luma_residual(fenc, pred, jq, decimate=decimate)
    t = tinter.inter_luma_residual(T(fenc), T(pred), tq, decimate)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if decimate:                 # the rules zeroed some coded groups
        full = tinter.inter_luma_residual(T(fenc), T(pred), tq, False)
        assert (full[2] != t[2]).any()


@pytest.mark.parametrize("qp,spread", DECIMATING)
def test_inter_chroma_joint_decimation_matches_jax(qp, spread):
    jq, tq = _qtabs(qp)
    (fu, pu), (fv, pv) = (_tiles(64, 8, qp + k, spread) for k in (0, 1))
    jsc = sum(jquant.decimate_score(
        np.asarray(jintra.chroma_ac_scan(f, p, jq, "pc"))[..., 1:],
        jquant.DECIMATE_TAB4).sum(-1) for f, p in ((fu, pu), (fv, pv)))
    tsc = sum(tquant.decimate_score(
        tintra.chroma_ac_scan(T(f), T(p), tq, "pc")[..., 1:]).sum(-1)
        for f, p in ((fu, pu), (fv, pv)))
    np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy())
    kill = np.asarray(jsc) < 7
    assert kill.any() and not kill.all()
    for f, p in ((fu, pu), (fv, pv)):
        j = jintra.chroma_residual(f, p, jq, "pc", ac_kill=kill)
        t = tintra.chroma_residual(T(f), T(p), tq, "pc",
                                   torch.from_numpy(kill))
        for a, b in zip(j[:3], t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _p_inputs(kind):
    rng = np.random.default_rng(0)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "inter":
        # the reference moved by a few pixels: every MB finds it
        ref_y = ((xx // 3 + yy // 2) % 200 + rng.integers(0, 24, (h, w)))
        ref_u = rng.integers(60, 200, (h // 2, w // 2))
        ref_v = rng.integers(60, 200, (h // 2, w // 2))
        y = np.roll(ref_y, (2, 3), (0, 1)) + rng.integers(-3, 4, (h, w))
        u, v = np.roll(ref_u, (1, 1), (0, 1)), np.roll(ref_v, (1, 2), (0, 1))
    else:
        # smooth source, noise reference: every MB would rather be intra,
        # so chains run deeper than the three sweeps and get demoted
        ref_y, ref_u, ref_v = (rng.integers(0, 256, s) for s in
                               ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        y = 100 + xx // 8 + yy // 8
        u = np.full((h // 2, w // 2), 120)
        v = np.full((h // 2, w // 2), 130)
    mvp = rng.integers(-8, 9, (MB_H, MB_W, 2))
    return [np.clip(a, 0, 255).astype(np.int32)
            for a in (y, u, v, ref_y, ref_u, ref_v)] + [mvp.astype(np.int32)]


@pytest.fixture(scope="module")
def jax_p_body():
    """x264_tpu's encode_p_body with the slice's flags, compiled once."""
    return jax.jit(functools.partial(
        jinter.encode_p_body, MB_H, MB_W, 16, subpel_steps=(), parts=False,
        n_refs=1, t8=False, rd=False, decimate=True))


@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_encode_p_body_matches_jax(kind, jax_p_body, monkeypatch):
    y, u, v, ry, ru, rv, mvp = _p_inputs(kind)
    lam = int(tables.LAMBDA_TABLE[QP])
    jq, tq = _qtabs(QP)
    jo = {k: np.asarray(a) for k, a in
          jax_p_body(y, u, v, ry, ru, rv, jq, lam, mvp).items()}
    chosen = []                  # the sweep-0 intra wishes, before demotion
    resolve = tinter.resolve_intra
    monkeypatch.setattr(tinter, "resolve_intra",
                        lambda c: chosen.append(c) or resolve(c))
    to = tinter.encode_p_body(MB_H, MB_W, 16, T(y), T(u), T(v), T(ry),
                              T(ru), T(rv), tq, lam, T(mvp), True)
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k].numpy(), err_msg=k)
    intra_mb, want = to["intra_mb"].numpy(), chosen[0].numpy()
    if kind == "inter":
        assert not intra_mb.any() and not to["skip"].any()
        assert (to["cbp_luma_bits"].numpy() > 0).any()
    else:
        assert intra_mb.any()
        assert (want & ~intra_mb).any()          # deep chains demoted

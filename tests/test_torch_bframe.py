"""The B slice against x264_tpu, function level: spatial_direct on maps
where the colocated low-motion override and the non-uniform case occur;
the whole plain B body (encode_b_body_plain: the two-list ME, the B mode
decision, residual pass 1, the intra decision, spatial direct with its
wavefront, residual pass 2, the intra sweeps and stage 4's maps) against
encode_b_body at 5 x 4 MBs, between two references that move apart, with
nonzero colocated maps and flat MBs, so that intra-in-B, B_Direct and
B_SKIP all occur (the trellis and AQ's constant row maps run in the
Encoder tests of tests/test_torch_encoder_b.py); then
b_slice_ops (compacted) and the B deblock (is_b, both lists' maps) on
x264_tpu's own B body output. Inputs are made with numpy from a seed;
every output is an integer and must be exactly equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import mvpred as jmvpred
from x264_tpu.entropy import cabac_planes as jcp
from x264_tpu.ops import deblock as jdeblock
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import mvpred as tmvpred
from x264_tpu_torch.entropy import cabac_planes as tcp
from x264_tpu_torch.ops import deblock as tdeblock

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
MB_H, MB_W, QP = 4, 5, 26
H, W = MB_H * 16, MB_W * 16


def _col_maps(rng):
    """Colocated L0 maps of the future reference: mostly ref 0 with small
    and large MVs, one intra MB, per-4x4 variation inside MBs."""
    ref4 = np.zeros((MB_H * 4, MB_W * 4), np.int32)
    ref4[4:8, 8:12] = -1
    mv4 = rng.integers(-1, 2, (MB_H * 4, MB_W * 4, 2))
    big = rng.random((MB_H * 4, MB_W * 4)) < 0.3
    mv4 = np.where(big[..., None], rng.integers(-12, 13, mv4.shape), mv4)
    mv4[ref4 < 0] = 0
    return ref4, mv4.astype(np.int32)


def test_spatial_direct_matches_jax():
    """Per-list maps with intra and unused blocks, and colocated maps
    where some quadrants are still and others move."""
    rng = np.random.default_rng(3)
    outs = []
    for seed in range(3):
        r = np.random.default_rng(seed)
        ref_l0 = r.choice([-1, 0, 0, 0], (MB_H * 4, MB_W * 4))
        ref_l1 = r.choice([-1, -1, 0], (MB_H * 4, MB_W * 4))
        mv_l0 = r.integers(-9, 10, (MB_H * 4, MB_W * 4, 2))
        mv_l1 = np.where(r.random((MB_H * 4, MB_W * 4, 1)) < 0.5, 0,
                         r.integers(-9, 10, (MB_H * 4, MB_W * 4, 2)))
        mv_l0[ref_l0 < 0] = 0
        mv_l1[ref_l1 < 0] = 0
        cr, cm = _col_maps(rng)
        args = [a.astype(np.int32) for a in (ref_l0, mv_l0, ref_l1, mv_l1,
                                             cr, cm)]
        j = jmvpred.spatial_direct(*map(jnp.asarray, args))
        t = tmvpred.spatial_direct(*map(T, args))
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        outs.append([b.numpy() for b in t])
    uni = np.concatenate([o[4].ravel() for o in outs])
    assert uni.any() and not uni.all()
    # the override zeroed a derived MV somewhere
    assert any(((o[0] == 0) & (o[2] == 0).all(-1)).any() for o in outs)


def _b_inputs():
    """Two references a pan apart, the B frame halfway, with flat MBs
    that match neither (intra) and a still corner (direct / skip)."""
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:H + 32, 0:W + 32]
    tex = (128 + 60 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
           + rng.integers(0, 30, yy.shape))

    def at(t):
        f = tex[8 + t:8 + t + H, 8 + 2 * t:8 + 2 * t + W].copy()
        f[:32, :32] = tex[:32, :32]                   # a still corner
        return f

    # independent noise on the references: their average pays (BI)
    l0 = at(0) + rng.integers(-12, 13, (H, W))
    l1 = at(4) + rng.integers(-12, 13, (H, W))
    cur = at(2) + rng.integers(-2, 3, (H, W))
    cur[32:48, 16:64] = 200                           # flat MBs
    # an object that appears: only the future reference holds it (L1)
    l1[48:64, 48:80] = cur[48:64, 48:80] = tex[:16, 40:72]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    planes = []
    for y, t in ((cur, 2), (l0, 0), (l1, 4)):
        u = 110 + (cx + t) % 17
        v = 140 - (cy + t) % 13
        planes += [y, u, v]
    return [np.clip(a, 0, 255).astype(np.int32) for a in planes]


@functools.lru_cache(maxsize=None)
def _bodies():
    y, u, v, ay, au, av, by, bu, bv = _b_inputs()
    rng = np.random.default_rng(8)
    seed0 = rng.integers(-8, 9, (MB_H, MB_W, 2)).astype(np.int32)
    seed1 = -seed0
    cr, cm = _col_maps(rng)
    lam = int(tables.LAMBDA_TABLE[QP])
    qp_c = tables.chroma_qp(QP)
    jq = jinter.make_qtab_p(QP, qp_c)
    tq = tinter.make_qtab_p(QP, qp_c, "cpu")
    jbody = jax.jit(functools.partial(jinter.encode_b_body, MB_H, MB_W, 16,
                                      subpel_steps=(2, 1)))
    jo = {k: np.asarray(a) for k, a in jbody(
        y, u, v, ay, au, av, by, bu, bv, jq, lam, seed0,
        col_ref4=cr, col_mv4=cm, mvp_seed_l1=seed1).items()}
    to = tinter.encode_b_body_plain(
        MB_H, MB_W, 16, T(y), T(u), T(v), (T(ay), T(au), T(av)),
        (T(by), T(bu), T(bv)), tq, lam, T(seed0), T(seed1), T(cr), T(cm))
    return jo, to


def test_encode_b_body_matches_jax():
    jo, to = _bodies()
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k].numpy(), err_msg=k)
    # every B mode of this slice occurs
    assert to["intra_mb"].any() and to["direct_mb"].any()
    assert to["skip"].any() and (to["direct_mb"] & ~to["skip"]).any()
    bm = to["bmode"].numpy()
    assert {0, 1, 2} <= set(bm[~to["direct_mb"].numpy()].ravel())


@pytest.mark.parametrize("t8_mode", [False, True])
def test_b_slice_ops_match_jax(t8_mode):
    """b_slice_ops on x264_tpu's own B body output, compacted."""
    jo, _ = _bodies()
    cap = tcp.capacity(MB_H * MB_W)
    jops = np.asarray(jcp.b_slice_ops({k: jnp.asarray(a) for k, a in
                                       jo.items()}, MB_H, MB_W, t8_mode))
    live = jops[(jops >> 29) != jcp.KIND_PAD].astype(np.uint32)
    tops, n = tcp.compact_ops(tcp.b_slice_ops(
        {k: torch.from_numpy(np.array(a)) for k, a in jo.items()}, MB_H, MB_W,
        t8_mode), cap)
    assert int(n) == live.size
    np.testing.assert_array_equal(live, tops[:int(n)].numpy().view(np.uint32))


@pytest.mark.parametrize("perturb", [False, True])
def test_b_deblock_matches_jax(perturb):
    """The B bS rule (both lists' refs and MVs) on x264_tpu's B body, and
    with its L1 maps moved on some 4x4 blocks, where the L1 comparison
    alone decides edges."""
    jo, _ = _bodies()
    qp_mb = np.full((MB_H, MB_W), QP + 8, np.int32)
    maps = {k: jo[k].copy() for k in ("nnz4", "ref4", "mv4", "ref4_l1",
                                      "mv4_l1")}
    if perturb:
        rng = np.random.default_rng(4)
        moved = rng.random(maps["ref4_l1"].shape) < 0.3
        maps["mv4_l1"][moved] += rng.integers(-8, 9, (moved.sum(), 2))
        maps["ref4_l1"][rng.random(moved.shape) < 0.1] = -1
    args = [jo[k] for k in ("recon_y", "recon_u", "recon_v")] + [
        qp_mb, jo["intra_mb"]] + list(maps.values())
    j = jdeblock.deblock_frame(MB_H, MB_W, *map(jnp.asarray, args), True,
                               0, 0, 0)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    t = tdeblock.deblock_frame(MB_H, MB_W, *targs, True, 0, 0, 0)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if perturb:      # the L1 maps decided some edges
        t0 = tdeblock.deblock_frame(MB_H, MB_W, *targs, False, 0, 0, 0)
        assert any(not torch.equal(a, b) for a, b in zip(t, t0))

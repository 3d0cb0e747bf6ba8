"""Two references (--ref 2) against x264_tpu, function level: the plain
versions of the multi-reference fetch and search with a per-block
reference index that takes both values (mc_luma and mc_chroma over the
stacks of both references, the sub-pel refinement at the half- and
quarter-pel ladders on every block shape, the full-pel partition search
with and without the 8x8 quadrants, the chroma-ME re-rank), then
encode_p_body with n_refs 2 on a flash triple at 4 x 5 MBs (subme 6 with
the partitions, P8x8, chroma ME, the RD ladder, the 8x8 transform and a
CRF QP map), where some MBs take the older reference, some on the newer
one sit beside them and some go intra; and the CABAC op stream
(p_slice_ops) and the CAVLC code planes (p_code_planes) of that body with
their ref_idx fields. Inputs are made with numpy from a seed; every
output is an integer and must be exactly equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu import tables as jtables
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import pipeline as jpipe
from x264_tpu.entropy import cabac_planes as jcp
from x264_tpu.entropy import device as jdev
from x264_tpu.ops import mc as jmc
from x264_tpu.ops import me as jme
from x264_tpu.ops import pixel as jpix
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.entropy import cabac_planes as tcp
from x264_tpu_torch.entropy import device as tdev
from x264_tpu_torch.ops import mc as tmc
from x264_tpu_torch.ops import me as tme

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
MB_H, MB_W = 4, 5
H, W = MB_H * 16, MB_W * 16
LAM = 4


def _textures(seed):
    """Two references of one texture moved apart, with noise of their
    own, and the source between them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H + 8, 0:W + 8]
    tex = (xx * 7 + yy * 3) % 97 + (xx // 5) * (yy // 7) % 61
    ref0 = tex[2:2 + H, 3:3 + W] + rng.integers(0, 30, (H, W))
    ref1 = tex[5:5 + H, 1:1 + W] + rng.integers(0, 30, (H, W))
    cur = tex[4:4 + H, 2:2 + W] + rng.integers(-3, 4, (H, W))
    return [np.clip(a, 0, 255).astype(np.int32) for a in (cur, ref0, ref1)]


def _stack(ref0, ref1):
    """The padded planes of both references and the 8 half-pel planes."""
    pads = [np.asarray(jmc.pad_plane(r)) for r in (ref0, ref1)]
    planes = np.concatenate([np.asarray(jmc.hpel_planes(p)) for p in pads])
    return np.stack(pads), planes


def _sel(rng, shape):
    """A seeded per-block reference index holding both values."""
    sel = rng.integers(0, 2, shape).astype(np.int32)
    assert sel.min() == 0 and sel.max() == 1
    return sel


def _origins(offs):
    gy = np.arange(MB_H)[:, None] * 16 + np.zeros((1, MB_W), int)
    gx = np.arange(MB_W)[None, :] * 16 + np.zeros((MB_H, 1), int)
    return (np.stack([gy + oy for oy, _ in offs]).astype(np.int32),
            np.stack([gx + ox for _, ox in offs]).astype(np.int32))


@pytest.mark.parametrize("bh,bw", [(16, 16), (8, 16), (16, 8), (8, 8)],
                         ids=lambda v: str(v))
def test_mc_with_ref_sel_matches_jax(bh, bw):
    _, ref0, ref1 = _textures(bh + bw)
    _, planes = _stack(ref0, ref1)
    rng = np.random.default_rng(bw)
    ys, xs = _origins([(0, 0), (H - bh - 16, W - bw - 16)])
    mvs = rng.integers(-40, 41, ys.shape + (2,)).astype(np.int32)
    sel = _sel(rng, ys.shape)
    j = jmc.mc_luma(planes, ys, xs, mvs, bh, bw, ref_sel=sel)
    t = tmc.mc_luma(T(planes), T(ys), T(xs), T(mvs), bh, bw, T(sel))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # chroma: the stack of both padded chroma planes
    cpads = np.stack([np.asarray(jmc.pad_plane(r[::2, ::2], jmc.PAD // 2))
                      for r in (ref0, ref1)])
    j = jmc.mc_chroma(cpads, ys >> 1, xs >> 1, mvs, bh // 2, bw // 2,
                      ref_sel=sel)
    t = tmc.mc_chroma(T(cpads), T(ys >> 1), T(xs >> 1), T(mvs), bh // 2,
                      bw // 2, T(sel))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # the index mattered: reference 0 alone fetches otherwise
    t0 = tmc.mc_luma(T(planes), T(ys), T(xs), T(mvs), bh, bw,
                     torch.zeros_like(T(sel)))
    assert not torch.equal(t0, tmc.mc_luma(T(planes), T(ys), T(xs), T(mvs),
                                           bh, bw, T(sel)))


LAYOUTS = {(16, 16): [(0, 0)], (8, 16): [(0, 0), (8, 0)],
           (16, 8): [(0, 0), (0, 8)],
           (8, 8): [(0, 0), (0, 8), (8, 0), (8, 8)]}


@pytest.mark.parametrize("steps", [(2,), (2, 1)], ids=["hpel", "qpel"])
@pytest.mark.parametrize("bh,bw", list(LAYOUTS), ids=lambda v: str(v))
def test_subpel_refine_blocks_with_ref_sel_matches_jax(steps, bh, bw):
    cur, ref0, ref1 = _textures(3 * bh + bw)
    _, planes = _stack(ref0, ref1)
    rng = np.random.default_rng(bh)
    ys, xs = _origins(LAYOUTS[(bh, bw)])
    n = len(LAYOUTS[(bh, bw)])
    mv = (rng.integers(-3, 4, (n, MB_H, MB_W, 2)) * 4).astype(np.int32)
    mvp = rng.integers(-12, 13, (n, MB_H, MB_W, 2)).astype(np.int32)
    sel = _sel(rng, ys.shape)
    blocks = np.stack([cur[y:y + bh, x:x + bw] for y, x in
                       zip(ys.reshape(-1), xs.reshape(-1))]) \
        .reshape(n, MB_H, MB_W, bh, bw)
    jmv, jsatd = jme.subpel_refine_blocks(blocks, planes, mv, LAM, mvp, ys,
                                          xs, bh, bw, steps, ref_sel=sel)
    tmv, tsatd = tme.subpel_refine_blocks(T(cur), T(planes), T(mv), LAM,
                                          T(mvp), T(ys), T(xs), bh, bw,
                                          steps, T(sel))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())
    assert ((tmv.numpy() & 3) != 0).any()


def test_subpel_refine_16x16_with_ref_sel_matches_jax():
    cur, ref0, ref1 = _textures(7)
    _, planes = _stack(ref0, ref1)
    rng = np.random.default_rng(7)
    mv = (rng.integers(-2, 3, (MB_H, MB_W, 2)) * 4).astype(np.int32)
    mvp = rng.integers(-9, 10, (MB_H, MB_W, 2)).astype(np.int32)
    sel = _sel(rng, (MB_H, MB_W))
    tiles = cur.reshape(MB_H, 16, MB_W, 16).swapaxes(1, 2)
    jmv, jsatd = jme.subpel_refine(tiles, planes, mv, LAM, mvp, (2, 1),
                                   ref_sel=sel)
    tmv, tsatd = tme.subpel_refine(T(cur), T(planes), T(mv), LAM, T(mvp),
                                   (2, 1), T(sel))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())


@pytest.mark.parametrize("with_8x8", [False, True])
def test_partition_fullpel_with_ref_sel_matches_jax(with_8x8):
    cur, ref0, ref1 = _textures(5)
    pads, _ = _stack(ref0, ref1)
    rng = np.random.default_rng(5)
    mv16 = (rng.integers(-3, 4, (MB_H, MB_W, 2)) * 4).astype(np.int32)
    mv16[0, 0] = (4 * 40 + 1, -4 * 40)           # clamped by the window
    mvp = rng.integers(-20, 21, (MB_H, MB_W, 2)).astype(np.int32)
    sel = _sel(rng, (MB_H, MB_W))
    tiles = cur.reshape(MB_H, 16, MB_W, 16).swapaxes(1, 2)
    j = jme.partition_fullpel(tiles, pads, mv16, LAM, mvp, 16, ref_sel=sel,
                              with_8x8=with_8x8)
    t = tme.partition_fullpel(T(cur), T(pads), T(mv16), LAM, T(mvp), 16,
                              with_8x8, T(sel))
    for k, tk in zip(j, t):
        np.testing.assert_array_equal(np.asarray(j[k]), tk.numpy(),
                                      err_msg=k)


def test_chroma_rerank_with_ref_sel_matches_jax():
    cur, ref0, ref1 = _textures(11)
    _, planes = _stack(ref0, ref1)
    rng = np.random.default_rng(11)
    h, w = H // 2, W // 2
    refs_c = [rng.integers(0, 256, (2, h, w)) for _ in range(2)]
    cur_u = (np.roll(refs_c[0][0], (1, -1), (0, 1))
             + rng.integers(-6, 7, (h, w))).clip(0, 255).astype(np.int32)
    cur_v = np.roll(refs_c[1][1], (1, 0), (0, 1)).astype(np.int32)
    cu_pad, cv_pad = (np.stack([np.asarray(jmc.pad_plane(
        r[k].astype(np.int32), jmc.PAD // 2)) for k in range(2)])
        for r in refs_c)
    mv = rng.integers(-9, 10, (MB_H, MB_W, 2)).astype(np.int32)
    mvp = rng.integers(-9, 10, (MB_H, MB_W, 2)).astype(np.int32)
    sel = _sel(rng, (MB_H, MB_W))
    tiles = cur.reshape(MB_H, 16, MB_W, 16).swapaxes(1, 2)
    ut = cur_u.reshape(MB_H, 8, MB_W, 8).swapaxes(1, 2)
    vt = cur_v.reshape(MB_H, 8, MB_W, 8).swapaxes(1, 2)
    ys, xs = (a[0] for a in _origins([(0, 0)]))
    center = np.asarray(jpix.satd(tiles, jmc.mc_luma(planes, ys, xs, mv, 16,
                                                     16, ref_sel=sel)))
    jmv, jsatd = jme.chroma_rerank(tiles, planes, ut, vt, cu_pad, cv_pad, mv,
                                   LAM, mvp, ref_sel=sel, center_satd=center)
    tmv, tsatd = tme.chroma_rerank(T(cur), T(planes), T(cur_u), T(cur_v),
                                   T(cu_pad), T(cv_pad), T(mv), LAM, T(mvp),
                                   T(center), T(sel))
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jsatd), tsatd.numpy())
    assert (tmv.numpy() != mv).any()


# ------------------------------------------------------- the P body
QP = 26


def _flash():
    """A flash triple (L0[1], L0[0], the source) in the manner of
    tests/test_multiref.py: a static texture with a band that alternates
    between two noise patterns (period 2), so the older reference holds
    the band exactly and the newer one does not; a flat patch in the
    source that neither holds (intra); each reference with a little
    noise of its own."""
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (128 + 50 * np.sin(yy / 6.0) * np.cos(xx / 9.0)
            + rng.integers(0, 30, (H, W)))
    pat = [rng.integers(0, 256, (24, W)) for _ in range(2)]
    out = []
    for t in range(3):
        y = base.copy()
        y[16:40] = pat[t % 2]
        if t < 2:
            y = y + rng.integers(-2, 3, (H, W))
        else:
            y[48:64, 16:48] = 90 + xx[48:64, 16:48] // 4
        u = ((y[::2, ::2] + 30) % 250)
        v = ((255 - y[1::2, ::2]) % 250)
        out += [np.clip(a, 0, 255).astype(np.int32) for a in (y, u, v)]
    return out


def _params(cls):
    p = cls(i_width=W, i_height=H, i_log_level=0, i_frame_reference=2)
    p.analyse.i_subpel_refine = 6
    return p


@functools.lru_cache(maxsize=None)
def _bodies():
    """x264_tpu's encode_p_body with n_refs 2 (jitted once) and the port's
    plain one on the flash triple, each with its own Encoder's qtab at the
    defaults' settings (CRF + AQ: the 52-QP tables) and one seeded QP
    map."""
    r2y, r2u, r2v, ry, ru, rv, y, u, v = _flash()
    qp_c = jtables.chroma_qp(QP)
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams))
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams),
                                  device="cpu")
    assert tenc._t8 and tenc._rd and tenc._p8x8 and tenc._chroma_me
    jq, tq = jenc._qtab_p(QP, qp_c), tenc._qtab_p(QP, qp_c)
    qp_map = np.random.default_rng(4).integers(QP - 6, QP + 7,
                                               (MB_H, MB_W)).astype(np.int32)
    qpc_map = np.asarray(jtables.CHROMA_QP_TABLE)[np.clip(qp_map, 0, 51)] \
        .astype(np.int32)
    lam = int(jtables.LAMBDA_TABLE[QP])
    mvp = np.random.default_rng(5).integers(-6, 7, (MB_H, MB_W, 2)) \
        .astype(np.int32)
    jbody = jax.jit(functools.partial(
        jinter.encode_p_body, MB_H, MB_W, 16, subpel_steps=(2, 1),
        parts=True, n_refs=2, t8=True, rd=True, decimate=True, p8x8=True,
        chroma_me=True))
    jo = {k: np.asarray(a) for k, a in jbody(
        y, u, v, ry, ru, rv, jq, lam, mvp, ref2_y=r2y, ref2_u=r2u,
        ref2_v=r2v, qp_map=qp_map, qpc_map=qpc_map).items()}
    to = tinter.encode_p_body(MB_H, MB_W, 16, T(y), T(u), T(v), T(ry),
                              T(ru), T(rv), tq, lam, T(mvp), True, (2, 1),
                              True, True, True, True, True, T(qp_map),
                              ref2=(T(r2y), T(r2u), T(r2v)))
    return jo, to


def test_encode_p_body_two_refs_matches_jax():
    jo, to = _bodies()
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k].numpy(), err_msg=k)
    ref = to["ref_idx"].numpy()
    im = to["intra_mb"].numpy()
    on1 = (ref == 1) & ~im
    on0 = (ref == 0) & ~im
    assert on1.any() and on0.any() and im.any(), (ref, im)
    # a ref-0 MB with a ref-1 neighbour on its left or above: the MV
    # prediction's i_ref matching decides there
    nb1 = np.zeros_like(on1)
    nb1[:, 1:] |= on1[:, :-1]
    nb1[1:, :] |= on1[:-1, :]
    assert (on0 & nb1).any()
    # ref4 carries the choice; no ref-1 MB is skipped
    ref4 = to["ref4"].numpy()
    assert set(np.unique(ref4)) == {-1, 0, 1}
    assert not (to["skip"].numpy() & on1).any()


def test_p_slice_ops_two_refs_matches_jax():
    jo, to = _bodies()
    jops, jn = jax.jit(lambda o: jcp.compact_ops(
        jcp.p_slice_ops(o, MB_H, MB_W, 2, t8_mode=True),
        jpipe.cabac_capacity(MB_H * MB_W)))(jo)
    tops, tn = tcp.compact_ops(tcp.p_slice_ops(to, MB_H, MB_W, 2,
                                               t8_mode=True),
                               tcp.capacity(MB_H * MB_W))
    n = int(jn)
    assert int(tn) == n
    ops = tops.numpy()[:n].view(np.uint32)
    np.testing.assert_array_equal(np.asarray(jops)[:n], ops)
    # the ref_idx bins (decisions at ctx 54-58) are in the stream
    ctx, kind = ops & 0x1FFFF, ops >> 29
    assert ((kind == tcp.KIND_DECISION) & (ctx >= 54) & (ctx <= 58)).any()


def test_p_code_planes_two_refs_matches_jax():
    jo, to = _bodies()
    jv, jl = jdev.p_code_planes({k: jnp.asarray(v) for k, v in jo.items()},
                                MB_H, MB_W, 2)
    tv, tl = tdev.p_code_planes(to, MB_H, MB_W, 2)
    np.testing.assert_array_equal(np.asarray(jl).astype(np.int64),
                                  tl.numpy())
    np.testing.assert_array_equal(
        np.where(np.asarray(jl) > 0, np.asarray(jv), 0).astype(np.int64),
        torch.where(tl > 0, tv, 0).numpy())
    # one ref_idx bit per partition of every coded inter MB
    nslot = tdev.P_HDR_SLOTS + 27 * tdev.BLOCK_SLOTS
    hdr = tl[:-1].reshape(MB_H * MB_W, nslot)[:, 7:11]
    coded_inter = ~(to["skip"] | to["intra_mb"]).reshape(-1)
    assert bool((hdr[coded_inter, 0] == 1).all())

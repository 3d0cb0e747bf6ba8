"""The port's CUDA / Triton kernels against their plain PyTorch versions
on the card, at small frames (K1-K15, K6 and K8 also with random
partition layouts and quarter-pel MVs, K7 also with the RD decision; K1
with I8x8, K3 / K2 on its output, K6 / K13 / K8 / K2 with the 8x8
transform), and the card's Encoder against the CPU's at subme 1, 2, 5
and 6 (the last with the scenecut lookahead, and at x264_tpu's defaults
with the 8x8 transform and I8x8).
Marked `cuda`: they skip where there is no card. On a machine with one:

    python -m pytest --noconftest tests/test_torch_kernels.py

(--noconftest because tests/conftest.py sets up JAX for the reference's
tests; these import only the port)."""

import numpy as np
import pytest
import torch

import x264_tpu_torch
from x264_tpu_torch import tables
from x264_tpu_torch.encoder import inter, intra, lookahead, pipeline, stats
from x264_tpu_torch.entropy import cabac_planes
from x264_tpu_torch.ops import deblock, mc, me

MB_H, MB_W = 5, 7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frame(dev, seed=0):
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    return (t(((xx // 3 + yy // 2) % 200 + rng.integers(0, 24, (h, w)))
              .clip(0, 255)),
            t(rng.integers(0, 256, (h // 2, w // 2))),
            t(128 + rng.integers(-20, 20, (h // 2, w // 2))))


def _blocky(dev, seed=3):
    """A directional gradient under 8x8-blocky noise, which I8x8 fits."""
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    low = np.kron(rng.integers(-20, 20, (h // 8, w // 8)), np.ones((8, 8)))
    t = lambda a: torch.as_tensor(np.clip(a, 0, 255), dtype=torch.int32,
                                  device=dev)
    return (t((yy * 2 + xx * 3) // 2 % 256 + low),
            t(128 + xx[::2, ::2] // 4), t(128 - yy[::2, ::2] // 4))


def _intra(dev, qp=26, i8x8=False):
    y, u, v = _blocky(dev) if i8x8 else _frame(dev, qp)
    q = intra.make_qtab(qp, tables.chroma_qp(qp), dev)
    lam = int(tables.LAMBDA_TABLE[qp])
    return (y, u, v), intra.encode_i16_frame(MB_H, MB_W, y, u, v, q, lam,
                                             i8x8), (q, lam)


@pytest.mark.cuda
@pytest.mark.parametrize("qp,i8x8", [(18, False), (26, False), (38, False),
                                     (26, True), (38, True)])
def test_intra_kernel_matches_plain(card, qp, i8x8):
    (y, u, v), k, (q, lam) = _intra(card, qp, i8x8)
    p = intra.encode_i16_frame_plain(MB_H, MB_W, y, u, v, q, lam, i8x8)
    assert set(k) == set(p)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    if i8x8:
        assert p["t8_mb"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("qp,i8x8", [(18, False), (38, False), (26, True)])
def test_cabac_ops_kernel_matches_plain(card, qp, i8x8):
    _, out, _ = _intra(card, qp, i8x8)
    k_ops, k_n = cabac_planes.i_slice_ops(out, MB_H, MB_W, i8x8)
    p_ops, p_n = cabac_planes.i_slice_ops_plain(out, MB_H, MB_W, i8x8)
    n = int(p_n)
    assert int(k_n) == n and torch.equal(k_ops[:n], p_ops[:n])


def _deblock_maps(kind, dev):
    """The slice's all-intra maps, or random qp / intra / nnz / ref / mv
    maps of the kind a P slice gives, with nonzero filter offsets."""
    if kind == "intra":
        intra_mb, z4, zmv = pipeline._zero_maps(MB_H, MB_W, dev)
        qp_mb = torch.full((MB_H, MB_W), 26, dtype=torch.int32, device=dev)
        return (qp_mb, intra_mb, z4, z4, zmv, z4, zmv, False, 0, 0, 0)
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, device=dev)
    h4, w4 = MB_H * 4, MB_W * 4
    i32 = lambda a: t(a.astype(np.int32))
    return (i32(rng.integers(20, 46, (MB_H, MB_W))),
            t(rng.random((MB_H, MB_W)) < 0.3),
            i32(rng.integers(0, 2, (h4, w4))),
            i32(rng.integers(0, 2, (h4, w4))),
            i32(rng.integers(-8, 8, (h4, w4, 2))),
            i32(np.zeros((h4, w4))), i32(np.zeros((h4, w4, 2))),
            False, -2, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["intra", "random", "i8x8"])
def test_deblock_kernel_matches_plain(card, kind):
    """i8x8: the IDR maps with the t8_mb map of an I8x8 frame."""
    _, out, _ = _intra(card, 26, kind == "i8x8")
    args = _deblock_maps("random" if kind == "random" else "intra", card)
    if kind == "i8x8":
        args = (*args, out["t8_mb"])
    src = [out[k] for k in ("recon_y", "recon_u", "recon_v")]
    p = deblock.deblock_frame_plain(MB_H, MB_W, *src, *args)
    k = deblock.deblock_frame(MB_H, MB_W, *[t.clone() for t in src], *args)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert not torch.equal(p[0], src[0])        # the filter acted


@pytest.mark.cuda
@pytest.mark.parametrize("crop", [(0, 0), (6, 4)])
def test_metrics_kernel_matches_plain(card, crop):
    (y, u, v), out, _ = _intra(card)
    r = [out[k] for k in ("recon_y", "recon_u", "recon_v")]
    w, h = MB_W * 16 - crop[0], MB_H * 16 - crop[1]
    k = stats.frame_metrics(y, u, v, *r, w, h).double()
    p = stats.frame_metrics_plain(y, u, v, *r, w, h).double()
    rel = (k - p).abs() / p.abs()
    assert rel[:3].max() <= 1e-6 and rel[3] <= 1e-5


@pytest.mark.cuda
def test_encoder_on_the_card_matches_the_cpu(card):
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(7)
    frames = [x264_tpu_torch.Frame(
        rng.integers(0, 256, (h, w), dtype=np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for _ in range(3)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_keyint_max=1, i_log_level=0,
                                         i_frame_parallel=3)
        p.rc.i_rc_method, p.rc.i_qp_constant = 0, 30
        p.analyse.b_transform_8x8 = False
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return enc.headers(), outs, enc.close()

    (kh, kout, ksum), (ph, pout, psum) = run(card), run("cpu")
    assert kh == ph and len(kout) == len(pout) == 3
    for a, b in zip(kout, pout):
        assert a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(), getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5


def _p_frame(dev, kind, qp=26):
    """Frame 1 and a reference: the reference moved by a few pixels
    ("inter"), or with 2x2-MB gray blocks that send MBs intra in chains
    deeper than the three sweeps ("intra"), or ("t8") a blocky gradient
    moved, with a different level on each 8x8 block of the reference, a
    residual that the 8x8 transform codes best."""
    if kind == "t8":
        y, u, v = _blocky(dev)
        ref = [torch.roll(t, (2, 2), (0, 1)) for t in (y, u, v)]
        off = np.kron(np.random.default_rng(5).integers(
            -6, 7, (MB_H * 2, MB_W * 2)), np.ones((8, 8), np.int64))
        ref[0] = (ref[0] + torch.as_tensor(off, dtype=torch.int32,
                                           device=dev)).clamp(0, 255)
        q = inter.make_qtab_p(qp, tables.chroma_qp(qp), dev)
        return (y, u, v), ref, q, int(tables.LAMBDA_TABLE[qp])
    y, u, v = _frame(dev, 3)
    ref = [torch.roll(t, (2, 3), (0, 1)) for t in (y, u, v)]
    if kind == "intra":
        g = torch.as_tensor(np.random.default_rng(2).random(
            ((MB_H + 1) // 2, (MB_W + 1) // 2)) < 0.5, device=dev)
        g = g.repeat_interleave(2, 0).repeat_interleave(2, 1)[:MB_H, :MB_W]
        ref = [torch.where(g.repeat_interleave(n, 0).repeat_interleave(n, 1),
                           128, t) for t, n in zip(ref, (16, 8, 8))]
    q = inter.make_qtab_p(qp, tables.chroma_qp(qp), dev)
    return (y, u, v), ref, q, int(tables.LAMBDA_TABLE[qp])


def _mvp(dev, seed=4):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        -140, 141, (MB_H, MB_W, 2)), dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mvp_kind", ["zero", "wide"])
def test_me_kernel_matches_plain(card, mvp_kind):
    (y, _, _), ref, _, lam = _p_frame(card, "inter")
    mvp = _mvp(card) if mvp_kind == "wide" else \
        torch.zeros((MB_H, MB_W, 2), dtype=torch.int32, device=card)
    args = (y, mc.pad_plane(ref[0]), MB_H, MB_W, 16, lam, mvp)
    kmv, ksad = me.hier_search(*args)
    pmv, psad = me.hier_search_plain(*args)
    assert torch.equal(kmv, pmv) and torch.equal(ksad, psad)


def _inter_args(dev, kind, decimate, wild_mvs=False, parts=False):
    """K6's arguments on frame 1: full-pel ME MVs on one plane, or (wild)
    MVs whose fetch starts wrap and clamp; with parts, the half-pel stack
    and random partition types with random quarter-pel quadrant MVs.
    Also returns the 16x16 cost K7 compares."""
    (y, u, v), ref, q, lam = _p_frame(dev, kind)
    pads = (mc.pad_plane(ref[0]), mc.pad_plane(ref[1], mc.PAD // 2),
            mc.pad_plane(ref[2], mc.PAD // 2))
    mvp = torch.zeros((MB_H, MB_W, 2), dtype=torch.int32, device=dev)
    mv, sad = me.hier_search(y, pads[0], MB_H, MB_W, 16, lam, mvp)
    cost = sad + lam * (me.mv_cost_bits(mv, mvp) + 1)
    if wild_mvs:                 # full-pel, fetch starts wrap and clamp
        mv = _mvp(dev, 8) * 4
    ptype = torch.zeros((MB_H, MB_W), dtype=torch.int32, device=dev)
    mv_quad = mv[:, :, None].expand(MB_H, MB_W, 4, 2).contiguous()
    planes = pads[0][None]
    if parts:
        rng = np.random.default_rng(9)
        ptype = torch.as_tensor(rng.integers(0, 4, (MB_H, MB_W)),
                                dtype=torch.int32, device=dev)
        mv_quad = mv_quad + torch.as_tensor(rng.integers(
            -9, 10, (MB_H, MB_W, 4, 2)), dtype=torch.int32, device=dev)
        planes = mc.hpel_planes(pads[0])
    return (MB_H, MB_W, y, u, v, planes, *pads[1:], ptype, mv_quad, q,
            decimate), cost


@pytest.mark.cuda
@pytest.mark.parametrize("decimate,wild,parts,t8", [
    (True, False, False, 0), (False, False, False, 0), (True, True, False, 0),
    (True, False, True, 0), (False, True, True, 0),
    (True, False, True, inter.T8_SA8D), (False, True, True, inter.T8_SA8D),
    (True, False, True, inter.T8_RD)])
def test_inter_kernel_matches_plain(card, decimate, wild, parts, t8):
    """t8: the 8x8 transform with the SA8D choice (subme 5) or both
    codings for the RD choice (subme 6)."""
    args, _ = _inter_args(card, "inter", decimate, wild, parts)
    k = inter.p_inter_mb(*args, t8)
    p = inter.p_inter_mb_plain(*args, t8)
    assert set(k) == set(p)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    if t8 == inter.T8_SA8D:
        assert p["t8_sel"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_intra_in_p_kernel_matches_plain(card, kind):
    a, cost = _inter_args(card, kind, True)
    (y, u, v), q = a[2:5], a[10]
    lam = int(tables.LAMBDA_TABLE[26])
    it = inter.p_inter_mb(*a)
    args = (MB_H, MB_W, y, u, v, it["recon_y"], it["recon_u"],
            it["recon_v"], cost, q, lam, True)
    k = inter.intra_in_p(*args)
    p = inter.intra_in_p_plain(*args)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    if kind == "intra":
        assert p["intra_mb"].any()


def _rd_args(dev, kind, psy, big, t8=False):
    """K13's arguments on frame 1 with random partitions (K6's real
    outputs, with both luma codings where t8), or with crafted level
    planes of large levels; the P qtab carries the RD tables, with psy-RD
    1.0 or off."""
    a, cost = _inter_args(dev, kind, True, parts=True)
    (y, u, v), ptype, mv_quad = a[2:5], a[8], a[9]
    q = inter.make_qtab_p(26, tables.chroma_qp(26), dev, rd_idc=0,
                          f_psy_rd=1.0 if psy else 0.0)
    it = inter.p_inter_mb(*a[:10], q, True,
                          inter.T8_RD if t8 else inter.T8_OFF)
    if big:
        rng = np.random.default_rng(4)
        t = lambda lo, hi, ref: torch.as_tensor(
            rng.integers(lo, hi, ref.shape) * (rng.random(ref.shape) < 0.4),
            dtype=torch.int32, device=dev)
        it = dict(it, blocks_z=t(-3000, 3000, it["blocks_z"]),
                  chroma_ac=t(-40, 41, it["chroma_ac"]),
                  chroma_dc=t(-70000, 70001, it["chroma_dc"]))
        if t8:
            it["blocks8_z"] = t(-3000, 3000, it["blocks8_z"])
    mvp = _mvp(dev, 8)
    return (MB_H, MB_W, y, u, v, it, ptype, mv_quad, mvp, q), cost


@pytest.mark.cuda
@pytest.mark.parametrize("psy,big,t8", [(True, False, False),
                                        (False, False, False),
                                        (True, True, False),
                                        (True, False, True),
                                        (False, False, True),
                                        (True, True, True)])
def test_rd_inter_kernel_matches_plain(card, psy, big, t8):
    """t8: the RD choice between the 4x4 and 8x8 codings too."""
    args, _ = _rd_args(card, "t8" if t8 else "inter", psy, big, t8)
    k = inter.rd_inter(*args)
    p = inter.rd_inter_plain(*args)
    assert len(k) == len(p) == (3 if t8 else 2)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if t8:
        for key in p[2]:
            assert torch.equal(k[2][key], p[2][key]), key
        assert p[2]["t8_sel"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,psy", [("inter", True), ("intra", True),
                                      ("intra", False)])
def test_intra_in_p_rd_kernel_matches_plain(card, kind, psy):
    args, cost = _rd_args(card, kind, psy, False)
    it, q = args[5], args[9]
    rd = inter.rd_inter(*args)[:2]
    a7 = (MB_H, MB_W, *args[2:5], it["recon_y"], it["recon_u"],
          it["recon_v"], cost, q, int(tables.LAMBDA_TABLE[26]), True)
    k = inter.intra_in_p(*a7, rd=rd)
    p = inter.intra_in_p_plain(*a7, rd=rd)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    if kind == "intra":
        assert p["intra_mb"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(MB_H * 16 - 4, MB_W * 16 - 6), (135, 240)])
def test_lookahead_kernels_match_plain(card, h, w):
    rng = np.random.default_rng(h)
    ys = [torch.as_tensor(np.pad(rng.integers(0, 256, (h, w)) // 2 * 2,
                                 ((0, -h % 16), (0, -w % 16)), mode="edge"),
                          dtype=torch.int32, device=card) for _ in range(2)]
    ys[1][4:, 6:] = ys[0][:-4, :-6].clone()      # mostly a move of frame 0
    bh, bw = lookahead.block_grid(h, w)
    prev = None
    for y in ys:
        lows = lookahead.lowres_planes(y, h, w)
        assert torch.equal(lows, lookahead.lowres_planes_plain(y, h, w))
        for r in (4, 8):
            k = lookahead.lowres_cost(lows, prev, bh, bw, r)
            p = lookahead.lowres_cost_plain(lows, prev, bh, bw, r)
            for a, b in zip(k, p):
                assert (a is None and b is None) or torch.equal(a, b)
        prev = lows


@pytest.mark.cuda
def test_hpel_kernel_matches_plain(card):
    rng = np.random.default_rng(3)
    p = torch.as_tensor(np.where(rng.random((MB_H * 16 + 64, MB_W * 16 + 64))
                                 < 0.5, 0, 255), dtype=torch.int32,
                        device=card)
    assert torch.equal(mc.hpel_planes(p), mc.hpel_planes_plain(p))
    (_, _, _), ref, _, _ = _p_frame(card, "inter")
    pad = mc.pad_plane(ref[0])
    assert torch.equal(mc.hpel_planes(pad), mc.hpel_planes_plain(pad))


def _subpel_args(dev):
    (y, u, v), ref, q, lam = _p_frame(dev, "inter")
    pad = mc.pad_plane(ref[0])
    mvp = _mvp(dev, 5) // 8
    mv, _ = me.hier_search(y, pad, MB_H, MB_W, 16, lam, mvp)
    return (y, u, v), ref, pad, mc.hpel_planes(pad), mv, mvp, q, lam


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [(2,), (2, 1)])
@pytest.mark.parametrize("layout", range(4))
def test_subpel_kernel_matches_plain(card, steps, layout):
    (y, _, _), _, _, planes, mv, mvp, _, lam = _subpel_args(card)
    bh, bw, offs, _ = (((16, 16, ((0, 0),), None),)
                       + inter.PART_LAYOUTS)[layout]
    ys, xs = inter._block_origins(MB_H, MB_W, offs, card)
    n = len(offs)
    mvs = mv.expand(n, MB_H, MB_W, 2) + torch.as_tensor(
        np.random.default_rng(layout).integers(-2, 3, (n, MB_H, MB_W, 2))
        * 4, dtype=torch.int32, device=card)
    args = (y, planes, mvs.contiguous(), lam,
            mvp.expand(n, MB_H, MB_W, 2).contiguous(), ys, xs, bh, bw, steps)
    k = me.subpel_refine_blocks(*args)
    p = me.subpel_refine_blocks_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("with_8x8", [False, True])
def test_part_fullpel_kernel_matches_plain(card, with_8x8):
    (y, _, _), _, pad, _, mv, mvp, _, lam = _subpel_args(card)
    for mv16 in (mv, _mvp(card, 6) * 4 + 1):     # near, and clamped
        args = (y, pad, mv16, lam, mvp, 16, with_8x8)
        assert torch.equal(me.partition_fullpel(*args),
                           me.partition_fullpel_plain(*args))


@pytest.mark.cuda
def test_chroma_rerank_kernel_matches_plain(card):
    (y, u, v), ref, _, planes, mv, mvp, _, lam = _subpel_args(card)
    mv_s, satd = me.subpel_refine(y, planes, mv, lam, mvp, (2, 1))
    args = (y, planes, u, v, mc.pad_plane(ref[1], mc.PAD // 2),
            mc.pad_plane(ref[2], mc.PAD // 2), mv_s, lam, mvp, satd)
    k = me.chroma_rerank(*args)
    p = me.chroma_rerank_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["inter", "intra", "partitions", "t8",
                                  "t8_rd"])
def test_cabac_p_ops_and_p_deblock_kernels_match_plain(card, kind):
    """t8 / t8_rd: the 8x8 transform at subme 5 (SA8D choice) and at
    subme 6 (RD choice): t8_mb, the 8x8 nnz cells, the flag, the cat-5
    blocks, and K2 with the t8_mb map."""
    t8 = kind.startswith("t8")
    (y, u, v), ref, q, lam = _p_frame(card, "t8" if t8 else "intra"
                                      if kind == "intra" else "inter")
    if kind == "t8_rd":
        q = inter.make_qtab_p(26, tables.chroma_qp(26), card, rd_idc=0,
                              f_psy_rd=1.0)
    subpel = ((2, 1), True, True, True, kind == "t8_rd", t8) \
        if kind == "partitions" or t8 else ()
    front = inter.encode_p_front(MB_H, MB_W, 16, y, u, v, *ref, q, lam,
                                 _mvp(card), True, *subpel)
    if kind == "partitions":     # every layout, whatever the search chose
        rng = np.random.default_rng(12)
        front["ptype"] = torch.as_tensor(rng.integers(0, 4, (MB_H, MB_W)),
                                         dtype=torch.int32, device=card)
        front["mv_quad"] = front["mv_quad"] + torch.as_tensor(
            rng.integers(-9, 10, (MB_H, MB_W, 4, 2)), dtype=torch.int32,
            device=card)
    kmaps, kops, kn = cabac_planes.cabac_p_ops(front, MB_H, MB_W, t8_mode=t8)
    pmaps, pops, pn = cabac_planes.cabac_p_ops_plain(front, MB_H, MB_W, t8)
    n = int(pn)
    assert int(kn) == n and torch.equal(kops[:n], pops[:n])
    assert set(kmaps) == set(pmaps)
    for key in pmaps:
        assert torch.equal(kmaps[key], pmaps[key]), key
    if t8:
        assert pmaps["t8_mb"].any()
    # K2 with the P maps: bS 0 / 1 / 2 from nnz, ref and mv
    z4 = torch.zeros_like(kmaps["ref4"])
    qp_mb = torch.full((MB_H, MB_W), 26, dtype=torch.int32, device=card)
    maps = (qp_mb, front["intra_mb"], kmaps["nnz4"], kmaps["ref4"],
            kmaps["mv4"], z4, torch.zeros_like(kmaps["mv4"]), False, 0, 0, 0,
            kmaps.get("t8_mb"))
    src = [front[k] for k in ("recon_y", "recon_u", "recon_v")]
    p = deblock.deblock_frame_plain(MB_H, MB_W, *src, *maps)
    k = deblock.deblock_frame(MB_H, MB_W, *[t.clone() for t in src], *maps)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_parallel,subme,t8", [
    (1, 1, False), (3, 1, False), (1, 2, False), (3, 5, False),
    (3, 6, False), (3, 6, True)])
def test_ippp_encoder_on_the_card_matches_the_cpu(card, frame_parallel,
                                                  subme, t8):
    """keyint 3 at scenecut 0, or at subme 6 with scenecut 40 (keyint_min
    then 2), where the lookahead may call a cut on the noise; t8: x264_tpu's
    defaults at CQP, with the 8x8 transform and I8x8."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (h + 8, w + 16), dtype=np.uint8)
    frames = [x264_tpu_torch.Frame(
        base[t:t + h, 2 * t:2 * t + w].copy(),
        np.full((h // 2, w // 2), 100 + 3 * t, np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for t in range(5)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_keyint_max=3, i_log_level=0,
                                         i_frame_parallel=frame_parallel)
        p.rc.i_rc_method, p.rc.i_qp_constant = 0, 28
        p.analyse.b_transform_8x8 = t8
        p.i_scenecut_threshold = 40 if subme >= 6 else 0
        p.analyse.i_subpel_refine = subme
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return enc.headers(), outs, enc.close()

    (kh, kout, ksum), (ph, pout, psum) = run(card), run("cpu")
    assert kh == ph and len(kout) == len(pout) == 5
    if subme < 6:
        assert [o.frame_type for o in kout] == ["IDR", "P", "P", "IDR", "P"]
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5

"""The port's CUDA / Triton kernels against their plain PyTorch versions
on the card, at small frames (K1-K15, K6 and K8 also with random
partition layouts and quarter-pel MVs, K7 also with the RD decision),
and the card's Encoder against the CPU's at subme 1, 2, 5 and 6 (the
last with the scenecut lookahead).
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


def _intra(dev, qp=26):
    y, u, v = _frame(dev, qp)
    q = intra.make_qtab(qp, tables.chroma_qp(qp), dev)
    lam = int(tables.LAMBDA_TABLE[qp])
    return (y, u, v), intra.encode_i16_frame(MB_H, MB_W, y, u, v, q, lam), \
        (q, lam)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [18, 26, 38])
def test_intra_kernel_matches_plain(card, qp):
    (y, u, v), k, (q, lam) = _intra(card, qp)
    p = intra.encode_i16_frame_plain(MB_H, MB_W, y, u, v, q, lam)
    for key in p:
        assert torch.equal(k[key], p[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [18, 38])
def test_cabac_ops_kernel_matches_plain(card, qp):
    _, out, _ = _intra(card, qp)
    k_ops, k_n = cabac_planes.i_slice_ops(out, MB_H, MB_W)
    p_ops, p_n = cabac_planes.i_slice_ops_plain(out, MB_H, MB_W)
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
@pytest.mark.parametrize("kind", ["intra", "random"])
def test_deblock_kernel_matches_plain(card, kind):
    _, out, _ = _intra(card)
    args = _deblock_maps(kind, card)
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
    deeper than the three sweeps ("intra")."""
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
@pytest.mark.parametrize("decimate,wild,parts", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True), (False, True, True)])
def test_inter_kernel_matches_plain(card, decimate, wild, parts):
    args, _ = _inter_args(card, "inter", decimate, wild, parts)
    k = inter.p_inter_mb(*args)
    p = inter.p_inter_mb_plain(*args)
    for key in p:
        assert torch.equal(k[key], p[key]), key


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


def _rd_args(dev, kind, psy, big):
    """K13's arguments on frame 1 with random partitions (K6's real
    outputs), or with crafted level planes of large levels; the P qtab
    carries the RD tables, with psy-RD 1.0 or off."""
    a, cost = _inter_args(dev, kind, True, parts=True)
    (y, u, v), ptype, mv_quad = a[2:5], a[8], a[9]
    q = inter.make_qtab_p(26, tables.chroma_qp(26), dev, rd_idc=0,
                          f_psy_rd=1.0 if psy else 0.0)
    it = inter.p_inter_mb(*a[:10], q, True)
    if big:
        rng = np.random.default_rng(4)
        t = lambda lo, hi, ref: torch.as_tensor(
            rng.integers(lo, hi, ref.shape) * (rng.random(ref.shape) < 0.4),
            dtype=torch.int32, device=dev)
        it = dict(it, blocks_z=t(-3000, 3000, it["blocks_z"]),
                  chroma_ac=t(-40, 41, it["chroma_ac"]),
                  chroma_dc=t(-70000, 70001, it["chroma_dc"]))
    mvp = _mvp(dev, 8)
    return (MB_H, MB_W, y, u, v, it, ptype, mv_quad, mvp, q), cost


@pytest.mark.cuda
@pytest.mark.parametrize("psy,big", [(True, False), (False, False),
                                     (True, True)])
def test_rd_inter_kernel_matches_plain(card, psy, big):
    args, _ = _rd_args(card, "inter", psy, big)
    k = inter.rd_inter(*args)
    p = inter.rd_inter_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,psy", [("inter", True), ("intra", True),
                                      ("intra", False)])
def test_intra_in_p_rd_kernel_matches_plain(card, kind, psy):
    args, cost = _rd_args(card, kind, psy, False)
    it, q = args[5], args[9]
    rd = inter.rd_inter(*args)
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
@pytest.mark.parametrize("kind", ["inter", "intra", "partitions"])
def test_cabac_p_ops_and_p_deblock_kernels_match_plain(card, kind):
    (y, u, v), ref, q, lam = _p_frame(card, "intra" if kind == "intra"
                                      else "inter")
    subpel = ((2, 1), True, True, True) if kind == "partitions" else ()
    front = inter.encode_p_front(MB_H, MB_W, 16, y, u, v, *ref, q, lam,
                                 _mvp(card), True, *subpel)
    if kind == "partitions":     # every layout, whatever the search chose
        rng = np.random.default_rng(12)
        front["ptype"] = torch.as_tensor(rng.integers(0, 4, (MB_H, MB_W)),
                                         dtype=torch.int32, device=card)
        front["mv_quad"] = front["mv_quad"] + torch.as_tensor(
            rng.integers(-9, 10, (MB_H, MB_W, 4, 2)), dtype=torch.int32,
            device=card)
    kmaps, kops, kn = cabac_planes.cabac_p_ops(front, MB_H, MB_W)
    pmaps, pops, pn = cabac_planes.cabac_p_ops_plain(front, MB_H, MB_W)
    n = int(pn)
    assert int(kn) == n and torch.equal(kops[:n], pops[:n])
    for key in pmaps:
        assert torch.equal(kmaps[key], pmaps[key]), key
    # K2 with the P maps: bS 0 / 1 / 2 from nnz, ref and mv
    z4 = torch.zeros_like(kmaps["ref4"])
    qp_mb = torch.full((MB_H, MB_W), 26, dtype=torch.int32, device=card)
    maps = (qp_mb, front["intra_mb"], kmaps["nnz4"], kmaps["ref4"],
            kmaps["mv4"], z4, torch.zeros_like(kmaps["mv4"]), False, 0, 0, 0)
    src = [front[k] for k in ("recon_y", "recon_u", "recon_v")]
    p = deblock.deblock_frame_plain(MB_H, MB_W, *src, *maps)
    k = deblock.deblock_frame(MB_H, MB_W, *[t.clone() for t in src], *maps)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_parallel,subme", [(1, 1), (3, 1), (1, 2),
                                                  (3, 5), (3, 6)])
def test_ippp_encoder_on_the_card_matches_the_cpu(card, frame_parallel,
                                                  subme):
    """keyint 3 at scenecut 0, or at subme 6 with scenecut 40 (keyint_min
    then 2), where the lookahead may call a cut on the noise."""
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
        p.analyse.b_transform_8x8 = False
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

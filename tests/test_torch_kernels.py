"""The port's CUDA kernels against their plain PyTorch versions
on the card, at small frames (K1-K24 and K8's pass A alone, K6 and K8
also with random partition layouts and quarter-pel MVs, K7 also with
the RD decision; K1 with I8x8, K3 / K2 on its output, K6 / K13 / K8 / K2
with the 8x8 transform; K1 / K3 / K6 / K7 / K8 / K2 / K18 / K19 with a
variance-AQ QP map; K18 / K19 with codes dropped past a small
capacity), and the card's Encoder against the CPU's at subme 1, 2, 5
and 6 (the last with the scenecut lookahead, and at x264_tpu's defaults
with the 8x8 transform and I8x8, at CQP and at CRF with variance AQ),
and with CAVLC at the defaults and all-intra at CQP; K20 at every
trellis category, shared and stacked, K6's trellis branch at t8 0 / 1 / 2
with and without a QP map, and the card's Encoder with --trellis 1 and 2
against the CPU's; K21 with one and two references and the bi candidate,
K22's two passes, K7's B decision and sweeps, K23, K24 and K2's B rule
(with and without the trellis), and the card's Encoder with i_bframe 3 at
b-adapt 0, 1 and 2 against the CPU's; the two-reference branches of K10,
K11, K12, K6, K13, K8, K8's pass A and K19, K2 on a ref4 with reference
1, K24's pass A alone and K25, and the card's Encoder with --ref 3 / 2 and
B frames under CABAC and CAVLC against the CPU's; K26 on |coef| grids
whose window trees XLA combines in each of its orders, K6's NR branch at
t8 0 / 1 / 2 with the trellis and a QP map, the lossless branches of K1,
K6 and K7, and the card's Encoder with --nr + the JVT matrices and at
CQP 0 (CABAC and CAVLC) against the CPU's; K1's I16x16-only branch (alone,
with I8x8, lossless, with a QP map) and its frame axis, K29
fullpel_search (R = 4, 16 and 40, flat references, a far predictor), K30
hadamard_ac, encode_gop_intra over [card] * 2 and lowres_plane; K2's row
wavefront at one MB row, one MB column, 3 x 2 and 40 x 2 MBs with
intra, P, B and t8 maps, 10 runs each, and two calls back to back; K1
one and two MBs wide with I8x8, under a QP map, without I4x4 and
lossless; K20 on tie-heavy rows (trellis.tie_coefs, lam2 0 and 1e7,
stack rows at QP 0 / 1 / 51), K6's trellis kernel at the edges (a
zero-residual MB row, QP 1, QP-map rows 0 / 1 / 51), K22 with the
trellis at QP 4 and 51, K10 on flat content at lam 0, from the corners
into the pad, and its one launch for the partition layouts; K7 (P
sequence, with RD, a QP map and lossless, and both B sequences) one MB
wide and one MB tall with no, some and every MB wanting intra, and K4 on
partial tiles and odd crops, bit-identical from call to call.
Marked `cuda`: they skip where there is no card. On a machine with one:

    python -m pytest --noconftest tests/test_torch_kernels.py

(--noconftest because tests/conftest.py sets up JAX for the reference's
tests; these import only the port)."""

import numpy as np
import pytest
import torch

import x264_tpu_torch
from x264_tpu_torch import tables
from x264_tpu_torch.encoder import (aq, inter, intra, lookahead, pipeline,
                                    stats)
from x264_tpu_torch.entropy import cabac_planes
from x264_tpu_torch.entropy import device as cavlc_device
from x264_tpu_torch.ops import deblock, mc, me
from x264_tpu_torch.ops import pixel as opixel
from x264_tpu_torch.ops import quant as oquant

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


def _blocky(dev, seed=3, mb_h=MB_H, mb_w=MB_W):
    """A directional gradient under 8x8-blocky noise, which I8x8 fits."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
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
@pytest.mark.parametrize("qp,i8x8,mb_h,mb_w,opt", [
    *(pytest.param(qp, i8x8, MB_H, MB_W, "", id=f"{qp}-{i8x8}")
      for qp, i8x8 in [(18, False), (26, False), (38, False), (26, True),
                       (38, True)]),
    *(pytest.param(qp, True, 4, w, "", id=f"i8x8-{qp}-{w}wide")
      for w in (1, 2) for qp in (12, 26, 45)),
    pytest.param(26, True, 4, 2, "aq", id="i8x8-aq-2wide"),
    pytest.param(26, True, 4, 1, "no_i4", id="i8x8-no-i4-1wide"),
    pytest.param(0, False, 3, 2, "lossless", id="lossless-2wide"),
    pytest.param(0, False, MB_H, MB_W, "lossless", id="lossless")])
def test_intra_kernel_matches_plain(card, qp, i8x8, mb_h, mb_w, opt):
    """K1 against its plain version: every output equal. At one and two
    MBs wide, I8x8's block 1 never, or only sometimes, has a top-right;
    opt "aq" adds a seeded QP map (the 52-QP stack rows), "no_i4" drops
    the I4x4 ladder, "lossless" takes the bypass with I4x4 on."""
    if (mb_h, mb_w) == (MB_H, MB_W):
        y, u, v = _blocky(card) if i8x8 else _frame(card, qp)
    else:
        y, u, v = _blocky(card, qp + mb_w, mb_h, mb_w)
    q = intra.make_qtab(qp, tables.chroma_qp(qp), card)
    lam = int(tables.LAMBDA_TABLE[qp])
    qp_map = None
    if opt == "aq":
        q = _with_stacks(q, card)
        rng = np.random.default_rng(qp)
        qp_map = torch.as_tensor(rng.integers(qp - 8, qp + 9, (mb_h, mb_w))
                                 .astype(np.int32), device=card)
    args = (mb_h, mb_w, y, u, v, q, lam, i8x8, qp_map, opt == "lossless",
            opt != "no_i4")
    k = intra.encode_i16_frame(*args)
    p = intra.encode_i16_frame_plain(*args)
    assert set(k) == set(p)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    if i8x8 and (mb_h, mb_w) == (MB_H, MB_W):
        assert p["t8_mb"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("qp,i8x8", [(18, False), (38, False), (26, True)])
def test_cabac_ops_kernel_matches_plain(card, qp, i8x8):
    _, out, _ = _intra(card, qp, i8x8)
    k_ops, k_n = cabac_planes.i_slice_ops(out, MB_H, MB_W, i8x8)
    p_ops, p_n = cabac_planes.i_slice_ops_plain(out, MB_H, MB_W, i8x8)
    n = int(p_n)
    assert int(k_n) == n and torch.equal(k_ops[:n], p_ops[:n])


def _deblock_maps(kind, dev, mb_h=MB_H, mb_w=MB_W, seed=1):
    """The slice's all-intra maps, or random qp / intra / nnz / ref / mv
    maps of the kind a P slice gives, with nonzero filter offsets; "b"
    adds random L1 refs and MVs (a B slice), "t8" a random t8_mb map."""
    if kind == "intra":
        intra_mb, z4, zmv = pipeline._zero_maps(mb_h, mb_w, dev)
        qp_mb = torch.full((mb_h, mb_w), 26, dtype=torch.int32, device=dev)
        return (qp_mb, intra_mb, z4, z4, zmv, z4, zmv, False, 0, 0, 0)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    h4, w4 = mb_h * 4, mb_w * 4
    i32 = lambda a: t(a.astype(np.int32))
    b = kind == "b"
    args = (i32(rng.integers(20, 46, (mb_h, mb_w))),
            t(rng.random((mb_h, mb_w)) < 0.3),
            i32(rng.integers(0, 2, (h4, w4))),
            i32(rng.integers(-1 if b else 0, 2, (h4, w4))),
            i32(rng.integers(-8, 8, (h4, w4, 2))),
            i32(rng.integers(-1, 1, (h4, w4)) if b else np.zeros((h4, w4))),
            i32(rng.integers(-8, 8, (h4, w4, 2)) if b
                else np.zeros((h4, w4, 2))),
            b, -2, 2, 1)
    if kind == "t8":
        args = (*args, t(rng.random((mb_h, mb_w)) < 0.5))
    return args


def _deblock_src(dev, mb_h, mb_w, seed=0):
    """Seeded planes of mb_h x mb_w MBs: a gradient under noise that the
    filter smooths."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
    t = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    return (t(rng.integers(0, 256, (h, w)) // 8 + 100
              + np.arange(w)[None, :] // 3),
            t(rng.integers(0, 256, (h // 2, w // 2)) // 10 + 120),
            t(rng.integers(0, 256, (h // 2, w // 2)) // 10 + 100))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mb_h,mb_w", [
    *(pytest.param(k, MB_H, MB_W, id=k) for k in ("intra", "random", "i8x8")),
    *(pytest.param(k, h, w, id=f"{k}-{h}x{w}")
      for h, w in ((1, 7), (6, 1), (3, 2), (40, 2))
      for k in ("intra", "random", "b", "t8"))])
def test_deblock_kernel_matches_plain(card, kind, mb_h, mb_w):
    """i8x8: the IDR maps with the t8_mb map of an I8x8 frame. At the
    edge shapes (one MB row, one MB column, 3 x 2 and a tall 40 x 2),
    seeded planes with intra, random P, B and t8 maps, each run 10 times
    on fresh copies: a fault in the row wavefront's memory ordering
    shows only now and then."""
    if (mb_h, mb_w) == (MB_H, MB_W):
        _, out, _ = _intra(card, 26, kind == "i8x8")
        args = _deblock_maps("random" if kind == "random" else "intra", card)
        if kind == "i8x8":
            args = (*args, out["t8_mb"])
        src = [out[k] for k in ("recon_y", "recon_u", "recon_v")]
        runs = 1
    else:
        src = _deblock_src(card, mb_h, mb_w)
        args = _deblock_maps(kind, card, mb_h, mb_w)
        runs = 10
    p = deblock.deblock_frame_plain(mb_h, mb_w, *src, *args)
    for _ in range(runs):
        n0 = deblock.deblock_frame.launches
        k = deblock.deblock_frame(mb_h, mb_w, *[t.clone() for t in src],
                                  *args)
        assert deblock.deblock_frame.launches == n0 + 1
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    assert not torch.equal(p[0], src[0])        # the filter acted


@pytest.mark.cuda
def test_deblock_kernel_back_to_back(card):
    """K2 calls queued on one stream with no sync between them: each
    clears the row counters and the ticket the one before left (the
    same frame twice), and the scratch grows for a taller frame."""
    calls = [(3, 2, "random", 0), (3, 2, "b", 1), (9, 3, "t8", 2)]
    work, plain = [], []
    for mb_h, mb_w, kind, seed in calls:
        src = _deblock_src(card, mb_h, mb_w, seed)
        args = _deblock_maps(kind, card, mb_h, mb_w, seed)
        plain.append(deblock.deblock_frame_plain(mb_h, mb_w, *src, *args))
        work.append(([t.clone() for t in src], args))
    torch.cuda.synchronize()
    outs = [deblock.deblock_frame(h, w, *src, *args)
            for (h, w, _, _), (src, args) in zip(calls, work)]
    for k, p in zip(outs, plain):
        for a, b in zip(k, p):
            assert torch.equal(a, b)


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
@pytest.mark.parametrize("crop", [(0, 0), (6, 4), (13, 7), (0, 330)])
def test_metrics_kernel_tiles(card, crop):
    """K4 on 23 x 21 MBs, whose SSIM windows (90 x 82) leave partial
    tiles in both directions, at crops with odd remainders and one (6
    rows) without any window: one launch a call, the SSDs exact, the SSIM
    sum within 1e-5 of the plain version's and bit-identical in 20
    calls."""
    rng = np.random.default_rng(6)
    h, w = 21 * 16, 23 * 16
    t = lambda a: torch.as_tensor(a.clip(0, 255), dtype=torch.int32,
                                  device=card)
    src = [rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h // 2, w // 2)),
           rng.integers(0, 256, (h // 2, w // 2))]
    rec = [t(a + rng.integers(-9, 10, a.shape)) for a in src]
    src = [t(a) for a in src]
    cw, ch = w - crop[0], h - crop[1]
    n = stats.frame_metrics.launches
    k = [stats.frame_metrics(*src, *rec, cw, ch) for _ in range(20)]
    assert stats.frame_metrics.launches == n + 20
    assert all(torch.equal(k[0], x) for x in k[1:])
    p = stats.frame_metrics_plain(*src, *rec, cw, ch).double()
    kd = k[0].double()
    assert torch.equal(kd[:3], p[:3])
    assert abs(float(kd[3] - p[3])) <= 1e-5 * max(abs(float(p[3])), 1e-30)
    if crop[1] == 330:
        assert float(p[3]) == 0.0


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


def _edge_frames(dev, mb_h, mb_w, seed=21):
    """A textured frame of mb_h x mb_w MBs and a reference that is it
    moved by a few pixels under fresh noise."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[0:h, 0:w]
    t = lambda a: torch.as_tensor(np.clip(a, 0, 255), dtype=torch.int32,
                                  device=dev)
    y = (xx * 3 + yy * 2) // 2 % 200 + rng.integers(0, 30, (h, w))
    u = rng.integers(90, 170, (h // 2, w // 2))
    v = 128 + rng.integers(-25, 25, (h // 2, w // 2))
    ref = [np.roll(y, (2, 3), (0, 1)) + rng.integers(-4, 5, (h, w)),
           np.roll(u, (1, 1), (0, 1)), np.roll(v, (1, 2), (0, 1))]
    return tuple(t(a) for a in (y, u, v)), [t(a) for a in ref]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [4, 16, 24])
@pytest.mark.parametrize("mb_h,mb_w,content", [
    (MB_H, MB_W, "moved"), (MB_H, MB_W, "flat"), (1, 9, "moved"),
    (9, 1, "moved"), (1, 1, "flat")])
@pytest.mark.parametrize("mvp_kind", ["zero", "wide"])
def test_me_kernel_edges(card, r, mb_h, mb_w, content, mvp_kind):
    """K5 at R 4, 16 and 24 (coarse radius 3, 9, 13), on one-MB-wide and
    one-MB-tall frames, where the half-res window clamps at every edge and
    the full-res windows' starts wrap and clamp, and on a flat reference
    (every SAD of a window equal: the cost ties between MVs of equal bits,
    and at lam 0 every candidate ties), with a zero or a wide predictor."""
    (y, _, _), ref = _edge_frames(card, mb_h, mb_w)
    lam = int(tables.LAMBDA_TABLE[26])
    if content == "flat":
        ref[0] = torch.full_like(ref[0], 117)
        lam = 0 if mvp_kind == "zero" else lam
    mvp = torch.as_tensor(np.random.default_rng(r).integers(
        -140, 141, (mb_h, mb_w, 2)), dtype=torch.int32, device=card)
    if mvp_kind == "zero":
        mvp = torch.zeros_like(mvp)
    args = (y, mc.pad_plane(ref[0]), mb_h, mb_w, r, lam, mvp)
    n5 = me.hier_search.launches
    kmv, ksad = me.hier_search(*args)
    assert me.hier_search.launches == n5 + 2
    pmv, psad = me.hier_search_plain(*args)
    assert torch.equal(kmv, pmv) and torch.equal(ksad, psad)
    for _ in range(3):                 # the same result from call to call
        k2 = me.hier_search(*args)
        assert torch.equal(k2[0], kmv) and torch.equal(k2[1], ksad)


def _k6_edge_args(dev, mb_h, mb_w, mode):
    """K6's arguments on an mb_h x mb_w frame: random partition types and
    quarter-pel quadrant MVs that reach past the pad (the fetch starts
    wrap and clamp), at QP 26 or in mode "lossless" QP 0 without
    decimation; "aq" a QP map and the 52-QP stacks, "ref2" two references
    and a per-MB index. Returns the positional arguments and the
    keyword ones."""
    (y, u, v), ref = _edge_frames(dev, mb_h, mb_w)
    rng = np.random.default_rng(mb_h * 31 + mb_w)
    qp = 0 if mode == "lossless" else 26
    q = inter.make_qtab_p(qp, tables.chroma_qp(qp), dev)
    pads = [mc.pad_plane(ref[0]), mc.pad_plane(ref[1], mc.PAD // 2),
            mc.pad_plane(ref[2], mc.PAD // 2)]
    planes = mc.hpel_planes(pads[0])
    ptype = torch.as_tensor(rng.integers(0, 4, (mb_h, mb_w)),
                            dtype=torch.int32, device=dev)
    mv_quad = torch.as_tensor(rng.integers(-150, 151, (mb_h, mb_w, 4, 2)),
                              dtype=torch.int32, device=dev)
    kw = {}
    if mode == "aq":
        q = _with_stacks(q, dev)
        kw["qp_map"] = torch.as_tensor(rng.choice(
            [0, 1, 18, 26, 38, 51], (mb_h, mb_w)), dtype=torch.int32,
            device=dev)
    if mode == "ref2":
        old = [torch.roll(t, (1, -2), (0, 1)) for t in (y, u, v)]
        planes = torch.cat([planes, mc.hpel_planes(mc.pad_plane(old[0]))])
        for k in (1, 2):
            pads[k] = torch.stack([pads[k], mc.pad_plane(old[k],
                                                         mc.PAD // 2)])
        kw["ref_sel"] = torch.as_tensor(rng.integers(0, 2, (mb_h, mb_w)),
                                        dtype=torch.int32, device=dev)
    if mode == "nr":
        kw["nr_offset4"] = torch.as_tensor(rng.integers(0, 300, 16),
                                           dtype=torch.int32, device=dev)
        kw["nr_offset8"] = torch.as_tensor(rng.integers(0, 300, 64),
                                           dtype=torch.int32, device=dev)
    if mode == "lossless":
        kw["lossless"] = True
    return (mb_h, mb_w, y, u, v, planes, *pads[1:], ptype, mv_quad, q,
            mode != "lossless"), kw


@pytest.mark.cuda
@pytest.mark.parametrize("mb_h,mb_w", [(1, 9), (9, 1), (2, 3)])
@pytest.mark.parametrize("mode,t8", [
    ("plain", inter.T8_OFF), ("plain", inter.T8_SA8D),
    ("plain", inter.T8_RD), ("aq", inter.T8_RD), ("aq", inter.T8_SA8D),
    ("lossless", inter.T8_OFF), ("nr", inter.T8_RD), ("nr", inter.T8_OFF),
    ("ref2", inter.T8_RD)])
def test_inter_kernel_edges(card, mb_h, mb_w, mode, t8):
    """K6 without the trellis one MB wide and one MB tall, at t8 0 / 1 / 2,
    with a QP map of rows 0 / 1 / 18 / 26 / 38 / 51, lossless, with the
    noise reduction and with two references, bit-identical from call to
    call."""
    args, kw = _k6_edge_args(card, mb_h, mb_w, mode)
    n0 = inter.p_inter_mb.launches
    k = inter.p_inter_mb(*args, t8, **kw)
    assert inter.p_inter_mb.launches == n0 + 1
    if "nr_offset8" in kw and t8 == inter.T8_OFF:
        kw["nr_offset8"] = None
    p = inter.p_inter_mb_plain(*args, t8, **kw)
    assert set(k) == set(p)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    k2 = inter.p_inter_mb(*args, t8, **kw)
    for key in p:
        assert torch.equal(k2[key], k[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("mb_h,mb_w", [(1, 9), (9, 1), (3, 4)])
def test_b_kernels_edges(card, mb_h, mb_w):
    """K22's passes 1 and 2 without the trellis one MB wide and one MB
    tall, with MVs past the pad, random ME costs (every B mode chosen) and
    random final references (intra MBs at MV 0 included)."""
    (y, u, v), ref = _edge_frames(card, mb_h, mb_w)
    (_, ref1) = _edge_frames(card, mb_h, mb_w, seed=22)
    fetch = [inter.b_list_fetch(*r)[0] for r in (ref, ref1)]
    rng = np.random.default_rng(mb_h + 7 * mb_w)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=card)
    mvs = [t(rng.integers(-150, 151, (mb_h, mb_w, 2))) for _ in range(2)]
    seeds = [t(rng.integers(-20, 21, (mb_h, mb_w, 2))) for _ in range(2)]
    satds = [t(rng.integers(0, 6000, (mb_h, mb_w))) for _ in range(2)]
    q = inter.make_qtab_p(26, tables.chroma_qp(26), card)
    lam = int(tables.LAMBDA_TABLE[26])
    a = (mb_h, mb_w, y, u, v, *fetch, q, *mvs)
    n22 = inter.b_inter_mb.launches
    k1 = inter.b_inter_mb(*a, satd=satds, seeds=seeds, lam=lam)
    p1 = inter.b_inter_mb_plain(*a, satd=satds, seeds=seeds, lam=lam)
    for key in p1:
        assert torch.equal(k1[key], p1[key]), key
    refs = (t(rng.choice([-1, 0], (mb_h, mb_w))),
            t(rng.choice([-1, 0], (mb_h, mb_w))))
    k2 = inter.b_inter_mb(*a, refs=refs)
    p2 = inter.b_inter_mb_plain(*a, refs=refs)
    assert inter.b_inter_mb.launches == n22 + 2
    for key in p2:
        assert torch.equal(k2[key], p2[key]), key


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


def _k7_edge(dev, mb_h, mb_w, want, mode, seed=11):
    """K7's arguments on a synthetic frame of mb_h x mb_w MBs: a textured
    source and its inter recon off by noise; no MB wanting intra (want
    "none"), every MB ("all": the chains deeper than three sweeps are
    demoted) or some. mode: "satd", "rd" (the RD decision with psy-RD on
    random inter RD costs), "aq" (a QP map over 0-51 and the 52-QP stacks)
    or "lossless" (CQP 0, the bypass). Returns intra_in_p's (args,
    kwargs)."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev)
    yy, xx = np.mgrid[0:h, 0:w]
    src = [((xx // 3 + yy // 2) % 200 + rng.integers(0, 24, (h, w)))
           .clip(0, 255), rng.integers(0, 256, (h // 2, w // 2)),
           128 + rng.integers(-20, 20, (h // 2, w // 2))]
    rec = [(a + rng.integers(-12, 13, a.shape)).clip(0, 255) for a in src]
    qp = 0 if mode == "lossless" else 26
    q = inter.make_qtab_p(qp, tables.chroma_qp(qp), dev,
                          **(dict(rd_idc=0, f_psy_rd=1.0) if mode == "rd"
                             else {}))
    shape = (mb_h, mb_w)
    cost = {"none": np.zeros(shape), "all": np.full(shape, 1 << 29),
            "some": rng.integers(0, 16000, shape)}[want]
    kw = {}
    if mode == "rd":
        rd_cost = {"none": np.full(shape, -1.0), "all": np.full(shape, 1e30),
                   "some": rng.uniform(0.0, 60000.0, shape)}[want]
        kw["rd"] = (torch.as_tensor(rd_cost, dtype=torch.float32,
                                    device=dev),
                    t(rng.integers(0, 3000, shape)))
    elif mode == "aq":
        q = _with_stacks(q, dev)
        kw["qp_map"] = t(rng.integers(0, 52, shape))
    elif mode == "lossless":
        kw["lossless"] = True
    args = (mb_h, mb_w, *(t(a) for a in src), *(t(a) for a in rec), t(cost),
            q, int(tables.LAMBDA_TABLE[qp]), mode != "lossless")
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("mb_h,mb_w", [(1, 9), (9, 1), (4, 6)])
@pytest.mark.parametrize("want", ["none", "all", "some"])
@pytest.mark.parametrize("mode", ["satd", "rd", "aq", "lossless"])
def test_intra_in_p_kernel_edges(card, mb_h, mb_w, want, mode):
    """K7 (its decision listing the intra MBs on the card, sweeps 1 and 2
    over that list) one MB wide and one MB tall, with no intra MB, with
    every MB wanting intra and with some, at SATD, RD + psy, a QP map and
    lossless: exact, 4 launches."""
    args, kw = _k7_edge(card, mb_h, mb_w, want, mode)
    n = inter.intra_in_p.launches
    k = inter.intra_in_p(*args, **kw)
    assert inter.intra_in_p.launches == n + 4
    p = inter.intra_in_p_plain(*args, **kw)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    im = p["intra_mb"]
    if want == "none":
        assert not im.any()
    elif want == "all":
        assert im.any() and not im.all()


@pytest.mark.cuda
@pytest.mark.parametrize("mb_h,mb_w", [(1, 9), (9, 1), (4, 6)])
@pytest.mark.parametrize("want", ["none", "all", "some"])
def test_intra_in_b_kernels_edges(card, mb_h, mb_w, want):
    """K7's B decision, and its B sweeps with that decision and with
    every MB intra, one MB wide, one MB tall and 4 x 6: exact, 2 and 4
    launches."""
    args, _ = _k7_edge(card, mb_h, mb_w, want, "satd")
    nd, ns = inter.intra_in_b_decide.launches, inter.intra_in_b_sweeps.launches
    im = inter.intra_in_b_decide(*args[:11])
    assert torch.equal(im, inter.intra_in_p_plain(*args[:11], True,
                                                  decide_only=True))
    for fixed in (im, torch.ones_like(im)):
        k = inter.intra_in_b_sweeps(*args[:8], fixed, *args[9:11])
        p = inter.intra_in_p_plain(*args[:8], None, *args[9:11], True,
                                   intra_mb=fixed)
        for key in p:
            assert torch.equal(k[key], p[key]), key
    assert inter.intra_in_b_decide.launches == nd + 2
    assert inter.intra_in_b_sweeps.launches == ns + 8


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


def _corner_mvs(dev, n, seed):
    """(n, MB_H, MB_W, 2) qpel MVs into the pad and past it (fetch starts
    that wrap and clamp), the four corner MBs pointing out of the frame."""
    rng = np.random.default_rng(seed)
    mv = rng.integers(-44, 45, (n, MB_H, MB_W, 2)) * 4 \
        + rng.integers(0, 4, (n, MB_H, MB_W, 2))
    far = 4 * (36 + 4 * np.arange(n))
    for r, c in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        mv[:, r, c, 0] = far if c else -far
        mv[:, r, c, 1] = far if r else -far
    return torch.as_tensor(mv, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [(2,), (2, 1)])
@pytest.mark.parametrize("layout", range(4))
@pytest.mark.parametrize("case", ["near", "flat", "corners"])
def test_subpel_kernel_matches_plain(card, steps, layout, case):
    """K10 on each block shape: near the ME's MVs; on a flat source over a
    flat reference at lam 0 (every cost equal: candidate 0 wins); and
    with MVs into the pad from the frame's corners. 35 MBs: no shape's
    block count fills the last CTA but the 8x8 one's."""
    (y, _, _), _, _, planes, mv, mvp, _, lam = _subpel_args(card)
    bh, bw, offs, _ = (((16, 16, ((0, 0),), None),)
                       + inter.PART_LAYOUTS)[layout]
    ys, xs = me.block_origins(MB_H, MB_W, offs, card)
    n = len(offs)
    mvs = mv.expand(n, MB_H, MB_W, 2) + torch.as_tensor(
        np.random.default_rng(layout).integers(-2, 3, (n, MB_H, MB_W, 2))
        * 4, dtype=torch.int32, device=card)
    if case == "flat":
        y = torch.full_like(y, 77)
        planes = mc.hpel_planes(mc.pad_plane(torch.full_like(y, 77)))
        lam = 0
    elif case == "corners":
        mvs = _corner_mvs(card, n, layout)
    args = (y, planes, mvs.contiguous(), lam,
            mvp.expand(n, MB_H, MB_W, 2).contiguous(), ys, xs, bh, bw, steps)
    k = me.subpel_refine_blocks(*args)
    p = me.subpel_refine_blocks_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if case == "flat":
        first = me.subpel_offsets(steps)[0]
        assert torch.equal(k[0], mvs + torch.as_tensor(first, device=card,
                                                       dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [(2,), (2, 1)])
@pytest.mark.parametrize("p8x8", [False, True])
@pytest.mark.parametrize("case", ["near", "flat", "corners", "ref2"])
def test_subpel_parts_kernel_matches_plain(card, steps, p8x8, case):
    """K10's one launch for the partition layouts against three calls of
    subpel_refine_blocks_plain: partition_fullpel's rows, flat content at
    lam 0, MVs into the pad from the corners, and a mixed reference per
    MB over both references' planes."""
    (y, _, _), _, pad, planes, mv, mvp, _, lam = _subpel_args(card)
    nk = 8 if p8x8 else 4
    pf = me.partition_fullpel(y, pad, mv, lam, mvp, 16, p8x8)
    sel = None
    if case == "flat":
        y = torch.full_like(y, 77)
        planes = mc.hpel_planes(mc.pad_plane(torch.full_like(y, 77)))
        lam = 0
    elif case == "corners":
        pf = _corner_mvs(card, nk, 7)
    elif case == "ref2":
        planes = torch.cat([planes, mc.hpel_planes(mc.pad_plane(
            torch.flip(y, (0, 1)).contiguous()))])
        sel = torch.as_tensor(np.random.default_rng(3).integers(
            0, 2, (MB_H, MB_W)), dtype=torch.int32, device=card)
    n0 = me.subpel_refine_parts.launches
    got = me.subpel_refine_parts(y, planes, pf, lam, mvp, steps, sel)
    assert me.subpel_refine_parts.launches == n0 + 1
    assert len(got) == (3 if p8x8 else 2)
    for (bh, bw, offs, (a, b)), (kmv, ksatd) in zip(inter.PART_LAYOUTS, got):
        n = len(offs)
        ys, xs = me.block_origins(MB_H, MB_W, offs, card)
        pmv, psatd = me.subpel_refine_blocks_plain(
            y, planes, pf[a:b], lam, mvp.expand(n, MB_H, MB_W, 2), ys, xs,
            bh, bw, steps,
            None if sel is None else sel.expand(n, MB_H, MB_W))
        assert torch.equal(kmv, pmv) and torch.equal(ksatd, psatd)


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


# ------------------------------------------------------------ variance AQ
def _half_flat(dev, seed=13):
    """A frame whose left half is flat and right half noise: a QP spread
    of at least 6 under AQ."""
    rng = np.random.default_rng(seed)
    out = []
    for n, level in ((16, 90), (8, 128), (8, 120)):
        p = rng.integers(0, 256, (MB_H * n, MB_W * n))
        p[:, :MB_W * n // 2] = level
        out.append(torch.as_tensor(p, dtype=torch.int32, device=dev))
    return tuple(out)


def _qp_map(dev, qp=26, seed=13):
    y, u, v = _half_flat(dev, seed)
    return aq.qp_map_from_planes_plain(y, u, v, MB_H, MB_W, qp, 1.0, 10, 51,
                                       0)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,qp,strength,off", [
    ("frame", 26, 1.0, 0), ("half_flat", 26, 1.0, 0),
    ("half_flat", 40, 1.7, -2), ("half_flat", 18, 0.5, 3)])
def test_aq_qp_map_kernel_matches_plain(card, kind, qp, strength, off):
    y, u, v = _frame(card) if kind == "frame" else _half_flat(card)
    args = (y, u, v, MB_H, MB_W, qp, strength, 10, 51, off)
    k = aq.qp_map_from_planes(*args)
    p = aq.qp_map_from_planes_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if kind == "half_flat" and strength == 1.0:
        assert int(p[0].max() - p[0].min()) >= 6


@pytest.mark.cuda
@pytest.mark.parametrize("exponents", [(0, 1, 2), (11, 12), (21, 22)])
def test_xla_log_kernel_matches_plain(card, exponents):
    """Every float32 of the binades [2^e, 2^(e+1)): the device log K16
    runs against the plain replay (run on the card's tensors)."""
    for e in exponents:
        bits = torch.arange(1 << 23, dtype=torch.int32, device=card) \
            | ((127 + e) << 23)
        x = bits.view(torch.float32)
        k = aq.xla_log_f32(x)
        p = aq.xla_log_f32_plain(x)
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), e


@pytest.mark.cuda
@pytest.mark.parametrize("mb_h,mb_w", [(MB_H, MB_W), (68, 120)])
def test_dqp_kernel_matches_plain(card, mb_h, mb_w):
    rng = np.random.default_rng(mb_w)
    qp_map = torch.as_tensor(rng.integers(10, 52, (mb_h, mb_w)),
                             dtype=torch.int32, device=card)
    has = torch.as_tensor(rng.random((mb_h, mb_w)) < 0.5, device=card)
    has[1], has[2] = False, True           # an all-false and an all-true row
    has[0, :3] = False
    for slice_qp in (23, 51):
        k = aq.dqp_syntax(qp_map, has, slice_qp)
        p = aq.dqp_syntax_plain(qp_map, has, slice_qp)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    none = torch.zeros_like(has)
    for a, b in zip(aq.dqp_syntax(qp_map, none, 30),
                    aq.dqp_syntax_plain(qp_map, none, 30)):
        assert torch.equal(a, b)


def _with_stacks(q, dev):
    st = aq.qtab_stacks(aq.full_tables(tables.DEFAULT_QUANT, dev), 0)
    return {**q, "aq_stack": st["intra"], "aq_stack_p": st["inter"]}


@pytest.mark.cuda
@pytest.mark.parametrize("i8x8", [False, True])
def test_intra_aq_kernels_match_plain(card, i8x8):
    """K1 with a QP map, then K17, K3 with the dqp planes and K2 on the
    effective QP map."""
    y, u, v = _blocky(card) if i8x8 else _half_flat(card)
    qp = 26
    qp_map = aq.qp_map_from_planes_plain(y, u, v, MB_H, MB_W, qp, 1.0, 10,
                                         51, 0)[0]
    q = _with_stacks(intra.make_qtab(qp, tables.chroma_qp(qp), card), card)
    lam = int(tables.LAMBDA_TABLE[qp])
    k = intra.encode_i16_frame(MB_H, MB_W, y, u, v, q, lam, i8x8, qp_map)
    p = intra.encode_i16_frame_plain(MB_H, MB_W, y, u, v, q, lam, i8x8,
                                     qp_map)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    cnz = (p["chroma_ac"][..., 1:] != 0).flatten(2).any(-1) \
        | (p["chroma_dc"] != 0).flatten(2).any(-1)
    has = ~p["i4_mb"] | (p["cbp_luma_bits"] > 0) | cnz
    p["dqp"], qp_eff, p["dqp_prev_nz"] = aq.dqp_syntax(qp_map, has, qp)
    assert (p["dqp"] != 0).any()
    k_ops, k_n = cabac_planes.i_slice_ops(p, MB_H, MB_W, i8x8)
    p_ops, p_n = cabac_planes.i_slice_ops_plain(p, MB_H, MB_W, i8x8)
    n = int(p_n)
    assert int(k_n) == n and torch.equal(k_ops[:n], p_ops[:n])
    intra_mb, z4, zmv = pipeline._zero_maps(MB_H, MB_W, card)
    args = (qp_eff, intra_mb, z4, z4, zmv, z4, zmv, False, 0, 0, 0,
            p.get("t8_mb"))
    src = [p[key] for key in ("recon_y", "recon_u", "recon_v")]
    pd = deblock.deblock_frame_plain(MB_H, MB_W, *src, *args)
    kd = deblock.deblock_frame(MB_H, MB_W, *[t.clone() for t in src], *args)
    for a, b in zip(kd, pd):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,t8", [("inter", inter.T8_OFF),
                                     ("intra", inter.T8_OFF),
                                     ("t8", inter.T8_SA8D),
                                     ("t8", inter.T8_RD)])
def test_inter_aq_kernels_match_plain(card, kind, t8):
    """K6 and K7 (with the RD decision under T8_RD) with a QP map, then
    K8 with K17 between its passes, and K2 on the effective QP map."""
    (y, u, v), ref, q, lam = _p_frame(card, kind)
    rd = t8 == inter.T8_RD
    if rd:
        q = inter.make_qtab_p(26, tables.chroma_qp(26), card, rd_idc=0,
                              f_psy_rd=1.0)
    q = _with_stacks(q, card)
    qp_map = aq.qp_map_from_planes_plain(y, u, v, MB_H, MB_W, 26, 1.0, 10,
                                         51, 0)[0]
    subpel = ((2, 1), True, True, True, rd, True) if t8 else ()
    args = (MB_H, MB_W, 16, y, u, v, *ref, q, lam, _mvp(card), True, *subpel)
    front = inter.encode_p_front(*args, qp_map=qp_map)
    pads = (mc.pad_plane(ref[0]), mc.pad_plane(ref[1], mc.PAD // 2),
            mc.pad_plane(ref[2], mc.PAD // 2))
    planes = mc.hpel_planes(pads[0]) if t8 else pads[0][None]
    k6 = (MB_H, MB_W, y, u, v, planes, *pads[1:], front["ptype"],
          front["mv_quad"], q, True, t8)
    k = inter.p_inter_mb(*k6, qp_map)
    p = inter.p_inter_mb_plain(*k6, qp_map)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    cost = torch.full((MB_H, MB_W), 1 << 20, dtype=torch.int32, device=card)
    cost[::2] = 0
    k7 = (MB_H, MB_W, y, u, v, p["recon_y"], p["recon_u"], p["recon_v"],
          cost, q, lam, True)
    rd_costs = inter.rd_inter(MB_H, MB_W, y, u, v, p, front["ptype"],
                              front["mv_quad"], _mvp(card), q)[:2] \
        if rd else None
    k = inter.intra_in_p(*k7, rd_costs, qp_map)
    pp = inter.intra_in_p_plain(*k7, rd_costs, qp_map)
    for key in pp:
        assert torch.equal(k[key], pp[key]), key
    kmaps, kops, kn = cabac_planes.cabac_p_ops(front, MB_H, MB_W,
                                               t8_mode=bool(t8),
                                               aq=(qp_map, 26))
    pmaps, pops, pn = cabac_planes.cabac_p_ops_plain(front, MB_H, MB_W,
                                                     bool(t8), (qp_map, 26))
    n = int(pn)
    assert int(kn) == n and torch.equal(kops[:n], pops[:n])
    for key in pmaps:
        assert torch.equal(kmaps[key], pmaps[key]), key
    assert (pmaps["dqp"] != 0).any()
    z4 = torch.zeros_like(kmaps["ref4"])
    maps = (pmaps["qp_eff"], front["intra_mb"], kmaps["nnz4"],
            kmaps["ref4"], kmaps["mv4"], z4, torch.zeros_like(kmaps["mv4"]),
            False, 0, 0, 0, kmaps.get("t8_mb"))
    src = [front[key] for key in ("recon_y", "recon_u", "recon_v")]
    pd = deblock.deblock_frame_plain(MB_H, MB_W, *src, *maps)
    kd = deblock.deblock_frame(MB_H, MB_W, *[t.clone() for t in src], *maps)
    for a, b in zip(kd, pd):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,frame_parallel", [("crf", 1), ("crf", 3),
                                                 ("abr", 3), ("crf-noaq", 3)])
def test_crf_encoder_on_the_card_matches_the_cpu(card, mode, frame_parallel):
    """x264_tpu's defaults (CRF 23 with variance AQ), 1-pass ABR and CRF
    without AQ: the card's payloads, frame QPs and recons equal the
    CPU's."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(17)
    base = rng.integers(0, 256, (h + 8, w + 16), dtype=np.uint8)
    base[:, :w // 2] = 100
    frames = [x264_tpu_torch.Frame(
        base[t:t + h, 2 * t:2 * t + w].copy(),
        np.full((h // 2, w // 2), 100 + 3 * t, np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for t in range(5)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_log_level=0, i_keyint_min=2,
                                         i_frame_parallel=frame_parallel)
        if mode == "abr":
            p.rc.i_rc_method, p.rc.i_bitrate = 2, 60
        if mode == "crf-noaq":
            p.rc.i_aq_mode = 0
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return (enc.headers(), outs, enc.close(),
                [e.qp for e in enc.rc.entries])

    (kh, kout, ksum, kq), (ph, pout, psum, pq) = run(card), run("cpu")
    assert kh == ph and len(kout) == len(pout) == 5 and kq == pq
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5


def _slice_header(slice_type):
    from x264_tpu_torch.entropy.bitstream import BitWriter
    from x264_tpu_torch.headers import SliceHeader
    bw = BitWriter()
    SliceHeader(slice_type=slice_type, idr_pic_id=0 if slice_type == 2
                else -1, qp=26, disable_deblock=0).write_rbsp(bw, 3)
    return cavlc_device.header_slots(bw)


def _same_words(k, p):
    (kw, kn), (pw, pn) = k, p
    assert int(kn) == int(pn) and torch.equal(kw, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("qp,aq_map,cap", [(26, False, None), (4, False, None),
                                          (26, True, None), (4, False, 300)])
def test_cavlc_i_slice_kernel_matches_plain(card, qp, aq_map, cap):
    """K18 on K1's planes (at QP 4 long level escapes occur), with K17's
    dqp planes, and with a capacity small enough that codes are
    dropped: the words in range and nbits equal the plain version's."""
    (y, u, v), out, (q, lam) = _intra(card, qp)
    if aq_map:
        qm = _qp_map(card, qp)
        cnz = (out["chroma_ac"][..., 1:] != 0).flatten(2).any(-1) \
            | (out["chroma_dc"] != 0).flatten(2).any(-1)
        out["dqp"] = aq.dqp_syntax(qm, ~out["i4_mb"]
                                   | (out["cbp_luma_bits"] > 0) | cnz, qp)[0]
    hv, hl = _slice_header(2)
    cap = cap or pipeline.capacity_words(MB_H * MB_W)
    k = cavlc_device.cavlc_i_slice(out, MB_H, MB_W, hv, hl, cap)
    p = cavlc_device.cavlc_i_slice_plain(out, MB_H, MB_W, hv, hl, cap)
    _same_words(k, p)
    assert (int(p[1]) > 32 * cap) == (cap == 300)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,aq_map,cap", [
    ("inter", False, None), ("intra", False, None), ("partitions", False, None),
    ("intra", True, None), ("inter", False, 60)])
def test_cavlc_p_slice_and_p_maps_kernels_match_plain(card, kind, aq_map,
                                                      cap):
    """K8's pass A alone against p_maps_plain, then K19 on its maps (with
    K17's dqp planes under aq_map, and with codes dropped past a small
    capacity), at subme 5 with the partitions."""
    (y, u, v), ref, q, lam = _p_frame(card, "intra" if kind == "intra"
                                      else "inter")
    front = inter.encode_p_front(MB_H, MB_W, 16, y, u, v, *ref, q, lam,
                                 _mvp(card), True, (2, 1), True, True, True)
    if kind == "partitions":     # every layout, whatever the search chose
        rng = np.random.default_rng(12)
        front["ptype"] = torch.as_tensor(rng.integers(0, 4, (MB_H, MB_W)),
                                         dtype=torch.int32, device=card)
    kmaps = cabac_planes.p_maps(front, MB_H, MB_W)
    pmaps = inter.p_maps_plain(front, MB_H, MB_W)
    assert set(kmaps) == set(pmaps)
    for key in pmaps:
        assert torch.equal(kmaps[key], pmaps[key]), key
    if aq_map:
        kmaps["dqp"] = aq.dqp_syntax(_qp_map(card), cabac_planes.has_dqp_p(
            kmaps, front), 26)[0]
    hv, hl = _slice_header(0)
    cap = cap or pipeline.capacity_words(MB_H * MB_W)
    k = cavlc_device.cavlc_p_slice(front, kmaps, MB_H, MB_W, hv, hl, cap)
    p = cavlc_device.cavlc_p_slice_plain(front, kmaps, MB_H, MB_W, hv, hl,
                                         cap)
    _same_words(k, p)
    assert (int(p[1]) > 32 * cap) == (cap == 60)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,frame_parallel", [("defaults", 1),
                                                 ("defaults", 3),
                                                 ("intra-cqp", 3)])
def test_cavlc_encoder_on_the_card_matches_the_cpu(card, mode,
                                                   frame_parallel):
    """b_cabac off at x264_tpu's defaults (CRF 23 with variance AQ, IPPP)
    and all-intra at CQP 26: the card's payloads, frame QPs and recons
    equal the CPU's."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(23)
    base = rng.integers(0, 256, (h + 8, w + 16), dtype=np.uint8)
    base[:, :w // 2] = 100
    frames = [x264_tpu_torch.Frame(
        base[t:t + h, 2 * t:2 * t + w].copy(),
        np.full((h // 2, w // 2), 100 + 3 * t, np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for t in range(5)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_log_level=0, i_keyint_min=2,
                                         b_cabac=False,
                                         i_frame_parallel=frame_parallel)
        if mode == "intra-cqp":
            p.i_keyint_max = 1
            p.rc.i_rc_method, p.rc.i_qp_constant = 0, 26
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return (enc.headers(), outs, enc.close(),
                [e.qp for e in enc.rc.entries])

    (kh, kout, ksum, kq), (ph, pout, psum, pq) = run(card), run("cpu")
    assert kh == ph and len(kout) == len(pout) == 5 and kq == pq
    if mode == "defaults":
        assert {o.frame_type for o in kout} == {"IDR", "P"}
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5


# ------------------------------------------------------------- trellis
_TR_CQM = {2: tables.CQM_4PY, 3: tables.CQM_4PC, 4: tables.CQM_4PC,
           5: tables.CQM_8PY}


@pytest.mark.cuda
@pytest.mark.parametrize("cat", [2, 3, 4, 5])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("rows", ["laplace", "ties"])
def test_trellis_kernel_matches_plain(card, cat, stacked, rows):
    """K20 at each category: with one QP's consts at QP 26 and QP 4 (levels
    past the ue escape), or with the 52-QP stack and a seeded row per
    block; Laplacian coefficients at four scales and all-zero blocks, or
    (ties) trellis.tie_coefs' rows (zero blocks, magnitudes on q's
    rounding edge, lone coefficients, levels >= 15) with lam2 at the
    table's, 0 and 1e7, or with stack rows at QP 0, 1 and 51; 3001 blocks,
    which do not fill the last CTA."""
    from x264_tpu_torch.ops import trellis
    C = int(trellis.CAT_C[cat])
    rng = np.random.default_rng(cat)
    n = 3001
    if rows == "laplace":
        scale = rng.choice([8, 40, 200, 1500], size=(n, 1))
        cf = (rng.laplace(0, 1, (n, C)) * scale).astype(np.int32)
    else:
        cf = trellis.tie_coefs(trellis.make_consts(
            1 if stacked else 26, cat, _TR_CQM[cat], False, 0)["qmf"], n,
            cat)
    cf[:64] = 0
    cf = torch.as_tensor(cf, device=card)
    if stacked:
        tab = trellis.pack_trellis(trellis.make_consts_all_qp(
            cat, _TR_CQM[cat], False, 0), card)
        qi = torch.as_tensor(rng.integers(0, 52, n) if rows == "laplace"
                             else rng.choice([0, 1, 51], n),
                             dtype=torch.int32, device=card)
        runs = [(tab, qi)]
    else:
        consts = [trellis.make_consts(qp, cat, _TR_CQM[cat], False, 0,
                                      state_qp=26) for qp in (26, 4)]
        if rows == "ties":
            consts += [dict(consts[0], lam2=np.float32(lam))
                       for lam in (0.0, 1e7)]
        runs = [(trellis.pack_trellis(c, card), None) for c in consts]
    outs = []
    for tab, qi in runs:
        n0 = trellis.trellis_scan.launches
        k = trellis.trellis_scan(cf, tab, qi)
        assert trellis.trellis_scan.launches == n0 + 1
        assert torch.equal(k, trellis.trellis_scan_plain(cf, tab, qi))
        assert not k[:64].any()
        outs.append(k)
    if not stacked:                    # QP 4's run
        assert (outs[1].abs() >= 15).any()
    elif rows == "ties":
        assert (outs[0].abs() >= 15).any()


def _zero_residual_row(args, dev):
    """K6's arguments with MB row 0 at ptype 0 and MV 0 over a source that
    is its reference there: every block of the row quantises to zero."""
    args = list(args)
    _, ref, _, _ = _p_frame(dev, "inter")
    args[8], args[9] = args[8].clone(), args[9].clone()
    args[8][0], args[9][0] = 0, 0
    for k, (r, n) in enumerate(zip(ref, (16, 8, 8))):
        args[2 + k] = args[2 + k].clone()
        args[2 + k][:n] = r[:n]
    return tuple(args)


@pytest.mark.cuda
@pytest.mark.parametrize("t8", [inter.T8_OFF, inter.T8_SA8D, inter.T8_RD])
@pytest.mark.parametrize("aq_map", [False, True])
@pytest.mark.parametrize("edge", [False, True])
def test_inter_kernel_with_trellis_matches_plain(card, t8, aq_map, edge):
    """K6's trellis branch at t8 0 / 1 / 2, with the frame's consts at QP
    26 or with a QP map and the 52-QP stacks, on random partitions; at
    the edges, MB row 0 codes a zero residual and the QP is 1 (levels past
    the ue escape), or the map's rows are QP 0, 1 and 51."""
    args, _ = _inter_args(card, "inter", True, parts=True)
    if edge:
        args = _zero_residual_row(args, card)
    q, qm = args[10], None
    if aq_map:
        y, u, v = args[2:5]
        qm = aq.qp_map_from_planes_plain(y, u, v, MB_H, MB_W, 26, 1.0, 10,
                                         51, 0)[0]
        if edge:
            qm = torch.as_tensor(np.random.default_rng(6).choice(
                [0, 1, 51], (MB_H, MB_W)), dtype=torch.int32, device=card)
        q = {**_with_stacks(q, card), **inter.trellis_stacks(0, 0, card)}
    else:
        qp = 1 if edge else 26
        q = {**q, **inter.trellis_consts(qp, tables.chroma_qp(qp), 0, card)}
    a = (*args[:10], q, True, t8, qm)
    n0 = inter.p_inter_mb.launches_trellis
    k = inter.p_inter_mb(*a)
    assert inter.p_inter_mb.launches_trellis == n0 + 1
    p = inter.p_inter_mb_plain(*a)
    assert set(k) == set(p)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    plain = inter.p_inter_mb_plain(*args[:10], _with_stacks(args[10], card)
                                   if aq_map else args[10], True, t8, qm)
    assert not torch.equal(plain["blocks_z"], p["blocks_z"])


@pytest.mark.cuda
@pytest.mark.parametrize("trellis_mode", [1, 2])
def test_trellis_encoder_on_the_card_matches_the_cpu(card, trellis_mode):
    """x264_tpu's defaults with the trellis (CRF 23 + AQ, 8x8dct, subme 6)
    at 5x7 MBs: an IDR and two P frames on the card equal the CPU's."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(29)
    base = rng.integers(0, 256, (h + 8, w + 16), dtype=np.uint8)
    base[:, :w // 3] = 90
    frames = [x264_tpu_torch.Frame(
        base[t:t + h, 2 * t:2 * t + w].copy(),
        np.full((h // 2, w // 2), 110 + 4 * t, np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for t in range(3)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_log_level=0)
        p.analyse.i_trellis = trellis_mode
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return (enc.headers(), outs, enc.close(),
                [e.qp for e in enc.rc.entries])

    n0 = inter.p_inter_mb.launches_trellis
    (kh, kout, ksum, kq), (ph, pout, psum, pq) = run(card), run("cpu")
    assert inter.p_inter_mb.launches_trellis == n0 + 2
    assert kh == ph and len(kout) == len(pout) == 3 and kq == pq
    assert [o.frame_type for o in kout] == ["IDR", "P", "P"]
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5


# ------------------------------------------------------------ B frames
def _b_refs(dev):
    """A B frame between two references a pan apart, with independent
    noise on the references (BI pays), flat MBs (intra) and a still
    corner (direct, skip)."""
    rng = np.random.default_rng(41)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    tex = 128 + 60 * np.sin(yy / 5.0) * np.cos(xx / 7.0) \
        + rng.integers(0, 30, yy.shape)

    def at(t, noise):
        f = tex[8 + t:8 + t + h, 8 + 2 * t:8 + 2 * t + w] \
            + rng.integers(-noise, noise + 1, (h, w))
        f[:32, :32] = tex[:32, :32]
        return f

    cur, l0, l1 = at(2, 2), at(0, 12), at(4, 12)
    cur[32:48, 16:64] = 200
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    t = lambda a: torch.as_tensor(np.clip(a, 0, 255), dtype=torch.int32,
                                  device=dev)
    planes = [(t(y), t(110 + (cx + k) % 17), t(140 - (cy + k) % 13))
              for y, k in ((cur, 2), (l0, 0), (l1, 4))]
    ref4 = np.zeros((MB_H * 4, MB_W * 4), np.int32)
    ref4[4:8, 8:12] = -1
    mv4 = np.where(rng.random((MB_H * 4, MB_W * 4, 1)) < 0.3,
                   rng.integers(-12, 13, (MB_H * 4, MB_W * 4, 2)),
                   rng.integers(-1, 2, (MB_H * 4, MB_W * 4, 2)))
    mv4[ref4 < 0] = 0
    return planes, (t(ref4), t(mv4))


@pytest.mark.cuda
@pytest.mark.parametrize("trellis,t8_mode,tqp", [
    (False, False, 26), (True, True, 26), (True, False, 4), (True, True, 51)])
def test_b_kernels_match_plain(card, trellis, t8_mode, tqp):
    """K22 (both passes), K7's B decision and sweeps, K23, K24 and K2's B
    rule, each on the card's outputs of the stage before it, against
    their plain versions; every B mode occurs. With the trellis its
    consts are at tqp (QP 4: levels past the ue escape; 51: most levels
    zero)."""
    ((y, u, v), l0, l1), col = _b_refs(card)
    qp = 26
    q = inter.make_qtab_p(qp, tables.chroma_qp(qp), card)
    if trellis:
        q.update(inter.trellis_consts(tqp, tables.chroma_qp(tqp), 0, card))
    lam = int(tables.LAMBDA_TABLE[qp])
    rng = np.random.default_rng(2)
    seeds = [torch.as_tensor(rng.integers(-8, 9, (MB_H, MB_W, 2)),
                             dtype=torch.int32, device=card)]
    seeds.append(-seeds[0])
    fetch, mvs, satds = [], [], []
    for ref, seed in zip((l0, l1), seeds):
        f, ref_pad = inter.b_list_fetch(*ref)
        mv_fp, _ = me.hier_search(y, ref_pad, MB_H, MB_W, 16, lam, seed)
        mv, satd = me.subpel_refine(y, f[0], mv_fp, lam, seed, (2, 1))
        fetch.append(f)
        mvs.append(mv)
        satds.append(satd)

    def same(k, p, keys=None):
        for key in keys or p:
            assert torch.equal(k[key], p[key]), key

    n22 = inter.b_inter_mb.launches
    k1 = inter.b_inter_mb(MB_H, MB_W, y, u, v, *fetch, q, *mvs, satd=satds,
                          seeds=seeds, lam=lam)
    same(k1, inter.b_inter_mb_plain(MB_H, MB_W, y, u, v, *fetch, q, *mvs,
                                    satd=satds, seeds=seeds, lam=lam))
    assert set(k1["bmode"].unique().tolist()) == {0, 1, 2}
    im = inter.intra_in_b_decide(MB_H, MB_W, y, u, v, k1["recon_y"],
                                 k1["recon_u"], k1["recon_v"],
                                 k1["cost_inter"], q, lam)
    assert torch.equal(im, inter.intra_in_p_plain(
        MB_H, MB_W, y, u, v, k1["recon_y"], k1["recon_u"], k1["recon_v"],
        k1["cost_inter"], q, lam, True, decide_only=True))
    assert im.any()
    args = (MB_H, MB_W, y, *fetch, im, k1["bmode"], *mvs, k1["cost_inter"],
            *col, lam)
    kd = inter.b_direct(*args)
    for a, b in zip(kd, inter.b_direct_plain(*args)):
        assert torch.equal(a, b)
    r0, r1, m0, m1, direct = kd
    assert direct.any()
    k2 = inter.b_inter_mb(MB_H, MB_W, y, u, v, *fetch, q, m0, m1,
                          refs=(r0, r1))
    same(k2, inter.b_inter_mb_plain(MB_H, MB_W, y, u, v, *fetch, q, m0, m1,
                                    refs=(r0, r1)))
    assert inter.b_inter_mb.launches == n22 + 2
    ks = inter.intra_in_b_sweeps(MB_H, MB_W, y, u, v, k2["recon_y"],
                                 k2["recon_u"], k2["recon_v"], im, q, lam)
    same(ks, inter.intra_in_p_plain(MB_H, MB_W, y, u, v, k2["recon_y"],
                                    k2["recon_u"], k2["recon_v"], None, q,
                                    lam, True, intra_mb=im))
    front = dict(inter.merge_intra(ks, k2, MB_H, MB_W), bmode=k1["bmode"],
                 direct_mb=direct, r0=r0, r1=r1, m0=m0, m1=m1)
    kmaps, kops, kn = cabac_planes.cabac_b_ops(front, MB_H, MB_W, t8_mode)
    pmaps, pops, pn = cabac_planes.cabac_b_ops_plain(front, MB_H, MB_W,
                                                     t8_mode)
    same(kmaps, pmaps)
    n = int(pn)
    assert int(kn) == n and torch.equal(kops[:n], pops[:n])
    assert pmaps["skip"].any()
    if tqp != 51:                      # at 51 every direct MB codes nothing
        assert (direct & ~pmaps["skip"]).any()
    qp_mb = torch.full((MB_H, MB_W), qp + 6, dtype=torch.int32, device=card)
    dargs = (qp_mb, im, pmaps["nnz4"], pmaps["ref4"], pmaps["mv4"],
             pmaps["ref4_l1"], pmaps["mv4_l1"], True, 0, 0, 0)
    planes = [t.clone() for t in (ks["recon_y"], ks["recon_u"],
                                  ks["recon_v"])]
    nb = deblock.deblock_frame.launches_b
    kdb = deblock.deblock_frame(MB_H, MB_W, *planes, *dargs)
    assert deblock.deblock_frame.launches_b > nb
    pdb = deblock.deblock_frame_plain(MB_H, MB_W, ks["recon_y"],
                                      ks["recon_u"], ks["recon_v"], *dargs)
    for a, b in zip(kdb, pdb):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [4, 8])
def test_lowres_bcost_kernel_matches_plain(card, r):
    """K21 with one and two references, with and without the bi
    candidate, on lowres planes that pan and jump by 2r (border blocks
    reach the clip and the window wrap)."""
    h, w = 96, 128
    rng = np.random.default_rng(r)
    big = rng.integers(0, 256, (h + 96, w + 96))
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    lows = []
    for dy, dx in ((0, 0), (3, 5), (6 + 4 * r, 10 - 4 * r)):
        f = torch.as_tensor(big[48 - dy:48 - dy + h, 48 - dx:48 - dx + w],
                            dtype=torch.int32, device=card)
        lows.append(lookahead.lowres_planes(f, h, w))
    bh, bw = h // 16, w // 16
    for ref1, bi in ((None, False), (lows[2], False), (lows[2], True)):
        n = lookahead.lowres_bcost.launches
        k = lookahead.lowres_bcost(lows[1], lows[0], ref1, bh, bw, r, bi,
                                   want_mv=True)
        assert lookahead.lowres_bcost.launches == n + 1
        p = lookahead.lowres_bcost_plain(lows[1].cpu(), lows[0].cpu(),
                                         None if ref1 is None else
                                         ref1.cpu(), bh, bw, r, bi)
        for a, b in zip(k, p):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("adapt,depth,cqp,trellis", [(1, 3, None, 0),
                                                     (0, 1, 26, 0),
                                                     (2, 1, None, 1)])
def test_b_encoder_on_the_card_matches_the_cpu(card, adapt, depth, cqp,
                                               trellis):
    """i_bframe 3 at 5x7 MBs, seven frames of a noisy pan: b-adapt 1 at
    x264_tpu's defaults (CRF + AQ) at depth 3, fixed runs at CQP, and
    b-adapt 2 with the trellis; the card's frames equal the CPU's."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h + 16, w + 24), dtype=np.uint8)
    base = ((base.astype(int) + np.roll(base, 1, 1)) // 2).astype(np.uint8)
    frames = [x264_tpu_torch.Frame(
        base[t:t + h, 2 * t:2 * t + w].copy(),
        np.full((h // 2, w // 2), 110 + 2 * t, np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for t in range(7)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h, i_bframe=3,
                                         i_log_level=0,
                                         i_frame_parallel=depth)
        p.i_bframe_adaptive = adapt
        p.analyse.i_trellis = trellis
        if cqp is not None:
            p.rc.i_rc_method, p.rc.i_qp_constant = 0, cqp
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return (enc.headers(), outs, enc.close(),
                [e.qp for e in enc.rc.entries])

    n = (inter.b_inter_mb.launches, inter.b_direct.launches,
         cabac_planes.cabac_b_ops.launches, lookahead.lowres_bcost.launches)
    (kh, kout, ksum, kq), (ph, pout, psum, pq) = run(card), run("cpu")
    assert inter.b_inter_mb.launches > n[0]
    assert inter.b_direct.launches > n[1]
    assert cabac_planes.cabac_b_ops.launches > n[2]
    if adapt:
        assert lookahead.lowres_bcost.launches > n[3]
    assert kh == ph and len(kout) == len(pout) == 7 and kq == pq
    assert "B" in [o.frame_type for o in pout]
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        assert a.display_idx == b.display_idx
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5


def _two_refs(dev, seed=9):
    """Frame 1, its reference moved a few pixels (L0[0]) and an older one
    (L0[1]) that holds the source's middle rows exactly, so that the real
    per-MB choice takes both references."""
    (y, u, v), ref, q, lam = _p_frame(dev, "inter")
    old = [torch.roll(t, (1, -2), (0, 1)) for t in (y, u, v)]
    rows = slice(2 * 16, 4 * 16)
    old[0][rows] = y[rows]
    old[1][rows.start // 2:rows.stop // 2] = u[rows.start // 2:rows.stop // 2]
    old[2][rows.start // 2:rows.stop // 2] = v[rows.start // 2:rows.stop // 2]
    sel = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2, (MB_H, MB_W)), dtype=torch.int32, device=dev)
    return (y, u, v), ref, old, sel, q, lam


@pytest.mark.cuda
@pytest.mark.parametrize("t8,trellis,aq_map", [
    (inter.T8_OFF, False, False), (inter.T8_SA8D, False, True),
    (inter.T8_RD, True, False), (inter.T8_RD, True, True)])
def test_ref2_kernels_match_plain(card, t8, trellis, aq_map):
    """The two-reference branches of K10 (every block shape), K11, K12, K6
    (with the 8x8 transform, the trellis and a QP map) and K13, on a seeded
    reference index holding both values."""
    (y, u, v), ref, old, sel, q, lam = _two_refs(card)
    pads = torch.stack([mc.pad_plane(r[0]) for r in (ref, old)])
    planes = torch.cat([mc.hpel_planes(p) for p in pads])
    cpads = [torch.stack([mc.pad_plane(r[k], mc.PAD // 2) for r in (ref,
                                                                     old)])
             for k in (1, 2)]
    mvp = _mvp(card, 5) // 8
    mv = me.hier_search(y, pads[0], MB_H, MB_W, 16, lam, mvp)[0]
    n10 = me.subpel_refine_blocks.launches_ref2
    for bh, bw, offs, _ in (((16, 16, ((0, 0),), None),)
                            + inter.PART_LAYOUTS):
        n = len(offs)
        ys, xs = me.block_origins(MB_H, MB_W, offs, card)
        s = torch.as_tensor(np.random.default_rng(bh + bw).integers(
            0, 2, (n, MB_H, MB_W)), dtype=torch.int32, device=card)
        args = (y, planes, mv.expand(n, MB_H, MB_W, 2).contiguous(), lam,
                mvp.expand(n, MB_H, MB_W, 2).contiguous(), ys, xs, bh, bw,
                (2, 1), s)
        k, p = me.subpel_refine_blocks(*args), \
            me.subpel_refine_blocks_plain(*args)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert me.subpel_refine_blocks.launches_ref2 == n10 + 4
    args = (y, pads, mv, lam, mvp, 16, True, sel)
    assert torch.equal(me.partition_fullpel(*args),
                       me.partition_fullpel_plain(*args))
    mv_s, satd = me.subpel_refine(y, planes, mv, lam, mvp, (2, 1), sel)
    args = (y, planes, u, v, *cpads, mv_s, lam, mvp, satd, sel)
    k, p = me.chroma_rerank(*args), me.chroma_rerank_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    rng = np.random.default_rng(12)
    ptype = torch.as_tensor(rng.integers(0, 4, (MB_H, MB_W)),
                            dtype=torch.int32, device=card)
    mv_quad = (mv_s[:, :, None] + torch.as_tensor(
        rng.integers(-9, 10, (MB_H, MB_W, 4, 2)), dtype=torch.int32,
        device=card)).contiguous()
    q = inter.make_qtab_p(26, tables.chroma_qp(26), card, rd_idc=0,
                          f_psy_rd=1.0)
    qp_map = None
    if trellis:
        q.update(inter.trellis_consts(26, tables.chroma_qp(26), 0, card))
    if aq_map:
        st = aq.qtab_stacks(aq.full_tables(tables.DEFAULT_QUANT, card), 0)
        q["aq_stack_p"] = st["inter"]
        if trellis:
            q.update(inter.trellis_stacks(0, 0, card))
        qp_map = torch.as_tensor(rng.integers(18, 36, (MB_H, MB_W)),
                                 dtype=torch.int32, device=card)
    args = (MB_H, MB_W, y, u, v, planes, *cpads, ptype, mv_quad, q, True,
            t8, qp_map, sel)
    n6 = inter.p_inter_mb.launches_ref2
    k6, p6 = inter.p_inter_mb(*args), inter.p_inter_mb_plain(*args)
    assert inter.p_inter_mb.launches_ref2 == n6 + 1
    for key in p6:
        assert torch.equal(k6[key], p6[key]), key
    if t8 != inter.T8_SA8D:
        args = (MB_H, MB_W, y, u, v, k6, ptype, mv_quad, mvp, q, sel)
        k13, p13 = inter.rd_inter(*args), inter.rd_inter_plain(*args)
        assert torch.equal(k13[0], p13[0]) and torch.equal(k13[1], p13[1])
        if t8:
            for key in p13[2]:
                assert torch.equal(k13[2][key], p13[2][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("t8", [False, True])
def test_ref2_maps_ops_and_words_match_plain(card, t8):
    """encode_p_front with two references on the card against the CPU's
    (every kernel's ref_sel branch), then K8 with its ref_idx bins, K8's
    pass A alone and K19 with the ref_idx bit, and K2 on a ref4 that holds
    0, 1 and -1, against their plain versions."""
    (y, u, v), ref, old, _, q, lam = _two_refs(card)
    q = inter.make_qtab_p(26, tables.chroma_qp(26), card, rd_idc=0,
                          f_psy_rd=1.0)
    mvp = _mvp(card, 5) // 8
    kw = dict(subpel_steps=(2, 1), parts=True, p8x8=True, chroma_me=True,
              rd=True, t8=t8, ref2=old)
    front = inter.encode_p_front(MB_H, MB_W, 16, y, u, v, *ref, q, lam, mvp,
                                 True, **kw)
    cpu = lambda x: {k: t.cpu() for k, t in x.items()} if isinstance(
        x, dict) else tuple(t.cpu() for t in x)
    qc = {k: (t.cpu() if torch.is_tensor(t) else t) for k, t in q.items()}
    qc["rdbits"] = {c: {n: t.cpu() for n, t in d.items()}
                    for c, d in q["rdbits"].items()}
    pfront = inter.encode_p_front(MB_H, MB_W, 16, *cpu((y, u, v)),
                                  *cpu(ref), qc, lam, mvp.cpu(), True,
                                  **dict(kw, ref2=cpu(old)))
    assert front.keys() == pfront.keys()
    for key in pfront:
        assert torch.equal(front[key].cpu(), pfront[key]), key
    sel, im = front["ref_sel"], front["intra_mb"]
    assert bool(((sel == 1) & ~im).any()) and bool(((sel == 0) & ~im).any())
    kmaps, kops, kn = cabac_planes.cabac_p_ops(front, MB_H, MB_W, 2, t8)
    pmaps, pops, pn = cabac_planes.cabac_p_ops_plain(front, MB_H, MB_W, t8,
                                                     n_refs=2)
    n = int(pn)
    assert int(kn) == n and torch.equal(kops[:n], pops[:n])
    for key in pmaps:
        assert torch.equal(kmaps[key], pmaps[key]), key
    assert set(pmaps["ref4"].unique().tolist()) <= {-1, 0, 1}
    assert bool((pmaps["ref4"] == 1).any())
    z4 = torch.zeros_like(kmaps["ref4"])
    qp_mb = torch.full((MB_H, MB_W), 30, dtype=torch.int32, device=card)
    dargs = (qp_mb, im, kmaps["nnz4"], kmaps["ref4"], kmaps["mv4"], z4,
             torch.zeros_like(kmaps["mv4"]), False, 0, 0, 0,
             kmaps.get("t8_mb"))
    src = [front[k] for k in ("recon_y", "recon_u", "recon_v")]
    p = deblock.deblock_frame_plain(MB_H, MB_W, *src, *dargs)
    k = deblock.deblock_frame(MB_H, MB_W, *[t.clone() for t in src], *dargs)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if t8:
        return
    maps = cabac_planes.p_maps(front, MB_H, MB_W)
    pm = inter.p_maps_plain(front, MB_H, MB_W)
    for key in pm:
        assert torch.equal(maps[key], pm[key]), key
    hdr = np.zeros(cavlc_device.HDR_SLOTS, np.int32)
    cap = pipeline.capacity_words(MB_H * MB_W)
    for c in (cap, 40):                   # 40 words drop codes
        kw_, kb = cavlc_device.cavlc_p_slice(front, maps, MB_H, MB_W, hdr,
                                             hdr, c, 2)
        pw, pb = cavlc_device.cavlc_p_slice_plain(front, maps, MB_H, MB_W,
                                                  hdr, hdr, c, 2)
        assert int(kb) == int(pb) and torch.equal(kw_, pw)
    assert int(pb) > 40 * 32


@pytest.mark.cuda
def test_cavlc_b_kernels_match_plain(card):
    """K24's pass A alone and K25 on the card's B front (the chain of
    test_b_kernels_match_plain), at the full capacity and at one that
    drops codes."""
    ((y, u, v), l0, l1), col = _b_refs(card)
    q = inter.make_qtab_p(26, tables.chroma_qp(26), card)
    lam = int(tables.LAMBDA_TABLE[26])
    seed = torch.as_tensor(np.random.default_rng(2).integers(
        -8, 9, (MB_H, MB_W, 2)), dtype=torch.int32, device=card)
    front = inter.encode_b_front(MB_H, MB_W, 16, y, u, v, l0, l1, q, lam,
                                 seed, -seed, *col)
    n0 = cabac_planes.b_maps.launches
    maps = cabac_planes.b_maps(front, MB_H, MB_W)
    assert cabac_planes.b_maps.launches == n0 + 1
    pm = inter.b_maps_plain(front, MB_H, MB_W)
    for key in pm:
        assert torch.equal(maps[key], pm[key]), key
    assert front["intra_mb"].any() and maps["skip"].any()
    hdr = np.zeros(cavlc_device.HDR_SLOTS, np.int32)
    cap = pipeline.capacity_words(MB_H * MB_W)
    n25 = cavlc_device.cavlc_b_slice.launches
    for c in (cap, 40):
        kw_, kb = cavlc_device.cavlc_b_slice(front, maps, MB_H, MB_W, hdr,
                                             hdr, c)
        pw, pb = cavlc_device.cavlc_b_slice_plain(front, maps, MB_H, MB_W,
                                                  hdr, hdr, c)
        assert int(kb) == int(pb) and torch.equal(kw_, pw)
    assert int(pb) > 40 * 32
    assert cavlc_device.cavlc_b_slice.launches == n25 + 8


@pytest.mark.cuda
@pytest.mark.parametrize("cabac,ref", [(True, 3), (False, 2)])
def test_ref2_and_cavlc_b_encoder_on_the_card_matches_the_cpu(card, cabac,
                                                              ref):
    """--ref 3 (clamped to 2) with CABAC and the trellis, and --ref 2 with
    CAVLC, each with one B frame (b-adapt 0) at x264_tpu's defaults, on
    a flash sequence at 5x7 MBs; the card's frames equal the CPU's and
    the two-reference branches and (CAVLC) K25 ran."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(17)
    base = rng.integers(0, 256, (h, w), dtype=np.uint8)
    pat = [rng.integers(0, 256, (24, w), dtype=np.uint8) for _ in range(2)]
    frames = []
    for t in range(7):
        yy = base.copy()
        yy[16:40] = pat[(t // 2) % 2]
        frames.append(x264_tpu_torch.Frame(
            yy, np.full((h // 2, w // 2), 110 + t, np.uint8),
            rng.integers(100, 140, (h // 2, w // 2), dtype=np.uint8)))

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h, i_bframe=1,
                                         i_log_level=0, b_cabac=cabac,
                                         i_frame_reference=ref)
        p.i_bframe_adaptive = 0
        p.analyse.i_trellis = int(cabac)
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs = [enc.encode(f) for f in frames]
        outs = [o for o in outs if o is not None] + enc.flush()
        return (enc.headers(), outs, enc.close(),
                [e.qp for e in enc.rc.entries])

    n = (inter.p_inter_mb.launches_ref2, me.subpel_refine_blocks.launches_ref2,
         cavlc_device.cavlc_b_slice.launches)
    (kh, kout, ksum, kq), (ph, pout, psum, pq) = run(card), run("cpu")
    assert inter.p_inter_mb.launches_ref2 > n[0]
    assert me.subpel_refine_blocks.launches_ref2 > n[1]
    assert (cavlc_device.cavlc_b_slice.launches > n[2]) == (not cabac)
    assert kh == ph and len(kout) == len(pout) == 7 and kq == pq
    assert "B" in [o.frame_type for o in pout]
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        assert a.display_idx == b.display_idx
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    assert abs(ksum["psnr"]["avg"] - psum["psnr"]["avg"]) <= 1e-3
    assert abs(ksum["ssim_y"] - psum["ssim_y"]) <= 1e-5


# ------------------------------------------- noise reduction, lossless
@pytest.mark.cuda
@pytest.mark.parametrize("grid,nblk,n", [((5, 7), 16, 16), ((40, 40), 4, 64),
                                         ((100, 40), 16, 16),
                                         ((68, 120), 16, 16),
                                         ((68, 120), 4, 64)])
def test_nr_sums_kernel_matches_plain(card, grid, nblk, n):
    """K26 on |coef| grids of one window, of 2 x 2 and 4 x 2 windows (the
    vectorised last reduce) and of 1080p's 3 x 4, with values large
    enough that the sums pass 2^24: bit-equal to the plain version."""
    rng = np.random.default_rng(sum(grid) + n)
    a = torch.as_tensor(rng.integers(0, 20000, (*grid, nblk, n)),
                        dtype=torch.int32, device=card)
    n0 = oquant.nr_sums.launches
    k = oquant.nr_sums(a)
    assert oquant.nr_sums.launches == n0 + 1
    p = oquant.nr_sums_plain(a)
    assert k.dtype == torch.float32 and torch.equal(k, p)
    if grid[0] * grid[1] > 1000:
        assert float(p.max()) > 2 ** 24


@pytest.mark.cuda
@pytest.mark.parametrize("t8", [inter.T8_OFF, inter.T8_SA8D, inter.T8_RD])
@pytest.mark.parametrize("trellis,aq_map", [(False, False), (True, True)])
def test_inter_kernel_with_nr_matches_plain(card, t8, trellis, aq_map):
    """K6's NR branch (the shrink before the deadzone quant or the
    trellis, the |coef| out to K26) on random partitions, with the 8x8
    offsets where the 8x8 transform runs."""
    args, _ = _inter_args(card, "inter", True, parts=True)
    q, qm = args[10], None
    if aq_map:
        y, u, v = args[2:5]
        qm = aq.qp_map_from_planes_plain(y, u, v, MB_H, MB_W, 26, 1.0, 10,
                                         51, 0)[0]
        q = _with_stacks(q, card)
    if trellis:
        q = {**q, **(inter.trellis_stacks(0, 0, card) if aq_map else
                     inter.trellis_consts(26, tables.chroma_qp(26), 0,
                                          card))}
    rng = np.random.default_rng(t8)
    off4 = torch.as_tensor(rng.integers(0, 300, 16), dtype=torch.int32,
                           device=card)
    off8 = torch.as_tensor(rng.integers(0, 300, 64), dtype=torch.int32,
                           device=card)
    a = (*args[:10], q, True, t8, qm)
    n0 = inter.p_inter_mb.launches_nr
    k = inter.p_inter_mb(*a, nr_offset4=off4, nr_offset8=off8)
    assert inter.p_inter_mb.launches_nr == n0 + 1
    p = inter.p_inter_mb_plain(*a, nr_offset4=off4,
                               nr_offset8=off8 if t8 else None)
    assert set(k) == set(p) and ("nr_sum8" in p) == (t8 != inter.T8_OFF)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    assert not torch.equal(inter.p_inter_mb_plain(*a)["blocks_z"],
                           p["blocks_z"])


@pytest.mark.cuda
def test_lossless_kernels_match_plain(card):
    """K1, K6 and K7 at CQP 0 with the bypass: every output equal to the
    plain version's, and every recon equal to its source."""
    y, u, v = _frame(card, 7)
    qp = 0
    q = inter.make_qtab_p(qp, tables.chroma_qp(qp), card)
    lam = int(tables.LAMBDA_TABLE[qp])
    n0 = intra.encode_i16_frame.launches_lossless
    k1 = intra.encode_i16_frame(MB_H, MB_W, y, u, v, q, lam, lossless=True)
    assert intra.encode_i16_frame.launches_lossless == n0 + MB_H + MB_W - 1
    p1 = intra.encode_i16_frame_plain(MB_H, MB_W, y, u, v, q, lam,
                                      lossless=True)
    for key in p1:
        assert torch.equal(k1[key], p1[key]), key
    for src, key in ((y, "recon_y"), (u, "recon_u"), (v, "recon_v")):
        assert torch.equal(k1[key], src), key
    assert k1["i4_mb"].any()
    args, cost = _inter_args(card, "intra", False, parts=True)
    yy, uu, vv = args[2:5]
    a6 = (*args[:10], q, False)
    k6 = inter.p_inter_mb(*a6, lossless=True)
    p6 = inter.p_inter_mb_plain(*a6, lossless=True)
    for key in p6:
        assert torch.equal(k6[key], p6[key]), key
    assert torch.equal(k6["recon_y"], yy) and torch.equal(k6["recon_u"], uu)
    a7 = (MB_H, MB_W, yy, uu, vv, k6["recon_y"], k6["recon_u"],
          k6["recon_v"], cost, q, lam, False)
    n7 = inter.intra_in_p.launches_lossless
    k7 = inter.intra_in_p(*a7, lossless=True)
    assert inter.intra_in_p.launches_lossless == n7 + 4
    p7 = inter.intra_in_p_plain(*a7, lossless=True)
    for key in p7:
        assert torch.equal(k7[key], p7[key]), key
    assert torch.equal(k7["recon_y"], yy) and k7["intra_mb"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nr_jvt", "lossless_cabac",
                                  "lossless_cavlc"])
def test_nr_and_lossless_encoder_on_the_card_matches_the_cpu(card, mode):
    """The card's Encoder against the CPU's at 5x7 MBs: the defaults with
    --nr 250, --cqm jvt and --trellis 1 at i_frame_parallel 2 (the NR
    offsets after every frame too), and CQP 0 under CABAC and CAVLC
    (every recon equal to its source)."""
    w, h = MB_W * 16 - 6, MB_H * 16 - 4
    rng = np.random.default_rng(31)
    base = rng.integers(0, 256, (h + 8, w + 16), dtype=np.uint8)
    base[:, :w // 3] = 90
    frames = [x264_tpu_torch.Frame(
        base[t:t + h, 2 * t:2 * t + w].copy(),
        np.full((h // 2, w // 2), 110 + 4 * t, np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
        for t in range(4)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_log_level=0, i_frame_parallel=2)
        if mode == "nr_jvt":
            p.analyse.i_noise_reduction = 250
            p.analyse.i_trellis = 1
            p.i_cqm_preset = 1
        else:
            p.rc.i_rc_method = 0
            p.rc.i_qp_constant = 0
            p.b_cabac = mode == "lossless_cabac"
        enc = x264_tpu_torch.Encoder(p, device=device)
        outs, offs = [], []
        for f in frames:
            o = enc.encode(f)
            if o is not None:
                outs.append(o)
                offs.append([a.copy() for a in getattr(enc, "_nr_off", [])])
        for o in enc.flush():
            outs.append(o)
            offs.append([a.copy() for a in getattr(enc, "_nr_off", [])])
        return enc.headers(), outs, offs

    n0 = (inter.p_inter_mb.launches_nr, oquant.nr_sums.launches,
          inter.p_inter_mb.launches_lossless)
    (kh, kout, koffs), (ph, pout, poffs) = run(card), run("cpu")
    n1 = (inter.p_inter_mb.launches_nr, oquant.nr_sums.launches,
          inter.p_inter_mb.launches_lossless)
    if mode == "nr_jvt":
        assert (n1[0] - n0[0], n1[1] - n0[1]) == (3, 6)
    else:
        assert n1[2] - n0[2] == 3
    assert kh == ph and len(kout) == len(pout) == 4
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))
    for a, b in zip(koffs, poffs):
        for x, z in zip(a, b):
            assert np.array_equal(x, z)
    if mode != "nr_jvt":
        for a, f in zip(kout, frames):
            assert np.array_equal(a.recon.y.cpu().numpy(), f.y)


@pytest.mark.cuda
@pytest.mark.parametrize("ext_share,cap_hw", [(0.0, 3 * 4096), (0.3, 3 * 4096),
                                              (1.0, 3 * 4096), (0.4, 3001)])
def test_hw_pack_kernel_matches_plain(card, ext_share, cap_hw):
    """K27 against its plain version on a seeded op stream of compact and
    extended ops (the live prefix of the words, and the count, exact;
    with a capacity that drops halfwords), and on K3's op stream."""
    rng = np.random.default_rng(int(10 * ext_share))
    n, cap = 2900, 4096
    kind = rng.choice([0, 1, 2, 3, 5, 6, 7], n).astype(np.int64)
    abits = np.asarray(cabac_planes.HW_A_BITS)[kind]
    a = rng.integers(0, 1 << 17, n) % np.where(
        rng.random(n) < ext_share, 1 << 17, 1 << abits)
    b = rng.integers(0, 1 << 12, n) % np.where(
        rng.random(n) < ext_share, 1 << 12, 1 << (12 - abits))
    ops = np.zeros(cap, np.int64)
    ops[:n] = (kind << 29) | (b << 17) | a
    ops = torch.from_numpy(ops.astype(np.uint32).view(np.int32))
    pw, pn = cabac_planes.hw_pack_plain(ops, n, cap_hw)
    n0 = cabac_planes.hw_pack.launches
    kw, kn = cabac_planes.hw_pack(ops.to(card),
                                  torch.tensor(n, dtype=torch.int32,
                                               device=card), cap_hw)
    torch.cuda.synchronize()
    assert cabac_planes.hw_pack.launches == n0 + 3
    assert int(kn) == int(pn)
    live = min((int(pn) + 1) // 2, pw.shape[0])
    assert torch.equal(kw[:live].cpu(), pw[:live])
    _, out, _ = _intra(card)
    k3, k3n = cabac_planes.i_slice_ops(out, MB_H, MB_W)
    pw, pn = cabac_planes.hw_pack_plain(k3.cpu(), k3n.cpu(), 3 * k3.shape[0])
    kw, kn = cabac_planes.hw_pack(k3, k3n, 3 * k3.shape[0])
    assert int(kn) == int(pn)
    assert torch.equal(kw[:(int(pn) + 1) // 2].cpu(), pw[:(int(pn) + 1) // 2])


@pytest.mark.cuda
def test_halo_extend_kernel_matches_plain(card):
    """K28 against its plain version on 4 bands of a 5x7-MB frame cut into
    bands of 2 MB rows (band 0, the inner bands and the last), exact, with
    one launch a band."""
    from x264_tpu_torch.parallel import rows
    rng = np.random.default_rng(4)
    n, band, w = 4, 2, MB_W * 16
    planes = [rng.integers(0, 256, (n * band * s, w * s // 16))
              for s in (16, 8, 8)]
    bands = [tuple(torch.as_tensor(p[k * band * s:(k + 1) * band * s],
                                   dtype=torch.int32)
                   for p, s in zip(planes, (16, 8, 8))) for k in range(n)]
    on_card = [tuple(t.to(card) for t in b) for b in bands]
    for k in range(n):
        n0 = rows.halo_extend.launches
        got = rows.ext_refs(on_card, k, card)
        assert rows.halo_extend.launches == n0 + 1
        want = rows.ext_refs(bands, k, torch.device("cpu"))
        for g, e in zip(got, want):
            assert torch.equal(g.cpu(), e)


@pytest.mark.cuda
@pytest.mark.parametrize("cabac", [True, False])
def test_sharded_encoder_on_the_card_matches_the_cpu(card, cabac):
    """The card's Encoder with i_mb_row_shards 4 on [card] * 4 against the
    CPU's on ["cpu"] * 4, at 128x128 (bands of 2 MB rows): CABAC with two
    references, B runs of 2 (b-adapt 0), variance AQ and the 8x8
    transform, and CAVLC at CQP 26; K27 (CABAC) and K28 must launch."""
    from x264_tpu_torch.parallel import rows
    w = h = 128
    rng = np.random.default_rng(3)
    tex = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    frames = [x264_tpu_torch.Frame(
        tex[2 * t:2 * t + h, 3 * t:3 * t + w].copy(),
        np.full((h // 2, w // 2), 100 + 5 * t, np.uint8),
        tex[:h // 2, t:t + w // 2].copy()) for t in range(5)]

    def run(device):
        p = x264_tpu_torch.EncoderParams(i_width=w, i_height=h,
                                         i_log_level=0, b_cabac=cabac,
                                         i_mb_row_shards=4, i_keyint_max=8)
        if cabac:
            p.i_frame_reference, p.i_bframe = 2, 2
            p.i_bframe_adaptive, p.i_scenecut_threshold = 0, 0
            p.analyse.i_subpel_refine = 5
        else:
            p.rc.i_rc_method, p.rc.i_qp_constant = 0, 26
        enc = x264_tpu_torch.Encoder(p, device=[device] * 4)
        assert enc._n_shards == 4
        outs = [o for o in (enc.encode(f) for f in frames) if o is not None]
        return enc.headers(), outs + enc.flush()

    n0 = (cabac_planes.hw_pack.launches, rows.halo_extend.launches)
    (kh, kout), (ph, pout) = run(card), run(torch.device("cpu"))
    n1 = (cabac_planes.hw_pack.launches, rows.halo_extend.launches)
    assert n1[1] > n0[1] and (n1[0] > n0[0]) == cabac
    assert kh == ph and len(kout) == len(pout) == 5
    for a, b in zip(kout, pout):
        assert a.frame_type == b.frame_type and a.payload == b.payload
        for pl in "yuv":
            assert torch.equal(getattr(a.recon, pl).cpu(),
                               getattr(b.recon, pl))


@pytest.mark.cuda
@pytest.mark.parametrize("i8x8,lossless,aq_map", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True)])
def test_intra_i16only_kernel_matches_plain(card, i8x8, lossless, aq_map):
    """K1 without the I4x4 ladder (--partitions none), with and without
    I8x8, lossless and with a QP map: every output equal to the plain
    version's, no MB I4x4, each launch counted in launches_i16."""
    y, u, v = _blocky(card) if i8x8 else _frame(card, 9)
    qp = 0 if lossless else 26
    q = _with_stacks(intra.make_qtab(qp, tables.chroma_qp(qp), card), card)
    lam = int(tables.LAMBDA_TABLE[qp])
    qp_map = aq.qp_map_from_planes_plain(y, u, v, MB_H, MB_W, qp, 1.0, 10,
                                         51, 0)[0] if aq_map else None
    n0 = intra.encode_i16_frame.launches_i16
    k = intra.encode_i16_frame(MB_H, MB_W, y, u, v, q, lam, i8x8, qp_map,
                               lossless, i4x4=False)
    n_diag = len(intra.diagonals(MB_H, MB_W, i8x8))
    assert intra.encode_i16_frame.launches_i16 == n0 + n_diag
    p = intra.encode_i16_frame_plain(MB_H, MB_W, y, u, v, q, lam, i8x8,
                                     qp_map, lossless, i4x4=False)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    assert torch.equal(p["i4_mb"], p["t8_mb"]) if i8x8 \
        else not p["i4_mb"].any()
    if i8x8:
        assert p["t8_mb"].any()


@pytest.mark.cuda
def test_intra_batch_kernel_matches_plain(card):
    """K1's frame axis: three frames in one launch a diagonal, equal to
    the plain version and to K1 frame by frame without I4x4."""
    fr = [_frame(card, s) for s in (1, 2, 3)]
    ys, us, vs = (torch.stack([f[i] for f in fr]) for i in range(3))
    q = intra.make_qtab(26, tables.chroma_qp(26), card)
    lam = int(tables.LAMBDA_TABLE[26])
    n0 = intra.encode_i16_frame.launches_batch
    k = intra.encode_i16_frames(MB_H, MB_W, ys, us, vs, q, lam)
    assert intra.encode_i16_frame.launches_batch == n0 + MB_H + MB_W - 1
    p = intra.encode_i16_frames_plain(MB_H, MB_W, ys, us, vs, q, lam)
    for key in p:
        assert torch.equal(k[key], p[key]), key
    for i, f in enumerate(fr):
        one = intra.encode_i16_frame(MB_H, MB_W, *f, q, lam, i4x4=False)
        for key in one:
            assert torch.equal(k[key][i], one[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("r,flat,far", [(4, False, 0), (16, False, 0),
                                        (16, True, 0), (40, False, 0),
                                        (40, False, -160), (40, False, 160)])
def test_fullpel_search_kernel_matches_plain(card, r, flat, far):
    """K29 at R = 4 and 16 and at R = 40 past the pad (the clamped
    windows), on noise and on a flat reference (every candidate ties on
    its SAD), with a nonzero MV predictor, and with one far predictor
    that a large lambda makes win (its SAD read at the clamped window)."""
    y, _, _ = _frame(card, 5)
    rng = np.random.default_rng(r)
    ref = torch.full_like(y, 100) if flat else torch.roll(y, (3, -5), (0, 1))
    ref_pad = mc.pad_plane(ref)
    mvp = torch.as_tensor(rng.integers(-40, 40, (MB_H, MB_W, 2)),
                          dtype=torch.int32, device=card)
    lam = 4
    if far:
        mvp, lam = torch.full_like(mvp, far), 3000
    n0 = me.fullpel_search.launches
    k = me.fullpel_search(y, ref_pad, MB_H, MB_W, r, lam, mvp)
    assert me.fullpel_search.launches == n0 + 1
    p = me.fullpel_search_plain(y, ref_pad, MB_H, MB_W, r, lam, mvp)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if far:
        assert (k[0] == far).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 8), (2, 5, 16, 16), (7, 8, 16),
                                   (4, 16, 8)])
def test_hadamard_ac_kernel_matches_plain(card, shape):
    """K30 at 8x8, 16x16, 8x16 and 16x8 tiles with leading shapes, on
    pixels, on signed residuals and on values whose sums wrap int32."""
    rng = np.random.default_rng(len(shape))
    for lo, hi in ((0, 256), (-255, 256), (-(1 << 28), 1 << 28)):
        pix = torch.as_tensor(rng.integers(lo, hi, shape), dtype=torch.int32,
                              device=card)
        n0 = opixel.hadamard_ac.launches
        k = opixel.hadamard_ac(pix)
        assert opixel.hadamard_ac.launches == n0 + 1
        p = opixel.hadamard_ac_plain(pix)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_gop_batch_and_lowres_plane_on_the_card(card):
    """encode_gop_intra over [card] * 2 against the plain version on the
    CPU, and lowres_plane (K14's phase-00 plane) against its plain
    version."""
    from x264_tpu_torch.parallel import mesh
    fr = [_frame("cpu", s) for s in (1, 2, 3, 4)]
    ys, us, vs = (torch.stack([f[i] for f in fr]) for i in range(3))
    qc = intra.make_qtab(26, tables.chroma_qp(26), "cpu")
    lam = int(tables.LAMBDA_TABLE[26])
    k = mesh.encode_gop_intra([card] * 2, MB_H, MB_W, ys, us, vs, qc, lam)
    p = mesh.encode_gop_intra(["cpu"] * 2, MB_H, MB_W, ys, us, vs, qc, lam)
    for key in p:
        assert k[key].device.type == "cuda"
        assert torch.equal(k[key].cpu(), p[key]), key
    y = fr[0][0].to(card)
    got = lookahead.lowres_plane(y)
    want = lookahead.lowres_planes_plain(y, *y.shape)[0]
    assert torch.equal(got, want)

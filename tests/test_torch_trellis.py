"""The port's CABAC trellis against x264_tpu's: the 52-QP const stacks
(make_consts_all_qp), the batched trellis itself (ops/trellis.py:
trellis_scan_plain against x264_tpu/ops/trellis.py:trellis_scan), and the
trellis branches of the inter residual (inter_luma_residual,
inter_luma_residual8, chroma_ac_scan, chroma_residual) and of K6's plain
version p_inter_mb_plain at t8 0, 1 and 2, with the frame QP's consts
(the CQP path) and with per-MB rows of the stacks (variance AQ). Inputs
are made with numpy from a seed; every output is an integer and must be
exactly equal.

x264_tpu's trellis runs under jax.jit with its consts passed as
arguments, as its encoder passes them inside the traced qtab: the float32
scores then round as XLA's CPU backend compiles that program (some
multiply-adds contracted into FMAs, trellis.py:_score), and closed-over
consts would fold into constants and round differently. Each jitted
program compiles once per shape, so the tests share their shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables as jtables
from x264_tpu.encoder import aq as jaq
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import intra as jintra
from x264_tpu.ops import quant as jquant
from x264_tpu.ops import trellis as jtr
from x264_tpu_torch import tables
from x264_tpu_torch.encoder import aq, inter, intra
from x264_tpu_torch.ops import dct as odct
from x264_tpu_torch.ops import fma, mc
from x264_tpu_torch.ops import pixel as opix
from x264_tpu_torch.ops import trellis as tr

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
CQM = {2: tables.CQM_4PY, 3: tables.CQM_4PC, 4: tables.CQM_4PC,
       5: tables.CQM_8PY}
_scan = jax.jit(jtr.trellis_scan)      # the consts are arguments


@pytest.mark.parametrize("cat", [2, 3, 4, 5])
def test_const_stacks_match_jax(cat):
    """make_consts_all_qp (each row's states and lambda2 at its own QP),
    and the frame form with the chroma states at the slice QP."""
    want = jtr.make_consts_all_qp(cat, CQM[cat], False, 1)
    got = tr.make_consts_all_qp(cat, CQM[cat], False, 1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for qp, state_qp in ((30, 33), (51, 51), (0, 4)):
        want = jtr.make_consts(qp, cat, CQM[cat], False, 2,
                               state_qp=state_qp)
        got = tr.make_consts(qp, cat, CQM[cat], False, 2, state_qp=state_qp)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


def test_packed_tables_are_the_consts():
    """pack_trellis / unpack_trellis round trip, and K6's tables: the frame
    QP's four categories, and row q of the stack with the luma categories
    at q and the chroma ones at q's chroma QP."""
    fr = inter.trellis_consts(30, tables.chroma_qp(30), 1, "cpu")
    off = 0
    for key, cat, _ in inter.TRELLIS_QTAB:
        n = tr.trellis_ints(int(tr.CAT_C[cat]))
        back = tr.unpack_trellis(fr["trellis_tab"][off:off + n],
                                 int(tr.CAT_C[cat]))
        for k, v in fr[key].items():
            assert torch.equal(back[k], v), (key, k)
        off += n
    assert off == inter.K6_TRELLIS_INTS == fr["trellis_tab"].numel()
    st = inter.trellis_stacks(1, -3, "cpu")
    qc = st["trellis_qpc_of"]
    for q in (0, 17, 40, 51):
        assert int(qc[q]) == tables.chroma_qp(q, -3)
        row, off = st["trellis_tab"][q], 0
        for key, cat, _ in inter.TRELLIS_QTAB:
            n = tr.trellis_ints(int(tr.CAT_C[cat]))
            r = q if cat in (2, 5) else int(qc[q])
            want = tr.pack_trellis({k: v[r] for k, v in st[key].items()})
            assert torch.equal(row[off:off + n], want), (q, key)
            off += n


def _laplace(seed, n=200_000, C=16):
    """Finding 1's set: Laplacian coefficients at four scales."""
    rng = np.random.default_rng(seed)
    scale = rng.choice([8, 40, 200, 1500], size=(n, 1))
    return (rng.laplace(0, 1, (n, C)) * scale).astype(np.int32)


# windows of 16384 blocks of two seeded sets, each holding a block on
# which one uniform rounding of base + bits * lam2 differs from x264_tpu
# (a separate multiply and add everywhere on seed 0 at QP 26, an FMA
# everywhere on seed 1 at QP 34); x264_tpu's mixed rounding is the port's
ROUNDING = [(0, 26, 163_840, "no fma"), (1, 34, 65_536, "all fma")]
_UNIFORM = {"no fma": lambda kind, bits, lam2, base: base + bits * lam2,
            "all fma": lambda kind, bits, lam2, base: fma.fma_f32(
                bits, lam2, base)}


@pytest.mark.parametrize("seed,qp,start,other", ROUNDING)
def test_trellis_rounding_matches_jax(seed, qp, start, other, monkeypatch):
    cf = _laplace(seed)[start:start + 16_384]
    want = np.asarray(_scan(jnp.asarray(cf), jtr.make_consts(
        qp, 2, jtables.CQM_4PY, False, 0, state_qp=26)))
    tc = tr.make_consts(qp, 2, tables.CQM_4PY, False, 0, state_qp=26)
    np.testing.assert_array_equal(tr.trellis_scan_plain(T(cf), tc).numpy(),
                                  want)
    monkeypatch.setattr(tr, "_score", _UNIFORM[other])
    off = tr.trellis_scan_plain(T(cf), tc).numpy()
    assert (off != want).any(1).sum() == 1


def _extremes(cat):
    """Coefficient rows in scan order at the extremes 8-bit residuals
    reach: for each coefficient, the residual block of +-255 in the signs
    of its basis row (and its negation), transformed whole; for the
    chroma DC, every sign pattern of four DCs of +-4080 through the 2x2
    Hadamard."""
    if cat == 3:
        signs = np.array(np.meshgrid(*[[-1, 1]] * 4)).reshape(4, -1).T
        dc = torch.as_tensor(signs * 4080, dtype=torch.int32).reshape(-1, 2, 2)
        return odct.hadamard2x2(dc).reshape(-1, 4).numpy()
    n = 8 if cat == 5 else 4
    fn = odct.dct8x8 if cat == 5 else odct.dct4x4
    eye = torch.eye(n * n, dtype=torch.int32).reshape(-1, n, n)
    basis = fn(eye).reshape(n * n, n * n).numpy().T        # [coef, sample]
    res = 255 * np.where(basis >= 0, 1, -1)
    res = np.concatenate([res, -res]).reshape(-1, n, n)
    co = fn(torch.as_tensor(res, dtype=torch.int32)).reshape(-1, n * n)
    zz = tables.ZIGZAG8 if cat == 5 else tables.ZIGZAG4
    co = co.numpy()[:, zz]
    return co[:, 1:] if cat == 4 else co


@pytest.mark.parametrize("cat", [2, 3, 4, 5])
def test_int32_products_stay_in_range(cat):
    """|coef| * qmf + 2^15 and uqmf * level + 128, which x264_tpu and the
    port compute in int32, stay below 2^31 at the extreme coefficients
    for every QP."""
    amax = np.abs(_extremes(cat)).max(0).astype(np.int64)
    for qp in range(52):
        c = tr.make_consts(qp, cat, CQM[cat], False, 0)
        p1 = amax * c["qmf"] + (1 << 15)
        p2 = c["uqmf"] * (p1 >> 16) + 128
        assert p1.max() < 2.2e8 and p2.max() < 4.4e6, qp


def _unit_set(cat, n):
    """n rows: the extremes, all-zero rows, then seeded Laplacian rows."""
    C = int(tr.CAT_C[cat])
    ext = _extremes(cat)
    return np.concatenate([ext, np.zeros((64, C), np.int32),
                           _laplace(10 + cat, n - len(ext) - 64, C)])


@pytest.mark.parametrize("cat,qp", [(2, 1), (2, 51), (3, 1), (3, 26),
                                    (3, 51), (4, 1), (4, 26), (4, 51)])
def test_trellis_matches_jax(cat, qp):
    """Shared consts at the extremes, on all-zero blocks and on Laplacian
    blocks; levels >= 15 (the ue escape) at QP 1."""
    cf = _unit_set(cat, 16_384 if cat == 2 else 4096)
    want = np.asarray(_scan(jnp.asarray(cf), jtr.make_consts(
        qp, cat, CQM[cat], False, 0, state_qp=26)))
    tc = tr.make_consts(qp, cat, CQM[cat], False, 0, state_qp=26)
    np.testing.assert_array_equal(tr.trellis_scan_plain(T(cf), tc).numpy(),
                                  want)
    if qp == 1:
        assert (np.abs(want) >= 15).any()
    assert not want[len(_extremes(cat)):len(_extremes(cat)) + 64].any()


@pytest.mark.parametrize("cat,qp,lam2", [
    (2, 26, None), (2, 26, 0.0), (2, 1, 1e7), (3, 1, None), (3, 51, 0.0),
    (4, 26, 1e7), (4, 51, None)])
def test_trellis_ties_match_jax(cat, qp, lam2):
    """tie_coefs' rows (zero blocks, magnitudes on either side of q's
    rounding edge, lone coefficients, levels past the ue escape) at the
    shapes of test_trellis_matches_jax, with lam2 the table's, 0 (every
    path of equal distortion ties) or 1e7."""
    n = 16_384 if cat == 2 else 4096
    jc = jtr.make_consts(qp, cat, CQM[cat], False, 0, state_qp=26)
    tc = tr.make_consts(qp, cat, CQM[cat], False, 0, state_qp=26)
    if lam2 is not None:
        jc = dict(jc, lam2=np.float32(lam2))
        tc = dict(tc, lam2=np.float32(lam2))
    cf = tr.tie_coefs(tc["qmf"], n, cat + qp)
    want = np.asarray(_scan(jnp.asarray(cf), jc))
    np.testing.assert_array_equal(tr.trellis_scan_plain(T(cf), tc).numpy(),
                                  want)
    assert not want[:n // 8].any() and (np.abs(want) >= 15).any()


# ----------------------------------------------- the residual functions
MB_H, MB_W, QP = 4, 6, 30
K = MB_H * MB_W


def _frame():
    """A P frame's inputs: source and reference planes, random partition
    types and quarter-pel quadrant MVs; MB 0 codes 255 over a zero
    reference, MB 1 +-255 in a checkerboard of 4x4 sign patterns, MB 2
    the reference itself, the rest the reference under noise of growing
    amplitude."""
    rng = np.random.default_rng(5)
    H, W = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:H, 0:W]
    ref = [((xx * 3 + yy * 2) % 256).astype(np.int32),
           rng.integers(60, 200, (H // 2, W // 2)).astype(np.int32),
           rng.integers(60, 200, (H // 2, W // 2)).astype(np.int32)]
    amp = np.kron(rng.choice([1, 4, 12, 40, 120], (MB_H, MB_W)),
                  np.ones((16, 16)))
    src = [np.clip(ref[0] + rng.laplace(0, 1, (H, W)) * amp, 0, 255)]
    for c in ref[1:]:
        src.append(np.clip(c + rng.laplace(0, 1, c.shape)
                           * amp[::2, ::2], 0, 255))
    ptype = rng.integers(0, 4, (MB_H, MB_W))
    mv = rng.integers(-20, 21, (MB_H, MB_W, 4, 2))
    for k in range(3):                         # MBs 0-2: no motion
        ptype[0, k] = 0
        mv[0, k] = 0
    ref[0][:16, :16], src[0][:16, :16] = 0, 255
    ref[1][:8, :8] = ref[2][:8, :8] = 0
    src[1][:8, :8] = src[2][:8, :8] = 255
    chk = np.where((yy[:16, :16] // 4 + xx[:16, :16] // 4) % 2, 255, 0)
    ref[0][:16, 16:32], src[0][:16, 16:32] = 255 - chk, chk
    src[0][:16, 32:48] = ref[0][:16, 32:48]
    for c in (1, 2):
        src[c][:8, 16:24] = ref[c][:8, 16:24]
    pads = (mc.pad_plane(T(ref[0])), mc.pad_plane(T(ref[1]), mc.PAD // 2),
            mc.pad_plane(T(ref[2]), mc.PAD // 2))
    return ([T(s) for s in src], mc.hpel_planes_plain(pads[0]), pads[1:],
            T(ptype), T(mv))


def _jax_stage2(fenc, pred, fuv, puv, q, q2):
    """x264_tpu's inter residual of K MBs with decimation: the luma 4x4
    and 8x8 codings, the chroma AC scan of both channels (stacked, u then
    v), the joint AC kill and the chroma residual."""
    r4 = jinter.inter_luma_residual(fenc, pred, q, decimate=True)
    r8 = jinter.inter_luma_residual8(fenc, pred, q, decimate=True)
    sc = jintra.chroma_ac_scan(fuv, puv, q2, "pc")
    s = jquant.decimate_score(sc[..., 1:], jquant.DECIMATE_TAB4).sum(-1)
    n = fenc.shape[0]
    kill = (s[:n] + s[n:]) < 7
    ch = jintra.chroma_residual(fuv, puv, q2, "pc",
                                ac_kill=jnp.concatenate([kill, kill]))
    return r4, r8, sc, kill, ch[:3]


_jax_stage2_jit = jax.jit(_jax_stage2)


def _jax_qtabs(form, qp_map):
    """x264_tpu's qtab of the luma MBs and of the stacked chroma MBs: the
    frame QP's tables and trellis consts (state QP the slice QP), or the
    per-MB rows and the 52-QP stacks with each MB's rows."""
    qpc = tables.chroma_qp(QP)
    q = jinter.make_qtab_p(QP, qpc)
    mk = lambda key: next((c, l) for k, c, l in inter.TRELLIS_QTAB
                          if k == key)
    if form == "frame":
        for key, cat, lst in inter.TRELLIS_QTAB:
            q[key] = jtr.make_consts(QP if cat in (2, 5) else qpc, cat, lst,
                                     False, 0, state_qp=QP)
        return q, q
    full = jaq.full_tables(jtables.DEFAULT_QUANT)
    qpc_map = np.asarray(jtables.CHROMA_QP_TABLE)[qp_map]
    stacks = {key: jtr.make_consts_all_qp(*mk(key), False, 0)
              for key, _, _ in inter.TRELLIS_QTAB}

    def rows(qm, qc):
        return {**q, **jaq.qtab_rows(full, jnp.asarray(qm), jnp.asarray(qc),
                                     intra_cqm=False, inter_tabs=True),
                **stacks, "trellis_qp": jnp.asarray(qm),
                "trellis_qpc": jnp.asarray(qc)}
    return (rows(qp_map, qpc_map),
            rows(np.tile(qp_map, 2), np.tile(qpc_map, 2)))


@pytest.fixture(scope="module", params=["frame", "mb"])
def stage2(request):
    """The frame, the port's qtab (for p_inter_mb_plain), the tiles, the
    port's per-MB qtabs of the residual functions and x264_tpu's results,
    at the frame QP or with a per-MB QP map over QP 1-51."""
    form = request.param
    (y, u, v), planes, cpads, ptype, mv = _frame()
    qt = tables.DEFAULT_QUANT
    base = inter.make_qtab_p(QP, tables.chroma_qp(QP), "cpu", qt)
    qp_map = None
    if form == "frame":
        base.update(inter.trellis_consts(QP, tables.chroma_qp(QP), 0, "cpu",
                                         qt))
        tq = tq2 = base
    else:
        qp_map = np.random.default_rng(8).integers(1, 52, K).astype(np.int32)
        base.update(aq_stack_p=aq.qtab_stacks(aq.full_tables(qt, "cpu"),
                                              0)["inter"],
                    **inter.trellis_stacks(0, 0, "cpu", qt))

        def rows(qm):
            r = inter.mb_rows(base, T(qm), True)
            return {**r, "trellis_qp": T(qm).long(),
                    "trellis_qpc": base["trellis_qpc_of"][T(qm).long()]}
        tq, tq2 = rows(qp_map), rows(np.tile(qp_map, 2))
    preds = inter.partition_preds(planes, *cpads, ptype, mv)
    pred, pu, pv = (p.reshape(K, *p.shape[2:]) for p in preds)
    fenc = inter._tiles(y, 16)
    fuv = torch.cat([inter._tiles(u, 8), inter._tiles(v, 8)])
    puv = torch.cat([pu, pv])
    jq, jq2 = _jax_qtabs(form, qp_map)
    want = jax.tree_util.tree_map(np.asarray, _jax_stage2_jit(
        fenc.numpy(), pred.numpy(), fuv.numpy(), puv.numpy(), jq, jq2))
    return dict(form=form, frame=(y, u, v, planes, *cpads, ptype, mv),
                base=base, qp_map=None if qp_map is None else T(
                    qp_map.reshape(MB_H, MB_W)),
                tiles=(fenc, pred, fuv, puv), tq=tq, tq2=tq2, want=want)


def test_trellis_residuals_match_jax(stage2):
    fenc, pred, fuv, puv = stage2["tiles"]
    tq, tq2 = stage2["tq"], stage2["tq2"]
    r4, r8, sc, kill, ch = stage2["want"]
    for got, want in ((inter.inter_luma_residual(fenc, pred, tq, True), r4),
                      (inter.inter_luma_residual8(fenc, pred, tq, True), r8),
                      (intra.chroma_residual(
                          fuv, puv, tq2, "pc",
                          torch.from_numpy(np.tile(kill, 2))), ch)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        intra.chroma_ac_scan(fuv, puv, tq2, "pc").numpy(), sc)
    assert kill.any() and not kill.all()
    assert (np.abs(r4[1]) >= 15).any() and (r4[2] == 0).any()


@pytest.mark.parametrize("t8", [inter.T8_OFF, inter.T8_SA8D, inter.T8_RD])
def test_p_inter_mb_plain_with_trellis(stage2, t8):
    """K6's plain version with the trellis consts in its qtab equals
    x264_tpu's inter residual assembled as encode_p_body's stage 2
    assembles it."""
    fenc, pred = stage2["tiles"][:2]
    (recon4, bz, cbp4), (recon8, b8, cbp8), _, _, (crec, cdc, cac) = \
        stage2["want"]
    got = inter.p_inter_mb_plain(MB_H, MB_W, *stage2["frame"][:8],
                                 stage2["base"], True, t8,
                                 stage2["qp_map"])
    grid = lambda a: a.reshape(MB_H, MB_W, *a.shape[1:])
    plane = lambda a: inter._untiles(torch.from_numpy(np.array(a)), MB_H,
                                     MB_W).numpy()
    ry, bz, cbp = recon4, bz, cbp4
    if t8 == inter.T8_SA8D:
        sel = (opix.sa8d_16x16(fenc, pred) < opix.satd(fenc, pred)).numpy()
        assert sel.any() and not sel.all()
        ry = np.where(sel[:, None, None], recon8, ry)
        bz = np.where(sel[:, None, None], 0, bz)
        cbp = np.where(sel, cbp8, cbp)
        np.testing.assert_array_equal(got["t8_sel"].numpy(), grid(sel))
    if t8 == inter.T8_RD:
        np.testing.assert_array_equal(got["recon8_y"].numpy(), plane(recon8))
        np.testing.assert_array_equal(got["cbp8"].numpy(), grid(cbp8))
    if t8 != inter.T8_OFF:
        np.testing.assert_array_equal(got["blocks8_z"].numpy(), grid(b8))
    want = dict(recon_y=plane(ry), recon_u=plane(crec[:K]),
                recon_v=plane(crec[K:]), blocks_z=grid(bz), cbp=grid(cbp),
                chroma_dc=grid(np.stack([cdc[:K], cdc[K:]], 1)),
                chroma_ac=grid(np.stack([cac[:K], cac[K:]], 1)))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, k)

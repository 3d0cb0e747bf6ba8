"""The RD ladder of the subme-6 slice against x264_tpu, function level:
the host half of ops/trellis.py (make_consts for every category at
several QP / cabac_init_idc pairs), ops/rdcost.py (residual_bits_f8 on
every category, with all-zero blocks, a last level at C-1 and levels of
15 and beyond; ssd_tiles; lambda2_f8), pixel.ac_energy, the RD tables of
the P qtab, and encode_p_body at subme 6 with psy-RD on and off at 4x5
MBs, on inputs where the RD decision sends MBs to intra that the SATD
decision keeps inter and the other way round. Exact throughout. The JAX
programs run eagerly except encode_p_body, which compiles once: psy off
is psy_rd 0 on its side, which adds 0 to every SSD, and no psy_rd key on
the port's, which adds nothing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import inter as jinter
from x264_tpu.ops import pixel as jpix
from x264_tpu.ops import rdcost as jrd
from x264_tpu.ops import trellis as jtr
from x264_tpu_torch import convert
from x264_tpu_torch import tables as ttables
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.ops import pixel as tpix
from x264_tpu_torch.ops import rdcost as trd
from x264_tpu_torch.ops import trellis as ttr
from test_torch_encoder_subpel import MB_H, MB_W, QP, T, _p_inputs

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("qp,idc", [(26, 0), (30, 2), (12, 1), (45, 0)])
def test_make_consts_matches_jax(qp, idc):
    for cat in range(6):
        lst = tables.CQM_8PY if cat == 5 else tables.CQM_4PY
        want = jtr._consts_np(qp, cat, lst, False, idc, False,
                              tables.DEFAULT_QUANT)
        got = ttr.make_consts(qp, cat, lst, False, idc)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          np.asarray(got[k]),
                                          err_msg=f"cat {cat} {k}")
    np.testing.assert_array_equal(jtr.entropy_f8(), ttr.entropy_f8())
    np.testing.assert_array_equal(jtr.size_unary(), ttr.size_unary())


def _levels(rng, C: int):
    """Random sparse levels with all-zero blocks, blocks whose last level
    sits at C-1, and blocks of levels 15 and far beyond."""
    lv = rng.integers(-3, 4, (120, C)) * (rng.random((120, C)) < 0.3)
    lv[:15] = 0
    lv[15:30, -1] = rng.choice([-2, -1, 1, 2], 15)
    lv[30:45] = rng.integers(-40, 41, (15, C))
    lv[45:50] = rng.integers(-70000, 70001, (5, C))
    lv[50:55, 0] = 15
    return lv.astype(np.int32)


@pytest.mark.parametrize("cat", range(6))
def test_residual_bits_matches_jax(cat):
    rng = np.random.default_rng(cat)
    C = int(ttr.CAT_C[cat])
    lv = _levels(rng, C)
    lst = tables.CQM_8PY if cat == 5 else tables.CQM_4PY
    want = np.asarray(jrd.residual_bits_f8(
        jnp.asarray(lv), jtr.make_consts(QP, cat, lst, False, 0)))
    got = trd.residual_bits_f8(torch.from_numpy(lv),
                               trd.make_rdbits(QP, 0, "cpu")[f"cat{cat}"])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    assert (want[:15] == 0).all() and (want[15:55] > 0).all()


def test_ssd_ac_energy_lambda2_match_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (2, 3, 16, 16)).astype(np.int32)
    b = rng.integers(0, 256, (2, 3, 16, 16)).astype(np.int32)
    a[0, 0], b[0, 0] = 255, 0                 # the largest 16x16 SSD
    np.testing.assert_array_equal(
        np.asarray(jrd.ssd_tiles(jnp.asarray(a), jnp.asarray(b))),
        trd.ssd_tiles(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpix.ac_energy(jnp.asarray(a))),
        tpix.ac_energy(torch.from_numpy(a)).numpy())
    for qp in (0, 12, 26, 51):
        assert trd.lambda2_f8(qp) == jrd.lambda2_f8(qp)


def _jax_rd_qtab(psy: bool) -> dict:
    """x264_tpu's P qtab with the RD ladder's tables, as its
    Encoder._qtab_p builds them (core.py:817-836); psy off leaves out
    psy_rd as Encoder._qtab_p does."""
    jq = dict(jinter.make_qtab_p(QP, tables.chroma_qp(QP)))
    jq["rdbits"] = {f"cat{c}": jtr.make_consts(
        QP, c, tables.CQM_4PY if c != 5 else tables.CQM_8PY, False, 0)
        for c in range(6)}
    jq["rd_lam2"] = jnp.float32(jrd.lambda2_f8(QP))
    if psy:
        jq["psy_rd"] = jnp.float32(1.0 * float(tables.LAMBDA_TABLE[QP]))
    return jq


def _numpy(q):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in q.items()}


@pytest.mark.parametrize("psy", [True, False])
def test_rd_qtab_matches_jax(psy):
    jq = _numpy(_jax_rd_qtab(psy))
    tq = tinter.make_qtab_p(QP, ttables.chroma_qp(QP, 0), "cpu", rd_idc=0,
                            f_psy_rd=1.0 if psy else 0.0)
    cq = convert.qtab_p_from_numpy(jq, "cpu")
    assert ("psy_rd" in tq) == psy == ("psy_rd" in cq)
    for q in (tq, cq):
        assert q["rd_lam2"] == float(jq["rd_lam2"])
        if psy:
            assert q["psy_rd"] == float(jq["psy_rd"])
        for c in range(6):
            for n in ("sig", "last", "l1", "unary"):
                np.testing.assert_array_equal(
                    jq["rdbits"][f"cat{c}"][n],
                    q["rdbits"][f"cat{c}"][n].numpy())
        assert torch.equal(q["rdtab"], trd.pack_rdbits(q["rdbits"]))


@pytest.fixture(scope="module")
def jax_rd_body():
    """x264_tpu's encode_p_body at subme 6 (quarter-pel steps, partitions
    with P8x8, chroma ME, the RD ladder), compiled once."""
    return jax.jit(functools.partial(
        jinter.encode_p_body, MB_H, MB_W, 16, subpel_steps=(2, 1),
        parts=True, n_refs=1, t8=False, rd=True, decimate=True, p8x8=True,
        chroma_me=True))


@pytest.mark.parametrize("psy", [True, False])
def test_encode_p_body_subme6_matches_jax(psy, jax_rd_body):
    """subme 6 on inputs where RD flips MBs both ways against the SATD
    decision, with psy-RD 1.0 and with psy off."""
    y, u, v, ry, ru, rv, mvp = _p_inputs(2)
    lam = int(tables.LAMBDA_TABLE[QP])
    jq = _jax_rd_qtab(True)
    tq = convert.qtab_p_from_numpy(_numpy(jq), "cpu")
    if not psy:
        jq["psy_rd"] = jnp.float32(0.0)
        del tq["psy_rd"]
    jo = {k: np.asarray(a) for k, a in
          jax_rd_body(y, u, v, ry, ru, rv, jq, lam, mvp).items()}
    args = (MB_H, MB_W, 16, T(y), T(u), T(v), T(ry), T(ru), T(rv), tq, lam,
            T(mvp), True, (2, 1), True, True, True)
    to = tinter.encode_p_body(*args, True)
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k].numpy(), err_msg=k)
    # RD decides otherwise than SATD + lambda * bits, in both directions
    satd_intra = tinter.encode_p_body(*args, False)["intra_mb"].numpy()
    rd_intra = to["intra_mb"].numpy()
    assert (rd_intra & ~satd_intra).any() and (satd_intra & ~rd_intra).any()

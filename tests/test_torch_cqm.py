"""Custom quant matrices in the port against x264_tpu: the QuantTables of
the JVT preset and of a custom list (entries from 1 to 255, read from a
JM-format file through EncoderParams.psz_cqm_file) equal to x264_tpu's;
the make_qtab / make_qtab_p tables (with the RD bit tables), the 52-QP
stacks and the trellis consts under those lists equal to x264_tpu's; and
the int32 products that a list with small entries pushes past 2^31 (the
deadzone quant's (bias + |c|) * mf, the trellis's |c| * qmf) wrapping
as x264_tpu's XLA programs wrap them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu import tables as jtables
from x264_tpu.encoder import aq as jaq
from x264_tpu.encoder import inter as jinter
from x264_tpu.encoder import intra as jintra
from x264_tpu.ops import quant as jquant
from x264_tpu.ops import trellis as jtr
from x264_tpu_torch import tables
from x264_tpu_torch.encoder import aq, inter, intra
from x264_tpu_torch.ops import quant as tquant
from x264_tpu_torch.ops import trellis as ttr

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
SECTIONS = (("INTRA4X4_LUMA", 16), ("INTRA4X4_CHROMA", 16),
            ("INTER4X4_LUMA", 16), ("INTER4X4_CHROMA", 16),
            ("INTRA8X8_LUMA", 64), ("INTER8X8_LUMA", 64))


def _cqm_file(path):
    """A JM-format file whose lists run from 1 to 255: the low-frequency
    corner at 1 (mf ~2.1e5), the rest spread over the range."""
    rng = np.random.default_rng(9)
    lines = ["# custom lists for the tests"]
    for name, n in SECTIONS:
        vals = rng.integers(1, 256, n)
        vals[:3] = (1, 1, 255)
        lines.append(f"{name} =")
        lines.append(", ".join(str(v) for v in vals))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _tables(preset, path=None):
    """(x264_tpu's, the port's) Encoder quant tables for the preset."""
    out = []
    for pkg in (x264_tpu, x264_tpu_torch):
        p = pkg.EncoderParams(i_width=64, i_height=48, i_log_level=0,
                              i_cqm_preset=preset)
        if path is not None:
            p.psz_cqm_file = path
        enc = pkg.Encoder(p) if pkg is x264_tpu \
            else pkg.Encoder(p, device="cpu")
        out.append(enc.qt)
    return out


@pytest.fixture(scope="module", params=["jvt", "custom"])
def qts(request, tmp_path_factory):
    if request.param == "jvt":
        return _tables(1)
    return _tables(2, _cqm_file(tmp_path_factory.mktemp("cqm") / "m.cfg"))


KEYS = ("scaling_list4", "scaling_list8", "quant4_mf", "quant4_bias",
        "dequant4_mf", "unquant4_mf", "quant8_mf", "quant8_bias",
        "dequant8_mf", "unquant8_mf")


def test_quant_tables_match_jax(qts):
    jqt, tqt = qts
    for k in KEYS:
        np.testing.assert_array_equal(getattr(tqt, k), getattr(jqt, k),
                                      err_msg=k)
    assert (tqt.scaling_list4 != 16).any()


@pytest.mark.parametrize("qp", [0, 5, 26, 51])
def test_qtabs_match_jax(qts, qp):
    jqt, tqt = qts
    qp_c = jtables.chroma_qp(qp)
    jq = jinter.make_qtab_p(qp, qp_c, jqt)
    tq = inter.make_qtab_p(qp, qp_c, "cpu", tqt, rd_idc=0)
    for k, v in jq.items():
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(v),
                                      err_msg=k)
    ji = jintra.make_qtab(qp, qp_c, jqt)
    ti = intra.make_qtab(qp, qp_c, "cpu", tqt)
    assert ji.keys() == ti.keys()
    for k, v in ji.items():
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the RD ladder's bit tables (x264_tpu's _qtab_p: make_consts at qp_y)
    for c in range(6):
        lst = jtables.CQM_8PY if c == 5 else jtables.CQM_4PY
        jk = jtr.make_consts(qp, c, lst, False, 0, qt=jqt)
        for n in ("sig", "last", "l1", "unary"):
            np.testing.assert_array_equal(tq["rdbits"][f"cat{c}"][n].numpy(),
                                          np.asarray(jk[n]).astype(np.int32))


def test_aq_stacks_match_jax(qts):
    jqt, tqt = qts
    jf = jaq.full_tables(jqt)
    tf = aq.full_tables(tqt, "cpu")
    for k in ("q4_mf", "q4_bias", "dq4_mf", "q8_mf", "q8_bias", "dq8_mf",
              "cqp"):
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]),
                                      err_msg=k)


@pytest.mark.parametrize("cat,lst", [(2, 1), (3, 3), (4, 3), (5, 1)])
def test_trellis_consts_match_jax(qts, cat, lst):
    jqt, tqt = qts
    for qp in (0, 30, 51):
        jk = jtr.make_consts(qp, cat, lst, False, 1, qt=jqt, state_qp=26)
        tk = ttr.make_consts(qp, cat, lst, False, 1, qt=tqt, state_qp=26)
        for k in jk:
            np.testing.assert_array_equal(np.asarray(tk[k]),
                                          np.asarray(jk[k]), err_msg=k)
    js = jtr.make_consts_all_qp(cat, lst, False, 1, qt=jqt)
    ts = ttr.make_consts_all_qp(cat, lst, False, 1, qt=tqt)
    for k in js:
        np.testing.assert_array_equal(np.asarray(ts[k]), np.asarray(js[k]),
                                      err_msg=k)


def test_quant_products_wrap_as_jax(tmp_path):
    """A list entry of 1 makes quant4_mf ~2.1e5 (4.2e5 below QP 6): every
    |c| past ~10,000 passes 2^31 in (bias + |c|) * mf, and the quant and
    the trellis must wrap it in int32 exactly as XLA does."""
    jqt, tqt = _tables(2, _cqm_file(tmp_path / "m.cfg"))
    for qp in (3, 8):
        mf = tqt.quant4_mf[jtables.CQM_4IY, qp].astype(np.int64)
        bias = tqt.quant4_bias[jtables.CQM_4IY, qp].astype(np.int64)
        rng = np.random.default_rng(qp)
        coef = rng.integers(-32768, 32768, (4096, 16)).astype(np.int32)
        assert ((bias + np.abs(coef)) * mf > 2 ** 31).any()
        want = np.asarray(jax.jit(jquant.quant)(coef, mf.astype(np.int32),
                                                bias.astype(np.int32)))
        got = tquant.quant(T(coef), T(mf), T(bias)).numpy()
        np.testing.assert_array_equal(got, want)
        lv = rng.integers(-4000, 4000, (4096, 16)).astype(np.int32)
        dmf = jqt.dequant4_mf[jtables.CQM_4IY, qp % 6].astype(np.int32)
        want = np.asarray(jax.jit(jquant.dequant, static_argnums=(3,))(
            lv, dmf, qp // 6, 4))
        got = tquant.dequant(T(lv), T(dmf), qp // 6, 4).numpy()
        np.testing.assert_array_equal(got, want)
        # the trellis's |c| * qmf (cat 2, luma 4x4 in zig-zag)
        jk = jtr.make_consts(qp, 2, jtables.CQM_4IY, False, 0, qt=jqt,
                             state_qp=26)
        tk = ttr.make_consts(qp, 2, tables.CQM_4IY, False, 0, qt=tqt,
                             state_qp=26)
        assert (np.abs(coef).astype(np.int64)
                * np.asarray(jk["qmf"]).astype(np.int64) > 2 ** 31).any()
        want = np.asarray(jax.jit(jtr.trellis_scan)(jnp.asarray(coef[:512]),
                                                    jk))
        got = ttr.trellis_scan_plain(T(coef[:512]), tk).numpy()
        np.testing.assert_array_equal(got, want)

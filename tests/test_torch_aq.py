"""The port's variance AQ against x264_tpu's encoder/aq.py: the plain K16
(qp_map_from_planes, against x264_tpu's function jitted as its pipelines
run it, on planes of flat areas, ramps and noise of amplitude 0-255 at
several strengths, QPs and chroma offsets), the float32 log it replays
(bit-exact against jnp.log2, also at the energies where the QP changes),
the plain K17 (dqp_syntax), qtab_rows and the 52-QP stacks K1 / K6 / K7
read, and the mb_qp_delta bins of the I and P op streams (the compacted
ops against x264_tpu's). Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables as jtables
from x264_tpu.encoder import aq as jaq
from x264_tpu.encoder import pipeline as jpipe
from x264_tpu.entropy import cabac_planes as jcp
from x264_tpu_torch import convert, tables
from x264_tpu_torch.encoder import aq
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.entropy import cabac_planes as tcp

from test_torch_inter import MB_H, MB_W, _p_inputs
from test_torch_intra import planes

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

AQ_H, AQ_W = 30, 40
_jit_qp_map = jax.jit(jaq.qp_map_from_planes, static_argnums=(5, 6))


def _aq_planes(seed: int):
    """MB-aligned int32 planes whose MBs are flat, ramps or noise of
    amplitude 0-255 around a random level."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, (AQ_H, AQ_W))
    amp = rng.integers(0, 256, (AQ_H, AQ_W))
    base = rng.integers(0, 256, (AQ_H, AQ_W))
    out = []
    for n in (16, 8, 8):
        up = lambda a: np.kron(a, np.ones((n, n), np.int64))
        yy, xx = np.mgrid[0:AQ_H * n, 0:AQ_W * n]
        ramp = (xx % n + yy % n) * up(amp) // (2 * n)
        noise = rng.integers(-128, 128, yy.shape) * up(amp) // 256
        p = up(base) + np.where(up(kind) == 1, ramp,
                                np.where(up(kind) == 2, noise, 0))
        out.append(np.clip(p, 0, 255).astype(np.int32))
    return out


@pytest.mark.parametrize("strength", [0.5, 1.0, 1.7])
def test_qp_map_matches_jax(strength):
    y, u, v = _aq_planes(int(strength * 10))
    tiles = [jnp.asarray(a.reshape(AQ_H, n, AQ_W, n).swapaxes(1, 2))
             for a, n in ((y, 16), (u, 8), (v, 8))]
    spread = 0
    for qp in (18, 26, 40):
        for off in (-2, 0, 3):
            jm, jmc = _jit_qp_map(*tiles, jnp.int32(qp),
                                  jnp.float32(strength), 10, 51,
                                  jnp.int32(off))
            tm, tmc = aq.qp_map_from_planes(
                *(torch.from_numpy(a) for a in (y, u, v)), AQ_H, AQ_W, qp,
                strength, 10, 51, off)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(tmc.numpy(), np.asarray(jmc))
            spread = max(spread, int(tm.max() - tm.min()))
    assert spread >= 8


def _qp_edges():
    """The float32 energies around each QP step of x264_tpu's map at QP 26
    and strength 1.0 (qp + 1.0397 * (log2 E - 14.427) = k + 0.5), with 64
    ulps either side."""
    out = []
    for k in range(11, 35):
        e0 = np.float32(2.0 ** ((k + 0.5 - 26) / 1.0397 + 14.427))
        if not 1 <= e0 <= 6.3e6:
            continue
        bits = e0.view(np.int32) + np.arange(-64, 65, dtype=np.int32)
        out.append(bits.view(np.float32))
    return np.concatenate(out)


def test_log2_matches_jnp():
    rng = np.random.default_rng(5)
    edges = _qp_edges()
    x = np.concatenate([rng.uniform(1.0, 6.3e6, 2_000_000)
                        .astype(np.float32), edges])
    got = aq.xla_log2_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log2)(x))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the QP at the step edges, as x264_tpu's jitted map computes it
    # (log2, the offset, the strength and the QP contracted into FMAs)
    qp_of = jax.jit(lambda e, qp, s: jnp.clip(jnp.round(
        qp + s * 1.0397 * (jnp.log2(jnp.maximum(e, 1.0)) - 14.427)), 10, 51))
    want_qp = np.asarray(qp_of(edges, jnp.int32(26), jnp.float32(1.0)))
    a = aq.fma_f32(aq.xla_log_f32_plain(torch.from_numpy(edges)),
                   aq.INV_LN2, aq.AQ_OFFSET)
    got_qp = torch.round(aq.fma_f32(aq.aq_scale(1.0), a, 26.0)).clamp(10, 51)
    np.testing.assert_array_equal(got_qp.numpy(), want_qp)
    assert len(np.unique(want_qp)) >= 20


def test_dqp_syntax_matches_jax():
    rng = np.random.default_rng(9)
    qp_map = rng.integers(10, 52, (9, 13)).astype(np.int32)
    has = rng.random((9, 13)) < 0.6
    has[2], has[5] = False, True            # an all-false and an all-true row
    has[0, 0] = False                       # slice QP carried into row 0
    for slice_qp in (23, 40):
        want = jaq.dqp_syntax(jnp.asarray(qp_map), jnp.asarray(has),
                              slice_qp)
        got = aq.dqp_syntax(torch.from_numpy(qp_map), torch.from_numpy(has),
                            slice_qp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("inter_tabs", [False, True])
def test_qtab_rows_and_stacks_match_jax(inter_tabs):
    qt = tables.QuantTables(luma_deadzone_inter=21, luma_deadzone_intra=11)
    jqt = jtables.QuantTables(luma_deadzone_inter=21, luma_deadzone_intra=11)
    rng = np.random.default_rng(2)
    qp_map = rng.integers(0, 52, (5, 7)).astype(np.int32)
    off = -2
    qpc_map = np.asarray(jtables.CHROMA_QP_TABLE)[np.clip(qp_map + off, 0,
                                                          51)]
    want = jaq.qtab_rows(jaq.full_tables(jqt), jnp.asarray(qp_map),
                         jnp.asarray(qpc_map), intra_cqm=not inter_tabs,
                         inter_tabs=inter_tabs)
    got = aq.qtab_rows(aq.full_tables(qt, "cpu"), torch.from_numpy(qp_map),
                       torch.from_numpy(qpc_map), intra_cqm=not inter_tabs,
                       inter_tabs=inter_tabs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # each stack row is x264_tpu's qtab_rows at that QP, packed, and the
    # per-QP table of make_qtab / make_qtab_p at that QP and its chroma
    # QP, packed; the stacks made from x264_tpu's own full tables agree
    kind = "inter" if inter_tabs else "intra"
    stack = aq.qtab_stacks(aq.full_tables(qt, "cpu"), off)[kind]
    assert torch.equal(stack, convert.aq_stacks_from_numpy(
        {k: np.array(t) for k, t in jaq.full_tables(jqt).items()}, off,
        "cpu")[kind])
    qs = np.arange(52, dtype=np.int32)
    rows = jaq.qtab_rows(jaq.full_tables(jqt), jnp.asarray(qs),
                         jnp.asarray(np.asarray(jtables.CHROMA_QP_TABLE)[
                             np.clip(qs + off, 0, 51)]),
                         intra_cqm=not inter_tabs, inter_tabs=inter_tabs)
    pack = tinter.pack_qtab_p if inter_tabs else tintra.pack_qtab
    make = tinter.make_qtab_p if inter_tabs else tintra.make_qtab
    for q in range(52):
        row = pack({k: torch.tensor(np.asarray(t[q])) for k, t in
                    rows.items()})
        assert torch.equal(stack[q], row), q
        assert torch.equal(stack[q], pack(make(
            q, tables.chroma_qp(q, off), "cpu", qt))), q


def _aq_qtab(qp, inter_tabs):
    qt = tables.DEFAULT_QUANT
    st = aq.qtab_stacks(aq.full_tables(qt, "cpu"), 0)
    if inter_tabs:
        tab = tinter.make_qtab_p(qp, tables.chroma_qp(qp), "cpu", qt)
        return {**tab, "aq_stack": st["intra"], "aq_stack_p": st["inter"]}
    tab = tintra.make_qtab(qp, tables.chroma_qp(qp), "cpu", qt)
    return {**tab, "aq_stack": st["intra"]}


def test_i_op_stream_with_dqp_matches_jax():
    mb_h, mb_w, qp = 3, 7, 26
    y, u, v = (torch.from_numpy(a) for a in planes(mb_h, mb_w, qp))
    qp_map = torch.from_numpy(np.random.default_rng(4).integers(
        18, 36, (mb_h, mb_w)).astype(np.int32))
    out = tintra.encode_i16_frame(mb_h, mb_w, y, u, v, _aq_qtab(qp, False),
                                  int(tables.LAMBDA_TABLE[qp]),
                                  qp_map=qp_map)
    cnz = (out["chroma_ac"][..., 1:] != 0).flatten(2).any(-1) \
        | (out["chroma_dc"] != 0).flatten(2).any(-1)
    has = ~out["i4_mb"] | (out["cbp_luma_bits"] > 0) | cnz
    out["dqp"], _, out["dqp_prev_nz"] = aq.dqp_syntax(qp_map, has, qp)
    assert (out["dqp"] != 0).sum() >= 5
    # jitted, as x264_tpu's pipelines run it (and one compile, not many)
    jops, jn = jax.jit(lambda o: jcp.compact_ops(
        jcp.i16_slice_ops(o, mb_h, mb_w, t8_mode=False),
        jpipe.cabac_capacity(mb_h * mb_w)))(
        {k: t.numpy() for k, t in out.items()})
    tops, tn = tcp.i_slice_ops(out, mb_h, mb_w)
    n = int(jn)
    assert int(tn) == n
    np.testing.assert_array_equal(np.asarray(jops)[:n],
                                  tops.numpy().view(np.uint32)[:n])


def test_p_op_stream_with_dqp_matches_jax():
    y, u, v, ry, ru, rv, mvp = (torch.from_numpy(a)
                                for a in _p_inputs("intra"))
    qp = 26
    qp_map = torch.from_numpy(np.random.default_rng(6).integers(
        16, 40, (MB_H, MB_W)).astype(np.int32))
    args = (MB_H, MB_W, 16, y, u, v, ry, ru, rv, _aq_qtab(qp, True),
            int(tables.LAMBDA_TABLE[qp]), mvp, True)
    out = tinter.encode_p_body(*args, qp_map=qp_map)
    front = tinter.encode_p_front(*args, qp_map=qp_map)
    maps, tops, tn = tcp.cabac_p_ops(front, MB_H, MB_W, aq=(qp_map, qp))
    has = ~out["skip"] & (out["intra_mb"] | (out["cbp_luma_bits"] > 0)
                          | (out["cbp_chroma"] > 0))
    jd = jaq.dqp_syntax(jnp.asarray(qp_map.numpy()), jnp.asarray(has.numpy()),
                        qp)
    for k, w in zip(("dqp", "qp_eff", "dqp_prev_nz"), jd):
        np.testing.assert_array_equal(maps[k].numpy(), np.asarray(w))
    assert (maps["dqp"] != 0).sum() >= 5
    jout = {k: t.numpy() for k, t in out.items()}
    jout.update(dqp=np.asarray(jd[0]), dqp_prev_nz=np.asarray(jd[2]))
    jops, jn = jax.jit(lambda o: jcp.compact_ops(
        jcp.p_slice_ops(o, MB_H, MB_W),
        jpipe.cabac_capacity(MB_H * MB_W)))(jout)
    n = int(jn)
    assert int(tn) == n
    np.testing.assert_array_equal(np.asarray(jops)[:n],
                                  tops.numpy().view(np.uint32)[:n])

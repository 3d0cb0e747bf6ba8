"""The port's host rate control against x264_tpu's: CRF, 1-pass ABR and
zones over a synthetic 40-frame sequence of (type, complexity), fed to
both RateControl objects' start / end directly (no lookahead, so nothing
compiles). Each frame's size is a deterministic function of its QP and
complexity, so ABR's feedback runs; end() lags start() by the pipe's
depth as in an Encoder with i_frame_parallel = depth + 1. Every frame's
QP must be equal, and VBV and 2-pass replay must still be refused."""

import math

import pytest

from x264_tpu.encoder import ratecontrol as jrc
from x264_tpu.params import EncoderParams as JParams
from x264_tpu_torch.encoder import ratecontrol as trc
from x264_tpu_torch.params import EncoderParams as TParams

N = 40


def _sequence():
    """(type, satd) of 40 frames: an I every 13 frames, the complexity
    swinging between calm and busy stretches."""
    out = []
    for i in range(N):
        t = "I" if i % 13 == 0 else "P"
        satd = 2000.0 + 1500.0 * math.sin(i / 3.0) ** 2 + 90.0 * (i % 7)
        out.append((t, satd * (3.0 if t == "I" else 1.0)))
    return out


def _bits(qp: int, satd: float, ftype: str) -> int:
    return int(satd * (40.0 if ftype == "I" else 25.0)
               / trc.qp2qscale(qp)) + 200


def _params(cls, mode):
    p = cls(i_width=320, i_height=240, i_log_level=0)
    if mode == "abr":
        p.rc.i_rc_method = 2
        p.rc.i_bitrate = 300
    elif mode == "crf18":
        p.rc.f_rf_constant = 18.0
    return p.validate()


def _drive(rc, depth: int, zones=()):
    rc.zones = list(zones)
    qps, pending = [], []
    for i, (t, satd) in enumerate(_sequence()):
        qp = rc.start(t, satd=satd, frame_idx=i)
        qps.append(qp)
        pending.append((t, qp, satd, rc.last_rceq, rc.last_satd))
        if len(pending) > depth:
            ft, fq, fs, rceq, ls = pending.pop(0)
            rc.end(ft, _bits(fq, fs, ft), fq, rceq=rceq, satd=ls)
    for ft, fq, fs, rceq, ls in pending:
        rc.end(ft, _bits(fq, fs, ft), fq, rceq=rceq, satd=ls)
    return qps


@pytest.mark.parametrize("mode,depth,zones", [
    ("crf", 0, ()), ("crf", 2, ()), ("crf18", 2, ()),
    ("abr", 0, ()), ("abr", 2, ()),
    ("crf", 2, ((5, 9, "q", 30), (20, 27, "b", 1.8))),
    ("abr", 2, ((5, 9, "b", 0.5), (12, 15, "q", 22), (14, 30, "b", 2.0)))],
    ids=["crf", "crf-pipe", "crf18-pipe", "abr", "abr-pipe", "crf-zones",
         "abr-zones"])
def test_rate_control_matches_jax(mode, depth, zones):
    jq = _drive(jrc.RateControl(_params(JParams, mode)), depth, zones)
    tq = _drive(trc.RateControl(_params(TParams, mode)), depth, zones)
    assert tq == jq
    assert len(set(tq)) > 2, tq


@pytest.mark.parametrize("what", ["vbv", "2pass"])
def test_vbv_and_2pass_name_their_slice(what, tmp_path):
    p = TParams(i_width=320, i_height=240, i_log_level=0)
    if what == "vbv":
        p.rc.i_vbv_max_bitrate, p.rc.i_vbv_buffer_size = 800, 800
        match = "VBV slice"
    else:
        stats = tmp_path / "x.stats"
        stats.write_text("")
        p.rc.b_stat_read, p.rc.psz_stat_in = True, str(stats)
        match = "2-pass slice"
    with pytest.raises(NotImplementedError, match=match):
        trc.RateControl(p.validate())


def _b_sequence(bframes: int):
    """(type, satd) in encode order with B runs: an I, then each P followed
    by the Bs of the run it closes (the B frames' complexity the P's)."""
    out = []
    for i, (t, satd) in enumerate(_sequence()):
        out.append((t, satd))
        if t == "P" and i % (bframes + 1) == 0:
            out += [("B", satd * 0.8)] * bframes
    return out


@pytest.mark.parametrize("mode,depth,bframes", [
    ("cqp", 0, 2), ("crf", 0, 1), ("crf", 2, 3), ("abr", 2, 2)],
    ids=["cqp", "crf", "crf-pipe", "abr-pipe"])
def test_b_frames_match_jax(mode, depth, bframes):
    """The B branches: the CQP pb offset (round(6 log2 1.3) = 2), the B
    qscale from the last P's times pb_factor under CRF / ABR, and end()'s
    B accounting (the rceq divided by pb_factor, no accum_p update, the
    last non-B type kept), with end() lagging by the pipe's depth."""
    seq = _b_sequence(bframes)

    def drive(rc):
        qps, pending = [], []
        for i, (t, satd) in enumerate(seq):
            qp = rc.start(t, satd=satd, frame_idx=i)
            qps.append(qp)
            pending.append((t, qp, satd, rc.last_rceq, rc.last_satd))
            if len(pending) > depth:
                ft, fq, fs, rceq, ls = pending.pop(0)
                rc.end(ft, _bits(fq, fs, ft), fq, rceq=rceq, satd=ls)
        for ft, fq, fs, rceq, ls in pending:
            rc.end(ft, _bits(fq, fs, ft), fq, rceq=rceq, satd=ls)
        return qps, rc.cplxr_sum, rc.accum_p_qp, rc.last_non_b_type

    def params(cls):
        p = _params(cls, "abr" if mode == "abr" else "crf")
        if mode == "cqp":
            p.rc.i_rc_method, p.rc.i_qp_constant = 0, 26
        return p

    j = drive(jrc.RateControl(params(JParams)))
    t = drive(trc.RateControl(params(TParams)))
    assert t == j
    qps = dict(zip(range(len(seq)), t[0]))
    b_qps = [qps[i] for i, (ft, _) in enumerate(seq) if ft == "B"]
    assert b_qps
    if mode == "cqp":
        assert set(b_qps) == {28}

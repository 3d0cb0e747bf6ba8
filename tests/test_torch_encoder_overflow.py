"""x264_tpu's synchronous CAVLC overflow path (core.py:1170-1194) against
the port's, Encoder level, at i_frame_parallel 1 on 80x48 all-intra
frames at CQP 26: the IDR's slice fits the device word buffer; it passes
it with I4x4 and fits after the retry without I4x4; it passes it even
then and is coded on the host (entropy/cavlc_vec.py). The buffer is
lowered in both packages (CAP_BITS_PER_MB through monkeypatch, between
the I4x4 and the I16x16-only slice's bits, then below both), and
x264_tpu's jitted IDR programs of the lowered sizes are dropped after
the module. Each branch: the
bytes and recons equal x264_tpu's and tests/refdec decodes the stream to
them. Lossless (CQP 0) on binary noise passes the buffer at its own
size: x264_tpu's host coder then codes the lossy QP-0 levels under the
transform-bypass
SPS, so its stream does not decode to its recons (a reference fault,
ROADMAP §3); the port codes the bypass levels its recons were made
from, its stream decodes to them, and with that one change undone its
bytes are x264_tpu's. The host coder (the port's copies of cavlc_vec and
of the scalar cavlc) equals x264_tpu's and the scalar coder bit for bit.
The pipelined path still raises."""

import numpy as np
import pytest
import torch

import x264_tpu
import x264_tpu_torch
from x264_tpu.encoder import pipeline as jpipe
from x264_tpu.encoder.core import Frame as JFrame
from x264_tpu.entropy import cavlc_vec as jvec
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.encoder import pipeline as tpipe
from x264_tpu_torch.entropy import cavlc as tcavlc
from x264_tpu_torch.entropy import cavlc_vec as tvec
from x264_tpu_torch.entropy import device as tdev
from x264_tpu_torch.entropy.bitstream import BitWriter
from refdec.decoder import decode_annexb

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

W, H = 80, 48
NMB = (W // 16) * (H // 16)


def _frames(noise):
    rng = np.random.default_rng(8)
    if noise:
        # samples of 0 or 255: lossless, some 5,700-6,000 bits an MB with
        # or without I4x4, past the buffer's 4,800
        return [tuple((rng.integers(0, 2, s) * 255).astype(np.uint8)
                      for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
                for _ in range(2)]
    yy, xx = np.mgrid[0:H, 0:W]
    return [tuple(np.clip(c, 0, 255).astype(np.uint8) for c in (
        (xx * 3 + yy * 2 + 5 * t) % 256 + rng.integers(0, 40, (H, W)),
        rng.integers(0, 256, (H // 2, W // 2)),
        (yy[::2, ::2] * 3) % 256)) for t in range(2)]


def _params(cls, qp, i4x4=True, frame_parallel=1):
    p = cls(i_width=W, i_height=H, i_log_level=0, b_cabac=False,
            i_keyint_max=1, i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0
    p.rc.i_qp_constant = qp
    if not i4x4:
        p.analyse.intra = 0
    return p


@pytest.fixture(scope="module", autouse=True)
def fresh_programs():
    """x264_tpu's jitted CAVLC IDR program sizes its word buffer when it is
    traced, and a program traced at a larger buffer than the host's check
    gives the same bytes (the words past the host's buffer are never
    read). So the buffers fall from test to test (the default, then the
    retry's, then the host coder's), and the programs of the lowered
    buffers are dropped when the module ends."""
    yield
    jpipe.encode_i16_idr.clear_cache()


def _set_cap(monkeypatch, cap_words):
    """CAP_BITS_PER_MB in both packages so that capacity_words(NMB) is
    cap_words."""
    base = tdev.HDR_SLOTS * 32 + 4096
    cap = -(-(32 * cap_words - base) // NMB)
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "CAP_BITS_PER_MB", cap)
    assert tpipe.capacity_words(NMB) == jpipe.capacity_words(NMB) \
        == cap_words


def _slice_bits(monkeypatch, frame, i4x4):
    """The nbits of the port's I pipeline on frame at the default buffer
    (the device's count, header and stop bit included)."""
    seen = []
    run = tpipe.encode_i16_idr

    def spy(*a, **k):
        out = run(*a, **k)
        seen.append(int(out["host32"][0]))
        return out

    monkeypatch.setattr(tpipe, "encode_i16_idr", spy)
    enc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, 26,
                                         i4x4), device="cpu")
    enc.encode(x264_tpu_torch.Frame(*frame))
    monkeypatch.setattr(tpipe, "encode_i16_idr", run)
    assert enc.last_idr_branch == "fits"
    return seen[0]


def _run(frames, qp):
    """Both encoders on frames: (headers, x264_tpu's frames, the port's
    frames, the port's branch of each IDR)."""
    jenc = x264_tpu.Encoder(_params(x264_tpu.EncoderParams, qp))
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, qp),
                                  device="cpu")
    head = tenc.headers()
    assert head == jenc.headers()
    jout, tout, branches = [], [], []
    for f in frames:
        jout.append(jenc.encode(JFrame(*f)))
        tout.append(tenc.encode(x264_tpu_torch.Frame(*f)))
        branches.append(tenc.last_idr_branch)
    return head, jout, tout, branches, tenc


def _decodes_to(head, frames_out):
    """Whether refdec decodes the stream to the frames' recons."""
    try:
        dec = decode_annexb(head + b"".join(e.payload for e in frames_out))
    except Exception:
        return False
    return len(dec) == len(frames_out) and all(
        np.array_equal(np.asarray(getattr(d, pl), np.int64),
                       np.asarray(getattr(e.recon, pl)).astype(np.int64))
        for d, e in zip(dec, frames_out) for pl in "yuv")


@pytest.mark.parametrize("branch", ["fits", "retry", "host"])
def test_overflow_branches_match_jax(branch, monkeypatch):
    frames = _frames(False)
    if branch != "fits":
        nb4 = _slice_bits(monkeypatch, frames[0], True)
        nb16 = _slice_bits(monkeypatch, frames[0], False)
        assert nb16 < nb4 - 32, (nb16, nb4)
        # the retry's buffer holds the I16x16-only slice, the host coder's
        # (smaller) neither
        _set_cap(monkeypatch, -(-nb16 // 32) if branch == "retry"
                 else nb16 // 32 - 4)
    head, jout, tout, branches, _ = _run(frames, 26)
    assert branches[0] == branch
    for j, t in zip(jout, tout):
        assert t.frame_type == j.frame_type == "IDR"
        assert t.payload == j.payload
        for pl in "yuv":
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          getattr(t.recon, pl).numpy())
    assert _decodes_to(head, tout)


def test_lossless_host_coder_codes_the_bypass():
    """Lossless noise passes the buffer with and without I4x4: x264_tpu's
    host coder codes transformed QP-0 levels under the bypass SPS (its
    stream does not decode to its recons, which are the source); the
    port's codes the bypass levels (its stream decodes to the source),
    and without that one change its bytes are x264_tpu's."""
    frames = _frames(True)
    head, jout, tout, branches, tenc = _run(frames, 0)
    assert branches == ["host", "host"] and tenc._host_bypass
    for j, t, f in zip(jout, tout, frames):
        for pl, src in zip("yuv", f):
            np.testing.assert_array_equal(getattr(t.recon, pl).numpy(), src)
            np.testing.assert_array_equal(np.asarray(getattr(j.recon, pl)),
                                          src)
        assert t.payload != j.payload
    assert _decodes_to(head, tout)
    assert not _decodes_to(head, jout)
    # the port with x264_tpu's host coder input: x264_tpu's bytes
    tenc2 = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, 0),
                                   device="cpu")
    tenc2._host_bypass = False
    for j, f in zip(jout, frames):
        assert tenc2.encode(x264_tpu_torch.Frame(*f)).payload == j.payload


def test_host_coder_matches_jax_and_the_scalar_coder():
    """The port's copy of the host coder: each residual block's codes
    against x264_tpu's cavlc_vec and against the port's scalar coder
    (cavlc.py) bit for bit, and a whole I16x16 slice's codes from K1's
    plain planes against x264_tpu's i16_slice_codes."""
    rng = np.random.default_rng(7)
    for c in (4, 15, 16):
        n = 400
        density = rng.random((n, 1))
        coeffs = np.where(rng.random((n, c)) < density,
                          rng.integers(-2200, 2200, (n, c)), 0)
        small = rng.random(n) < 0.5
        coeffs[small] = np.where(rng.random((small.sum(), c)) < 0.5,
                                 rng.integers(-3, 4, (small.sum(), c)), 0)
        nc = np.full(n, -1) if c == 4 else rng.integers(0, 17, n)
        v, l, tot = tvec.residual_codes(coeffs, nc)
        jv, jl, jtot = jvec.residual_codes(coeffs, nc)
        for a, b in ((v, jv), (l, jl), (tot, jtot)):
            np.testing.assert_array_equal(a, b)
        for i in range(n):
            ref, vec = BitWriter(), BitWriter()
            tcavlc.write_block_residual(ref, coeffs[i], int(nc[i]))
            vec.put_codes(v[i], l[i])
            assert ref.pack() == vec.pack() and ref.bit_pos == vec.bit_pos
    y, u, v = (torch.from_numpy(a.astype(np.int32)) for a in _frames(False)[0])
    planes = tintra.encode_i16_frame(H // 16, W // 16, y, u, v,
                                     tintra.make_qtab(12, 12, "cpu"), 10,
                                     i4x4=False)
    planes = {k: t.numpy() for k, t in planes.items()}
    tv_, tl_ = tvec.i16_slice_codes(planes, W // 16, H // 16)
    jv_, jl_ = jvec.i16_slice_codes(planes, W // 16, H // 16)
    np.testing.assert_array_equal(tv_, jv_)
    np.testing.assert_array_equal(tl_, jl_)


def test_pipelined_overflow_still_raises(monkeypatch):
    """At i_frame_parallel 3 x264_tpu queues the IDR and raises at
    finalize; so does the port."""
    _set_cap(monkeypatch, 64)
    tenc = x264_tpu_torch.Encoder(_params(x264_tpu_torch.EncoderParams, 26,
                                          frame_parallel=3), device="cpu")
    for f in _frames(False):
        tenc.encode(x264_tpu_torch.Frame(*f))
    with pytest.raises(RuntimeError, match="only an IDR at i_frame_parallel"):
        tenc.flush()

"""The CAVLC B slice against x264_tpu, function level: b_code_planes
(the B_SKIP runs, mb_type, the intra chroma mode, the mvds of each used
list, the inter cbp, mb_qp_delta and the residual) and the packed slice
(header slots, the MBs' codes and the stop bit through pack_codes: the
words and nbits that K25's plain version returns), on the port's plain
B body of tests/test_torch_bframe.py's inputs, where intra, direct,
B_SKIP, L0, L1 and BI MBs all occur, and on a synthetic 5 x 6-MB slice
with every mode, level escapes and a trailing skip run; the words also
at a capacity that drops codes. Exact throughout; the JAX functions run
eagerly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.entropy import device as jdev
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.entropy import device as tdev
from x264_tpu_torch.entropy.bitstream import BitWriter
from x264_tpu_torch.headers import SLICE_B, SliceHeader
from test_torch_bframe import MB_H, MB_W, QP, T, _b_inputs, _col_maps
from test_torch_cavlc import _coeffs

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

KEYS = ("intra_mb", "skip", "direct_mb", "bmode", "use_l0", "use_l1",
        "mvd_l0", "mvd_l1", "cbp_luma_bits", "cbp_chroma", "luma_blocks",
        "luma_dc", "chroma_dc", "chroma_ac", "mode16", "modec")


@functools.lru_cache(maxsize=None)
def _body():
    """The port's plain B body (equal to x264_tpu's encode_b_body, which
    tests/test_torch_bframe.py holds) on that file's inputs."""
    y, u, v, ay, au, av, by, bu, bv = _b_inputs()
    rng = np.random.default_rng(8)
    seed0 = rng.integers(-8, 9, (MB_H, MB_W, 2)).astype(np.int32)
    cr, cm = _col_maps(rng)
    tq = tinter.make_qtab_p(QP, tables.chroma_qp(QP), "cpu")
    out = tinter.encode_b_body_plain(
        MB_H, MB_W, 16, T(y), T(u), T(v), (T(ay), T(au), T(av)),
        (T(by), T(bu), T(bv)), tq, int(tables.LAMBDA_TABLE[QP]), T(seed0),
        T(-seed0), T(cr), T(cm))
    return MB_H, MB_W, {k: out[k].numpy() for k in KEYS}


@functools.lru_cache(maxsize=None)
def _synthetic():
    """A 5 x 6-MB B slice with intra (I16 with and without coded luma),
    direct, B_SKIP, L0, L1 and BI MBs, random cbps, levels of every
    escape form and a trailing skip run."""
    h, w = 5, 6
    nmb = h * w
    rng = np.random.default_rng(41)
    intra = rng.random(nmb) < 0.2
    direct = ~intra & (rng.random(nmb) < 0.35)
    bmode = rng.integers(0, 3, nmb)
    cbp_l = np.where(intra, np.where(rng.random(nmb) < 0.6, 15, 0),
                     rng.integers(0, 16, nmb))
    cbp_c = rng.integers(0, 3, nmb)
    quiet = direct & (rng.random(nmb) < 0.6)
    quiet[-3:] = True                       # a trailing skip run
    intra[-3:] = False
    direct[-3:] = True
    cbp_l[quiet] = 0
    cbp_c[quiet] = 0
    skip = direct & (cbp_l == 0) & (cbp_c == 0)
    use0 = ~intra & ~direct & (bmode != 1)
    use1 = ~intra & ~direct & (bmode != 0)
    luma = _coeffs(rng, nmb * 16, 16).reshape(nmb, 16, 16)
    luma[rng.random((nmb, 16)) < 0.4] = 0
    out = dict(intra_mb=intra, skip=skip, direct_mb=direct, bmode=bmode,
               use_l0=use0, use_l1=use1,
               mvd_l0=rng.integers(-300, 300, (nmb, 2)),
               mvd_l1=rng.integers(-40, 40, (nmb, 2)),
               cbp_luma_bits=cbp_l, cbp_chroma=cbp_c, luma_blocks=luma,
               luma_dc=_coeffs(rng, nmb, 16),
               chroma_dc=_coeffs(rng, nmb * 2, 4).reshape(nmb, 2, 4),
               chroma_ac=_coeffs(rng, nmb * 8, 16).reshape(nmb, 2, 4, 16),
               mode16=rng.integers(0, 4, nmb), modec=rng.integers(0, 4, nmb))
    out = {k: np.asarray(a).reshape((h, w) + np.asarray(a).shape[1:])
           for k, a in out.items()}
    return h, w, {k: a.astype(bool if a.dtype == bool else np.int32)
                  for k, a in out.items()}


SLICES = {"body": _body, "synthetic": _synthetic}


def _modes(out):
    """The MB kinds of a B slice that occur: intra, skip, direct (coded),
    and the explicit L0, L1, BI."""
    im, sk, dm = out["intra_mb"], out["skip"], out["direct_mb"]
    ex = ~im & ~dm
    return dict(intra=im.any(), skip=sk.any(), direct=(dm & ~sk).any(),
                **{m: (ex & (out["bmode"] == i)).any()
                   for i, m in enumerate(("l0", "l1", "bi"))})


@pytest.mark.parametrize("name", list(SLICES))
def test_b_code_planes_match_jax(name):
    h, w, out = SLICES[name]()
    assert all(_modes(out).values()), _modes(out)
    jv, jl = jdev.b_code_planes({k: jnp.asarray(a) for k, a in out.items()},
                                h, w)
    tv, tl = tdev.b_code_planes({k: torch.from_numpy(a)
                                 for k, a in out.items()}, h, w)
    np.testing.assert_array_equal(np.asarray(jl).astype(np.int64),
                                  tl.numpy())
    np.testing.assert_array_equal(
        np.where(np.asarray(jl) > 0, np.asarray(jv), 0).astype(np.int64),
        torch.where(tl > 0, tv, 0).numpy())
    if name == "synthetic":
        assert int(tl[-1]) > 0                # the trailing run is coded


def _hdr():
    bw = BitWriter()
    SliceHeader(slice_type=SLICE_B, frame_num=2, idr_pic_id=-1, poc_lsb=2,
                qp=QP, disable_deblock=0, cabac=False, num_ref_idx_l0=1,
                num_ref_idx_l1=1, num_ref_idx_override=True).write_rbsp(bw, 0)
    return tdev.header_slots(bw)


@pytest.mark.parametrize("cap", ["full", "dropping"])
@pytest.mark.parametrize("name", list(SLICES))
def test_cavlc_b_slice_words_match_jax(name, cap):
    """The packed slice as x264_tpu's encode_b packs it: the header slots,
    b_code_planes and the rbsp stop bit through pack_codes."""
    h, w, out = SLICES[name]()
    hv, hl = _hdr()
    jv, jl = jdev.b_code_planes({k: jnp.asarray(a) for k, a in out.items()},
                                h, w)
    one = jnp.ones((1,), jnp.int32)
    all_v = jnp.concatenate([jnp.asarray(hv), jv, one])
    all_l = jnp.concatenate([jnp.asarray(hl), jl, one])
    nbits = int(jnp.sum(all_l))
    words = (nbits + 31) // 32 + 2 if cap == "full" else nbits // 64
    jw, jn = jdev.pack_codes(all_v, all_l, words)
    tw, tn = tdev.cavlc_b_slice_plain(
        {k: torch.from_numpy(a) for k, a in out.items()}, {}, h, w, hv, hl,
        words)
    assert int(tn) == int(jn) == nbits
    np.testing.assert_array_equal(np.asarray(jw).view(np.uint32),
                                  tw.numpy().view(np.uint32))
    if cap == "dropping":
        assert nbits > 32 * words           # codes past the capacity

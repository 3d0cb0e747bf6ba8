"""The CAVLC slice's plain functions (x264_tpu_torch/entropy/device.py,
the plain versions of kernels K18 / K19) against x264_tpu's jnp ones on
seeded numpy inputs, exactly: residual_codes for C = 4 / 15 / 16 and nC
-1..16 (trailing-one patterns, levels up to +-3000 so that every escape
form occurs, full and empty blocks), nc_map, i4_pred_mode_codes,
i16_code_planes and p_code_planes on synthetic 6x5-MB slices (every
ptype, intra and skip MBs, a trailing skip run, with and without dqp),
pack_codes (zero lengths, 32-bit codes, codes dropped past the capacity)
and header_slots of a real slice header; the table layout csrc/cavlc.cu
reads. No Encoder is compiled here."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu.entropy import device as jdev
from x264_tpu.entropy.bitstream import BitWriter as JBitWriter
from x264_tpu.headers import SliceHeader as JSliceHeader
from x264_tpu_torch.entropy import device as tdev
from x264_tpu_torch.entropy.bitstream import BitWriter
from x264_tpu_torch.headers import SLICE_I, SLICE_P, SliceHeader

torch.set_num_threads(1)

MB_H, MB_W = 5, 6
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  t.numpy().astype(np.int64))


def _coeffs(rng, n, c):
    """Blocks of every kind: empty, full, trailing ones, small and large
    levels (every escape form), sparse and dense."""
    kind = rng.integers(0, 6, n)
    mag = np.choose(kind, [1, 2, 5, 40, 3000, 15])
    coef = rng.integers(-mag[:, None], mag[:, None] + 1, (n, c))
    dens = rng.random(n)[:, None]
    coef = coef * (rng.random((n, c)) < dens)
    coef[kind == 0] = 0
    coef[::7] = rng.choice([-1, 1], (len(coef[::7]), c))      # all ones
    coef[3::11] = rng.integers(1, 3000, (len(coef[3::11]), c)) \
        * rng.choice([-1, 1], (len(coef[3::11]), c))           # total = C
    return coef.astype(np.int32)


@pytest.mark.parametrize("c", [4, 15, 16])
def test_residual_codes_match_jax(c):
    rng = np.random.default_rng(c)
    n = 3000
    coef = _coeffs(rng, n, c)
    nc = (np.full(n, -1) if c == 4 else rng.integers(-1, 17, n)).astype(
        np.int32)
    jv, jl = jax.jit(jdev.residual_codes)(jnp.asarray(coef), jnp.asarray(nc))
    tv, tl = tdev.residual_codes(_t(coef), _t(nc))
    _eq(jl, tl)
    _eq(jv, tv)
    # every escape form of the levels occurs
    lvl_l = tl[:, 2:18]
    assert (lvl_l == 19).any() and (lvl_l >= 28).any()
    assert int(tl.max()) <= 32


def test_nc_map_and_i4_pred_modes_match_jax():
    rng = np.random.default_rng(5)
    grid = rng.integers(0, 17, (MB_H * 4, MB_W * 4)).astype(np.int32)
    _eq(jdev.nc_map(jnp.asarray(grid)), tdev.nc_map(_t(grid)))
    i4_mb = rng.random((MB_H, MB_W)) < 0.6
    modes = np.where(i4_mb[..., None, None],
                     rng.integers(0, 9, (MB_H, MB_W, 4, 4)), 2).astype(
        np.int32)
    jv, jl = jdev.i4_pred_mode_codes(jnp.asarray(i4_mb), jnp.asarray(modes),
                                     MB_H, MB_W)
    tv, tl = tdev.i4_pred_mode_codes(_t(i4_mb), _t(modes), MB_H, MB_W)
    _eq(jl, tl)
    _eq(jv, tv)


def _intra_out(seed, dqp):
    rng = np.random.default_rng(seed)
    h, w = MB_H, MB_W
    i4_mb = rng.random((h, w)) < 0.5
    luma_ac = _coeffs(rng, h * w * 16, 16).reshape(h, w, 16, 16)
    luma_ac[rng.random((h, w, 16)) < 0.4] = 0
    cbp = np.where(i4_mb, rng.integers(0, 16, (h, w)),
                   np.where(rng.random((h, w)) < 0.7, 15, 0))
    # an I16 MB without AC keeps its (uncoded) slot 0, which the nC counts
    luma_ac[~i4_mb & (cbp == 0), :, 1:] = 0
    chroma_ac = _coeffs(rng, h * w * 8, 16).reshape(h, w, 2, 4, 16)
    chroma_ac[rng.random((h, w)) < 0.4] = 0
    chroma_dc = _coeffs(rng, h * w * 2, 4).reshape(h, w, 2, 4)
    chroma_dc[rng.random((h, w)) < 0.3] = 0
    out = dict(luma_dc=_coeffs(rng, h * w, 16).reshape(h, w, 16),
               luma_ac=luma_ac, chroma_dc=chroma_dc, chroma_ac=chroma_ac,
               mode16=rng.integers(0, 4, (h, w)),
               modec=rng.integers(0, 4, (h, w)), i4_mb=i4_mb,
               i4_modes=np.where(i4_mb[..., None, None],
                                 rng.integers(0, 9, (h, w, 4, 4)), 2),
               cbp_luma_bits=cbp)
    if dqp:
        out["dqp"] = rng.integers(-30, 31, (h, w))
    return {k: np.asarray(v, bool if v.dtype == bool else np.int32)
            for k, v in out.items()}


@pytest.mark.parametrize("dqp", [False, True])
def test_i16_code_planes_match_jax(dqp):
    out = _intra_out(1 + dqp, dqp)
    jv, jl = jdev.i16_code_planes({k: jnp.asarray(v) for k, v in
                                   out.items()}, MB_H, MB_W)
    tv, tl = tdev.i16_code_planes({k: _t(v) for k, v in out.items()},
                                  MB_H, MB_W)
    _eq(jl, tl)
    _eq(np.where(np.asarray(jl) > 0, jv, 0), torch.where(tl > 0, tv, 0))
    assert int(tl.sum()) > 0


def _p_out(seed, dqp):
    rng = np.random.default_rng(seed)
    h, w = MB_H, MB_W
    nmb = h * w
    intra = rng.random(nmb) < 0.2
    skip = ~intra & (rng.random(nmb) < 0.35)
    skip[-4:] = True                      # a trailing skip run
    skip[-4:] &= ~intra[-4:]
    intra[-4:] = False
    ptype = np.where(intra, 0, np.arange(nmb) % 4)
    ptype[skip] = 0
    cbp_l = np.where(intra, np.where(rng.random(nmb) < 0.6, 15, 0),
                     rng.integers(0, 16, nmb))
    cbp_c = rng.integers(0, 3, nmb)
    cbp_l[skip] = 0
    cbp_c[skip] = 0
    luma = _coeffs(rng, nmb * 16, 16).reshape(nmb, 16, 16)
    luma[rng.random((nmb, 16)) < 0.4] = 0
    out = dict(intra_mb=intra, skip=skip, ptype=ptype,
               cbp_luma_bits=cbp_l, cbp_chroma=cbp_c,
               luma_blocks=luma,
               luma_dc=_coeffs(rng, nmb, 16),
               chroma_dc=_coeffs(rng, nmb * 2, 4).reshape(nmb, 2, 4),
               chroma_ac=_coeffs(rng, nmb * 8, 16).reshape(nmb, 2, 4, 16),
               mode16=rng.integers(0, 4, nmb), modec=rng.integers(0, 4, nmb),
               mvd=rng.integers(-300, 300, (nmb, 2)),
               mvd1=rng.integers(-40, 40, (nmb, 2)),
               mvd_sub=rng.integers(-20, 20, (nmb, 4, 2)))
    if dqp:
        out["dqp"] = rng.integers(-30, 31, nmb)
    out = {k: np.asarray(v).reshape((h, w) + np.asarray(v).shape[1:])
           for k, v in out.items()}
    return {k: np.asarray(v, bool if v.dtype == bool else np.int32)
            for k, v in out.items()}


@pytest.mark.parametrize("dqp", [False, True])
def test_p_code_planes_match_jax(dqp):
    out = _p_out(3 + dqp, dqp)
    assert set(np.unique(out["ptype"][~out["intra_mb"] & ~out["skip"]])) \
        == {0, 1, 2, 3}
    jv, jl = jdev.p_code_planes({k: jnp.asarray(v) for k, v in out.items()},
                                MB_H, MB_W)
    tv, tl = tdev.p_code_planes({k: _t(v) for k, v in out.items()},
                                MB_H, MB_W)
    _eq(jl, tl)
    _eq(np.where(np.asarray(jl) > 0, jv, 0), torch.where(tl > 0, tv, 0))
    assert int(tl[-1]) > 0                # the trailing run is coded


def test_pack_codes_matches_jax():
    rng = np.random.default_rng(9)
    n = 5000
    lens = rng.integers(0, 33, n)
    lens[rng.random(n) < 0.3] = 0
    lens[::17] = 32
    vals = rng.integers(-(1 << 31), 1 << 31, n)      # bits above the length
    for cap in (int(lens.sum()) // 32 + 2, int(lens.sum()) // 64):
        jw, jn = jdev.pack_codes(jnp.asarray(vals, jnp.int32),
                                 jnp.asarray(lens, jnp.int32), cap)
        tw, tn = tdev.pack_codes(_t(vals.astype(np.int32)),
                                 _t(lens.astype(np.int32)), cap)
        np.testing.assert_array_equal(np.asarray(jw),
                                      tw.numpy().view(np.uint32))
        assert int(jn) == int(tn) == int(lens.sum())
    assert cap * 32 < int(tn)              # the second run dropped codes


@pytest.mark.parametrize("slice_type", [SLICE_I, SLICE_P])
def test_header_slots_match_jax(slice_type):
    kw = dict(slice_type=slice_type, frame_num=3, idr_pic_id=7
              if slice_type == SLICE_I else -1, poc_lsb=6, qp=31,
              pic_init_qp=26, disable_deblock=0, alpha_c0_offset=-1,
              beta_offset=2, cabac=False, num_ref_idx_l0=1,
              num_ref_idx_l1=1, num_ref_idx_override=False,
              log2_max_frame_num=4, log2_max_poc_lsb=6)
    jb, tb = JBitWriter(), BitWriter()
    JSliceHeader(**kw).write_rbsp(jb, nal_ref_idc=3)
    SliceHeader(**kw).write_rbsp(tb, nal_ref_idc=3)
    jb.put((1 << 30) | 5, 31)             # a code longer than 24 bits
    tb.put((1 << 30) | 5, 31)
    for j, t in zip(jdev.header_slots(jb), tdev.header_slots(tb)):
        np.testing.assert_array_equal(j, t)
    words = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    assert tdev.words_to_bytes(words.view(np.int32), 44) \
        == jdev.words_to_bytes(words, 44)


def test_kernel_table_layout():
    """csrc/cavlc.cu's T_* offsets equal the flat table the wrapper
    uploads."""
    src = (ROOT / "x264_tpu_torch/csrc/cavlc.cu").read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (T_\w+) = (\d+);", src)}
    assert consts == tdev.table_offsets()
    assert tdev._device_tables("cpu").numel() == consts["T_SIZE"]

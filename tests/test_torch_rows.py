"""The MB-row sharded path's functions against x264_tpu, on the CPU: K27's
plain version (hw_pack_plain) against x264_tpu's hw_pack on seeded op
streams of compact and extended ops, with a capacity that drops
halfwords, bit for bit; unpack_hw round trips and agrees with x264_tpu's;
K28's plain version (halo_extend_plain, through ext_refs) against
x264_tpu's _ext_refs run under shard_map on 4 of the virtual CPU devices
(tests/conftest.py), exact at each band position; and K4's plain version
against x264_tpu's stats.frame_metrics, which the band path's metrics
replace (row 24), within K4's tolerance: relative 1e-6 on the SSDs (K4
sums in int64, x264_tpu in int32 blocks then float32) and 1e-5 on the
SSIM sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from x264_tpu.encoder import stats as jstats
from x264_tpu.entropy import cabac as jcabac
from x264_tpu.entropy import cabac_planes as jplanes
from x264_tpu.parallel import rows as jrows
from x264_tpu_torch.encoder import stats as tstats
from x264_tpu_torch.entropy import cabac as tcabac
from x264_tpu_torch.entropy import cabac_planes as tplanes
from x264_tpu_torch.parallel import rows as trows

torch.set_num_threads(1)


def _ops(n: int, cap: int, seed: int, ext_share: float):
    """cap int32 op bit patterns, the first n live: kinds 0-7 but the pad,
    with a and b inside the compact payload except for ext_share of them,
    whose a or b is drawn wide (extended ops); zero past n, as K3 / K8 /
    K24's plain versions leave them."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, 1, 2, 3, 5, 6, 7], n).astype(np.uint32)
    abits = np.asarray(tplanes.HW_A_BITS, np.uint32)[kind]
    a = rng.integers(0, 1 << 11, n).astype(np.uint32) % (1 << abits)
    b = rng.integers(0, 1 << 12, n).astype(np.uint32) % (1 << (12 - abits))
    wide = rng.random(n) < ext_share
    a = np.where(wide & (rng.random(n) < 0.5),
                 rng.integers(0, 1 << 17, n).astype(np.uint32), a)
    b = np.where(wide, rng.integers(0, 1 << 12, n).astype(np.uint32), b)
    ops = np.zeros(cap, np.uint32)
    ops[:n] = (kind << 29) | (b << 17) | a
    return ops


@pytest.mark.parametrize("n,cap,ext_share,cap_hw", [
    (3000, 4096, 0.0, 3 * 4096),        # all compact
    (3000, 4096, 0.3, 3 * 4096),        # mixed
    (4096, 4096, 1.0, 3 * 4096),        # all extended, full
    (2500, 4096, 0.4, 3001),            # odd capacity, drops halfwords
    (0, 4096, 0.5, 3 * 4096),           # empty
])
def test_hw_pack_plain_is_x264_tpus(n, cap, ext_share, cap_hw):
    ops = _ops(n, cap, seed=n + int(100 * ext_share), ext_share=ext_share)
    jw, jn = jplanes.hw_pack(jnp.asarray(ops), jnp.int32(n), cap_hw)
    tw, tn = tplanes.hw_pack_plain(torch.from_numpy(ops.view(np.int32)),
                                   torch.tensor(n, dtype=torch.int32), cap_hw)
    assert tw.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  np.asarray(jw))
    assert int(tn) == int(jn)
    if cap_hw < int(jn):
        assert tw.shape[0] * 2 == cap_hw + 1     # x264_tpu keeps it even


@pytest.mark.parametrize("ext_share", [0.0, 0.3, 1.0])
def test_unpack_hw_round_trips(ext_share):
    n = 3333
    ops = _ops(n, 4096, seed=7, ext_share=ext_share)
    words, n_hw = tplanes.hw_pack_plain(
        torch.from_numpy(ops.view(np.int32)), n, 3 * 4096)
    back = tcabac.unpack_hw(words.numpy(), int(n_hw))
    np.testing.assert_array_equal(back, ops[:n])
    np.testing.assert_array_equal(
        jcabac.unpack_hw(words.numpy().view(np.uint32), int(n_hw)), back)
    # the live prefix alone, as the band path fetches it
    prefix = words.numpy()[:(int(n_hw) + 1) // 2]
    np.testing.assert_array_equal(tcabac.unpack_hw(prefix, int(n_hw)), back)


def _planes(n_bands: int, band: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    h = n_bands * band * 16
    return (rng.integers(0, 256, (h, w)).astype(np.int32),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32))


@pytest.mark.parametrize("band", [2, 3])
def test_halo_extend_plain_is_x264_tpus_ext_refs(band):
    n = 4
    y, u, v = _planes(n, band, 48, seed=band)
    mesh = jrows.make_rows_mesh(n)
    row = P(jrows.AXIS)
    fn = jax.jit(shard_map(lambda a, b, c: jrows._ext_refs(a, b, c, n),
                           mesh=mesh, in_specs=(row,) * 3,
                           out_specs=(row,) * 3, check_vma=False))
    jy, ju, jv = (np.asarray(x) for x in fn(y, u, v))
    bands = [tuple(torch.from_numpy(np.ascontiguousarray(
        p[k * band * s:(k + 1) * band * s])) for p, s in
        zip((y, u, v), (16, 8, 8))) for k in range(n)]
    hy, hc = band * 16 + 64, band * 8 + 32
    for k in range(n):
        ty, tu, tv = trows.ext_refs(bands, k, torch.device("cpu"))
        np.testing.assert_array_equal(ty.numpy(), jy[k * hy:(k + 1) * hy])
        np.testing.assert_array_equal(tu.numpy(), ju[k * hc:(k + 1) * hc])
        np.testing.assert_array_equal(tv.numpy(), jv[k * hc:(k + 1) * hc])


def test_halo_extend_plain_edges():
    """One band alone: both sides replicate its own edge rows."""
    y, u, v = (torch.from_numpy(p) for p in _planes(1, 2, 32, seed=9))
    ey, eu, _ = trows.halo_extend_plain((y, u, v), None, None)
    assert ey.shape == (32 + 64, 32 + 64) and eu.shape == (16 + 32, 16 + 32)
    assert (ey[:33, 32:64] == y[0]).all() and (ey[-33:, 32:64] == y[-1]).all()
    assert (ey[40, :33] == y[8, 0]).all() and (eu[-1, -17:] == u[-1, -1]).all()


@pytest.mark.parametrize("w,h", [(128, 128), (64, 138), (94, 70)])
def test_k4_plain_is_x264_tpus_frame_metrics(w, h):
    rng = np.random.default_rng(w + h)
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    src = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    rec = [np.clip(p + rng.integers(-9, 10, p.shape), 0, 255).astype(np.int32)
           for p in src]
    j = [float(x) for x in jstats.frame_metrics(*src, *rec, w, h)]
    t = tstats.frame_metrics_plain(*(torch.from_numpy(p)
                                     for p in src + rec), w, h)
    t = [float(x) for x in t]
    for a, b in zip(j[:3], t[:3]):
        assert abs(a - b) <= 1e-6 * abs(a)
    assert abs(j[3] - t[3]) <= 1e-5 * abs(j[3])

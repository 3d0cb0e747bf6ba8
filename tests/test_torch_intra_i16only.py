"""The port's plain K1 without the I4x4 ladder (--partitions none)
against x264_tpu's encode_i16_frame(..., i4x4=False) on seeded planes:
alone, with I8x8 (held against I16x16 alone), lossless (CQP 0), and
with a variance-AQ QP map through both packages' I-pipeline fronts
(x264_tpu's _encode_i16_aq, the port's _intra_front). Every output is
integer and must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x264_tpu import tables
from x264_tpu.encoder import aq as jaq
from x264_tpu.encoder import intra as jintra
from x264_tpu.encoder import pipeline as jpipe
from x264_tpu_torch import tables as ttables
from x264_tpu_torch.encoder import aq as taq
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.encoder import pipeline as tpipe

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

MB_H, MB_W = 3, 5


def _planes(seed, blocky=False):
    """Seeded planes: a gradient under noise, or (blocky) under 8x8-blocky
    noise, which I8x8 fits."""
    rng = np.random.default_rng(seed)
    h, w = MB_H * 16, MB_W * 16
    yy, xx = np.mgrid[0:h, 0:w]
    if blocky:
        low = np.kron(rng.integers(-20, 20, (h // 8, w // 8)),
                      np.ones((8, 8), np.int64))
        y = (yy * 2 + xx * 3) // 2 % 256 + low
    else:
        y = (xx // 3 + yy // 2) % 220 + rng.integers(0, 40, (h, w))
    u = rng.integers(0, 256, (h // 2, w // 2))
    v = 128 + rng.integers(-20, 20, (h // 2, w // 2))
    return tuple(np.clip(a, 0, 255).astype(np.int32) for a in (y, u, v))


def _check(jo, to):
    assert set(to) == set(jo)
    for k in jo:
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("qp,i8x8,lossless", [
    (26, False, False), (38, False, False), (26, True, False),
    (0, False, True)])
def test_i16only_frame_matches_jax(qp, i8x8, lossless):
    y, u, v = _planes(qp + int(i8x8), blocky=i8x8)
    lam = int(tables.LAMBDA_TABLE[qp])
    jq = jintra.make_qtab(qp, tables.chroma_qp(qp))
    jo = jintra.encode_i16_frame(MB_H, MB_W, y, u, v, jq, lam, False,
                                 lossless, i8x8)
    tq = tintra.make_qtab(qp, ttables.chroma_qp(qp), "cpu")
    to = tintra.encode_i16_frame(MB_H, MB_W, *(torch.from_numpy(a)
                                               for a in (y, u, v)),
                                 tq, lam, i8x8, None, lossless, i4x4=False)
    _check(jo, to)
    assert not to["i4_mb"].any() if not i8x8 \
        else torch.equal(to["i4_mb"], to["t8_mb"]) and to["t8_mb"].any()
    assert (to["i4_modes"] == 2).all() if not i8x8 else True
    if lossless:
        assert torch.equal(to["recon_y"], torch.from_numpy(y))


def test_i16only_with_a_qp_map_matches_jax():
    """Variance AQ: the QP map of each package's AQ front, K1 without
    I4x4 at each MB's row of the 52-QP stack, and K17's dqp planes."""
    qp = 26
    y, u, v = _planes(7)
    lam = int(tables.LAMBDA_TABLE[qp])
    jq = dict(jintra.make_qtab(qp, tables.chroma_qp(qp)),
              full=jaq.full_tables(tables.DEFAULT_QUANT),
              aq_strength=jnp.float32(1.0))
    jo, jqp = jpipe._encode_i16_aq(MB_H, MB_W, y, u, v, jq, lam, qp, False,
                                   False, True, 10, 51, 0)
    st = taq.qtab_stacks(taq.full_tables(ttables.DEFAULT_QUANT, "cpu"), 0)
    tq = dict(tintra.make_qtab(qp, ttables.chroma_qp(qp), "cpu"),
              aq_stack=st["intra"])
    to, tqp = tpipe._intra_front(
        MB_H, MB_W, *(torch.from_numpy(a) for a in (y, u, v)), tq, lam, qp,
        0, False, (float(np.float32(1.0)), 10, 51), False, False)
    _check(jo, to)
    np.testing.assert_array_equal(np.asarray(jqp), tqp.numpy())
    assert len(np.unique(tqp.numpy())) > 1 and not to["i4_mb"].any()

"""The port's plain CABAC op stream of an intra slice against x264_tpu's
compact_ops(i16_slice_ops(...)), both fed the same intra syntax planes
(the port's plain encode_i16_frame output, which test_torch_intra holds
equal to x264_tpu's), and that of a P slice against
compact_ops(p_slice_ops(...)), fed the port's plain encode_p_body output
(held equal by test_torch_inter and, at subme 5 with the 16x8 / 8x16 /
P8x8 partitions, by test_torch_encoder_subpel). The live ops and n_ops
must be exactly
equal, and the port's two host coders (native C and its Python twin)
must turn each stream into the same bytes."""

import numpy as np
import pytest
import torch

from x264_tpu.encoder import pipeline as jpipe
from x264_tpu.entropy import cabac_planes as jcp
from x264_tpu_torch import native, tables
from x264_tpu_torch.encoder import inter as tinter
from x264_tpu_torch.encoder import intra as tintra
from x264_tpu_torch.entropy import cabac as tcabac
from x264_tpu_torch.entropy import cabac_planes as tcp
from x264_tpu_torch.entropy import cabac_tables as tctab

from test_torch_encoder_subpel import _p_inputs as _part_inputs
from test_torch_inter import MB_H, MB_W, _p_inputs
from test_torch_intra import planes

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("mb_h,mb_w,qp", [(3, 7, 18), (3, 7, 26),
                                          (3, 7, 38)])
def test_op_stream_matches_jax(mb_h, mb_w, qp, monkeypatch):
    y, u, v = (torch.from_numpy(a) for a in planes(mb_h, mb_w, qp))
    out = tintra.encode_i16_frame(
        mb_h, mb_w, y, u, v,
        tintra.make_qtab(qp, tables.chroma_qp(qp), "cpu"),
        int(tables.LAMBDA_TABLE[qp]))
    ops = jcp.i16_slice_ops({k: t.numpy() for k, t in out.items()}, mb_h,
                            mb_w, t8_mode=False)
    jops, jn = jcp.compact_ops(ops, jpipe.cabac_capacity(mb_h * mb_w))
    tops, tn = tcp.i_slice_ops(out, mb_h, mb_w)
    n = int(jn)
    assert int(tn) == n
    assert tops.shape[0] == tcp.capacity(mb_h * mb_w) == jops.shape[0]
    np.testing.assert_array_equal(np.asarray(jops)[:n],
                                  tops.numpy().view(np.uint32)[:n])
    assert not tops[n:].any()

    live = tops.numpy().view(np.uint32)[:n]
    assert native.load() is not None
    code = lambda: tcabac.encode_ops(tctab.init_states(True, qp, 0), live,
                                     0x5A)
    c_bytes = code()
    monkeypatch.setattr(native, "load", lambda: None)
    assert code() == c_bytes


@pytest.mark.parametrize("kind", ["inter", "intra", "partitions"])
def test_p_op_stream_matches_jax(kind, monkeypatch):
    """The P slice: both packages' compact_ops(p_slice_ops(...)) on the
    port's plain encode_p_body output (which test_torch_inter and
    test_torch_encoder_subpel hold equal to x264_tpu's), and the port's K8
    wrapper on the CPU. "partitions" is subme 5 with every partition
    type, so the mb_type, sub_mb_type and per-partition mvd bins run."""
    inputs = _part_inputs(0) if kind == "partitions" else _p_inputs(kind)
    y, u, v, ry, ru, rv, mvp = (torch.from_numpy(a) for a in inputs)
    qp = 26
    args = (MB_H, MB_W, 16, y, u, v, ry, ru, rv,
            tinter.make_qtab_p(qp, tables.chroma_qp(qp), "cpu"),
            int(tables.LAMBDA_TABLE[qp]), mvp, True)
    if kind == "partitions":
        args += ((2, 1), True, True, True)
    out = tinter.encode_p_body(*args)
    if kind == "partitions":
        assert set(out["ptype"][~out["intra_mb"]].tolist()) == {0, 1, 2, 3}
    nmb = MB_H * MB_W
    jops, jn = jcp.compact_ops(
        jcp.p_slice_ops({k: t.numpy() for k, t in out.items()}, MB_H, MB_W),
        jpipe.cabac_capacity(nmb))
    n = int(jn)
    front = tinter.encode_p_front(*args)
    maps, tops, tn = tcp.cabac_p_ops(front, MB_H, MB_W)
    assert int(tn) == n
    assert tops.shape[0] == jops.shape[0]
    np.testing.assert_array_equal(np.asarray(jops)[:n],
                                  tops.numpy().view(np.uint32)[:n])
    for k, t in maps.items():
        assert torch.equal(t, out[k]), k
    with pytest.raises(NotImplementedError):        # two references
        tcp.cabac_p_ops(front, MB_H, MB_W, n_refs=2)

    live = tops.numpy().view(np.uint32)[:n]
    code = lambda: tcabac.encode_ops(tctab.init_states(False, qp, 0), live,
                                     0x5A)
    c_bytes = code()
    monkeypatch.setattr(native, "load", lambda: None)
    assert code() == c_bytes

"""Per-stage timings of the port's P and I pipelines (the counterpart of
tools/profile_stages.py, a checkasm --bench analogue): each stage that
x264_tpu's tool times, on seeded random planes at WxH (1080p by
default), CQP 26.

    python -m x264_tpu_torch.tools.profile_stages [WxH] [--device cuda|cpu]

On the card each stage is timed with CUDA events over three calls after
one warm-up call; with --device cpu the plain versions on the host
clock. Where the port runs two of x264_tpu's stages as one call, the
line's name says so: the P body is encode_p_front (stages 1-3; the
stage-4 maps run inside K8), and K8 also builds the op planes and
compacts them (x264_tpu's cabac_plane_gen and cabac_compact)."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import tables
from ..encoder import inter, intra, pipeline
from ..entropy import cabac as ecabac
from ..entropy import cabac_planes
from ..entropy import cabac_tables as ctab
from ..ops import deblock, mc, me
from . import device_line, parse_args

I32 = torch.int32


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn, name: str, reps: int = 3) -> float:
    """ms a call of fn: one warm-up call, then reps calls between two CUDA
    events (the host clock on the CPU); prints the line."""
    fn()
    _sync(dev)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"{name:48s} {ms:10.3f} ms", flush=True)
    return ms


def main(argv=None) -> dict:
    w, h, dev = parse_args(sys.argv[1:] if argv is None else argv,
                           "per-stage timings of the port's pipelines")
    print(device_line(dev), flush=True)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    qp = 26
    qp_c = tables.chroma_qp(qp, 0)
    rng = np.random.default_rng(0)
    mk = lambda hh, ww: torch.as_tensor(
        rng.integers(0, 255, (hh, ww)).astype(np.int32), device=dev)
    y, u, v = mk(mb_h * 16, mb_w * 16), mk(mb_h * 8, mb_w * 8), \
        mk(mb_h * 8, mb_w * 8)
    ry, ru, rv = mk(mb_h * 16, mb_w * 16), mk(mb_h * 8, mb_w * 8), \
        mk(mb_h * 8, mb_w * 8)
    qtab = inter.make_qtab_p(qp, qp_c, dev)
    lam = int(tables.LAMBDA_TABLE[qp])
    mvp0 = torch.zeros((mb_h, mb_w, 2), dtype=I32, device=dev)
    res = {}

    # --- ME stages
    ref_pad = mc.pad_plane(ry)
    res["pad_ref"] = timed(dev, lambda: mc.pad_plane(ry), "pad_ref")
    planes = mc.hpel_planes(ref_pad)
    res["hpel_planes"] = timed(dev, lambda: mc.hpel_planes(ref_pad),
                               "hpel_planes (K9)")
    mv_fp = me.fullpel_search(y, ref_pad, mb_h, mb_w, 16, lam, mvp0)[0]
    res["me_fullpel_r16"] = timed(
        dev, lambda: me.fullpel_search(y, ref_pad, mb_h, mb_w, 16, lam, mvp0),
        "me_fullpel_r16 (K29)")
    res["me_hier_r16"] = timed(
        dev, lambda: me.hier_search(y, ref_pad, mb_h, mb_w, 16, lam, mvp0),
        "me_hier_r16 (K5)")
    res["me_subpel"] = timed(
        dev, lambda: me.subpel_refine(y, planes, mv_fp, lam, mvp0, (2, 1)),
        "me_subpel (K10)")

    # --- the P body before entropy: stages 1-3 (the maps run in K8)
    body = lambda: inter.encode_p_front(mb_h, mb_w, 16, y, u, v, ry, ru, rv,
                                        qtab, lam, mvp0, False, (2, 1), True)
    front = body()
    res["p_body_total"] = timed(dev, body,
                                "p_body_total [stages 1-3; 4 in K8]")

    # --- the intra wavefronts, with and without I4x4 (K1)
    res["i16_i4_wavefront"] = timed(
        dev, lambda: intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab, lam),
        "i16_i4_wavefront (K1)")
    res["i16_wavefront"] = timed(
        dev, lambda: intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab, lam,
                                            i4x4=False),
        "i16_wavefront (K1 without I4x4)")

    # --- the maps, op planes and compaction, fused in K8
    maps, _, _ = cabac_planes.cabac_p_ops(front, mb_h, mb_w)
    res["cabac_plane_gen+compact"] = timed(
        dev, lambda: cabac_planes.cabac_p_ops(front, mb_h, mb_w),
        "cabac_plane_gen+compact [K8: maps, planes, compact]")

    # --- deblock (K2, in place on a copy of the body's recon)
    qp_mb = torch.full((mb_h, mb_w), qp, dtype=I32, device=dev)
    rec = [front[k].clone() for k in ("recon_y", "recon_u", "recon_v")]
    z4, zmv = torch.zeros_like(maps["ref4"]), torch.zeros_like(maps["mv4"])
    res["deblock"] = timed(dev, lambda: deblock.deblock_frame(
        mb_h, mb_w, *rec, qp_mb, front["intra_mb"], maps["nnz4"],
        maps["ref4"], maps["mv4"], z4, zmv, False, 0, 0, 0), "deblock (K2)")

    # --- the fused P pipeline, then the host tail
    fused = lambda: pipeline.encode_p_cabac(
        mb_h, mb_w, 16, True, y, u, v, ry, ru, rv, qtab, lam, qp, 0, 0, 0,
        mvp0, mb_w * 16, mb_h * 16, False, False, (2, 1), True)
    out = fused()
    res["p_cabac_fused_total"] = timed(dev, fused, "p_cabac_fused_total")
    _sync(dev)
    t0 = time.perf_counter()
    n = int(out["host32"][0])
    ops = out["ops"][:n].cpu().numpy().view(np.uint32)
    res["d2h_ops_transfer"] = (time.perf_counter() - t0) * 1e3
    res["n_ops"] = n
    states = ctab.init_states(False, qp, 0)
    t0 = time.perf_counter()
    payload, _ = ecabac.encode_ops(states, ops, 0)
    res["host_cabac_fsm"] = (time.perf_counter() - t0) * 1e3
    res["payload_bytes"] = len(payload)

    for k, val in res.items():
        unit = "" if k in ("n_ops", "payload_bytes") else " ms"
        print(f"{k:48s} {val:10.3f}{unit}", flush=True)
    return res


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of x264_tpu_torch on one NVIDIA GPU (the quickest proof that
the PyTorch / CUDA port still starts and is right on the card).

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build: the CUDA kernels of x264_tpu_torch/csrc (one nvcc per source,
     started together) and the host CABAC engine, with the seconds;
  3. kernels: K1-K4 at 1080p on seeded frames, each held against its
     plain PyTorch version on the card (K1-K3 exact, K4 within relative
     1e-6 on the SSDs and 1e-5 on the SSIM sum) and timed beside it;
     then the host time to queue K1's and K2's launches, and one frame's
     split: kernels, d2h of the op stream, host CABAC;
  4. main path: x264_tpu_torch.Encoder on eight 1920x1080 frames,
     all-intra (keyint 1), CQP 26, CABAC, no 8x8 transform, deblocking
     and PSNR / SSIM on, i_frame_parallel 3. Every kernel's launch count
     must rise during the run, and frame 0's payload and recon must equal
     those of Encoder(device="cpu") (the plain versions) on that frame.
The line before the last is the JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Needs one CUDA card, nvcc, and triton.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
QP = 26
N_FRAMES = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA's data sheet)
# the kernels' work is int32 arithmetic off the tensor cores; the data
# sheet gives no int32 rate, so its non-tensor float32 rate stands in
ALU_OPS_PER_S = 67e12
# integer operations the kernels need, counted from their arithmetic:
# K1 per MB: 4 I16 + 9x16 I4 + 4x2x4 chroma SATD blocks of ~130 ops, the
# 4x4 predictors, and the transform / quant / recon of 40 blocks;
# K2 per MB: 128 luma and 64 chroma line filters plus 48 bS derivations;
# K3: per live op, plus the neighbour scans of each MB;
# K4 per luma pixel: the SSD terms and four overlapping 8x8 SSIM windows
K1_OPS_PER_MB = 57_000
K2_OPS_PER_MB = 7_700
K3_OPS_PER_OP, K3_OPS_PER_MB = 10, 2_000
K4_OPS_PER_PX = 50


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_frames(w: int, h: int, n: int, frame_cls):
    """bench.py's synthetic source: static texture + noise, global pan."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx // 3 + yy // 2) % 200).astype(np.int32)
    noise = rng.integers(0, 24, (h + 32, w + 2 * n + 32))
    frames = []
    for t in range(n):
        y = (base + noise[t % 32:t % 32 + h, 2 * t:2 * t + w]) \
            .clip(0, 255).astype(np.uint8)
        u = (128 + (xx[::2, ::2] % 40) - 20).clip(0, 255).astype(np.uint8)
        v = (128 - (yy[::2, ::2] % 40) + 20).clip(0, 255).astype(np.uint8)
        frames.append(frame_cls(y, u, v))
    return frames


def params(EncoderParams, frame_parallel: int):
    p = EncoderParams(i_width=W, i_height=H, i_keyint_max=1, i_log_level=0,
                      i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = QP
    p.analyse.b_transform_8x8 = False
    return p


def event_ms(fn, reps: int, setup=None) -> float:
    """Median device time of fn() over reps, by CUDA events; setup() runs
    before each rep, outside the timed span."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def enqueue_ms(fn, reps: int, setup=None) -> float:
    """Median host time to queue fn()'s launches, the card idle at the
    start: where it nears event_ms, the host's launches bound the kernel."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: float):
    """Least time on the card: the larger of bytes over HBM rate and ops
    over the scalar ALU rate; returns (ms, "bytes" | "operations")."""
    tb, to = bytes_moved / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_err(a: dict, b: dict) -> int:
    return max(int((a[k].long() - b[k].long()).abs().max()) for k in b)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    import x264_tpu_torch
    from x264_tpu_torch import cuda, native, tables
    from x264_tpu_torch.encoder import intra, pipeline, stats
    from x264_tpu_torch.encoder.core import pad_plane
    from x264_tpu_torch.entropy import cabac as ecabac
    from x264_tpu_torch.entropy import cabac_planes
    from x264_tpu_torch.entropy import cabac_tables as ctab
    from x264_tpu_torch.ops import deblock

    # ---------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(smi_line, flush=True)
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    t_nvcc = cuda.build()
    if native.load() is None:
        fail("the host CABAC engine (native/cabac.c) did not build")
    print(f"build: nvcc {t_nvcc:.2f} s for {len(cuda.SOURCES)} sources, "
          f"total {time.perf_counter() - t0:.2f} s", flush=True)

    # ------------------------------------------------------- 3. kernels
    frames = make_frames(W, H, N_FRAMES, x264_tpu_torch.Frame)
    mb_h, mb_w = (H + 15) // 16, W // 16
    nmb = mb_h * mb_w
    f0 = frames[0]
    y, u, v = (torch.as_tensor(pad_plane(a, mb_h * s, mb_w * s),
                               device=dev).to(torch.int32)
               for a, s in ((f0.y, 16), (f0.u, 8), (f0.v, 8)))
    qtab = intra.make_qtab(QP, tables.chroma_qp(QP, 0), dev)
    lam = int(tables.LAMBDA_TABLE[QP])
    rec = {}

    def record(name, route, source, replaces, err, ms, plain_ms, bmoved,
               ops, library_ms=None):
        bms, by = bound(bmoved, ops)
        rec[name] = dict(name=name, route=route, source=source,
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms)
        print(f"kernel {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{bms:.4f} ms by {by}), max_abs_err {err}", flush=True)

    # K1 intra_diag
    k1 = intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab, lam)
    torch.cuda.synchronize()
    p1 = {}
    plain1_ms = event_ms(lambda: p1.update(intra.encode_i16_frame_plain(
        mb_h, mb_w, y, u, v, qtab, lam)), 1)
    err1 = max_err(k1, p1)
    if err1 != 0:
        bad = [k for k in p1 if not torch.equal(k1[k], p1[k])]
        fail(f"K1 intra_diag differs from its plain version in {bad}")
    ms1 = event_ms(lambda: intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab,
                                                  lam), 5)
    record("intra_diag", "cuda", "x264_tpu_torch/csrc/intra.cu",
           "x264_tpu/encoder/intra.py:268", err1, ms1, plain1_ms,
           nbytes(y, u, v) + nbytes(*k1.values()), K1_OPS_PER_MB * nmb)

    # K3 cabac_i_ops, on K1's syntax planes
    ops_k, n_k = cabac_planes.i_slice_ops(k1, mb_h, mb_w)
    pl3 = {}
    plain3_ms = event_ms(lambda: pl3.update(zip(
        ("ops", "n"), cabac_planes.i_slice_ops_plain(k1, mb_h, mb_w))), 1)
    n_ops = int(pl3["n"])
    if int(n_k) != n_ops:
        fail(f"K3 cabac_i_ops counts {int(n_k)} ops, its plain version "
             f"{n_ops}")
    err3 = int((ops_k[:n_ops].long() - pl3["ops"][:n_ops].long()).abs().max())
    if err3 != 0:
        fail("K3 cabac_i_ops differs from its plain version")
    ms3 = event_ms(lambda: cabac_planes.i_slice_ops(k1, mb_h, mb_w), 20)
    planes3 = [k1[k] for k in ("mode16", "modec", "i4_mb", "i4_modes",
                               "cbp_luma_bits", "luma_dc", "luma_ac",
                               "chroma_dc", "chroma_ac")]
    record("cabac_i_ops", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/entropy/cabac_planes.py:234", err3, ms3, plain3_ms,
           nbytes(*planes3) + 4 * n_ops + 4,
           K3_OPS_PER_OP * n_ops + K3_OPS_PER_MB * nmb)

    # K2 deblock_diag, in place on a copy of K1's recon
    intra_mb, z4, zmv = pipeline._zero_maps(mb_h, mb_w, dev)
    qp_mb = torch.full((mb_h, mb_w), QP, dtype=torch.int32, device=dev)
    maps = (qp_mb, intra_mb, z4, z4, zmv, z4, zmv, False, 0, 0, 0)
    src = (k1["recon_y"], k1["recon_u"], k1["recon_v"])
    work = []

    def fresh():
        work[:] = [t.clone() for t in src]

    fresh()
    p2 = {}
    plain2_ms = event_ms(lambda: p2.update(zip("yuv", deblock.deblock_frame_plain(
        mb_h, mb_w, *work, *maps))), 1)
    fresh()
    k2 = dict(zip("yuv", deblock.deblock_frame(mb_h, mb_w, *work, *maps)))
    err2 = max_err(k2, p2)
    if err2 != 0:
        fail("K2 deblock_diag differs from its plain version")
    ms2 = event_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work, *maps), 5,
                   setup=fresh)
    record("deblock_diag", "cuda", "x264_tpu_torch/csrc/deblock.cu",
           "x264_tpu/ops/deblock.py:166", err2, ms2, plain2_ms,
           2 * nbytes(*src) + nbytes(qp_mb, intra_mb, z4, z4, zmv),
           K2_OPS_PER_MB * nmb)

    # K4 frame_metrics, source against the deblocked recon
    ry, ru, rv = p2["y"], p2["u"], p2["v"]
    m_k = stats.frame_metrics(y, u, v, ry, ru, rv, W, H)
    m_p = {}
    plain4_ms = event_ms(lambda: m_p.update(m=stats.frame_metrics_plain(
        y, u, v, ry, ru, rv, W, H)), 3)
    rel = ((m_k.double() - m_p["m"].double()).abs()
           / m_p["m"].double().abs().clamp(min=1e-30)).tolist()
    if max(rel[:3]) > 1e-6 or rel[3] > 1e-5 or not torch.isfinite(m_k).all():
        fail(f"K4 frame_metrics {m_k.tolist()} vs plain {m_p['m'].tolist()}")
    err4 = float((m_k - m_p["m"]).abs().max())
    ms4 = event_ms(lambda: stats.frame_metrics(y, u, v, ry, ru, rv, W, H), 20)
    lib4 = event_ms(lambda: torch.sum((y - ry) ** 2), 20)
    record("frame_metrics", "triton", "x264_tpu_torch/encoder/stats.py",
           "x264_tpu/encoder/pipeline.py:32", err4, ms4, plain4_ms,
           nbytes(y, u, v, ry, ru, rv) + 16, K4_OPS_PER_PX * H * W, lib4)

    q1 = enqueue_ms(lambda: intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab,
                                                   lam), 5)
    q2 = enqueue_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work, *maps), 5,
                    setup=fresh)
    print(f"host enqueue of one frame's launches: intra_diag {q1:.3f} ms, "
          f"deblock_diag {q2:.3f} ms", flush=True)

    # the host tail of one frame, as Encoder runs it: the d2h copy of the
    # whole op buffer into pinned memory, then the C arithmetic coder
    ops_h = torch.empty(ops_k.shape, dtype=torch.int32, pin_memory=True)
    d2h_ms = event_ms(lambda: ops_h.copy_(ops_k, non_blocking=True), 5)
    live = ops_h.numpy()[:n_ops].view(np.uint32)
    t = time.perf_counter()
    payload, _ = ecabac.encode_ops(ctab.init_states(True, QP, 0), live, 0)
    cabac_ms = (time.perf_counter() - t) * 1e3
    device_ms = ms1 + ms2 + ms3 + ms4
    print(f"frame split: kernels {device_ms:.3f} ms, d2h of "
          f"{nbytes(ops_k)} bytes {d2h_ms:.3f} ms, host CABAC of {n_ops} "
          f"ops into {len(payload)} bytes {cabac_ms:.3f} ms", flush=True)

    # ----------------------------------------------------- 4. main path
    wrappers = {"intra_diag": intra.encode_i16_frame,
                "cabac_i_ops": cabac_planes.i_slice_ops,
                "deblock_diag": deblock.deblock_frame,
                "frame_metrics": stats.frame_metrics}
    enc = x264_tpu_torch.Encoder(params(x264_tpu_torch.EncoderParams, 3))
    header = enc.headers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    done, call_ms = [], []
    t_start = time.perf_counter()
    for f in frames:
        t = time.perf_counter()
        ef = enc.encode(f)
        call_ms.append((time.perf_counter() - t) * 1e3)
        if ef is not None:
            done.append(ef)
    done += enc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k: w.launches for k, w in wrappers.items()}
    summary = enc.close()
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
        rec[k]["launches"] = n
    if len(done) != N_FRAMES:
        fail(f"{len(done)} frames came out of {N_FRAMES}")
    sizes = [len(e.payload) for e in done]
    print(f"main path: {N_FRAMES} frames 1920x1080 all-intra CQP {QP} "
          f"CABAC, {N_FRAMES / wall:.3f} fps, median encode() "
          f"{statistics.median(call_ms[2:]):.1f} ms, "
          f"{statistics.mean(sizes):.0f} bytes/frame, PSNR Y "
          f"{summary['psnr']['y']:.4f} avg {summary['psnr']['avg']:.4f} dB, "
          f"SSIM {summary['ssim_y']:.6f} [{smi_line}]", flush=True)
    print(f"launches: {json.dumps(launches)}", flush=True)
    if not all(np.isfinite([summary["psnr"]["avg"], summary["ssim_y"]])):
        fail("metrics are not finite")

    # frame 0 against the plain versions on the CPU
    cpu = x264_tpu_torch.Encoder(params(x264_tpu_torch.EncoderParams, 1),
                                 device="cpu")
    if cpu.headers() != header:
        fail("headers differ between the card and the CPU")
    ref = cpu.encode(frames[0])
    if ref.payload != done[0].payload:
        fail("frame 0 payload differs from the CPU run")
    for pl in "yuv":
        if not torch.equal(getattr(ref.recon, pl),
                           getattr(done[0].recon, pl).cpu()):
            fail(f"frame 0 recon {pl} differs from the CPU run")
    print("frame 0: payload and recon equal the CPU run", flush=True)

    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

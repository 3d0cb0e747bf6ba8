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
     split: kernels, d2h of the op stream, host CABAC. Then the P-frame
     kernels K5-K8, and K2 with P maps, exact against their plain
     versions on frame 1 against frame 0's deblocked recon; K5-K8 once
     more against that recon with 30% of its 64x64 blocks (seeded)
     flattened to gray, so that many MBs go intra and intra chains deeper
     than the three sweeps are demoted; and one P frame's split;
  4. the all-intra main path: x264_tpu_torch.Encoder on four 1920x1080
     frames, all-intra (keyint 1), CQP 26, CABAC, no 8x8 transform,
     deblocking and PSNR / SSIM on, i_frame_parallel 3. K1-K4's launch
     counts must rise, and frame 0's payload and recon must equal those
     of Encoder(device="cpu") (the plain versions) on that frame;
     Then the sub-pel kernels K9-K12 and the partitioned K6 / K8 / K2,
     exact against their plain versions at 1080p: frame 1 against a
     second reference built from frame 0's recon, in which the 8x8
     blocks of each MB move by their partition's own small motion and
     some 64x64 tiles take a half-pel filter, so that every partition
     type and fractional MVs occur (K10 at steps (2,) and (2, 1)); and
     the host CABAC of frame 1 at subme 5 on frame 0's recon;
  5. the IPPP main path at subme 1: Encoder on eight 1920x1080 frames,
     keyint 250, subme 1, one reference, scenecut 0, no B frames,
     otherwise as in 4. K1-K8's launch counts must rise, and frames 0-1
     (IDR, P) must equal the CPU run's payloads and recons;
  6. IPPP at subme 5: eight 1920x1080 frames as in 5 but at subme 5,
     with the 16x8 / 8x16 / P8x8 partitions and chroma ME. K1-K12's
     launch counts must rise, frames 0-1 must equal the CPU run's, and a
     torch.profiler trace splits the device time by kernel;
  7. IPPP at subme 6 with the scenecut lookahead, without the 8x8
     transform:
     32 1920x1080 frames, subme 6 (the RD ladder, psy-RD 1.0), scenecut
     40, keyint 250, keyint_min 25, otherwise as in 6; frames 26-31 are a
     second picture (make_frames' pan over a smooth texture of its own,
     seed 1: cut_frames), so the lookahead must call an IDR at frame 26
     and nowhere else but frame 0. Every kernel's launch count (K1-K15)
     must rise, frames 0-1 must equal the CPU run's, every frame's two
     lookahead sums must equal their plain versions', and the phase
     reports fps, the median encode(), a P frame's host CABAC, the
     profiler's device split and the host's wait on the lookahead per
     frame.
  8. bench.py's main path (bench.py:59-91): x264_tpu's defaults at CQP
     26 with keyint 250 (the 8x8 transform with I8x8 in the IDRs, subme 6
     with psy-RD 1.0 and the RD transform choice, scenecut 40,
     keyint_min 25, ref 1, no B frames), nothing else set, on phase 7's
     32 frames. Every kernel's launch count must rise, frames 0-2 must
     equal the CPU run's, the IDRs must fall at frames 0 and 26 only, and
     the IDRs must hold I8x8 MBs and the P frames 8x8-transform MBs; the
     phase reports fps, the median encode(), a P frame's host CABAC, the
     profiler's device split and the idle share.
Phase 3 also holds K13 (rd_inter) and K7 with the RD decision exact at
1080p, on frame 1 against frame 0's recon and against the 30%-gray
reference, K14 / K15 on a pair of frames of one scene and on a pair
across the cut, and the 8x8 transform: K1 with I8x8 and K3 / K2 on its
output on a frame that I8x8 fits, and K6 (the SA8D and the RD choice),
K13, K8 and K2 with t8 on frame 1 against frame 0's recon and against
the 30%-gray reference. The line before the last is the JSON `kernels`
record (the 8x8 variants as records of their own, each counting the
launches that took its branch); the last line is
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
N_INTRA = 4                    # frames of the all-intra main path
N_IPPP = 8                     # frames of the IPPP path at subme 1
N_SUBPEL = 8                   # frames of the IPPP path at subme 5
N_RD = 32                      # frames of the subme-6 + scenecut path
N_BENCH = 32                   # frames of bench.py's main path (phase 8)
CUT = 26                       # its first frame of the second picture
N_CHECK = 3                    # frames of phase 8 held against the CPU
N_CHECK_EARLY = 2              # and of phases 5-7 (IDR, P)
SUBME = 5
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
# K5: |a - b| and the sum, 3 ops per sample of every SAD it takes; K6 per
# MB: the chroma 1/8-pel filter (128 samples x 12 ops) and 24 blocks of
# DCT, quant, decimate score, dequant, IDCT and recon (~350 ops each);
# K7 per MB and sweep: 4 I16 + 2x4x4 chroma SATD blocks, the two
# predictions and 24 blocks of transforms (sweep 0 runs every MB, sweeps
# 1 and 2 only the intra ones)
K5_OPS_PER_SAMPLE = 3
K6_OPS_PER_MB = 10_000
K7_OPS_PER_MB_SWEEP = 25_000
# K9 per output sample: the h, v and c 6-tap filters with their rounding
# and clips, and the vertical taps of the apron (~40 ops); K10 per
# candidate and 4x4 block: 16 two-plane averages, the difference, the
# Hadamard and its abs-sum (~190 ops); K11 per MB: 49 offsets x 256
# samples of |a - b| and the sums; K12 per MB: the four luma and five
# chroma fetches and 5 x 24 4x4 SATD blocks; K6 at subme >= 2 adds the
# partition lookup and the two-plane average to each luma sample
K9_OPS_PER_SAMPLE = 40
K10_OPS_PER_CAND_4X4 = 190
K11_OPS_PER_MB = 49 * 256 * 3
K12_OPS_PER_MB = 4 * 256 * 10 + 5 * 128 * 12 + 5 * 24 * 150
K6_SUBPEL_OPS_PER_MB = K6_OPS_PER_MB + 256 * 12
# K13 per MB: 26 level walks of up to 16 steps (~12 ops each), the 384
# samples' SSD terms and pixel sums, 32 4x4 Hadamards for the psy energy;
# K7 under RD adds 27 walks, the SSDs and 16 Hadamards to sweep 0's MBs;
# K14 per output sample: four loads, the clamps and the rounded mean;
# K15 per 8x8 block: (2r+1)^2 candidates of 64 |a - b| sums (3 ops a
# sample), 9 + 3 8x8 SATDs (~520 ops each) and the staging
K13_OPS_PER_MB = 26 * 16 * 12 + 384 * 5 + 32 * 130
K7_RD_OPS_PER_MB = 27 * 16 * 12 + 384 * 5 + 16 * 130
K14_OPS_PER_SAMPLE = 12
# the 8x8 transform: K1's I8x8 ladder per MB adds 4 blocks of the edge
# filter, 9 modes x (64 gathered predictions + an 8x8 Hadamard, ~960
# ops) and the 8x8 DCT / quant / dequant / IDCT / recon (~2,000 ops); K6
# per MB adds 4 such 8x8 residuals with decimation (~2,300 ops each) and
# the SA8D / SATD of the choice; K13 per MB adds 4 walks of 64 steps,
# the 8x8 recon's SSD and 16 Hadamards
K1_I8X8_OPS_PER_MB = K1_OPS_PER_MB + 4 * (9 * 960 + 2_000 + 50)
K6_T8_OPS_PER_MB = K6_SUBPEL_OPS_PER_MB + 4 * 2_300 + 4 * 450 + 16 * 130
K13_T8_OPS_PER_MB = K13_OPS_PER_MB + 4 * 64 * 12 + 256 * 3 + 16 * 130
K15_OPS_PER_CAND_SAMPLE = 3
K15_OPS_PER_BLOCK = 12 * 520 + 2_000


T0 = time.perf_counter()


def stamp(what: str) -> None:
    """One line with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_frames(w: int, h: int, n: int, frame_cls, seed: int = 0,
                base=None):
    """bench.py's synthetic source: static texture + noise, global pan;
    base: another static texture than bench.py's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if base is None:
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


def cut_frames(w: int, h: int, n: int, frame_cls):
    """The phase-7 source: make_frames' first CUT frames, then a second
    picture from seed 1 over a smooth texture of its own (a slow diagonal
    ramp), cheap to intra-code and far from the first, panning the same
    way."""
    yy, xx = np.mgrid[0:h, 0:w]
    second = make_frames(w, h, n, frame_cls, seed=1,
                         base=(40 + xx // 12 + yy // 9).astype(np.int32))
    return make_frames(w, h, n, frame_cls)[:CUT] + second[CUT:]


def blocky_frame(w: int, h: int, frame_cls, seed: int = 3):
    """A picture that I8x8 fits (as tests/test_i8x8.py builds them):
    directional gradients under 8x8-blocky low-frequency noise, detail
    enough to beat I16, smooth enough that 8x8 beats 4x4."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy * 2 + xx * 3) // 2) % 256
    low = rng.integers(-20, 20, (h // 8 + 1, w // 8 + 1))
    y = (base + np.kron(low, np.ones((8, 8), np.int64))[:h, :w]) \
        .clip(0, 255).astype(np.uint8)
    u = (128 + xx[::2, ::2] // 4).clip(0, 255).astype(np.uint8)
    v = (128 - yy[::2, ::2] // 4).clip(0, 255).astype(np.uint8)
    return frame_cls(y, u, v)


def bench_params(EncoderParams, frame_parallel: int = 3):
    """bench.py's main path (bench.py:59-91): x264_tpu's defaults with
    CQP 26 and keyint 250, nothing else set (the 8x8 transform with
    I8x8, subme 6 with psy-RD 1.0, scenecut 40, keyint_min 25, ref 1, no
    B frames)."""
    p = EncoderParams(i_width=W, i_height=H, i_keyint_max=250,
                      i_log_level=0, i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = QP
    return p


def params(EncoderParams, frame_parallel: int, keyint: int = 1,
           subme: int = 1, scenecut: int = 0):
    """All-intra at keyint 1; else the IPPP slice: one reference, no B
    frames, at `subme` (the default partitions, chroma ME and, at subme
    6, the RD ladder with psy-RD), with a fixed GOP (scenecut 0) or the
    scenecut lookahead at keyint_min 25."""
    p = EncoderParams(i_width=W, i_height=H, i_keyint_max=keyint,
                      i_log_level=0, i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = QP
    p.analyse.b_transform_8x8 = False
    if keyint > 1:
        p.i_scenecut_threshold = scenecut
        p.i_keyint_min = 25
        p.analyse.i_subpel_refine = subme
        p.i_frame_reference = 1
        p.i_bframe = 0
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


def counted(fn, *args):
    """fn(*args) and the launches its wrapper counted in that call."""
    n0 = fn.launches
    out = fn(*args)
    return out, fn.launches - n0


def drive(enc, frames):
    """Encode frames through enc and flush; returns (encoded frames, wall
    seconds, per-call encode() ms)."""
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
    return done, time.perf_counter() - t_start, call_ms


def same_as_cpu(x264_tpu_torch, done, frames, header, n: int, keyint: int,
                what: str, subme: int = 1, scenecut: int = 0,
                make=None) -> None:
    """The first n frames of a card run against Encoder(device="cpu");
    make(EncoderParams, frame_parallel) builds other parameters than
    params()."""
    stamp(f"{what}: the CPU run")
    p = make(x264_tpu_torch.EncoderParams, 1) if make else \
        params(x264_tpu_torch.EncoderParams, 1, keyint, subme, scenecut)
    cpu = x264_tpu_torch.Encoder(p, device="cpu")
    if cpu.headers() != header:
        fail(f"{what}: headers differ between the card and the CPU")
    for i in range(n):
        ref = cpu.encode(frames[i])
        if ref.frame_type != done[i].frame_type:
            fail(f"{what}: frame {i} is {done[i].frame_type} on the card, "
                 f"{ref.frame_type} on the CPU")
        if ref.payload != done[i].payload:
            fail(f"{what}: frame {i} payload differs from the CPU run")
        for pl in "yuv":
            if not torch.equal(getattr(ref.recon, pl),
                               getattr(done[i].recon, pl).cpu()):
                fail(f"{what}: frame {i} recon {pl} differs from the CPU run")
    print(f"{what}: frames 0-{n - 1} payloads and recons equal the CPU run",
          flush=True)


def partition_warp(ref, mb_h: int, mb_w: int, seed: int = 1):
    """A second reference built from `ref` (y, u, v tensors): each MB
    takes a random partition layout (16x16, 16x8, 8x16, 8x8) and each
    partition its own displacement in -3..3 (chroma half of it); 30% of
    the 64x64 tiles take a horizontal half-pel average. Returns int32
    tensors on ref's device."""
    rng = np.random.default_rng(seed)
    y, u, v = (t.cpu().numpy().astype(np.int64) for t in ref)
    kind = rng.integers(0, 4, (mb_h, mb_w))[..., None, None, None]
    d = rng.integers(-3, 4, (mb_h, mb_w, 2, 2, 2))      # MB, qy, qx, (y, x)
    d = np.where(kind == 0, d[:, :, :1, :1], np.where(
        kind == 1, d[:, :, :, :1], np.where(kind == 2, d[:, :, :1, :], d)))
    d8 = d.transpose(0, 2, 1, 3, 4).reshape(mb_h * 2, mb_w * 2, 2)
    half = rng.random(((mb_h + 3) // 4, (mb_w + 3) // 4)) < 0.3

    def warp(p, n, dd):
        h, w = p.shape
        dp = dd.repeat(n, 0).repeat(n, 1)
        yy, xx = np.mgrid[0:h, 0:w]
        ys = np.clip(yy + dp[..., 0], 0, h - 1)
        xs = np.clip(xx + dp[..., 1], 0, w - 1)
        hm = half.repeat(8 * n, 0).repeat(8 * n, 1)[:h, :w]
        return np.where(hm, (p[ys, xs] + p[ys, np.clip(xs + 1, 0, w - 1)]
                             + 1) >> 1, p[ys, xs])

    dev = ref[0].device
    out = (warp(y, 8, d8), warp(u, 4, d8 // 2), warp(v, 4, d8 // 2))
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in out)


# kernel name fragment -> the port's kernel it belongs to (device time
# of everything else is PyTorch's own glue: padding, copies, merges)
KERNEL_GROUPS = (("intra_diag_kernel", "K1"), ("deblock_diag_kernel", "K2"),
                 ("p_emit_kernel", "K8"), ("p_maps_kernel", "K8"),
                 ("emit_kernel", "K3"), ("scan_kernel", "K3/K8 scan"),
                 ("scatter_kernel", "K3/K8 scatter"), ("ssd_kernel", "K4"),
                 ("ssim_kernel", "K4"), ("reduce_kernel", "K4"),
                 ("half_kernel", "K5"), ("search_kernel", "K5"),
                 ("p_inter_mb_kernel", "K6"), ("sweep_kernel", "K7"),
                 ("decide_kernel", "K7"), ("hpel_kernel", "K9"),
                 ("subpel_kernel", "K10"), ("part_kernel", "K11"),
                 ("rerank_kernel", "K12"), ("rd_inter_kernel", "K13"),
                 ("lowres_kernel", "K14"), ("cost_kernel", "K15"))


def device_split(x264_tpu_torch, frames, n_warm: int, n: int,
                 subme: int, scenecut: int = 0, make=None) -> None:
    """Device time by kernel over n steady IPPP frames, from a
    torch.profiler trace of the card (CUPTI sees the ctypes launches
    too): per frame, each kernel's share, PyTorch's glue, the busy sum
    and the host wall; the idle share is 1 - busy / wall. make: as in
    same_as_cpu."""
    from torch.profiler import ProfilerActivity, profile
    enc = x264_tpu_torch.Encoder(
        make(x264_tpu_torch.EncoderParams, 3) if make else
        params(x264_tpu_torch.EncoderParams, 3, 250, subme, scenecut))
    enc.headers()
    for f in frames[:n_warm]:
        enc.encode(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for f in frames[n_warm:n_warm + n]:
            enc.encode(f)
        enc.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    enc.close()
    by = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((g for frag, g in KERNEL_GROUPS if frag in e.name),
                    "torch glue" if "emcpy" not in e.name
                    else "memcpy")
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by:
        print("device split: not measured (the trace holds no device "
              "events)", flush=True)
        return
    busy = sum(by.values())
    parts = ", ".join(f"{k} {v / n:.3f}" for k, v in sorted(by.items()))
    tag = "bench.py's defaults" if make else \
        f"subme {subme} scenecut {scenecut}"
    print(f"device split at {tag} over {n} "
          f"frames (profiled; the "
          f"{len(frames[:n_warm])} frames before are not in it, the flush "
          f"is): per frame ms "
          f"{parts}; busy {busy / n:.3f} ms of {wall / n:.3f} ms wall, "
          f"idle share {1 - busy / wall:.3f}", flush=True)


def ippp_report(done, summary, st, fps, med, n: int, subme: int,
                smi_line: str, nmb: int, extra: str = "",
                idrs=(0,)) -> None:
    """Check an IPPP run's frame types (IDRs at `idrs` only) and print its
    end-to-end line."""
    types = [e.frame_type for e in done]
    if types != ["IDR" if i in idrs else "P" for i in range(n)]:
        fail(f"IPPP subme {subme} frame types {types}")
    p_bytes = [len(e.payload) for i, e in enumerate(done) if i not in idrs]
    n_p = n - len(idrs)             # the IDRs' MBs are all intra
    p_intra = (st.mb_intra - len(idrs) * nmb) / n_p
    p_skip = st.mb_skip / n_p
    print(f"IPPP path: {n} frames {W}x{H} keyint 250 subme {subme} ref 1 "
          f"CQP {QP} CABAC, {fps:.3f} fps, median encode() {med:.1f} ms, "
          f"IDR {len(done[0].payload)} bytes, P {statistics.mean(p_bytes):.0f}"
          f" bytes/frame (min {min(p_bytes)}, max {max(p_bytes)}; frames "
          f"1-7 {statistics.mean(p_bytes[:7]):.0f}), per P "
          f"frame {p_intra:.1f} intra and {p_skip:.1f} skip MBs of {nmb}, "
          f"PSNR Y "
          f"{summary['psnr']['y']:.4f} avg {summary['psnr']['avg']:.4f} dB "
          f"(P Y {summary['psnr_by_type']['P']['y']:.4f}), SSIM "
          f"{summary['ssim_y']:.6f}{extra} [{smi_line}]", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    import x264_tpu_torch
    from x264_tpu_torch import cuda, native, tables
    from x264_tpu_torch.encoder import inter, intra, lookahead, pipeline
    from x264_tpu_torch.encoder import ratecontrol, stats
    from x264_tpu_torch.encoder.core import pad_plane
    from x264_tpu_torch.entropy import cabac as ecabac
    from x264_tpu_torch.entropy import cabac_planes
    from x264_tpu_torch.entropy import cabac_tables as ctab
    from x264_tpu_torch.ops import deblock, mc, me

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
    stamp("build")
    t0 = time.perf_counter()
    t_nvcc = cuda.build()
    if native.load() is None:
        fail("the host CABAC engine (native/cabac.c) did not build")
    print(f"build: nvcc {t_nvcc:.2f} s for {len(cuda.SOURCES)} sources, "
          f"total {time.perf_counter() - t0:.2f} s", flush=True)

    # ------------------------------------------------------- 3. kernels
    stamp("phase 3: the kernels")
    frames = make_frames(W, H, max(N_IPPP, N_SUBPEL), x264_tpu_torch.Frame)
    mb_h, mb_w = (H + 15) // 16, W // 16
    nmb = mb_h * mb_w

    def frame_planes(f):
        return tuple(torch.as_tensor(pad_plane(a, mb_h * s, mb_w * s),
                                     device=dev).to(torch.int32)
                     for a, s in ((f.y, 16), (f.u, 8), (f.v, 8)))

    y, u, v = frame_planes(frames[0])
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

    # K5-K8 and K2 with P maps: frame 1 against frame 0's deblocked recon
    # (p2, the plain deblock of K1's recon: the IDR's DPB entry)
    qtab_p = inter.make_qtab_p(QP, tables.chroma_qp(QP, 0), dev)
    y1, u1, v1 = frame_planes(frames[1])
    mvp0 = torch.zeros((mb_h, mb_w, 2), dtype=torch.int32, device=dev)
    me_range = 16
    p_ms = {}

    def p_kernels(ref, tag: str, time_it: bool):
        """K5 -> K6 -> K7 -> K8 (-> K2) on frame 1 against `ref`, each
        held against its plain version on the same inputs."""
        ref_pad = mc.pad_plane(ref[0])
        refu_pad = mc.pad_plane(ref[1], mc.PAD // 2)
        refv_pad = mc.pad_plane(ref[2], mc.PAD // 2)
        # K5 me_hier
        a5 = (y1, ref_pad, mb_h, mb_w, me_range, lam, mvp0)
        (mv, sad), n5 = counted(me.hier_search, *a5)
        pm, ps = me.hier_search_plain(*a5)
        err5 = max_err({"mv": mv, "sad": sad}, {"mv": pm, "sad": ps})
        if err5:
            fail(f"K5 me_hier ({tag}) differs from its plain version")
        # K6 p_inter_mb at full-pel MVs: one plane, ptype 0
        ptype0 = torch.zeros((mb_h, mb_w), dtype=torch.int32, device=dev)
        mvq = mv[:, :, None].expand(mb_h, mb_w, 4, 2).contiguous()
        a6 = (mb_h, mb_w, y1, u1, v1, ref_pad[None], refu_pad, refv_pad,
              ptype0, mvq, qtab_p, True)
        k6, n6 = counted(inter.p_inter_mb, *a6)
        p6 = inter.p_inter_mb_plain(*a6)
        err6 = max_err(k6, p6)
        if err6:
            bad = [k for k in p6 if not torch.equal(k6[k], p6[k])]
            fail(f"K6 p_inter_mb ({tag}) differs in {bad}")
        cost = sad + lam * (me.mv_cost_bits(mv, mvp0) + 1)
        # K7 intra_in_p
        a7 = (mb_h, mb_w, y1, u1, v1, k6["recon_y"], k6["recon_u"],
              k6["recon_v"], cost, qtab_p, lam, True)
        k7, n7 = counted(inter.intra_in_p, *a7)
        # the plain version, with the sweep-0 intra wishes it demotes from
        chosen, resolve = [], inter.resolve_intra
        inter.resolve_intra = lambda c: chosen.append(c) or resolve(c)
        p7 = inter.intra_in_p_plain(*a7)
        inter.resolve_intra = resolve
        demoted = int((chosen[0] & ~p7["intra_mb"]).sum())
        err7 = max_err(k7, p7)
        if err7:
            bad = [k for k in p7 if not torch.equal(k7[k], p7[k])]
            fail(f"K7 intra_in_p ({tag}) differs in {bad}")
        # K8 cabac_p_ops on the merged planes of stages 1-3
        front = inter.encode_p_front(mb_h, mb_w, me_range, y1, u1, v1, *ref,
                                     qtab_p, lam, mvp0, True)
        (maps, ops8, n8k), n8 = counted(cabac_planes.cabac_p_ops, front,
                                        mb_h, mb_w)
        pmaps, pops8, pn8 = cabac_planes.cabac_p_ops_plain(front, mb_h, mb_w)
        n_ops8 = int(pn8)
        if int(n8k) != n_ops8:
            fail(f"K8 cabac_p_ops ({tag}) counts {int(n8k)} ops, its plain "
                 f"version {n_ops8}")
        err8 = max(max_err(maps, pmaps), int(
            (ops8[:n_ops8].long() - pops8[:n_ops8].long()).abs().max()))
        if err8:
            fail(f"K8 cabac_p_ops ({tag}) differs from its plain version")
        n_intra = int(front["intra_mb"].sum())
        print(f"P kernels ({tag}): exact; {n_intra} intra ({demoted} more "
              f"demoted) and {int(maps['skip'].sum())} skip MBs of {nmb}, "
              f"{n_ops8} ops; launches per frame K5 {n5}, K6 {n6}, K7 {n7}, "
              f"K8 {n8}", flush=True)
        if not time_it:
            return n_intra, demoted
        # K2 with the P maps of frame 1
        qp_mb1 = torch.full((mb_h, mb_w), QP, dtype=torch.int32, device=dev)
        maps2 = (qp_mb1, front["intra_mb"], maps["nnz4"], maps["ref4"],
                 maps["mv4"], z4, zmv, False, 0, 0, 0)
        src2 = (front["recon_y"], front["recon_u"], front["recon_v"])
        work2 = []

        def fresh2():
            work2[:] = [t.clone() for t in src2]

        fresh2()
        p2p = dict(zip("yuv", deblock.deblock_frame_plain(mb_h, mb_w, *work2,
                                                          *maps2)))
        k2p = dict(zip("yuv", deblock.deblock_frame(mb_h, mb_w, *work2,
                                                    *maps2)))
        if max_err(k2p, p2p):
            fail("K2 deblock_diag with P maps differs from its plain version")
        ms2p = event_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work2,
                                                      *maps2), 5, setup=fresh2)
        print(f"kernel deblock_diag with P maps: {ms2p:.3f} ms, exact",
              flush=True)
        # times, bounds
        ms5 = event_ms(lambda: me.hier_search(*a5), 10)
        pl5 = event_ms(lambda: me.hier_search_plain(*a5), 1)
        rq = me.coarse_range(me_range)
        Hq, Wq = mb_h * 8, mb_w * 8
        ops5 = K5_OPS_PER_SAMPLE * ((2 * rq + 1) ** 2 * Hq * Wq
                                    + 83 * 256 * nmb) + 8 * Hq * Wq
        record("me_hier", "cuda", "x264_tpu_torch/csrc/me.cu",
               "x264_tpu/ops/me.py:127", err5, ms5, pl5,
               nbytes(y1, ref_pad, mvp0, mv, sad), ops5)
        ms6 = event_ms(lambda: inter.p_inter_mb(*a6), 10)
        ms7 = event_ms(lambda: inter.intra_in_p(*a7), 10)
        pl7 = event_ms(lambda: inter.intra_in_p_plain(*a7), 1)
        record("intra_in_p", "cuda", "x264_tpu_torch/csrc/intra_p.cu",
               "x264_tpu/encoder/inter.py:596", err7, ms7, pl7,
               nbytes(y1, u1, v1, k6["recon_y"], k6["recon_u"],
                      k6["recon_v"], cost, *k7.values()),
               K7_OPS_PER_MB_SWEEP * (nmb + 2 * n_intra))
        ms8 = event_ms(lambda: cabac_planes.cabac_p_ops(front, mb_h, mb_w), 20)
        print(f"subme 1 P kernels: K6 p_inter_mb {ms6:.3f} ms, K8 "
              f"cabac_p_ops {ms8:.3f} ms (their records are taken at "
              f"subme {SUBME} below)", flush=True)
        p_ms.update(k5=ms5, k6=ms6, k7=ms7, k8=ms8, k2=ms2p, ops=ops8,
                    n_ops=n_ops8)
        return n_intra, demoted

    p_kernels((ry, ru, rv), "frame 1 on frame 0", True)
    # 64x64 gray blocks: the search cannot leave their interior, so those
    # MBs go intra in clusters whose chains run deeper than three sweeps
    gray = np.random.default_rng(0).random(((mb_h + 3) // 4,
                                            (mb_w + 3) // 4)) < 0.3
    gray = torch.as_tensor(gray.repeat(4, 0).repeat(4, 1)[:mb_h, :mb_w],
                           device=dev)
    mixed = tuple(torch.where(gray.repeat_interleave(n, 0)
                              .repeat_interleave(n, 1), 128, t)
                  for t, n in ((ry, 16), (ru, 8), (rv, 8)))
    n_mix, demoted = p_kernels(mixed, "frame 1 on frame 0 with 30% of its "
                               "64x64 blocks gray", False)
    if n_mix < nmb // 50 or demoted == 0:
        fail(f"the gray-masked reference sent {n_mix} MBs intra and "
             f"demoted {demoted}: the intra-heavy case did not run")

    # one P frame's split: kernels (K4 as on the IDR), d2h, host CABAC
    ops_p = p_ms["ops"]
    ops_ph = torch.empty(ops_p.shape, dtype=torch.int32, pin_memory=True)
    d2h_p = event_ms(lambda: ops_ph.copy_(ops_p, non_blocking=True), 5)
    live_p = ops_ph.numpy()[:p_ms["n_ops"]].view(np.uint32)
    t = time.perf_counter()
    payload_p, _ = ecabac.encode_ops(ctab.init_states(False, QP, 0), live_p, 0)
    cabac_p = (time.perf_counter() - t) * 1e3
    dev_p = sum(p_ms[k] for k in ("k5", "k6", "k7", "k8", "k2")) + ms4
    print(f"P frame split: kernels {dev_p:.3f} ms (K5 {p_ms['k5']:.3f}, K6 "
          f"{p_ms['k6']:.3f}, K7 {p_ms['k7']:.3f}, K8 {p_ms['k8']:.3f}, K2 "
          f"{p_ms['k2']:.3f}, K4 {ms4:.3f}), d2h of {nbytes(ops_p)} bytes "
          f"{d2h_p:.3f} ms, host CABAC of {p_ms['n_ops']} ops into "
          f"{len(payload_p)} bytes {cabac_p:.3f} ms", flush=True)

    # K9-K12 and the partitioned K6 / K8 / K2: frame 1 against a second
    # reference whose partitions move apart (partition_warp)
    ref2 = partition_warp((ry, ru, rv), mb_h, mb_w)
    ref_pad2 = mc.pad_plane(ref2[0])
    refu2, refv2 = (mc.pad_plane(t, mc.PAD // 2) for t in ref2[1:])
    mv_fp, _ = me.hier_search(y1, ref_pad2, mb_h, mb_w, me_range, lam, mvp0)
    torch.cuda.synchronize()

    def exact(name, k, p):
        err = max_err(k, p) if isinstance(p, dict) else max(
            int((a.long() - b.long()).abs().max()) for a, b in zip(k, p))
        if err:
            fail(f"{name} differs from its plain version")
        return err

    planes, n9 = counted(mc.hpel_planes, ref_pad2)
    err9 = exact("K9 hpel_planes", [planes], [mc.hpel_planes_plain(ref_pad2)])
    ms9 = event_ms(lambda: mc.hpel_planes(ref_pad2), 10)
    pl9 = event_ms(lambda: mc.hpel_planes_plain(ref_pad2), 1)
    hp_, wp_ = ref_pad2.shape
    record("hpel_planes", "cuda", "x264_tpu_torch/csrc/mc.cu",
           "x264_tpu/ops/mc.py:57", err9, ms9, pl9,
           nbytes(ref_pad2, planes), K9_OPS_PER_SAMPLE * hp_ * wp_)
    # K10 on the 16x16 MBs at both ladders, then on each partition layout
    ys16, xs16 = me.mb_origins(mb_h, mb_w, dev)
    calls10, err10 = [], 0
    for steps in ((2,), (2, 1)):
        a10 = (y1, planes, mv_fp, lam, mvp0, ys16, xs16, 16, 16, steps)
        k10 = me.subpel_refine_blocks(*a10)
        err10 = max(err10, exact(f"K10 subpel_refine 16x16 {steps}", k10,
                                 me.subpel_refine_blocks_plain(*a10)))
    calls10.append((a10, 49 * 16 * nmb))
    mv_s, satd_s = k10
    pf = me.partition_fullpel(y1, ref_pad2, mv_fp, lam, mvp0, me_range, True)
    for bh, bw, offs, (a, b) in inter.PART_LAYOUTS:
        ysb, xsb = inter._block_origins(mb_h, mb_w, offs, dev)
        mvpb = mvp0.expand(len(offs), mb_h, mb_w, 2).contiguous()
        a10 = (y1, planes, pf[a:b].contiguous(), lam, mvpb, ysb, xsb, bh, bw,
               (2, 1))
        err10 = max(err10, exact(f"K10 subpel_refine {bh}x{bw}",
                                 me.subpel_refine_blocks(*a10),
                                 me.subpel_refine_blocks_plain(*a10)))
        calls10.append((a10, 49 * (bh * bw // 16) * len(offs) * nmb))
    ms10 = [event_ms(lambda a=a: me.subpel_refine_blocks(*a), 10)
            for a, _ in calls10]
    pl10 = sum(event_ms(lambda a=a: me.subpel_refine_blocks_plain(*a), 1)
               for a, _ in calls10)
    print("kernel subpel_refine per call at (2, 1): " + ", ".join(
        f"{a[7]}x{a[8]} {t:.3f} ms" for (a, _), t in zip(calls10, ms10)),
        flush=True)
    record("subpel_refine", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:217", err10, sum(ms10), pl10,
           sum(nbytes(*a[:3], a[4], a[5], a[6]) + 12 * a[2][..., 0].numel()
               for a, _ in calls10),
           K10_OPS_PER_CAND_4X4 * sum(n for _, n in calls10))
    # K11
    a11 = (y1, ref_pad2, mv_fp, lam, mvp0, me_range, True)
    err11 = exact("K11 part_fullpel", [pf], [me.partition_fullpel_plain(*a11)])
    ms11 = event_ms(lambda: me.partition_fullpel(*a11), 10)
    pl11 = event_ms(lambda: me.partition_fullpel_plain(*a11), 1)
    record("part_fullpel", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:304", err11, ms11, pl11,
           nbytes(y1, ref_pad2, mv_fp, mvp0, pf), K11_OPS_PER_MB * nmb)
    # K12
    a12 = (y1, planes, u1, v1, refu2, refv2, mv_s, lam, mvp0, satd_s)
    k12 = me.chroma_rerank(*a12)
    err12 = exact("K12 chroma_rerank", k12, me.chroma_rerank_plain(*a12))
    ms12 = event_ms(lambda: me.chroma_rerank(*a12), 10)
    pl12 = event_ms(lambda: me.chroma_rerank_plain(*a12), 1)
    record("chroma_rerank", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:368", err12, ms12, pl12,
           nbytes(y1, planes, u1, v1, refu2, refv2, mv_s, mvp0, satd_s,
                  *k12), K12_OPS_PER_MB * nmb)
    print(f"chroma_rerank moved {int((k12[0] != mv_s).any(-1).sum())} of "
          f"{nmb} MVs", flush=True)
    # the stages 1-3 at subme 5 through the kernels, then K6, K8 and K2
    # on its partitions against their plain versions
    front5 = inter.encode_p_front(mb_h, mb_w, me_range, y1, u1, v1, *ref2,
                                  qtab_p, lam, mvp0, True, (2, 1), True,
                                  True, True)
    im5 = front5["intra_mb"]
    hist = torch.bincount(front5["ptype"][~im5], minlength=4).tolist()
    frac = float(((front5["mv_quad"] & 3) != 0).any(-1)[~im5].float().mean())
    print(f"partitioned P frame: ptype histogram {hist} of "
          f"{int((~im5).sum())} inter MBs ({int(im5.sum())} intra); "
          f"{frac:.3f} of inter quadrants have a fractional MV", flush=True)
    if min(hist) == 0 or frac == 0:
        fail(f"the partition reference did not exercise every ptype "
             f"({hist}) and fractional MVs ({frac})")
    a6 = (mb_h, mb_w, y1, u1, v1, planes, refu2, refv2, front5["ptype"],
          front5["mv_quad"], qtab_p, True)
    k6 = inter.p_inter_mb(*a6)
    err6 = exact("K6 p_inter_mb with partitions", k6,
                 inter.p_inter_mb_plain(*a6))
    ms6 = event_ms(lambda: inter.p_inter_mb(*a6), 10)
    pl6 = event_ms(lambda: inter.p_inter_mb_plain(*a6), 1)
    record("p_inter_mb", "cuda", "x264_tpu_torch/csrc/inter.cu",
           "x264_tpu/encoder/inter.py:81", err6, ms6, pl6,
           nbytes(y1, u1, v1, planes, refu2, refv2, front5["ptype"],
                  front5["mv_quad"], *k6.values()),
           K6_SUBPEL_OPS_PER_MB * nmb)
    maps5, ops5, n5k = cabac_planes.cabac_p_ops(front5, mb_h, mb_w)
    pmaps5, pops5, pn5 = cabac_planes.cabac_p_ops_plain(front5, mb_h, mb_w)
    n_ops5 = int(pn5)
    if int(n5k) != n_ops5:
        fail(f"K8 cabac_p_ops with partitions counts {int(n5k)} ops, its "
             f"plain version {n_ops5}")
    err8 = max(exact("K8 cabac_p_ops maps with partitions", maps5, pmaps5),
               exact("K8 cabac_p_ops ops with partitions", [ops5[:n_ops5]],
                     [pops5[:n_ops5]]))
    ms8 = event_ms(lambda: cabac_planes.cabac_p_ops(front5, mb_h, mb_w), 20)
    pl8 = event_ms(lambda: cabac_planes.cabac_p_ops_plain(front5, mb_h,
                                                          mb_w), 1)
    keys8 = ("intra_mb", "me_mv", "ptype", "mv_quad", "mode16", "modec",
             "cbp_luma_bits", "cbp_chroma", "luma_dc", "luma_blocks",
             "chroma_dc", "chroma_ac")
    record("cabac_p_ops", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/entropy/cabac_planes.py:518", err8, ms8, pl8,
           nbytes(*(front5[k] for k in keys8), *maps5.values())
           + 4 * n_ops5 + 4, K3_OPS_PER_OP * n_ops5 + K3_OPS_PER_MB * nmb)
    qp_mb5 = torch.full((mb_h, mb_w), QP, dtype=torch.int32, device=dev)
    maps2 = (qp_mb5, im5, maps5["nnz4"], maps5["ref4"], maps5["mv4"], z4,
             zmv, False, 0, 0, 0)
    src5 = (front5["recon_y"], front5["recon_u"], front5["recon_v"])
    k2p = dict(zip("yuv", deblock.deblock_frame(
        mb_h, mb_w, *[t.clone() for t in src5], *maps2)))
    exact("K2 deblock_diag with partition maps", k2p, dict(zip(
        "yuv", deblock.deblock_frame_plain(
            mb_h, mb_w, *[t.clone() for t in src5], *maps2))))
    print(f"partition kernels exact at {W}x{H}: K9-K12, K6, K8 ({n_ops5} "
          f"ops), K2 with partition maps; launches per call K9 {n9}",
          flush=True)
    # that P frame's split: kernels (K5, K7, K2 and K4 as timed above),
    # d2h, host CABAC of its op stream
    ops5_h = torch.empty(ops5.shape, dtype=torch.int32, pin_memory=True)
    d2h5 = event_ms(lambda: ops5_h.copy_(ops5, non_blocking=True), 5)
    t = time.perf_counter()
    payload5, _ = ecabac.encode_ops(ctab.init_states(False, QP, 0),
                                    ops5_h.numpy()[:n_ops5].view(np.uint32),
                                    0)
    cabac5 = (time.perf_counter() - t) * 1e3
    k_ms = dict(K5=p_ms["k5"], K9=ms9, K10=sum(ms10), K11=ms11, K12=ms12,
                K6=ms6, K7=p_ms["k7"], K8=ms8, K2=p_ms["k2"], K4=ms4)
    # the cell's own P frame at subme 5 (frame 1 on frame 0's recon): its
    # op stream and host CABAC, for the split of section 5
    front_c = inter.encode_p_front(mb_h, mb_w, me_range, y1, u1, v1, ry, ru,
                                   rv, qtab_p, lam, mvp0, True, (2, 1), True,
                                   True, True)
    _, ops_c, n_c = cabac_planes.cabac_p_ops(front_c, mb_h, mb_w)
    n_c = int(n_c)
    t = time.perf_counter()
    payload_c, _ = ecabac.encode_ops(ctab.init_states(False, QP, 0),
                                     ops_c[:n_c].cpu().numpy().view(np.uint32),
                                     0)
    cabac_c = (time.perf_counter() - t) * 1e3
    hist_c = torch.bincount(front_c["ptype"].reshape(-1), minlength=4)
    print(f"P frame at subme {SUBME} on frame 0's recon: host CABAC of "
          f"{n_c} ops into {len(payload_c)} bytes {cabac_c:.3f} ms; ptype "
          f"histogram {hist_c.tolist()}", flush=True)
    print(f"P frame split at subme {SUBME} (partition reference): kernels "
          f"{sum(k_ms.values()):.3f} ms ("
          + ", ".join(f"{k} {v:.3f}" for k, v in k_ms.items())
          + f"), d2h of {nbytes(ops5)} bytes {d2h5:.3f} ms, host CABAC of "
          f"{n_ops5} ops into {len(payload5)} bytes {cabac5:.3f} ms",
          flush=True)

    # K13 rd_inter and K7 with the RD decision (subme 6, psy-RD 1.0) on
    # frame 1 against frame 0's recon and against the gray-masked
    # reference; each kernel's arguments are those of encode_p_front's own
    # calls at subme 6
    qtab_rd = inter.make_qtab_p(QP, tables.chroma_qp(QP, 0), dev, rd_idc=0,
                                f_psy_rd=1.0)

    def spied_front(ref, qt, rd: bool, t8: bool, names):
        """encode_p_front at subme 6 (rd) or 5 on frame 1 against ref, with
        or without the 8x8 transform, and the arguments of its calls of
        the wrappers `names`."""
        seen, kept = {}, {n: getattr(inter, n) for n in names}

        def spy(name):
            def call(*a, **k):
                seen[name] = (a, k)
                return kept[name](*a, **k)
            # the wrapper counts on the name it is called by: the spy's
            call.__dict__.update(kept[name].__dict__)
            return call

        for n in kept:
            setattr(inter, n, spy(n))
        front = inter.encode_p_front(mb_h, mb_w, me_range, y1, u1, v1, *ref,
                                     qt, lam, mvp0, True, (2, 1), True,
                                     True, True, rd, t8)
        for n, f in kept.items():
            f.__dict__.update(getattr(inter, n).__dict__)
            setattr(inter, n, f)
        return front, seen

    rd_ms = {}
    for ref, tag in (((ry, ru, rv), "frame 1 on frame 0"),
                     (mixed, "frame 1 on the 30%-gray reference")):
        front6, seen = spied_front(ref, qtab_rd, True, False,
                                   ("rd_inter", "intra_in_p"))
        a13, a7 = seen["rd_inter"][0], seen["intra_in_p"][0]
        if len(a7) != 13 or a7[12] is None:
            fail("encode_p_front at subme 6 did not pass K7 the RD costs")
        k13, n13 = counted(inter.rd_inter, *a13)
        p13 = inter.rd_inter_plain(*a13)
        if not all(torch.equal(a, b) for a, b in zip(k13, p13)):
            fail(f"K13 rd_inter ({tag}) differs from its plain version")
        err13 = 0.0
        k7r, n7r = counted(inter.intra_in_p, *a7)
        err7r = exact(f"K7 intra_in_p with RD ({tag})", k7r,
                      inter.intra_in_p_plain(*a7))
        satd_im = inter.intra_in_p(*a7[:12])["intra_mb"]
        rd_im = k7r["intra_mb"]
        to_i, to_p = int((rd_im & ~satd_im).sum()), int((satd_im & ~rd_im).sum())
        print(f"RD kernels ({tag}): exact; {int(rd_im.sum())} intra MBs "
              f"under RD, {int(satd_im.sum())} under the SATD decision "
              f"({to_i} go intra and {to_p} inter by RD alone); launches "
              f"per frame K13 {n13}, K7 {n7r}", flush=True)
        if tag.startswith("frame 1 on frame 0"):
            rd_ms.update(
                k13=event_ms(lambda: inter.rd_inter(*a13), 10),
                pl13=event_ms(lambda: inter.rd_inter_plain(*a13), 1),
                k7=event_ms(lambda: inter.intra_in_p(*a7), 10),
                pl7=event_ms(lambda: inter.intra_in_p_plain(*a7), 1),
                a13=a13, a7=a7, k13_out=k13, k7_out=k7r, err13=err13,
                err7=err7r, front=front6)
        elif int(rd_im.sum()) < nmb // 50 or to_i + to_p == 0:
            fail(f"the gray-masked reference sent {int(rd_im.sum())} MBs "
                 f"intra under RD, {to_i + to_p} decided otherwise than by "
                 f"SATD: the RD decision did not run on many MBs")
    a13, a7 = rd_ms["a13"], rd_ms["a7"]
    it13 = a13[5]
    record("rd_inter", "cuda", "x264_tpu_torch/csrc/rdcost.cu",
           "x264_tpu/encoder/inter.py:498", rd_ms["err13"], rd_ms["k13"],
           rd_ms["pl13"],
           nbytes(*a13[2:5], *(it13[k] for k in (
               "recon_y", "recon_u", "recon_v", "blocks_z", "chroma_dc",
               "chroma_ac")), *a13[6:9], qtab_rd["rdtab"],
                  *rd_ms["k13_out"]), K13_OPS_PER_MB * nmb)
    n_intra_rd = int(rd_ms["k7_out"]["intra_mb"].sum())
    # K7's record: the RD decision of the main path; the SATD decision's
    # times (phase 3's subme-1 frame) beside it
    satd7 = rec["intra_in_p"]
    record("intra_in_p", "cuda", "x264_tpu_torch/csrc/intra_p.cu",
           "x264_tpu/encoder/inter.py:596", rd_ms["err7"], rd_ms["k7"],
           rd_ms["pl7"],
           nbytes(*a7[2:9], *a7[12], qtab_rd["rdtab"],
                  *rd_ms["k7_out"].values()),
           K7_OPS_PER_MB_SWEEP * (nmb + 2 * n_intra_rd)
           + K7_RD_OPS_PER_MB * nmb)
    rec["intra_in_p"].update(ms_satd=satd7["ms"],
                             plain_ms_satd=satd7["plain_ms"],
                             bound_ms_satd=satd7["bound_ms"])
    # the host CABAC of that P frame at subme 6 (frame 1 on frame 0)
    _, ops6, n6 = cabac_planes.cabac_p_ops(rd_ms["front"], mb_h, mb_w)
    n6 = int(n6)
    t = time.perf_counter()
    payload6, _ = ecabac.encode_ops(ctab.init_states(False, QP, 0),
                                    ops6[:n6].cpu().numpy().view(np.uint32), 0)
    cabac6 = (time.perf_counter() - t) * 1e3
    print(f"P frame at subme 6 on frame 0's recon: host CABAC of {n6} ops "
          f"into {len(payload6)} bytes {cabac6:.3f} ms; K13 "
          f"{rd_ms['k13']:.3f} ms, K7 with RD {rd_ms['k7']:.3f} ms "
          f"({n_intra_rd} intra MBs)", flush=True)

    # K14 lowres_planes and K15 lowres_cost: frame 0 -> frame 1 (one scene)
    # and the last frame of phase 7's first picture -> its second picture
    cut = cut_frames(W, H, N_RD, x264_tpu_torch.Frame)

    def luma(f):
        return torch.as_tensor(pad_plane(f.y, mb_h * 16, mb_w * 16),
                               device=dev).to(torch.int32)

    la_y = [luma(f) for f in (frames[0], frames[1], cut[CUT - 1], cut[CUT])]
    bh, bw = lookahead.block_grid(H, W)
    r_la = max(4, min(12, 16 // 2))         # the default i_me_range 16
    lows = []
    for yy in la_y:
        (k14, n14) = counted(lookahead.lowres_planes, yy, H, W)
        err14 = exact("K14 lowres_planes", [k14],
                      [lookahead.lowres_planes_plain(yy, H, W)])
        lows.append(k14)
    err15 = 0
    la_pairs = (((None, 0), "the first frame"), ((0, 1), "one scene"),
                ((2, 3), "across the cut"))
    for (a, b), tag in la_pairs:
        prev = None if a is None else lows[a]
        k15, n15 = counted(lookahead.lowres_cost, lows[b], prev, bh, bw, r_la)
        p15 = lookahead.lowres_cost_plain(lows[b], prev, bh, bw, r_la)
        err15 = max(err15, exact(f"K15 lowres_cost ({tag})",
                                 [t for t in k15 if t is not None],
                                 [t for t in p15 if t is not None]))
        isum, psum = k15[0].tolist()
        print(f"lookahead ({tag}): exact; icost {isum}, pcost {psum} "
              f"({psum / isum:.4f} of icost)", flush=True)
    ms14 = event_ms(lambda: lookahead.lowres_planes(la_y[0], H, W), 20)
    pl14 = event_ms(lambda: lookahead.lowres_planes_plain(la_y[0], H, W), 3)
    record("lowres_planes", "cuda", "x264_tpu_torch/csrc/lookahead.cu",
           "x264_tpu/encoder/lookahead.py:58", err14, ms14, pl14,
           4 * H * W + nbytes(lows[0]), K14_OPS_PER_SAMPLE * lows[0].numel())
    ms15 = event_ms(lambda: lookahead.lowres_cost(lows[1], lows[0], bh, bw,
                                                  r_la), 10)
    pl15 = event_ms(lambda: lookahead.lowres_cost_plain(lows[1], lows[0], bh,
                                                        bw, r_la), 1)
    record("lowres_cost", "cuda", "x264_tpu_torch/csrc/lookahead.cu",
           "x264_tpu/encoder/lookahead.py:216", err15, ms15, pl15,
           nbytes(lows[1][0], lows[0]) + 2 * 4 * bh * bw + 8,
           K15_OPS_PER_CAND_SAMPLE * (2 * r_la + 1) ** 2 * 64 * bh * bw
           + K15_OPS_PER_BLOCK * bh * bw)

    # ------------------------------------------------- the 8x8 transform
    stamp("phase 3: the 8x8 transform's kernels")
    # K1 with I8x8, and K3 / K2 on its output, on a frame that I8x8 fits
    yb, ub, vb = frame_planes(blocky_frame(W, H, x264_tpu_torch.Frame))
    a1b = (mb_h, mb_w, yb, ub, vb, qtab, lam, True)
    k1b = intra.encode_i16_frame(*a1b)
    torch.cuda.synchronize()
    p1b = {}
    pl1b = event_ms(lambda: p1b.update(intra.encode_i16_frame_plain(*a1b)), 1)
    err1b = exact("K1 intra_diag with I8x8", k1b, p1b)
    n_i8 = int(k1b["t8_mb"].sum())
    if n_i8 == 0:
        fail("the I8x8 frame sent no MB to I8x8")
    ms1b = event_ms(lambda: intra.encode_i16_frame(*a1b), 3)
    record("intra_diag_i8x8", "cuda", "x264_tpu_torch/csrc/intra.cu",
           "x264_tpu/encoder/intra.py:647", err1b, ms1b, pl1b,
           nbytes(yb, ub, vb) + nbytes(*k1b.values()),
           K1_I8X8_OPS_PER_MB * nmb)
    ms1_same = event_ms(lambda: intra.encode_i16_frame(*a1b[:-1]), 3)
    keys3b = ("mode16", "modec", "i4_mb", "i4_modes", "cbp_luma_bits",
              "luma_dc", "luma_ac", "chroma_dc", "chroma_ac", "t8_mb",
              "luma8_z")
    ops_b, nk_b = cabac_planes.i_slice_ops(k1b, mb_h, mb_w, True)
    pl3b = {}
    pl3b_ms = event_ms(lambda: pl3b.update(zip(("ops", "n"), (
        cabac_planes.i_slice_ops_plain(k1b, mb_h, mb_w, True)))), 1)
    n_ops_b = int(pl3b["n"])
    if int(nk_b) != n_ops_b:
        fail(f"K3 cabac_i_ops with I8x8 counts {int(nk_b)} ops, its plain "
             f"version {n_ops_b}")
    err3b = exact("K3 cabac_i_ops with I8x8", [ops_b[:n_ops_b]],
                  [pl3b["ops"][:n_ops_b]])
    ms3b = event_ms(lambda: cabac_planes.i_slice_ops(k1b, mb_h, mb_w, True),
                    20)
    record("cabac_i_ops_t8", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/entropy/cabac_planes.py:104", err3b, ms3b, pl3b_ms,
           nbytes(*(k1b[k] for k in keys3b)) + 4 * n_ops_b + 4,
           K3_OPS_PER_OP * n_ops_b + K3_OPS_PER_MB * nmb)
    maps_b = (qp_mb, intra_mb, z4, z4, zmv, z4, zmv, False, 0, 0, 0,
              k1b["t8_mb"])
    src_b = (k1b["recon_y"], k1b["recon_u"], k1b["recon_v"])
    work_b = []

    def fresh_b():
        work_b[:] = [t.clone() for t in src_b]

    fresh_b()
    p2b = {}
    pl2b = event_ms(lambda: p2b.update(zip("yuv", deblock.deblock_frame_plain(
        mb_h, mb_w, *work_b, *maps_b))), 1)
    fresh_b()
    k2b = dict(zip("yuv", deblock.deblock_frame(mb_h, mb_w, *work_b,
                                                *maps_b)))
    err2b = exact("K2 deblock_diag with an I8x8 map", k2b, p2b)
    ms2b = event_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work_b,
                                                  *maps_b), 5, setup=fresh_b)
    record("deblock_diag_t8", "cuda", "x264_tpu_torch/csrc/deblock.cu",
           "x264_tpu/ops/deblock.py:203", err2b, ms2b, pl2b,
           2 * nbytes(*src_b) + nbytes(qp_mb, intra_mb, z4, z4, zmv,
                                       k1b["t8_mb"]), K2_OPS_PER_MB * nmb)
    ops_bh = ops_b[:n_ops_b].cpu().numpy().view(np.uint32)
    t = time.perf_counter()
    payload_b, _ = ecabac.encode_ops(ctab.init_states(True, QP, 0), ops_bh, 0)
    cabac_b = (time.perf_counter() - t) * 1e3
    print(f"I8x8 frame: {n_i8} of {nmb} MBs take I8x8; K1 with I8x8 "
          f"{ms1b:.3f} ms ({len(intra.diagonals(mb_h, mb_w, True))} "
          f"launches), without {ms1_same:.3f} ms on the same frame; host "
          f"CABAC of {n_ops_b} ops into {len(payload_b)} bytes "
          f"{cabac_b:.3f} ms", flush=True)

    # K6 (the SA8D choice of subme 5, both codings at subme 6), K13 with
    # the RD choice, K8 and K2 with t8: frame 1 against frame 0's recon and
    # against the gray-masked reference, with the arguments of
    # encode_p_front's own calls
    t8_ms = {}
    for ref, tag in (((ry, ru, rv), "frame 1 on frame 0"),
                     (mixed, "frame 1 on the 30%-gray reference")):
        _, s5 = spied_front(ref, qtab_p, False, True, ("p_inter_mb",))
        a6s = s5["p_inter_mb"][0]
        k6s = inter.p_inter_mb(*a6s)
        err6s = exact(f"K6 p_inter_mb with the SA8D choice ({tag})", k6s,
                      inter.p_inter_mb_plain(*a6s))
        front8, s6 = spied_front(ref, qtab_rd, True, True,
                                 ("p_inter_mb", "rd_inter"))
        a6r, a13t = s6["p_inter_mb"][0], s6["rd_inter"][0]
        k6r = inter.p_inter_mb(*a6r)
        err6r = exact(f"K6 p_inter_mb with both codings ({tag})", k6r,
                      inter.p_inter_mb_plain(*a6r))
        k13t = inter.rd_inter(*a13t)
        p13t = inter.rd_inter_plain(*a13t)
        if not all(torch.equal(a, b) for a, b in zip(k13t[:2], p13t[:2])):
            fail(f"K13 rd_inter with t8 ({tag}) differs from its plain "
                 f"version")
        err13t = exact(f"K13 rd_inter's t8 choice ({tag})", k13t[2], p13t[2])
        maps8, ops8t, nk8 = cabac_planes.cabac_p_ops(front8, mb_h, mb_w,
                                                     t8_mode=True)
        pmaps8, pops8t, pn8 = cabac_planes.cabac_p_ops_plain(front8, mb_h,
                                                             mb_w, True)
        n_ops8t = int(pn8)
        if int(nk8) != n_ops8t:
            fail(f"K8 cabac_p_ops with t8 ({tag}) counts {int(nk8)} ops, "
                 f"its plain version {n_ops8t}")
        err8t = max(exact(f"K8 cabac_p_ops maps with t8 ({tag})", maps8,
                          pmaps8),
                    exact(f"K8 cabac_p_ops ops with t8 ({tag})",
                          [ops8t[:n_ops8t]], [pops8t[:n_ops8t]]))
        qp_mb8 = torch.full((mb_h, mb_w), QP, dtype=torch.int32, device=dev)
        maps2t = (qp_mb8, front8["intra_mb"], maps8["nnz4"], maps8["ref4"],
                  maps8["mv4"], z4, zmv, False, 0, 0, 0, maps8["t8_mb"])
        src8 = (front8["recon_y"], front8["recon_u"], front8["recon_v"])
        exact(f"K2 deblock_diag with t8 P maps ({tag})", dict(zip(
            "yuv", deblock.deblock_frame(mb_h, mb_w, *[t.clone() for t in src8],
                                         *maps2t))), dict(zip(
            "yuv", deblock.deblock_frame_plain(mb_h, mb_w, *src8, *maps2t))))
        n_sel5 = int(k6s["t8_sel"].sum())
        n_sel6 = int(k13t[2]["t8_sel"].sum())
        n_t8 = int(maps8["t8_mb"].sum())
        print(f"t8 kernels ({tag}): exact; the SA8D choice takes 8x8 in "
              f"{n_sel5} MBs, the RD choice in {n_sel6}, {n_t8} MBs coded "
              f"with it (t8_mb), {n_ops8t} ops", flush=True)
        if n_sel5 == 0 or n_sel6 == 0 or n_t8 == 0:
            fail(f"the 8x8 transform was not chosen ({tag}): SA8D {n_sel5}, "
                 f"RD {n_sel6}, coded {n_t8}")
        if t8_ms:
            continue
        t8_ms.update(
            k6s=event_ms(lambda: inter.p_inter_mb(*a6s), 10),
            pl6s=event_ms(lambda: inter.p_inter_mb_plain(*a6s), 1),
            k6r=event_ms(lambda: inter.p_inter_mb(*a6r), 10),
            pl6r=event_ms(lambda: inter.p_inter_mb_plain(*a6r), 1),
            k6o=event_ms(lambda: inter.p_inter_mb(*a6r[:-1]), 10),
            k13=event_ms(lambda: inter.rd_inter(*a13t), 10),
            pl13=event_ms(lambda: inter.rd_inter_plain(*a13t), 1),
            k8=event_ms(lambda: cabac_planes.cabac_p_ops(
                front8, mb_h, mb_w, t8_mode=True), 20),
            pl8=event_ms(lambda: cabac_planes.cabac_p_ops_plain(
                front8, mb_h, mb_w, True), 1))
        it_in = a13t[5]
        record("p_inter_mb_t8_sa8d", "cuda", "x264_tpu_torch/csrc/inter.cu",
               "x264_tpu/encoder/inter.py:163", err6s, t8_ms["k6s"],
               t8_ms["pl6s"], nbytes(*a6s[2:10], *k6s.values()),
               K6_T8_OPS_PER_MB * nmb)
        record("p_inter_mb_t8_rd", "cuda", "x264_tpu_torch/csrc/inter.cu",
               "x264_tpu/encoder/inter.py:163", err6r, t8_ms["k6r"],
               t8_ms["pl6r"], nbytes(*a6r[2:10], *k6r.values()),
               K6_T8_OPS_PER_MB * nmb)
        record("rd_inter_t8", "cuda", "x264_tpu_torch/csrc/rdcost.cu",
               "x264_tpu/encoder/inter.py:535", err13t, t8_ms["k13"],
               t8_ms["pl13"],
               nbytes(*a13t[2:5], *(it_in[k] for k in (
                   "recon_y", "recon_u", "recon_v", "blocks_z", "cbp",
                   "chroma_dc", "chroma_ac", "recon8_y", "blocks8_z",
                   "cbp8")), *a13t[6:9], qtab_rd["rdtab"], *k13t[:2],
                   *k13t[2].values()), K13_T8_OPS_PER_MB * nmb)
        record("cabac_p_ops_t8", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
               "x264_tpu/entropy/cabac_planes.py:759", err8t, t8_ms["k8"],
               t8_ms["pl8"],
               nbytes(*(front8[k] for k in keys8 + ("t8_sel", "luma8_z")),
                      *maps8.values()) + 4 * n_ops8t + 4,
               K3_OPS_PER_OP * n_ops8t + K3_OPS_PER_MB * nmb)
        live8 = ops8t[:n_ops8t].cpu().numpy().view(np.uint32)
        t = time.perf_counter()
        payload8, _ = ecabac.encode_ops(ctab.init_states(False, QP, 0),
                                        live8, 0)
        t8_ms["cabac"] = (time.perf_counter() - t) * 1e3
        print(f"P frame at bench.py's defaults on frame 0's recon: host "
              f"CABAC of {n_ops8t} ops into {len(payload8)} bytes "
              f"{t8_ms['cabac']:.3f} ms; K6 with both codings "
              f"{t8_ms['k6r']:.3f} ms against {t8_ms['k6o']:.3f} ms "
              f"without the 8x8 transform", flush=True)

    wrappers = {"intra_diag": intra.encode_i16_frame,
                "cabac_i_ops": cabac_planes.i_slice_ops,
                "deblock_diag": deblock.deblock_frame,
                "frame_metrics": stats.frame_metrics,
                "me_hier": me.hier_search,
                "p_inter_mb": inter.p_inter_mb,
                "intra_in_p": inter.intra_in_p,
                "cabac_p_ops": cabac_planes.cabac_p_ops,
                "hpel_planes": mc.hpel_planes,
                "subpel_refine": me.subpel_refine_blocks,
                "part_fullpel": me.partition_fullpel,
                "chroma_rerank": me.chroma_rerank,
                "rd_inter": inter.rd_inter,
                "lowres_planes": lookahead.lowres_planes,
                "lowres_cost": lookahead.lowres_cost}
    # the 8x8 variants: the wrapper and its count of the launches that
    # took the variant's branch
    variants = {"intra_diag_i8x8": (intra.encode_i16_frame, "launches_i8x8"),
                "cabac_i_ops_t8": (cabac_planes.i_slice_ops, "launches_t8"),
                "deblock_diag_t8": (deblock.deblock_frame, "launches_t8"),
                "p_inter_mb_t8_sa8d": (inter.p_inter_mb, "launches_t8_sa8d"),
                "p_inter_mb_t8_rd": (inter.p_inter_mb, "launches_t8_rd"),
                "rd_inter_t8": (inter.rd_inter, "launches_t8"),
                "cabac_p_ops_t8": (cabac_planes.cabac_p_ops, "launches_t8")}

    def main_path(keyint: int, n: int, what: str, subme: int = 1,
                  scenecut: int = 0, src=None, make=None):
        """Encoder on the first n frames of src (make_frames' by default)
        at 1080p, the launch counts set to 0 just before and read just
        after (the 8x8 variants' among them, which must stay 0 without
        make, whose parameters turn the 8x8 transform off); make: as in
        same_as_cpu. Returns (frames, summary, launches, header, fps,
        median encode() ms, the encoder)."""
        enc = x264_tpu_torch.Encoder(
            make(x264_tpu_torch.EncoderParams, 3) if make else
            params(x264_tpu_torch.EncoderParams, 3, keyint, subme, scenecut))
        header = enc.headers()
        for w in wrappers.values():
            w.launches = 0
        for w, count in variants.values():
            setattr(w, count, 0)
        done, wall, call_ms = drive(enc, (src or frames)[:n])
        launches = {k: w.launches for k, w in wrappers.items()}
        launches.update({k: getattr(w, count)
                         for k, (w, count) in variants.items()})
        if make is None and any(launches[k] for k in variants):
            fail(f"{what}: an 8x8 branch ran without the 8x8 transform")
        summary = enc.close()
        if len(done) != n:
            fail(f"{what}: {len(done)} frames came out of {n}")
        if not all(np.isfinite([summary["psnr"]["avg"], summary["ssim_y"]])):
            fail(f"{what}: metrics are not finite")
        print(f"{what} launches: {json.dumps(launches)}", flush=True)
        return done, summary, launches, header, n / wall, \
            statistics.median(call_ms[2:]), enc

    # ----------------------------------------------- 4. all-intra path
    stamp("phase 4")
    done, summary, launches_i, header, fps, med, _ = main_path(
        1, N_INTRA, "all-intra")
    for k in ("intra_diag", "cabac_i_ops", "deblock_diag", "frame_metrics"):
        if launches_i[k] <= 0:
            fail(f"kernel {k} was not launched on the all-intra path")
    sizes = [len(e.payload) for e in done]
    print(f"all-intra path: {N_INTRA} frames {W}x{H} keyint 1 CQP {QP} "
          f"CABAC, {fps:.3f} fps, median encode() {med:.1f} ms, "
          f"{statistics.mean(sizes):.0f} bytes/frame, PSNR Y "
          f"{summary['psnr']['y']:.4f} avg {summary['psnr']['avg']:.4f} dB, "
          f"SSIM {summary['ssim_y']:.6f} [{smi_line}]", flush=True)
    same_as_cpu(x264_tpu_torch, done, frames, header, 1, 1, "all-intra")

    # ---------------------------------------- 5. IPPP path at subme 1
    stamp("phase 5")
    done, summary, launches_1, header, fps, med, enc = main_path(
        250, N_IPPP, "IPPP subme 1")
    for k in list(wrappers)[:8]:
        if launches_1[k] <= 0:
            fail(f"kernel {k} was not launched on the IPPP subme-1 path")
    ippp_report(done, summary, enc.stats, fps, med, N_IPPP, 1, smi_line, nmb)
    same_as_cpu(x264_tpu_torch, done, frames, header, N_CHECK_EARLY, 250,
                "IPPP subme 1")
    device_split(x264_tpu_torch, frames, 4, 4, 1)

    # ------------------------------------------- 6. IPPP at subme 5
    stamp("phase 6")
    ptypes = []
    encode_p = pipeline.encode_p_cabac

    def encode_p_seen(*a, **k):
        out = encode_p(*a, **k)
        ptypes.append(out["ptype"])
        return out

    pipeline.encode_p_cabac = encode_p_seen
    done, summary, launches_5, header, fps, med, enc = main_path(
        250, N_SUBPEL, f"IPPP subme {SUBME}", SUBME)
    pipeline.encode_p_cabac = encode_p
    for k in list(wrappers)[:12]:
        if launches_5[k] <= 0:
            fail(f"kernel {k} was not launched on the IPPP subme-{SUBME} "
                 f"path")
    hist = torch.stack([torch.bincount(p.reshape(-1), minlength=4)
                        for p in ptypes]).sum(0).tolist()
    ippp_report(done, summary, enc.stats, fps, med, N_SUBPEL, SUBME,
                smi_line, nmb, f", ptype histogram over the P frames (intra "
                f"MBs as 0) {hist}")
    same_as_cpu(x264_tpu_torch, done, frames, header, N_CHECK_EARLY, 250,
                f"IPPP subme {SUBME}", SUBME)
    device_split(x264_tpu_torch, frames, 4, 4, SUBME)

    # -------- 7. IPPP at subme 6 with the lookahead, without 8x8dct
    stamp("phase 7")
    la_sums = []
    analyse = ratecontrol.RateControl.analyse_frame

    def analyse_seen(self, *a, **k):
        out = analyse(self, *a, **k)
        la_sums.append([int(out["icost"]), int(out["pcost"])])
        return out

    ratecontrol.RateControl.analyse_frame = analyse_seen
    what7 = "IPPP subme 6 scenecut 40"
    done, summary, launches_6, header, fps, med, enc = main_path(
        250, N_RD, what7, 6, 40, cut)
    ratecontrol.RateControl.analyse_frame = analyse
    for k in wrappers:
        if launches_6[k] <= 0:
            fail(f"kernel {k} was not launched on the {what7} path")
    # every frame's lookahead sums against the plain versions
    prev = None
    for i, f in enumerate(cut):
        low = lookahead.lowres_planes_plain(luma(f), H, W)
        want = lookahead.lowres_cost_plain(low, prev, bh, bw, r_la)[0]
        if la_sums[i] != want.tolist():
            fail(f"{what7}: frame {i}'s lookahead sums {la_sums[i]} differ "
                 f"from the plain versions' {want.tolist()}")
        prev = low
    print(f"{what7}: every frame's lookahead sums equal the plain "
          f"versions'; frame {CUT}'s pcost is "
          f"{la_sums[CUT][1] / la_sums[CUT][0]:.4f} of its icost, frame "
          f"{CUT - 1}'s {la_sums[CUT - 1][1] / la_sums[CUT - 1][0]:.4f}",
          flush=True)
    ippp_report(done, summary, enc.stats, fps, med, N_RD, 6, smi_line, nmb,
                f", IDRs at frames 0 and {CUT}, host wait on the lookahead "
                f"{enc.rc.lookahead_wait_s / N_RD * 1e3:.3f} ms a frame, "
                f"host CABAC of a subme-6 P frame {cabac6:.3f} ms",
                idrs=(0, CUT))
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_EARLY, 250, what7,
                6, 40)
    device_split(x264_tpu_torch, cut, 4, 8, 6, 40)

    # ------------------------- 8. bench.py's main path: the defaults at CQP
    stamp("phase 8")
    t8_seen = {"IDR": [], "P": []}
    encode_idr, encode_p = pipeline.encode_i16_idr_cabac, \
        pipeline.encode_p_cabac

    def seen_t8(fn, kind):
        def call(*a, **k):
            out = fn(*a, **k)
            t8_seen[kind].append(out.get("t8_mb"))
            return out
        return call

    pipeline.encode_i16_idr_cabac = seen_t8(encode_idr, "IDR")
    pipeline.encode_p_cabac = seen_t8(encode_p, "P")
    what8 = "bench.py main path"
    done, summary, launches_8, header, fps, med, enc = main_path(
        250, N_BENCH, what8, src=cut, make=bench_params)
    pipeline.encode_i16_idr_cabac, pipeline.encode_p_cabac = encode_idr, \
        encode_p
    if not (enc._t8 and enc._i8x8 and enc._rd and enc._analyse_lowres):
        fail(f"{what8}: the defaults did not turn on the 8x8 transform, "
             f"I8x8, the RD ladder and the lookahead")
    # subme 6 takes the RD transform choice: the SA8D branch stays idle
    for k, n in launches_8.items():
        if (n <= 0) != (k == "p_inter_mb_t8_sa8d"):
            fail(f"kernel {k} was launched {n} times on the {what8}")
    for name, r in rec.items():
        r.update(launches=launches_8[name],
                 launches_ippp_subme6=launches_6[name],
                 launches_ippp_subme5=launches_5[name],
                 launches_ippp_subme1=launches_1[name],
                 launches_all_intra=launches_i[name])
    if any(t is None for v in t8_seen.values() for t in v):
        fail(f"{what8}: a frame ran without the 8x8 transform")
    i8_per_idr = [int(t.sum()) for t in t8_seen["IDR"]]
    t8_per_p = [int(t.sum()) for t in t8_seen["P"]]
    if len(i8_per_idr) != 2 or min(i8_per_idr) == 0 or sum(t8_per_p) == 0:
        fail(f"{what8}: I8x8 MBs per IDR {i8_per_idr}, 8x8-transform MBs "
             f"over the P frames {sum(t8_per_p)}")
    ippp_report(done, summary, enc.stats, fps, med, N_BENCH, 6, smi_line,
                nmb, f", defaults (8x8dct, I8x8), IDRs at frames 0 and {CUT} "
                f"with {i8_per_idr} I8x8 MBs, "
                f"{statistics.mean(t8_per_p):.1f} 8x8-transform MBs per P "
                f"frame, host wait on the lookahead "
                f"{enc.rc.lookahead_wait_s / N_BENCH * 1e3:.3f} ms a frame, "
                f"host CABAC of a P frame at these settings "
                f"{t8_ms['cabac']:.3f} ms", idrs=(0, CUT))
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK, 250, what8,
                make=bench_params)
    device_split(x264_tpu_torch, cut, 4, 8, 6, 40, make=bench_params)
    stamp("done")

    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

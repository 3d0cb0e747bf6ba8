#!/usr/bin/env python3
"""Smoke run of x264_tpu_torch on one NVIDIA GPU (the quickest proof that
the PyTorch / CUDA port still starts and is right on the card).

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build: the CUDA kernels of x264_tpu_torch/csrc (one nvcc per source,
     started together) and the host CABAC engine, with the seconds; then
     the registers and local bytes a thread and the resident CTAs an SM
     of the kernels of inter.cu (K6, K22), me.cu (K5, K29), trellis.cu
     (K20) and subpel.cu (K10-K12), as libcuda reports them;
  3. kernels: K1-K4 at 1080p on seeded frames, each held against its
     plain PyTorch version on the card (K1-K3 exact, K4 within relative
     1e-6 on the SSDs and 1e-5 on the SSIM sum) and timed beside it;
     then the host time to queue K1's and K2's launches (and their
     launches a frame), and one frame's split: kernels, d2h of the op
     stream, host CABAC. Then the P-frame kernels K5-K8, and K2 with P
     maps, exact against their plain versions on frame 1 against frame
     0's deblocked recon (K2 also in 20 more runs on fresh copies, its
     row wavefront's memory ordering, and on a band's 17 MB rows); K5-K8 once
     more against that recon with 30% of its 64x64 blocks (seeded)
     flattened to gray, so that many MBs go intra and intra chains deeper
     than the three sweeps are demoted; K5 also at R 4 and 24 and on a
     flat reference, and its two launches by device time (and, with K6
     without the trellis and K22's two passes, on frames one MB wide and
     one MB tall: k5_k6_edges); and one P frame's split;
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
     type and fractional MVs occur (K10 at steps (2,) and (2, 1), on
     each layout alone and on the three in the one launch a P frame
     runs; and on its edge inputs: flat content at lam 0, where
     candidate 0 must win, MVs into the pad from a crop's corners and a
     mixed reference, on every shape and both layout sets); and the host
     CABAC of frame 1 at subme 5 on frame 0's recon;
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
     must rise, frame 0 must equal the CPU run's, every frame's two
     lookahead sums must equal their plain versions', and the phase
     reports fps, the median encode(), a P frame's host CABAC, the
     profiler's device split and the host's wait on the lookahead per
     frame.
  8. bench.py's main path (bench.py:59-91): x264_tpu's defaults at CQP
     26 with keyint 250 (the 8x8 transform with I8x8 in the IDRs, subme 6
     with psy-RD 1.0 and the RD transform choice, scenecut 40,
     keyint_min 25, ref 1, no B frames), nothing else set, on phase 7's
     32 frames. Every kernel's launch count must rise, frames 0-1 must
     equal the CPU run's, the IDRs must fall at frames 0 and 26 only, and
     the IDRs must hold I8x8 MBs and the P frames 8x8-transform MBs; the
     phase reports fps, the median encode(), a P frame's host CABAC, the
     profiler's device split and the idle share.
  9. x264_tpu's own defaults: EncoderParams(1920, 1080) with nothing else
     set but i_frame_parallel 3 (CRF 23 with variance AQ at strength 1.0,
     keyint 250, 8x8dct + I8x8, subme 6 with psy-RD, scenecut 40, ref 1,
     no B frames), on phase 7's 32 frames. Every kernel's launch count
     must rise (K16 aq_qp_map and K17 dqp_syntax and the AQ branches of
     K1 / K6 / K7 / K3 / K8 among them), frames 0-1 must equal a CPU run
     at the same pipe depth, the IDRs must fall at frames 0 and 26 only,
     and some MBs must code a nonzero mb_qp_delta; the phase reports fps,
     the median encode(), the bytes of the IDRs and P frames, PSNR /
     SSIM, the frame QPs, the share of MBs with a nonzero delta, the
     profiler's device split (K16 and K17 in it) and the idle share.
 10. bench.py's all-intra CAVLC line (bench.py:247-252): five 1920x1080
     frames, keyint 1, CQP 26, b_cabac off, deblocking, i_frame_parallel
     3, nothing else set. K1, K18, K2 and K4 must launch and no other
     kernel, frame 0's payload and recon must equal the CPU run's; the
     phase reports fps, the median encode(), bytes a frame, PSNR / SSIM,
     the d2h of the word buffer, the profiler's split and the idle share.
 11. x264_tpu's defaults with b_cabac off (CRF 23 with variance AQ,
     subme 6 with psy-RD, scenecut 40, keyint 250, ref 1, no 8x8dct),
     on phase 7's 32 frames. Every kernel but CABAC's and the 8x8 ones
     must launch (K16-K19 and K8's pass A alone among them), frames 0-1
     must equal a CPU run at the same pipe depth, the IDRs must fall at
     frames 0 and 26 only, and some MBs must code a nonzero
     mb_qp_delta; the phase reports as phase 9, the K18 / K19 device
     time in the profiler's split.
 12. x264_tpu's defaults with the CABAC trellis (--trellis 1, as real
     x264's defaults have it with CABAC), on phase 7's 32 frames. Every
     kernel of phase 9 must launch and K6 must take its trellis branch
     on every P frame (K20's device code runs inside K6; K20 itself
     runs in phase 3 alone), frames 0-1 must equal a CPU run at the
     same pipe depth and the IDRs must fall at frames 0 and 26 only;
     the phase reports as phase 9, against phase 9's fps, bytes,
     PSNR / SSIM and frame QPs, and the profiler's split with K6.
 13. x264_tpu's defaults with B frames: i_bframe 3 (b-adapt 1, the fast
     greedy; spatial direct; CRF 23 with variance AQ in the I / P frames,
     the B frames at the frame QP), i_frame_parallel 3, on phase 7's 32
     frames. Every kernel of phase 9 must launch and K21-K24, K7's B
     decision and sweeps and K2's B branch too; every b-adapt decision
     and seed must equal the plain K21's on the same lowres planes; B
     frames must occur and the IDRs fall at display frames 0 and 26 only;
     its first two frames in encode order (IDR, P: on the noisy first
     picture b-adapt 1 keeps no B) must equal a CPU run at the same pipe
     depth, and so must the three frames (IDR, P, B) of a run of the
     defaults with i_bframe 1 on the first frames of the second picture;
     the phase reports fps (against phase 9's), the median encode(), the
     bytes of the IDR, P and B frames, PSNR / SSIM, the frame types and
     QPs, and the profiler's split and idle share over frames 24-31 (the
     cut and the B run after it).
 14. x264's default preset as far as x264_tpu encodes it: its defaults
     with --ref 3 (which validate() clamps to 2), --bframes 3 (b-adapt 1)
     and --trellis 1, CABAC, i_frame_parallel 3, on phase 7's 32 frames.
     Every kernel of phase 13 must launch, the two-reference branches of
     K10-K13, K6 and K8 too; the IDRs fall at display frames 0 and 26
     only; the first three frames in encode order (IDR, the P with one
     reference, the first P with two) must equal a CPU run, and so must
     three 1080p flash frames at i_bframe 0 (a band that alternates
     between two noise patterns: the third frame takes MBs from L0[1]);
     the phase reports fps beside phases 12 and 13, the median
     encode(), the IDR / P / B bytes, PSNR / SSIM, the share of the
     two-reference P frames' MBs on L0[1], and the profiler's split and
     idle share.
 15. the same preset with b_cabac off (ref 2, i_bframe 3; no trellis,
     no 8x8 transform): K25, K24's pass A alone, K19's ref_idx bit and
     K8's pass A with two references must launch, and every other kernel
     of phase 11 and of the B frames but CABAC's; frames 0-2 must equal
     a CPU run, and so must an IDR, P, B run of the second picture at
     i_bframe 1; the phase reports as phase 14, beside phase 11.
 16. phase 12's settings with --nr 250 and --cqm jvt, on phase 7's 32
     frames: every kernel of phase 12 must launch, K6's NR branch on
     every P frame and K26 twice on each (the 4x4 and the 8x8 sums),
     with the offsets passed; IDRs at 0 and 26 only; frames 0-2 must
     equal a CPU run; the phase reports fps, bytes, PSNR / SSIM beside
     phase 12's and the final NR offsets. Then 3 frames at
     i_mb_row_shards 2 on the one card: x264_tpu's fallback line must be
     logged and the bytes must equal i_mb_row_shards 1's at the
     parameters validate() leaves (I8x8 off, as x264_tpu turns it off).
 17. lossless (CQP 0, subme 6: the bypass, the RD ladder off) on 8
     frames of make_frames with CABAC, then 3 with CAVLC: K1, K6 and K7
     must take their lossless branches, every frame's reconstruction on
     the card must equal its source, frames 0-1 of each must equal a CPU
     run; the phase reports bytes per frame and the fullest CAVLC
     frame's bits per MB against the word buffer's 4800.
 18. MB-row sharding on the one card: (a) x264_tpu's defaults (CRF 23
     with variance AQ, subme 6, the 8x8 transform; I8x8 off with shards)
     with --ref 2 and --bframes 2 at b-adapt 0, i_mb_row_shards 4 on
     device=[cuda:0] * 4 (4 bands of 17 MB rows), 8 frames of
     make_frames: every CABAC band program's kernels must launch, K27 on
     every band of every frame and K28 once a band and reference, none
     of chroma ME, I8x8 or the I bands' AQ; the first three frames in
     encode order (IDR, P, B) must equal a CPU run on device=["cpu"] * 4;
     (b) CAVLC at CQP 26 over 2 bands, 5 frames: K18, K8's pass A, K19
     and K28 launch, K27 does not, frames 0-2 equal the CPU's on
     ["cpu"] * 2. It reports fps, the median encode(), bytes by frame
     type, each band's host CABAC time, K28's time a frame derived from
     phase 3's per launch, the d2h bytes of the packed op streams against
     32-bit ops, and the profiler's split (K27 and K28 in it) and idle
     share over frames 1-6. One card cannot
     show the peer copies between cards or the bands' overlap across
     cards: the bands share cuda:0 and their strips stay in place.
 19. intra without I4x4, the overflow path, the GOP batch, the profilers:
     (a) x264's ultrafast as x264_tpu takes it (CAVLC, no deblocking,
     --partitions none, subme 1, no 8x8dct, scenecut 0, ref 1, no B
     frames, CRF 23 without AQ) on phase 7's 32 frames: K1's
     I16x16-only branch and the CAVLC kernels launch, K2 and the sub-pel
     kernels do not, frames 0-2 equal a CPU run; (b) --partitions i8x8 on
     phase 9's defaults, 8 frames: K1 with I8x8 without I4x4 (some I8x8
     MBs), no partition search, frames 0-1 equal a CPU run; (c) a
     lossless CAVLC IDR of binary noise at i_frame_parallel 1: past the
     word buffer with and without I4x4, so the host coder codes it; its
     branch, the host coder's ms, the recon the source and the payload
     equal to a CPU run's; (d) encode_gop_intra of 8 frames over
     [cuda:0] x 2 (K1's frame axis, one launch a diagonal a chunk) and
     hadamard_ac (K30) on their MBs: every output equal to K1 alone frame
     by frame, frame 0 and K30 to the CPU's plain versions, frames/s
     batched against one frame a call; (e) both profilers
     (x264_tpu_torch/tools) at 1920x1080, their lines printed, K29
     launched by profile_stages.
Phase 3 also holds K13 (rd_inter) and K7 with the RD decision exact at
1080p, on frame 1 against frame 0's recon and against the 30%-gray
reference, K14 / K15 on a pair of frames of one scene and on a pair
across the cut, and the 8x8 transform: K1 with I8x8 and K3 / K2 on its
output on a frame that I8x8 fits, and K6 (the SA8D and the RD choice),
K13, K8 and K2 with t8 on frame 1 against frame 0's recon and against
the 30%-gray reference; and variance AQ: K16 on frame 0 and on a frame
that is half flat, half noise, K16's device log against the plain
version over every float32 in [1, 2^23), K17 on seeded maps, K1 + K17 +
K3 + K2 with a QP map on frame 0 (with I8x8), and K6 / K7 / K8 (with K17
between its passes) / K2 with a QP map on frame 1 against frame 0's
recon and against the 30%-gray reference (subme 6 with the 8x8
transform); and CAVLC: K18 exact (words and nbits) on frame 0's K1
planes at QP 26, at QP 4 on the half-flat frame (long level escapes),
with frame 0's QP map and K17's dqp, and with a capacity that drops
codes; K8's pass A alone and K19 on frame 1 against frame 0's recon, the
partition reference, a reference with 30% of its 64x64 tiles gray and
30% copied from frame 1 (intra MBs, skip runs) and with frame 1's QP
map, and K19 with a capacity that drops codes; and the trellis: K20
exact at each category on frame 1's coefficients against frame 0's
recon at QP 26, at cat 2 and 5 with the 52-QP stacks and a seeded row
per block, on trellis.tie_coefs' rows of each category (zero blocks,
magnitudes on q's rounding edge, lone coefficients, levels past the ue
escape) at lam2 the table's, 0 and 1e7 and with the stack's rows at QP
0, 1 and 51, at QP 4 on the half-flat frame (levels past the ue escape),
and K6 with the trellis at t8 0, 1 and 2, at QP 26 and with frame 1's QP
map (each t8 timed with and without it), and at the edges: an MB row
whose residual is zero, QP 1's consts, a QP map of rows 0, 1 and 51;
and B frames: K21 in each of the four b-adapt programs on the
lowres planes of frames 0-2, and K22 (both passes, with and without the
trellis, and with it at QP 4 and 51), K7's B decision and sweeps, K23, K24 and K2 with B maps on
frame 1 as a B frame between frame 0's recon and frame 2, with 30% of the
64x64 blocks gray in all three (direct, skip) and 15% flat in the B
frame alone (intra), all exact; and two references: frame 1 against the
partition reference as L0[0] and frame 0's recon as L0[1] at subme 6
with the 8x8 transform, the trellis and frame 1's QP map, K10 (every
block shape), K11, K12, K6 and K13 on the arguments encode_p_front gave
them and again with a seeded reference index, K8 with the ref_idx bins
and K2 on a ref4 holding 0, 1 and -1, K8's pass A alone and K19 with the
ref_idx bit (and with a dropping capacity), and K24's pass A alone and
K25 on the B frame above (and with a dropping capacity), all exact; and
the noise reduction and lossless: K6's NR branch at t8 0, 1 and 2 with
the deadzone quant, the trellis, and the trellis with frame 1's QP map,
K26 on that frame's 4x4 and 8x8 |coef|, on the 30%-gray reference's and
on 1080p |coef| whose sums pass 2^24, and the lossless branches of K1
(frame 0), K6 and K7 (frame 1 against frame 0's recon), each recon the
source, all exact; and MB-row sharding: K27 on frame 0's IDR and frame 1's
P op streams and on a seeded stream past a small capacity, K28 on frame
0's recon cut into 4 bands at each position, both exact, and the d2h of
frame 1's live P stream packed against unpacked; and intra without I4x4:
K1's I16x16-only branch on frame 0 (alone, with I8x8, lossless) and its
frame axis on 8 frames, K29 fullpel_search on frame 1 against frame 0's
recon at R = 16 and R = 40 (past the pad; also with a far predictor), K30
hadamard_ac on frame 0's 16x16 and 8x8 tiles, all exact, and
lowres_plane against K14's plain phase-00 plane. The
line before the last is the JSON `kernels` record (the 8x8, AQ, CAVLC,
trellis, two-reference, NR and lossless variants as records of their own, each
counting the launches that took its branch; `launches` is the count of
the kernel's own main path, phase 11 for K18, K19 and K8's pass A alone,
phase 12 for K6's trellis branch and K20 (0: its device code runs
inside K6), phase 13 for the B kernels and branches, phase 14 for the
two-reference branches, phase 15 for K25, K24's pass A alone and the
CAVLC two-reference branches, phase 16 for K26 and K6's NR branch,
phase 17's CABAC run for the lossless branches, phase 18's CABAC run
for K27 and K28 (`launches_rows`, and `launches_rows_cavlc`, phase 18's
band launches of every kernel), phase 19a for K1's I16x16-only branch
(`launches_i16`), 19d for its frame axis (`launches_batch`) and K30,
19e for K29, phase 9 for the others, the other
phases' beside it); the
last line is
{"ok": true, "device": {...}}. Needs one CUDA card and nvcc.
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
N_CHECK_EARLY = 2              # frames of phases 5, 6, 8 and 9 held against
                               # the CPU (IDR, P)
N_CHECK_RD = 1                 # and of phase 7 (its IDR; phases 8 and 9
                               # check the subme-6 P frame)
N_DEFAULTS = 32                # frames of x264_tpu's defaults (phases 9
                               # and 11)
N_INTRA_CAVLC = 5              # frames of bench.py's all-intra CAVLC line
                               # (phase 10)
N_CHECK_CAVLC = 1              # frames of phase 11 held against the CPU
N_TRELLIS = 32                 # frames of the defaults with the trellis
N_BFRAMES = 32                 # frames of the defaults with B frames
N_NR = 32                      # frames of the defaults with NR + JVT
                               # matrices (phase 16)
N_CHECK_NR = 3                 # of them held against the CPU
N_LOSSLESS = 8                 # frames of the lossless CABAC run (phase 17)
N_LOSSLESS_CAVLC = 3           # and of its CAVLC run
N_CHECK_LOSSLESS = 2           # frames of each held against the CPU
N_PRESET = 32                  # frames of x264's default preset (phases
                               # 14 and 15)
N_ROWS = 8                     # frames of the sharded CABAC run (phase 18)
N_ROWS_CAVLC = 5               # and of its CAVLC run
N_BANDS = 4                    # bands of MB rows of the CABAC run
N_BANDS_CAVLC = 2              # and of the CAVLC run
N_CHECK_ROWS = 3               # frames of each held against the CPU
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
# K16 per MB: a load, a square and two adds for each of its 384 samples,
# eight 5-step warp sums and the float chain with the log (~60 ops); K17
# per MB: the run's max, the scan's share and the three outputs
K16_OPS_PER_MB = 384 * 4 + 8 * 5 * 32 + 60
K17_OPS_PER_MB = 16
# K18 / K19 per MB: both passes scan the MB's 408 levels (~6 ops each),
# the count grids another 400, and each live code costs ~20 ops a pass
K18_OPS_PER_MB = 2 * 408 * 6 + 400
K18_OPS_PER_BIT = 2 * 20 // 4
# K20 (and K6's trellis branch), counted from the data: per candidate
# level it scores (q at every position, q - 1 where q > 0), from each of
# the 8 nodes the base add, up to four bit-cost adds, the multiply-add and
# the compare-select (~9 ops), plus the level's unquant, distortion and
# prefix (~12); per position the quant, the history word and the
# backtrack step
K20_OPS_PER_CAND = 8 * 9 + 12
K20_OPS_PER_POS = 28
# the B frame: K21 per block adds to K15's work the bi candidate's two
# fetches, the average and four 4x4 Hadamards (~600 ops); K22 per MB in
# pass 1 two lists' luma and chroma fetches (~16 ops a sample), the BI
# average's 16 Hadamards and K6's residual, in pass 2 the fetches and the
# residual; K23 per MB two spatial-direct derivations (~300 ops each),
# the two-list fetch of the direct prediction and its 16 Hadamards
K21_BI_OPS_PER_BLOCK = 600
K22_PASS1_OPS_PER_MB = K6_OPS_PER_MB + 2 * 384 * 16 + 16 * 130
K22_PASS2_OPS_PER_MB = K6_OPS_PER_MB + 2 * 384 * 16
K23_OPS_PER_MB = 2 * 300 + 2 * 256 * 16 + 16 * 130
# the noise reduction: K6 per MB adds, for each of the 256 4x4 and 256
# 8x8 coefficients, the |c| store, the shrink and the sign (~4 ops); K26
# one float addition per |coef| (counted from the tensors). Lossless: K1
# per MB skips the 40 blocks' transform / quant / recon (~350 ops each)
K6_NR_OPS_PER_MB = 512 * 4
K1_LOSSLESS_OPS_PER_MB = K1_OPS_PER_MB - 40 * 350
# intra without I4x4: K1 per MB drops the 9 x 16 I4 SATD blocks and the
# 16 I4 transforms (~130 + 350 ops each); K29 per candidate of an MB: a
# subtract, an abs and an add for each of its 256 samples (at 1080p and
# R = 16, 8160 x 1089 x 256 = 2.3e9 terms); K30 per sample: its share of
# a 4x4 and an 8x8 butterfly (2 + 3 adds), the two abs-sums and the DC
K1_I16_OPS_PER_MB = K1_OPS_PER_MB - 9 * 16 * 130 - 16 * 350
K29_OPS_PER_CAND = 3 * 256
K30_OPS_PER_SAMPLE = 12
N_ULTRAFAST = 32               # frames of x264's ultrafast (phase 19a)
N_CHECK_ULTRAFAST = 3          # of them held against the CPU
N_PART_I8X8 = 8                # frames of --partitions i8x8 (phase 19b)
N_GOP = 8                      # frames of the GOP batch (phase 19d)


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


def half_flat_frame(w: int, h: int, frame_cls, seed: int = 13):
    """A picture whose left half is flat and right half noise (all three
    planes): variance AQ spreads its MBs' QPs widely."""
    rng = np.random.default_rng(seed)
    planes = []
    for ph, pw, level in ((h, w, 90), (h // 2, w // 2, 128),
                          (h // 2, w // 2, 120)):
        a = rng.integers(0, 256, (ph, pw)).astype(np.uint8)
        a[:, :pw // 2] = level
        planes.append(a)
    return frame_cls(*planes)


def defaults_params(EncoderParams, frame_parallel: int = 3):
    """x264_tpu's own defaults at 1080p, nothing else set (CRF 23 with
    variance AQ at strength 1.0, keyint 250, the 8x8 transform with I8x8,
    subme 6 with psy-RD 1.0, scenecut 40, ref 1, no B frames)."""
    return EncoderParams(i_width=W, i_height=H, i_log_level=0,
                         i_frame_parallel=frame_parallel)


def bframes_params(EncoderParams, frame_parallel: int = 3):
    """x264_tpu's own defaults at 1080p with i_bframe 3 (b-adapt 1, the
    fast greedy, i_bframe_adaptive's default; spatial direct)."""
    return EncoderParams(i_width=W, i_height=H, i_log_level=0,
                         i_frame_parallel=frame_parallel, i_bframe=3)


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


def cavlc_intra_params(EncoderParams, frame_parallel: int = 3):
    """bench.py's all-intra CAVLC line (bench.py:247-252, run_encoder):
    keyint 1, CQP 26, CAVLC, deblocking, nothing else set."""
    p = EncoderParams(i_width=W, i_height=H, b_cabac=False,
                      b_deblocking_filter=True, i_log_level=0,
                      i_keyint_max=1, i_frame_parallel=frame_parallel)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = QP
    return p


def cavlc_defaults_params(EncoderParams, frame_parallel: int = 3):
    """x264_tpu's own defaults with b_cabac off (CRF 23 with variance AQ,
    keyint 250, subme 6 with psy-RD, scenecut 40, ref 1, no B frames;
    validate() turns 8x8dct and I8x8 off without CABAC)."""
    return EncoderParams(i_width=W, i_height=H, b_cabac=False,
                         i_log_level=0, i_frame_parallel=frame_parallel)


def trellis_params(EncoderParams, frame_parallel: int = 3):
    """x264_tpu's own defaults with the CABAC trellis on (--trellis 1, as
    real x264's own defaults have it with CABAC), nothing else set."""
    p = defaults_params(EncoderParams, frame_parallel)
    p.analyse.i_trellis = 1
    return p


def preset_params(EncoderParams, frame_parallel: int = 3):
    """x264's default preset (medium: --ref 3 --bframes 3 --trellis 1 at
    CRF 23 with AQ) as x264_tpu encodes it: its own defaults with
    i_frame_reference 3 (validate() clamps it to 2 and logs it),
    i_bframe 3 (b-adapt 1) and analyse.i_trellis 1, CABAC."""
    p = defaults_params(EncoderParams, frame_parallel)
    p.i_frame_reference = 3
    p.i_bframe = 3
    p.analyse.i_trellis = 1
    return p


def preset_cavlc_params(EncoderParams, frame_parallel: int = 3):
    """The preset with b_cabac off: ref 2, i_bframe 3, and (validate())
    neither the trellis nor the 8x8 transform."""
    p = preset_params(EncoderParams, frame_parallel)
    p.b_cabac = False
    return p


def bframes1_params(EncoderParams, frame_parallel: int = 3):
    """Phase 13's CPU check of a B frame: its defaults at i_bframe 1."""
    p = bframes_params(EncoderParams, frame_parallel)
    p.i_bframe = 1
    return p


def preset_cavlc_b1_params(EncoderParams, frame_parallel: int = 3):
    """Phase 15's CPU check of a B frame: its settings at i_bframe 1."""
    p = preset_cavlc_params(EncoderParams, frame_parallel)
    p.i_bframe = 1
    return p


def preset_flash_params(EncoderParams, frame_parallel: int = 3):
    """The preset at i_bframe 0, for the flash frames' IDR, P, P."""
    p = preset_params(EncoderParams, frame_parallel)
    p.i_bframe = 0
    return p


def nr_cqm_params(EncoderParams, frame_parallel: int = 3, shards: int = 1):
    """Phase 12's settings (x264_tpu's defaults with --trellis 1) with
    --nr 250 and the JVT quant matrices (--cqm jvt); shards: the
    i_mb_row_shards the one card falls back from."""
    p = trellis_params(EncoderParams, frame_parallel)
    p.analyse.i_noise_reduction = 250
    p.i_cqm_preset = 1
    p.i_mb_row_shards = shards
    return p


def lossless_params(EncoderParams, frame_parallel: int = 3,
                    cabac: bool = True):
    """Lossless: CQP 0 at subme 6, keyint 250, x264_tpu's defaults
    otherwise (validate() turns the 8x8 transform, the trellis and B
    frames off; the encoder the RD ladder), CABAC or CAVLC."""
    p = EncoderParams(i_width=W, i_height=H, i_keyint_max=250,
                      i_log_level=0, i_frame_parallel=frame_parallel,
                      b_cabac=cabac)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = 0
    p.analyse.i_subpel_refine = 6
    return p


def lossless_cavlc_params(EncoderParams, frame_parallel: int = 3):
    return lossless_params(EncoderParams, frame_parallel, cabac=False)


def rows_params(EncoderParams, frame_parallel: int = 3):
    """Phase 18a: x264_tpu's defaults (CRF 23 with variance AQ, subme 6
    with psy-RD, the 8x8 transform; validate() turns I8x8 off with
    shards) with --ref 2 and --bframes 2, over 4 bands of MB rows. The B
    runs are fixed (b-adapt 0): on make_frames' noisy pan b-adapt 1
    places no B, and the B band program must run."""
    p = EncoderParams(i_width=W, i_height=H, i_log_level=0,
                      i_frame_parallel=frame_parallel, i_frame_reference=2,
                      i_bframe=2, i_mb_row_shards=N_BANDS)
    p.i_bframe_adaptive = 0
    return p


def rows_cavlc_params(EncoderParams, frame_parallel: int = 3):
    """Phase 18b: CAVLC at CQP 26 over 2 bands of MB rows, keyint 250,
    x264_tpu's defaults otherwise (validate() turns the 8x8 transform,
    I8x8 and, with shards, AQ off)."""
    p = EncoderParams(i_width=W, i_height=H, i_log_level=0, b_cabac=False,
                      i_frame_parallel=frame_parallel, i_keyint_max=250,
                      i_mb_row_shards=N_BANDS_CAVLC)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = QP
    return p


def ultrafast_params(EncoderParams, frame_parallel: int = 3):
    """Phase 19a: x264's ultrafast preset as x264_tpu takes it: CAVLC, no
    deblocking, --partitions none (no I4x4, I8x8 or P partitions), subme
    1 (x264's 0 clamps to 1), no 8x8dct, scenecut 0, ref 1, no B frames,
    no trellis, CRF 23 without AQ, keyint 250."""
    p = EncoderParams(i_width=W, i_height=H, i_log_level=0, b_cabac=False,
                      b_deblocking_filter=False,
                      i_frame_parallel=frame_parallel,
                      i_scenecut_threshold=0, i_frame_reference=1,
                      i_bframe=0)
    p.analyse.intra = p.analyse.inter = 0
    p.analyse.i_subpel_refine = 1
    p.analyse.b_transform_8x8 = False
    p.analyse.i_trellis = 0
    p.rc.i_aq_mode = 0
    return p


def part_i8x8_params(EncoderParams, frame_parallel: int = 3):
    """Phase 19b: x264_tpu's defaults (phase 9: CABAC, CRF 23 with
    variance AQ, the 8x8 transform, subme 6) with --partitions i8x8: I8x8
    without I4x4 in the I slices, no P partitions."""
    from x264_tpu_torch.params import ANALYSE_I8x8
    p = defaults_params(EncoderParams, frame_parallel)
    p.analyse.intra = p.analyse.inter = ANALYSE_I8x8
    return p


def overflow_params(EncoderParams, frame_parallel: int = 1):
    """Phase 19c: a lossless (CQP 0) CAVLC IDR at i_frame_parallel 1,
    the synchronous path that retries without I4x4 and then codes the
    slice on the host."""
    p = EncoderParams(i_width=W, i_height=H, i_log_level=0, b_cabac=False,
                      i_frame_parallel=frame_parallel, i_keyint_max=1)
    p.rc.i_rc_method = 0            # CQP
    p.rc.i_qp_constant = 0
    return p


def lossless_check(done, frames, what: str) -> None:
    """Every frame's reconstruction on the card equals its source: the
    bypass's own proof."""
    for i, e in enumerate(done):
        for pl in "yuv":
            got = getattr(e.recon, pl).cpu().numpy()
            if not np.array_equal(got, getattr(frames[i], pl)):
                fail(f"{what}: frame {i} recon {pl} is not its source")
    print(f"{what}: the recons of frames 0-{len(done) - 1} equal their "
          f"sources", flush=True)


def flash_frames(w: int, h: int, n: int, frame_cls):
    """make_frames' pan with its middle third replaced by one of two
    noise patterns, pattern t % 2 at frame t (tests/test_multiref.py's
    flash sequence at 1080p): the band of frame 2 is in frame 0, L0[1]
    of the third frame's P, and not in frame 1."""
    rng = np.random.default_rng(5)
    band = slice(h // 3 // 16 * 16, 2 * h // 3 // 16 * 16)
    pats = [rng.integers(0, 256, (band.stop - band.start, w), dtype=np.uint8)
            for _ in range(2)]
    out = []
    for t, f in enumerate(make_frames(w, h, n, frame_cls)):
        y = f.y.copy()
        y[band] = pats[t % 2]
        out.append(frame_cls(y, f.u, f.v))
    return out


def preset_report(what: str, done, summary, enc, fps: float, med: float,
                  seen, beside: str) -> dict:
    """Check a preset run's frame types (B frames; IDRs at display 0 and
    CUT only) and print its end-to-end line: fps beside `beside`, the
    median encode(), IDR / P / B bytes, PSNR / SSIM, the share of the
    two-reference P frames' MBs on L0[1]. Returns fps and the P / B
    bytes."""
    types = [e.frame_type for e in done]
    idrs = sorted(e.display_idx for e in done if e.frame_type == "IDR")
    if "B" not in types or idrs != [0, CUT]:
        fail(f"{what}: frame types {types}, IDRs at display {idrs}")
    by_type = {t: [len(e.payload) for e in done if e.frame_type == t]
               for t in ("IDR", "P", "B")}
    two = [r for two_refs, r, _ in seen if two_refs]
    nmb2 = sum(r.numel() for r in two)
    on1 = sum(int((r == 1).sum()) for r in two)
    if not two or on1 == 0:
        fail(f"{what}: {len(two)} P frames with two references, {on1} MBs "
             f"on L0[1]")
    qps = [e.qp for e in enc.rc.entries]
    print(f"{what}: {len(done)} frames {W}x{H}, {fps:.3f} fps ({beside}), "
          f"median encode() {med:.1f} ms, encode order "
          f"{''.join(t[0] for t in types)}, bytes IDR "
          f"{statistics.mean(by_type['IDR']):.0f}, P "
          f"{statistics.mean(by_type['P']):.0f} ({len(by_type['P'])} "
          f"frames), B {statistics.mean(by_type['B']):.0f} "
          f"({len(by_type['B'])} frames), PSNR Y {summary['psnr']['y']:.4f} "
          f"avg {summary['psnr']['avg']:.4f} dB, SSIM "
          f"{summary['ssim_y']:.6f}, frame QPs {qps}, {on1 / nmb2:.4f} of "
          f"the MBs of the {len(two)} two-reference P frames on L0[1] "
          f"({len(seen) - len(two)} P frames with one)", flush=True)
    return dict(fps=fps, p=statistics.mean(by_type["P"]),
                b=statistics.mean(by_type["B"]))


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


# K7's kernels (csrc/intra_p.cu), whose launches launch_split times
K7_KERNELS = ("sweep0_kernel", "decide_kernel", "list_sweep_kernel")


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


def launch_split(fn, names=K7_KERNELS, reps: int = 10) -> list:
    """Device ms of each launch of fn()'s kernels whose names hold one of
    `names`, by its place in the call, from a torch.profiler trace of
    reps calls after one warm-up (as device_split traces; where that trace
    holds no whole calls, once more with the device activity alone, as
    scripts/redesign_turns.py traces): [(kernel name, mean ms)] in launch
    order; [] where neither trace holds them, after a line that counts
    what the traces held."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 [ProfilerActivity.CUDA]):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ev = sorted((e for e in dev_ev if any(n in e.name for n in names)),
                    key=lambda e: e.time_range.start)
        n = len(ev) // reps
        if n and n * reps == len(ev):
            return [(ev[i].name.replace("(anonymous namespace)::", "")
                     .split("(")[0],
                     sum(ev[i + k * n].time_range.elapsed_us()
                         for k in range(reps)) / reps / 1e3)
                    for i in range(n)]
        seen.append(f"{len(dev_ev)} device events, {len(ev)} of {names}")
    print(f"launch_split: no whole calls in {reps} traced ({'; '.join(seen)})",
          flush=True)
    return []


def split_text(split: list) -> str:
    return ", ".join(f"{name} {ms:.4f}" for name, ms in split) \
        or "not measured (no device events in the trace)"


def k7_edges(dev, exact) -> int:
    """K7 exact against its plain version on its edge inputs: frames one
    MB wide (9 x 1 MBs), one MB tall (1 x 9) and 4 x 6, a textured source
    over an inter recon off by noise, with no MB wanting intra, every MB
    wanting intra (the chains deeper than three sweeps demoted) and some;
    the P sequence at SATD, with the RD decision and psy-RD, with a QP
    map over 0-51 and lossless, and both B sequences (the sweeps with the
    B decision and with every MB intra). Returns the max error, 0."""
    from x264_tpu_torch import tables
    from x264_tpu_torch.encoder import aq, inter
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev)
    st = aq.qtab_stacks(aq.full_tables(tables.DEFAULT_QUANT, dev), 0)
    err = 0
    for mb_h, mb_w in ((9, 1), (1, 9), (4, 6)):
        h, w = mb_h * 16, mb_w * 16
        yy, xx = np.mgrid[0:h, 0:w]
        src = [((xx // 3 + yy // 2) % 200 + rng.integers(0, 24, (h, w)))
               .clip(0, 255), rng.integers(0, 256, (h // 2, w // 2)),
               128 + rng.integers(-20, 20, (h // 2, w // 2))]
        planes = [t(a) for a in src] + [
            t((a + rng.integers(-12, 13, a.shape)).clip(0, 255))
            for a in src]
        shape = (mb_h, mb_w)
        for want, cost, rd_cost in (
                ("none", np.zeros(shape), np.full(shape, -1.0)),
                ("all", np.full(shape, 1 << 29), np.full(shape, 1e30)),
                ("some", rng.integers(0, 16000, shape),
                 rng.uniform(0.0, 60000.0, shape))):
            for mode in ("satd", "rd", "aq", "lossless"):
                qp = 0 if mode == "lossless" else 26
                q = inter.make_qtab_p(
                    qp, tables.chroma_qp(qp, 0), dev,
                    **(dict(rd_idc=0, f_psy_rd=1.0) if mode == "rd" else {}))
                kw = {}
                if mode == "rd":
                    kw["rd"] = (torch.as_tensor(rd_cost, dtype=torch.float32,
                                                device=dev),
                                t(rng.integers(0, 3000, shape)))
                elif mode == "aq":
                    q = {**q, "aq_stack": st["intra"]}
                    kw["qp_map"] = t(rng.integers(0, 52, shape))
                elif mode == "lossless":
                    kw["lossless"] = True
                a7 = (mb_h, mb_w, *planes, t(cost), q,
                      int(tables.LAMBDA_TABLE[qp]), mode != "lossless")
                tag = f"K7 intra_in_p {mb_h}x{mb_w} MBs, {want} wanting intra"
                err = max(err, exact(f"{tag}, {mode}", inter.intra_in_p(
                    *a7, **kw), inter.intra_in_p_plain(*a7, **kw)))
                if mode != "satd":
                    continue
                im = inter.intra_in_b_decide(*a7[:11])
                err = max(err, exact(f"{tag}, B decision", [im], [
                    inter.intra_in_p_plain(*a7[:11], True,
                                           decide_only=True)]))
                for fixed in (im, torch.ones_like(im)):
                    err = max(err, exact(
                        f"{tag}, B sweeps", inter.intra_in_b_sweeps(
                            *a7[:8], fixed, *a7[9:11]),
                        inter.intra_in_p_plain(*a7[:8], None, *a7[9:11],
                                               True, intra_mb=fixed)))
    print("K7 exact one MB wide, one MB tall and at 4 x 6 MBs with no, "
          "some and every MB wanting intra: SATD, RD + psy, a QP map, "
          "lossless, the B decision and sweeps", flush=True)
    return err


def edge_frames(dev, mb_h: int, mb_w: int, seed: int = 21):
    """A textured frame of mb_h x mb_w MBs (y, u, v) and a reference that
    is it moved by a few samples under fresh noise, as int32 planes."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[0:h, 0:w]
    t = lambda a: torch.as_tensor(np.clip(a, 0, 255), dtype=torch.int32,
                                  device=dev)
    y = (xx * 3 + yy * 2) // 2 % 200 + rng.integers(0, 30, (h, w))
    u = rng.integers(90, 170, (h // 2, w // 2))
    v = 128 + rng.integers(-25, 25, (h // 2, w // 2))
    ref = [np.roll(y, (2, 3), (0, 1)) + rng.integers(-4, 5, (h, w)),
           np.roll(u, (1, 1), (0, 1)), np.roll(v, (1, 2), (0, 1))]
    return tuple(t(a) for a in (y, u, v)), [t(a) for a in ref]


def k5_k6_edges(dev, exact) -> int:
    """K5 me_hier, K6 p_inter_mb without the trellis and K22 b_inter_mb's
    two passes without it, exact against their plain versions on frames
    one MB wide (9 x 1 MBs), one MB tall (1 x 9) and 2 x 3 (K5 also 1 x
    1), where every window clamps and the fetch starts wrap: K5 at R 4, 16
    and 24 on a moved and a flat reference (every SAD equal; at lam 0
    every candidate ties) with a zero and a wide predictor; K6 with MVs
    past the pad and random partition types at t8 0 / 1 / 2, with a QP map
    of rows 0-51, lossless, with the noise reduction and with two
    references; K22's passes with random ME costs (every B mode taken)
    and random final references. Returns the max error, 0."""
    from x264_tpu_torch import tables
    from x264_tpu_torch.encoder import aq, inter
    from x264_tpu_torch.ops import mc, me
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev)
    lam26 = int(tables.LAMBDA_TABLE[26])
    st = aq.qtab_stacks(aq.full_tables(tables.DEFAULT_QUANT, dev), 0)
    err = 0
    for mb_h, mb_w in ((9, 1), (1, 9), (2, 3), (1, 1)):
        (y, u, v), ref = edge_frames(dev, mb_h, mb_w)
        rng = np.random.default_rng(mb_h * 31 + mb_w)
        # K5
        for flat in (False, True):
            ref_y = torch.full_like(ref[0], 117) if flat else ref[0]
            ref_pad = mc.pad_plane(ref_y)
            for wide in (False, True):
                mvp = t(rng.integers(-140, 141, (mb_h, mb_w, 2)) if wide
                        else np.zeros((mb_h, mb_w, 2)))
                lam = 0 if flat and not wide else lam26
                for r in (4, 16, 24):
                    a5 = (y, ref_pad, mb_h, mb_w, r, lam, mvp)
                    err = max(err, exact(
                        f"K5 me_hier {mb_h}x{mb_w} MBs, R {r}, "
                        f"{'flat' if flat else 'moved'} reference, "
                        f"{'wide' if wide else 'zero'} predictor",
                        me.hier_search(*a5), me.hier_search_plain(*a5)))
        if (mb_h, mb_w) == (1, 1):
            continue
        # K6 without the trellis
        pads = [mc.pad_plane(ref[0]), mc.pad_plane(ref[1], mc.PAD // 2),
                mc.pad_plane(ref[2], mc.PAD // 2)]
        planes = mc.hpel_planes(pads[0])
        ptype = t(rng.integers(0, 4, (mb_h, mb_w)))
        mv_quad = t(rng.integers(-150, 151, (mb_h, mb_w, 4, 2)))
        old = [torch.roll(a, (1, -2), (0, 1)) for a in (y, u, v)]
        for mode, t8 in (("plain", 0), ("plain", 1), ("plain", 2),
                         ("aq", 1), ("aq", 2), ("lossless", 0), ("nr", 0),
                         ("nr", 2), ("ref2", 2)):
            qp = 0 if mode == "lossless" else 26
            q = inter.make_qtab_p(qp, tables.chroma_qp(qp), dev)
            pl, cu, cv = planes, pads[1], pads[2]
            kw = {}
            if mode == "aq":
                q = {**q, "aq_stack": st["intra"], "aq_stack_p": st["inter"]}
                kw["qp_map"] = t(rng.choice([0, 1, 18, 26, 38, 51],
                                            (mb_h, mb_w)))
            elif mode == "ref2":
                pl = torch.cat([planes, mc.hpel_planes(mc.pad_plane(old[0]))])
                cu, cv = (torch.stack([p, mc.pad_plane(o, mc.PAD // 2)])
                          for p, o in zip(pads[1:], old[1:]))
                kw["ref_sel"] = t(rng.integers(0, 2, (mb_h, mb_w)))
            elif mode == "nr":
                kw["nr_offset4"] = t(rng.integers(0, 300, 16))
                if t8:
                    kw["nr_offset8"] = t(rng.integers(0, 300, 64))
            elif mode == "lossless":
                kw["lossless"] = True
            a6 = (mb_h, mb_w, y, u, v, pl, cu, cv, ptype, mv_quad, q,
                  mode != "lossless", t8)
            err = max(err, exact(
                f"K6 p_inter_mb {mb_h}x{mb_w} MBs, {mode}, t8 {t8}",
                inter.p_inter_mb(*a6, **kw),
                inter.p_inter_mb_plain(*a6, **kw)))
        # K22's two passes without the trellis
        _, ref1 = edge_frames(dev, mb_h, mb_w, seed=22)
        fetch = [inter.b_list_fetch(*r)[0] for r in (ref, ref1)]
        mvs = [t(rng.integers(-150, 151, (mb_h, mb_w, 2))) for _ in range(2)]
        kw1 = dict(satd=[t(rng.integers(0, 6000, (mb_h, mb_w)))
                         for _ in range(2)],
                   seeds=[t(rng.integers(-20, 21, (mb_h, mb_w, 2)))
                          for _ in range(2)], lam=lam26)
        kw2 = dict(refs=tuple(t(rng.choice([-1, 0], (mb_h, mb_w)))
                              for _ in range(2)))
        a22 = (mb_h, mb_w, y, u, v, *fetch,
               inter.make_qtab_p(26, tables.chroma_qp(26), dev), *mvs)
        for n, kw in ((1, kw1), (2, kw2)):
            err = max(err, exact(
                f"K22 b_inter_mb pass {n} {mb_h}x{mb_w} MBs",
                inter.b_inter_mb(*a22, **kw),
                inter.b_inter_mb_plain(*a22, **kw)))
    print("K5 exact one MB wide, one MB tall, at 2 x 3 and 1 x 1 MBs at R "
          "4 / 16 / 24 on a moved and a flat reference with a zero and a "
          "wide predictor; K6 without the trellis and K22's two passes "
          "exact there (K6 at t8 0 / 1 / 2, a QP map, lossless, NR, two "
          "references)", flush=True)
    return err


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


# The CPU reference runs of every phase: each phase queues its run here,
# with what the card gave, and the runs go at the end of the script to a
# pool of worker processes (the plain versions are bound by Python's
# serial work, not by torch's threads), after every card measurement.
CPU_CHECKS = []
CPU_WORKERS = 6


def _card_frames(done, n: int) -> list:
    """The first n encoded frames as (type, display index, payload, recon
    planes on the host)."""
    return [(e.frame_type, e.display_idx, e.payload,
             [getattr(e.recon, pl).cpu().numpy() for pl in "yuv"])
            for e in done[:n]]


def _cpu_run(job):
    """One CPU reference run, in a worker: Encoder(device=...) on the
    frames; "ip" encodes n frames and flushes, "b" feeds frames until n
    are queued in encode order and finishes its pipe without flush()
    (which would turn a queued B candidate into a P and queue more).
    Returns (headers, the frames as _card_frames gives them, the last
    IDR's branch)."""
    import x264_tpu_torch
    torch.set_num_threads(1)
    kind, make, margs, frames, n, frame_parallel, device = job
    cpu = x264_tpu_torch.Encoder(
        make(x264_tpu_torch.EncoderParams, frame_parallel, *margs),
        device=device)
    header = cpu.headers()
    refs = []
    if kind == "ip":
        refs = [cpu.encode(f) for f in frames[:n]]
        refs = [r for r in refs if r is not None] + cpu.flush()
    else:
        for f in frames:
            if cpu.frame_count >= n:
                break
            ef = cpu.encode(f)
            if ef is not None:
                refs.append(ef)
        while len(refs) < n:
            refs.append(cpu._finalize(cpu._pending.pop(0)))
    return header, _card_frames(refs, n), cpu.last_idr_branch


def same_as_cpu(x264_tpu_torch, done, frames, header, n: int, keyint: int,
                what: str, subme: int = 1, scenecut: int = 0,
                make=None, frame_parallel: int = 1, device="cpu",
                branch=None) -> None:
    """Queue the check of the first n frames of a card run against
    Encoder(device="cpu") on those n frames (then flushed);
    make(EncoderParams, frame_parallel) builds other parameters than
    params(). Under CRF / ABR a frame's QP depends on the pipe's depth,
    so the CPU run then takes the card run's frame_parallel. device: the
    CPU run's (a list: its bands'); branch: the synchronous CAVLC IDR's
    branch the CPU run must also take."""
    job = ("ip", make or params, () if make else (keyint, subme, scenecut),
           list(frames[:n]), n, frame_parallel, device)
    CPU_CHECKS.append((what, job, header, _card_frames(done, n), branch))


def same_as_cpu_b(x264_tpu_torch, done, frames, header, n: int, what: str,
                  make, device="cpu") -> None:
    """Queue the check of the first n frames in encode order of a card run
    with B frames against Encoder(device="cpu") at the card run's pipe
    depth, fed the same frames until it has queued n of them (_cpu_run's
    "b"). device: as same_as_cpu's."""
    job = ("b", make, (), list(frames[:n + 4]), n, 3, device)
    CPU_CHECKS.append((what, job, header, _card_frames(done, n), None))


def run_cpu_checks() -> None:
    """Every queued CPU reference run, CPU_WORKERS at a time in spawned
    worker processes (no CUDA in them), each held against its card run:
    headers, frame types and display order, payloads, recons."""
    import multiprocessing
    stamp(f"the CPU runs: {len(CPU_CHECKS)} on {CPU_WORKERS} workers")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(CPU_WORKERS, len(CPU_CHECKS))) as pool:
        results = pool.imap(_cpu_run, [c[1] for c in CPU_CHECKS])
        for (what, _, header, card, branch), (cpu_header, refs, cpu_branch) \
                in zip(CPU_CHECKS, results):
            if cpu_header != header:
                fail(f"{what}: headers differ between the card and the CPU")
            if branch is not None and cpu_branch != branch:
                fail(f"{what}: the CPU run took the {cpu_branch} branch, the "
                     f"card the {branch}")
            for i, (ref, k) in enumerate(zip(refs, card)):
                if ref[:2] != k[:2]:
                    fail(f"{what}: frame {i} in encode order is {k[:2]} on "
                         f"the card, {ref[:2]} on the CPU")
                if ref[2] != k[2]:
                    fail(f"{what}: frame {i} payload differs from the CPU "
                         f"run")
                for pl, a, b in zip("yuv", ref[3], k[3]):
                    if not np.array_equal(a, b):
                        fail(f"{what}: frame {i} recon {pl} differs from the "
                             f"CPU run")
            if len(refs) != len(card):
                fail(f"{what}: {len(refs)} CPU frames for {len(card)}")
            print(f"{what}: frames 0-{len(card) - 1} in encode order "
                  f"({[r[0] for r in refs]}, display {[r[1] for r in refs]})"
                  f" equal the CPU run", flush=True)
    stamp("the CPU runs: done")


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


def k10_edges(y, ref_y, exact) -> int:
    """K10 exact against its plain version on its edge inputs, on the
    7 x 5 MBs at the top left of y over those of ref_y (block counts that
    do not fill the last CTA): a flat source over a flat reference at lam
    0 (every cost equal: candidate 0 must win), MVs into the pad from the
    crop's corners (fetch starts that wrap and clamp), and a reference
    per block (per MB for the layouts) mixing two references' planes; at
    steps (2,) and (2, 1), subpel_refine_blocks on every shape and
    subpel_refine_parts on the layouts with and without P8x8. Returns
    the max error, 0."""
    from x264_tpu_torch.encoder import inter
    from x264_tpu_torch.ops import mc, me
    hh, ww, dev = 5, 7, y.device
    i32 = dict(dtype=torch.int32, device=dev)
    rng = np.random.default_rng(10)
    yc = y[:hh * 16, :ww * 16].contiguous()
    rc = ref_y[:hh * 16, :ww * 16].contiguous()
    hp = lambda p: mc.hpel_planes(mc.pad_plane(p))
    flat = torch.full_like(yc, 77)
    two = torch.cat([hp(rc), hp(torch.flip(rc, (0, 1)).contiguous())])
    mvp = torch.as_tensor(rng.integers(-12, 13, (hh, ww, 2)), **i32)

    def mvs(n, corners):
        mv = rng.integers(-3, 4, (n, hh, ww, 2)) * 4
        if corners:
            mv = rng.integers(-44, 45, (n, hh, ww, 2)) * 4 \
                + rng.integers(0, 4, (n, hh, ww, 2))
            far = 4 * (36 + 4 * np.arange(n))
            for r, c in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
                mv[:, r, c, 0] = far if c else -far
                mv[:, r, c, 1] = far if r else -far
        return torch.as_tensor(mv, **i32)

    shapes = ((16, 16, ((0, 0),), None),) + inter.PART_LAYOUTS
    for steps in ((2,), (2, 1)):
        for case in ("flat", "corners", "ref2"):
            src, pl, lam = (flat, hp(flat), 0) if case == "flat" else \
                (yc, two if case == "ref2" else hp(rc), 4)
            for bh, bw, offs, _ in shapes:
                n = len(offs)
                ys, xs = me.block_origins(hh, ww, offs, dev)
                sel = torch.as_tensor(rng.integers(0, 2, (n, hh, ww)), **i32) \
                    if case == "ref2" else None
                mv = mvs(n, case == "corners")
                a = (src, pl, mv, lam, mvp.expand(n, hh, ww, 2).contiguous(),
                     ys, xs, bh, bw, steps, sel)
                k = me.subpel_refine_blocks(*a)
                exact(f"K10 subpel_refine {bh}x{bw} {steps} ({case})", k,
                      me.subpel_refine_blocks_plain(*a))
                first = torch.as_tensor(me.subpel_offsets(steps)[0], **i32)
                if case == "flat" and not torch.equal(k[0], mv + first):
                    fail("K10 on flat content: candidate 0 did not win")
            for nk in (4, 8):
                pf = mvs(nk, case == "corners")
                sel = torch.as_tensor(rng.integers(0, 2, (hh, ww)), **i32) \
                    if case == "ref2" else None
                got = me.subpel_refine_parts(src, pl, pf, lam, mvp, steps,
                                             sel)
                for (bh, bw, offs, (a, b)), g in zip(inter.PART_LAYOUTS, got):
                    n = len(offs)
                    ys, xs = me.block_origins(hh, ww, offs, dev)
                    exact(f"K10 subpel_refine_parts {bh}x{bw} {steps} "
                          f"({case}, {nk} rows)", g,
                          me.subpel_refine_blocks_plain(
                              src, pl, pf[a:b], lam,
                              mvp.expand(n, hh, ww, 2), ys, xs, bh, bw,
                              steps, None if sel is None
                              else sel.expand(n, hh, ww)))
    print("K10 exact on flat content at lam 0, MVs into the pad from the "
          "corners and a mixed reference, at steps (2,) and (2, 1), "
          "every shape and both layout sets", flush=True)
    return 0


# kernel name fragment -> the port's kernel it belongs to (device time
# of everything else is PyTorch's own glue: padding, copies, merges)
KERNEL_GROUPS = (("hwpack_", "K27"), ("halo_kernel", "K28"),
                 ("intra_diag_kernel", "K1"), ("deblock_diag_kernel", "K2"),
                 ("p_emit_kernel", "K8"), ("p_maps_kernel", "K8 pass A"),
                 ("b_emit_kernel", "K24"), ("b_maps_kernel", "K24 pass A"),
                 ("bcost_kernel", "K21"), ("provisional_kernel", "K23"),
                 ("wave_kernel", "K23"), ("inter_mb_kernel<0>", "K6"),
                 ("inter_mb_kernel<1>", "K22"),
                 ("inter_mb_kernel<2>", "K22"),
                 ("inter_mb_trellis_kernel<0>", "K6"),
                 ("inter_mb_trellis_kernel<1>", "K22"),
                 ("inter_mb_trellis_kernel<2>", "K22"),
                 ("emit_kernel", "K3"),
                 ("scan_kernel", "K3/K8/K18/K19/K25 scan"),
                 ("scatter_kernel", "K3/K8 scatter"), ("metrics_kernel", "K4"),
                 ("half_kernel", "K5"), ("search_kernel", "K5"),
                 ("sweep0_kernel", "K7"), ("list_sweep_kernel", "K7"),
                 ("decide_kernel", "K7"), ("hpel_kernel", "K9"),
                 ("subpel_kernel", "K10"), ("subpel_parts_kernel", "K10"),
                 ("part_kernel", "K11"),
                 ("rerank_kernel", "K12"), ("rd_inter_kernel", "K13"),
                 ("lowres_kernel", "K14"), ("cost_kernel", "K15"),
                 ("aq_qp_kernel", "K16"), ("dqp_kernel", "K17"),
                 ("i_counts_kernel", "K18"), ("i_bits_kernel", "K18"),
                 ("i_write_kernel", "K18"),
                 # K19's and K25's passes: one template, instantiated on
                 # each slice's planes
                 ("PPlanes>(", "K19"), ("BPlanes>(", "K25"),
                 ("trellis_kernel", "K20"), ("fullpel_kernel", "K29"),
                 ("hadamard_ac_kernel", "K30"))


def device_split(x264_tpu_torch, frames, n_warm: int, n: int,
                 subme: int, scenecut: int = 0, make=None,
                 tag: str = "bench.py's defaults", device=None) -> None:
    """Device time by kernel over n steady IPPP frames, from a
    torch.profiler trace of the card (CUPTI sees the ctypes launches
    too): per frame, each kernel's share, PyTorch's glue, the busy sum
    and the host wall; the idle share is 1 - busy / wall. make: as in
    same_as_cpu; device: the Encoder's."""
    from torch.profiler import ProfilerActivity, profile
    enc = x264_tpu_torch.Encoder(
        make(x264_tpu_torch.EncoderParams, 3) if make else
        params(x264_tpu_torch.EncoderParams, 3, 250, subme, scenecut),
        device=device)
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
    if make is None:
        tag = f"subme {subme} scenecut {scenecut}"
    print(f"device split at {tag} over {n} "
          f"frames (profiled; the "
          f"{len(frames[:n_warm])} frames before are not in it, the flush "
          f"is): per frame ms "
          f"{parts}; busy {busy / n:.3f} ms of {wall / n:.3f} ms wall, "
          f"idle share {1 - busy / wall:.3f}", flush=True)


def ippp_report(done, summary, st, fps, med, n: int, subme: int,
                smi_line: str, nmb: int, extra: str = "",
                idrs=(0,), rc: str = f"CQP {QP}",
                entropy: str = "CABAC") -> None:
    """Check an IPPP run's frame types (IDRs at `idrs` only) and print its
    end-to-end line; rc: the rate control's name."""
    types = [e.frame_type for e in done]
    if types != ["IDR" if i in idrs else "P" for i in range(n)]:
        fail(f"IPPP subme {subme} frame types {types}")
    p_bytes = [len(e.payload) for i, e in enumerate(done) if i not in idrs]
    n_p = n - len(idrs)             # the IDRs' MBs are all intra
    p_intra = (st.mb_intra - len(idrs) * nmb) / n_p
    p_skip = st.mb_skip / n_p
    print(f"IPPP path: {n} frames {W}x{H} keyint 250 subme {subme} ref 1 "
          f"{rc} {entropy}, {fps:.3f} fps, median encode() {med:.1f} ms, "
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
    from x264_tpu_torch.encoder import aq, inter, intra, lookahead, pipeline
    from x264_tpu_torch.encoder import ratecontrol, stats
    from x264_tpu_torch.encoder.core import pad_plane
    from x264_tpu_torch.entropy import cabac as ecabac
    from x264_tpu_torch.entropy import cabac_planes
    from x264_tpu_torch.entropy import cabac_tables as ctab
    from x264_tpu_torch.entropy import device as cavlc
    from x264_tpu_torch.entropy.bitstream import BitWriter
    from x264_tpu_torch.headers import SLICE_B, SLICE_I, SLICE_P, SliceHeader
    from x264_tpu_torch.ops import dct as odct
    from x264_tpu_torch.ops import deblock, mc, me
    from x264_tpu_torch.ops import pixel as opixel
    from x264_tpu_torch.ops import quant as oquant
    from x264_tpu_torch.ops import trellis as otrellis
    from x264_tpu_torch import log as xlog
    from x264_tpu_torch.parallel import rows as prows

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
    # the registers, local memory and resident CTAs of K6 / K22, K5, K20
    # and K10-K12 as the card holds them
    from x264_tpu_torch.tools import kernel_resources
    for line in kernel_resources.report(("inter", "me", "trellis", "subpel"),
                                        (cuda.BUILD_DIR,)):
        print(f"resources: {line}", flush=True)

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
    # one launch a call, the same sum from call to call (the last CTA adds
    # the partials in a fixed order)
    n4 = stats.frame_metrics.launches
    again = [stats.frame_metrics(y, u, v, ry, ru, rv, W, H) for _ in range(20)]
    if stats.frame_metrics.launches != n4 + 20:
        fail(f"K4 frame_metrics counted {stats.frame_metrics.launches - n4} "
             f"launches in 20 calls")
    if not all(torch.equal(m_k, m) for m in again):
        fail("K4 frame_metrics differs from call to call")
    ms4 = event_ms(lambda: stats.frame_metrics(y, u, v, ry, ru, rv, W, H), 20)
    # no single PyTorch call computes the four metrics; the luma SSD alone
    # is timed as an aside
    ssd4 = event_ms(lambda: torch.sum((y - ry) ** 2), 20)
    record("frame_metrics", "cuda", "x264_tpu_torch/csrc/metrics.cu",
           "x264_tpu/encoder/pipeline.py:32", err4, ms4, plain4_ms,
           nbytes(y, u, v, ry, ru, rv) + 16, K4_OPS_PER_PX * H * W)
    print(f"K4 frame_metrics: bit-identical in 20 calls, one launch each; "
          f"aside, the luma SSD alone as torch.sum((y - ry) ** 2) "
          f"{ssd4:.3f} ms [{smi_line}]", flush=True)

    q1 = enqueue_ms(lambda: intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab,
                                                   lam), 5)
    q2 = enqueue_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work, *maps), 5,
                    setup=fresh)
    _, n1 = counted(intra.encode_i16_frame, mb_h, mb_w, y, u, v, qtab, lam)
    fresh()
    _, n2 = counted(deblock.deblock_frame, mb_h, mb_w, *work, *maps)
    print(f"host enqueue of one frame's launches: intra_diag {q1:.3f} ms "
          f"({n1} launches), deblock_diag {q2:.3f} ms ({n2} launch); "
          f"{smi_line}", flush=True)

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
        print(f"K7 intra_in_p per launch ({tag}, the SATD decision): "
              f"{split_text(launch_split(lambda: inter.intra_in_p(*a7)))} ms "
              f"[{smi_line}]", flush=True)
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
        # the row wavefront's memory ordering: a fault shows only now and
        # then, so 20 more runs on fresh copies, each exact
        bad = 0
        for _ in range(20):
            fresh2()
            bad += max_err(dict(zip("yuv", deblock.deblock_frame(
                mb_h, mb_w, *work2, *maps2))), p2p) != 0
        if bad:
            fail(f"K2 deblock_diag with P maps differs from its plain "
                 f"version in {bad} of 20 runs")
        q2p = enqueue_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work2,
                                                       *maps2), 5,
                         setup=fresh2)
        # a band's size: the first 17 MB rows of the same inputs
        bh = min(17, mb_h)
        rows = lambda t, mbs: t[:mbs].contiguous()
        src_band = [rows(t, bh * n) for t, n in zip(src2, (16, 8, 8))]
        maps_band = (rows(qp_mb1, bh), rows(front["intra_mb"], bh),
                     *(rows(t, 4 * bh) for t in (maps["nnz4"], maps["ref4"],
                                                 maps["mv4"], z4, zmv)),
                     False, 0, 0, 0)
        p_band = dict(zip("yuv", deblock.deblock_frame_plain(
            bh, mb_w, *src_band, *maps_band)))
        k_band, n_band = counted(deblock.deblock_frame, bh, mb_w,
                                 *[t.clone() for t in src_band], *maps_band)
        if max_err(dict(zip("yuv", k_band)), p_band):
            fail(f"K2 deblock_diag at {bh} MB rows differs from its plain "
                 f"version")
        work_band = []
        ms2band = event_ms(
            lambda: deblock.deblock_frame(bh, mb_w, *work_band, *maps_band),
            5, setup=lambda: work_band.__setitem__(
                slice(None), [t.clone() for t in src_band]))
        print(f"kernel deblock_diag with P maps: {ms2p:.3f} ms, exact in 21 "
              f"runs, host enqueue {q2p:.3f} ms; at {bh} MB rows (a band) "
              f"{ms2band:.3f} ms, exact, {n_band} launch; {smi_line}",
              flush=True)
        # K5 at R 4 and 24 (coarse radius 3 and 13) and on a flat
        # reference (every SAD of a window equal), then split by launch
        for r5, ref5, what in ((4, ref_pad, "R 4"), (24, ref_pad, "R 24"),
                               (me_range, torch.full_like(ref_pad, 117),
                                "a flat reference")):
            a5x = (y1, ref5, mb_h, mb_w, r5, lam, mvp0)
            if max_err(dict(zip(("mv", "sad"), me.hier_search(*a5x))),
                       dict(zip(("mv", "sad"), me.hier_search_plain(*a5x)))):
                fail(f"K5 me_hier ({tag}, {what}) differs from its plain "
                     f"version")
        split5 = launch_split(lambda: me.hier_search(*a5),
                              ("half_kernel", "search_kernel"))
        print(f"K5 me_hier ({tag}): exact at R 4, 16 and 24 and on a flat "
              f"reference; per launch at R {me_range}: {split_text(split5)} "
              f"ms [{smi_line}]", flush=True)
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
    # (a launch each through subpel_refine_blocks) and on the three in the
    # one launch of subpel_refine_parts that a P frame runs
    ys16, xs16 = me.mb_origins(mb_h, mb_w, dev)
    err10 = 0
    for steps in ((2,), (2, 1)):
        a16 = (y1, planes, mv_fp, lam, mvp0, ys16, xs16, 16, 16, steps)
        k10 = me.subpel_refine_blocks(*a16)
        err10 = max(err10, exact(f"K10 subpel_refine 16x16 {steps}", k10,
                                 me.subpel_refine_blocks_plain(*a16)))
    mv_s, satd_s = k10
    pf = me.partition_fullpel(y1, ref_pad2, mv_fp, lam, mvp0, me_range, True)
    lay10 = []
    for bh, bw, offs, (a, b) in inter.PART_LAYOUTS:
        ysb, xsb = me.block_origins(mb_h, mb_w, offs, dev)
        mvpb = mvp0.expand(len(offs), mb_h, mb_w, 2).contiguous()
        a10 = (y1, planes, pf[a:b].contiguous(), lam, mvpb, ysb, xsb, bh, bw,
               (2, 1))
        err10 = max(err10, exact(f"K10 subpel_refine {bh}x{bw}",
                                 me.subpel_refine_blocks(*a10),
                                 me.subpel_refine_blocks_plain(*a10)))
        lay10.append(a10)
    parts10 = (y1, planes, pf, lam, mvp0, (2, 1))
    n0 = me.subpel_refine_parts.launches
    kp10 = me.subpel_refine_parts(*parts10)
    if me.subpel_refine_parts.launches != n0 + 1:
        fail("K10's partition layouts did not count their one launch")
    for a10, got in zip(lay10, kp10):
        err10 = max(err10, exact(
            f"K10 subpel_refine_parts {a10[7]}x{a10[8]}", got,
            me.subpel_refine_blocks_plain(*a10)))
    err10 = max(err10, k10_edges(y1, ry, exact))
    ms16 = event_ms(lambda: me.subpel_refine_blocks(*a16), 10)
    ms_lay = [event_ms(lambda a=a: me.subpel_refine_blocks(*a), 10)
              for a in lay10]
    ms_parts = event_ms(lambda: me.subpel_refine_parts(*parts10), 10)
    pl10 = sum(event_ms(lambda a=a: me.subpel_refine_blocks_plain(*a), 1)
               for a in (a16, *lay10))
    print("kernel subpel_refine per call at (2, 1): 16x16 "
          f"{ms16:.3f} ms, " + ", ".join(
              f"{a[7]}x{a[8]} (bh x bw) {t:.3f} ms"
              for a, t in zip(lay10, ms_lay))
          + f"; the three layouts in one launch {ms_parts:.3f} ms (their "
          f"three launches {sum(ms_lay):.3f}); a P frame's K10 "
          f"{ms16 + ms_parts:.3f} ms in 2 launches [{smi_line}]", flush=True)
    record("subpel_refine", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:217", err10, ms16 + ms_parts, pl10,
           nbytes(y1, planes, mv_fp, mvp0, ys16, xs16) + 12 * nmb
           + nbytes(y1, planes, pf, mvp0) + 12 * pf[..., 0].numel(),
           K10_OPS_PER_CAND_4X4 * 49 * nmb
           * (16 + sum(a[7] * a[8] // 16 * a[5].shape[0] for a in lay10)))
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
    k_ms = dict(K5=p_ms["k5"], K9=ms9, K10=ms16 + ms_parts, K11=ms11,
                K12=ms12, K6=ms6, K7=p_ms["k7"], K8=ms8, K2=p_ms["k2"], K4=ms4)
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

    def spied_front(ref, qt, rd: bool, t8: bool, names, qp_map=None):
        """encode_p_front at subme 6 (rd) or 5 on frame 1 against ref, with
        or without the 8x8 transform (and with qp_map, variance AQ's
        per-MB QPs), and the arguments of its calls of the wrappers
        `names`."""
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
                                     True, True, rd, t8, qp_map)
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
        if len(a7) != 14 or a7[12] is None:
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
        print(f"K7 intra_in_p per launch ({tag}, the RD decision): "
              f"{split_text(launch_split(lambda: inter.intra_in_p(*a7)))} ms; "
              f"the SATD decision on the same inputs "
              f"{split_text(launch_split(lambda: inter.intra_in_p(*a7[:12])))}"
              f" ms [{smi_line}]", flush=True)
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
    k7_edges(dev, exact)
    k5_k6_edges(dev, exact)
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
          f"{cabac_b:.3f} ms; {smi_line}", flush=True)

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
            k6o=event_ms(lambda: inter.p_inter_mb(*a6r[:12]), 10),
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

    # ------------------------------------------------------ variance AQ
    stamp("phase 3: variance AQ's kernels")
    # K16 aq_qp_map on frame 0 and on a frame that is half flat, half noise
    a16 = (y, u, v, mb_h, mb_w, QP, 1.0, 10, 51, 0)
    k16 = aq.qp_map_from_planes(*a16)
    err16 = exact("K16 aq_qp_map (frame 0)", k16,
                  aq.qp_map_from_planes_plain(*a16))
    qm0 = k16[0]
    yh, uh, vh = frame_planes(half_flat_frame(W, H, x264_tpu_torch.Frame))
    a16h = (yh, uh, vh, mb_h, mb_w, QP, 1.0, 10, 51, 0)
    k16h = aq.qp_map_from_planes(*a16h)
    err16 = max(err16, exact("K16 aq_qp_map (half flat)", k16h,
                             aq.qp_map_from_planes_plain(*a16h)))
    spread = [int(q.max() - q.min()) for q in (qm0, k16h[0])]
    if spread[1] < 6:
        fail(f"K16 spread the half-flat frame's QPs over {spread[1]} only")
    ms16 = event_ms(lambda: aq.qp_map_from_planes(*a16), 20)
    pl16 = event_ms(lambda: aq.qp_map_from_planes_plain(*a16), 3)
    record("aq_qp_map", "cuda", "x264_tpu_torch/csrc/aq.cu",
           "x264_tpu/encoder/aq.py:43", err16, ms16, pl16,
           nbytes(y, u, v, *k16), K16_OPS_PER_MB * nmb)
    # K16's device log against the plain version, every float32 in
    # [1, 2^23) (the plain version runs on the card's tensors)
    t = time.perf_counter()
    log_diffs = 0
    for e in range(23):
        xs = (torch.arange(1 << 23, dtype=torch.int32, device=dev)
              | ((127 + e) << 23)).view(torch.float32)
        log_diffs += int((aq.xla_log_f32(xs).view(torch.int32)
                          != aq.xla_log_f32_plain(xs).view(torch.int32))
                         .sum())
    if log_diffs:
        fail(f"K16's device log differs from the plain version on "
             f"{log_diffs} float32 values in [1, 2^23)")
    print(f"K16 aq_qp_map: exact on frame 0 (QP spread {spread[0]}) and on "
          f"the half-flat frame (spread {spread[1]}); its device log equals "
          f"the plain version on all {23 << 23} float32 values in "
          f"[1, 2^23) ({time.perf_counter() - t:.2f} s)", flush=True)
    # K17 dqp_syntax on seeded maps, with an all-false and an all-true row
    rng17 = np.random.default_rng(17)
    qm17 = torch.as_tensor(rng17.integers(10, 52, (mb_h, mb_w)),
                           dtype=torch.int32, device=dev)
    has17 = torch.as_tensor(rng17.random((mb_h, mb_w)) < 0.6, device=dev)
    has17[3], has17[4] = False, True
    has17[0, :5] = False
    err17 = 0
    for sq in (23, 51):
        err17 = max(err17, exact(f"K17 dqp_syntax (slice QP {sq})",
                                 aq.dqp_syntax(qm17, has17, sq),
                                 aq.dqp_syntax_plain(qm17, has17, sq)))
    ms17 = event_ms(lambda: aq.dqp_syntax(qm17, has17, 23), 20)
    pl17 = event_ms(lambda: aq.dqp_syntax_plain(qm17, has17, 23), 3)
    record("dqp_syntax", "cuda", "x264_tpu_torch/csrc/aq.cu",
           "x264_tpu/encoder/aq.py:65", err17, ms17, pl17,
           nbytes(qm17, has17) + 9 * nmb, K17_OPS_PER_MB * nmb)
    # K1 + K17 + K3 + K2 with frame 0's QP map (I8x8 on)
    stacks = aq.qtab_stacks(aq.full_tables(tables.DEFAULT_QUANT, dev), 0)
    qtab_aq = {**qtab, "aq_stack": stacks["intra"]}
    a1a = (mb_h, mb_w, y, u, v, qtab_aq, lam, True, qm0)
    k1a = intra.encode_i16_frame(*a1a)
    torch.cuda.synchronize()
    p1a = {}
    pl1a = event_ms(lambda: p1a.update(intra.encode_i16_frame_plain(*a1a)), 1)
    err1a = exact("K1 intra_diag with a QP map", k1a, p1a)
    ms1a = event_ms(lambda: intra.encode_i16_frame(*a1a), 3)
    record("intra_diag_aq", "cuda", "x264_tpu_torch/csrc/intra.cu",
           "x264_tpu/encoder/intra.py:335", err1a, ms1a, pl1a,
           nbytes(y, u, v, qm0, stacks["intra"]) + nbytes(*k1a.values()),
           K1_I8X8_OPS_PER_MB * nmb)
    cnz = (k1a["chroma_ac"][..., 1:] != 0).flatten(2).any(-1) \
        | (k1a["chroma_dc"] != 0).flatten(2).any(-1)
    has1 = ~k1a["i4_mb"] | (k1a["cbp_luma_bits"] > 0) | cnz
    k1a["dqp"], qeff1, k1a["dqp_prev_nz"] = aq.dqp_syntax(qm0, has1, QP)
    exact("K17 dqp_syntax on frame 0", [k1a["dqp"], qeff1,
                                        k1a["dqp_prev_nz"]],
          aq.dqp_syntax_plain(qm0, has1, QP))
    ops_a, nk_a = cabac_planes.i_slice_ops(k1a, mb_h, mb_w, True)
    pl3a = {}
    pl3a_ms = event_ms(lambda: pl3a.update(zip(("ops", "n"), (
        cabac_planes.i_slice_ops_plain(k1a, mb_h, mb_w, True)))), 1)
    n_ops_a = int(pl3a["n"])
    if int(nk_a) != n_ops_a:
        fail(f"K3 cabac_i_ops with dqp counts {int(nk_a)} ops, its plain "
             f"version {n_ops_a}")
    err3a = exact("K3 cabac_i_ops with dqp", [ops_a[:n_ops_a]],
                  [pl3a["ops"][:n_ops_a]])
    ms3a = event_ms(lambda: cabac_planes.i_slice_ops(k1a, mb_h, mb_w, True),
                    20)
    record("cabac_i_ops_aq", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/entropy/cabac_planes.py:148", err3a, ms3a, pl3a_ms,
           nbytes(*(k1a[k] for k in keys3b + ("dqp", "dqp_prev_nz")))
           + 4 * n_ops_a + 4, K3_OPS_PER_OP * n_ops_a + K3_OPS_PER_MB * nmb)
    maps_a = (qeff1, intra_mb, z4, z4, zmv, z4, zmv, False, 0, 0, 0,
              k1a["t8_mb"])
    src_a = (k1a["recon_y"], k1a["recon_u"], k1a["recon_v"])
    exact("K2 deblock_diag on the effective QP map", dict(zip(
        "yuv", deblock.deblock_frame(mb_h, mb_w, *[t.clone() for t in src_a],
                                     *maps_a))), dict(zip(
        "yuv", deblock.deblock_frame_plain(mb_h, mb_w, *[t.clone() for t in
                                                         src_a], *maps_a))))
    n_dqp1 = int((k1a["dqp"] != 0).sum())
    print(f"AQ IDR kernels exact on frame 0: QPs {int(qm0.min())}-"
          f"{int(qm0.max())}, {n_dqp1} of {nmb} MBs code a nonzero "
          f"mb_qp_delta, {int(k1a['t8_mb'].sum())} I8x8 MBs; K1 with the QP "
          f"map {ms1a:.3f} ms, {n_ops_a} ops", flush=True)
    # K6 / K7 / K8 (K17 between its passes) / K2 with frame 1's QP map,
    # subme 6 with the 8x8 transform: frame 1 against frame 0's recon and
    # against the gray-masked reference
    qm1 = aq.qp_map_from_planes(y1, u1, v1, mb_h, mb_w, QP, 1.0, 10, 51,
                                0)[0]
    qtab_rd_aq = {**qtab_rd, "aq_stack": stacks["intra"],
                  "aq_stack_p": stacks["inter"]}
    aq_ms = {}
    for ref, tag in (((ry, ru, rv), "frame 1 on frame 0"),
                     (mixed, "frame 1 on the 30%-gray reference")):
        fra, sa = spied_front(ref, qtab_rd_aq, True, True,
                              ("p_inter_mb", "intra_in_p"), qm1)
        a6a, a7a = sa["p_inter_mb"][0], sa["intra_in_p"][0]
        if a6a[-1] is None or a7a[-1] is None:
            fail("encode_p_front did not pass K6 / K7 the QP map")
        k6a = inter.p_inter_mb(*a6a)
        err6a = exact(f"K6 p_inter_mb with a QP map ({tag})", k6a,
                      inter.p_inter_mb_plain(*a6a))
        k7a = inter.intra_in_p(*a7a)
        err7a = exact(f"K7 intra_in_p with a QP map ({tag})", k7a,
                      inter.intra_in_p_plain(*a7a))
        kmaps, kops, kn = cabac_planes.cabac_p_ops(fra, mb_h, mb_w,
                                                   t8_mode=True,
                                                   aq=(qm1, QP))
        pmaps, pops, pn = cabac_planes.cabac_p_ops_plain(fra, mb_h, mb_w,
                                                         True, (qm1, QP))
        n_opsa = int(pn)
        if int(kn) != n_opsa:
            fail(f"K8 cabac_p_ops with dqp ({tag}) counts {int(kn)} ops, "
                 f"its plain version {n_opsa}")
        err8a = max(exact(f"K8 cabac_p_ops maps with dqp ({tag})", kmaps,
                          pmaps),
                    exact(f"K8 cabac_p_ops ops with dqp ({tag})",
                          [kops[:n_opsa]], [pops[:n_opsa]]))
        maps2a = (pmaps["qp_eff"], fra["intra_mb"], kmaps["nnz4"],
                  kmaps["ref4"], kmaps["mv4"], z4, zmv, False, 0, 0, 0,
                  kmaps["t8_mb"])
        srca = (fra["recon_y"], fra["recon_u"], fra["recon_v"])
        exact(f"K2 deblock_diag on the P effective QP map ({tag})", dict(zip(
            "yuv", deblock.deblock_frame(mb_h, mb_w,
                                         *[t.clone() for t in srca],
                                         *maps2a))), dict(zip(
            "yuv", deblock.deblock_frame_plain(mb_h, mb_w, *srca, *maps2a))))
        n_dqp = int((pmaps["dqp"] != 0).sum())
        print(f"AQ P kernels ({tag}): exact; QPs {int(qm1.min())}-"
              f"{int(qm1.max())}, {n_dqp} MBs code a nonzero mb_qp_delta, "
              f"{int(fra['intra_mb'].sum())} intra and "
              f"{int(pmaps['skip'].sum())} skip MBs, {n_opsa} ops",
              flush=True)
        if n_dqp == 0:
            fail(f"no P MB coded a nonzero mb_qp_delta ({tag})")
        if aq_ms:
            continue
        aq_ms.update(
            k6=event_ms(lambda: inter.p_inter_mb(*a6a), 10),
            pl6=event_ms(lambda: inter.p_inter_mb_plain(*a6a), 1),
            k7=event_ms(lambda: inter.intra_in_p(*a7a), 10),
            pl7=event_ms(lambda: inter.intra_in_p_plain(*a7a), 1),
            k8=event_ms(lambda: cabac_planes.cabac_p_ops(
                fra, mb_h, mb_w, t8_mode=True, aq=(qm1, QP)), 20),
            pl8=event_ms(lambda: cabac_planes.cabac_p_ops_plain(
                fra, mb_h, mb_w, True, (qm1, QP)), 1))
        record("p_inter_mb_aq", "cuda", "x264_tpu_torch/csrc/inter.cu",
               "x264_tpu/encoder/inter.py:249", err6a, aq_ms["k6"],
               aq_ms["pl6"], nbytes(*a6a[2:10], stacks["inter"], qm1,
                                    *k6a.values()), K6_T8_OPS_PER_MB * nmb)
        n_intra_a = int(k7a["intra_mb"].sum())
        record("intra_in_p_aq", "cuda", "x264_tpu_torch/csrc/intra_p.cu",
               "x264_tpu/encoder/inter.py:252", err7a, aq_ms["k7"],
               aq_ms["pl7"], nbytes(*a7a[2:9], *a7a[12], stacks["intra"],
                                    qm1, *k7a.values()),
               K7_OPS_PER_MB_SWEEP * (nmb + 2 * n_intra_a)
               + K7_RD_OPS_PER_MB * nmb)
        record("cabac_p_ops_aq", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
               "x264_tpu/entropy/cabac_planes.py:699", err8a, aq_ms["k8"],
               aq_ms["pl8"],
               nbytes(*(fra[k] for k in keys8 + ("t8_sel", "luma8_z")),
                      *kmaps.values()) + 4 * n_opsa + 4,
               K3_OPS_PER_OP * n_opsa + K3_OPS_PER_MB * nmb
               + K17_OPS_PER_MB * nmb)

    # ---------------------------------------------------------- trellis
    stamp("phase 3: the trellis's kernels")
    zig4 = torch.as_tensor(tables.ZIGZAG4, device=dev).long()
    zig8 = torch.as_tensor(tables.ZIGZAG8, device=dev).long()
    cqm = {2: tables.CQM_4PY, 3: tables.CQM_4PC, 4: tables.CQM_4PC,
           5: tables.CQM_8PY}

    def trellis_coefs(src, pred):
        """The forward-transform coefficients, in scan order, of each
        trellis category of the residual src - pred (planes): cat 2 the
        luma 4x4 blocks, cat 5 the luma 8x8 blocks, cat 4 the chroma AC
        (zig-zag positions 1..15) and cat 3 the chroma DC Hadamard, both
        channels."""
        d = inter._tiles(src[0], 16) - inter._tiles(pred[0], 16)
        c2 = odct.dct4x4(intra._blocks4(d, 4)).reshape(-1, 16)[:, zig4]
        c5 = odct.dct8x8(d.reshape(-1, 2, 8, 2, 8).transpose(2, 3)) \
            .reshape(-1, 64)[:, zig8]
        cc = [odct.dct4x4(intra._blocks4(inter._tiles(a, 8)
                                         - inter._tiles(b, 8), 2))
              for a, b in zip(src[1:], pred[1:])]
        c4 = torch.cat([c.reshape(-1, 16)[:, zig4][:, 1:] for c in cc])
        c3 = torch.cat([odct.hadamard2x2(c[..., 0, 0]).reshape(-1, 4)
                        for c in cc])
        return {c: t.to(torch.int32).contiguous()
                for c, t in ((2, c2), (3, c3), (4, c4), (5, c5))}

    def trellis_ops(cats, qmfs):
        """The trellis's operations on this data: K20_OPS_PER_CAND for each
        candidate level scored (q at every position, q - 1 only where q >
        0), K20_OPS_PER_POS for each position's quant and backtrack. qmfs:
        each category's qmf, (C,) shared or (N, C) a row per block."""
        n = 0
        for c, cf in cats.items():
            q = (cf.abs() * qmfs[c] + (1 << 15)) >> 16
            n += K20_OPS_PER_CAND * (cf.numel() + int((q > 0).sum())) \
                + K20_OPS_PER_POS * cf.numel()
        return n

    # K20 on frame 1's coefficients against frame 0's recon, at QP 26 with
    # shared consts: the four categories of one P frame
    cats = trellis_coefs((y1, u1, v1), (ry, ru, rv))
    tabs = {c: otrellis.pack_trellis(otrellis.make_consts(
        QP, c, cqm[c], False, 0, state_qp=QP), dev) for c in cats}
    err20, ms20, pl20 = 0, 0.0, 0.0
    for c, cf in cats.items():
        k20 = otrellis.trellis_scan(cf, tabs[c])
        p20 = {}
        pl20 += event_ms(lambda: p20.update(o=otrellis.trellis_scan_plain(
            cf, tabs[c])), 1)
        err20 = max(err20, exact(f"K20 trellis_scan (cat {c}, QP {QP})",
                                 [k20], [p20["o"]]))
        ms20 += event_ms(lambda: otrellis.trellis_scan(cf, tabs[c]), 5)
    record("trellis_scan", "cuda", "x264_tpu_torch/csrc/trellis.cu",
           "x264_tpu/ops/trellis.py:236", err20, ms20, pl20,
           2 * nbytes(*cats.values()) + nbytes(*tabs.values()),
           trellis_ops(cats, {c: otrellis.unpack_trellis(
               tabs[c], cats[c].shape[1])["qmf"] for c in cats}))
    print(f"K20 trellis_scan: exact on frame 1's {', '.join(f'cat {c} '
          f'{tuple(cf.shape)}' for c, cf in cats.items())} at QP {QP} "
          f"(shared consts), {ms20:.3f} ms for the four", flush=True)
    # K20 with the 52-QP stacks and a seeded row per block (QP 1-51)
    rng20 = np.random.default_rng(20)
    for c in (2, 5):
        cf = cats[c]
        st = otrellis.pack_trellis(otrellis.make_consts_all_qp(
            c, cqm[c], False, 0), dev)
        qi = torch.as_tensor(rng20.integers(1, 52, cf.shape[0]),
                             dtype=torch.int32, device=dev)
        exact(f"K20 trellis_scan (cat {c}, 52-QP stack)",
              [otrellis.trellis_scan(cf, st, qi)],
              [otrellis.trellis_scan_plain(cf, st, qi)])
        ms = event_ms(lambda: otrellis.trellis_scan(cf, st, qi), 5)
        print(f"K20 trellis_scan (cat {c}, 52-QP stack, rows over QP "
              f"1-51): exact, {ms:.3f} ms", flush=True)
    # K20 on tie_coefs' rows (zero blocks, magnitudes on q's rounding
    # edge, lone coefficients, levels past the ue escape) of each
    # category: at QP 26 with lam2 the table's, 0 and 1e7, and with the
    # stack's rows at QP 0, 1 and 51; 20,001 blocks (the last CTA part
    # full)
    for c in cats:
        tc = otrellis.make_consts(QP, c, cqm[c], False, 0, state_qp=QP)
        cf = torch.as_tensor(otrellis.tie_coefs(tc["qmf"], 20_001, c),
                             device=dev)
        for lam2 in (None, 0.0, 1e7):
            tab = otrellis.pack_trellis(
                tc if lam2 is None else dict(tc, lam2=np.float32(lam2)), dev)
            exact(f"K20 trellis_scan (cat {c}, ties, lam2 {lam2})",
                  [otrellis.trellis_scan(cf, tab)],
                  [otrellis.trellis_scan_plain(cf, tab)])
        st = otrellis.pack_trellis(otrellis.make_consts_all_qp(
            c, cqm[c], False, 0), dev)
        cf = torch.as_tensor(otrellis.tie_coefs(otrellis.make_consts(
            1, c, cqm[c], False, 0)["qmf"], 20_001, c + 10), device=dev)
        qi = torch.as_tensor(rng20.choice([0, 1, 51], 20_001),
                             dtype=torch.int32, device=dev)
        exact(f"K20 trellis_scan (cat {c}, ties, stack rows 0 / 1 / 51)",
              [otrellis.trellis_scan(cf, st, qi)],
              [otrellis.trellis_scan_plain(cf, st, qi)])
    print("K20 trellis_scan: exact on tie_coefs' rows of each category at "
          "lam2 the table's, 0 and 1e7 and on stack rows 0 / 1 / 51",
          flush=True)
    # K20 at QP 4 on the half-flat frame against a gray prediction, where
    # levels reach the ue escape (>= 15)
    flat = tuple(torch.full_like(a, 128) for a in (yh, uh, vh))
    cf = trellis_coefs((yh, uh, vh), flat)[2]
    tab4 = otrellis.pack_trellis(otrellis.make_consts(
        4, 2, tables.CQM_4PY, False, 0, state_qp=4), dev)
    k20 = otrellis.trellis_scan(cf, tab4)
    exact("K20 trellis_scan (cat 2, QP 4, half-flat)", [k20],
          [otrellis.trellis_scan_plain(cf, tab4)])
    n_esc = int((k20.abs() >= 15).sum())
    if n_esc == 0:
        fail("K20 at QP 4 on the half-flat frame made no level >= 15")
    print(f"K20 trellis_scan (cat 2, QP 4, half-flat frame): exact, {n_esc} "
          f"levels >= 15 (largest {int(k20.abs().max())})", flush=True)
    # K6 with the trellis at t8 0, 1 and 2: at QP 26 with the frame's
    # consts, and with frame 1's QP map and the 52-QP stacks
    _, s6 = spied_front((ry, ru, rv), qtab_rd, True, True, ("p_inter_mb",))
    a6t = s6["p_inter_mb"][0][:10]
    tr_frame = {**qtab_rd, **inter.trellis_consts(
        QP, tables.chroma_qp(QP, 0), 0, dev)}
    tr_stack = {**qtab_rd_aq, **inter.trellis_stacks(0, 0, dev)}
    k6t_ms = {}
    for qtab_t, qm, tag in ((tr_frame, None, f"QP {QP}"),
                            (tr_stack, qm1, "QP map")):
        for t8m in (inter.T8_OFF, inter.T8_SA8D, inter.T8_RD):
            a6x = (*a6t, qtab_t, True, t8m, qm)
            n0 = inter.p_inter_mb.launches_trellis
            k6x = inter.p_inter_mb(*a6x)
            if inter.p_inter_mb.launches_trellis != n0 + 1:
                fail("K6 did not count its trellis launch")
            err6t = exact(f"K6 p_inter_mb with the trellis ({tag}, t8 "
                          f"{t8m})", k6x, inter.p_inter_mb_plain(*a6x))
        k6t_ms[tag] = (event_ms(lambda: inter.p_inter_mb(*a6x), 10),
                       event_ms(lambda: inter.p_inter_mb_plain(*a6x), 1),
                       event_ms(lambda: inter.p_inter_mb(
                           *a6x[:10], qtab_rd_aq if qm is not None
                           else qtab_rd, True, t8m, qm), 10))
    for qtab_t, qtab_n, qm, tag in ((tr_frame, qtab_rd, None, f"QP {QP}"),
                                    (tr_stack, qtab_rd_aq, qm1, "QP map")):
        t6 = [event_ms(lambda: inter.p_inter_mb(*a6t, qt, True, t8m, qm),
                       10)
              for t8m in (inter.T8_OFF, inter.T8_SA8D, inter.T8_RD)
              for qt in (qtab_t, qtab_n)]
        print(f"K6 p_inter_mb ({tag}) at t8 0 / 1 / 2: "
              + ", ".join(f"{t:.3f}" for t in t6) + " ms (each t8 with the "
              f"trellis, then without) [{smi_line}]", flush=True)
    # K6 with the trellis at the edges: MB row 0 at ptype 0 and MV 0 over
    # a source that is its reference there (every block zero), at QP 1's
    # consts (levels past the ue escape) and with a QP map of rows 0, 1
    # and 51, at t8 0, 1 and 2
    e6 = list(a6t)
    e6[8], e6[9] = e6[8].clone(), e6[9].clone()
    e6[8][0], e6[9][0] = 0, 0
    for k, (r, n) in enumerate(zip((ry, ru, rv), (16, 8, 8))):
        e6[2 + k] = e6[2 + k].clone()
        e6[2 + k][:n] = r[:n]
    qm_e = torch.as_tensor(np.random.default_rng(61).choice(
        [0, 1, 51], (mb_h, mb_w)), dtype=torch.int32, device=dev)
    tr_qp1 = {**qtab_rd, **inter.trellis_consts(1, tables.chroma_qp(1, 0),
                                                0, dev)}
    for qtab_t, qm, tag in ((tr_qp1, None, "QP 1"),
                            (tr_stack, qm_e, "QP map rows 0 / 1 / 51")):
        for t8m in (inter.T8_OFF, inter.T8_SA8D, inter.T8_RD):
            a6e = (*e6, qtab_t, True, t8m, qm)
            k6e = inter.p_inter_mb(*a6e)
            exact(f"K6 p_inter_mb with the trellis at the edges ({tag}, "
                  f"t8 {t8m})", k6e, inter.p_inter_mb_plain(*a6e))
            if k6e["blocks_z"][0].any():
                fail("K6's zero-residual MB row coded a level")
    print("K6 p_inter_mb with the trellis: exact at the edges (a zero MB "
          "row, QP 1, QP-map rows 0 / 1 / 51) at t8 0 / 1 / 2", flush=True)
    preds = [inter._untiles(p.reshape(nmb, *p.shape[2:]), mb_h, mb_w)
             for p in inter.partition_preds(*a6t[5:10])]
    cats6 = trellis_coefs(a6t[2:5], preds)
    # each block's qmf row: luma by its MB's QP, chroma by its chroma QP
    rows = qm1.flatten().long()
    rows_c = tr_stack["trellis_qpc_of"][rows]
    qmfs6 = {c: tr_stack[key]["qmf"][r.repeat_interleave(n).repeat(k)]
             for key, c, r, n, k in (("trellis", 2, rows, 16, 1),
                                     ("trellis8", 5, rows, 4, 1),
                                     ("trellis_pc", 4, rows_c, 4, 2),
                                     ("trellis_pc_dc", 3, rows_c, 1, 2))}
    ms6t, pl6t, ms6n = k6t_ms["QP map"]
    record("p_inter_mb_trellis", "cuda", "x264_tpu_torch/csrc/inter.cu",
           "x264_tpu/encoder/inter.py:123", err6t, ms6t, pl6t,
           nbytes(*a6t[2:10], tr_stack["trellis_tab"], stacks["inter"], qm1,
                  *k6x.values()),
           K6_T8_OPS_PER_MB * nmb + trellis_ops(cats6, qmfs6))
    print(f"K6 p_inter_mb with the trellis: exact at t8 0 / 1 / 2 at QP {QP}"
          f" and with frame 1's QP map; at t8 2 {k6t_ms[f'QP {QP}'][0]:.3f} ms"
          f" (without the trellis {k6t_ms[f'QP {QP}'][2]:.3f}) at QP {QP}, "
          f"{ms6t:.3f} ms (without {ms6n:.3f}) with the map [{smi_line}]",
          flush=True)

    # ------------------------------------------------------------ CAVLC
    stamp("phase 3: CAVLC's kernels")
    cap = pipeline.capacity_words(nmb)

    def slots(slice_type):
        bw = BitWriter()
        SliceHeader(slice_type=slice_type, idr_pic_id=0 if slice_type ==
                    SLICE_I else -1, qp=QP, disable_deblock=0).write_rbsp(
            bw, 3 if slice_type == SLICE_I else 2)
        return cavlc.header_slots(bw)

    hdr_i, hdr_p = slots(SLICE_I), slots(SLICE_P)
    cav_ms = {}

    def same_words(name, k, p, caps=cap):
        """K18 / K19 against the plain version: nbits and every word."""
        (kw, kn), (pw, pn) = k, p
        if int(kn) != int(pn) or not torch.equal(kw, pw):
            fail(f"{name} differs from its plain version ({int(kn)} bits "
                 f"against {int(pn)})")
        print(f"{name}: exact, {int(pn)} bits"
              + (f" ({int(pn) - 32 * caps} past the capacity, dropped)"
                 if int(pn) > 32 * caps else ""), flush=True)
        return int(pn)

    # K18 on frame 0's K1 output at QP 26, then at QP 4 on the half-flat
    # frame (long level escapes), with an AQ map and K17's dqp, and with
    # a capacity that drops codes
    a18 = (k1, mb_h, mb_w, *hdr_i, cap)
    bits18 = same_words("K18 cavlc_i_slice (frame 0, QP 26)",
                        cavlc.cavlc_i_slice(*a18),
                        cavlc.cavlc_i_slice_plain(*a18))
    cav_ms.update(k18=event_ms(lambda: cavlc.cavlc_i_slice(*a18), 20),
                  pl18=event_ms(lambda: cavlc.cavlc_i_slice_plain(*a18), 1))
    keys18 = ("mode16", "modec", "i4_mb", "i4_modes", "cbp_luma_bits",
              "luma_dc", "luma_ac", "chroma_dc", "chroma_ac")
    record("cavlc_i_slice", "cuda", "x264_tpu_torch/csrc/cavlc.cu",
           "x264_tpu/entropy/device.py:246", 0, cav_ms["k18"],
           cav_ms["pl18"], nbytes(*(k1[k] for k in keys18))
           + (bits18 + 31) // 32 * 4 + 4,
           K18_OPS_PER_MB * nmb + K18_OPS_PER_BIT * bits18)
    qtab4 = intra.make_qtab(4, tables.chroma_qp(4, 0), dev)
    k1q4 = intra.encode_i16_frame(mb_h, mb_w, yh, uh, vh, qtab4,
                                  int(tables.LAMBDA_TABLE[4]))
    same_words("K18 cavlc_i_slice (half-flat frame, QP 4)",
               cavlc.cavlc_i_slice(k1q4, mb_h, mb_w, *hdr_i, cap),
               cavlc.cavlc_i_slice_plain(k1q4, mb_h, mb_w, *hdr_i, cap))
    longest = int(cavlc.i16_code_planes(k1q4, mb_h, mb_w)[1].max())
    if longest < 28:
        fail(f"QP 4 on the half-flat frame coded no long level escape "
             f"(longest code {longest} bits)")
    print(f"K18 at QP 4: the longest code is {longest} bits", flush=True)
    k1n = intra.encode_i16_frame(mb_h, mb_w, y, u, v, qtab_aq, lam, False,
                                 qm0)
    cnz = (k1n["chroma_ac"][..., 1:] != 0).flatten(2).any(-1) \
        | (k1n["chroma_dc"] != 0).flatten(2).any(-1)
    k1n["dqp"] = aq.dqp_syntax(qm0, ~k1n["i4_mb"]
                               | (k1n["cbp_luma_bits"] > 0) | cnz, QP)[0]
    a18a = (k1n, mb_h, mb_w, *hdr_i, cap)
    bits18a = same_words("K18 cavlc_i_slice with dqp (frame 0's QP map)",
                         cavlc.cavlc_i_slice(*a18a),
                         cavlc.cavlc_i_slice_plain(*a18a))
    cav_ms.update(k18a=event_ms(lambda: cavlc.cavlc_i_slice(*a18a), 20),
                  pl18a=event_ms(lambda: cavlc.cavlc_i_slice_plain(*a18a),
                                 1))
    record("cavlc_i_slice_aq", "cuda", "x264_tpu_torch/csrc/cavlc.cu",
           "x264_tpu/entropy/device.py:339", 0, cav_ms["k18a"],
           cav_ms["pl18a"], nbytes(*(k1n[k] for k in keys18 + ("dqp",)))
           + (bits18a + 31) // 32 * 4 + 4,
           K18_OPS_PER_MB * nmb + K18_OPS_PER_BIT * bits18a)
    small = bits18 // 64
    same_words("K18 cavlc_i_slice (frame 0, half the bits' capacity)",
               cavlc.cavlc_i_slice(k1, mb_h, mb_w, *hdr_i, small),
               cavlc.cavlc_i_slice_plain(k1, mb_h, mb_w, *hdr_i, small),
               small)
    # the d2h of the whole word buffer into pinned memory, as Encoder
    # copies it per frame
    words_k = cavlc.cavlc_i_slice(*a18)[0]
    words_h = torch.empty(words_k.shape, dtype=torch.int32, pin_memory=True)
    cav_ms["d2h"] = event_ms(lambda: words_h.copy_(words_k,
                                                   non_blocking=True), 5)
    print(f"d2h of the CAVLC word buffer ({nbytes(words_k)} bytes): "
          f"{cav_ms['d2h']:.3f} ms", flush=True)

    # K8's pass A alone and K19: frame 1 against frame 0's recon (subme 5),
    # the partition reference (every ptype), a reference with 30% of its
    # 64x64 tiles gray (intra MBs) and 30% copied from frame 1 itself (runs
    # of skip MBs), and under AQ (subme 6, frame 1's QP map)
    copy = np.random.default_rng(19).random(((mb_h + 3) // 4,
                                             (mb_w + 3) // 4)) < 0.3
    copy = torch.as_tensor(copy.repeat(4, 0).repeat(4, 1)[:mb_h, :mb_w],
                           device=dev) & ~gray
    gray_copy = tuple(torch.where(copy.repeat_interleave(n, 0)
                                  .repeat_interleave(n, 1), f, t)
                      for t, f, n in zip(mixed, (y1, u1, v1), (16, 8, 8)))
    fronts = {"frame 1 on frame 0": front_c,
              "the partition reference": front5,
              "the gray / copied reference": inter.encode_p_front(
                  mb_h, mb_w, me_range, y1, u1, v1, *gray_copy, qtab_p, lam,
                  mvp0, True, (2, 1), True, True, True),
              "frame 1's QP map": inter.encode_p_front(
                  mb_h, mb_w, me_range, y1, u1, v1, ry, ru, rv, qtab_rd_aq,
                  lam, mvp0, True, (2, 1), True, True, True, True, False,
                  qm1)}
    keys19 = ("intra_mb", "mode16", "modec", "cbp_luma_bits", "cbp_chroma",
              "luma_dc", "luma_blocks", "chroma_dc", "chroma_ac")
    for tag, fr in fronts.items():
        pm = cabac_planes.p_maps(fr, mb_h, mb_w)
        exact(f"K8 pass A alone ({tag})", pm, inter.p_maps_plain(fr, mb_h,
                                                                 mb_w))
        if tag == "frame 1's QP map":
            pm["dqp"] = aq.dqp_syntax(qm1, cabac_planes.has_dqp_p(pm, fr),
                                      QP)[0]
        a19 = (fr, pm, mb_h, mb_w, *hdr_p, cap)
        bits19 = same_words(f"K19 cavlc_p_slice ({tag})",
                            cavlc.cavlc_p_slice(*a19),
                            cavlc.cavlc_p_slice_plain(*a19))
        skip = pm["skip"].reshape(-1).cpu().numpy()
        runs = np.diff(np.flatnonzero(np.concatenate([[1], ~skip, [1]]))) - 1
        pt = torch.bincount(pm["ptype"][~fr["intra_mb"] & ~pm["skip"]],
                            minlength=4).tolist()
        print(f"K19 ({tag}): {int(fr['intra_mb'].sum())} intra, "
              f"{int(skip.sum())} skip MBs (longest run {int(runs.max())}), "
              f"coded ptypes {pt}", flush=True)
        if tag == "the partition reference" and min(pt) == 0:
            fail(f"K19 on the partition reference saw ptypes {pt}")
        if tag.startswith("the gray") and (int(fr["intra_mb"].sum()) == 0
                                           or int(runs.max()) < 4):
            fail("the gray / copied reference gave no intra MBs or no skip "
                 "run of 4")
        if tag == "frame 1 on frame 0":
            cav_ms.update(
                k19=event_ms(lambda: cavlc.cavlc_p_slice(*a19), 20),
                pl19=event_ms(lambda: cavlc.cavlc_p_slice_plain(*a19), 1),
                kpa=event_ms(lambda: cabac_planes.p_maps(fr, mb_h, mb_w),
                             20),
                plpa=event_ms(lambda: inter.p_maps_plain(fr, mb_h, mb_w),
                              1))
            record("cavlc_p_slice", "cuda", "x264_tpu_torch/csrc/cavlc.cu",
                   "x264_tpu/entropy/device.py:379", 0, cav_ms["k19"],
                   cav_ms["pl19"], nbytes(*(fr[k] for k in keys19), *(
                       pm[k] for k in ("skip", "ptype", "mvd", "mvd1",
                                       "mvd_sub")))
                   + (bits19 + 31) // 32 * 4 + 4,
                   K18_OPS_PER_MB * nmb + K18_OPS_PER_BIT * bits19)
            record("p_maps", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
                   "x264_tpu/encoder/inter.py:733", 0, cav_ms["kpa"],
                   cav_ms["plpa"], nbytes(*(fr[k] for k in (
                       "intra_mb", "me_mv", "ptype", "mv_quad",
                       "cbp_luma_bits", "cbp_chroma", "luma_blocks")),
                       *pm.values()), K3_OPS_PER_MB * nmb)
            small19 = bits19 // 64
            same_words(f"K19 cavlc_p_slice ({tag}, half the bits' capacity)",
                       cavlc.cavlc_p_slice(fr, pm, mb_h, mb_w, *hdr_p,
                                           small19),
                       cavlc.cavlc_p_slice_plain(fr, pm, mb_h, mb_w, *hdr_p,
                                                 small19), small19)
        if tag == "frame 1's QP map":
            if int((pm["dqp"] != 0).sum()) == 0:
                fail("no P MB coded a nonzero mb_qp_delta under K19")
            cav_ms.update(
                k19a=event_ms(lambda: cavlc.cavlc_p_slice(*a19), 20),
                pl19a=event_ms(lambda: cavlc.cavlc_p_slice_plain(*a19), 1))
            record("cavlc_p_slice_aq", "cuda", "x264_tpu_torch/csrc/cavlc.cu",
                   "x264_tpu/entropy/device.py:528", 0, cav_ms["k19a"],
                   cav_ms["pl19a"], nbytes(*(fr[k] for k in keys19), *(
                       pm[k] for k in ("skip", "ptype", "mvd", "mvd1",
                                       "mvd_sub", "dqp")))
                   + (bits19 + 31) // 32 * 4 + 4,
                   K18_OPS_PER_MB * nmb + K18_OPS_PER_BIT * bits19)
    print(f"CAVLC kernels: K18 {cav_ms['k18']:.3f} ms (plain "
          f"{cav_ms['pl18']:.3f}), with dqp {cav_ms['k18a']:.3f}; K19 "
          f"{cav_ms['k19']:.3f} ms (plain {cav_ms['pl19']:.3f}), with dqp "
          f"{cav_ms['k19a']:.3f}; K8 pass A alone {cav_ms['kpa']:.3f} ms "
          f"[{smi_line}]", flush=True)

    # ------------------------------------------------------- B frames
    stamp("phase 3: the B frame's kernels")
    # K21 on the lowres planes of frames 0, 1 and 2: the four b-adapt
    # programs, each against its composition of plain K21 versions
    lows2 = lookahead.lowres_planes(luma(frames[2]), H, W)
    programs = (("badapt_first", (lows[1], lows2, lows[0])),
                ("badapt_ext", (lows2, lows[0])),
                ("b_seed_mvs", (lows[1], lows[0], lows2)),
                ("b_cost", (lows[1], lows[0], lows2)))
    kernel21 = lookahead.lowres_bcost

    def plain21(*a, want_mv=False):
        sums, m0, m1 = lookahead.lowres_bcost_plain(*a)
        return (sums, m0, m1) if want_mv else (sums, None, None)

    err21, calls21 = 0, {}
    for name, args in programs:
        n0 = kernel21.launches
        k21 = getattr(lookahead, name)(*args, bh, bw, r_la)
        calls21[name] = kernel21.launches - n0
        lookahead.lowres_bcost = plain21
        try:
            p21 = getattr(lookahead, name)(*args, bh, bw, r_la)
        finally:
            lookahead.lowres_bcost = kernel21
        k21, p21 = (k21, p21) if isinstance(k21, tuple) else ((k21,), (p21,))
        err21 = max(err21, exact(f"K21 lowres_bcost ({name})", k21, p21))
        print(f"K21 {name}: exact, {calls21[name]} launches: "
              f"{[t.tolist() for t in k21] if name != 'b_seed_mvs' else ''}",
              flush=True)
    a21 = (lows[1], lows[0], lows2, bh, bw, r_la, True)
    ms21 = event_ms(lambda: lookahead.lowres_bcost(*a21), 10)
    pl21 = event_ms(lambda: lookahead.lowres_bcost_plain(*a21), 1)
    record("lowres_bcost", "cuda", "x264_tpu_torch/csrc/badapt.cu",
           "x264_tpu/encoder/lookahead.py:272", err21, ms21, pl21,
           nbytes(lows[1][0], lows[0], lows2) + 24,
           (2 * (K15_OPS_PER_CAND_SAMPLE * (2 * r_la + 1) ** 2 * 64
                 + K15_OPS_PER_BLOCK) + K21_BI_OPS_PER_BLOCK) * bh * bw)
    # K22 / K7 / K23 / K24 / K2 on frame 1 as a B frame between frame 0's
    # recon (L0) and frame 2 (L1): 30% of its 64x64 blocks gray in all
    # three (still, so direct and skip), 15% of others flat in the B frame
    # alone (intra), colocated maps of ref 0 with small and large MVs
    rng_b = np.random.default_rng(9)
    tiles = rng_b.random(((mb_h + 3) // 4, (mb_w + 3) // 4))
    grid = lambda m: torch.as_tensor(m.repeat(4, 0).repeat(4, 1)[:mb_h,
                                                                 :mb_w],
                                     device=dev)
    still, flat = grid(tiles < 0.3), grid((tiles >= 0.3) & (tiles < 0.45))
    px = lambda m, n: m.repeat_interleave(n, 0).repeat_interleave(n, 1)
    grayed = lambda planes, m, val: tuple(
        torch.where(px(m, n), val, t) for t, n in zip(planes, (16, 8, 8)))
    yb, ub, vb = grayed(grayed((y1, u1, v1), still, 128), flat, 60)
    l0 = grayed((ry, ru, rv), still, 128)
    l1 = grayed(frame_planes(frames[2]), still, 128)
    col_ref4 = torch.where(torch.as_tensor(
        rng_b.random((4 * mb_h, 4 * mb_w)) < 0.1, device=dev), -1, 0) \
        .to(torch.int32)
    col_mv4 = torch.as_tensor(np.where(
        rng_b.random((4 * mb_h, 4 * mb_w, 1)) < 0.3,
        rng_b.integers(-24, 25, (4 * mb_h, 4 * mb_w, 2)),
        rng_b.integers(-1, 2, (4 * mb_h, 4 * mb_w, 2))), dtype=torch.int32,
        device=dev) * (col_ref4 == 0)[..., None]
    seeds = (mvp0, mvp0)
    fetch_b, mvs_b, satds_b = [], [], []
    for ref in (l0, l1):
        f, ref_pad = inter.b_list_fetch(*ref)
        mv_fp, _ = me.hier_search(yb, ref_pad, mb_h, mb_w, me_range, lam,
                                  mvp0)
        mv, satd = me.subpel_refine(yb, f[0], mv_fp, lam, mvp0, (2, 1))
        fetch_b.append(f)
        mvs_b.append(mv)
        satds_b.append(satd)
    qtab_b = inter.make_qtab_p(QP, tables.chroma_qp(QP, 0), dev)
    qtab_bt = {**qtab_b, **inter.trellis_consts(QP, tables.chroma_qp(QP, 0),
                                                0, dev)}
    b_ms = {}

    def timed(key, fn, plain, reps=10):
        b_ms[key] = (event_ms(fn, reps), event_ms(plain, 1))

    a22 = (mb_h, mb_w, yb, ub, vb, *fetch_b)
    kw1 = dict(satd=satds_b, seeds=seeds, lam=lam)
    err22 = 0
    for qt, tag in ((qtab_b, ""), (qtab_bt, " with the trellis")):
        k22 = inter.b_inter_mb(*a22, qt, *mvs_b, **kw1)
        err22 = max(err22, exact(f"K22 b_inter_mb pass 1{tag}", k22,
                                 inter.b_inter_mb_plain(*a22, qt, *mvs_b,
                                                        **kw1)))
        timed("k22a" + tag, lambda: inter.b_inter_mb(*a22, qt, *mvs_b, **kw1),
              lambda: inter.b_inter_mb_plain(*a22, qt, *mvs_b, **kw1))
    k22 = inter.b_inter_mb(*a22, qtab_b, *mvs_b, **kw1)
    modes = k22["bmode"].flatten().bincount(minlength=3).tolist()
    a7d = (mb_h, mb_w, yb, ub, vb, k22["recon_y"], k22["recon_u"],
           k22["recon_v"], k22["cost_inter"], qtab_b, lam)
    im_b = inter.intra_in_b_decide(*a7d)
    err7b = exact("K7 intra_in_b_decide", [im_b], [inter.intra_in_p_plain(
        *a7d, True, decide_only=True)])
    timed("k7d", lambda: inter.intra_in_b_decide(*a7d),
          lambda: inter.intra_in_p_plain(*a7d, True, decide_only=True))
    print(f"K7 intra_in_b_decide per launch: "
          f"{split_text(launch_split(lambda: inter.intra_in_b_decide(*a7d)))}"
          f" ms [{smi_line}]", flush=True)
    a23 = (mb_h, mb_w, yb, *fetch_b, im_b, k22["bmode"], *mvs_b,
           k22["cost_inter"], col_ref4, col_mv4, lam)
    k23 = inter.b_direct(*a23)
    err23 = exact("K23 b_direct", k23, inter.b_direct_plain(*a23))
    timed("k23", lambda: inter.b_direct(*a23),
          lambda: inter.b_direct_plain(*a23))
    r0, r1, m0, m1, direct_b = k23
    refs_b = (r0, r1)
    for qt, tag in ((qtab_b, ""), (qtab_bt, " with the trellis")):
        n0 = inter.b_inter_mb.launches_trellis
        k22b = inter.b_inter_mb(*a22, qt, m0, m1, refs=refs_b)
        if inter.b_inter_mb.launches_trellis != n0 + int(bool(tag)):
            fail("K22 did not count its trellis launch")
        err22 = max(err22, exact(f"K22 b_inter_mb pass 2{tag}", k22b,
                                 inter.b_inter_mb_plain(*a22, qt, m0, m1,
                                                        refs=refs_b)))
        timed("k22b" + tag, lambda: inter.b_inter_mb(*a22, qt, m0, m1,
                                                     refs=refs_b),
              lambda: inter.b_inter_mb_plain(*a22, qt, m0, m1, refs=refs_b))
    # both passes with the trellis at QP 4's consts (levels past the ue
    # escape) and QP 51's (most levels zero)
    for tqp in (4, 51):
        qt = {**qtab_b, **inter.trellis_consts(
            tqp, tables.chroma_qp(tqp, 0), 0, dev)}
        exact(f"K22 b_inter_mb pass 1 with the trellis at QP {tqp}",
              inter.b_inter_mb(*a22, qt, *mvs_b, **kw1),
              inter.b_inter_mb_plain(*a22, qt, *mvs_b, **kw1))
        exact(f"K22 b_inter_mb pass 2 with the trellis at QP {tqp}",
              inter.b_inter_mb(*a22, qt, m0, m1, refs=refs_b),
              inter.b_inter_mb_plain(*a22, qt, m0, m1, refs=refs_b))
    it_b = inter.b_inter_mb(*a22, qtab_b, m0, m1, refs=refs_b)
    a7s = (mb_h, mb_w, yb, ub, vb, it_b["recon_y"], it_b["recon_u"],
           it_b["recon_v"])
    ip_b = inter.intra_in_b_sweeps(*a7s, im_b, qtab_b, lam)
    err7s = exact("K7 intra_in_b_sweeps", ip_b, inter.intra_in_p_plain(
        *a7s, None, qtab_b, lam, True, intra_mb=im_b))
    timed("k7s", lambda: inter.intra_in_b_sweeps(*a7s, im_b, qtab_b, lam),
          lambda: inter.intra_in_p_plain(*a7s, None, qtab_b, lam, True,
                                         intra_mb=im_b))
    print(f"K7 intra_in_b_sweeps per launch ({int(im_b.sum())} intra MBs): "
          f"{split_text(launch_split(lambda: inter.intra_in_b_sweeps(*a7s, im_b, qtab_b, lam)))}"
          f" ms [{smi_line}]", flush=True)
    front_b = dict(inter.merge_intra(ip_b, it_b, mb_h, mb_w),
                   bmode=k22["bmode"], direct_mb=direct_b, r0=r0, r1=r1,
                   m0=m0, m1=m1)
    maps_b, ops_b, n_b = cabac_planes.cabac_b_ops(front_b, mb_h, mb_w, True)
    pmaps_b, pops_b, pn_b = cabac_planes.cabac_b_ops_plain(front_b, mb_h,
                                                           mb_w, True)
    n_ops_bf = int(pn_b)
    if int(n_b) != n_ops_bf:
        fail(f"K24 cabac_b_ops counts {int(n_b)} ops, its plain version "
             f"{n_ops_bf}")
    err24 = max(exact("K24 cabac_b_ops (maps)", maps_b, pmaps_b),
                exact("K24 cabac_b_ops (ops)", [ops_b[:n_ops_bf]],
                      [pops_b[:n_ops_bf]]))
    timed("k24", lambda: cabac_planes.cabac_b_ops(front_b, mb_h, mb_w, True),
          lambda: cabac_planes.cabac_b_ops_plain(front_b, mb_h, mb_w, True),
          20)
    n_intra_b, n_direct_b = int(im_b.sum()), int(direct_b.sum())
    n_skip_b = int(maps_b["skip"].sum())
    if not (n_intra_b and n_direct_b and n_skip_b and n_direct_b > n_skip_b
            and min(modes) > 0):
        fail(f"the B frame's modes did not all occur: L0 / L1 / BI {modes}, "
             f"{n_intra_b} intra, {n_direct_b} direct, {n_skip_b} skip")
    # K2 with the B maps (both lists' refs and MVs)
    qp_b = torch.full((mb_h, mb_w), QP, dtype=torch.int32, device=dev)
    maps2b = (qp_b, im_b, maps_b["nnz4"], maps_b["ref4"], maps_b["mv4"],
              maps_b["ref4_l1"], maps_b["mv4_l1"], True, 0, 0, 0)
    src2b = (front_b["recon_y"], front_b["recon_u"], front_b["recon_v"])
    work2b = []

    def fresh2b():
        work2b[:] = [t.clone() for t in src2b]

    fresh2b()
    p2b = dict(zip("yuv", deblock.deblock_frame_plain(mb_h, mb_w, *work2b,
                                                      *maps2b)))
    pl2b = event_ms(lambda: deblock.deblock_frame_plain(mb_h, mb_w, *work2b,
                                                        *maps2b), 1)
    n0 = deblock.deblock_frame.launches_b
    k2b = dict(zip("yuv", deblock.deblock_frame(mb_h, mb_w, *work2b,
                                                *maps2b)))
    if deblock.deblock_frame.launches_b == n0:
        fail("K2 did not count its B-slice launches")
    err2b = exact("K2 deblock_diag with B maps", k2b, p2b)
    ms2b = event_ms(lambda: deblock.deblock_frame(mb_h, mb_w, *work2b,
                                                  *maps2b), 5, setup=fresh2b)
    record("deblock_diag_b", "cuda", "x264_tpu_torch/csrc/deblock.cu",
           "x264_tpu/ops/deblock.py:166", err2b, ms2b, pl2b,
           2 * nbytes(*src2b) + nbytes(*maps2b[:7]), K2_OPS_PER_MB * nmb)
    ms22 = b_ms["k22a"][0] + b_ms["k22b"][0]
    pl22 = b_ms["k22a"][1] + b_ms["k22b"][1]
    record("b_inter_mb", "cuda", "x264_tpu_torch/csrc/inter.cu",
           "x264_tpu/encoder/inter.py:866", err22, ms22, pl22,
           2 * nbytes(yb, ub, vb, *fetch_b[0], *fetch_b[1])
           + nbytes(*mvs_b, *satds_b, *seeds, *k22.values(), r0, r1, m0, m1,
                    *it_b.values()),
           (K22_PASS1_OPS_PER_MB + K22_PASS2_OPS_PER_MB) * nmb)
    record("intra_in_b_decide", "cuda", "x264_tpu_torch/csrc/intra_p.cu",
           "x264_tpu/encoder/inter.py:965", err7b, *b_ms["k7d"],
           nbytes(*a7d[2:9], im_b), K7_OPS_PER_MB_SWEEP * nmb)
    record("intra_in_b_sweeps", "cuda", "x264_tpu_torch/csrc/intra_p.cu",
           "x264_tpu/encoder/inter.py:1137", err7s, *b_ms["k7s"],
           nbytes(*a7s[2:], im_b, *ip_b.values()),
           K7_OPS_PER_MB_SWEEP * (nmb + 2 * n_intra_b))
    record("b_direct", "cuda", "x264_tpu_torch/csrc/direct.cu",
           "x264_tpu/encoder/inter.py:1028", err23, *b_ms["k23"],
           nbytes(yb, fetch_b[0][0], fetch_b[1][0], im_b, k22["bmode"],
                  *mvs_b, k22["cost_inter"], col_ref4, col_mv4, *k23),
           K23_OPS_PER_MB * nmb)
    record("cabac_b_ops", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/entropy/cabac_planes.py:791", err24, *b_ms["k24"],
           nbytes(*(front_b[k] for k in ("intra_mb", "direct_mb", "bmode",
                                         "r0", "r1", "m0", "m1",
                                         "cbp_luma_bits", "cbp_chroma",
                                         "luma_blocks", "mode16", "modec",
                                         "luma_dc", "chroma_dc",
                                         "chroma_ac")), *maps_b.values())
           + 4 * n_ops_bf + 4, K3_OPS_PER_OP * n_ops_bf + K3_OPS_PER_MB * nmb)
    print(f"B kernels: exact; L0 / L1 / BI {modes}, {n_intra_b} intra, "
          f"{n_direct_b} direct ({n_skip_b} skip) MBs of {nmb}, {n_ops_bf} "
          f"ops; K22 pass 1 {b_ms['k22a'][0]:.3f} ms (trellis "
          f"{b_ms['k22a with the trellis'][0]:.3f}), pass 2 "
          f"{b_ms['k22b'][0]:.3f} ms (trellis "
          f"{b_ms['k22b with the trellis'][0]:.3f}), K7 decision "
          f"{b_ms['k7d'][0]:.3f} ms, sweeps {b_ms['k7s'][0]:.3f} ms, K23 "
          f"{b_ms['k23'][0]:.3f} ms, K24 {b_ms['k24'][0]:.3f} ms, K2 with B "
          f"maps {ms2b:.3f} ms, K21 {ms21:.3f} ms a launch [{smi_line}]",
          flush=True)

    # ------------------------------------------------- two references
    stamp("phase 3: two references' kernels")
    # frame 1 against two references (--ref 2): L0[0] the partition
    # reference (ref2, whose partitions move apart), L0[1] frame 0's recon,
    # each with its own 30% of the 64x64 tiles gray: frame 1 matches the
    # recon best where it is left, the partition reference where the recon
    # is gray, and neither where both are (intra), so the real per-MB
    # choice takes both. Subme 6 with the partitions, chroma ME, the 8x8
    # transform, the trellis and frame 1's QP map: the main path's K10,
    # K11, K12, K6 and K13 calls, spied, each held against its plain
    # version on the arguments encode_p_front gave it and again with a
    # seeded reference index in place of the real one
    rng_r = np.random.default_rng(101)
    tiles_r = rng_r.random((2, (mb_h + 3) // 4, (mb_w + 3) // 4)) < 0.3
    ref_newer = grayed(ref2, grid(tiles_r[0]), 128)
    ref_older = grayed((ry, ru, rv), grid(tiles_r[1]), 128)
    spied_fns = {"subpel_refine_blocks": me, "subpel_refine_parts": me,
                 "partition_fullpel": me, "chroma_rerank": me,
                 "p_inter_mb": inter, "rd_inter": inter}
    calls = {n: [] for n in spied_fns}
    kept = {n: getattr(m, n) for n, m in spied_fns.items()}

    def spy2(name):
        def call(*a, **k):
            calls[name].append((a, k))
            return kept[name](*a, **k)
        call.__dict__.update(kept[name].__dict__)
        return call

    for n, m in spied_fns.items():
        setattr(m, n, spy2(n))
    try:
        front_r = inter.encode_p_front(
            mb_h, mb_w, me_range, y1, u1, v1, *ref_newer, tr_stack, lam,
            mvp0, True, (2, 1), True, True, True, True, True, qm1, ref_older)
    finally:
        for n, m in spied_fns.items():
            kept[n].__dict__.update(getattr(m, n).__dict__)
            setattr(m, n, kept[n])
    sel_r, im_r = front_r["ref_sel"], front_r["intra_mb"]
    n_on1 = int(((sel_r == 1) & ~im_r).sum())
    n_on0 = int(((sel_r == 0) & ~im_r).sum())
    if n_on1 == 0 or n_on0 == 0:
        fail(f"two references: {n_on1} MBs on L0[1], {n_on0} on L0[0]")

    def seeded(s):
        return torch.as_tensor(rng_r.integers(0, 2, tuple(s.shape)),
                               dtype=torch.int32, device=dev)

    r2_ms = {}

    def flat(x):
        """A wrapper's result as a list of tensors (dicts and tuples
        opened)."""
        if torch.is_tensor(x):
            return [x]
        items = x.values() if isinstance(x, dict) else x
        return [t for v in items for t in flat(v)]

    def check_ref2(name, fn, plain, a, k, sel_at):
        """fn against plain on the spied arguments, then with a seeded
        reference index at position (or keyword) sel_at: every output
        equal (the float RD costs too); returns the max error, 0."""
        a2, k2 = list(a), dict(k)
        if isinstance(sel_at, str):
            k2[sel_at] = seeded(k[sel_at])
        else:
            a2[sel_at] = seeded(a[sel_at])
        for args, kw, tag in ((a, k, "two references"),
                              (a2, k2, "a seeded reference index")):
            got, want = flat(fn(*args, **kw)), flat(plain(*args, **kw))
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"{name} with {tag} differs from its plain version")
        return 0

    # K10: the 16x16 refinement and each partition layout's
    err10r, ops10r, bytes10r, ms10r, pl10r = 0, 0, 0, 0.0, 0.0
    for a, k in calls["subpel_refine_blocks"]:
        err10r = max(err10r, check_ref2(
            f"K10 subpel_refine {a[7]}x{a[8]}", me.subpel_refine_blocks,
            me.subpel_refine_blocks_plain, a, k, 10))
        ms10r += event_ms(lambda a=a: me.subpel_refine_blocks(*a), 10)
        pl10r += event_ms(lambda a=a: me.subpel_refine_blocks_plain(*a), 1)
        ops10r += 49 * (a[7] * a[8] // 16) * a[5].numel()
        bytes10r += nbytes(a[0], a[1], a[2], a[4], a[5], a[6], a[10]) \
            + 12 * a[5].numel()
    # the partition layouts' one launch (ref_sel: argument 6)
    for a, k in calls["subpel_refine_parts"]:
        err10r = max(err10r, check_ref2(
            "K10 subpel_refine_parts", me.subpel_refine_parts,
            me.subpel_refine_parts_plain, a, k, 6))
        ms10r += event_ms(lambda a=a: me.subpel_refine_parts(*a), 10)
        pl10r += event_ms(lambda a=a: me.subpel_refine_parts_plain(*a), 1)
        ops10r += 49 * 16 * nmb * (3 if a[2].shape[0] == 8 else 2)
        bytes10r += nbytes(a[0], a[1], a[2], a[4], a[6]) \
            + 12 * a[2][..., 0].numel()
    record("subpel_refine_ref2", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:245", err10r, ms10r, pl10r, bytes10r,
           K10_OPS_PER_CAND_4X4 * ops10r)
    if len(calls["subpel_refine_parts"]) != 1:
        fail("the two-reference P frame did not refine its partition "
             "layouts in one K10 launch")
    (a11, k11), = calls["partition_fullpel"]
    err11r = check_ref2("K11 part_fullpel", me.partition_fullpel,
                        me.partition_fullpel_plain, a11, k11, 7)
    record("part_fullpel_ref2", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:328", err11r,
           event_ms(lambda: me.partition_fullpel(*a11), 10),
           event_ms(lambda: me.partition_fullpel_plain(*a11), 1),
           nbytes(a11[0], a11[1], a11[2], a11[4], a11[7]) + 8 * 8 * nmb,
           K11_OPS_PER_MB * nmb)
    (a12, k12r), = calls["chroma_rerank"]
    err12r = check_ref2("K12 chroma_rerank", me.chroma_rerank,
                        me.chroma_rerank_plain, a12, k12r, 10)
    record("chroma_rerank_ref2", "cuda", "x264_tpu_torch/csrc/subpel.cu",
           "x264_tpu/ops/me.py:403", err12r,
           event_ms(lambda: me.chroma_rerank(*a12), 10),
           event_ms(lambda: me.chroma_rerank_plain(*a12), 1),
           nbytes(*a12[:7], a12[8], a12[9], a12[10]) + 12 * nmb,
           K12_OPS_PER_MB * nmb)
    (a6r, k6r), = calls["p_inter_mb"]
    if a6r[12] != inter.T8_RD or a6r[13] is None or "trellis_tab" not in \
            a6r[10]:
        fail("K6 with two references ran without the 8x8 transform, the "
             "QP map or the trellis")
    err6r = check_ref2("K6 p_inter_mb", inter.p_inter_mb,
                       inter.p_inter_mb_plain, a6r, k6r, "ref_sel")
    out6r = inter.p_inter_mb(*a6r, **k6r)
    preds_r = [inter._untiles(p.reshape(nmb, *p.shape[2:]), mb_h, mb_w)
               for p in inter.partition_preds(*a6r[5:10], k6r["ref_sel"])]
    record("p_inter_mb_ref2", "cuda", "x264_tpu_torch/csrc/inter.cu",
           "x264_tpu/encoder/inter.py:425", err6r,
           event_ms(lambda: inter.p_inter_mb(*a6r, **k6r), 10),
           event_ms(lambda: inter.p_inter_mb_plain(*a6r, **k6r), 1),
           nbytes(*a6r[2:10], a6r[10]["trellis_tab"], stacks["inter"], qm1,
                  k6r["ref_sel"], *out6r.values()),
           K6_T8_OPS_PER_MB * nmb + trellis_ops(
               trellis_coefs(a6r[2:5], preds_r), qmfs6))
    (a13r, k13r), = calls["rd_inter"]
    err13r = check_ref2("K13 rd_inter", inter.rd_inter, inter.rd_inter_plain,
                        a13r, k13r, "ref_sel")
    it13r = a13r[5]
    record("rd_inter_ref2", "cuda", "x264_tpu_torch/csrc/rdcost.cu",
           "x264_tpu/encoder/inter.py:583", err13r,
           event_ms(lambda: inter.rd_inter(*a13r, **k13r), 10),
           event_ms(lambda: inter.rd_inter_plain(*a13r, **k13r), 1),
           nbytes(*a13r[2:5], *it13r.values(), *a13r[6:9], k13r["ref_sel"],
                  a13r[9]["rdtab"]) + 4 * nmb * 2
           + nbytes(it13r["recon_y"]), K13_T8_OPS_PER_MB * nmb)
    # K8 with the ref_idx bins and i_ref, on that front, and K2 on its
    # ref4 (0, 1 and -1)
    a8r = (front_r, mb_h, mb_w, 2, True, (qm1, QP))
    a8rp = (front_r, mb_h, mb_w, True, (qm1, QP), 2)
    maps_r, ops_r, n_r = cabac_planes.cabac_p_ops(*a8r)
    pmaps_r, pops_r, pn_r = cabac_planes.cabac_p_ops_plain(*a8rp)
    n_ops_r = int(pn_r)
    if int(n_r) != n_ops_r:
        fail(f"K8 cabac_p_ops with two references counts {int(n_r)} ops, "
             f"its plain version {n_ops_r}")
    err8r = max(exact("K8 cabac_p_ops maps with two references", maps_r,
                      pmaps_r),
                exact("K8 cabac_p_ops ops with two references",
                      [ops_r[:n_ops_r]], [pops_r[:n_ops_r]]))
    refs_seen = sorted(maps_r["ref4"].unique().tolist())
    if refs_seen != [-1, 0, 1]:
        fail(f"the two-reference ref4 holds {refs_seen}, not -1, 0 and 1")
    record("cabac_p_ops_ref2", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/entropy/cabac_planes.py:625", err8r,
           event_ms(lambda: cabac_planes.cabac_p_ops(*a8r), 20),
           event_ms(lambda: cabac_planes.cabac_p_ops_plain(*a8rp), 1),
           nbytes(*(front_r[k] for k in keys8), front_r["ref_sel"],
                  *maps_r.values()) + 4 * n_ops_r + 4,
           K3_OPS_PER_OP * n_ops_r + K3_OPS_PER_MB * nmb)
    maps2r = (maps_r["qp_eff"], im_r, maps_r["nnz4"], maps_r["ref4"],
              maps_r["mv4"], z4, zmv, False, 0, 0, 0, maps_r["t8_mb"])
    src_r = (front_r["recon_y"], front_r["recon_u"], front_r["recon_v"])
    exact("K2 deblock_diag on a ref4 with 0, 1 and -1", dict(zip(
        "yuv", deblock.deblock_frame(mb_h, mb_w, *[t.clone() for t in src_r],
                                     *maps2r))), dict(zip(
        "yuv", deblock.deblock_frame_plain(
            mb_h, mb_w, *[t.clone() for t in src_r], *maps2r))))
    # K8's pass A alone and K19 with the ref_idx bit, on the CAVLC front
    # (no 8x8 transform, no trellis)
    front_rc = inter.encode_p_front(
        mb_h, mb_w, me_range, y1, u1, v1, *ref_newer, qtab_rd_aq, lam, mvp0,
        True, (2, 1), True, True, True, True, False, qm1, ref_older)
    pm_r = cabac_planes.p_maps(front_rc, mb_h, mb_w)
    errpa = exact("K8 pass A alone with two references", pm_r,
                  inter.p_maps_plain(front_rc, mb_h, mb_w))
    pm_r["dqp"] = aq.dqp_syntax(qm1, cabac_planes.has_dqp_p(pm_r, front_rc),
                                QP)[0]
    a19r = (front_rc, pm_r, mb_h, mb_w, *hdr_p, cap, 2)
    bits19r = same_words("K19 cavlc_p_slice with the ref_idx bit",
                         cavlc.cavlc_p_slice(*a19r),
                         cavlc.cavlc_p_slice_plain(*a19r))
    small19r = bits19r // 64
    same_words("K19 cavlc_p_slice with the ref_idx bit (half the bits' "
               "capacity)",
               cavlc.cavlc_p_slice(*a19r[:6], small19r, 2),
               cavlc.cavlc_p_slice_plain(*a19r[:6], small19r, 2), small19r)
    record("p_maps_ref2", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/encoder/inter.py:754", errpa,
           event_ms(lambda: cabac_planes.p_maps(front_rc, mb_h, mb_w), 20),
           event_ms(lambda: inter.p_maps_plain(front_rc, mb_h, mb_w), 1),
           nbytes(*(front_rc[k] for k in (
               "intra_mb", "me_mv", "ptype", "mv_quad", "cbp_luma_bits",
               "cbp_chroma", "luma_blocks", "ref_sel")), *pm_r.values()),
           K3_OPS_PER_MB * nmb)
    record("cavlc_p_slice_ref2", "cuda", "x264_tpu_torch/csrc/cavlc.cu",
           "x264_tpu/entropy/device.py:505", 0,
           event_ms(lambda: cavlc.cavlc_p_slice(*a19r), 20),
           event_ms(lambda: cavlc.cavlc_p_slice_plain(*a19r), 1),
           nbytes(*(front_rc[k] for k in keys19), *(
               pm_r[k] for k in ("skip", "ptype", "mvd", "mvd1", "mvd_sub",
                                 "dqp", "ref_idx")))
           + (bits19r + 31) // 32 * 4 + 4,
           K18_OPS_PER_MB * nmb + K18_OPS_PER_BIT * bits19r)
    # K24's pass A alone and K25 on the B frame above (front_b)
    bm_b = cabac_planes.b_maps(front_b, mb_h, mb_w)
    errbm = exact("K24 pass A alone", bm_b,
                  inter.b_maps_plain(front_b, mb_h, mb_w))
    hdr_b = slots(SLICE_B)
    a25 = (front_b, bm_b, mb_h, mb_w, *hdr_b, cap)
    bits25 = same_words("K25 cavlc_b_slice", cavlc.cavlc_b_slice(*a25),
                        cavlc.cavlc_b_slice_plain(*a25))
    small25 = bits25 // 64
    same_words("K25 cavlc_b_slice (half the bits' capacity)",
               cavlc.cavlc_b_slice(*a25[:6], small25),
               cavlc.cavlc_b_slice_plain(*a25[:6], small25), small25)
    record("b_maps", "cuda", "x264_tpu_torch/csrc/cabac_ops.cu",
           "x264_tpu/encoder/inter.py:1174", errbm,
           event_ms(lambda: cabac_planes.b_maps(front_b, mb_h, mb_w), 20),
           event_ms(lambda: inter.b_maps_plain(front_b, mb_h, mb_w), 1),
           nbytes(*(front_b[k] for k in cabac_planes.B_MAPS_IN),
                  *bm_b.values()), K3_OPS_PER_MB * nmb)
    keys25 = ("intra_mb", "mode16", "modec", "cbp_luma_bits", "cbp_chroma",
              "luma_dc", "luma_blocks", "chroma_dc", "chroma_ac",
              "direct_mb", "bmode")
    record("cavlc_b_slice", "cuda", "x264_tpu_torch/csrc/cavlc.cu",
           "x264_tpu/entropy/device.py:631", 0,
           event_ms(lambda: cavlc.cavlc_b_slice(*a25), 20),
           event_ms(lambda: cavlc.cavlc_b_slice_plain(*a25), 1),
           nbytes(*(front_b[k] for k in keys25), *(
               bm_b[k] for k in ("skip", "use_l0", "use_l1", "mvd_l0",
                                 "mvd_l1"))) + (bits25 + 31) // 32 * 4 + 4,
           K18_OPS_PER_MB * nmb + K18_OPS_PER_BIT * bits25)
    print(f"two-reference kernels: exact; {n_on1} inter MBs on L0[1], "
          f"{n_on0} on L0[0], {int(im_r.sum())} intra; K10 "
          f"{rec['subpel_refine_ref2']['ms']:.3f} ms over "
          f"{len(calls['subpel_refine_blocks'])} + "
          f"{len(calls['subpel_refine_parts'])} calls, K11 "
          f"{rec['part_fullpel_ref2']['ms']:.3f}, K12 "
          f"{rec['chroma_rerank_ref2']['ms']:.3f}, K6 "
          f"{rec['p_inter_mb_ref2']['ms']:.3f}, K13 "
          f"{rec['rd_inter_ref2']['ms']:.3f}, K8 "
          f"{rec['cabac_p_ops_ref2']['ms']:.3f} ({n_ops_r} ops), K8 pass A "
          f"{rec['p_maps_ref2']['ms']:.3f}, K19 "
          f"{rec['cavlc_p_slice_ref2']['ms']:.3f}; CAVLC B: K24 pass A "
          f"{rec['b_maps']['ms']:.3f} ms, K25 {rec['cavlc_b_slice']['ms']:.3f}"
          f" ms ({bits25} bits) [{smi_line}]", flush=True)

    # ------------------------------ the noise reduction and lossless
    stamp("phase 3: the noise reduction's and the lossless kernels")
    rng26 = np.random.default_rng(26)
    off4 = torch.as_tensor(rng26.integers(0, 300, 16), dtype=torch.int32,
                           device=dev)
    off8 = torch.as_tensor(rng26.integers(0, 300, 64), dtype=torch.int32,
                           device=dev)
    nr_kw = dict(nr_offset4=off4, nr_offset8=off8)
    # K6's NR branch at t8 0, 1 and 2 on the subme-6 arguments of frame 1
    # against frame 0's recon: the deadzone quant at QP 26, the trellis at
    # QP 26, and the trellis with frame 1's QP map and the 52-QP stacks
    qtab_rd_st = {**qtab_rd_aq, **inter.trellis_stacks(0, 0, dev)}
    for qtab_n, qm, tag in ((qtab_rd, None, f"QP {QP}"),
                            (tr_frame, None, f"QP {QP}, trellis"),
                            (qtab_rd_st, qm1, "QP map, trellis")):
        for t8m in (inter.T8_OFF, inter.T8_SA8D, inter.T8_RD):
            a6n = (*a6t, qtab_n, True, t8m, qm)
            n0 = inter.p_inter_mb.launches_nr
            k6n = inter.p_inter_mb(*a6n, **nr_kw)
            if inter.p_inter_mb.launches_nr != n0 + 1:
                fail("K6 did not count its NR launch")
            err6n = exact(f"K6 p_inter_mb with NR ({tag}, t8 {t8m})", k6n,
                          inter.p_inter_mb_plain(*a6n, **nr_kw))
            if "nr_sum8" in k6n and not (k6n["nr_sum8"] > 0).any():
                fail(f"K6 with NR ({tag}, t8 {t8m}) summed no 8x8 |coef|")
    ms6n = event_ms(lambda: inter.p_inter_mb(*a6n, **nr_kw), 10)
    ms6o = event_ms(lambda: inter.p_inter_mb(*a6n), 10)
    pl6n = event_ms(lambda: inter.p_inter_mb_plain(*a6n, **nr_kw), 1)
    record("p_inter_mb_nr", "cuda", "x264_tpu_torch/csrc/inter.cu",
           "x264_tpu/encoder/inter.py:119", err6n, ms6n, pl6n,
           nbytes(*a6t[2:10], qtab_rd_st["trellis_tab"], stacks["inter"],
                  qm1, off4, off8, *k6n.values()),
           (K6_T8_OPS_PER_MB + K6_NR_OPS_PER_MB) * nmb
           + trellis_ops(cats6, qmfs6))
    # K26 on that frame's |coef| (the plain residual functions give them),
    # on the 30%-gray reference's, and on 1080p-shaped |coef| past 2^24
    fenc6 = inter._tiles(y1, 16)
    err26, sums = 0, []
    for ref, tag in (((ry, ru, rv), "frame 1 on frame 0"),
                     (mixed, "frame 1 on the 30%-gray reference")):
        pred = inter._tiles(ref[0], 16)
        abs4 = inter.inter_luma_residual(fenc6, pred, qtab_rd,
                                         nr_offset=off4)[3] \
            .reshape(mb_h, mb_w, 16, 16)
        abs8 = inter.inter_luma_residual8(fenc6, pred, qtab_rd,
                                          nr_offset=off8)[3] \
            .reshape(mb_h, mb_w, 4, 64)
        for a in (abs4, abs8):
            err26 = max(err26, exact(f"K26 nr_sums ({tag}, {a.shape[-1]})",
                                     [oquant.nr_sums(a)],
                                     [oquant.nr_sums_plain(a)]))
        sums.append(float(oquant.nr_sums(abs4).max()) / 2 ** 24)
    big = torch.as_tensor(rng26.integers(0, 20000, (mb_h, mb_w, 16, 16)),
                          dtype=torch.int32, device=dev)
    kb, pb = oquant.nr_sums(big), oquant.nr_sums_plain(big)
    err26 = max(err26, exact("K26 nr_sums (|coef| up to 20000)", [kb], [pb]))
    if float(pb.max()) <= 2 ** 24:
        fail("K26's large case did not pass 2^24")
    a26 = (abs4, abs8)
    ms26 = sum(event_ms(lambda: oquant.nr_sums(a), 10) for a in a26)
    pl26 = sum(event_ms(lambda: oquant.nr_sums_plain(a), 1) for a in a26)
    lib26 = sum(event_ms(lambda: torch.sum(a, dim=(0, 1, 2),
                                           dtype=torch.float32), 10)
                for a in a26)
    record("nr_sums", "cuda", "x264_tpu_torch/csrc/nr.cu",
           "x264_tpu/ops/quant.py:120", err26, ms26, pl26,
           nbytes(*a26) + 4 * (16 + 64),
           sum(a.numel() for a in a26), lib26)
    print(f"noise reduction: K6's NR branch exact at t8 0 / 1 / 2 (deadzone,"
          f" trellis, trellis with a QP map); {ms6n:.3f} ms with NR (its two"
          f" K26 launches included) against {ms6o:.3f} without, same inputs;"
          f" K26 exact on frame 1's |coef| (largest 4x4 sum "
          f"{sums[0]:.4f} x 2^24; on the gray reference {sums[1]:.4f} x "
          f"2^24) and on 1080p |coef| up to 20000 (largest sum "
          f"{float(pb.max()) / 2 ** 24:.2f} x 2^24), {ms26:.3f} ms for a P "
          f"frame's 4x4 + 8x8 sums [{smi_line}]", flush=True)
    # the lossless bypass: K1 on frame 0, K6 and K7 on frame 1 against
    # frame 0's recon (the subme-6 partitions), CQP 0
    qtab0 = inter.make_qtab_p(0, tables.chroma_qp(0, 0), dev)
    lam0 = int(tables.LAMBDA_TABLE[0])
    a1l = (mb_h, mb_w, y, u, v, qtab0, lam0)
    k1l, n1l = counted(intra.encode_i16_frame, *a1l, False, None, True)
    torch.cuda.synchronize()
    p1l = {}
    pl1l = event_ms(lambda: p1l.update(intra.encode_i16_frame_plain(
        *a1l, lossless=True)), 1)
    err1l = exact("K1 intra_diag lossless", k1l, p1l)
    for src, key in ((y, "recon_y"), (u, "recon_u"), (v, "recon_v")):
        if not torch.equal(k1l[key], src):
            fail(f"K1 lossless: {key} is not the source")
    ms1l = event_ms(lambda: intra.encode_i16_frame(*a1l, lossless=True), 3)
    record("intra_diag_lossless", "cuda", "x264_tpu_torch/csrc/intra.cu",
           "x264_tpu/encoder/intra.py:97", err1l, ms1l, pl1l,
           nbytes(y, u, v) + nbytes(*k1l.values()),
           K1_LOSSLESS_OPS_PER_MB * nmb)
    a6l = (*a6t[:10], qtab0, False)
    k6l = inter.p_inter_mb(*a6l, lossless=True)
    err6l = exact("K6 p_inter_mb lossless", k6l,
                  inter.p_inter_mb_plain(*a6l, lossless=True))
    for src, key in ((y1, "recon_y"), (u1, "recon_u"), (v1, "recon_v")):
        if not torch.equal(k6l[key], src):
            fail(f"K6 lossless: {key} is not the source")
    ms6l = event_ms(lambda: inter.p_inter_mb(*a6l, lossless=True), 10)
    pl6l = event_ms(lambda: inter.p_inter_mb_plain(*a6l, lossless=True), 1)
    record("p_inter_mb_lossless", "cuda", "x264_tpu_torch/csrc/inter.cu",
           "x264_tpu/encoder/inter.py:106", err6l, ms6l, pl6l,
           nbytes(*a6t[2:10], *k6l.values()), K6_SUBPEL_OPS_PER_MB * nmb)
    a7l = (mb_h, mb_w, y1, u1, v1, k6l["recon_y"], k6l["recon_u"],
           k6l["recon_v"], rd_ms["a7"][8], qtab0, lam0, False)
    k7l = inter.intra_in_p(*a7l, lossless=True)
    err7l = exact("K7 intra_in_p lossless", k7l,
                  inter.intra_in_p_plain(*a7l, lossless=True))
    if not torch.equal(k7l["recon_y"], y1):
        fail("K7 lossless: recon_y is not the source")
    n_intra_l = int(k7l["intra_mb"].sum())
    ms7l = event_ms(lambda: inter.intra_in_p(*a7l, lossless=True), 10)
    pl7l = event_ms(lambda: inter.intra_in_p_plain(*a7l, lossless=True), 1)
    record("intra_in_p_lossless", "cuda", "x264_tpu_torch/csrc/intra_p.cu",
           "x264_tpu/encoder/inter.py:634", err7l, ms7l, pl7l,
           nbytes(*a7l[2:9], *k7l.values()),
           K7_OPS_PER_MB_SWEEP * (nmb + 2 * n_intra_l))
    print(f"lossless: K1 ({n1l} launches), K6 and K7 exact, every recon the"
          f" source; K1 {ms1l:.3f} ms, K6 {ms6l:.3f} ms, K7 {ms7l:.3f} ms "
          f"({n_intra_l} intra MBs) [{smi_line}]", flush=True)

    # ---- K27 hw_pack and K28 halo_extend, the MB-row sharded path's
    stamp("phase 3: the MB-row sharded path's kernels")
    y0, u0, v0 = frame_planes(frames[0])
    qt26 = intra.make_qtab(QP, tables.chroma_qp(QP, 0), dev)
    k1r = intra.encode_i16_frame(mb_h, mb_w, y0, u0, v0, qt26,
                                 int(tables.LAMBDA_TABLE[QP]))
    ops_i, n_i = cabac_planes.i_slice_ops(k1r, mb_h, mb_w)
    # a seeded stream, a third of it extended ops, whose halfwords pass a
    # small capacity
    rng27 = np.random.default_rng(27)
    n_x, cap_x = 100000, 3001
    kind_x = rng27.choice([0, 1, 2, 3, 5, 6, 7], n_x).astype(np.int64)
    ab_x = np.asarray(cabac_planes.HW_A_BITS)[kind_x]
    wide = rng27.random(n_x) < 0.33
    a_x = rng27.integers(0, 1 << 17, n_x) % np.where(wide, 1 << 17,
                                                     1 << ab_x)
    b_x = rng27.integers(0, 1 << 12, n_x) % np.where(wide, 1 << 12,
                                                     1 << (12 - ab_x))
    ops_x = torch.as_tensor(((kind_x << 29) | (b_x << 17) | a_x)
                            .astype(np.uint32).view(np.int32), device=dev)
    streams27 = (("frame 0's IDR", ops_i, n_i, 3 * ops_i.shape[0]),
                 ("frame 1's P", p_ms["ops"],
                  torch.tensor(p_ms["n_ops"], dtype=torch.int32, device=dev),
                  3 * p_ms["ops"].shape[0]),
                 ("a seeded stream past a small capacity", ops_x,
                  torch.tensor(n_x, dtype=torch.int32, device=dev), cap_x))
    for tag, ops_s, n_s, cap_s in streams27:
        (kw27, kn27), l27 = counted(cabac_planes.hw_pack, ops_s, n_s, cap_s)
        pw27, pn27 = cabac_planes.hw_pack_plain(ops_s, n_s, cap_s)
        live27 = min((int(pn27) + 1) // 2, pw27.shape[0])
        if l27 != 3 or int(kn27) != int(pn27) or not torch.equal(
                kw27[:live27], pw27[:live27]):
            fail(f"K27 hw_pack differs from its plain version on {tag} "
                 f"({l27} launches, {int(kn27)} against {int(pn27)} "
                 f"halfwords)")
        if tag.startswith("a seeded") and int(kn27) <= cap_s:
            fail("K27's seeded stream did not pass its capacity")
        print(f"K27 hw_pack on {tag}: {int(kn27)} halfwords for "
              f"{int(n_s)} ops, exact", flush=True)
    ops_pp, n_pp = streams27[1][1], streams27[1][2]
    n_ops_p = int(n_pp)
    ms27 = event_ms(lambda: cabac_planes.hw_pack(ops_pp, n_pp,
                                                 3 * ops_pp.shape[0]), 20)
    pl27 = event_ms(lambda: cabac_planes.hw_pack_plain(
        ops_pp, n_pp, 3 * ops_pp.shape[0]), 1)
    words_p, n_hw_p = cabac_planes.hw_pack(ops_pp, n_pp, 3 * ops_pp.shape[0])
    n_hw_p = int(n_hw_p)
    record("hw_pack", "cuda", "x264_tpu_torch/csrc/hwpack.cu",
           "x264_tpu/entropy/cabac_planes.py:455", 0, ms27, pl27,
           4 * n_ops_p + 2 * n_hw_p + 8, 0)
    # what packing would save on the unsharded path: the live prefix of
    # frame 1's P stream, packed and not, into pinned memory
    live_w = (n_hw_p + 1) // 2
    pin_o = torch.empty(n_ops_p, dtype=torch.int32, pin_memory=True)
    pin_w = torch.empty(live_w, dtype=torch.int32, pin_memory=True)
    d2h_o = event_ms(lambda: pin_o.copy_(ops_pp[:n_ops_p],
                                         non_blocking=True), 10)
    d2h_w = event_ms(lambda: pin_w.copy_(words_p[:live_w],
                                         non_blocking=True), 10)
    if not np.array_equal(ecabac.unpack_hw(pin_w.numpy(), n_hw_p),
                          pin_o.numpy().view(np.uint32)):
        fail("K27: frame 1's packed P stream does not unpack to its ops")
    print(f"K27 on frame 1's P stream: {n_ops_p} ops ({4 * n_ops_p} bytes) "
          f"as {n_hw_p} halfwords ({4 * live_w} bytes, "
          f"{4 * live_w / (4 * n_ops_p):.3f} of them); d2h of the live "
          f"prefix {d2h_o:.3f} ms unpacked, {d2h_w:.3f} ms packed, K27 "
          f"{ms27:.3f} ms [{smi_line}]", flush=True)
    # K28 on frame 0's recon cut into 4 bands of 17 MB rows, each position
    nb28 = 4
    band28 = mb_h // nb28
    rec0 = (k1r["recon_y"], k1r["recon_u"], k1r["recon_v"])
    bands28 = [tuple(t[k * band28 * s:(k + 1) * band28 * s].contiguous()
                     for t, s in zip(rec0, (16, 8, 8))) for k in range(nb28)]
    for k in range(nb28):
        n0 = prows.halo_extend.launches
        got = prows.ext_refs(bands28, k, dev)
        l28 = prows.halo_extend.launches - n0
        above = None if k == 0 else tuple(
            p[-h:] for p, h in zip(bands28[k - 1], (32, 16, 16)))
        below = None if k == nb28 - 1 else tuple(
            p[:h] for p, h in zip(bands28[k + 1], (32, 16, 16)))
        want = prows.halo_extend_plain(bands28[k], above, below)
        if not all(torch.equal(g, w) for g, w in zip(got, want)) or \
                l28 != 1:
            fail(f"K28 halo_extend differs from its plain version at band "
                 f"{k} of {nb28}")
    strips = tuple(tuple(p[-h:].contiguous() for p, h in
                         zip(bands28[0], (32, 16, 16))) for _ in range(2))
    ms28 = event_ms(lambda: prows.halo_extend(bands28[1], strips[0],
                                              strips[1]), 20)
    pl28 = event_ms(lambda: prows.halo_extend_plain(bands28[1], strips[0],
                                                    strips[1]), 3)
    out28 = prows.halo_extend(bands28[1], strips[0], strips[1])
    copy_dst = tuple(torch.empty_like(t) for t in strips[0])
    strip_ms = event_ms(lambda: [d.copy_(t, non_blocking=True)
                                 for d, t in zip(copy_dst, strips[0])], 20)
    record("halo_extend", "cuda", "x264_tpu_torch/csrc/halo.cu",
           "x264_tpu/parallel/rows.py:57", 0, ms28, pl28,
           nbytes(*bands28[1], *strips[0], *strips[1], *out28), 0)
    print(f"K28 halo_extend: 4 bands of {band28} MB rows, exact at each "
          f"position; {ms28:.3f} ms a band and reference (plain "
          f"{pl28:.3f} ms); one band's strips copied on the card "
          f"{strip_ms:.3f} ms [{smi_line}]", flush=True)

    # ---- K1 without I4x4 and over a frame axis, K29, K30, lowres_plane
    stamp("phase 3: intra without I4x4, the GOP batch, K29 and K30")
    lam26 = int(tables.LAMBDA_TABLE[QP])
    a1i = (mb_h, mb_w, y0, u0, v0, qt26, lam26)
    # K1's I16x16-only branch on frame 0: alone, with I8x8, lossless
    k1i, n1i = counted(intra.encode_i16_frame, *a1i, False, None, False,
                       False)
    torch.cuda.synchronize()
    p1i = {}
    pl1i = event_ms(lambda: p1i.update(intra.encode_i16_frame_plain(
        *a1i, i4x4=False)), 1)
    err1i = exact("K1 intra_diag without I4x4", k1i, p1i)
    if k1i["i4_mb"].any() or n1i != mb_h + mb_w - 1:
        fail(f"K1 without I4x4: I4x4 MBs or {n1i} launches")
    ms1i = event_ms(lambda: intra.encode_i16_frame(*a1i, i4x4=False), 5)
    ms1_i4 = event_ms(lambda: intra.encode_i16_frame(*a1i), 5)
    record("intra_diag_i16", "cuda", "x264_tpu_torch/csrc/intra.cu",
           "x264_tpu/encoder/intra.py:366", err1i, ms1i, pl1i,
           nbytes(y0, u0, v0) + nbytes(*k1i.values()),
           K1_I16_OPS_PER_MB * nmb)
    k1i8 = intra.encode_i16_frame(*a1i, True, None, False, False)
    exact("K1 intra_diag with I8x8 without I4x4", k1i8,
          intra.encode_i16_frame_plain(*a1i, True, i4x4=False))
    qt0 = intra.make_qtab(0, tables.chroma_qp(0, 0), dev)
    a1i0 = (mb_h, mb_w, y0, u0, v0, qt0, int(tables.LAMBDA_TABLE[0]))
    k1i0 = intra.encode_i16_frame(*a1i0, False, None, True, False)
    exact("K1 intra_diag lossless without I4x4", k1i0,
          intra.encode_i16_frame_plain(*a1i0, lossless=True, i4x4=False))
    if not torch.equal(k1i0["recon_y"], y0):
        fail("K1 lossless without I4x4: recon_y is not the source")
    print(f"K1 without I4x4: exact alone, with I8x8 "
          f"({int(k1i8['t8_mb'].sum())} I8x8 MBs) and lossless; "
          f"{ms1i:.3f} ms a frame against {ms1_i4:.3f} ms with I4x4, same "
          f"frame [{smi_line}]", flush=True)
    # K1's frame axis: N_GOP frames of make_frames in one launch a diagonal
    gop = [frame_planes(f) for f in frames[:N_GOP]]
    ysb, usb, vsb = (torch.stack([g[i] for g in gop]) for i in range(3))
    n0 = intra.encode_i16_frame.launches_batch     # K1's counts
    kb1 = intra.encode_i16_frames(mb_h, mb_w, ysb, usb, vsb, qt26, lam26)
    nb1 = intra.encode_i16_frame.launches_batch - n0
    torch.cuda.synchronize()
    pb1 = {}
    plb1 = event_ms(lambda: pb1.update(intra.encode_i16_frames_plain(
        mb_h, mb_w, ysb, usb, vsb, qt26, lam26)), 1)
    errb1 = exact("K1 intra_diag over a frame axis", kb1, pb1)
    if nb1 != mb_h + mb_w - 1:
        fail(f"K1's frame axis took {nb1} launches")
    msb1 = event_ms(lambda: intra.encode_i16_frames(mb_h, mb_w, ysb, usb,
                                                    vsb, qt26, lam26), 3)
    record("intra_diag_batch", "cuda", "x264_tpu_torch/csrc/intra.cu",
           "x264_tpu/parallel/mesh.py:36", errb1, msb1, plb1,
           nbytes(ysb, usb, vsb) + nbytes(*kb1.values()),
           K1_I16_OPS_PER_MB * nmb * N_GOP)
    print(f"K1 over {N_GOP} frames: exact, {msb1:.3f} ms a batch, "
          f"{msb1 / N_GOP:.3f} ms a frame against {ms1i:.3f} one frame a "
          f"call [{smi_line}]", flush=True)
    # K29 on frame 1 against frame 0's deblocked recon, R = 16 and R = 40
    # (past the pad: the clamped windows), with the ME seed of phase 3's
    # P frame and with a far predictor
    ref29 = mc.pad_plane(ry)
    y29, _, _ = frame_planes(frames[1])
    mvp29 = torch.as_tensor(np.random.default_rng(29).integers(
        -64, 64, (mb_h, mb_w, 2)), dtype=torch.int32, device=dev)
    err29 = 0
    for r29, mvp_t, lam_t, tag in ((16, mvp29, lam26, "R 16"),
                                   (40, mvp29, lam26, "R 40"),
                                   (40, torch.full_like(mvp29, -160), 3000,
                                    "R 40, a far predictor")):
        k29 = me.fullpel_search(y29, ref29, mb_h, mb_w, r29, lam_t, mvp_t)
        p29 = me.fullpel_search_plain(y29, ref29, mb_h, mb_w, r29, lam_t,
                                      mvp_t)
        err29 = max(err29, exact(f"K29 fullpel_search ({tag})", k29, p29))
    a29 = (y29, ref29, mb_h, mb_w, 16, lam26, mvp29)
    ms29 = event_ms(lambda: me.fullpel_search(*a29), 10)
    ms29_40 = event_ms(lambda: me.fullpel_search(*a29[:4], 40, *a29[5:]), 5)
    pl29 = event_ms(lambda: me.fullpel_search_plain(*a29), 1)
    record("fullpel_search", "cuda", "x264_tpu_torch/csrc/me.cu",
           "x264_tpu/ops/me.py:50", err29, ms29, pl29,
           nbytes(y29, ref29, mvp29) + 12 * nmb,
           K29_OPS_PER_CAND * 33 * 33 * nmb)
    print(f"K29 fullpel_search: exact at R 16, R 40 and R 40 with a far "
          f"predictor; {ms29:.3f} ms at R 16, {ms29_40:.3f} ms at R 40 "
          f"[{smi_line}]", flush=True)
    # K30 on frame 0's 16x16 MB tiles and its 8x8 tiles
    t16 = y0.reshape(mb_h, 16, mb_w, 16).transpose(1, 2).contiguous()
    t8_ = y0.reshape(mb_h * 2, 8, mb_w * 2, 8).transpose(1, 2).contiguous()
    err30 = 0
    for tiles, tag in ((t16, "16x16"), (t8_, "8x8")):
        err30 = max(err30, exact(f"K30 hadamard_ac ({tag} tiles)",
                                 opixel.hadamard_ac(tiles),
                                 opixel.hadamard_ac_plain(tiles)))
    ms30 = event_ms(lambda: opixel.hadamard_ac(t16), 20)
    ms30_8 = event_ms(lambda: opixel.hadamard_ac(t8_), 20)
    pl30 = event_ms(lambda: opixel.hadamard_ac_plain(t16), 3)
    record("hadamard_ac", "cuda", "x264_tpu_torch/csrc/pixel.cu",
           "x264_tpu/ops/pixel.py:151", err30, ms30, pl30,
           nbytes(t16) + 8 * nmb, K30_OPS_PER_SAMPLE * t16.numel())
    # lowres_plane: K14's phase-00 plane
    if not torch.equal(lookahead.lowres_plane(y0[:H]),
                       lookahead.lowres_planes_plain(y0, H, W)[0]):
        fail("lowres_plane differs from K14's plain phase-00 plane")
    print(f"K30 hadamard_ac: exact on 16x16 and 8x8 tiles, {ms30:.3f} ms "
          f"on frame 0's MBs, {ms30_8:.3f} ms on its 8x8 blocks; "
          f"lowres_plane exact [{smi_line}]", flush=True)

    wrappers = {"intra_diag": intra.encode_i16_frame,
                "cabac_i_ops": cabac_planes.i_slice_ops,
                "deblock_diag": deblock.deblock_frame,
                "frame_metrics": stats.frame_metrics,
                "me_hier": me.hier_search,
                "p_inter_mb": inter.p_inter_mb,
                "intra_in_p": inter.intra_in_p,
                "cabac_p_ops": cabac_planes.cabac_p_ops,
                "hpel_planes": mc.hpel_planes,
                # K10: the 16x16 call and the partition layouts' one
                "subpel_refine": (me.subpel_refine_blocks,
                                  me.subpel_refine_parts),
                "part_fullpel": me.partition_fullpel,
                "chroma_rerank": me.chroma_rerank,
                "rd_inter": inter.rd_inter,
                "lowres_planes": lookahead.lowres_planes,
                "lowres_cost": lookahead.lowres_cost,
                "aq_qp_map": aq.qp_map_from_planes,
                "dqp_syntax": aq.dqp_syntax,
                "cavlc_i_slice": cavlc.cavlc_i_slice,
                "cavlc_p_slice": cavlc.cavlc_p_slice,
                "p_maps": cabac_planes.p_maps,
                "trellis_scan": otrellis.trellis_scan,
                "lowres_bcost": lookahead.lowres_bcost,
                "b_inter_mb": inter.b_inter_mb,
                "intra_in_b_decide": inter.intra_in_b_decide,
                "intra_in_b_sweeps": inter.intra_in_b_sweeps,
                "b_direct": inter.b_direct,
                "cabac_b_ops": cabac_planes.cabac_b_ops,
                "b_maps": cabac_planes.b_maps,
                "cavlc_b_slice": cavlc.cavlc_b_slice,
                "nr_sums": oquant.nr_sums,
                "hw_pack": cabac_planes.hw_pack,
                "halo_extend": prows.halo_extend,
                "fullpel_search": me.fullpel_search,
                "hadamard_ac": opixel.hadamard_ac}
    # the kernels and branches of variance AQ, idle at constant QP
    aq_only = ("aq_qp_map", "dqp_syntax", "intra_diag_aq", "cabac_i_ops_aq",
               "p_inter_mb_aq", "intra_in_p_aq", "cabac_p_ops_aq")
    # the kernels of CAVLC, idle under CABAC, and those of CABAC, idle
    # under CAVLC
    cavlc_only = ("cavlc_i_slice", "cavlc_p_slice", "p_maps",
                  "cavlc_i_slice_aq", "cavlc_p_slice_aq")
    cabac_only = tuple(k for k in rec if k.startswith("cabac_"))
    # the 8x8 variants: the wrapper and its count of the launches that
    # took the variant's branch
    variants = {"intra_diag_i8x8": (intra.encode_i16_frame, "launches_i8x8"),
                "cabac_i_ops_t8": (cabac_planes.i_slice_ops, "launches_t8"),
                "deblock_diag_t8": (deblock.deblock_frame, "launches_t8"),
                "p_inter_mb_t8_sa8d": (inter.p_inter_mb, "launches_t8_sa8d"),
                "p_inter_mb_t8_rd": (inter.p_inter_mb, "launches_t8_rd"),
                "rd_inter_t8": (inter.rd_inter, "launches_t8"),
                "cabac_p_ops_t8": (cabac_planes.cabac_p_ops, "launches_t8"),
                "intra_diag_aq": (intra.encode_i16_frame, "launches_aq"),
                "cabac_i_ops_aq": (cabac_planes.i_slice_ops, "launches_aq"),
                "p_inter_mb_aq": (inter.p_inter_mb, "launches_aq"),
                "intra_in_p_aq": (inter.intra_in_p, "launches_aq"),
                "cabac_p_ops_aq": (cabac_planes.cabac_p_ops, "launches_aq"),
                "cavlc_i_slice_aq": (cavlc.cavlc_i_slice, "launches_aq"),
                "cavlc_p_slice_aq": (cavlc.cavlc_p_slice, "launches_aq"),
                "p_inter_mb_trellis": (inter.p_inter_mb,
                                       "launches_trellis"),
                "deblock_diag_b": (deblock.deblock_frame, "launches_b"),
                "subpel_refine_ref2": ((me.subpel_refine_blocks,
                                        me.subpel_refine_parts),
                                       "launches_ref2"),
                "part_fullpel_ref2": (me.partition_fullpel, "launches_ref2"),
                "chroma_rerank_ref2": (me.chroma_rerank, "launches_ref2"),
                "p_inter_mb_ref2": (inter.p_inter_mb, "launches_ref2"),
                "rd_inter_ref2": (inter.rd_inter, "launches_ref2"),
                "cabac_p_ops_ref2": (cabac_planes.cabac_p_ops,
                                     "launches_ref2"),
                "p_maps_ref2": (cabac_planes.p_maps, "launches_ref2"),
                "cavlc_p_slice_ref2": (cavlc.cavlc_p_slice,
                                       "launches_ref2"),
                "p_inter_mb_nr": (inter.p_inter_mb, "launches_nr"),
                "intra_diag_lossless": (intra.encode_i16_frame,
                                        "launches_lossless"),
                "p_inter_mb_lossless": (inter.p_inter_mb,
                                        "launches_lossless"),
                "intra_in_p_lossless": (inter.intra_in_p,
                                        "launches_lossless"),
                "intra_diag_i16": (intra.encode_i16_frame, "launches_i16"),
                "intra_diag_batch": (intra.encode_i16_frame,
                                     "launches_batch")}
    # the kernels and branches of B frames, idle without them
    b_only = ("lowres_bcost", "b_inter_mb", "intra_in_b_decide",
              "intra_in_b_sweeps", "b_direct", "cabac_b_ops",
              "deblock_diag_b")
    # K6's trellis branch, idle without --trellis, and K20, whose device
    # code runs inside K6 on every path (held against its plain version
    # in phase 3 alone)
    trellis_only = ("p_inter_mb_trellis",)
    standalone = ("trellis_scan",)
    # the two-reference branches, idle with one reference, and the kernels
    # of the CAVLC B slice, idle without B frames under CAVLC (phases
    # 14 and 15 run them)
    ref2_only = tuple(k for k in variants if k.endswith("_ref2"))
    cavlc_b_only = ("b_maps", "cavlc_b_slice")
    # the noise reduction's kernel and branch, and the lossless branches,
    # idle without --nr and above CQP 0 (phases 16 and 17 run them)
    nr_only = ("nr_sums", "p_inter_mb_nr")
    lossless_only = ("intra_diag_lossless", "p_inter_mb_lossless",
                     "intra_in_p_lossless")
    # the MB-row sharded path's kernels, idle unsharded (phase 18 runs
    # them)
    rows_only = ("hw_pack", "halo_extend")
    # intra without I4x4, the GOP batch, K29 and K30, idle on every
    # earlier path (phase 19 runs them)
    slice13_only = ("intra_diag_i16", "intra_diag_batch", "fullpel_search",
                    "hadamard_ac")
    later = ref2_only + cavlc_b_only + nr_only + lossless_only + rows_only \
        + slice13_only

    def fns(w) -> tuple:
        """A record's wrappers: one, or a tuple of those that launch its
        kernel."""
        return w if isinstance(w, tuple) else (w,)

    def reset_counts():
        """Every wrapper's and variant's launch count set to 0."""
        for w in wrappers.values():
            for f in fns(w):
                f.launches = 0
        for w, count in variants.values():
            for f in fns(w):
                setattr(f, count, 0)

    def read_counts() -> dict:
        """Every wrapper's and variant's launch count, by record name."""
        launches = {k: sum(f.launches for f in fns(w))
                    for k, w in wrappers.items()}
        launches.update({k: sum(getattr(f, count) for f in fns(w))
                         for k, (w, count) in variants.items()})
        return launches

    def main_path(keyint: int, n: int, what: str, subme: int = 1,
                  scenecut: int = 0, src=None, make=None, device=None):
        """Encoder on the first n frames of src (make_frames' by default)
        at 1080p, the launch counts set to 0 just before and read just
        after (the 8x8, AQ and CAVLC variants' among them, which must stay
        0 without make, whose parameters turn the 8x8 transform off at
        constant QP under CABAC); make: as in same_as_cpu; device: the
        Encoder's (a list: its bands'). Returns (frames, summary,
        launches, header, fps, median encode() ms, the encoder)."""
        enc = x264_tpu_torch.Encoder(
            make(x264_tpu_torch.EncoderParams, 3) if make else
            params(x264_tpu_torch.EncoderParams, 3, keyint, subme, scenecut),
            device=device)
        header = enc.headers()
        reset_counts()
        done, wall, call_ms = drive(enc, (src or frames)[:n])
        launches = read_counts()
        if make is None and any(launches[k] for k in (
                *variants, *aq_only, *cavlc_only, *cavlc_b_only)):
            fail(f"{what}: an 8x8, AQ or CAVLC branch ran without the 8x8 "
                 f"transform, variance AQ or CAVLC")
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
    for k in list(wrappers)[:15]:
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
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_RD, 250, what7,
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
    # subme 6 takes the RD transform choice: the SA8D branch stays idle,
    # and so do variance AQ's kernels and branches at constant QP
    for k, n in launches_8.items():
        if (n <= 0) != (k == "p_inter_mb_t8_sa8d" or k in aq_only
                        or k in cavlc_only or k in trellis_only
                        or k in standalone or k in b_only or k in later):
            fail(f"kernel {k} was launched {n} times on the {what8}")
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
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_EARLY, 250, what8,
                make=bench_params)
    device_split(x264_tpu_torch, cut, 4, 8, 6, 40, make=bench_params)

    # ----------------- 9. x264_tpu's own defaults: CRF 23 with variance AQ
    stamp("phase 9")
    seen9 = {"IDR": [], "P": []}
    encode_idr, encode_p = pipeline.encode_i16_idr_cabac, \
        pipeline.encode_p_cabac

    def seen_dqp(fn, kind, seen):
        def call(*a, **k):
            out = fn(*a, **k)
            seen[kind].append(out.get("dqp"))
            return out
        return call

    pipeline.encode_i16_idr_cabac = seen_dqp(encode_idr, "IDR", seen9)
    pipeline.encode_p_cabac = seen_dqp(encode_p, "P", seen9)
    what9 = "x264_tpu's defaults (CRF 23, variance AQ)"
    done, summary, launches_9, header, fps, med, enc = main_path(
        250, N_DEFAULTS, what9, src=cut, make=defaults_params)
    pipeline.encode_i16_idr_cabac, pipeline.encode_p_cabac = encode_idr, \
        encode_p
    if not (enc._aq and enc._t8 and enc._i8x8 and enc._rd
            and enc._analyse_lowres and enc.rc.method == 1):
        fail(f"{what9}: the defaults did not turn on CRF, variance AQ, the "
             f"8x8 transform, I8x8, the RD ladder and the lookahead")
    for k, n in launches_9.items():
        if (n <= 0) != (k == "p_inter_mb_t8_sa8d" or k in cavlc_only
                        or k in trellis_only or k in standalone
                        or k in b_only or k in later):
            fail(f"kernel {k} was launched {n} times on {what9}")
    if launches_9["frame_metrics"] != N_DEFAULTS:
        fail(f"{what9}: K4 launched {launches_9['frame_metrics']} times for "
             f"{N_DEFAULTS} frames")
    if any(d is None for v in seen9.values() for d in v):
        fail(f"{what9}: a frame ran without the mb_qp_delta planes")
    dqp_nz = [int((d != 0).sum()) for v in seen9.values() for d in v]
    if len(seen9["IDR"]) != 2 or sum(dqp_nz) == 0:
        fail(f"{what9}: {len(seen9['IDR'])} IDRs, nonzero mb_qp_delta MBs "
             f"per frame {dqp_nz}")
    qps = [e.qp for e in enc.rc.entries]
    ippp_report(done, summary, enc.stats, fps, med, N_DEFAULTS, 6, smi_line,
                nmb, f", CRF 23 with variance AQ: frame QPs {min(qps)}-"
                f"{max(qps)} ({qps}), {sum(dqp_nz) / (nmb * N_DEFAULTS):.4f} "
                f"of MBs code a nonzero mb_qp_delta, IDRs at frames 0 and "
                f"{CUT} ({len(done[CUT].payload)} bytes at frame {CUT}), host "
                f"wait on the lookahead "
                f"{enc.rc.lookahead_wait_s / N_DEFAULTS * 1e3:.3f} ms a frame",
                idrs=(0, CUT), rc="CRF 23")
    ph9 = dict(fps=fps, qps=qps, idr=len(done[0].payload),
               p=statistics.mean(len(e.payload) for i, e in enumerate(done)
                                 if i not in (0, CUT)),
               psnr=summary["psnr"]["avg"], ssim=summary["ssim_y"])
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_EARLY, 250, what9,
                make=defaults_params, frame_parallel=3)
    device_split(x264_tpu_torch, cut, 4, 8, 6, 40, make=defaults_params,
                 tag="x264_tpu's defaults (CRF 23, variance AQ)")

    # -------------------- 10. bench.py's all-intra CAVLC line (CQP 26)
    stamp("phase 10")
    what10 = "all-intra CAVLC"
    done, summary, launches_10, header, fps, med, _ = main_path(
        1, N_INTRA_CAVLC, what10, make=cavlc_intra_params)
    for k, n in launches_10.items():
        if (n > 0) != (k in ("intra_diag", "cavlc_i_slice", "deblock_diag",
                             "frame_metrics")):
            fail(f"kernel {k} was launched {n} times on the {what10} path")
    sizes = [len(e.payload) for e in done]
    print(f"{what10} path: {N_INTRA_CAVLC} frames {W}x{H} keyint 1 CQP {QP} "
          f"CAVLC, deblock, {fps:.3f} fps, median encode() {med:.1f} ms, "
          f"{statistics.mean(sizes):.0f} bytes/frame, PSNR Y "
          f"{summary['psnr']['y']:.4f} avg {summary['psnr']['avg']:.4f} dB, "
          f"SSIM {summary['ssim_y']:.6f}, d2h of the word buffer "
          f"{cav_ms['d2h']:.3f} ms a frame [{smi_line}]", flush=True)
    same_as_cpu(x264_tpu_torch, done, frames, header, 1, 1, what10,
                make=cavlc_intra_params)
    device_split(x264_tpu_torch, frames, 2, N_INTRA_CAVLC - 2, 1,
                 make=cavlc_intra_params, tag=what10)

    # -------- 11. x264_tpu's defaults with b_cabac off (CRF 23, AQ)
    stamp("phase 11")
    seen11 = {"IDR": [], "P": []}
    encode_idr, encode_p = pipeline.encode_i16_idr, pipeline.encode_p
    pipeline.encode_i16_idr = seen_dqp(encode_idr, "IDR", seen11)
    pipeline.encode_p = seen_dqp(encode_p, "P", seen11)
    what11 = "x264_tpu's defaults with CAVLC (CRF 23, variance AQ)"
    done, summary, launches_11, header, fps, med, enc = main_path(
        250, N_DEFAULTS, what11, src=cut, make=cavlc_defaults_params)
    pipeline.encode_i16_idr, pipeline.encode_p = encode_idr, encode_p
    if not (enc._aq and enc._rd and enc._analyse_lowres
            and not (enc._cabac or enc._t8 or enc._i8x8)
            and enc.rc.method == 1):
        fail(f"{what11}: the defaults without CABAC did not turn on CRF, "
             f"variance AQ, the RD ladder and the lookahead, and off the "
             f"8x8 transform and I8x8")
    idle11 = set(cabac_only) | {k for k in launches_11 if "t8" in k
                                or "i8x8" in k} | set(trellis_only) \
        | set(standalone) | set(b_only) | set(later)
    for k, n in launches_11.items():
        if (n <= 0) != (k in idle11):
            fail(f"kernel {k} was launched {n} times on {what11}")
    dqp_nz = [int((d != 0).sum()) for v in seen11.values() for d in v]
    if len(seen11["IDR"]) != 2 or sum(dqp_nz) == 0:
        fail(f"{what11}: {len(seen11['IDR'])} IDRs, nonzero mb_qp_delta "
             f"MBs per frame {dqp_nz}")
    dqp_max = max(int(d.abs().max()) for v in seen11.values() for d in v)
    qps = [e.qp for e in enc.rc.entries]
    ippp_report(done, summary, enc.stats, fps, med, N_DEFAULTS, 6, smi_line,
                nmb, f", CAVLC, CRF 23 with variance AQ: frame QPs "
                f"{min(qps)}-{max(qps)} ({qps}), "
                f"{sum(dqp_nz) / (nmb * N_DEFAULTS):.4f} of MBs code a "
                f"nonzero mb_qp_delta (largest |mb_qp_delta| {dqp_max}), IDRs "
                f"at frames 0 and {CUT} ({len(done[CUT].payload)} bytes at "
                f"frame {CUT}), host wait on the lookahead "
                f"{enc.rc.lookahead_wait_s / N_DEFAULTS * 1e3:.3f} ms a frame",
                idrs=(0, CUT), rc="CRF 23", entropy="CAVLC")
    ph11 = dict(fps=fps, summary=summary, med=med, done=done)
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_CAVLC, 250,
                what11, make=cavlc_defaults_params, frame_parallel=3)
    device_split(x264_tpu_torch, cut, 4, 8, 6, 40,
                 make=cavlc_defaults_params, tag=what11)
    # ------ 12. x264_tpu's defaults with the CABAC trellis (--trellis 1)
    stamp("phase 12")
    seen12 = {"IDR": [], "P": []}
    encode_idr, encode_p = pipeline.encode_i16_idr_cabac, \
        pipeline.encode_p_cabac
    pipeline.encode_i16_idr_cabac = seen_dqp(encode_idr, "IDR", seen12)
    pipeline.encode_p_cabac = seen_dqp(encode_p, "P", seen12)
    what12 = "x264_tpu's defaults with --trellis 1 (CRF 23, variance AQ)"
    done, summary, launches_12, header, fps, med, enc = main_path(
        250, N_TRELLIS, what12, src=cut, make=trellis_params)
    pipeline.encode_i16_idr_cabac, pipeline.encode_p_cabac = encode_idr, \
        encode_p
    if not (enc._trellis and enc._aq and enc._t8 and enc._i8x8 and enc._rd
            and enc._analyse_lowres and enc.rc.method == 1):
        fail(f"{what12}: the trellis did not open at the defaults")
    for k, n in launches_12.items():
        if (n <= 0) != (k == "p_inter_mb_t8_sa8d" or k in cavlc_only
                        or k in standalone or k in b_only or k in later):
            fail(f"kernel {k} was launched {n} times on {what12}")
    if launches_12["p_inter_mb_trellis"] != launches_12["p_inter_mb"]:
        fail(f"{what12}: K6 ran {launches_12['p_inter_mb']} times, "
             f"{launches_12['p_inter_mb_trellis']} of them with the trellis")
    if len(seen12["IDR"]) != 2:
        fail(f"{what12}: {len(seen12['IDR'])} IDRs")
    qps = [e.qp for e in enc.rc.entries]
    p12 = statistics.mean(len(e.payload) for i, e in enumerate(done)
                          if i not in (0, CUT))
    ippp_report(done, summary, enc.stats, fps, med, N_TRELLIS, 6, smi_line,
                nmb, f", CRF 23 with variance AQ and trellis 1: frame QPs "
                f"{min(qps)}-{max(qps)} ({qps}), IDRs at frames 0 and {CUT}; "
                f"against phase 9 (the same without the trellis): {fps:.3f} "
                f"fps vs {ph9['fps']:.3f}, IDR {len(done[0].payload)} vs "
                f"{ph9['idr']} bytes, P {p12:.0f} vs {ph9['p']:.0f} bytes/"
                f"frame, PSNR avg {summary['psnr']['avg']:.4f} vs "
                f"{ph9['psnr']:.4f} dB, SSIM {summary['ssim_y']:.6f} vs "
                f"{ph9['ssim']:.6f}, frame QPs equal to phase 9's: "
                f"{qps == ph9['qps']}", idrs=(0, CUT), rc="CRF 23")
    ph12 = dict(fps=fps, idr=len(done[0].payload), p=p12,
                psnr=summary["psnr"]["avg"], ssim=summary["ssim_y"])
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_EARLY, 250,
                what12, make=trellis_params, frame_parallel=3)
    device_split(x264_tpu_torch, cut, 4, 8, 6, 40, make=trellis_params,
                 tag=what12)

    # ------ 13. x264_tpu's defaults with B frames (i_bframe 3, b-adapt 1)
    stamp("phase 13")
    progs = {n: getattr(lookahead, n) for n in ("badapt_first", "badapt_ext",
                                                "b_seed_mvs", "b_cost")}
    seen13 = []

    def seen_prog(name, fn):
        def call(*a):
            out = fn(*a)
            seen13.append((name, a, out))
            return out
        return call

    for name, fn in progs.items():
        setattr(lookahead, name, seen_prog(name, fn))
    what13 = "x264_tpu's defaults with B frames (i_bframe 3, b-adapt 1)"
    try:
        done, summary, launches_13, header, fps, med, enc = main_path(
            250, N_BFRAMES, what13, src=cut, make=bframes_params)
    finally:
        for name, fn in progs.items():
            setattr(lookahead, name, fn)
    if not (enc._bframes == 3 and enc._badapt and not enc._badapt2
            and enc._aq and enc._t8 and enc._rd and enc.rc.method == 1):
        fail(f"{what13}: the defaults with i_bframe 3 did not turn on "
             f"b-adapt 1, CRF with variance AQ, the 8x8 transform and RD")
    for k, n in launches_13.items():
        if (n <= 0) != (k == "p_inter_mb_t8_sa8d" or k in cavlc_only
                        or k in trellis_only or k in standalone
                        or k in later):
            fail(f"kernel {k} was launched {n} times on {what13}")
    ph13 = dict(fps=fps)
    # every b-adapt decision and seed against the plain K21's on the same
    # lowres planes
    for name, args, out in seen13:
        lookahead.lowres_bcost = plain21
        try:
            want = progs[name](*args)
        finally:
            lookahead.lowres_bcost = kernel21
        got = out if isinstance(out, tuple) else (out,)
        exact(f"{what13}: {name}", got,
              want if isinstance(want, tuple) else (want,))
    n_calls = {n: sum(c[0] == n for c in seen13) for n in progs}
    types = [e.frame_type for e in done]
    idrs = sorted(e.display_idx for e in done if e.frame_type == "IDR")
    if "B" not in types or idrs != [0, CUT]:
        fail(f"{what13}: frame types {types}, IDRs at display {idrs}")
    by_type = {t: [len(e.payload) for e in done if e.frame_type == t]
               for t in ("IDR", "P", "B")}
    qps = [e.qp for e in enc.rc.entries]
    st13 = enc.stats
    print(f"{what13}: {N_BFRAMES} frames {W}x{H} CRF 23 with variance AQ, "
          f"{fps:.3f} fps (phase 9: {ph9['fps']:.3f}), median encode() "
          f"{med:.1f} ms, encode order {''.join(t[0] for t in types)} "
          f"(display {[e.display_idx for e in done]}), bytes IDR "
          f"{statistics.mean(by_type['IDR']):.0f}, P "
          f"{statistics.mean(by_type['P']):.0f} ({len(by_type['P'])} "
          f"frames), B {statistics.mean(by_type['B']):.0f} "
          f"({len(by_type['B'])} frames; phase 9's P {ph9['p']:.0f}), PSNR "
          f"Y {summary['psnr']['y']:.4f} avg {summary['psnr']['avg']:.4f} "
          f"dB (phase 9 {ph9['psnr']:.4f}), SSIM {summary['ssim_y']:.6f} "
          f"(phase 9 {ph9['ssim']:.6f}), frame QPs {qps}, b-adapt "
          f"decisions and seeds equal to the plain K21's: {n_calls}, "
          f"{st13.mb_intra} intra and {st13.mb_skip} skip MBs in all "
          f"[{smi_line}]", flush=True)
    # the first frames in encode order: on this noisy pan b-adapt 1 keeps
    # no B before the cut, so a CPU run up to the first B would encode 29
    # frames; phase 13's own IDR and P, then a run that starts on the
    # second picture, where B pays, with i_bframe 1 (its first frames in
    # encode order are IDR, P, B whatever b-adapt says)
    same_as_cpu_b(x264_tpu_torch, done, cut, header, 2, what13,
                  bframes_params)
    what13b = "the defaults with i_bframe 1 on the second picture"

    enc13b = x264_tpu_torch.Encoder(bframes1_params(
        x264_tpu_torch.EncoderParams))
    header13b = enc13b.headers()
    done13b, _, _ = drive(enc13b, cut[CUT:CUT + 3])
    enc13b.close()
    if [e.frame_type for e in done13b] != ["IDR", "P", "B"]:
        fail(f"{what13b}: frame types {[e.frame_type for e in done13b]}")
    same_as_cpu_b(x264_tpu_torch, done13b, cut[CUT:CUT + 3], header13b, 3,
                  what13b, bframes1_params)
    # the profiled window holds the cut and the B run after it
    device_split(x264_tpu_torch, cut, 24, 8, 6, 40, make=bframes_params,
                 tag=what13)
    # ---- 14. x264's default preset as far as x264_tpu encodes it:
    # --ref 3 (clamped to 2), --bframes 3 (b-adapt 1), --trellis 1, at
    # CRF 23 with variance AQ, CABAC
    stamp("phase 14")
    what14 = ("x264's default preset (--ref 3 as ref 2, --bframes 3, "
              "--trellis 1, CRF 23, variance AQ)")
    seen14 = []
    encode_p = pipeline.encode_p_cabac

    def seen_refs(fn, seen):
        def call(*a, **k):
            out = fn(*a, **k)
            seen.append((k.get("ref2") is not None, out["ref_idx"],
                         out.get("dqp")))
            return out
        return call

    pipeline.encode_p_cabac = seen_refs(encode_p, seen14)
    try:
        done, summary, launches_14, header, fps, med, enc = main_path(
            250, N_PRESET, what14, src=cut, make=preset_params)
    finally:
        pipeline.encode_p_cabac = encode_p
    if not (enc.params.i_frame_reference == 2 and enc._bframes == 3
            and enc._badapt and enc._trellis and enc._aq and enc._t8
            and enc._rd and enc.pps.num_ref_idx_l0 == 2):
        fail(f"{what14}: the preset did not open ref 2, i_bframe 3, b-adapt "
             f"1, the trellis, AQ, the 8x8 transform and RD")
    idle14 = set(cavlc_only) | set(cavlc_b_only) | set(standalone) | {
        "p_inter_mb_t8_sa8d", "p_maps_ref2", "cavlc_p_slice_ref2"} \
        | set(nr_only) | set(lossless_only) | set(rows_only) \
        | set(slice13_only)
    for k, n in launches_14.items():
        if (n <= 0) != (k in idle14):
            fail(f"kernel {k} was launched {n} times on {what14}")
    ph14 = preset_report(what14, done, summary, enc, fps, med, seen14,
                         f"phase 12 {ph12['fps']:.3f}, phase 13 "
                         f"{ph13['fps']:.3f}")
    # the first three frames in encode order: the IDR, the P with one
    # reference (its header overrides the PPS's two) and the first P
    # with two (b-adapt 1 keeps no B in the noisy first picture)
    if [e.frame_type for e in done[:3]] != ["IDR", "P", "P"] or \
            [r for r, _, _ in seen14[:2]] != [False, True]:
        fail(f"{what14}: the first frames in encode order are "
             f"{[e.frame_type for e in done[:3]]}, two references "
             f"{[r for r, _, _ in seen14[:2]]}")
    same_as_cpu_b(x264_tpu_torch, done, cut, header, 3, what14,
                  preset_params)
    # three 1080p flash frames at i_bframe 0: the third P finds the band
    # in L0[1]
    flash = flash_frames(W, H, 3, x264_tpu_torch.Frame)
    seen14f = []
    pipeline.encode_p_cabac = seen_refs(encode_p, seen14f)
    try:
        enc14f = x264_tpu_torch.Encoder(preset_flash_params(
            x264_tpu_torch.EncoderParams))
        header14f = enc14f.headers()
        done14f, _, _ = drive(enc14f, flash)
        enc14f.close()
    finally:
        pipeline.encode_p_cabac = encode_p
    on1 = int((seen14f[-1][1] == 1).sum()) if seen14f else 0
    if [e.frame_type for e in done14f] != ["IDR", "P", "P"] or on1 == 0:
        fail(f"{what14} on flash frames: types "
             f"{[e.frame_type for e in done14f]}, {on1} MBs on L0[1]")
    same_as_cpu(x264_tpu_torch, done14f, flash, header14f, 3, 250,
                f"{what14} at i_bframe 0 on flash frames",
                make=preset_flash_params, frame_parallel=3)
    print(f"{what14} at i_bframe 0 on three flash frames: {on1} of {nmb} "
          f"MBs of the third frame on L0[1], bytes "
          f"{[len(e.payload) for e in done14f]}", flush=True)
    device_split(x264_tpu_torch, cut, 24, 8, 6, 40, make=preset_params,
                 tag=what14)

    # ---- 15. the same with b_cabac off: ref 2, --bframes 3 through the
    # CAVLC B slice, no trellis, no 8x8 transform
    stamp("phase 15")
    what15 = ("x264's default preset with CAVLC (ref 2, --bframes 3, CRF "
              "23, variance AQ)")
    seen15 = []
    encode_p = pipeline.encode_p
    pipeline.encode_p = seen_refs(encode_p, seen15)
    try:
        done, summary, launches_15, header, fps, med, enc = main_path(
            250, N_PRESET, what15, src=cut, make=preset_cavlc_params)
    finally:
        pipeline.encode_p = encode_p
    if not (enc.params.i_frame_reference == 2 and enc._bframes == 3
            and not (enc._cabac or enc._trellis or enc._t8)
            and enc._aq and enc._rd):
        fail(f"{what15}: the preset without CABAC did not open ref 2 and "
             f"B frames without the trellis and the 8x8 transform")
    idle15 = set(cabac_only) | {k for k in launches_15 if "t8" in k
                                or "i8x8" in k} | set(trellis_only) \
        | set(standalone) | set(nr_only) | set(lossless_only) \
        | set(rows_only) | set(slice13_only)
    for k, n in launches_15.items():
        if (n <= 0) != (k in idle15):
            fail(f"kernel {k} was launched {n} times on {what15}")
    preset_report(what15, done, summary, enc, fps, med, seen15,
                  f"phase 11 {ph11['fps']:.3f}; phase 14 "
                  f"{ph14['fps']:.3f}, P {ph14['p']:.0f} bytes, B "
                  f"{ph14['b']:.0f} bytes")
    same_as_cpu_b(x264_tpu_torch, done, cut, header, 3, what15,
                  preset_cavlc_params)
    # an IDR, P, B run of the second picture at i_bframe 1 (as phase 13's)
    what15b = "the CAVLC preset with i_bframe 1 on the second picture"

    enc15b = x264_tpu_torch.Encoder(preset_cavlc_b1_params(
        x264_tpu_torch.EncoderParams))
    header15b = enc15b.headers()
    n25 = cavlc.cavlc_b_slice.launches
    done15b, _, _ = drive(enc15b, cut[CUT:CUT + 3])
    enc15b.close()
    if [e.frame_type for e in done15b] != ["IDR", "P", "B"] or \
            cavlc.cavlc_b_slice.launches == n25:
        fail(f"{what15b}: frame types {[e.frame_type for e in done15b]}")
    same_as_cpu_b(x264_tpu_torch, done15b, cut[CUT:CUT + 3], header15b, 3,
                  what15b, preset_cavlc_b1_params)
    device_split(x264_tpu_torch, cut, 24, 8, 6, 40,
                 make=preset_cavlc_params, tag=what15)
    # ---- 16. the defaults with the trellis, --nr 250 and --cqm jvt
    stamp("phase 16")
    seen16 = []
    encode_p = pipeline.encode_p_cabac

    def seen_nr(*a, **k):
        seen16.append(("nr_offset4" in k, "nr_offset8" in k))
        return encode_p(*a, **k)

    pipeline.encode_p_cabac = seen_nr
    what16 = ("x264_tpu's defaults with --trellis 1, --nr 250 and --cqm jvt "
              "(CRF 23, variance AQ)")
    try:
        done, summary, launches_16, header, fps, med, enc = main_path(
            250, N_NR, what16, src=cut, make=nr_cqm_params)
    finally:
        pipeline.encode_p_cabac = encode_p
    if not (enc._nr == 250 and enc.params.i_cqm_preset == 1
            and (enc.qt.scaling_list4 != 16).any() and enc._trellis
            and enc._aq and enc._t8 and enc._rd):
        fail(f"{what16}: the parameters did not open the noise reduction, "
             f"the JVT matrices, the trellis, AQ and the 8x8 transform")
    idle16 = {"p_inter_mb_t8_sa8d", *cavlc_only, *standalone, *b_only,
              *rows_only, *slice13_only,
              *ref2_only, *cavlc_b_only, *lossless_only}
    for k, n in launches_16.items():
        if (n <= 0) != (k in idle16):
            fail(f"kernel {k} was launched {n} times on {what16}")
    n_p16 = sum(e.frame_type == "P" for e in done)
    if (launches_16["p_inter_mb_nr"], launches_16["nr_sums"],
            len(seen16)) != (n_p16, 2 * n_p16, n_p16) or \
            not all(a and b for a, b in seen16):
        fail(f"{what16}: {n_p16} P frames, K6's NR branch "
             f"{launches_16['p_inter_mb_nr']}, K26 {launches_16['nr_sums']} "
             f"launches, offsets passed {seen16}")
    qps = [e.qp for e in enc.rc.entries]
    p16 = statistics.mean(len(e.payload) for i, e in enumerate(done)
                          if i not in (0, CUT))
    ippp_report(done, summary, enc.stats, fps, med, N_NR, 6, smi_line,
                nmb, f", CRF 23 with variance AQ, trellis 1, NR 250, JVT "
                f"matrices: frame QPs {min(qps)}-{max(qps)} ({qps}), IDRs at "
                f"frames 0 and {CUT}; against phase 12 (the same without NR "
                f"and CQM): {fps:.3f} fps vs {ph12['fps']:.3f}, IDR "
                f"{len(done[0].payload)} vs {ph12['idr']} bytes, P {p16:.0f} "
                f"vs {ph12['p']:.0f} bytes/frame, PSNR avg "
                f"{summary['psnr']['avg']:.4f} vs {ph12['psnr']:.4f} dB, SSIM "
                f"{summary['ssim_y']:.6f} vs {ph12['ssim']:.6f}; the final "
                f"NR offsets 4x4 {enc._nr_off[0].tolist()}, 8x8 "
                f"{enc._nr_off[1].tolist()}", idrs=(0, CUT), rc="CRF 23")
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_NR, 250, what16,
                make=nr_cqm_params, frame_parallel=3)
    # i_mb_row_shards 2 on the one card: x264_tpu's fallback line, and the
    # bytes of i_mb_row_shards 1 at the parameters validate() leaves
    # (with shards it turns I8x8 off, as x264_tpu's does)
    what16s = f"{what16} at i_mb_row_shards 2"
    lines = []
    xlog.set_log_callback(lambda level, msg: lines.append(msg))
    try:
        p2 = nr_cqm_params(x264_tpu_torch.EncoderParams, 3, shards=2)
        p2.i_log_level = 2
        enc2 = x264_tpu_torch.Encoder(p2)
    finally:
        xlog.set_log_callback(None)
    enc2.params.i_log_level = 0      # no stats report at close()
    want = (f"mb-row sharding unavailable (shards=2, mb_h={mb_h}); "
            f"encoding unsharded")
    if want not in lines:
        fail(f"{what16s}: the fallback line is missing from {lines}")
    done2, _, _ = drive(enc2, cut[:3])
    enc2.close()
    p1 = nr_cqm_params(x264_tpu_torch.EncoderParams, 3)
    p1.analyse.intra = enc2.params.analyse.intra
    enc1 = x264_tpu_torch.Encoder(p1)
    done1, _, _ = drive(enc1, cut[:3])
    enc1.close()
    if [e.payload for e in done2] != [e.payload for e in done1]:
        fail(f"{what16s}: the bytes differ from i_mb_row_shards 1's")
    print(f"{what16s}: logs '{want}', and frames 0-2 "
          f"({[len(e.payload) for e in done2]} bytes) equal "
          f"i_mb_row_shards 1's", flush=True)

    # ---- 17. lossless (CQP 0): CABAC, then CAVLC
    stamp("phase 17")
    what17 = "lossless (CQP 0, subme 6) CABAC"
    done, summary, launches_17, header, fps, med, enc = main_path(
        250, N_LOSSLESS, what17, make=lossless_params)
    if not (enc._lossless and not enc._rd and enc.sps.profile_idc == 144
            and enc.sps.qpprime_y_zero_transform_bypass):
        fail(f"{what17}: not the bypass (profile {enc.sps.profile_idc})")
    must17 = ("intra_diag", "intra_diag_lossless", "p_inter_mb",
              "p_inter_mb_lossless", "intra_in_p", "intra_in_p_lossless",
              "cabac_i_ops", "cabac_p_ops", "deblock_diag", "frame_metrics")
    idle17 = {*aq_only, *cavlc_only, *trellis_only, *standalone, *b_only,
              *rows_only, *slice13_only,
              *ref2_only, *cavlc_b_only, *nr_only, "rd_inter"} | {
        k for k in launches_17 if "t8" in k or "i8x8" in k}
    for k, n in launches_17.items():
        if (k in must17 and n <= 0) or (k in idle17 and n > 0):
            fail(f"kernel {k} was launched {n} times on {what17}")
    lossless_check(done, frames, what17)
    ph17 = dict(fps=fps, sizes=[len(e.payload) for e in done])
    same_as_cpu(x264_tpu_torch, done, frames, header, N_CHECK_LOSSLESS, 250,
                what17, make=lossless_params, frame_parallel=3)
    what17c = "lossless (CQP 0, subme 6) CAVLC"
    done, _, launches_17c, header, fps_c, med_c, enc = main_path(
        250, N_LOSSLESS_CAVLC, what17c, make=lossless_cavlc_params)
    for k in ("intra_diag_lossless", "p_inter_mb_lossless",
              "intra_in_p_lossless", "cavlc_i_slice", "cavlc_p_slice"):
        if launches_17c[k] <= 0:
            fail(f"kernel {k} was not launched on {what17c}")
    lossless_check(done, frames, what17c)
    bits_mb = max(8 * len(e.payload) for e in done) / nmb
    print(f"lossless: {N_LOSSLESS} frames {W}x{H} CABAC {ph17['fps']:.3f} "
          f"fps, median encode() {med:.1f} ms, bytes per frame "
          f"{ph17['sizes']}; {N_LOSSLESS_CAVLC} frames CAVLC {fps_c:.3f} fps,"
          f" median encode() {med_c:.1f} ms, bytes per frame "
          f"{[len(e.payload) for e in done]}, the fullest frame "
          f"{bits_mb:.1f} bits per MB against the word buffer's "
          f"{pipeline.CAP_BITS_PER_MB}; every recon equals its source on "
          f"the card [{smi_line}]", flush=True)
    same_as_cpu(x264_tpu_torch, done, frames, header, N_CHECK_LOSSLESS, 250,
                what17c, make=lossless_cavlc_params, frame_parallel=3)
    # ---- 18. MB-row sharding on the one card: 4 bands CABAC, 2 CAVLC
    stamp("phase 18")
    what18 = (f"x264_tpu's defaults with --ref 2 --bframes 2 (b-adapt 0) "
              f"over {N_BANDS} bands of MB rows on [cuda:0] x {N_BANDS}")
    band_cabac_ms, crossed = [], []
    encode_ops, unpack_hw = ecabac.encode_ops, ecabac.unpack_hw

    def timed_ops(*a):
        t = time.perf_counter()
        r = encode_ops(*a)
        band_cabac_ms.append((time.perf_counter() - t) * 1e3)
        return r

    def seen_hw(words, n_hw):
        r = unpack_hw(words, n_hw)
        crossed.append((4 * len(words), 4 * len(r)))
        return r

    ecabac.encode_ops, ecabac.unpack_hw = timed_ops, seen_hw
    try:
        done, summary, launches_18, header, fps, med, enc = main_path(
            250, N_ROWS, what18, make=rows_params, device=[dev] * N_BANDS)
    finally:
        ecabac.encode_ops, ecabac.unpack_hw = encode_ops, unpack_hw
    if not (enc._n_shards == N_BANDS and enc._aq and enc._t8 and enc._rd
            and not enc._i8x8 and enc._bframes == 2
            and enc.params.i_frame_reference == 2):
        fail(f"{what18}: the parameters did not open {N_BANDS} bands, AQ, "
             f"the 8x8 transform, RD, two references and B frames")
    must18 = ("intra_diag", "cabac_i_ops", "cabac_i_ops_t8", "deblock_diag",
              "deblock_diag_t8", "deblock_diag_b", "frame_metrics",
              "me_hier", "hpel_planes", "subpel_refine", "part_fullpel",
              "p_inter_mb", "p_inter_mb_t8_rd", "p_inter_mb_aq",
              "p_inter_mb_ref2", "rd_inter", "rd_inter_t8", "rd_inter_ref2",
              "intra_in_p", "intra_in_p_aq", "cabac_p_ops", "cabac_p_ops_t8",
              "cabac_p_ops_aq", "cabac_p_ops_ref2", "subpel_refine_ref2",
              "part_fullpel_ref2", "aq_qp_map", "dqp_syntax",
              "lowres_planes", "lowres_cost", "b_inter_mb",
              "intra_in_b_decide", "intra_in_b_sweeps", "b_direct",
              "cabac_b_ops", "hw_pack", "halo_extend")
    # no chroma ME, I8x8 or QP map in the I bands (x264_tpu's band
    # programs pass none), b-adapt 0
    idle18 = {"chroma_rerank", "chroma_rerank_ref2", "intra_diag_i8x8",
              "intra_diag_aq", "cabac_i_ops_aq", "lowres_bcost",
              "p_inter_mb_t8_sa8d", *cavlc_only, *cavlc_b_only,
              *trellis_only, *standalone, *nr_only, *lossless_only,
              *slice13_only,
              "p_maps_ref2", "cavlc_p_slice_ref2"}
    for k, n in launches_18.items():
        if (k in must18 and n <= 0) or (k in idle18 and n > 0):
            fail(f"kernel {k} was launched {n} times on {what18}")
    types18 = [e.frame_type for e in done]
    n_refs18 = sum(2 if t == "B" else 1 for t in types18[1:]) \
        + types18[2:].count("P")            # the P frames after the first
    if launches_18["hw_pack"] != 3 * N_BANDS * N_ROWS or \
            launches_18["halo_extend"] != N_BANDS * n_refs18:
        fail(f"{what18}: K27 {launches_18['hw_pack']} launches, K28 "
             f"{launches_18['halo_extend']} for {types18}")
    if len(band_cabac_ms) != N_BANDS * N_ROWS:
        fail(f"{what18}: {len(band_cabac_ms)} band CABAC runs")
    by18 = {t: [len(e.payload) for e in done if e.frame_type == t]
            for t in ("IDR", "P", "B")}
    packed = sum(c[0] for c in crossed) / N_ROWS
    unpacked = sum(c[1] for c in crossed) / N_ROWS
    k28_frame = ms28 * launches_18["halo_extend"] / N_ROWS
    order18 = "".join(t[0] for t in types18)
    print(f"{what18}: {N_ROWS} frames {W}x{H}, {fps:.3f} fps, median "
          f"encode() {med:.1f} ms, encode order {order18}"
          f" (display {[e.display_idx for e in done]}), bytes "
          + ", ".join(f"{t} {statistics.mean(v):.0f} ({len(v)})"
                      for t, v in by18.items() if v)
          + f", PSNR Y {summary['psnr']['y']:.4f} avg "
          f"{summary['psnr']['avg']:.4f} dB, SSIM {summary['ssim_y']:.6f}; "
          f"host CABAC per band median "
          f"{statistics.median(band_cabac_ms):.3f} ms (max "
          f"{max(band_cabac_ms):.3f}); K28 {launches_18['halo_extend']} "
          f"launches, {k28_frame:.3f} ms a frame derived from phase 3's "
          f"{ms28:.3f} ms a launch (the device split below measures it); "
          f"peer copies: none (the bands share "
          f"cuda:0, the strips stay in place; a same-card copy of one "
          f"band's strips takes {strip_ms:.3f} ms); d2h per frame "
          f"{packed:.0f} bytes packed (K27's live prefix) against "
          f"{unpacked:.0f} of 32-bit ops [{smi_line}]", flush=True)
    same_as_cpu_b(x264_tpu_torch, done, frames, header, N_CHECK_ROWS, what18,
                  rows_params, device=["cpu"] * N_BANDS)
    # K28's (and every band kernel's) device time inside this path: frames
    # 1-6 (two P, four B) in the profiler
    device_split(x264_tpu_torch, frames, 1, 6, 6, make=rows_params,
                 tag=what18, device=[dev] * N_BANDS)
    what18c = (f"CAVLC at CQP {QP} over {N_BANDS_CAVLC} bands of MB rows "
               f"on [cuda:0] x {N_BANDS_CAVLC}")
    done, _, launches_18c, header, fps_c, med_c, enc = main_path(
        250, N_ROWS_CAVLC, what18c, make=rows_cavlc_params,
        device=[dev] * N_BANDS_CAVLC)
    if enc._n_shards != N_BANDS_CAVLC or enc._cabac or enc._delay:
        fail(f"{what18c}: not {N_BANDS_CAVLC} synchronous CAVLC bands")
    for k in ("intra_diag", "cavlc_i_slice", "me_hier", "p_inter_mb",
              "intra_in_p", "p_maps", "cavlc_p_slice", "deblock_diag",
              "frame_metrics", "halo_extend"):
        if launches_18c[k] <= 0:
            fail(f"kernel {k} was not launched on {what18c}")
    for k in ("hw_pack", *cabac_only, "aq_qp_map", "chroma_rerank"):
        if launches_18c[k] > 0:
            fail(f"kernel {k} was launched on {what18c}")
    if [e.frame_type for e in done] != ["IDR"] + ["P"] * (N_ROWS_CAVLC - 1):
        fail(f"{what18c}: frame types {[e.frame_type for e in done]}")
    print(f"{what18c}: {N_ROWS_CAVLC} frames {W}x{H}, {fps_c:.3f} fps, "
          f"median encode() {med_c:.1f} ms, bytes IDR "
          f"{len(done[0].payload)}, P "
          f"{statistics.mean(len(e.payload) for e in done[1:]):.0f}, K28 "
          f"{launches_18c['halo_extend']} launches [{smi_line}]", flush=True)
    same_as_cpu(x264_tpu_torch, done, frames, header, N_CHECK_ROWS, 250,
                what18c, make=rows_cavlc_params, frame_parallel=3,
                device=["cpu"] * N_BANDS_CAVLC)
    # ---- 19. intra without I4x4, the overflow path, the GOP batch and
    # the profilers
    stamp("phase 19")

    # (a) x264's ultrafast as x264_tpu takes it
    what19a = ("x264's ultrafast (CAVLC, no deblocking, --partitions none, "
               "subme 1, no 8x8dct, CRF 23 without AQ)")
    done, summary, launches_19a, header, fps, med, enc = main_path(
        250, N_ULTRAFAST, what19a, src=cut, make=ultrafast_params)
    if enc._i4x4 or enc._i8x8 or enc._parts or enc._cabac or enc._aq \
            or enc._subpel or enc._t8 or enc.rc.method != 1:
        fail(f"{what19a}: not the ultrafast settings")
    must19a = ("intra_diag", "intra_diag_i16", "cavlc_i_slice", "me_hier",
               "p_inter_mb", "intra_in_p", "p_maps", "cavlc_p_slice",
               "frame_metrics", "lowres_planes", "lowres_cost")
    idle19a = {"deblock_diag", "hpel_planes", "subpel_refine",
               "part_fullpel", "chroma_rerank", "rd_inter", "aq_qp_map",
               "intra_diag_i8x8", "intra_diag_batch", "fullpel_search",
               "hadamard_ac", *cabac_only}
    for k, n in launches_19a.items():
        if (k in must19a and n <= 0) or (k in idle19a and n > 0):
            fail(f"kernel {k} was launched {n} times on {what19a}")
    print(f"{what19a}: {N_ULTRAFAST} frames {W}x{H}, {fps:.3f} fps, median "
          f"encode() {med:.1f} ms, bytes IDR {len(done[0].payload)}, P "
          f"{statistics.mean(len(e.payload) for e in done[1:]):.0f}, PSNR Y "
          f"{summary['psnr']['y']:.4f} avg {summary['psnr']['avg']:.4f} dB, "
          f"SSIM {summary['ssim_y']:.6f}; K1 without I4x4 "
          f"{launches_19a['intra_diag_i16']} launches [{smi_line}]",
          flush=True)
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_ULTRAFAST, 250,
                what19a, make=ultrafast_params, frame_parallel=3)

    # (b) --partitions i8x8 on x264_tpu's defaults
    what19b = "x264_tpu's defaults with --partitions i8x8 (CRF 23, AQ)"
    i8_seen = []
    encode_idr = pipeline.encode_i16_idr_cabac

    def idr_seen(*a, **k):
        out = encode_idr(*a, **k)
        i8_seen.append(int(out["t8_mb"].sum()))
        return out

    pipeline.encode_i16_idr_cabac = idr_seen
    try:
        done, summary, launches_19b, header, fps_b, med_b, enc = main_path(
            250, N_PART_I8X8, what19b, src=cut, make=part_i8x8_params)
    finally:
        pipeline.encode_i16_idr_cabac = encode_idr
    if enc._i4x4 or not (enc._i8x8 and enc._aq and enc._t8) or enc._parts:
        fail(f"{what19b}: not I8x8 without I4x4 and partitions under AQ")
    for k in ("intra_diag_i16", "intra_diag_i8x8", "intra_diag_aq",
              "cabac_i_ops_t8", "p_inter_mb_t8_rd", "cabac_p_ops"):
        if launches_19b[k] <= 0:
            fail(f"kernel {k} was not launched on {what19b}")
    for k in ("part_fullpel", "intra_diag_batch", "fullpel_search",
              "hadamard_ac"):
        if launches_19b[k] > 0:
            fail(f"kernel {k} was launched on {what19b}")
    if not i8_seen or i8_seen[0] <= 0:
        fail(f"{what19b}: I8x8 MBs per IDR {i8_seen}")
    print(f"{what19b}: {N_PART_I8X8} frames {W}x{H}, {fps_b:.3f} fps, "
          f"median encode() {med_b:.1f} ms, IDR {len(done[0].payload)} "
          f"bytes with {i8_seen[0]} I8x8 MBs, P "
          f"{statistics.mean(len(e.payload) for e in done[1:]):.0f} bytes, "
          f"PSNR Y {summary['psnr']['y']:.4f} dB [{smi_line}]", flush=True)
    same_as_cpu(x264_tpu_torch, done, cut, header, N_CHECK_EARLY, 250,
                what19b, make=part_i8x8_params, frame_parallel=3)

    # (c) the synchronous CAVLC overflow path: a lossless IDR of binary
    # noise passes the word buffer with and without I4x4
    what19c = ("a lossless CAVLC IDR of binary noise at i_frame_parallel 1 "
               "(the overflow path)")
    rng19 = np.random.default_rng(19)
    noise = x264_tpu_torch.Frame(*[(rng19.integers(0, 2, sh) * 255).astype(
        np.uint8) for sh in ((H, W), (H // 2, W // 2), (H // 2, W // 2))])
    enc = x264_tpu_torch.Encoder(
        overflow_params(x264_tpu_torch.EncoderParams), device=dev)
    header = enc.headers()
    host_ms = []
    write_i = enc._write_i_slice

    def timed_write(*a):
        t = time.perf_counter()
        r = write_i(*a)
        host_ms.append((time.perf_counter() - t) * 1e3)
        return r

    enc._write_i_slice = timed_write
    reset_counts()
    torch.cuda.synchronize()
    t19 = time.perf_counter()
    ef = enc.encode(noise)
    wall19 = (time.perf_counter() - t19) * 1e3
    launches_19c = read_counts()
    branch = enc.last_idr_branch
    if ef is None or branch != "host" or len(host_ms) != 1:
        fail(f"{what19c}: branch {branch}, {len(host_ms)} host slices")
    if launches_19c["intra_diag_i16"] != 2 * (mb_h + mb_w - 1) or \
            launches_19c["cavlc_i_slice"] != 2 * 4:
        fail(f"{what19c}: K1 without I4x4 {launches_19c['intra_diag_i16']} "
             f"launches, K18 {launches_19c['cavlc_i_slice']}")
    lossless_check([ef], [noise], what19c)
    enc.close()
    print(f"{what19c}: branch {branch}, {8 * len(ef.payload) / nmb:.1f} bits "
          f"an MB against the buffer's {pipeline.CAP_BITS_PER_MB}, host coder "
          f"(cavlc_vec and the NAL) {host_ms[0]:.3f} ms, encode() "
          f"{wall19:.1f} ms, the recon the source, payload "
          f"{len(ef.payload)} bytes (its equality to the CPU run's, and the "
          f"CPU run's branch, are checked with the CPU runs) [{smi_line}]",
          flush=True)
    same_as_cpu(x264_tpu_torch, [ef], [noise], header, 1, 1, what19c,
                make=overflow_params, frame_parallel=1, branch=branch)

    # (d) the GOP batch over [cuda:0] x 2, and hadamard_ac on its MBs
    from x264_tpu_torch.parallel import mesh as pmesh
    what19d = f"encode_gop_intra of {N_GOP} frames over [cuda:0] x 2"
    reset_counts()
    out_g = pmesh.encode_gop_intra([dev] * 2, mb_h, mb_w, ysb, usb, vsb,
                                   qt26, lam26)
    tiles_g = ysb.reshape(N_GOP, mb_h, 16, mb_w, 16).transpose(2, 3) \
        .contiguous()
    ac_g = opixel.hadamard_ac(tiles_g)
    torch.cuda.synchronize()
    launches_19d = read_counts()
    if launches_19d["intra_diag_batch"] != 2 * (mb_h + mb_w - 1) or \
            launches_19d["hadamard_ac"] != 1:
        fail(f"{what19d}: {launches_19d['intra_diag_batch']} batch launches, "
             f"{launches_19d['hadamard_ac']} of K30")
    for i in range(N_GOP):
        one = intra.encode_i16_frame(mb_h, mb_w, ysb[i], usb[i], vsb[i],
                                     qt26, lam26, i4x4=False)
        for k, t in one.items():
            if not torch.equal(out_g[k][i], t):
                fail(f"{what19d}: frame {i} {k} differs from K1 alone")
    stamp(f"{what19d}: frame 0 on the CPU")
    cpu0 = intra.encode_i16_frame_plain(
        mb_h, mb_w, ysb[0].cpu(), usb[0].cpu(), vsb[0].cpu(),
        {k: t.cpu() for k, t in qt26.items()}, lam26, i4x4=False)
    for k, t in cpu0.items():
        if not torch.equal(out_g[k][0].cpu(), t):
            fail(f"{what19d}: frame 0 {k} differs from the CPU's plain K1")
    if not all(torch.equal(a[0].cpu(), b) for a, b in zip(
            ac_g, opixel.hadamard_ac_plain(tiles_g[0].cpu()))):
        fail(f"{what19d}: K30 on frame 0's MBs differs from the CPU's")
    ms_gop = event_ms(lambda: pmesh.encode_gop_intra(
        [dev] * 2, mb_h, mb_w, ysb, usb, vsb, qt26, lam26), 3)
    ms_one = event_ms(lambda: [intra.encode_i16_frame(
        mb_h, mb_w, ysb[i], usb[i], vsb[i], qt26, lam26, i4x4=False)
        for i in range(N_GOP)], 3)
    print(f"{what19d}: every output equal to K1 alone frame by frame, frame "
          f"0 to the CPU's plain K1; {N_GOP / ms_gop * 1e3:.1f} frames/s "
          f"batched ({ms_gop:.3f} ms) against "
          f"{N_GOP / ms_one * 1e3:.1f} one frame a call ({ms_one:.3f} ms); "
          f"K30 on the batch's MBs equal to the CPU's [{smi_line}]",
          flush=True)

    # (e) the profilers at 1080p
    from x264_tpu_torch.tools import profile_encode, profile_stages
    stamp("phase 19e: profile_stages")
    reset_counts()
    stages19 = profile_stages.main([f"{W}x{H}"])
    launches_19e = read_counts()
    if launches_19e["fullpel_search"] <= 0:
        fail("profile_stages did not launch K29")
    stamp("phase 19e: profile_encode")
    rows19 = profile_encode.main([f"{W}x{H}"])
    if len(rows19) != 4 or not all(np.isfinite(list(r.values())).all()
                                   for r in rows19):
        fail("profile_encode gave no finite breakdown")
    print(f"profilers at {W}x{H}: {len(stages19)} stages, "
          f"{len(rows19)} frames [{smi_line}]", flush=True)

    for name, r in rec.items():
        main = launches_11 if name in cavlc_only else launches_16 \
            if name in nr_only else launches_17 \
            if name in lossless_only else launches_12 \
            if name in trellis_only + standalone else launches_13 \
            if name in b_only else launches_15 \
            if name in cavlc_b_only + ("p_maps_ref2", "cavlc_p_slice_ref2") \
            else launches_14 if name in ref2_only else launches_18 \
            if name in rows_only else launches_19a \
            if name == "intra_diag_i16" else launches_19e \
            if name == "fullpel_search" else launches_19d \
            if name in slice13_only else launches_9
        r.update(launches=main[name],
                 launches_ultrafast=launches_19a[name],
                 launches_partitions_i8x8=launches_19b[name],
                 launches_overflow=launches_19c[name],
                 launches_gop_batch=launches_19d[name],
                 launches_profilers=launches_19e[name],
                 launches_rows=launches_18[name],
                 launches_rows_cavlc=launches_18c[name],
                 launches_lossless_cavlc=launches_17c[name],
                 launches_lossless=launches_17[name],
                 launches_nr_cqm=launches_16[name],
                 launches_preset_cavlc=launches_15[name],
                 launches_preset=launches_14[name],
                 launches_b_defaults=launches_13[name],
                 launches_trellis_defaults=launches_12[name],
                 launches_cavlc_defaults=launches_11[name],
                 launches_cavlc_all_intra=launches_10[name],
                 launches_defaults=launches_9[name],
                 launches_bench_cqp=launches_8[name],
                 launches_ippp_subme6=launches_6[name],
                 launches_ippp_subme5=launches_5[name],
                 launches_ippp_subme1=launches_1[name],
                 launches_all_intra=launches_i[name])
    if set(rec) != set(launches_11):
        fail(f"the kernels line lacks {sorted(set(launches_11) - set(rec))}")
    run_cpu_checks()
    stamp("done")

    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

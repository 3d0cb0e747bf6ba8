// K6 p_inter_mb: the inter residual path of every MB of a P frame.
//
// Replaces x264_tpu/ops/mc.py:74 mc_luma and :114 mc_chroma as
// encode_p_body's stage 2 calls them (the partitioned fetch,
// inter.py:420-494), x264_tpu/encoder/inter.py:81 inter_luma_residual
// (with DCT decimation) and the chroma half of stage 2 (the "pc" chroma
// residual with the joint two-channel AC decimation, inter.py:551-567).
// Plain twin:
// x264_tpu_torch/encoder/inter.py:p_inter_mb_plain; wrapper: p_inter_mb.
//
// Design. Inter prediction reads only the reference, so there is no
// wavefront: one launch, one CTA per MB (128 threads; 256 with the
// trellis, a template instantiation of its own). Four threads set up the
// fetch of the MB's four quadrants once (each quadrant's partition:
// ptype 0 16x16, 1 16x8, 2 8x16, 3 8x8, with the MV of the partition's
// top-left 8x8 quadrant): the offsets of its sample (0, 0) in the two
// half-pel planes its quarter-pel phase names (kHpelRef0/1), each block
// start taken as jax.lax.dynamic_slice takes it (ds_start: a negative
// start wraps once, then clamps, and the plane index clamps into the
// stack, so a one-plane stack serves full-pel MVs), and its chroma
// block's start and bilinear weights. Every thread then fetches luma
// samples (the rounding average of the two planes) and chroma samples
// (the 1/8-pel bilinear filter, (ca*s00 + cb*s01 + cc*s10 + cd*s11 +
// 32) >> 6) into shared memory. The residual runs a lane a row of a
// block, by role: warps 0-1 the 16 luma 4x4 blocks (DCT, P-matrix
// quant, decimate score), warp 3 the eight chroma blocks, and with the
// 8x8 transform (t8 = 1 or 2) warp 2 the four 8x8 blocks on the same
// prediction (DCT8, CQM_8PY quant, DECIMATE_TAB8 score; t8.cuh); each
// transform's two passes are the serial butterflies with a transpose
// through the warp's shared scratch. The decimation scores come from
// each block's nonzero mask in scan order by shuffles; the 8x8-group /
// whole-MB luma kill (score < 4 / total < 6), the 8x8 blocks' kill (a
// block < 4, or all four when the total is < 6) and the joint chroma AC
// kill (score < 7) from warp reductions; then dequant, IDCT and
// reconstruction on the same lanes. At t8 = 1 (below subme 6) the MB's
// transform is chosen here: warps 0-1 and 2 take the 4x4 and 8x8
// Hadamard abs-sums of the prediction error, and the 8x8 coding is
// taken where sa8d_16x16 < satd, strictly; its recon, its cbp and zero
// 4x4 levels are written. At t8 = 2 (the RD ladder) both codings are
// written for K13. The recon, the levels in scan order and the chroma
// AC are staged in shared memory and stored by the whole CTA as 16-byte
// vectors.
// With a trellis table (analyse.i_trellis under CABAC; x264_tpu
// inter.py:123-133, :182-192 and intra.py:185-221, each calling
// ops/trellis.py:236 trellis_scan) the transform threads leave their
// coefficients in scan order in shared memory instead of quantising
// them, and a trellis phase of its own, between two barriers, runs every
// block of the MB at once on trellis.cuh's lane-parallel Viterbi (8
// lanes a block, one category a warp: warps 0-3 the 16 cat-2 luma 4x4
// blocks in zig-zag, warp 4 the four cat-5 8x8 blocks, which then skip
// decimation, warps 5-6 the eight cat-4 chroma AC blocks on zig-zag
// positions 1..15, warp 7 the two cat-3 chroma DC Hadamards); the table,
// the frame's four categories or with a QP map the MB's row of the
// 52-QP stack, is staged in shared memory once. Everything after the
// quant stays as it is.
// The noise reduction (--nr; x264_tpu inter.py:119-121 and :178-180,
// ops/quant.py:120 denoise): given the offsets, the 4x4 threads, and the
// 8x8 ones with the 8x8 transform, write each block's pre-shrink |coef|
// for K26 (csrc/nr.cu, the float32 sums in XLA's order) and shrink every
// AC coefficient by its position's offset before the quant or the
// trellis. Lossless (CQP 0; x264_tpu inter.py:106-117, intra.py:172-181):
// the luma and chroma threads take the residual samples as the levels
// (sample 0 of each chroma 4x4 as its DC, untransformed), nothing is
// decimated, and the recon is the source.
// Two references (--ref 2; x264_tpu inter.py:425-437, mc.py:91-93 and
// :134-145): given a per-MB reference index, the CTA's fetch reads its
// MB's reference, the base of the half-pel stack moved by 4 planes and
// that of the padded chroma by one plane per reference; every partition
// carries the MB's reference, so nothing else in the kernel changes.
//
// K22 b_inter_mb, the inter residual of a B frame's MBs, is the same
// kernel instantiated for a B pass (BP 1, 2). It replaces
// x264_tpu/ops/mc.py:155 avg and mc_luma / mc_chroma as
// x264_tpu/encoder/inter.py:866 encode_b_body calls them, the BI SATD and
// the B mode decision (inter.py:923-951), and the residual of its passes
// 1 (inter.py:958-963) and 2 (:1103-1135). Plain twin:
// x264_tpu_torch/encoder/inter.py:b_inter_mb_plain; wrapper: b_inter_mb.
// The CTA fetches both lists' 16x16 luma (through each list's half-pel
// stack) and 8x8 chroma predictions. Pass 1: warps 0-1 take the 4x4
// Hadamards of the source minus the rounding average on lanes, thread 0
// forms the BI SATD and picks argmin(satd + lam * (mv bits + 3 | 3 |
// 5)) over L0, L1, BI (first on ties), every thread then keeps the
// chosen prediction (the average for BI); pass 2 keeps the average where
// both of the MB's final references are used, else the one list's. The residual follows
// as K6's, decimated, with the trellis phase where given (warp 4 idle:
// no 8x8 transform), and with the joint chroma AC decimation in pass 2
// only (pass 1 has none). Bounded as K6 by bytes, by the count: pass 1
// reads two half-pel stacks.
// What bounds it on the H100: bytes, by the count (the source, the
// half-pel planes, the padded chroma, and the recon and coefficient
// planes out, as int32), with few operations an MB. In practice an MB's
// chain of dependent phases (fetch, transform, decimation, recon; with
// the trellis its 64-position cat-5 Viterbi and backtrack) and the CTAs
// an SM holds set the time: the lanes shorten the chain (no thread
// carries a whole block), and the kernel without the trellis is held to
// 32 registers so that an SM holds 16 CTAs.
#include "t8.cuh"
#include "trellis.cuh"

using namespace x264t;

namespace {

constexpr int PAD = 32, CPAD = 16;

__constant__ int kZig4P[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// raster 4x4 block index -> z-scan index (LUMA4x4 raster <-> z)
__constant__ int kZOfRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// the packed table of inter.py:pack_qtab_p
struct QTabP {
  int py_mf[16], py_bias[16], py_dmf[16], pc_mf[16], pc_bias[16], pc_dmf[16];
  int py_qpdiv6, pc_dmf0, pc_mf_dc, pc_bias_dc, pc_qpdiv6;
  int p8_mf[64], p8_bias[64], p8_dmf[64];
};
constexpr int QTABP_INTS = sizeof(QTabP) / sizeof(int);

// partition of MB sample (r, c) under ptype: its rectangle in the MB
struct Part {
  int top, left, bh, bw;
};

__device__ __forceinline__ Part part_of(int ptype, int r, int c) {
  switch (ptype) {
    case 1: return Part{r & 8, 0, 8, 16};
    case 2: return Part{0, c & 8, 16, 8};
    case 3: return Part{r & 8, c & 8, 8, 8};
    default: return Part{0, 0, 16, 16};
  }
}

// the B passes' inputs (K22); unused by K6 (BP 0)
struct BArgs {
  const int *planes1, *refu1, *refv1;    // the L1 list's fetch
  const int *mv0, *mv1;                  // per-MB MVs of each list
  const int *satd0, *satd1, *seed0, *seed1;  // pass 1: ME costs, seeds
  const int *r0, *r1;                    // pass 2: per-MB final refs
  int *bmode, *cost;                     // pass 1's outputs
  int lam;
};

// inverse scans: raster position -> scan index (kZig4P, t8.cuh's kZig8)
__constant__ int kInvZig4[16] = {0, 1, 5, 6, 2, 4, 7, 12, 3, 8, 11, 13, 9, 10, 14, 15};
__constant__ int kInvZig8[64] = {
    0,  1,  5,  6, 14, 15, 27, 28,  2,  4,  7, 13, 16, 26, 29, 42,
    3,  8, 12, 17, 25, 30, 41, 43,  9, 11, 18, 24, 31, 40, 44, 53,
   10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
   21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// The lanes' transforms. A 4x4 block is 4 lanes (lane j: column j, then
// row j), an 8x8 block 8 lanes (lane r: column r, then row r); the
// transpose between the passes goes through a warp's scratch in shared
// memory, skewed so that a row and a column of every block of the warp
// each fall on distinct banks: element (i, j) of 4x4 block b (b < 8) at
// 32 i + 4 b + ((i + j) & 3), of 8x8 block k (k < 4) at 32 i + 8 k +
// ((i + j) & 7). Each pass is the serial function's own butterfly
// (common.cuh dct4x4 / idct4x4 / had4x4, t8.cuh dct8_1d / idct8_1d /
// had8_1d; ops/dct.py, ops/pixel.py), so every value is the serial
// one. Every lane of the warp
// calls them (__syncwarp).
__device__ __forceinline__ int sk4(int i, int j, int b) {
  return 32 * i + 4 * b + ((i + j) & 3);
}
__device__ __forceinline__ int sk8(int i, int j, int k) {
  return 32 * i + 8 * k + ((i + j) & 7);
}

// forward 4x4 DCT (dct4x4): x column j of the residual -> y row j
__device__ __forceinline__ void dct4_lanes(const int (&x)[4], int (&y)[4],
                                           int* sk, int b, int j) {
  sk[sk4(0, j, b)] = x[0] + x[1] + x[2] + x[3];
  sk[sk4(1, j, b)] = 2 * x[0] + x[1] - x[2] - 2 * x[3];
  sk[sk4(2, j, b)] = x[0] - x[1] - x[2] + x[3];
  sk[sk4(3, j, b)] = x[0] - 2 * x[1] + 2 * x[2] - x[3];
  __syncwarp();
  const int a0 = sk[sk4(j, 0, b)], a1 = sk[sk4(j, 1, b)];
  const int a2 = sk[sk4(j, 2, b)], a3 = sk[sk4(j, 3, b)];
  __syncwarp();
  y[0] = a0 + a1 + a2 + a3;
  y[1] = 2 * a0 + a1 - a2 - 2 * a3;
  y[2] = a0 - a1 - a2 + a3;
  y[3] = a0 - 2 * a1 + 2 * a2 - a3;
}

// inverse 4x4 (idct4x4, rows first): x row j of the coefficients -> y
// column j of the residual, (+ 32) >> 6 taken
__device__ __forceinline__ void idct4_lanes(const int (&x)[4], int (&y)[4],
                                            int* sk, int b, int j) {
  {
    const int e0 = x[0] + x[2], e1 = x[0] - x[2];
    const int e2 = (x[1] >> 1) - x[3], e3 = x[1] + (x[3] >> 1);
    sk[sk4(j, 0, b)] = e0 + e3;
    sk[sk4(j, 1, b)] = e1 + e2;
    sk[sk4(j, 2, b)] = e1 - e2;
    sk[sk4(j, 3, b)] = e0 - e3;
  }
  __syncwarp();
  const int a0 = sk[sk4(0, j, b)], a1 = sk[sk4(1, j, b)];
  const int a2 = sk[sk4(2, j, b)], a3 = sk[sk4(3, j, b)];
  __syncwarp();
  const int e0 = a0 + a2, e1 = a0 - a2, e2 = (a1 >> 1) - a3, e3 = a1 + (a3 >> 1);
  y[0] = (e0 + e3 + 32) >> 6;
  y[1] = (e1 + e2 + 32) >> 6;
  y[2] = (e1 - e2 + 32) >> 6;
  y[3] = (e0 - e3 + 32) >> 6;
}

// sum |H d H| of the 4x4 block (common.cuh abs_had4x4) from column j of
// d, in each of its 4 lanes
__device__ __forceinline__ int had4_lanes(const int (&x)[4], int* sk, int b,
                                          int j) {
  sk[sk4(0, j, b)] = x[0] + x[1] + x[2] + x[3];
  sk[sk4(1, j, b)] = x[0] + x[1] - x[2] - x[3];
  sk[sk4(2, j, b)] = x[0] - x[1] - x[2] + x[3];
  sk[sk4(3, j, b)] = x[0] - x[1] + x[2] - x[3];
  __syncwarp();
  const int a0 = sk[sk4(j, 0, b)], a1 = sk[sk4(j, 1, b)];
  const int a2 = sk[sk4(j, 2, b)], a3 = sk[sk4(j, 3, b)];
  __syncwarp();
  int s = abs(a0 + a1 + a2 + a3) + abs(a0 + a1 - a2 - a3)
          + abs(a0 - a1 - a2 + a3) + abs(a0 - a1 + a2 - a3);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// forward 8x8 DCT (dct.py:dct8x8, columns first): x column r -> y row r
__device__ __forceinline__ void dct8_lanes(const int (&x)[8], int (&y)[8],
                                           int* sk, int k, int r) {
  int t[8];
  dct8_1d(x, 1, t, 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) sk[sk8(i, r, k)] = t[i];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 8; ++m) t[m] = sk[sk8(r, m, k)];
  __syncwarp();
  dct8_1d(t, 1, y, 1);
}

// inverse 8x8 (dct.py:idct8x8, rows first, + 32 at [0][0], >> 6): x row r of
// the coefficients -> y column r of the residual
__device__ __forceinline__ void idct8_lanes(const int (&x)[8], int (&y)[8],
                                            int* sk, int k, int r) {
  int in[8], t[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) in[m] = x[m];
  if (r == 0) in[0] += 32;
  idct8_1d(in, 1, t, 1);
#pragma unroll
  for (int m = 0; m < 8; ++m) sk[sk8(r, m, k)] = t[m];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = sk[sk8(i, r, k)];
  __syncwarp();
  idct8_1d(t, 1, in, 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = in[i] >> 6;
}

// sum |H8 d H8| of the 8x8 block (pixel.py:sa8d_8x8 before its (+2) >>
// 2) from column r of d, in each of its 8 lanes
__device__ __forceinline__ int had8_lanes(const int (&x)[8], int* sk, int k,
                                          int r) {
  int a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = x[i];
  had8_1d(a);
#pragma unroll
  for (int i = 0; i < 8; ++i) sk[sk8(i, r, k)] = a[i];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 8; ++m) a[m] = sk[sk8(r, m, k)];
  __syncwarp();
  had8_1d(a);
  int s = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) s += abs(a[m]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  return s;
}

// decimate_score of a 4x4 block whose 4 lanes each hold a row of 4
// raster levels (l, row j), in each of them: 9 if any |level| > 1, else
// the sum over the nonzero levels of kDecimateTab4[the zeros before it
// in scan order], from the block's nonzero mask in scan order (OR over
// the lanes). ac: the 15 AC levels of a chroma block (scan 1..15; the
// raster DC is left out, and a run starts at scan position 1).
__device__ __forceinline__ int decimate_lanes4(const int* l, int j,
                                               bool ac) {
  unsigned m = 0;
  int big = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (l[c] != 0 && (!ac || 4 * j + c > 0)) {
      m |= 1u << kInvZig4[4 * j + c];
      big |= abs(l[c]) > 1;
    }
  m |= __shfl_xor_sync(0xffffffffu, m, 1);
  m |= __shfl_xor_sync(0xffffffffu, m, 2);
  big |= __shfl_xor_sync(0xffffffffu, big, 1);
  big |= __shfl_xor_sync(0xffffffffu, big, 2);
  int s = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (l[c] != 0 && (!ac || 4 * j + c > 0)) {
      const int z = kInvZig4[4 * j + c];
      const unsigned below = m & ((1u << z) - 1u);
      const int prev = below ? 31 - __clz(below) : (ac ? 0 : -1);
      s += kDecimateTab4[z - prev - 1];
    }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return big ? 9 : s;
}

// decimate_score of an 8x8 block (DECIMATE_TAB8) from its 8 lanes' rows
// (lane r: row r)
__device__ __forceinline__ int decimate_lanes8(const int* l, int r) {
  unsigned long long m = 0;
  int big = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (l[c] != 0) {
      m |= 1ull << kInvZig8[8 * r + c];
      big |= abs(l[c]) > 1;
    }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    m |= __shfl_xor_sync(0xffffffffu, m, o);
    big |= __shfl_xor_sync(0xffffffffu, big, o);
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (l[c] != 0) {
      const int z = kInvZig8[8 * r + c];
      const unsigned long long below = m & ((1ull << z) - 1ull);
      const int prev = below ? 63 - __clzll((long long)below) : -1;
      s += kDecimateTab8[z - prev - 1];
    }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return big ? 9 : s;
}

// a partition's fetch, set up once a CTA: the offsets of its luma
// sample (0, 0) in the two half-pel planes averaged (from the plane
// stack's base; sample (r, c) of the MB at + r * Wp + c), and of its
// chroma sample (0, 0) with the four bilinear weights
struct FetchAt {
  long long a, b;
  int c, w0, w1, w2, w3;
};

__device__ __forceinline__ void chroma_weights(FetchAt& f, int mvx, int mvy) {
  const int dx = mvx & 7, dy = mvy & 7;
  f.w0 = (8 - dx) * (8 - dy);
  f.w1 = dx * (8 - dy);
  f.w2 = (8 - dx) * dy;
  f.w3 = dx * dy;
}

__device__ __forceinline__ int chroma_at(const FetchAt& f, const int* R,
                                         int Wcp, int r, int c) {
  const int* s = R + f.c + r * Wcp + c;
  return (f.w0 * s[0] + f.w1 * s[1] + f.w2 * s[Wcp] + f.w3 * s[Wcp + 1] + 32) >> 6;
}

__device__ __forceinline__ int luma_at(const FetchAt& f, const int* P,
                                       int Wp, int r, int c) {
  const long long o = (long long)r * Wp + c;
  return (P[f.a + o] + P[f.b + o] + 1) >> 1;
}

// the trellis phase's scratch a block, in words: its 8 * C history bytes
// or its 2 * C float distortions, tr_pad(2 * C) apart (40 words for cat 2,
// 4 and 3, 136 for cat 5), 4 blocks a warp; the offset of warp w's share
// (0-3 cat 2, 4 cat 5, 5-6 cat 4, 7 cat 3)
constexpr int TR_WORDS = 7 * 4 * 40 + 4 * 136;
__device__ __forceinline__ int tr_scratch_at(int w) {
  return 160 * w + (w > 4 ? 544 - 160 : 0);
}

// The trellis phase (TR): every block of the MB at once, 8 lanes a block
// (trellis.cuh's trellis_lanes), one category a warp: warps 0-3 the 16
// luma 4x4 blocks (cat 2), warp 4 the four 8x8 blocks (cat 5, with the
// 8x8 transform), warps 5-6 the eight chroma AC blocks (cat 4) and warp 7
// the two chroma DC blocks (cat 3; its other 16 lanes run channel 0 and 1
// again, on copies, and write nothing). tab: the MB's table (TR_ layout)
// in shared memory; the coefficients in scan order in c2 / c5 / c4, and
// the chroma DC of each channel's four blocks in cdc, whose Hadamard
// warp 7 puts in c3; hist and ssd: the trellis's shared scratch; the
// levels go to lv / lv8 (raster) and clv (raster, position 0 kept) / l3
// (the DC, raster).
__device__ __forceinline__ void trellis_phase(
    const int* tab, int (*c2)[24], int (*c5)[72], int (*c4)[24],
    int (*cdc)[4], int (*c3)[4], unsigned char* hist, float* ssd,
    int (*lv)[16], int (*lv8)[64], int (*clv)[4][16], int (*l3)[4], int t8) {
  const int w = threadIdx.x >> 5, g = (threadIdx.x >> 3) & 3;
  // each block's history bytes and distortions (tr_scratch_at)
  const int at = tr_scratch_at(w) + g * (w == 4 ? 136 : 40);
  unsigned char* h = hist + 4 * at;
  float* sd = ssd + at;
  if (w < 4) {
    const int blk = 4 * w + g;
    trellis_lanes<16>(c2[blk], trellis_tab(tab + TR_CAT2, 16), sd, h,
                      [&](int i, int v) { lv[blk][kZig4P[i]] = v; });
  } else if (w == 4) {
    if (t8)
      trellis_lanes<64>(c5[g], trellis_tab(tab + TR_CAT5, 64), sd, h,
                        [&](int i, int v) { lv8[g][kZig8[i]] = v; });
  } else if (w < 7) {
    const int k = 4 * (w - 5) + g, ch = k >> 2, blk = k & 3;
    trellis_lanes<15>(c4[k], trellis_tab(tab + TR_CAT4, 15), sd, h,
                      [&](int i, int v) { clv[ch][blk][kZig4P[i + 1]] = v; });
  } else {
    const int lane = threadIdx.x & 31;
    if (lane < 4) {                    // the 2x2 Hadamard of channel lane & 1
      const int* d = cdc[lane & 1];
      c3[lane][0] = d[0] + d[1] + d[2] + d[3];
      c3[lane][1] = d[0] - d[1] + d[2] - d[3];
      c3[lane][2] = d[0] + d[1] - d[2] - d[3];
      c3[lane][3] = d[0] - d[1] - d[2] + d[3];
    }
    __syncwarp();
    trellis_lanes<4>(c3[g], trellis_tab(tab + TR_CAT3, 4), sd, h,
                     [&](int i, int v) {
                       if (g < 2) l3[g][i] = v;
                     });
  }
}

// the parameters of the body and of its two entry points
#define INTER_MB_PARAMS \
    const int* __restrict__ Y, const int* __restrict__ U, \
    const int* __restrict__ V, const int* __restrict__ planes, \
    const int* __restrict__ refu, const int* __restrict__ refv, \
    const int* __restrict__ ptype_g, const int* __restrict__ mv_quad, \
    const int* __restrict__ qtab_g, int* __restrict__ RY, \
    int* __restrict__ RU, int* __restrict__ RV, int* __restrict__ blocks_z, \
    int* __restrict__ cbp_o, int* __restrict__ chroma_dc_o, \
    int* __restrict__ chroma_ac_o, int* __restrict__ blocks8_o, \
    uint8_t* __restrict__ t8_sel_o, int* __restrict__ R8Y, \
    int* __restrict__ cbp8_o, const int* __restrict__ qp_map, \
    const int* __restrict__ trellis_g, const int* __restrict__ ref_sel, \
    int mb_h, int mb_w, int n_planes, int decimate, int t8, const BArgs B, \
    const int* __restrict__ nr_off4, const int* __restrict__ nr_off8, \
    int* __restrict__ nr_abs4, int* __restrict__ nr_abs8, int lossless
#define INTER_MB_ARGS                                                       \
  Y, U, V, planes, refu, refv, ptype_g, mv_quad, qtab_g, RY, RU, RV,         \
      blocks_z, cbp_o, chroma_dc_o, chroma_ac_o, blocks8_o, t8_sel_o, R8Y,   \
      cbp8_o, qp_map, trellis_g, ref_sel, mb_h, mb_w, n_planes, decimate,    \
      t8, B, nr_off4, nr_off8, nr_abs4, nr_abs8, lossless

// the MB's samples in shared memory, each array 16-byte aligned
struct alignas(16) Stage {
  int fenc[256], pred[256], rec[256], rec8[256];
  int fc[2][64], pc[2][64], recc[2][64];
};

// one MB of K6 / K22 on a CTA of 128 threads, or 256 with the trellis
// phase (TR). Warps 0-3 take the residual by role, a lane a row of a
// block: warps 0-1 the 16 luma 4x4 blocks (lane 4 b + j, b the raster
// block within the warp), warp 2 the four 8x8 blocks (lane 8 k + r), warp
// 3 the eight chroma blocks (lane 4 (4 ch + blk) + j); with TR, warps 4-7
// join the fetch, the trellis phase and the stores.
template <int BP, bool TR>
__device__ __forceinline__ void inter_mb_body(INTER_MB_PARAMS) {
  constexpr int NT = TR ? 256 : 128;
  constexpr unsigned ALL = 0xffffffffu;
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = mb_w * 16, H = mb_h * 16, Wc = mb_w * 8, Hc = mb_h * 8;
  const int Wp = W + 2 * PAD, Hp = H + 2 * PAD;
  const int Wcp = Wc + 2 * CPAD, Hcp = Hc + 2 * CPAD;
  const size_t plane = (size_t)Hp * Wp;

  __shared__ QTabP q;
  // the MB's source and prediction, and its recon staged for the stores
  // (rec: the 4x4 coding's luma, rec8: the 8x8 coding's)
  __shared__ Stage st;
  int(&fenc)[256] = st.fenc;
  int(&pred)[256] = st.pred;
  int(&rec)[256] = st.rec;
  int(&rec8)[256] = st.rec8;
  int(&fc)[2][64] = st.fc;
  int(&pc)[2][64] = st.pc;
  int(&recc)[2][64] = st.recc;
  __shared__ int lv[16][16], lv8[4][64], clv[2][4][16], cdc[2][4];
  // the warps' transpose scratch (warps 0, 1, 3: 128 words, warp 2: 256)
  __shared__ int skr[640];
  __shared__ int off4[16], off8[64];
  __shared__ FetchAt fa[4];
  // each luma 8x8 group's decimation score (2 gy + gx), the SATD halves of
  // the two luma warps and the 8x8 warp's SA8D, the cbp bits of the two
  // luma warps and the 8x8 warp
  __shared__ int gsum[4], part[3], cbits[3];
  __shared__ int pred1[BP == 1 ? 256 : 1], pc1[BP == 1 ? 2 : 1][64], bsel;
  // the trellis phase's table, coefficients in scan order, levels of the
  // chroma DC and history bytes (TR only)
  constexpr int TRS = TR ? 1 : 0;
  __shared__ int trt[TR ? TR_K6_INTS : 1];
  // (a block's coefficients 24 or 72 words apart: the 4 blocks of a
  // warp on 4 banks)
  __shared__ int tc2[16 * TRS + 1 - TRS][24], tc5[4 * TRS + 1 - TRS][72];
  __shared__ int tc4[8 * TRS + 1 - TRS][24], tc3[4][4], tl3[2][4];
  __shared__ unsigned char trh[TR ? 4 * TR_WORDS : 1];
  __shared__ float trsd[TR ? TR_WORDS : 1];
  // the joint chroma AC decimation: K6's, off in B pass 1
  const int cdecim = BP == 1 ? 0 : decimate;
  int* sk = skr + (warp == 0 ? 0 : warp == 1 ? 128 : warp == 2 ? 256 : 512);

  // ------------------------------------------ tables, source, set-up
  // with a QP map (variance AQ) qtab_g is the 52-QP stack: the MB's row
  const int* qrow = qtab_g + (qp_map ? qp_map[mb] * QTABP_INTS : 0);
  if (TR) {
    // the trellis table (trellis.cuh's TR_ layout), the MB's row with a
    // map, staged in shared memory
    const int* trg = trellis_g + (qp_map ? qp_map[mb] * TR_K6_INTS : 0);
    for (int i = tid; i < TR_K6_INTS; i += NT) trt[i] = trg[i];
  }
  for (int i = tid; i < QTABP_INTS; i += NT)
    reinterpret_cast<int*>(&q)[i] = qrow[i];
  // the noise reduction's offsets (null: NR off)
  if (nr_off4 && tid < 16) off4[tid] = nr_off4[tid];
  if (nr_off8 && tid < 64) off8[tid] = nr_off8[tid];
  for (int i = tid; i < 256; i += NT)
    fenc[i] = Y[(my * 16 + (i >> 4)) * W + mx * 16 + (i & 15)];
  for (int i = tid; i < 128; i += NT) {
    const int ch = i >> 6, k = i & 63;
    fc[ch][k] = (ch ? V : U)[(my * 8 + (k >> 3)) * Wc + mx * 8 + (k & 7)];
  }
  // the MB's reference (K6): n_planes half-pel planes and one padded
  // chroma plane of each channel per reference
  const int rs = BP == 0 && ref_sel ? ref_sel[mb] : 0;
  const int* PL = planes + (size_t)rs * n_planes * plane;
  const int* CU = refu + (size_t)rs * Hcp * Wcp;
  const int* CV = refv + (size_t)rs * Hcp * Wcp;
  if (BP == 0 && tid < 4) {
    // quadrant tid's partition (ptype 0 16x16, 1 16x8, 2 8x16, 3 8x8,
    // each with the MV of its top-left quadrant), its block starts taken
    // as jax.lax.dynamic_slice takes them (ds_start)
    const Part p = part_of(ptype_g[mb], 8 * (tid >> 1), 8 * (tid & 1));
    const int kq = 2 * (p.top >> 3) + (p.left >> 3);
    const int mvx = mv_quad[(mb * 4 + kq) * 2], mvy = mv_quad[(mb * 4 + kq) * 2 + 1];
    const int fx = mvx & 3, fy = mvy & 3, qi = (fy << 2) | fx;
    const int p0 = ds_start(kHpelRef0[qi], n_planes, 1);
    const int p1 = ds_start(kHpelRef1[qi], n_planes, 1);
    const int iy = my * 16 + p.top + (mvy >> 2) + PAD;
    const int ix = mx * 16 + p.left + (mvx >> 2) + PAD;
    const int ya = ds_start(iy + (fy == 3), Hp, p.bh), xa = ds_start(ix, Wp, p.bw);
    const int yb = ds_start(iy, Hp, p.bh), xb = ds_start(ix + (fx == 3), Wp, p.bw);
    FetchAt f;
    f.a = (long long)p0 * plane + (long long)(ya - p.top) * Wp + xa - p.left;
    f.b = (long long)p1 * plane + (long long)(yb - p.top) * Wp + xb - p.left;
    const int ctop = p.top >> 1, cleft = p.left >> 1;
    const int y0 = ds_start(my * 8 + ctop + (mvy >> 3) + CPAD, Hcp, p.bh / 2 + 1);
    const int x0 = ds_start(mx * 8 + cleft + (mvx >> 3) + CPAD, Wcp, p.bw / 2 + 1);
    f.c = (y0 - ctop) * Wcp + x0 - cleft;
    chroma_weights(f, mvx, mvy);
    fa[tid] = f;
  } else if (BP > 0 && tid < 2) {
    // list tid's 16x16 luma and 8x8 chroma fetch at the MB's MV
    const int* mvl = tid ? B.mv1 : B.mv0;
    const int mvx = mvl[2 * mb], mvy = mvl[2 * mb + 1];
    const int fx = mvx & 3, fy = mvy & 3, qi = (fy << 2) | fx;
    const int iy = my * 16 + (mvy >> 2) + PAD, ix = mx * 16 + (mvx >> 2) + PAD;
    const int ya = ds_start(iy + (fy == 3), Hp, 16), xa = ds_start(ix, Wp, 16);
    const int yb = ds_start(iy, Hp, 16), xb = ds_start(ix + (fx == 3), Wp, 16);
    FetchAt f;
    f.a = (long long)kHpelRef0[qi] * plane + (long long)ya * Wp + xa;
    f.b = (long long)kHpelRef1[qi] * plane + (long long)yb * Wp + xb;
    const int y0 = ds_start(my * 8 + (mvy >> 3) + CPAD, Hcp, 9);
    const int x0 = ds_start(mx * 8 + (mvx >> 3) + CPAD, Wcp, 9);
    f.c = y0 * Wcp + x0;
    chroma_weights(f, mvx, mvy);
    fa[tid] = f;
  }
  __syncthreads();

  // ------------------------------------------------------ predictions
  if (BP > 0) {
    // both lists' predictions: pass 2 keeps the MB's final one, pass 1
    // both until the decision below. Pass 2: the average where both
    // lists are used, else L0 where it is, else L1 (at MV 0 on intra
    // MBs, as encode_b_body's where() takes it)
    const bool u0 = BP == 1 || B.r0[mb] >= 0;
    const bool u1 = BP == 1 || B.r1[mb] >= 0 || !u0;
    for (int i = tid; i < 256; i += NT) {
      const int r = i >> 4, c = i & 15;
      const int a = u0 ? luma_at(fa[0], planes, Wp, r, c) : 0;
      const int b = u1 ? luma_at(fa[1], B.planes1, Wp, r, c) : 0;
      if (BP == 1) {
        pred[i] = a;
        pred1[i] = b;
      } else {
        pred[i] = u0 && u1 ? (a + b + 1) >> 1 : u0 ? a : b;
      }
    }
    for (int i = tid; i < 128; i += NT) {
      const int ch = i >> 6, k = i & 63, r = k >> 3, c = k & 7;
      const int a = u0 ? chroma_at(fa[0], ch ? refv : refu, Wcp, r, c) : 0;
      const int b = u1 ? chroma_at(fa[1], ch ? B.refv1 : B.refu1, Wcp, r, c) : 0;
      if (BP == 1) {
        pc[ch][k] = a;
        pc1[ch][k] = b;
      } else {
        pc[ch][k] = u0 && u1 ? (a + b + 1) >> 1 : u0 ? a : b;
      }
    }
    if (BP == 1) {
      __syncthreads();
      if (warp < 2) {                  // the BI average's 4x4 Hadamards
        const int b = tid >> 2, j = tid & 3, by = b >> 2, bx = b & 3;
        int x[4];
        #pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = (4 * by + r) * 16 + 4 * bx + j;
          x[r] = fenc[o] - ((pred[o] + pred1[o] + 1) >> 1);
        }
        const int h = had4_lanes(x, sk, b & 7, j);
        // satd: the pairs (bx 2p, 2p + 1) of each block row, each >> 1
        const int pair = (h + __shfl_xor_sync(ALL, h, 4)) >> 1;
        const int s = __reduce_add_sync(ALL, j == 0 && !(b & 1) ? pair : 0);
        if (lane == 0) part[warp] = s;
      }
      __syncthreads();
      if (tid == 0) {                  // argmin over L0, L1, BI
        const int satd = part[0] + part[1];
        const int m0x = B.mv0[2 * mb], m0y = B.mv0[2 * mb + 1];
        const int m1x = B.mv1[2 * mb], m1y = B.mv1[2 * mb + 1];
        const int b0 = se_bits(m0x - B.seed0[2 * mb]) + se_bits(m0y - B.seed0[2 * mb + 1]);
        const int b1 = se_bits(m1x - B.seed1[2 * mb]) + se_bits(m1y - B.seed1[2 * mb + 1]);
        const int c0 = B.satd0[mb] + B.lam * (b0 + 3);
        const int c1 = B.satd1[mb] + B.lam * (b1 + 3);
        const int c2 = satd + B.lam * (b0 + b1 + 5);
        int m = 0, best = c0;
        if (c1 < best) { m = 1; best = c1; }
        if (c2 < best) { m = 2; best = c2; }
        bsel = m;
        B.bmode[mb] = m;
        B.cost[mb] = best;
      }
      __syncthreads();
      for (int i = tid; i < 256; i += NT)
        pred[i] = bsel == 2 ? (pred[i] + pred1[i] + 1) >> 1 : bsel == 1 ? pred1[i] : pred[i];
      for (int i = tid; i < 128; i += NT) {
        const int ch = i >> 6, k = i & 63;
        const int a = pc[ch][k], b = pc1[ch][k];
        pc[ch][k] = bsel == 2 ? (a + b + 1) >> 1 : bsel == 1 ? b : a;
      }
    }
  } else {
    for (int i = tid; i < 256; i += NT) {
      const int r = i >> 4, c = i & 15;
      pred[i] = luma_at(fa[2 * (r >> 3) + (c >> 3)], PL, Wp, r, c);
    }
    for (int i = tid; i < 128; i += NT) {
      const int ch = i >> 6, k = i & 63, r = k >> 3, c = k & 7;
      pc[ch][k] = chroma_at(fa[2 * (r >> 2) + (c >> 2)], ch ? CV : CU, Wcp, r, c);
    }
  }
  __syncthreads();

  // ------------------------------------------- transform + quant
  // (with TR the coefficients go to the trellis phase in scan order)
  if (warp < 2) {                      // luma 4x4 block b, row / column j
    const int b = tid >> 2, j = tid & 3, by = b >> 2, bx = b & 3;
    int x[4], l[4];
    #pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = (4 * by + r) * 16 + 4 * bx + j;
      x[r] = fenc[o] - pred[o];
    }
    if (t8 == 1) {                     // SATD's half of the pair (bx 2p, 2p + 1)
      const int h = had4_lanes(x, sk, b & 7, j);
      const int pair = (h + __shfl_xor_sync(ALL, h, 4)) >> 1;
      const int s = __reduce_add_sync(ALL, j == 0 && !(b & 1) ? pair : 0);
      if (lane == 0) part[warp] = s;
    }
    if (lossless) {                    // the bypass: the samples are the levels
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = (4 * by + j) * 16 + 4 * bx + c;
        l[c] = fenc[o] - pred[o];
      }
    } else {
      int co[4];
      dct4_lanes(x, co, sk, b & 7, j);
      if (nr_off4) {                   // x264_denoise_dct: |coef| out, AC shrunk
        int a[4];
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          a[c] = abs(co[c]);
          if (i > 0) co[c] = co[c] < 0 ? -max(a[c] - off4[i], 0) : max(a[c] - off4[i], 0);
        }
        *reinterpret_cast<int4*>(nr_abs4 + (mb * 16 + b) * 16 + 4 * j) =
            make_int4(a[0], a[1], a[2], a[3]);
      }
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (TR)                        // cat 2 in zig-zag: the trellis phase
          tc2[b][kInvZig4[4 * j + c]] = co[c];
        else
          l[c] = quant(co[c], q.py_mf[4 * j + c], q.py_bias[4 * j + c]);
      }
    }
    if (!TR || lossless)
      #pragma unroll
      for (int c = 0; c < 4; ++c) lv[b][4 * j + c] = l[c];
  } else if (warp == 2 && t8) {        // 8x8 block k, row / column r
    const int k = lane >> 3, r = lane & 7, r0 = 8 * (k >> 1), c0 = 8 * (k & 1);
    int x[8], co[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (r0 + i) * 16 + c0 + r;
      x[i] = fenc[o] - pred[o];
    }
    if (t8 == 1) {                     // SA8D (sa8d_16x16 before its (+2) >> 2)
      const int h = had8_lanes(x, sk, k, r);
      const int s = __reduce_add_sync(ALL, r == 0 ? h : 0);
      if (lane == 0) part[2] = s;
    }
    dct8_lanes(x, co, sk, k, r);
    if (nr_off8) {
      int a[8];
      #pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = 8 * r + c;
        a[c] = abs(co[c]);
        if (i > 0) co[c] = co[c] < 0 ? -max(a[c] - off8[i], 0) : max(a[c] - off8[i], 0);
      }
      int4* o = reinterpret_cast<int4*>(nr_abs8 + (mb * 4 + k) * 64 + 8 * r);
      o[0] = make_int4(a[0], a[1], a[2], a[3]);
      o[1] = make_int4(a[4], a[5], a[6], a[7]);
    }
    #pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (TR)                          // cat 5 in ZIGZAG8: the trellis phase
        tc5[k][kInvZig8[8 * r + c]] = co[c];
      else
        lv8[k][8 * r + c] = quant(co[c], q.p8_mf[8 * r + c], q.p8_bias[8 * r + c]);
    }
  } else if (warp == 3) {              // chroma block (ch, blk), row / column j
    const int k = lane >> 2, ch = k >> 2, blk = k & 3, j = lane & 3;
    const int by = blk >> 1, bx = blk & 1;
    int x[4], l[4];
    #pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = (4 * by + r) * 8 + 4 * bx + j;
      x[r] = fc[ch][o] - pc[ch][o];
    }
    if (lossless) {                    // the bypass: sample 0 rides the DC
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = (4 * by + j) * 8 + 4 * bx + c;
        l[c] = fc[ch][o] - pc[ch][o];
      }
      if (j == 0) {
        cdc[ch][blk] = l[0];
        l[0] = 0;
      }
    } else {
      int co[4];
      dct4_lanes(x, co, sk, k, j);
      if (j == 0) {
        cdc[ch][blk] = co[0];
        co[0] = 0;
      }
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * j + c;
        if (TR) {                      // cat 4 on zig-zag 1..15: the trellis
          if (i > 0) tc4[k][kInvZig4[i] - 1] = co[c];
          else clv[ch][blk][0] = 0;
        } else {
          l[c] = quant(co[c], q.pc_mf[i], q.pc_bias[i]);
        }
      }
    }
    if (!TR || lossless)
      #pragma unroll
      for (int c = 0; c < 4; ++c) clv[ch][blk][4 * j + c] = l[c];
  }

  // ------------------------------------------------ the trellis phase
  if constexpr (TR) {
    if (!lossless) {
      __syncthreads();
      trellis_phase(trt, tc2, tc5, tc4, cdc, tc3, trh, trsd, lv, lv8, clv,
                    tl3, t8);
      __syncthreads();
    }
  }

  // ------------------------------ decimation scores, by warp reductions
  // (each lane reads back its own row of levels; a block's score in
  // each of its lanes)
  int l[8], score = 0, sum = 0;
  if (warp < 2) {
    const int b = tid >> 2, j = tid & 3;
    #pragma unroll
    for (int c = 0; c < 4; ++c) l[c] = lv[b][4 * j + c];
    score = decimate_lanes4(l, j, false);
    // the 8x8 group's sum (blocks b ^ 1 and b ^ 4 of the warp: lanes ^ 4
    // and ^ 16), recorded by lane 0 (group gx 0) and lane 8 (gx 1)
    int g = score + __shfl_xor_sync(ALL, score, 4);
    g += __shfl_xor_sync(ALL, g, 16);
    if (lane == 0 || lane == 8) gsum[2 * warp + (lane >> 3)] = g;
  } else if (warp == 2 && t8) {
    const int k = lane >> 3, r = lane & 7;
    #pragma unroll
    for (int c = 0; c < 8; ++c) l[c] = lv8[k][8 * r + c];
    score = decimate_lanes8(l, r);
    sum = __reduce_add_sync(ALL, r == 0 ? score : 0);
  } else if (warp == 3) {
    const int k = lane >> 2, ch = k >> 2, blk = k & 3, j = lane & 3;
    #pragma unroll
    for (int c = 0; c < 4; ++c) l[c] = clv[ch][blk][4 * j + c];
    score = decimate_lanes4(l, j, true);
    sum = __reduce_add_sync(ALL, j == 0 ? score : 0);
  }
  __syncthreads();

  // ------------------------------------- decimation, dequant + recon
  // the transform choice below subme 6: sa8d_16x16 < satd, strictly
  const bool sel8 = t8 == 1 && (part[2] + 2) >> 2 < part[0] + part[1];
  if (warp < 2) {
    const int b = tid >> 2, j = tid & 3, by = b >> 2, bx = b & 3;
    // the 8x8 group (score < 4) or whole-MB (total < 6) kill; the bypass
    // codes every sample: no decimation (x264_tpu inter.py:497)
    const int tot = gsum[0] + gsum[1] + gsum[2] + gsum[3];
    const bool kill = decimate && !lossless
                      && (gsum[2 * warp + (bx >> 1)] < 4 || tot < 6);
    int nz = 0, dq[4], res[4];
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kill) l[c] = 0;
      lv[b][4 * j + c] = l[c];
      nz |= l[c] != 0;
      dq[c] = dequant(l[c], q.py_dmf[4 * j + c], q.py_qpdiv6);
    }
    // the cbp bits of the warp's two groups (lanes 0-7 and 16-23: gx 0)
    const unsigned m = __ballot_sync(ALL, nz);
    if (lane == 0)
      cbits[warp] = ((m & 0x00ff00ffu) != 0) | ((m & 0xff00ff00u) != 0) << 1;
    if (lossless) {                    // the recon is the source
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = (4 * by + j) * 16 + 4 * bx + c;
        rec[o] = clip255(pred[o] + l[c]);
      }
    } else {
      idct4_lanes(dq, res, sk, b & 7, j);
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (4 * by + i) * 16 + 4 * bx + j;
        rec[o] = clip255(pred[o] + res[i]);
      }
    }
  } else if (warp == 2 && t8) {        // 8x8 block k: kill, dequant, recon
    const int k = lane >> 3, r = lane & 7, r0 = 8 * (k >> 1), c0 = 8 * (k & 1);
    // a block scoring < 4, or all four when the total is < 6; the 8x8
    // trellis is its own decimation (encoder/macroblock.c:630)
    const bool kill = decimate && !TR && (score < 4 || sum < 6);
    int nz = 0, dq[8], res[8];
    #pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kill) l[c] = 0;
      lv8[k][8 * r + c] = l[c];
      nz |= l[c] != 0;
      dq[c] = dequant8(l[c], q.p8_dmf[8 * r + c], q.py_qpdiv6);
    }
    const unsigned m = __ballot_sync(ALL, nz);
    if (lane == 0)
      cbits[2] = ((m & 0xffu) != 0) | ((m & 0xff00u) != 0) << 1
                 | ((m & 0xff0000u) != 0) << 2 | ((m & 0xff000000u) != 0) << 3;
    idct8_lanes(dq, res, sk, k, r);
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (r0 + i) * 16 + c0 + r;
      rec8[o] = clip255(pred[o] + res[i]);
    }
  } else if (warp == 3) {
    const int k = lane >> 2, ch = k >> 2, blk = k & 3, j = lane & 3;
    const int by = blk >> 1, bx = blk & 1;
    // the joint two-channel AC kill (score < 7)
    const bool ackill = cdecim && !lossless && sum < 7;
    int nz = 0, dq[4], res[4];
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (ackill) l[c] = 0;
      clv[ch][blk][4 * j + c] = l[c];
      nz |= l[c] != 0;
      dq[c] = dequant(l[c], q.pc_dmf[4 * j + c], q.pc_qpdiv6);
    }
    const bool cnz = (__ballot_sync(ALL, nz) >> (16 * ch)) & 0xffffu;
    // the channel's DC: its 2x2 Hadamard, quant (the trellis phase's cat
    // 3, or the samples under the bypass), inverse and dequant
    const int* d = cdc[ch];
    const int h[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                      d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
    int dl[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      dl[i] = lossless ? d[i] : TR ? tl3[ch][i] : quant(h[i], q.pc_mf_dc, q.pc_bias_dc);
    const int gg[4] = {dl[0] + dl[1] + dl[2] + dl[3], dl[0] - dl[1] + dl[2] - dl[3],
                       dl[0] + dl[1] - dl[2] - dl[3], dl[0] - dl[1] - dl[2] + dl[3]};
    const int dcr = dequant_2x2_dc(gg[blk], q.pc_dmf0, q.pc_qpdiv6);
    if (j == 0) chroma_dc_o[mb * 8 + ch * 4 + blk] = dl[blk];
    if (lossless) {                    // the recon is the source
      if (j == 0) l[0] = d[blk];
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = (4 * by + j) * 8 + 4 * bx + c;
        recc[ch][o] = clip255(pc[ch][o] + l[c]);
      }
    } else {
      if (j == 0) dq[0] = dcr;
      idct4_lanes(dq, res, sk, k, j);
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (4 * by + i) * 8 + 4 * bx + j;
        recc[ch][o] = clip255(pc[ch][o] + (cnz ? res[i] : (dcr + 32) >> 6));
      }
    }
  }
  __syncthreads();

  // ------------------------------------- coalesced stores of the MB
  // (16-byte vectors: the wrappers allocate every output, so each
  // plane and each MB's run of levels starts 16-byte aligned)
  const int4* r4 = reinterpret_cast<const int4*>(sel8 ? rec8 : rec);
  for (int i = tid; i < 64; i += NT)
    *reinterpret_cast<int4*>(RY + (my * 16 + (i >> 2)) * W + mx * 16 + 4 * (i & 3)) = r4[i];
  if (t8 == 2)
    for (int i = tid; i < 64; i += NT)
      *reinterpret_cast<int4*>(R8Y + (my * 16 + (i >> 2)) * W + mx * 16 + 4 * (i & 3)) =
          reinterpret_cast<const int4*>(rec8)[i];
  for (int i = tid; i < 32; i += NT) {
    const int ch = i >> 4, r = (i >> 1) & 7, h = i & 1;
    *reinterpret_cast<int4*>((ch ? RV : RU) + (my * 8 + r) * Wc + mx * 8 + 4 * h) =
        reinterpret_cast<const int4*>(recc[ch])[2 * r + h];
  }
  // blocks_z: z-order block zb is raster block kZOfRaster[zb] (an
  // involution), in zig-zag; zero where the 8x8 coding was chosen
  for (int i = tid; i < 64; i += NT) {
    const int b = kZOfRaster[i >> 2], j = 4 * (i & 3);
    const int4 v = sel8 ? make_int4(0, 0, 0, 0)
                        : make_int4(lv[b][kZig4P[j]], lv[b][kZig4P[j + 1]],
                                    lv[b][kZig4P[j + 2]], lv[b][kZig4P[j + 3]]);
    *reinterpret_cast<int4*>(blocks_z + mb * 256 + 4 * i) = v;
  }
  if (t8)
    for (int i = tid; i < 64; i += NT) {
      const int k = i >> 4, j = 4 * (i & 15);
      *reinterpret_cast<int4*>(blocks8_o + mb * 256 + 4 * i) =
          make_int4(lv8[k][kZig8[j]], lv8[k][kZig8[j + 1]],
                    lv8[k][kZig8[j + 2]], lv8[k][kZig8[j + 3]]);
    }
  for (int i = tid; i < 32; i += NT) {
    const int ch = i >> 4, blk = (i >> 2) & 3, j = 4 * (i & 3);
    const int* c = clv[ch][blk];
    *reinterpret_cast<int4*>(chroma_ac_o + mb * 128 + 4 * i) =
        make_int4(c[kZig4P[j]], c[kZig4P[j + 1]], c[kZig4P[j + 2]], c[kZig4P[j + 3]]);
  }
  if (tid == 0) {
    const int bits = cbits[0] | cbits[1] << 2, bits8 = t8 ? cbits[2] : 0;
    cbp_o[mb] = sel8 ? bits8 : bits;
    if (t8 == 1) t8_sel_o[mb] = sel8 ? 1 : 0;
    if (t8 == 2) cbp8_o[mb] = bits8;
  }
}

// K6 / K22 without the trellis: 128 threads a CTA, their registers held
// to 32 so that an SM holds 16 CTAs (a few words spill; faster than 40
// registers and 12 CTAs in turns on the H100)
template <int BP>
__global__ void __launch_bounds__(128, 16) inter_mb_kernel(INTER_MB_PARAMS) {
  inter_mb_body<BP, false>(INTER_MB_ARGS);
}

// K6 / K22 with the trellis phase: 256 threads a CTA, their registers
// held to 64 so that an SM holds 4 CTAs
template <int BP>
__global__ void __launch_bounds__(256, 4)
    inter_mb_trellis_kernel(INTER_MB_PARAMS) {
  inter_mb_body<BP, true>(INTER_MB_ARGS);
}

// one MB a CTA: the trellis kernel given a table, else the 128-thread one
template <int BP, class... A>
void launch_inter(const int* trellis, int nmb, cudaStream_t s, A... a) {
  if (trellis)
    inter_mb_trellis_kernel<BP><<<nmb, 256, 0, s>>>(a...);
  else
    inter_mb_kernel<BP><<<nmb, 128, 0, s>>>(a...);
}

}  // namespace

extern "C" int p_inter_mb(const int* y, const int* u, const int* v,
                          const int* planes, const int* refu_pad,
                          const int* refv_pad, const int* ptype,
                          const int* mv_quad, const int* qtab, int* recon_y,
                          int* recon_u, int* recon_v, int* blocks_z, int* cbp,
                          int* chroma_dc, int* chroma_ac, int* blocks8,
                          uint8_t* t8_sel, int* recon8_y, int* cbp8,
                          const int* qp_map, const int* trellis,
                          const int* ref_sel, const int* nr_off4,
                          const int* nr_off8, int* nr_abs4, int* nr_abs8,
                          int mb_h, int mb_w, int n_planes, int decimate,
                          int t8, int lossless, void* stream) {
  // ref_sel: null with one reference; else each MB's, and n_planes the
  // half-pel planes of each reference in the stack
  launch_inter<0>(trellis, mb_h * mb_w, (cudaStream_t)stream, y, u, v,
                  planes, refu_pad, refv_pad, ptype, mv_quad, qtab, recon_y,
                  recon_u, recon_v, blocks_z, cbp, chroma_dc, chroma_ac,
                  blocks8, t8_sel, recon8_y, cbp8, qp_map, trellis, ref_sel,
                  mb_h, mb_w, n_planes, decimate, t8, BArgs{}, nr_off4,
                  nr_off8, nr_abs4, nr_abs8, lossless);
  return (int)cudaGetLastError();
}

// K22: pass 1 where satd0 is given (then bmode / cost_inter are written;
// blocks_z .. chroma_ac are scratch), else pass 2 (r0 / r1 given)
extern "C" int b_inter_mb(const int* y, const int* u, const int* v,
                          const int* planes0, const int* cu0, const int* cv0,
                          const int* planes1, const int* cu1, const int* cv1,
                          const int* mv0, const int* mv1, const int* r0,
                          const int* r1, const int* satd0, const int* satd1,
                          const int* seed0, const int* seed1, const int* qtab,
                          const int* trellis, int* recon_y, int* recon_u,
                          int* recon_v, int* blocks_z, int* cbp,
                          int* chroma_dc, int* chroma_ac, int* bmode,
                          int* cost_inter, int mb_h, int mb_w, int lam,
                          void* stream) {
  const BArgs B{planes1, cu1, cv1, mv0, mv1, satd0, satd1, seed0, seed1, r0,
                r1, bmode, cost_inter, lam};
  cudaStream_t s = (cudaStream_t)stream;
  if (satd0 != nullptr)
    launch_inter<1>(trellis, mb_h * mb_w, s, y, u, v, planes0, cu0, cv0,
                    nullptr, nullptr, qtab, recon_y, recon_u, recon_v,
                    blocks_z, cbp, chroma_dc, chroma_ac, nullptr, nullptr,
                    nullptr, nullptr, nullptr, trellis, nullptr, mb_h, mb_w,
                    4, 1, 0, B, nullptr, nullptr, nullptr, nullptr, 0);
  else
    launch_inter<2>(trellis, mb_h * mb_w, s, y, u, v, planes0, cu0, cv0,
                    nullptr, nullptr, qtab, recon_y, recon_u, recon_v,
                    blocks_z, cbp, chroma_dc, chroma_ac, nullptr, nullptr,
                    nullptr, nullptr, nullptr, trellis, nullptr, mb_h, mb_w,
                    4, 1, 0, B, nullptr, nullptr, nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

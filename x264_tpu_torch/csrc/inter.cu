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
// wavefront: one launch, one CTA per MB (64 threads; 256 with the
// trellis, a template instantiation of its own). The CTA fetches its
// luma prediction partition by partition (ptype 0 16x16, 1 16x8, 2
// 8x16, 3 8x8; each partition takes the MV of its top-left 8x8
// quadrant): a sample is the rounding average of the two half-pel
// planes its quarter-pel phase names (kHpelRef0/1), each block start
// taken as jax.lax.dynamic_slice takes it (ds_start: a negative start
// wraps once, then clamps, and the plane index clamps into the stack, so
// a one-plane stack serves full-pel MVs). The chroma predictions (8x8,
// 8x4, 4x8 or 4x4 blocks) come from the 1/8-pel bilinear filter
// ((ca*s00 + cb*s01 + cc*s10 + cd*s11 + 32) >> 6). Threads 0-15 then run
// one luma 4x4 block each (DCT, P-matrix quant, decimate score) and
// threads 32-39 one chroma block each. The 8x8-group / whole-MB luma
// kill (score < 4 / total < 6) and the joint chroma AC kill (score < 7)
// are decided by one thread between the phases, then dequant, IDCT and
// reconstruction. With the 8x8 transform (t8 = 1 or 2) threads 48-51
// run one 8x8 block each on the same prediction in shared memory (DCT8,
// CQM_8PY quant, DECIMATE_TAB8 score; a block scoring < 4, or all four
// when the total is < 6, is zeroed; dequant, IDCT8, reconstruction:
// t8.cuh). At t8 = 1 (below subme 6) the MB's transform is chosen here:
// threads 0-15 and 52-55 take the 4x4 and 8x8 Hadamard abs-sums of the
// prediction error, and the 8x8 coding is taken where sa8d_16x16 <
// satd, strictly; its recon, its cbp and zero 4x4 levels are written.
// At t8 = 2 (the RD ladder) both codings are written for K13.
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
// stack) and 8x8 chroma predictions. Pass 1: threads 0-15 take the 4x4
// Hadamards of the source minus the rounding average, thread 0 forms the
// BI SATD and picks argmin(satd + lam * (mv bits + 3 | 3 | 5)) over L0,
// L1, BI (first on ties), every thread then keeps the chosen prediction
// (the average for BI); pass 2 keeps the average where both of the MB's
// final references are used, else the one list's. The residual follows
// as K6's, decimated, with the trellis phase where given (warp 4 idle:
// no 8x8 transform), and with the joint chroma AC decimation in pass 2
// only (pass 1 has none). Bounded as K6 by bytes, by the count: pass 1
// reads two half-pel stacks.
// What bounds it on the H100: bytes, by the count (the source, the
// half-pel planes, the padded chroma, and the recon and coefficient
// planes out, as int32), with few operations an MB. In practice an MB's
// chain of dependent phases (fetch, transform, decimation, recon; with
// the trellis its 64-position cat-5 Viterbi and backtrack) and the CTAs
// an SM holds set the time: one MB a CTA with most threads idle outside
// the transform phases keeps it well above the bound.
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

// one list's 8x8 chroma prediction sample (r, c) (1/8-pel bilinear)
__device__ __forceinline__ int fetch8c(const int* R, int Hcp, int Wcp, int mx,
                                       int my, int mvx, int mvy, int r, int c) {
  const int dx = mvx & 7, dy = mvy & 7;
  const int y0 = ds_start(my * 8 + (mvy >> 3) + CPAD, Hcp, 9);
  const int x0 = ds_start(mx * 8 + (mvx >> 3) + CPAD, Wcp, 9);
  const int* s = R + (y0 + r) * Wcp + x0 + c;
  return ((8 - dx) * (8 - dy) * s[0] + dx * (8 - dy) * s[1]
          + (8 - dx) * dy * s[Wcp] + dx * dy * s[Wcp + 1] + 32) >> 6;
}

// x264_denoise_dct (common/quant.c:180) on one block's n coefficients:
// the pre-shrink |c| of every position to abs_out (for K26), then every
// AC |c| less its position's offset, floored at 0, the sign kept
__device__ __forceinline__ void nr_block(int* co, const int* off,
                                         int* abs_out, int n) {
  for (int i = 0; i < n; ++i) {
    const int a = abs(co[i]);
    abs_out[i] = a;
    if (i > 0) co[i] = co[i] < 0 ? -max(a - off[i], 0) : max(a - off[i], 0);
  }
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

// one MB of K6 / K22 on a CTA of 64 threads, or 256 with the trellis
// phase (TR)
template <int BP, bool TR>
__device__ __forceinline__ void inter_mb_body(INTER_MB_PARAMS) {
  constexpr int NT = TR ? 256 : 64;
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x;
  const int W = mb_w * 16, H = mb_h * 16, Wc = mb_w * 8, Hc = mb_h * 8;
  const int Wp = W + 2 * PAD, Hp = H + 2 * PAD;
  const int Wcp = Wc + 2 * CPAD, Hcp = Hc + 2 * CPAD;
  const size_t plane = (size_t)Hp * Wp;
  const int pt = BP == 0 ? ptype_g[mb] : 0;

  __shared__ QTabP q;
  __shared__ int fenc[256], pred[256], lv[16][16], score[16], nzb[16];
  __shared__ int fc[2][64], pc[2][64], clv[2][4][16], cdc[2][4], cscore[8];
  __shared__ int cdcl[2][4], cdcr[2][4], cnz[2], killg[4], ackill;
  __shared__ int had4[16], had8[4], lv8[4][64], score8[4], nz8[4], kill8[4];
  __shared__ int sel8, off4[16], off8[64];
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

  // ---------------------------------------------------------- fetch
  // with a QP map (variance AQ) qtab_g is the 52-QP stack: the MB's row
  const int* qrow = qtab_g + (qp_map ? qp_map[mb] * QTABP_INTS : 0);
  // the trellis table (trellis.cuh's TR_ layout), the MB's row with a
  // map, staged in shared memory (TR: given a table)
  const bool tr = TR;
  if (TR) {
    const int* trg = trellis_g + (qp_map ? qp_map[mb] * TR_K6_INTS : 0);
    for (int i = tid; i < TR_K6_INTS; i += NT) trt[i] = trg[i];
  }
  for (int i = tid; i < QTABP_INTS; i += NT)
    reinterpret_cast<int*>(&q)[i] = qrow[i];
  // the noise reduction's offsets (null: NR off)
  if (nr_off4 && tid < 16) off4[tid] = nr_off4[tid];
  if (nr_off8 && tid < 64) off8[tid] = nr_off8[tid];
  if (BP > 0) {
    // both lists' predictions: pass 2 keeps the MB's final one, pass 1
    // both until the decision below
    const int m0x = B.mv0[2 * mb], m0y = B.mv0[2 * mb + 1];
    const int m1x = B.mv1[2 * mb], m1y = B.mv1[2 * mb + 1];
    // pass 2: the average where both lists are used, else L0 where it is,
    // else L1 (at MV 0 on intra MBs, as encode_b_body's where() takes it)
    const bool u0 = BP == 1 || B.r0[mb] >= 0;
    const bool u1 = BP == 1 || B.r1[mb] >= 0 || !u0;
    for (int i = tid; i < 256; i += NT) {
      const int r = i >> 4, c = i & 15;
      const int a = u0 ? mc_luma16(planes, plane, Hp, Wp, PAD, mx, my, m0x, m0y, r, c) : 0;
      const int b = u1 ? mc_luma16(B.planes1, plane, Hp, Wp, PAD, mx, my, m1x, m1y, r,
                                     c) : 0;
      if (BP == 1) {
        pred[i] = a;
        pred1[i] = b;
      } else {
        pred[i] = u0 && u1 ? (a + b + 1) >> 1 : u0 ? a : b;
      }
      fenc[i] = Y[(my * 16 + r) * W + mx * 16 + c];
    }
    for (int i = tid; i < 128; i += NT) {
      const int ch = i >> 6, k = i & 63, r = k >> 3, c = k & 7;
      const int a = u0 ? fetch8c(ch ? refv : refu, Hcp, Wcp, mx, my, m0x, m0y, r, c) : 0;
      const int b = u1 ? fetch8c(ch ? B.refv1 : B.refu1, Hcp, Wcp, mx, my, m1x, m1y, r, c)
                       : 0;
      if (BP == 1) {
        pc[ch][k] = a;
        pc1[ch][k] = b;
      } else {
        pc[ch][k] = u0 && u1 ? (a + b + 1) >> 1 : u0 ? a : b;
      }
      fc[ch][k] = (ch ? V : U)[(my * 8 + r) * Wc + mx * 8 + c];
    }
    if (BP == 1) {
      __syncthreads();
      if (tid < 16) {                  // the BI average's 4x4 Hadamards
        const int by = tid >> 2, bx = tid & 3;
        int dd[16];
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c) {
            const int o = (4 * by + r) * 16 + 4 * bx + c;
            dd[4 * r + c] = fenc[o] - ((pred[o] + pred1[o] + 1) >> 1);
          }
        had4[tid] = abs_had4x4(dd);
      }
      __syncthreads();
      if (tid == 0) {                  // argmin over L0, L1, BI
        int satd = 0;
        for (int by = 0; by < 4; ++by)
          for (int p = 0; p < 2; ++p)
            satd += (had4[4 * by + 2 * p] + had4[4 * by + 2 * p + 1]) >> 1;
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
  // the MB's reference: n_planes half-pel planes and one padded chroma
  // plane of each channel per reference
  const int rs = ref_sel ? ref_sel[mb] : 0;
  const int* PL = planes + (size_t)rs * n_planes * plane;
  const int* RU = refu + (size_t)rs * Hcp * Wcp;
  const int* RV = refv + (size_t)rs * Hcp * Wcp;
  for (int i = tid; i < 256; i += NT) {
    const int r = i >> 4, c = i & 15;
    const Part p = part_of(pt, r, c);
    const int k = 2 * (p.top >> 3) + (p.left >> 3);
    const int mvx = mv_quad[(mb * 4 + k) * 2], mvy = mv_quad[(mb * 4 + k) * 2 + 1];
    const int fx = mvx & 3, fy = mvy & 3, qi = (fy << 2) | fx;
    const int p0 = ds_start(kHpelRef0[qi], n_planes, 1);
    const int p1 = ds_start(kHpelRef1[qi], n_planes, 1);
    const int iy = my * 16 + p.top + (mvy >> 2) + PAD;
    const int ix = mx * 16 + p.left + (mvx >> 2) + PAD;
    const int ya = ds_start(iy + (fy == 3), Hp, p.bh), xa = ds_start(ix, Wp, p.bw);
    const int yb = ds_start(iy, Hp, p.bh), xb = ds_start(ix + (fx == 3), Wp, p.bw);
    const int rr = r - p.top, cc = c - p.left;
    const int a = PL[p0 * plane + (size_t)(ya + rr) * Wp + xa + cc];
    const int b = PL[p1 * plane + (size_t)(yb + rr) * Wp + xb + cc];
    pred[i] = (a + b + 1) >> 1;
    fenc[i] = Y[(my * 16 + r) * W + mx * 16 + c];
  }
  for (int i = tid; i < 128; i += NT) {
    const int ch = i >> 6, k = i & 63, r = k >> 3, c = k & 7;
    const Part p = part_of(pt, 2 * r, 2 * c);
    const int kq = 2 * (p.top >> 3) + (p.left >> 3);
    const int mvx = mv_quad[(mb * 4 + kq) * 2], mvy = mv_quad[(mb * 4 + kq) * 2 + 1];
    const int dx = mvx & 7, dy = mvy & 7;
    const int ca = (8 - dx) * (8 - dy), cb = dx * (8 - dy);
    const int cc = (8 - dx) * dy, cd = dx * dy;
    const int ctop = p.top >> 1, cleft = p.left >> 1;
    const int y0 = ds_start(my * 8 + ctop + (mvy >> 3) + CPAD, Hcp, p.bh / 2 + 1);
    const int x0 = ds_start(mx * 8 + cleft + (mvx >> 3) + CPAD, Wcp, p.bw / 2 + 1);
    const int* R = ch ? RV : RU;
    const int* s = R + (y0 + r - ctop) * Wcp + x0 + c - cleft;
    pc[ch][k] = (ca * s[0] + cb * s[1] + cc * s[Wcp] + cd * s[Wcp + 1] + 32) >> 6;
    fc[ch][k] = (ch ? V : U)[(my * 8 + r) * Wc + mx * 8 + c];
  }
  }
  __syncthreads();

  // ------------------------------------------- transform + quant
  if (tid < 16) {                      // luma raster block tid
    int by = tid >> 2, bx = tid & 3, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        dd[4 * r + c] = fenc[o] - pred[o];
      }
    if (t8 == 1) had4[tid] = abs_had4x4(dd);
    if (lossless) {                    // the bypass: the samples are the levels
      for (int i = 0; i < 16; ++i) lv[tid][i] = dd[i];
    } else {
    dct4x4(dd, co);
    if (nr_off4) nr_block(co, off4, nr_abs4 + (mb * 16 + tid) * 16, 16);
    if (tr) {                          // cat 2 in zig-zag: the trellis phase
      for (int j = 0; j < 16; ++j) tc2[tid][j] = co[kZig4P[j]];
    } else {
      for (int i = 0; i < 16; ++i) lv[tid][i] = quant(co[i], q.py_mf[i], q.py_bias[i]);
    }
    }
  } else if (t8 && tid >= 48 && tid < 56) {  // 8x8 block k: levels, or Hadamard
    const int k = tid & 3, r0 = 8 * (k >> 1), c0 = 8 * (k & 1);
    int dd[64];
    for (int i = 0; i < 64; ++i) {
      const int o = (r0 + (i >> 3)) * 16 + c0 + (i & 7);
      dd[i] = fenc[o] - pred[o];
    }
    if (tid < 52) {
      int co[64];
      dct8x8(dd, co);
      if (nr_off8) nr_block(co, off8, nr_abs8 + (mb * 4 + k) * 64, 64);
      if (tr) {                        // cat 5 in ZIGZAG8: the trellis phase
        for (int j = 0; j < 64; ++j) tc5[k][j] = co[kZig8[j]];
      } else {
        for (int i = 0; i < 64; ++i) lv8[k][i] = quant(co[i], q.p8_mf[i], q.p8_bias[i]);
      }
    } else if (t8 == 1) {
      had8[k] = abs_had8x8(dd);
    }
  } else if (tid >= 32 && tid < 40) {  // chroma block (ch, blk)
    int k = tid - 32, ch = k >> 2, blk = k & 3, by = blk >> 1, bx = blk & 1;
    int dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        dd[4 * r + c] = fc[ch][o] - pc[ch][o];
      }
    if (lossless) {                    // the bypass: sample 0 rides the DC
      cdc[ch][blk] = dd[0];
      clv[ch][blk][0] = 0;
      for (int i = 1; i < 16; ++i) clv[ch][blk][i] = dd[i];
    } else {
    dct4x4(dd, co);
    cdc[ch][blk] = co[0];
    co[0] = 0;
    if (tr) {                          // cat 4 on zig-zag 1..15: the trellis
      clv[ch][blk][0] = 0;
      for (int j = 1; j < 16; ++j) tc4[k][j - 1] = co[kZig4P[j]];
    } else {
      for (int i = 0; i < 16; ++i) clv[ch][blk][i] = quant(co[i], q.pc_mf[i], q.pc_bias[i]);
    }
    }
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

  // ------------------------------------------------ decimation scores
  if (tid < 16) {
    int zz[16];
    for (int j = 0; j < 16; ++j) zz[j] = lv[tid][kZig4P[j]];
    score[tid] = decimate_score(zz, 16);
  } else if (t8 && tid >= 48 && tid < 52) {
    const int k = tid & 3;
    int zz[64];
    for (int j = 0; j < 64; ++j) zz[j] = lv8[k][kZig8[j]];
    score8[k] = decimate_score8(zz);
  } else if (tid >= 32 && tid < 40) {
    const int k = tid - 32, ch = k >> 2, blk = k & 3;
    int zz[15];
    for (int j = 1; j < 16; ++j) zz[j - 1] = clv[ch][blk][kZig4P[j]];
    cscore[k] = decimate_score(zz, 15);
  }
  __syncthreads();

  // ------------------------------------------------ decimation
  if (tid == 0) {
    int g[4], tot = 0;
    for (int gi = 0; gi < 4; ++gi) {     // 8x8 group (gy, gx) = (gi>>1, gi&1)
      int gy = gi >> 1, gx = gi & 1, s = 0;
      for (int iy = 0; iy < 2; ++iy)
        for (int ix = 0; ix < 2; ++ix) s += score[(2 * gy + iy) * 4 + 2 * gx + ix];
      g[gi] = s;
      tot += s;
    }
    // the bypass codes every sample: no decimation (x264_tpu
    // inter.py:497)
    for (int gi = 0; gi < 4; ++gi)
      killg[gi] = decimate && !lossless && (g[gi] < 4 || tot < 6);
    int csc = 0;
    for (int k = 0; k < 8; ++k) csc += cscore[k];
    ackill = cdecim && !lossless && csc < 7;
    int sel = 0;
    if (t8) {
      const int tot8 = score8[0] + score8[1] + score8[2] + score8[3];
      // the 8x8 trellis is its own decimation (encoder/macroblock.c:630)
      for (int k = 0; k < 4; ++k)
        kill8[k] = decimate && !tr && (score8[k] < 4 || tot8 < 6);
    }
    if (t8 == 1) {                     // sa8d_16x16 < satd, strictly
      int satd = 0;
      for (int by = 0; by < 4; ++by)
        for (int p = 0; p < 2; ++p)
          satd += (had4[4 * by + 2 * p] + had4[4 * by + 2 * p + 1]) >> 1;
      const int sa8d = (had8[0] + had8[1] + had8[2] + had8[3] + 2) >> 2;
      sel = sa8d < satd;
    }
    sel8 = sel;
  }
  __syncthreads();

  // ------------------------------------- dequant + recon, outputs
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dq[16], res[16], nz = 0;
    const bool kill = killg[(by >> 1) * 2 + (bx >> 1)];
    for (int i = 0; i < 16; ++i) {
      if (kill) lv[tid][i] = 0;
      nz |= lv[tid][i] != 0;
      dq[i] = dequant(lv[tid][i], q.py_dmf[i], q.py_qpdiv6);
    }
    nzb[tid] = nz;
    if (lossless)                      // the recon is the source
      for (int i = 0; i < 16; ++i) res[i] = lv[tid][i];
    else
      idct4x4(dq, res);
    if (!sel8)
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          RY[(my * 16 + 4 * by + r) * W + mx * 16 + 4 * bx + c] =
              clip255(pred[(4 * by + r) * 16 + 4 * bx + c] + res[4 * r + c]);
    int* bz = blocks_z + (mb * 16 + kZOfRaster[tid]) * 16;
    for (int j = 0; j < 16; ++j) bz[j] = sel8 ? 0 : lv[tid][kZig4P[j]];
  } else if (t8 && tid >= 48 && tid < 52) {   // 8x8 block: dequant, recon
    const int k = tid - 48, r0 = 8 * (k >> 1), c0 = 8 * (k & 1);
    int dq[64], res[64], nz = 0;
    for (int i = 0; i < 64; ++i) {
      if (kill8[k]) lv8[k][i] = 0;
      nz |= lv8[k][i] != 0;
      dq[i] = dequant8(lv8[k][i], q.p8_dmf[i], q.py_qpdiv6);
    }
    nz8[k] = nz;
    idct8x8(dq, res);
    int* R = t8 == 2 ? R8Y : sel8 ? RY : nullptr;
    if (R)
      for (int i = 0; i < 64; ++i) {
        const int r = r0 + (i >> 3), c = c0 + (i & 7);
        R[(my * 16 + r) * W + mx * 16 + c] = clip255(pred[r * 16 + c] + res[i]);
      }
    for (int j = 0; j < 64; ++j) blocks8_o[(mb * 4 + k) * 64 + j] = lv8[k][kZig8[j]];
  } else if (tid >= 32 && tid < 40 && ackill) {
    int k = tid - 32;
    for (int i = 0; i < 16; ++i) clv[k >> 2][k & 3][i] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int bits = 0;
    for (int gi = 0; gi < 4; ++gi) {
      int gy = gi >> 1, gx = gi & 1;
      if (nzb[(2 * gy) * 4 + 2 * gx] | nzb[(2 * gy) * 4 + 2 * gx + 1]
          | nzb[(2 * gy + 1) * 4 + 2 * gx] | nzb[(2 * gy + 1) * 4 + 2 * gx + 1])
        bits |= 1 << gi;
    }
    const int bits8 = t8 ? nz8[0] | nz8[1] << 1 | nz8[2] << 2 | nz8[3] << 3 : 0;
    cbp_o[mb] = sel8 ? bits8 : bits;
    if (t8 == 1) t8_sel_o[mb] = sel8 ? 1 : 0;
    if (t8 == 2) cbp8_o[mb] = bits8;
  } else if (tid >= 32 && tid < 34) {  // chroma DC of channel ch
    const int ch = tid - 32;
    int a = cdc[ch][0], b = cdc[ch][1], c = cdc[ch][2], e = cdc[ch][3];
    int h[4] = {a + b + c + e, a - b + c - e, a + b - c - e, a - b - c + e};
    int l[4];
    if (lossless)                      // the samples, untransformed
      for (int i = 0; i < 4; ++i) l[i] = cdc[ch][i];
    else if (tr)                       // the trellis phase's cat 3
      for (int i = 0; i < 4; ++i) l[i] = tl3[ch][i];
    else
      for (int i = 0; i < 4; ++i) l[i] = quant(h[i], q.pc_mf_dc, q.pc_bias_dc);
    int gg[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                 l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    int nz = 0;
    for (int i = 0; i < 4; ++i) {
      cdcl[ch][i] = l[i];
      cdcr[ch][i] = dequant_2x2_dc(gg[i], q.pc_dmf0, q.pc_qpdiv6);
      for (int j = 0; j < 16; ++j) nz |= clv[ch][i][j] != 0;
    }
    cnz[ch] = nz;
  }
  __syncthreads();
  if (tid >= 32 && tid < 40) {
    int k = tid - 32, ch = k >> 2, blk = k & 3, by = blk >> 1, bx = blk & 1;
    int dq[16], res[16];
    if (lossless) {                    // the recon is the source
      for (int i = 0; i < 16; ++i) res[i] = clv[ch][blk][i];
      res[0] = cdc[ch][blk];
    } else if (cnz[ch]) {
      for (int i = 0; i < 16; ++i) dq[i] = dequant(clv[ch][blk][i], q.pc_dmf[i], q.pc_qpdiv6);
      dq[0] = cdcr[ch][blk];
      idct4x4(dq, res);
    } else {
      for (int i = 0; i < 16; ++i) res[i] = (cdcr[ch][blk] + 32) >> 6;
    }
    int* R = ch ? RV : RU;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        R[(my * 8 + 4 * by + r) * Wc + mx * 8 + 4 * bx + c] = clip255(pc[ch][o] + res[4 * r + c]);
      }
    chroma_dc_o[mb * 8 + ch * 4 + blk] = cdcl[ch][blk];
    for (int j = 0; j < 16; ++j)
      chroma_ac_o[mb * 128 + ch * 64 + blk * 16 + j] = clv[ch][blk][kZig4P[j]];
  }
}

// K6 / K22 without the trellis: 64 threads a CTA
template <int BP>
__global__ void __launch_bounds__(64) inter_mb_kernel(INTER_MB_PARAMS) {
  inter_mb_body<BP, false>(INTER_MB_ARGS);
}

// K6 / K22 with the trellis phase: 256 threads a CTA, their registers
// held to 64 so that an SM holds 4 CTAs
template <int BP>
__global__ void __launch_bounds__(256, 4)
    inter_mb_trellis_kernel(INTER_MB_PARAMS) {
  inter_mb_body<BP, true>(INTER_MB_ARGS);
}

// one MB a CTA: the trellis kernel given a table, else the 64-thread one
template <int BP, class... A>
void launch_inter(const int* trellis, int nmb, cudaStream_t s, A... a) {
  if (trellis)
    inter_mb_trellis_kernel<BP><<<nmb, 256, 0, s>>>(a...);
  else
    inter_mb_kernel<BP><<<nmb, 64, 0, s>>>(a...);
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

// K10 subpel_refine, K11 part_fullpel and K12 chroma_rerank: the
// sub-pel and partition motion search of a P frame (subme 2-5).
//
// K10 replaces x264_tpu/ops/me.py:217 subpel_refine_blocks and :291
// subpel_refine (refine_subpel, encoder/me.c:680); K11 :304
// partition_fullpel (the seeds of inter_p16x8 / p8x16 / p8x8,
// encoder/analyse.c:1222-1404); K12 :368 chroma_rerank (the b_chroma_me
// term, encoder/me.c:61-66). Plain twins:
// x264_tpu_torch/ops/me.py:subpel_refine_blocks_plain,
// partition_fullpel_plain, chroma_rerank_plain; wrappers of the same
// names without _plain.
//
// Design.
//   K10, a warp per block and four blocks to a 128-thread CTA, the
//   block shape (16x16, 16x8, 8x16 or 8x8) and the candidate set
//   template parameters, so that every index division is by a constant.
//   Every candidate of a block shares the full-pel start, so the warp
//   stages the (bh+3)x(bw+3) window of each of the four half-pel planes
//   (start taken as dynamic_slice takes it, ds_start) in its share of
//   shared memory, with no barrier beyond __syncwarp. Each lane owns one
//   8x4 pair of 4x4 blocks (its 32 source samples in registers) and
//   takes it for 32 / (pairs a block) candidates a round: the
//   prediction is (a + b + 1) >> 1 of the two planes the qpel phase
//   names (the hpel_ref0/1 tables as two 32-bit constants), the pair's
//   two Hadamard abs-sums are halved together (pixel.py:satd), and xor
//   shuffles over the lanes of a candidate sum its SATD; the lane that
//   holds it adds lam * mv bits. Candidates run dy outer, dx inner (9
//   half-pel ones at steps (2,), all 49 within +-3 at (2, 1)); the
//   winner is the warp's minimum of (cost << 32 | candidate), so the
//   first of equal costs wins, as argmin does. The partition layouts of
//   a P frame (16x8, 8x16, and 8x8 with P8x8) run in one launch
//   (subpel_refine_parts): their blocks on CTAs of their own, each CTA
//   taking its shape from its index.
//   K11, one 256-thread CTA per MB: the 22x22 window of the padded
//   reference around the clamped 16x16 full-pel winner and the 16x16
//   source in shared memory; the 49 offsets x 4 quadrants are SADs of 64
//   samples; then one thread per output (16x8 top / bottom, 8x16 left /
//   right as sums of two quadrants, and with P8x8 the quadrants) scans
//   the offsets oy outer, ox inner for the first minimum of
//   sad + lam * bits.
//   K12, one 128-thread CTA per MB: the candidates' phases differ per
//   MB, so the CTA fetches the luma prediction of the four outer diamond
//   points (mc_luma from global memory) and the 8x8 U / V predictions
//   of all five (mc_chroma) into shared memory; 120 threads take one
//   4x4 SATD block each (16 luma and 8 chroma per candidate; the centre's
//   luma SATD is K10's); one thread ranks the five in order with a
//   strict <. The returned cost is the luma SATD, as in x264_tpu.
//   Two references (--ref 2; x264_tpu's ref_sel, me.py:245-257, :328-331,
//   :403-408): each kernel takes a per-block (K10) or per-MB (K11, K12)
//   reference index and the stack of both references' planes (K10 / K12
//   the 8 half-pel planes, plane 4 * ref + p, and K12 the two padded
//   chroma planes of each channel; K11 the two padded luma planes). The
//   index only moves the base pointer a block reads from, so one launch
//   serves both references; a null index reads reference 0.
// What bounds them on the H100: operations, by the count (K10: the
// 4x4 Hadamards of every candidate and block; K11: the SADs of 49
// offsets; K12: 5 x 24 4x4 SATDs and the fetches an MB), the windows
// and sources being few bytes. K10's lanes are busy in every round but
// the last; the staging of the windows from global memory and the
// rounds' shared loads are what keep it above the count's time. K11
// and K12 keep one MB to a CTA with threads idle in their reduction
// steps.
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int PAD = 32, CPAD = 16;

// ---------------------------------------------------------------- K10
constexpr int SP_WARPS = 4, SP_NT = 32 * SP_WARPS;
// the qpel phase's two half-pel planes (kHpelRef0 / kHpelRef1), two bits
// a phase: a shift, where the phases of a warp's lanes differ
constexpr unsigned kRef0Bits = 0x54fe5454u, kRef1Bits = 0xbababa10u;

// the windows' ints of one warp: four (bh + 3) x (bw + 3) planes
template <int BH, int BW>
__host__ __device__ constexpr int sp_win() { return 4 * (BH + 3) * (BW + 3); }

// One block of K10 on one warp: the four plane windows (their start as
// dynamic_slice takes it) staged in the warp's shared ints `win`; each
// lane takes one 8x4 pair of the block (its source samples in registers)
// for CPR candidates a round, so a candidate's SATD is the sum over NP
// consecutive lanes (xor shuffles) of the pairs' halved Hadamard sums;
// the first minimum of (cost << 32 | candidate), candidates dy outer and
// dx inner, by a warp reduction. Writes mv_o[2 * o .. 2 * o + 1] and
// satd_o[o].
template <int BH, int BW, bool QPEL>
__device__ __forceinline__ void subpel_warp(
    const int* __restrict__ cur, const int* __restrict__ P, int H, int W,
    int by0, int bx0, int mvx, int mvy, int px, int py, int lam, int* win,
    int* csatd, int* __restrict__ mv_o, int* __restrict__ satd_o, int o) {
  constexpr int WY = BH + 3, WX = BW + 3, WN = WY * WX;
  constexpr int NCAND = QPEL ? 49 : 9, SIDE = QPEL ? 7 : 3, STEP = QPEL ? 1 : 2;
  constexpr int NP = (BH / 4) * (BW / 8), CPR = 32 / NP;
  constexpr int ROUNDS = (NCAND + CPR - 1) / CPR;
  const int lane = threadIdx.x & 31;
  const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
  const size_t plane = (size_t)Hp * Wp;
  const int y0 = ds_start(by0 + (mvy >> 2) - 1 + PAD, Hp, WY);
  const int x0 = ds_start(bx0 + (mvx >> 2) - 1 + PAD, Wp, WX);
#pragma unroll 4
  for (int i = lane; i < 4 * WN; i += 32) {
    const int p = i / WN, k = i - p * WN, r = k / WX, c = k - r * WX;
    win[i] = P[p * plane + (size_t)(y0 + r) * Wp + x0 + c];
  }
  // the lane's 8x4 pair of the source block
  const int pr = lane % NP;
  const int r0 = (pr / (BW / 8)) * 4, c0 = (pr % (BW / 8)) * 8;
  int src[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    src[i] = cur[(size_t)(by0 + r0 + (i >> 3)) * W + bx0 + c0 + (i & 7)];
  __syncwarp();
  unsigned long long best = ~0ull;
#pragma unroll 1
  for (int rd = 0; rd < ROUNDS; ++rd) {
    const int cand = rd * CPR + lane / NP;
    const int cc = min(cand, NCAND - 1);      // past the last: a duplicate
    const int ox = (cc % SIDE - SIDE / 2) * STEP;
    const int oy = (cc / SIDE - SIDE / 2) * STEP;
    const int fx = ox & 3, fy = oy & 3, q = (fy << 2) | fx;
    const int* pa = win + (int)((kRef0Bits >> (2 * q)) & 3u) * WN
                  + (1 + (oy >> 2) + (fy == 3) + r0) * WX + 1 + (ox >> 2) + c0;
    const int* pb = win + (int)((kRef1Bits >> (2 * q)) & 3u) * WN
                  + (1 + (oy >> 2) + r0) * WX + 1 + (ox >> 2) + (fx == 3) + c0;
    int sh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int d[16];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int at = r * WX + 4 * h + c;
          d[4 * r + c] = src[8 * r + 4 * h + c] - ((pa[at] + pb[at] + 1) >> 1);
        }
      sh[h] = abs_had4x4(d);
    }
    int satd = (sh[0] + sh[1]) >> 1;
#pragma unroll
    for (int off = NP / 2; off >= 1; off >>= 1)
      satd += __shfl_xor_sync(0xffffffffu, satd, off);
    if (pr == 0 && cand < NCAND) {
      csatd[cand] = satd;
      const int cost = satd + lam * (se_bits(mvx + ox - px) + se_bits(mvy + oy - py));
      const unsigned long long key =
          ((unsigned long long)(unsigned)cost << 32) | (unsigned)cand;
      best = key < best ? key : best;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
    best = other < best ? other : best;
  }
  __syncwarp();
  if (lane == 0) {
    const int cand = (int)(best & 0xffffffffu);
    mv_o[2 * o] = mvx + (cand % SIDE - SIDE / 2) * STEP;
    mv_o[2 * o + 1] = mvy + (cand / SIDE - SIDE / 2) * STEP;
    satd_o[o] = csatd[cand];
  }
}

// K10 on n blocks of one shape at top-left (ys, xs), a warp a block
template <int BH, int BW, bool QPEL>
__global__ void __launch_bounds__(SP_NT) subpel_kernel(
    const int* __restrict__ cur, const int* __restrict__ planes,
    const int* __restrict__ mv, const int* __restrict__ mvp,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const int* __restrict__ ref_sel, int* __restrict__ mv_o,
    int* __restrict__ satd_o, int n, int H, int W, int lam) {
  __shared__ int win[SP_WARPS][sp_win<BH, BW>()];
  __shared__ int csatd[SP_WARPS][49];
  const int w = threadIdx.x >> 5, b = blockIdx.x * SP_WARPS + w;
  if (b >= n) return;
  const size_t plane = (size_t)(H + 2 * PAD) * (W + 2 * PAD);
  const int* P = planes + (ref_sel ? 4 * ref_sel[b] * plane : 0);
  subpel_warp<BH, BW, QPEL>(cur, P, H, W, ys[b], xs[b], mv[2 * b],
                            mv[2 * b + 1], mvp[2 * b], mvp[2 * b + 1], lam,
                            win[w], csatd[w], mv_o, satd_o, b);
}

// K10 on the partition layouts of a P frame in one launch: the rows of
// partition_fullpel's result (0-1 16x8 top / bottom, 2-3 8x16 left /
// right, 4-7 the 8x8 quadrants; nk 4 or 8 rows), block k = row * nmb +
// mb, each layout's blocks on CTAs of their own, a CTA's shape chosen
// from its index; every block of an MB takes the MB's predictor and
// reference
template <bool QPEL>
__global__ void __launch_bounds__(SP_NT) subpel_parts_kernel(
    const int* __restrict__ cur, const int* __restrict__ planes,
    const int* __restrict__ mv, const int* __restrict__ mvp,
    const int* __restrict__ ref_sel, int* __restrict__ mv_o,
    int* __restrict__ satd_o, int mb_h, int mb_w, int nk, int lam) {
  __shared__ int win[SP_WARPS][sp_win<8, 16>()];
  __shared__ int csatd[SP_WARPS][49];
  const int nmb = mb_h * mb_w, w = threadIdx.x >> 5;
  const int c2 = (2 * nmb + SP_WARPS - 1) / SP_WARPS;   // CTAs of a 2-row layout
  const int layout = min((int)blockIdx.x / c2, 2);
  const int k = 2 * layout * nmb + ((int)blockIdx.x - layout * c2) * SP_WARPS + w;
  if (k >= (layout < 2 ? 2 * layout + 2 : nk) * nmb) return;
  const int row = k / nmb, mb = k - row * nmb;
  const int H = mb_h * 16, W = mb_w * 16;
  const size_t plane = (size_t)(H + 2 * PAD) * (W + 2 * PAD);
  const int* P = planes + (ref_sel ? 4 * ref_sel[mb] * plane : 0);
  const int by = (mb / mb_w) * 16, bx = (mb % mb_w) * 16;
  const int mvx = mv[2 * k], mvy = mv[2 * k + 1];
  const int px = mvp[2 * mb], py = mvp[2 * mb + 1];
  if (layout == 0)
    subpel_warp<8, 16, QPEL>(cur, P, H, W, by + 8 * row, bx, mvx, mvy, px,
                             py, lam, win[w], csatd[w], mv_o, satd_o, k);
  else if (layout == 1)
    subpel_warp<16, 8, QPEL>(cur, P, H, W, by, bx + 8 * (row - 2), mvx, mvy,
                             px, py, lam, win[w], csatd[w], mv_o, satd_o, k);
  else
    subpel_warp<8, 8, QPEL>(cur, P, H, W, by + 8 * ((row - 4) >> 1),
                            bx + 8 * (row & 1), mvx, mvy, px, py, lam, win[w],
                            csatd[w], mv_o, satd_o, k);
}

// ---------------------------------------------------------------- K11
constexpr int PF_NT = 256;
constexpr int PF_M = 3, PF_N = 2 * PF_M + 1, PF_W = 16 + 2 * PF_M;

__global__ void __launch_bounds__(PF_NT) part_kernel(
    const int* __restrict__ cur, const int* __restrict__ ref_pad,
    const int* __restrict__ mv16, const int* __restrict__ mvp,
    const int* __restrict__ ref_sel, int* __restrict__ out, int mb_h,
    int mb_w, int R, int pad, int lam, int nk) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w, tid = threadIdx.x;
  const int nmb = mb_h * mb_w;
  const int W = mb_w * 16, Hp = mb_h * 16 + 2 * pad, Wp = W + 2 * pad;
  const int* ref = ref_pad + (ref_sel ? (size_t)ref_sel[mb] * Hp * Wp : 0);
  const int lim = min(R, pad - PF_M - 1);
  const int cx = min(max(mv16[2 * mb] >> 2, -lim), lim);
  const int cy = min(max(mv16[2 * mb + 1] >> 2, -lim), lim);
  const int px = mvp[2 * mb], py = mvp[2 * mb + 1];

  __shared__ int win[PF_W * PF_W];
  __shared__ int cb[256];
  __shared__ int qs[PF_N * PF_N][4];

  const int y0 = ds_start(my * 16 + cy - PF_M + pad, Hp, PF_W);
  const int x0 = ds_start(mx * 16 + cx - PF_M + pad, Wp, PF_W);
  for (int i = tid; i < PF_W * PF_W; i += PF_NT)
    win[i] = ref[(size_t)(y0 + i / PF_W) * Wp + x0 + i % PF_W];
  for (int i = tid; i < 256; i += PF_NT)
    cb[i] = cur[(size_t)(my * 16 + (i >> 4)) * W + mx * 16 + (i & 15)];
  __syncthreads();
  for (int k = tid; k < PF_N * PF_N * 4; k += PF_NT) {
    const int off = k >> 2, q = k & 3, oy = off / PF_N, ox = off % PF_N;
    const int qy = (q >> 1) * 8, qx = (q & 1) * 8;
    int s = 0;
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        s += abs(cb[(qy + r) * 16 + qx + c] - win[(oy + qy + r) * PF_W + ox + qx + c]);
    qs[off][q] = s;
  }
  __syncthreads();
  if (tid < nk) {       // t, b, l, r, then the quadrants q0-q3
    int best = 0, best_cost = 0;
    for (int off = 0; off < PF_N * PF_N; ++off) {
      const int* s = qs[off];
      const int sum = tid == 0 ? s[0] + s[1] : tid == 1 ? s[2] + s[3]
                    : tid == 2 ? s[0] + s[2] : tid == 3 ? s[1] + s[3] : s[tid - 4];
      const int mvx = 4 * (cx + off % PF_N - PF_M), mvy = 4 * (cy + off / PF_N - PF_M);
      const int cost = sum + lam * (se_bits(mvx - px) + se_bits(mvy - py));
      if (off == 0 || cost < best_cost) { best = off; best_cost = cost; }
    }
    out[(tid * nmb + mb) * 2] = 4 * (cx + best % PF_N - PF_M);
    out[(tid * nmb + mb) * 2 + 1] = 4 * (cy + best / PF_N - PF_M);
  }
}

// ---------------------------------------------------------------- K12
constexpr int CR_NT = 128;
__constant__ int kDiamond[5][2] = {{0, 0}, {-1, 0}, {1, 0}, {0, -1}, {0, 1}};

__global__ void __launch_bounds__(CR_NT) rerank_kernel(
    const int* __restrict__ cur, const int* __restrict__ planes,
    const int* __restrict__ cur_u, const int* __restrict__ cur_v,
    const int* __restrict__ cu_pad, const int* __restrict__ cv_pad,
    const int* __restrict__ mv, const int* __restrict__ mvp,
    const int* __restrict__ center_satd, const int* __restrict__ ref_sel,
    int* __restrict__ mv_o, int* __restrict__ satd_o, int mb_h, int mb_w,
    int lam) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w, tid = threadIdx.x;
  const int W = mb_w * 16, Wc = mb_w * 8;
  const int Hp = mb_h * 16 + 2 * PAD, Wp = W + 2 * PAD;
  const int Hcp = mb_h * 8 + 2 * CPAD, Wcp = Wc + 2 * CPAD;
  const size_t plane = (size_t)Hp * Wp;
  const int rs = ref_sel ? ref_sel[mb] : 0;
  const int* P = planes + 4 * rs * plane;
  const int* CU = cu_pad + (size_t)rs * Hcp * Wcp;
  const int* CV = cv_pad + (size_t)rs * Hcp * Wcp;
  const int mvx0 = mv[2 * mb], mvy0 = mv[2 * mb + 1];

  __shared__ int pl[5][256];       // luma predictions (0: unused)
  __shared__ int pc[5][2][64];     // U / V predictions
  __shared__ int cb[256], cc[2][64];
  __shared__ int s44[5][24];

  for (int i = tid; i < 4 * 256; i += CR_NT) {
    const int cand = 1 + (i >> 8), k = i & 255, r = k >> 4, c = k & 15;
    const int mvx = mvx0 + kDiamond[cand][0], mvy = mvy0 + kDiamond[cand][1];
    const int fx = mvx & 3, fy = mvy & 3, q = (fy << 2) | fx;
    const int iy = my * 16 + (mvy >> 2) + PAD, ix = mx * 16 + (mvx >> 2) + PAD;
    const int ya = ds_start(iy + (fy == 3), Hp, 16), xa = ds_start(ix, Wp, 16);
    const int yb = ds_start(iy, Hp, 16), xb = ds_start(ix + (fx == 3), Wp, 16);
    const int a = P[kHpelRef0[q] * plane + (size_t)(ya + r) * Wp + xa + c];
    const int b = P[kHpelRef1[q] * plane + (size_t)(yb + r) * Wp + xb + c];
    pl[cand][k] = (a + b + 1) >> 1;
  }
  for (int i = tid; i < 5 * 128; i += CR_NT) {
    const int cand = i >> 7, ch = (i >> 6) & 1, k = i & 63, r = k >> 3, c = k & 7;
    const int mvx = mvx0 + kDiamond[cand][0], mvy = mvy0 + kDiamond[cand][1];
    const int dx = mvx & 7, dy = mvy & 7;
    const int y0 = ds_start(my * 8 + (mvy >> 3) + CPAD, Hcp, 9);
    const int x0 = ds_start(mx * 8 + (mvx >> 3) + CPAD, Wcp, 9);
    const int* s = (ch ? CV : CU) + (size_t)(y0 + r) * Wcp + x0 + c;
    pc[cand][ch][k] = ((8 - dx) * (8 - dy) * s[0] + dx * (8 - dy) * s[1]
                       + (8 - dx) * dy * s[Wcp] + dx * dy * s[Wcp + 1] + 32) >> 6;
  }
  for (int i = tid; i < 256; i += CR_NT)
    cb[i] = cur[(size_t)(my * 16 + (i >> 4)) * W + mx * 16 + (i & 15)];
  for (int i = tid; i < 128; i += CR_NT)
    cc[i >> 6][i & 63] = (i >> 6 ? cur_v : cur_u)[(size_t)(my * 8 + ((i & 63) >> 3)) * Wc
                                                  + mx * 8 + (i & 7)];
  __syncthreads();
  if (tid < 5 * 24) {
    const int cand = tid / 24, b = tid % 24;
    int d[16];
    if (b < 16) {
      if (cand == 0) {
        s44[0][b] = 0;                 // the centre reuses K10's SATD
      } else {
        const int r0 = (b >> 2) * 4, c0 = (b & 3) * 4;
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c)
            d[4 * r + c] = cb[(r0 + r) * 16 + c0 + c] - pl[cand][(r0 + r) * 16 + c0 + c];
        s44[cand][b] = abs_had4x4(d);
      }
    } else {
      const int ch = (b - 16) >> 2, blk = (b - 16) & 3;
      const int r0 = (blk >> 1) * 4, c0 = (blk & 1) * 4;
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          d[4 * r + c] = cc[ch][(r0 + r) * 8 + c0 + c] - pc[cand][ch][(r0 + r) * 8 + c0 + c];
      s44[cand][b] = abs_had4x4(d);
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int px = mvp[2 * mb], py = mvp[2 * mb + 1];
    int best_cost = 0, best_l = 0, bx = mvx0, by = mvy0;
    for (int cand = 0; cand < 5; ++cand) {
      const int* s = s44[cand];
      int l = 0;
      if (cand == 0) {
        l = center_satd[mb];
      } else {
        for (int b = 0; b < 16; b += 2) l += (s[b] + s[b + 1]) >> 1;
      }
      int c = 0;
      for (int b = 16; b < 24; b += 2) c += (s[b] + s[b + 1]) >> 1;
      const int mvx = mvx0 + kDiamond[cand][0], mvy = mvy0 + kDiamond[cand][1];
      const int cost = l + c + lam * (se_bits(mvx - px) + se_bits(mvy - py));
      if (cand == 0 || cost < best_cost) {
        best_cost = cost; best_l = l; bx = mvx; by = mvy;
      }
    }
    mv_o[2 * mb] = bx;
    mv_o[2 * mb + 1] = by;
    satd_o[mb] = best_l;
  }
}

template <int BH, int BW, bool QPEL>
void launch_subpel(cudaStream_t s, const int* cur, const int* planes,
                   const int* mv, const int* mvp, const int* ys, const int* xs,
                   const int* ref_sel, int* mv_o, int* satd_o, int n, int H,
                   int W, int lam) {
  subpel_kernel<BH, BW, QPEL><<<(n + SP_WARPS - 1) / SP_WARPS, SP_NT, 0, s>>>(
      cur, planes, mv, mvp, ys, xs, ref_sel, mv_o, satd_o, n, H, W, lam);
}

template <bool QPEL>
int subpel_shape(cudaStream_t s, int bh, int bw, const int* cur,
                 const int* planes, const int* mv, const int* mvp,
                 const int* ys, const int* xs, const int* ref_sel, int* mv_o,
                 int* satd_o, int n, int H, int W, int lam) {
  if (bh == 16 && bw == 16)
    launch_subpel<16, 16, QPEL>(s, cur, planes, mv, mvp, ys, xs, ref_sel, mv_o, satd_o, n, H, W, lam);
  else if (bh == 8 && bw == 16)
    launch_subpel<8, 16, QPEL>(s, cur, planes, mv, mvp, ys, xs, ref_sel, mv_o, satd_o, n, H, W, lam);
  else if (bh == 16 && bw == 8)
    launch_subpel<16, 8, QPEL>(s, cur, planes, mv, mvp, ys, xs, ref_sel, mv_o, satd_o, n, H, W, lam);
  else if (bh == 8 && bw == 8)
    launch_subpel<8, 8, QPEL>(s, cur, planes, mv, mvp, ys, xs, ref_sel, mv_o, satd_o, n, H, W, lam);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// ref_sel (K10: one per block, or per MB for the partition layouts; K11,
// K12: one per MB) may be null: one reference
extern "C" int subpel_refine(const int* cur, const int* planes, const int* mv,
                             const int* mvp, const int* ys, const int* xs,
                             const int* ref_sel, int* mv_o, int* satd_o,
                             int n, int H, int W, int bh, int bw, int lam,
                             int qpel, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = qpel ? subpel_shape<true>(s, bh, bw, cur, planes, mv, mvp, ys, xs,
                                            ref_sel, mv_o, satd_o, n, H, W, lam)
                       : subpel_shape<false>(s, bh, bw, cur, planes, mv, mvp, ys, xs,
                                             ref_sel, mv_o, satd_o, n, H, W, lam);
  return err ? err : (int)cudaGetLastError();
}

// the 16x8, 8x16 and (nk 8) 8x8 layouts in one launch: mv (nk, mb_h,
// mb_w, 2) partition_fullpel's rows, mvp and ref_sel per MB; mv_o / satd_o
// as mv / its first three axes
extern "C" int subpel_refine_parts(const int* cur, const int* planes,
                                   const int* mv, const int* mvp,
                                   const int* ref_sel, int* mv_o, int* satd_o,
                                   int mb_h, int mb_w, int nk, int lam,
                                   int qpel, void* stream) {
  if (nk != 4 && nk != 8) return (int)cudaErrorInvalidValue;
  const int nmb = mb_h * mb_w, c2 = (2 * nmb + SP_WARPS - 1) / SP_WARPS;
  const int grid = 2 * c2 + (nk == 8 ? (4 * nmb + SP_WARPS - 1) / SP_WARPS : 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (qpel)
    subpel_parts_kernel<true><<<grid, SP_NT, 0, s>>>(
        cur, planes, mv, mvp, ref_sel, mv_o, satd_o, mb_h, mb_w, nk, lam);
  else
    subpel_parts_kernel<false><<<grid, SP_NT, 0, s>>>(
        cur, planes, mv, mvp, ref_sel, mv_o, satd_o, mb_h, mb_w, nk, lam);
  return (int)cudaGetLastError();
}

extern "C" int part_fullpel(const int* cur, const int* ref_pad,
                            const int* mv16, const int* mvp,
                            const int* ref_sel, int* out, int mb_h, int mb_w,
                            int me_range, int pad, int lam, int nk,
                            void* stream) {
  if (nk != 4 && nk != 8) return (int)cudaErrorInvalidValue;
  part_kernel<<<mb_h * mb_w, PF_NT, 0, (cudaStream_t)stream>>>(
      cur, ref_pad, mv16, mvp, ref_sel, out, mb_h, mb_w, me_range, pad, lam,
      nk);
  return (int)cudaGetLastError();
}

extern "C" int chroma_rerank(const int* cur, const int* planes,
                             const int* cur_u, const int* cur_v,
                             const int* cu_pad, const int* cv_pad,
                             const int* mv, const int* mvp,
                             const int* center_satd, const int* ref_sel,
                             int* mv_o, int* satd_o, int mb_h, int mb_w,
                             int lam, void* stream) {
  rerank_kernel<<<mb_h * mb_w, CR_NT, 0, (cudaStream_t)stream>>>(
      cur, planes, cur_u, cur_v, cu_pad, cv_pad, mv, mvp, center_satd,
      ref_sel, mv_o, satd_o, mb_h, mb_w, lam);
  return (int)cudaGetLastError();
}

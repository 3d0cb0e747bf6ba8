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
//   K10, one 128-thread CTA per block (16x16, 16x8, 8x16 or 8x8; one
//   launch per batch of blocks). Every candidate of a block shares the
//   full-pel start, so the CTA stages the (bh+3)x(bw+3) window of each
//   of the four half-pel planes (start taken as dynamic_slice takes it,
//   ds_start) and the source block in shared memory. The work items are
//   (candidate, 4x4 block) pairs: the prediction is (a + b + 1) >> 1 of
//   the two planes the qpel phase names (the hpel_ref0/1 tables), and
//   each item stores its 4x4 Hadamard abs-sum. One thread per candidate
//   then halves the sums per 8x4 pair (per 4x4 block for 4-wide shapes,
//   pixel.py:satd) and adds lam * mv bits. Candidates run dy outer, dx
//   inner (9 half-pel ones at steps (2,), all 49 within +-3 at (2, 1));
//   the winner is the minimum of (cost << 32 | candidate), so the first
//   of equal costs wins, as argmin does.
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
// What bounds them on the H100, at 1080p (8160 MBs): operations.
//   K10 at (2, 1) on 16x16 blocks: 49 x 16 4x4 blocks of ~180 integer
//   ops per MB, 1.15 G ops (~17 us at the ALU rate) against ~13 MB of
//   window, source and MV traffic (~4 us); the partition calls do the
//   same work over their blocks. K11: 49 x 256 samples x 3 ops per MB,
//   0.31 G ops (~4.6 us). K12: 5 x 24 4x4 SATDs and the fetches per MB,
//   ~0.2 G ops (~3 us). One block per CTA leaves most threads idle in
//   the reduction phases; a later PR can batch blocks per CTA.
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int PAD = 32, CPAD = 16;

// ---------------------------------------------------------------- K10
constexpr int SP_NT = 128;
constexpr int SP_MAXW = 19;                      // bh + 3 at most

__global__ void __launch_bounds__(SP_NT) subpel_kernel(
    const int* __restrict__ cur, const int* __restrict__ planes,
    const int* __restrict__ mv, const int* __restrict__ mvp,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const int* __restrict__ ref_sel, int* __restrict__ mv_o,
    int* __restrict__ satd_o, int H, int W, int bh, int bw, int lam,
    int qpel) {
  const int n = blockIdx.x, tid = threadIdx.x;
  const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
  const size_t plane = (size_t)Hp * Wp;
  const int* P = planes + (ref_sel ? 4 * ref_sel[n] * plane : 0);
  const int wy = bh + 3, wx = bw + 3;
  const int by0 = ys[n], bx0 = xs[n];
  const int mvx = mv[2 * n], mvy = mv[2 * n + 1];
  const int px = mvp[2 * n], py = mvp[2 * n + 1];
  const int ncand = qpel ? 49 : 9, side = qpel ? 7 : 3;
  const int b4w = bw / 4, nb4 = (bh / 4) * b4w;

  __shared__ int win[4][SP_MAXW * SP_MAXW];
  __shared__ int cb[256];
  __shared__ int s44[49 * 16];
  __shared__ unsigned long long best;
  __shared__ int csatd[49];

  const int y0 = ds_start(by0 + (mvy >> 2) - 1 + PAD, Hp, wy);
  const int x0 = ds_start(bx0 + (mvx >> 2) - 1 + PAD, Wp, wx);
  for (int i = tid; i < 4 * wy * wx; i += SP_NT) {
    const int p = i / (wy * wx), k = i % (wy * wx), r = k / wx, c = k % wx;
    win[p][k] = P[p * plane + (size_t)(y0 + r) * Wp + x0 + c];
  }
  for (int i = tid; i < bh * bw; i += SP_NT)
    cb[i] = cur[(size_t)(by0 + i / bw) * W + bx0 + i % bw];
  if (tid == 0) best = ~0ull;
  __syncthreads();

  for (int k = tid; k < ncand * nb4; k += SP_NT) {
    const int cand = k / nb4, b = k % nb4;
    const int step = qpel ? 1 : 2;
    const int ox = (cand % side - side / 2) * step;
    const int oy = (cand / side - side / 2) * step;
    const int fx = ox & 3, fy = oy & 3, q = (fy << 2) | fx;
    const int* pa = win[kHpelRef0[q]];
    const int* pb = win[kHpelRef1[q]];
    const int ay = 1 + (oy >> 2) + (fy == 3), ax = 1 + (ox >> 2);
    const int byy = 1 + (oy >> 2), bxx = 1 + (ox >> 2) + (fx == 3);
    const int r0 = (b / b4w) * 4, c0 = (b % b4w) * 4;
    int d[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        const int rr = r0 + r, cc = c0 + c;
        const int pred = (pa[(ay + rr) * wx + ax + cc] + pb[(byy + rr) * wx + bxx + cc] + 1) >> 1;
        d[4 * r + c] = cb[rr * bw + cc] - pred;
      }
    s44[cand * 16 + b] = abs_had4x4(d);
  }
  __syncthreads();
  if (tid < ncand) {
    const int cand = tid;
    const int step = qpel ? 1 : 2;
    const int ox = (cand % side - side / 2) * step;
    const int oy = (cand / side - side / 2) * step;
    const int* s = s44 + cand * 16;
    int satd = 0;
    if (b4w % 2 == 0) {
      for (int b = 0; b < nb4; b += 2) satd += (s[b] + s[b + 1]) >> 1;
    } else {
      for (int b = 0; b < nb4; ++b) satd += s[b] >> 1;
    }
    csatd[cand] = satd;
    const int cost = satd + lam * (se_bits(mvx + ox - px) + se_bits(mvy + oy - py));
    atomicMin(&best, ((unsigned long long)(unsigned)cost << 32) | (unsigned)cand);
  }
  __syncthreads();
  if (tid == 0) {
    const int cand = (int)(best & 0xffffffffu);
    const int step = qpel ? 1 : 2;
    mv_o[2 * n] = mvx + (cand % side - side / 2) * step;
    mv_o[2 * n + 1] = mvy + (cand / side - side / 2) * step;
    satd_o[n] = csatd[cand];
  }
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

}  // namespace

// ref_sel (K10: one per block; K11, K12: one per MB) may be null: one
// reference
extern "C" int subpel_refine(const int* cur, const int* planes, const int* mv,
                             const int* mvp, const int* ys, const int* xs,
                             const int* ref_sel, int* mv_o, int* satd_o,
                             int n, int H, int W, int bh, int bw, int lam,
                             int qpel, void* stream) {
  if (bh + 3 > SP_MAXW || bw + 3 > SP_MAXW || bh * bw > 256)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  subpel_kernel<<<n, SP_NT, 0, (cudaStream_t)stream>>>(
      cur, planes, mv, mvp, ys, xs, ref_sel, mv_o, satd_o, H, W, bh, bw, lam,
      qpel);
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

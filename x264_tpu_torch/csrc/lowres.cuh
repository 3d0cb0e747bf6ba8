// The lowres block costs of the lookahead, shared by K15 lowres_cost
// (lookahead.cu) and K21 lowres_bcost (badapt.cu): one 128-thread CTA per
// 8x8 lowres block (x264_tpu/encoder/lookahead.py:intra_cost_plane,
// inter_cost_plane; slicetype.c:43-256).
//
// The CTA stages its block and its top / left neighbours; the intra cost
// is the least of the DC / V / H SATDs (12 threads take the 4x4
// Hadamards) + 5. The inter cost against one reference's four phase
// planes: the (8 + 2r)^2 window of plane 0 (rows and columns clamped into
// the plane, which is what _pad8 and the edge pad of r make of it) in
// shared memory, each thread scoring every 128th full-pel candidate in
// x264_tpu's order (dy outer, dx inner) and keeping the least (cost << 32
// | index), so the first index wins ties as argmin does; a shared-memory
// reduction finds the winner; 36 threads take the 9 half-pel candidates'
// 4x4 Hadamards from the 9x9 window of the four planes, whose start is
// dynamic_slice's (ds_start: negative counted from the end once, then
// clamped; ROADMAP's reproduced wrap), and thread 0 keeps the first of
// the least in oy-outer, ox-inner order.
#pragma once
#include "common.cuh"

namespace x264t {
namespace lowres {

constexpr int NT = 128;
constexpr int MAX_R = 12;            // the lookahead range is 4..12
constexpr int MAX_WIN = 8 + 2 * MAX_R;
constexpr int INTRA_PENALTY = 5, NONZERO_MV_PENALTY = 5;
constexpr int BIG = 1 << 28;

// SATD of an 8x8 block from its four 4x4 Hadamard abs-sums (raster
// order): halved per 8x4 pair (pixel.py:satd)
__device__ __forceinline__ int satd8(const int* s) {
  return ((s[0] + s[1]) >> 1) + ((s[2] + s[3]) >> 1);
}

// a lowres plane's sample, clamped into the plane
__device__ __forceinline__ int low(const int* P, int h2, int w2, int y, int x) {
  return P[min(max(y, 0), h2 - 1) * w2 + min(max(x, 0), w2 - 1)];
}

struct Shared {
  int c[64], top[8], left[8], dc;
  int win[MAX_WIN * MAX_WIN];
  int hwin[4][81];
  int had[36];
  unsigned long long best[NT];
  int icost, cost, mvx, mvy;         // results (mv in half-pel units)
};

// stage block (by, bx) of plane 0 `cur` and its neighbours (all threads)
__device__ __forceinline__ void load_block(Shared& S, const int* cur, int h2,
                                           int w2, int by, int bx) {
  const int tid = threadIdx.x;
  if (tid < 64) S.c[tid] = low(cur, h2, w2, 8 * by + (tid >> 3), 8 * bx + (tid & 7));
  else if (tid < 72) S.top[tid - 64] = low(cur, h2, w2, 8 * by - 1, 8 * bx + tid - 64);
  else if (tid < 80) S.left[tid - 72] = low(cur, h2, w2, 8 * by + tid - 72, 8 * bx - 1);
  __syncthreads();
}

// the intra cost into S.icost (all threads)
__device__ __forceinline__ void intra_cost(Shared& S, bool has_top,
                                           bool has_left) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    int ts = 0, ls = 0;
    for (int i = 0; i < 8; ++i) { ts += S.top[i]; ls += S.left[i]; }
    S.dc = has_top && has_left ? (ts + ls + 8) >> 4
         : has_top ? (ts + 4) >> 3 : has_left ? (ls + 4) >> 3 : 128;
  }
  __syncthreads();
  if (tid < 12) {                      // mode (DC, V, H) x 4x4 block
    const int m = tid >> 2, sb = tid & 3, y0 = 4 * (sb >> 1), x0 = 4 * (sb & 1);
    int d[16];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int p = m == 0 ? S.dc : m == 1 ? S.top[x0 + j] : S.left[y0 + i];
        d[4 * i + j] = S.c[(y0 + i) * 8 + x0 + j] - p;
      }
    S.had[tid] = abs_had4x4(d);
  }
  __syncthreads();
  if (tid == 0) {
    const int s_dc = satd8(S.had), s_v = has_top ? satd8(S.had + 4) : BIG;
    const int s_h = has_left ? satd8(S.had + 8) : BIG;
    S.icost = min(s_dc, min(s_v, s_h)) + INTRA_PENALTY;
  }
  __syncthreads();
}

// the inter cost of the staged block against the four phase planes
// `ref` into S.cost, S.mvx, S.mvy (all threads)
__device__ __forceinline__ void inter_cost(Shared& S, const int* ref, int h2,
                                           int w2, int bh, int bw, int r,
                                           int by, int bx) {
  const int tid = threadIdx.x, n = 2 * r + 1, ws = 8 + 2 * r;
  for (int i = tid; i < ws * ws; i += NT)
    S.win[i] = low(ref, h2, w2, 8 * by - r + i / ws, 8 * bx - r + i % ws);
  __syncthreads();
  // the dense full-pel search: candidate k = (dy + r) * n + (dx + r)
  unsigned long long mine = ~0ull;
  for (int k = tid; k < n * n; k += NT) {
    const int dy = k / n - r, dx = k % n - r;
    int sad = 0;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        sad += abs(S.c[8 * i + j] - S.win[(i + dy + r) * ws + j + dx + r]);
    const int cost = sad + se_bits(dx) + se_bits(dy) - 2
                   + ((dx | dy) != 0 ? NONZERO_MV_PENALTY : 0);
    const unsigned long long key = ((unsigned long long)cost << 32) | (unsigned)k;
    mine = key < mine ? key : mine;
  }
  S.best[tid] = mine;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s && S.best[tid + s] < S.best[tid]) S.best[tid] = S.best[tid + s];
    __syncthreads();
  }
  const int kb = (int)(S.best[0] & 0xffffffffu);
  const int mvx = kb % n - r, mvy = kb / n - r;
  const int pen = se_bits(mvx) + se_bits(mvy) - 2
                + ((mvx | mvy) != 0 ? NONZERO_MV_PENALTY : 0);
  // the 9x9 half-pel window of the four planes, in the padded frame of
  // inter_cost_plane (rows -r .. bh*8 + r), started as dynamic_slice
  const int sy = ds_start(8 * by + mvy - 1 + r, bh * 8 + 2 * r, 9);
  const int sx = ds_start(8 * bx + mvx - 1 + r, bw * 8 + 2 * r, 9);
  for (int i = tid; i < 4 * 81; i += NT) {
    const int p = i / 81, a = (i % 81) / 9, b = i % 9;
    S.hwin[p][a * 9 + b] = low(ref + p * h2 * w2, h2, w2, sy + a - r, sx + b - r);
  }
  __syncthreads();
  if (tid < 36) {
    const int cand = tid >> 2, sb = tid & 3;
    const int oy = cand / 3 - 1, ox = cand % 3 - 1;
    const int plane = (oy & 1) * 2 + (ox & 1);
    const int r0 = (oy >> 1) + 1 + 4 * (sb >> 1), c0 = (ox >> 1) + 1 + 4 * (sb & 1);
    int d[16];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        d[4 * i + j] = S.c[(4 * (sb >> 1) + i) * 8 + 4 * (sb & 1) + j]
                     - S.hwin[plane][(r0 + i) * 9 + c0 + j];
    S.had[tid] = abs_had4x4(d);
  }
  __syncthreads();
  if (tid == 0) {
    int bc = 0, bmx = 0, bmy = 0;
    for (int cand = 0; cand < 9; ++cand) {
      const int cost = satd8(S.had + 4 * cand) + pen;
      if (cand == 0 || cost < bc) {
        bc = cost;
        bmx = 2 * mvx + cand % 3 - 1;
        bmy = 2 * mvy + cand / 3 - 1;
      }
    }
    S.cost = bc;
    S.mvx = bmx;
    S.mvy = bmy;
  }
  __syncthreads();
}

}  // namespace lowres
}  // namespace x264t

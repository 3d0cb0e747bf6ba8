// K14 lowres_planes and K15 lowres_cost: the scenecut lookahead.
//
// K14 replaces x264_tpu/encoder/lookahead.py:lowres_planes (:58): the four
// phase-shifted half-resolution planes of a frame's luma
// (x264_frame_init_lowres, common/mc.c:306-357), plane 2*pv+ph averaging
// the full-resolution 2x2 at (2i+pv, 2j+ph) of the luma edge-padded by
// one. K15 replaces intra_cost_plane (:85), inter_cost_plane (:122),
// frame_costs_fused (:199) and analyse_fused (:216): per 8x8 lowres
// block the intra cost (min of the DC / H / V SATD, + 5) and, against
// the previous frame's planes, the inter cost (a dense (2r+1)^2
// full-pel SAD search with the se_bits - 2 + 5 * (mv != 0) penalty, then
// the 3x3 half-pel SATD re-score through the phase planes), and the two
// interior sums the scenecut rule reads (slicetype.c:243-247). Plain
// twins and wrappers: x264_tpu_torch/encoder/lookahead.py.
//
// Design. K14: one thread per output sample of the four planes, reading
// the first h & ~1 rows of the luma the encoder already uploaded.
// K15: one 128-thread CTA per 8x8 lowres block (68 x 120 at 1080p). The
// CTA stages its block and the (8 + 2r)^2 reference window (rows and
// columns clamped into the plane, which is what _pad8 and the edge pad
// of r make of it) in shared memory; each thread scores every 128th
// candidate in x264_tpu's order (dy outer, dx inner) and keeps the least
// (cost << 32 | index), so the first index wins ties as argmin does; a
// shared-memory reduction finds the block's winner. 36 threads then take
// the 9 half-pel candidates' 4x4 Hadamards from the 9x9 window of the
// four planes, whose start is dynamic_slice's (negative counted from the
// end once, then clamped: common.cuh:ds_start), and thread 0 keeps the
// first of the least in oy-outer, ox-inner order. Intra: 12 threads take
// the DC / V / H 4x4 Hadamards. The block costs go to icost / pcost, and
// the interior blocks' icost and min(pcost, icost) into the two sums by
// integer atomics, which are order-free; the host reads those 8 bytes.
// What bounds it on the H100: operations. K15 does ~289 x 64 x 3 integer
// ops per block at r = 8 (~0.45 G at 1080p, 0.007 ms at 67 T/s); K14 moves
// ~17 MB at 1080p (the luma and the planes as int32, 0.005 ms).
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 128;
constexpr int MAX_R = 12;            // the lookahead range is 4..12
constexpr int MAX_WIN = 8 + 2 * MAX_R;
constexpr int INTRA_PENALTY = 5, NONZERO_MV_PENALTY = 5;
constexpr int BIG = 1 << 28;

__global__ void lowres_kernel(const int* __restrict__ Y, int stride, int he,
                              int we, int h2, int w2, int* __restrict__ out) {
  const int n = h2 * w2;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * n) return;
  const int k = idx / n, i = (idx % n) / w2, j = idx % w2;
  const int pv = k >> 1, ph = k & 1;
  const int r0 = min(2 * i + pv, he - 1), r1 = min(2 * i + 1 + pv, he - 1);
  const int c0 = min(2 * j + ph, we - 1), c1 = min(2 * j + 1 + ph, we - 1);
  out[idx] = (Y[r0 * stride + c0] + Y[r0 * stride + c1] + Y[r1 * stride + c0]
              + Y[r1 * stride + c1] + 2) >> 2;
}

// SATD of an 8x8 block from its four 4x4 Hadamard abs-sums (raster
// order): halved per 8x4 pair (pixel.py:satd)
__device__ __forceinline__ int satd8(const int* s) {
  return ((s[0] + s[1]) >> 1) + ((s[2] + s[3]) >> 1);
}

__global__ void __launch_bounds__(NT) cost_kernel(
    const int* __restrict__ cur, const int* __restrict__ prev, int h2, int w2,
    int bh, int bw, int r, int all_blocks, int* __restrict__ icost,
    int* __restrict__ pcost, int* __restrict__ sums) {
  const int blk = blockIdx.x, bx = blk % bw, by = blk / bw;
  const int tid = threadIdx.x, n = 2 * r + 1, ws = 8 + 2 * r;
  const bool has_top = by > 0, has_left = bx > 0;
  __shared__ int c[64], top[8], left[8], dc;
  __shared__ int win[MAX_WIN * MAX_WIN];
  __shared__ int hwin[4][81];
  __shared__ int had[36];
  __shared__ unsigned long long best[NT];
  __shared__ int icost_s;
  auto low = [&](const int* P, int y, int x) {
    return P[min(max(y, 0), h2 - 1) * w2 + min(max(x, 0), w2 - 1)];
  };

  if (tid < 64) c[tid] = low(cur, 8 * by + (tid >> 3), 8 * bx + (tid & 7));
  else if (tid < 72) top[tid - 64] = low(cur, 8 * by - 1, 8 * bx + tid - 64);
  else if (tid < 80) left[tid - 72] = low(cur, 8 * by + tid - 72, 8 * bx - 1);
  if (prev != nullptr)
    for (int i = tid; i < ws * ws; i += NT)
      win[i] = low(prev, 8 * by - r + i / ws, 8 * bx - r + i % ws);
  __syncthreads();
  if (tid == 0) {
    int ts = 0, ls = 0;
    for (int i = 0; i < 8; ++i) { ts += top[i]; ls += left[i]; }
    dc = has_top && has_left ? (ts + ls + 8) >> 4
       : has_top ? (ts + 4) >> 3 : has_left ? (ls + 4) >> 3 : 128;
  }
  __syncthreads();
  // intra: mode (DC, V, H) x 4x4 block
  if (tid < 12) {
    const int m = tid >> 2, sb = tid & 3, y0 = 4 * (sb >> 1), x0 = 4 * (sb & 1);
    int d[16];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int p = m == 0 ? dc : m == 1 ? top[x0 + j] : left[y0 + i];
        d[4 * i + j] = c[(y0 + i) * 8 + x0 + j] - p;
      }
    had[tid] = abs_had4x4(d);
  }
  __syncthreads();
  if (tid == 0) {
    const int s_dc = satd8(had), s_v = has_top ? satd8(had + 4) : BIG;
    const int s_h = has_left ? satd8(had + 8) : BIG;
    icost_s = min(s_dc, min(s_v, s_h)) + INTRA_PENALTY;
    icost[blk] = icost_s;
  }
  const bool inner = all_blocks
      || (by >= 1 && by < bh - 1 && bx >= 1 && bx < bw - 1);
  if (prev == nullptr) {                 // the first frame: [s, s]
    __syncthreads();
    if (tid == 0 && inner) {
      atomicAdd(&sums[0], icost_s);
      atomicAdd(&sums[1], icost_s);
    }
    return;
  }
  // the dense full-pel search: candidate k = (dy + r) * n + (dx + r)
  unsigned long long mine = ~0ull;
  for (int k = tid; k < n * n; k += NT) {
    const int dy = k / n - r, dx = k % n - r;
    int sad = 0;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        sad += abs(c[8 * i + j] - win[(i + dy + r) * ws + j + dx + r]);
    const int cost = sad + se_bits(dx) + se_bits(dy) - 2
                   + ((dx | dy) != 0 ? NONZERO_MV_PENALTY : 0);
    const unsigned long long key = ((unsigned long long)cost << 32) | (unsigned)k;
    mine = key < mine ? key : mine;
  }
  best[tid] = mine;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s && best[tid + s] < best[tid]) best[tid] = best[tid + s];
    __syncthreads();
  }
  const int kb = (int)(best[0] & 0xffffffffu);
  const int mvx = kb % n - r, mvy = kb / n - r;
  const int pen = se_bits(mvx) + se_bits(mvy) - 2
                + ((mvx | mvy) != 0 ? NONZERO_MV_PENALTY : 0);
  // the 9x9 half-pel window of the four planes, in the padded frame of
  // inter_cost_plane (rows -r .. bh*8 + r), started as dynamic_slice
  const int sy = ds_start(8 * by + mvy - 1 + r, bh * 8 + 2 * r, 9);
  const int sx = ds_start(8 * bx + mvx - 1 + r, bw * 8 + 2 * r, 9);
  for (int i = tid; i < 4 * 81; i += NT) {
    const int p = i / 81, a = (i % 81) / 9, b = i % 9;
    hwin[p][a * 9 + b] = low(prev + p * h2 * w2, sy + a - r, sx + b - r);
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
        d[4 * i + j] = c[(4 * (sb >> 1) + i) * 8 + 4 * (sb & 1) + j]
                     - hwin[plane][(r0 + i) * 9 + c0 + j];
    had[tid] = abs_had4x4(d);
  }
  __syncthreads();
  if (tid == 0) {
    int bc = 0;
    for (int cand = 0; cand < 9; ++cand) {
      const int cost = satd8(had + 4 * cand) + pen;
      if (cand == 0 || cost < bc) bc = cost;
    }
    pcost[blk] = bc;
    if (inner) {
      atomicAdd(&sums[0], icost_s);
      atomicAdd(&sums[1], min(bc, icost_s));
    }
  }
}

}  // namespace

extern "C" int lowres_planes(const int* y, int stride, int h, int w,
                             int* out, void* stream) {
  const int he = h & ~1, we = w & ~1, h2 = he / 2, w2 = we / 2;
  const int total = 4 * h2 * w2;
  lowres_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      y, stride, he, we, h2, w2, out);
  return (int)cudaGetLastError();
}

extern "C" int lowres_cost(const int* cur, const int* prev, int h2, int w2,
                           int bh, int bw, int r, int all_blocks, int* icost,
                           int* pcost, int* sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (r < 0 || r > MAX_R) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(sums, 0, 2 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  cost_kernel<<<bh * bw, NT, 0, s>>>(cur, prev, h2, w2, bh, bw, r, all_blocks,
                                     icost, pcost, sums);
  return (int)cudaGetLastError();
}

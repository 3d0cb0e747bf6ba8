// K5 me_hier: hierarchical full-pel motion estimation of every MB.
//
// Replaces x264_tpu/ops/me.py:hier_search (with _half_plane, se_bits and
// mv_cost_bits). Plain twin: x264_tpu_torch/ops/me.py:hier_search_plain;
// wrapper: hier_search.
//
// Design. Two launches.
//   1. half_kernel: the half-resolution planes of the current frame and
//      of the reference interior ((sum of 2x2 + 2) >> 2), one thread per
//      half-res sample of both planes.
//   2. search_kernel, one 128-thread CTA per MB, every SAD split over
//      lanes and every minimum a reduction:
//      the MB's 8x8 half-res block, the (8 + 2 rq)^2 half-res reference
//      window around it (edge-clamped, which is the edge padding by rq;
//      rows 4 mod 8 words apart), and the full-res windows of stage 2's
//      second and third centres ((mvp + 2) >> 2 and zero, which do not
//      depend on the coarse search) are staged first, each window's rows
//      an odd number of words apart;
//      then windows 2 and 3 (m = 2, 1: 25 + 9 candidates) on half-warps:
//      lane r holds row r of the MB's 16x16 block in registers and sums
//      |diff| over its row of the candidate, the 16 row sums added by
//      xor shuffles; cost = sad + lam * bits(4 mv - mvp);
//      then stage 1, the dense coarse search, on lane pairs: each lane of
//      a pair holds four rows of the 8x8 half-res block in registers, the
//      (2 rq + 1)^2 candidates (rq = min((R + 1) / 2 + 1, PAD / 2), 361
//      at R = 16) spread over the pairs; cost = 4 sad + lam * bits(8 cand
//      - mvp); each lane keeps its least (cost << 32 | candidate), the
//      CTA's least by warp shuffles and a shared word a warp;
//      then window 1 (m = 3, 49 candidates) around the coarse winner on
//      half-warps as above.
//      Each centre is clamped to +-min(R, PAD - m - 1) and each window
//      start taken as dynamic_slice takes it (ds_start).
//   Ties: the winner is the minimum of (cost << 32 | candidate index), so
//   the first candidate in x264_tpu's order wins, as argmin does: y outer,
//   x inner in stage 1; window 1, 2, 3 (indices 0-48, 49-73, 74-82), each
//   oy outer, ox inner, in stage 2. The sums are integers: splitting them
//   over lanes changes no value.
// What bounds it on the H100: operations. At 1080p it reads ~17.6 MB
// (source and padded reference as int32, ~5 us at 3.35 TB/s) and does
// ~1.1 G integer ops (361 coarse candidates over 960x544, 83 x 256 per
// MB; ~16 us at the ALU rate). In practice the shared-memory reads set
// the time: one per |diff| term now that the MB's samples sit in
// registers (two before), and ~1 in 16 lanes idle at the rounds' ends.
//
// K29 fullpel_search: the exhaustive full-pel search of every MB.
//
// Replaces x264_tpu/ops/me.py:fullpel_search (the (2R+1)^2 displacements
// of each 16x16 MB; cost = SAD + lam * bits(4 cand - mvp); argmin's first
// index in dy-major, dx-minor order). Plain twin:
// x264_tpu_torch/ops/me.py:fullpel_search_plain; wrapper: fullpel_search.
//
// Design. One 256-thread CTA per MB. The candidate at (dy, dx) reads the
// reference rows from ds_start(pad + dy, H + 2 pad, H) and the columns
// from ds_start(pad + dx, W + 2 pad, W): dynamic_slice's start, counted
// once from the end where negative and then clamped, so for R > pad the
// SAD is taken at the clamped window while the MV stays the candidate's.
// The host takes the least and greatest of those starts; the window
// between them ((rs_hi - rs_lo + 16) x (cs_hi - cs_lo + 16), at most
// (2 pad + 16)^2: 80 x 80 at pad 32, 48 x 48 at R = 16) and the MB's
// 16 x 16 block sit in shared memory. Threads walk the candidates in
// index order (consecutive threads, consecutive dx: conflict-free window
// reads, the block read as a broadcast), each keeping the first of its
// least (cost, index); the CTA's minimum of (cost << 32 | index) is then
// argmin's first index, and the thread that holds it writes the MV and
// its SAD (not its cost). Sums and lam * bits wrap as int32.
// What bounds it on the H100: operations. At 1080p and R = 16 it does
// 8160 x 1089 x 256 = 2.3 G |diff| terms (each two shared loads, a
// subtract, an abs and an add) against ~17.6 MB of reads.
#include <climits>

#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 128;
constexpr int MAX_RQ = 16;                       // PAD / 2
constexpr int QWIN = 8 + 2 * MAX_RQ;             // half-res window side
// a packed row of the half-res window, in words (a slack word past the
// last: each 8-sample read takes 3 words from its first)
constexpr int QROW = QWIN / 4 + 1;
constexpr int NCAND2 = 49 + 25 + 9;
// the three full-res windows (m = 3, 2, 1: 22, 20 and 18 samples a
// side), a packed row 7 words apart (16 lanes' rows on 16 banks; a
// 16-sample read takes 5 words from its first), one after another
constexpr int WROW = 7;
constexpr int WIN_WORDS = 3 * 22 * WROW;

// four 8-bit samples, the first in the low byte
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (unsigned)a | (unsigned)b << 8 | (unsigned)c << 16 | (unsigned)d << 24;
}

// samples o .. o + 3 of a packed row
__device__ __forceinline__ unsigned bytes_at(const unsigned* row, int o) {
  return __funnelshift_r(row[o >> 2], row[(o >> 2) + 1], 8 * (o & 3));
}

__global__ void half_kernel(const int* __restrict__ cur,
                            const int* __restrict__ ref_pad,
                            int* __restrict__ half, int H, int W, int pad) {
  const int Hq = H / 2, Wq = W / 2, Wp = W + 2 * pad;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Hq * Wq) return;
  const int y = i / Wq, x = i % Wq;
  const int* c = cur + 2 * y * W + 2 * x;
  half[i] = (c[0] + c[1] + c[W] + c[W + 1] + 2) >> 2;
  const int* r = ref_pad + (2 * y + pad) * Wp + 2 * x + pad;
  half[Hq * Wq + i] = (r[0] + r[1] + r[Wp] + r[Wp + 1] + 2) >> 2;
}

// stage 2's window w around centre (cx, cy) for the MB at (mx, my): the
// clamped centre, and the window packed at win + 22 * WROW * w (the
// words past its right edge hold zeros)
__device__ __forceinline__ void stage_window(
    const int* __restrict__ ref_pad, unsigned* win, int w, int& cx, int& cy,
    int mx, int my, int R, int pad, int Hp, int Wp) {
  const int m = 3 - w, wn = 16 + 2 * m;
  const int lim = min(R, pad - m - 1);
  cx = min(max(cx, -lim), lim);
  cy = min(max(cy, -lim), lim);
  const int y0 = ds_start(16 * my + cy - m + pad, Hp, wn);
  const int x0 = ds_start(16 * mx + cx - m + pad, Wp, wn);
  for (int i = threadIdx.x; i < wn * (WROW - 1); i += NT) {
    const int y = i / (WROW - 1), c = 4 * (i % (WROW - 1));
    const int* src = ref_pad + (y0 + y) * Wp + x0 + c;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < wn ? src[e] : 0;
    win[22 * WROW * w + y * WROW + c / 4] = pack4(v[0], v[1], v[2], v[3]);
  }
}

// window w's candidates on the CTA's 8 half-warps: lane r sums row r
// (the MB's row r packed in row[]); lane 0 of a half-warp records each
// candidate's SAD and MV at its index and keeps the least key in best
__device__ __forceinline__ void search_window(
    const unsigned* win, int w, int cx, int cy, const unsigned (&row)[4],
    int px, int py, int lam, int* csad, int* cmvx, int* cmvy,
    unsigned long long& best) {
  const int m = 3 - w, n = 2 * m + 1;
  const int base = w == 0 ? 0 : w == 1 ? 49 : 74;
  const int r = threadIdx.x & 15;
  // both half-warps of a warp run every round (the shuffles take the
  // whole warp), past the last candidate on a copy of candidate 0
  const int rounds = (n * n + NT / 16 - 1) / (NT / 16);
  for (int t = 0; t < rounds; ++t) {
    const int jj = (threadIdx.x >> 4) + t * (NT / 16);
    const int j = jj < n * n ? jj : 0;
    const int oy = j / n, ox = j % n;
    const unsigned* wr = win + 22 * WROW * w + (oy + r) * WROW + (ox >> 2);
    const int sh = 8 * (ox & 3);
    unsigned wd[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) wd[i] = wr[i];
    int s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s += __vsadu4(row[i], __funnelshift_r(wd[i], wd[i + 1], sh));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (r == 0 && jj < n * n) {
      const int mvx = 4 * (cx + ox - m), mvy = 4 * (cy + oy - m);
      const int cost = s + lam * (se_bits(mvx - px) + se_bits(mvy - py));
      const int idx = base + j;
      csad[idx] = s;
      cmvx[idx] = mvx;
      cmvy[idx] = mvy;
      best = min(best, ((unsigned long long)(unsigned)cost << 32) | (unsigned)idx);
    }
  }
}

// the least key of the CTA, in every thread (red: a word a warp)
__device__ __forceinline__ unsigned long long cta_min(unsigned long long v,
                                                      unsigned long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int k = 1; k < NT / 32; ++k) v = min(v, red[k]);
  return v;
}

__global__ void __launch_bounds__(NT) search_kernel(
    const int* __restrict__ cur, const int* __restrict__ ref_pad,
    const int* __restrict__ mvp, const int* __restrict__ half,
    int* __restrict__ mv_o, int* __restrict__ sad_o, int mb_h, int mb_w,
    int R, int pad, int lam) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x;
  const int H = mb_h * 16, W = mb_w * 16, Hq = H / 2, Wq = W / 2;
  const int Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int rq = min((R + 1) / 2 + 1, pad / 2), nq = 2 * rq + 1, qw = 8 + 2 * rq;
  const int px = mvp[2 * mb], py = mvp[2 * mb + 1];

  __shared__ unsigned cq[16], rwin[QWIN * QROW], win[WIN_WORDS];
  __shared__ int csad[NCAND2], cmvx[NCAND2], cmvy[NCAND2];
  __shared__ unsigned long long red[NT / 32], red2[NT / 32];

  // ------------------------------------------------ staging
  const int* cur_q = half;
  const int* ref_q = half + Hq * Wq;
  if (tid < 16) {
    const int* src = cur_q + (8 * my + (tid >> 1)) * Wq + 8 * mx + 4 * (tid & 1);
    cq[tid] = pack4(src[0], src[1], src[2], src[3]);
  }
  for (int i = tid; i < qw * (QROW - 1); i += NT) {
    const int y = min(max(8 * my - rq + i / (QROW - 1), 0), Hq - 1);
    const int c = 4 * (i % (QROW - 1));
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = ref_q[y * Wq + min(max(8 * mx - rq + c + e, 0), Wq - 1)];
    rwin[(i / (QROW - 1)) * QROW + c / 4] = pack4(v[0], v[1], v[2], v[3]);
  }
  int c2x = (px + 2) >> 2, c2y = (py + 2) >> 2, c3x = 0, c3y = 0;
  stage_window(ref_pad, win, 1, c2x, c2y, mx, my, R, pad, Hp, Wp);
  stage_window(ref_pad, win, 2, c3x, c3y, mx, my, R, pad, Hp, Wp);
  // the MB's row r = tid & 15, packed in registers
  unsigned row[4];
  {
    const int* src = cur + (16 * my + (tid & 15)) * W + 16 * mx;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      row[i] = pack4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
  }
  __syncthreads();

  // ------------------------------- stage 2's windows 2 and 3
  unsigned long long best = ~0ull;
  search_window(win, 1, c2x, c2y, row, px, py, lam, csad, cmvx, cmvy, best);
  search_window(win, 2, c3x, c3y, row, px, py, lam, csad, cmvx, cmvy, best);

  // ---------------------------------------- stage 1: coarse
  // a thread a candidate, the MB's half-res block packed in registers
  unsigned long long best1 = ~0ull;
  {
    unsigned q[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = cq[i];
    for (int k = tid; k < nq * nq; k += NT) {
      const int oy = k / nq, ox = k % nq;          // window offsets rq + d
      const unsigned* wr = rwin + oy * QROW + (ox >> 2);
      const int sh = 8 * (ox & 3);
      int s = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const unsigned a = wr[r * QROW], b = wr[r * QROW + 1], c = wr[r * QROW + 2];
        s += __vsadu4(q[2 * r], __funnelshift_r(a, b, sh));
        s += __vsadu4(q[2 * r + 1], __funnelshift_r(b, c, sh));
      }
      const int dx = ox - rq, dy = oy - rq;
      const int cost = s * 4 + lam * (se_bits(dx * 8 - px) + se_bits(dy * 8 - py));
      best1 = min(best1, ((unsigned long long)(unsigned)cost << 32) | (unsigned)k);
    }
  }
  const int kb = (int)(cta_min(best1, red) & 0xffffffffu);

  // --------------------------- stage 2's window 1: the coarse winner
  int c1x = 2 * (kb % nq - rq), c1y = 2 * (kb / nq - rq);
  stage_window(ref_pad, win, 0, c1x, c1y, mx, my, R, pad, Hp, Wp);
  __syncthreads();
  search_window(win, 0, c1x, c1y, row, px, py, lam, csad, cmvx, cmvy, best);
  const unsigned long long b2 = cta_min(best, red2);
  if (tid == 0) {
    const int idx = (int)(b2 & 0xffffffffu);
    mv_o[2 * mb] = cmvx[idx];
    mv_o[2 * mb + 1] = cmvy[idx];
    sad_o[mb] = csad[idx];
  }
}

constexpr int FP_NT = 256;

__global__ void __launch_bounds__(FP_NT) fullpel_kernel(
    const int* __restrict__ cur, const int* __restrict__ ref_pad,
    const int* __restrict__ mvp, int* __restrict__ mv_o,
    int* __restrict__ sad_o, int mb_w, int H, int W, int R, int pad, int lam,
    int rs_lo, int cs_lo, int win_h, int win_w) {
  extern __shared__ int win[];
  __shared__ int blk[256];
  __shared__ long long best;
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x, Hp = H + 2 * pad, Wp = W + 2 * pad;
  blk[tid] = cur[(my * 16 + tid / 16) * W + mx * 16 + tid % 16];
  for (int i = tid; i < win_h * win_w; i += FP_NT) {
    const int r = i / win_w, c = i % win_w;
    win[i] = ref_pad[(size_t)(my * 16 + rs_lo + r) * Wp + mx * 16 + cs_lo + c];
  }
  if (tid == 0) best = LLONG_MAX;
  __syncthreads();
  const int n = 2 * R + 1, nc = n * n;
  const int px = mvp[2 * mb], py = mvp[2 * mb + 1];
  long long mine = LLONG_MAX;
  int mine_sad = 0;
  for (int c = tid; c < nc; c += FP_NT) {
    const int dy = c / n - R, dx = c % n - R;
    const int ro = ds_start(pad + dy, Hp, H) - rs_lo;
    const int co = ds_start(pad + dx, Wp, W) - cs_lo;
    unsigned sad = 0;
    for (int r = 0; r < 16; ++r) {
      const int* w = win + (ro + r) * win_w + co;
      #pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int d = blk[r * 16 + k] - w[k];
        sad += (unsigned)(d < 0 ? -d : d);
      }
    }
    const unsigned bits = (unsigned)(se_bits(4 * dx - px) + se_bits(4 * dy - py));
    const int cost = (int)(sad + (unsigned)lam * bits);
    const long long key = (long long)cost * 4294967296LL + c;
    if (key < mine) {
      mine = key;
      mine_sad = (int)sad;
    }
  }
  atomicMin(&best, mine);
  __syncthreads();
  if (mine == best) {
    const int c = (int)(best & 0xffffffffLL);
    mv_o[2 * mb] = 4 * (c % n - R);
    mv_o[2 * mb + 1] = 4 * (c / n - R);
    sad_o[mb] = mine_sad;
  }
}

}  // namespace

extern "C" int fullpel_search(const int* cur, const int* ref_pad,
                              const int* mvp, int* mv, int* sad, int mb_h,
                              int mb_w, int me_range, int pad, int lam,
                              void* stream) {
  const int H = mb_h * 16, W = mb_w * 16, R = me_range;
  if (R < 0 || pad < 0) return (int)cudaErrorInvalidValue;
  // the least and greatest row / column starts of the candidates
  int rs_lo = INT_MAX, rs_hi = INT_MIN, cs_lo = INT_MAX, cs_hi = INT_MIN;
  for (int d = -R; d <= R; ++d) {
    const int sr = pad + d < 0 ? pad + d + H + 2 * pad : pad + d;
    const int sc = pad + d < 0 ? pad + d + W + 2 * pad : pad + d;
    const int r = min(max(sr, 0), 2 * pad), c = min(max(sc, 0), 2 * pad);
    rs_lo = min(rs_lo, r); rs_hi = max(rs_hi, r);
    cs_lo = min(cs_lo, c); cs_hi = max(cs_hi, c);
  }
  const int win_h = rs_hi - rs_lo + 16, win_w = cs_hi - cs_lo + 16;
  const size_t smem = (size_t)win_h * win_w * sizeof(int);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fullpel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fullpel_kernel<<<mb_h * mb_w, FP_NT, smem, (cudaStream_t)stream>>>(
      cur, ref_pad, mvp, mv, sad, mb_w, H, W, R, pad, lam, rs_lo, cs_lo,
      win_h, win_w);
  return (int)cudaGetLastError();
}

extern "C" int me_hier(const int* cur, const int* ref_pad, const int* mvp,
                       int* half, int* mv, int* sad, int mb_h, int mb_w,
                       int me_range, int pad, int lam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (pad / 2 > MAX_RQ)
    return (int)cudaErrorInvalidValue;
  const int H = mb_h * 16, W = mb_w * 16, nq = (H / 2) * (W / 2);
  half_kernel<<<(nq + 255) / 256, 256, 0, s>>>(cur, ref_pad, half, H, W, pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  search_kernel<<<mb_h * mb_w, NT, 0, s>>>(cur, ref_pad, mvp, half, mv, sad,
                                           mb_h, mb_w, me_range, pad, lam);
  return (int)cudaGetLastError();
}

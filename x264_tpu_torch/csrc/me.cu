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
//   2. search_kernel, one 128-thread CTA per MB:
//      stage 1, the dense coarse search: the MB's 8x8 half-res block and
//      the (8 + 2 rq)^2 reference window around it (edge-clamped, which
//      is the edge padding by rq) sit in shared memory; the (2 rq + 1)^2
//      candidates (rq = min((R + 1) / 2 + 1, PAD / 2), 361 at R = 16) are
//      spread over the threads; cost = 4 sad + lam * bits(8 cand - mvp);
//      stage 2, three full-res windows of m = 3, 2, 1 around the coarse
//      winner, (mvp + 2) >> 2 and zero, each centre clamped to
//      +-min(R, PAD - m - 1) and each window start taken as
//      dynamic_slice takes it (ds_start): 49 + 25 + 9 = 83 candidates of
//      256-sample SADs with the 16x16 block and the window in shared
//      memory; cost = sad + lam * bits(4 mv - mvp).
//   Ties: the winner is the minimum of (cost << 32 | candidate index), so
//   the first candidate in x264_tpu's order wins, as argmin does: y outer,
//   x inner in stage 1; window 1, 2, 3, each oy outer, ox inner, in stage 2.
// What bounds it on the H100: operations. At 1080p it reads ~17.6 MB
// (source and padded reference as int32, ~5 us at 3.35 TB/s) and does
// ~1.1 G integer ops (361 coarse candidates over 960x544, 83 x 256 per
// MB; ~16 us at the ALU rate). Stage 2 keeps at most 49 of 128 threads
// busy; a later PR can give each thread a slice of a candidate.
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
constexpr int NCAND2 = 49 + 25 + 9;

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

  __shared__ int cq[64], rwin[QWIN * QWIN];
  __shared__ int cb[256], win[22 * 22];
  __shared__ int csad[NCAND2], cmvx[NCAND2], cmvy[NCAND2];
  __shared__ unsigned long long best1, best2;

  // ---------------------------------------------- stage 1: coarse
  const int* cur_q = half;
  const int* ref_q = half + Hq * Wq;
  for (int i = tid; i < 64; i += NT)
    cq[i] = cur_q[(8 * my + (i >> 3)) * Wq + 8 * mx + (i & 7)];
  for (int i = tid; i < qw * qw; i += NT) {
    int y = min(max(8 * my - rq + i / qw, 0), Hq - 1);
    int x = min(max(8 * mx - rq + i % qw, 0), Wq - 1);
    rwin[i] = ref_q[y * Wq + x];
  }
  for (int i = tid; i < 256; i += NT)
    cb[i] = cur[(16 * my + (i >> 4)) * W + 16 * mx + (i & 15)];
  if (tid == 0) { best1 = ~0ull; best2 = ~0ull; }
  __syncthreads();
  for (int k = tid; k < nq * nq; k += NT) {
    const int oy = k / nq, ox = k % nq;          // window offsets rq + d
    int s = 0;
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        s += abs(cq[r * 8 + c] - rwin[(oy + r) * qw + ox + c]);
    const int dx = ox - rq, dy = oy - rq;
    const int cost = s * 4 + lam * (se_bits(dx * 8 - px) + se_bits(dy * 8 - py));
    atomicMin(&best1, ((unsigned long long)(unsigned)cost << 32) | (unsigned)k);
  }
  __syncthreads();
  const int kb = (int)(best1 & 0xffffffffu);
  const int cx = 2 * (kb % nq - rq), cy = 2 * (kb / nq - rq);

  // ---------------------------------------------- stage 2: windows
  int base = 0;
  for (int w = 0; w < 3; ++w) {
    const int m = 3 - w, n = 2 * m + 1, wn = 16 + 2 * m;
    const int lim = min(R, pad - m - 1);
    int ccx = w == 0 ? cx : w == 1 ? (px + 2) >> 2 : 0;
    int ccy = w == 0 ? cy : w == 1 ? (py + 2) >> 2 : 0;
    ccx = min(max(ccx, -lim), lim);
    ccy = min(max(ccy, -lim), lim);
    const int y0 = ds_start(16 * my + ccy - m + pad, Hp, wn);
    const int x0 = ds_start(16 * mx + ccx - m + pad, Wp, wn);
    for (int i = tid; i < wn * wn; i += NT)
      win[i] = ref_pad[(y0 + i / wn) * Wp + x0 + i % wn];
    __syncthreads();
    if (tid < n * n) {
      const int oy = tid / n, ox = tid % n;
      int s = 0;
      for (int r = 0; r < 16; ++r)
        for (int c = 0; c < 16; ++c)
          s += abs(cb[r * 16 + c] - win[(oy + r) * wn + ox + c]);
      const int mvx = 4 * (ccx + ox - m), mvy = 4 * (ccy + oy - m);
      const int cost = s + lam * (se_bits(mvx - px) + se_bits(mvy - py));
      const int idx = base + tid;
      csad[idx] = s;
      cmvx[idx] = mvx;
      cmvy[idx] = mvy;
      atomicMin(&best2, ((unsigned long long)(unsigned)cost << 32) | (unsigned)idx);
    }
    base += n * n;
    __syncthreads();
  }
  if (tid == 0) {
    const int idx = (int)(best2 & 0xffffffffu);
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

// K26 nr_sums: the per-position float32 sums of the noise reduction.
//
// Replaces the reduction of x264_tpu/ops/quant.py:120 denoise,
// a.astype(f32).reshape(-1, N).sum(axis=0) over the (mb_h, mb_w, nblk, N)
// pre-shrink |coef| of a P frame's inter luma residual (N = 16, nblk = 16
// for the 4x4 transform; N = 64, nblk = 4 for the 8x8), position 0 forced
// to 0. K6's NR branch writes the |coef| (csrc/inter.cu). Plain twin:
// x264_tpu_torch/ops/quant.py:nr_sums_plain; wrapper: nr_sums.
//
// Design. The order of the float32 additions is the whole specification:
// past 2^24 a partial sum of integers rounds, so the offsets the host
// derives from the sums move with the order. x264_tpu's sums are those
// of XLA's CPU backend, whose tree-reduction rewrite turns the reduce
// into a reduce-window over (32, 32, nblk, 1) windows of the MB grid,
// zero-padded to a multiple of 32 (floor(pad / 2) rows and columns
// first; a side of 32 or less is one window of its own length, unpadded),
// each window summed in row-major order from 0, and then a plain reduce
// over the windows' partials, which its code generator emits in
// row-major order from 0 except where the window grid is 2 x 2 or 4 x 2
// (the rows then become vector lanes, reduced by halving; read from the
// optimised LLVM IR, jax 0.9). So this kernel is two launches: one CTA
// per window with one thread per position walking the window's MBs,
// blocks and rows in that order (padding adds nothing), then one CTA
// whose threads combine the partials in that order; a thread loads the
// next MB's blocks while it adds the current one's. A grid of at most
// 32 x 32 MBs is one window: one sequential sum, which equals XLA's
// vectorised reduce while the sums stay below 2^24 (ops/quant.py:
// nr_sums_plain says when they may not).
// Every addition is a separately rounded __fadd_rn. A grid side past
// 32 * 32 MBs would take a second level of the tree; the wrapper refuses
// it.
// What bounds it on the H100: neither bytes (8.4 MB of 4x4 |coef| and
// 8.4 MB of 8x8 at 1080p as int32, ~5 us at 3.35 TB/s) nor operations
// (4.2 M float additions), but the serial chain: 12 CTAs of 16 (or 64)
// threads, each thread 16,384 (or 4,096) dependent additions.
#include <cuda_runtime.h>

namespace {

// one window's partial of position pos, NBLK blocks an MB: the MBs of
// the window's rows in order, each MB's blocks in order; the next MB's
// NBLK values are loaded while the current MB's are added (the loads
// do not depend on the chain, so one load latency an MB overlaps)
template <int NBLK>
__global__ void window_kernel(const int* __restrict__ a,
                              float* __restrict__ part, int d0, int d1,
                              int n, int w0, int p0, int w1, int p1,
                              int n1) {
  const int win = blockIdx.x, wa = win / n1, wb = win % n1;
  const int pos = threadIdx.x;
  if (pos >= n) return;
  const int c_lo = max(wb * w1 - p1, 0), c_hi = min(wb * w1 - p1 + w1, d1);
  float s = 0.0f;
  for (int i0 = 0; i0 < w0; ++i0) {
    const int r = wa * w0 + i0 - p0;
    if (r < 0 || r >= d0 || c_lo >= c_hi) continue;
    const int* mb = a + ((size_t)r * d1 + c_lo) * NBLK * n + pos;
    int nxt[NBLK];
#pragma unroll
    for (int k = 0; k < NBLK; ++k) nxt[k] = mb[k * n];
    for (int c = c_lo; c < c_hi; ++c) {
      int cur[NBLK];
#pragma unroll
      for (int k = 0; k < NBLK; ++k) cur[k] = nxt[k];
      mb += NBLK * n;
      if (c + 1 < c_hi) {
#pragma unroll
        for (int k = 0; k < NBLK; ++k) nxt[k] = mb[k * n];
      }
#pragma unroll
      for (int k = 0; k < NBLK; ++k) s = __fadd_rn(s, (float)cur[k]);
    }
  }
  part[(size_t)win * n + pos] = s;
}

// the last reduce over the n0 x n1 window partials (ops/quant.py:_combine):
// row-major from 0, or where n1 is 2 and n0 is 2 or 4 the lanes of XLA's
// vectorised loop, each row's two partials, reduced by halving
__global__ void final_kernel(const float* __restrict__ part,
                             float* __restrict__ out, int n0, int n1, int n) {
  const int pos = threadIdx.x;
  if (pos >= n) return;
  float s = 0.0f;
  if (n1 == 2 && (n0 == 2 || n0 == 4)) {
    float l[4];
    for (int a = 0; a < n0; ++a)
      l[a] = __fadd_rn(__fadd_rn(part[(size_t)(2 * a) * n + pos], 0.0f),
                       part[(size_t)(2 * a + 1) * n + pos]);
    s = n0 == 2 ? __fadd_rn(l[0], l[1])
                : __fadd_rn(__fadd_rn(l[0], l[2]), __fadd_rn(l[1], l[3]));
  } else {
    for (int w = 0; w < n0 * n1; ++w) s = __fadd_rn(s, part[(size_t)w * n + pos]);
  }
  out[pos] = pos == 0 ? 0.0f : s;
}

}  // namespace

// a: (d0, d1, nblk, n) int32 |coef|; part: (n0 * n1, n) float32 scratch;
// out: (n,) float32. (w, p, nw) per grid side: window, low padding and
// number of windows (x264_tpu_torch/ops/quant.py:_xla_plan); n <= 1024.
extern "C" int nr_sums(const int* a, float* part, float* out, int d0, int d1,
                       int nblk, int n, int w0, int p0, int n0, int w1,
                       int p1, int n1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nblk == 16)
    window_kernel<16><<<n0 * n1, n, 0, s>>>(a, part, d0, d1, n, w0, p0, w1,
                                            p1, n1);
  else if (nblk == 4)
    window_kernel<4><<<n0 * n1, n, 0, s>>>(a, part, d0, d1, n, w0, p0, w1,
                                           p1, n1);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  final_kernel<<<1, n, 0, s>>>(part, out, n0, n1, n);
  return (int)cudaGetLastError();
}

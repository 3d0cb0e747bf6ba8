// K4 frame_metrics: the SSD of the three planes and the SSIM sum of a
// frame, in one launch.
//
// Replaces the metric half of x264_tpu/encoder/pipeline.py:host32_pack
// (with ops/pixel.py:ssim_sum): the SSD of Y / U / V over the w x h
// output crop and x264's SSIM sum over the (2, 2)-offset luma region,
// ssim_4x4x2_core + ssim_end1 (common/pixel.c:435-513). Plain twin:
// x264_tpu_torch/encoder/stats.py:frame_metrics_plain; wrapper:
// frame_metrics.
//
// Design. The luma CTAs own a tile of TR x TC SSIM windows. Each forms
// the s1, s2, ss, s12 sums of the 4x4 blocks under its windows once (one
// halo block row and column past them) into shared memory, as
// ssim_4x4x2_core does; a window is the sum of its 2x2 blocks, and its
// float is the plain formula with the same casts, each step rounded
// alone. The same CTA sums the luma SSD of the pixels it owns (its
// windows' rows and columns, the first tile also rows / columns 0-1, the
// last the rows / columns past the last window), whose lines its block
// sums have just brought into the caches. Further CTAs of the grid sum
// the U and V SSD over CR rows each. Every CTA reduces its partials in a
// fixed order (int64 SSD, float SSIM) and takes a ticket; the last sums
// all partials in a fixed order, so the result is the same from call to
// call, and clears the ticket for the next launch.
// What bounds it on the H100: bytes, the six int32 planes (~25 MB at
// 1080p, ~7.5 us at 3.35 TB/s); each luma pixel comes from device memory
// once (the halo blocks and the SSD's second look hit L1 / L2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int TR = 4, TC = 64;       // SSIM windows a luma CTA (rows, cols)
constexpr int CR = 8;                // chroma rows a CTA
// ssim_c1 / ssim_c2 of ssim_end1 (ops/pixel.py SSIM_C1 / SSIM_C2)
constexpr int SSIM_C1 = 416, SSIM_C2 = 235963;

struct Geo {
  int w, h, W, Wc;                   // crop, luma / chroma row strides
  int hb, wb, nh, nw;                // 4x4 block rows / cols, windows
  int tr, tc, n_luma, n_chroma;      // luma tiles, chroma CTAs a plane
};

Geo geometry(int w, int h, int W, int Wc) {
  Geo g;
  g.w = w, g.h = h, g.W = W, g.Wc = Wc;
  g.hb = h > 2 ? (h - 2) / 4 : 0;
  g.wb = w > 2 ? (w - 2) / 4 : 0;
  g.nh = g.hb - 1, g.nw = g.wb - 1;
  g.tr = g.nh > 0 ? (g.nh + TR - 1) / TR : 1;
  g.tc = g.nw > 0 ? (g.nw + TC - 1) / TC : 1;
  g.n_luma = g.tr * g.tc;
  g.n_chroma = (h / 2 + CR - 1) / CR;
  if (g.n_chroma < 1) g.n_chroma = 1;
  return g;
}

// the first pixel row / column a tile owns for the SSD: 0 for the first,
// the first row / column of its windows' blocks after it, n past the last
__device__ __forceinline__ int owned(int t, int nt, int per, int n) {
  return t == 0 ? 0 : t == nt ? n : 2 + 4 * per * t;
}

// fixed-order sum over the CTA (every thread gets it; red: NT slots)
template <class T>
__device__ __forceinline__ T cta_sum(T* red, T v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + s];
    __syncthreads();
  }
  const T out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ long long ssd_rect(const int* a, const int* b,
                                              int stride, int r0, int r1,
                                              int c0, int c1) {
  long long s = 0;
  for (int r = r0; r < r1; ++r)
    for (int c = c0 + (int)threadIdx.x; c < c1; c += NT) {
      const int d = a[r * stride + c] - b[r * stride + c];
      s += d * d;
    }
  return s;
}

__global__ void __launch_bounds__(NT) metrics_kernel(
    const int* __restrict__ oy, const int* __restrict__ ou,
    const int* __restrict__ ov, const int* __restrict__ ry,
    const int* __restrict__ ru, const int* __restrict__ rv, const Geo g,
    long long* ssd_part, float* ssim_part, unsigned* ticket,
    float* __restrict__ out) {
  __shared__ int4 blk[TR + 1][TC + 1];
  __shared__ long long red64[NT];
  __shared__ float red32[NT];
  __shared__ bool last;
  const int b = blockIdx.x, tid = threadIdx.x;
  long long ssd;
  float ssim = 0.0f;
  if (b < g.n_luma) {
    const int ti = b / g.tc, tj = b % g.tc;
    const int bi0 = ti * TR, bj0 = tj * TC;
    const int nbr = min(TR + 1, g.hb - bi0), nbc = min(TC + 1, g.wb - bj0);
    const bool windows = g.nh > 0 && g.nw > 0;
    // the 4x4 block sums under this tile's windows and their halo
    if (windows)
      for (int k = tid; k < nbr * nbc; k += NT) {
        const int r = k / nbc, c = k % nbc;
        const int o = (2 + 4 * (bi0 + r)) * g.W + 2 + 4 * (bj0 + c);
        int s1 = 0, s2 = 0, ss = 0, s12 = 0;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int p = oy[o + y * g.W + x], q = ry[o + y * g.W + x];
            s1 += p;
            s2 += q;
            ss += p * p + q * q;
            s12 += p * q;
          }
        blk[r][c] = make_int4(s1, s2, ss, s12);
      }
    // the luma SSD of the pixels this tile owns
    ssd = ssd_rect(oy, ry, g.W, owned(ti, g.tr, TR, g.h),
                   owned(ti + 1, g.tr, TR, g.h), owned(tj, g.tc, TC, g.w),
                   owned(tj + 1, g.tc, TC, g.w));
    __syncthreads();
    // each window: its 2x2 blocks, then ssim_end1's float in its order
    const int nwr = min(TR, g.nh - bi0), nwc = min(TC, g.nw - bj0);
    for (int k = tid; windows && k < nwr * nwc; k += NT) {
      const int i = k / nwc, j = k % nwc;
      const int4 a = blk[i][j], c = blk[i][j + 1], d = blk[i + 1][j],
                 e = blk[i + 1][j + 1];
      const int f1 = a.x + c.x + d.x + e.x, f2 = a.y + c.y + d.y + e.y;
      const int fss = a.z + c.z + d.z + e.z, f12 = a.w + c.w + d.w + e.w;
      const int vars = fss * 64 - f1 * f1 - f2 * f2;
      const int covar = f12 * 64 - f1 * f2;
      const float num = __fmul_rn((float)(2 * f1 * f2 + SSIM_C1),
                                  (float)(2 * covar + SSIM_C2));
      const float den = __fmul_rn((float)(f1 * f1 + f2 * f2 + SSIM_C1),
                                  (float)(vars + SSIM_C2));
      ssim = __fadd_rn(ssim, __fdiv_rn(num, den));
    }
  } else {                             // U, then V: CR rows a CTA
    const int c = b - g.n_luma, plane = c / g.n_chroma, r0 = (c % g.n_chroma) * CR;
    ssd = ssd_rect(plane ? ov : ou, plane ? rv : ru, g.Wc, r0,
                   min(r0 + CR, g.h / 2), 0, g.w / 2);
  }
  ssd = cta_sum(red64, ssd);
  ssim = cta_sum(red32, ssim);
  if (tid == 0) {
    ssd_part[b] = ssd;
    ssim_part[b] = ssim;
    __threadfence();                   // the partials before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA: every partial in a fixed order (thread k takes k, k +
  // NT, ...; then the fixed tree), read past L1
  const volatile long long* vs = ssd_part;
  const volatile float* vf = ssim_part;
  const int n_l = g.n_luma, n_c = g.n_chroma;
  long long sy = 0, su = 0, sv = 0;
  float sm = 0.0f;
  for (int k = tid; k < n_l; k += NT) {
    sy += vs[k];
    sm = __fadd_rn(sm, vf[k]);
  }
  for (int k = tid; k < n_c; k += NT) {
    su += vs[n_l + k];
    sv += vs[n_l + n_c + k];
  }
  sy = cta_sum(red64, sy);
  su = cta_sum(red64, su);
  sv = cta_sum(red64, sv);
  sm = cta_sum(red32, sm);
  if (tid == 0) {
    out[0] = (float)sy;
    out[1] = (float)su;
    out[2] = (float)sv;
    out[3] = sm;
    *ticket = 0u;
  }
}

}  // namespace

// the CTAs of the launch for a w x h crop: the partials the caller's
// scratch must hold
extern "C" int frame_metrics_ctas(int w, int h) {
  const Geo g = geometry(w, h, 0, 0);
  return g.n_luma + 2 * g.n_chroma;
}

// scratch: a cleared unsigned ticket (the kernel leaves it cleared), then
// frame_metrics_ctas() int64 SSD partials and as many float SSIM ones
extern "C" int frame_metrics(const int* oy, const int* ou, const int* ov,
                             const int* ry, const int* ru, const int* rv,
                             unsigned* ticket, long long* ssd_part,
                             float* ssim_part, float* out, int w, int h,
                             int W, int Wc, void* stream) {
  const Geo g = geometry(w, h, W, Wc);
  metrics_kernel<<<g.n_luma + 2 * g.n_chroma, NT, 0, (cudaStream_t)stream>>>(
      oy, ou, ov, ry, ru, rv, g, ssd_part, ssim_part, ticket, out);
  return (int)cudaGetLastError();
}

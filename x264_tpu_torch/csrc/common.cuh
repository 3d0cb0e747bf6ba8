// Integer transform, quantisation and SATD building blocks shared by
// the CUDA kernels. Each is the per-block form of a batched function in
// x264_tpu_torch/ops/ (dct.py, quant.py, pixel.py) and is bit-exact
// with it: int32 arithmetic, arithmetic right shifts, no floats.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace x264t {

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }

// forward 4x4 core transform Y = C d C^T (dct.py:dct4x4), raster in/out
__device__ __forceinline__ void dct4x4(const int* d, int* out) {
  int t[16];
  for (int j = 0; j < 4; ++j) {
    int x0 = d[j], x1 = d[4 + j], x2 = d[8 + j], x3 = d[12 + j];
    t[j] = x0 + x1 + x2 + x3;
    t[4 + j] = 2 * x0 + x1 - x2 - 2 * x3;
    t[8 + j] = x0 - x1 - x2 + x3;
    t[12 + j] = x0 - 2 * x1 + 2 * x2 - x3;
  }
  for (int i = 0; i < 4; ++i) {
    int x0 = t[4 * i], x1 = t[4 * i + 1], x2 = t[4 * i + 2], x3 = t[4 * i + 3];
    out[4 * i] = x0 + x1 + x2 + x3;
    out[4 * i + 1] = 2 * x0 + x1 - x2 - 2 * x3;
    out[4 * i + 2] = x0 - x1 - x2 + x3;
    out[4 * i + 3] = x0 - 2 * x1 + 2 * x2 - x3;
  }
}

// inverse 4x4 transform incl. (x+32)>>6, rows first (dct.py:idct4x4)
__device__ __forceinline__ void idct4x4(const int* c, int* out) {
  int t[16];
  for (int i = 0; i < 4; ++i) {
    int x0 = c[4 * i], x1 = c[4 * i + 1], x2 = c[4 * i + 2], x3 = c[4 * i + 3];
    int e0 = x0 + x2, e1 = x0 - x2, e2 = (x1 >> 1) - x3, e3 = x1 + (x3 >> 1);
    t[4 * i] = e0 + e3;
    t[4 * i + 1] = e1 + e2;
    t[4 * i + 2] = e1 - e2;
    t[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {
    int x0 = t[j], x1 = t[4 + j], x2 = t[8 + j], x3 = t[12 + j];
    int e0 = x0 + x2, e1 = x0 - x2, e2 = (x1 >> 1) - x3, e3 = x1 + (x3 >> 1);
    out[j] = (e0 + e3 + 32) >> 6;
    out[4 + j] = (e1 + e2 + 32) >> 6;
    out[8 + j] = (e1 - e2 + 32) >> 6;
    out[12 + j] = (e0 - e3 + 32) >> 6;
  }
}

// 2-D 4x4 Hadamard H d H, raster in/out (dct.py:hadamard4x4_inv)
__device__ __forceinline__ void had4x4(const int* d, int* out) {
  int t[16];
  for (int j = 0; j < 4; ++j) {
    int x0 = d[j], x1 = d[4 + j], x2 = d[8 + j], x3 = d[12 + j];
    t[j] = x0 + x1 + x2 + x3;
    t[4 + j] = x0 + x1 - x2 - x3;
    t[8 + j] = x0 - x1 - x2 + x3;
    t[12 + j] = x0 - x1 + x2 - x3;
  }
  for (int i = 0; i < 4; ++i) {
    int x0 = t[4 * i], x1 = t[4 * i + 1], x2 = t[4 * i + 2], x3 = t[4 * i + 3];
    out[4 * i] = x0 + x1 + x2 + x3;
    out[4 * i + 1] = x0 + x1 - x2 - x3;
    out[4 * i + 2] = x0 - x1 - x2 + x3;
    out[4 * i + 3] = x0 - x1 + x2 - x3;
  }
}

// sum |H d H| of one 4x4 difference block (pixel.py:satd before the >>1)
__device__ __forceinline__ int abs_had4x4(const int* d) {
  int h[16];
  had4x4(d, h);
  int s = 0;
  for (int i = 0; i < 16; ++i) s += abs(h[i]);
  return s;
}

// a * b wrapped to 32 bits, as XLA's int32 multiply wraps: custom quant
// matrices with small entries push quant4_mf / quant8_mf to ~2.1e5 (4.2e5
// below QP 6), and (bias + |c|) * mf then passes 2^31; signed overflow
// is undefined in C++, so the product is taken in uint32
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// deadzone quantisation (quant.py:quant); the product wraps (wmul) and
// the shift is arithmetic, as in the JAX function
__device__ __forceinline__ int quant(int c, int mf, int bias) {
  int mag = wmul(bias + abs(c), mf) >> 16;
  return c >= 0 ? mag : -mag;
}

// dequant_4x4 with i_qbits = qp/6 - 4 (quant.py:dequant)
__device__ __forceinline__ int dequant(int lv, int dmf, int qpdiv6) {
  int qbits = qpdiv6 - 4;
  int prod = wmul(lv, dmf);
  if (qbits >= 0) return wmul(prod, 1 << qbits);
  return (int)((unsigned)prod + (1u << (-qbits - 1))) >> -qbits;
}

// dequant_4x4_dc after the inverse Hadamard (quant.py:dequant_4x4_dc)
__device__ __forceinline__ int dequant_4x4_dc(int lv, int dmf0, int qpdiv6) {
  int qbits = qpdiv6 - 6;
  if (qbits >= 0) return wmul(lv, wmul(dmf0, 1 << qbits));
  return (int)((unsigned)wmul(lv, dmf0) + (1u << (-qbits - 1))) >> -qbits;
}

// chroma DC dequant after the inverse 2x2 Hadamard (quant.py:dequant_2x2_dc)
__device__ __forceinline__ int dequant_2x2_dc(int x, int dmf0, int qpdiv6) {
  int qbits = qpdiv6 - 5;
  int dmf_eff = wmul(dmf0, 1 << max(qbits, 0));
  return wmul(x, dmf_eff) >> max(-qbits, 0);
}

// decimate-score run costs (x264_decimate_table4, common/quant.c:203)
__constant__ int kDecimateTab4[16] = {3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// x264_decimate_score_internal of n <= 16 levels in scan order
// (quant.py:decimate_score): 9 if any |level| > 1, else the sum over the
// nonzero levels of the run cost of the zeros before each
__device__ __forceinline__ int decimate_score(const int* lv, int n) {
  int score = 0, run = 0;
  for (int i = 0; i < n; ++i) {
    if (lv[i] == 0) { ++run; continue; }
    if (abs(lv[i]) > 1) return 9;
    score += kDecimateTab4[run];
    run = 0;
  }
  return score;
}

// qpel phase (fy << 2 | fx) -> the two half-pel planes (0 fpel, 1 h,
// 2 v, 3 c) whose rounding average is the prediction (common/mc.c:
// 157-158; ops/mc.py:_HPEL_REF0 / _HPEL_REF1, the latter pre-fixed so
// that phases with no averaging average a sample with itself)
__constant__ int kHpelRef0[16] = {0, 1, 1, 1, 0, 1, 1, 1, 2, 3, 3, 3, 0, 1, 1, 1};
__constant__ int kHpelRef1[16] = {0, 0, 1, 0, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2};

// the start jax.lax.dynamic_slice uses for a slice of `size` of an axis
// of `dim` (ops/mc.py:ds_start): a negative start counts from the end
// once, then the start is clamped so that the slice fits
__device__ __forceinline__ int ds_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

// sample (r, c) of an MB's 16x16 luma prediction at the qpel MV (mvx,
// mvy) from a half-pel stack of planes `plane` samples apart, each padded
// by pad (ops/mc.py:mc_luma for one 16x16 block): the rounding average of
// the two half-pel planes the quarter-pel phase names, each block start
// taken as dynamic_slice takes it
__device__ __forceinline__ int mc_luma16(const int* planes, size_t plane,
                                         int Hp, int Wp, int pad, int mx,
                                         int my, int mvx, int mvy, int r,
                                         int c) {
  const int fx = mvx & 3, fy = mvy & 3, qi = (fy << 2) | fx;
  const int iy = my * 16 + (mvy >> 2) + pad, ix = mx * 16 + (mvx >> 2) + pad;
  const int ya = ds_start(iy + (fy == 3), Hp, 16), xa = ds_start(ix, Wp, 16);
  const int yb = ds_start(iy, Hp, 16), xb = ds_start(ix + (fx == 3), Wp, 16);
  const int a = planes[kHpelRef0[qi] * plane + (size_t)(ya + r) * Wp + xa + c];
  const int b = planes[kHpelRef1[qi] * plane + (size_t)(yb + r) * Wp + xb + c];
  return (a + b + 1) >> 1;
}

// bit length of the signed Exp-Golomb code of v (me.py:se_bits)
__device__ __forceinline__ int se_bits(int v) {
  unsigned m = v > 0 ? 2u * (unsigned)v - 1u : 2u * (unsigned)(-v);
  return 2 * (31 - __clz(m + 1u)) + 1;
}

}  // namespace x264t

// The 8x8 transform's device code (High profile), shared by K1
// (intra.cu, the I8x8 ladder), K6 (inter.cu, the 8x8 inter residual and
// the SA8D transform choice) and K13 (rdcost.cu, the RD transform
// choice).
//
// Per-block forms of x264_tpu_torch/ops/dct.py (dct8x8, idct8x8),
// ops/quant.py (dequant at shift base 6, decimate_score on
// DECIMATE_TAB8) and ops/pixel.py (the 8x8 Hadamard of sa8d_8x8 and
// sa8d_16x16), bit-exact with them: int32 arithmetic, arithmetic right
// shifts on negative values (checked below at compile time), no floats;
// and the cat-5 bit walk of the RD choice (ops/rdcost.py:
// residual_bits_i32 on the cat5 table).
#pragma once
#include "common.cuh"
#include "rdcost.cuh"

namespace x264t {

// the transforms below rely on >> of a negative int being arithmetic,
// which nvcc guarantees and C++ only requires from C++20
static_assert((-7 >> 1) == -4 && (-1 >> 2) == -1,
              "signed right shift must be arithmetic");

// 8x8 zig-zag scan: scan position -> raster index (tables.py:ZIGZAG8)
__constant__ int kZig8[64] = {
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// decimate-score run costs of 8x8 blocks (x264_decimate_table8,
// common/quant.c:203)
__constant__ int kDecimateTab8[64] = {3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
                                      1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

// 1-D 8-point forward transform (dct.py:_dct8_1d): x[i * s] -> y[i * t]
__device__ __forceinline__ void dct8_1d(const int* x, int s, int* y, int t) {
  const int s07 = x[0] + x[7 * s], s16 = x[s] + x[6 * s];
  const int s25 = x[2 * s] + x[5 * s], s34 = x[3 * s] + x[4 * s];
  const int a0 = s07 + s34, a1 = s16 + s25, a2 = s07 - s34, a3 = s16 - s25;
  const int d07 = x[0] - x[7 * s], d16 = x[s] - x[6 * s];
  const int d25 = x[2 * s] - x[5 * s], d34 = x[3 * s] - x[4 * s];
  const int a4 = d16 + d25 + (d07 + (d07 >> 1));
  const int a5 = d07 - d34 - (d25 + (d25 >> 1));
  const int a6 = d07 + d34 - (d16 + (d16 >> 1));
  const int a7 = d16 - d25 + (d34 + (d34 >> 1));
  y[0] = a0 + a1;
  y[t] = a4 + (a7 >> 2);
  y[2 * t] = a2 + (a3 >> 1);
  y[3 * t] = a5 + (a6 >> 2);
  y[4 * t] = a0 - a1;
  y[5 * t] = a6 - (a5 >> 2);
  y[6 * t] = (a2 >> 1) - a3;
  y[7 * t] = (a4 >> 2) - a7;
}

// 1-D 8-point inverse butterfly (dct.py:_idct8_1d)
__device__ __forceinline__ void idct8_1d(const int* x, int s, int* y, int t) {
  const int a0 = x[0] + x[4 * s], a2 = x[0] - x[4 * s];
  const int a4 = (x[2 * s] >> 1) - x[6 * s], a6 = (x[6 * s] >> 1) + x[2 * s];
  const int b0 = a0 + a6, b2 = a2 + a4, b4 = a2 - a4, b6 = a0 - a6;
  const int x1 = x[s], x3 = x[3 * s], x5 = x[5 * s], x7 = x[7 * s];
  const int a1 = -x3 + x5 - x7 - (x7 >> 1);
  const int a3 = x1 + x7 - x3 - (x3 >> 1);
  const int a5 = -x1 + x7 + x5 + (x5 >> 1);
  const int a7 = x3 + x5 + x1 + (x1 >> 1);
  const int b1 = (a7 >> 2) + a1, b3 = a3 + (a5 >> 2);
  const int b5 = (a3 >> 2) - a5, b7 = a7 - (a1 >> 2);
  y[0] = b0 + b7;
  y[t] = b2 + b5;
  y[2 * t] = b4 + b3;
  y[3 * t] = b6 + b1;
  y[4 * t] = b6 - b1;
  y[5 * t] = b4 - b3;
  y[6 * t] = b2 - b5;
  y[7 * t] = b0 - b7;
}

// forward 8x8 transform of a raster residual (dct.py:dct8x8): columns
// first, then rows (the intermediates truncate, so the order matters)
__device__ __forceinline__ void dct8x8(const int* d, int* out) {
  int t[64];
  for (int c = 0; c < 8; ++c) dct8_1d(d + c, 8, t + c, 8);
  for (int r = 0; r < 8; ++r) dct8_1d(t + 8 * r, 1, out + 8 * r, 1);
}

// inverse 8x8 transform incl. the +32 at [0][0] and the >> 6
// (dct.py:idct8x8): rows first, then columns
__device__ __forceinline__ void idct8x8(const int* c, int* out) {
  int in[64], t[64];
  for (int i = 0; i < 64; ++i) in[i] = c[i];
  in[0] += 32;
  for (int r = 0; r < 8; ++r) idct8_1d(in + 8 * r, 1, t + 8 * r, 1);
  for (int k = 0; k < 8; ++k) idct8_1d(t + k, 8, in + k, 8);
  for (int i = 0; i < 64; ++i) out[i] = in[i] >> 6;
}

// dequant_8x8: i_qbits = qp/6 - 6, a rounded right shift when negative
// (quant.py:dequant with shift_base 6)
__device__ __forceinline__ int dequant8(int lv, int dmf, int qpdiv6) {
  const int qbits = qpdiv6 - 6;
  const int prod = lv * dmf;
  if (qbits >= 0) return prod * (1 << qbits);
  return (prod + (1 << (-qbits - 1))) >> -qbits;
}

// sum |H8 d H8| of one raster 8x8 difference block (pixel.py:sa8d_8x8
// before its (+2) >> 2)
__device__ __forceinline__ int abs_had8x8(const int* d) {
  int t[64];
  for (int c = 0; c < 8; ++c) {          // columns: H8 d
    int a[8];
    for (int i = 0; i < 8; ++i) a[i] = d[8 * i + c];
    for (int h = 1; h < 8; h <<= 1)
      for (int i = 0; i < 8; ++i)
        if (!(i & h)) {
          const int p = a[i], q = a[i + h];
          a[i] = p + q;
          a[i + h] = p - q;
        }
    for (int i = 0; i < 8; ++i) t[8 * i + c] = a[i];
  }
  int s = 0;
  for (int r = 0; r < 8; ++r) {          // rows: (H8 d) H8
    int a[8];
    for (int i = 0; i < 8; ++i) a[i] = t[8 * r + i];
    for (int h = 1; h < 8; h <<= 1)
      for (int i = 0; i < 8; ++i)
        if (!(i & h)) {
          const int p = a[i], q = a[i + h];
          a[i] = p + q;
          a[i + h] = p - q;
        }
    for (int i = 0; i < 8; ++i) s += abs(a[i]);
  }
  return s;
}

// x264_decimate_score_internal of 64 levels in 8x8 scan order
// (quant.py:decimate_score with DECIMATE_TAB8)
__device__ __forceinline__ int decimate_score8(const int* lv) {
  int score = 0, run = 0;
  for (int i = 0; i < 64; ++i) {
    if (lv[i] == 0) { ++run; continue; }
    if (abs(lv[i]) > 1) return 9;
    score += kDecimateTab8[run];
    run = 0;
  }
  return score;
}

// CABAC bits (1/256 units) of one 8x8 block's 64 levels in scan order
// (ctxBlockCat 5) with the packed RD tables of rdcost.py:pack_rdbits:
// rdcost.cuh's walk, whose layout holds 64 sig / last pairs
__device__ __forceinline__ int residual_bits8(const int* lv,
                                              const int* __restrict__ rdtab) {
  return residual_bits(lv, 64, rdtab + 5 * RD_CAT_STRIDE);
}

}  // namespace x264t

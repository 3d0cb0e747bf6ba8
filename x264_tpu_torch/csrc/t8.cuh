// The 8x8 transform's device code (High profile), shared by K1
// (intra.cu, the I8x8 ladder), K6 (inter.cu, the 8x8 inter residual and
// the SA8D transform choice) and K13 (rdcost.cu, the RD transform
// choice).
//
// The 1-D passes of x264_tpu_torch/ops/dct.py (dct8x8, idct8x8), and
// the forms of ops/quant.py (dequant at shift base 6, decimate_score's
// DECIMATE_TAB8) and ops/pixel.py (the 8x8 Hadamard of sa8d_8x8 and
// sa8d_16x16) that the kernels run on lanes, bit-exact with them: int32 arithmetic, arithmetic right
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

// dequant_8x8: i_qbits = qp/6 - 6, a rounded right shift when negative
// (quant.py:dequant with shift_base 6)
__device__ __forceinline__ int dequant8(int lv, int dmf, int qpdiv6) {
  const int qbits = qpdiv6 - 6;
  const int prod = wmul(lv, dmf);
  if (qbits >= 0) return wmul(prod, 1 << qbits);
  return (int)((unsigned)prod + (1u << (-qbits - 1))) >> -qbits;
}

// the 8-point Hadamard butterfly of sa8d_8x8, in place
__device__ __forceinline__ void had8_1d(int* a) {
  for (int h = 1; h < 8; h <<= 1)
    for (int i = 0; i < 8; ++i)
      if (!(i & h)) {
        const int p = a[i], q = a[i + h];
        a[i] = p + q;
        a[i + h] = p - q;
      }
}

// CABAC bits (1/256 units) of one 8x8 block's 64 levels in scan order
// (ctxBlockCat 5) with the packed RD tables of rdcost.py:pack_rdbits:
// rdcost.cuh's walk, whose layout holds 64 sig / last pairs
__device__ __forceinline__ int residual_bits8(const int* lv,
                                              const int* __restrict__ rdtab) {
  return residual_bits(lv, 64, rdtab + 5 * RD_CAT_STRIDE);
}

}  // namespace x264t

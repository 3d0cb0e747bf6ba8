// The RD ladder's device code, shared by K13 (rdcost.cu, the inter RD
// cost) and K7 (intra_p.cu, the intra RD cost of sweep 0).
//
// Per-block forms of x264_tpu_torch/ops/rdcost.py (residual_bits_i32,
// the row-15a functions of x264_tpu/ops/rdcost.py:34-98) and of
// ops/pixel.py:ac_energy, bit-exact with them. Every bit-table entry and
// every ue_big_f8 is an integer in 1/256-bit units, so the walks sum in
// int32; the callers turn the sums into float once and then evaluate the
// float steps of x264_tpu's expressions in their order with the _rn
// intrinsics, which nvcc never contracts into an FMA.
#pragma once
#include "common.cuh"

namespace x264t {

// int32 layout of one category in the packed table (rdcost.py:
// pack_rdbits): sig (C, 2), last (C, 2), l1 (8, 2), unary (8, 15)
constexpr int RD_SIG = 0, RD_LAST = 128, RD_L1 = 256, RD_UNARY = 272;
constexpr int RD_CAT_STRIDE = 392;

// the level node-context machine (trellis.py:NODE_TRANS), [gt1][node]
__constant__ int kNodeTrans[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                     {4, 4, 4, 4, 5, 6, 7, 7}};

// bs_size_ue_big(v) << 8 (trellis.py:_ue_big_f8)
__device__ __forceinline__ int ue_big_f8(int v) {
  unsigned n = (unsigned)v + 1u;
  return (2 * (31 - __clz(n)) + 1) << 8;
}

// CABAC bits (1/256 units) of n levels in scan order with the category
// table tab (rdcost.py:residual_bits_i32): the sig flags of positions
// <= last (capped at n - 2) and the last flags of the significant ones,
// then the levels in reverse scan order through the node machine
__device__ __forceinline__ int residual_bits(const int* lv, int n,
                                             const int* __restrict__ tab) {
  int last = -1;
  for (int i = 0; i < n; ++i)
    if (lv[i] != 0) last = i;
  int bits = 0;
  for (int i = 0; i < n - 1 && i <= last; ++i) {
    const int nz = lv[i] != 0;
    bits += tab[RD_SIG + 2 * i + nz];
    if (nz) bits += tab[RD_LAST + 2 * i + (last == i)];
  }
  int node = 0;
  for (int i = last; i >= 0; --i) {
    const int a = abs(lv[i]);
    if (a == 0) continue;
    const int prefix = min(a - 1, 14), gt1 = prefix > 0;
    int step = tab[RD_L1 + 2 * node + gt1];
    if (gt1)
      step += tab[RD_UNARY + 15 * node + prefix] + (a >= 15 ? ue_big_f8(a - 15) : 0);
    else
      step += 256;                          // the sign's bypass bin
    bits += step;
    node = kNodeTrans[gt1][node];
  }
  return bits;
}

// SATD against zero of a 16x16 tile from its 16 per-4x4 Hadamard
// abs-sums (raster blocks), halved per 8x4 pair as pixel.py:satd does,
// less (pixel sum >> 1): pixel.py:ac_energy
__device__ __forceinline__ int ac_energy16(const int* had, int pixel_sum) {
  int s = 0;
  for (int by = 0; by < 4; ++by)
    for (int p = 0; p < 2; ++p)
      s += (had[4 * by + 2 * p] + had[4 * by + 2 * p + 1]) >> 1;
  return s - (pixel_sum >> 1);
}

// |Hadamard| abs-sum of raster 4x4 block k of a 16x16 tile read through
// px(y, x), against zero
template <class Px>
__device__ __forceinline__ int tile_had16(int k, Px px) {
  int d[16];
  const int by = k >> 2, bx = k & 3;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) d[4 * r + c] = px(4 * by + r, 4 * bx + c);
  return abs_had4x4(d);
}

// sum over a CTA's threads of one int per thread (red: blockDim.x ints of
// shared memory); every thread gets the sum
__device__ __forceinline__ int cta_sum(int* red, int v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const int out = red[0];
  __syncthreads();
  return out;
}

}  // namespace x264t

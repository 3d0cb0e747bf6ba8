// K21 lowres_bcost: the lowres costs of the b-adapt lookahead.
//
// Replaces x264_tpu/encoder/lookahead.py:251 _fetch_blocks and the block
// costs and interior sums of :272 badapt_first_fused, :310
// badapt_ext_fused, :325 b_seed_mvs_fused and :341 b_cost_fused (each a
// composition of launches of this kernel: encoder/lookahead.py
// badapt_first, badapt_ext, b_seed_mvs, b_cost). Plain twin:
// x264_tpu_torch/encoder/lookahead.py:lowres_bcost_plain; wrapper:
// lowres_bcost.
//
// Design. One 128-thread CTA per 8x8 lowres block, running K15's block
// code (lowres.cuh): the intra cost i, the inter cost and half-pel MV
// against ref0 (c0, mv0) and, where given, ref1 (c1, mv1). With bi, the
// 64 threads then fetch one sample each of the two predictions as
// _fetch_blocks does (the full-pel part mv >> 1 clipped to [-r, r], the
// phase plane (mvy & 1) * 2 + (mvx & 1), samples clamped into the
// plane), average them with rounding, and 4 threads take the 4x4
// Hadamards of the difference: bi = SATD + the se_bits of the four MV
// components. Thread 0 adds the interior block's terms to the six sums
// by integer atomics (order-free): min(c0, i), min(c1, i),
// min(c0, c1, bi, i), i < c0, i < c1 and 1; the host reads those 24
// bytes, and b_seed_mvs the MV fields.
// What bounds it on the H100: operations, as K15: one or two dense
// (2r + 1)^2 searches per block (~0.45 G integer ops each at 1080p and
// r = 8, ~0.007 ms at 67 T/s).
#include "lowres.cuh"

using namespace x264t;
using namespace x264t::lowres;

namespace {

__global__ void __launch_bounds__(NT) bcost_kernel(
    const int* __restrict__ cur, const int* __restrict__ ref0,
    const int* __restrict__ ref1, int h2, int w2, int bh, int bw, int r,
    int all_blocks, int bi, int* __restrict__ sums, int* __restrict__ mv0_o,
    int* __restrict__ mv1_o) {
  const int blk = blockIdx.x, bx = blk % bw, by = blk / bw;
  const int tid = threadIdx.x;
  __shared__ Shared S;
  __shared__ int c0, m0x, m0y, d[64], hb[4];
  load_block(S, cur, h2, w2, by, bx);
  intra_cost(S, by > 0, bx > 0);
  inter_cost(S, ref0, h2, w2, bh, bw, r, by, bx);
  if (tid == 0) {
    c0 = S.cost;
    m0x = S.mvx;
    m0y = S.mvy;
    if (mv0_o) {
      mv0_o[2 * blk] = S.mvx;
      mv0_o[2 * blk + 1] = S.mvy;
    }
  }
  __syncthreads();
  int c1 = BIG, bic = BIG;
  if (ref1 != nullptr) {
    inter_cost(S, ref1, h2, w2, bh, bw, r, by, bx);
    c1 = S.cost;
    if (tid == 0 && mv1_o) {
      mv1_o[2 * blk] = S.mvx;
      mv1_o[2 * blk + 1] = S.mvy;
    }
    if (bi) {
      if (tid < 64) {
        const int i = tid >> 3, j = tid & 7;
        auto fetch = [&](const int* P, int mx, int my) {
          const int ph = (my & 1) * 2 + (mx & 1);
          const int y = 8 * by + min(max(my >> 1, -r), r) + i;
          const int x = 8 * bx + min(max(mx >> 1, -r), r) + j;
          return low(P + ph * h2 * w2, h2, w2, y, x);
        };
        const int a = fetch(ref0, m0x, m0y), b = fetch(ref1, S.mvx, S.mvy);
        d[tid] = S.c[tid] - ((a + b + 1) >> 1);
      }
      __syncthreads();
      if (tid < 4) {
        int dd[16];
        for (int k = 0; k < 16; ++k)
          dd[k] = d[(4 * (tid >> 1) + (k >> 2)) * 8 + 4 * (tid & 1) + (k & 3)];
        hb[tid] = abs_had4x4(dd);
      }
      __syncthreads();
      bic = satd8(hb) + se_bits(m0x) + se_bits(m0y) + se_bits(S.mvx)
          + se_bits(S.mvy);
    }
  }
  const bool inner = all_blocks
      || (by >= 1 && by < bh - 1 && bx >= 1 && bx < bw - 1);
  if (tid == 0 && inner) {
    const int i = S.icost;
    atomicAdd(&sums[0], min(c0, i));
    atomicAdd(&sums[3], (int)(i < c0));
    atomicAdd(&sums[5], 1);
    if (ref1 != nullptr) {
      atomicAdd(&sums[1], min(c1, i));
      atomicAdd(&sums[4], (int)(i < c1));
      if (bi) atomicAdd(&sums[2], min(min(c0, c1), min(bic, i)));
    }
  }
}

}  // namespace

extern "C" int lowres_bcost(const int* cur, const int* ref0, const int* ref1,
                            int h2, int w2, int bh, int bw, int r,
                            int all_blocks, int bi, int* sums, int* mv0,
                            int* mv1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (r < 0 || r > MAX_R || (bi && ref1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(sums, 0, 6 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  bcost_kernel<<<bh * bw, NT, 0, s>>>(cur, ref0, ref1, h2, w2, bh, bw, r,
                                      all_blocks, bi, sums, mv0, mv1);
  return (int)cudaGetLastError();
}

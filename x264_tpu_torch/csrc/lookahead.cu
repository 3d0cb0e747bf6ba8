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
// K15: one 128-thread CTA per 8x8 lowres block (68 x 120 at 1080p),
// running the block-cost device code of lowres.cuh (shared with K21):
// the intra cost, and against the previous frame's planes the full-pel
// search and the half-pel re-score. The block costs go to icost / pcost, and
// the interior blocks' icost and min(pcost, icost) into the two sums by
// integer atomics, which are order-free; the host reads those 8 bytes.
// What bounds it on the H100: operations. K15 does ~289 x 64 x 3 integer
// ops per block at r = 8 (~0.45 G at 1080p, 0.007 ms at 67 T/s); K14 moves
// ~17 MB at 1080p (the luma and the planes as int32, 0.005 ms).
#include "lowres.cuh"

using namespace x264t;
using namespace x264t::lowres;

namespace {

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

__global__ void __launch_bounds__(NT) cost_kernel(
    const int* __restrict__ cur, const int* __restrict__ prev, int h2, int w2,
    int bh, int bw, int r, int all_blocks, int* __restrict__ icost,
    int* __restrict__ pcost, int* __restrict__ sums) {
  const int blk = blockIdx.x, bx = blk % bw, by = blk / bw;
  __shared__ Shared S;
  load_block(S, cur, h2, w2, by, bx);
  intra_cost(S, by > 0, bx > 0);
  const bool inner = all_blocks
      || (by >= 1 && by < bh - 1 && bx >= 1 && bx < bw - 1);
  if (prev == nullptr) {                 // the first frame: [s, s]
    if (threadIdx.x == 0) {
      icost[blk] = S.icost;
      if (inner) {
        atomicAdd(&sums[0], S.icost);
        atomicAdd(&sums[1], S.icost);
      }
    }
    return;
  }
  inter_cost(S, prev, h2, w2, bh, bw, r, by, bx);
  if (threadIdx.x == 0) {
    icost[blk] = S.icost;
    pcost[blk] = S.cost;
    if (inner) {
      atomicAdd(&sums[0], S.icost);
      atomicAdd(&sums[1], min(S.cost, S.icost));
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

// K20 trellis_scan: the batched CABAC trellis over N blocks of one
// category.
//
// Replaces x264_tpu/ops/trellis.py:236 trellis_scan (with its consts
// shared by every block, or row-gathered from the 52-QP stacks of
// make_consts_all_qp by a per-block qp_idx). Plain twin:
// x264_tpu_torch/ops/trellis.py:trellis_scan_plain; wrapper:
// trellis_scan. The device code is trellis.cuh's trellis_lanes, which K6
// and K22 run inside their inter residual too.
//
// Design. 8 lanes a block (one per trellis node), 4 blocks a warp, 16 a
// 128-thread CTA, one launch. The CTA stages its blocks' coefficients
// (one coalesced run of 16 * C ints) and, with a shared table, the
// category's table in shared memory; with a QP index each block's lanes
// read their row of the stack through L1. A block past N runs on a copy
// of the last block and writes nothing, so that every lane of a warp
// takes part in the shuffles.
// What bounds it on the H100: latency and the instructions a position
// takes on every lane, as trellis.cuh says; the bytes are the
// coefficients in and the levels out.
#include "trellis.cuh"

using namespace x264t;

namespace {

constexpr int NT = 128, NB = NT / 8;

template <int C>
__global__ void __launch_bounds__(NT) trellis_kernel(
    const int* __restrict__ coefs, const int* __restrict__ tab,
    const int* __restrict__ qp_idx, int* __restrict__ out, int n) {
  // each block's coefficients, distortions and history bytes, a block's
  // rows tr_pad apart
  __shared__ int cf[NB][tr_pad(C)];
  __shared__ int st[trellis_ints(C)];
  __shared__ float ssd[NB][tr_pad(2 * C)];
  __shared__ unsigned char hist[NB][4 * tr_pad(2 * C)];
  const int tid = threadIdx.x, b0 = blockIdx.x * NB;
  for (int i = tid; i < NB * C; i += NT)
    cf[i / C][i % C] = coefs[(size_t)min(b0 + i / C, n - 1) * C + i % C];
  if (!qp_idx)
    for (int i = tid; i < trellis_ints(C); i += NT) st[i] = tab[i];
  __syncthreads();
  const int k = tid >> 3, b = min(b0 + k, n - 1);
  const int* row = qp_idx ? tab + (size_t)qp_idx[b] * trellis_ints(C) : st;
  int* o = out + (size_t)b * C;
  const bool live = b0 + k < n;
  trellis_lanes<C>(cf[k], trellis_tab(row, C), ssd[k], hist[k],
                   [&](int i, int v) {
                     if (live) o[i] = v;
                   });
}

}  // namespace

extern "C" int trellis_scan(const int* coefs, const int* tab, const int* qp_idx,
                            int* out, int n, int C, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + NB - 1) / NB);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 4: trellis_kernel<4><<<grid, NT, 0, s>>>(coefs, tab, qp_idx, out, n); break;
    case 15: trellis_kernel<15><<<grid, NT, 0, s>>>(coefs, tab, qp_idx, out, n); break;
    case 16: trellis_kernel<16><<<grid, NT, 0, s>>>(coefs, tab, qp_idx, out, n); break;
    case 64: trellis_kernel<64><<<grid, NT, 0, s>>>(coefs, tab, qp_idx, out, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

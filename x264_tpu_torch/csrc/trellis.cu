// K20 trellis_scan: the batched CABAC trellis over N blocks of one
// category.
//
// Replaces x264_tpu/ops/trellis.py:236 trellis_scan (with its consts
// shared by every block, or row-gathered from the 52-QP stacks of
// make_consts_all_qp by a per-block qp_idx). Plain twin:
// x264_tpu_torch/ops/trellis.py:trellis_scan_plain; wrapper:
// trellis_scan. The device code is trellis.cuh's trellis_block, which K6
// runs inside its inter residual too.
//
// Design. One thread per block, 128 threads a CTA, one launch. The
// thread reads its C coefficients and its table row (the shared table,
// or row qp_idx[b] of the stack) from global memory, keeps the 8 node
// scores in registers and the backtrack history (one byte per position
// and node) in local memory, and writes its C levels.
// What bounds it on the H100: operations. Per position it scores 2
// candidates from 8 nodes (a handful of float and integer operations
// each); the bytes are the coefficients in and the levels out. A thread
// per block with scattered row reads keeps it far from either bound; a
// later PR can give a block a warp.
#include "trellis.cuh"

using namespace x264t;

namespace {

constexpr int NT = 128;

template <int C>
__global__ void __launch_bounds__(NT) trellis_kernel(
    const int* __restrict__ coefs, const int* __restrict__ tab,
    const int* __restrict__ qp_idx, int* __restrict__ out, int n) {
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= n) return;
  const int* row = tab + (qp_idx ? (size_t)qp_idx[b] * trellis_ints(C) : 0);
  const TrellisTab t = trellis_tab(row, C);
  int cf[C], lv[C];
  for (int i = 0; i < C; ++i) cf[i] = coefs[(size_t)b * C + i];
  trellis_block<C>(cf, t, lv);
  for (int i = 0; i < C; ++i) out[(size_t)b * C + i] = lv[i];
}

}  // namespace

extern "C" int trellis_scan(const int* coefs, const int* tab, const int* qp_idx,
                            int* out, int n, int C, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + NT - 1) / NT);
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

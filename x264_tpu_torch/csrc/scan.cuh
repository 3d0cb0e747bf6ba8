// The exclusive scan shared by K3 / K8 (csrc/cabac_ops.cu: op counts ->
// op offsets) and K18 / K19 (csrc/cavlc.cu: bit counts -> bit offsets):
// one CTA of SCAN_NT threads, each summing a contiguous run of the
// counts, a Hillis-Steele scan of the partial sums in shared memory, and
// a second pass over each run writing the offsets.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SCAN_NT = 1024;

// exclusive scan of counts[0..n) into offsets[0..n], offsets[n] = total
__global__ void __launch_bounds__(SCAN_NT) scan_kernel(
    const int* __restrict__ counts, int* __restrict__ offsets, int n) {
  __shared__ int part[SCAN_NT];
  const int t = threadIdx.x;
  const int per = (n + SCAN_NT - 1) / SCAN_NT;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_NT; off <<= 1) {     // Hillis-Steele inclusive
    int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - s;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (t == SCAN_NT - 1) offsets[n] = part[t];
}

}  // namespace

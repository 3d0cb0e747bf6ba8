// K27 hw_pack: the halfword packing of a compacted CABAC op stream.
//
// Replaces x264_tpu/entropy/cabac_planes.py:455 hw_pack, which every CABAC
// band program of x264_tpu/parallel/rows.py runs on its compact_ops output
// before the op stream crosses to the host. Each live op (the first n_ops,
// read on the device) becomes one 16-bit halfword, 0 | kind << 12 |
// (b << HW_A_BITS[kind]) | a, where a and b fit in the 12 payload bits, or
// three, (0x8000 | kind << 12 | b), (a & 0x7FFF), (a >> 15); an op's
// halfwords start at the exclusive scan of the counts; those at or past
// cap_hw (even) are dropped; the total is kept even past capacity. Plain
// twin: x264_tpu_torch/entropy/cabac_planes.py:hw_pack_plain; wrapper:
// hw_pack.
//
// Design: three launches. Pass one: a CTA of 256 threads takes 2048 ops
// (coalesced, 8 strided loads a thread) and sums their halfword counts.
// One CTA then scans the per-CTA sums in place (exclusive; the total
// after the last), and writes the spare high halfword of an odd total as
// 0. Pass two: each CTA stages its 2048 ops in shared memory, each thread
// takes 8 consecutive ones, a warp-shuffle scan of the 256 thread sums
// gives each op its offset, and the halfwords go to a uint16 view of the
// output words. Low halfword first is little-endian order, so no two
// threads write the same bytes and no atomics are needed. CTAs past the
// live ops return at once. A single-pass scan with decoupled look-back
// would save pass one's read; that is later work.
// What bounds it on the H100: bytes. It reads the live ops twice (4 bytes
// each) and writes 2 to 6 bytes an op: at 1080p some 1.3 M live ops, ~10 MB,
// ~3 us at 3.35 TB/s; the three launches' latency is of the same order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256, kPer = 8, kTile = kThreads * kPer;
constexpr int kScanThreads = 1024;

// a copy of x264_tpu_torch/entropy/cabac.py:HW_A_BITS, the one definition
__constant__ int kAbits[8] = {11, 8, 9, 11, 0, 9, 0, 11};

__device__ __forceinline__ bool is_small(uint32_t op) {
  const uint32_t kind = op >> 29, a = op & 0x1FFFFu, b = (op >> 17) & 0xFFFu;
  const int ab = kAbits[kind];
  return a < (1u << ab) && b < (1u << (12 - ab));
}

// exclusive scan of one value a thread over a CTA of nthreads (a multiple
// of 32, at most 1024); *total gets the sum. warp_sums: 32 ints of shared.
__device__ int cta_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;   // inclusive warp prefix
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();                            // warp_sums free for reuse
  return before + x - v;
}

__global__ void hwpack_count(const uint32_t* __restrict__ ops,
                             const int* __restrict__ n_ops,
                             int* __restrict__ sums, int n) {
  __shared__ int warp_sums[32];
  const int live = min(*n_ops, n);
  const int base = blockIdx.x * kTile;
  int c = 0;
  if (base < live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      if (i < live) c += is_small(ops[i]) ? 1 : 3;
    }
  }
  int total;
  cta_exclusive_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// one CTA: sums[0..nblk) become exclusive offsets, sums[nblk] the total
__global__ void hwpack_scan(int* __restrict__ sums, uint16_t* __restrict__ hw,
                            int nblk, int cap_hw) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int start = 0; start < nblk; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int v = i < nblk ? sums[i] : 0;
    int total;
    const int ex = cta_exclusive_scan(v, warp_sums, &total);
    if (i < nblk) sums[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    sums[nblk] = carry;
    // the spare high halfword of an odd count: x264_tpu's buffer is zero
    if ((carry & 1) && carry < cap_hw) hw[carry] = 0;
  }
}

__global__ void hwpack_write(const uint32_t* __restrict__ ops,
                             const int* __restrict__ n_ops,
                             const int* __restrict__ offs,
                             uint16_t* __restrict__ hw, int n, int cap_hw) {
  __shared__ uint32_t tile[kTile];
  __shared__ int warp_sums[32];
  const int live = min(*n_ops, n);
  const int base = blockIdx.x * kTile;
  if (base >= live) return;                   // uniform over the CTA
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * kThreads + threadIdx.x, i = base + j;
    tile[j] = i < live ? ops[i] : 0u;
  }
  __syncthreads();
  const int first = threadIdx.x * kPer;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (base + first + k < live) c += is_small(tile[first + k]) ? 1 : 3;
  int total;
  int off = offs[blockIdx.x] + cta_exclusive_scan(c, warp_sums, &total);
  for (int k = 0; k < kPer; ++k) {
    if (base + first + k >= live) break;
    const uint32_t op = tile[first + k];
    const uint32_t kind = op >> 29, a = op & 0x1FFFFu,
                   b = (op >> 17) & 0xFFFu;
    if (is_small(op)) {
      if (off < cap_hw)
        hw[off] = (uint16_t)((kind << 12) | (b << kAbits[kind]) | a);
      off += 1;
    } else {
      if (off < cap_hw) hw[off] = (uint16_t)(0x8000u | (kind << 12) | b);
      if (off + 1 < cap_hw) hw[off + 1] = (uint16_t)(a & 0x7FFFu);
      if (off + 2 < cap_hw) hw[off + 2] = (uint16_t)(a >> 15);
      off += 3;
    }
  }
}

}  // namespace

// ops: (n,) int32 bit patterns of the compacted op stream; n_ops: its
// live count (int32 on the device); sums: (nblk + 1,) int32 scratch, the
// total left in sums[nblk]; words: (cap_hw / 2,) int32, two halfwords a
// word; nblk = ceil(n / 2048); cap_hw even.
extern "C" int hw_pack(const int* ops, const int* n_ops, int* sums,
                       int* words, int n, int nblk, int cap_hw,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* o = reinterpret_cast<const uint32_t*>(ops);
  uint16_t* hw = reinterpret_cast<uint16_t*>(words);
  if (nblk > 0) {
    hwpack_count<<<nblk, kThreads, 0, s>>>(o, n_ops, sums, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  hwpack_scan<<<1, kScanThreads, 0, s>>>(sums, hw, nblk, cap_hw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nblk == 0) return (int)e;
  hwpack_write<<<nblk, kThreads, 0, s>>>(o, n_ops, sums, hw, n, cap_hw);
  return (int)cudaGetLastError();
}

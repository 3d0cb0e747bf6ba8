// K9 hpel_planes: the half-pel planes of a padded reference frame.
//
// Replaces x264_tpu/ops/mc.py:57 hpel_planes (with _tap6, :45). Plain
// twin: x264_tpu_torch/ops/mc.py:hpel_planes_plain; wrapper: hpel_planes.
//
// Output: the (4, Hp, Wp) int32 stack [fpel, h, v, c] of an (Hp, Wp)
// padded plane (hpel_filter, common/mc.c:133-155; spec 8.4.2.2.1):
//   h(y, x) = clip((T(row y, columns x-2 .. x+3) + 16) >> 5),
//   v(y, x) = clip((V(y, x) + 16) >> 5),
//   c(y, x) = clip((T over V(y, x-2 .. x+3) + 512) >> 10),
// with T the 6-tap (1, -5, 20, 20, -5, 1), V(y, x) the *unrounded*
// vertical tap over rows y-2 .. y+3, and every coordinate clamped into
// the plane (x264_tpu pads the input by 3 more edge samples).
//
// Design. One launch; one 256-thread CTA per 32x32 output tile. The CTA
// stages the tile and its apron (2 samples before, 3 after, on both
// axes: 37x37) in shared memory with clamped reads, then the unrounded
// vertical taps of the tile's 32 rows over all 37 apron columns, then
// writes the four planes: each thread 4 outputs a plane.
// What bounds it on the H100: bytes. At 1080p the padded plane is
// 1152x1984 int32 (9.1 MB in) and the stack 36.6 MB out: ~13.7 us at
// 3.35 TB/s; ~0.1 G integer operations (~1.5 us at the ALU rate).
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int TILE = 32;
constexpr int APRON = TILE + 5;                 // 2 before, 3 after
constexpr int NT = 256;

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a + f - 5 * (b + e) + 20 * (c + d);
}

__global__ void __launch_bounds__(NT) hpel_kernel(const int* __restrict__ src,
                                                  int* __restrict__ out,
                                                  int hp, int wp) {
  __shared__ int s[APRON][APRON];               // rows y0-2 .. y0+34
  __shared__ int vt[TILE][APRON];               // V(y, x0-2 .. x0+34)
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  for (int i = tid; i < APRON * APRON; i += NT) {
    const int r = i / APRON, c = i % APRON;
    const int y = min(max(y0 - 2 + r, 0), hp - 1);
    const int x = min(max(x0 - 2 + c, 0), wp - 1);
    s[r][c] = src[(size_t)y * wp + x];
  }
  __syncthreads();
  for (int i = tid; i < TILE * APRON; i += NT) {
    const int r = i / APRON, c = i % APRON;
    vt[r][c] = tap6(s[r][c], s[r + 1][c], s[r + 2][c], s[r + 3][c],
                    s[r + 4][c], s[r + 5][c]);
  }
  __syncthreads();
  const size_t plane = (size_t)hp * wp;
  for (int i = tid; i < TILE * TILE; i += NT) {
    const int r = i / TILE, c = i % TILE;
    const int y = y0 + r, x = x0 + c;
    if (y >= hp || x >= wp) continue;
    const int* sr = &s[r + 2][c];               // columns x-2 .. x+3
    const int* vr = &vt[r][c];
    const size_t o = (size_t)y * wp + x;
    out[o] = sr[2];
    out[plane + o] = clip255((tap6(sr[0], sr[1], sr[2], sr[3], sr[4], sr[5]) + 16) >> 5);
    out[2 * plane + o] = clip255((vr[2] + 16) >> 5);
    out[3 * plane + o] = clip255((tap6(vr[0], vr[1], vr[2], vr[3], vr[4], vr[5]) + 512) >> 10);
  }
}

}  // namespace

extern "C" int hpel_planes(const int* padded, int* out, int hp, int wp,
                           void* stream) {
  dim3 grid((wp + TILE - 1) / TILE, (hp + TILE - 1) / TILE);
  hpel_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(padded, out, hp, wp);
  return (int)cudaGetLastError();
}

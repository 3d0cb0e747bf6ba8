// K30 hadamard_ac: the AC Hadamard complexity pair of a batch of tiles.
//
// Replaces x264_tpu/ops/pixel.py:hadamard_ac (x264_pixel_hadamard_ac,
// common/pixel.c:306-358) on (..., H, W) int32 tiles with H, W in {8, 16}:
// per 8x8 quadrant the abs-sum of its four 4x4 Hadamards and the abs-sum
// of its 8x8 Hadamard, each minus the quadrant's sample sum (the DC of
// both); the quadrants' values added, then >> 1 (satd_ac) and >> 2
// (sa8d_ac). Plain twin: x264_tpu_torch/ops/pixel.py:hadamard_ac_plain;
// wrapper: hadamard_ac.
//
// Design. One thread per 8x8 quadrant: it loads its 64 samples into
// registers and runs the 1-D butterflies over rows, then columns, for
// the 4x4 and the 8x8 transforms (the abs-sums do not depend on the
// Hadamard's row order or signs, so the butterflies equal x264_tpu's
// matrix products). The nq = (H / 8) (W / 8) quadrants of a tile sit on
// nq consecutive lanes of a warp (nq is 1, 2 or 4) and add with
// __shfl_xor_sync; the tile's first lane shifts and writes. Every sum is
// taken modulo 2^32, as x264_tpu's int32 products and sums wrap, so the
// result is exact for any int32 input.
// What bounds it on the H100: bytes. It reads each sample once (8.4 MB
// for a 1080p frame's 16x16 tiles, 2.5 us at 3.35 TB/s) for ~30 integer
// operations a sample.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ void had4(unsigned* a, int s) {
  const unsigned a0 = a[0], a1 = a[s], a2 = a[2 * s], a3 = a[3 * s];
  const unsigned b0 = a0 + a1, b1 = a0 - a1, b2 = a2 + a3, b3 = a2 - a3;
  a[0] = b0 + b2; a[s] = b1 + b3; a[2 * s] = b0 - b2; a[3 * s] = b1 - b3;
}

__device__ __forceinline__ void had8(unsigned* a, int s) {
  unsigned b[8];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = a[i * s] + a[(i + 4) * s];
    b[i + 4] = a[i * s] - a[(i + 4) * s];
  }
  had4(b, 1);
  had4(b + 4, 1);
  #pragma unroll
  for (int i = 0; i < 8; ++i) a[i * s] = b[i];
}

__device__ __forceinline__ unsigned uabs(unsigned x) {
  return (int)x < 0 ? 0u - x : x;
}

__global__ void __launch_bounds__(NT) hadamard_ac_kernel(
    const int* __restrict__ pix, int* __restrict__ satd_o,
    int* __restrict__ sa8d_o, int n_tiles, int th, int tw) {
  const int nqw = tw / 8, nq = (th / 8) * nqw;
  const long long q = (long long)blockIdx.x * NT + threadIdx.x;
  const long long tile = q / nq;
  const int k = (int)(q % nq);
  unsigned s4 = 0, s8 = 0;
  if (tile < n_tiles) {
    const int* p = pix + tile * th * tw + (k / nqw) * 8 * tw + (k % nqw) * 8;
    unsigned m[64], c[64], dc = 0;
    #pragma unroll
    for (int r = 0; r < 8; ++r) {
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[8 * r + j] = (unsigned)p[r * tw + j];
        c[8 * r + j] = m[8 * r + j];
        dc += m[8 * r + j];
      }
    }
    // four 4x4 Hadamards: rows, then columns, of each 4x4 block
    #pragma unroll
    for (int r = 0; r < 8; ++r) {
      had4(m + 8 * r, 1);
      had4(m + 8 * r + 4, 1);
    }
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      had4(m + j, 8);
      had4(m + 32 + j, 8);
    }
    // the 8x8 Hadamard
    #pragma unroll
    for (int r = 0; r < 8; ++r) had8(c + 8 * r, 1);
    #pragma unroll
    for (int j = 0; j < 8; ++j) had8(c + j, 8);
    #pragma unroll
    for (int i = 0; i < 64; ++i) {
      s4 += uabs(m[i]);
      s8 += uabs(c[i]);
    }
    s4 -= dc;
    s8 -= dc;
  }
  // the tile's quadrants, on nq consecutive lanes
  for (int o = 1; o < nq; o <<= 1) {
    s4 += __shfl_xor_sync(0xffffffffu, s4, o);
    s8 += __shfl_xor_sync(0xffffffffu, s8, o);
  }
  if (tile < n_tiles && k == 0) {
    satd_o[tile] = (int)s4 >> 1;
    sa8d_o[tile] = (int)s8 >> 2;
  }
}

}  // namespace

extern "C" int hadamard_ac(const int* pix, int* satd_ac, int* sa8d_ac,
                           int n_tiles, int th, int tw, void* stream) {
  if ((th != 8 && th != 16) || (tw != 8 && tw != 16))
    return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return 0;
  const long long nq = (long long)n_tiles * (th / 8) * (tw / 8);
  hadamard_ac_kernel<<<(unsigned)((nq + NT - 1) / NT), NT, 0,
                       (cudaStream_t)stream>>>(pix, satd_ac, sa8d_ac,
                                               n_tiles, th, tw);
  return (int)cudaGetLastError();
}

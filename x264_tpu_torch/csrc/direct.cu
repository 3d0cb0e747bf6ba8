// K23 b_direct: the B_SKIP / B_Direct_16x16 selection of a B frame.
//
// Replaces x264_tpu/encoder/mvpred.py:104 spatial_direct as
// x264_tpu/encoder/inter.py:866 encode_b_body's stage 3.5 calls it
// (inter.py:1028-1101): the provisional spatial-direct derivation from
// the chosen-mode maps, the direct prediction's SATD + lam and `want`,
// and the lax.scan over the slope-2 diagonals that commits the exact
// derivation. Plain twin: x264_tpu_torch/encoder/inter.py:b_direct_plain;
// wrapper: b_direct.
//
// Design. Two launches.
//   1. one 64-thread CTA per MB: thread 0 derives spatial direct from the
//      chosen-mode configs of the left / top / top-right (else top-left)
//      MBs, read straight from intra_mb, bmode and the ME MVs (each
//      list's reference 0 where the mode uses it, else -1, the pad -2),
//      and the colocated corners; every thread fetches the direct
//      prediction (both lists averaged where both references are used),
//      threads 0-15 take its 4x4 Hadamards, thread 0 forms SATD + lam
//      and want = inter MB and cheaper than cost_inter; the carry (r0,
//      r1, m0, m1) starts as the chosen-mode config and direct_mb 0;
//   2. one persistent 256-thread CTA walks the diagonals d = 2y + x in
//      order, a thread per MB of the diagonal: an MB that wants direct
//      re-derives it from the carry and commits it where the derivation
//      is quadrant-uniform; __syncthreads between diagonals. The
//      derivation reads the left (d - 1), top (d - 2), top-right (d - 1)
//      and top-left (d - 3) MBs, all committed already, so re-deriving
//      only the committing diagonal gives the scan's result, which
//      re-derives the whole frame at every step.
// Spatial direct (x264_mb_predict_mv_direct16x16_spatial): each list's
// reference is the unsigned MIN3 of the A / B / C refs, its MV the median
// rule at that reference; neither usable makes both reference 0 with the
// zero MV; the colocated corner 4x4 blocks of the four quadrants with ref
// 0 and |mv| <= 1 zero a reference-0 MV where all four agree, and the MB
// is uniform unless some but not all do and a derived MV would change.
// What bounds it on the H100: launch 2's serial depth (2 * mb_h + mb_w -
// 1 diagonals, 255 at 1080p, each a few hundred integer ops deep);
// launch 1 reads two half-pel windows per MB (~8 MB at 1080p).
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 64, NT_WAVE = 256;
constexpr int PAD = 32;
constexpr int BIG = 1 << 20;

struct Cell {
  int ref, x, y;
};

// the chosen-mode config of launch 1: list k used where the mode is L0 /
// BI (k 0) or L1 / BI (k 1) and the MB is not intra
struct Chosen {
  const uint8_t* intra;
  const int *bmode, *mv0, *mv1;
  __device__ Cell at(int n, int k) const {
    const bool use = !intra[n] && bmode[n] != (k ? 0 : 1);
    const int* mv = k ? mv1 : mv0;
    return use ? Cell{0, mv[2 * n], mv[2 * n + 1]} : Cell{-1, 0, 0};
  }
};

// the carry of launch 2 (written by the walk itself)
struct Carry {
  int *r0, *r1, *m0, *m1;
  __device__ Cell at(int n, int k) const {
    const int* r = k ? r1 : r0;
    const int* m = k ? m1 : m0;
    return Cell{r[n], m[2 * n], m[2 * n + 1]};
  }
};

__device__ __forceinline__ int median3(int a, int b, int c) {
  return a + b + c - min(a, min(b, c)) - max(a, max(b, c));
}

// the median / count rule at reference i (mvpred.py:_predict)
__device__ __forceinline__ Cell predict(const Cell& A, const Cell& B,
                                        const Cell& C, int i) {
  const int cnt = (A.ref == i) + (B.ref == i) + (C.ref == i);
  if (cnt == 1) return A.ref == i ? A : B.ref == i ? B : C;
  if (cnt == 0 && B.ref == -2 && C.ref == -2 && A.ref != -2) return A;
  return Cell{i, median3(A.x, B.x, C.x), median3(A.y, B.y, C.y)};
}

struct Direct {
  int ref[2], x[2], y[2];
  bool uniform;
};

template <class Get>
__device__ Direct derive(const Get& g, int mx, int my, int mb_h, int mb_w,
                         const int* col_ref4, const int* col_mv4) {
  auto cell = [&](int y, int x, int k) {
    if (y < 0 || x < 0 || y >= mb_h || x >= mb_w) return Cell{-2, 0, 0};
    return g.at(y * mb_w + x, k);
  };
  Direct D;
  for (int k = 0; k < 2; ++k) {
    const Cell A = cell(my, mx - 1, k), B = cell(my - 1, mx, k);
    Cell C = cell(my - 1, mx + 1, k);
    if (C.ref == -2) C = cell(my - 1, mx - 1, k);
    auto un = [](int r) { return r < 0 ? BIG : r; };
    const int r = min(min(un(A.ref), un(B.ref)), un(C.ref));
    const int ref = r >= BIG ? -1 : r;
    const Cell p = predict(A, B, C, ref);
    D.ref[k] = ref;
    D.x[k] = ref >= 0 ? p.x : 0;
    D.y[k] = ref >= 0 ? p.y : 0;
  }
  const bool both_neg = D.ref[0] < 0 && D.ref[1] < 0;
  if (both_neg)
    for (int k = 0; k < 2; ++k) D.ref[k] = D.x[k] = D.y[k] = 0;
  const int W4 = 4 * mb_w;
  int nz = 0;
  for (int q = 0; q < 4; ++q) {
    const int o = (4 * my + 3 * (q >> 1)) * W4 + 4 * mx + 3 * (q & 1);
    nz += col_ref4[o] == 0 && abs(col_mv4[2 * o]) <= 1
          && abs(col_mv4[2 * o + 1]) <= 1;
  }
  const bool z_all = nz == 4 && !both_neg, z_any = nz > 0 && !both_neg;
  bool change = false;
  for (int k = 0; k < 2; ++k)
    change |= D.ref[k] == 0 && (D.x[k] != 0 || D.y[k] != 0);
  D.uniform = !change || z_all || !z_any;
  for (int k = 0; k < 2; ++k)
    if (z_all && D.ref[k] == 0) D.x[k] = D.y[k] = 0;
  return D;
}

__global__ void __launch_bounds__(NT) provisional_kernel(
    const int* __restrict__ Y, const int* __restrict__ planes0,
    const int* __restrict__ planes1, const Chosen g,
    const int* __restrict__ cost_inter, const int* __restrict__ col_ref4,
    const int* __restrict__ col_mv4, int* r0, int* r1, int* m0, int* m1,
    uint8_t* direct, uint8_t* want, int mb_h, int mb_w, int lam) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x;
  const int W = mb_w * 16, Wp = W + 2 * PAD, Hp = mb_h * 16 + 2 * PAD;
  const size_t plane = (size_t)Hp * Wp;
  __shared__ Direct D;
  __shared__ int dd[256], had[16];
  if (tid == 0) D = derive(g, mx, my, mb_h, mb_w, col_ref4, col_mv4);
  __syncthreads();
  const bool u0 = D.ref[0] >= 0, u1 = D.ref[1] >= 0;
  for (int i = tid; i < 256; i += NT) {
    const int r = i >> 4, c = i & 15;
    const int a = u0 ? mc_luma16(planes0, plane, Hp, Wp, PAD, mx, my, D.x[0],
                                 D.y[0], r, c) : 0;
    const int b = u1 ? mc_luma16(planes1, plane, Hp, Wp, PAD, mx, my, D.x[1],
                                 D.y[1], r, c) : 0;
    const int p = u0 && u1 ? (a + b + 1) >> 1 : u0 ? a : b;
    dd[i] = Y[(my * 16 + r) * W + mx * 16 + c] - p;
  }
  __syncthreads();
  if (tid < 16) {
    const int by = tid >> 2, bx = tid & 3;
    int d[16];
    for (int j = 0; j < 16; ++j) d[j] = dd[(4 * by + (j >> 2)) * 16 + 4 * bx + (j & 3)];
    had[tid] = abs_had4x4(d);
  }
  __syncthreads();
  if (tid == 0) {
    int satd = 0;
    for (int by = 0; by < 4; ++by)
      for (int p = 0; p < 2; ++p)
        satd += (had[4 * by + 2 * p] + had[4 * by + 2 * p + 1]) >> 1;
    want[mb] = !g.intra[mb] && satd + lam < cost_inter[mb];
    direct[mb] = 0;
    for (int k = 0; k < 2; ++k) {
      const Cell c = g.at(mb, k);
      (k ? r1 : r0)[mb] = c.ref;
      (k ? m1 : m0)[2 * mb] = c.x;
      (k ? m1 : m0)[2 * mb + 1] = c.y;
    }
  }
}

__global__ void __launch_bounds__(NT_WAVE) wave_kernel(
    Carry g, const int* __restrict__ col_ref4, const int* __restrict__ col_mv4,
    const uint8_t* __restrict__ want, uint8_t* direct, int mb_h, int mb_w) {
  for (int d = 0; d < 2 * mb_h + mb_w - 1; ++d) {
    // MBs (x = d - 2y, y) of the diagonal inside the frame
    const int y0 = max(0, (d - (mb_w - 1) + 1) / 2), y1 = min(mb_h - 1, d / 2);
    for (int my = y0 + threadIdx.x; my <= y1; my += NT_WAVE) {
      const int mx = d - 2 * my, mb = my * mb_w + mx;
      if (!want[mb]) continue;
      const Direct D = derive(g, mx, my, mb_h, mb_w, col_ref4, col_mv4);
      if (!D.uniform) continue;
      g.r0[mb] = D.ref[0];
      g.r1[mb] = D.ref[1];
      g.m0[2 * mb] = D.x[0];
      g.m0[2 * mb + 1] = D.y[0];
      g.m1[2 * mb] = D.x[1];
      g.m1[2 * mb + 1] = D.y[1];
      direct[mb] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int b_direct(const int* y, const int* planes0, const int* planes1,
                        const uint8_t* intra_mb, const int* bmode,
                        const int* mv0, const int* mv1, const int* cost_inter,
                        const int* col_ref4, const int* col_mv4, int* r0,
                        int* r1, int* m0, int* m1, uint8_t* direct,
                        uint8_t* want, int mb_h, int mb_w, int lam,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  provisional_kernel<<<mb_h * mb_w, NT, 0, s>>>(
      y, planes0, planes1, Chosen{intra_mb, bmode, mv0, mv1}, cost_inter,
      col_ref4, col_mv4, r0, r1, m0, m1, direct, want, mb_h, mb_w, lam);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wave_kernel<<<1, NT_WAVE, 0, s>>>(Carry{r0, r1, m0, m1}, col_ref4, col_mv4,
                                    want, direct, mb_h, mb_w);
  return (int)cudaGetLastError();
}

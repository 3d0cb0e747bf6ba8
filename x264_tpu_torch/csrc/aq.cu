// Variance AQ: K16 aq_qp_map and K17 dqp_syntax, the CUDA form of
// x264_tpu/encoder/aq.py's qp_map_from_planes and dqp_syntax (plain
// versions in x264_tpu_torch/encoder/aq.py).
//
// K16: one warp per MB, four MBs per CTA. Each lane sums 8 luma samples
// (two in each of the four 64-sample row blocks) and 2 + 2 chroma
// samples; warp shuffles finish the int32 sums (exact in any order:
// every partial stays below 2^24). Lane 0 then runs the float32 chain
// in x264_tpu's order, as XLA's CPU backend compiles it:
//   v = ss - (s * s) * 2^-n          (n = 8 luma, 6 chroma; exact scale)
//   E = max((v_y + v_u) + v_v, 1)
//   a = fma(log(E), 1/ln 2, -14.427) (XLA contracts log2's multiply
//   q = fma(k, a, qp)                 and the following adds into FMAs)
//   qp_map = clip(rint(q), qp_min, qp_max)
// with k = float32(strength * 1.0397) from the host and log the exact
// replica of XLA's CPU float32 log (Cephes polynomial with the FMAs the
// x86 backend forms): every step is an explicit __f*_rn / __fmaf_rn, so
// nvcc cannot contract or reorder. rint rounds half to even, as
// jnp.round does.
//
// K17: one CTA of 1024 threads over the frame's MBs in raster order.
// Each thread owns a contiguous run; a block-wide max scan of the last
// MB with a dqp element gives, for every MB, the QP it inherits
// (QPy_prev, spec 7.4.5), its mb_qp_delta and the previous MB's
// nonzero-delta flag (the CABAC ctxInc of x264_cabac_mb_qp_delta).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// XLA's Cephes log constants (float32)
constexpr float kP0 = 0x1.204376p-4f, kP1 = -0x1.d7a37p-4f;
constexpr float kP2 = 0x1.de4a34p-4f, kP3 = -0x1.fcba9ep-4f;
constexpr float kP4 = 0x1.23d37ep-3f, kP5 = -0x1.555ca0p-3f;
constexpr float kP6 = 0x1.999d58p-3f, kP7 = -0x1.fffff8p-3f;
constexpr float kP8 = 0x1.555554p-2f, kQ1 = -0x1.bd0106p-13f;
constexpr float kQ2 = 0x1.63p-1f, kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kInvLn2 = 0x1.715476p+0f;
constexpr float kMinNorm = 0x1p-126f;

__constant__ int kChromaQp[52] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

// XLA's CPU float32 log for x >= 1 (inputs below the smallest normal are
// raised to it, as XLA does; the zero / infinity / NaN fix-ups are left
// out: the energy is at least 1)
__device__ __forceinline__ float xla_logf(float x) {
  x = fmaxf(x, kMinNorm);
  const int b = __float_as_int(x);
  const int emm0 = (int)((unsigned)b >> 23) - 127;
  const float fr = __int_as_float((b & (int)0x807fffff) | 0x3f000000);
  float e = __fadd_rn(1.0f, (float)emm0);
  const bool m = fr < kSqrtHalf;
  float t = __fsub_rn(fr, 1.0f);
  e = __fsub_rn(e, m ? 1.0f : 0.0f);
  t = __fadd_rn(t, m ? fr : 0.0f);
  const float x2 = __fmul_rn(t, t), x3 = __fmul_rn(x2, t);
  float y = __fmaf_rn(t, kP0, kP1);
  float y1 = __fmaf_rn(t, kP3, kP4);
  float y2 = __fmaf_rn(t, kP6, kP7);
  y = __fmaf_rn(y, t, kP2);
  y1 = __fmaf_rn(y1, t, kP5);
  y2 = __fmaf_rn(y2, t, kP8);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(kQ1, e));
  const float r = __fadd_rn(__fmaf_rn(-0.5f, x2, t), y);
  return __fmaf_rn(kQ2, e, r);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (ss - (s * s) * 2^-n) in float32; ss exact (< 2^24)
__device__ __forceinline__ float block_var(int s, float ss, float scale) {
  const float sf = (float)s;
  return __fsub_rn(ss, __fmul_rn(__fmul_rn(sf, sf), scale));
}

constexpr int AQ_MBS = 4;   // MBs (warps) per CTA

__global__ void __launch_bounds__(32 * AQ_MBS) aq_qp_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, int mb_h, int mb_w, int qp, float k,
    int qp_min, int qp_max, int chroma_qp_offset, int* __restrict__ qp_map,
    int* __restrict__ qpc_map) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * AQ_MBS + (threadIdx.x >> 5);
  if (mb >= mb_h * mb_w) return;
  const int mx = mb % mb_w, my = mb / mb_w, W = mb_w * 16, Wc = mb_w * 8;
  // luma: row block b (rows 4b..4b+3) holds samples 64b..64b+63 of the
  // tile; lane takes samples lane and lane + 32 of each block
  int s = 0, ssb[4];
  for (int b = 0; b < 4; ++b) {
    int acc = 0;
    for (int h = 0; h < 2; ++h) {
      const int i = 64 * b + lane + 32 * h;
      const int px = Y[(my * 16 + i / 16) * W + mx * 16 + i % 16];
      s += px;
      acc += px * px;
    }
    ssb[b] = acc;
  }
  int su = 0, ssu = 0, sv = 0, ssv = 0;
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    const int off = (my * 8 + i / 8) * Wc + mx * 8 + i % 8;
    const int pu = U[off], pv = V[off];
    su += pu;
    ssu += pu * pu;
    sv += pv;
    ssv += pv * pv;
  }
  s = warp_sum(s);
  for (int b = 0; b < 4; ++b) ssb[b] = warp_sum(ssb[b]);
  su = warp_sum(su);
  ssu = warp_sum(ssu);
  sv = warp_sum(sv);
  ssv = warp_sum(ssv);
  if (lane) return;
  // the four luma partials as float32 (each exact, and so is their sum)
  const float ssy = __fadd_rn(__fadd_rn(__fadd_rn((float)ssb[0], (float)ssb[1]),
                                        (float)ssb[2]),
                              (float)ssb[3]);
  const float vy = block_var(s, ssy, 0x1p-8f);
  const float vu = block_var(su, (float)ssu, 0x1p-6f);
  const float vv = block_var(sv, (float)ssv, 0x1p-6f);
  const float energy = fmaxf(__fadd_rn(__fadd_rn(vy, vu), vv), 1.0f);
  const float a = __fmaf_rn(xla_logf(energy), kInvLn2, -14.427f);
  const float q = __fmaf_rn(k, a, (float)qp);
  const float qc = fminf(fmaxf(rintf(q), (float)qp_min), (float)qp_max);
  const int qm = (int)qc;
  qp_map[mb] = qm;
  qpc_map[mb] = kChromaQp[min(max(qm + chroma_qp_offset, 0), 51)];
}

__global__ void log_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = xla_logf(x[i]);
}

constexpr int DQP_NT = 1024;

__global__ void __launch_bounds__(DQP_NT) dqp_kernel(
    const int* __restrict__ qp_map, const uint8_t* __restrict__ has_dqp,
    int nmb, int slice_qp, int* __restrict__ dqp, int* __restrict__ qp_eff,
    uint8_t* __restrict__ prev_nz) {
  __shared__ int scan[DQP_NT];
  const int tid = threadIdx.x;
  const int chunk = (nmb + DQP_NT - 1) / DQP_NT;
  const int lo = min(tid * chunk, nmb), hi = min(lo + chunk, nmb);
  // the last coded MB of this thread's run (-1: none)
  int last = -1;
  for (int i = lo; i < hi; ++i)
    if (has_dqp[i]) last = i;
  scan[tid] = last;
  __syncthreads();
  // inclusive max scan over the threads' runs (Hillis-Steele)
  for (int o = 1; o < DQP_NT; o <<= 1) {
    const int v = tid >= o ? scan[tid - o] : -1;
    __syncthreads();
    scan[tid] = max(scan[tid], v);
    __syncthreads();
  }
  // the last coded MB strictly before this run
  int prev = tid ? scan[tid - 1] : -1;
  for (int i = lo; i < hi; ++i) {
    const int q = qp_map[i];
    const int prev_qp = prev >= 0 ? qp_map[prev] : slice_qp;
    const bool h = has_dqp[i];
    if (h) prev = i;
    dqp[i] = h ? q - prev_qp : 0;
    qp_eff[i] = prev >= 0 ? qp_map[prev] : slice_qp;
  }
  __syncthreads();   // every dqp written (global memory, same CTA)
  for (int i = lo; i < hi; ++i) prev_nz[i] = i > 0 && dqp[i - 1] != 0;
}

}  // namespace

extern "C" int aq_qp_map(const int* y, const int* u, const int* v, int mb_h,
                         int mb_w, int qp, float k, int qp_min, int qp_max,
                         int chroma_qp_offset, int* qp_map, int* qpc_map,
                         void* stream) {
  const int nmb = mb_h * mb_w;
  aq_qp_kernel<<<(nmb + AQ_MBS - 1) / AQ_MBS, 32 * AQ_MBS, 0,
                 (cudaStream_t)stream>>>(y, u, v, mb_h, mb_w, qp, k, qp_min,
                                         qp_max, chroma_qp_offset, qp_map,
                                         qpc_map);
  return (int)cudaGetLastError();
}

extern "C" int aq_log(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  log_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, out, n);
  return (int)cudaGetLastError();
}

extern "C" int dqp_syntax(const int* qp_map, const uint8_t* has_dqp, int nmb,
                          int slice_qp, int* dqp, int* qp_eff,
                          uint8_t* prev_nz, void* stream) {
  dqp_kernel<<<1, DQP_NT, 0, (cudaStream_t)stream>>>(
      qp_map, has_dqp, nmb, slice_qp, dqp, qp_eff, prev_nz);
  return (int)cudaGetLastError();
}

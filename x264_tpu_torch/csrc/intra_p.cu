// K7 intra_in_p: stage 3 of the P-frame encode, the intra-in-P decision.
//
// Replaces the intra-in-P sweeps of x264_tpu/encoder/inter.py:
// encode_p_body (stage 3: eval_intra with luma_i16_path, predict_8x8c and
// chroma_residual; the decision, and the K_SWEEPS = 3 `resolved`
// fixpoint). Below subme 6 the decision is lp.cost + lam * INTRA_PEN_BITS
// < cost_inter; under the RD ladder (subme >= 6) it is cost_i_rd <
// rd_cost_inter on true SSD + lambda2 * bits with the psy term
// (inter.py:671-701), rd_cost_inter and the source's AC energy coming
// from K13. Plain twin: x264_tpu_torch/encoder/inter.py:intra_in_p_plain
// (rd_cost_intra under RD); wrapper: intra_in_p.
//
// Design. Intra prediction reads the left / top / top-left
// reconstruction, which the reference produces MB by MB. x264_tpu
// replaces that wavefront by bounded-depth sweeps over the whole frame,
// and so does this kernel, in four launches of one 64-thread CTA per MB,
// running the I16x16 + chroma device code K1 runs (intra_mb.cuh):
//   1. sweep 0: every MB's intra path against the inter reconstruction
//      (pre-deblock), its cost and modes; the candidate recon goes to A.
//      Under RD the CTA then prices the candidate that is already in
//      shared memory with the RD device code of rdcost.cuh: threads 0-26
//      walk the luma DC, 16 luma AC, 8 chroma AC and 2 chroma DC blocks,
//      threads 32-47 take the recon's 4x4 Hadamards for its AC energy,
//      all threads the three SSDs; thread 0 evaluates
//      (((ssd_y + ssd_u) + ssd_v) + psy * |ace - ce_psy|)
//      + lam2 * (ibits + 256 * 9) in that order, each float step rounded
//      alone (no FMA), into cost_i_rd;
//   2. decide: an MB goes intra where cost + lam * 7 < cost_inter (or
//      cost_i_rd < rd_cost_inter under RD), unless its intra chain is
//      deeper than 3 (each CTA resolves the fixpoint on the 4x4 window of
//      MBs above-left of it, which is all the three iterations can
//      reach); A becomes intra ? candidate : inter;
//   3. sweep 1 against A with the sweep-0 modes, into B;
//   4. sweep 2 against B, into A, which is the output. Sweeps 1 and 2
//      evaluate only the intra MBs (the others keep the inter recon and
//      zero syntax), as x264_tpu's masked whole-frame sweeps leave them.
// Without RD the kernels run exactly as before the RD ladder came.
// Lossless (CQP 0; x264_tpu inter.py:634, :654): the sweeps take
// intra_mb.cuh's bypass, the decision keeps its SATD costs.
// B frames (x264_tpu encode_b_body) use the same kernels in two other
// sequences: intra_in_b_decide runs sweep 0 against residual pass 1's
// reconstruction and the decision (stage 3, inter.py:965-1026), and
// intra_in_b_sweeps three sweeps with that decision fixed against pass
// 2's reconstruction, the first choosing the modes of the intra MBs
// afresh (free_modes) and the next two keeping them (stage 3.7,
// :1137-1160). Both decimate (B slices always do) and decide on SATD.
// What bounds it on the H100: bytes. The source, inter and output planes
// and syntax planes are ~51 MB at 1080p as int32 (~15 us at 3.35 TB/s);
// each sweep is ~16 SATD and 24 transform blocks per MB it runs (~25 k
// integer ops, some 0.2 G for sweep 0 over every MB, ~3 us at the ALU
// rate; the RD pricing adds ~27 x 16 walk steps and 16 Hadamards per MB).
// One MB per 64-thread CTA leaves lanes idle in the serial DC, walk and
// decision steps; a later PR can batch MBs per CTA.
#include "intra_mb.cuh"
#include "rdcost.cuh"

using namespace x264t;

namespace {

constexpr int NT = IMB_NT;
constexpr int INTRA_PEN_BITS = 7;

struct Planes {
  int* y;
  int* u;
  int* v;
};

// copy MB `mb`'s reconstruction from src to dst (all threads)
__device__ __forceinline__ void copy_mb(Planes dst, const Planes src, int mb_w,
                                        int mx, int my) {
  const int W = mb_w * 16, Wc = mb_w * 8;
  for (int i = threadIdx.x; i < 256; i += NT) {
    int o = (my * 16 + (i >> 4)) * W + mx * 16 + (i & 15);
    dst.y[o] = src.y[o];
  }
  for (int i = threadIdx.x; i < 128; i += NT) {
    int k = i & 63, o = (my * 8 + (k >> 3)) * Wc + mx * 8 + (k & 7);
    if (i < 64) dst.u[o] = src.u[o];
    else dst.v[o] = src.v[o];
  }
}

struct Syntax {
  int* mode16;
  int* modec;
  int* luma_dc;
  int* luma_ac;
  int* chroma_dc;
  int* chroma_ac;
};

// the RD ladder's inputs and sweep 0's intra RD costs; rd_cost is null
// below subme 6
struct RD {
  const float* rd_cost;
  const int* ce_psy;
  const int* rdtab;
  float* cost_i_rd;
  float lam2, psy;
};

// the RD cost of sweep 0's candidate in S (x264_tpu inter.py:677-699)
__device__ __forceinline__ void intra_rd_cost(const IntraMB& S, const RD rd,
                                              int mb) {
  const int tid = threadIdx.x;
  __shared__ int red[NT];
  __shared__ int bits[27];
  __shared__ int had[16];
  if (tid < 27) {
    int lv[16], n, cat;
    if (tid == 0) {                         // luma DC, zig-zag
      n = 16, cat = 0;
      for (int i = 0; i < 16; ++i) lv[i] = S.dcl16[kZig4[i]];
    } else if (tid < 17) {                  // luma AC of block tid - 1
      n = 15, cat = 1;
      const int* b = S.lv16[tid - 1];
      for (int i = 1; i < 16; ++i) lv[i - 1] = b[kZig4[i]];
    } else if (tid < 25) {                  // chroma AC
      n = 15, cat = 4;
      const int* b = S.clv[(tid - 17) >> 2][(tid - 17) & 3];
      for (int i = 1; i < 16; ++i) lv[i - 1] = b[kZig4[i]];
    } else {                                // chroma DC of U, V
      n = 4, cat = 3;
      for (int i = 0; i < 4; ++i) lv[i] = S.cdcl[tid - 25][i];
    }
    bits[tid] = residual_bits(lv, n, rd.rdtab + cat * RD_CAT_STRIDE);
  } else if (tid >= 32 && tid < 48) {
    had[tid - 32] = tile_had16(tid - 32, [&](int r, int c) {
      return S.rec16[16 * r + c];
    });
  }
  int sy = 0, ps = 0;
  for (int i = tid; i < 256; i += NT) {
    const int d = S.fenc[i] - S.rec16[i];
    sy += d * d;
    ps += S.rec16[i];
  }
  const int du = S.fc[0][tid] - S.crec[0][tid];
  const int dv = S.fc[1][tid] - S.crec[1][tid];
  sy = cta_sum(red, sy);
  ps = cta_sum(red, ps);
  const int su = cta_sum(red, du * du);
  const int sv = cta_sum(red, dv * dv);
  if (tid == 0) {
    int ibits = 0;
    for (int i = 0; i < 27; ++i) ibits += bits[i];
    const float ace = (float)ac_energy16(had, ps);
    float issd = __fadd_rn(__fadd_rn((float)sy, (float)su), (float)sv);
    issd = __fadd_rn(issd, __fmul_rn(rd.psy, fabsf(__fsub_rn(
                                                 ace, (float)rd.ce_psy[mb]))));
    rd.cost_i_rd[mb] = __fadd_rn(
        issd, __fmul_rn(rd.lam2, __fadd_rn((float)ibits, 256.0f * 9.0f)));
  }
}

// one sweep: the intra path of every MB (sweep 0) or of the intra MBs
// with their sweep-0 modes (sweeps 1, 2), neighbours read from src
__global__ void __launch_bounds__(NT) sweep_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, Planes src, Planes inter, Planes dst,
    const int* __restrict__ qtab_g, const uint8_t* __restrict__ intra_mb,
    Syntax out, int* __restrict__ cost_i, const RD rd,
    const int* __restrict__ qp_map, int mb_w, int lam, int decimate,
    int free_modes, int lossless = 0) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x;
  const bool has_top = my > 0, has_left = mx > 0;
  const bool fixed = intra_mb != nullptr;
  __shared__ IntraMB S;

  if (fixed && !intra_mb[mb]) {           // inter MB: inter recon, no syntax
    copy_mb(dst, inter, mb_w, mx, my);
    if (tid == 0) { out.mode16[mb] = 0; out.modec[mb] = 0; }
    if (tid < 16) out.luma_dc[mb * 16 + tid] = 0;
    if (tid < 8) out.chroma_dc[mb * 8 + tid] = 0;
    for (int i = tid; i < 256; i += NT) out.luma_ac[mb * 256 + i] = 0;
    for (int i = tid; i < 128; i += NT) out.chroma_ac[mb * 128 + i] = 0;
    return;
  }
  // with intra_mb given, the sweep-0 modes unless the modes are free
  const int fix16 = fixed && !free_modes ? out.mode16[mb] : -1;
  const int fixc = fixed && !free_modes ? out.modec[mb] : -1;
  // with a QP map (variance AQ) qtab_g is the 52-QP intra stack
  imb_load(S, qtab_g + (qp_map ? qp_map[mb] * QTAB_INTS : 0), Y, U, V, src.y,
           src.u, src.v, mb_w, mx, my, has_top, has_left);
  __syncthreads();
  imb_predict(S, has_top, has_left);
  imb_i16_decide(S, has_top, has_left, lam, fix16);
  imb_i16_residual(S, decimate != 0, lossless != 0);
  imb_chroma_decide(S, has_top, has_left, fixc);
  imb_chroma_residual(S, lossless != 0);
  if (!fixed && rd.rd_cost != nullptr) intra_rd_cost(S, rd, mb);

  const int W = mb_w * 16, Wc = mb_w * 8;
  for (int i = tid; i < 256; i += NT) {
    dst.y[(my * 16 + (i >> 4)) * W + mx * 16 + (i & 15)] = S.rec16[i];
    int z = i >> 4, j = i & 15;
    out.luma_ac[mb * 256 + i] = S.lv16[4 * kBlkY[z] + kBlkX[z]][kZig4[j]];
  }
  for (int i = tid; i < 128; i += NT) {
    int ch = i >> 6, k = i & 63;
    int* P = ch ? dst.v : dst.u;
    P[(my * 8 + (k >> 3)) * Wc + mx * 8 + (k & 7)] = S.crec[ch][k];
    int blk = k >> 4, j = k & 15;
    out.chroma_ac[mb * 128 + i] = S.clv[ch][blk][kZig4[j]];
  }
  if (tid < 16) out.luma_dc[mb * 16 + tid] = S.dcl16[kZig4[tid]];
  if (tid < 8) out.chroma_dc[mb * 8 + tid] = S.cdcl[tid >> 2][tid & 3];
  if (tid == 0) {
    out.mode16[mb] = S.mode16;
    out.modec[mb] = S.cmode;
    if (!fixed) cost_i[mb] = S.cost16;
  }
}

// the intra / inter decision with the demotion of chains deeper than 3
// sweeps; merges A (the sweep-0 candidates) with the inter recon
__global__ void __launch_bounds__(NT) decide_kernel(
    const int* __restrict__ cost_i, const int* __restrict__ cost_inter,
    const RD rd, Planes inter, Planes a, uint8_t* __restrict__ intra_mb,
    int mb_w, int lam) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  __shared__ int keep;
  if (threadIdx.x == 0) {
    // resolved_k on the window rows my-3..my, cols mx-3..mx; outside
    // the frame counts as resolved (the True fill of up / lf)
    bool choose[4][4], r[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        int y = my - 3 + i, x = mx - 3 + j;
        bool in = y >= 0 && x >= 0;
        int n = y * mb_w + x;
        choose[i][j] = in && (rd.rd_cost != nullptr
                              ? rd.cost_i_rd[n] < rd.rd_cost[n]
                              : cost_i[n] + lam * INTRA_PEN_BITS < cost_inter[n]);
        r[i][j] = !in || !choose[i][j];
      }
    for (int k = 1; k <= 3; ++k)
      for (int i = 3; i >= k; --i)           // descending: reads k-1 values
        for (int j = 3; j >= k; --j)
          r[i][j] = r[i][j] || (choose[i][j] && r[i - 1][j] && r[i][j - 1]
                                && r[i - 1][j - 1]);
    keep = choose[3][3] && r[3][3];
    intra_mb[mb] = keep ? 1 : 0;
  }
  __syncthreads();
  if (!keep) copy_mb(a, inter, mb_w, mx, my);
}

}  // namespace

extern "C" int intra_in_p(const int* y, const int* u, const int* v,
                          int* inter_y, int* inter_u, int* inter_v,
                          const int* cost_inter, const int* qtab, int* ry,
                          int* ru, int* rv, uint8_t* intra_mb, int* mode16,
                          int* modec, int* luma_dc, int* luma_ac,
                          int* chroma_dc, int* chroma_ac, int* sy, int* su,
                          int* sv, int* cost_i, const float* rd_cost,
                          const int* ce_psy, const int* rdtab,
                          float* cost_i_rd, const int* qp_map, int mb_h,
                          int mb_w, int lam, int decimate, float lam2,
                          float psy, int lossless, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  const Planes inter{inter_y, inter_u, inter_v}, A{ry, ru, rv}, B{sy, su, sv};
  const Syntax out{mode16, modec, luma_dc, luma_ac, chroma_dc, chroma_ac};
  const RD rd{rd_cost, ce_psy, rdtab, cost_i_rd, lam2, psy};
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, inter, inter, A, qtab, nullptr,
                                  out, cost_i, rd, qp_map, mb_w, lam, decimate,
                                  0, lossless);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decide_kernel<<<nmb, NT, 0, s>>>(cost_i, cost_inter, rd, inter, A, intra_mb,
                                   mb_w, lam);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, A, inter, B, qtab, intra_mb, out,
                                  cost_i, rd, qp_map, mb_w, lam, decimate, 0,
                                  lossless);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, B, inter, A, qtab, intra_mb, out,
                                  cost_i, rd, qp_map, mb_w, lam, decimate, 0,
                                  lossless);
  return (int)cudaGetLastError();
}

// the B frame's decision (inter.py:encode_b_body stage 3): sweep 0
// against pass 1's reconstruction into the scratch planes A, then the
// decision (SATD, decimated) into intra_mb
extern "C" int intra_in_b_decide(const int* y, const int* u, const int* v,
                                 int* inter_y, int* inter_u, int* inter_v,
                                 const int* cost_inter, const int* qtab,
                                 uint8_t* intra_mb, int* ay, int* au, int* av,
                                 int* cost_i, int* mode16, int* modec,
                                 int* luma_dc, int* luma_ac, int* chroma_dc,
                                 int* chroma_ac, int mb_h, int mb_w, int lam,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  const Planes inter{inter_y, inter_u, inter_v}, A{ay, au, av};
  const Syntax out{mode16, modec, luma_dc, luma_ac, chroma_dc, chroma_ac};
  const RD rd{nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f};
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, inter, inter, A, qtab, nullptr,
                                  out, cost_i, rd, nullptr, mb_w, lam, 1, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decide_kernel<<<nmb, NT, 0, s>>>(cost_i, cost_inter, rd, inter, A, intra_mb,
                                   mb_w, lam);
  return (int)cudaGetLastError();
}

// the B frame's sweeps (stage 3.7) with intra_mb fixed: sweep 0 against
// pass 2's reconstruction with free modes into A, sweep 1 into B, sweep 2
// into A, which is the output
extern "C" int intra_in_b_sweeps(const int* y, const int* u, const int* v,
                                 int* inter_y, int* inter_u, int* inter_v,
                                 const int* qtab, int* ry, int* ru, int* rv,
                                 const uint8_t* intra_mb, int* mode16,
                                 int* modec, int* luma_dc, int* luma_ac,
                                 int* chroma_dc, int* chroma_ac, int* sy,
                                 int* su, int* sv, int mb_h, int mb_w,
                                 int lam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  const Planes inter{inter_y, inter_u, inter_v}, A{ry, ru, rv}, B{sy, su, sv};
  const Syntax out{mode16, modec, luma_dc, luma_ac, chroma_dc, chroma_ac};
  const RD rd{nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f};
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, inter, inter, A, qtab, intra_mb,
                                  out, nullptr, rd, nullptr, mb_w, lam, 1, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, A, inter, B, qtab, intra_mb, out,
                                  nullptr, rd, nullptr, mb_w, lam, 1, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<nmb, NT, 0, s>>>(y, u, v, B, inter, A, qtab, intra_mb, out,
                                  nullptr, rd, nullptr, mb_w, lam, 1, 0);
  return (int)cudaGetLastError();
}

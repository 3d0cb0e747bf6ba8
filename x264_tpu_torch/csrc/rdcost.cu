// K13 rd_inter: the whole-MB inter RD cost of the RD ladder (subme >= 6).
//
// Replaces the RD stages of x264_tpu/encoder/inter.py:encode_p_body that
// price the inter choice (inter.py:498-548, 568-594: rd_cost_inter from
// rdcost.residual_bits_f8 of the luma 4x4 levels (cat 2), the chroma AC
// (cat 4) and DC (cat 3) levels, rdcost.ssd_tiles, the psy term of
// pixel.ac_energy, and the mode / mvd header bits), with one reference;
// with the 8x8 transform also the RD transform choice (x264_mb_analyse_
// transform_rd: the 8x8 coding's cat-5 bits and SSD against the 4x4
// one's). Plain twin: x264_tpu_torch/encoder/inter.py:rd_inter_plain;
// wrapper: rd_inter.
//
// Design. One launch, one 64-thread CTA per MB. Threads 0-15 walk the
// 16 luma blocks, 16-23 the chroma AC blocks and 24-25 the chroma DC
// (rdcost.cuh:residual_bits, one serial walk per block); threads 32-63
// take the 4x4 Hadamards of the source and the recon for the psy AC
// energy; all threads sum the SSDs and pixel sums, reduced in shared
// memory. Thread 0 turns the int32 sums into float once and evaluates
// x264_tpu's float expression in its order, each step rounded alone:
//   ((ssd4 + psy * |ace(recon) - ace(src)|) + (ssd_u + ssd_v))
//   + lam2 * (((bits4 + cbits) + cdcb) + 256 * hdr_bits).
// Outputs: rd_cost (float) and the source's AC energy ce_psy (int), which
// K7 reads for the intra side. With the 8x8 transform (t8) K6 has
// written both luma codings: threads 26-29 walk the four 8x8 blocks
// (cat 5), threads 48-63 also take the Hadamards of the 8x8 recon, and
// the SSD loop sums both errors. Thread 0 picks the 8x8 coding where
//   ssd8 + lam2 * bits8 < ssd4 + lam2 * bits4   (strictly; each ssd with
// its psy term, each step rounded alone) and prices the chosen one; then
// every thread copies the chosen recon and 4x4 levels (zero for 8x8)
// into the choice outputs, with the cbp and t8_sel.
// What bounds it on the H100: bytes. It reads the source and K6's recon
// (12.4 MB each at 1080p as int32), the luma and chroma levels (8.4 and
// 4.2 MB) and the MVs: ~38 MB, ~0.011 ms at 3.35 TB/s; the walks are
// ~26 x 16 steps of a few ops per MB (~0.1 G ops in all, 0.002 ms).
#include "t8.cuh"

using namespace x264t;

namespace {

constexpr int NT = 64;

__device__ __forceinline__ int mv_bits(const int* mv, const int* mvp) {
  return se_bits(mv[0] - mvp[0]) + se_bits(mv[1] - mvp[1]);
}

__global__ void __launch_bounds__(NT) rd_inter_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, const int* __restrict__ RY,
    const int* __restrict__ RU, const int* __restrict__ RV,
    const int* __restrict__ blocks_z, const int* __restrict__ chroma_dc,
    const int* __restrict__ chroma_ac, const int* __restrict__ ptype,
    const int* __restrict__ mv_quad, const int* __restrict__ mvp,
    const int* __restrict__ rdtab, float* __restrict__ cost,
    int* __restrict__ ce_psy, const int* __restrict__ R8Y,
    const int* __restrict__ blocks8, const int* __restrict__ cbp4,
    const int* __restrict__ cbp8, int* __restrict__ RY_o,
    int* __restrict__ blocks_z_o, int* __restrict__ cbp_o,
    uint8_t* __restrict__ t8_sel_o, int mb_w, float lam2, float psy, int t8) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x, W = mb_w * 16, Wc = mb_w * 8;
  __shared__ int red[NT];
  __shared__ int bits[30];
  __shared__ int had[32], had8[16];
  __shared__ int sel;

  if (tid < 26) {
    int lv[16], n, cat;
    if (tid < 16) {                         // luma 4x4, z-scan block tid
      n = 16, cat = 2;
      for (int i = 0; i < 16; ++i) lv[i] = blocks_z[mb * 256 + tid * 16 + i];
    } else if (tid < 24) {                  // chroma AC, scan 1..15
      n = 15, cat = 4;
      const int* p = chroma_ac + mb * 128 + (tid - 16) * 16 + 1;
      for (int i = 0; i < 15; ++i) lv[i] = p[i];
    } else {                                // chroma DC of U, V
      n = 4, cat = 3;
      for (int i = 0; i < 4; ++i) lv[i] = chroma_dc[mb * 8 + (tid - 24) * 4 + i];
    }
    bits[tid] = residual_bits(lv, n, rdtab + cat * RD_CAT_STRIDE);
  } else if (t8 && tid < 30) {              // the 8x8 coding's blocks
    bits[tid] = residual_bits8(blocks8 + (mb * 4 + tid - 26) * 64, rdtab);
  } else if (tid >= 32) {                   // psy: source, then recon
    const int* P = tid < 48 ? Y : RY;
    had[tid - 32] = tile_had16(tid & 15, [&](int r, int c) {
      return P[(my * 16 + r) * W + mx * 16 + c];
    });
    if (t8 && tid >= 48)
      had8[tid - 48] = tile_had16(tid & 15, [&](int r, int c) {
        return R8Y[(my * 16 + r) * W + mx * 16 + c];
      });
  }
  int sy = 0, su = 0, sv = 0, ps = 0, pr = 0, sy8 = 0, pr8 = 0;
  for (int i = tid; i < 256; i += NT) {
    const int o = (my * 16 + (i >> 4)) * W + mx * 16 + (i & 15);
    const int a = Y[o], b = RY[o], d = a - b;
    sy += d * d;
    ps += a;
    pr += b;
    if (t8) {
      const int b8 = R8Y[o], d8 = a - b8;
      sy8 += d8 * d8;
      pr8 += b8;
    }
  }
  {
    const int o = (my * 8 + (tid >> 3)) * Wc + mx * 8 + (tid & 7);
    const int du = U[o] - RU[o], dv = V[o] - RV[o];
    su = du * du;
    sv = dv * dv;
  }
  sy = cta_sum(red, sy);
  su = cta_sum(red, su);
  sv = cta_sum(red, sv);
  ps = cta_sum(red, ps);
  pr = cta_sum(red, pr);     // cta_sum's barriers also publish bits / had
  if (t8) {
    sy8 = cta_sum(red, sy8);
    pr8 = cta_sum(red, pr8);
  }
  if (tid == 0) {
    int bits4 = 0, cbits = 0, cdcb = 0, bits8 = 0;
    for (int i = 0; i < 16; ++i) bits4 += bits[i];
    for (int i = 16; i < 24; ++i) cbits += bits[i];
    cdcb = bits[24] + bits[25];
    const int ce = ac_energy16(had, ps), ace = ac_energy16(had + 16, pr);
    ce_psy[mb] = ce;
    const int* q = mv_quad + mb * 8;
    const int* pv = mvp + mb * 2;
    const int pt = ptype[mb];
    int hdr;
    if (pt == 3) {
      hdr = mv_bits(q, pv) + mv_bits(q + 2, pv) + mv_bits(q + 4, pv)
          + mv_bits(q + 6, pv) + 9;
    } else {
      hdr = mv_bits(q, pv) + 4;
      if (pt != 0) hdr += mv_bits(pt == 1 ? q + 4 : q + 2, pv) + 2;
    }
    float luma = __fadd_rn(
        (float)sy, __fmul_rn(psy, fabsf(__fsub_rn((float)ace, (float)ce))));
    int lbits = bits4, s8 = 0;
    if (t8) {                // x264_mb_analyse_transform_rd, strictly below
      bits8 = bits[26] + bits[27] + bits[28] + bits[29];
      const int ace8 = ac_energy16(had8, pr8);
      const float luma8 = __fadd_rn(
          (float)sy8, __fmul_rn(psy, fabsf(__fsub_rn((float)ace8, (float)ce))));
      s8 = __fadd_rn(luma8, __fmul_rn(lam2, (float)bits8))
         < __fadd_rn(luma, __fmul_rn(lam2, (float)bits4));
      if (s8) { luma = luma8; lbits = bits8; }
      sel = s8;
      cbp_o[mb] = s8 ? cbp8[mb] : cbp4[mb];
      t8_sel_o[mb] = s8;
    }
    const float dist = __fadd_rn(luma, __fadd_rn((float)su, (float)sv));
    const float b = __fadd_rn(
        __fadd_rn(__fadd_rn((float)lbits, (float)cbits), (float)cdcb),
        __fmul_rn(256.0f, (float)hdr));
    cost[mb] = __fadd_rn(dist, __fmul_rn(lam2, b));
  }
  if (!t8) return;
  __syncthreads();
  // the chosen luma coding: its recon, and the 4x4 levels (zero for 8x8)
  for (int i = tid; i < 256; i += NT) {
    const int o = (my * 16 + (i >> 4)) * W + mx * 16 + (i & 15);
    RY_o[o] = sel ? R8Y[o] : RY[o];
    blocks_z_o[mb * 256 + i] = sel ? 0 : blocks_z[mb * 256 + i];
  }
}

}  // namespace

extern "C" int rd_inter(const int* y, const int* u, const int* v,
                        const int* ry, const int* ru, const int* rv,
                        const int* blocks_z, const int* chroma_dc,
                        const int* chroma_ac, const int* ptype,
                        const int* mv_quad, const int* mvp, const int* rdtab,
                        float* cost, int* ce_psy, const int* recon8_y,
                        const int* blocks8, const int* cbp4, const int* cbp8,
                        int* recon_y_o, int* blocks_z_o, int* cbp_o,
                        uint8_t* t8_sel_o, int mb_h, int mb_w, float lam2,
                        float psy, int t8, void* stream) {
  rd_inter_kernel<<<mb_h * mb_w, NT, 0, (cudaStream_t)stream>>>(
      y, u, v, ry, ru, rv, blocks_z, chroma_dc, chroma_ac, ptype, mv_quad,
      mvp, rdtab, cost, ce_psy, recon8_y, blocks8, cbp4, cbp8, recon_y_o,
      blocks_z_o, cbp_o, t8_sel_o, mb_w, lam2, psy, t8);
  return (int)cudaGetLastError();
}

// K6 p_inter_mb: the inter residual path of every MB of a P frame.
//
// Replaces x264_tpu/ops/mc.py:mc_luma (at full-pel MVs) and mc_chroma,
// x264_tpu/encoder/inter.py:inter_luma_residual (with DCT decimation)
// and the chroma half of encode_p_body's stage 2 (the "pc" chroma
// residual with the joint two-channel AC decimation, inter.py:551-567),
// plus the MB cost sad + lam * (mv bits + 1) (inter.py:325). Plain twin:
// x264_tpu_torch/encoder/inter.py:p_inter_mb_plain; wrapper: p_inter_mb.
//
// Design. Inter prediction reads only the reference, so there is no
// wavefront: one launch, one 64-thread CTA per MB. The CTA fetches its
// 16x16 luma prediction from the edge-padded reference at the full-pel
// MV and its two 8x8 chroma predictions by the 1/8-pel bilinear filter
// ((ca*s00 + cb*s01 + cc*s10 + cd*s11 + 32) >> 6; chroma MVs are
// fractional even at subme 1); threads 0-15 then run one luma 4x4 block
// each (DCT, P-matrix quant, decimate score) and threads 32-39 one
// chroma block each. The 8x8-group / whole-MB luma kill (score < 4 /
// total < 6) and the joint chroma AC kill (score < 7) are decided by one
// thread between the phases, then dequant, IDCT and reconstruction.
// Fetch starts are taken as jax.lax.dynamic_slice takes them
// (ds_start: a negative start wraps once, then clamps). The kernel
// computes full-pel luma only: sub-pel MVs belong to the subme >= 2
// slice, which Encoder refuses.
// What bounds it on the H100: bytes. A 1080p frame moves ~52 MB (source,
// padded reference planes, and the recon, coefficient and cost planes
// out, as int32: ~15 us at 3.35 TB/s) for ~0.08 G integer ops (~1 us).
// One MB per 64-thread CTA, with 16 or 8 threads busy in the transform
// phases, keeps it far from either; a later PR can batch MBs per CTA.
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 64;
constexpr int PAD = 32, CPAD = 16;

__constant__ int kZig4P[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// raster 4x4 block index -> z-scan index (LUMA4x4 raster <-> z)
__constant__ int kZOfRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// the packed table of inter.py:pack_qtab_p
struct QTabP {
  int py_mf[16], py_bias[16], py_dmf[16], pc_mf[16], pc_bias[16], pc_dmf[16];
  int py_qpdiv6, pc_dmf0, pc_mf_dc, pc_bias_dc, pc_qpdiv6;
};
constexpr int QTABP_INTS = sizeof(QTabP) / sizeof(int);

__global__ void __launch_bounds__(NT) p_inter_mb_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, const int* __restrict__ refp,
    const int* __restrict__ refu, const int* __restrict__ refv,
    const int* __restrict__ mv, const int* __restrict__ sad,
    const int* __restrict__ mvp, const int* __restrict__ qtab_g,
    int* __restrict__ RY, int* __restrict__ RU, int* __restrict__ RV,
    int* __restrict__ blocks_z, int* __restrict__ cbp_o,
    int* __restrict__ chroma_dc_o, int* __restrict__ chroma_ac_o,
    int* __restrict__ cost_o, int mb_h, int mb_w, int lam, int decimate) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x;
  const int W = mb_w * 16, H = mb_h * 16, Wc = mb_w * 8, Hc = mb_h * 8;
  const int Wp = W + 2 * PAD, Hp = H + 2 * PAD;
  const int Wcp = Wc + 2 * CPAD, Hcp = Hc + 2 * CPAD;
  const int mvx = mv[2 * mb], mvy = mv[2 * mb + 1];

  __shared__ QTabP q;
  __shared__ int fenc[256], pred[256], lv[16][16], score[16], nzb[16];
  __shared__ int fc[2][64], pc[2][64], clv[2][4][16], cdc[2][4], cscore[8];
  __shared__ int cdcl[2][4], cdcr[2][4], cnz[2], killg[4], ackill;

  // ---------------------------------------------------------- fetch
  for (int i = tid; i < QTABP_INTS; i += NT)
    reinterpret_cast<int*>(&q)[i] = qtab_g[i];
  {
    const int y0 = ds_start(my * 16 + (mvy >> 2) + PAD, Hp, 16);
    const int x0 = ds_start(mx * 16 + (mvx >> 2) + PAD, Wp, 16);
    for (int i = tid; i < 256; i += NT) {
      int r = i >> 4, c = i & 15;
      fenc[i] = Y[(my * 16 + r) * W + mx * 16 + c];
      pred[i] = refp[(y0 + r) * Wp + x0 + c];
    }
  }
  {
    const int dx = mvx & 7, dy = mvy & 7;
    const int ca = (8 - dx) * (8 - dy), cb = dx * (8 - dy);
    const int cc = (8 - dx) * dy, cd = dx * dy;
    const int y0 = ds_start(my * 8 + (mvy >> 3) + CPAD, Hcp, 9);
    const int x0 = ds_start(mx * 8 + (mvx >> 3) + CPAD, Wcp, 9);
    for (int i = tid; i < 128; i += NT) {
      const int ch = i >> 6, k = i & 63, r = k >> 3, c = k & 7;
      const int* R = ch ? refv : refu;
      const int* s = R + (y0 + r) * Wcp + x0 + c;
      pc[ch][k] = (ca * s[0] + cb * s[1] + cc * s[Wcp] + cd * s[Wcp + 1] + 32) >> 6;
      fc[ch][k] = (ch ? V : U)[(my * 8 + r) * Wc + mx * 8 + c];
    }
  }
  __syncthreads();

  // ------------------------------------------- transform + quant
  if (tid < 16) {                      // luma raster block tid
    int by = tid >> 2, bx = tid & 3, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        dd[4 * r + c] = fenc[o] - pred[o];
      }
    dct4x4(dd, co);
    int zz[16];
    for (int i = 0; i < 16; ++i) lv[tid][i] = quant(co[i], q.py_mf[i], q.py_bias[i]);
    for (int j = 0; j < 16; ++j) zz[j] = lv[tid][kZig4P[j]];
    score[tid] = decimate_score(zz, 16);
  } else if (tid >= 32 && tid < 40) {  // chroma block (ch, blk)
    int k = tid - 32, ch = k >> 2, blk = k & 3, by = blk >> 1, bx = blk & 1;
    int dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        dd[4 * r + c] = fc[ch][o] - pc[ch][o];
      }
    dct4x4(dd, co);
    cdc[ch][blk] = co[0];
    co[0] = 0;
    int zz[15];
    for (int i = 0; i < 16; ++i) clv[ch][blk][i] = quant(co[i], q.pc_mf[i], q.pc_bias[i]);
    for (int j = 1; j < 16; ++j) zz[j - 1] = clv[ch][blk][kZig4P[j]];
    cscore[k] = decimate_score(zz, 15);
  }
  __syncthreads();

  // ------------------------------------------------ decimation
  if (tid == 0) {
    int g[4], tot = 0;
    for (int gi = 0; gi < 4; ++gi) {     // 8x8 group (gy, gx) = (gi>>1, gi&1)
      int gy = gi >> 1, gx = gi & 1, s = 0;
      for (int iy = 0; iy < 2; ++iy)
        for (int ix = 0; ix < 2; ++ix) s += score[(2 * gy + iy) * 4 + 2 * gx + ix];
      g[gi] = s;
      tot += s;
    }
    for (int gi = 0; gi < 4; ++gi) killg[gi] = decimate && (g[gi] < 4 || tot < 6);
    int csc = 0;
    for (int k = 0; k < 8; ++k) csc += cscore[k];
    ackill = decimate && csc < 7;
  }
  __syncthreads();

  // ------------------------------------- dequant + recon, outputs
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dq[16], res[16], nz = 0;
    const bool kill = killg[(by >> 1) * 2 + (bx >> 1)];
    for (int i = 0; i < 16; ++i) {
      if (kill) lv[tid][i] = 0;
      nz |= lv[tid][i] != 0;
      dq[i] = dequant(lv[tid][i], q.py_dmf[i], q.py_qpdiv6);
    }
    nzb[tid] = nz;
    idct4x4(dq, res);
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c)
        RY[(my * 16 + 4 * by + r) * W + mx * 16 + 4 * bx + c] =
            clip255(pred[(4 * by + r) * 16 + 4 * bx + c] + res[4 * r + c]);
    int* bz = blocks_z + (mb * 16 + kZOfRaster[tid]) * 16;
    for (int j = 0; j < 16; ++j) bz[j] = lv[tid][kZig4P[j]];
  } else if (tid >= 32 && tid < 40 && ackill) {
    int k = tid - 32;
    for (int i = 0; i < 16; ++i) clv[k >> 2][k & 3][i] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int bits = 0;
    for (int gi = 0; gi < 4; ++gi) {
      int gy = gi >> 1, gx = gi & 1;
      if (nzb[(2 * gy) * 4 + 2 * gx] | nzb[(2 * gy) * 4 + 2 * gx + 1]
          | nzb[(2 * gy + 1) * 4 + 2 * gx] | nzb[(2 * gy + 1) * 4 + 2 * gx + 1])
        bits |= 1 << gi;
    }
    cbp_o[mb] = bits;
    const int mb_bits = se_bits(mvx - mvp[2 * mb]) + se_bits(mvy - mvp[2 * mb + 1]);
    cost_o[mb] = sad[mb] + lam * (mb_bits + 1);
  } else if (tid >= 32 && tid < 34) {  // chroma DC of channel ch
    const int ch = tid - 32;
    int a = cdc[ch][0], b = cdc[ch][1], c = cdc[ch][2], e = cdc[ch][3];
    int h[4] = {a + b + c + e, a - b + c - e, a + b - c - e, a - b - c + e};
    int l[4];
    for (int i = 0; i < 4; ++i) l[i] = quant(h[i], q.pc_mf_dc, q.pc_bias_dc);
    int gg[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                 l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    int nz = 0;
    for (int i = 0; i < 4; ++i) {
      cdcl[ch][i] = l[i];
      cdcr[ch][i] = dequant_2x2_dc(gg[i], q.pc_dmf0, q.pc_qpdiv6);
      for (int j = 0; j < 16; ++j) nz |= clv[ch][i][j] != 0;
    }
    cnz[ch] = nz;
  }
  __syncthreads();
  if (tid >= 32 && tid < 40) {
    int k = tid - 32, ch = k >> 2, blk = k & 3, by = blk >> 1, bx = blk & 1;
    int dq[16], res[16];
    if (cnz[ch]) {
      for (int i = 0; i < 16; ++i) dq[i] = dequant(clv[ch][blk][i], q.pc_dmf[i], q.pc_qpdiv6);
      dq[0] = cdcr[ch][blk];
      idct4x4(dq, res);
    } else {
      for (int i = 0; i < 16; ++i) res[i] = (cdcr[ch][blk] + 32) >> 6;
    }
    int* R = ch ? RV : RU;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        R[(my * 8 + 4 * by + r) * Wc + mx * 8 + 4 * bx + c] = clip255(pc[ch][o] + res[4 * r + c]);
      }
    chroma_dc_o[mb * 8 + ch * 4 + blk] = cdcl[ch][blk];
    for (int j = 0; j < 16; ++j)
      chroma_ac_o[mb * 128 + ch * 64 + blk * 16 + j] = clv[ch][blk][kZig4P[j]];
  }
}

}  // namespace

extern "C" int p_inter_mb(const int* y, const int* u, const int* v,
                          const int* ref_pad, const int* refu_pad,
                          const int* refv_pad, const int* mv, const int* sad,
                          const int* mvp, const int* qtab, int* recon_y,
                          int* recon_u, int* recon_v, int* blocks_z, int* cbp,
                          int* chroma_dc, int* chroma_ac, int* cost, int mb_h,
                          int mb_w, int lam, int decimate, void* stream) {
  p_inter_mb_kernel<<<mb_h * mb_w, NT, 0, (cudaStream_t)stream>>>(
      y, u, v, ref_pad, refu_pad, refv_pad, mv, sad, mvp, qtab, recon_y,
      recon_u, recon_v, blocks_z, cbp, chroma_dc, chroma_ac, cost, mb_h, mb_w,
      lam, decimate);
  return (int)cudaGetLastError();
}

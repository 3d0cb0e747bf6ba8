// K6 p_inter_mb: the inter residual path of every MB of a P frame.
//
// Replaces x264_tpu/ops/mc.py:74 mc_luma and :114 mc_chroma as
// encode_p_body's stage 2 calls them (the partitioned fetch,
// inter.py:420-494), x264_tpu/encoder/inter.py:81 inter_luma_residual
// (with DCT decimation) and the chroma half of stage 2 (the "pc" chroma
// residual with the joint two-channel AC decimation, inter.py:551-567).
// Plain twin:
// x264_tpu_torch/encoder/inter.py:p_inter_mb_plain; wrapper: p_inter_mb.
//
// Design. Inter prediction reads only the reference, so there is no
// wavefront: one launch, one 64-thread CTA per MB. The CTA fetches its
// luma prediction partition by partition (ptype 0 16x16, 1 16x8, 2
// 8x16, 3 8x8; each partition takes the MV of its top-left 8x8
// quadrant): a sample is the rounding average of the two half-pel
// planes its quarter-pel phase names (kHpelRef0/1), each block start
// taken as jax.lax.dynamic_slice takes it (ds_start: a negative start
// wraps once, then clamps, and the plane index clamps into the stack, so
// a one-plane stack serves full-pel MVs). The chroma predictions (8x8,
// 8x4, 4x8 or 4x4 blocks) come from the 1/8-pel bilinear filter
// ((ca*s00 + cb*s01 + cc*s10 + cd*s11 + 32) >> 6). Threads 0-15 then run
// one luma 4x4 block each (DCT, P-matrix quant, decimate score) and
// threads 32-39 one chroma block each. The 8x8-group / whole-MB luma
// kill (score < 4 / total < 6) and the joint chroma AC kill (score < 7)
// are decided by one thread between the phases, then dequant, IDCT and
// reconstruction. With the 8x8 transform (t8 = 1 or 2) threads 48-51
// run one 8x8 block each on the same prediction in shared memory (DCT8,
// CQM_8PY quant, DECIMATE_TAB8 score; a block scoring < 4, or all four
// when the total is < 6, is zeroed; dequant, IDCT8, reconstruction:
// t8.cuh). At t8 = 1 (below subme 6) the MB's transform is chosen here:
// threads 0-15 and 52-55 take the 4x4 and 8x8 Hadamard abs-sums of the
// prediction error, and the 8x8 coding is taken where sa8d_16x16 <
// satd, strictly; its recon, its cbp and zero 4x4 levels are written.
// At t8 = 2 (the RD ladder) both codings are written for K13.
// What bounds it on the H100: bytes. A 1080p frame moves ~116 MB at
// subme >= 2 (source, the four half-pel planes, the padded chroma, and
// the recon and coefficient planes out, as int32: ~35 us at 3.35 TB/s;
// ~52 MB at subme 1, where the stack is one plane) for ~0.08 G integer
// ops (~1 us). One MB per 64-thread CTA, with 16 or 8 threads busy in
// the transform phases, keeps it far from either; a later PR can batch
// MBs per CTA.
#include "t8.cuh"

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
  int p8_mf[64], p8_bias[64], p8_dmf[64];
};
constexpr int QTABP_INTS = sizeof(QTabP) / sizeof(int);

// partition of MB sample (r, c) under ptype: its rectangle in the MB
struct Part {
  int top, left, bh, bw;
};

__device__ __forceinline__ Part part_of(int ptype, int r, int c) {
  switch (ptype) {
    case 1: return Part{r & 8, 0, 8, 16};
    case 2: return Part{0, c & 8, 16, 8};
    case 3: return Part{r & 8, c & 8, 8, 8};
    default: return Part{0, 0, 16, 16};
  }
}

__global__ void __launch_bounds__(NT) p_inter_mb_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, const int* __restrict__ planes,
    const int* __restrict__ refu, const int* __restrict__ refv,
    const int* __restrict__ ptype_g, const int* __restrict__ mv_quad,
    const int* __restrict__ qtab_g, int* __restrict__ RY,
    int* __restrict__ RU, int* __restrict__ RV, int* __restrict__ blocks_z,
    int* __restrict__ cbp_o, int* __restrict__ chroma_dc_o,
    int* __restrict__ chroma_ac_o, int* __restrict__ blocks8_o,
    uint8_t* __restrict__ t8_sel_o, int* __restrict__ R8Y,
    int* __restrict__ cbp8_o, int mb_h, int mb_w, int n_planes, int decimate,
    int t8) {
  const int mb = blockIdx.x, mx = mb % mb_w, my = mb / mb_w;
  const int tid = threadIdx.x;
  const int W = mb_w * 16, H = mb_h * 16, Wc = mb_w * 8, Hc = mb_h * 8;
  const int Wp = W + 2 * PAD, Hp = H + 2 * PAD;
  const int Wcp = Wc + 2 * CPAD, Hcp = Hc + 2 * CPAD;
  const size_t plane = (size_t)Hp * Wp;
  const int pt = ptype_g[mb];

  __shared__ QTabP q;
  __shared__ int fenc[256], pred[256], lv[16][16], score[16], nzb[16];
  __shared__ int fc[2][64], pc[2][64], clv[2][4][16], cdc[2][4], cscore[8];
  __shared__ int cdcl[2][4], cdcr[2][4], cnz[2], killg[4], ackill;
  __shared__ int had4[16], had8[4], lv8[4][64], score8[4], nz8[4], kill8[4];
  __shared__ int sel8;

  // ---------------------------------------------------------- fetch
  for (int i = tid; i < QTABP_INTS; i += NT)
    reinterpret_cast<int*>(&q)[i] = qtab_g[i];
  for (int i = tid; i < 256; i += NT) {
    const int r = i >> 4, c = i & 15;
    const Part p = part_of(pt, r, c);
    const int k = 2 * (p.top >> 3) + (p.left >> 3);
    const int mvx = mv_quad[(mb * 4 + k) * 2], mvy = mv_quad[(mb * 4 + k) * 2 + 1];
    const int fx = mvx & 3, fy = mvy & 3, qi = (fy << 2) | fx;
    const int p0 = ds_start(kHpelRef0[qi], n_planes, 1);
    const int p1 = ds_start(kHpelRef1[qi], n_planes, 1);
    const int iy = my * 16 + p.top + (mvy >> 2) + PAD;
    const int ix = mx * 16 + p.left + (mvx >> 2) + PAD;
    const int ya = ds_start(iy + (fy == 3), Hp, p.bh), xa = ds_start(ix, Wp, p.bw);
    const int yb = ds_start(iy, Hp, p.bh), xb = ds_start(ix + (fx == 3), Wp, p.bw);
    const int rr = r - p.top, cc = c - p.left;
    const int a = planes[p0 * plane + (size_t)(ya + rr) * Wp + xa + cc];
    const int b = planes[p1 * plane + (size_t)(yb + rr) * Wp + xb + cc];
    pred[i] = (a + b + 1) >> 1;
    fenc[i] = Y[(my * 16 + r) * W + mx * 16 + c];
  }
  for (int i = tid; i < 128; i += NT) {
    const int ch = i >> 6, k = i & 63, r = k >> 3, c = k & 7;
    const Part p = part_of(pt, 2 * r, 2 * c);
    const int kq = 2 * (p.top >> 3) + (p.left >> 3);
    const int mvx = mv_quad[(mb * 4 + kq) * 2], mvy = mv_quad[(mb * 4 + kq) * 2 + 1];
    const int dx = mvx & 7, dy = mvy & 7;
    const int ca = (8 - dx) * (8 - dy), cb = dx * (8 - dy);
    const int cc = (8 - dx) * dy, cd = dx * dy;
    const int ctop = p.top >> 1, cleft = p.left >> 1;
    const int y0 = ds_start(my * 8 + ctop + (mvy >> 3) + CPAD, Hcp, p.bh / 2 + 1);
    const int x0 = ds_start(mx * 8 + cleft + (mvx >> 3) + CPAD, Wcp, p.bw / 2 + 1);
    const int* R = ch ? refv : refu;
    const int* s = R + (y0 + r - ctop) * Wcp + x0 + c - cleft;
    pc[ch][k] = (ca * s[0] + cb * s[1] + cc * s[Wcp] + cd * s[Wcp + 1] + 32) >> 6;
    fc[ch][k] = (ch ? V : U)[(my * 8 + r) * Wc + mx * 8 + c];
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
    if (t8 == 1) had4[tid] = abs_had4x4(dd);
    dct4x4(dd, co);
    int zz[16];
    for (int i = 0; i < 16; ++i) lv[tid][i] = quant(co[i], q.py_mf[i], q.py_bias[i]);
    for (int j = 0; j < 16; ++j) zz[j] = lv[tid][kZig4P[j]];
    score[tid] = decimate_score(zz, 16);
  } else if (t8 && tid >= 48 && tid < 56) {  // 8x8 block k: levels, or Hadamard
    const int k = tid & 3, r0 = 8 * (k >> 1), c0 = 8 * (k & 1);
    int dd[64];
    for (int i = 0; i < 64; ++i) {
      const int o = (r0 + (i >> 3)) * 16 + c0 + (i & 7);
      dd[i] = fenc[o] - pred[o];
    }
    if (tid < 52) {
      int co[64], zz[64];
      dct8x8(dd, co);
      for (int i = 0; i < 64; ++i) lv8[k][i] = quant(co[i], q.p8_mf[i], q.p8_bias[i]);
      for (int j = 0; j < 64; ++j) zz[j] = lv8[k][kZig8[j]];
      score8[k] = decimate_score8(zz);
    } else if (t8 == 1) {
      had8[k] = abs_had8x8(dd);
    }
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
    int sel = 0;
    if (t8) {
      const int tot8 = score8[0] + score8[1] + score8[2] + score8[3];
      for (int k = 0; k < 4; ++k) kill8[k] = decimate && (score8[k] < 4 || tot8 < 6);
    }
    if (t8 == 1) {                     // sa8d_16x16 < satd, strictly
      int satd = 0;
      for (int by = 0; by < 4; ++by)
        for (int p = 0; p < 2; ++p)
          satd += (had4[4 * by + 2 * p] + had4[4 * by + 2 * p + 1]) >> 1;
      const int sa8d = (had8[0] + had8[1] + had8[2] + had8[3] + 2) >> 2;
      sel = sa8d < satd;
    }
    sel8 = sel;
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
    if (!sel8)
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          RY[(my * 16 + 4 * by + r) * W + mx * 16 + 4 * bx + c] =
              clip255(pred[(4 * by + r) * 16 + 4 * bx + c] + res[4 * r + c]);
    int* bz = blocks_z + (mb * 16 + kZOfRaster[tid]) * 16;
    for (int j = 0; j < 16; ++j) bz[j] = sel8 ? 0 : lv[tid][kZig4P[j]];
  } else if (t8 && tid >= 48 && tid < 52) {   // 8x8 block: dequant, recon
    const int k = tid - 48, r0 = 8 * (k >> 1), c0 = 8 * (k & 1);
    int dq[64], res[64], nz = 0;
    for (int i = 0; i < 64; ++i) {
      if (kill8[k]) lv8[k][i] = 0;
      nz |= lv8[k][i] != 0;
      dq[i] = dequant8(lv8[k][i], q.p8_dmf[i], q.py_qpdiv6);
    }
    nz8[k] = nz;
    idct8x8(dq, res);
    int* R = t8 == 2 ? R8Y : sel8 ? RY : nullptr;
    if (R)
      for (int i = 0; i < 64; ++i) {
        const int r = r0 + (i >> 3), c = c0 + (i & 7);
        R[(my * 16 + r) * W + mx * 16 + c] = clip255(pred[r * 16 + c] + res[i]);
      }
    for (int j = 0; j < 64; ++j) blocks8_o[(mb * 4 + k) * 64 + j] = lv8[k][kZig8[j]];
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
    const int bits8 = t8 ? nz8[0] | nz8[1] << 1 | nz8[2] << 2 | nz8[3] << 3 : 0;
    cbp_o[mb] = sel8 ? bits8 : bits;
    if (t8 == 1) t8_sel_o[mb] = sel8 ? 1 : 0;
    if (t8 == 2) cbp8_o[mb] = bits8;
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
                          const int* planes, const int* refu_pad,
                          const int* refv_pad, const int* ptype,
                          const int* mv_quad, const int* qtab, int* recon_y,
                          int* recon_u, int* recon_v, int* blocks_z, int* cbp,
                          int* chroma_dc, int* chroma_ac, int* blocks8,
                          uint8_t* t8_sel, int* recon8_y, int* cbp8, int mb_h,
                          int mb_w, int n_planes, int decimate, int t8,
                          void* stream) {
  p_inter_mb_kernel<<<mb_h * mb_w, NT, 0, (cudaStream_t)stream>>>(
      y, u, v, planes, refu_pad, refv_pad, ptype, mv_quad, qtab, recon_y,
      recon_u, recon_v, blocks_z, cbp, chroma_dc, chroma_ac, blocks8, t8_sel,
      recon8_y, cbp8, mb_h, mb_w, n_planes, decimate, t8);
  return (int)cudaGetLastError();
}

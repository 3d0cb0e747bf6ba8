// K1 intra_diag: the all-intra encode of one anti-diagonal of macroblocks.
//
// Replaces x264_tpu/encoder/intra.py:encode_i16_frame (diag_step with
// luma_i16_path, luma_i4_path and chroma_residual; i4x4 on, i8x8 and
// lossless off). Plain twin: x264_tpu_torch/encoder/intra.py
// encode_i16_frame_plain; wrapper: encode_i16_frame.
//
// Design. The host launches this kernel once per anti-diagonal
// d = x + y (187 launches at 1080p), one CTA of 64 threads per MB on the
// diagonal; the MBs of one diagonal are independent, and every launch
// reads the top / left / top-left reconstruction that earlier launches
// wrote into the recon planes. Inside the CTA the MB's source pixels,
// the four I16x16 predictions, the 17x21 I4x4 neighbour buffer `ext`
// and the chroma predictions live in shared memory. Mode scoring runs
// one thread per (mode, 4x4 block) Hadamard; the I4x4 chain of 16
// blocks is sequential by nature (each block predicts from the recon of
// the blocks before it): 9 threads score the 9 modes of a block, then
// one thread transforms, quantises and reconstructs it.
//
// What bounds it on the H100: neither bytes (~40 MB a 1080p frame, some
// 12 us at 3.35 TB/s) nor integer throughput, but the serial depth: 187
// dependent launches, each running a 16-step I4x4 chain on at most 68
// CTAs, leave most of the 132 SMs idle. A persistent kernel over the
// whole frame, and warp-parallel I4x4 transforms, are the later work.
//
// Traps kept bit-exact with the JAX function: mode bits [1,3,3,5];
// unavailable modes cost 1<<28 and argmin takes the first index on ties;
// I4 top-right substitution on z 3, 7, 11, 13, 15 and no DDL/VL on z 5;
// the MPM bit cost and the + lam*24 I4 signalling cost; I4 replaces I16
// only when strictly cheaper; chroma mode by argmin(satd_u + satd_v);
// DC tables mf[0] >> 1 and bias[0] << 1 (packed by the wrapper).
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 64;
constexpr int BIG = 1 << 28;

__constant__ int kZig4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// z-scan 4x4 block -> (bx, by) and raster index 4*by + bx
__constant__ int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kMode16Bits[4] = {1, 3, 3, 5};

// the packed table of intra.py:pack_qtab
struct QTab {
  int y_mf[16], y_bias[16], y_dmf[16], c_mf[16], c_bias[16], c_dmf[16];
  int y_dmf0, y_mf_dc, y_bias_dc, y_qpdiv6, c_dmf0, c_mf_dc, c_bias_dc, c_qpdiv6;
};
constexpr int QTAB_INTS = sizeof(QTab) / sizeof(int);
constexpr int P4_N = 9 * 16 * 3;

__device__ __forceinline__ bool tr_subst(int z) {
  return z == 3 || z == 7 || z == 11 || z == 13 || z == 15 || z == 5;
}

__global__ void __launch_bounds__(NT) intra_diag_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, const int* __restrict__ qtab_g,
    const int* __restrict__ p4_g, int* RY, int* RU, int* RV,
    int* __restrict__ mode16_o, int* __restrict__ modec_o,
    int* __restrict__ luma_dc_o, int* __restrict__ luma_ac_o,
    int* __restrict__ chroma_dc_o, int* __restrict__ chroma_ac_o,
    uint8_t* __restrict__ i4_mb_o, int* i4_modes_o, int* __restrict__ cbp_o,
    int mb_w, int d, int lam) {
  const int my = max(0, d - (mb_w - 1)) + blockIdx.x;
  const int mx = d - my;
  const int W = mb_w * 16, Wc = mb_w * 8;
  const int mb = my * mb_w + mx;
  const int tid = threadIdx.x;
  const bool has_top = my > 0, has_left = mx > 0;

  __shared__ QTab q;
  __shared__ short p4idx[P4_N], p4wgt[P4_N];
  __shared__ int fenc[256], fc[2][64];
  __shared__ int top[16], left[16], topleft;
  __shared__ int ctop[2][8], cleft[2][8], ctl[2];
  __shared__ int pred16[4][256];
  __shared__ int part[64];
  __shared__ int dc16, pa, pb, pc;
  __shared__ int mode16, cost16, cbp16;
  __shared__ int lv16[16][16], dcr16[16], dcl16[16], rec16[256];
  __shared__ int ext[17][21];
  __shared__ int nmt[4], nml[4], modes_r[16], blk4[16][16], nnz4[16];
  __shared__ int cost4c[9], pred4c[9][16];
  __shared__ int total4, cbp4;
  __shared__ int pred8[2][4][64], dcq[2][4], cpa[2], cpb[2], cpc[2];
  __shared__ int cmode;
  __shared__ int cdc[2][4], clv[2][4][16], cdcl[2][4], cdcr[2][4], cnz[2];

  // ------------------------------------------------------------ load
  const int* qg = qtab_g;
  for (int i = tid; i < QTAB_INTS; i += NT) reinterpret_cast<int*>(&q)[i] = qg[i];
  for (int i = tid; i < P4_N; i += NT) {
    p4idx[i] = (short)p4_g[i];
    p4wgt[i] = (short)p4_g[P4_N + i];
  }
  for (int i = tid; i < 256; i += NT)
    fenc[i] = Y[(my * 16 + i / 16) * W + mx * 16 + i % 16];
  for (int i = tid; i < 128; i += NT) {
    const int* P = i < 64 ? U : V;
    int k = i & 63;
    fc[i >> 6][k] = P[(my * 8 + k / 8) * Wc + mx * 8 + k % 8];
  }
  if (tid < 16) {
    top[tid] = has_top ? RY[(my * 16 - 1) * W + mx * 16 + tid] : 0;
    left[tid] = has_left ? RY[(my * 16 + tid) * W + mx * 16 - 1] : 0;
  } else if (tid < 32) {
    int k = tid - 16, ch = k >> 3, i = k & 7;
    const int* R = ch ? RV : RU;
    ctop[ch][i] = has_top ? R[(my * 8 - 1) * Wc + mx * 8 + i] : 0;
    cleft[ch][i] = has_left ? R[(my * 8 + i) * Wc + mx * 8 - 1] : 0;
  } else if (tid < 34) {
    int ch = tid - 32;
    const int* R = ch ? RV : RU;
    ctl[ch] = (has_top && has_left) ? R[(my * 8 - 1) * Wc + mx * 8 - 1] : 0;
  } else if (tid == 34) {
    topleft = (has_top && has_left) ? RY[(my * 16 - 1) * W + mx * 16 - 1] : 0;
  } else if (tid >= 40 && tid < 44) {
    int k = tid - 40;
    nmt[k] = has_top ? i4_modes_o[((my - 1) * mb_w + mx) * 16 + 12 + k] : 2;
    nml[k] = has_left ? i4_modes_o[(my * mb_w + mx - 1) * 16 + 4 * k + 3] : 2;
  }
  __syncthreads();

  // ------------------------------------------------ I16x16 predictions
  if (tid == 0) {
    int st = 0, sl = 0;
    for (int i = 0; i < 16; ++i) { st += top[i]; sl += left[i]; }
    dc16 = (has_top && has_left) ? (st + sl + 16) >> 5
         : has_left ? (sl + 8) >> 4 : has_top ? (st + 8) >> 4 : 128;
    int hh = 0, vv = 0;
    for (int i = 0; i < 8; ++i) {
      int tb = i == 7 ? topleft : top[6 - i];
      int lb = i == 7 ? topleft : left[6 - i];
      hh += (i + 1) * (top[8 + i] - tb);
      vv += (i + 1) * (left[8 + i] - lb);
    }
    pa = 16 * (left[15] + top[15]);
    pb = (5 * hh + 32) >> 6;
    pc = (5 * vv + 32) >> 6;
  } else if (tid == 1) {
    for (int ch = 0; ch < 2; ++ch) {
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      for (int i = 0; i < 4; ++i) {
        s0 += ctop[ch][i]; s1 += ctop[ch][4 + i];
        s2 += cleft[ch][i]; s3 += cleft[ch][4 + i];
      }
      if (has_top && has_left) {
        dcq[ch][0] = (s0 + s2 + 4) >> 3; dcq[ch][1] = (s1 + 2) >> 2;
        dcq[ch][2] = (s3 + 2) >> 2;      dcq[ch][3] = (s1 + s3 + 4) >> 3;
      } else if (has_left) {
        dcq[ch][0] = dcq[ch][1] = (s2 + 2) >> 2;
        dcq[ch][2] = dcq[ch][3] = (s3 + 2) >> 2;
      } else if (has_top) {
        dcq[ch][0] = dcq[ch][2] = (s0 + 2) >> 2;
        dcq[ch][1] = dcq[ch][3] = (s1 + 2) >> 2;
      } else {
        dcq[ch][0] = dcq[ch][1] = dcq[ch][2] = dcq[ch][3] = 128;
      }
      int hh = 0, vv = 0;
      for (int i = 0; i < 4; ++i) {
        int tb = i == 3 ? ctl[ch] : ctop[ch][2 - i];
        int lb = i == 3 ? ctl[ch] : cleft[ch][2 - i];
        hh += (i + 1) * (ctop[ch][4 + i] - tb);
        vv += (i + 1) * (cleft[ch][4 + i] - lb);
      }
      cpa[ch] = 16 * (cleft[ch][7] + ctop[ch][7]);
      cpb[ch] = (17 * hh + 16) >> 5;
      cpc[ch] = (17 * vv + 16) >> 5;
    }
  }
  __syncthreads();
  for (int i = tid; i < 1024; i += NT) {
    int m = i >> 8, k = i & 255, yy = k >> 4, xx = k & 15, p;
    if (m == 0) p = top[xx];
    else if (m == 1) p = left[yy];
    else if (m == 2) p = dc16;
    else p = clip255((pa + pb * (xx - 7) + pc * (yy - 7) + 16) >> 5);
    pred16[m][k] = p;
  }
  for (int i = tid; i < 512; i += NT) {
    int ch = i >> 8, m = (i >> 6) & 3, k = i & 63, yy = k >> 3, xx = k & 7, p;
    if (m == 0) p = dcq[ch][(yy >> 2) * 2 + (xx >> 2)];
    else if (m == 1) p = cleft[ch][yy];
    else if (m == 2) p = ctop[ch][xx];
    else p = clip255((cpa[ch] + cpb[ch] * (xx - 3) + cpc[ch] * (yy - 3) + 16) >> 5);
    pred8[ch][m][k] = p;
  }
  __syncthreads();

  // ------------------------------------------------ I16x16 decision
  {
    int m = tid >> 4, k = tid & 15, by = k >> 2, bx = k & 3, dd[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        dd[4 * r + c] = fenc[o] - pred16[m][o];
      }
    part[tid] = abs_had4x4(dd);
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0, bc = 0;
    for (int m = 0; m < 4; ++m) {
      int s = 0;
      for (int by = 0; by < 4; ++by)
        for (int p = 0; p < 2; ++p)
          s += (part[m * 16 + by * 4 + 2 * p] + part[m * 16 + by * 4 + 2 * p + 1]) >> 1;
      bool avail = m == 0 ? has_top : m == 1 ? has_left : m == 2 ? true
                 : (has_top && has_left);
      int c = avail ? s + lam * kMode16Bits[m] : BIG;
      if (m == 0 || c < bc) { bc = c; best = m; }
    }
    mode16 = best;
    cost16 = bc;
  }
  __syncthreads();

  // ------------------------------------------------ I16x16 residual
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        dd[4 * r + c] = fenc[o] - pred16[mode16][o];
      }
    dct4x4(dd, co);
    dcr16[tid] = co[0];
    co[0] = 0;
    for (int i = 0; i < 16; ++i) lv16[tid][i] = quant(co[i], q.y_mf[i], q.y_bias[i]);
  }
  __syncthreads();
  if (tid == 0) {
    int h[16], lv[16], inv[16];
    had4x4(dcr16, h);
    for (int i = 0; i < 16; ++i) lv[i] = quant((h[i] + 1) >> 1, q.y_mf_dc, q.y_bias_dc);
    had4x4(lv, inv);
    for (int i = 0; i < 16; ++i) {
      dcl16[i] = lv[i];
      dcr16[i] = dequant_4x4_dc(inv[i], q.y_dmf0, q.y_qpdiv6);
    }
    int nz = 0;
    for (int b = 0; b < 16; ++b)
      for (int i = 0; i < 16; ++i) nz |= lv16[b][i] != 0;
    cbp16 = nz;
  }
  __syncthreads();
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dq[16], res[16];
    if (cbp16) {
      for (int i = 0; i < 16; ++i) dq[i] = dequant(lv16[tid][i], q.y_dmf[i], q.y_qpdiv6);
      dq[0] = dcr16[tid];
      idct4x4(dq, res);
    } else {
      for (int i = 0; i < 16; ++i) res[i] = (dcr16[tid] + 32) >> 6;
    }
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        rec16[o] = clip255(pred16[mode16][o] + res[4 * r + c]);
      }
  }

  // ------------------------------------------------ I4x4 ladder
  for (int i = tid; i < 17 * 21; i += NT) {
    int r = i / 21, c = i % 21, v = 0;
    if (r == 0 && c == 0) v = topleft;
    else if (r == 0) v = top[min(c - 1, 15)];
    else if (c == 0) v = left[r - 1];
    ext[r][c] = v;
  }
  if (tid == 0) total4 = 0;
  __syncthreads();
  for (int z = 0; z < 16; ++z) {
    const int bx = kBlkX[z], by = kBlkY[z];
    if (tid < 9) {
      const int m = tid;
      int e[13];
      for (int i = 0; i < 4; ++i) {
        e[3 - i] = ext[1 + 4 * by + i][4 * bx];                 // l0..l3 reversed
        e[5 + i] = ext[4 * by][1 + 4 * bx + i];                 // t0..t3
      }
      e[4] = ext[4 * by][4 * bx];                               // lt
      for (int i = 0; i < 4; ++i)
        e[9 + i] = tr_subst(z) ? e[8] : ext[4 * by][5 + 4 * bx + i];
      const bool ht = by == 0 ? has_top : true;
      const bool hl = bx == 0 ? has_left : true;
      bool avail = m == 0 ? ht : m == 1 ? hl : m == 2 ? true
                 : m == 3 ? ht : m == 7 ? ht : m == 8 ? hl : (ht && hl);
      if (z == 5 && (m == 3 || m == 7)) avail = false;
      int p[16];
      if (m == 2) {
        int st = e[5] + e[6] + e[7] + e[8], sl = e[0] + e[1] + e[2] + e[3];
        int dc = (ht && hl) ? (st + sl + 4) >> 3 : hl ? (sl + 2) >> 2
               : ht ? (st + 2) >> 2 : 128;
        for (int i = 0; i < 16; ++i) p[i] = dc;
      } else {
        for (int i = 0; i < 16; ++i) {
          int o = (m * 16 + i) * 3;
          p[i] = (e[p4idx[o]] * p4wgt[o] + e[p4idx[o + 1]] * p4wgt[o + 1]
                  + e[p4idx[o + 2]] * p4wgt[o + 2] + 2) >> 2;
        }
      }
      int dd[16];
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          dd[4 * r + c] = fenc[(4 * by + r) * 16 + 4 * bx + c] - p[4 * r + c];
      const int lmode = bx > 0 ? modes_r[4 * by + bx - 1] : nml[by];
      const int tmode = by > 0 ? modes_r[4 * (by - 1) + bx] : nmt[bx];
      const int mpm = min(lmode, tmode);
      cost4c[m] = avail ? (abs_had4x4(dd) >> 1) + lam * (m == mpm ? 1 : 4) : BIG;
      for (int i = 0; i < 16; ++i) pred4c[m][i] = p[i];
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0;
      for (int m = 1; m < 9; ++m)
        if (cost4c[m] < cost4c[best]) best = m;
      total4 += cost4c[best];
      int dd[16], co[16], lv[16], dq[16], res[16], nz = 0;
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          dd[4 * r + c] = fenc[(4 * by + r) * 16 + 4 * bx + c] - pred4c[best][4 * r + c];
      dct4x4(dd, co);
      for (int i = 0; i < 16; ++i) {
        lv[i] = quant(co[i], q.y_mf[i], q.y_bias[i]);
        nz += lv[i] != 0;
        dq[i] = dequant(lv[i], q.y_dmf[i], q.y_qpdiv6);
      }
      idct4x4(dq, res);
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          ext[1 + 4 * by + r][1 + 4 * bx + c] = clip255(pred4c[best][4 * r + c] + res[4 * r + c]);
      modes_r[4 * by + bx] = best;
      for (int j = 0; j < 16; ++j) blk4[z][j] = lv[kZig4[j]];
      nnz4[z] = nz;
    }
    __syncthreads();
  }
  if (tid == 0) {
    int bits = 0;
    for (int g = 0; g < 4; ++g)
      if (nnz4[4 * g] + nnz4[4 * g + 1] + nnz4[4 * g + 2] + nnz4[4 * g + 3] > 0)
        bits |= 1 << g;
    cbp4 = bits;
    total4 += lam * 24;
  }

  // ------------------------------------------------ chroma decision
  if (tid < 32) {
    int ch = tid >> 4, m = (tid >> 2) & 3, blk = tid & 3, by = blk >> 1, bx = blk & 1;
    int dd[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        dd[4 * r + c] = fc[ch][o] - pred8[ch][m][o];
      }
    part[tid] = abs_had4x4(dd);
  }
  __syncthreads();
  const bool use_i4 = total4 < cost16;
  if (tid == 0) {
    int best = 0, bc = 0;
    for (int m = 0; m < 4; ++m) {
      int s = 0;
      for (int ch = 0; ch < 2; ++ch)
        for (int by = 0; by < 2; ++by)
          s += (part[ch * 16 + m * 4 + 2 * by] + part[ch * 16 + m * 4 + 2 * by + 1]) >> 1;
      bool avail = m == 0 ? true : m == 1 ? has_left : m == 2 ? has_top
                 : (has_top && has_left);
      int c = avail ? s : BIG;
      if (m == 0 || c < bc) { bc = c; best = m; }
    }
    cmode = best;
  }

  // ------------------------------------------------ luma outputs
  for (int i = tid; i < 256; i += NT) {
    int r = i >> 4, c = i & 15;
    RY[(my * 16 + r) * W + mx * 16 + c] = use_i4 ? ext[1 + r][1 + c] : rec16[i];
    int z = i >> 4, j = i & 15;
    luma_ac_o[mb * 256 + i] = use_i4 ? blk4[z][j]
        : lv16[4 * kBlkY[z] + kBlkX[z]][kZig4[j]];
  }
  if (tid < 16) {
    luma_dc_o[mb * 16 + tid] = use_i4 ? 0 : dcl16[kZig4[tid]];
    i4_modes_o[mb * 16 + tid] = use_i4 ? modes_r[tid] : 2;
  } else if (tid == 16) {
    cbp_o[mb] = use_i4 ? cbp4 : (cbp16 ? 15 : 0);
    i4_mb_o[mb] = use_i4 ? 1 : 0;
    mode16_o[mb] = mode16;
  }
  __syncthreads();

  // ------------------------------------------------ chroma residual
  if (tid < 8) {
    int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        dd[4 * r + c] = fc[ch][o] - pred8[ch][cmode][o];
      }
    dct4x4(dd, co);
    cdc[ch][blk] = co[0];
    co[0] = 0;
    for (int i = 0; i < 16; ++i) clv[ch][blk][i] = quant(co[i], q.c_mf[i], q.c_bias[i]);
  }
  __syncthreads();
  if (tid < 2) {
    const int ch = tid;
    int a = cdc[ch][0], b = cdc[ch][1], c = cdc[ch][2], e = cdc[ch][3];
    int h[4] = {a + b + c + e, a - b + c - e, a + b - c - e, a - b - c + e};
    int l[4];
    for (int i = 0; i < 4; ++i) l[i] = quant(h[i], q.c_mf_dc, q.c_bias_dc);
    int g[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    int nz = 0;
    for (int i = 0; i < 4; ++i) {
      cdcl[ch][i] = l[i];
      cdcr[ch][i] = dequant_2x2_dc(g[i], q.c_dmf0, q.c_qpdiv6);
      for (int j = 0; j < 16; ++j) nz |= clv[ch][i][j] != 0;
    }
    cnz[ch] = nz;
    modec_o[mb] = cmode;
  }
  __syncthreads();
  if (tid < 8) {
    int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1, dq[16], res[16];
    if (cnz[ch]) {
      for (int i = 0; i < 16; ++i) dq[i] = dequant(clv[ch][blk][i], q.c_dmf[i], q.c_qpdiv6);
      dq[0] = cdcr[ch][blk];
      idct4x4(dq, res);
    } else {
      for (int i = 0; i < 16; ++i) res[i] = (cdcr[ch][blk] + 32) >> 6;
    }
    int* R = ch ? RV : RU;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        R[(my * 8 + 4 * by + r) * Wc + mx * 8 + 4 * bx + c] =
            clip255(pred8[ch][cmode][o] + res[4 * r + c]);
      }
    chroma_dc_o[mb * 8 + ch * 4 + blk] = cdcl[ch][blk];
    for (int j = 0; j < 16; ++j)
      chroma_ac_o[mb * 128 + ch * 64 + blk * 16 + j] = clv[ch][blk][kZig4[j]];
  }
}

}  // namespace

extern "C" int intra_diag(const int* y, const int* u, const int* v,
                          const int* qtab, const int* p4tab, int* recon_y,
                          int* recon_u, int* recon_v, int* mode16, int* modec,
                          int* luma_dc, int* luma_ac, int* chroma_dc,
                          int* chroma_ac, uint8_t* i4_mb, int* i4_modes,
                          int* cbp_luma_bits, int mb_h, int mb_w, int d,
                          int lam, void* stream) {
  const int y0 = max(0, d - (mb_w - 1)), y1 = min(mb_h - 1, d);
  if (y1 < y0) return 0;
  intra_diag_kernel<<<y1 - y0 + 1, NT, 0, (cudaStream_t)stream>>>(
      y, u, v, qtab, p4tab, recon_y, recon_u, recon_v, mode16, modec, luma_dc,
      luma_ac, chroma_dc, chroma_ac, i4_mb, i4_modes, cbp_luma_bits, mb_w, d,
      lam);
  return (int)cudaGetLastError();
}

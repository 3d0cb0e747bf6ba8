// The I16x16 + chroma intra path of one macroblock, shared by K1
// (intra.cu, the all-intra wavefront) and K7 (intra_p.cu, intra-in-P).
//
// Block-level device code: one CTA of IMB_NT = 64 threads per MB calls
// every function (each ends in __syncthreads), with the MB's state in
// one IntraMB in shared memory. It is the per-MB form of
// x264_tpu_torch/encoder/intra.py's luma_i16_path, predict_8x8c mode
// decision and chroma_residual ("c" tables), bit-exact with them:
//   imb_load          source samples, reconstructed neighbours, tables
//   imb_predict       the four I16x16 and the four chroma predictions
//   imb_i16_decide    SATD + lambda * mode bits, or a fixed mode
//   imb_i16_residual  DCT, AC quant (+ the P-slice AC decimation), DC
//                     Hadamard, dequant, IDCT, reconstruction in rec16
//   imb_chroma_decide argmin of the U + V SATD, or a fixed mode
//   imb_chroma_residual  DCT, quant, 2x2 DC, dequant, IDCT, crec
#pragma once
#include "common.cuh"

namespace x264t {

constexpr int IMB_NT = 64;
constexpr int IMB_BIG = 1 << 28;

__constant__ int kZig4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// z-scan 4x4 block -> (bx, by); raster index 4*by + bx
__constant__ int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kMode16Bits[4] = {1, 3, 3, 5};

// the packed table of intra.py:pack_qtab (the I8x8 tables last)
struct QTab {
  int y_mf[16], y_bias[16], y_dmf[16], c_mf[16], c_bias[16], c_dmf[16];
  int y_dmf0, y_mf_dc, y_bias_dc, y_qpdiv6, c_dmf0, c_mf_dc, c_bias_dc, c_qpdiv6;
  int y8_mf[64], y8_bias[64], y8_dmf[64];
};
constexpr int QTAB_INTS = sizeof(QTab) / sizeof(int);

struct IntraMB {
  QTab q;
  int fenc[256], fc[2][64];
  int top[16], left[16], topleft;
  int ctop[2][8], cleft[2][8], ctl[2];
  int pred16[4][256];
  int part[64];
  int dc16, pa, pb, pc, flag;
  int mode16, cost16, cbp16;
  int lv16[16][16], dcr16[16], dcl16[16], rec16[256];
  int pred8[2][4][64], dcq[2][4], cpa[2], cpb[2], cpc[2];
  int cmode;
  int cdc[2][4], clv[2][4][16], cdcl[2][4], cdcr[2][4], cnz[2], crec[2][64];
};

// The tables, the MB's source samples and its top / left / top-left
// neighbours from the reconstruction planes RY / RU / RV (0 where
// unavailable). Threads >= 35 are free for the caller's own loads; the
// caller synchronises.
__device__ __forceinline__ void imb_load(
    IntraMB& S, const int* __restrict__ qtab_g, const int* __restrict__ Y,
    const int* __restrict__ U, const int* __restrict__ V, const int* RY,
    const int* RU, const int* RV, int mb_w, int mx, int my, bool has_top,
    bool has_left) {
  const int tid = threadIdx.x, W = mb_w * 16, Wc = mb_w * 8;
  for (int i = tid; i < QTAB_INTS; i += IMB_NT)
    reinterpret_cast<int*>(&S.q)[i] = qtab_g[i];
  for (int i = tid; i < 256; i += IMB_NT)
    S.fenc[i] = Y[(my * 16 + i / 16) * W + mx * 16 + i % 16];
  for (int i = tid; i < 128; i += IMB_NT) {
    const int* P = i < 64 ? U : V;
    int k = i & 63;
    S.fc[i >> 6][k] = P[(my * 8 + k / 8) * Wc + mx * 8 + k % 8];
  }
  if (tid < 16) {
    S.top[tid] = has_top ? RY[(my * 16 - 1) * W + mx * 16 + tid] : 0;
    S.left[tid] = has_left ? RY[(my * 16 + tid) * W + mx * 16 - 1] : 0;
  } else if (tid < 32) {
    int k = tid - 16, ch = k >> 3, i = k & 7;
    const int* R = ch ? RV : RU;
    S.ctop[ch][i] = has_top ? R[(my * 8 - 1) * Wc + mx * 8 + i] : 0;
    S.cleft[ch][i] = has_left ? R[(my * 8 + i) * Wc + mx * 8 - 1] : 0;
  } else if (tid < 34) {
    int ch = tid - 32;
    const int* R = ch ? RV : RU;
    S.ctl[ch] = (has_top && has_left) ? R[(my * 8 - 1) * Wc + mx * 8 - 1] : 0;
  } else if (tid == 34) {
    S.topleft = (has_top && has_left) ? RY[(my * 16 - 1) * W + mx * 16 - 1] : 0;
  }
}

// predict_16x16 and predict_8x8c (ops/predict.py) into pred16 / pred8
__device__ __forceinline__ void imb_predict(IntraMB& S, bool has_top,
                                            bool has_left) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    int st = 0, sl = 0;
    for (int i = 0; i < 16; ++i) { st += S.top[i]; sl += S.left[i]; }
    S.dc16 = (has_top && has_left) ? (st + sl + 16) >> 5
           : has_left ? (sl + 8) >> 4 : has_top ? (st + 8) >> 4 : 128;
    int hh = 0, vv = 0;
    for (int i = 0; i < 8; ++i) {
      int tb = i == 7 ? S.topleft : S.top[6 - i];
      int lb = i == 7 ? S.topleft : S.left[6 - i];
      hh += (i + 1) * (S.top[8 + i] - tb);
      vv += (i + 1) * (S.left[8 + i] - lb);
    }
    S.pa = 16 * (S.left[15] + S.top[15]);
    S.pb = (5 * hh + 32) >> 6;
    S.pc = (5 * vv + 32) >> 6;
  } else if (tid == 1) {
    for (int ch = 0; ch < 2; ++ch) {
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      for (int i = 0; i < 4; ++i) {
        s0 += S.ctop[ch][i]; s1 += S.ctop[ch][4 + i];
        s2 += S.cleft[ch][i]; s3 += S.cleft[ch][4 + i];
      }
      int* dq = S.dcq[ch];
      if (has_top && has_left) {
        dq[0] = (s0 + s2 + 4) >> 3; dq[1] = (s1 + 2) >> 2;
        dq[2] = (s3 + 2) >> 2;      dq[3] = (s1 + s3 + 4) >> 3;
      } else if (has_left) {
        dq[0] = dq[1] = (s2 + 2) >> 2;
        dq[2] = dq[3] = (s3 + 2) >> 2;
      } else if (has_top) {
        dq[0] = dq[2] = (s0 + 2) >> 2;
        dq[1] = dq[3] = (s1 + 2) >> 2;
      } else {
        dq[0] = dq[1] = dq[2] = dq[3] = 128;
      }
      int hh = 0, vv = 0;
      for (int i = 0; i < 4; ++i) {
        int tb = i == 3 ? S.ctl[ch] : S.ctop[ch][2 - i];
        int lb = i == 3 ? S.ctl[ch] : S.cleft[ch][2 - i];
        hh += (i + 1) * (S.ctop[ch][4 + i] - tb);
        vv += (i + 1) * (S.cleft[ch][4 + i] - lb);
      }
      S.cpa[ch] = 16 * (S.cleft[ch][7] + S.ctop[ch][7]);
      S.cpb[ch] = (17 * hh + 16) >> 5;
      S.cpc[ch] = (17 * vv + 16) >> 5;
    }
  }
  __syncthreads();
  for (int i = tid; i < 1024; i += IMB_NT) {
    int m = i >> 8, k = i & 255, yy = k >> 4, xx = k & 15, p;
    if (m == 0) p = S.top[xx];
    else if (m == 1) p = S.left[yy];
    else if (m == 2) p = S.dc16;
    else p = clip255((S.pa + S.pb * (xx - 7) + S.pc * (yy - 7) + 16) >> 5);
    S.pred16[m][k] = p;
  }
  for (int i = tid; i < 512; i += IMB_NT) {
    int ch = i >> 8, m = (i >> 6) & 3, k = i & 63, yy = k >> 3, xx = k & 7, p;
    if (m == 0) p = S.dcq[ch][(yy >> 2) * 2 + (xx >> 2)];
    else if (m == 1) p = S.cleft[ch][yy];
    else if (m == 2) p = S.ctop[ch][xx];
    else p = clip255((S.cpa[ch] + S.cpb[ch] * (xx - 3) + S.cpc[ch] * (yy - 3) + 16) >> 5);
    S.pred8[ch][m][k] = p;
  }
  __syncthreads();
}

// I16x16 mode: argmin of SATD + lam * mode bits over the available modes
// (first index on ties), its cost in cost16; or fixed_mode >= 0 with
// cost 0 (the re-evaluation sweeps of intra-in-P)
__device__ __forceinline__ void imb_i16_decide(IntraMB& S, bool has_top,
                                               bool has_left, int lam,
                                               int fixed_mode) {
  const int tid = threadIdx.x;
  if (fixed_mode >= 0) {
    if (tid == 0) { S.mode16 = fixed_mode; S.cost16 = 0; }
    __syncthreads();
    return;
  }
  {
    int m = tid >> 4, k = tid & 15, by = k >> 2, bx = k & 3, dd[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        dd[4 * r + c] = S.fenc[o] - S.pred16[m][o];
      }
    S.part[tid] = abs_had4x4(dd);
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0, bc = 0;
    for (int m = 0; m < 4; ++m) {
      int s = 0;
      for (int by = 0; by < 4; ++by)
        for (int p = 0; p < 2; ++p)
          s += (S.part[m * 16 + by * 4 + 2 * p] + S.part[m * 16 + by * 4 + 2 * p + 1]) >> 1;
      bool avail = m == 0 ? has_top : m == 1 ? has_left : m == 2 ? true
                 : (has_top && has_left);
      int c = avail ? s + lam * kMode16Bits[m] : IMB_BIG;
      if (m == 0 || c < bc) { bc = c; best = m; }
    }
    S.mode16 = best;
    S.cost16 = bc;
  }
  __syncthreads();
}

// I16x16 residual of mode16: AC levels lv16 (raster blocks, raster
// coefficients), DC levels dcl16, cbp16, reconstruction rec16. decimate:
// a total AC score (zig-zag positions 1..15) < 6 zeroes every AC level
__device__ __forceinline__ void imb_i16_residual(IntraMB& S, bool decimate) {
  const int tid = threadIdx.x;
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        dd[4 * r + c] = S.fenc[o] - S.pred16[S.mode16][o];
      }
    dct4x4(dd, co);
    S.dcr16[tid] = co[0];
    co[0] = 0;
    for (int i = 0; i < 16; ++i) S.lv16[tid][i] = quant(co[i], S.q.y_mf[i], S.q.y_bias[i]);
  }
  __syncthreads();
  if (decimate) {
    if (tid < 16) {
      int zz[15];
      for (int j = 1; j < 16; ++j) zz[j - 1] = S.lv16[tid][kZig4[j]];
      S.part[tid] = decimate_score(zz, 15);
    }
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int b = 0; b < 16; ++b) s += S.part[b];
      S.flag = s < 6;
    }
    __syncthreads();
    if (S.flag)
      for (int i = tid; i < 256; i += IMB_NT) S.lv16[i >> 4][i & 15] = 0;
    __syncthreads();
  }
  if (tid == 0) {
    int h[16], lv[16], inv[16];
    had4x4(S.dcr16, h);
    for (int i = 0; i < 16; ++i) lv[i] = quant((h[i] + 1) >> 1, S.q.y_mf_dc, S.q.y_bias_dc);
    had4x4(lv, inv);
    for (int i = 0; i < 16; ++i) {
      S.dcl16[i] = lv[i];
      S.dcr16[i] = dequant_4x4_dc(inv[i], S.q.y_dmf0, S.q.y_qpdiv6);
    }
    int nz = 0;
    for (int b = 0; b < 16; ++b)
      for (int i = 0; i < 16; ++i) nz |= S.lv16[b][i] != 0;
    S.cbp16 = nz;
  }
  __syncthreads();
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dq[16], res[16];
    if (S.cbp16) {
      for (int i = 0; i < 16; ++i) dq[i] = dequant(S.lv16[tid][i], S.q.y_dmf[i], S.q.y_qpdiv6);
      dq[0] = S.dcr16[tid];
      idct4x4(dq, res);
    } else {
      for (int i = 0; i < 16; ++i) res[i] = (S.dcr16[tid] + 32) >> 6;
    }
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 16 + 4 * bx + c;
        S.rec16[o] = clip255(S.pred16[S.mode16][o] + res[4 * r + c]);
      }
  }
  __syncthreads();
}

// chroma mode: argmin of satd_u + satd_v over the available modes, or
// fixed_cmode >= 0
__device__ __forceinline__ void imb_chroma_decide(IntraMB& S, bool has_top,
                                                  bool has_left,
                                                  int fixed_cmode) {
  const int tid = threadIdx.x;
  if (fixed_cmode >= 0) {
    if (tid == 0) S.cmode = fixed_cmode;
    __syncthreads();
    return;
  }
  if (tid < 32) {
    int ch = tid >> 4, m = (tid >> 2) & 3, blk = tid & 3, by = blk >> 1, bx = blk & 1;
    int dd[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        dd[4 * r + c] = S.fc[ch][o] - S.pred8[ch][m][o];
      }
    S.part[tid] = abs_had4x4(dd);
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0, bc = 0;
    for (int m = 0; m < 4; ++m) {
      int s = 0;
      for (int ch = 0; ch < 2; ++ch)
        for (int by = 0; by < 2; ++by)
          s += (S.part[ch * 16 + m * 4 + 2 * by] + S.part[ch * 16 + m * 4 + 2 * by + 1]) >> 1;
      bool avail = m == 0 ? true : m == 1 ? has_left : m == 2 ? has_top
                 : (has_top && has_left);
      int c = avail ? s : IMB_BIG;
      if (m == 0 || c < bc) { bc = c; best = m; }
    }
    S.cmode = best;
  }
  __syncthreads();
}

// chroma residual of cmode with the intra ("c") tables: AC levels clv
// (raster coefficients), DC levels cdcl, reconstruction crec
__device__ __forceinline__ void imb_chroma_residual(IntraMB& S) {
  const int tid = threadIdx.x;
  if (tid < 8) {
    int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        dd[4 * r + c] = S.fc[ch][o] - S.pred8[ch][S.cmode][o];
      }
    dct4x4(dd, co);
    S.cdc[ch][blk] = co[0];
    co[0] = 0;
    for (int i = 0; i < 16; ++i) S.clv[ch][blk][i] = quant(co[i], S.q.c_mf[i], S.q.c_bias[i]);
  }
  __syncthreads();
  if (tid < 2) {
    const int ch = tid;
    int a = S.cdc[ch][0], b = S.cdc[ch][1], c = S.cdc[ch][2], e = S.cdc[ch][3];
    int h[4] = {a + b + c + e, a - b + c - e, a + b - c - e, a - b - c + e};
    int l[4];
    for (int i = 0; i < 4; ++i) l[i] = quant(h[i], S.q.c_mf_dc, S.q.c_bias_dc);
    int g[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    int nz = 0;
    for (int i = 0; i < 4; ++i) {
      S.cdcl[ch][i] = l[i];
      S.cdcr[ch][i] = dequant_2x2_dc(g[i], S.q.c_dmf0, S.q.c_qpdiv6);
      for (int j = 0; j < 16; ++j) nz |= S.clv[ch][i][j] != 0;
    }
    S.cnz[ch] = nz;
  }
  __syncthreads();
  if (tid < 8) {
    int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1, dq[16], res[16];
    if (S.cnz[ch]) {
      for (int i = 0; i < 16; ++i) dq[i] = dequant(S.clv[ch][blk][i], S.q.c_dmf[i], S.q.c_qpdiv6);
      dq[0] = S.cdcr[ch][blk];
      idct4x4(dq, res);
    } else {
      for (int i = 0; i < 16; ++i) res[i] = (S.cdcr[ch][blk] + 32) >> 6;
    }
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        int o = (4 * by + r) * 8 + 4 * bx + c;
        S.crec[ch][o] = clip255(S.pred8[ch][S.cmode][o] + res[4 * r + c]);
      }
  }
  __syncthreads();
}

}  // namespace x264t

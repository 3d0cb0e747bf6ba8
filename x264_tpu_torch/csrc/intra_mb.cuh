// The I16x16 + chroma intra path of one macroblock, shared by K1
// (intra.cu, the all-intra wavefront) and K7 (intra_p.cu, intra-in-P).
//
// Block-level device code: one CTA of IMB_NT = 64 threads per MB calls
// every function (each ends in __syncthreads), with the MB's state in
// one IntraMB in shared memory; the residual and chroma functions also
// run on one warp of the CTA (ImbWarp, K7's sweeps). It is the per-MB form of
// x264_tpu_torch/encoder/intra.py's luma_i16_path, predict_8x8c mode
// decision and chroma_residual ("c" tables), bit-exact with them:
//   imb_load          source samples, reconstructed neighbours, tables
//   imb_predict       the four I16x16 and the four chroma predictions
//   imb_i16_decide    SATD + lambda * mode bits, or a fixed mode
//   imb_i16_residual  DCT, AC quant (+ the P-slice AC decimation), DC
//                     Hadamard, dequant, IDCT, reconstruction in rec16
//   imb_chroma_decide argmin of the U + V SATD, or a fixed mode
//   imb_chroma_residual  DCT, quant, 2x2 DC, dequant, IDCT, crec
// Both residual functions take the lossless transform bypass
// (qpprime_y_zero_transform_bypass, x264_tpu intra.py:97-113 and
// :172-181): the residual samples are the levels, sample 0 of each 4x4
// rides the DC list untransformed, and the reconstruction is the source.
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

// Laid out for shared memory's banks: lv16 and clv rows are padded to 17
// ints, so that the threads that own a block each (16 or 8 of them) touch
// distinct banks; the sample planes are 16-byte aligned and read and
// written a block row (4 samples) at a time
struct alignas(16) IntraMB {
  QTab q;
  alignas(16) int fenc[256];
  alignas(16) int fc[2][64];
  int top[16], left[16], topleft;
  int ctop[2][8], cleft[2][8], ctl[2];
  alignas(16) int pred16[4][256];
  int part[64];
  int dc16, pa, pb, pc, flag;
  int mode16, cost16, cbp16;
  int lv16[16][17], dcr16[16], dcl16[16];
  alignas(16) int rec16[256];
  alignas(16) int pred8[2][4][64];
  int dcq[2][4], cpa[2], cpb[2], cpc[2];
  int cmode;
  int cdc[2][4], clv[2][4][17], cdcl[2][4], cdcr[2][4], cnz[2];
  alignas(16) int crec[2][64];
};

// the reconstruction planes one neighbour of the MB is read from
struct ImbNbr {
  const int* y;
  const int* u;
  const int* v;
};

// 4 samples of a block row, 16-byte aligned in shared memory: a - b into
// d, and clip255(p + res) into out (one vector access each)
__device__ __forceinline__ void rows_diff(int* d, const int* a, const int* b) {
  const int4 x = *reinterpret_cast<const int4*>(a);
  const int4 y = *reinterpret_cast<const int4*>(b);
  d[0] = x.x - y.x, d[1] = x.y - y.y, d[2] = x.z - y.z, d[3] = x.w - y.w;
}

__device__ __forceinline__ void row_recon(int* out, const int* p,
                                          const int* res) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  *reinterpret_cast<int4*>(out) = make_int4(
      clip255(x.x + res[0]), clip255(x.y + res[1]), clip255(x.z + res[2]),
      clip255(x.w + res[3]));
}

// The tables, the MB's source samples and its top / left / top-left
// neighbours, each from its own reconstruction planes t / l / tl (0 where
// unavailable). Threads >= 35 are free for the caller's own loads; the
// caller synchronises.
__device__ __forceinline__ void imb_load(
    IntraMB& S, const int* __restrict__ qtab_g, const int* __restrict__ Y,
    const int* __restrict__ U, const int* __restrict__ V, const ImbNbr t,
    const ImbNbr l, const ImbNbr tl, int mb_w, int mx, int my, bool has_top,
    bool has_left) {
  const int tid = threadIdx.x, W = mb_w * 16, Wc = mb_w * 8;
  // every load issued before the first store
  constexpr int QN = (QTAB_INTS + IMB_NT - 1) / IMB_NT;
  int qv[QN], fv[256 / IMB_NT], cv[128 / IMB_NT];
#pragma unroll
  for (int k = 0; k < QN; ++k)
    qv[k] = tid + k * IMB_NT < QTAB_INTS ? qtab_g[tid + k * IMB_NT] : 0;
#pragma unroll
  for (int k = 0; k < 256 / IMB_NT; ++k) {
    const int i = tid + k * IMB_NT;
    fv[k] = Y[(my * 16 + i / 16) * W + mx * 16 + i % 16];
  }
#pragma unroll
  for (int k = 0; k < 128 / IMB_NT; ++k) {
    const int i = tid + k * IMB_NT, c = i & 63;
    cv[k] = (i < 64 ? U : V)[(my * 8 + c / 8) * Wc + mx * 8 + c % 8];
  }
#pragma unroll
  for (int k = 0; k < QN; ++k)
    if (tid + k * IMB_NT < QTAB_INTS)
      reinterpret_cast<int*>(&S.q)[tid + k * IMB_NT] = qv[k];
#pragma unroll
  for (int k = 0; k < 256 / IMB_NT; ++k) S.fenc[tid + k * IMB_NT] = fv[k];
#pragma unroll
  for (int k = 0; k < 128 / IMB_NT; ++k) {
    const int i = tid + k * IMB_NT;
    S.fc[i >> 6][i & 63] = cv[k];
  }
  if (tid < 16) {
    S.top[tid] = has_top ? t.y[(my * 16 - 1) * W + mx * 16 + tid] : 0;
    S.left[tid] = has_left ? l.y[(my * 16 + tid) * W + mx * 16 - 1] : 0;
  } else if (tid < 32) {
    int k = tid - 16, ch = k >> 3, i = k & 7;
    S.ctop[ch][i] = has_top ? (ch ? t.v : t.u)[(my * 8 - 1) * Wc + mx * 8 + i] : 0;
    S.cleft[ch][i] = has_left ? (ch ? l.v : l.u)[(my * 8 + i) * Wc + mx * 8 - 1] : 0;
  } else if (tid < 34) {
    int ch = tid - 32;
    S.ctl[ch] = (has_top && has_left)
        ? (ch ? tl.v : tl.u)[(my * 8 - 1) * Wc + mx * 8 - 1] : 0;
  } else if (tid == 34) {
    S.topleft = (has_top && has_left) ? tl.y[(my * 16 - 1) * W + mx * 16 - 1] : 0;
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
  // 4 samples (a block row) a thread and store
  for (int i = tid; i < 256; i += IMB_NT) {
    const int m = i >> 6, k = (i & 63) * 4, yy = k >> 4, xx = k & 15;
    int4 p;
    if (m == 0) {
      p = make_int4(S.top[xx], S.top[xx + 1], S.top[xx + 2], S.top[xx + 3]);
    } else if (m == 1) {
      p = make_int4(S.left[yy], S.left[yy], S.left[yy], S.left[yy]);
    } else if (m == 2) {
      p = make_int4(S.dc16, S.dc16, S.dc16, S.dc16);
    } else {
      const int b = S.pa + S.pb * (xx - 7) + S.pc * (yy - 7) + 16;
      p = make_int4(clip255(b >> 5), clip255((b + S.pb) >> 5),
                    clip255((b + 2 * S.pb) >> 5), clip255((b + 3 * S.pb) >> 5));
    }
    *reinterpret_cast<int4*>(&S.pred16[m][k]) = p;
  }
  for (int i = tid; i < 128; i += IMB_NT) {
    const int ch = i >> 6, m = (i >> 4) & 3, k = (i & 15) * 4;
    const int yy = k >> 3, xx = k & 7;
    int4 p;
    if (m == 0) {
      const int d = S.dcq[ch][(yy >> 2) * 2 + (xx >> 2)];
      p = make_int4(d, d, d, d);
    } else if (m == 1) {
      const int d = S.cleft[ch][yy];
      p = make_int4(d, d, d, d);
    } else if (m == 2) {
      p = make_int4(S.ctop[ch][xx], S.ctop[ch][xx + 1], S.ctop[ch][xx + 2],
                    S.ctop[ch][xx + 3]);
    } else {
      const int b = S.cpa[ch] + S.cpb[ch] * (xx - 3) + S.cpc[ch] * (yy - 3) + 16;
      p = make_int4(clip255(b >> 5), clip255((b + S.cpb[ch]) >> 5),
                    clip255((b + 2 * S.cpb[ch]) >> 5),
                    clip255((b + 3 * S.cpb[ch]) >> 5));
    }
    *reinterpret_cast<int4*>(&S.pred8[ch][m][k]) = p;
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
      rows_diff(dd + 4 * r, S.fenc + (4 * by + r) * 16 + 4 * bx,
                S.pred16[m] + (4 * by + r) * 16 + 4 * bx);
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

// The threads that run the residual and chroma functions below: the
// whole CTA (K1, and the default), or one warp of it (K7 runs the luma
// residual on warp 0 while warp 1 runs the chroma decision and residual,
// which share no state with it)
struct ImbCta {
  static constexpr int N = IMB_NT;
  __device__ static int rank() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static int any(int p) { return __syncthreads_or(p); }
};
struct ImbWarp {
  static constexpr int N = 32;
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static void sync() { __syncwarp(); }
  __device__ static int any(int p) { return __any_sync(0xffffffffu, p); }
};

// I16x16 residual of mode16: AC levels lv16 (raster blocks, raster
// coefficients), DC levels dcl16, cbp16, reconstruction rec16. decimate:
// a total AC score (zig-zag positions 1..15) < 6 zeroes every AC level.
// lossless: the bypass (levels = samples, dcl16 = sample 0 of each block)
template <class G = ImbCta>
__device__ __forceinline__ void imb_i16_residual(IntraMB& S, bool decimate,
                                                 bool lossless = false) {
  const int tid = G::rank();
  if (lossless) {
    if (tid < 16) {
      const int by = tid >> 2, bx = tid & 3;
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          const int o = (4 * by + r) * 16 + 4 * bx + c;
          S.lv16[tid][4 * r + c] = S.fenc[o] - S.pred16[S.mode16][o];
          S.rec16[o] = S.fenc[o];
        }
      S.dcl16[tid] = S.lv16[tid][0];
      S.lv16[tid][0] = 0;
    }
    G::sync();
    if (tid == 0) {
      int nz = 0;
      for (int b = 0; b < 16; ++b)
        for (int i = 0; i < 16; ++i) nz |= S.lv16[b][i] != 0;
      S.cbp16 = nz;
    }
    G::sync();
    return;
  }
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      rows_diff(dd + 4 * r, S.fenc + (4 * by + r) * 16 + 4 * bx,
                S.pred16[S.mode16] + (4 * by + r) * 16 + 4 * bx);
    dct4x4(dd, co);
    S.dcr16[tid] = co[0];
    co[0] = 0;
    for (int i = 0; i < 16; ++i) S.lv16[tid][i] = quant(co[i], S.q.y_mf[i], S.q.y_bias[i]);
  }
  G::sync();
  if (decimate) {
    if (tid < 16) {
      int zz[15];
      for (int j = 1; j < 16; ++j) zz[j - 1] = S.lv16[tid][kZig4[j]];
      S.part[tid] = decimate_score(zz, 15);
    }
    G::sync();
    if (tid == 0) {
      int s = 0;
      for (int b = 0; b < 16; ++b) s += S.part[b];
      S.flag = s < 6;
    }
    G::sync();
    if (S.flag)
      for (int i = tid; i < 256; i += G::N) S.lv16[i >> 4][i & 15] = 0;
    G::sync();
  }
  int mine = 0;
  for (int i = tid; i < 256; i += G::N) mine |= S.lv16[i >> 4][i & 15] != 0;
  const int nz = G::any(mine);
  if (tid == 0) {
    int h[16], lv[16], inv[16];
    had4x4(S.dcr16, h);
    for (int i = 0; i < 16; ++i) lv[i] = quant((h[i] + 1) >> 1, S.q.y_mf_dc, S.q.y_bias_dc);
    had4x4(lv, inv);
    for (int i = 0; i < 16; ++i) {
      S.dcl16[i] = lv[i];
      S.dcr16[i] = dequant_4x4_dc(inv[i], S.q.y_dmf0, S.q.y_qpdiv6);
    }
    S.cbp16 = nz;
  }
  G::sync();
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
      row_recon(S.rec16 + (4 * by + r) * 16 + 4 * bx,
                S.pred16[S.mode16] + (4 * by + r) * 16 + 4 * bx, res + 4 * r);
  }
  G::sync();
}

// chroma mode: argmin of satd_u + satd_v over the available modes, or
// fixed_cmode >= 0
template <class G = ImbCta>
__device__ __forceinline__ void imb_chroma_decide(IntraMB& S, bool has_top,
                                                  bool has_left,
                                                  int fixed_cmode) {
  const int tid = G::rank();
  if (fixed_cmode >= 0) {
    if (tid == 0) S.cmode = fixed_cmode;
    G::sync();
    return;
  }
  if (tid < 32) {
    int ch = tid >> 4, m = (tid >> 2) & 3, blk = tid & 3, by = blk >> 1, bx = blk & 1;
    int dd[16];
    for (int r = 0; r < 4; ++r)
      rows_diff(dd + 4 * r, S.fc[ch] + (4 * by + r) * 8 + 4 * bx,
                S.pred8[ch][m] + (4 * by + r) * 8 + 4 * bx);
    S.part[32 + tid] = abs_had4x4(dd);
  }
  G::sync();
  if (tid == 0) {
    int best = 0, bc = 0;
    for (int m = 0; m < 4; ++m) {
      int s = 0;
      for (int ch = 0; ch < 2; ++ch)
        for (int by = 0; by < 2; ++by)
          s += (S.part[32 + ch * 16 + m * 4 + 2 * by] + S.part[32 + ch * 16 + m * 4 + 2 * by + 1]) >> 1;
      bool avail = m == 0 ? true : m == 1 ? has_left : m == 2 ? has_top
                 : (has_top && has_left);
      int c = avail ? s : IMB_BIG;
      if (m == 0 || c < bc) { bc = c; best = m; }
    }
    S.cmode = best;
  }
  G::sync();
}

// chroma residual of cmode with the intra ("c") tables: AC levels clv
// (raster coefficients), DC levels cdcl, reconstruction crec; lossless:
// the bypass (levels = samples, cdcl = sample 0 of each block)
template <class G = ImbCta>
__device__ __forceinline__ void imb_chroma_residual(IntraMB& S,
                                                   bool lossless = false) {
  const int tid = G::rank();
  if (lossless) {
    if (tid < 8) {
      const int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1;
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          const int o = (4 * by + r) * 8 + 4 * bx + c;
          S.clv[ch][blk][4 * r + c] = S.fc[ch][o] - S.pred8[ch][S.cmode][o];
          S.crec[ch][o] = S.fc[ch][o];
        }
      S.cdcl[ch][blk] = S.clv[ch][blk][0];
      S.clv[ch][blk][0] = 0;
    }
    G::sync();
    return;
  }
  if (tid < 8) {
    int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1, dd[16], co[16];
    for (int r = 0; r < 4; ++r)
      rows_diff(dd + 4 * r, S.fc[ch] + (4 * by + r) * 8 + 4 * bx,
                S.pred8[ch][S.cmode] + (4 * by + r) * 8 + 4 * bx);
    dct4x4(dd, co);
    S.cdc[ch][blk] = co[0];
    co[0] = 0;
    for (int i = 0; i < 16; ++i) S.clv[ch][blk][i] = quant(co[i], S.q.c_mf[i], S.q.c_bias[i]);
  }
  G::sync();
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
  G::sync();
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
      row_recon(S.crec[ch] + (4 * by + r) * 8 + 4 * bx,
                S.pred8[ch][S.cmode] + (4 * by + r) * 8 + 4 * bx, res + 4 * r);
  }
  G::sync();
}

}  // namespace x264t

// K1 intra_diag: the all-intra encode of one wavefront diagonal of
// macroblocks.
//
// Replaces x264_tpu/encoder/intra.py:encode_i16_frame (diag_step with
// luma_i16_path, luma_i4_path, luma_i8_path and chroma_residual; i4x4
// and i8x8 on or off, and the lossless transform bypass of intra.py:97,
// :172 and :603), and parallel/mesh.py's vmap of it over a frame axis. Plain twin:
// x264_tpu_torch/encoder/intra.py encode_i16_frame_plain; wrapper:
// encode_i16_frame.
//
// Design. The I16x16 and chroma paths are the shared device code of
// intra_mb.cuh (K7 runs the same code); the I4x4 ladder is K1's own.
// The host launches this kernel once per anti-diagonal
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
// With I8x8 on, the host walks the slope-2 diagonals d = x + 2y instead
// (254 launches at 1080p, at most 61 CTAs each): the I8x8 edge filter of
// block 1 reads the bottom row of the top-right MB, which this order has
// coded. After I4x4 the CTA runs the I8x8 ladder of four 8x8 blocks in z
// order (t8.cuh): 25 threads filter the block's edges (spec 8.3.2.2.1),
// 9 threads predict and score the nine modes (SA8D + lam * mode bits),
// one thread runs the 8x8 DCT, quant, dequant, IDCT and reconstruction.
//
// What bounds it on the H100: neither bytes (~40 MB a 1080p frame, some
// 12 us at 3.35 TB/s) nor integer throughput, but the serial depth: 187
// dependent launches (254 with I8x8), each running a 16-step I4x4 chain
// (and a 4-step I8x8 one) on at most 68 (61) CTAs, leave most of the 132
// SMs idle. A persistent kernel over the
// whole frame, and warp-parallel I4x4 transforms, are the later work.
//
// Traps kept bit-exact with the JAX function: mode bits [1,3,3,5];
// unavailable modes cost 1<<28 and argmin takes the first index on ties;
// I4 top-right substitution on z 3, 7, 11, 13, 15 and no DDL/VL on z 5;
// the MPM bit cost and the + lam*24 I4 signalling cost; I4 replaces I16
// only when strictly cheaper; chroma mode by argmin(satd_u + satd_v);
// DC tables mf[0] >> 1 and bias[0] << 1 (packed by the wrapper). I8x8:
// one availability set per block (block 1's top-right only where the
// top-right MB exists, block 3's always replaced by t7; DDR / VR / HD
// also need the top-left), the linear edge layout of the gather tables
// (T(-1) and L(-1) both the filtered top-left), the + lam * 10
// signalling cost, and I8x8 replacing the best of I16 and I4 only when
// strictly cheaper; an I8x8 MB stays I_NxN (i4_mb) with its four modes
// copied into the 4x4 mode grid.
// Lossless (CQP 0): the I16x16 and chroma residuals take intra_mb.cuh's
// bypass, and the I4x4 ladder's chosen block keeps its residual samples
// as its levels and the source as its recon (intra.py:603-606); the mode
// decisions keep their SATD costs.
// Variance AQ: given a QP map, the qtab argument is the 52-QP stack
// (encoder/aq.py:qtab_stacks) and each CTA loads the row of its MB's QP
// (x264_tpu's per-MB qtab_rows gather); lambda stays the frame's.
// Without I4x4 (i4x4 = 0, --partitions none, x264_tpu intra.py:366-376)
// the CTA skips the I4x4 ladder: no MB takes I4x4, and I8x8 (where on)
// replaces I16x16 only when strictly cheaper than it alone (:383); the
// neighbours' 4x4 modes are still read for I8x8's MPM.
// The frame axis: nf frames of one size, one QP table and one lambda run
// in one launch a diagonal, blockIdx.y the frame (x264_tpu's
// parallel/mesh.py vmap of encode_i16_frame); every plane and output is
// nf stacked frames. At 1080p a diagonal holds at most 68 MBs, so the
// frames are what fills the 132 SMs.
#include "intra_mb.cuh"
#include "t8.cuh"

using namespace x264t;

namespace {

constexpr int NT = IMB_NT;
constexpr int P4_N = 9 * 16 * 3;
constexpr int P8_N = 9 * 64 * 3;

__device__ __forceinline__ bool tr_subst(int z) {
  return z == 3 || z == 7 || z == 11 || z == 13 || z == 15 || z == 5;
}

__global__ void __launch_bounds__(NT) intra_diag_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, const int* __restrict__ qtab_g,
    const int* __restrict__ p4_g, const int* __restrict__ p8_g, int* RY,
    int* RU, int* RV, int* __restrict__ mode16_o, int* __restrict__ modec_o,
    int* __restrict__ luma_dc_o, int* __restrict__ luma_ac_o,
    int* __restrict__ chroma_dc_o, int* __restrict__ chroma_ac_o,
    uint8_t* __restrict__ i4_mb_o, int* i4_modes_o, int* __restrict__ cbp_o,
    uint8_t* __restrict__ t8_mb_o, int* __restrict__ luma8_o,
    const int* __restrict__ qp_map, int mb_h, int mb_w, int d, int y0,
    int lam, int i8x8, int lossless, int i4x4) {
  // the MB of this CTA: x + y = d, or x + 2y = d with I8x8
  const int my = y0 + blockIdx.x;
  const int mx = d - (i8x8 ? 2 : 1) * my;
  const int W = mb_w * 16, Wc = mb_w * 8;
  const int mb = my * mb_w + mx;
  // this CTA's frame of the stack: every plane and output moves to it
  {
    const size_t nmb = (size_t)mb_h * mb_w, f = blockIdx.y;
    Y += f * nmb * 256; U += f * nmb * 64; V += f * nmb * 64;
    RY += f * nmb * 256; RU += f * nmb * 64; RV += f * nmb * 64;
    mode16_o += f * nmb; modec_o += f * nmb; cbp_o += f * nmb;
    i4_mb_o += f * nmb; luma_dc_o += f * nmb * 16; i4_modes_o += f * nmb * 16;
    luma_ac_o += f * nmb * 256; chroma_dc_o += f * nmb * 8;
    chroma_ac_o += f * nmb * 128;
    if (t8_mb_o) { t8_mb_o += f * nmb; luma8_o += f * nmb * 256; }
    if (qp_map) qp_map += f * nmb;
  }
  const int tid = threadIdx.x;
  const bool has_top = my > 0, has_left = mx > 0;

  __shared__ IntraMB S;
  __shared__ short p4idx[P4_N], p4wgt[P4_N];
  __shared__ int ext[17][21];
  __shared__ int nmt[4], nml[4], modes_r[16], blk4[16][16], nnz4[16];
  __shared__ int cost4c[9], pred4c[9][16];
  __shared__ int total4, cbp4;
  __shared__ short p8idx[P8_N], p8wgt[P8_N];
  __shared__ int ext8[17][25], e8[25], cost8c[9], pred8c[9][64];
  __shared__ int modes8[4], blk8[4][64], total8, cbp8;

  // ------------------------------------------------------------ load
  // with a QP map (variance AQ) qtab_g is the 52-QP stack and the MB
  // reads the row of its QP
  imb_load(S, qtab_g + (qp_map ? qp_map[mb] * QTAB_INTS : 0), Y, U, V, RY,
           RU, RV, mb_w, mx, my, has_top, has_left);
  for (int i = tid; i < P4_N; i += NT) {
    p4idx[i] = (short)p4_g[i];
    p4wgt[i] = (short)p4_g[P4_N + i];
  }
  if (i8x8)
    for (int i = tid; i < P8_N; i += NT) {
      p8idx[i] = (short)p8_g[i];
      p8wgt[i] = (short)p8_g[P8_N + i];
    }
  if (tid >= 40 && tid < 44) {
    int k = tid - 40;
    nmt[k] = has_top ? i4_modes_o[((my - 1) * mb_w + mx) * 16 + 12 + k] : 2;
    nml[k] = has_left ? i4_modes_o[(my * mb_w + mx - 1) * 16 + 4 * k + 3] : 2;
  }
  __syncthreads();

  // ------------------------------------------------ I16x16
  imb_predict(S, has_top, has_left);
  imb_i16_decide(S, has_top, has_left, lam, -1);
  imb_i16_residual(S, false, lossless);

  // ------------------------------------------------ I4x4 ladder
  if (i4x4) {
  for (int i = tid; i < 17 * 21; i += NT) {
    int r = i / 21, c = i % 21, v = 0;
    if (r == 0 && c == 0) v = S.topleft;
    else if (r == 0) v = S.top[min(c - 1, 15)];
    else if (c == 0) v = S.left[r - 1];
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
          dd[4 * r + c] = S.fenc[(4 * by + r) * 16 + 4 * bx + c] - p[4 * r + c];
      const int lmode = bx > 0 ? modes_r[4 * by + bx - 1] : nml[by];
      const int tmode = by > 0 ? modes_r[4 * (by - 1) + bx] : nmt[bx];
      const int mpm = min(lmode, tmode);
      cost4c[m] = avail ? (abs_had4x4(dd) >> 1) + lam * (m == mpm ? 1 : 4) : IMB_BIG;
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
          dd[4 * r + c] = S.fenc[(4 * by + r) * 16 + 4 * bx + c] - pred4c[best][4 * r + c];
      if (lossless) {                  // the bypass: the samples are the levels
        for (int i = 0; i < 16; ++i) {
          lv[i] = res[i] = dd[i];
          nz += lv[i] != 0;
        }
      } else {
        dct4x4(dd, co);
        for (int i = 0; i < 16; ++i) {
          lv[i] = quant(co[i], S.q.y_mf[i], S.q.y_bias[i]);
          nz += lv[i] != 0;
          dq[i] = dequant(lv[i], S.q.y_dmf[i], S.q.y_qpdiv6);
        }
        idct4x4(dq, res);
      }
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
  __syncthreads();
  }  // i4x4

  // ------------------------------------------------ I8x8 ladder
  if (i8x8) {
    // the top-right MB's bottom row (block 1's top-right samples)
    const bool has_tr = has_top && mx < mb_w - 1;
    for (int i = tid; i < 17 * 25; i += NT) {
      int r = i / 25, c = i % 25, v = 0;
      if (r == 0 && c == 0) v = S.topleft;
      else if (r == 0 && c <= 16) v = S.top[c - 1];
      else if (r == 0) v = has_tr ? RY[(my * 16 - 1) * W + mx * 16 + c - 1] : 0;
      else if (c == 0) v = S.left[r - 1];
      ext8[r][c] = v;
    }
    if (tid == 0) total8 = 0;
    __syncthreads();
    for (int z = 0; z < 4; ++z) {
      const int by = z >> 1, bx = z & 1, r0 = 8 * by, c0 = 8 * bx;
      // availability (ht, hl, htl, htr) of this block's edges
      const bool ht = by ? true : has_top, hl = bx ? true : has_left;
      const bool htl = z == 0 ? (has_top && has_left) : z == 1 ? has_top
                     : z == 2 ? has_left : true;
      const bool htr = z == 0 ? has_top : z == 1 ? has_tr : z == 2;
      // the filtered edge vector e8 = [l7'..l0', lt', t0'..t15']
      if (tid < 25) {
        const int tl = ext8[r0][c0];
        auto lft = [&](int i) { return ext8[r0 + 1 + i][c0]; };
        auto t16 = [&](int j) {
          return (j < 8 || htr) ? ext8[r0][c0 + 1 + j] : ext8[r0][c0 + 8];
        };
        int v;
        if (tid < 8) {
          const int i = 7 - tid;
          const int prv = i == 0 ? (htl ? tl : lft(0)) : lft(i - 1);
          const int nxt = i == 7 ? lft(7) : lft(i + 1);
          v = (prv + 2 * lft(i) + nxt + 2) >> 2;
        } else if (tid == 8) {
          v = (ht && hl) ? (t16(0) + 2 * tl + lft(0) + 2) >> 2
            : ht ? (3 * tl + t16(0) + 2) >> 2 : (3 * tl + lft(0) + 2) >> 2;
        } else {
          const int j = tid - 9;
          const int prv = j == 0 ? (htl ? tl : t16(0)) : t16(j - 1);
          const int nxt = j == 15 ? t16(15) : t16(j + 1);
          v = (prv + 2 * t16(j) + nxt + 2) >> 2;
        }
        e8[tid] = v;
      }
      __syncthreads();
      if (tid < 9) {
        const int m = tid;
        const bool diag = ht && hl && htl;
        const bool avail = m == 0 ? ht : m == 1 ? hl : m == 2 ? true
                         : m == 3 ? ht : m == 7 ? ht : m == 8 ? hl : diag;
        int dd[64];
        int dc = 0;
        if (m == 2) {
          int st = 0, sl = 0;
          for (int i = 0; i < 8; ++i) { st += e8[9 + i]; sl += e8[i]; }
          dc = (ht && hl) ? (st + sl + 8) >> 4 : hl ? (sl + 4) >> 3
             : ht ? (st + 4) >> 3 : 128;
        }
        for (int i = 0; i < 64; ++i) {
          int p = dc;
          if (m != 2) {
            const int o = (m * 64 + i) * 3;
            p = (e8[p8idx[o]] * p8wgt[o] + e8[p8idx[o + 1]] * p8wgt[o + 1]
                 + e8[p8idx[o + 2]] * p8wgt[o + 2] + 2) >> 2;
          }
          pred8c[m][i] = p;
          dd[i] = S.fenc[(r0 + (i >> 3)) * 16 + c0 + (i & 7)] - p;
        }
        const int lmode = bx ? modes8[2 * by] : nml[2 * by];
        const int tmode = by ? modes8[bx] : nmt[2 * bx];
        const int mpm = min(lmode, tmode);
        cost8c[m] = avail ? ((abs_had8x8(dd) + 2) >> 2) + lam * (m == mpm ? 1 : 4)
                          : IMB_BIG;
      }
      __syncthreads();
      if (tid == 0) {
        int best = 0;
        for (int m = 1; m < 9; ++m)
          if (cost8c[m] < cost8c[best]) best = m;
        total8 += cost8c[best];
        int dd[64], co[64], dq[64], res[64];
        for (int i = 0; i < 64; ++i)
          dd[i] = S.fenc[(r0 + (i >> 3)) * 16 + c0 + (i & 7)] - pred8c[best][i];
        dct8x8(dd, co);
        for (int i = 0; i < 64; ++i) {
          co[i] = quant(co[i], S.q.y8_mf[i], S.q.y8_bias[i]);
          dq[i] = dequant8(co[i], S.q.y8_dmf[i], S.q.y_qpdiv6);
        }
        idct8x8(dq, res);
        for (int i = 0; i < 64; ++i)
          ext8[r0 + 1 + (i >> 3)][c0 + 1 + (i & 7)] = clip255(pred8c[best][i] + res[i]);
        modes8[z] = best;
        for (int j = 0; j < 64; ++j) blk8[z][j] = co[kZig8[j]];
      }
      __syncthreads();
    }
    if (tid == 0) {
      int bits = 0;
      for (int z = 0; z < 4; ++z) {
        int nz = 0;
        for (int j = 0; j < 64; ++j) nz |= blk8[z][j] != 0;
        bits |= nz << z;
      }
      cbp8 = bits;
      total8 += lam * 10;
    }
    __syncthreads();
  }

  // ------------------------------------------------ chroma decision
  imb_chroma_decide(S, has_top, has_left, -1);
  // I4x4 replaces I16x16, and I8x8 the best of them, only when strictly
  // cheaper; without I4x4 I8x8 is held against I16x16 alone
  const bool use_i4 = i4x4 && total4 < S.cost16;
  const bool use_i8 = i8x8 && total8 < (i4x4 ? min(S.cost16, total4) : S.cost16);

  // ------------------------------------------------ luma outputs
  for (int i = tid; i < 256; i += NT) {
    int r = i >> 4, c = i & 15;
    RY[(my * 16 + r) * W + mx * 16 + c] = use_i8 ? ext8[1 + r][1 + c]
        : use_i4 ? ext[1 + r][1 + c] : S.rec16[i];
    int z = i >> 4, j = i & 15;
    luma_ac_o[mb * 256 + i] = use_i8 ? 0 : use_i4 ? blk4[z][j]
        : S.lv16[4 * kBlkY[z] + kBlkX[z]][kZig4[j]];
    if (i8x8) luma8_o[mb * 256 + i] = use_i8 ? blk8[i >> 6][i & 63] : 0;
  }
  if (tid < 16) {
    luma_dc_o[mb * 16 + tid] = (use_i4 || use_i8) ? 0 : S.dcl16[kZig4[tid]];
    i4_modes_o[mb * 16 + tid] = use_i8 ? modes8[2 * (tid >> 3) + ((tid & 3) >> 1)]
        : use_i4 ? modes_r[tid] : 2;
  } else if (tid == 16) {
    cbp_o[mb] = use_i8 ? cbp8 : use_i4 ? cbp4 : (S.cbp16 ? 15 : 0);
    i4_mb_o[mb] = (use_i4 || use_i8) ? 1 : 0;
    if (i8x8) t8_mb_o[mb] = use_i8 ? 1 : 0;
    mode16_o[mb] = S.mode16;
    modec_o[mb] = S.cmode;
  }

  // ------------------------------------------------ chroma residual
  imb_chroma_residual(S, lossless);
  if (tid < 8) {
    int ch = tid >> 2, blk = tid & 3, by = blk >> 1, bx = blk & 1;
    int* R = ch ? RV : RU;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c)
        R[(my * 8 + 4 * by + r) * Wc + mx * 8 + 4 * bx + c] =
            S.crec[ch][(4 * by + r) * 8 + 4 * bx + c];
    chroma_dc_o[mb * 8 + ch * 4 + blk] = S.cdcl[ch][blk];
    for (int j = 0; j < 16; ++j)
      chroma_ac_o[mb * 128 + ch * 64 + blk * 16 + j] = S.clv[ch][blk][kZig4[j]];
  }
}

}  // namespace

extern "C" int intra_diag(const int* y, const int* u, const int* v,
                          const int* qtab, const int* p4tab, const int* p8tab,
                          int* recon_y, int* recon_u, int* recon_v,
                          int* mode16, int* modec, int* luma_dc, int* luma_ac,
                          int* chroma_dc, int* chroma_ac, uint8_t* i4_mb,
                          int* i4_modes, int* cbp_luma_bits, uint8_t* t8_mb,
                          int* luma8, const int* qp_map, int mb_h, int mb_w,
                          int d, int lam, int i8x8, int lossless, int i4x4,
                          int nf, void* stream) {
  // the MBs of diagonal d: x = d - y, or x = d - 2y with I8x8, in [0, mb_w);
  // one row of CTAs a frame of the nf stacked frames
  const int y0 = i8x8 ? max(0, (d - (mb_w - 1) + 1) / 2) : max(0, d - (mb_w - 1));
  const int y1 = min(mb_h - 1, i8x8 ? d / 2 : d);
  if (y1 < y0 || nf < 1) return 0;
  intra_diag_kernel<<<dim3(y1 - y0 + 1, nf), NT, 0, (cudaStream_t)stream>>>(
      y, u, v, qtab, p4tab, p8tab, recon_y, recon_u, recon_v, mode16, modec,
      luma_dc, luma_ac, chroma_dc, chroma_ac, i4_mb, i4_modes, cbp_luma_bits,
      t8_mb, luma8, qp_map, mb_h, mb_w, d, y0, lam, i8x8, lossless, i4x4);
  return (int)cudaGetLastError();
}

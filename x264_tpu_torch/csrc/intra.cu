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
// intra_mb.cuh (K7 runs the same code); the I4x4 and I8x8 ladders are
// K1's own. The host launches this kernel once per anti-diagonal
// d = x + y (187 launches at 1080p), one CTA of 64 threads per MB on the
// diagonal; the MBs of one diagonal are independent, and every launch
// reads the top / left / top-left reconstruction that earlier launches
// wrote into the recon planes. Inside the CTA the MB's source pixels,
// the four I16x16 predictions, the 17x21 I4x4 neighbour buffer `ext`
// and the chroma predictions live in shared memory. The I4x4 chain of 16
// blocks is sequential by nature (each block predicts from the recon of
// the blocks before it), so each block spreads over the CTA in three
// steps between barriers: 36 threads (mode, row) build the nine modes'
// predictions (each thread's gather taps held in registers for the whole
// chain) and the row pass of their residuals' Hadamard; 36 threads
// (mode, column) the column pass, a mode's |sums| added over its four
// lanes by shuffles, and the costs; then warp 0, one coefficient a lane,
// takes the cheapest mode through dct4x4, quant, dequant and idct4x4 by
// shuffles, reconstructs, zig-zags, votes the block's nonzero flag, and
// gathers the next block's edge vector, DC (warp reductions), most
// probable mode and mode availability.
// With I8x8 on, the host walks the slope-2 diagonals d = x + 2y instead
// (254 launches at 1080p, at most 61 CTAs each): the I8x8 edge filter of
// block 1 reads the bottom row of the top-right MB, which this order has
// coded. After I4x4 the CTA runs the I8x8 ladder of four 8x8 blocks in z
// order (t8.cuh), each over the CTA too: 25 lanes of warp 0 filter the
// block's edges (spec 8.3.2.2.1) and the warp reduces the DC sums; 72
// (mode, row) lines build the predictions (taps in registers) and the
// Hadamard's row pass, 72 (mode, column) lines its column pass (SA8D +
// lam * mode bits, a mode's |sums| added over eight lanes); the chosen
// block's dct8x8 runs as 8 column then 8 row butterflies, its row's
// thread quantises, dequantises and runs idct8x8's row butterfly, 8
// column butterflies follow, and the reconstruction, the zig-zag and
// the nonzero flag (a __syncthreads_or) take a sample a thread.
//
// What bounds it on the H100: neither bytes (~40 MB a 1080p frame, some
// 12 us at 3.35 TB/s) nor integer throughput, but latency: a frame is 187
// dependent launches (254 with I8x8) on at most 68 (61) CTAs, and each
// MB's time is a chain of dependent shared-memory, shuffle and barrier
// steps, most of them the 16 blocks of the I4x4 chain (three steps a
// block) and the four of the I8x8 ladder. A persistent kernel on K2's row
// wavefront would keep the depth and save only the launch gaps; what
// remains is to shorten each MB's chain.
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

// output k of the 1-D pass of dct4x4, and of idct4x4 before its rounding,
// on x[0..3] (common.cuh)
__device__ __forceinline__ int dct4_at(const int* x, int k) {
  return k == 0 ? x[0] + x[1] + x[2] + x[3]
       : k == 1 ? 2 * x[0] + x[1] - x[2] - 2 * x[3]
       : k == 2 ? x[0] - x[1] - x[2] + x[3]
                : x[0] - 2 * x[1] + 2 * x[2] - x[3];
}

__device__ __forceinline__ int idct4_at(const int* x, int k) {
  const int e0 = x[0] + x[2], e1 = x[0] - x[2];
  const int e2 = (x[1] >> 1) - x[3], e3 = x[1] + (x[3] >> 1);
  return k == 0 ? e0 + e3 : k == 1 ? e1 + e2 : k == 2 ? e1 - e2 : e0 - e3;
}

// the 4-point Hadamard of had4x4 on x[0..3], in place
__device__ __forceinline__ void had4_1d(int* x) {
  const int s01 = x[0] + x[1], d01 = x[0] - x[1];
  const int s23 = x[2] + x[3], d23 = x[2] - x[3];
  x[0] = s01 + s23; x[1] = s01 - s23; x[2] = d01 - d23; x[3] = d01 + d23;
}

// x[i] = v of warp lane (lane & 16) + base + step * i: one 4-point line
// of the 4x4 block that lanes 0-15 (and again 16-31) hold a coefficient
// each
__device__ __forceinline__ void lanes4(int v, int base, int step, int* x) {
  const int half = threadIdx.x & 16;
  for (int i = 0; i < 4; ++i)
    x[i] = __shfl_sync(0xffffffffu, v, half + base + step * i);
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
  __shared__ int ext[17][21];
  __shared__ int nmt[4], nml[4], modes_r[16], blk4[16][16];
  __shared__ int pred4c[9][16], e4[13], dc4, mpm4, avail4, cost4_hu;
  __shared__ int had4[9][16];
  __shared__ int total4, cbp4;
  __shared__ int ext8[17][25], e8[25], cost8c[9], pred8c[9][64];
  __shared__ int had8[9][64], d8[64], tb8[64], lv8[64], dc8, mpm8, avail8;
  __shared__ int modes8[4], blk8[4][64], total8, cbp8;

  // the predictors' gather taps, the same for every block, in registers:
  // a (mode, row) line's 12 I4x4 taps (threads 0-35), and its 24 I8x8
  // taps as index | weight << 16 (line tid, and line 64 + tid for
  // threads 0-7)
  int tap[12], wt[12], tw0[24], tw1[24];
  if (i4x4 && tid < 36)
    for (int k = 0; k < 12; ++k) {
      tap[k] = __ldg(p4_g + tid * 12 + k);
      wt[k] = __ldg(p4_g + P4_N + tid * 12 + k);
    }
  if (i8x8)
    for (int k = 0; k < 24; ++k) {
      tw0[k] = __ldg(p8_g + tid * 24 + k) | __ldg(p8_g + P8_N + tid * 24 + k) << 16;
      tw1[k] = tid < 8 ? __ldg(p8_g + (NT + tid) * 24 + k)
                             | __ldg(p8_g + P8_N + (NT + tid) * 24 + k) << 16
                       : 0;
    }

  // ------------------------------------------------------------ load
  // with a QP map (variance AQ) qtab_g is the 52-QP stack and the MB
  // reads the row of its QP
  const ImbNbr rec{RY, RU, RV};
  imb_load(S, qtab_g + (qp_map ? qp_map[mb] * QTAB_INTS : 0), Y, U, V, rec,
           rec, rec, mb_w, mx, my, has_top, has_left);
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
  // warp 0: a block's edge vector [l3 l2 l1 l0 lt t0..t3 t4..t7] (lanes
  // 0-12) from the recon of the blocks before it, its DC prediction (the
  // sums by warp reductions), most probable mode and mode availability
  auto gather_edges = [&](int z) {
    const int bx = kBlkX[z], by = kBlkY[z];
    const bool ht = by == 0 ? has_top : true, hl = bx == 0 ? has_left : true;
    int v = 0;
    if (tid < 4) v = ext[4 + 4 * by - tid][4 * bx];
    else if (tid == 4) v = ext[4 * by][4 * bx];
    else if (tid < 9) v = ext[4 * by][4 * bx + tid - 4];
    else if (tid < 13) v = ext[4 * by][tr_subst(z) ? 4 + 4 * bx : 4 * bx + tid - 4];
    if (tid < 13) e4[tid] = v;
    const int sl = __reduce_add_sync(0xffffffffu, tid < 4 ? v : 0);
    const int st = __reduce_add_sync(0xffffffffu, tid >= 5 && tid < 9 ? v : 0);
    if (tid == 0) {
      dc4 = (ht && hl) ? (st + sl + 4) >> 3 : hl ? (sl + 2) >> 2
          : ht ? (st + 2) >> 2 : 128;
    } else if (tid == 1) {
      const int lmode = bx > 0 ? modes_r[4 * by + bx - 1] : nml[by];
      const int tmode = by > 0 ? modes_r[4 * (by - 1) + bx] : nmt[bx];
      mpm4 = min(lmode, tmode);
      // modes V, H, DC, DDL, DDR, VR, HD, VL, HU; no DDL / VL on z 5
      const int dl = ht && z != 5;
      avail4 = ht | hl << 1 | 1 << 2 | dl << 3 | (ht && hl) * (7 << 4) | dl << 7
             | hl << 8;
    }
  };
  int sum4 = 0, cbp_bits = 0;   // warp 0: the chain's cost and cbp bits
  __syncthreads();
  if (tid < 32) gather_edges(0);
  // the lane whose level is this lane's zig-zag position
  const int zig_lane = (tid & 16) + kZig4[tid & 15];
  __syncthreads();
  for (int z = 0; z < 16; ++z) {
    const int bx = kBlkX[z], by = kBlkY[z];
    // the nine predictions and the Hadamard's row pass of their
    // residuals: a (mode, row) a thread
    if (tid < 36) {
      const int m = tid >> 2, r = tid & 3;
      int d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = m == 2 ? dc4
            : (e4[tap[3 * c]] * wt[3 * c] + e4[tap[3 * c + 1]] * wt[3 * c + 1]
               + e4[tap[3 * c + 2]] * wt[3 * c + 2] + 2) >> 2;
        pred4c[m][4 * r + c] = p;
        d[c] = S.fenc[(4 * by + r) * 16 + 4 * bx + c] - p;
      }
      had4_1d(d);
      for (int c = 0; c < 4; ++c) had4[m][4 * r + c] = d[c];
    }
    __syncthreads();
    // the column pass: a (mode, column) a thread, the |sums| of a mode's
    // four lanes added by shuffles; the mode's cost, and each warp's
    // cheapest mode (the lower on ties) by shuffles: warp 0 holds modes
    // 0-7, warp 1 mode 8
    int best, best_cost;
    {
      const int m = tid >> 2, c = tid & 3;
      int s = 0;
      if (tid < 36) {
        int x[4] = {had4[m][c], had4[m][4 + c], had4[m][8 + c], had4[m][12 + c]};
        had4_1d(x);
        s = abs(x[0]) + abs(x[1]) + abs(x[2]) + abs(x[3]);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      best = m;
      best_cost = tid >= 36 ? 0x7fffffff
          : avail4 >> m & 1 ? (s >> 1) + lam * (m == mpm4 ? 1 : 4) : IMB_BIG;
      for (int o = 4; o < 32; o <<= 1) {
        const int oc = __shfl_xor_sync(0xffffffffu, best_cost, o);
        const int om = __shfl_xor_sync(0xffffffffu, best, o);
        if (oc < best_cost || (oc == best_cost && om < best)) {
          best_cost = oc;
          best = om;
        }
      }
      if (tid == 32) cost4_hu = best_cost;
    }
    __syncthreads();
    // the cheapest mode: HU (8) only when strictly cheaper. Warp 0, lane
    // 4r + c holding coefficient (r, c), runs dct4x4 (columns, then rows),
    // quant, dequant and idct4x4 (rows, then columns) through shuffles, or
    // keeps the residual (lossless); then the reconstruction, the zig-zag
    // and a vote for the nonzero flag, and the next block's edges
    if (tid < 32) {
      if (cost4_hu < best_cost) {
        best = 8;
        best_cost = cost4_hu;
      }
      const int k = tid & 15, r = k >> 2, c = k & 3;
      const int pred = pred4c[best][k];
      const int dd = S.fenc[(4 * by + r) * 16 + 4 * bx + c] - pred;
      int lv = dd, res = dd, x[4];
      if (!lossless) {
        lanes4(dd, c, 4, x);
        lanes4(dct4_at(x, r), 4 * r, 1, x);
        lv = quant(dct4_at(x, c), S.q.y_mf[k], S.q.y_bias[k]);
        lanes4(dequant(lv, S.q.y_dmf[k], S.q.y_qpdiv6), 4 * r, 1, x);
        lanes4(idct4_at(x, c), c, 4, x);
        res = (idct4_at(x, r) + 32) >> 6;
      }
      const int zz = __shfl_sync(0xffffffffu, lv, zig_lane);
      const int nz = __any_sync(0xffffffffu, lv != 0);
      if (tid < 16) {
        ext[1 + 4 * by + r][1 + 4 * bx + c] = clip255(pred + res);
        blk4[z][k] = zz;
      }
      if (tid == 0) modes_r[4 * by + bx] = best;
      sum4 += best_cost;
      cbp_bits |= nz << (z >> 2);
      if (z < 15) {
        __syncwarp();
        gather_edges(z + 1);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    cbp4 = cbp_bits;
    total4 = sum4 + lam * 24;
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
    if (tid == 0) total8 = cbp8 = 0;
    __syncthreads();
    const int zig8 = kZig8[tid];
    for (int z = 0; z < 4; ++z) {
      const int by = z >> 1, bx = z & 1, r0 = 8 * by, c0 = 8 * bx;
      // availability (ht, hl, htl, htr) of this block's edges
      const bool ht = by ? true : has_top, hl = bx ? true : has_left;
      const bool htl = z == 0 ? (has_top && has_left) : z == 1 ? has_top
                     : z == 2 ? has_left : true;
      const bool htr = z == 0 ? has_top : z == 1 ? has_tr : z == 2;
      // the filtered edge vector e8 = [l7'..l0', lt', t0'..t15'] (lanes
      // 0-24 of warp 0), its DC prediction (the sums by warp reductions),
      // the most probable mode and the modes' availability
      if (tid < 32) {
        int v = 0;
        if (tid < 25) {
          const int tl = ext8[r0][c0];
          auto lft = [&](int i) { return ext8[r0 + 1 + i][c0]; };
          auto t16 = [&](int j) {
            return (j < 8 || htr) ? ext8[r0][c0 + 1 + j] : ext8[r0][c0 + 8];
          };
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
        const int sl = __reduce_add_sync(0xffffffffu, tid < 8 ? v : 0);
        const int st = __reduce_add_sync(0xffffffffu, tid >= 9 && tid < 17 ? v : 0);
        if (tid == 0) {
          dc8 = (ht && hl) ? (st + sl + 8) >> 4 : hl ? (sl + 4) >> 3
              : ht ? (st + 4) >> 3 : 128;
        } else if (tid == 1) {
          const int lmode = bx ? modes8[2 * by] : nml[2 * by];
          const int tmode = by ? modes8[bx] : nmt[2 * bx];
          mpm8 = min(lmode, tmode);
          // modes V, H, DC, DDL, DDR, VR, HD, VL, HU
          avail8 = ht | hl << 1 | 1 << 2 | ht << 3 | (ht && hl && htl) * (7 << 4)
                 | ht << 7 | hl << 8;
        }
      }
      __syncthreads();
      // the nine predictions and the Hadamard's row pass of their
      // residuals: a (mode, row) a thread, 72 over two rounds, each
      // thread's taps in registers
      auto pred_row = [&](int i, const int (&tw)[24]) {
        const int m = i >> 3, r = i & 7;
        int d[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int* t = tw + 3 * c;
          const int p = m == 2 ? dc8
              : (e8[t[0] & 0xffff] * (t[0] >> 16) + e8[t[1] & 0xffff] * (t[1] >> 16)
                 + e8[t[2] & 0xffff] * (t[2] >> 16) + 2) >> 2;
          pred8c[m][8 * r + c] = p;
          d[c] = S.fenc[(r0 + r) * 16 + c0 + c] - p;
        }
        had8_1d(d);
        for (int c = 0; c < 8; ++c) had8[m][8 * r + c] = d[c];
      };
      pred_row(tid, tw0);
      if (tid < 8) pred_row(NT + tid, tw1);
      __syncthreads();
      // the column pass: a (mode, column) a thread, the |sums| of a
      // mode's eight lanes added by shuffles; the mode's cost
      for (int i0 = 0; i0 < 72; i0 += NT) {
        const int i = i0 + tid, m = i >> 3, c = i & 7;
        int s = 0;
        if (i < 72) {
          int a[8];
          for (int j = 0; j < 8; ++j) a[j] = had8[m][8 * j + c];
          had8_1d(a);
          for (int j = 0; j < 8; ++j) s += abs(a[j]);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        if (i < 72 && c == 0)
          cost8c[m] = avail8 >> m & 1 ? ((s + 2) >> 2) + lam * (m == mpm8 ? 1 : 4)
                                      : IMB_BIG;
      }
      __syncthreads();
      // the cheapest mode (first on ties): its residual a sample a thread;
      // dct8x8 as 8 column then 8 row butterflies, the row's thread
      // quantising, dequantising and running idct8x8's row butterfly
      // (rows first), then its 8 column butterflies; the reconstruction
      // and the zig-zag a sample a thread, the nonzero flag by a vote
      int best = 0;
      for (int m = 1; m < 9; ++m)
        if (cost8c[m] < cost8c[best]) best = m;
      const int ri = tid >> 3, ci = tid & 7;
      d8[tid] = S.fenc[(r0 + ri) * 16 + c0 + ci] - pred8c[best][tid];
      __syncthreads();
      if (tid < 8) dct8_1d(d8 + tid, 8, tb8 + tid, 8);
      __syncthreads();
      if (tid < 8) {
        int co[8], dq[8];
        dct8_1d(tb8 + 8 * tid, 1, co, 1);
        for (int k = 0; k < 8; ++k) {
          const int i = 8 * tid + k;
          lv8[i] = quant(co[k], S.q.y8_mf[i], S.q.y8_bias[i]);
          dq[k] = dequant8(lv8[i], S.q.y8_dmf[i], S.q.y_qpdiv6);
        }
        if (tid == 0) dq[0] += 32;
        idct8_1d(dq, 1, tb8 + 8 * tid, 1);
      }
      __syncthreads();
      if (tid < 8) idct8_1d(tb8 + tid, 8, d8 + tid, 8);
      __syncthreads();
      ext8[r0 + 1 + ri][c0 + 1 + ci] = clip255(pred8c[best][tid] + (d8[tid] >> 6));
      blk8[z][tid] = lv8[zig8];
      const int nz = __syncthreads_or(lv8[tid] != 0);
      if (tid == 0) {
        total8 += cost8c[best];
        modes8[z] = best;
        cbp8 |= nz << z;
      }
    }
    if (tid == 0) total8 += lam * 10;
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

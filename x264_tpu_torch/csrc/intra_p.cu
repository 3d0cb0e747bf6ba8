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
// replaces that wavefront by bounded-depth sweeps over the whole frame;
// this kernel runs the same sweeps, with the I16x16 + chroma device code
// K1 runs (intra_mb.cuh), in four launches:
//   1. sweep 0 (one 64-thread CTA an MB, every MB): the intra path
//      against the inter reconstruction (pre-deblock), its cost and
//      modes; the candidate recon goes to A. After the I16x16 decision
//      warp 0 runs the luma residual while warp 1 runs the chroma
//      decision and residual (they share no state). Under RD the CTA
//      then prices the candidate that is already in shared memory: the
//      CABAC bits of the luma DC, 16 luma AC, 8 chroma AC and 2 chroma
//      DC blocks a block a 16-lane half (residual_bits_lanes), threads
//      0-15 the recon's 4x4 Hadamards for its AC energy, all threads the
//      three SSDs (warp reductions); thread 0 evaluates (((ssd_y + ssd_u)
//      + ssd_v) + psy * |ace - ce_psy|) + lam2 * (ibits + 256 * 9) in
//      that order, each float step rounded alone (no FMA), into
//      cost_i_rd;
//   2. decide (a thread an MB, DQ 256-thread CTAs an MB row): an MB
//      goes intra where cost + lam * 7 < cost_inter (or cost_i_rd <
//      rd_cost_inter under RD), unless its intra chain is deeper than 3
//      (the fixpoint on the 4x4 window of MBs above-left of it, which is
//      all the three iterations can reach). The intra MBs go to a list on
//      the card (an atomic count; no host sync). The MBs that stay inter
//      get the inter recon in A and zero syntax, once, by coalesced rows;
//   3. sweep 1 over the list with the sweep-0 modes, into B: neighbours
//      from A where intra, from the inter recon where not;
//   4. sweep 2 the same from B, into A, which is the output, with the
//      syntax. The list sweeps run a grid of as many CTAs as the card
//      holds, striding over the list: on a frame with few intra MBs most
//      CTAs find no work and end at once.
// Lossless (CQP 0; x264_tpu inter.py:634, :654): the sweeps take
// intra_mb.cuh's bypass, the decision keeps its SATD costs.
// B frames (x264_tpu encode_b_body) use the same kernels in two other
// sequences: intra_in_b_decide runs sweep 0 against residual pass 1's
// reconstruction (its costs alone) and the decision (stage 3,
// inter.py:965-1026), and intra_in_b_sweeps the merge with the decision
// given, then three list sweeps against pass 2's reconstruction, the
// first choosing the modes of the intra MBs afresh and the next two
// keeping them (stage 3.7, :1137-1160). Both decimate (B slices always
// do) and decide on SATD.
// What bounds it on the H100: bytes. The source, inter and output planes
// and syntax planes are ~51 MB at 1080p as int32 (~15 us at 3.35 TB/s);
// each sweep is ~16 SATD and 24 transform blocks per MB it runs (~25 k
// integer ops, some 0.2 G for sweep 0 over every MB, ~3 us at the ALU
// rate; the RD pricing adds ~27 x 16 walk steps and 16 Hadamards per MB).
// Sweep 0 is a chain of dependent steps an MB, 16 MBs resident an SM:
// its time is that chain's, which the shared layout of intra_mb.cuh (no
// bank conflicts on the per-block steps), the two warps' side by side
// residuals and the lane-parallel bit count shorten.
#include "intra_mb.cuh"
#include "rdcost.cuh"

using namespace x264t;

namespace {

constexpr int NT = IMB_NT;
constexpr int INTRA_PEN_BITS = 7;
constexpr int DNT = 256;                    // the decision's CTA: an MB a thread
constexpr int DQ = 8;                       // its CTAs an MB row
constexpr int MAX_MB_W = 512;               // 8192 pixels (the wrapper checks)

struct Planes {
  int* y;
  int* u;
  int* v;
};

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

// the intra MBs of the decision: their count, then their indices
struct List {
  int* count;
  int* mbs;
};

// CABAC bits (1/256 units) of a block's levels held a position a lane in
// each 16-lane half of the warp (rdcost.cuh:residual_bits, lane by lane):
// lv the lane's level in scan order (0 at and past n). A nonzero level's
// node is what the serial walk from the last position down reaches: with
// A nonzero and G greater-than-1 levels after it, min(A, 3) while G is 0,
// else min(3 + G, 7). Every lane of the warp calls it; each lane of a
// half gets its half's sum.
__device__ __forceinline__ int residual_bits_lanes(int lv, int n,
                                                   const int* __restrict__ tab) {
  const int lane = threadIdx.x & 31, l = lane & 15, half = lane & 16;
  const unsigned nzm = (__ballot_sync(0xffffffffu, lv != 0) >> half) & 0xffffu;
  const unsigned g1m = (__ballot_sync(0xffffffffu, abs(lv) > 1) >> half) & 0xffffu;
  const int last = nzm ? 31 - __clz((int)nzm) : -1;
  const int nz = lv != 0;
  int bits = 0;
  if (l < n - 1 && l <= last) {
    bits += tab[RD_SIG + 2 * l + nz];
    if (nz) bits += tab[RD_LAST + 2 * l + (last == l)];
  }
  if (nz) {
    const unsigned after = 0xffffffffu << (l + 1);
    const int na = __popc(nzm & after), ng = __popc(g1m & after);
    const int node = ng == 0 ? min(na, 3) : min(3 + ng, 7);
    const int a = abs(lv), prefix = min(a - 1, 14), gt1 = prefix > 0;
    bits += tab[RD_L1 + 2 * node + gt1];
    if (gt1)
      bits += tab[RD_UNARY + 15 * node + prefix] + (a >= 15 ? ue_big_f8(a - 15) : 0);
    else
      bits += 256;                          // the sign's bypass bin
  }
  for (int o = 8; o > 0; o >>= 1) bits += __shfl_xor_sync(0xffffffffu, bits, o);
  return bits;
}

// zig-zag position i of a 4x4 block, raster index (kZig4 without a
// memory access: lanes read different entries)
__device__ __forceinline__ int zig4(int i) {
  return (int)((0xfeb7adc963258410ull >> (4 * i)) & 15u);
}

// the RD cost of sweep 0's candidate in S (x264_tpu inter.py:677-699)
__device__ __forceinline__ void intra_rd_cost(const IntraMB& S, const RD rd,
                                              int mb) {
  const int tid = threadIdx.x;
  __shared__ int bits[28];
  __shared__ int had[16];
  __shared__ int wsum[NT / 32][4];
  // the bits of the luma DC (cat 0), 16 luma AC (cat 1), 8 chroma AC (cat
  // 4) and 2 chroma DC (cat 3) blocks: a block a 16-lane half, 4 a pass
  for (int p = 0; p < 7; ++p) {
    const int b = 4 * p + (tid >> 4), l = tid & 15;
    int lv = 0, n = 0, cat = 0;
    if (b == 0) {
      n = 16, lv = S.dcl16[zig4(l)];
    } else if (b < 17) {
      n = 15, cat = 1, lv = l < 15 ? S.lv16[b - 1][zig4(l + 1)] : 0;
    } else if (b < 25) {
      n = 15, cat = 4;
      lv = l < 15 ? S.clv[(b - 17) >> 2][(b - 17) & 3][zig4(l + 1)] : 0;
    } else if (b < 27) {
      n = 4, cat = 3, lv = l < 4 ? S.cdcl[b - 25][l] : 0;
    }
    const int s = residual_bits_lanes(lv, n, rd.rdtab + cat * RD_CAT_STRIDE);
    if (l == 0) bits[b] = s;
  }
  if (tid < 16)
    had[tid] = tile_had16(tid, [&](int r, int c) { return S.rec16[16 * r + c]; });
  int sy = 0, ps = 0;
  for (int i = tid; i < 256; i += NT) {
    const int d = S.fenc[i] - S.rec16[i];
    sy += d * d;
    ps += S.rec16[i];
  }
  const int du = S.fc[0][tid] - S.crec[0][tid];
  const int dv = S.fc[1][tid] - S.crec[1][tid];
  // the three SSDs and the recon's sum: a warp reduction each, then the
  // two warps' (integer sums: the order does not matter)
  int v4[4] = {sy, ps, du * du, dv * dv};
  for (int k = 0; k < 4; ++k) v4[k] = __reduce_add_sync(0xffffffffu, v4[k]);
  if ((tid & 31) == 0)
    for (int k = 0; k < 4; ++k) wsum[tid >> 5][k] = v4[k];
  __syncthreads();
  sy = wsum[0][0] + wsum[1][0];
  ps = wsum[0][1] + wsum[1][1];
  const int su = wsum[0][2] + wsum[1][2], sv = wsum[0][3] + wsum[1][3];
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

// one MB's I16 + chroma path into S: each neighbour read from its own
// planes (t, l, tl), the modes chosen (fix16 / fixc < 0) or fixed
__device__ __forceinline__ void eval_mb(
    IntraMB& S, const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, const ImbNbr t, const ImbNbr l,
    const ImbNbr tl, const int* __restrict__ qtab_g,
    const int* __restrict__ qp_map, int mb, int mb_w, int lam, int fix16,
    int fixc, int decimate, int lossless) {
  const int mx = mb % mb_w, my = mb / mb_w;
  const bool has_top = my > 0, has_left = mx > 0;
  // with a QP map (variance AQ) qtab_g is the 52-QP intra stack
  imb_load(S, qtab_g + (qp_map ? qp_map[mb] * QTAB_INTS : 0), Y, U, V, t, l,
           tl, mb_w, mx, my, has_top, has_left);
  __syncthreads();
  imb_predict(S, has_top, has_left);
  imb_i16_decide(S, has_top, has_left, lam, fix16);
  if (threadIdx.x < 32) {                   // luma and chroma side by side
    imb_i16_residual<ImbWarp>(S, decimate != 0, lossless != 0);
  } else {
    imb_chroma_decide<ImbWarp>(S, has_top, has_left, fixc);
    imb_chroma_residual<ImbWarp>(S, lossless != 0);
  }
  __syncthreads();
}

// S's reconstruction into MB mb of dst (all threads)
__device__ __forceinline__ void store_recon(const IntraMB& S, Planes dst,
                                            int mb, int mb_w) {
  const int mx = mb % mb_w, my = mb / mb_w, W = mb_w * 16, Wc = mb_w * 8;
  for (int i = threadIdx.x; i < 256; i += NT)
    dst.y[(my * 16 + (i >> 4)) * W + mx * 16 + (i & 15)] = S.rec16[i];
  for (int i = threadIdx.x; i < 128; i += NT) {
    const int ch = i >> 6, k = i & 63;
    (ch ? dst.v : dst.u)[(my * 8 + (k >> 3)) * Wc + mx * 8 + (k & 7)] =
        S.crec[ch][k];
  }
}

// S's syntax (zig-zag levels and modes) into MB mb of out (all threads)
__device__ __forceinline__ void store_syntax(const IntraMB& S, Syntax out,
                                             int mb) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += NT) {
    const int z = i >> 4, j = i & 15;
    out.luma_ac[mb * 256 + i] = S.lv16[4 * kBlkY[z] + kBlkX[z]][kZig4[j]];
  }
  for (int i = tid; i < 128; i += NT) {
    const int ch = i >> 6, k = i & 63;
    out.chroma_ac[mb * 128 + i] = S.clv[ch][k >> 4][kZig4[k & 15]];
  }
  if (tid < 16) out.luma_dc[mb * 16 + tid] = S.dcl16[kZig4[tid]];
  if (tid < 8) out.chroma_dc[mb * 8 + tid] = S.cdcl[tid >> 2][tid & 3];
  if (tid == 0) {
    out.mode16[mb] = S.mode16;
    out.modec[mb] = S.cmode;
  }
}

// sweep 0: the intra path of every MB against the inter reconstruction,
// its SATD cost (and under RD its RD cost) and modes; the candidate
// recon into dst. The B decision needs the costs alone (dst.y and
// out.mode16 null). Block 0 clears the intra list's count.
__global__ void __launch_bounds__(NT) sweep0_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, Planes inter, Planes dst,
    const int* __restrict__ qtab_g, Syntax out, int* __restrict__ cost_i,
    const RD rd, const int* __restrict__ qp_map, List list, int mb_w, int lam,
    int decimate, int lossless) {
  const int mb = blockIdx.x, tid = threadIdx.x;
  if (list.count && mb == 0 && tid == 0) *list.count = 0;
  __shared__ IntraMB S;
  const ImbNbr n{inter.y, inter.u, inter.v};
  eval_mb(S, Y, U, V, n, n, n, qtab_g, qp_map, mb, mb_w, lam, -1, -1,
          decimate, lossless);
  if (rd.rd_cost != nullptr) intra_rd_cost(S, rd, mb);
  if (dst.y) store_recon(S, dst, mb, mb_w);
  if (tid == 0) {
    cost_i[mb] = S.cost16;
    if (out.mode16) {
      out.mode16[mb] = S.mode16;
      out.modec[mb] = S.cmode;
    }
  }
}

// whether MB (mx, my) goes intra: it wants to (cost + lam * 7 <
// cost_inter, or cost_i_rd < rd_cost_inter under RD) and its intra chain
// resolves within 3 sweeps (resolved_k on the 4x4 window of MBs
// above-left of it, which is all the three iterations can reach; outside
// the frame counts as resolved, the True fill of up / lf)
__device__ __forceinline__ bool decide_mb(const int* __restrict__ cost_i,
                                          const int* __restrict__ cost_inter,
                                          const RD rd, int mb_w, int mx,
                                          int my, int lam) {
  bool choose[4][4], r[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int y = my - 3 + i, x = mx - 3 + j;
      const bool in = y >= 0 && x >= 0;
      const int n = in ? y * mb_w + x : 0;
      choose[i][j] = in && (rd.rd_cost != nullptr
                            ? rd.cost_i_rd[n] < rd.rd_cost[n]
                            : cost_i[n] + lam * INTRA_PEN_BITS < cost_inter[n]);
      r[i][j] = !choose[i][j];
    }
  for (int k = 1; k <= 3; ++k)
    for (int i = 3; i >= k; --i)             // descending: reads k-1 values
      for (int j = 3; j >= k; --j)
        r[i][j] = r[i][j] || (choose[i][j] && r[i - 1][j] && r[i][j - 1]
                              && r[i - 1][j - 1]);
  return choose[3][3] && r[3][3];
}

// n ints of p (an MB row's plane, per ints an MB) set to 0 on the MBs
// that stay inter; this CTA's DQ-th of them, 4 ints a store where per is
// a multiple of 4
__device__ __forceinline__ void zero_inter(int* p, int n, int per,
                                           const uint8_t* keep, int part) {
  if (per % 4 == 0) {
    const int n4 = n / 4, per4 = per / 4;
    for (int i = part * n4 / DQ + threadIdx.x; i < (part + 1) * n4 / DQ;
         i += DNT)
      if (!keep[i / per4]) reinterpret_cast<int4*>(p)[i] = make_int4(0, 0, 0, 0);
    return;
  }
  for (int i = part * n / DQ + threadIdx.x; i < (part + 1) * n / DQ; i += DNT)
    if (!keep[i / per]) p[i] = 0;
}

// The decision of MB row blockIdx.x, one thread an MB, by DQ CTAs (or,
// with `given`, the B sweeps' fixed decision); blockIdx.y == 0 writes
// intra_mb and appends the intra MBs to the list (in any order: the MBs
// of one sweep do not depend on each other). Unless a.y is null the
// CTAs then merge: the inter recon into A and zero syntax on the MBs that
// stay inter, each CTA a DQ-th of the row's rows and syntax.
__global__ void __launch_bounds__(DNT) decide_kernel(
    const int* __restrict__ cost_i, const int* __restrict__ cost_inter,
    const RD rd, const uint8_t* __restrict__ given,
    uint8_t* __restrict__ intra_mb, Planes inter, Planes a, Syntax out,
    List list, int mb_w, int lam) {
  const int my = blockIdx.x, part = blockIdx.y, tid = threadIdx.x;
  __shared__ uint8_t keep[MAX_MB_W];
  for (int mx = tid; mx < mb_w; mx += DNT) {
    const int mb = my * mb_w + mx;
    const bool k = given ? given[mb] != 0
                         : decide_mb(cost_i, cost_inter, rd, mb_w, mx, my, lam);
    keep[mx] = k;
    if (part == 0) {
      if (intra_mb) intra_mb[mb] = k ? 1 : 0;
      if (k && list.count) list.mbs[atomicAdd(list.count, 1)] = mb;
    }
  }
  if (a.y == nullptr) return;
  __syncthreads();
  // 4 samples a thread (int4; the wrapper checks the planes' alignment)
  const int W4 = mb_w * 4, Wc4 = mb_w * 2;
  for (int r = part * 16 / DQ; r < (part + 1) * 16 / DQ; ++r) {
    const int o = (my * 16 + r) * W4;
    for (int x = tid; x < W4; x += DNT)
      if (!keep[x >> 2])
        reinterpret_cast<int4*>(a.y)[o + x] =
            reinterpret_cast<const int4*>(inter.y)[o + x];
  }
  for (int r = part * 8 / DQ; r < (part + 1) * 8 / DQ; ++r) {
    const int o = (my * 8 + r) * Wc4;
    for (int x = tid; x < Wc4; x += DNT)
      if (!keep[x >> 1]) {
        reinterpret_cast<int4*>(a.u)[o + x] =
            reinterpret_cast<const int4*>(inter.u)[o + x];
        reinterpret_cast<int4*>(a.v)[o + x] =
            reinterpret_cast<const int4*>(inter.v)[o + x];
      }
  }
  const int m0 = my * mb_w;
  zero_inter(out.luma_ac + m0 * 256, mb_w * 256, 256, keep, part);
  zero_inter(out.chroma_ac + m0 * 128, mb_w * 128, 128, keep, part);
  zero_inter(out.luma_dc + m0 * 16, mb_w * 16, 16, keep, part);
  zero_inter(out.chroma_dc + m0 * 8, mb_w * 8, 8, keep, part);
  zero_inter(out.mode16 + m0, mb_w, 1, keep, part);
  zero_inter(out.modec + m0, mb_w, 1, keep, part);
}

// sweeps 1 and 2, and the B sweeps: the intra MBs of the list, a CTA at a
// time in a grid that strides over it. Each neighbour comes from src if
// it is intra (the last sweep's reconstruction) and from the inter
// recon if not, which is what the merged plane of x264_tpu's whole-frame
// sweep holds; the MB goes to dst, which no CTA of the launch reads.
// free_modes: the modes chosen afresh and written (the B sweeps' first);
// last: the syntax written.
__global__ void __launch_bounds__(NT) list_sweep_kernel(
    const int* __restrict__ Y, const int* __restrict__ U,
    const int* __restrict__ V, Planes src, Planes inter, Planes dst,
    const int* __restrict__ qtab_g, const uint8_t* __restrict__ intra_mb,
    List list, Syntax out, const int* __restrict__ qp_map, int mb_w, int lam,
    int decimate, int lossless, int free_modes, int last) {
  __shared__ IntraMB S;
  const int n = *list.count;
  const ImbNbr s{src.y, src.u, src.v}, i{inter.y, inter.u, inter.v};
  for (int k = blockIdx.x; k < n; k += gridDim.x) {
    const int mb = list.mbs[k], mx = mb % mb_w, my = mb / mb_w;
    const ImbNbr t = my > 0 && intra_mb[mb - mb_w] ? s : i;
    const ImbNbr l = mx > 0 && intra_mb[mb - 1] ? s : i;
    const ImbNbr tl = my > 0 && mx > 0 && intra_mb[mb - mb_w - 1] ? s : i;
    const int fix16 = free_modes ? -1 : out.mode16[mb];
    const int fixc = free_modes ? -1 : out.modec[mb];
    __syncthreads();                        // the last MB's S is read
    eval_mb(S, Y, U, V, t, l, tl, qtab_g, qp_map, mb, mb_w, lam, fix16, fixc,
            decimate, lossless);
    store_recon(S, dst, mb, mb_w);
    if (last) {
      store_syntax(S, out, mb);
    } else if (free_modes && threadIdx.x == 0) {
      out.mode16[mb] = S.mode16;
      out.modec[mb] = S.cmode;
    }
  }
}

// the list sweeps' grid: as many CTAs as the card holds at once, at most
// one an MB
int list_grid(int nmb) {
  static int full = 0;
  if (full == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, list_sweep_kernel,
                                                  NT, 0);
    full = sms * per > 0 ? sms * per : 1;
  }
  return nmb < full ? nmb : full;
}

}  // namespace

extern "C" int intra_in_p(const int* y, const int* u, const int* v,
                          int* inter_y, int* inter_u, int* inter_v,
                          const int* cost_inter, const int* qtab, int* ry,
                          int* ru, int* rv, uint8_t* intra_mb, int* mode16,
                          int* modec, int* luma_dc, int* luma_ac,
                          int* chroma_dc, int* chroma_ac, int* sy, int* su,
                          int* sv, int* cost_i, int* list,
                          const float* rd_cost, const int* ce_psy,
                          const int* rdtab, float* cost_i_rd,
                          const int* qp_map, int mb_h, int mb_w, int lam,
                          int decimate, float lam2, float psy, int lossless,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  const Planes inter{inter_y, inter_u, inter_v}, A{ry, ru, rv}, B{sy, su, sv};
  const Syntax out{mode16, modec, luma_dc, luma_ac, chroma_dc, chroma_ac};
  const RD rd{rd_cost, ce_psy, rdtab, cost_i_rd, lam2, psy};
  const List L{list, list + 1};
  sweep0_kernel<<<nmb, NT, 0, s>>>(y, u, v, inter, A, qtab, out, cost_i, rd,
                                   qp_map, L, mb_w, lam, decimate, lossless);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decide_kernel<<<dim3(mb_h, DQ), DNT, 0, s>>>(cost_i, cost_inter, rd,
                                               nullptr, intra_mb, inter, A,
                                               out, L, mb_w, lam);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int g = list_grid(nmb);
  list_sweep_kernel<<<g, NT, 0, s>>>(y, u, v, A, inter, B, qtab, intra_mb, L,
                                     out, qp_map, mb_w, lam, decimate,
                                     lossless, 0, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  list_sweep_kernel<<<g, NT, 0, s>>>(y, u, v, B, inter, A, qtab, intra_mb, L,
                                     out, qp_map, mb_w, lam, decimate,
                                     lossless, 0, 1);
  return (int)cudaGetLastError();
}

// the B frame's decision (inter.py:encode_b_body stage 3): sweep 0's
// costs against pass 1's reconstruction, then the decision (SATD,
// decimated) into intra_mb
extern "C" int intra_in_b_decide(const int* y, const int* u, const int* v,
                                 int* inter_y, int* inter_u, int* inter_v,
                                 const int* cost_inter, const int* qtab,
                                 uint8_t* intra_mb, int* cost_i, int mb_h,
                                 int mb_w, int lam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Planes inter{inter_y, inter_u, inter_v}, none{nullptr, nullptr,
                                                      nullptr};
  const Syntax out{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  const RD rd{nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f};
  const List L{nullptr, nullptr};
  sweep0_kernel<<<mb_h * mb_w, NT, 0, s>>>(y, u, v, inter, none, qtab, out,
                                           cost_i, rd, nullptr, L, mb_w, lam,
                                           1, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decide_kernel<<<dim3(mb_h, 1), DNT, 0, s>>>(cost_i, cost_inter, rd,
                                              nullptr, intra_mb, inter, none,
                                              out, L, mb_w, lam);
  return (int)cudaGetLastError();
}

// the B frame's sweeps (stage 3.7) with intra_mb fixed: the merge and the
// intra list, then over the list sweep 0 against pass 2's reconstruction
// with free modes into A, sweep 1 into B, sweep 2 into A, which is the
// output
extern "C" int intra_in_b_sweeps(const int* y, const int* u, const int* v,
                                 int* inter_y, int* inter_u, int* inter_v,
                                 const int* qtab, int* ry, int* ru, int* rv,
                                 const uint8_t* intra_mb, int* mode16,
                                 int* modec, int* luma_dc, int* luma_ac,
                                 int* chroma_dc, int* chroma_ac, int* sy,
                                 int* su, int* sv, int* list, int mb_h,
                                 int mb_w, int lam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  const Planes inter{inter_y, inter_u, inter_v}, A{ry, ru, rv}, B{sy, su, sv};
  const Syntax out{mode16, modec, luma_dc, luma_ac, chroma_dc, chroma_ac};
  const RD rd{nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f};
  const List L{list, list + 1};
  cudaError_t e = cudaMemsetAsync(list, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  decide_kernel<<<dim3(mb_h, DQ), DNT, 0, s>>>(nullptr, nullptr, rd, intra_mb,
                                               nullptr, inter, A, out, L,
                                               mb_w, lam);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int g = list_grid(nmb);
  const Planes src[3] = {inter, A, B}, dst[3] = {A, B, A};
  for (int k = 0; k < 3; ++k) {
    list_sweep_kernel<<<g, NT, 0, s>>>(y, u, v, src[k], inter, dst[k], qtab,
                                       intra_mb, L, out, nullptr, mb_w, lam,
                                       1, 0, k == 0, k == 2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

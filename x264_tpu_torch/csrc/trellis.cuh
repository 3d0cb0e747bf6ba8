// The CABAC trellis's device code, shared by K20 (trellis.cu, the
// standalone batched trellis) and K6 / K22 (inter.cu, which run it in
// place of their deadzone quant when given a trellis table).
//
// The per-block form of x264_tpu_torch/ops/trellis.py:trellis_scan_plain
// (x264_tpu/ops/trellis.py:236 trellis_scan; quant_trellis_cabac,
// encoder/rdo.c:411-628), bit for bit: an 8-node Viterbi over the C scan
// positions of one block, from the last position down, each level chosen
// from {q, q - 1} (no deadzone) by ssd + lambda2 * CABAC bits from the
// slice-initial states. The float steps are the plain version's, in its
// order, each with an explicit _rn intrinsic so that nvcc contracts
// nothing on its own: ssd = (d * d) * w2, base = score + ssd, and the
// candidate's score base + bits * lam2, as one __fmaf_rn where x264_tpu's
// XLA CPU code rounds it once (trellis.py:_score says where).
//
// Design. A block takes 8 lanes of a warp, one lane per node (lane j of
// the group keeps node j's score in a register). The lanes first work
// out, a position each in turn, what no node changes (q and the two
// candidates' distortions) into shared memory. At each position every
// lane then scores its own node's contribution for both candidates, and
// each destination node gathers the contributions that reach it with
// __shfl_sync from a fixed set of lanes in its group (the previous node,
// and for node 4 nodes 0-2 as well) and keeps the first strict minimum
// by selects: a handful of dependent float steps and eight shuffles, the
// same instructions on every lane, instead of 16 node updates on one
// thread. Where every block of the warp quantises the position to zero
// (most positions at the usual QPs) each node only takes its own zero,
// with no shuffle. A lane writes its node's history byte (parent * 4 +
// choice) for each position to shared memory, 8 * C bytes a block; the
// first argmin node is found by three xor shuffles, and every lane of
// the group then walks the same backtrack through shared memory and
// writes the positions congruent to its node mod 8. Every lane of a warp
// runs every shuffle (a group whose q is 0 runs the second candidate and
// drops it), so a warp must hold blocks of one length.
// What bounds it on the H100: latency. The work of a position is a few
// dozen operations a lane, but each position depends on the one after
// it, and the backtrack is C dependent shared loads: a block's chain is
// C x (the float steps and the shuffle rounds) long. Many blocks in
// flight (4 a warp, many warps an SM) are what hide it.
#pragma once
#include "rdcost.cuh"

namespace x264t {

// one category's packed table (trellis.py:pack_trellis): qmf, uqmf, w2
// (float bits) at C each, sig (C, 2), last (C, 2), l1 (8, 2), unary
// (8, 15), lam2
struct TrellisTab {
  const int* qmf;
  const int* uqmf;
  const float* w2;
  const float* sig;
  const float* last;
  const float* l1;
  const float* unary;
  float lam2;
};

__host__ __device__ constexpr int trellis_ints(int C) { return 7 * C + 16 + 120 + 1; }

__device__ __forceinline__ TrellisTab trellis_tab(const int* p, int C) {
  TrellisTab t;
  t.qmf = p;
  t.uqmf = p + C;
  t.w2 = reinterpret_cast<const float*>(p + 2 * C);
  t.sig = reinterpret_cast<const float*>(p + 3 * C);
  t.last = reinterpret_cast<const float*>(p + 5 * C);
  t.l1 = reinterpret_cast<const float*>(p + 7 * C);
  t.unary = reinterpret_cast<const float*>(p + 7 * C + 16);
  t.lam2 = __int_as_float(p[7 * C + 136]);
  return t;
}

// K6's frame table: cat 2 (luma 4x4, C 16), cat 4 (chroma AC, 15),
// cat 3 (chroma DC, 4), cat 5 (luma 8x8, 64), one after the other
// (encoder/inter.py:TRELLIS_QTAB)
constexpr int TR_CAT2 = 0;
constexpr int TR_CAT4 = TR_CAT2 + trellis_ints(16);
constexpr int TR_CAT3 = TR_CAT4 + trellis_ints(15);
constexpr int TR_CAT5 = TR_CAT3 + trellis_ints(4);
constexpr int TR_K6_INTS = TR_CAT5 + trellis_ints(64);

constexpr float TR_BIG = 1e30f;

// the words between two blocks' shared arrays of n words: a multiple of
// 32 plus 8, so that the 4 blocks of a warp sit on 4 different banks
__host__ __device__ constexpr int tr_pad(int n) { return (n + 31) / 32 * 32 + 8; }
constexpr unsigned TR_FULL = 0xffffffffu;

// the level of a stored choice: 0 q, 1 max(q - 1, 0), 2 zero
__device__ __forceinline__ int tr_level(int choice, int q) {
  return choice == 0 ? max(q, 0) : (choice == 1 ? max(q - 1, 0) : 0);
}

// position i's quantised magnitude q (no deadzone)
__device__ __forceinline__ int tr_q(int a, int qmf) {
  return (int)((unsigned)wmul(a, qmf) + (1u << 15)) >> 16;
}

// take (s, from node j, candidate cand) where `on` and s is strictly
// below the node's best so far (the serial loop's first strict
// minimum), as selects: no branch, whatever the lane
__device__ __forceinline__ void tr_take(bool on, float s, int j, int cand,
                                        float& ns, unsigned& nh) {
  const bool t = on & (s < ns);
  ns = t ? s : ns;
  nh = t ? (unsigned)(j << 2) | (unsigned)cand : nh;
}

// The trellis of one block on the 8 lanes of a group (lanes 8g .. 8g + 7
// of a warp; every lane of the warp must call it with blocks of the same
// C). coef: the block's C coefficients in scan order in shared memory,
// overwritten with each position's q * 2 + (coefficient < 0);
// ssd: 2 * C floats and hist: 8 * C bytes of shared memory for the
// group; out(i, level) is called once for each position i with its
// signed level, by the lane i % 8 of the group.
template <int C, class Out>
__device__ __forceinline__ void trellis_lanes(int* coef, const TrellisTab& t,
                                              float* ssd, unsigned char* hist,
                                              Out out) {
  const int lane = threadIdx.x & 31, j = lane & 7, g0 = lane & ~7;
  // what the node does not change: each position's q and the distortion
  // of its two candidate levels, C / 8 positions a lane
  for (int i = j; i < C; i += 8) {
    const int c = coef[i], a = abs(c), q = tr_q(a, t.qmf[i]);
#pragma unroll
    for (int cand = 0; cand < 2; ++cand) {
      const int lvl = max(q - cand, 0);
      const int unq = (int)((unsigned)wmul(t.uqmf[i], lvl) + 128u) >> 8;
      const float d = __int2float_rn(a - unq);
      ssd[2 * i + cand] = __fmul_rn(__fmul_rn(d, d), t.w2[i]);
    }
    coef[i] = q * 2 + (c < 0);
  }
  __syncwarp();
  // node j's own bit costs
  const float l1a = t.l1[2 * j], l1b = t.l1[2 * j + 1];
  const float* unary = t.unary + 15 * j;
  const int up_lane = g0 + max(j - 1, 0);
  float score = j ? TR_BIG : 0.f;
#pragma unroll 1
  for (int i = C - 1; i >= 0; --i) {
    const int q = coef[i] >> 1;
    float sig0 = 0.f, sig1 = 0.f, last0 = 0.f, last1 = 0.f;
    if (i < C - 1) {
      sig0 = t.sig[2 * i];
      sig1 = t.sig[2 * i + 1];
      last0 = t.last[2 * i];
      last1 = t.last[2 * i + 1];
    }
    const float bits0 = j ? sig0 : 0.f;         // the bits of a zero
    float ns = TR_BIG;
    unsigned nh = 2;                            // level 0, parent 0
    if (__all_sync(TR_FULL, q == 0)) {
      // every block of the warp quantises position i to zero: the one
      // candidate is a zero, which each node takes from itself
      tr_take(true, __fadd_rn(__fadd_rn(score, ssd[2 * i]),
                              __fmul_rn(bits0, t.lam2)),
              j, 0, ns, nh);
      score = ns;
      hist[8 * i + j] = (unsigned char)nh;
      continue;
    }
    // the bits of a level of 1 (the same for both candidates), and the
    // common head of a level > 1's
    const float sl = __fadd_rn(sig1, j == 0 ? last1 : last0);
    const float bits1 = __fadd_rn(__fadd_rn(sl, l1a), 256.f);
    const float head2 = __fadd_rn(sl, l1b);
#pragma unroll
    for (int cand = 0; cand < 2; ++cand) {
      const int lvl = max(q - cand, 0);
      const float base = __fadd_rn(score, ssd[2 * i + cand]);
      const float ue = lvl >= 15 ? __int2float_rn(ue_big_f8(lvl - 15)) : 0.f;
      const float bits2 = __fadd_rn(
          __fadd_rn(head2, unary[min(max(lvl - 1, 0), 14)]), ue);
      // the score as x264_tpu rounds it (trellis.py:_score): one FMA for
      // a level > 1, a separate multiply and add for 0 or 1
      const float s = lvl >= 2 ? __fmaf_rn(bits2, t.lam2, base)
                               : __fadd_rn(base, __fmul_rn(lvl ? bits1 : bits0,
                                                           t.lam2));
      // the sources of node j: itself (a zero; a level of 1 at nodes
      // 3-7; a level > 1 at node 7), node j - 1 (levels 1 and > 1) and,
      // for node 4 at a level > 1, nodes 0-2; every lane shuffles, also
      // where it drops the result
      const float up = __shfl_sync(TR_FULL, s, up_lane);
      const float s0 = __shfl_sync(TR_FULL, s, g0);
      const float s1 = __shfl_sync(TR_FULL, s, g0 + 1);
      const float s2 = __shfl_sync(TR_FULL, s, g0 + 2);
      const bool live = cand == 0 || q > 0;     // q - 1 duplicates q
      const bool k1 = live & (lvl == 1), k2 = live & (lvl >= 2);
      tr_take(k2 & (j == 4), s0, 0, cand, ns, nh);
      tr_take(k2 & (j == 4), s1, 1, cand, ns, nh);
      tr_take(k2 & (j == 4), s2, 2, cand, ns, nh);
      tr_take((k1 & (j >= 1) & (j <= 3)) | (k2 & (j >= 4)), up, j - 1, cand,
              ns, nh);
      tr_take((live & (lvl == 0)) | (k1 & (j >= 3)) | (k2 & (j == 7)), s, j,
              cand, ns, nh);
    }
    score = ns;
    hist[8 * i + j] = (unsigned char)nh;
  }
  // the first argmin node of the group
  float best = score;
  int node = j;
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1) {
    const float os = __shfl_xor_sync(TR_FULL, best, off);
    const int on = __shfl_xor_sync(TR_FULL, node, off);
    if (os < best || (os == best && on < node)) {
      best = os;
      node = on;
    }
  }
  __syncwarp();
#pragma unroll 4
  for (int i = 0; i < C; ++i) {
    const unsigned h = hist[8 * i + node];
    if ((i & 7) == j) {
      const int qs = coef[i], lvl = tr_level((int)(h & 3u), qs >> 1);
      out(i, qs & 1 ? -lvl : lvl);
    }
    node = (int)(h >> 2);
  }
}

}  // namespace x264t

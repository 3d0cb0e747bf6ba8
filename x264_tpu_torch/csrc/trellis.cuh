// The CABAC trellis's device code, shared by K20 (trellis.cu, the
// standalone batched trellis) and K6 (inter.cu, which runs it in place of
// its deadzone quant when given a trellis table).
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

// the node machine (trellis.py:NODE_TRANS) as functions of a constant j
__device__ __forceinline__ constexpr int tr_next1(int j) { return j < 3 ? j + 1 : j; }
__device__ __forceinline__ constexpr int tr_next2(int j) { return j < 4 ? 4 : (j < 7 ? j + 1 : 7); }

// the score of one contribution: base + bits * lam2, rounded as x264_tpu
// rounds it (trellis.py:_score): one FMA for a level > 1 (kind 2), a
// separate multiply and add for a zero (kind 0) or a level of 1 (kind 1)
__device__ __forceinline__ float tr_contrib(int kind, float bits, float lam2,
                                            float base) {
  return kind == 2 ? __fmaf_rn(bits, lam2, base)
                   : __fadd_rn(base, __fmul_rn(bits, lam2));
}

// the level of a stored choice: 0 q, 1 max(q - 1, 0), 2 zero
__device__ __forceinline__ int tr_level(int choice, int q) {
  return choice == 0 ? max(q, 0) : (choice == 1 ? max(q - 1, 0) : 0);
}

// The trellis of one block: coef (C) forward-transform coefficients in
// scan order -> out (C) signed levels in scan order. The history keeps
// one byte per (position, node), parent * 4 + choice, packed eight to a
// 64-bit word: C * 8 bytes of local memory.
template <int C>
__device__ void trellis_block(const int* coef, const TrellisTab& t, int* out) {
  float score[8];
  unsigned long long hist[C];
#pragma unroll
  for (int j = 0; j < 8; ++j) score[j] = j ? TR_BIG : 0.f;
  for (int i = C - 1; i >= 0; --i) {
    const int a = abs(coef[i]);
    const int q = (int)((unsigned)wmul(a, t.qmf[i]) + (1u << 15)) >> 16;
    float sig0 = 0.f, sig1 = 0.f, last0 = 0.f, last1 = 0.f;
    if (i < C - 1) {
      sig0 = t.sig[2 * i];
      sig1 = t.sig[2 * i + 1];
      last0 = t.last[2 * i];
      last1 = t.last[2 * i + 1];
    }
    float ns[8];
    unsigned nh[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      ns[d] = TR_BIG;
      nh[d] = 2;                                // level 0, parent 0
    }
    for (int cand = 0; cand < 2; ++cand) {
      if (cand == 1 && q <= 0) break;           // q - 1 duplicates q
      const int lvl = max(q - cand, 0);
      const int unq = (int)((unsigned)wmul(t.uqmf[i], lvl) + 128u) >> 8;
      const float d = __int2float_rn(a - unq);
      const float ssd = __fmul_rn(__fmul_rn(d, d), t.w2[i]);
      const int kind = lvl == 0 ? 0 : (lvl == 1 ? 1 : 2);
      const int prefix = min(max(lvl - 1, 0), 14);
      const float ue = lvl >= 15 ? __int2float_rn(ue_big_f8(lvl - 15)) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float base = __fadd_rn(score[j], ssd);
        const float last_j = j == 0 ? last1 : last0;
        const unsigned h = (unsigned)(j << 2) | (unsigned)cand;
        if (kind == 0) {
          const float s = tr_contrib(0, j ? sig0 : 0.f, t.lam2, base);
          if (s < ns[j]) { ns[j] = s; nh[j] = h; }
        } else if (kind == 1) {
          const float bits = __fadd_rn(
              __fadd_rn(__fadd_rn(sig1, last_j), t.l1[2 * j]), 256.f);
          const float s = tr_contrib(1, bits, t.lam2, base);
          if (s < ns[tr_next1(j)]) { ns[tr_next1(j)] = s; nh[tr_next1(j)] = h; }
        } else {
          const float bits = __fadd_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(sig1, last_j), t.l1[2 * j + 1]),
                        t.unary[15 * j + prefix]),
              ue);
          const float s = tr_contrib(2, bits, t.lam2, base);
          if (s < ns[tr_next2(j)]) { ns[tr_next2(j)] = s; nh[tr_next2(j)] = h; }
        }
      }
    }
    unsigned long long w = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      score[d] = ns[d];
      w |= (unsigned long long)nh[d] << (8 * d);
    }
    hist[i] = w;
  }
  int node = 0;                                 // the first argmin
  float best = score[0];
#pragma unroll
  for (int j = 1; j < 8; ++j)
    if (score[j] < best) {
      best = score[j];
      node = j;
    }
  for (int i = 0; i < C; ++i) {
    const unsigned h = (unsigned)(hist[i] >> (8 * node)) & 255u;
    const int a = abs(coef[i]);
    const int q = (int)((unsigned)wmul(a, t.qmf[i]) + (1u << 15)) >> 16;
    const int lvl = tr_level((int)(h & 3u), q);
    out[i] = coef[i] < 0 ? -lvl : lvl;
    node = (int)(h >> 2);
  }
}

}  // namespace x264t

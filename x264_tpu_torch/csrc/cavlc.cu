// K18 cavlc_i_slice, K19 cavlc_p_slice and K25 cavlc_b_slice: the packed
// CAVLC bitstream of an intra, a P and a B slice, header slots, MB codes
// and the rbsp stop bit, as big-endian 32-bit words.
//
// Replace x264_tpu/entropy/device.py:246 i16_code_planes, :379
// p_code_planes (with its ref_idx bits, :505-511) and :631 b_code_planes
// (with :100 residual_codes, :70 _level_codes, :208 nc_map, :220
// i4_pred_mode_codes, :57-68 ue/se_codes), each followed by :565
// pack_codes, as x264_tpu/encoder/pipeline.py's encode_i16_idr,
// encode_p and encode_b run them. Plain twins:
// x264_tpu_torch/entropy/device.py cavlc_i_slice_plain /
// cavlc_p_slice_plain / cavlc_b_slice_plain; wrappers: cavlc_i_slice /
// cavlc_p_slice / cavlc_b_slice.
//
// Design. The JAX version fills fixed per-MB (value, length) slot planes
// (938 slots an MB, most of them empty) and packs them with a cumsum and
// a scatter-add. Here each MB's live codes are produced twice by the
// same device functions (code_i_mb / code_p_mb over a BitSink), once
// counting and once writing, so the two passes cannot disagree (K25's
// code_mb for B differs from K19's only in its header; the residual, the
// count grids, the skip runs and the three passes are the same code):
//   a. counts: one thread per MB writes the total_coeff of its coded luma
//      4x4 and chroma AC blocks into frame-wide count grids (0 outside
//      the coded cbp groups), from which every MB reads its nC;
//   b. bits: one thread per MB sums the lengths of its codes;
//   c. scan: K3's exclusive scan (scan.cuh) turns them into offsets;
//   d. write: one thread per MB writes its codes MSB-first from the
//      header's end plus its offset. It gathers them into whole words and
//      ORs each into the zeroed buffer (atomicOr: the first and last
//      words are shared with the neighbouring MBs); words at or past the
//      capacity are dropped, as pack_codes' mode="drop". MB 0's thread
//      writes the header slots first; the last MB's thread (P: after the
//      trailing skip run) writes the stop bit and the total bit count.
// x264_tpu's semantics are kept where they differ from the host coder
// or the spec: _NEXT_SUFFIX ends in 0x7FFFFFF, the nC counts of intra AC
// blocks cover all 16 slots, the I16 luma DC takes block 0's nC, and
// mb_qp_delta is se(dqp) without a mod-52 fold. A code is at most 32
// bits long (the level escapes of the 4x4 dynamic range) and spans at
// most two words.
// What bounds it on the H100: bytes. The syntax planes (~13 MB at 1080p
// as int32) are read twice, the words written once. One thread per MB
// gives 8160 threads in 64 CTAs and each walks its MB serially, so the
// passes run far above that bound; a warp per MB is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int HDR_SLOTS = 96;
// the flat table of entropy/device.py:TABLE_PARTS, as (value, length)
// pairs where a table holds codes
constexpr int T_COEFF0 = 0;          // [5][2]
constexpr int T_COEFF = 10;          // [5][64][2]
constexpr int T_TZ = 650;            // [15][16][2]
constexpr int T_TZ_DC = 1130;        // [3][4][2]
constexpr int T_RUN = 1154;          // [7][15][2]
constexpr int T_CBP_I = 1364;        // [48]
constexpr int T_CBP_P = 1412;        // [48]
constexpr int T_CT_INDEX = 1460;     // [17]
constexpr int T_NEXT_SUFFIX = 1477;  // [7]
constexpr int T_SIZE = 1484;

__constant__ int kRasterOfZ[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

struct Header {
  int v[HDR_SLOTS];
  int l[HDR_SLOTS];
  int bits;
};

__device__ __forceinline__ int bitlen(unsigned x) {
  return x ? 32 - __clz(x) : 0;
}

// A bit position that only counts (WRITE false) or also writes the codes
// into the word buffer (WRITE true), gathering them into whole words.
template <bool WRITE>
struct BitSink {
  long long pos = 0;
  uint32_t* words = nullptr;
  int cap = 0;
  uint32_t acc = 0;  // the current word's bits so far (WRITE)

  __device__ void flush_word(long long w, uint32_t x) {
    if (x && w < cap) atomicOr(words + w, x);
  }
  __device__ void put(int value, int len) {
    if (len <= 0) return;
    if (WRITE) {
      const uint64_t mask = len >= 32 ? 0xFFFFFFFFull : ((1ull << len) - 1);
      const uint64_t v = (uint64_t)(uint32_t)value & mask;
      const int end = (int)(pos & 31) + len;        // in (0, 63]
      const uint64_t win = v << (64 - end);         // bits of 2 words
      acc |= (uint32_t)(win >> 32);
      if (end >= 32) {
        flush_word(pos >> 5, acc);
        acc = (uint32_t)win;
      }
    }
    pos += len;
  }
  __device__ void finish() {
    if (WRITE && (pos & 31)) flush_word(pos >> 5, acc);
  }
  __device__ void ue(int v) {
    const int n = bitlen((unsigned)(v + 1));
    put(v + 1, 2 * n - 1);
  }
  __device__ void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
  // a (value, length) pair of the flat table
  __device__ void code(const int* __restrict__ T, int at) {
    put(T[at], T[at + 1]);
  }
};

// level_prefix / level_suffix of one level (device.py _level_codes)
template <class S>
__device__ void level_code(S& s, int level, int suffix) {
  const int lc = abs(level) * 2 - 2 + (level < 0);
  const int msk = (1 << suffix) - 1;
  if ((lc >> suffix) < 14) {
    s.put((1 << suffix) | (lc & msk), (lc >> suffix) + 1 + suffix);
  } else if (suffix == 0 && lc < 30) {
    s.put(16 | min(max(lc - 14, 0), 15), 19);
  } else if (suffix > 0 && (lc >> suffix) == 14) {
    s.put((1 << suffix) | (lc & msk), 15 + suffix);
  } else {
    const int lc2 = max(lc - (15 << suffix) - (suffix == 0 ? 15 : 0), 0);
    const int p = bitlen((unsigned)(lc2 + 4096)) + 2;
    s.put((1 << (p - 3)) | (lc2 + 4096 - (1 << (p - 3))), 2 * p - 2);
  }
}

// block_residual_write_cavlc of one block of C coefficients in scan order
// (device.py residual_codes); nc < 0 selects the chroma-DC tables
template <class S>
__device__ void residual(S& s, const int* __restrict__ T,
                         const int* __restrict__ c, int C, int nc) {
  int lvl[16], pos[16];
  int total = 0;
  for (int i = C - 1; i >= 0; --i)
    if (c[i]) {
      lvl[total] = c[i];
      pos[total] = i;
      ++total;
    }
  int trailing = 0;
  while (trailing < total && trailing < 3 && abs(lvl[trailing]) == 1)
    ++trailing;
  const int cls = nc < 0 ? 4 : T[T_CT_INDEX + min(nc, 16)];
  if (total > 0)
    s.code(T, T_COEFF + (cls * 64 + (total - 1) * 4 + trailing) * 2);
  else
    s.code(T, T_COEFF0 + cls * 2);
  int signs = 0;
  for (int i = 0; i < trailing; ++i) signs = (signs << 1) | (lvl[i] < 0);
  s.put(signs, trailing);
  int suffix = (total > 10 && trailing < 3) ? 1 : 0;
  for (int i = trailing; i < total; ++i) {
    int level = lvl[i];
    const int orig_abs = abs(level);
    if (i == trailing && trailing < 3) level -= level > 0 ? 1 : -1;
    level_code(s, level, suffix);
    suffix = max(suffix, 1);
    if (orig_abs > T[T_NEXT_SUFFIX + suffix] && suffix < 6) ++suffix;
  }
  if (total == 0) return;
  int zeros_left = pos[0] + 1 - total;
  if (total < C) {
    if (nc < 0)
      s.code(T, T_TZ_DC + ((total - 1) * 4 + zeros_left) * 2);
    else
      s.code(T, T_TZ + ((total - 1) * 16 + zeros_left) * 2);
  }
  for (int i = 0; i < total - 1 && zeros_left > 0; ++i) {
    const int run = pos[i] - pos[i + 1] - 1;
    s.code(T, T_RUN + (min(zeros_left - 1, 6) * 15 + min(run, 14)) * 2);
    zeros_left -= run;
  }
}

__device__ __forceinline__ int count_nz(const int* __restrict__ c, int n) {
  int k = 0;
  for (int i = 0; i < n; ++i) k += c[i] != 0;
  return k;
}

// nC of a block at (gx, gy) of a count grid of width gw (nc_map)
__device__ __forceinline__ int nc_at(const int* __restrict__ grid, int gw,
                                     int gx, int gy) {
  const int a = gx > 0 ? grid[gy * gw + gx - 1] : -1;
  const int b = gy > 0 ? grid[(gy - 1) * gw + gx] : -1;
  if (a >= 0 && b >= 0) return (a + b + 1) >> 1;
  return a >= 0 ? a : (b >= 0 ? b : 0);
}

// the planes both slice kinds share
struct Residual {
  const int* mode16;
  const int* modec;
  const int* cbp;
  const int* luma_dc;
  const int* luma;       // (nmb, 16 z, 16): luma_ac / luma_blocks
  const int* chroma_dc;
  const int* chroma_ac;
  const int* dqp;        // or null: every mb_qp_delta 0
  const int* lcount;     // (mb_h*4, mb_w*4) coded counts, raster
  const int* ccount;     // (2, mb_h*2, mb_w*2)
  const int* T;
  int mb_h, mb_w;
};

// the chroma and (16 + 1) luma blocks of one coded MB
template <class S>
__device__ void mb_residual(S& s, const Residual& R, int mb, int cbp_l,
                            int cbp_c, int i16, int luma_all) {
  const int mbx = mb % R.mb_w, mby = mb / R.mb_w;
  const int gw = R.mb_w * 4;
  const int* lb = R.luma + (size_t)mb * 256;
  if (i16)                              // the luma DC takes block 0's nC
    residual(s, R.T, R.luma_dc + mb * 16, 16,
             nc_at(R.lcount, gw, mbx * 4, mby * 4));
  for (int k = 0; k < 16; ++k) {
    if (!(luma_all ? cbp_l > 0 : (cbp_l >> (k >> 2)) & 1)) continue;
    const int r = kRasterOfZ[k];
    const int nc = nc_at(R.lcount, gw, mbx * 4 + (r & 3), mby * 4 + (r >> 2));
    if (i16)
      residual(s, R.T, lb + k * 16 + 1, 15, nc);
    else
      residual(s, R.T, lb + k * 16, 16, nc);
  }
  if (cbp_c > 0)
    for (int ch = 0; ch < 2; ++ch)
      residual(s, R.T, R.chroma_dc + (mb * 2 + ch) * 4, 4, -1);
  if (cbp_c == 2) {
    const int cw = R.mb_w * 2;
    for (int ch = 0; ch < 2; ++ch)
      for (int blk = 0; blk < 4; ++blk)
        residual(s, R.T, R.chroma_ac + ((mb * 2 + ch) * 4 + blk) * 16 + 1, 15,
                 nc_at(R.ccount + ch * R.mb_h * 2 * cw, cw,
                       mbx * 2 + (blk & 1), mby * 2 + (blk >> 1)));
  }
}

__device__ __forceinline__ int dqp_of(const Residual& R, int mb) {
  return R.dqp ? R.dqp[mb] : 0;
}

// the count grids of one MB: luma counts of the blocks its cbp codes
// (all 16 slots), chroma AC counts (slots 1-15 in I slices, all 16 in P
// slices, as x264_tpu counts them) where cbp_chroma is 2
__device__ void write_counts(const Residual& R, int* lcount, int* ccount,
                             int mb, int cbp_l, int cbp_c, int luma_all,
                             int chroma_from) {
  const int mbx = mb % R.mb_w, mby = mb / R.mb_w;
  const int gw = R.mb_w * 4, cw = R.mb_w * 2;
  for (int k = 0; k < 16; ++k) {
    const int coded = luma_all ? cbp_l > 0 : (cbp_l >> (k >> 2)) & 1;
    const int r = kRasterOfZ[k];
    lcount[(mby * 4 + (r >> 2)) * gw + mbx * 4 + (r & 3)] =
        coded ? count_nz(R.luma + ((size_t)mb * 16 + k) * 16, 16) : 0;
  }
  for (int ch = 0; ch < 2; ++ch)
    for (int blk = 0; blk < 4; ++blk)
      ccount[ch * R.mb_h * 2 * cw + (mby * 2 + (blk >> 1)) * cw + mbx * 2 +
             (blk & 1)] =
          cbp_c == 2 ? count_nz(R.chroma_ac + ((mb * 2 + ch) * 4 + blk) * 16 +
                                    chroma_from,
                                16 - chroma_from)
                     : 0;
}

// ------------------------------------------------------------------ K18
struct IPlanes {
  Residual R;
  const uint8_t* i4_mb;
  const int* i4_modes;   // (mb_h, mb_w, 4, 4) raster, 2 for non-I4x4 MBs
};

// cbp_chroma of an intra MB from its levels (i16_code_planes)
__device__ int intra_cbp_c(const Residual& R, int mb) {
  const int* ac = R.chroma_ac + (size_t)mb * 128;
  for (int b = 0; b < 8; ++b)
    if (count_nz(ac + b * 16 + 1, 15)) return 2;
  return count_nz(R.chroma_dc + mb * 8, 8) ? 1 : 0;
}

// the I4x4 mode of raster cell (gx, gy) of the frame's 4x4 grid
__device__ __forceinline__ int i4_mode(const IPlanes& P, int gx, int gy) {
  const int mbx = gx >> 2, mby = gy >> 2;
  return P.i4_modes[((mby * P.R.mb_w + mbx) * 4 + (gy & 3)) * 4 + (gx & 3)];
}

template <class S>
__device__ void code_i_mb(S& s, const IPlanes& P, int mb) {
  const Residual& R = P.R;
  const int mbx = mb % R.mb_w, mby = mb / R.mb_w;
  const int i4 = P.i4_mb[mb];
  const int cbp_l = R.cbp[mb];
  const int cbp_c = intra_cbp_c(R, mb);
  s.ue(i4 ? 0 : 1 + R.mode16[mb] + 4 * cbp_c + 12 * (cbp_l > 0));
  if (i4)
    for (int k = 0; k < 16; ++k) {
      const int r = kRasterOfZ[k];
      const int gx = mbx * 4 + (r & 3), gy = mby * 4 + (r >> 2);
      const int m = i4_mode(P, gx, gy);
      const int left = gx > 0 ? i4_mode(P, gx - 1, gy) : 2;
      const int top = gy > 0 ? i4_mode(P, gx, gy - 1) : 2;
      const int mpm = min(left, top);
      if (m == mpm)
        s.put(1, 1);
      else
        s.put(m - (m > mpm), 4);
    }
  s.ue(R.modec[mb]);
  if (i4) s.ue(R.T[T_CBP_I + cbp_c * 16 + cbp_l]);
  if (!i4 || cbp_l > 0 || cbp_c > 0) s.se(dqp_of(R, mb));
  mb_residual(s, R, mb, cbp_l, cbp_c, !i4, 0);  // cbp groups, as JAX codes
}

__global__ void i_counts_kernel(IPlanes P, int* lcount, int* ccount) {
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= P.R.mb_h * P.R.mb_w) return;
  write_counts(P.R, lcount, ccount, mb, P.R.cbp[mb], intra_cbp_c(P.R, mb),
               0, 1);
}

__global__ void i_bits_kernel(IPlanes P, int* mb_bits) {
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= P.R.mb_h * P.R.mb_w) return;
  BitSink<false> s;
  code_i_mb(s, P, mb);
  mb_bits[mb] = (int)s.pos;
}

// MB 0 writes the header first, the last MB the stop bit and the total
template <class S>
__device__ void begin(S& s, const Header& H, const int* offsets, int mb) {
  if (mb == 0)
    for (int i = 0; i < HDR_SLOTS; ++i) s.put(H.v[i], H.l[i]);
  s.pos = H.bits + offsets[mb];
}

template <class S>
__device__ void end(S& s, int mb, int nmb, int* nbits) {
  if (mb == nmb - 1) {
    s.put(1, 1);                        // rbsp_stop_one_bit
    *nbits = (int)s.pos;
  }
  s.finish();
}

__global__ void i_write_kernel(IPlanes P, Header H, const int* offsets,
                               uint32_t* words, int cap, int* nbits) {
  const int nmb = P.R.mb_h * P.R.mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  BitSink<true> s;
  s.words = words;
  s.cap = cap;
  begin(s, H, offsets, mb);
  code_i_mb(s, P, mb);
  end(s, mb, nmb, nbits);
}

// ------------------------------------------------------------- K19, K25
struct PPlanes {
  Residual R;
  const uint8_t* intra_mb;
  const uint8_t* skip;
  const int* cbp_c;
  const int* ptype;
  const int* mvd;        // (nmb, 2)
  const int* mvd1;       // (nmb, 2)
  const int* mvd_sub;    // (nmb, 4, 2)
  const int* ref_idx;    // each MB's ref_idx_l0; null with one reference
};

struct BPlanes {
  Residual R;
  const uint8_t* intra_mb;
  const uint8_t* skip;
  const int* cbp_c;
  const uint8_t* direct;
  const int* bmode;      // 0 L0, 1 L1, 2 BI (before intra and direct)
  const uint8_t* use0;
  const uint8_t* use1;
  const int* mvd0;       // (nmb, 2) each list's
  const int* mvd1;
};

// the skip MBs right before mb (the mb_skip_run a coded mb carries)
__device__ __forceinline__ int skips_before(const uint8_t* skip, int mb) {
  int run = 0;
  while (mb - 1 - run >= 0 && skip[mb - 1 - run]) ++run;
  return run;
}

// the trailing skip run, after the last MB
template <class S>
__device__ void skip_tail(S& s, const uint8_t* skip, int mb, int nmb) {
  if (mb == nmb - 1) {
    const int tail = skip[mb] ? 1 + skips_before(skip, mb) : 0;
    if (tail > 0) s.ue(tail);
  }
}

template <class S>
__device__ void code_mb(S& s, const PPlanes& P, int mb, int nmb) {
  const Residual& R = P.R;
  if (!P.skip[mb]) {
    const int intra = P.intra_mb[mb];
    const int cbp_l = R.cbp[mb], cbp_c = P.cbp_c[mb];
    const int pt = P.ptype[mb];
    const int p8 = pt == 3;
    s.ue(skips_before(P.skip, mb));
    s.ue(intra ? 6 + R.mode16[mb] + 4 * cbp_c + 12 * (cbp_l > 0) : pt);
    if (intra) s.ue(R.modec[mb]);
    if (!intra) {
      if (p8)
        for (int k = 0; k < 4; ++k) s.put(1, 1);    // sub_mb_type P_L0_8x8
      // ref_idx_l0 te(v) of each partition, with two active references
      // the single bit !ref, all of them before the mvds
      if (P.ref_idx)
        for (int k = 0; k < (p8 ? 4 : pt > 0 ? 2 : 1); ++k)
          s.put(1 - P.ref_idx[mb], 1);
      const int* sub = P.mvd_sub + mb * 8;
      const int* m0 = p8 ? sub : P.mvd + mb * 2;
      s.se(m0[0]);
      s.se(m0[1]);
      if (pt > 0) {
        const int* m1 = p8 ? sub + 2 : P.mvd1 + mb * 2;
        s.se(m1[0]);
        s.se(m1[1]);
      }
      if (p8)
        for (int k = 4; k < 8; ++k) s.se(sub[k]);
      s.ue(R.T[T_CBP_P + cbp_c * 16 + cbp_l]);
    }
    if (intra || cbp_l > 0 || cbp_c > 0) s.se(dqp_of(R, mb));
    mb_residual(s, R, mb, cbp_l, cbp_c, intra, intra);
  }
  skip_tail(s, P.skip, mb, nmb);
}

// a B MB (b_code_planes): mb_type B_Direct_16x16 0, B_L0 / L1 / Bi_16x16
// 1 / 2 / 3, I16x16 23 + its I type; the mvds of each used list;
// mb_qp_delta 0 (B frames keep the frame QP)
template <class S>
__device__ void code_mb(S& s, const BPlanes& P, int mb, int nmb) {
  const Residual& R = P.R;
  if (!P.skip[mb]) {
    const int intra = P.intra_mb[mb];
    const int cbp_l = R.cbp[mb], cbp_c = P.cbp_c[mb];
    s.ue(skips_before(P.skip, mb));
    s.ue(intra ? 24 + R.mode16[mb] + 4 * cbp_c + 12 * (cbp_l > 0)
         : P.direct[mb] ? 0 : min(max(P.bmode[mb], 0), 2) + 1);
    if (intra) s.ue(R.modec[mb]);
    if (P.use0[mb]) {
      s.se(P.mvd0[2 * mb]);
      s.se(P.mvd0[2 * mb + 1]);
    }
    if (P.use1[mb]) {
      s.se(P.mvd1[2 * mb]);
      s.se(P.mvd1[2 * mb + 1]);
    }
    if (!intra) s.ue(R.T[T_CBP_P + cbp_c * 16 + cbp_l]);
    if (intra || cbp_l > 0 || cbp_c > 0) s.se(0);
    mb_residual(s, R, mb, cbp_l, cbp_c, intra, intra);
  }
  skip_tail(s, P.skip, mb, nmb);
}

// the three passes of an inter slice (P or B), over code_mb
template <class Planes>
__global__ void inter_counts_kernel(Planes P, int* lcount, int* ccount) {
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= P.R.mb_h * P.R.mb_w) return;
  write_counts(P.R, lcount, ccount, mb, P.R.cbp[mb], P.cbp_c[mb],
               P.intra_mb[mb], 0);
}

template <class Planes>
__global__ void inter_bits_kernel(Planes P, int* mb_bits) {
  const int nmb = P.R.mb_h * P.R.mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  BitSink<false> s;
  code_mb(s, P, mb, nmb);
  mb_bits[mb] = (int)s.pos;
}

template <class Planes>
__global__ void inter_write_kernel(Planes P, Header H, const int* offsets,
                                   uint32_t* words, int cap, int* nbits) {
  const int nmb = P.R.mb_h * P.R.mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  BitSink<true> s;
  s.words = words;
  s.cap = cap;
  begin(s, H, offsets, mb);
  code_mb(s, P, mb, nmb);
  end(s, mb, nmb, nbits);
}

Header make_header(const int* hdr_v, const int* hdr_l) {
  Header H;
  H.bits = 0;
  for (int i = 0; i < HDR_SLOTS; ++i) {
    H.v[i] = hdr_v[i];
    H.l[i] = hdr_l[i];
    H.bits += hdr_l[i];
  }
  return H;
}

// memset, counts, bits, scan, write: the launch sequence of both kernels
template <class Planes, class Counts, class Bits, class Write>
int run_slice(Counts counts_k, Bits bits_k, Write write_k, const Planes& P,
              const int* hdr_v, const int* hdr_l, int* lcount, int* ccount,
              int* mb_bits, int* offsets, uint32_t* words, int* nbits,
              int nmb, int cap, cudaStream_t s) {
  const int grid = (nmb + 127) / 128;
  cudaError_t e = cudaMemsetAsync(words, 0, (size_t)cap * 4, s);
  if (e != cudaSuccess) return (int)e;
  counts_k<<<grid, 128, 0, s>>>(P, lcount, ccount);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bits_k<<<grid, 128, 0, s>>>(P, mb_bits);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_kernel<<<1, SCAN_NT, 0, s>>>(mb_bits, offsets, nmb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  write_k<<<grid, 128, 0, s>>>(P, make_header(hdr_v, hdr_l), offsets, words,
                               cap, nbits);
  return (int)cudaGetLastError();
}

}  // namespace

// hdr_v / hdr_l: the 96 header slots in host memory (passed by value to
// the write kernel); tables: the flat table on the device
extern "C" int cavlc_i_slice(const int* mode16, const int* modec,
                             const uint8_t* i4_mb, const int* i4_modes,
                             const int* cbp_luma_bits, const int* luma_dc,
                             const int* luma_ac, const int* chroma_dc,
                             const int* chroma_ac, const int* dqp,
                             const int* tables, const int* hdr_v,
                             const int* hdr_l, int* lcount, int* ccount,
                             int* mb_bits, int* offsets, uint32_t* words,
                             int* nbits, int mb_h, int mb_w, int cap,
                             void* stream) {
  IPlanes P{{mode16, modec, cbp_luma_bits, luma_dc, luma_ac, chroma_dc,
             chroma_ac, dqp, lcount, ccount, tables, mb_h, mb_w},
            i4_mb, i4_modes};
  return run_slice(i_counts_kernel, i_bits_kernel, i_write_kernel, P, hdr_v,
                   hdr_l, lcount, ccount, mb_bits, offsets, words, nbits,
                   mb_h * mb_w, cap, (cudaStream_t)stream);
}

extern "C" int cavlc_p_slice(const uint8_t* intra_mb, const int* mode16,
                             const int* modec, const int* cbp_luma_bits,
                             const int* cbp_chroma, const int* luma_dc,
                             const int* luma_blocks, const int* chroma_dc,
                             const int* chroma_ac, const uint8_t* skip,
                             const int* ptype, const int* mvd,
                             const int* mvd1, const int* mvd_sub,
                             const int* dqp, const int* ref_idx,
                             const int* tables, const int* hdr_v,
                             const int* hdr_l, int* lcount, int* ccount,
                             int* mb_bits, int* offsets, uint32_t* words,
                             int* nbits, int mb_h, int mb_w, int cap,
                             void* stream) {
  PPlanes P{{mode16, modec, cbp_luma_bits, luma_dc, luma_blocks, chroma_dc,
             chroma_ac, dqp, lcount, ccount, tables, mb_h, mb_w},
            intra_mb, skip, cbp_chroma, ptype, mvd, mvd1, mvd_sub, ref_idx};
  return run_slice(inter_counts_kernel<PPlanes>, inter_bits_kernel<PPlanes>,
                   inter_write_kernel<PPlanes>, P, hdr_v, hdr_l, lcount,
                   ccount, mb_bits, offsets, words, nbits, mb_h * mb_w, cap,
                   (cudaStream_t)stream);
}

extern "C" int cavlc_b_slice(const uint8_t* intra_mb, const int* mode16,
                             const int* modec, const int* cbp_luma_bits,
                             const int* cbp_chroma, const int* luma_dc,
                             const int* luma_blocks, const int* chroma_dc,
                             const int* chroma_ac, const uint8_t* direct_mb,
                             const int* bmode, const uint8_t* skip,
                             const uint8_t* use_l0, const uint8_t* use_l1,
                             const int* mvd_l0, const int* mvd_l1,
                             const int* tables, const int* hdr_v,
                             const int* hdr_l, int* lcount, int* ccount,
                             int* mb_bits, int* offsets, uint32_t* words,
                             int* nbits, int mb_h, int mb_w, int cap,
                             void* stream) {
  BPlanes P{{mode16, modec, cbp_luma_bits, luma_dc, luma_blocks, chroma_dc,
             chroma_ac, nullptr, lcount, ccount, tables, mb_h, mb_w},
            intra_mb, skip, cbp_chroma, direct_mb, bmode, use_l0, use_l1,
            mvd_l0, mvd_l1};
  return run_slice(inter_counts_kernel<BPlanes>, inter_bits_kernel<BPlanes>,
                   inter_write_kernel<BPlanes>, P, hdr_v, hdr_l, lcount,
                   ccount, mb_bits, offsets, words, nbits, mb_h * mb_w, cap,
                   (cudaStream_t)stream);
}

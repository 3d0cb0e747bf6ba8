// K3 cabac_i_ops: the compacted CABAC bin-op stream of an intra slice,
// and K8 cabac_p_ops, that of a P slice (below the K3 kernels).
//
// Replaces x264_tpu/entropy/cabac_planes.py:i16_slice_ops (with
// residual_block_ops, i4_pred_mode_ops, _dqp_slots, _nbr_grids) followed
// by compact_ops, with t8_mode (transform_size_8x8_flag of I_NxN MBs) and
// the I8x8 MBs' mode bins and cat-5 blocks. Plain twin:
// x264_tpu_torch/entropy/cabac_planes.py i_slice_ops_plain; wrapper:
// i_slice_ops.
//
// Design. The JAX version fills fixed per-MB slot planes (560 slots, a
// pad op where a bin is absent) and compacts them with a cumsum and a
// scatter. Here three short kernels do the same without the pad slots:
//   1. emit: one thread per MB writes its live ops, in exactly the order
//      of the slot concatenation (header1, pred modes, header2, luma DC,
//      luma blocks, chroma DC, chroma AC, terminal), into its own
//      560-slot row of a scratch buffer and stores its count. It reads
//      the neighbour flags (coded blocks, cbp, modes, the 8x8 flag) from
//      the intra kernel's syntax planes of the left and top MBs; an I8x8
//      MB's 4x4 cells show the coded status of their 8x8 block;
//   2. scan: one CTA turns the counts into exclusive offsets (and the
//      total n_ops at offsets[nmb]);
//   3. scatter: one CTA per MB copies its row to its offset.
// What bounds it on the H100: bytes. The syntax planes (~10 MB at
// 1080p as int32) are read once by the emit kernel, the live ops are
// written twice (scratch, then the dense stream) and read once; the
// emit kernel's thread-per-MB loop is serial per MB but 8160 MBs fill
// the card. Op packing: kind << 29 | b << 17 | a (entropy/cabac.py).
// Variance AQ: given K17's planes (dqp, dqp_prev_nz) both emitters write
// each coded MB's mb_qp_delta as _dqp_slots does (at most 3 more ops
// than the one 0 bin: an I MB then emits at most 540 ops, a P one 511,
// still within OPS_PER_MB); without them the single 0 bin at ctx 60.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int OPS_PER_MB = 560;
enum { K_DEC = 0, K_BYPASS = 1, K_UE = 2, K_TERM = 3, K_ONES = 5,
       K_SIGMAP = 6, K_LEVEL = 7 };

__constant__ int kRasterOfZ[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
__constant__ int kZOfRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
// the 8x8 block of each raster 4x4 cell (cabac_planes.py:CELL_8X8)
__constant__ int kCell8[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

// any nonzero level in n levels
__device__ __forceinline__ int any_nz(const int* c, int n) {
  for (int i = 0; i < n; ++i)
    if (c[i]) return 1;
  return 0;
}

struct Planes {
  const int* mode16;
  const int* modec;
  const uint8_t* i4_mb;
  const int* i4_modes;
  const int* cbp;
  const int* luma_dc;
  const int* luma_ac;
  const int* chroma_dc;
  const int* chroma_ac;
  const uint8_t* t8_mb;      // null without I8x8
  const int* luma8;          // (nmb, 4, 64) 8x8 scan order; null without
  const int* dqp;            // K17's mb_qp_delta; null at one QP
  const uint8_t* dqp_pnz;    // the previous MB's delta was nonzero
  int mb_w;

  __device__ int t8(int mb) const { return t8_mb ? t8_mb[mb] : 0; }
  // 4x4 luma block (raster index r) of `mb` coded with a nonzero level;
  // an I8x8 MB's cell takes its 8x8 block's status
  __device__ int luma_coded(int mb, int r) const {
    if (t8(mb)) return any_nz(luma8 + (mb * 4 + kCell8[r]) * 64, 64);
    int z = kZOfRaster[r];
    if (!((cbp[mb] >> (z >> 2)) & 1)) return 0;
    const int* c = luma_ac + (mb * 16 + z) * 16;
    for (int i = 0; i < 16; ++i)
      if (c[i]) return 1;
    return 0;
  }
  __device__ int luma_dc_nz(int mb) const {
    if (i4_mb[mb]) return 0;
    for (int i = 0; i < 16; ++i)
      if (luma_dc[mb * 16 + i]) return 1;
    return 0;
  }
  __device__ int chroma_dc_nz(int mb, int ch) const {
    for (int i = 0; i < 4; ++i)
      if (chroma_dc[mb * 8 + ch * 4 + i]) return 1;
    return 0;
  }
  __device__ int chroma_ac_nz(int mb, int ch, int blk) const {
    const int* c = chroma_ac + ((mb * 2 + ch) * 4 + blk) * 16;
    for (int i = 1; i < 16; ++i)
      if (c[i]) return 1;
    return 0;
  }
  __device__ int cbp_chroma(int mb) const {
    for (int ch = 0; ch < 2; ++ch)
      for (int b = 0; b < 4; ++b)
        if (chroma_ac_nz(mb, ch, b)) return 2;
    return (chroma_dc_nz(mb, 0) || chroma_dc_nz(mb, 1)) ? 1 : 0;
  }
};

struct Emitter {
  uint32_t* out;
  int n;
  __device__ void put(int kind, uint32_t a, uint32_t b) {
    out[n++] = ((uint32_t)kind << 29) | (b << 17) | a;
  }
  __device__ void dec(int ctx, int bin) { put(K_DEC, (uint32_t)ctx, (uint32_t)bin); }
  // block_residual_write_cabac: cbf, then significance map and levels
  __device__ void residual(const int* c, int C, int cat, int cbf_ctx) {
    int last = -1;
    uint32_t mask = 0;
    for (int i = 0; i < C; ++i)
      if (c[i]) {
        last = i;
        if (i < C - 1) mask |= 1u << i;
      }
    dec(85 + 4 * cat + cbf_ctx, last >= 0);
    if (last < 0) return;
    put(K_SIGMAP, mask, (uint32_t)(cat | (last << 3)));
    for (int i = C - 1; i >= 0; --i)
      if (c[i]) put(K_LEVEL, (uint32_t)min(abs(c[i]) - 1, 0x1FFFF), c[i] < 0);
  }
  // an 8x8 block (cat 5, residual_block_ops8): no cbf; the significance
  // mask of positions 0..62 as four 16-bit parts (part in b[10:9]), then
  // the levels in reverse scan order
  __device__ void residual8(const int* c) {
    int last = -1;
    uint32_t mask[4] = {0, 0, 0, 0};
    for (int i = 0; i < 64; ++i)
      if (c[i]) {
        last = i;
        if (i < 63) mask[i >> 4] |= 1u << (i & 15);
      }
    if (last < 0) return;
    for (int part = 0; part < 4; ++part)
      put(K_SIGMAP, mask[part], (uint32_t)(5 | (last << 3) | (part << 9)));
    for (int i = 63; i >= 0; --i)
      if (c[i]) put(K_LEVEL, (uint32_t)min(abs(c[i]) - 1, 0x1FFFF), c[i] < 0);
  }
  // mb_qp_delta (x264_cabac_mb_qp_delta, cabac_planes.py:dqp_slots): one
  // 0 bin without a delta plane; else the mapped-unary value folded mod
  // 52 at ctxs 60 + c0, 62, then 63
  __device__ void dqp(const int* dqp_g, const uint8_t* pnz, int mb) {
    if (!dqp_g) {
      dec(60, 0);
      return;
    }
    const int d = dqp_g[mb];
    int val = d > 0 ? 2 * d - 1 : -2 * d;
    if (val >= 51 && val != 52) val = 103 - val;
    dec(60 + pnz[mb], val > 0);
    if (val >= 1) dec(62, val > 1);
    if (val >= 3) put(K_ONES, 63, (uint32_t)min(val - 2, 4095));
    if (val >= 2) dec(63, 0);
  }
};

__global__ void emit_kernel(Planes P, int mb_h, int t8_mode,
                            uint32_t* __restrict__ scratch,
                            int* __restrict__ counts) {
  const int mb_w = P.mb_w, nmb = mb_h * mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  const int mx = mb % mb_w, my = mb / mb_w;
  const bool hl = mx > 0, ht = my > 0;
  const int mbl = mb - 1, mbt = mb - mb_w;
  const bool i4 = P.i4_mb[mb];
  const int cbp = P.cbp[mb];
  const int cbpc = P.cbp_chroma(mb);
  Emitter E{scratch + (size_t)mb * OPS_PER_MB, 0};

  // ---- header1: mb_type (ctxInc counts available non-I4x4 neighbours)
  const int ctx_mbtype = 3 + (hl && !P.i4_mb[mbl]) + (ht && !P.i4_mb[mbt]);
  E.dec(ctx_mbtype, !i4);
  // transform_size_8x8_flag of I_NxN MBs (x264_cabac_mb_transform_size)
  if (t8_mode && i4) E.dec(399 + (hl && P.t8(mbl)) + (ht && P.t8(mbt)), P.t8(mb));
  if (!i4) {
    const int m16 = P.mode16[mb];
    E.put(K_TERM, 0, 0);
    E.dec(6, cbp > 0);
    E.dec(7, cbpc > 0);
    if (cbpc > 0) E.dec(8, cbpc == 2);
    E.dec(9, m16 >> 1);
    E.dec(10, m16 & 1);
  }
  // ---- prev / rem_intra4x4_pred_mode (16 blocks), or the I8x8 MB's
  // four (the top-left cells of its 8x8 blocks, z 0, 4, 8, 12)
  const bool i8 = P.t8(mb);
  if (i4) {
    const int* md = P.i4_modes + mb * 16;
    for (int z = 0; z < 16; z += i8 ? 4 : 1) {
      const int r = kRasterOfZ[z], by = r >> 2, bx = r & 3;
      const int lm = bx > 0 ? md[r - 1] : hl ? P.i4_modes[mbl * 16 + 4 * by + 3] : 2;
      const int tm = by > 0 ? md[r - 4] : ht ? P.i4_modes[mbt * 16 + 12 + bx] : 2;
      const int mpm = min(lm, tm), m = md[r];
      E.dec(68, m == mpm);
      if (m != mpm) {
        const int rem = m - (m > mpm);
        for (int k = 0; k < 3; ++k) E.dec(69, (rem >> k) & 1);
      }
    }
  }
  // ---- header2: chroma pred mode, I4x4 cbp, mb_qp_delta
  const int cm = P.modec[mb];
  E.dec(64 + (hl && P.modec[mbl] != 0) + (ht && P.modec[mbt] != 0), cm > 0);
  if (cm > 0) E.dec(67, cm > 1);
  if (cm > 1) E.dec(67, cm > 2);
  if (i4) {
    const int cl = hl ? P.cbp[mbl] : -1, ct = ht ? P.cbp[mbt] : -1;
    const int ctx[4] = {76 - ((cl >> 1) & 1) - ((ct >> 1) & 2),
                        76 - (cbp & 1) - ((ct >> 2) & 2),
                        76 - ((cl >> 3) & 1) - ((cbp << 1) & 2),
                        76 - ((cbp >> 2) & 1) - (cbp & 2)};
    for (int k = 0; k < 4; ++k) E.dec(ctx[k], (cbp >> k) & 1);
    const int ccl = hl ? P.cbp_chroma(mbl) : -1, cct = ht ? P.cbp_chroma(mbt) : -1;
    E.dec(77 + (ccl > 0) + 2 * (cct > 0), cbpc > 0);
    if (cbpc > 0) E.dec(81 + (ccl == 2) + 2 * (cct == 2), cbpc == 2);
  }
  if (!i4 || cbp > 0 || cbpc > 0) E.dqp(P.dqp, P.dqp_pnz, mb);

  // ---- luma DC (I16x16, cat 0); outside the frame counts as coded
  if (!i4) {
    const int a = hl ? P.luma_dc_nz(mbl) : 1, b = ht ? P.luma_dc_nz(mbt) : 1;
    E.residual(P.luma_dc + mb * 16, 16, 0, 2 * b + a);
  }
  // ---- luma 8x8 blocks of an I8x8 MB (cat 5, no cbf)
  if (i8)
    for (int b = 0; b < 4; ++b)
      if ((cbp >> b) & 1) E.residual8(P.luma8 + (mb * 4 + b) * 64);
  // ---- luma 4x4 blocks: I16 AC (cat 1) or I4x4 (cat 2)
  for (int z = 0; z < 16 && !i8; ++z) {
    const bool coded = i4 ? ((cbp >> (z >> 2)) & 1) : cbp > 0;
    if (!coded) continue;
    const int r = kRasterOfZ[z], by = r >> 2, bx = r & 3;
    const int a = bx > 0 ? P.luma_coded(mb, r - 1) : hl ? P.luma_coded(mbl, r + 3) : 1;
    const int b = by > 0 ? P.luma_coded(mb, r - 4) : ht ? P.luma_coded(mbt, r + 12) : 1;
    const int* c = P.luma_ac + (mb * 16 + z) * 16;
    if (i4) E.residual(c, 16, 2, 2 * b + a);
    else E.residual(c + 1, 15, 1, 2 * b + a);
  }
  // ---- chroma DC (cat 3) and AC (cat 4)
  if (cbpc > 0)
    for (int ch = 0; ch < 2; ++ch) {
      const int a = hl ? P.chroma_dc_nz(mbl, ch) : 1;
      const int b = ht ? P.chroma_dc_nz(mbt, ch) : 1;
      E.residual(P.chroma_dc + mb * 8 + ch * 4, 4, 3, 2 * b + a);
    }
  if (cbpc == 2)
    for (int ch = 0; ch < 2; ++ch)
      for (int blk = 0; blk < 4; ++blk) {
        const int by = blk >> 1, bx = blk & 1;
        const int a = bx ? P.chroma_ac_nz(mb, ch, blk - 1)
                    : hl ? P.chroma_ac_nz(mbl, ch, blk + 1) : 1;
        const int b = by ? P.chroma_ac_nz(mb, ch, blk - 2)
                    : ht ? P.chroma_ac_nz(mbt, ch, blk + 2) : 1;
        E.residual(P.chroma_ac + ((mb * 2 + ch) * 4 + blk) * 16 + 1, 15, 4,
                   2 * b + a);
      }
  // ---- end_of_slice_flag = 0 after every MB but the last
  if (mb != nmb - 1) E.put(K_TERM, 0, 0);
  counts[mb] = E.n;
}

__global__ void scatter_kernel(const uint32_t* __restrict__ scratch,
                               const int* __restrict__ counts,
                               const int* __restrict__ offsets,
                               uint32_t* __restrict__ ops) {
  const int mb = blockIdx.x;
  const uint32_t* src = scratch + (size_t)mb * OPS_PER_MB;
  uint32_t* dst = ops + offsets[mb];
  for (int i = threadIdx.x; i < counts[mb]; i += blockDim.x) dst[i] = src[i];
}

// ---------------------------------------------------------------- K8
// K8 cabac_p_ops: stage 4 of the P encode and the op stream of the slice.
//
// Replaces x264_tpu/encoder/mvpred.py:77 predict_16x16, :86
// predict_pskip, :169 predict_16x8, :196 predict_8x16 and :233
// predict_p8x8, the skip / mvd / 4x4-map derivation of
// encoder/inter.py:encode_p_body (stage 4, inter.py:733-842) and
// x264_tpu/entropy/cabac_planes.py:518 p_slice_ops (with
// _mvd_component_ops and _cbf_ctx_from_grid) followed by :429
// compact_ops, for P_L0 16x16 / 16x8 / 8x16, P_8x8, P_Skip and I16x16 MBs
// with one reference, with or without the 8x8 transform. Plain twin:
// x264_tpu_torch/entropy/cabac_planes.py:cabac_p_ops_plain; wrapper:
// cabac_p_ops.
//
// Design. Four launches.
//   A. one thread per MB: the MB's final 16x16 MV and quadrant MVs (0 if
//      intra); the exact predictors from the final 4x4 maps, which a
//      thread reads straight from its neighbours' ptype / quadrant MVs
//      (ref 0, -1 intra, -2 outside the frame): 16x16 and P_Skip, and per
//      partition type 16x8 (B or A outright when ref 0 matches), 8x16 (A
//      or C), P8x8 (the median of each sub-block, C falling back to D);
//      the skip flag (ptype 0 only), mvd / mvd1 / mvd_sub, mv_sub, and
//      the per-4x4 mvd4 / nnz4 / ref4 / mv4 maps; with the 8x8 transform
//      t8_mb (the 8x8 choice of an inter MB that is not skipped and has
//      coded luma: the skip test uses the cbp after the choice) and, in
//      nnz4, each cell of a t8 MB holding its 8x8 block's count;
//   B. one thread per MB emits its live ops in the slot order of
//      p_slice_ops (skip flag, mb_type, intra fields, sub_mb_types, the
//      mvds partition by partition, cbp, transform_size_8x8_flag, dqp,
//      luma DC, 16 luma blocks or four cat-5 blocks, chroma DC, chroma
//      AC, end_of_slice), reading the neighbours' skip, t8_mb, nnz4 and
//      mvd4 that pass A wrote. A P_8x8 MB emits at most 508
//      live ops (with the 8x8 transform, 493: one flag, and four cat-5
//      blocks of at most 68 in place of 288), an intra MB 452:
//      OPS_PER_MB = 560 bounds pass B's scratch;
//   then K3's scan and scatter.
// What bounds it on the H100: bytes, as K3: the syntax planes and maps
// (~19 MB at 1080p as int32) are read or written once and the live ops
// written twice.

__constant__ int kMvdTermOff[9] = {0, 3, 4, 5, 6, 6, 6, 6, 6};

struct PPlanes {
  const uint8_t* intra;
  const uint8_t* skip;
  const int* ptype;
  const int* mode16;
  const int* modec;
  const int* cbp;
  const int* cbpc;
  const int* luma_dc;
  const int* luma_blocks;
  const int* chroma_dc;
  const int* chroma_ac;
  const int* mvd;
  const int* mvd1;
  const int* mvd_sub;
  const int* mvd4;
  const int* nnz4;
  const uint8_t* t8_mb;      // null without the 8x8 transform
  const int* luma8;
  const int* dqp;            // K17's mb_qp_delta; null at one QP
  const uint8_t* dqp_pnz;
  int mb_w;
  const int* ref4;           // pass A's 4x4 L0 refs; null: one reference
  const int* ref_idx;        // each MB's ref_idx_l0 (with ref4)

  __device__ int t8(int n) const { return t8_mb ? t8_mb[n] : 0; }

  // cbf flag of 4x4 block (raster r) of MB n, from the final nnz map
  __device__ int nnz(int n, int r) const {
    const int nx = n % mb_w, ny = n / mb_w;
    return nnz4[(4 * ny + (r >> 2)) * 4 * mb_w + 4 * nx + (r & 3)] > 0;
  }
  __device__ int dc_nz(int n) const {
    if (!intra[n]) return 0;
    for (int i = 0; i < 16; ++i)
      if (luma_dc[n * 16 + i]) return 1;
    return 0;
  }
  __device__ int cdc_nz(int n, int ch) const {
    if (cbpc[n] <= 0) return 0;
    for (int i = 0; i < 4; ++i)
      if (chroma_dc[n * 8 + ch * 4 + i]) return 1;
    return 0;
  }
  __device__ int cac_nz(int n, int ch, int blk) const {
    if (cbpc[n] != 2) return 0;
    const int* c = chroma_ac + ((n * 2 + ch) * 4 + blk) * 16;
    for (int i = 1; i < 16; ++i)
      if (c[i]) return 1;
    return 0;
  }
  // the |mvd| component of the 4x4 block (by4, bx4); 0 outside the frame
  __device__ int amvd(int by4, int bx4, int comp) const {
    if (by4 < 0 || bx4 < 0) return 0;
    return abs(mvd4[(by4 * 4 * mb_w + bx4) * 2 + comp]);
  }
};

// (ref, mv) of one 4x4 block of the final maps
struct Cell {
  int ref, x, y;
};

struct MvMaps {
  const uint8_t* intra;
  const int* ptype;
  const int* mv_quad;
  int mb_h, mb_w;
  const int* ref_sel;        // each MB's reference; null: all ref 0

  // the block (by4, bx4): -2 outside the frame, -1 intra, else the MB's
  // reference with the MV of its 8x8 quadrant
  __device__ Cell cell(int by4, int bx4) const {
    if (by4 < 0 || bx4 < 0 || by4 >= 4 * mb_h || bx4 >= 4 * mb_w) return Cell{-2, 0, 0};
    const int n = (by4 >> 2) * mb_w + (bx4 >> 2);
    if (intra[n]) return Cell{-1, 0, 0};
    const int k = 2 * ((by4 & 3) >> 1) + ((bx4 & 3) >> 1);
    return Cell{ref_sel ? ref_sel[n] : 0, mv_quad[(n * 4 + k) * 2],
                mv_quad[(n * 4 + k) * 2 + 1]};
  }
  // the C slot at (r, c), or D at (rd, cd) where C is unavailable
  __device__ Cell c_or_d(int r, int c, int rd, int cd) const {
    const Cell C = cell(r, c);
    return C.ref == -2 ? cell(rd, cd) : C;
  }
};

__device__ __forceinline__ int median3(int a, int b, int c) {
  return a + b + c - min(a, min(b, c)) - max(a, max(b, c));
}

// the median / count rule (mvpred.py:_predict) for reference i_ref
__device__ __forceinline__ Cell predict(const Cell& A, const Cell& B, const Cell& C,
                                        int i_ref = 0) {
  const int cnt = (A.ref == i_ref) + (B.ref == i_ref) + (C.ref == i_ref);
  if (cnt == 1) return A.ref == i_ref ? A : B.ref == i_ref ? B : C;
  if (cnt == 0 && B.ref == -2 && C.ref == -2 && A.ref != -2) return A;
  return Cell{i_ref, median3(A.x, B.x, C.x), median3(A.y, B.y, C.y)};
}

__global__ void p_maps_kernel(MvMaps M, const int* __restrict__ me_mv,
                              const int* __restrict__ cbp,
                              const int* __restrict__ cbpc,
                              const int* __restrict__ luma_blocks,
                              const uint8_t* __restrict__ t8_sel,
                              const int* __restrict__ luma8,
                              uint8_t* __restrict__ skip_o,
                              int* __restrict__ mv_o, int* __restrict__ mvd_o,
                              int* __restrict__ mvd1_o,
                              int* __restrict__ ptype_o,
                              int* __restrict__ mv_sub_o,
                              int* __restrict__ mvd_sub_o,
                              int* __restrict__ mvd4, int* __restrict__ nnz4,
                              int* __restrict__ ref4, int* __restrict__ mv4,
                              uint8_t* __restrict__ t8_mb,
                              int* __restrict__ ref_idx_o) {
  const int mb_h = M.mb_h, mb_w = M.mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= mb_h * mb_w) return;
  const int mx = mb % mb_w, my = mb / mb_w, gy = 4 * my, gx = 4 * mx;
  const bool im = M.intra[mb];
  const int pt = im ? 0 : M.ptype[mb];
  const int mvx = im ? 0 : me_mv[2 * mb], mvy = im ? 0 : me_mv[2 * mb + 1];
  int qx[4], qy[4];
  for (int k = 0; k < 4; ++k) {
    qx[k] = im ? 0 : M.mv_quad[(mb * 4 + k) * 2];
    qy[k] = im ? 0 : M.mv_quad[(mb * 4 + k) * 2 + 1];
  }
  // the MB's reference, the i_ref of its predictions (0 on intra MBs)
  const int ir = im || !M.ref_sel ? 0 : M.ref_sel[mb];
  // predict_16x16 and predict_pskip (whose median is ref 0's)
  const Cell A = M.cell(gy, gx - 1), B = M.cell(gy - 1, gx);
  const Cell C16 = M.c_or_d(gy - 1, gx + 4, gy - 1, gx - 1);
  const Cell p16 = predict(A, B, C16, ir);
  const Cell s16 = ir == 0 ? p16 : predict(A, B, C16, 0);
  const bool force0 = A.ref == -2 || B.ref == -2
      || (A.ref == 0 && A.x == 0 && A.y == 0) || (B.ref == 0 && B.x == 0 && B.y == 0);
  const int sx = force0 ? 0 : s16.x, sy = force0 ? 0 : s16.y;
  int d0x = 0, d0y = 0, d1x = 0, d1y = 0, dsx[4] = {0, 0, 0, 0}, dsy[4] = {0, 0, 0, 0};
  if (pt == 1) {             // predict_16x8
    const Cell t = B.ref == ir ? B : p16;
    const Cell A1 = M.cell(gy + 2, gx - 1);
    const Cell m1 = predict(A1, M.cell(gy + 1, gx), M.cell(gy + 1, gx - 1), ir);
    const Cell b = A1.ref == ir ? A1 : m1;
    d0x = qx[0] - t.x; d0y = qy[0] - t.y;
    d1x = qx[2] - b.x; d1y = qy[2] - b.y;
  } else if (pt == 2) {      // predict_8x16
    const Cell m0 = predict(A, B, M.c_or_d(gy - 1, gx + 2, gy - 1, gx - 1), ir);
    const Cell l = A.ref == ir ? A : m0;
    const Cell C1 = M.c_or_d(gy - 1, gx + 4, gy - 1, gx + 1);
    const Cell m1 = predict(M.cell(gy, gx + 1), M.cell(gy - 1, gx + 2), C1, ir);
    const Cell r = C1.ref == ir ? C1 : m1;
    d0x = qx[0] - l.x; d0y = qy[0] - l.y;
    d1x = qx[1] - r.x; d1y = qy[1] - r.y;
  } else if (pt == 3) {      // predict_p8x8
    for (int k = 0; k < 4; ++k) {
      const int by = gy + 2 * (k >> 1), bx = gx + 2 * (k & 1);
      const Cell C = k == 3 ? M.cell(by - 1, bx - 1) : M.c_or_d(by - 1, bx + 2, by - 1, bx - 1);
      const Cell p = predict(M.cell(by, bx - 1), M.cell(by - 1, bx), C, ir);
      dsx[k] = qx[k] - p.x; dsy[k] = qy[k] - p.y;
    }
  } else if (!im) {
    d0x = mvx - p16.x; d0y = mvy - p16.y;
  }
  // P_Skip implies ref_idx 0: a ref-1 MB never skips
  const bool sk = !im && pt == 0 && ir == 0 && cbp[mb] == 0 && cbpc[mb] == 0
      && mvx == sx && mvy == sy;
  skip_o[mb] = sk ? 1 : 0;
  ptype_o[mb] = pt;
  mv_o[2 * mb] = mvx; mv_o[2 * mb + 1] = mvy;
  mvd_o[2 * mb] = d0x; mvd_o[2 * mb + 1] = d0y;
  mvd1_o[2 * mb] = d1x; mvd1_o[2 * mb + 1] = d1y;
  for (int k = 0; k < 4; ++k) {
    mv_sub_o[(mb * 4 + k) * 2] = pt == 3 ? qx[k] : 0;
    mv_sub_o[(mb * 4 + k) * 2 + 1] = pt == 3 ? qy[k] : 0;
    mvd_sub_o[(mb * 4 + k) * 2] = dsx[k];
    mvd_sub_o[(mb * 4 + k) * 2 + 1] = dsy[k];
  }
  const int W4 = 4 * mb_w;
  for (int r = 0; r < 16; ++r) {
    const int by = r >> 2, bx = r & 3, k = 2 * (by >> 1) + (bx >> 1);
    const int o = (gy + by) * W4 + gx + bx;
    const bool p1 = (pt == 1 && by >= 2) || (pt == 2 && bx >= 2);
    int ex = p1 ? d1x : d0x, ey = p1 ? d1y : d0y;
    if (pt == 3) { ex = dsx[k]; ey = dsy[k]; }
    mvd4[2 * o] = sk ? 0 : ex;
    mvd4[2 * o + 1] = sk ? 0 : ey;
    ref4[o] = im ? -1 : ir;
    mv4[2 * o] = qx[k];
    mv4[2 * o + 1] = qy[k];
  }
  if (ref_idx_o) ref_idx_o[mb] = ir;
  const bool t8 = t8_sel && t8_sel[mb] && !im && !sk && cbp[mb] > 0;
  if (t8_mb) t8_mb[mb] = t8 ? 1 : 0;
  int n8[4] = {0, 0, 0, 0};
  if (t8)
    for (int b = 0; b < 4; ++b)
      for (int i = 0; i < 64; ++i) n8[b] += luma8[(mb * 4 + b) * 64 + i] != 0;
  for (int z = 0; z < 16; ++z) {
    const int* c = luma_blocks + (mb * 16 + z) * 16;
    int n = 0;
    for (int i = 0; i < 16; ++i) n += c[i] != 0;
    const int r = kRasterOfZ[z];
    nnz4[(gy + (r >> 2)) * W4 + gx + (r & 3)] =
        t8 ? n8[kCell8[r]] : ((cbp[mb] >> (z >> 2)) & 1) ? n : 0;
  }
}

// one mvd component, UEG3 (x264_cabac_mb_mvd_cpn; p_slice_ops'
// _mvd_component_ops); am: the left + top neighbours' |mvd|
__device__ void emit_mvd(Emitter& E, int v, int base, int am) {
  const int a = abs(v);
  E.dec(base + (am > 2) + (am > 32), a > 0);
  if (a >= 2) E.dec(base + 3, 1);
  if (a >= 3) E.dec(base + 4, 1);
  if (a >= 4) E.dec(base + 5, 1);
  const int ones = min(max(min(a - 1, 8) - 3, 0), 5);
  if (ones > 0) E.put(K_ONES, (uint32_t)(base + 6), (uint32_t)ones);
  if (a >= 1 && a < 9) E.dec(base + kMvdTermOff[a], 0);
  if (a >= 9) E.put(K_UE, (uint32_t)(a - 9), 3);
  if (a >= 1) E.put(K_BYPASS, v < 0, 1);
}

// the residual of a P or B MB (p_slice_ops / b_slice_ops): luma DC of
// an intra MB, the 16 luma 4x4 blocks (I16 AC or inter cat 2) or the four
// cat-5 blocks, chroma DC and AC; outside the frame a cbf context takes
// the current MB's intra flag (luma DC: 1)
__device__ void emit_residual(Emitter& E, const PPlanes& P, int mb, bool hl,
                              bool ht, bool im, bool coded, bool inter,
                              int cbp, int cbpc) {
  const int mbl = mb - 1, mbt = mb - P.mb_w;
  if (im) {
    const int a = hl ? P.dc_nz(mbl) : 1, b = ht ? P.dc_nz(mbt) : 1;
    E.residual(P.luma_dc + mb * 16, 16, 0, 2 * b + a);
  }
  const bool t8 = P.t8(mb);
  if (t8)                                        // cat 5, no cbf
    for (int b = 0; b < 4; ++b)
      if ((cbp >> b) & 1) E.residual8(P.luma8 + (mb * 4 + b) * 64);
  for (int z = 0; z < 16 && !t8; ++z) {
    const bool blk_coded = im ? cbp > 0 : (inter && ((cbp >> (z >> 2)) & 1));
    if (!blk_coded) continue;
    const int r = kRasterOfZ[z], by = r >> 2, bx = r & 3;
    const int a = bx > 0 ? P.nnz(mb, r - 1) : hl ? P.nnz(mbl, r + 3) : im;
    const int b = by > 0 ? P.nnz(mb, r - 4) : ht ? P.nnz(mbt, r + 12) : im;
    const int* c = P.luma_blocks + (mb * 16 + z) * 16;
    if (im) E.residual(c + 1, 15, 1, 2 * b + a);
    else E.residual(c, 16, 2, 2 * b + a);
  }
  if (coded && cbpc > 0)
    for (int ch = 0; ch < 2; ++ch) {
      const int a = hl ? P.cdc_nz(mbl, ch) : im, b = ht ? P.cdc_nz(mbt, ch) : im;
      E.residual(P.chroma_dc + mb * 8 + ch * 4, 4, 3, 2 * b + a);
    }
  if (coded && cbpc == 2)
    for (int ch = 0; ch < 2; ++ch)
      for (int blk = 0; blk < 4; ++blk) {
        const int by = blk >> 1, bx = blk & 1;
        const int a = bx ? P.cac_nz(mb, ch, blk - 1)
                    : hl ? P.cac_nz(mbl, ch, blk + 1) : im;
        const int b = by ? P.cac_nz(mb, ch, blk - 2)
                    : ht ? P.cac_nz(mbt, ch, blk + 2) : im;
        E.residual(P.chroma_ac + ((mb * 2 + ch) * 4 + blk) * 16 + 1, 15, 4,
                   2 * b + a);
      }
}

__global__ void p_emit_kernel(PPlanes P, int mb_h, int t8_mode,
                              uint32_t* __restrict__ scratch,
                              int* __restrict__ counts) {
  const int mb_w = P.mb_w, nmb = mb_h * mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  const int mx = mb % mb_w, my = mb / mb_w;
  const bool hl = mx > 0, ht = my > 0;
  const int mbl = mb - 1, mbt = mb - mb_w;
  const bool im = P.intra[mb], sk = P.skip[mb];
  const bool coded = !sk, inter = coded && !im;
  const int cbp = P.cbp[mb], cbpc = P.cbpc[mb], pt = P.ptype[mb];
  Emitter E{scratch + (size_t)mb * OPS_PER_MB, 0};

  // ---- mb_skip_flag (ctx 11 + non-skip neighbours), mb_type: P_L0
  // 16x16 (15,0)(16,0), 16x8 (15,1)(17,1), 8x16 (15,1)(17,0), P_8x8
  // (15,0)(16,1)
  E.dec(11 + (hl && !P.skip[mbl]) + (ht && !P.skip[mbt]), sk);
  if (coded) E.dec(14, im);
  if (inter) {
    const bool split = pt == 1 || pt == 2;
    E.dec(15, split);
    if (split) E.dec(17, pt == 1);
    else E.dec(16, pt == 3);
  }
  if (im) {
    const int m16 = P.mode16[mb];
    E.dec(17, 1);
    E.put(K_TERM, 0, 0);
    E.dec(18, cbp > 0);
    E.dec(19, cbpc > 0);
    if (cbpc > 0) E.dec(19, cbpc == 2);
    E.dec(20, m16 >> 1);
    E.dec(20, m16 & 1);
    // intra chroma pred mode; non-intra neighbours count as mode 0
    const int cm = P.modec[mb];
    const int cml = hl && P.intra[mbl] ? P.modec[mbl] : 0;
    const int cmt = ht && P.intra[mbt] ? P.modec[mbt] : 0;
    E.dec(64 + (cml != 0) + (cmt != 0), cm > 0);
    if (cm > 0) E.dec(67, cm > 1);
    if (cm > 1) E.dec(67, cm > 2);
  }
  if (inter) {
    // ---- sub_mb_type x4: D_L0_8x8 is one '1' bin at ctx 21
    if (pt == 3)
      for (int k = 0; k < 4; ++k) E.dec(21, 1);
    // a partition's first 4x4 block
    const int n_parts = pt == 0 ? 1 : pt == 3 ? 4 : 2;
    auto part_r = [&](int k) {
      return 4 * my + (pt == 1 || pt == 3 ? 2 * (k >> (pt == 3)) : 0);
    };
    auto part_c = [&](int k) {
      return 4 * mx + (pt == 2 ? 2 * k : pt == 3 ? 2 * (k & 1) : 0);
    };
    // ---- ref_idx_l0 per partition under two references: ctx 54 +
    // (refA > 0) + 2 * (refB > 0) from the left / top 4x4 slots of ref4
    // (the MB's own cells included), then a 0 at ctx 58 after a 1
    if (P.ref4) {
      const int W4 = 4 * mb_w, ri = P.ref_idx[mb];
      for (int k = 0; k < n_parts; ++k) {
        const int r = part_r(k), c = part_c(k);
        const int ra = c > 0 && P.ref4[r * W4 + c - 1] > 0;
        const int rb = r > 0 && P.ref4[(r - 1) * W4 + c] > 0;
        E.dec(54 + ra + 2 * rb, ri > 0);
        if (ri > 0) E.dec(58, 0);
      }
    }
    // ---- mvds per partition in syntax order; ctxInc from the left /
    // top 4x4 neighbours' |mvd| at the partition's first block
    for (int k = 0; k < n_parts; ++k) {
      const int* d = pt == 3 ? P.mvd_sub + (mb * 4 + k) * 2
                   : k == 0 ? P.mvd + 2 * mb : P.mvd1 + 2 * mb;
      const int r = part_r(k), c = part_c(k);
      for (int comp = 0; comp < 2; ++comp)
        emit_mvd(E, d[comp], comp ? 47 : 40,
                 P.amvd(r, c - 1, comp) + P.amvd(r - 1, c, comp));
    }
    // ---- coded_block_pattern; skip neighbours count as cbp 0
    const int cl = hl ? (P.skip[mbl] ? 0 : P.cbp[mbl]) : -1;
    const int ct = ht ? (P.skip[mbt] ? 0 : P.cbp[mbt]) : -1;
    const int ctx[4] = {76 - ((cl >> 1) & 1) - ((ct >> 1) & 2),
                        76 - (cbp & 1) - ((ct >> 2) & 2),
                        76 - ((cl >> 3) & 1) - ((cbp << 1) & 2),
                        76 - ((cbp >> 2) & 1) - (cbp & 2)};
    for (int k = 0; k < 4; ++k) E.dec(ctx[k], (cbp >> k) & 1);
    const int ccl = hl ? (P.skip[mbl] ? 0 : P.cbpc[mbl]) : -1;
    const int cct = ht ? (P.skip[mbt] ? 0 : P.cbpc[mbt]) : -1;
    E.dec(77 + (ccl > 0) + 2 * (cct > 0), cbpc > 0);
    if (cbpc > 0) E.dec(81 + (ccl == 2) + 2 * (cct == 2), cbpc == 2);
    // ---- transform_size_8x8_flag of inter MBs with coded luma
    if (t8_mode && cbp > 0)
      E.dec(399 + (hl && P.t8(mbl)) + (ht && P.t8(mbt)), P.t8(mb));
  }
  if (coded && (im || cbp > 0 || cbpc > 0)) E.dqp(P.dqp, P.dqp_pnz, mb);

  emit_residual(E, P, mb, hl, ht, im, coded, inter, cbp, cbpc);
  if (mb != nmb - 1) E.put(K_TERM, 0, 0);          // end_of_slice_flag 0
  counts[mb] = E.n;
}

// ---------------------------------------------------------------- K24
// K24 cabac_b_ops: stage 4 of the B encode and the op stream of the slice.
//
// Replaces the map derivation of x264_tpu/encoder/inter.py:866
// encode_b_body's stage 4 (inter.py:1174-1224: the per-list 4x4 ref / mv
// maps, mvpred.py:77 predict_16x16 per list, the mvds and their maps,
// B_SKIP, nnz4) and x264_tpu/entropy/cabac_planes.py:791 b_slice_ops
// followed by compact_ops. Plain twin:
// x264_tpu_torch/entropy/cabac_planes.py:cabac_b_ops_plain; wrapper:
// cabac_b_ops.
//
// Design. Four launches, as K8's:
//   A. one thread per MB: use_l0 / use_l1 (explicit L0 / L1 / BI modes;
//      direct and skip code no mvd), each list's 4x4 ref / mv maps (ref
//      -1 and MV 0 on intra MBs, -1 on an unused list), each list's 16x16
//      predictor from the neighbours' final per-MB configs (ref 0, -1, or
//      -2 outside the frame; C falling back to D), the mvds and their 4x4
//      maps, B_SKIP (direct without coded luma or chroma) and nnz4;
//   B. one thread per MB emits its live ops in b_slice_ops' slot order:
//      the skip flag (ctx 24 + non-skip neighbours), mb_type (bin 0 at ctx
//      27 + the neighbours that are neither skip nor direct: 0 for
//      B_Direct_16x16; L0 1 0 0, L1 1 0 1, Bi 1 1 0 0 0 0, intra
//      1 1 1 1 0 1 and the I16 suffix at ctxs 32-35), the intra chroma
//      mode, the mvds of L0 then L1 (ctxInc from the same list's left /
//      top |mvd|), cbp, transform_size_8x8_flag 0 under t8_mode, the
//      mb_qp_delta 0 bin, then K8's residual; an MB emits at most the
//      P_8x8 bound (two mvds of 2 x 7 in place of four);
//   then K3's scan and scatter.
// What bounds it on the H100: bytes, as K8.

// the final per-MB config of one list as a 4x4 block (by4, bx4) of its
// maps: -2 outside the frame, -1 intra or unused, else ref 0 and its MV
struct BCfg {
  const uint8_t* intra;
  const int *r, *m;
  int mb_h, mb_w;
  __device__ Cell cell(int by4, int bx4) const {
    if (by4 < 0 || bx4 < 0 || by4 >= 4 * mb_h || bx4 >= 4 * mb_w) return Cell{-2, 0, 0};
    const int n = (by4 >> 2) * mb_w + (bx4 >> 2);
    if (intra[n] || r[n] < 0) return Cell{-1, 0, 0};
    return Cell{r[n], m[2 * n], m[2 * n + 1]};
  }
};

__global__ void b_maps_kernel(
    const uint8_t* __restrict__ intra, const uint8_t* __restrict__ direct,
    const int* __restrict__ bmode, const int* __restrict__ r0,
    const int* __restrict__ r1, const int* __restrict__ m0,
    const int* __restrict__ m1, const int* __restrict__ cbp,
    const int* __restrict__ cbpc, const int* __restrict__ luma_blocks,
    uint8_t* __restrict__ use0_o, uint8_t* __restrict__ use1_o,
    int* __restrict__ mvd0_o, int* __restrict__ mvd1_o,
    int* __restrict__ mvd4_0, int* __restrict__ mvd4_1,
    uint8_t* __restrict__ skip_o, int* __restrict__ nnz4,
    int* __restrict__ ref4_0, int* __restrict__ mv4_0,
    int* __restrict__ ref4_1, int* __restrict__ mv4_1, int mb_h, int mb_w) {
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= mb_h * mb_w) return;
  const int mx = mb % mb_w, my = mb / mb_w, gy = 4 * my, gx = 4 * mx;
  const int W4 = 4 * mb_w;
  const bool im = intra[mb], dm = direct[mb];
  const int bm = bmode[mb];
  const bool use[2] = {!im && !dm && bm != 1, !im && !dm && bm != 0};
  int* mvd_o[2] = {mvd0_o, mvd1_o};
  int* mvd4[2] = {mvd4_0, mvd4_1};
  int* ref4[2] = {ref4_0, ref4_1};
  int* mv4[2] = {mv4_0, mv4_1};
  for (int k = 0; k < 2; ++k) {
    const BCfg M{intra, k ? r1 : r0, k ? m1 : m0, mb_h, mb_w};
    Cell C = M.cell(gy - 1, gx + 4);
    if (C.ref == -2) C = M.cell(gy - 1, gx - 1);
    const Cell p = predict(M.cell(gy, gx - 1), M.cell(gy - 1, gx), C);
    const int mvx = (k ? m1 : m0)[2 * mb], mvy = (k ? m1 : m0)[2 * mb + 1];
    const int dx = use[k] ? mvx - p.x : 0, dy = use[k] ? mvy - p.y : 0;
    mvd_o[k][2 * mb] = dx;
    mvd_o[k][2 * mb + 1] = dy;
    for (int r = 0; r < 16; ++r) {
      const int o = (gy + (r >> 2)) * W4 + gx + (r & 3);
      mvd4[k][2 * o] = dx;
      mvd4[k][2 * o + 1] = dy;
      ref4[k][o] = im ? -1 : (k ? r1 : r0)[mb];
      mv4[k][2 * o] = mvx;
      mv4[k][2 * o + 1] = mvy;
    }
  }
  use0_o[mb] = use[0];
  use1_o[mb] = use[1];
  skip_o[mb] = dm && cbp[mb] == 0 && cbpc[mb] == 0;
  for (int z = 0; z < 16; ++z) {
    const int* c = luma_blocks + (mb * 16 + z) * 16;
    int n = 0;
    for (int i = 0; i < 16; ++i) n += c[i] != 0;
    const int r = kRasterOfZ[z];
    nnz4[(gy + (r >> 2)) * W4 + gx + (r & 3)] = ((cbp[mb] >> (z >> 2)) & 1) ? n : 0;
  }
}

__global__ void b_emit_kernel(PPlanes P, const uint8_t* __restrict__ direct,
                              const int* __restrict__ bmode,
                              const uint8_t* __restrict__ use0,
                              const uint8_t* __restrict__ use1,
                              const int* __restrict__ mvd0,
                              const int* __restrict__ mvd1,
                              const int* __restrict__ mvd4_0,
                              const int* __restrict__ mvd4_1, int mb_h,
                              int t8_mode, uint32_t* __restrict__ scratch,
                              int* __restrict__ counts) {
  const int mb_w = P.mb_w, nmb = mb_h * mb_w;
  const int mb = blockIdx.x * blockDim.x + threadIdx.x;
  if (mb >= nmb) return;
  const int mx = mb % mb_w, my = mb / mb_w;
  const bool hl = mx > 0, ht = my > 0;
  const int mbl = mb - 1, mbt = mb - mb_w;
  const bool im = P.intra[mb], sk = P.skip[mb], dm = direct[mb];
  const bool coded = !sk, inter = coded && !im, expl = inter && !dm;
  const int cbp = P.cbp[mb], cbpc = P.cbpc[mb], bm = bmode[mb];
  const bool bi = expl && bm == 2;
  Emitter E{scratch + (size_t)mb * OPS_PER_MB, 0};

  E.dec(24 + (hl && !P.skip[mbl]) + (ht && !P.skip[mbt]), sk);
  if (coded) {
    E.dec(27 + (hl && !P.skip[mbl] && !direct[mbl])
          + (ht && !P.skip[mbt] && !direct[mbt]), !dm);
    if (!dm) E.dec(30, im || bi);
  }
  if (expl && !bi) E.dec(32, bm == 1);
  if (bi) {
    E.dec(31, 0);
    for (int k = 0; k < 3; ++k) E.dec(32, 0);
  }
  if (im) {
    const int m16 = P.mode16[mb];
    E.dec(31, 1);
    E.dec(32, 1);
    E.dec(32, 0);
    E.dec(32, 1);
    E.dec(32, 1);
    E.put(K_TERM, 0, 0);
    E.dec(33, cbp > 0);
    E.dec(34, cbpc > 0);
    if (cbpc > 0) E.dec(34, cbpc == 2);
    E.dec(35, m16 >> 1);
    E.dec(35, m16 & 1);
    // intra chroma pred mode; non-intra neighbours count as mode 0
    const int cm = P.modec[mb];
    const int cml = hl && P.intra[mbl] ? P.modec[mbl] : 0;
    const int cmt = ht && P.intra[mbt] ? P.modec[mbt] : 0;
    E.dec(64 + (cml != 0) + (cmt != 0), cm > 0);
    if (cm > 0) E.dec(67, cm > 1);
    if (cm > 1) E.dec(67, cm > 2);
  }
  // the mvds of L0 then L1; ctxInc from the same list's left / top |mvd|
  for (int k = 0; k < 2; ++k) {
    if (!(k ? use1 : use0)[mb]) continue;
    const int* d = (k ? mvd1 : mvd0) + 2 * mb;
    const int* m4 = k ? mvd4_1 : mvd4_0;
    auto am = [&](int by4, int bx4, int comp) {
      return by4 < 0 || bx4 < 0 ? 0 : abs(m4[(by4 * 4 * mb_w + bx4) * 2 + comp]);
    };
    for (int comp = 0; comp < 2; ++comp)
      emit_mvd(E, d[comp], comp ? 47 : 40,
               am(4 * my, 4 * mx - 1, comp) + am(4 * my - 1, 4 * mx, comp));
  }
  if (inter) {
    const int cl = hl ? P.cbp[mbl] : -1, ct = ht ? P.cbp[mbt] : -1;
    const int ctx[4] = {76 - ((cl >> 1) & 1) - ((ct >> 1) & 2),
                        76 - (cbp & 1) - ((ct >> 2) & 2),
                        76 - ((cl >> 3) & 1) - ((cbp << 1) & 2),
                        76 - ((cbp >> 2) & 1) - (cbp & 2)};
    for (int k = 0; k < 4; ++k) E.dec(ctx[k], (cbp >> k) & 1);
    const int ccl = hl ? P.cbpc[mbl] : -1, cct = ht ? P.cbpc[mbt] : -1;
    E.dec(77 + (ccl > 0) + 2 * (cct > 0), cbpc > 0);
    if (cbpc > 0) E.dec(81 + (ccl == 2) + 2 * (cct == 2), cbpc == 2);
    // B MBs keep the 4x4 transform
    if (t8_mode && cbp > 0) E.dec(399, 0);
  }
  if (coded && (im || cbp > 0 || cbpc > 0)) E.dec(60, 0);
  emit_residual(E, P, mb, hl, ht, im, coded, inter, cbp, cbpc);
  if (mb != nmb - 1) E.put(K_TERM, 0, 0);          // end_of_slice_flag 0
  counts[mb] = E.n;
}

}  // namespace

extern "C" int cabac_i_ops(const int* mode16, const int* modec,
                           const uint8_t* i4_mb, const int* i4_modes,
                           const int* cbp_luma_bits, const int* luma_dc,
                           const int* luma_ac, const int* chroma_dc,
                           const int* chroma_ac, const uint8_t* t8_mb,
                           const int* luma8, const int* dqp,
                           const uint8_t* dqp_pnz, uint32_t* scratch,
                           int* counts, int* offsets, uint32_t* ops, int mb_h,
                           int mb_w, int t8_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  Planes P{mode16, modec, i4_mb, i4_modes, cbp_luma_bits, luma_dc, luma_ac,
           chroma_dc, chroma_ac, t8_mb, luma8, dqp, dqp_pnz, mb_w};
  emit_kernel<<<(nmb + 127) / 128, 128, 0, s>>>(P, mb_h, t8_mode, scratch,
                                                counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, SCAN_NT, 0, s>>>(counts, offsets, nmb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<nmb, 128, 0, s>>>(scratch, counts, offsets, ops);
  return (int)cudaGetLastError();
}

// K8 in two calls, so that K17 can run between them under AQ: pass A,
// then pass B with the scan and scatter
// ref_sel: each MB's reference under two references, else null
extern "C" int cabac_p_maps(const uint8_t* intra_mb, const int* me_mv,
                            const int* ptype, const int* mv_quad,
                            const int* cbp_luma_bits, const int* cbp_chroma,
                            const int* luma_blocks, const uint8_t* t8_sel,
                            const int* luma8, const int* ref_sel,
                            uint8_t* skip, int* mv, int* mvd, int* mvd1,
                            int* ptype_o, int* mv_sub, int* mvd_sub,
                            int* mvd4, int* nnz4, int* ref4, int* mv4,
                            uint8_t* t8_mb, int* ref_idx, int mb_h, int mb_w,
                            void* stream) {
  const int nmb = mb_h * mb_w;
  MvMaps M{intra_mb, ptype, mv_quad, mb_h, mb_w, ref_sel};
  p_maps_kernel<<<(nmb + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      M, me_mv, cbp_luma_bits, cbp_chroma, luma_blocks, t8_sel, luma8, skip,
      mv, mvd, mvd1, ptype_o, mv_sub, mvd_sub, mvd4, nnz4, ref4, mv4, t8_mb,
      ref_idx);
  return (int)cudaGetLastError();
}

extern "C" int cabac_p_emit(const uint8_t* intra_mb, const uint8_t* skip,
                            const int* ptype_o, const int* mode16,
                            const int* modec, const int* cbp_luma_bits,
                            const int* cbp_chroma, const int* luma_dc,
                            const int* luma_blocks, const int* chroma_dc,
                            const int* chroma_ac, const int* mvd,
                            const int* mvd1, const int* mvd_sub,
                            const int* mvd4, const int* nnz4,
                            const uint8_t* t8_mb, const int* luma8,
                            const int* dqp, const uint8_t* dqp_pnz,
                            const int* ref4, const int* ref_idx,
                            uint32_t* scratch, int* counts, int* offsets,
                            uint32_t* ops, int mb_h, int mb_w, int t8_mode,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w;
  PPlanes P{intra_mb, skip, ptype_o, mode16, modec, cbp_luma_bits, cbp_chroma,
            luma_dc, luma_blocks, chroma_dc, chroma_ac, mvd, mvd1, mvd_sub,
            mvd4, nnz4, t8_mb, luma8, dqp, dqp_pnz, mb_w, ref4, ref_idx};
  p_emit_kernel<<<(nmb + 127) / 128, 128, 0, s>>>(P, mb_h, t8_mode, scratch,
                                                  counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, SCAN_NT, 0, s>>>(counts, offsets, nmb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<nmb, 128, 0, s>>>(scratch, counts, offsets, ops);
  return (int)cudaGetLastError();
}

// K24's pass A alone (the CAVLC B slice's maps)
extern "C" int cabac_b_maps(const uint8_t* intra_mb, const uint8_t* direct_mb,
                            const int* bmode, const int* r0, const int* r1,
                            const int* m0, const int* m1,
                            const int* cbp_luma_bits, const int* cbp_chroma,
                            const int* luma_blocks, uint8_t* use_l0,
                            uint8_t* use_l1, int* mvd_l0, int* mvd_l1,
                            int* mvd4_l0, int* mvd4_l1, uint8_t* skip,
                            int* nnz4, int* ref4, int* mv4, int* ref4_l1,
                            int* mv4_l1, int mb_h, int mb_w, void* stream) {
  const int nmb = mb_h * mb_w;
  b_maps_kernel<<<(nmb + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      intra_mb, direct_mb, bmode, r0, r1, m0, m1, cbp_luma_bits, cbp_chroma,
      luma_blocks, use_l0, use_l1, mvd_l0, mvd_l1, mvd4_l0, mvd4_l1, skip,
      nnz4, ref4, mv4, ref4_l1, mv4_l1, mb_h, mb_w);
  return (int)cudaGetLastError();
}

// K24: pass A, pass B, scan, scatter
extern "C" int cabac_b_ops(const uint8_t* intra_mb, const uint8_t* direct_mb,
                           const int* bmode, const int* r0, const int* r1,
                           const int* m0, const int* m1,
                           const int* cbp_luma_bits, const int* cbp_chroma,
                           const int* luma_blocks, const int* mode16,
                           const int* modec, const int* luma_dc,
                           const int* chroma_dc, const int* chroma_ac,
                           uint8_t* use_l0, uint8_t* use_l1, int* mvd_l0,
                           int* mvd_l1, int* mvd4_l0, int* mvd4_l1,
                           uint8_t* skip, int* nnz4, int* ref4, int* mv4,
                           int* ref4_l1, int* mv4_l1, uint32_t* scratch,
                           int* counts, int* offsets, uint32_t* ops, int mb_h,
                           int mb_w, int t8_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nmb = mb_h * mb_w, grid = (nmb + 127) / 128;
  b_maps_kernel<<<grid, 128, 0, s>>>(
      intra_mb, direct_mb, bmode, r0, r1, m0, m1, cbp_luma_bits, cbp_chroma,
      luma_blocks, use_l0, use_l1, mvd_l0, mvd_l1, mvd4_l0, mvd4_l1, skip,
      nnz4, ref4, mv4, ref4_l1, mv4_l1, mb_h, mb_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  PPlanes P{intra_mb, skip, nullptr, mode16, modec, cbp_luma_bits, cbp_chroma,
            luma_dc, luma_blocks, chroma_dc, chroma_ac, nullptr, nullptr,
            nullptr, nullptr, nnz4, nullptr, nullptr, nullptr, nullptr, mb_w};
  b_emit_kernel<<<grid, 128, 0, s>>>(P, direct_mb, bmode, use_l0, use_l1,
                                     mvd_l0, mvd_l1, mvd4_l0, mvd4_l1, mb_h,
                                     t8_mode, scratch, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, SCAN_NT, 0, s>>>(counts, offsets, nmb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<nmb, 128, 0, s>>>(scratch, counts, offsets, ops);
  return (int)cudaGetLastError();
}

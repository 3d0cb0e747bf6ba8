// K2 deblock_diag: the in-loop deblocking filter of a frame, in one
// launch.
//
// Replaces x264_tpu/ops/deblock.py:deblock_frame (_strengths,
// _edge_params, _luma_filter, _chroma_filter and the wavefront scan).
// Plain twin: x264_tpu_torch/ops/deblock.py deblock_frame_plain;
// wrapper: deblock_frame.
//
// Design. One launch filters the recon planes in place: one a frame, or
// one a band and frame on the row-band path. Each CTA claims an MB row by
// atomicAdd on a ticket (never by blockIdx), walks it from left to right,
// then claims the next. MB (x, y) starts its top edge only when row y-1
// has finished MB min(x+1, mb_w-1): MB (x+1, y-1)'s left-edge filter
// rewrites columns 13-15 of MB (x, y-1), bottom rows included, which MB
// (x, y)'s top edge reads and rewrites (column 7 in chroma). That is the
// partial order of the slope-2 diagonals d = x + 2y, whose MBs touch
// disjoint pixels, so every pixel sees the filter operations of raster
// order in raster order and the planes are bit-equal to the plain
// version's. A row's predecessor was claimed by a CTA that is already
// running, so the wavefront cannot deadlock whatever order the CTAs start
// in, and needs no cooperative launch.
// Each row's progress (MBs finished) is an int32 counter; the entry point
// clears the counters and the ticket with cudaMemsetAsync on the launch's
// stream. To publish an MB the filtering warp syncs and one lane makes a
// release store of the counter (fence.acq_rel, then the store: the
// pattern of CUTLASS's GenericBarrier); to wait, one lane spins on an
// acquire load, then the warp syncs. L1 is not coherent across SMs, and a
// 128-byte line of an int32 plane spans the luma columns of two MBs, so
// every load and store of the planes goes through L2 (__ldcg, __stcg).
// A CTA is two warps. Warp 1 stages the next MB: its 48 edges' bS and
// alpha / beta / tc0 from the maps (every map load issued at once) and
// its 16x16 luma and two 8x8 chroma blocks, into the third of three
// shared tiles. Warp 0 filters the current MB in its tile: the left
// neighbour's right four columns come from the previous MB's tile,
// the vertical edges touch only row y and run before the wait; after it
// the rows above (4 luma, 2 chroma) are loaded, the horizontal edges run,
// and the MB goes back. An MB's right four columns go back after the next
// MB's left edge (or at the row's end): each pixel is written once a row.
// In warp 0, lanes 0-15 own one luma line each, lanes 16-31 one chroma
// line (8 of U, 8 of V): a line's four (two) vertical edges depend on
// nothing else, so each lane filters them in order; then each lane
// filters the horizontal edges of one column. With a t8_mb map the luma
// edges 1 and 3 inside an MB coded with the 8x8 transform take bS 0
// (spec 8.7); in a B slice (the L1 maps given) an edge also takes bS 1
// where the two sides' L1 references or L1 MVs differ (deblock.py:
// _strengths with is_b). bS follows DEBLOCK_STRENGTH (common/frame.c:
// 697-742), so the P slice reuses the kernel.
//
// What bounds it on the H100: the serial depth. A row's MBs follow one
// another and each row trails the one above by two MBs, so a frame is
// about mb_w + mb_h MB steps of one warp plus mb_h hand-overs between
// rows (254 steps in all at 1080p): each step its vertical edges, an L2
// round trip for the rows above, the horizontal edges and the store and
// release; each hand-over the counter's trip through L2. The bytes (the
// three planes read and written once, ~25 MB at 1080p as int32) would
// take ~8 us.
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 64;   // warp 0 filters, warp 1 stages the next MB
constexpr int LS = 21;   // luma tile: rows -4..15, columns -4..15 of the MB
constexpr int CS = 13;   // chroma tiles: rows -2..7, columns -4..7

struct Tabs {            // deblock.py:_deblock_tab
  int alpha[52], beta[52], tc0[52][4], chroma_qp[52];
};

__device__ __forceinline__ int clip3(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// one list's refs or MVs differ across the edge p | q
__device__ __forceinline__ bool mv_differ(const int* ref4, const int* mv4,
                                          int p, int q) {
  const int2 a = __ldg(reinterpret_cast<const int2*>(mv4) + p);
  const int2 b = __ldg(reinterpret_cast<const int2*>(mv4) + q);
  return (__ldg(ref4 + p) != __ldg(ref4 + q)) | (abs(a.x - b.x) >= 4) |
         (abs(a.y - b.y) >= 4);
}

// the per-4x4 maps bS reads; ref4_l1 / mv4_l1 null outside B slices
struct Maps {
  const uint8_t* intra_mb;
  const int *nnz4, *ref4, *mv4, *ref4_l1, *mv4_l1;
};

// bS of the edge between 4x4 blocks p (left / above) and q; every load
// first, so that they go out together
__device__ int strength(const Maps& M, int W4, int mb_w, int py, int px,
                        int qy, int qx, bool mb_edge) {
  const int p = py * W4 + px, q = qy * W4 + qx;
  const int intra = __ldg(M.intra_mb + (py >> 2) * mb_w + (px >> 2)) |
                    __ldg(M.intra_mb + (qy >> 2) * mb_w + (qx >> 2));
  const int nz = __ldg(M.nnz4 + p) | __ldg(M.nnz4 + q);
  bool mvd = mv_differ(M.ref4, M.mv4, p, q);
  if (M.ref4_l1 != nullptr) mvd = mvd | mv_differ(M.ref4_l1, M.mv4_l1, p, q);
  return intra ? (mb_edge ? 4 : 3) : nz ? 2 : mvd ? 1 : 0;
}

// filter one luma line across an edge: s[k * step] for k = -4..3 holds
// p3 p2 p1 p0 q0 q1 q2 q3 (deblock.py:_luma_filter)
__device__ void luma_line(int* s, int step, int bs, int tc0, int alpha,
                          int beta) {
  int p3 = s[-4 * step], p2 = s[-3 * step], p1 = s[-2 * step], p0 = s[-step];
  int q0 = s[0], q1 = s[step], q2 = s[2 * step], q3 = s[3 * step];
  if (!(bs > 0 && abs(p0 - q0) < alpha && abs(p1 - p0) < beta &&
        abs(q1 - q0) < beta))
    return;
  bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  if (bs == 4) {
    bool shrt = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (shrt && ap) {
      s[-3 * step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
      s[-2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
      s[-step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
    } else {
      s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (shrt && aq) {
      s[0] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      s[step] = (p0 + q0 + q1 + q2 + 2) >> 2;
      s[2 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  int avg01 = (p0 + q0 + 1) >> 1;
  int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
  int delta = clip3((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
  if (ap) s[-2 * step] = p1 + clip3(((p2 + avg01) >> 1) - p1, -tc0, tc0);
  if (aq) s[step] = q1 + clip3(((q2 + avg01) >> 1) - q1, -tc0, tc0);
  s[-step] = clip255(p0 + delta);
  s[0] = clip255(q0 - delta);
}

// one chroma line [p1 p0 q0 q1] at s[-2 * step .. step]; tc includes +1
__device__ void chroma_line(int* s, int step, int bs, int tc, int alpha,
                            int beta) {
  int p1 = s[-2 * step], p0 = s[-step], q0 = s[0], q1 = s[step];
  if (!(bs > 0 && abs(p0 - q0) < alpha && abs(p1 - p0) < beta &&
        abs(q1 - q0) < beta))
    return;
  if (bs == 4) {
    s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    int delta = clip3((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    s[-step] = clip255(p0 + delta);
    s[0] = clip255(q0 - delta);
  }
}

// the row counters: an acquire load and a release store at GPU scope
// (the #else branch is what a host-side parse of the source sees)
__device__ __forceinline__ int load_acquire(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return *(const volatile int*)p;
#endif
}

__device__ __forceinline__ void store_release(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
#else
  *(volatile int*)p = v;
#endif
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return __ldcg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ void st4(int* p, const int* s) {
  __stcg(reinterpret_cast<int4*>(p), make_int4(s[0], s[1], s[2], s[3]));
}

__device__ __forceinline__ void put4(int* s, int4 v) {
  s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
}

// an edge's bS, alpha, beta and tc0
struct __align__(16) Edge {
  int bs, alpha, beta, tc0;
};

// The 48 edges of an MB: luma vertical [seg][e] (0-15), luma horizontal
// [seg][e] (16-31), chroma vertical [seg][e] (32-39), chroma horizontal
// [seg][e] (40-47); seg the 4x4 row (column) of the lines it crosses.
__device__ __forceinline__ Edge mb_edge(int i, const Maps& M,
                                        const int* __restrict__ qp_mb,
                                        const Tabs* T,
                                        const uint8_t* __restrict__ t8_mb,
                                        int mb_w, int mx, int my,
                                        int alpha_off, int beta_off,
                                        int cqp_off) {
  const bool luma = i < 32, vert = luma ? i < 16 : i < 40;
  const int j = luma ? i & 15 : i & 7;
  const int seg = luma ? j >> 2 : j >> 1, e = luma ? j & 3 : j & 1;
  const int k4 = luma ? e : 2 * e;        // the edge's 4x4 column / row
  const int qy4 = 4 * my + (vert ? seg : k4), qx4 = 4 * mx + (vert ? k4 : seg);
  const int py4 = vert ? qy4 : qy4 - 1, px4 = vert ? qx4 - 1 : qx4;
  const int mb = my * mb_w + mx;
  // the inner luma edges 1 and 3 of an 8x8-transform MB are not filtered
  const bool skip = (vert ? qx4 : qy4) == 0 ||
                    (luma && (e & 1) && t8_mb != nullptr && t8_mb[mb]);
  const int bs = skip ? 0 : strength(M, 4 * mb_w, mb_w, py4, px4, qy4, qx4, e == 0);
  int qpq = qp_mb[mb];
  int qpp = e > 0 ? qpq : vert ? (mx > 0 ? qp_mb[mb - 1] : qpq)
                               : (my > 0 ? qp_mb[mb - mb_w] : qpq);
  if (!luma) {
    qpp = T->chroma_qp[clip3(qpp + cqp_off, 0, 51)];
    qpq = T->chroma_qp[clip3(qpq + cqp_off, 0, 51)];
  }
  // alpha / beta / tc0 of the edge's side QPs (_edge_params)
  const int avg = (qpp + qpq + 1) >> 1, ia = clip3(avg + alpha_off, 0, 51);
  return Edge{bs, T->alpha[ia], T->beta[clip3(avg + beta_off, 0, 51)],
              T->tc0[ia][min(bs, 3)]};
}

// prog: mb_h row counters (MBs finished), then the row ticket; zero at
// the launch
__global__ void __launch_bounds__(NT) deblock_diag_kernel(
    int* Y, int* U, int* V, const int* __restrict__ qp_mb, const Maps M,
    const int* __restrict__ tabs_g, const uint8_t* __restrict__ t8_mb,
    int* prog, int mb_h, int mb_w, int alpha_off, int beta_off,
    int cqp_off) {
  // three tiles, MB x in tile x % 3: luma rows -4..15 x columns -4..15,
  // chroma rows -2..7 x columns -4..7, and their edges. While warp 0
  // filters MB x and reads the right columns of MB x-1, warp 1 stages MB
  // x+1 in the third tile.
  __shared__ int ly[3][20][LS];
  __shared__ int lc[3][2][10][CS];
  __shared__ Edge ep[3][48];
  __shared__ int row_s;
  const int W = mb_w * 16, Wc = mb_w * 8;
  const int tid = threadIdx.x, lane = tid & 31;
  const Tabs* T = reinterpret_cast<const Tabs*>(tabs_g);

  // warp 1: MB (mx, my)'s edges and samples into tile b; its samples no
  // other CTA writes before it
  auto prepare = [&](int mx, int my, int b) {
    int4 vy[2], vc;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k, r = i >> 2, q = i & 3;
      vy[k] = ld4(Y + (size_t)(16 * my + r) * W + 16 * mx + 4 * q);
    }
    vc = ld4((lane >> 4 ? V : U) + (size_t)(8 * my + ((lane >> 1) & 7)) * Wc +
             8 * mx + 4 * (lane & 1));
    ep[b][lane] = mb_edge(lane, M, qp_mb, T, t8_mb, mb_w, mx, my, alpha_off,
                          beta_off, cqp_off);
    if (lane < 16)
      ep[b][32 + lane] = mb_edge(32 + lane, M, qp_mb, T, t8_mb, mb_w, mx, my,
                                 alpha_off, beta_off, cqp_off);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k;
      put4(&ly[b][4 + (i >> 2)][4 + 4 * (i & 3)], vy[k]);
    }
    put4(&lc[b][lane >> 4][2 + ((lane >> 1) & 7)][4 + 4 * (lane & 1)], vc);
  };

  for (;;) {
    if (tid == 0) row_s = atomicAdd(prog + mb_h, 1);
    __syncthreads();
    const int my = row_s;
    if (my >= mb_h) break;
    if (tid >= 32) prepare(0, my, 0);
    int seen = 0;                          // warp 0, lane 0: row my-1's count
    for (int mx = 0, b = 0, bl = 2; mx < mb_w; ++mx, bl = b, b = b == 2 ? 0 : b + 1) {
      __syncthreads();                     // MB mx staged, MB mx-1 filtered
      if (tid >= 32) {
        if (mx + 1 < mb_w) prepare(mx + 1, my, b == 2 ? 0 : b + 1);
        continue;
      }
      // warp 0 filters MB mx. Lane l < 16: luma line (and column) l;
      // lane 16 + l: chroma line l & 7 of plane l >> 3
      const bool luma = lane < 16;
      const int pl = (lane >> 3) & 1, l = luma ? lane : lane & 7;
      const int seg = luma ? l >> 2 : l >> 1;
      int* const P = pl ? V : U;
      // the left strip: the previous MB's right four columns (tile bl)
      if (mx > 0) {
        for (int i = lane; i < 64; i += 32) {
          const int r = i >> 2, c = i & 3;
          ly[b][4 + r][c] = ly[bl][4 + r][16 + c];
          lc[b][i >> 5][2 + ((i >> 2) & 7)][c] = lc[bl][i >> 5][2 + ((i >> 2) & 7)][8 + c];
        }
      }
      __syncwarp();

      // the vertical edges: they touch row y alone
      if (luma) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Edge g = ep[b][4 * seg + e];
          luma_line(&ly[b][4 + l][4 + 4 * e], 1, g.bs, g.tc0, g.alpha, g.beta);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Edge g = ep[b][32 + 2 * seg + e];
          chroma_line(&lc[b][pl][2 + l][4 + 4 * e], 1, g.bs, g.tc0 + 1, g.alpha, g.beta);
        }
      }
      __syncwarp();
      // the previous MB's right four columns are final for this row
      if (mx > 0) {
        if (luma) st4(Y + (size_t)(16 * my + l) * W + 16 * mx - 4, &ly[b][4 + l][0]);
        else st4(P + (size_t)(8 * my + l) * Wc + 8 * mx - 4, &lc[b][pl][2 + l][0]);
      }

      // wait for row y-1 to finish MB min(x+1, mb_w-1), then stage the
      // rows above: 4 of luma, 2 of chroma
      if (my > 0) {
        if (lane == 0) {
          const int need = min(mx + 2, mb_w);
          while (seen < need) seen = load_acquire(prog + my - 1);
        }
        __syncwarp();
        if (lane < 16) {
          const int r = lane >> 2, q = lane & 3;
          put4(&ly[b][r][4 + 4 * q], ld4(Y + (size_t)(16 * my - 4 + r) * W + 16 * mx + 4 * q));
        } else if (lane < 24) {
          const int j = lane - 16, r = (j >> 1) & 1, q = j & 1;
          put4(&lc[b][j >> 2][r][4 + 4 * q],
               ld4((j >> 2 ? V : U) + (size_t)(8 * my - 2 + r) * Wc + 8 * mx + 4 * q));
        }
        __syncwarp();
      }

      // the horizontal edges
      if (luma) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Edge g = ep[b][16 + 4 * seg + e];
          luma_line(&ly[b][4 + 4 * e][4 + l], LS, g.bs, g.tc0, g.alpha, g.beta);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Edge g = ep[b][40 + 2 * seg + e];
          chroma_line(&lc[b][pl][2 + 4 * e][4 + l], CS, g.bs, g.tc0 + 1, g.alpha, g.beta);
        }
      }
      __syncwarp();

      // back to the planes: the rows above that the top edge rewrote (3
      // of luma, 1 of chroma), and the MB but its right four columns (all
      // of it at the row's end)
      if (my > 0) {
        if (lane < 12) {
          const int r = 1 + (lane >> 2), q = lane & 3;
          st4(Y + (size_t)(16 * my - 4 + r) * W + 16 * mx + 4 * q, &ly[b][r][4 + 4 * q]);
        } else if (lane < 16) {
          const int j = lane - 12, q = j & 1;
          st4((j >> 1 ? V : U) + (size_t)(8 * my - 1) * Wc + 8 * mx + 4 * q, &lc[b][j >> 1][1][4 + 4 * q]);
        }
      }
      const int nq = mx == mb_w - 1 ? 4 : 3, ncq = mx == mb_w - 1 ? 2 : 1;
      for (int i = lane; i < 16 * nq; i += 32) {
        const int r = i / nq, q = i % nq;
        st4(Y + (size_t)(16 * my + r) * W + 16 * mx + 4 * q, &ly[b][4 + r][4 + 4 * q]);
      }
      if (lane < 16 * ncq) {
        const int p = lane / (8 * ncq), r = (lane / ncq) & 7, q = lane % ncq;
        st4((p ? V : U) + (size_t)(8 * my + r) * Wc + 8 * mx + 4 * q, &lc[b][p][2 + r][4 + 4 * q]);
      }

      // publish the MB to row y+1: the release orders the warp's stores,
      // which __syncwarp ordered before it, ahead of the counter
      __syncwarp();
      if (lane == 0) store_release(prog + my, mx + 1);
    }
  }
}

}  // namespace

extern "C" int deblock_frame(int* y, int* u, int* v, const int* qp_mb,
                             const uint8_t* intra_mb, const int* nnz4,
                             const int* ref4, const int* mv4,
                             const int* ref4_l1, const int* mv4_l1,
                             const int* tabs, const uint8_t* t8_mb, int* wave,
                             int mb_h, int mb_w, int alpha_off, int beta_off,
                             int chroma_qp_offset, void* stream) {
  // wave: the mb_h row counters and the row ticket, cleared on the
  // launch's stream; a CTA a row (each claims its row by the ticket)
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(wave, 0, sizeof(int) * (mb_h + 1), s);
  if (err != cudaSuccess) return (int)err;
  deblock_diag_kernel<<<mb_h, NT, 0, s>>>(
      y, u, v, qp_mb, Maps{intra_mb, nnz4, ref4, mv4, ref4_l1, mv4_l1}, tabs,
      t8_mb, wave, mb_h, mb_w, alpha_off, beta_off, chroma_qp_offset);
  return (int)cudaGetLastError();
}

// K2 deblock_diag: the in-loop deblocking filter of one slope-2 diagonal.
//
// Replaces x264_tpu/ops/deblock.py:deblock_frame (_strengths,
// _edge_params, _luma_filter, _chroma_filter and the wavefront scan).
// Plain twin: x264_tpu_torch/ops/deblock.py deblock_frame_plain;
// wrapper: deblock_frame.
//
// Design. The host launches this kernel once per diagonal d = x + 2y
// (254 launches at 1080p), one CTA of one warp per MB on the diagonal;
// it filters the recon planes in place. The x + 2y order is the widest
// that keeps raster semantics: MB (x, y)'s top-edge filter reads the
// columns MB (x+1, y-1)'s left-edge filter wrote on diagonal d - 1, and
// the MBs of one diagonal touch disjoint pixels. Threads 0-15 own one
// luma line each, threads 16-31 one chroma line (8 of U, 8 of V): a
// line's four (two) vertical edges depend on nothing else, so each
// thread filters them in order, the warp syncs, and then each thread
// filters the horizontal edges of one column. The kernel derives bS and
// alpha / beta / tc0 itself from the per-4x4 qp / intra / nnz / ref / mv
// maps (DEBLOCK_STRENGTH, common/frame.c:697-742), so the P slice reuses
// it. With a t8_mb map the luma edges 1 and 3 inside an MB coded with the
// 8x8 transform take bS 0 (spec 8.7); the B-slice rules are rejected by
// the wrapper.
//
// What bounds it on the H100: the serial depth of 254 dependent
// launches of at most 68 one-warp CTAs; the bytes (the three planes read
// and written once, ~25 MB at 1080p as int32) would take ~8 us.
#include "common.cuh"

using namespace x264t;

namespace {

constexpr int NT = 32;

struct Tabs {            // deblock.py:_deblock_tab
  int alpha[52], beta[52], tc0[52][4], chroma_qp[52];
};

__device__ __forceinline__ int clip3(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// bS of the edge between 4x4 blocks p (left / above) and q
__device__ int strength(const uint8_t* intra_mb, const int* nnz4,
                        const int* ref4, const int* mv4, int W4, int mb_w,
                        int py, int px, int qy, int qx, bool mb_edge) {
  bool intra = intra_mb[(py >> 2) * mb_w + (px >> 2)] ||
               intra_mb[(qy >> 2) * mb_w + (qx >> 2)];
  if (intra) return mb_edge ? 4 : 3;
  int p = py * W4 + px, q = qy * W4 + qx;
  if (nnz4[p] != 0 || nnz4[q] != 0) return 2;
  if (ref4[p] != ref4[q] || abs(mv4[2 * p] - mv4[2 * q]) >= 4 ||
      abs(mv4[2 * p + 1] - mv4[2 * q + 1]) >= 4)
    return 1;
  return 0;
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

__global__ void __launch_bounds__(NT) deblock_diag_kernel(
    int* Y, int* U, int* V, const int* __restrict__ qp_mb,
    const uint8_t* __restrict__ intra_mb, const int* __restrict__ nnz4,
    const int* __restrict__ ref4, const int* __restrict__ mv4,
    const int* __restrict__ tabs_g, const uint8_t* __restrict__ t8_mb,
    int mb_w, int d, int y0, int alpha_off, int beta_off, int cqp_off) {
  const int my = y0 + blockIdx.x;
  const int mx = d - 2 * my;
  const int W = mb_w * 16, Wc = mb_w * 8, W4 = mb_w * 4;
  const int tid = threadIdx.x;
  const Tabs* T = reinterpret_cast<const Tabs*>(tabs_g);
  const int qp_q = qp_mb[my * mb_w + mx];
  const int qp_left = mx > 0 ? qp_mb[my * mb_w + mx - 1] : qp_q;
  const int qp_top = my > 0 ? qp_mb[(my - 1) * mb_w + mx] : qp_q;
  // the inner luma edges 1 and 3 of an 8x8-transform MB are not filtered
  const bool t8 = t8_mb != nullptr && t8_mb[my * mb_w + mx];

  // alpha / beta / tc0 of an edge with side QPs qp_p, qp_q (_edge_params)
  auto params = [&](int qpp, int qpq, int bs, int& alpha, int& beta, int& tc0) {
    int avg = (qpp + qpq + 1) >> 1;
    int ia = clip3(avg + alpha_off, 0, 51);
    alpha = T->alpha[ia];
    beta = T->beta[clip3(avg + beta_off, 0, 51)];
    tc0 = T->tc0[ia][min(bs, 3)];
  };
  auto cqp = [&](int qp) { return T->chroma_qp[clip3(qp + cqp_off, 0, 51)]; };

  for (int dir = 0; dir < 2; ++dir) {           // 0: vertical edges, 1: horizontal
    if (tid < 16) {
      const int l = tid, seg = l >> 2;
      for (int e = 0; e < 4; ++e) {
        int qy4, qx4, py4, px4, qpp;
        int* s;
        int step;
        if (dir == 0) {
          qy4 = 4 * my + seg; qx4 = 4 * mx + e; py4 = qy4; px4 = qx4 - 1;
          if (qx4 == 0) continue;
          qpp = e == 0 ? qp_left : qp_q;
          s = Y + (16 * my + l) * W + 16 * mx + 4 * e;
          step = 1;
        } else {
          qy4 = 4 * my + e; qx4 = 4 * mx + seg; py4 = qy4 - 1; px4 = qx4;
          if (qy4 == 0) continue;
          qpp = e == 0 ? qp_top : qp_q;
          s = Y + (16 * my + 4 * e) * W + 16 * mx + l;
          step = W;
        }
        int bs = (t8 && (e & 1)) ? 0
            : strength(intra_mb, nnz4, ref4, mv4, W4, mb_w, py4, px4, qy4, qx4,
                       e == 0);
        int alpha, beta, tc0;
        params(qpp, qp_q, bs, alpha, beta, tc0);
        luma_line(s, step, bs, tc0, alpha, beta);
      }
    } else {
      const int c = tid - 16, l = c & 7, seg = l >> 1;
      int* P = c < 8 ? U : V;
      for (int e = 0; e < 2; ++e) {
        int qy4, qx4, py4, px4, qpp;
        int* s;
        int step;
        if (dir == 0) {
          qy4 = 4 * my + seg; qx4 = 4 * mx + 2 * e; py4 = qy4; px4 = qx4 - 1;
          if (qx4 == 0) continue;
          qpp = e == 0 ? qp_left : qp_q;
          s = P + (8 * my + l) * Wc + 8 * mx + 4 * e;
          step = 1;
        } else {
          qy4 = 4 * my + 2 * e; qx4 = 4 * mx + seg; py4 = qy4 - 1; px4 = qx4;
          if (qy4 == 0) continue;
          qpp = e == 0 ? qp_top : qp_q;
          s = P + (8 * my + 4 * e) * Wc + 8 * mx + l;
          step = Wc;
        }
        int bs = strength(intra_mb, nnz4, ref4, mv4, W4, mb_w, py4, px4, qy4,
                          qx4, e == 0);
        int alpha, beta, tc0;
        params(cqp(qpp), cqp(qp_q), bs, alpha, beta, tc0);
        chroma_line(s, step, bs, tc0 + 1, alpha, beta);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int deblock_diag(int* y, int* u, int* v, const int* qp_mb,
                            const uint8_t* intra_mb, const int* nnz4,
                            const int* ref4, const int* mv4, const int* tabs,
                            const uint8_t* t8_mb, int mb_h, int mb_w, int d,
                            int alpha_off,
                            int beta_off, int chroma_qp_offset, void* stream) {
  // MBs with x = d - 2y in [0, mb_w)
  const int y0 = max(0, (d - (mb_w - 1) + 1) / 2), y1 = min(mb_h - 1, d / 2);
  if (y1 < y0) return 0;
  deblock_diag_kernel<<<y1 - y0 + 1, NT, 0, (cudaStream_t)stream>>>(
      y, u, v, qp_mb, intra_mb, nnz4, ref4, mv4, tabs, t8_mb, mb_w, d, y0,
      alpha_off,
      beta_off, chroma_qp_offset);
  return (int)cudaGetLastError();
}

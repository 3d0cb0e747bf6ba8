// K28 halo_extend: one MB-row band's padded reference planes.
//
// Replaces the device half of x264_tpu/parallel/rows.py:_halo_extend
// (rows.py:57) and _ext_refs (rows.py:154): a band's luma plane (band*16
// rows, W columns) gets 32 rows above and below from its neighbour bands
// (their last / first 32 rows, the strips its caller copied over), edge
// replicated where there is no neighbour (band 0's top, the last band's
// bottom), and 32 edge-replicated columns left and right; each chroma
// plane the same with 16. The result is the (band*16 + 64) x (W + 64)
// luma and (band*8 + 32) x (W/2 + 32) chroma planes that the P and B
// fronts read as their prepadded reference (encoder/inter.py,
// ref_prepadded). Plain twin: x264_tpu_torch/parallel/rows.py:
// halo_extend_plain; wrapper: halo_extend.
//
// Design: one launch for the three planes of one reference (blockIdx.z),
// one CTA row per output row (blockIdx.y), whose source row (own, strip or
// edge) is chosen once; threads walk the columns with the column clamp.
// Every read of a row is coalesced, every write too.
// What bounds it on the H100: bytes. It writes the padded planes (int32,
// 4 B a sample) and reads the band and the strips: at 1080p a band of 17
// MB rows, ~4.0 MB written and ~3.9 MB read, ~2.4 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

struct Plane {
  const int* src;     // (hb, w)
  const int* above;   // (h, w), or null: replicate src's first row
  const int* below;   // (h, w), or null: replicate src's last row
  int* out;           // (hb + 2h, w + 2h)
  int hb, w, h;
};

__global__ void halo_kernel(Plane p0, Plane p1, Plane p2) {
  const Plane p = blockIdx.z == 0 ? p0 : (blockIdx.z == 1 ? p1 : p2);
  const int ow = p.w + 2 * p.h, oh = p.hb + 2 * p.h;
  const int r = blockIdx.y;
  if (r >= oh) return;
  const int* row;
  if (r < p.h) {
    row = p.above ? p.above + (size_t)r * p.w : p.src;
  } else if (r >= p.h + p.hb) {
    const int rr = r - p.h - p.hb;
    row = p.below ? p.below + (size_t)rr * p.w
                  : p.src + (size_t)(p.hb - 1) * p.w;
  } else {
    row = p.src + (size_t)(r - p.h) * p.w;
  }
  int* out = p.out + (size_t)r * ow;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < ow;
       c += gridDim.x * blockDim.x)
    out[c] = row[min(max(c - p.h, 0), p.w - 1)];
}

}  // namespace

// the luma plane (hb rows, w columns, halo h) and the two chroma planes
// (hb / 2, w / 2, h / 2); a null above / below strip means the frame edge
extern "C" int halo_extend(const int* y, const int* ya, const int* yb,
                           int* yo, const int* u, const int* ua,
                           const int* ub, int* uo, const int* v,
                           const int* va, const int* vb, int* vo, int hb,
                           int w, int h, void* stream) {
  Plane py{y, ya, yb, yo, hb, w, h};
  Plane pu{u, ua, ub, uo, hb / 2, w / 2, h / 2};
  Plane pv{v, va, vb, vo, hb / 2, w / 2, h / 2};
  const int threads = 256;
  dim3 grid((w + 2 * h + threads - 1) / threads, hb + 2 * h, 3);
  halo_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(py, pu, pv);
  return (int)cudaGetLastError();
}

"""Encoder statistics — per-frame and global PSNR / SSIM / bitrate / MB
accounting (x264_t.stat, common/common.h:560-614; accumulation at
encoder/encoder.c:1034-1056; final report x264_encoder_close:1878-2080),
and the frame metrics: the plain PyTorch version and the wrapper of its
Triton kernel (kernel K4).
"""

from __future__ import annotations

import math

import torch

from .. import cuda
from ..ops import pixel as opix

I32 = torch.int32
F32 = torch.float32


def frame_metrics_plain(oy, ou, ov, ry, ru, rv, w: int, h: int):
    """Plain version of K4: SSD of Y / U / V over the w x h output crop
    (exact int64 sums, then float32) and the x264 SSIM sum over the
    (2, 2)-offset luma region. Returns a float32 tensor of 4."""
    def ssd(a, b, ww, hh):
        d = a[:hh, :ww].to(I32) - b[:hh, :ww].to(I32)
        return (d * d).sum(dtype=torch.int64).to(F32)

    ssim = opix.ssim_sum(oy[2:h, 2:w], ry[2:h, 2:w]).to(F32)
    return torch.stack([ssd(oy, ry, w, h), ssd(ou, ru, w // 2, h // 2),
                        ssd(ov, rv, w // 2, h // 2), ssim])


# ---------------------------------------------------------------- K4
_SSD_BR, _SSD_BC = 32, 64        # SSD tile (rows, cols)
_SSIM_BR, _SSIM_BC = 8, 64       # SSIM tile of 8x8-window positions


def _kernels():
    """The Triton kernels of K4, defined on first use: Triton is imported
    only where a card is."""
    import triton
    import triton.language as tl

    @triton.jit
    def ssd_kernel(a_ptr, b_ptr, part_ptr, part_off, h, w, stride,
                   BR: tl.constexpr, BC: tl.constexpr):
        pr, pc = tl.program_id(0), tl.program_id(1)
        r = pr * BR + tl.arange(0, BR)[:, None]
        c = pc * BC + tl.arange(0, BC)[None, :]
        m = (r < h) & (c < w)
        a = tl.load(a_ptr + r * stride + c, mask=m, other=0)
        b = tl.load(b_ptr + r * stride + c, mask=m, other=0)
        d = a - b
        s = tl.sum(tl.sum((d * d).to(tl.int64), axis=1), axis=0)
        tl.store(part_ptr + part_off + pr * tl.num_programs(1) + pc, s)

    @triton.jit
    def ssim_kernel(a_ptr, b_ptr, part_ptr, nh, nw, stride, C1, C2,
                    BR: tl.constexpr, BC: tl.constexpr):
        # position (i, j) sums the 8x8 window at (2 + 4i, 2 + 4j): the
        # four 4x4 block sums of ssim_4x4x2_core, as ssim_end1 adds them
        pr, pc = tl.program_id(0), tl.program_id(1)
        i = pr * BR + tl.arange(0, BR)[:, None]
        j = pc * BC + tl.arange(0, BC)[None, :]
        m = (i < nh) & (j < nw)
        base = (2 + 4 * i) * stride + 2 + 4 * j
        s1 = tl.zeros((BR, BC), tl.int32)
        s2 = tl.zeros((BR, BC), tl.int32)
        ss = tl.zeros((BR, BC), tl.int32)
        s12 = tl.zeros((BR, BC), tl.int32)
        for dy in tl.static_range(8):
            for dx in tl.static_range(8):
                a = tl.load(a_ptr + base + dy * stride + dx, mask=m, other=0)
                b = tl.load(b_ptr + base + dy * stride + dx, mask=m, other=0)
                s1 += a
                s2 += b
                ss += a * a + b * b
                s12 += a * b
        vars_ = ss * 64 - s1 * s1 - s2 * s2
        covar = s12 * 64 - s1 * s2
        num = (2 * s1 * s2 + C1).to(tl.float32) \
            * (2 * covar + C2).to(tl.float32)
        den = (s1 * s1 + s2 * s2 + C1).to(tl.float32) \
            * (vars_ + C2).to(tl.float32)
        val = tl.where(m, num / den, 0.0)
        s = tl.sum(tl.sum(val, axis=1), axis=0)
        tl.store(part_ptr + pr * tl.num_programs(1) + pc, s)

    @triton.jit
    def range_sum(ptr, n, zero, B: tl.constexpr):
        k = tl.arange(0, B)
        acc = tl.zeros((B,), zero.dtype)
        for s in range(0, n, B):
            acc += tl.load(ptr + s + k, mask=s + k < n, other=0)
        return tl.sum(acc, axis=0)

    @triton.jit
    def reduce_kernel(ssd_ptr, n_y, n_u, n_v, ssim_ptr, n_s, out_ptr,
                      B: tl.constexpr):
        z64 = tl.zeros((1,), tl.int64)
        tl.store(out_ptr + 0, range_sum(ssd_ptr, n_y, z64, B).to(tl.float32))
        tl.store(out_ptr + 1,
                 range_sum(ssd_ptr + n_y, n_u, z64, B).to(tl.float32))
        tl.store(out_ptr + 2, range_sum(ssd_ptr + n_y + n_u, n_v, z64,
                                        B).to(tl.float32))
        tl.store(out_ptr + 3,
                 range_sum(ssim_ptr, n_s, tl.zeros((1,), tl.float32), B))

    return ssd_kernel, ssim_kernel, reduce_kernel


_KERNELS = []


def frame_metrics(oy, ou, ov, ry, ru, rv, w: int, h: int):
    """K4 `frame_metrics`: SSD of the three planes and the SSIM sum.

    Replaces the metric half of x264_tpu/encoder/pipeline.py:host32_pack
    (with ops/pixel.py:ssim_sum). On CUDA tensors it runs three Triton
    kernels (per-tile SSD partials in int64 for the three planes, per-tile
    SSIM partials, one reduction: five launches); on CPU tensors the
    plain version. Inputs are int32 (H, W) / (H/2, W/2) planes, the crop
    w x h. Returns float32 (4,) = (ssd_y, ssd_u, ssd_v, ssim_sum)."""
    if oy.device.type == "cpu":
        return frame_metrics_plain(oy, ou, ov, ry, ru, rv, w, h)
    import triton

    for name, t in (("oy", oy), ("ou", ou), ("ov", ov), ("ry", ry),
                    ("ru", ru), ("rv", rv)):
        ref = oy if name.endswith("y") else ou
        cuda.check(t, tuple(ref.shape), I32, name)
    if not _KERNELS:
        _KERNELS.extend(_kernels())
    ssd_k, ssim_k, red_k = _KERNELS
    dev = oy.device
    grids = [(triton.cdiv(hh, _SSD_BR), triton.cdiv(ww, _SSD_BC))
             for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    ns = [g[0] * g[1] for g in grids]
    ssd_parts = torch.empty(sum(ns), dtype=torch.int64, device=dev)
    off = 0
    for (a, b, hh, ww), g, n in zip(((oy, ry, h, w), (ou, ru, h // 2, w // 2),
                                     (ov, rv, h // 2, w // 2)), grids, ns):
        ssd_k[g](a, b, ssd_parts, off, hh, ww, a.stride(0),
                 BR=_SSD_BR, BC=_SSD_BC)
        off += n
    nh, nw = (h - 2) // 4 - 1, (w - 2) // 4 - 1
    sg = (triton.cdiv(nh, _SSIM_BR), triton.cdiv(nw, _SSIM_BC))
    ssim_parts = torch.empty(sg[0] * sg[1], dtype=F32, device=dev)
    ssim_k[sg](oy, ry, ssim_parts, nh, nw, oy.stride(0), opix.SSIM_C1,
               opix.SSIM_C2, BR=_SSIM_BR, BC=_SSIM_BC)
    out = torch.empty(4, dtype=F32, device=dev)
    red_k[(1,)](ssd_parts, ns[0], ns[1], ns[2], ssim_parts, ssim_parts.numel(),
                out, B=1024)
    frame_metrics.launches += 5
    return out


frame_metrics.launches = 0


def psnr(sqe: float, size: float) -> float:
    """x264_psnr (encoder/encoder.c:60)."""
    if sqe <= 0:
        return 99.99
    return 10.0 * math.log10(65025.0 * size / sqe)


class Stats:
    """Aggregates what the reference logs per frame and at close."""

    TYPES = ("IDR", "I", "P", "B")

    def __init__(self, width: int, height: int, fps: float,
                 b_psnr=True, b_ssim=True):
        self.w, self.h, self.fps = width, height, fps
        self.b_psnr, self.b_ssim = b_psnr, b_ssim
        self.count = {}          # frame count per type
        self.bits = {}           # total bits per type
        self.qp_sum = {}
        self.ssd = [0, 0, 0]     # global Y/U/V SSD
        self.psnr_sum = [0.0, 0.0, 0.0, 0.0]   # mean-of-frame Y/U/V/avg
        self.ssim_sum = 0.0
        self.mb_intra = 0
        self.mb_inter = 0
        self.mb_skip = 0
        self.psnr_type_sum = {}  # frame type -> [Y, avg] sums

    def add_frame(self, ftype: str, bits: int, qp: int, metrics=None,
                  mb_counts=None):
        """metrics: (ssd_y, ssd_u, ssd_v, ssim_sum) host floats;
        mb_counts: (intra, inter, skip)."""
        self.count[ftype] = self.count.get(ftype, 0) + 1
        self.bits[ftype] = self.bits.get(ftype, 0) + bits
        self.qp_sum[ftype] = self.qp_sum.get(ftype, 0) + qp
        if mb_counts is not None:
            self.mb_intra += int(mb_counts[0])
            self.mb_inter += int(mb_counts[1])
            self.mb_skip += int(mb_counts[2])
        if metrics is None:
            return
        w, h = self.w, self.h
        sy, su, sv = (int(m) for m in metrics[:3])
        self.ssd[0] += sy
        self.ssd[1] += su
        self.ssd[2] += sv
        py, pu, pv = (psnr(sy, w * h), psnr(su, w * h // 4),
                      psnr(sv, w * h // 4))
        self.psnr_sum[0] += py
        self.psnr_sum[1] += pu
        self.psnr_sum[2] += pv
        self.psnr_sum[3] += (py + pu + pv) / 3.0
        by_type = self.psnr_type_sum.setdefault(ftype, [0.0, 0.0])
        by_type[0] += py
        by_type[1] += (py + pu + pv) / 3.0
        self.ssim_sum += float(metrics[3]) / max(
            1, ((w - 6) >> 2) * ((h - 6) >> 2))

    def summary(self) -> dict:
        """The numbers of the reference's close-time report
        (encoder/encoder.c:2061-2080)."""
        n = sum(self.count.values())
        if n == 0:
            return {}
        total_bits = sum(self.bits.values())
        out = {
            "frames": n,
            "kb/s": self.fps * total_bits / n / 1000.0,
            "frame_types": dict(self.count),
            "avg_qp": {t: self.qp_sum[t] / c
                       for t, c in self.count.items()},
            "avg_bytes": {t: self.bits[t] / 8.0 / c
                          for t, c in self.count.items()},
        }
        nmb = self.mb_intra + self.mb_inter + self.mb_skip
        if nmb:
            out["mb_pct"] = {"intra": 100.0 * self.mb_intra / nmb,
                             "inter": 100.0 * self.mb_inter / nmb,
                             "skip": 100.0 * self.mb_skip / nmb}
        if self.b_psnr:
            yuv_size = self.w * self.h * 3 // 2
            out["psnr"] = {
                "y": self.psnr_sum[0] / n,
                "u": self.psnr_sum[1] / n,
                "v": self.psnr_sum[2] / n,
                "avg": self.psnr_sum[3] / n,
                "global": psnr(sum(self.ssd), n * yuv_size),
            }
            out["psnr_by_type"] = {
                t: {"y": sy / self.count[t], "avg": sa / self.count[t]}
                for t, (sy, sa) in self.psnr_type_sum.items()}
        if self.b_ssim:
            out["ssim_y"] = self.ssim_sum / n
        return out

    def report_lines(self):
        """Formatted like the reference's final x264_log lines."""
        s = self.summary()
        if not s:
            return []
        lines = []
        ft = s["frame_types"]
        for t in self.TYPES:
            if t in ft:
                lines.append(
                    f"frame {t}:{ft[t]:<5} Avg QP:{s['avg_qp'][t]:5.2f}"
                    f"  size:{s['avg_bytes'][t]:9.1f}")
        if "mb_pct" in s:
            m = s["mb_pct"]
            lines.append(f"mb    intra:{m['intra']:5.1f}%  "
                         f"inter:{m['inter']:5.1f}%  skip:{m['skip']:5.1f}%")
        if "ssim_y" in s:
            lines.append(f"SSIM Mean Y:{s['ssim_y']:.7f}")
        if "psnr" in s:
            p = s["psnr"]
            lines.append(
                f"PSNR Mean Y:{p['y']:6.3f} U:{p['u']:6.3f} "
                f"V:{p['v']:6.3f} Avg:{p['avg']:6.3f} "
                f"Global:{p['global']:6.3f} kb/s:{s['kb/s']:.2f}")
        else:
            lines.append(f"kb/s:{s['kb/s']:.1f}")
        return lines

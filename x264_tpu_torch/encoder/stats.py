"""Encoder statistics — per-frame and global PSNR / SSIM / bitrate / MB
accounting (x264_t.stat, common/common.h:560-614; accumulation at
encoder/encoder.c:1034-1056; final report x264_encoder_close:1878-2080),
and the frame metrics: the plain PyTorch version and the wrapper of its
CUDA kernel (kernel K4, csrc/metrics.cu).
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
# per device and stream: the kernel's ticket and partials (the kernel
# leaves the ticket cleared, so calls on one stream may share them)
_SCRATCH: dict = {}
# (w, h) -> the launch's CTAs (csrc/metrics.cu frame_metrics_ctas)
_CTAS: dict = {}


def frame_metrics(oy, ou, ov, ry, ru, rv, w: int, h: int):
    """K4 `frame_metrics`: SSD of the three planes and the SSIM sum.

    Replaces the metric half of x264_tpu/encoder/pipeline.py:host32_pack
    (with ops/pixel.py:ssim_sum). On CUDA tensors it runs csrc/metrics.cu
    in one launch: the SSIM windows from 4x4 block sums in shared memory,
    the exact int64 SSDs, the partials summed by the last CTA in a fixed
    order (the same result from call to call); on CPU tensors the plain
    version. Inputs are int32 (H, W) / (H/2, W/2) planes, the crop w x h.
    Returns float32 (4,) = (ssd_y, ssd_u, ssd_v, ssim_sum)."""
    if oy.device.type == "cpu":
        return frame_metrics_plain(oy, ou, ov, ry, ru, rv, w, h)
    for name, t in (("oy", oy), ("ou", ou), ("ov", ov), ("ry", ry),
                    ("ru", ru), ("rv", rv)):
        ref = oy if name.endswith("y") else ou
        cuda.check(t, tuple(ref.shape), I32, name)
    if not (0 < w <= oy.shape[1] and 0 < h <= oy.shape[0]
            and tuple(ou.shape) == (oy.shape[0] // 2, oy.shape[1] // 2)):
        raise ValueError(f"frame_metrics: a {w}x{h} crop of "
                         f"{tuple(oy.shape)} / {tuple(ou.shape)} planes")
    dev = oy.device
    if (w, h) not in _CTAS:
        _CTAS[w, h] = cuda.function("metrics", "frame_metrics_ctas",
                                    "ii")(w, h)
    n = _CTAS[w, h]
    stream = cuda.stream(dev)
    key = (str(dev), stream)
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.numel() < 1 + 2 * n:
        scratch = _SCRATCH[key] = torch.zeros(1 + 2 * n, dtype=torch.int64,
                                              device=dev)
    out = torch.empty(4, dtype=F32, device=dev)
    base = scratch.data_ptr()
    cuda.launch("metrics", "frame_metrics", "p" * 10 + "iiii" + "p",
                *[t.data_ptr() for t in (oy, ou, ov, ry, ru, rv)], base,
                base + 8, base + 8 + 8 * n, out.data_ptr(), w, h,
                oy.shape[1], ou.shape[1], stream)
    frame_metrics.launches += 1
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

"""The port's profilers, counterparts of tools/profile_stages.py and
tools/profile_encode.py:

    python -m x264_tpu_torch.tools.profile_stages [WxH] [--device cuda|cpu]
    python -m x264_tpu_torch.tools.profile_encode [WxH] [--device cuda|cpu]

Both run on the card by default and raise where there is none; with
--device cpu they run the plain PyTorch versions and time them on the
host clock (a CPU time, never a device one). The content generator is
the port's own copy of bench.py's make_frames."""

from __future__ import annotations

import argparse

import numpy as np
import torch


def make_frames(w: int, h: int, n: int, frame_cls, seed: int = 0):
    """bench.py's synthetic source: a static texture under noise that pans
    two pixels a frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx // 3 + yy // 2) % 200).astype(np.int32)
    noise = rng.integers(0, 24, (h + 32, w + 2 * n + 32))
    frames = []
    for t in range(n):
        y = (base + noise[t % 32:t % 32 + h, 2 * t:2 * t + w]) \
            .clip(0, 255).astype(np.uint8)
        u = (128 + (xx[::2, ::2] % 40) - 20).clip(0, 255).astype(np.uint8)
        v = (128 - (yy[::2, ::2] % 40) + 20).clip(0, 255).astype(np.uint8)
        frames.append(frame_cls(y, u, v))
    return frames


def parse_args(argv, what: str):
    """(width, height, device) from [WxH] [--device cuda|cpu]; the card
    must be there unless --device cpu."""
    ap = argparse.ArgumentParser(description=what)
    ap.add_argument("size", nargs="?", default="1920x1080")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    w, h = (int(x) for x in a.size.split("x"))
    if a.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the profilers run on the card; "
                           "pass --device cpu for the plain PyTorch "
                           "versions")
    return w, h, torch.device(a.device)


def device_line(dev) -> str:
    """What the times were taken on."""
    if dev.type == "cuda":
        return f"device: {torch.cuda.get_device_name(dev)} (CUDA events)"
    return "device: cpu (host clock, plain PyTorch versions)"

"""float32 fused multiply-add in plain PyTorch.

x264_tpu's float32 arithmetic runs on XLA's CPU backend, whose x86 code
generator contracts a multiply feeding an add into one FMA instruction.
The plain versions that must equal it bit for bit (encoder/aq.py's QP
map, ops/trellis.py's path scores) round those steps once, as fma_f32
does; the CUDA kernels use __fmaf_rn at the same steps.
"""

from __future__ import annotations

import torch

F32 = torch.float32
F64 = torch.float64


def fma_f32(a, b, c):
    """float32 fused multiply-add, correctly rounded: a * b is exact in
    float64, the float64 sum's rounding error is recovered exactly
    (TwoSum), and a float32 tie of the float64 sum is broken by that
    error's sign, so the result is round(a * b + c) once. a / b / c:
    float32 tensors or Python floats holding float32 values."""
    ref = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a64, b64, c64 = (torch.as_tensor(t, dtype=F32, device=ref.device)
                     .to(F64) for t in (a, b, c))
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(F32)
    d = s - r.to(F64)
    nxt = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf)
                          .to(F32))
    tie = (d != 0) & (d.abs() * 2 == (nxt.to(F64) - r.to(F64)).abs())
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), nxt, r)

#!/usr/bin/env python3
"""Hold the port's float32 log replay against XLA's CPU log, exhaustively.

    JAX_PLATFORMS=cpu python scripts/check_xla_log.py

x264_tpu_torch.encoder.aq.xla_log_f32_plain (the sequence K16 runs on the
card) against jax.numpy.log on the CPU, and xla_log2_f32 against
jax.numpy.log2, on every float32 in [1, 2^23) (23 binades, 192,937,984
values; the largest AQ energy is about 6.2e6). Prints the count of
values whose bits differ, for each, and the seconds taken; exits 1 if
any differ. XLA's CPU backend contracts the polynomial's multiply-adds
into FMAs where the host has them, so run it on a host with FMA."""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
from x264_tpu_torch.encoder import aq  # noqa: E402


def main() -> int:
    jlog, jlog2 = jax.jit(jnp.log), jax.jit(jnp.log2)
    t0 = time.perf_counter()
    n = d_log = d_log2 = 0
    for e in range(23):
        bits = np.arange(1 << 23, dtype=np.uint32) | np.uint32((127 + e) << 23)
        x = bits.view(np.float32)
        mine = aq.xla_log_f32_plain(torch.from_numpy(x))
        d_log += int((mine.numpy().view(np.int32)
                      != np.asarray(jlog(x)).view(np.int32)).sum())
        d_log2 += int(((mine * aq.INV_LN2).numpy().view(np.int32)
                       != np.asarray(jlog2(x)).view(np.int32)).sum())
        n += x.size
    secs = time.perf_counter() - t0
    print(f"{n} float32 values in [1, 2^23): log differs on {d_log}, log2 "
          f"on {d_log2}; {secs:.1f} s (jax {jax.__version__}, torch "
          f"{torch.__version__})")
    return 1 if d_log or d_log2 else 0


if __name__ == "__main__":
    sys.exit(main())

"""GOP-parallel intra: a batch of independent frames over a list of devices.

The PyTorch form of x264_tpu/parallel/mesh.py. x264_tpu shards the frame
axis of encode_i16_frame's vmap over a 1-D "gop" mesh (the analogue of
x264's frame threads on an all-intra stream: no frame reads another).
Here, as in parallel/rows.py, a list of devices replaces the mesh (a
device may repeat): the N frames are cut into len(devices) contiguous
chunks of equal size, as PartitionSpec("gop") cuts axis 0, and each
device runs K1's frame axis on its chunk (intra.encode_i16_frames: one
launch per wavefront diagonal for all of the chunk's frames). The
results are gathered on the first device. Nothing waits on the host: each
chunk's kernels go on its device's current stream, and the gather is a
non-blocking copy ordered after them.
"""

from __future__ import annotations

import torch

from ..encoder import intra
from .rows import on_device


def gop_devices(n_devices: int | None = None) -> list:
    """The visible cards, the first n_devices of them (x264_tpu's
    make_gop_mesh over jax.devices()). Raises without a card: pass a list
    such as ["cpu"] * 2 to encode_gop_intra for the plain versions."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: gop_devices lists the cards; "
                           "pass ['cpu'] * n to encode_gop_intra for the "
                           "plain PyTorch versions")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs if n_devices is None else devs[:n_devices]


def encode_gop_intra(devices, mb_h: int, mb_w: int, ys, us, vs, qtab,
                     lam: int) -> dict:
    """Encode a batch of frames, their axis split across devices
    (x264_tpu's encode_gop_intra: encode_i16_frame at its defaults, I16x16
    only, no I8x8, not lossless, one qtab and lambda).

    devices: a list of devices, one chunk of frames each (may repeat);
    ys: (N, 16 mb_h, 16 mb_w), us / vs: (N, 8 mb_h, 8 mb_w) int32 tensors
    or arrays; qtab: intra.make_qtab's tables; lam: the frame lambda. N
    must be a multiple of len(devices): like jax.device_put with
    P("gop"), an N that does not divide raises ValueError. Returns the
    dict of (N, ...) tensors of intra.encode_i16_frame, on devices[0]."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("encode_gop_intra: an empty device list")
    n = len(ys)
    if n % len(devs):
        raise ValueError(f"encode_gop_intra: {n} frames do not split into "
                         f"{len(devs)} equal chunks (the 'gop' axis must "
                         f"divide the frame axis)")
    per = n // len(devs)
    outs = []
    for k, d in enumerate(devs):
        with on_device(d):
            chunk = [torch.as_tensor(a[k * per:(k + 1) * per]).to(
                d, torch.int32) for a in (ys, us, vs)]
            q = {key: t.to(d) if torch.is_tensor(t) else t
                 for key, t in qtab.items()}
            outs.append(intra.encode_i16_frames(mb_h, mb_w, *chunk, q, lam))
    main = devs[0]
    return {key: torch.cat([o[key].to(main, non_blocking=True)
                            for o in outs]) for key in outs[0]}

"""Carry x264_tpu's tables into the port.

The encoder's counterpart of loading weights: ``qtab_from_numpy`` turns
the per-QP quantisation tables of x264_tpu's ``make_qtab`` (given as
numpy arrays) into the port's int32 tensors on a device, so the same
tables drive both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoder.intra import QTAB_SCALAR_KEYS, QTAB_VEC_KEYS


def qtab_from_numpy(qtab: dict, device) -> dict:
    """{name: array} -> {name: int32 tensor on `device`} for the keys
    the port's intra encode reads (the 4x4 luma and chroma tables)."""
    return {k: torch.as_tensor(np.array(qtab[k], np.int32), device=device)
            for k in QTAB_VEC_KEYS + QTAB_SCALAR_KEYS}

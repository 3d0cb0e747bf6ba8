"""Carry x264_tpu's tables into the port.

The encoder's counterpart of loading weights: ``qtab_from_numpy`` and
``qtab_p_from_numpy`` turn the per-QP quantisation tables of x264_tpu's
``make_qtab`` / ``make_qtab_p`` (given as numpy arrays) into the port's
int32 tensors on a device, so the same tables drive both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoder.inter import QTAB_P_SCALAR_KEYS, QTAB_P_VEC_KEYS
from .encoder.intra import QTAB_SCALAR_KEYS, QTAB_VEC_KEYS


def _tensors(qtab: dict, keys, device) -> dict:
    return {k: torch.as_tensor(np.array(qtab[k], np.int32), device=device)
            for k in keys}


def qtab_from_numpy(qtab: dict, device) -> dict:
    """{name: array} -> {name: int32 tensor on `device`} for the keys
    the port's intra encode reads (the 4x4 luma and chroma tables)."""
    return _tensors(qtab, QTAB_VEC_KEYS + QTAB_SCALAR_KEYS, device)


def qtab_p_from_numpy(qtab: dict, device) -> dict:
    """The same for x264_tpu's make_qtab_p: the intra keys plus the inter
    (py_ / pc_) keys the port's P encode reads."""
    return _tensors(qtab, QTAB_VEC_KEYS + QTAB_SCALAR_KEYS + QTAB_P_VEC_KEYS
                    + QTAB_P_SCALAR_KEYS, device)

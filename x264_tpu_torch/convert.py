"""Carry x264_tpu's tables into the port.

The encoder's counterpart of loading weights: ``qtab_from_numpy`` and
``qtab_p_from_numpy`` turn the per-QP quantisation tables of x264_tpu's
``make_qtab`` / ``make_qtab_p`` (given as numpy arrays) into the port's
int32 tensors on a device, so the same tables drive both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoder.inter import (QTAB_P_SCALAR_KEYS, QTAB_P_VEC8_KEYS,
                            QTAB_P_VEC_KEYS)
from .encoder.intra import QTAB_SCALAR_KEYS, QTAB_VEC8_KEYS, QTAB_VEC_KEYS
from .ops import rdcost as ordc


def _tensors(qtab: dict, keys, device) -> dict:
    return {k: torch.as_tensor(np.array(qtab[k], np.int32), device=device)
            for k in keys}


def qtab_from_numpy(qtab: dict, device) -> dict:
    """{name: array} -> {name: int32 tensor on `device`} for the keys
    the port's intra encode reads (the 4x4 luma and chroma tables and the
    I8x8 ones)."""
    return _tensors(qtab, QTAB_VEC_KEYS + QTAB_SCALAR_KEYS + QTAB_VEC8_KEYS,
                    device)


def qtab_p_from_numpy(qtab: dict, device) -> dict:
    """The same for x264_tpu's make_qtab_p: the intra keys plus the inter
    (py_ / pc_, and p8_ of the 8x8 transform) keys the port's P encode
    reads; and, where x264_tpu's
    Encoder._qtab_p added the RD ladder's tables, those as the port keeps
    them (rdbits as int32 tensors and packed into rdtab, rd_lam2 and
    psy_rd as Python floats holding their float32 values)."""
    out = _tensors(qtab, QTAB_VEC_KEYS + QTAB_SCALAR_KEYS + QTAB_VEC8_KEYS
                   + QTAB_P_VEC_KEYS + QTAB_P_SCALAR_KEYS + QTAB_P_VEC8_KEYS,
                   device)
    if "rdbits" in qtab:
        out["rdbits"] = {
            cat: {n: torch.as_tensor(np.asarray(t[n]).astype(np.int32),
                                     device=device)
                  for n in ("sig", "last", "l1", "unary")}
            for cat, t in qtab["rdbits"].items()}
        out["rdtab"] = ordc.pack_rdbits(out["rdbits"])
        out["rd_lam2"] = float(np.float32(qtab["rd_lam2"]))
        if "psy_rd" in qtab:
            out["psy_rd"] = float(np.float32(qtab["psy_rd"]))
    return out

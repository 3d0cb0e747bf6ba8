"""CABAC bit-cost tables of the trellis and the RD ladder — the host half
of x264_tpu/ops/trellis.py, in numpy.

``make_consts`` builds, for one (QP, block category), the slice-initial
CABAC bit costs (1/256-bit units) that both the trellis and the RD
ladder's ``rdcost.residual_bits_f8`` read: the per-position significance
and last flags, the coeff_abs_level_minus1 prefix context of each node
of the 8-node level machine, and the unary prefix + sign cost from each
gt1 state (x264_rdo_init semantics, encoder/rdo.c:326-344), plus the
quant / unquant / weight vectors of the trellis itself. The states come
from the port's own ``entropy/cabac_tables.py``. The batched trellis
(``trellis_scan``) comes with the trellis slice.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import tables
from ..entropy import cabac_tables as CT

CABAC_SIZE_BITS = 8
LAMBDA_BITS = 4

# level node-context machine (same tables as the entropy writers)
L1_CTX = np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int32)
GT1_CTX = np.array([5, 5, 5, 5, 6, 7, 8, 9], np.int32)
NODE_TRANS = np.array([[1, 2, 3, 3, 4, 5, 6, 7],
                       [4, 4, 4, 4, 5, 6, 7, 7]], np.int32)
# per-category context bases + coefficient counts (spec 9.3.3.1.1.9;
# cat 5 = luma 8x8 with the Table 9-43 shared significance contexts)
CAT_C = np.array([16, 15, 16, 4, 15, 64], np.int32)
SIG_BASE = np.array([105, 120, 134, 149, 152, 402], np.int32)
LAST_BASE = np.array([166, 181, 195, 210, 213, 417], np.int32)
LVL_BASE = np.array([227, 237, 247, 257, 266, 426], np.int32)
SIG_MAP8 = np.array([
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12],
    np.int32)
LAST_MAP8 = np.minimum(np.arange(63) >> 2, 8).astype(np.int32)

# inverse-squared 4x4 DCT scale factors in raster order (row norms^2 of
# the core transform are 4 and 10)
_N2 = np.array([4, 10, 4, 10], np.float64)
DCT4_WEIGHT2 = np.round(
    256.0 * 800.0 / (_N2[:, None] * _N2[None, :]) / 16.0
).astype(np.int32).reshape(16)

# inverse-squared 8x8 DCT scale factors, raster order (x264_dct8_weight2_tab
# semantics, common/dct.h:67-84, from the 8-point basis row norms)
_W8_AXIS = np.array([1.0, 0.941175, 1.6 ** 0.5, 0.941175] * 2)
DCT8_WEIGHT2 = np.round(
    256.0 * (_W8_AXIS[:, None] * _W8_AXIS[None, :]) ** 2
).astype(np.int32).reshape(64)


@functools.lru_cache()
def entropy_f8():
    """(128, 2) CABAC bit cost (1/256 units) of coding bin b from the
    combined state s = mps<<6 | pstate, from the state machine's
    probability model p_LPS(sigma) = 0.5 * alpha^sigma,
    alpha = (0.01875/0.5)^(1/63) (spec 9.3.3.2.1.1)."""
    alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
    sigma = np.arange(64)
    plps = 0.5 * alpha ** sigma
    ent_lps = -np.log2(plps) * 256.0
    ent_mps = -np.log2(1.0 - plps) * 256.0
    out = np.zeros((128, 2), np.int32)
    for s in range(128):
        # s < 64: MPS 0, pStateIdx 63-s; else MPS 1, s-64
        mps = s >> 6
        st = (s - 64) if mps else (63 - s)
        out[s, mps] = int(round(ent_mps[st]))
        out[s, 1 - mps] = int(round(ent_lps[st]))
    return out


@functools.lru_cache()
def size_unary():
    """(15, 128) f8 bit cost of a unary level prefix (prefix-1 ones +
    the terminator if prefix < 14) + sign, from gt1 state s, with the
    state evolving along the run (encoder/rdo.c:326-344)."""
    ent = entropy_f8()
    trans = CT.TRANSITION
    size = np.zeros((15, 128), np.int32)
    for prefix in range(15):
        for s0 in range(128):
            s, f8 = s0, 0
            for _ in range(1, prefix):
                f8 += ent[s, 1]
                s = trans[s][1]
            if 0 < prefix < 14:
                f8 += ent[s, 0]
            f8 += 1 << CABAC_SIZE_BITS          # sign bypass
            size[prefix, s0] = f8
    return size


def lambda2(qp: int, intra: bool) -> int:
    """encoder/rdo.c:363-380: .85^2 (inter) / .65^2 (intra)
    * 2^(qp/3 + 10 - LAMBDA_BITS)."""
    f = 0.65 ** 2 if intra else 0.85 ** 2
    return max(1, int(round(f * 2.0 ** (qp / 3.0 + 10 - LAMBDA_BITS))))


def _ue_big_f8(v):
    """bs_size_ue_big(v) << 8 of an int array: the exp-Golomb bit length of
    the level suffix beyond 14."""
    n = np.asarray(v, np.int64) + 1
    bl = np.zeros_like(n)
    for shift in (16, 8, 4, 2, 1):
        ge = n >= (1 << shift)
        bl = bl + np.where(ge, shift, 0)
        n = np.where(ge, n >> shift, n)
    return ((2 * bl + 1) << CABAC_SIZE_BITS).astype(np.int32)


def _consts_np(qp: int, cat: int, cqm_list: int, slice_is_i: bool,
               cabac_init_idc: int, intra: bool, qt: tables.QuantTables,
               state_qp: int | None = None) -> dict:
    """The consts of one (qp, category); see make_consts. state_qp: the QP
    of the CABAC context initialisation (the slice QP)."""
    states = CT.init_states(slice_is_i, qp if state_qp is None else state_qp,
                            cabac_init_idc)
    ent = entropy_f8()
    C = int(CAT_C[cat])
    dc = cat in (0, 3)
    if cat == 5:
        order = tables.ZIGZAG8
        qmf = qt.quant8_mf[cqm_list, qp][order].astype(np.int64)
        uqmf = qt.unquant8_mf[cqm_list, qp][order].astype(np.int64)
        w2 = DCT8_WEIGHT2[order].astype(np.int64)
    else:
        zz = tables.ZIGZAG4
        order = (zz[1:] if cat in (1, 4)
                 else (np.arange(4) if cat == 3 else zz))
        if dc:
            # DC quant / unquant (quant_trellis_cabac dc path,
            # encoder/rdo.c:498,551): mf[0]>>1, unquant[0]<<1, flat weight
            qmf = np.full(C, qt.quant4_mf[cqm_list, qp][0] >> 1, np.int64)
            uqmf = np.full(C, qt.unquant4_mf[cqm_list, qp][0] << 1,
                           np.int64)
            w2 = np.full(C, 256, np.int64)
        else:
            qmf = qt.quant4_mf[cqm_list, qp][order].astype(np.int64)
            uqmf = qt.unquant4_mf[cqm_list, qp][order].astype(np.int64)
            w2 = DCT4_WEIGHT2[order].astype(np.int64)

    sig_bits = np.zeros((C, 2), np.int32)
    last_bits = np.zeros((C, 2), np.int32)
    for i in range(C - 1):
        if cat == 5:
            si, li = SIG_MAP8[i], LAST_MAP8[i]
        elif cat == 3:
            si = li = min(i, 2)   # chroma DC ctxIdxInc = Min(i, 2)
        else:
            si = li = i
        sig_bits[i] = ent[states[SIG_BASE[cat] + si]]
        last_bits[i] = ent[states[LAST_BASE[cat] + li]]

    base = LVL_BASE[cat]
    l1_bits = np.zeros((8, 2), np.int32)     # [node][prefix > 0]
    un_node = np.zeros((8, 15), np.int32)    # [node][prefix] unary + sign
    for j in range(8):
        l1_bits[j] = ent[states[base + L1_CTX[j]]]
        un_node[j] = size_unary()[:, states[base + GT1_CTX[j]]]
    lam2f = lambda2(qp, intra) / (1 << (CABAC_SIZE_BITS - LAMBDA_BITS))
    return dict(qmf=qmf, uqmf=uqmf, w2=np.asarray(w2, np.float32),
                sig=np.asarray(sig_bits, np.float32),
                last=np.asarray(last_bits, np.float32),
                l1=np.asarray(l1_bits, np.float32),
                unary=np.asarray(un_node, np.float32),
                lam2=np.float32(lam2f))


def make_consts(qp: int, cat: int, cqm_list: int, slice_is_i: bool,
                cabac_init_idc: int = 0, intra: bool = False,
                qt: tables.QuantTables | None = None,
                state_qp: int | None = None) -> dict:
    """Host-side static inputs of the trellis and the RD bit costs at one
    (qp, category), as numpy arrays: quant / unquant / weights in scan
    order, and the bit-cost tables sig (C, 2), last (C, 2), l1 (8, 2),
    unary (8, 15) from the slice-initial CABAC states. Categories (spec
    ctxBlockCat): 0 luma DC, 1 luma AC, 2 luma 4x4, 3 chroma DC (2x2),
    4 chroma AC, 5 luma 8x8."""
    return _consts_np(qp, cat, cqm_list, slice_is_i, cabac_init_idc, intra,
                      qt or tables.DEFAULT_QUANT, state_qp)

"""CABAC bit-cost tables of the trellis and the RD ladder — the host half
of x264_tpu/ops/trellis.py, in numpy.

``make_consts`` builds, for one (QP, block category), the slice-initial
CABAC bit costs (1/256-bit units) that both the trellis and the RD
ladder's ``rdcost.residual_bits_f8`` read: the per-position significance
and last flags, the coeff_abs_level_minus1 prefix context of each node
of the 8-node level machine, and the unary prefix + sign cost from each
gt1 state (x264_rdo_init semantics, encoder/rdo.c:326-344), plus the
quant / unquant / weight vectors of the trellis itself. The states come
from the port's own ``entropy/cabac_tables.py``.

``trellis_scan_plain`` is the batched trellis itself (x264_tpu/ops/
trellis.py:trellis_scan, quant_trellis_cabac semantics, encoder/rdo.c:
411-628): an 8-node Viterbi over each block's scan that picks every level
from {q, q - 1} (no deadzone) by ssd + lambda2 * CABAC bits. Its wrapper
``trellis_scan`` is kernel K20 (csrc/trellis.cu); K6 (csrc/inter.cu) runs
the same device code (csrc/trellis.cuh) in place of its deadzone quant.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cuda
from .. import tables
from ..entropy import cabac_tables as CT
from .fma import fma_f32

I32 = torch.int32
F32 = torch.float32

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
    """bs_size_ue_big(v) << 8 of an int32 tensor: the exp-Golomb bit length
    of the level suffix beyond 14, in 1/256 bits."""
    n = v + 1
    bl = torch.zeros_like(n)
    for shift in (16, 8, 4, 2, 1):
        ge = n >= (1 << shift)
        bl = bl + torch.where(ge, shift, 0)
        n = torch.where(ge, n >> shift, n)
    return (2 * bl + 1) << CABAC_SIZE_BITS


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


def make_consts_all_qp(cat: int, cqm_list: int, slice_is_i: bool,
                       cabac_init_idc: int = 0, intra: bool = False,
                       qt: tables.QuantTables | None = None) -> dict:
    """make_consts at all 52 QPs, stacked on a leading axis: the per-MB-QP
    (variance AQ) form that trellis_scan row-gathers by qp_idx. Each row's
    CABAC states and lambda2 are its own QP's, luma and chroma categories
    alike (x264_tpu's make_consts_all_qp passes no state_qp), where the
    frame-QP form initialises the chroma states at the slice QP."""
    qt = qt or tables.DEFAULT_QUANT
    rows = [_consts_np(q, cat, cqm_list, slice_is_i, cabac_init_idc, intra,
                       qt) for q in range(52)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def tie_coefs(qmf, n: int, seed: int) -> np.ndarray:
    """(n, C) int32 coefficient rows in scan order on which the trellis's
    ties and edges occur, for holding its kernel against its plain
    version: all-zero rows; magnitudes on either side of a position's
    rounding edge (|c| * qmf + 2^15 at a multiple of 2^16, so that q
    steps by one), at random positions and signs, and as the row's one
    nonzero coefficient; and edges high enough that the levels pass the
    ue escape (>= 15). qmf: the category's (C,) quant multipliers."""
    rng = np.random.default_rng(seed)
    qmf = np.asarray(qmf, np.int64).reshape(-1)
    C = qmf.size

    def edge(k, rows):
        a = -(-(k * 65536 - 32768) // qmf)          # the least |c| of q = k
        return a - rng.integers(0, 2, (rows, C))

    n0, n1, n2 = n // 8, n // 3, n // 4
    near = edge(rng.integers(1, 4, (n1, C)), n1) \
        * (rng.random((n1, C)) < 0.5)
    single = np.zeros((n2, C), np.int64)
    at = rng.integers(0, C, n2)
    single[np.arange(n2), at] = edge(rng.integers(1, 3, (n2, 1)), n2)[
        np.arange(n2), at]
    big = edge(rng.integers(1, 24, (n - n0 - n1 - n2, C)), n - n0 - n1 - n2)
    rows = np.concatenate([np.zeros((n0, C), np.int64), near, single, big])
    return (rows * rng.choice([-1, 1], rows.shape)).astype(np.int32)


# ------------------------------------------------------------ the trellis
BIG = 1e30          # the score of an unreachable node (float32)
# the packed int32 layout of one category (pack_trellis), C <= 64 scan
# positions: qmf, uqmf (int32), w2 (float32 bits) at C each, sig and last
# (C, 2), l1 (8, 2), unary (8, 15), lam2; csrc/trellis.cuh reads it
TRELLIS_KEYS = ("qmf", "uqmf", "w2", "sig", "last", "l1", "unary", "lam2")


def trellis_ints(C: int) -> int:
    """Length of one category's packed table with C scan positions."""
    return 7 * C + 16 + 120 + 1


def unpack_trellis(tab, C: int) -> dict:
    """pack_trellis inverted: the consts of C scan positions from a packed
    (..., trellis_ints(C)) int32 table, as torch tensors."""
    lead, out, o = tab.shape[:-1], {}, 0
    for k, shape in (("qmf", (C,)), ("uqmf", (C,)), ("w2", (C,)),
                     ("sig", (C, 2)), ("last", (C, 2)), ("l1", (8, 2)),
                     ("unary", (8, 15)), ("lam2", ())):
        n = int(np.prod(shape))
        v = tab[..., o:o + n].reshape(tuple(lead) + shape)
        out[k] = v if k in ("qmf", "uqmf") else v.view(F32)
        o += n
    return out


def _as_torch(tc, device, C: int | None = None) -> dict:
    """A make_consts / make_consts_all_qp dict (or its pack_trellis table,
    given C) as torch tensors: qmf and uqmf int32, the rest float32 (lam2
    0-d, or (52,) stacked)."""
    if torch.is_tensor(tc):
        tc = unpack_trellis(tc, C)
    out = {}
    for k in TRELLIS_KEYS:
        v = tc[k]
        dt = I32 if k in ("qmf", "uqmf") else F32
        out[k] = v.to(device, dt) if torch.is_tensor(v) else \
            torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    return out


def pack_trellis(tc: dict, device=None) -> torch.Tensor:
    """One category's consts as the flat int32 vector csrc/trellis.cuh
    reads (the floats by their bits), or with a 52-QP stack
    (make_consts_all_qp) one such row per QP, (52, trellis_ints(C))."""
    t = _as_torch(tc, device or "cpu")
    lead = t["lam2"].shape
    parts = [t[k].reshape(*lead, -1) if k != "lam2" else t[k].reshape(*lead, 1)
             for k in TRELLIS_KEYS]
    parts = [p if p.dtype == I32 else p.view(I32) for p in parts]
    return torch.cat(parts, -1).contiguous()


def _dest_index():
    """For each destination node, the columns of the (cand, j, kind)
    contributions that reach it, in the reference's update order (cand 0
    then 1, j 0..7, and kinds zero / level 1 / level > 1), padded with the
    index of an always-BIG column: (8, 12) int64."""
    dest = (lambda j: j, lambda j: int(NODE_TRANS[0][j]),
            lambda j: int(NODE_TRANS[1][j]))
    lists = [[] for _ in range(8)]
    for cand in range(2):
        for j in range(8):
            for kind in range(3):
                lists[dest[kind](j)].append(24 * cand + 3 * j + kind)
    width = max(len(x) for x in lists)
    return np.array([x + [48] * (width - len(x)) for x in lists], np.int64)


_DEST = _dest_index()


def _score(kind, bits, lam2, base):
    """A contribution's float32 score base + bits * lam2, rounded as
    x264_tpu's jitted trellis_scan rounds it on XLA's CPU backend, whose
    x86 code generator contracts a multiply into the add it feeds only
    where the product has that one use in the same basic block: for a
    level > 1 (kind 2) the bits hold the block's own unary prefix, the
    product feeds one add and becomes one FMA; for a zero or a level of
    1 the bits are the same for both candidates (and, with shared
    consts, for every block, so the product is hoisted out of the loop),
    and product and sum round apart. The same holds for base = score +
    (d * d) * w2, whose product feeds the adds of all eight nodes: it
    rounds apart too. (The fused loops of trellis_scan's XLA dump, and
    blocks on which either uniform rounding differs from x264_tpu, show
    it.)"""
    return torch.where(kind == 2, fma_f32(bits, lam2, base),
                       base + bits * lam2)


def trellis_scan_plain(coefs_scan, tc: dict, qp_idx=None):
    """Plain version of K20: the batched CABAC trellis of x264_tpu/ops/
    trellis.py:trellis_scan, bit for bit. coefs_scan: (N, C) int32 forward
    DCT coefficients in scan order; tc: one category's consts
    (make_consts), or a 52-QP stack (make_consts_all_qp) with qp_idx (N,)
    the row of each block. Returns (N, C) int32 signed levels in scan
    order.

    The reference's order of operations is kept: the scan runs from the
    last position down; at each, candidate q then q - 1 (dropped where q
    is 0 or below), from node j 0..7, each scoring the one kind of transition its
    level takes (zero j -> j, level 1 NODE_TRANS[0][j], level > 1
    NODE_TRANS[1][j]); a destination keeps the first contribution that is
    strictly below its score, which starts at BIG (so one that nothing
    reaches keeps level 0 and parent 0); the final node is the first
    argmin. Scores are float32, rounded as _score says.

    The integer steps run in int32, as x264_tpu's do (its int64 casts are
    int32 without jax_enable_x64). With the flat lists both products stay
    far below 2^31 for every coefficient the transforms of 8-bit
    residuals make: |coef| is at most 9180 (4x4), 16320 (8x8) and 16320
    (the chroma DC Hadamard), so |coef| * qmf + 2^15 < 2.2e8 with qmf <=
    26214 (13107 for the DC, 20972 for the 8x8) at any QP, and uqmf *
    level + 128 < 4.4e6; the tests hold both bounds and the levels at
    those extremes. A custom list with small entries (--cqm) raises qmf
    to ~4.2e5, and the product then wraps as x264_tpu's does; q may come
    out negative, and its level is then 0 (max(q - cand, 0), the second
    candidate dropped)."""
    dev = coefs_scan.device
    N, C = coefs_scan.shape
    t = _as_torch(tc, dev, C)
    if qp_idx is not None:
        t = {k: v[qp_idx.long()] for k, v in t.items()}
    else:
        t = {k: v[None] for k, v in t.items()}       # (1, ...) broadcast
    coefs_scan = coefs_scan.to(I32)
    sign = torch.where(coefs_scan < 0, -1, 1).to(I32)
    ac = coefs_scan.abs()
    q = (ac * t["qmf"] + (1 << 15)) >> 16             # no deadzone
    lam2 = t["lam2"][:, None]
    zero = torch.zeros(1, dtype=F32, device=dev)
    big = torch.full((N, 1), BIG, dtype=F32, device=dev)
    dest = torch.as_tensor(_DEST, device=dev)
    kinds = torch.arange(3, device=dev)
    score = torch.full((N, 8), BIG, dtype=F32, device=dev)
    score[:, 0] = 0.0
    hist = [None] * C          # per position: (N, 8) parent * 4 + choice
    unary = t["unary"].expand(N, 8, 15)
    for i in range(C - 1, -1, -1):
        qi, ci = q[:, i], ac[:, i]
        if i < C - 1:
            sig0, sig1 = t["sig"][:, i, 0], t["sig"][:, i, 1]
            last0, last1 = t["last"][:, i, 0], t["last"][:, i, 1]
        else:
            sig0 = sig1 = last0 = last1 = zero
        # node j's last flag: node 0 codes this level as the last one
        last_j = torch.cat([last1[:, None].expand(-1, 1),
                            last0[:, None].expand(-1, 7)], 1)
        cols = []
        for cand in range(2):
            lvl = (qi - cand).clamp(min=0)
            unq = (t["uqmf"][:, i] * lvl + 128) >> 8
            d = (ci - unq).to(F32)
            ssd = (d * d) * t["w2"][:, i]
            base = score + ssd[:, None]                   # (N, 8)
            prefix = (lvl - 1).clamp(0, 14)
            ue = torch.where(lvl >= 15, _ue_big_f8((lvl - 15).clamp(min=0)),
                             0).to(F32)
            un = unary.gather(2, prefix.long()[:, None, None]
                              .expand(N, 8, 1))[..., 0]
            s1l = sig1[:, None] + last_j
            b1 = ((s1l + t["l1"][..., 1]) + un) + ue[:, None]
            bA = (s1l + t["l1"][..., 0]) + float(1 << CABAC_SIZE_BITS)
            bZ = torch.cat([torch.zeros((N, 1), dtype=F32, device=dev),
                            sig0[:, None].expand(N, 7)], 1)
            # 0 zero, 1 level 1, 2 level > 1, 3 none (q - 1 where q is 0)
            kind = torch.where(lvl == 0, 0, torch.where(lvl == 1, 1, 2))
            if cand == 1:
                kind = torch.where(qi <= 0, 3, kind)
            bits = torch.where((kind == 0)[:, None], bZ,
                               torch.where((kind == 1)[:, None], bA, b1))
            s = _score(kind[:, None], bits, lam2, base)   # (N, 8)
            cols.append(torch.where(kind[:, None, None] == kinds,
                                    s[..., None], BIG).reshape(N, 24))
        cand_vals = torch.cat(cols + [big], 1)           # (N, 49)
        g = cand_vals[:, dest]                            # (N, 8, 12)
        m, w = g.min(2)
        col = dest[torch.arange(8, device=dev)[None, :], w]   # (N, 8)
        upd = m < BIG
        choice = torch.where(upd, col // 24, 2)          # 2: level 0
        par = torch.where(upd, (col % 24) // 3, 0)
        hist[i] = (par * 4 + choice).to(torch.uint8)
        score = m
    node = score.argmin(1)
    out = torch.empty((N, C), dtype=I32, device=dev)
    ar = torch.arange(N, device=dev)
    for i in range(C):
        h = hist[i][ar, node].long()
        ch = h & 3
        out[:, i] = torch.where(ch == 0, q[:, i].clamp(min=0), torch.where(
            ch == 1, (q[:, i] - 1).clamp(min=0), 0))
        node = h >> 2
    return out * sign


def trellis_scan(coefs_scan, tab, qp_idx=None):
    """K20 `trellis_scan`: the batched CABAC trellis.

    Replaces x264_tpu/ops/trellis.py:trellis_scan. On CUDA tensors it runs
    csrc/trellis.cu, 8 lanes a block in one launch; on CPU tensors
    the plain version. tab: one category's pack_trellis table (one row,
    or the 52-row stack read by qp_idx). Arguments and result as
    trellis_scan_plain."""
    if coefs_scan.device.type == "cpu":
        return trellis_scan_plain(coefs_scan, tab, qp_idx)
    dev = coefs_scan.device
    N, C = coefs_scan.shape
    if C not in (4, 15, 16, 64):
        raise ValueError(f"trellis_scan: no kernel for {C} scan positions")
    cuda.check(coefs_scan, (N, C), I32, "coefs_scan")
    rows = 52 if qp_idx is not None else None
    cuda.check(tab, (rows, trellis_ints(C)) if rows else (trellis_ints(C),),
               I32, "trellis table")
    if qp_idx is not None:
        cuda.check(qp_idx, (N,), I32, "qp_idx")
    out = torch.empty((N, C), dtype=I32, device=dev)
    cuda.launch("trellis", "trellis_scan", "ppppiip", coefs_scan.data_ptr(),
                tab.data_ptr(), 0 if qp_idx is None else qp_idx.data_ptr(),
                out.data_ptr(), N, C, cuda.stream(dev))
    trellis_scan.launches += 1
    trellis_scan.launches_aq += int(qp_idx is not None)
    return out


# launches, and those of them with a per-block row of the 52-QP stack
trellis_scan.launches = trellis_scan.launches_aq = 0


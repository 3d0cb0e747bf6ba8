"""CABAC engine front-end: packed bin-op stream -> encoded bytes.

The op stream is produced vectorized (device-side, cabac_planes.py); the
sequential arithmetic coding runs in the native C engine
(native/cabac.c) with a pure-Python fallback of identical semantics.

Both engines implement the H.264 spec 9.3.4 encoder flowcharts directly
(EncodeDecision / RenormE / PutBit / EncodeBypass / EncodeTerminate /
EncodeFlush): bits are deferred through the spec's bitsOutstanding
counter and emitted MSB-first through a plain bit-to-byte packer, so a
carry never revisits previously written bytes and the slice-header byte
is left untouched. (The role of this engine corresponds to
common/cabac.c:807-926 in the reference; the byte-emission scheme here
is the spec's own, not x264's byte-queue/carry-sink formulation.)

Packed op (uint32): kind = op >> 29, b = (op >> 17) & 0xFFF,
a = op & 0x1FFFF. Kinds: 0 decision(ctx=a, bin=b), 1 raw bypass
(value=a, nbits=b), 2 ue-bypass(value=a, exp_bits=b), 3 terminal(0),
4 pad, 5 repeated 1-bins (ctx=a, count=b), 6 residual significance
map (mask=a, b = cat | last<<3), 7 residual level (|l|-1 = a, sign=b).
Kinds 6/7 expand the sig/last decisions and the level binarization of
block_residual_write_cabac (encoder/cabac.c:584) inside the serial
engine, so the device stream stays ~6x smaller.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import cabac_tables as CT
from .. import native

(KIND_DECISION, KIND_BYPASS, KIND_UE, KIND_TERMINAL, KIND_PAD,
 KIND_ONES, KIND_SIGMAP, KIND_LEVEL) = range(8)

A_BITS, B_BITS = 17, 12
A_MAX, B_MAX = (1 << A_BITS) - 1, (1 << B_BITS) - 1

# residual tables shared with the device plane generator (category 5 =
# luma 8x8; SIG_MAP8/LAST_MAP8 are the spec Table 9-43 shared-context
# maps for 8x8 significance/last flags)
CAT_C = (16, 15, 16, 4, 15, 64)
SIG_BASE = (105, 120, 134, 149, 152, 402)
LAST_BASE = (166, 181, 195, 210, 213, 417)
LVL_BASE = (227, 237, 247, 257, 266, 426)
SIG_MAP8 = (
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12)
LAST_MAP8 = (
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8)
L1_CTX = (1, 2, 3, 4, 0, 0, 0, 0)
GT1_CTX = (5, 5, 5, 5, 6, 7, 8, 9)
NODE_TRANS = ((1, 2, 3, 3, 4, 5, 6, 7), (4, 4, 4, 4, 5, 6, 7, 7))


# The halfword transfer format of K27 (cabac_planes.hw_pack; x264_tpu
# cabac_planes.py:440-452): an op crosses to the host as one 16-bit
# halfword, 0 | kind << 12 | payload12 with payload12 = (b <<
# HW_A_BITS[kind]) | a where a and b fit, else as three, (0x8000 | kind <<
# 12 | b), a & 0x7FFF, a >> 15, whose continuations always carry bit 15 =
# 0; halfwords pair into uint32 words low first. The one definition of
# the format: cabac_planes.py imports it, csrc/hwpack.cu's kAbits copies it.
HW_A_BITS = (11, 8, 9, 11, 0, 9, 0, 11)


def unpack_hw(words: np.ndarray, n_hw: int) -> np.ndarray:
    """Expand a packed halfword stream (uint32 words, two halfwords a
    word, low first; the first n_hw halfwords live) back to the 32-bit op
    stream (x264_tpu entropy/cabac.py:unpack_hw), vectorised on the host
    right after the copy from the device."""
    if n_hw == 0:
        return np.zeros(0, np.uint32)
    w = np.ascontiguousarray(words).view(np.uint32)
    hws = np.empty(w.shape[0] * 2, np.uint32)
    hws[0::2] = w & 0xFFFF
    hws[1::2] = w >> 16
    hws = hws[:n_hw]
    e = (hws >> 15) != 0                    # extended-op start halfwords
    cont = np.zeros(n_hw, bool)
    cont[1:] = e[:-1]
    if n_hw > 2:
        cont[2:] |= e[:-2]
    sidx = np.nonzero(~cont)[0]             # op start positions
    kind = (hws[sidx] >> 12) & 7
    is_e = e[sidx]
    i1 = np.minimum(sidx + 1, n_hw - 1)
    i2 = np.minimum(sidx + 2, n_hw - 1)
    abits = np.asarray(HW_A_BITS, np.uint32)[kind]
    p = hws[sidx] & 0xFFF
    a = np.where(is_e, hws[i1] | (hws[i2] << 15),
                 p & ((np.uint32(1) << abits) - 1))
    b = np.where(is_e, p, p >> abits)
    return ((kind << 29) | (b << 17) | a).astype(np.uint32)


def encode_ops(states: np.ndarray, ops: np.ndarray,
               prev_byte: int) -> tuple[bytes, int]:
    """Run the arithmetic coder over the packed op stream.

    states: uint8[460] (mutated); prev_byte: the last slice-header byte
    (returned unchanged — this engine never carries into the header).
    Returns (payload bytes, prev_byte).
    """
    ops = np.ascontiguousarray(ops, np.uint32)
    n = len(ops)
    lib = native.load()
    if lib is not None:
        kinds = ops >> 29
        # worst-case output bound: decisions/terminals <= 2 B each;
        # sigmap <= 30 decisions; level <= 15 decisions + ue + sign;
        # ue/bypass payloads <= ~6 B
        cap = 64 + 2 * n \
            + 64 * int(((kinds == KIND_ONES) | (kinds == KIND_SIGMAP)
                        | (kinds == KIND_LEVEL)).sum()) \
            + 8 * int(((kinds == KIND_UE) | (kinds == KIND_BYPASS)).sum())
        out = np.zeros(cap, np.uint8)
        out[0] = prev_byte
        st = np.ascontiguousarray(states, np.uint8)
        nbytes = lib.cabac_encode(
            st.ctypes.data_as(ctypes.c_char_p),
            CT.RANGE_LPS.ctypes.data_as(ctypes.c_char_p),
            CT.TRANSITION.ctypes.data_as(ctypes.c_char_p),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, out.ctypes.data_as(ctypes.c_char_p))
        states[:] = st
        return out[1:1 + nbytes].tobytes(), int(out[0])

    enc = PyCabacEncoder(states, prev_byte)
    for op in ops:
        op = int(op)
        k, b, a = op >> 29, (op >> 17) & B_MAX, op & A_MAX
        if k == KIND_DECISION:
            enc.decision(a, b & 1)
        elif k == KIND_ONES:
            for _ in range(b):
                enc.decision(a, 1)
        elif k == KIND_BYPASS:
            for j in range(b - 1, -1, -1):
                enc.bypass((a >> j) & 1)
        elif k == KIND_UE:
            enc.ue_bypass(a, b)
        elif k == KIND_TERMINAL:
            enc.terminal0()
        elif k == KIND_SIGMAP:
            enc.sigmap(a, b & 7, (b >> 3) & 63, (b >> 9) & 3)
        elif k == KIND_LEVEL:
            enc.level(a, b & 1)
    enc.flush()
    return bytes(enc.out[1:]), enc.out[0]


class PyCabacEncoder:
    """Bit-identical Python engine (fallback / tests): a direct
    transcription of the spec 9.3.4.3 flowcharts."""

    def __init__(self, states: np.ndarray, prev_byte: int):
        self.states = states
        self.low = 0
        self.range = 510
        self.first = True          # firstBitFlag
        self.pending = 0           # bitsOutstanding
        self.bitbuf = 0
        self.nbits = 0
        self.out = bytearray([prev_byte])
        self.cat = 0               # residual expansion state
        self.node = 0
        self.sig_acc = 0

    # ---- bit output (PutBit + MSB-first byte packer)
    def _raw_bit(self, b: int):
        self.bitbuf = (self.bitbuf << 1) | b
        self.nbits += 1
        if self.nbits == 8:
            self.out.append(self.bitbuf)
            self.bitbuf = 0
            self.nbits = 0

    def _put_bit(self, b: int):
        if self.first:
            self.first = False
        else:
            self._raw_bit(b)
        while self.pending:
            self._raw_bit(b ^ 1)
            self.pending -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.pending += 1
            self.range <<= 1
            self.low <<= 1

    # ---- core coding ops
    def decision(self, ctx: int, b: int):
        s = int(self.states[ctx])
        lps = int(CT.RANGE_LPS[s][(self.range >> 6) & 3])
        self.range -= lps
        if b != (s >> 6):
            self.low += self.range
            self.range = lps
        self.states[ctx] = CT.TRANSITION[s][b]
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put_bit(1)
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.pending += 1

    def ue_bypass(self, val: int, exp_bits: int):
        """k-th order exp-Golomb in bypass mode."""
        k = exp_bits
        while val >= (1 << k):
            self.bypass(1)
            val -= 1 << k
            k += 1
        self.bypass(0)
        while k > 0:
            k -= 1
            self.bypass((val >> k) & 1)

    def terminal0(self):
        self.range -= 2
        self._renorm()

    # ---- residual expansion (kinds 6/7)
    def sigmap(self, mask: int, cat: int, last: int, part: int = 0):
        if cat == 5 and part < 3:      # accumulate 8x8 mask parts
            if part == 0:
                self.sig_acc = 0
            self.sig_acc |= mask << (16 * part)
            return
        if cat == 5:
            mask = self.sig_acc | (mask << 48)
            self.sig_acc = 0
        self.cat = cat
        self.node = 0
        sz = min(last + 1, CAT_C[cat] - 1)
        for i in range(sz):
            bit = (mask >> i) & 1
            co = SIG_MAP8[i] if cat == 5 else i
            lo = LAST_MAP8[i] if cat == 5 else i
            self.decision(SIG_BASE[cat] + co, bit)
            if bit:
                self.decision(LAST_BASE[cat] + lo,
                              1 if i == last else 0)

    def level(self, absm1: int, sign: int):
        base = LVL_BASE[self.cat]
        prefix = min(absm1, 14)
        self.decision(base + L1_CTX[self.node], 1 if prefix > 0 else 0)
        cg = base + GT1_CTX[self.node]
        for _ in range(max(prefix - 1, 0)):
            self.decision(cg, 1)
        if 0 < prefix < 14:
            self.decision(cg, 0)
        if prefix >= 14:
            self.ue_bypass(absm1 - 14, 0)
        self.bypass(sign)
        self.node = NODE_TRANS[1 if prefix > 0 else 0][self.node]

    def flush(self):
        """EncodeTerminate(1) + EncodeFlush (spec 9.3.4.3.5/.6), then
        zero-pad to the byte boundary (the rbsp stop bit is the forced
        1 of the flush's final 2 written bits)."""
        self.low += self.range - 2
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        tail = ((self.low >> 7) & 3) | 1
        self._raw_bit((tail >> 1) & 1)
        self._raw_bit(tail & 1)
        while self.nbits:
            self._raw_bit(0)

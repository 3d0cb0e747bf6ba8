"""Bitstream writer + NAL packaging (common/bs.h, x264_nal_encode).

The writer collects (value, length) code pairs and packs them into bytes in
one vectorized NumPy pass — the host-side mirror of the device-side code
emission (the jitted pipelines produce exactly such (value, length) arrays,
so the two compose: device computes codes, host concatenates and packs).
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """MSB-first bitstream builder (bs_t, common/bs.h:42-51)."""

    def __init__(self):
        self._vals: list[int] = []
        self._lens: list[int] = []
        self._nbits = 0

    # ---------------------------------------------------------------- core
    def put(self, value: int, nbits: int):
        """bs_write (common/bs.h:95): write nbits of value, MSB first."""
        if nbits == 0:
            return
        assert 0 <= nbits, nbits
        value &= (1 << nbits) - 1
        while nbits > 48:       # keep packer codes <= 48 bits
            hi = nbits - 48
            self._vals.append(value >> 48)
            self._lens.append(hi)
            self._nbits += hi
            value &= (1 << 48) - 1
            nbits = 48
        self._vals.append(value)
        self._lens.append(nbits)
        self._nbits += nbits

    def put_codes(self, vals, lens):
        """Append arrays of (value, length) pairs (device-produced codes).
        Entries with length 0 are skipped."""
        vals = np.asarray(vals, dtype=np.int64).ravel()
        lens = np.asarray(lens, dtype=np.int64).ravel()
        keep = lens > 0
        self._vals.extend(int(v) for v in vals[keep])
        self._lens.extend(int(l) for l in lens[keep])
        self._nbits += int(lens[keep].sum())

    # --------------------------------------------------------------- exp-golomb
    def ue(self, v: int):
        """Unsigned Exp-Golomb (bs_write_ue)."""
        n = (v + 1).bit_length()
        self.put(v + 1, 2 * n - 1)

    def se(self, v: int):
        """Signed Exp-Golomb (bs_write_se)."""
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, x: int, v: int):
        """Truncated Exp-Golomb (bs_write_te)."""
        if x == 1:
            self.put(1 - v, 1)
        elif x > 1:
            self.ue(v)

    def bit(self, b):
        self.put(int(bool(b)), 1)

    # --------------------------------------------------------------- trailer
    def rbsp_trailing(self):
        """bs_rbsp_trailing: stop bit + align to byte."""
        self.put(1, 1)
        pad = (-self._nbits) % 8
        if pad:
            self.put(0, pad)

    @property
    def bit_pos(self) -> int:
        return self._nbits

    # --------------------------------------------------------------- pack
    def pack(self) -> bytes:
        """Pack all queued codes into bytes (vectorized)."""
        if not self._vals:
            return b""
        vals = np.asarray(self._vals, dtype=np.uint64)
        lens = np.asarray(self._lens, dtype=np.int64)
        ends = np.cumsum(lens)
        starts = ends - lens
        total_bits = int(ends[-1])
        nbytes = (total_bits + 7) // 8
        out = np.zeros(nbytes + 8, dtype=np.uint8)
        # each code is placed into an 8-byte window starting at its byte
        byte_start = (starts >> 3).astype(np.int64)
        bit_off = (starts & 7).astype(np.int64)
        # align value to MSB of the 64-bit window: shift left by
        # (64 - bit_off - len)
        shift = (64 - bit_off - lens).astype(np.uint64)
        w = (vals << shift)
        # split into 8 big-endian bytes
        b = np.empty((len(vals), 8), dtype=np.uint8)
        for k in range(8):
            b[:, k] = ((w >> np.uint64(56 - 8 * k)) & np.uint64(0xFF)).astype(np.uint8)
        idx = byte_start[:, None] + np.arange(8)[None, :]
        np.bitwise_or.at(out, idx.ravel(), b.ravel())
        return out[:nbytes].tobytes()


def _nal_escape_scalar(payload, start: int, zeros: int) -> bytes:
    out = bytearray(payload[:start])
    for byte in payload[start:]:
        if zeros >= 2 and byte <= 3:
            out.append(3)
            zeros = 0
        out.append(byte)
        zeros = zeros + 1 if byte == 0 else 0
    return bytes(out)


def nal_escape(payload: bytes) -> bytes:
    """Emulation prevention (x264_nal_encode, x264.h:405-409): insert 0x03
    after any 00 00 when the next byte is <= 0x03.

    Vectorized candidate detection; escape sequences are rare in
    compressed data, so the scalar fixup only runs from the first
    candidate onward (usually never)."""
    if len(payload) < 3:
        return payload
    b = np.frombuffer(payload, dtype=np.uint8)
    cand = (b[:-2] == 0) & (b[1:-1] == 0) & (b[2:] <= 3)
    hits = np.flatnonzero(cand)
    if hits.size == 0:
        return payload
    # at the first candidate, exactly two zeros precede it (any longer
    # zero run would itself have been an earlier candidate)
    first = int(hits[0])            # escape needed at byte first+2
    return _nal_escape_scalar(payload, first + 2, 2)


def nal_unit(nal_type: int, ref_idc: int, rbsp: bytes,
             long_startcode: bool = True) -> bytes:
    """Annex-B NAL: startcode + header byte + escaped RBSP."""
    start = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    header = bytes([(ref_idc << 5) | nal_type])
    return start + header + nal_escape(rbsp)


# NAL types (x264.h NAL_*)
NAL_SLICE = 1
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9

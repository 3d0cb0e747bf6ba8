"""Custom quantization matrices (CQM).

Plays the roles of x264_cqm_parse_file / x264_cqm_parse_jmlist
(common/set.c:198-270: the JM-config-format matrix file reader) and
scaling_list_write (encoder/set.c:42-80: PPS pic_scaling_matrix
signaling, spec 7.3.2.1.1.1). Matrices are held in RASTER coefficient
order (the QuantTables layout); the bitstream carries them in zig-zag
scan order.
"""

from __future__ import annotations

import numpy as np

from . import tables

CQM_FLAT, CQM_JVT, CQM_CUSTOM = 0, 1, 2

# spec default (a.k.a. "JVT") scaling lists, raster order
# (Table 7-3 / 7-4 values)
JVT_4IY = np.array([
    6, 13, 20, 28,
    13, 20, 28, 32,
    20, 28, 32, 37,
    28, 32, 37, 42], np.int64)
JVT_4PY = np.array([
    10, 14, 20, 24,
    14, 20, 24, 27,
    20, 24, 27, 30,
    24, 27, 30, 34], np.int64)
JVT_8IY = np.array([
    6, 10, 13, 16, 18, 23, 25, 27,
    10, 11, 16, 18, 23, 25, 27, 29,
    13, 16, 18, 23, 25, 27, 29, 31,
    16, 18, 23, 25, 27, 29, 31, 33,
    18, 23, 25, 27, 29, 31, 33, 36,
    23, 25, 27, 29, 31, 33, 36, 38,
    25, 27, 29, 31, 33, 36, 38, 40,
    27, 29, 31, 33, 36, 38, 40, 42], np.int64)
JVT_8PY = np.array([
    9, 13, 15, 17, 19, 21, 22, 24,
    13, 13, 17, 19, 21, 22, 24, 25,
    15, 17, 19, 21, 22, 24, 25, 27,
    17, 19, 21, 22, 24, 25, 27, 28,
    19, 21, 22, 24, 25, 27, 28, 30,
    21, 22, 24, 25, 27, 28, 30, 32,
    22, 24, 25, 27, 28, 30, 32, 33,
    24, 25, 27, 28, 30, 32, 33, 35], np.int64)

# default (fallback) list per spec list index 0..7 = 4x4 IntraY, IntraCb,
# InterY, InterCb, 8x8 IntraY, InterY in OUR storage order
# [4IY, 4PY, 4IC, 4PC] + [8IY, 8PY]
_JVT4 = (JVT_4IY, JVT_4PY, JVT_4IY, JVT_4PY)
_JVT8 = (JVT_8IY, JVT_8PY)

_JM_SECTIONS = (
    ("INTRA4X4_LUMA", "cqm_4iy", JVT_4IY, 16),
    ("INTRA4X4_CHROMA", "cqm_4ic", JVT_4IY, 16),
    ("INTER4X4_LUMA", "cqm_4py", JVT_4PY, 16),
    ("INTER4X4_CHROMA", "cqm_4pc", JVT_4PY, 16),
    ("INTRA8X8_LUMA", "cqm_8iy", JVT_8IY, 64),
    ("INTER8X8_LUMA", "cqm_8py", JVT_8PY, 64),
)


def parse_jm_file(text: str) -> dict:
    """Parse a JM-format matrix config: '#' comments; sections named as
    in _JM_SECTIONS (optionally suffixed U/V); values in raster order;
    a first coefficient of 0 selects the JVT default; a missing section
    means flat 16 (x264_cqm_parse_file semantics). Raises ValueError on
    out-of-range or short lists."""
    import re
    text = re.sub(r"#[^\n]*", " ", text)
    out = {}
    for name, key, jvt, length in _JM_SECTIONS:
        m = re.search(re.escape(name) + r"[UV]?\s*:?", text)
        if m is None:
            out[key] = np.full(length, 16, np.int64)
            continue
        tail = text[m.end():]
        nums = re.findall(r"\d+", tail)[:length]
        if nums and int(nums[0]) == 0:
            out[key] = jvt.copy()
            continue
        if len(nums) < length:
            raise ValueError(f"not enough coefficients in list '{name}'")
        vals = np.array([int(x) for x in nums], np.int64)
        if vals.min() < 1 or vals.max() > 255:
            raise ValueError(f"bad coefficient in list '{name}'")
        out[key] = vals
    return out


def scaling_lists(preset: int, custom: dict | None = None):
    """(scaling_list4 (4,16), scaling_list8 (2,64)) in the QuantTables
    list order [4IY, 4PY, 4IC, 4PC] / [8IY, 8PY]; None for flat."""
    if preset == CQM_FLAT:
        return None, None
    if preset == CQM_JVT:
        return (np.stack(_JVT4), np.stack(_JVT8))
    c = custom or {}
    flat16 = np.full(16, 16, np.int64)
    flat64 = np.full(64, 16, np.int64)
    sl4 = np.stack([np.asarray(c.get("cqm_4iy", flat16)),
                    np.asarray(c.get("cqm_4py", flat16)),
                    np.asarray(c.get("cqm_4ic", flat16)),
                    np.asarray(c.get("cqm_4pc", flat16))])
    sl8 = np.stack([np.asarray(c.get("cqm_8iy", flat64)),
                    np.asarray(c.get("cqm_8py", flat64))])
    return sl4, sl8


def write_scaling_list(bs, lst, def_list, jvt_list, size: int):
    """One scaling_list() element (spec 7.3.2.1.1.1; the
    scaling_list_write role, encoder/set.c:42-80): absent when equal to
    its fall-back, delta -8 at j=0 when equal to the spec default, else
    explicit deltas with trailing-run compression."""
    zig = tables.ZIGZAG4 if size == 16 else tables.ZIGZAG8
    lst = np.asarray(lst, np.int64)
    if np.array_equal(lst, def_list):
        bs.bit(0)                  # scaling_list_present_flag
        return
    bs.bit(1)
    if np.array_equal(lst, jvt_list):
        bs.se(-8)                  # nextScale 0 at j=0 -> use default
        return
    scan = lst[np.asarray(zig)]
    run = size
    while run > 1 and scan[run - 1] == scan[run - 2]:
        run -= 1
    # trailing-run compression only pays when the freeze delta is
    # shorter than the saved explicit deltas (reference heuristic)
    last = 8
    for j in range(run):
        d = int(scan[j]) - last
        bs.se(((d + 128) % 256) - 128)
        last = int(scan[j])
    if run < size:
        bs.se(((-last + 128) % 256) - 128)   # nextScale 0: freeze


def read_scaling_list(br, size: int, fallback, jvt_list):
    """Decode one scaling_list() element; returns the raster-order
    list (spec 7.3.2.1.1.1 incl. useDefault at j=0)."""
    zig = np.asarray(tables.ZIGZAG4 if size == 16 else tables.ZIGZAG8)
    if not br.bit():
        return np.asarray(fallback, np.int64).copy()
    scan = np.zeros(size, np.int64)
    last, nxt = 8, 8
    for j in range(size):
        if nxt != 0:
            delta = br.se()
            nxt = (last + delta + 256) % 256
            if j == 0 and nxt == 0:
                return np.asarray(jvt_list, np.int64).copy()
        scan[j] = last if nxt == 0 else nxt
        last = int(scan[j])
    out = np.zeros(size, np.int64)
    out[zig] = scan
    return out

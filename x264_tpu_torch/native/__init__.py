"""Native (C) runtime components.

The compute path is PyTorch with hand-written CUDA kernels; the
inherently-serial byte-emission tail (CABAC's carry-propagating
arithmetic coder) runs as a small C library on the host, compiled on
first use with the system compiler into ``build/`` at the repository
root (the role common/cabac.c's compiled code plays in the reference).
A pure-Python twin of identical semantics (entropy/cabac.py) keeps
everything functional without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)), "build")
_lib = None
_tried = False


def load():
    """Compile (once, rebuilt when the source is newer) and load the
    native library. Returns the ctypes CDLL or None if no C compiler is
    available."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    src = os.path.join(_SRC_DIR, "cabac.c")
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, "libx264torch_cabac.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        tmp = f"{so}.{os.getpid()}.tmp"
        for cc in ("cc", "gcc", "clang"):
            try:
                r = subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", src, "-o", tmp],
                    capture_output=True)
            except FileNotFoundError:
                continue
            if r.returncode == 0:
                os.replace(tmp, so)
                break
        else:
            return None
    lib = ctypes.CDLL(so)
    lib.cabac_encode.restype = ctypes.c_long
    lib.cabac_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_char_p]
    _lib = lib
    return _lib

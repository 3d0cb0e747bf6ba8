"""Build and bind the hand-written CUDA kernels of csrc/.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into ``build/libx264torch_<name>.so`` at the repository
root, exposes plain C entry points that return the ``cudaError_t`` of
their launches, and is loaded with ``ctypes``: pointers travel as
``c_void_p``, ints as ``c_int``, floats as ``c_float``, and every
launch goes on PyTorch's current stream. A build or launch that fails
raises; there is no fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
# kernel sources; each builds into its own shared library
SOURCES = ("intra", "deblock", "cabac_ops", "me", "inter", "intra_p", "mc",
           "subpel", "rdcost", "lookahead", "aq", "cavlc", "trellis",
           "badapt", "direct", "nr", "hwpack", "halo", "pixel", "metrics")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
_fns: dict = {}


def nvcc() -> str:
    """Path of nvcc: PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libx264torch_{name}.so")


def _stale(name: str) -> bool:
    so = _so(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
            if f == f"{name}.cu" or f.endswith(".cuh")]
    return any(os.path.getmtime(d) > os.path.getmtime(so) for d in deps)


def build(names=SOURCES) -> float:
    """Compile the stale kernel libraries, one nvcc process per source,
    all started together. Returns the wall seconds; raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = nvcc()
    procs = []
    for n in todo:
        tmp = f"{_so(n)}.{os.getpid()}.tmp"
        cmd = [cc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            continue
        os.replace(tmp, _so(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if stale."""
    if name not in _libs:
        build((name,))
        _libs[name] = ctypes.CDLL(_so(name))
    return _libs[name]


def function(name: str, fn: str, sig: str):
    """C entry point `fn` of csrc/<name>.cu with its argument types set
    from `sig`: one letter per argument, 'p' pointer (and the stream),
    'i' int, 'f' float. The entry point returns the cudaError_t of its
    launches."""
    key = (name, fn)
    if key not in _fns:
        f = getattr(lib(name), fn)
        types = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        f.argtypes = [types[c] for c in sig]
        f.restype = ctypes.c_int
        _fns[key] = f
    return _fns[key]


def launch(name: str, fn: str, sig: str, *args) -> None:
    """Call a C entry point and raise if it reports a CUDA error."""
    err = function(name, fn, sig)(*args)
    if err != 0:
        raise RuntimeError(f"{name}.cu:{fn} failed with cudaError {err}")


def stream(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def check(t: torch.Tensor, shape, dtype, what: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of shape / dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _tool(name: str) -> str | None:
    """A CUDA toolkit program: PATH, then beside nvcc."""
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.path.dirname(nvcc()), name)
    return path if os.path.exists(path) else None


def resources(name: str, build_dir: str = BUILD_DIR) -> list:
    """Each kernel of build_dir/libx264torch_<name>.so as the card holds
    it: [{kernel, regs, local, shared, threads, ctas}], registers a
    thread, local-memory bytes a thread, static shared bytes a CTA, the
    CTA size its launch bounds give and the CTAs an SM can hold at that
    size (libcuda's occupancy query). cuobjdump extracts the sm_90a
    cubin and lists its functions; libcuda loads it into the current
    context (the caller has used the card through torch)."""
    import tempfile
    so = os.path.abspath(os.path.join(build_dir, f"libx264torch_{name}.so"))
    dump, filt = _tool("cuobjdump"), _tool("cu++filt")
    torch.empty(1, device="cuda")            # the context, made current
    if dump is None:
        raise RuntimeError("cuobjdump not found")
    drv = ctypes.CDLL("libcuda.so.1")
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([dump, "-xelf", "all", so], cwd=tmp, check=True,
                       capture_output=True)
        for cubin in sorted(f for f in os.listdir(tmp) if f.endswith(".cubin")):
            path = os.path.join(tmp, cubin)
            usage = subprocess.run([dump, "--dump-resource-usage", path],
                                   check=True, capture_output=True,
                                   text=True).stdout
            mod = ctypes.c_void_p()
            if drv.cuModuleLoad(ctypes.byref(mod), path.encode()) != 0:
                raise RuntimeError(f"libcuda did not load {cubin}")
            for fn in re.findall(r"Function (\S+):", usage):
                f = ctypes.c_void_p()
                if drv.cuModuleGetFunction(ctypes.byref(f), mod,
                                           fn.encode()) != 0:
                    raise RuntimeError(f"{cubin} has no function {fn}")
                val = {}
                for key, attr in (("threads", 0), ("shared", 1),
                                  ("local", 3), ("regs", 4)):
                    v = ctypes.c_int()
                    drv.cuFuncGetAttribute(ctypes.byref(v), attr, f)
                    val[key] = v.value
                n = ctypes.c_int()
                drv.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                    ctypes.byref(n), f, val["threads"], ctypes.c_size_t(0))
                readable = fn
                if filt:
                    readable = subprocess.run([filt, fn], capture_output=True,
                                              text=True).stdout.strip() or fn
                out.append(dict(kernel=readable, ctas=n.value, **val))
            drv.cuModuleUnload(mod)
    return out

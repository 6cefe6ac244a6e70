"""Build, load and bind the port's hand-written CUDA kernels.

The sources under datum_tpu_torch/csrc/ are compiled by `nvcc` into one
shared library with a plain C interface, at first use, into
datum_tpu_torch/_build/ (named by a hash of the sources and flags, so
an edited source rebuilds).  Each source compiles in its own nvcc
process, all started together; one more nvcc links the objects.  The library is loaded with ctypes;
pointers and the CUDA stream are passed as c_void_p.  Nothing here runs
at import time: the CPU tests import every module.

Flags: sm_90a (Hopper), -O3, and -fmad=false — without it nvcc contracts
`a*x + b*y + c` into FMAs, edge and depth values move by an ulp against
the plain PyTorch versions and edge-pixel winners flip.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("raster_shade.cu", "raster_shade_2p.cu", "shade.cu", "raster_depth.cu",
           "raster_blend.cu", "shade_epilogue.cu", "raster_v1.cu", "raster_mxu.cu",
           "gather_rows.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, build_log: str):
        self.path = path
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.raster_shade_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f,
                                                 i, i, p, p]
        self.lib.raster_shade_launch.restype = i
        self.lib.raster_shade_2p_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, f,
                                                    f, i, i, p, p]
        self.lib.raster_shade_2p_launch.restype = i
        self.lib.raster_shade_2p_smem_bytes.argtypes = [i, i]
        self.lib.raster_shade_2p_smem_bytes.restype = i
        self.lib.shade_smem_bytes.argtypes = [i, i, i, i]
        self.lib.shade_smem_bytes.restype = i
        self.lib.shade_launch.argtypes = [p, p, i, i, i, p, p, i, p, p, i, p, i, p,
                                          i, p, i, p, p, i, i, i, f, f, p, p]
        self.lib.shade_launch.restype = i
        self.lib.raster_depth_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, f,
                                                 i, p, p]
        self.lib.raster_depth_launch.restype = i
        self.lib.raster_blend_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                                 f, f, i, p, p]
        self.lib.raster_blend_launch.restype = i
        self.lib.shade_epilogue_launch.argtypes = [p, p, p, p, p, i, i, p, p]
        self.lib.shade_epilogue_launch.restype = i
        self.lib.raster_v1_launch.argtypes = [p, p, p, p, i, i, i, i, f, f, i, p, p]
        self.lib.raster_v1_launch.restype = i
        self.lib.raster_mxu_launch.argtypes = [p, p, p, p, i, i, i, i, f, f, i, p, p]
        self.lib.raster_mxu_launch.restype = i
        self.lib.gather_rows_launch.argtypes = [p, p, ctypes.c_longlong, i, p, p]
        self.lib.gather_rows_launch.restype = i


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _build() -> KernelLibrary:
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libdatum_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return KernelLibrary(out, "(cached build)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "\n".join(logs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed ({[p.returncode for p in procs]}):\n"
                           f"{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return KernelLibrary(out, log)


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The kernel library, built and loaded on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = _build()
    return _LIBRARY


def check(code: int, what: str):
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {code})")


def check_tensors(what: str, device, checks):
    """Raise ValueError unless every (name, tensor, dtype, shape) of
    checks is a contiguous tensor of that dtype and shape on device."""
    for name, t, dt, shape in checks:
        if t.device != device or t.dtype != dt or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

"""Build, load and bind the port's hand-written CUDA kernels.

The sources under datum_tpu_torch/csrc/ are compiled by `nvcc` into one
shared library with a plain C interface, at first use, into
datum_tpu_torch/_build/ (named by a hash of the sources and of each
source's flags, so an edited source or flag rebuilds).  Each source
compiles in its own nvcc process, all started together; one more nvcc
links the objects.  The library is loaded with ctypes; pointers and the
CUDA stream are passed as c_void_p.  Nothing here runs at import time:
the CPU tests import every module.

Flags (`nvcc_flags`): sm_90a (Hopper), -O3, -Xptxas -v (registers and
spill, kept per source in KernelLibrary.logs), and -fmad=false for every
source but those of FMAD_SOURCES.  Without -fmad=false nvcc contracts
`a*x + b*y + c` into FMAs, edge and depth values move by an ulp against
the plain PyTorch versions and edge-pixel winners flip: the rasters (K1,
K6, K3, K4, K5, K7), the K2 epilogue, the gather and the sprite pass
are held to their plain versions bit for bit and keep it.  K2 (shade.cu) is held within
atol 1e-4 / rtol 1e-3 and takes -fmad=true: nvcc fuses its shading
terms' multiply-adds, while its view and light geometry, whose rounding
the GGX highlight of a smooth surface magnifies, is written with
__fmul_rn / __fadd_rn, which nvcc never contracts.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("raster_shade.cu", "raster_shade_2p.cu", "shade.cu", "raster_depth.cu",
           "raster_blend.cu", "shade_epilogue.cu", "raster_v1.cu", "raster_mxu.cu",
           "gather_rows.cu", "sprite_pass.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# the flags of every source but those of FMAD_SOURCES
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
FMAD_SOURCES = ("shade.cu",)       # held to a tolerance: nvcc may contract


def nvcc_flags(source: str, fmad: bool | None = None) -> tuple:
    """The nvcc flags of one source (a file name under csrc/); fmad
    overrides FMAD_SOURCES (for builds of other versions of a source)."""
    if fmad is None:
        fmad = source in FMAD_SOURCES
    return tuple("-fmad=true" if f == "-fmad=false" and fmad else f for f in NVCC_FLAGS)


def compile_commands(nvcc: str, sources, objects, fmad: bool | None = None) -> list:
    """One nvcc command line per source: compile it to its object (fmad:
    as in nvcc_flags)."""
    return [[nvcc, *nvcc_flags(Path(s).name, fmad), "-c", "-o", str(o), str(s)]
            for s, o in zip(sources, objects)]


def library_path(sources=None) -> Path:
    """Where the build of these sources (default SOURCES) lands: named by
    a hash of every source's flags and bytes."""
    h = hashlib.sha256()
    for s in (sources or [CSRC / n for n in SOURCES]):
        h.update(" ".join(nvcc_flags(Path(s).name)).encode())
        h.update(Path(s).read_bytes())
    return BUILD_DIR / f"libdatum_tpu_torch_{h.hexdigest()[:16]}.so"


# argtypes of every C entry point, by name (p: pointer, i: int, f: float,
# L: long long)
_SIGNATURES = dict(
    raster_shade_launch="ppppppiiiiiffiipp",
    raster_shade_2p_launch="ppppppiiiiiffiipp",
    raster_shade_2p_smem_bytes="ii",
    shade_smem_bytes="iiii",
    shade_launch="ppiiippippipipipppiiiffpp",
    raster_depth_launch="pppppiiiiffipp",
    raster_blend_launch="ppppppiiiiiiffipp",
    shade_epilogue_launch="pppppiipp",
    raster_v1_launch="ppppiiiiffiipp",
    raster_mxu_launch="ppppiiiiffipp",
    gather_rows_launch="ppLipp",
    sprite_pass_launch="ppiipppppppipiiip",
)


class KernelLibrary:
    """The loaded shared library plus what its build reported: logs maps
    each source's name to nvcc's output for it."""

    def __init__(self, path: Path, logs: dict):
        self.path = path
        self.logs = logs
        self.lib = ctypes.CDLL(str(path))
        types = dict(p=ctypes.c_void_p, i=ctypes.c_int, f=ctypes.c_float,
                     L=ctypes.c_longlong)
        for name, sig in _SIGNATURES.items():
            fn = getattr(self.lib, name, None)      # a library of one source
            if fn is not None:
                fn.argtypes = [types[c] for c in sig]
                fn.restype = ctypes.c_int

    def ptxas(self, source: str) -> dict:
        """What ptxas reported for the kernels of one source: the most
        registers and spill-store bytes over its entry functions."""
        log = self.logs.get(source, "")
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
        spill = [int(v) for v in re.findall(r"(\d+) bytes spill stores", log)]
        return dict(registers=max(regs, default=None), spill_bytes=max(spill, default=None))


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _compile(sources, out: Path, commands) -> dict:
    """Run the compile commands together, link their objects into out;
    returns nvcc's output per source name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in commands]
    logs = {Path(s).name: p.communicate()[0] for s, p in zip(sources, procs)}
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed ({[p.returncode for p in procs]}):\n"
                           + "\n".join(logs.values()))
    objs = [c[c.index("-o") + 1] for c in commands]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([commands[0][0], *ARCH, "-shared", "-o", str(tmp), *objs],
                         capture_output=True, text=True)
    for o in objs:
        Path(o).unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    out.with_suffix(".log.json").write_text(json.dumps(logs))
    os.replace(tmp, out)
    return logs


def _build() -> KernelLibrary:
    srcs = [CSRC / s for s in SOURCES]
    out = library_path(srcs)
    if out.exists():
        return KernelLibrary(out, json.loads(out.with_suffix(".log.json").read_text()))
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    return KernelLibrary(out, _compile(srcs, out, compile_commands(_nvcc(), srcs, objs)))


def build_version(source: Path, fmad: bool, name: str) -> KernelLibrary:
    """Another version of one kernel source (its own library, binding the
    entry points it defines), built with -fmad=true or false: for timing
    versions of a kernel side by side (chip_smoke.py --versions)."""
    out = BUILD_DIR / "versions" / (re.sub(r"[^A-Za-z0-9_.-]", "_", name) + ".so")
    out.parent.mkdir(parents=True, exist_ok=True)
    return KernelLibrary(out, _compile([source], out, compile_commands(
        _nvcc(), [source], [out.with_suffix(".o")], fmad)))


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The kernel library, built and loaded on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = _build()
    return _LIBRARY


class using:
    """Launch the entry points a version's library defines from it while
    the with-block runs (the others from the main library)."""

    def __init__(self, version: KernelLibrary):
        self.version = version

    def __enter__(self):
        global _LIBRARY
        self.main = library()
        _LIBRARY = copy.copy(self.main)
        _LIBRARY.lib = _Merged(self.version.lib, self.main.lib)

    def __exit__(self, *exc):
        global _LIBRARY
        _LIBRARY = self.main


class _Merged:
    """Entry points of one library, falling back to another's."""

    def __init__(self, first, second):
        self._first, self._second = first, second

    def __getattr__(self, name):
        fn = getattr(self._first, name, None)
        return fn if fn is not None else getattr(self._second, name)


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


# the enrolled launchers, in the order enrolled (render/framegraph.py
# reads and adjusts their counts around its captures and replays)
ENROLLED = []

# the recorder of the frame graph being captured (render/framegraph.py),
# or None: it takes launch_eager's calls and device_cached's constants
recorder = None


def enroll(fn):
    """A hand-written kernel's launcher, enrolled: fn, counting in its
    attribute `launches` each call that returns, and in ENROLLED."""
    @functools.wraps(fn)
    def launcher(*args, **kw):
        out = fn(*args, **kw)
        launcher.launches += 1
        return out
    launcher.launches = 0
    ENROLLED.append(launcher)
    return launcher


def launch_counts():
    """The launches of every enrolled launcher, in ENROLLED's order."""
    return [fn.launches for fn in ENROLLED]


def launches_since(before):
    """Each enrolled launcher's launches since launch_counts() gave
    before (one enrolled after it counts from 0)."""
    return [n - (before[i] if i < len(before) else 0)
            for i, n in enumerate(launch_counts())]


def add_launches(counts):
    """Add counts (as launches_since gives them) to the enrolled
    launchers' counts."""
    for fn, n in zip(ENROLLED, counts):
        fn.launches += n


def launch_eager(module, name, **kw):
    """module.<name>(**kw), looked up at the call: the launch of a kernel
    that the frame graph keeps out of its CUDA graphs (K1 or K6, K2, K5
    and K4, which the benchmark's roofline readers find by wrapping their
    module attributes).  kw carries the preallocated output, `out`.  While a
    frame graph is being captured its recorder takes the call instead,
    and each replay makes it between two of the graphs."""
    if recorder is not None:
        return recorder.between(module, name, kw)
    return getattr(module, name)(**kw)


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

"""The nvcc command lines of the port's kernels, built without running
nvcc (CPU).

The rasters (K1, K6, K3, K4, K5, K7), the K2 epilogue and the gather
are held to their plain versions bit for bit, which needs -fmad=false
(nvcc would otherwise contract a*x + b*y + c into FMAs and move edge and
depth values by an ulp); K2 (shade.cu) is held to a tolerance and takes
-fmad=true (its view and light geometry keeps the plain version's
rounding through __fmul_rn / __fadd_rn, which nvcc does not contract);
the deferred lighting pass (lighting.cu), held to K2's tolerance, keeps
-fmad=false.
The hash that names the library covers every source's flags, so a
changed flag rebuilds."""

import re
import shutil
import subprocess

import pytest

from datum_tpu_torch.ops import _kernels

RASTERS = ("raster_shade.cu", "raster_shade_2p.cu", "raster_depth.cu",
           "raster_blend.cu", "raster_v1.cu", "raster_mxu.cu")


@pytest.fixture
def no_nvcc(monkeypatch):
    """Fail the test if anything starts a process."""
    def refuse(*a, **k):
        raise AssertionError(f"started a process: {a}")
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)


def _commands():
    srcs = [_kernels.CSRC / s for s in _kernels.SOURCES]
    objs = [f"/build/{s}.o" for s in _kernels.SOURCES]
    return dict(zip(_kernels.SOURCES, _kernels.compile_commands("nvcc", srcs, objs)))


def test_every_source_compiles_alone_for_hopper(no_nvcc):
    cmds = _commands()
    assert set(cmds) == set(_kernels.SOURCES)
    for name, cmd in cmds.items():
        assert cmd[0] == "nvcc" and cmd[-1].endswith(name)
        assert cmd[cmd.index("-o") + 1] == f"/build/{name}.o" and "-c" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        assert sum(f.startswith("-fmad=") for f in cmd) == 1, name


# lighting.cu is held to a tolerance, but it is bound by bytes: it keeps
# every operation rounded as its plain version's
@pytest.mark.parametrize("name", RASTERS + ("shade_epilogue.cu", "gather_rows.cu",
                                            "sprite_pass.cu", "lighting.cu"))
def test_bit_exact_sources_keep_fmad_false(no_nvcc, name):
    cmd = _commands()[name]
    assert "-fmad=false" in cmd and "-fmad=true" not in cmd


def test_shade_takes_fmad_true(no_nvcc):
    assert _kernels.FMAD_SOURCES == ("shade.cu",)
    cmd = _commands()["shade.cu"]
    assert "-fmad=true" in cmd and "-fmad=false" not in cmd
    # the flags otherwise equal every other source's
    other = _commands()["raster_depth.cu"]
    strip = lambda c: [f for f in c if not f.startswith("-fmad=") and "/" not in f
                       and not f.endswith(".cu")]
    assert strip(cmd) == strip(other)


def test_library_name_covers_flags_and_sources(no_nvcc, monkeypatch, tmp_path):
    base = _kernels.library_path()
    assert base.parent == _kernels.BUILD_DIR
    monkeypatch.setattr(_kernels, "FMAD_SOURCES", ())
    no_fmad = _kernels.library_path()
    monkeypatch.setattr(_kernels, "FMAD_SOURCES", ("shade.cu", "raster_depth.cu"))
    more = _kernels.library_path()
    monkeypatch.setattr(_kernels, "FMAD_SOURCES", ("shade.cu",))
    assert len({base, no_fmad, more}) == 3
    assert _kernels.library_path() == base
    # an edited source renames the library too
    srcs = []
    for s in _kernels.SOURCES:
        shutil.copy(_kernels.CSRC / s, tmp_path / s)
        srcs.append(tmp_path / s)
    assert _kernels.library_path(srcs) == base
    (tmp_path / "shade.cu").write_text((tmp_path / "shade.cu").read_text() + "\n")
    assert _kernels.library_path(srcs) != base


def test_version_flags_override(no_nvcc):
    """A build of another version of a source picks its own -fmad."""
    assert "-fmad=false" in _kernels.nvcc_flags("shade.cu", fmad=False)
    assert "-fmad=true" in _kernels.nvcc_flags("raster_depth.cu", fmad=True)


def test_ptxas_report_per_source():
    """Registers and spill stores, the most over a source's entries."""
    lib = _kernels.KernelLibrary.__new__(_kernels.KernelLibrary)
    lib.logs = {"shade.cu": (
        "ptxas info    : Compiling entry function 'a' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function 'b' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"),
        "raster_depth.cu": "(cached build)"}
    assert lib.ptxas("shade.cu") == dict(registers=128, spill_bytes=8)
    assert lib.ptxas("raster_depth.cu") == dict(registers=None, spill_bytes=None)


def test_using_routes_a_versions_entry_points(monkeypatch):
    """chip_smoke.py --versions launches a kernel from another build of
    its source: `using` takes the entry points that build defines from
    it, the rest from the main library, and restores the main library."""
    class Lib:
        def __init__(self, **fns):
            self.__dict__.update(fns)

    def fake(lib):
        k = _kernels.KernelLibrary.__new__(_kernels.KernelLibrary)
        k.lib, k.logs = lib, {}
        return k

    main = fake(Lib(shade_launch="main shade", raster_depth_launch="main k3"))
    version = fake(Lib(shade_launch="version shade"))
    monkeypatch.setattr(_kernels, "_LIBRARY", main)
    with _kernels.using(version):
        lib = _kernels.library().lib
        assert lib.shade_launch == "version shade"
        assert lib.raster_depth_launch == "main k3"
    assert _kernels.library() is main


def _c_signatures():
    """Each `extern "C"` entry point of csrc/*.cu, its arguments coded as
    in _kernels._SIGNATURES (p: pointer, i: int, f: float, L: long long)."""
    codes = {"int": "i", "float": "f", "long long": "L"}
    out = {}
    for src in sorted(_kernels.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            args = [a.strip() for a in m.group(2).split(",")]
            out[m.group(1)] = "".join(
                "p" if "*" in a else codes[a.rsplit(" ", 1)[0].removeprefix("const ")]
                for a in args)
    return out


@pytest.mark.parametrize("name", sorted(_kernels._SIGNATURES))
def test_argtypes_match_the_c_declaration(name):
    """ctypes passes what _SIGNATURES says: a code out of step with the
    source's declaration shifts every argument after it."""
    assert _c_signatures()[name] == _kernels._SIGNATURES[name]


def test_every_c_entry_point_has_argtypes():
    assert set(_c_signatures()) == set(_kernels._SIGNATURES)

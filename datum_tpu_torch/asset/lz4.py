"""LZ4 block codec: a ctypes binding to csrc/lz4.cpp, and the plain
Python codec beside it (counterpart of datum_tpu/asset/lz4.py).

Wire format: standard LZ4 blocks, the payload of a pack's CDAT chunks
(asset/pack.py).  `compress` and `decompress` always run the native
codec, which is built at first use with `g++ -O3 -fPIC -shared` into
datum_tpu_torch/_build/ (named by a hash of the source and the flags),
under a file lock and landed with os.replace, so that test workers and
the asset manager's threads never load a half-written library.  A
failed build raises with the compiler's output: there is no quiet drop
to the Python codec, which is ~100x slower.  `py_compress` and
`py_decompress` are that plain codec; tests and chip_smoke hold the two
against each other.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lz4.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the build of csrc/lz4.cpp lands: named by a hash of the
    flags and the source's bytes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblz4_{h.hexdigest()[:16]}.so"


def build(cxx: str = "g++") -> Path:
    """Compile csrc/lz4.cpp unless its build is there; returns its path.
    Raises RuntimeError with the compiler's output if the build fails
    (OSError if the compiler cannot be run)."""
    import fcntl

    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the lock is held until the file closes
    with open(BUILD_DIR / ".lz4.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():                # another process built it meanwhile
            return path
        tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.so")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"lz4.cpp build failed ({cxx} exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    return path


def native():
    """The loaded native codec (built at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.datum_lz4_decompress.restype = ctypes.c_long
            lib.datum_lz4_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
            lib.datum_lz4_compress.restype = ctypes.c_long
            lib.datum_lz4_compress.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_void_p,
                ctypes.c_long]
            _lib = lib
        return _lib


def decompress(src: bytes, dstcap: int) -> bytes:
    """Decompress one LZ4 block, producing at most dstcap bytes.  Raises
    ValueError on a corrupt block."""
    out = bytearray(dstcap)
    n = decompress_into(bytes(src), 0, len(src), out, 0)
    return bytes(out[:n])


def decompress_into(src: bytes, start: int, size: int, dst: bytearray, offset: int) -> int:
    """Decompress the block src[start:start + size] into dst from offset
    on, writing at most len(dst) - offset bytes; returns the bytes
    written.  Raises ValueError on a corrupt block.  (A pack's payload is
    decoded block by block into one buffer: no buffer a block, no copy.)"""
    if not (0 <= start and start + size <= len(src) and 0 <= offset <= len(dst)):
        raise ValueError("decompress_into: a range outside its buffer")
    sptr = ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p).value + start
    dbuf = (ctypes.c_char * len(dst)).from_buffer(dst)
    n = native().datum_lz4_decompress(sptr, size, ctypes.addressof(dbuf) + offset,
                                      len(dst) - offset)
    del dbuf
    if n < 0:
        raise ValueError("corrupt LZ4 block")
    return n


def compress(src: bytes, dstcap: int, start: int = 0) -> tuple[bytes, int]:
    """Compress as much of src[start:] as fits into dstcap output bytes.
    Returns (compressed bytes, input bytes consumed): the packer's
    contract for fixed-size output blocks.  (start walks a payload
    block by block without copying its tail.)"""
    src = bytes(src)
    if not 0 <= start <= len(src):
        raise ValueError(f"start {start} outside the {len(src)}-byte input")
    ptr = ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p).value + start
    out = ctypes.create_string_buffer(dstcap)
    consumed = ctypes.c_long(len(src) - start)
    n = native().datum_lz4_compress(ptr, ctypes.byref(consumed), out, dstcap)
    return out.raw[:n], consumed.value


# ---------------------------------------------------------------------------
# The plain codec (pure Python; the same streams as the native one)
# ---------------------------------------------------------------------------

def py_decompress(src: bytes, dstcap: int) -> bytes:
    ip, iend = 0, len(src)
    out = bytearray()
    while ip < iend:
        token = src[ip]
        ip += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                s = src[ip]
                ip += 1
                litlen += s
                if s != 255:
                    break
        out += src[ip:ip + litlen]
        ip += litlen
        if ip >= iend:
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        matchlen = token & 15
        if matchlen == 15:
            while True:
                s = src[ip]
                ip += 1
                matchlen += s
                if s != 255:
                    break
        matchlen += 4
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block")
        for i in range(matchlen):
            out.append(out[start + i])
        if len(out) > dstcap:
            raise ValueError("LZ4 output overflow")
    return bytes(out[:dstcap])


def py_compress(src: bytes, dstcap: int) -> tuple[bytes, int]:
    # greedy single-probe hash matcher; the same stream shape as the native one
    n = len(src)
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    ip = 0
    consumed_end = n

    def seq_size(litlen, matchlen):
        size = 1 + litlen
        if litlen >= 15:
            size += 1 + (litlen - 15) // 255
        if matchlen > 0:
            size += 2
            ml = matchlen - 4
            if ml >= 15:
                size += 1 + (ml - 15) // 255
        return size

    def emit(litlen, offset, matchlen):
        ml = matchlen - 4 if matchlen else 0
        out.append(((15 if litlen >= 15 else litlen) << 4)
                   | (15 if ml >= 15 and matchlen else (ml if matchlen else 0)))
        if litlen >= 15:
            rem = litlen - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[anchor:anchor + litlen])
        if matchlen:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while ip < n - 12:
        key = src[ip:ip + 4]
        cand = table.get(key, -1)
        table[key] = ip
        if cand >= 0 and ip - cand <= 0xFFFF:
            matchlen = 4
            while ip + matchlen < n - 5 and src[cand + matchlen] == src[ip + matchlen]:
                matchlen += 1
            litlen = ip - anchor
            if len(out) + seq_size(litlen, matchlen) + 1 > dstcap:
                break
            emit(litlen, ip - cand, matchlen)
            ip += matchlen
            anchor = ip
        else:
            ip += 1

    litlen = n - anchor
    while litlen > 0 and len(out) + seq_size(litlen, 0) > dstcap:
        litlen -= 1
        consumed_end -= 1
    emit(litlen, 0, 0)
    return bytes(out), anchor + litlen

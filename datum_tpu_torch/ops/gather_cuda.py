"""The row gather of the gather microbenchmark on the card.

Counterpart of profiling/prof_gather.py's Pallas `gather_kernel`
(`pallas_gather`: out[i] = tab[idx[i]], 524,288 indices into a
(16384, 16) f32 table); its body becomes csrc/gather_rows.cu.  No frame
path runs it: it is the microbenchmark's kernel, kept beside the ops
and timed by chip_smoke.py against the one PyTorch call `tab[idx]`.

`gather_rows` runs the CUDA kernel for CUDA tensors (`gather_rows_cuda`)
and the plain version `tab[idx]` for CPU tensors
(`gather_rows_reference`).  The result is the table's bits: both copy
rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels


def gather_rows_reference(tab, idx):
    """Plain PyTorch: (n, C) rows tab[idx]."""
    return tab[idx.long()]


def gather_rows_cuda(tab, idx, check_bounds=False):
    """The CUDA kernel: the same contract as gather_rows_reference for a
    contiguous (rows, C) f32 table with C a multiple of 4 and (n,) int32
    indices in [0, rows).  check_bounds: raise on an index outside that
    range first (a debug check: it reads a flag back from the card)."""
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rows_cuda needs CUDA tensors, got {dev}")
    if tab.dim() != 2 or tab.shape[1] % 4:
        raise ValueError(f"gather_rows_cuda: the table must be (rows, C) with C a "
                         f"multiple of 4, got {tuple(tab.shape)}")
    rows, cols = tab.shape
    _kernels.check_tensors("gather_rows_cuda", dev, [
        ("tab", tab, torch.float32, (rows, cols)),
        ("idx", idx, torch.int32, (idx.shape[0],))])
    if tab.data_ptr() % 16:
        raise ValueError("gather_rows_cuda: the table must be 16-byte aligned")
    if check_bounds and idx.numel() and bool(((idx < 0) | (idx >= rows)).any()):
        raise IndexError(f"gather_rows_cuda: an index lies outside [0, {rows})")
    out = torch.empty((idx.shape[0], cols), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    code = _kernels.library().lib.gather_rows_launch(
        vp(tab.data_ptr()), vp(idx.data_ptr()), idx.shape[0], cols // 4,
        vp(out.data_ptr()), vp(_kernels.stream_ptr(dev)))
    _kernels.check(code, "gather_rows")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def gather_rows(tab, idx):
    """out[i] = tab[idx[i]]: the kernel for CUDA tensors (it raises if it
    cannot launch), the plain version for CPU tensors."""
    if tab.is_cuda:
        return gather_rows_cuda(tab, idx)
    return gather_rows_reference(tab, idx)

"""The sprite and text pass on the card: csrc/sprite_pass.cu.

Counterpart of datum_tpu/ops/sprite_pass.py `composite_sprites`, which
the JAX package compiles as one XLA `fori_loop` over the instance
capacity S (each step ~35 element-wise ops on an R x R window).  Ported
as eager PyTorch that is ~35 launches a sprite; here it is one launch for
the whole pass.  One thread per display pixel of a 16 x 16 tile: the
block first collects, in draw order, the live sprites whose clamped
window covers its tile, then each thread walks that list and repeats
ops/sprite_pass.py::composite_sprites_reference's arithmetic a sprite
(built with -fmad=false: bit-equal to it on the card).  The kernel reads
the instance count from the device, so the host never waits for it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

_FIELDS = (("origin", 2), ("axis_x", 2), ("axis_y", 2), ("uv0", 2), ("uv1", 2),
           ("tint", 4))


@_kernels.enroll
def composite_sprites_cuda(rgb, inst, atlas, region=128):
    """The CUDA kernel: the contract of
    sprite_pass.composite_sprites_reference for a contiguous (H, W, 3) f32
    image, contiguous f32 instance arrays of one capacity S, an int32
    count () and a contiguous, 16-byte aligned (AH, AW, 4) f32 atlas, all
    on one CUDA device.  Returns a new image."""
    dev = rgb.device
    if dev.type != "cuda":
        raise ValueError(f"composite_sprites_cuda needs CUDA tensors, got {dev}")
    if rgb.dim() != 3 or atlas.dim() != 3 or atlas.shape[2] != 4:
        raise ValueError(f"composite_sprites_cuda: rgb (H, W, 3) and atlas (AH, AW, 4), "
                         f"got {tuple(rgb.shape)} and {tuple(atlas.shape)}")
    h, w = rgb.shape[:2]
    R = int(region)
    if not 1 <= R <= min(h, w):
        raise ValueError(f"composite_sprites: overlay region {R} exceeds image {h}x{w}")
    S = inst["origin"].shape[0]
    ah, aw = atlas.shape[:2]
    _kernels.check_tensors("composite_sprites_cuda", dev, [
        ("rgb", rgb, torch.float32, (h, w, 3)),
        *((k, inst[k], torch.float32, (S, n)) for k, n in _FIELDS),
        ("count", inst["count"], torch.int32, ()),
        ("atlas", atlas, torch.float32, (ah, aw, 4))])
    if atlas.data_ptr() % 16:
        raise ValueError("composite_sprites_cuda: the atlas must be 16-byte aligned")
    out = torch.empty_like(rgb)
    vp = ctypes.c_void_p
    code = _kernels.library().lib.sprite_pass_launch(
        vp(rgb.data_ptr()), vp(out.data_ptr()), h, w,
        *(vp(inst[k].data_ptr()) for k, _ in _FIELDS), vp(inst["count"].data_ptr()), S,
        vp(atlas.data_ptr()), ah, aw, R, vp(_kernels.stream_ptr(dev)))
    _kernels.check(code, "sprite_pass")
    return out

"""Shared configuration and helpers (counterpart of datum_tpu/ops/common.py).

`FrameConfig` keeps the JAX package's fields, defaults and properties
exactly, so one configuration drives both packages; the port rejects
the flags its slice does not implement at the top of `render_frame`.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from . import _kernels

# Raster tile size: one CUDA block shades one 32 x 128 tile, the same
# tiling the binning keys and the JAX package use.
TILE_H = 32
TILE_W = 128

# Scene capacity bounds (reference SceneSet capacities)
MAX_POINT_LIGHTS = 512
MAX_SPOT_LIGHTS = 16
MAX_PROBES = 128
MAX_ENVIRONMENTS = 8
MAX_DECALS = 128
SHADOW_SLICES = 4
SHADOW_RES = 1024
CLUSTER_TILE = 64
CLUSTER_SIZE_Z = 24

# Fog froxel grid
FOG_W, FOG_H, FOG_D = 160, 90, 64
FOG_DEPTH_RANGE = 50.0
FOG_DEPTH_EXPONENT = 3.0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static frame configuration; field-for-field the JAX package's
    FrameConfig (see datum_tpu/ops/common.py for what each field does)."""

    width: int = 1280
    height: int = 720
    bin_capacity: int | None = None
    big_capacity: int = 64
    bin_max_span: int = 16
    max_vertices: int = 1 << 16
    max_triangles: int = 1 << 16
    max_instances: int = 256
    tile_light_capacity: int = 64
    enable_shadows: bool = True
    shadow_res: int = 1024
    shadow_bin_capacity: int = 128
    shadow_mode: str = "esm"
    shadow_far_res: int | None = None
    shadow_factor_scale: int = 2
    shadow_slice_blend: float = 0.0
    enable_material_maps: bool = True
    use_pallas: bool = False
    raster_kernel: str = "v2"
    raster_two_phase: bool = False
    raster_early_z: bool = False
    texture_filter: str = "nearest"
    matmap_max_size: int = 256
    use_shade_kernel: bool = True
    pallas_interpret: bool = False
    enable_skinning: bool = False
    enable_foliage: bool = False
    enable_terrain_morph: bool = False
    max_palettes: int = 16
    max_bones: int = 128
    max_particle_quads: int = 0
    max_translucent_draws: int = 0
    max_translucent_tris: int = 4096
    translucent_lit: bool = True
    translucent_lit_layers: int = 1
    translucent_lit_scale: int = 1
    max_dynamic_vertices: int = 0
    backface_cull: bool = True
    use_light_clusters: bool = False
    max_spot_shadows: int = 0
    spot_shadow_res: int = 256
    spot_shadow_mode: str = "parabolic"
    max_decals_active: int = 0
    decal_textures: bool = True
    max_fog_planes: int = 0
    max_overlay_sprites: int = 0
    overlay_region: int = 128
    enable_depth_of_field: bool = False
    enable_color_grading: bool = True
    enable_ssao: bool = False
    ssao_scale: float = 0.5
    ssao_temporal: bool = False
    enable_ssr: bool = False
    ssr_mode: str = "binned"
    enable_bloom: bool = True
    enable_fog: bool = False
    fog_depth_range: float = FOG_DEPTH_RANGE
    fog_sample_scale: int = 4
    forward_bin_capacity: int = 64
    forward_big_capacity: int = 16

    def __post_init__(self):
        if self.bin_capacity is None:
            # ~128K (tile, tri) pairs in total, as the JAX package sizes it
            cap = max(131072 // max(self.n_tiles, 1), 64)
            cap = min(round_up(cap, 8), round_up(self.max_triangles, 8))
            object.__setattr__(self, "bin_capacity", cap)

    @property
    def padded_width(self) -> int:
        return round_up(self.width, TILE_W)

    @property
    def padded_height(self) -> int:
        return round_up(self.height, TILE_H)

    @property
    def tiles_x(self) -> int:
        return self.padded_width // TILE_W

    @property
    def tiles_y(self) -> int:
        return self.padded_height // TILE_H

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def ndc_grid(height: int, width: int, device=None, dtype=torch.float32):
    """Per-pixel NDC coordinates at pixel centers, row 0 = top; returns
    (yn, xn), each (height, width)."""
    ys = (torch.arange(height, device=device, dtype=dtype) + 0.5) / height * 2.0 - 1.0
    xs = (torch.arange(width, device=device, dtype=dtype) + 0.5) / width * 2.0 - 1.0
    return torch.meshgrid(ys, xs, indexing="ij")


def fma(a, b, c):
    """a*b + c rounded once to f32, as a fused multiply-add (the plain
    versions' form of the fmas the kernels write with __fmaf_rn and XLA
    contracts on the CPU).  The f32 product is exact in f64, but the f64
    sum rounds too: where it lands exactly halfway between two f32 values
    while the exact sum does not (an addend below half an f64 ulp, e.g. a
    ~1e-22 plane coefficient beside a product that is an f32 tie), a
    second rounding to f32 would break the tie to even.  Those rare sums
    are moved one f64 ulp toward the exact value (its TwoSum error) before
    they round, so that every result in the normal f32 range is the single
    rounding of the exact a*b + c."""
    s = a.double() * b.double() + c.double()
    f = s.float()
    # halfway between two f32 values: the 29 mantissa bits f32 drops
    # are 1 followed by zeros
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if not bool(tie.any()):
        return f
    idx = tie.nonzero(as_tuple=True)
    a, b, c = (t[idx].double() for t in torch.broadcast_tensors(a, b, c))
    p = a * b
    st = p + c
    bb = st - p
    err = (p - (st - bb)) + (c - bb)             # st + err == p + c exactly
    inf = torch.full_like(st, float("inf"))
    st = torch.where(err != 0, torch.nextafter(st, torch.where(err > 0, inf, -inf)), st)
    f[idx] = st.float()
    return f


def device_cached(maxsize):
    """A least-recently-used cache of static tensors built once per shape
    and device, by their arguments (the eager frame would otherwise
    rebuild and re-upload them, a host sync, every frame).  Callers only
    read what it returns.  While a frame graph is being captured
    (_kernels.recorder), every tensor handed out goes into the recorder's
    keep (the graphs read them by address, so the capture keeps them
    alive past their eviction from the cache), and one missing from its
    cache is built by the recorder's outside(build, args), between two of
    its graphs (a graph cannot hold the build's copy from the host)."""
    def wrap(build):
        cache = collections.OrderedDict()

        @functools.wraps(build)
        def get(*args):
            rec = _kernels.recorder
            if args in cache:
                cache.move_to_end(args)
            else:
                cache[args] = build(*args) if rec is None else rec.outside(build, args)
                if len(cache) > maxsize:
                    cache.popitem(last=False)
            out = cache[args]
            if rec is not None:
                rec.keep.append(out)
            return out
        get.cache_clear = cache.clear
        return get
    return wrap


@device_cached(maxsize=64)
def constant(values, dtype, device):
    """torch.tensor(values, dtype=dtype, device=device) for static values
    (a number or nested tuples of numbers), built once per device."""
    return torch.tensor(values, dtype=dtype, device=device)


@device_cached(maxsize=32)
def shifted_taps(offsets, h: int, w: int, device):
    """For static (dy, dx) pixel offsets (a tuple of pairs): ((S, 2)
    int64 offsets, (S, h, w) bool mask of the pixels whose shifted tap
    lies inside the h x w image).  Built once per shape and device (the
    eager passes would rebuild them every frame); callers only read
    them."""
    o = torch.tensor(offsets, dtype=torch.int64, device=device)
    yi = torch.arange(h, device=device)[None, :, None] + o[:, 0, None, None]
    xi = torch.arange(w, device=device)[None, None, :] + o[:, 1, None, None]
    return o, (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)


def texel_index(x, n: int):
    """int32(x) truncated toward zero, then clipped to [0, n-1], as the
    JAX package's `clip(x.astype(int32), 0, n-1)` texel taps; x is
    clamped first so that far-off values convert as XLA's saturating
    convert does."""
    return torch.clamp(torch.clamp(x, -1.0, float(n)).to(torch.int32), 0, n - 1)


def srgb_encode(linear):
    """Piecewise sRGB transfer (final image encode)."""
    linear = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * torch.pow(torch.clamp(linear, min=1e-8), 1 / 2.4) - 0.055,
    )

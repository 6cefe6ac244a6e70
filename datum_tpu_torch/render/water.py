"""Flat water surface (counterpart of datum_tpu/render/water.py): the
ocean grid with a nearly flat spectrum and a flow scroll, shaded either
opaque through the material's water LUT or, with translucent=True,
through the lit translucent layer (depth-aware transmission by the water
column and refraction of the background)."""

from __future__ import annotations

from .ocean import Ocean, OceanParams, render_ocean_surface


class Water(Ocean):
    """Calm water plane: the ocean grid with a flat spectrum (the bump
    comes from the residual small-wave amplitude) plus a flow scroll."""

    def __init__(self, ctx, grid=48, patch_size=64.0, flow=(0.02, 0.01),
                 ripple=4e-6, material=None, waterdepth=6.0):
        params = OceanParams(amplitude=ripple, choppiness=0.4, flow=flow,
                             waterdepth=waterdepth,
                             foamwavescale=0.0, foamshorescale=0.0)
        super().__init__(ctx, grid=grid, patch_size=patch_size,
                         params=params, material=material)


def push_water(renderlist, water: Water, transform, material,
               translucent=False):
    """Queue a water surface; translucent=True needs
    FrameConfig.max_translucent_draws > 0."""
    render_ocean_surface(water, renderlist, transform, material,
                         translucent=translucent)

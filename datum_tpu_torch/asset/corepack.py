"""Core asset pack manifest: the built-in asset ids (counterpart of
datum_tpu/asset/corepack.py).

Keeps the reference core pack's id numbering (magic 0x65726F43, version
45), so packs and code that name CoreAsset ids interoperate.  Shader
entries hold no SPIR-V: each names the port's function that implements
the pipeline (tools/assetbuilder.py's KERNEL_REGISTRY).
"""

from enum import IntEnum

CORE_MAGIC = 0x65726F43
CORE_VERSION = 45


class CoreAsset(IntEnum):
    catalog = 0
    white_diffuse = 1
    nominal_normal = 2
    zero_depth = 3
    unit_quad = 4
    unit_cube = 5
    unit_cone = 6
    unit_hemi = 7
    unit_sphere = 8
    line_quad = 9
    line_cube = 10
    line_cone = 11
    cluster_comp = 12
    prepass_frag = 13
    geometry_frag = 14
    shadow_geom = 15
    shadow_frag = 16
    model_shadow_vert = 17
    model_prepass_vert = 18
    model_geometry_vert = 19
    model_spotmap_vert = 20
    actor_shadow_vert = 21
    actor_prepass_vert = 22
    actor_geometry_vert = 23
    actor_spotmap_vert = 24
    foilage_shadow_vert = 25
    foilage_prepass_vert = 26
    foilage_geometry_vert = 27
    foilage_spotmap_vert = 28
    terrain_prepass_vert = 29
    terrain_geometry_vert = 30
    terrain_frag = 31
    depth_blit_comp = 32
    depth_mip_comp = 33
    esm_gen_comp = 34
    esm_hblur_comp = 35
    esm_vblur_comp = 36
    fog_density_comp = 37
    fog_scatter_comp = 38
    ssao_comp = 39
    envbrdf_lut = 40
    lighting_comp = 41
    skybox_vert = 42
    skybox_frag = 43
    ocean_vert = 44
    ocean_frag = 45
    opaque_vert = 46
    opaque_frag = 47
    translucent_vert = 48
    translucent_frag = 49
    translucent_blend_vert = 50
    translucent_blend_frag = 51
    fogplane_vert = 52
    fogplane_frag = 53
    water_vert = 54
    water_frag = 55
    particle_vert = 56
    particle_frag = 57
    particle_blend_vert = 58
    particle_blend_frag = 59
    weightblend_vert = 60
    weightblend_frag = 61
    ssr_comp = 62
    default_skybox = 63
    bloom_luma_comp = 64
    bloom_hblur_comp = 65
    bloom_vblur_comp = 66
    luminance_comp = 67
    color_hblur_comp = 68
    color_vblur_comp = 69
    color_lut = 70
    composite_vert = 71
    composite_frag = 72
    sprite_vert = 73
    sprite_frag = 74
    gizmo_vert = 75
    gizmo_frag = 76
    wireframe_vert = 77
    wireframe_geom = 78
    wireframe_frag = 79
    stencilmask_vert = 80
    stencilmask_frag = 81
    stencilfill_vert = 82
    stencilfill_frag = 83
    stencilpath_vert = 84
    stencilpath_geom = 85
    stencilpath_frag = 86
    line_vert = 87
    line_geom = 88
    line_frag = 89
    outline_vert = 90
    outline_geom = 91
    outline_frag = 92
    convolve_comp = 93
    project_comp = 94
    skybox_gen_comp = 95
    spotmap_src_vert = 96
    spotmap_src_frag = 97
    spotmap_frag = 98
    ocean_sim_comp = 99
    ocean_fftx_comp = 100
    ocean_ffty_comp = 101
    ocean_map_comp = 102
    ocean_gen_comp = 103
    wave_color = 104
    wave_normal = 105
    wave_foam = 106
    cloud_density = 107
    cloud_normal = 108
    noise_normal = 109
    default_material = 110
    default_particle = 111
    loader_image = 112
    test_image = 113
    debug_font = 114

    core_asset_count = 115

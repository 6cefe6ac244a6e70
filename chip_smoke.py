#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--versions FILE]

Renders the bench frame, the dense stress frame, the deferred
(non-megakernel) frames, the local-environment frames, the animated
vertex stage's frame, the bench frame with a sprite and text HUD, the
city example, the datumtest example with its live particle system, the
bench frame with that live stream and the bench scene loaded from a
pack written from a seed at 1920x1088 through
datum_tpu_torch.render.frame.render_frame, after building the port's
CUDA kernels from datum_tpu_torch/csrc with nvcc.  The bench
frame is bench.py's config (the datumtest scene with 4 sun cascades as a
1024 near and a 512 far atlas with ESM and slice blend, one parabolic
spot map, the procedural skybox and its IBL environment, the lit glass
sphere and water patch shaded at half resolution, the 256-particle
cloud, two decals, SSAO, the froxel fog with its taps at 1/8 resolution
and the binned SSR), with the one-phase raster (K1), with the two-phase
raster (K6) and once with depth of field.  The stress frame is
profiling/bench_stress.py::run_dense's config (stress_scene: a
geomorphed 256^2-cell terrain, 8x4 spheres at detail 48, 128 clustered
point lights, 4 ESM cascades at 1024, bins 1024 + 128), rendered with
the early-z exit off and on.  Phases, one line each; any failure raises
and exits non-zero:

1. require a CUDA device; print its name and nvidia-smi's name and
   power limit; turn TF32 off;
2. build the kernels (timed, first use; ptxas registers and spill per
   source);
3. build the scene through the port's datumtest_scene; the main
   bin_overflow must be 0; print each shadow stack's, the lit layer's
   and the forward (WBOIT) stream's overflow;
4. each kernel against its plain PyTorch version on the bench frame's
   real inputs, with the stated tolerances: K3 on all three shadow
   stacks with early-z off and on (bit-identical), K1 on the opaque and
   the lit layer, K2 (with SSAO's ao; and on the lit layer), its
   epilogue with refraction active, the epilogue with the fog group, K4
   on the merged stream; K6 against its plain version and against K1 on
   the opaque and the lit layer (bit-identical); then, at
   translucent_lit_layers=2, K1 and K6 with peel_depth and K4 with a
   peeled residual;
5. drive each path the port renders with the kernel counts set to 0
   just before and read just after: the opaque frame, the shadowed,
   sky-lit frame and the translucent frame of the earlier slices, the
   bench frame 3 times (K1), twice with raster_two_phase (K6, no K1) and
   once with DoF; check the image, the luminance, bin_overflow 0 and the
   launches of every frame; check a small bench frame against the plain
   path on the CPU;
5r. render the bench frame as profiling/capture_frame.py does (its
   config at make_rl(0.5), no SSAO history) and compare its rows
   [:1080] with the TPU's tests/golden/datumtest_1080_tpu.png: the
   port's own frame (exact f32 matmuls) printed, the frame with the
   TPU's bf16 rounding of f32 matmul operands held at that script's
   gate, RMSE < 0.01 (RMSE, mean |d|, bin_overflow and the blocks that
   differ most printed for both);
6. time ms/frame (CUDA events, median) of the frames (the bench frame
   with K1 and with K6 in turns), the bench frame's device time and
   launches under torch.profiler, its stages (the program's spans over
   a profiled window with its tracing on: host ms, device ms, launches
   and syncs a frame of each, and the device's longest idle gaps;
   debug/stages.py), and each kernel vs its plain version; compute
   each kernel's bound from this run's inputs;
3s-6s. the stress frame: its scene (triangles, bin entries, overflows);
   K1, K6 and K3 with early-z against themselves without it and their
   plain versions, K7 and K5 on the stress frame's setup and bins (the
   stress-depth and the K5 stress sets) against their plain versions
   (bit-identical),
   clustered K2 against its plain version and clustered
   frames against dense ones (also the 128-light bench scene); the
   frame driven 3 times with early-z off and 3 times on, with its
   launches checked; its ms/frame, stages, kernels, the gather
   microbenchmark's one PyTorch call and the bounds;
4d-6d. the deferred frame (FrameConfig's default path): K5 and K7
   against their plain versions on the bench frame's inputs (bit-equal,
   vis identical) and K7's vis against K1's; the lighting kernel against
   its plain version (atol 1e-4 / rtol 1e-3) on the arguments one eager
   K5 frame gives it at 1920x1088; the full-width K5 frame (the
   bench config with the bilinear filter: K5 1, K4 2, K3 once per stack,
   the lighting kernel 1, K1/K2/K6/K7 0) and K7 frame (raster_kernel='mxu',
   material maps off: K7 1, the lighting kernel 1, K1/K2/K5 0) driven 3
   times each, and entry()'s 1280x704
   use_pallas=False frame, where no kernel launches; the 256x128
   deferred frames (entry()'s config with ESM and with PCF, the K5 and
   the K7 frame) on the card against the CPU plain path; the stress
   golden config against tests/golden/stress.png (decoded with zlib;
   RMSE printed); ms/frame, a profiler window, stages, K5's, K7's and the
   lighting kernel's ms and bounds (the lighting kernel's from the
   frame's covered pixels);
4e-6e. the local-environment frame: the bench scene with a box
   environment probe (ctx.add_environment), 4 SH probes and a fog plane;
   K2 with the edm group against its plain version (edm coverage
   printed, nonzero) and the gather kernel against tab[idx] on
   profiling/prof_gather.py's shapes (bit-identical); the megakernel
   probe frame (every K2 launch carries the edm group), the deferred K5
   probe frame (bilinear: the lighting kernel 1 with the box probe's
   diffuse plane and the SH probes, K2 0), the
   probe frame with the DDA SSR and RenderContext.render at params.scale
   0.5 (1920x1080 out) driven 3 times each with their launches checked;
   256x128 probe frames (megakernel, K5, DDA) on the card against the
   CPU plain path; ms/frame, a profiler window, the stages of the probe
   fields, the fog planes and the SSRs, K2 with and without the group,
   the gather against tab[idx], and their bounds;
3v-6v. the animated vertex stage: the bench scene with a skinned actor
   (an Animator blending two channels), 8x8 wind-bent foliage blades and
   an FFT ocean (examples/ocean.py's grid 96) through the dynamic-vertex
   slab (scenes.VertexModes), bins 1024 + 64; its triangles, slab,
   palettes and overflows (main bins held at 0); skinning, the wind
   bends, the ocean's maps and the patched pool on the card against the
   CPU, K1, K2 and K3 against their plain versions on its inputs; 3
   frames with the animation advancing 1/60 s a frame, their launches
   checked (K1 and K2 2, K3 3, K4 and the epilogue 1, K5/K6/K7 0) and
   each region's change printed (nonzero); examples/ocean.py's config
   through RenderContext.render (320x160, 3 updates, no kernel) against
   tests/golden/ocean.png at RMSE < 2/255 (the ocean example module
   through its harness); 256x128 vertex-modes frames
   (megakernel, deferred K5) and a translucent Water frame on the card
   against the CPU plain path; ms/frame beside the bench frame, a
   profiler window and the vertex stage's wall ms with and without the
   three modes;
4o-6o. the overlay layer and the scene systems: the HUD (the bench
   config with max_overlay_sprites 256 and a 128-px window: icons, a
   layered and a rotated one, a panel and a map larger than the window,
   10 lines of builtin-font text) on the bench scene; the sprite kernel
   against its plain version on the HUD's instances, bit for bit; 3 HUD
   frames through RenderContext.render with their launches checked (K1
   and K2 2, K3 3, K4 1, epilogue 1, sprite pass 1 a frame), the HUD
   frame equal to the frame without it outside the sprites' rectangles,
   3 HUD frames at params.scale 0.5 (the sprites in display space); the
   city example through its harness (ECS, occlusion culling, sun
   shadows, two depth-tested gizmos, the debug overlay; the scan
   raster, no kernel) at 1920x1088 for one frame and at the golden's
   320x160 (43/73 visible; tests/golden/city.png held at RMSE < 2/255
   with the jitted reference's zero-area-triangle texels in the cascade
   stack, CITY_GOLDEN_SLIVERS); the HUD frame's ms/frame beside the
   bench frame in turns, both under torch.profiler, the sprite kernel
   and the plain pass (its launches counted) with the kernel's bound,
   the host ms of the draws with and without the HUD, the city frame's
   and its host culling's ms from the debug ring;
3p-6p. the particle system, the platform layer, the sky re-bake, the
   live material and texture edits and the pack-free example apps: the
   datumtest example through its harness at 1920x1088 (3 frames; its
   live particle count after each update, > 0 by frame 2; bin
   overflows; the scan raster: every kernel count 0); the bench frame
   with the example's live ParticleSystem in place of the static cloud,
   and with an 8000-particle burst at max_particle_quads 8192, K4
   against its plain version on each merged stream (phase 4's
   tolerance) and each frame driven with its launches checked;
   render_skybox (64^2, 16 samples) on the card against the CPU bake;
   update_texture and update_material on a rendered bench context
   against a context given the edits before its first frame (state and
   frame bit for bit); triangle, material, skybox, stardust, asteroids
   and datumtest through their harness at their goldens' config (320x160,
   3 frames) against tests/golden/<name>.png at RMSE < 2/255 (datumtest
   with DATUMTEST_GOLDEN_SLIVERS in its cascade stack; ocean's golden is
   held in 5v through its example module), stardust and asteroids for
   one frame at 1920x1088; the datumtest example's ms/frame, the host ms
   of the particle updates (one system; stardust's four on the worker
   pool), of the billboards at 8000 particles and the re-bake's ms, the
   bench frame with the live stream beside the bench frame in turns and
   under torch.profiler;
3a-6a. the pack pipeline: the bench scene written as a pack from a seed
   (packscene: the sphere grid and the floor as one MODL with 13 maps of
   1024^2 with full mip chains, BC3, RGBA and RGBE; the rigged column of
   the vertex-modes scene with 3 clips) and the core pack at its default
   sizes, LZ4-compressed, their bytes and ratios; the AssetManager on 4
   workers decoding every asset equal to what the writer took, the native
   and the Python LZ4 codec each decoding the other's stream of every
   CDAT block, the DeviceUploader on its CUDA side stream landing every
   payload bit-equal to its host copy and keeping it while the default
   stream reads it behind a long kernel and the uploader evicts and
   re-uploads, K1/K2/K3/K4 against their plain versions on the pack
   frame's inputs; the pack frame (Model.load into a Scene with the
   animated column, the bench config with matmap_max_size 1024) 3 times
   with the bench frame's launches, each bit-equal to the frame of the
   same scene built in memory; the teapot example (a seeded lathe OBJ
   through obj_to_pack) and the character example (the scene pack) at
   320x160 for 3 frames on the card against the CPU plain path (each run
   in a child process from the end of 4a to 5a, beside none of the timings
   below and of earlier phases); the write, compress, decode, stream,
   upload and Model.load times and the pack frame's ms beside the bench
   frame's, in turns and under torch.profiler;
4m-6m. the tile-sharded frame (datum_tpu_torch/parallel/) on the bench
   config at translucent_lit_scale 1 (MULTI): K1 and K6 (early-z), K4,
   K2 (dense and clustered) and its epilogue on two bands of 17 tile rows
   against their plain versions in band mode (bit-identical; K2 within
   its tolerance) and against the whole frame's rows (bit-identical); the
   sharded frame at world size 1 on nccl in this process, 3 frames and
   one with raster_two_phase, each bit-equal to render_frame's, their
   launches counted; at world size 2, two processes on the one card over
   gloo (host-staged), the frame bit-equal to render_frame's and the
   replicated stage's outputs equal on both ranks, the RMSE at the
   bench's translucent_lit_scale 2 printed (the parity exception), the
   reduced path at 256x128 with bloom off and on within
   tests/test_parallel.py's tolerances, and with use_pallas (bloom off:
   each rank's band through the lighting kernel, once a rank, held to
   lighting_reference and the image to the single-device frame at the
   same tolerances); dryrun_multichip(4) on the card
   with its gate; ms/frame of the world-1 sharded frame beside
   render_frame's in turns and the byte ledger at n = 2 (two ranks on one
   card are not timed);
7. with --versions FILE, other versions of K1's, K6's, K2's, K3's, K4's,
   K5's and K7's sources built alone and timed beside this build's on the same
   inputs (see versions_phase); then print the kernels' JSON line (11
   rows), then the device JSON line last, after the script's wall time.

Needs one card, torch with CUDA and nvcc; imports no jax and nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

from datum_tpu_torch.examples.common import read_png

W, H = 1920, 1088
# the shadowed, sky-lit frame (the bench scene without its forward content)
SHADOWED = dict(sphere_detail=24, n_point_lights=8, skybox=True, skybox_size=64,
                max_vertices=1 << 15, max_triangles=1 << 15, bin_capacity=160,
                big_capacity=64, bin_max_span=8, use_pallas=True,
                enable_material_maps=True, texture_filter="mip_half",
                enable_shadows=True, shadow_mode="esm", shadow_res=1024,
                shadow_far_res=512, shadow_slice_blend=0.25,
                shadow_bin_capacity=128, max_spot_shadows=1,
                spot_shadow_mode="parabolic", spot_shadow_res=256)
# the translucent frame: the bench's forward content at the default
# forward bin capacities (64 + 16)
TRANSLUCENT = dict(SHADOWED, max_translucent_draws=2, max_translucent_tris=2048,
                   translucent_lit=True, translucent_lit_layers=1,
                   translucent_lit_scale=2, max_particle_quads=512,
                   max_decals_active=2, decal_textures=False)
# the bench frame (bench.py:88-115): the translucent frame with SSAO, the
# froxel fog (taps at 1/8 resolution) and the binned SSR.  The scene's
# fog density is 0, as the bench renders it: the volume and its taps run
# in full and leave the colour as it is
SCENE = dict(TRANSLUCENT, shadow_factor_scale=4, enable_ssao=True, enable_fog=True,
             enable_ssr=True, fog_sample_scale=8)
# a fog density for the checks that must see the fog move values
FOG_DENSITY = (0.6, 0.65, 0.7, 0.04)
# the opaque frame (no skybox, no shadows, no forward content)
OPAQUE = dict(SHADOWED, skybox=False, enable_shadows=False, max_spot_shadows=0)
SMALL = dict(SCENE, sphere_detail=8, grid=(4, 3), max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             skybox_size=32, shadow_res=256, shadow_far_res=128,
             shadow_bin_capacity=1024, spot_shadow_res=128,
             forward_bin_capacity=256)
STACKS = ("near cascades", "far cascades", "spot")
# the dense stress frame (profiling/bench_stress.py::run_dense at its
# default DATUM_STRESS_CAP=1024): stress_scene's 256^2-cell geomorphed
# terrain and 8x4 spheres at detail 48, 128 point lights clustered at 64
# a tile, the 4 ESM sun cascades at 1024 in one stack (shadow_far_res
# None), the 32^2 skybox; bins 1024 + 128, span 8, mip_half
STRESS = dict(terrain_n=256, sphere_detail=48, grid=(8, 4), n_point_lights=128,
              use_pallas=True, shadow_factor_scale=4, enable_material_maps=True,
              texture_filter="mip_half", bin_max_span=8, bin_capacity=1024,
              big_capacity=128)
# the bench scene with 128 point lights, clustered at 64 a tile
# (bench_stress.py::run with use_light_clusters=True, tile_light_capacity=64)
LIGHTS128 = dict(sphere_detail=24, n_point_lights=128, max_vertices=1 << 15,
                 max_triangles=1 << 15, bin_capacity=160, big_capacity=64,
                 bin_max_span=8, use_pallas=True, shadow_factor_scale=4,
                 enable_material_maps=True, texture_filter="mip_half",
                 use_light_clusters=True, tile_light_capacity=64)

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (pixel, walked entry) and per pixel, counted from
# the kernels' source (an fma counts 2): a plane fma(a, xn, b*yn) + c is
# 4; K1 and K3 walk 4 planes + s; K4 also takes the barycentrics, 4 (6
# where soft) interpolations of 5, the soft falloff, the weight and the
# 5 accumulators; K1's epilogue evaluates ~22 planes and a divide; K2
# spends ~200 a pixel on the surface, IBL and SH terms and ~60 a light;
# the epilogue ~40 on the ladder picks, the blend and the resolve
OPS_WALK_DEPTH = 18
OPS_WALK_BLEND = 80
OPS_K1_PIXEL = 110
OPS_K2_PIXEL, OPS_K2_LIGHT = 200, 60
OPS_EPILOGUE_PIXEL = 40
# K5 walks K3's 4 planes + s a (pixel, entry), 18, and spends ~16 a
# pixel on the winner's barycentrics; K7 evaluates 6 planes (e0..e2, d
# and the two scissor planes yn - ylo, hi - yn) + s, 26, and ~40 a pixel
# on the barycentrics and 5 interpolations.  The TPU kernel's padded
# product (24 coefficient rows x 128 entries x 6*2048 columns a chunk and
# 16-row half tile) is a layout, reported beside K7's bound, not in it
OPS_WALK_K5, OPS_K5_PIXEL = 18, 16
OPS_WALK_K7, OPS_K7_PIXEL = 26, 40
# entry()'s frame (__graft_entry__.py: the datumtest scene at 1280x704,
# FrameConfig's defaults: use_pallas=False, the nearest filter, ESM sun
# cascades at 1024, material maps; bins 128 + 32)
ENTRY = dict(sphere_detail=16, n_point_lights=4, max_vertices=1 << 15,
             max_triangles=1 << 15, bin_capacity=128, big_capacity=32)
ENTRY_SIZE = (1280, 704)
# the 256x128 deferred frames held against the CPU plain path: entry()'s
# config with ESM and with PCF, the K5 frame (bilinear filter, material
# maps, translucents, particles, decals, SSAO, fog, a perspective spot
# map, SSR) and the K7 frame; bins that do not overflow
DEFERRED_SMALL = dict(sphere_detail=8, grid=(4, 3), n_point_lights=4,
                      max_vertices=4096, max_triangles=4096, bin_capacity=128,
                      big_capacity=32, shadow_res=256, shadow_bin_capacity=320)
K5_SMALL = dict(DEFERRED_SMALL, use_pallas=True, texture_filter="bilinear",
                max_translucent_draws=2, max_translucent_tris=2048,
                max_particle_quads=512, max_decals_active=2, enable_ssao=True,
                enable_fog=True, enable_ssr=True, max_spot_shadows=1,
                spot_shadow_mode="perspective", spot_shadow_res=128,
                forward_bin_capacity=256, forward_big_capacity=16)
K7_SMALL = dict(DEFERRED_SMALL, use_pallas=True, raster_kernel="mxu",
                enable_material_maps=False, enable_shadows=False)
# FP32 operations of the deferred lighting kernel (csrc/lighting.cu),
# counted from its source: ~200 a covered pixel on the gbuffer decode, the
# world position, the eye vector, the sky's SH-9 diffuse and the IBL
# apply, ~80 a light (the sun, each point light and spot: the half
# vector, four dot products, the Disney diffuse, GGX, Fresnel and the
# attenuation) and OPS_K2_PROBE a live SH probe
OPS_LIGHTING_PIXEL, OPS_LIGHTING_LIGHT = 200, 80
# the local-environment frame: the bench frame's scene with a box
# environment probe around the sphere grid (its cubemap the procedural sky
# at 64^2 under a second sun, prefiltered at 5 levels), 4 SH probes of
# that cubemap and tests/test_kitchen_sink.py's fog plane
LOCAL_ENV = dict(SCENE, max_fog_planes=1)
# RenderContext.render at params.scale 0.5 renders a 1920x1080 viewport
SCALED_H = 1080
# K2 spends ~75 FP32 operations a (pixel, SH probe): the distance, the
# falloff and 3 x 9 SH terms
OPS_K2_PROBE = 75
# the gather microbenchmark's shapes (profiling/prof_gather.py:159-170):
# 524,288 rows of a 16384 x 16 f32 table
GATHER_ROWS, GATHER_TABLE = 524288, (16384, 16)
# profiling/capture_frame.py:41-54's config (bench.py's at 1920x1088),
# rendered at make_rl(0.5) with no SSAO history: its rows [:1080] are the
# TPU's tests/golden/datumtest_1080_tpu.png, gated at RMSE < 0.01 (:82)
CAPTURE = dict(sphere_detail=24, n_point_lights=8, max_vertices=1 << 15,
               max_triangles=1 << 15, bin_capacity=160, big_capacity=64, bin_max_span=8,
               use_pallas=True, shadow_factor_scale=4, enable_material_maps=True,
               texture_filter="mip_half", enable_ssao=True, enable_fog=True,
               enable_ssr=True, max_spot_shadows=1, max_particle_quads=512,
               max_translucent_draws=2, max_translucent_tris=2048, max_decals_active=2,
               decal_textures=False, translucent_lit_scale=2, shadow_far_res=512,
               shadow_slice_blend=0.25, fog_sample_scale=8)
CAPTURE_ROWS, CAPTURE_RMSE = 1080, 0.01
# datum_tpu/tools/stress_golden.py's CONFIG, rendered for tests/golden/stress.png
STRESS_GOLDEN = dict(width=320, height=160, terrain_n=96, sphere_detail=20,
                     grid=(6, 3), n_point_lights=64, skybox_size=16,
                     max_vertices=1 << 16, max_triangles=1 << 16, big_capacity=32)
# the HUD on the bench frame: the bench config with the sprite pass at
# 256 instances and a 128-px window
HUD = dict(SCENE, max_overlay_sprites=256, overlay_region=128)
# FP32 operations a (window pixel, sprite) of the sprite pass, counted
# from csrc/sprite_pass.cu: the sprite-local (u, v) 14, the atlas
# coordinates 6, the bilinear weights and tap coordinates 11, its 4
# channels 36, the alpha and the 3-channel blend 15
OPS_SPRITE_PIXEL = 82
# examples/city.py's golden config (datum_tpu/tools/update_goldens.py:
# 320x160, 3 frames).  tests/golden/city.png is the jitted JAX frame on the
# CPU, whose shadow setup XLA contracts into FMAs: there six zero-area
# triangles of the lat-long spheres (two corners at one position) keep a
# det of rounding residue that passes the relative degeneracy test, and
# each wins one cascade texel at a depth off its corners' (ROADMAP Queue
# 3).  Those texels raise the ESM's zmax of cascades 2 and 3, and with it
# the street's shadows (RMSE 0.03094 against the port's frame).  The
# port's setup rejects these triangles, as the JAX function does
# un-jitted.  The golden is held at 2/255 with the six texels of the
# jitted stack (slice, row, column, depth) written into the port's stack
# (golden_slivers); tests/test_torch_city.py derives them from the live
# JAX frame and holds this table to them.
CITY_GOLDEN = (320, 160)
CITY_GOLDEN_SLIVERS = ((2, 168, 434, 0.064453125), (2, 269, 114, 0.0703125),
                       (3, 274, 221, 0.31390380859375), (3, 337, 190, 0.3905029296875),
                       (3, 362, 207, 0.25), (3, 364, 228, 0.34765625))
CITY_GOLDEN_STACK = (4, 512, 512)
# The datumtest golden (examples/datumtest.py at 320x160, 3 frames) has
# the same cause: in its jitted 4 x 1024^2 cascade stack three
# degenerate triangles of the lat-long spheres (two corners at one
# position, or three collinear corners: a cross product of 0 or ~1e-17)
# each win one texel, and raise the ESM's zmax of cascades 1 and 2 from
# 0.0158 and 0.0412 to 0.109 and 0.25 (the port's frame misses the golden
# by RMSE 0.0221, the far floor's shadows).  The port's stack equals the
# un-jitted one bit for bit; with these three texels written in, the
# frame holds the golden at RMSE 0.00118.  tests/
# test_torch_examples_datumtest.py derives them from the live JAX frame.
DATUMTEST_GOLDEN_SLIVERS = ((1, 792, 987, 0.109375), (2, 568, 461, 0.25),
                            (3, 532, 223, 0.14892578125))
DATUMTEST_GOLDEN_STACK = (4, 1024, 1024)


@contextlib.contextmanager
def golden_slivers(slivers=CITY_GOLDEN_SLIVERS, stack=CITY_GOLDEN_STACK):
    """Inside the block, every sun cascade stack of shape `stack` that the
    port renders takes the depths of `slivers` (slice, row, column,
    depth) at their texels; other stacks (a spot map's) pass unchanged.
    Raises at the end of the block if no such stack was rendered."""
    import torch

    from datum_tpu_torch.ops import shadow

    orig = shadow.render_shadow_cascades
    hits = []

    def with_slivers(*args, **kw):
        maps = orig(*args, **kw)
        if not (torch.is_tensor(maps) and tuple(maps.shape) == stack):
            return maps
        hits.append(1)
        maps = maps.clone()
        for sl, y, x, d in slivers:
            maps[sl, y, x] = d
        return maps

    shadow.render_shadow_cascades = with_slivers
    try:
        yield
    finally:
        shadow.render_shadow_cascades = orig
    if not hits:
        raise ValueError(f"golden_slivers: no cascade stack of shape {stack} rendered")


_T0 = time.perf_counter()


def phase(n, msg):
    """One phase line, with the seconds since the script started."""
    print(f"phase {n} [{time.perf_counter() - _T0:.0f} s]: {msg}", flush=True)


def frame_inputs(ctx, camera, params, make_rl, t):
    """(draws, sceneset) numpy trees of the frame at time t."""
    from datum_tpu_torch.render.types import make_sceneset

    rl = make_rl(t)
    sceneset = make_sceneset(camera, params, point_lights=rl.point_lights,
                             spot_lights=rl.spot_lights, probes=rl.probes)
    return ctx.frame_draws(rl, camera), sceneset


def shadow_stacks(cfg, ex, worldp, s):
    """The frame's three K3 stacks (near and far cascades, spot)."""
    from datum_tpu_torch.ops import shadow as shadow_ops

    sl = s["spotlights"]
    return (shadow_ops.cascade_stacks(
        worldp, ex["tris"], s["mainlight"]["shadowview"], res=cfg.shadow_res,
        far_res=cfg.shadow_far_res)
        + [shadow_ops.spot_stack_parabolic(
            worldp, ex["tris"], sl["view"], sl["attenuation"][:, 3],
            cfg.max_spot_shadows, res=cfg.spot_shadow_res)])


def lit_bins(cfg, ts, **kw):
    """The lit layer's setup and bins: (setup, tx, w_t, h_t, bins...)."""
    from datum_tpu_torch.ops import raster as raster_ops
    from datum_tpu_torch.render import frame as F

    setup, tx, ty, w_t, h_t = F.lit_setup(cfg, ts)
    return (setup, tx, w_t, h_t) + tuple(raster_ops.bin_triangles(
        setup, cfg.max_translucent_tris, tx, ty, cfg.forward_bin_capacity,
        cfg.forward_big_capacity, **kw))


def record_lighting(cfg, state, draws, ss, dev):
    """The lighting kernel's arguments (ops/lighting_cuda.py::
    lighting_inputs') in one eager frame of cfg on (draws, ss), recorded
    as the frame launches it."""
    import torch

    from datum_tpu_torch.ops import lighting_cuda as lc
    from datum_tpu_torch.render import frame as F

    seen, launch = [], lc.lighting_cuda

    def record(**inp):
        seen.append(inp)
        return launch(**inp)

    lc.lighting_cuda = record
    try:
        F._eager_frame(cfg, state, draws, ss, None, dev, F.host_light_counts(ss))
        torch.cuda.synchronize()
    finally:
        lc.lighting_cuda = launch
    if len(seen) != 1:
        raise RuntimeError(f"the frame launched the lighting kernel {len(seen)} times")
    return seen[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Device time of fn() a call: after one warm-up, the reps calls are
    enqueued behind a sleep kernel that keeps the card busy while the host
    launches them, so that they run back to back and the CUDA events
    around them time the kernels alone.  cuda_ms also counts the host's
    time between launches, which sets it for a kernel shorter than its
    wrapper's Python.  Raises if the host took longer to enqueue the
    calls than the sleep lasted (the kernels then waited for the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0.record()
    torch.cuda._sleep(100_000_000)          # ~50 ms at ~2 GHz
    start.record()
    host = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - host) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host >= t0.elapsed_time(start):
        raise RuntimeError(f"device_ms: enqueuing took {host:.3f} ms, longer than "
                           f"the {t0.elapsed_time(start):.3f} ms sleep")
    return start.elapsed_time(end) / reps


def frame_ms(render, inputs, n=7):
    """Median CUDA-event ms of render(draws, ss) over n frames, after two
    warm-up frames."""
    import torch

    for draws, ss in inputs[:2]:
        render(draws, ss)
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        draws, ss = inputs[i % len(inputs)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        render(draws, ss)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_frames(render, inputs, by_name=False):
    """(device ms, kernel launches) per frame over a torch.profiler window
    of len(inputs) frames: the summed time of the kernels the card ran
    (torch's and the port's) and the count of kernel launches; with
    by_name, also {device kernel name: launches a frame}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for draws, ss in inputs:
            render(draws, ss)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    out = (device_us / 1e3 / len(inputs), launches / len(inputs))
    if by_name:
        out += ({e.key: e.count / len(inputs) for e in events
                 if e.device_type == DeviceType.CUDA},)
    return out


def stage_table(render, inputs):
    """The frame's stages over one torch.profiler window of the frames
    of inputs with the program's tracing on (debug/stages.py: host ms,
    device ms, launches and syncs a frame of each span, and the longest
    idle gaps of the device), as text lines."""
    from datum_tpu_torch.debug.stages import profile_stages

    return profile_stages(lambda: [render(d, s) for d, s in inputs], len(inputs),
                          "cuda").format()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _walked(inp):
    """Valid entries a raster kernel walks, summed over tiles: the valid
    big-list entries for every tile plus each tile's bin count."""
    n_tiles = inp["bins"].shape[0]
    return (int((inp["big_ids"] >= 0).sum()) * n_tiles
            + int(inp["counts"].sum()))


def lighting_bound(inp):
    """(ms, "bytes" | "operations", bytes, covered pixels) of the lighting
    kernel on its arguments (ops/lighting_cuda.py::lighting_inputs'):
    every pixel reads its mask and writes its 12 B of hdr; a covered pixel
    also reads each of its per-pixel planes and walks its lights and live
    SH probes (a background pixel stops at its mask); the tables and each
    spot map's texels are read once."""
    H, W = inp["depth"].shape
    mask = inp["mask"]
    covered = int(mask.sum())
    planes = ("depth", "normal", "diffuse", "specular", "ssao", "env_spec", "env_brdf",
              "env_diff", "sf")
    per_pixel = sum(inp[k].numel() // (H * W) * inp[k].element_size() for k in planes
                    if inp[k] is not None)
    nbytes = (H * W * (mask.element_size() + 12) + covered * per_pixel
              + _nbytes(*(inp[k] for k in ("spotmaps", "params", "lights", "spots",
                                           "probes", "probe_count", "cl_lists",
                                           "cl_counts"))))
    if inp["cl_lists"] is None:
        walks = covered * inp["n_point"]
    else:
        # each covered pixel walks its tile's list
        from datum_tpu_torch.ops.common import TILE_H, TILE_W

        per_tile = mask.reshape(H // TILE_H, TILE_H, inp["tiles_x"], TILE_W).sum((1, 3))
        per_tile = per_tile.reshape(-1)
        walks = int((per_tile * inp["cl_counts"].clamp(0, inp["cl_lists"].shape[1])).sum())
    n_probe = min(int(inp["probe_count"][0]), inp["probes"].shape[0])
    nops = (covered * (OPS_LIGHTING_PIXEL + (1 + inp["n_spot"]) * OPS_LIGHTING_LIGHT
                       + n_probe * OPS_K2_PROBE) + walks * OPS_LIGHTING_LIGHT)
    return bound(nbytes, nops) + (nbytes, covered)


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the larger of the two least times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(kp, rp, what):
    """K1 vs plain: all 22 planes bit-identical on every pixel.  Returns
    the max abs error (0)."""
    import torch

    from datum_tpu_torch.ops.raster_cuda import PLANE_NAMES

    if not torch.equal(kp, rp):
        same = (kp == rp).float().mean().item()
        raise RuntimeError(f"K1 ({what}) vs plain: bit-identical on {same} of values")
    covered = (kp[1] >= 0).float().mean().item()
    phase(4, f"K1 vs plain, {what} ({tuple(kp.shape[1:])}): all {len(PLANE_NAMES)} planes "
             f"bit-identical on every pixel (covered {covered:.3f})")
    return 0.0


def check_same(k, r, what, extra="", tag=4):
    """Bit-identical on >= 99.99% of values, atol/rtol 1e-5 on the rest
    (K4 and the epilogue write the plain version's operations); printed
    under phase `tag`."""
    import torch

    same = (k == r).float().mean().item()
    err = (k - r).abs().max().item()
    if (not torch.isfinite(k).all() or same < 0.9999
            or not torch.allclose(k, r, atol=1e-5, rtol=1e-5)):
        raise RuntimeError(f"{what} vs plain: bit-identical on {same}, max abs "
                           f"err {err}")
    phase(tag, f"{what} vs plain: bit-identical on {same:.6f} of values, max abs "
               f"err {err:.3g} (>= 0.9999 identical, atol/rtol 1e-5){extra}")
    return err


def check_k6(k6, plain, k1, what):
    """K6 vs its plain version and vs K1 on the same inputs: all 22
    planes bit-identical on every pixel.  Returns the max abs error vs
    the plain version."""
    import torch

    err = (k6 - plain).abs().max().item()
    for other, name in ((plain, "its plain version"), (k1, "K1")):
        if not torch.equal(k6, other):
            same = (k6 == other).float().mean().item()
            raise RuntimeError(f"K6 ({what}) vs {name}: bit-identical on {same}")
    covered = (k6[1] >= 0).float().mean().item()
    phase(4, f"K6 ({what}, {tuple(k6.shape[1:])}): all 22 planes bit-identical to "
             f"its plain version and to K1 on every pixel (covered {covered:.3f})")
    return err


def drive(render, inputs, kernels, expect, forbid=(), overflow_limit=0, size=None):
    """Render each (draws, ss) with every kernel count set to 0 just
    before and read just after; check the image ((width, height) size),
    bin_overflow (at most overflow_limit; None: no limit) and that every
    frame launched each kernel at least expect[name] times and the
    kernels of forbid never.  Returns (per-frame launches, totals, the
    last image, luminance)."""
    import torch

    size = size or (W, H)
    for k in kernels.values():
        k.launches = 0
    per_frame = []
    for draws, ss in inputs:
        before = {n: k.launches for n, k in kernels.items()}
        out = render(draws, ss)
        torch.cuda.synchronize()
        per_frame.append({n: k.launches - before[n] for n, k in kernels.items()})
        img, lum = out["image"], out["luminance"]
        if tuple(img.shape) != (size[1], size[0], 3) or img.dtype != torch.uint8:
            raise RuntimeError(f"image {tuple(img.shape)} {img.dtype}")
        mean = img.float().mean().item()
        over = overflow_limit is not None and int(out["bin_overflow"]) > overflow_limit
        if not mean > 10 or not torch.isfinite(lum) or over:
            raise RuntimeError(f"frame: image mean {mean}, luminance "
                               f"{lum.item()}, bin_overflow "
                               f"{int(out['bin_overflow'])}")
    totals = {n: k.launches for n, k in kernels.items()}
    if any(f[n] < m for f in per_frame for n, m in expect.items()):
        raise RuntimeError(f"a frame ran without its kernels: {per_frame}, "
                           f"expected at least {expect}")
    if any(f[n] for f in per_frame for n in forbid):
        raise RuntimeError(f"a frame launched {forbid}: {per_frame}")
    return per_frame, totals, img, lum


def _walked_early_z(inp, depth, szb=None):
    """Valid entries a raster kernel with early-z walks at the least on
    this data, in entries a tile summed over tiles: each thread (16 rows
    of one column) stops at the first slot whose bound (szb, default
    inp["szb"]) its final min depth reaches; a tile counts the mean over
    its 256 threads.  The kernels stop on the running min, so they walk
    at least this much."""
    from datum_tpu_torch.ops.raster import tile_image
    from datum_tpu_torch.ops.raster_cuda import _entry_ids

    n_tiles, tx = inp["bins"].shape[0], inp["tiles_x"]
    ids = _entry_ids(inp["bins"], inp["big_ids"])
    szb = inp["szb"] if szb is None else szb
    tmin = tile_image(depth, tx, n_tiles // tx).reshape(n_tiles, 2, 16, -1).amin(2)
    tmin = tmin.reshape(n_tiles, -1)                               # (n, 256)
    walked = ((ids >= 0)[:, None, :] & (szb[:, None, :] > tmin[:, :, None])).sum()
    return walked.item() / tmin.shape[1]


def image_diff(a, b):
    """(mean, max) |a - b| of two u8 images, in levels."""
    d = (a.float() - b.float()).abs()
    return d.mean().item(), d.max().item()


def require_equal(k, other, what):
    """Raise unless k and other are equal on every value."""
    import torch

    if not torch.equal(k, other):
        same = (k == other).float().mean().item()
        raise RuntimeError(f"{what}: bit-identical on {same} of values only")


def stress_phases(dev, card, kernels):
    """Phases 3s-6s: the dense stress frame (STRESS) and the 128-light
    bench scene (LIGHTS128).  Returns the numbers the kernels' JSON line
    reports for them."""
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.ops import shadow as shadow_ops
    from datum_tpu_torch.ops.raster_cuda import (
        PLANE_NAMES, early_z_bounds, raster_inputs, raster_shade_2p_cuda,
        raster_shade_2p_reference, raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_depth_cuda import (
        depth_inputs, raster_depth_cuda, raster_depth_reference)
    from datum_tpu_torch.ops.raster_mxu_cuda import (
        raster_mxu_cuda, raster_mxu_inputs, raster_mxu_reference)
    from datum_tpu_torch.ops.raster_v1_cuda import (
        raster_v1_cuda, raster_v1_inputs, raster_v1_reference)
    from datum_tpu_torch.ops.shade_cuda import (
        shade_deferred_cuda, shade_deferred_reference, shade_inputs)
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.scenes import datumtest_scene, stress_scene

    # ---- 3s. the stress scene
    t0 = time.perf_counter()
    ctx, camera, params, make_rl = stress_scene(width=W, height=H, **STRESS)
    cfg = ctx.config
    cfg_ez = dataclasses.replace(cfg, raster_early_z=True)
    state = ctx.device_state(dev)
    inputs = [frame_inputs(ctx, camera, params, make_rl, t) for t in (0.0, 0.1, 0.2)]
    scene = []
    for draws, ss in inputs:
        d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
        ex, _, clip, _, _, wp = F._vertex_stage(cfg, state, d_t, s_t)
        _, _, counts, big, ovf = F._bin_stage(cfg, ex, clip)
        (stack,) = shadow_ops.cascade_stacks(
            wp, ex["tris"], s_t["mainlight"]["shadowview"], res=cfg.shadow_res,
            far_res=cfg.shadow_far_res)
        sovf = shadow_ops.bin_stack(stack, cfg.shadow_bin_capacity, cfg.big_capacity,
                                    return_overflow=True)[3]
        scene.append((int(draws["t_valid"].sum()), int((big >= 0).sum()),
                      counts.float().mean().item(), int(counts.max()), int(ovf),
                      int(sovf)))
    phase("3s", f"stress scene {W}x{H} ({time.perf_counter() - t0:.1f} s): per frame "
                "(triangles drawn, big entries, bin entries a tile mean / max, "
                f"bin_overflow, shadow stack overflow): {scene}; bins "
                f"{cfg.bin_capacity}+{cfg.big_capacity} = "
                f"{cfg.bin_capacity + cfg.big_capacity} entries a tile, "
                f"{cfg.n_tiles} tiles; one {cfg.shadow_res}x{4 * cfg.shadow_res} "
                f"cascade stack, shadow bins {cfg.shadow_bin_capacity}+"
                f"{cfg.big_capacity}; {int(inputs[0][1]['pointlights']['count'])} "
                f"point lights, {cfg.tile_light_capacity} a tile")

    # ---- 4s. kernels on the stress frame's inputs
    draws, ss = frame_inputs(ctx, camera, params, make_rl, 0.3)
    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, state, d_t, s_t)
    setup, bins, counts, big, _ = F._bin_stage(cfg, ex, clip)
    k1_in = raster_inputs(setup, bins, big, counts, ex["tris"], uv, wn, d_t["tri_mat"],
                          state["materials"], cfg.tiles_x, cfg.padded_width,
                          cfg.padded_height, wt)
    k1z_in = dict(k1_in, szb=early_z_bounds(k1_in["rows"], bins, big, cfg.tiles_x,
                                            cfg.padded_width, cfg.padded_height))
    pk = raster_shade_cuda(**k1_in)
    pz = raster_shade_cuda(**k1z_in)
    pr = raster_shade_reference(**k1_in)
    torch.cuda.synchronize()
    require_equal(pz, pk, "K1 with early-z vs without (stress opaque layer)")
    k1_err = check_k1(pz, pr, "stress opaque layer, early-z")
    phase("4s", f"K1 with early-z vs without: all 22 planes bit-identical on every "
                f"pixel; vs plain: {(pz == pr).float().mean().item():.6f} of values "
                "bit-identical")
    k6 = raster_shade_2p_cuda(**k1_in)
    k6z = raster_shade_2p_cuda(**k1z_in)
    torch.cuda.synchronize()
    require_equal(k6z, k6, "K6 with early-z vs without (stress opaque layer)")
    k6_err = check_k6(k6z, raster_shade_2p_reference(**k1_in), pk,
                      "stress opaque layer, early-z")
    phase("4s", "K6 with early-z vs without: all 22 planes bit-identical on every pixel")
    # K7 at the stress frame's bin depth: its setup and bins through
    # raster_mxu_inputs (the stress-depth set; the K7 frame itself runs the
    # bench scene)
    k7_in = raster_mxu_inputs(setup, bins, big, counts, ex["tris"], uv, wn,
                              d_t["tri_mat"], state["materials"], cfg.tiles_x,
                              cfg.padded_width, cfg.padded_height)
    k7 = raster_mxu_cuda(**k7_in)
    k7r = raster_mxu_reference(**k7_in)
    torch.cuda.synchronize()
    require_equal(k7, k7r, "K7 vs plain (stress-depth inputs)")
    k7_err = (k7 - k7r).abs().max().item()
    phase("4s", f"K7 vs plain on the stress-depth inputs (the stress frame's setup "
                f"and bins, {k7_in['big_ids'].shape[0]} + {k7_in['bins'].shape[1]} "
                f"entries a tile, covered {(k7r[1] >= 0).float().mean().item():.3f}): "
                "all 15 planes bit-identical on every pixel")
    # K5 on the same setup and bins (the K5 frame itself runs the bench scene)
    k5_in = raster_v1_inputs(setup, bins, big, counts, cfg.tiles_x, cfg.padded_width,
                             cfg.padded_height)
    k5 = raster_v1_cuda(**k5_in)
    k5r = raster_v1_reference(**k5_in)
    torch.cuda.synchronize()
    require_equal(k5, k5r, "K5 vs plain (stress inputs)")
    k5_err = (k5 - k5r).abs().max().item()
    phase("4s", f"K5 vs plain on the stress inputs (the stress frame's setup and bins, "
                f"{k5_in['big_ids'].shape[0]} + {k5_in['bins'].shape[1]} entries a tile, "
                f"covered {(k5r[1] >= 0).float().mean().item():.3f}): all 4 planes "
                "bit-identical on every pixel")

    (stack,) = shadow_ops.cascade_stacks(wp, ex["tris"], s_t["mainlight"]["shadowview"],
                                         res=cfg.shadow_res, far_res=cfg.shadow_far_res)
    sbins, scounts, sbig = shadow_ops.bin_stack(stack, cfg.shadow_bin_capacity,
                                                cfg.big_capacity)
    k3_in = depth_inputs(stack["setup"], sbins, sbig, scounts, stack["tiles_x"],
                         stack["res"], stack["height"])
    k3z_in = depth_inputs(stack["setup"], sbins, sbig, scounts, stack["tiles_x"],
                          stack["res"], stack["height"], early_z=True)
    dk = raster_depth_cuda(**k3_in)
    dz = raster_depth_cuda(**k3z_in)
    dr = raster_depth_reference(**k3_in)
    torch.cuda.synchronize()
    require_equal(dz, dk, "K3 with early-z vs without (4-cascade stack)")
    require_equal(dz, dr, "K3 with early-z vs plain (4-cascade stack)")
    k3_err = (dz - dr).abs().max().item()
    phase("4s", f"K3 on the 4-cascade stack ({stack['res']}x{stack['height']}, covered "
                f"{(dr > 0).float().mean().item():.3f}): with early-z bit-identical to "
                "itself without it and to its plain version on every texel")

    kp = dict(zip(PLANE_NAMES, pk))
    shadows = F._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf, ao, _ = F._shade_inputs(cfg, kp, state, d_t, s_t, shadows)
    clusters = F.light_clusters(cfg, kp["depth"], s_t)
    k2c_in = shade_inputs(gpl, ss2, proj=s_t["proj"], invview=s_t["invview"], ao=ao,
                          spotsf=spotsf, clusters=clusters)
    k2d_in = shade_inputs(gpl, ss2, proj=s_t["proj"], invview=s_t["invview"], ao=ao,
                          spotsf=spotsf)
    hc = shade_deferred_cuda(**k2c_in)
    hr = shade_deferred_reference(**k2c_in)
    torch.cuda.synchronize()
    k2c_err = (hc - hr).abs().max().item()
    if not torch.isfinite(hc).all() or not torch.allclose(hc, hr, atol=1e-4, rtol=1e-3):
        raise RuntimeError(f"clustered K2 vs plain: max abs err {k2c_err} beyond "
                           "atol 1e-4 / rtol 1e-3")
    tile_counts = clusters[1][::2]                     # one row of each band pair
    lights_walked = int(clusters[1].sum()) * 16 * 128  # per pixel of each cell
    phase("4s", f"clustered K2 vs plain: bit-identical on "
                f"{(hc == hr).float().mean().item():.6f} of values, max abs err "
                f"{k2c_err:.3g} (atol 1e-4, rtol 1e-3); lights a tile: mean "
                f"{tile_counts.float().mean().item():.2f}, max {int(tile_counts.max())}, "
                f"{int((tile_counts >= cfg.tile_light_capacity).sum())} of "
                f"{tile_counts.numel()} tiles at {cfg.tile_light_capacity}")

    # clustered vs dense frames: with lists that hold every light (no
    # list truncates) the clustered loop must match the dense one; at the
    # config's capacity a saturated tile drops lights, as in the JAX
    # package, and that difference is printed, not held
    def versus_dense(c, st_, inp, what):
        n_lights = int(inp[1]["pointlights"]["count"])
        imgs = [F.render_frame(dataclasses.replace(c, **kw), st_, *inp, device=dev)["image"]
                for kw in (dict(use_light_clusters=False),
                           dict(tile_light_capacity=n_lights), {})]
        full = image_diff(imgs[1], imgs[0])
        if full[0] >= 0.5 or full[1] > 2:
            raise RuntimeError(f"{what}, clustered (lists of {n_lights}) vs dense K2: "
                               f"mean |d| {full[0]}, max {full[1]} levels")
        cap = image_diff(imgs[2], imgs[0])
        phase("4s", f"{what}, clustered vs dense K2: lists of {n_lights} (none "
                    f"truncates) mean |d| {full[0]:.4f}, max {full[1]:.0f} levels "
                    f"(limits 0.5, 2); at {c.tile_light_capacity} a tile (saturated "
                    f"tiles drop lights, as in the JAX package) mean |d| {cap[0]:.4f}, "
                    f"max {cap[1]:.0f}")

    versus_dense(cfg, state, (draws, ss), "stress frame")
    lctx, lcam, lparams, lmake = datumtest_scene(width=W, height=H, **LIGHTS128)
    lstate = lctx.device_state(dev)
    linputs = [frame_inputs(lctx, lcam, lparams, lmake, 0.3)]
    lcfg = lctx.config
    versus_dense(lcfg, lstate, linputs[0], "128-light bench scene")

    # ---- 5s. drive the stress frame, early-z off then on, and the 128-light
    # bench scene (no bin_overflow limit: the stress bins' overflow is
    # printed, not held)
    render_0 = lambda d, s: F.render_frame(cfg, state, d, s, device=dev)
    render_z = lambda d, s: F.render_frame(cfg_ez, state, d, s, device=dev)
    render_l = lambda d, s: F.render_frame(lcfg, lstate, d, s, device=dev)
    expect = dict(raster_shade=1, shade_deferred=1, raster_depth=1)
    pf0, _, _, _ = drive(render_0, inputs, kernels, expect, forbid=("raster_shade_2p",),
                         overflow_limit=None)
    pfz, _, img, lum = drive(render_z, inputs, kernels, expect,
                                      forbid=("raster_shade_2p",), overflow_limit=None)
    phase("5s", f"3 stress frames {W}x{H}, early-z off: launches per frame {pf0}")
    phase("5s", f"3 stress frames, early-z on: launches per frame {pfz}; image "
                f"mean {img.float().mean().item():.2f}, luminance {lum.item():.6g}")
    if not torch.equal(render_0(*inputs[0])["image"], render_z(*inputs[0])["image"]):
        raise RuntimeError("the stress frame with early-z differs from the frame without")
    phase("5s", "stress frame t=0: the early-z image equals the image without (u8, "
                "every pixel)")
    pfl, _, _, _ = drive(render_l, linputs, kernels, expect)
    phase("5s", f"128-light bench scene (clusters): launches {pfl}")

    # ---- 6s. timing (informational: this PR claims no speed)
    ms_off, ms_on = [frame_ms(render_0, inputs, n=5)], []
    ms_on += [frame_ms(render_z, inputs, n=5), frame_ms(render_z, inputs, n=5)]
    ms_off.append(frame_ms(render_0, inputs, n=5))
    prof_ms, prof_launches = profile_frames(render_0, inputs)
    stages = stage_table(render_0, inputs)
    t = dict(k1=cuda_ms(lambda: raster_shade_cuda(**k1_in), 20),
             k1z=cuda_ms(lambda: raster_shade_cuda(**k1z_in), 20),
             k1p=cuda_ms(lambda: raster_shade_reference(**k1_in), 1),
             k6=cuda_ms(lambda: raster_shade_2p_cuda(**k1_in), 20),
             k6z=cuda_ms(lambda: raster_shade_2p_cuda(**k1z_in), 20),
             k3=cuda_ms(lambda: raster_depth_cuda(**k3_in), 20),
             k3z=cuda_ms(lambda: raster_depth_cuda(**k3z_in), 20),
             k3p=cuda_ms(lambda: raster_depth_reference(**k3_in), 1),
             k2c=cuda_ms(lambda: shade_deferred_cuda(**k2c_in), 20),
             k2d=cuda_ms(lambda: shade_deferred_cuda(**k2d_in), 20),
             k2cp=cuda_ms(lambda: shade_deferred_reference(**k2c_in), 1),
             k1_dev=device_ms(lambda: raster_shade_cuda(**k1_in)),
             k1z_dev=device_ms(lambda: raster_shade_cuda(**k1z_in)),
             k6_dev=device_ms(lambda: raster_shade_2p_cuda(**k1_in)),
             k6z_dev=device_ms(lambda: raster_shade_2p_cuda(**k1z_in)),
             k7=cuda_ms(lambda: raster_mxu_cuda(**k7_in), 20),
             k7p=cuda_ms(lambda: raster_mxu_reference(**k7_in), 1),
             k7_dev=device_ms(lambda: raster_mxu_cuda(**k7_in)),
             k5=cuda_ms(lambda: raster_v1_cuda(**k5_in), 20),
             k5p=cuda_ms(lambda: raster_v1_reference(**k5_in), 1),
             k5_dev=device_ms(lambda: raster_v1_cuda(**k5_in)),
             k3_dev=device_ms(lambda: raster_depth_cuda(**k3_in)),
             k3z_dev=device_ms(lambda: raster_depth_cuda(**k3z_in)),
             k2c_dev=device_ms(lambda: shade_deferred_cuda(**k2c_in)))
    # the gather microbenchmark's shapes (profiling/prof_gather.py:159-170):
    # a 16K x 16 f32 table, 512K rows gathered; the one PyTorch call
    gen = torch.Generator(device=dev).manual_seed(0)
    tab = torch.rand((16384, 16), device=dev, generator=gen)
    idx = torch.randint(0, 16384, (524288,), device=dev, generator=gen)
    t["gather"] = cuda_ms(lambda: tab[idx], 50)
    phase("6s", f"stress frame: {statistics.mean(ms_off):.3f} ms/frame early-z off, "
                f"{statistics.mean(ms_on):.3f} early-z on (each the mean of 2 medians "
                f"of 5, timed off, on, on, off: "
                f"{', '.join(f'{v:.3f}' for v in (ms_off[0], *ms_on, ms_off[1]))}; "
                f"CUDA events, {W}x{H}) on {card}")
    phase("6s", f"stress frame under torch.profiler (3 frames, early-z off): "
                f"{prof_ms:.3f} ms of device time and {prof_launches:.0f} kernel "
                f"launches per frame; busy {prof_ms / statistics.mean(ms_off):.3f}")
    phase("6s", "stress frame stages (3 frames under torch.profiler, tracing on):\n"
          + stages)
    phase("6s", f"stress inputs: K1 {t['k1']:.3f} ms, with early-z {t['k1z']:.3f} ms, "
                f"plain {t['k1p']:.3f} ms; K6 {t['k6']:.3f} ms, with early-z "
                f"{t['k6z']:.3f} ms; K3 (4-cascade stack) {t['k3']:.3f} ms, with "
                f"early-z {t['k3z']:.3f} ms, plain {t['k3p']:.3f} ms; K2 clustered "
                f"{t['k2c']:.3f} ms, dense {t['k2d']:.3f} ms (128 lights), clustered "
                f"plain {t['k2cp']:.3f} ms; gather tab[idx] (16384x16 f32, 524288 rows) "
                f"{t['gather']:.4f} ms; K7 (stress-depth inputs) {t['k7']:.3f} ms, plain "
                f"{t['k7p']:.3f} ms; K5 (stress inputs) {t['k5']:.3f} ms, plain "
                f"{t['k5p']:.3f} ms; device time a call (device_ms): K1 "
                f"{t['k1_dev']:.4f} ms, with early-z {t['k1z_dev']:.4f} ms, K6 "
                f"{t['k6_dev']:.4f} ms, with early-z {t['k6z_dev']:.4f} ms, K7 "
                f"{t['k7_dev']:.4f} ms, K5 {t['k5_dev']:.4f} ms, K3 {t['k3_dev']:.4f} ms, "
                f"with early-z "
                f"{t['k3z_dev']:.4f} ms, K2 clustered {t['k2c_dev']:.4f} ms on {card}")

    px = cfg.padded_width * cfg.padded_height
    k1_bytes = (_nbytes(*(k1_in[k] for k in ("rows", "bins", "counts", "big_ids")))
                + 22 * px * 4)
    b = dict(
        k1=bound(k1_bytes, _walked(k1_in) * 4096 * OPS_WALK_DEPTH + px * OPS_K1_PIXEL),
        k1z=bound(k1_bytes + _nbytes(k1z_in["szb"]),
                  _walked_early_z(k1z_in, pk[0]) * 4096 * OPS_WALK_DEPTH
                  + px * OPS_K1_PIXEL),
        k3=bound(_nbytes(k3_in["rows"], k3_in["bins"], k3_in["counts"], k3_in["big_ids"])
                 + 4 * k3_in["bins"].shape[0] * 4096,
                 _walked(k3_in) * 4096 * OPS_WALK_DEPTH),
        k3z=bound(_nbytes(k3z_in["rows"], k3z_in["bins"], k3z_in["counts"],
                          k3z_in["big_ids"], k3z_in["szb"])
                  + 4 * k3z_in["bins"].shape[0] * 4096,
                  _walked_early_z(k3z_in, dr) * 4096 * OPS_WALK_DEPTH),
        k2c=bound(_nbytes(k2c_in["f32_planes"], k2c_in["planes"], k2c_in["ao"],
                          k2c_in["cl_lists"], k2c_in["cl_counts"]) + 3 * px * 4,
                  px * OPS_K2_PIXEL + lights_walked * OPS_K2_LIGHT),
        k2d=bound(_nbytes(k2d_in["f32_planes"], k2d_in["planes"], k2d_in["ao"])
                  + 3 * px * 4,
                  px * (OPS_K2_PIXEL + OPS_K2_LIGHT * int(k2d_in["counts"][0]))),
        k7=bound(_nbytes(*(k7_in[k] for k in ("rows", "bins", "counts", "big_ids")))
                 + 15 * px * 4, _walked(k7_in) * 4096 * OPS_WALK_K7 + px * OPS_K7_PIXEL),
        k5=bound(_nbytes(*(k5_in[k] for k in ("rows", "bins", "counts", "big_ids")))
                 + 4 * px * 4, _walked(k5_in) * 4096 * OPS_WALK_K5 + px * OPS_K5_PIXEL),
        gather=bound(_nbytes(tab, idx) + idx.numel() * 16 * 4, 0))
    phase("6s", "stress bounds (ms, by): " + "; ".join(
        f"{n} {v[0]:.4f} {v[1]}" for n, v in b.items()))

    def vertex_bounds(inp, setup):
        # each entry's largest vertex depth (the TPU kernels' bound, not a
        # bound for zero-area triangles): (own, suffix max)
        from datum_tpu_torch.ops.raster_cuda import _entry_ids

        ids = _entry_ids(inp["bins"], inp["big_ids"]).long()
        zb = torch.where(ids >= 0, setup["zbound"][ids.clamp(min=0)],
                         torch.zeros((), device=ids.device))
        return zb, torch.flip(torch.cummax(torch.flip(zb, [1]), 1).values, [1])

    walks = []
    for name, inp, zin, depth, st_setup in (("K1", k1_in, k1z_in, pk[0], setup),
                                            ("K3", k3_in, k3z_in, dr, stack["setup"])):
        own, suffix = vertex_bounds(inp, st_setup)
        walks.append(f"{name} {_walked(inp)}, {_walked_early_z(zin, depth):.0f}, "
                     f"{_walked_early_z(zin, depth, suffix):.0f}, "
                     f"{_walked_early_z(zin, depth, own):.0f}")
    phase("6s", "entries walked, summed over tiles (the full walk; with each "
                "thread's exit at its final min depth by the port's bound; by the "
                "TPU's vertex bound; by the vertex bound if the bins were sorted by "
                "it, nearest first): " + "; ".join(walks))
    return dict(t=t, b=b, launches=pfz[0], errs=dict(k1=k1_err, k6=k6_err, k3=k3_err,
                                                     k2c=k2c_err, k7=k7_err, k5=k5_err),
                inputs=dict(k1=k1_in, k1z=k1z_in, k2c=k2c_in, k3=k3_in, k3z=k3z_in,
                            k7=k7_in, k5=k5_in))


class tpu_default_matmuls:
    """While the with-block runs, the port's f32 matmuls (torch.matmul,
    torch.einsum, the @ operator: all it calls) take each f32 operand
    rounded to bf16, with exact products and f32 sums: how a TPU runs the
    JAX package's f32 dots at their default precision (one bf16 pass; the
    JAX package's blur.py says so of its upsamples).  The port's contract
    is exact f32, as the JAX package computes on the CPU; this is for
    holding the port against a frame the TPU rendered."""

    def __enter__(self):
        import torch

        self.saved = torch.matmul, torch.einsum, torch.Tensor.__matmul__
        mm, ein, at = self.saved

        def rnd(t):
            return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t

        def einsum(eq, *ops):
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = ops[0]
            return ein(eq, *(rnd(o) for o in ops))

        torch.matmul = lambda a, b, **kw: mm(rnd(a), rnd(b), **kw)
        torch.einsum = einsum
        torch.Tensor.__matmul__ = lambda a, b: at(rnd(a), rnd(b))

    def __exit__(self, *exc):
        import torch

        torch.matmul, torch.einsum, torch.Tensor.__matmul__ = self.saved


def reference_1080_phase(dev):
    """Phase 5r: the port's bench frame as profiling/capture_frame.py
    renders it (CAPTURE at make_rl(0.5), no history) against the TPU's
    tests/golden/datumtest_1080_tpu.png, its rows [:1080], at that
    script's gate (RMSE < 0.01 on [0, 1] values).  The port's own frame
    (exact f32 matmuls) misses it: the TPU rounded the operands of its
    f32 matmuls to bf16, among them proj @ view, which moves every
    projected vertex (ROADMAP Queue 3); its RMSE is printed, not held.
    The same frame with the TPU's matmul rounding (tpu_default_matmuls)
    is held at the gate.  Prints each one's RMSE, mean |d|, bin_overflow
    and the 64 x 64 blocks that differ most.  Returns dict(rmse,
    rmse_tpu_matmuls)."""
    import torch

    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    gold = torch.from_numpy(read_png(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
        "datumtest_1080_tpu.png"))).float()
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, **CAPTURE)
    rl = make_rl(0.5)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    draws, state = ctx.frame_draws(rl, camera), ctx.device_state(dev)

    def versus_gold(what):
        out = F.render_frame(ctx.config, state, draws, ss, device=dev)
        img = out["image"][:CAPTURE_ROWS].cpu().float()
        if img.shape != gold.shape:
            raise RuntimeError(f"1080p frame {tuple(img.shape)} vs golden "
                               f"{tuple(gold.shape)}")
        d = (img - gold).abs()
        rmse = ((d / 255.0) ** 2).mean().sqrt().item()
        ovf = int(out["bin_overflow"])
        blocks = d.mean(2)[:CAPTURE_ROWS // 64 * 64].reshape(
            CAPTURE_ROWS // 64, 64, W // 64, 64).mean((1, 3))
        worst = torch.topk(blocks.flatten(), 3)
        where = ", ".join(f"rows {int(i) // blocks.shape[1] * 64}+64 cols "
                          f"{int(i) % blocks.shape[1] * 64}+64 {v:.2f}"
                          for v, i in zip(worst.values.tolist(), worst.indices.tolist()))
        phase("5r", f"{what}: RMSE {rmse:.5f} (gate < {CAPTURE_RMSE}), mean |d| "
                    f"{d.mean().item():.4f} levels, max {d.max().item():.0f}, "
                    f"{(d.amax(2) > 8).float().mean().item():.5f} of pixels off by more "
                    f"than 8 levels, bin_overflow {ovf}; the 64x64 blocks that differ "
                    f"most (mean |d| levels): {where}")
        if ovf:
            raise RuntimeError(f"the 1080p frame overflows its bins: {ovf}")
        return rmse

    intro = ("bench frame as profiling/capture_frame.py renders it (make_rl(0.5), no "
             f"history, rows [:{CAPTURE_ROWS}]) on the card vs the TPU's "
             "tests/golden/datumtest_1080_tpu.png")
    rmse = versus_gold(f"{intro}, the port's exact f32 matmuls (printed, not held: the "
                       "TPU rounded its f32 matmul operands to bf16, ROADMAP Queue 3)")
    with tpu_default_matmuls():
        rmse_tpu = versus_gold(f"{intro}, f32 matmul operands rounded to bf16 as on the "
                               "TPU (held)")
    if not rmse_tpu < CAPTURE_RMSE:
        raise RuntimeError(f"the 1080p frame with the TPU's matmul rounding misses the "
                           f"TPU frame: RMSE {rmse_tpu}")
    return dict(rmse=rmse, rmse_tpu_matmuls=rmse_tpu)


def deferred_phases(dev, card, kernels, bench):
    """Phases 4d-6d: the deferred frame of FrameConfig's default path.  K5
    and K7 against their plain versions on the bench frame's inputs; the
    full-width K5 frame (the bench config with the bilinear filter) and
    K7 frame (raster_kernel='mxu', material maps off) and entry()'s
    1280x704 use_pallas=False frame, driven with their launches checked;
    the 256x128 deferred frames on the card against the CPU plain path;
    the stress golden through the port; timings and bounds.  bench: the
    bench frame's (cfg, state, inputs, setup, bins, counts, big_ids, ex,
    uv, wn, d_t, k1 planes).  Returns the numbers of K5's and K7's JSON
    rows."""
    import torch

    from datum_tpu_torch.ops.lighting_cuda import lighting_cuda, lighting_reference
    from datum_tpu_torch.ops.raster_mxu_cuda import (
        PLANE_NAMES as MXU_NAMES, raster_mxu_cuda, raster_mxu_inputs,
        raster_mxu_reference)
    from datum_tpu_torch.ops.raster_v1_cuda import (
        raster_v1_cuda, raster_v1_inputs, raster_v1_reference)
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene, stress_scene

    cfg, state, inputs, setup, bins, counts, big_ids, ex, uv, wn, d_t, kp = bench
    tx, w, h = cfg.tiles_x, cfg.padded_width, cfg.padded_height

    # ---- 4d. K5 and K7 against their plain versions
    def versus_plain(k, r, names, what):
        vis_same = torch.equal(k[1], r[1])
        same = (k == r).float().mean().item()
        err = (k - r).abs().max().item()
        if not vis_same or not torch.equal(k, r):
            raise RuntimeError(f"{what} vs plain: vis identical {vis_same}, "
                               f"bit-identical on {same}, max abs err {err}")
        phase("4d", f"{what} vs plain ({tuple(k.shape[1:])}, covered "
                    f"{(k[1] >= 0).float().mean().item():.3f}): vis identical on every "
                    f"pixel, all {len(names)} planes bit-identical on {same:.6f} of "
                    f"values, max abs err {err:.3g} (tolerance: bit-identical)")
        return err

    k5_in = raster_v1_inputs(setup, bins, big_ids, counts, tx, w, h)
    k5 = raster_v1_cuda(**k5_in)
    k5r = raster_v1_reference(**k5_in)
    torch.cuda.synchronize()
    k5_err = versus_plain(k5, k5r, ("depth", "visf", "l0", "l1"),
                          "K5, bench frame (bilinear filter)")
    k7_in = raster_mxu_inputs(setup, bins, big_ids, counts, ex["tris"], uv, wn,
                              d_t["tri_mat"], state["materials"], tx, w, h)
    k7 = raster_mxu_cuda(**k7_in)
    k7r = raster_mxu_reference(**k7_in)
    torch.cuda.synchronize()
    k7_err = versus_plain(k7, k7r, MXU_NAMES, "K7, bench frame (mxu, material maps off)")
    k1v = kp["visf"]
    phase("4d", f"K7 vs K1 on the same inputs: vis identical on "
                f"{(k7[1] == k1v).float().mean().item():.6f} of pixels, K5 vs K1 on "
                f"{(k5[1] == k1v).float().mean().item():.6f} (K7 evaluates its planes in "
                "the product's summation order, fma(b, yn, a*xn) + c, and takes no valid "
                "flag: edge pixels may pick apart)")

    # ---- 4d. the lighting kernel on the K5 frame's own arguments
    cfg5 = dataclasses.replace(cfg, texture_filter="bilinear")
    lt_in = record_lighting(cfg5, state, *inputs[0], dev)
    lt = lighting_cuda(**lt_in)
    ltr = lighting_reference(**lt_in)
    torch.cuda.synchronize()
    d = (lt - ltr).abs()
    lt_err, lt_off = d.max().item(), int((d > 1e-4 + 1e-3 * ltr.abs()).sum())
    if not torch.isfinite(lt).all() or lt_off:
        raise RuntimeError(f"lighting kernel vs plain: {lt_off} values outside atol 1e-4 / "
                           f"rtol 1e-3, max abs err {lt_err}")
    n_maps = 0 if lt_in["spotmaps"] is None else lt_in["spotmaps"].shape[0]
    phase("4d", f"lighting kernel vs plain (lighting_reference: the plain pass's PyTorch "
                f"operations on the card) on the K5 frame's arguments {W}x{H} "
                f"({lt_in['n_point']} point lights, {lt_in['n_spot']} spot, {n_maps} spot "
                f"map, {int(lt_in['probe_count'][0])} of {lt_in['probes'].shape[0]} SH probe "
                f"slots live, the env diffuse "
                f"{'as the sky SH-9' if lt_in['env_diff'] is None else 'a plane'}, covered "
                f"{lt_in['mask'].float().mean().item():.4f}): max abs err {lt_err:.3g}, "
                f"bit-identical on {(lt == ltr).float().mean().item():.6f} of values, 0 of "
                f"{lt.numel()} outside atol 1e-4 / rtol 1e-3")

    # ---- 5d. drive the K5, K7 and entry() frames
    cfg7 = dataclasses.replace(cfg, raster_kernel="mxu", enable_material_maps=False,
                               texture_filter="nearest")
    render5 = lambda d, s: F.render_frame(cfg5, state, d, s, device=dev)
    render7 = lambda d, s: F.render_frame(cfg7, state, d, s, device=dev)
    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda)
    n_stacks = 2 if cfg.shadow_far_res else 1
    no_shade = ("raster_shade", "raster_shade_2p", "shade_deferred", "shade_epilogue")
    pf5, _, img5, lum5 = drive(render5, inputs, kernels,
                               dict(raster_v1=1, raster_blend=2, raster_depth=n_stacks + 1,
                                    lighting=1),
                               forbid=no_shade + ("raster_mxu",))
    if any(f["raster_v1"] != 1 or f["raster_blend"] != 2 or f["lighting"] != 1
           or f["raster_depth"] != n_stacks + 1 for f in pf5):
        raise RuntimeError(f"K5 frame launches {pf5}")
    phase("5d", f"3 K5 frames {W}x{H} (the bench config, bilinear filter, deferred "
                f"branch): launches per frame {pf5} (K5 1, K4 2, K3 {n_stacks} sun "
                f"stacks + 1 perspective spot map, the lighting kernel 1, K1/K2/K6/K7 "
                f"0); image mean "
                f"{img5.float().mean().item():.2f}, luminance {lum5.item():.6g}")
    pf7, _, img7, lum7 = drive(render7, inputs, kernels, dict(raster_mxu=1, lighting=1),
                               forbid=no_shade + ("raster_v1",))
    if any(f["raster_mxu"] != 1 or f["lighting"] != 1 for f in pf7):
        raise RuntimeError(f"K7 frame launches {pf7}")
    phase("5d", f"3 K7 frames {W}x{H} (raster_kernel='mxu', material maps off, "
                f"nearest): launches per frame {pf7}; image mean "
                f"{img7.float().mean().item():.2f}, luminance {lum7.item():.6g}")
    ew, eh = ENTRY_SIZE
    ectx, ecam, eparams, emake = datumtest_scene(width=ew, height=eh, **ENTRY)
    estate = ectx.device_state(dev)
    ecfg = ectx.config
    e_inputs = [frame_inputs(ectx, ecam, eparams, emake, t) for t in (0.0, 0.1, 0.2)]
    render_e = lambda d, s: F.render_frame(ecfg, estate, d, s, device=dev)
    pfe, _, imge, lume = drive(render_e, e_inputs, kernels, {}, forbid=tuple(kernels),
                               overflow_limit=None, size=ENTRY_SIZE)
    e_ovf = int(render_e(*e_inputs[0])["bin_overflow"])
    phase("5d", f"entry() frame {ew}x{eh} (use_pallas=False: the scan raster, the XLA "
                f"lighting and blend as PyTorch ops on the card): launches per frame "
                f"{pfe} (no kernel of the port); image mean "
                f"{imge.float().mean().item():.2f}, luminance {lume.item():.6g}, "
                f"bin_overflow {e_ovf} (bins {ecfg.bin_capacity}+{ecfg.big_capacity}, "
                "as entry() sets them: printed, not held)")

    # ---- 5d. the 256x128 deferred frames on the card against the CPU plain path
    for name, kw in (("entry() config, ESM", DEFERRED_SMALL),
                     ("entry() config, PCF", dict(DEFERRED_SMALL, shadow_mode="pcf")),
                     ("K5 frame", K5_SMALL), ("K7 frame (256x64)",
                                              dict(K7_SMALL, height=64))):
        mctx, mcam, mparams, mmake = datumtest_scene(
            **dict(dict(width=256, height=128), **kw))
        if mctx.config.enable_fog:
            mparams.fogdensity = FOG_DENSITY
        md, ms = frame_inputs(mctx, mcam, mparams, mmake, 0.3)
        outs = [F.render_frame(mctx.config, mctx.host_state(), md, ms, device=d)
                for d in (dev, "cpu")]
        ia, ib = (o["image"].cpu().float() for o in outs)
        dimg = (ia - ib).abs()
        rmse = ((ia - ib) ** 2).mean().sqrt().item()
        vis = (outs[0]["vis"].cpu() == outs[1]["vis"]).float().mean().item()
        if dimg.mean().item() > 0.5 or rmse > 2.0 or ib.mean() <= 10 or vis < 0.999:
            raise RuntimeError(f"{name} card vs CPU plain: mean |d| "
                               f"{dimg.mean().item()}, RMSE {rmse} levels, vis {vis}")
        phase("5d", f"256x128 {name}, card vs CPU plain path: mean |d| "
                    f"{dimg.mean().item():.4f} levels, RMSE {rmse:.4f} levels (limits "
                    f"0.5, 2), max {dimg.max().item():.0f}, vis identical on {vis:.6f}")

    # ---- 5d. the stress golden through the port
    gold = torch.from_numpy(read_png(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
        "stress.png"))).float()
    gctx, gcam, gparams, gmake = stress_scene(**STRESS_GOLDEN)
    grl = gmake(0.0)
    gss = make_sceneset(gcam, gparams, point_lights=grl.point_lights)
    gout = F.render_frame(gctx.config, gctx.device_state(dev),
                          gctx.frame_draws(grl, gcam), gss, device=dev)
    gimg = gout["image"].cpu().float()
    g_rmse = (((gimg - gold) / 255.0) ** 2).mean().sqrt().item()
    phase("5d", f"stress golden config (tools/stress_golden.py, 320x160, "
                f"use_pallas=False) on the card vs tests/golden/stress.png: RMSE "
                f"{g_rmse:.5f} (the gate's 2/255 = {2 / 255:.5f}: printed, not held — "
                f"collapsed terrain cells, ROADMAP Queue 3), mean |d| "
                f"{(gimg - gold).abs().mean().item():.4f} levels, bin_overflow "
                f"{int(gout['bin_overflow'])}")

    # ---- 6d. timing (informational: this PR claims no speed)
    ms5 = frame_ms(render5, inputs, n=5)
    ms7 = frame_ms(render7, inputs, n=5)
    mse = frame_ms(render_e, e_inputs, n=5)
    prof5 = profile_frames(render5, inputs)
    profe = profile_frames(render_e, e_inputs[:1])      # one frame: ~1 s and 150K launches
    st5 = stage_table(render5, inputs)
    ste = stage_table(render_e, e_inputs[:1])
    phase("6d", f"{ms5:.3f} ms/frame K5 frame, {ms7:.3f} ms/frame K7 frame ({W}x{H}), "
                f"{mse:.3f} ms/frame entry() frame ({ew}x{eh}) (median of 5, CUDA "
                f"events) on {card}")
    phase("6d", f"under torch.profiler: K5 frame (3 frames) {prof5[0]:.3f} ms of device "
                f"time and {prof5[1]:.0f} launches per frame, busy {prof5[0] / ms5:.3f}; "
                f"entry() frame (1 frame) {profe[0]:.3f} ms and {profe[1]:.0f} launches, "
                f"busy {profe[0] / mse:.3f}")
    for name, stg in (("K5 frame (3 frames)", st5), ("entry() frame (1 frame)", ste)):
        phase("6d", f"{name} stages under torch.profiler, tracing on:\n" + stg)
    t = dict(k5=cuda_ms(lambda: raster_v1_cuda(**k5_in), 20),
             k5p=cuda_ms(lambda: raster_v1_reference(**k5_in), 1),
             k7=cuda_ms(lambda: raster_mxu_cuda(**k7_in), 20),
             k7p=cuda_ms(lambda: raster_mxu_reference(**k7_in), 1),
             k5_dev=device_ms(lambda: raster_v1_cuda(**k5_in)),
             k7_dev=device_ms(lambda: raster_mxu_cuda(**k7_in)))
    px = w * h
    walked = _walked(k5_in)
    b5 = bound(_nbytes(*(k5_in[k] for k in ("rows", "bins", "counts", "big_ids")))
               + 4 * px * 4, walked * 4096 * OPS_WALK_K5 + px * OPS_K5_PIXEL)
    b7 = bound(_nbytes(*(k7_in[k] for k in ("rows", "bins", "counts", "big_ids")))
               + 15 * px * 4, walked * 4096 * OPS_WALK_K7 + px * OPS_K7_PIXEL)
    # the TPU kernel's padded product: every tile walks ceil((B + count) /
    # 128) chunks of 128 entries, each two 16-row halves of (24 x 128)^T x
    # (24 x 6*2048) multiply-adds
    chunks = int(((k7_in["big_ids"].shape[0] + k7_in["counts"] + 127) // 128).sum())
    tpu_ops = chunks * 2 * 2 * 24 * 128 * 6 * 2048
    b7_tpu = tpu_ops / FP32_OPS_PER_S * 1e3
    lt_out = torch.empty_like(lt)
    t.update(lt=cuda_ms(lambda: lighting_cuda(**lt_in, out=lt_out), 20),
             ltp=cuda_ms(lambda: lighting_reference(**lt_in), 1),
             lt_dev=device_ms(lambda: lighting_cuda(**lt_in, out=lt_out)))
    blt = lighting_bound(lt_in)
    phase("6d", f"lighting kernel {t['lt']:.4f} ms (device time a call {t['lt_dev']:.4f} "
                f"ms) vs plain {t['ltp']:.3f} ms, bound {blt[0]:.4f} ms ({blt[1]}: "
                f"{blt[2] / 1e6:.1f} MB, {blt[3]} of {lt_in['mask'].numel()} pixels covered, "
                f"a background pixel reading its mask and writing 12 B), "
                f"{100 * blt[0] / t['lt_dev']:.1f}% of its bound by device time, on {card}")
    phase("6d", f"K5 {t['k5']:.3f} ms vs plain {t['k5p']:.3f} ms, bound {b5[0]:.4f} ms "
                f"({b5[1]}); K7 {t['k7']:.3f} ms vs plain {t['k7p']:.3f} ms, bound "
                f"{b7[0]:.4f} ms ({b7[1]}; operations counted as {walked} entries "
                f"walked x 4096 pixels x 6 "
                f"planes); the TPU's padded 24 x (6*2048) product would count "
                f"{tpu_ops:.4g} f32 operations, {b7_tpu:.4f} ms ({chunks} chunks, not the "
                f"work); bench inputs {W}x{H}, library call: none; device time a call "
                f"(device_ms): K5 {t['k5_dev']:.4f} ms, K7 {t['k7_dev']:.4f} ms, on "
                f"{card}")
    launches = dict(raster_v1=pf5[0]["raster_v1"], raster_mxu=pf7[0]["raster_mxu"],
                    lighting=pf5[0]["lighting"])
    return dict(t=t, b5=b5, b7=b7, b7_tpu=b7_tpu, blt=blt, launches=launches,
                errs=dict(k5=k5_err, k7=k7_err, lighting=lt_err),
                ms=dict(k5=ms5, k7=ms7, entry=mse),
                golden_rmse=g_rmse, inputs=dict(k7=k7_in, k5=k5_in))


def wall_ms(fn, reps=5):
    """Median wall ms of fn() synced before and after, over reps calls
    after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def env_phases(dev, card, kernels, bench_expect):
    """Phases 4e-6e: the local-environment frame (LOCAL_ENV, the box probe
    through ctx.add_environment) and the gather kernel.  K2 with the edm
    group against its plain version on the frame's inputs, the gather
    against tab[idx]; the megakernel probe frame, the deferred K5 probe
    frame, the bench frame with the DDA SSR and RenderContext.render at
    params.scale 0.5 driven with their launches checked; a 256x128 probe
    frame on the card against the CPU plain path; timings, stages and
    bounds.  Returns the numbers of K2's envd fields and the gather's
    JSON row."""
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.ops.gather_cuda import gather_rows, gather_rows_cuda, \
        gather_rows_reference
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
    from datum_tpu_torch.ops.shade_cuda import (
        ENVD_NAMES, shade_deferred_cuda, shade_deferred_reference, shade_inputs)
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.scenes import datumtest_scene

    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda)
    # ---- 4e. K2 with the edm group and the gather against their plain versions
    t0 = time.perf_counter()
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, local_env=True,
                                                   **LOCAL_ENV)
    cfg = ctx.config
    state = ctx.device_state(dev)
    envs = state["ibl"]["envprobes"]
    inputs = [frame_inputs(ctx, camera, params, make_rl, t) for t in (0.0, 0.1, 0.2)]
    draws, ss = frame_inputs(ctx, camera, params, make_rl, 0.3)
    phase("4e", f"local-environment scene {W}x{H} ({time.perf_counter() - t0:.1f} s): "
                f"{int(envs['count'])} box probe(s), cubemap {envs['mips'][0].shape[2]}^2 "
                f"x 6 with {len(envs['mips'])} mips, {int(ss['probes']['count'])} SH "
                f"probes, {int(draws['fogplanes']['count'])} fog plane(s)")
    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, state, d_t, s_t)
    planes, _ = F._raster_stage(cfg, state, d_t, ex, uv, clip, wn, wt)
    shadows = F._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf, ao, _ = F._shade_inputs(cfg, planes, state, d_t, s_t, shadows)
    kw = dict(proj=s_t["proj"], invview=s_t["invview"], ao=ao, spotsf=spotsf)
    k2e_in = shade_inputs(gpl, ss2, **kw)
    k2n_in = shade_inputs({k: v for k, v in gpl.items() if k not in ENVD_NAMES}, ss2, **kw)
    if not k2e_in["envd"] or int(k2e_in["counts"][3]) != 4:
        raise RuntimeError("K2's inputs lack the edm group or the 4 SH probes")
    edm = k2e_in["planes"][-1].float()       # bf16, as K2 reads it
    cover = (edm > 0.5).float().mean().item()
    halves = int((edm == 0.5).sum())
    hk = shade_deferred_cuda(**k2e_in)
    hr = shade_deferred_reference(**k2e_in)
    torch.cuda.synchronize()
    k2e_err = (hk - hr).abs().max().item()
    if (cover == 0 or not torch.isfinite(hk).all()
            or not torch.allclose(hk, hr, atol=1e-4, rtol=1e-3)):
        raise RuntimeError(f"K2 with edm vs plain: coverage {cover}, max abs err "
                           f"{k2e_err} (atol 1e-4 / rtol 1e-3)")
    moved = (hr - shade_deferred_reference(**k2n_in)).abs().amax(0) > 0
    phase("4e", f"K2 with the edm group vs plain ({W}x{H}, 4 SH probes): edm > 0.5 on "
                f"{cover:.4f} of pixels ({halves} exactly 0.5 in bf16: SH-9 kept), the "
                f"group moves {moved.float().mean().item():.4f} of pixels; hdr max abs "
                f"err {k2e_err:.3g} (atol 1e-4, rtol 1e-3)")
    gen = torch.Generator(device=dev).manual_seed(1)
    tab = torch.rand(GATHER_TABLE, device=dev, generator=gen)
    idx = torch.randint(0, GATHER_TABLE[0], (GATHER_ROWS,), device=dev,
                        generator=gen).to(torch.int32)
    gk = gather_rows_cuda(tab, idx, check_bounds=True)
    gr = gather_rows_reference(tab, idx)
    torch.cuda.synchronize()
    if not torch.equal(gk, gr) or not torch.equal(gk, tab[idx]):
        raise RuntimeError("the gather kernel differs from tab[idx]")
    gather_err = (gk - gr).abs().max().item()
    phase("4e", f"gather_rows vs tab[idx] ({GATHER_TABLE[0]}x{GATHER_TABLE[1]} f32 table, "
                f"{GATHER_ROWS} int32 indices, bounds checked): bit-identical on every "
                f"value (max abs err {gather_err})")

    # ---- 5e. the paths, each driven with the counts set to 0 just before
    cfg5 = dataclasses.replace(cfg, texture_filter="bilinear")
    cfg_dda = dataclasses.replace(cfg, ssr_mode="dda")
    render_e = lambda d, s: F.render_frame(cfg, state, d, s, device=dev)
    render_5 = lambda d, s: F.render_frame(cfg5, state, d, s, device=dev)
    render_dda = lambda d, s: F.render_frame(cfg_dda, state, d, s, device=dev)
    n_stacks = 2 if cfg.shadow_far_res else 1
    other = ("raster_shade_2p", "raster_v1", "raster_mxu", "gather_rows", "lighting")
    pfe, _, img, lum = drive(render_e, inputs, kernels,
                             dict(bench_expect, shade_deferred_envd=1), forbid=other)
    if any(f["shade_deferred_envd"] != f["shade_deferred"] for f in pfe):
        raise RuntimeError(f"a K2 launch of the probe frame lacked the edm group: {pfe}")
    launches = dict(shade_deferred_envd=pfe[0]["shade_deferred_envd"])
    phase("5e", f"3 megakernel probe frames {W}x{H} (box probe, 4 SH probes, fog plane): "
                f"launches per frame {pfe} (every K2 launch, the opaque layer's and the "
                f"lit layer's, carries the edm group); image mean "
                f"{img.float().mean().item():.2f}, luminance {lum.item():.6g}, bin_overflow 0")
    no_shade = ("raster_shade", "raster_shade_2p", "shade_deferred", "shade_epilogue",
                "shade_deferred_envd", "raster_mxu", "gather_rows")
    pf5, _, img5, lum5 = drive(render_5, inputs, kernels,
                               dict(raster_v1=1, raster_blend=2, raster_depth=n_stacks + 1,
                                    lighting=1),
                               forbid=no_shade)
    if any(f["raster_v1"] != 1 or f["lighting"] != 1 for f in pf5):
        raise RuntimeError(f"deferred probe frame launches {pf5}")
    phase("5e", f"3 deferred K5 probe frames {W}x{H} (bilinear: env_probe_lookup's taps, "
                f"then the lighting kernel with the probes' diffuse plane and the 4 SH "
                f"probes): launches per frame {pf5}; image mean "
                f"{img5.float().mean().item():.2f}, luminance {lum5.item():.6g}")
    pfd, _, imgd, _ = drive(render_dda, inputs, kernels,
                            dict(bench_expect, shade_deferred_envd=1), forbid=other)
    moved = (imgd.float() - img.float()).abs().mean().item()
    if moved <= 0.0:
        raise RuntimeError("the DDA SSR frame equals the binned SSR frame")
    phase("5e", f"3 probe frames with ssr_mode='dda': launches per frame {pfd}; mean |d| "
                f"{moved:.3f} levels from the binned-SSR frame")
    # the frame renders at half the viewport on tiles of the same size, so
    # a tile holds ~4x the triangles: bins 4x the bench's (at 160 the
    # main bins drop ~3,100 entries a frame, as the JAX package's would)
    sctx, scam, sparams, smake = datumtest_scene(
        width=W, height=SCALED_H, local_env=True,
        **dict(LOCAL_ENV, bin_capacity=4 * LOCAL_ENV["bin_capacity"]))
    sparams.scale = 0.5
    for k in kernels.values():
        k.launches = 0
    pfs = []
    for t in (0.0, 0.1, 0.2):
        before = {n: k.launches for n, k in kernels.items()}
        simg = sctx.render(scam, smake(t), sparams)
        pfs.append({n: k.launches - before[n] for n, k in kernels.items()})
        if (simg.shape != (SCALED_H, W, 3) or not simg.mean() > 10 or sctx.bin_overflow
                or not math.isfinite(sctx.luminance)):
            raise RuntimeError(f"scaled render: image {simg.shape} mean {simg.mean()}, "
                               f"bin_overflow {sctx.bin_overflow}, luminance "
                               f"{sctx.luminance}")
    if any(f[n] < m for f in pfs for n, m in dict(bench_expect,
                                                    shade_deferred_envd=1).items()):
        raise RuntimeError(f"a scaled render ran without its kernels: {pfs}")
    phase("5e", f"3 RenderContext.render calls at params.scale 0.5 (frame "
                f"{sctx.config.width // 2}x{sctx.config.height // 2}, bins "
                f"{sctx.config.bin_capacity}, blitted to {W}x{SCALED_H}): image {simg.shape} u8 mean {simg.mean():.2f}, luminance "
                f"{sctx.luminance:.6g}, bin_overflow 0, launches per frame {pfs}")
    mctx, mcam, mparams, mmake = datumtest_scene(width=256, height=128, local_env=True,
                                                 **dict(SMALL, max_fog_planes=1))
    mparams.fogdensity = FOG_DENSITY
    md, mss = frame_inputs(mctx, mcam, mparams, mmake, 0.3)
    for name, mcfg in (("megakernel", mctx.config),
                       ("deferred K5", dataclasses.replace(mctx.config,
                                                           texture_filter="bilinear")),
                       ("DDA SSR", dataclasses.replace(mctx.config, ssr_mode="dda"))):
        imgs = [F.render_frame(mcfg, mctx.host_state(), md, mss, device=d)["image"]
                .cpu().float() for d in (dev, "cpu")]
        dimg = (imgs[0] - imgs[1]).abs()
        rmse = ((imgs[0] - imgs[1]) ** 2).mean().sqrt().item()
        if dimg.mean().item() > 0.5 or rmse > 2.0 or imgs[1].mean() <= 10:
            raise RuntimeError(f"256x128 {name} probe frame card vs CPU plain: mean |d| "
                               f"{dimg.mean().item()}, RMSE {rmse} levels")
        phase("5e", f"256x128 {name} probe frame (fog density {FOG_DENSITY}), card vs "
                    f"CPU plain path: mean |d| {dimg.mean().item():.4f} levels, RMSE "
                    f"{rmse:.4f} levels (limits 0.5, 2)")

    # ---- 6e. timing (informational: this PR claims no speed)
    ms_e = frame_ms(render_e, inputs, n=5)
    ms_5 = frame_ms(render_5, inputs, n=5)
    ms_dda = frame_ms(render_dda, inputs, n=5)
    prof = profile_frames(render_e, inputs)
    w, h = cfg.padded_width, cfg.padded_height
    ibl_sky = {k: v for k, v in state["ibl"].items() if k != "envprobes"}
    state_sky = dict(state, ibl=ibl_sky)
    hdr = hk.permute(1, 2, 0)
    stages = {
        "plane assembly with the box probe": wall_ms(lambda: F._assemble_gplanes(
            cfg, planes, state, s_t, shadows, w, h)),
        "plane assembly, skybox only": wall_ms(lambda: F._assemble_gplanes(
            cfg, planes, state_sky, s_t, shadows, w, h)),
        "fog planes (1)": wall_ms(lambda: F._fog_planes(cfg, hdr, planes["depth"], d_t, s_t)),
        "DDA SSR (half res, upsample)": wall_ms(lambda: F._ssr(
            cfg_dda, state, s_t, hdr, planes["depth"], F._ssr_inputs_planes(gpl))),
        "binned SSR (quarter res)": wall_ms(lambda: F._ssr(
            cfg, state, s_t, hdr, planes["depth"], F._ssr_inputs_planes(gpl))),
    }
    t = dict(k2e=cuda_ms(lambda: shade_deferred_cuda(**k2e_in), 20),
             k2n=cuda_ms(lambda: shade_deferred_cuda(**k2n_in), 20),
             k2ep=cuda_ms(lambda: shade_deferred_reference(**k2e_in), 1),
             gather=cuda_ms(lambda: gather_rows_cuda(tab, idx), 50),
             gather_lib=cuda_ms(lambda: tab[idx], 50),
             gather_plain=cuda_ms(lambda: gather_rows_reference(tab, idx), 50),
             k2e_dev=device_ms(lambda: shade_deferred_cuda(**k2e_in)),
             gather_dev=device_ms(lambda: gather_rows_cuda(tab, idx)),
             gather_lib_dev=device_ms(lambda: tab[idx]))
    # the microbenchmark's own path: one counted gather_rows call
    for k in kernels.values():
        k.launches = 0
    gather_rows(tab, idx)
    torch.cuda.synchronize()
    bench_launches = gather_rows_cuda.launches
    if bench_launches != 1:
        raise RuntimeError(f"gather_rows launched {bench_launches} kernels")
    phase("6e", f"{ms_e:.3f} ms/frame megakernel probe frame, {ms_5:.3f} deferred K5 probe "
                f"frame, {ms_dda:.3f} probe frame with the DDA SSR (median of 5, CUDA "
                f"events, {W}x{H}) on {card}")
    phase("6e", f"megakernel probe frame under torch.profiler (3 frames): {prof[0]:.3f} ms "
                f"of device time and {prof[1]:.0f} launches per frame, busy "
                f"{prof[0] / ms_e:.3f}")
    phase("6e", "probe frame stages (ms, wall, synced, median of 5): "
          + "; ".join(f"{n} {v:.3f}" for n, v in stages.items()))
    px = w * h
    n_lights = int(k2e_in["counts"][0]) + int(k2e_in["counts"][1])
    k2_ops = px * (OPS_K2_PIXEL + OPS_K2_LIGHT * n_lights + OPS_K2_PROBE * 4)
    b = dict(k2e=bound(_nbytes(k2e_in["f32_planes"], k2e_in["planes"], k2e_in["ao"],
                               k2e_in["spotsf"]) + 3 * px * 4, k2_ops),
             k2n=bound(_nbytes(k2n_in["f32_planes"], k2n_in["planes"], k2n_in["ao"],
                               k2n_in["spotsf"]) + 3 * px * 4, k2_ops),
             gather=bound(_nbytes(tab, idx, gk), 0))
    phase("6e", f"K2 with the edm group {t['k2e']:.3f} ms, without it {t['k2n']:.3f} ms "
                f"(the same inputs), plain {t['k2ep']:.3f} ms; bounds {b['k2e'][0]:.4f} / "
                f"{b['k2n'][0]:.4f} ms ({b['k2e'][1]}); gather_rows {t['gather']:.4f} ms vs "
                f"tab[idx] {t['gather_lib']:.4f} ms (int32 indices), plain "
                f"{t['gather_plain']:.4f} ms, bound {b['gather'][0]:.4f} ms ({b['gather'][1]}"
                f"), launches {bench_launches} a benchmark call, 0 a frame; device time a "
                f"call (device_ms): K2 with the group {t['k2e_dev']:.4f} ms, gather_rows "
                f"{t['gather_dev']:.4f} ms, tab[idx] {t['gather_lib_dev']:.4f} ms; on {card}")
    return dict(t=t, b=b, errs=dict(k2e=k2e_err, gather=gather_err), launches=launches,
                bench_launches=bench_launches, cover=cover,
                ms=dict(probe=ms_e, deferred=ms_5, dda=ms_dda), inputs=dict(k2e=k2e_in))


def _region_masks(draws, vis, meshes):
    """Boolean (H, W) masks of the pixels whose visible triangle belongs
    to a draw of each mesh id in meshes (a dict name -> mesh id)."""
    tri = vis.long().clamp(min=0)
    mesh_of_px = draws["mesh"].long()[draws["tri_draw"].long()[tri]]
    return {n: (vis >= 0) & (mesh_of_px == m) for n, m in meshes.items()}


def _water_frame_inputs(dev):
    """A 256x128 megakernel frame with a translucent Water (push_water(
    translucent=True), the first ocean: the slab moves its grid) on the
    lit layer over a floor and a sphere: (cfg, ctx, draws, sceneset)."""
    import numpy as np

    from datum_tpu_torch.math import Transform
    from datum_tpu_torch.ops.common import FrameConfig
    from datum_tpu_torch.render import primitives
    from datum_tpu_torch.render.camera import Camera
    from datum_tpu_torch.render.context import RenderContext
    from datum_tpu_torch.render.renderlist import RenderList
    from datum_tpu_torch.render.types import RenderParams, make_sceneset
    from datum_tpu_torch.render.water import Water, push_water

    cfg = FrameConfig(width=256, height=128, max_vertices=1 << 13, max_triangles=1 << 13,
                      max_instances=8, bin_capacity=512, big_capacity=16,
                      enable_shadows=False, enable_material_maps=True,
                      texture_filter="mip_half", use_pallas=True,
                      max_dynamic_vertices=1 << 11, max_translucent_draws=2,
                      max_translucent_tris=2048, forward_bin_capacity=512)
    ctx = RenderContext(cfg, device=dev)
    sv, si = primitives.unit_sphere(12, 6)
    ball = ctx.add_mesh(sv, si)
    floor = ctx.add_mesh(*primitives.plane(20.0, 4.0))
    red = ctx.add_material(color=(0.85, 0.3, 0.2, 1), roughness=0.5)
    grey = ctx.add_material(color=(0.6, 0.6, 0.65, 1), roughness=0.9)
    wmat = ctx.add_water_material(color=(0.6, 0.8, 1.0, 0.35))
    water = Water(ctx, grid=24, patch_size=8.0, ripple=2e-3, flow=(0.2, 0.1))
    water.update(1.5)
    cam = Camera()
    cam.set_projection(np.radians(60), 2.0)
    cam.lookat(np.array([0.0, 3.0, 9.0]), np.array([0.0, 0.5, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=256, height=128)
    params.sundirection = np.float32([-0.3, -0.8, -0.4]) / np.linalg.norm([-0.3, -0.8, -0.4])
    params.sunintensity = np.float32([3.5, 3.4, 3.2])
    rl = RenderList()
    rl.push_mesh(floor, Transform.identity(), grey)
    rl.push_mesh(ball, Transform.translation([0.5, 0.3, 0.0]), red)
    push_water(rl, water, Transform.translation([-4.0, 0.4, -4.0]), wmat, translucent=True)
    ss = make_sceneset(cam, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    return cfg, ctx, ctx.frame_draws(rl, cam), ss


def vertex_phases(dev, card, kernels, bench):
    """Phases 3v-6v: the animated vertex stage (scenes.VertexModes: the
    skinned actor, 8x8 foliage blades and the FFT ocean's dynamic-vertex
    slab beside the bench scene, VERTEX_MODES).  3v: the scene's
    triangles, slab, palettes and overflows (main bins held at 0); 4v:
    skinning, the wind bends, the ocean's maps and the patched pool on
    the card against the same functions on the CPU, and K1, K2 and K3
    against their plain versions on this frame's inputs; 5v: 3 frames
    with the Animator, the Ocean and the wind time advancing by 1/60 s,
    their launches checked and each region's change printed; the ocean
    example against tests/golden/ocean.png; 256x128 vertex-modes frames
    (megakernel, deferred K5) and a translucent Water frame on the card
    against the CPU plain path; 6v: ms/frame beside the bench frame in
    turns, a profiler window and the vertex stage's wall ms with and
    without the three modes.  bench: (render, inputs) of the bench
    frame.  Returns the numbers PERF.md records."""
    import numpy as np
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.ops import geometry, ocean as ocean_ops
    from datum_tpu_torch.ops import shadow as shadow_ops
    from datum_tpu_torch.ops.raster_cuda import (PLANE_NAMES, raster_inputs,
                                                 raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_depth_cuda import (
        depth_inputs, raster_depth_cuda, raster_depth_reference)
    from datum_tpu_torch.ops.shade_cuda import (shade_deferred_cuda,
                                                shade_deferred_reference, shade_inputs)
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.scenes import VERTEX_MODES_CONFIG, datumtest_scene

    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda)
    vm_kw = dict(SCENE, **VERTEX_MODES_CONFIG)
    # ---- 3v. the scene at full width
    t0 = time.perf_counter()
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, vertex_modes=True,
                                                   device=dev, **vm_kw)
    cfg, vm = ctx.config, make_rl.vertex_modes
    md, offset = cfg.max_dynamic_vertices, vm.ocean.vertex_offset
    if offset + md > cfg.max_vertices:
        raise RuntimeError(f"the slab [{offset}, {offset + md}) passes the pool's "
                           f"{cfg.max_vertices} rows")
    state = ctx.device_state(dev)
    # 3 frames: the lights at t = 0, the animation advancing 1/60 s a frame
    inputs = []
    for _ in range(3):
        inputs.append(frame_inputs(ctx, camera, params, make_rl, 0.0))
        vm.update(1 / 60)
    build_s = time.perf_counter() - t0
    overflows = []
    for draws, ss in inputs:
        d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
        st_p = F.patch_dynamic(cfg, state, d_t)
        ex, _, clip, _, _, wp = F._vertex_stage(cfg, st_p, d_t, s_t)
        setup, bins, counts, big, main_ovf = F._bin_stage(cfg, ex, clip)
        ts = F.translucent_stream(st_p, d_t, s_t)
        st = F.oit_stream(cfg, st_p, d_t, s_t, ts, None)
        overflows.append(dict(
            main=int(main_ovf), max_bin=int(counts.max()),
            stacks=[int(shadow_ops.bin_stack(s, cfg.shadow_bin_capacity, cfg.big_capacity,
                                             return_overflow=True)[3])
                    for s in shadow_stacks(cfg, ex, wp, s_t)],
            lit=int(lit_bins(cfg, ts, return_overflow=True)[-1]),
            wboit=int(F.oit_bins(cfg, st, return_overflow=True)[3])))
    draws = inputs[0][0]
    dyn = draws["dyn"]
    n_pal = int((draws["palette_id"] > 0).sum())
    phase("3v", f"vertex-modes scene {W}x{H} ({build_s:.1f} s, 3 frames' inputs): "
                f"{int(draws['t_valid'].sum())} opaque + "
                f"{int(draws['translucent']['t_valid'].sum())} translucent triangles "
                f"drawn (the actor {vm.actor.trianglecount}, {len(vm.blades)} blades x "
                f"{vm.blade.trianglecount}, the ocean {vm.ocean.mesh.trianglecount}), "
                f"{int(draws['count'])} draws; slab {int(dyn['count'])} of {md} rows at "
                f"pool offset {offset} (+ {md} <= {cfg.max_vertices}), on "
                f"{dyn['positions'].device}; palettes {n_pal} actor(s) of "
                f"{cfg.max_palettes} x {cfg.max_bones} bones; bins "
                f"{cfg.bin_capacity}+{cfg.big_capacity}")
    phase("3v", f"overflow per frame (main bins, max entries in a bin, shadow stacks "
                f"{', '.join(STACKS)}, lit layer, WBOIT stream): {overflows}")
    if any(o["main"] for o in overflows):
        raise RuntimeError(f"vertex-modes main bins overflow: {overflows}")

    # ---- 4v. the vertex modes and K1/K2/K3 against the CPU / plain
    draws, ss = inputs[0]
    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    d_c, s_c = to_torch(draws, "cpu"), to_torch(ss, "cpu")
    st_p = F.patch_dynamic(cfg, state, d_t)
    st_c = F.patch_dynamic(cfg, ctx.device_state("cpu"), d_c)
    errs = {}
    if not torch.equal(st_p["geometry"]["attr12"].cpu(), st_c["geometry"]["attr12"]):
        raise RuntimeError("the patched pool on the card differs from the CPU's")
    errs["patched pool"] = 0.0
    src, vd = d_t["src_v"].long(), d_t["vtx_draw"].long()
    g = st_p["geometry"]
    rows = g["attr12"][src]
    skin_args = (rows[:, 0:3], rows[:, 5:8], rows[:, 8:12], g["bone_idx"][src],
                 g["bone_wt"][src], d_t["palettes"].reshape(-1, 8), d_t["palette_id"][vd])
    on_card = geometry.skin_vertices(*skin_args, cfg.max_bones)
    on_cpu = geometry.skin_vertices(*(a.cpu() for a in skin_args), cfg.max_bones)
    errs["skin_vertices"] = max((a.cpu() - b).abs().max().item()
                                for a, b in zip(on_card, on_cpu))
    fol = F._foliage_bend(rows[:, 0:3], d_t, vd)
    errs["inline wind bends"] = (fol.cpu() - F._foliage_bend(
        rows[:, 0:3].cpu(), d_c, vd.cpu())).abs().max().item()
    o = int(ctx.pool.mesh_vtx_offset[vm.blade.mesh_id])
    blade = torch.from_numpy(ctx.pool.positions[o:o + vm.blade.vertexcount].copy())
    anchor = vm.blades[0].translation_vec()
    for name, fn, a in (("wind_bend", geometry.wind_bend, (vm.WIND, (0, 0.35, 0))),
                        ("wind_detail_bend", geometry.wind_detail_bend,
                         (anchor, vm.wind_time, vm.WIND, (0, 0.1, 0)))):
        errs[name] = (fn(blade.to(dev), *a).cpu() - fn(blade, *a)).abs().max().item()
    oc = vm.ocean
    t_oc = torch.tensor(np.float32(oc.time))
    maps_c = ocean_ops.ocean_maps(*(x.cpu() for x in oc._spectrum_dev), t_oc,
                                  oc.params.choppiness)
    maps_g = ocean_ops.ocean_maps(*oc._spectrum_dev, t_oc.to(dev), oc.params.choppiness)
    errs["ocean_maps (rel. to max)"] = max(((a.cpu() - b).abs().max()
                                            / b.abs().max()).item()
                                           for a, b in zip(maps_g, maps_c))
    p = oc.params
    swell = (p.swellamplitude, *p.swelldirection, p.swellwavelength)
    base = oc._base_dev
    pg, ng = ocean_ops.displace_grid(base, *maps_g, oc.patch_size, swell)
    pc, nc = ocean_ops.displace_grid(base.cpu(), *maps_c, oc.patch_size, swell)
    errs["displace_grid"] = max((pg.cpu() - pc).abs().max().item(),
                                (ng.cpu() - nc).abs().max().item())
    cam = camera.position
    errs["ocean_lut_uv"] = (ocean_ops.ocean_lut_uv(pg, ng, cam).cpu()
                            - ocean_ops.ocean_lut_uv(pc, nc, cam)).abs().max().item()
    tol = {"ocean_maps (rel. to max)": 1e-5}
    bad = {k: v for k, v in errs.items() if not v <= tol.get(k, 1e-5)}
    if bad:
        raise RuntimeError(f"vertex modes on the card vs the CPU beyond 1e-5: {bad}")
    phase("4v", "on the card vs the same functions on the CPU, max abs err (limit 1e-5; "
                "the maps relative to their max |value|; the pool bit for bit): "
          + "; ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, st_p, d_t, s_t)
    k3_in = []
    for name, stk in zip(STACKS, shadow_stacks(cfg, ex, wp, s_t)):
        bins, counts, big = shadow_ops.bin_stack(stk, cfg.shadow_bin_capacity,
                                                 cfg.big_capacity)
        inp = depth_inputs(stk["setup"], bins, big, counts, stk["tiles_x"], stk["res"],
                           stk["height"])
        require_equal(raster_depth_cuda(**inp), raster_depth_reference(**inp),
                      f"K3 vs plain on the vertex-modes {name}")
        k3_in.append(inp)
    setup, bins, counts, big_ids, _ = F._bin_stage(cfg, ex, clip)
    k1_in = raster_inputs(setup, bins, big_ids, counts, ex["tris"], uv, wn, d_t["tri_mat"],
                          st_p["materials"], cfg.tiles_x, cfg.padded_width,
                          cfg.padded_height, wt)
    pk = raster_shade_cuda(**k1_in)
    check_k1(pk, raster_shade_reference(**k1_in), "vertex-modes opaque layer")
    kp = dict(zip(PLANE_NAMES, pk))
    shadows = F._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf, ao, _ = F._shade_inputs(cfg, kp, st_p, d_t, s_t, shadows)
    k2_in = shade_inputs(gpl, ss2, proj=s_t["proj"], invview=s_t["invview"], ao=ao,
                         spotsf=spotsf)
    hk, hr = shade_deferred_cuda(**k2_in), shade_deferred_reference(**k2_in)
    torch.cuda.synchronize()
    k2_err = (hk - hr).abs().max().item()
    if not torch.isfinite(hk).all() or not torch.allclose(hk, hr, atol=1e-4, rtol=1e-3):
        raise RuntimeError(f"K2 vs plain on the vertex-modes frame: {k2_err}")
    phase("4v", f"K3 on the 3 vertex-modes stacks bit-identical to plain; K1 above; K2 vs "
                f"plain hdr max abs err {k2_err:.3g} (atol 1e-4, rtol 1e-3)")

    # ---- 5v. the frames, counts set to 0 just before
    render_v = lambda d, s: F.render_frame(cfg, state, d, s, device=dev)
    per_frame = {"raster_shade": 2, "shade_deferred": 2, "raster_depth": 3,
                 "raster_blend": 1, "shade_epilogue": 1}
    pf, _, _, _ = drive(render_v, inputs, kernels, per_frame,
                        forbid=("raster_shade_2p", "raster_v1", "raster_mxu",
                                "gather_rows", "shade_deferred_envd"))
    if any(f[n] != m for f in pf for n, m in per_frame.items()):
        raise RuntimeError(f"vertex-modes launches {pf}, expected {per_frame} a frame")
    meshes = dict(actor=vm.actor.mesh_id, foliage=vm.blade.mesh_id,
                  ocean=vm.ocean.mesh.mesh_id)
    outs = [render_v(d, s) for d, s in inputs]
    moved = []
    for (da, _), (db, _), a, b in zip(inputs, inputs[1:], outs, outs[1:]):
        ma = _region_masks(to_torch(da, dev), a["vis"], meshes)
        mb = _region_masks(to_torch(db, dev), b["vis"], meshes)
        diff = (a["image"].float() - b["image"].float()).abs().mean(-1)
        moved.append({n: diff[ma[n] | mb[n]].mean().item() for n in meshes})
    cover = {n: m.float().mean().item() for n, m in _region_masks(
        to_torch(inputs[0][0], dev), outs[0]["vis"], meshes).items()}
    if any(not v > 0 for f in moved for v in f.values()):
        raise RuntimeError(f"a region did not change between frames: {moved}")
    phase("5v", f"3 vertex-modes frames {W}x{H} (Animator, Ocean and wind time + 1/60 s a "
                f"frame, lights fixed): launches per frame {pf}; regions cover {cover} of "
                f"the frame; mean |d| a region between frames (levels): {moved}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "examples")
    os.makedirs(out_dir, exist_ok=True)
    ost, rmse_ocean, mean_ocean, secs = golden_example("ocean", out_dir)
    ovf = ost["ctx"].bin_overflow
    if not rmse_ocean < 2 / 255 or ovf:
        raise RuntimeError(f"ocean example vs golden: RMSE {rmse_ocean}, overflow {ovf}")
    phase("5v", f"the ocean example through its harness on the card "
                f"({GOLDEN_ARGV[3]}x{GOLDEN_ARGV[5]}, 3 frames, {secs:.1f} s, deferred "
                f"default path) vs tests/golden/ocean.png: RMSE {rmse_ocean:.6f} (gate < "
                f"{2 / 255:.6f}), mean |d| {mean_ocean:.4f} levels")
    sctx, scam, sparams, smake = datumtest_scene(
        width=256, height=128, vertex_modes=True, ocean_grid=16, device=dev,
        **dict(SMALL, **dict(VERTEX_MODES_CONFIG, bin_capacity=512)))
    smake.vertex_modes.update(0.4)
    sd, sss = frame_inputs(sctx, scam, sparams, smake, 0.3)
    wcfg, wctx, wd, wss = _water_frame_inputs(dev)
    small = (("megakernel", sctx.config, sctx, sd, sss),
             ("deferred K5", dataclasses.replace(sctx.config, texture_filter="bilinear"),
              sctx, sd, sss),
             ("translucent Water", wcfg, wctx, wd, wss))
    small_d = {}
    for name, mcfg, mctx, md_, mss in small:
        imgs = [F.render_frame(mcfg, mctx.host_state(), md_, mss, device=d)["image"]
                .cpu().float() for d in (dev, "cpu")]
        dimg = (imgs[0] - imgs[1]).abs()
        rmse = ((imgs[0] - imgs[1]) ** 2).mean().sqrt().item()
        if dimg.mean().item() > 0.5 or rmse > 2.0 or imgs[1].mean() <= 10:
            raise RuntimeError(f"256x128 {name} vertex-modes frame card vs CPU plain: "
                               f"mean |d| {dimg.mean().item()}, RMSE {rmse} levels")
        small_d[name] = (dimg.mean().item(), rmse)
    phase("5v", "256x128 frames, card vs CPU plain path (mean |d|, RMSE levels; limits 0.5, "
                "2): " + "; ".join(f"{n} {a:.4f}, {b:.4f}" for n, (a, b) in small_d.items()))

    # ---- 6v. timing (informational: no frame gain is claimed)
    render_b, b_inputs = bench
    runs = dict(bench=[frame_ms(render_b, b_inputs)], vm=[])
    runs["vm"] += [frame_ms(render_v, inputs), frame_ms(render_v, inputs)]
    runs["bench"].append(frame_ms(render_b, b_inputs))
    prof = profile_frames(render_v, inputs)
    no_modes = dataclasses.replace(cfg, enable_skinning=False, enable_foliage=False,
                                   max_dynamic_vertices=0)
    stage = dict(
        with_modes=wall_ms(lambda: F._vertex_stage(cfg, F.patch_dynamic(cfg, state, d_t),
                                                   d_t, s_t)),
        without=wall_ms(lambda: F._vertex_stage(no_modes, state, d_t, s_t)),
        slab=wall_ms(lambda: vm.ocean.vertex_data(md, camera.position)))
    ms_vm, ms_b = statistics.mean(runs["vm"]), statistics.mean(runs["bench"])
    phase("6v", f"{ms_vm:.3f} ms/frame vertex-modes frame, {ms_b:.3f} ms/frame bench frame "
                f"(each the mean of 2 medians of 7, timed bench, vertex modes x2, bench: "
                f"{runs['bench'][0]:.3f}, {runs['vm'][0]:.3f}, {runs['vm'][1]:.3f}, "
                f"{runs['bench'][1]:.3f}; CUDA events, {W}x{H}) on {card}")
    phase("6v", f"vertex-modes frame under torch.profiler (3 frames): {prof[0]:.3f} ms of "
                f"device time and {prof[1]:.0f} launches per frame, busy "
                f"{prof[0] / ms_vm:.3f}")
    phase("6v", f"vertex stage (wall ms, synced, median of 5): with the three modes (slab "
                f"patch, gather, bends, skinning, transform) {stage['with_modes']:.3f}, "
                f"without them on the same draws {stage['without']:.3f}; the ocean's slab "
                f"(FFT, displace, LUT coords; Ocean.vertex_data) {stage['slab']:.3f} on "
                f"{card}")
    return dict(ms=ms_vm, ms_bench=ms_b, prof=prof, stage=stage, moved=moved,
                rmse_ocean=rmse_ocean, launches=pf[0], overflows=overflows)


def hud_sprites(ctx, seed=13):
    """Register the HUD's images on ctx (seeded): an opaque 32^2 icon, a
    layered icon (4 layers of 24^2), a translucent 64x32 panel image and
    the builtin font.  Returns their sprite ids."""
    import numpy as np

    rng = np.random.RandomState(seed)
    icon = rng.randint(0, 256, (32, 32, 4)).astype(np.uint8)
    icon[..., 3] = 255
    layered = rng.randint(0, 256, (4 * 24, 24, 4)).astype(np.uint8)
    panel = rng.randint(0, 256, (32, 64, 4)).astype(np.uint8)
    panel[..., 3] = 160
    ids = (ctx.add_sprite(icon), ctx.add_sprite(layered, layers=4),
           ctx.add_sprite(panel))
    ctx.set_overlay_font()
    return ids


def hud_renderlist(make_rl, t, ids):
    """The bench frame's render list at time t with the HUD pushed on
    top: the opaque icon, a layer of the layered icon, the icon rotated
    and translucent, a 600x200 panel and a 180^2 map (both larger than
    the 128-px window: sprite_arrays splits them into chunks) and 10
    lines of builtin-font text at scale 2 over the panel."""
    icon, layered, panel = ids
    rl = make_rl(t)
    rl.push_sprite((24, 24, 32, 32), icon)
    rl.push_sprite((70, 24, 48, 48), layered, layer=2)
    rl.push_sprite((140, 24, 40, 40), icon, tint=(1, 1, 1, 0.8), rotation=0.6)
    rl.push_sprite((16, H - 228, 600, 200), panel, tint=(0.6, 0.7, 1, 0.9))
    rl.push_sprite((W - 200, 20, 180, 180), layered, layer=1, rotation=0.2)
    for k in range(10):
        rl.push_text(f"LINE {k}: {t * 60 + k:05.1f} MS", (28, H - 220 + 19 * k),
                     tint=(1, 1, 0.4 + 0.06 * k, 1), scale=2)
    return rl


def sprite_rect_mask(inst, w, h):
    """(h, w) bool: each live sprite's bounding box, one pixel wider each
    side (every pixel a sprite can paint)."""
    import numpy as np

    mask = np.zeros((h, w), bool)
    for i in range(int(inst["count"])):
        o, ax, ay = inst["origin"][i], inst["axis_x"][i], inst["axis_y"][i]
        xs = [o[0], o[0] + ax[0], o[0] + ay[0], o[0] + ax[0] + ay[0]]
        ys = [o[1], o[1] + ax[1], o[1] + ay[1], o[1] + ax[1] + ay[1]]
        x0, x1 = int(np.floor(min(xs))) - 1, int(np.ceil(max(xs))) + 1
        y0, y1 = int(np.floor(min(ys))) - 1, int(np.ceil(max(ys))) + 1
        mask[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = True
    return mask


def ring_ms(log, name, frames):
    """Wall ms of the timed block `name` in each of the debug ring's
    frames in `frames` (its begin/end pairs within the frame summed)."""
    from datum_tpu_torch.debug.debug import ENTRY_BEGIN, ENTRY_END

    out = {f: 0.0 for f in frames}
    start = {}
    for idx in range(max(0, log.tail - log.size), log.tail):
        kind, n, ts, _, _, frame = log.entries[idx % log.size]
        if n != name or frame not in out:
            continue
        if kind == ENTRY_BEGIN:
            start[frame] = ts
        elif kind == ENTRY_END and frame in start:
            out[frame] += (ts - start.pop(frame)) * 1e3
    return [out[f] for f in frames]


def profile_call(fn):
    """(device ms, kernel launches) of one fn() under torch.profiler."""
    return profile_frames(lambda d, s: fn(), [(None, None)])


def overlay_phases(dev, card, kernels, bench):
    """Phases 4o-6o: the sprite and text pass, the host overlays, the
    scene systems and the city example.  4o: the HUD (HUD: the bench
    config with 256 sprite instances and a 128-px window; icons, a
    layered and a rotated one, a panel and a map split into chunks, 10
    lines of text) on the bench scene at full width; the sprite kernel
    against its plain version on the HUD's instances over the frame
    without the HUD, bit for bit.  5o: 3 HUD frames through
    RenderContext.render with the kernel counts set to 0 just before
    and read just after (K1 2, K2 2, K3 3, K4 1, epilogue 1, sprite pass
    1 a frame); the HUD frame equal to the frame without the HUD (same
    context, no SSAO history) outside the sprites' rectangles; 3 HUD
    frames at params.scale 0.5 (the sprites composite after the blit:
    the opaque icon's pixels equal the scale-1 frame's); the city example
    through its harness (examples/city.py's config, use_pallas off:
    the scan raster, no kernel) at full width for one frame with the
    debug overlay, and at the golden's 320x160 for 3 frames: 43 of 73
    meshes visible, the frame against tests/golden/city.png at 2/255
    with CITY_GOLDEN_SLIVERS in the cascade stack (golden_slivers), and
    the port's own frame's RMSE printed.  6o: the HUD frame's ms/frame
    beside the bench frame in turns and their launches under
    torch.profiler, the host ms of the draws with and without the HUD,
    the sprite kernel's and the plain pass's ms (the plain pass's
    launches counted), the city frame's and its host culling's ms from
    the debug ring, and the phases' wall time.  bench: (render, inputs) of
    the bench frame.  The city PNGs go to chiprun_out/city/.  Returns the
    numbers the kernels line and PERF.md record."""
    import numpy as np
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.debug import debug as dbg
    from datum_tpu_torch.examples import city
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
    from datum_tpu_torch.ops.sprite_pass import composite_sprites_reference
    from datum_tpu_torch.ops.sprite_pass_cuda import composite_sprites_cuda
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda,
                   sprite_pass=composite_sprites_cuda)
    expect = dict({n: 0 for n in kernels}, raster_shade=2, shade_deferred=2,
                  raster_depth=3, raster_blend=1, shade_epilogue=1, sprite_pass=1)

    def count(fn, n):
        """fn(i) for i < n with every count set to 0 just before; the
        per-frame launches, checked against expect, and the last result."""
        for k in kernels.values():
            k.launches = 0
        per = []
        for i in range(n):
            before = {m: k.launches for m, k in kernels.items()}
            out = fn(i)
            torch.cuda.synchronize()
            per.append({m: k.launches - before[m] for m, k in kernels.items()})
        if any(f != expect for f in per):
            raise RuntimeError(f"HUD frame launches {per}, expected {expect} a frame")
        return per[0], out

    # ---- 4o. the HUD scene; the sprite kernel vs plain on its inputs
    t_all = t0 = time.perf_counter()
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, device=dev, **HUD)
    cfg, R = ctx.config, ctx.overlay_region()
    ids = hud_sprites(ctx)
    n_pushed = len(hud_renderlist(make_rl, 0.0, ids).sprites)
    plain_img = ctx.render(camera, make_rl(0.0), params)
    hud_draws = ctx.frame_draws(hud_renderlist(make_rl, 0.0, ids), camera)
    inst = hud_draws["sprites"]
    n_live, atlas = int(inst["count"]), ctx._state["overlay_atlas"]
    if not n_pushed < n_live <= cfg.max_overlay_sprites:
        raise RuntimeError(f"HUD: {n_live} instances from {n_pushed} pushes")
    rgb = torch.from_numpy(plain_img).to(dev).float() / torch.tensor(255.0, device=dev)
    inst_t = to_torch(inst, dev)
    ks = composite_sprites_cuda(rgb, inst_t, atlas, R)
    ps = composite_sprites_reference(rgb, inst_t, atlas, R)
    torch.cuda.synchronize()
    if not torch.equal(ks.view(torch.int32), ps.view(torch.int32)):
        same = (ks == ps).float().mean().item()
        raise RuntimeError(f"sprite kernel vs plain: bit-identical on {same} of values")
    sp_err = (ks - ps).abs().max().item()
    changed = (ks != rgb).any(-1).float().mean().item()
    phase("4o", f"HUD scene {W}x{H} ({time.perf_counter() - t0:.1f} s): {n_pushed} pushes "
                f"-> {n_live} instances of {cfg.max_overlay_sprites} (the panel and the "
                f"map split into chunks), window {R}, atlas {tuple(atlas.shape)}; the "
                f"sprite kernel vs plain on them: every bit equal ({changed:.4f} of "
                f"pixels changed)")

    # ---- 5o. the HUD frames, counts set to 0 just before
    hud = lambda i: ctx.render(camera, hud_renderlist(make_rl, 0.0, ids), params)
    pf, img_hud = count(hud, 3)
    mask = sprite_rect_mask(inst, W, H)
    outside = ~mask
    if not np.array_equal(img_hud[outside], plain_img[outside]):
        raise RuntimeError(f"the HUD frame differs from the frame without it outside "
                           f"the sprites on {(img_hud != plain_img)[outside].mean()}")
    inside = (img_hud != plain_img).any(-1)[mask].mean()
    phase("5o", f"3 HUD frames through RenderContext.render: launches per frame {pf}; "
                f"outside the sprites' rectangles ({outside.mean():.4f} of the frame) "
                f"every pixel equals the frame without the HUD; {inside:.4f} of the "
                f"pixels inside changed")
    half = dataclasses.replace(params, scale=0.5)
    pf_half, img_half = count(lambda i: ctx.render(camera, hud_renderlist(
        make_rl, 0.0, ids), half), 3)
    if img_half.shape != img_hud.shape or tuple(ctx.last_depth.shape) != (H // 2, W // 2):
        raise RuntimeError(f"scale 0.5: image {img_half.shape}, depth "
                           f"{tuple(ctx.last_depth.shape)}")
    icon = (slice(28, 52), slice(28, 52))      # the opaque icon's inner pixels
    if not np.array_equal(img_half[icon], img_hud[icon]):
        raise RuntimeError("scale 0.5: the opaque icon is not where it was pushed")
    phase("5o", f"3 HUD frames at params.scale 0.5 ({W // 2}x{H // 2} rendered, "
                f"{W}x{H} out): launches per frame {pf_half}; the opaque icon's pixels "
                f"equal the scale-1 frame's (display-space sprites)")

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "city")
    os.makedirs(out_dir, exist_ok=True)
    frame0 = dbg.g_debuglog.frame
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    cstate = city.main(["--frames", "1", "--width", str(W), "--height", str(H),
                        "--overlay", "--out", os.path.join(out_dir, "city.png")])
    city_s = time.perf_counter() - t0
    city_launches = {n: k.launches for n, k in kernels.items() if k.launches}
    cimg = read_png(os.path.join(out_dir, "city.png"))
    if cimg.shape != (H, W, 3) or not cimg.mean() > 10 or city_launches:
        raise RuntimeError(f"city {W}x{H}: image {cimg.shape} mean {cimg.mean()}, "
                           f"kernel launches {city_launches}")
    ring = dict(render=ring_ms(dbg.g_debuglog, "render", [frame0 + 1])[0],
                cull=ring_ms(dbg.g_debuglog, "cull", [frame0 + 1])[0])
    phase("5o", f"city example {W}x{H} through its harness (1 frame, --overlay; "
                f"{city_s:.1f} s with the set-up): {cstate['stats'][0]}/"
                f"{cstate['stats'][1]} meshes after frustum + occlusion culling, "
                f"bin_overflow {cstate['ctx'].bin_overflow}, no kernel launched "
                f"(use_pallas off)")
    gw, gh = CITY_GOLDEN
    with golden_slivers():
        gstate = city.main(["--frames", "3", "--width", str(gw), "--height", str(gh),
                            "--out", os.path.join(out_dir, "city_golden.png")])
    gimg = read_png(os.path.join(out_dir, "city_golden.png")).astype(np.float32)
    own = city.render(gstate).astype(np.float32)     # the port's own cascades
    gold = read_png(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "tests", "golden", "city.png")).astype(np.float32)
    rmse = lambda a, b: float(np.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2)))
    city_rmse, city_rmse_own = rmse(gimg, gold), rmse(own, gold)
    city_mean = float(np.abs(gimg - gold).mean())
    if gstate["stats"] != (43, 73) or not city_rmse < 2 / 255 or not city_mean <= 0.5:
        raise RuntimeError(f"city golden: {gstate['stats']} visible, RMSE {city_rmse} "
                           f"(< {2 / 255}), mean |d| {city_mean} levels (<= 0.5)")
    phase("5o", f"city example {gw}x{gh} (3 frames) vs tests/golden/city.png: "
                f"{gstate['stats'][0]}/{gstate['stats'][1]} visible; with the jitted "
                f"reference's {len(CITY_GOLDEN_SLIVERS)} zero-area-triangle texels in the "
                f"cascade stack RMSE {city_rmse:.6f} (gate < {2 / 255:.6f}), mean |d| "
                f"{city_mean:.4f} levels (gate <= 0.5); the port's own frame RMSE "
                f"{city_rmse_own:.6f} (printed: ROADMAP Queue 3)")

    # ---- 6o. timing (informational: no frame gain is claimed)
    render_b, b_inputs = bench
    state_h = ctx._state
    render_h = lambda d, s: F.render_frame(cfg, state_h, d, s, device=dev)
    h_inputs = []
    for t in (0.0, 0.1, 0.2):
        rl = hud_renderlist(make_rl, t, ids)
        h_inputs.append((ctx.frame_draws(rl, camera), make_sceneset(
            camera, params, point_lights=rl.point_lights, spot_lights=rl.spot_lights,
            probes=rl.probes)))
    runs = dict(bench=[frame_ms(render_b, b_inputs)], hud=[])
    runs["hud"] += [frame_ms(render_h, h_inputs), frame_ms(render_h, h_inputs)]
    runs["bench"].append(frame_ms(render_b, b_inputs))
    ms_h, ms_b = statistics.mean(runs["hud"]), statistics.mean(runs["bench"])
    prof_h, prof_b = profile_frames(render_h, h_inputs), profile_frames(render_b, b_inputs)
    t = dict(sp=cuda_ms(lambda: composite_sprites_cuda(rgb, inst_t, atlas, R), 20),
             sp_dev=device_ms(lambda: composite_sprites_cuda(rgb, inst_t, atlas, R)),
             plain=cuda_ms(lambda: composite_sprites_reference(rgb, inst_t, atlas, R), 1))
    plain_prof = profile_call(lambda: composite_sprites_reference(rgb, inst_t, atlas, R))
    b_sp = bound(2 * _nbytes(rgb) + _nbytes(atlas, *inst_t.values()),
                 n_live * R * R * OPS_SPRITE_PIXEL)
    host_h = wall_ms(lambda: ctx.frame_draws(hud_renderlist(make_rl, 0.0, ids), camera))
    host_b = wall_ms(lambda: ctx.frame_draws(make_rl(0.0), camera))
    phase("6o", f"{ms_h:.3f} ms/frame HUD frame, {ms_b:.3f} ms/frame bench frame (each "
                f"the mean of 2 medians of 7, timed bench, HUD x2, bench: "
                f"{runs['bench'][0]:.3f}, {runs['hud'][0]:.3f}, {runs['hud'][1]:.3f}, "
                f"{runs['bench'][1]:.3f}; CUDA events around render_frame, {W}x{H}) on "
                f"{card}")
    phase("6o", f"under torch.profiler (3 frames each): HUD frame {prof_h[0]:.3f} ms of "
                f"device time and {prof_h[1]:.0f} launches a frame, bench frame "
                f"{prof_b[0]:.3f} ms and {prof_b[1]:.0f} launches; the draws on the host "
                f"(frame_draws, wall, median of 5) {host_h:.3f} ms with the HUD "
                f"(sprite_arrays), {host_b:.3f} ms without, on {card}")
    phase("6o", f"sprite kernel {t['sp']:.4f} ms a call ({t['sp_dev']:.4f} ms device time) "
                f"vs plain {t['plain']:.3f} ms ({plain_prof[1]:.0f} launches, "
                f"{plain_prof[0]:.3f} ms of device time) on {n_live} instances, window "
                f"{R}, {W}x{H}; bound {b_sp[0]:.4f} ms by {b_sp[1]} on {card}")
    phase("6o", f"city frame {W}x{H}, the debug ring's ms of its harness frame: "
                f"'render' (the culling, the frame, its read-back and the two "
                f"depth-tested gizmos) {ring['render']:.3f}; 'cull' (fill_occlusion + "
                f"update_meshes) {ring['cull']:.3f} on {card}")
    phase("6o", f"phases 4o-6o took {time.perf_counter() - t_all:.1f} s")
    return dict(err=sp_err, t=t, bound=b_sp, launches=pf["sprite_pass"], n_live=n_live,
                plain_launches=plain_prof[1], ms_hud=ms_h, ms_bench=ms_b, prof_h=prof_h,
                prof_b=prof_b, city_ms=ring["render"], cull_ms=ring["cull"],
                host_hud=host_h, host_bench=host_b,
                city_rmse=city_rmse, city_rmse_own=city_rmse_own)


# the examples held to their goldens on the card in phase 5p, at
# datum_tpu/tools/update_goldens.py's config (3 frames at 320x160);
# ocean's golden is held in phase 5v through its example module
GOLDEN_EXAMPLES = ("triangle", "material", "skybox", "stardust", "asteroids",
                   "datumtest")
GOLDEN_ARGV = ["--frames", "3", "--width", "320", "--height", "160"]
# tests/test_particles_render.py's burst: 8000 live particles of one
# system, past the 4096 quads where the JAX package's billboards switch
# to its native helper; drawn at max_particle_quads 8192
BURST_QUADS = 8192


def burst_system():
    """The 8000-particle burst system (sphere emitter of radius 2,
    constant 10 s life, seed 3) and its instance after one 0.02 s step at
    the datumtest example's emitter position."""
    import numpy as np

    from datum_tpu_torch.examples.datumtest import EMITTER
    from datum_tpu_torch.math import Transform
    from datum_tpu_torch.render.particlesystem import (
        Distribution, ParticleEmitter, ParticleSystem)

    ps = ParticleSystem(maxparticles=9000, emitters=[ParticleEmitter(
        rate=0.0, bursts=[(0.0, 8000)], life=Distribution.constant(10.0),
        velocity=Distribution.uniform(0.2, 1.0), shape="sphere", shape_radius=2.0,
        size=Distribution.uniform(0.05, 0.3), rotation=Distribution.uniform(0.0, 3.0),
        color=Distribution.constant([1, 1, 1, 1]),
        acceleration=np.zeros(3, np.float32))])
    inst = ps.create(seed=3)
    ps.update(inst, 0.02, Transform.translation(EMITTER))
    return ps, inst


def jittered_rebake(sky_params, jitter=1e-6, seed=0):
    """The skybox example's re-bake (64^2, 16 samples) on the CPU with
    every GGX tap direction (ops/ibl.py::ggx_taps) scaled by 1 + jitter
    times a normal draw: the bake's own sensitivity to a rounding-sized
    change of its taps.  Returns the levels."""
    import torch

    from datum_tpu_torch.ops import ibl
    from datum_tpu_torch.render.skybox import SkyBox, render_skybox

    orig, gen = ibl.ggx_taps, torch.Generator().manual_seed(seed)

    def jittered(n, roughness, samples):
        for l, ndl in orig(n, roughness, samples):
            yield l * (1 + jitter * torch.randn(l.shape, generator=gen)), ndl

    ibl.ggx_taps = jittered
    with contextlib.ExitStack() as done:
        done.callback(setattr, ibl, "ggx_taps", orig)
        sky = SkyBox(size=64, convolve_samples=16, device="cpu")
        return render_skybox(sky, sky_params, device="cpu").mips


def live_renderlist(make_rl, t, instance):
    """The bench scene's renderlist at t with a live particle instance in
    place of its static cloud."""
    rl = make_rl(t)
    rl.particles = []
    rl.push_particles(instance)
    return rl


def k4_stream(cfg, state, draws, ss, dev):
    """K4's inputs on a frame's merged WBOIT stream (the opaque depth from
    K1's plain version) and the stream's forward-bin overflow."""
    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.ops.raster_blend_cuda import blend_inputs
    from datum_tpu_torch.ops.raster_cuda import raster_inputs, raster_shade_reference
    from datum_tpu_torch.render import frame as F

    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    ex, uv, clip, wn, wt, _ = F._vertex_stage(cfg, state, d_t, s_t)
    setup, bins, counts, big_ids, _ = F._bin_stage(cfg, ex, clip)
    depth = raster_shade_reference(**raster_inputs(
        setup, bins, big_ids, counts, ex["tris"], uv, wn, d_t["tri_mat"],
        state["materials"], cfg.tiles_x, cfg.padded_width, cfg.padded_height, wt))[0]
    ts = F.translucent_stream(state, d_t, s_t)
    st = F.oit_stream(cfg, state, d_t, s_t, ts, None)
    obins, ocounts, obig, ovf = F.oit_bins(cfg, st, return_overflow=True)
    return blend_inputs(st["setup"], obins, obig, ocounts, st["tris"], st["uv"],
                        st["color"], depth, cfg.tiles_x, cfg.padded_width,
                        cfg.padded_height, "per_tri", None, st["soft_flag"],
                        st["peel_flag"]), int(ovf)


def golden_example(name, out_dir, slivers=None):
    """datum_tpu_torch.examples.<name> through its harness on the card at
    its golden's config (with slivers: DATUMTEST_GOLDEN_SLIVERS in its
    cascade stack); (its state, RMSE and mean |d| against
    tests/golden/<name>.png, seconds)."""
    import importlib

    import numpy as np

    mod = importlib.import_module(f"datum_tpu_torch.examples.{name}")
    out = os.path.join(out_dir, f"{name}.png")
    t0 = time.perf_counter()
    with golden_slivers(*slivers) if slivers else contextlib.nullcontext():
        state = mod.main(GOLDEN_ARGV + ["--out", out])
    secs = time.perf_counter() - t0
    img = read_png(out).astype(np.float32)
    gold = read_png(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                     "golden", f"{name}.png")).astype(np.float32)
    if img.shape != gold.shape:
        raise RuntimeError(f"{name}: image {img.shape}, golden {gold.shape}")
    d = img - gold
    return state, float(np.sqrt(np.mean((d / 255.0) ** 2))), float(np.abs(d).mean()), secs


def particle_phases(dev, card, kernels, bench):
    """Phases 3p-6p: the particle system, the platform layer, the sky
    re-bake, the live material and texture edits and the seven pack-free
    example apps.  3p: the datumtest example through its harness at full
    width (the scan raster: no kernel), its live particle count after
    each update and its bin overflows, 3 frames with every kernel count
    0.  4p: the bench frame with the example's live ParticleSystem (after
    90 steps) in place of the static cloud, and with the 8000-particle
    burst at max_particle_quads 8192: K4 against its plain version on
    each merged stream (phase 4's tolerance), each frame driven once
    with its launches checked; render_skybox at the skybox example's size
    (64, 16 samples) on the card against the CPU bake; update_texture and
    update_material (a parameter edit and a map rebinding) on a rendered
    bench context against a context given the edited values before its
    first frame (device state and frame, bit for bit).  5p: the six
    examples of GOLDEN_EXAMPLES through their harness at the golden's
    config against tests/golden/<name>.png at RMSE < 2/255 (datumtest
    with DATUMTEST_GOLDEN_SLIVERS in its cascade stack, its own frame's
    RMSE printed), and stardust and asteroids for one frame at full
    width.  6p: the datumtest example's ms/frame at full width (CUDA
    events around its render), the particle updates' host ms (the
    example's system; stardust's four on the worker pool), the
    billboards' host ms at 8000 particles, the re-bake's ms, and the
    bench frame with the live stream beside the bench frame in turns and
    under torch.profiler.  bench: (render, inputs) of the bench frame.
    PNGs go to chiprun_out/examples/.  Returns the numbers the kernels
    line and PERF.md record."""
    import numpy as np
    import torch

    from datum_tpu_torch.examples import asteroids, datumtest, stardust
    from datum_tpu_torch.math import Transform
    from datum_tpu_torch.ops.raster_blend_cuda import (
        raster_blend_cuda, raster_blend_reference)
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.render.skybox import SkyBox, render_skybox
    from datum_tpu_torch.scenes import datumtest_scene

    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "examples")
    os.makedirs(out_dir, exist_ok=True)
    reset = lambda: [setattr(k, "launches", 0) for k in kernels.values()]
    launched = lambda: {n: k.launches for n, k in kernels.items() if k.launches}

    # ---- 3p. the datumtest example through its harness at full width
    t_all = t0 = time.perf_counter()
    counts, overflows = [], []
    update, render = datumtest.update, datumtest.render

    def counted_update(state, dt):
        update(state, dt)
        counts.append(state["inst"].count)

    def counted_render(state):
        img = render(state)
        overflows.append(state["ctx"].bin_overflow)
        return img

    datumtest.update, datumtest.render = counted_update, counted_render
    reset()
    try:
        dstate = datumtest.main(["--frames", "3", "--width", str(W), "--height", str(H),
                                 "--out", os.path.join(out_dir, "datumtest_full.png")])
    finally:
        datumtest.update, datumtest.render = update, render
    torch.cuda.synchronize()
    d_launches = launched()
    dimg = read_png(os.path.join(out_dir, "datumtest_full.png"))
    if (len(counts) != 3 or not counts[1] > 0 or d_launches or dimg.shape != (H, W, 3)
            or not dimg.mean() > 10):
        raise RuntimeError(f"datumtest {W}x{H}: live particles {counts}, kernel launches "
                           f"{d_launches}, image {dimg.shape} mean {dimg.mean()}")
    phase("3p", f"datumtest example {W}x{H} through its harness (3 frames, "
                f"{time.perf_counter() - t0:.1f} s with the set-up): live particles after "
                f"each update {counts}, bin_overflow per frame {overflows}, exposure "
                f"{dstate['camera'].exposure:.4f} (adapted from ctx.luminance), no kernel "
                f"launched (use_pallas off: the scan raster)")

    # ---- 4p. K4 on the live stream and on the 8000-particle burst
    t0 = time.perf_counter()
    ps = datumtest.particle_system()
    inst = ps.create(seed=2)
    emitter = Transform.translation(datumtest.EMITTER)
    for _ in range(90):
        ps.update(inst, 1 / 60, emitter)
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, device=dev, **SCENE)
    cfg, state = ctx.config, ctx.device_state(dev)
    render_b = lambda d, s: F.render_frame(cfg, state, d, s, device=dev)
    live = [frame_inputs(ctx, camera, params, lambda t: live_renderlist(make_rl, t, inst), t)
            for t in (0.0, 0.1, 0.2)]
    bps, binst = burst_system()
    bctx, bcam, bparams, bmake = datumtest_scene(
        width=W, height=H, device=dev, **dict(SCENE, max_particle_quads=BURST_QUADS))
    bcfg, bstate = bctx.config, bctx.device_state(dev)
    burst = [frame_inputs(bctx, bcam, bparams,
                          lambda t: live_renderlist(bmake, t, binst), 0.0)]
    errs, k4_live = {}, {}
    for name, c, st, (draws, ss), n_live in (
            ("live stream", cfg, state, live[0], inst.count),
            ("8000-particle burst", bcfg, bstate, burst[0], binst.count)):
        quads = int(draws["forward"]["quad_count"])
        if quads != n_live:
            raise RuntimeError(f"{name}: {quads} quads of {n_live} live particles")
        k4_in, ovf = k4_stream(c, st, draws, ss, dev)
        bk = raster_blend_cuda(**k4_in)
        br = raster_blend_reference(**k4_in)
        torch.cuda.synchronize()
        errs[name] = check_same(bk, br, f"K4, {name} ({quads} particle quads)",
                                f"; forward-bin overflow {ovf}, particles and translucents "
                                f"cover {(br[3] > 0).float().mean().item():.4f} of pixels",
                                tag="4p")
        k4_live[name] = k4_in
    expect = dict(raster_shade=2, shade_deferred=2, shade_epilogue=1, raster_depth=3,
                  raster_blend=1)
    pf_live, _, _, _ = drive(render_b, live[:1], kernels, expect,
                             forbid=("raster_shade_2p", "sprite_pass"))
    pf_burst, _, _, _ = drive(lambda d, s: F.render_frame(bcfg, bstate, d, s, device=dev),
                              burst, kernels, expect, overflow_limit=None,
                              forbid=("raster_shade_2p", "sprite_pass"))
    phase("4p", f"bench frame {W}x{H} with the live stream ({inst.count} particles after "
                f"90 steps): launches {pf_live}; with the burst ({binst.count} particles, "
                f"max_particle_quads {BURST_QUADS}): launches {pf_burst} "
                f"({time.perf_counter() - t0:.1f} s)")

    cpu_sky = SkyBox(size=64, convolve_samples=16, device="cpu")
    dev_sky = SkyBox(size=64, convolve_samples=16, device=dev)
    for sky, d in ((cpu_sky, "cpu"), (dev_sky, dev)):
        render_skybox(sky, dataclasses.replace(sky.params, sundirection=(-0.6, -0.55,
                                                                          -0.58)), device=d)
    # the GGX chain is ill-conditioned in its tap directions: the cube
    # sampler picks a face per tap and clamps within it, so a tap that
    # crosses a face edge jumps between two faces' edge texels.  The gate
    # is each level's relative L2 error, 1e-2; the CPU bake's own change
    # under a 1e-6 relative jitter of its taps is printed beside it
    sd = (-0.6, -0.55, -0.58)
    jit = jittered_rebake(dataclasses.replace(cpu_sky.params, sundirection=sd))
    l2 = lambda a, b: ((a.cpu() - b).norm() / b.norm()).item()
    rel_l2 = [l2(a, b) for a, b in zip(dev_sky.mips, cpu_sky.mips)]
    jit_l2 = [l2(a, b) for a, b in zip(jit, cpu_sky.mips)]
    rebake_err = max(rel_l2)
    if (len(dev_sky.mips) != len(cpu_sky.mips) or dev_sky.device != torch.device(dev)
            or not rebake_err <= 1e-2):
        raise RuntimeError(f"render_skybox on the card vs the CPU: relative L2 error "
                           f"per level {rel_l2} (<= 1e-2)")
    phase("4p", f"render_skybox (64^2, 16 samples, {len(dev_sky.mips)} levels) on the "
                f"card vs the CPU bake: relative L2 error per level "
                f"{', '.join(f'{e:.3g}' for e in rel_l2)} (gate 1e-2); the CPU bake with "
                f"its GGX taps jittered by 1e-6 relative moves them by "
                f"{', '.join(f'{e:.3g}' for e in jit_l2)}")

    edits = dict(texture=(3, np.tile(np.array([[[40, 160, 220, 255]]], np.uint8),
                                     (32, 32, 1))),
                 material=(10, dict(color=(0.1, 0.6, 0.2, 1.0), roughness=0.3)),
                 binding=(1, dict(albedomap=0)))

    def edit(c):
        c.update_texture(*edits["texture"])
        c.update_material(edits["material"][0], **edits["material"][1])
        c.update_material(edits["binding"][0], **edits["binding"][1])

    ectx, ecam, eparams, emake = datumtest_scene(width=W, height=H, device=dev, **SCENE)
    einputs = frame_inputs(ectx, ecam, eparams, emake, 0.0)
    before = ectx.render(ecam, emake(0.0), eparams)
    edit(ectx)
    fctx = datumtest_scene(width=W, height=H, device=dev, **SCENE)[0]
    edit(fctx)                                         # before its first frame
    fstate = fctx.device_state(dev)
    for k in ("materials", "matmaps", "textures"):
        for kk, v in (fstate[k].items() if isinstance(fstate[k], dict) else [("", fstate[k])]):
            got = ectx._state[k][kk] if kk else ectx._state[k]
            if not torch.equal(got, v):
                raise RuntimeError(f"live edit: state {k}{'.' + kk if kk else ''} differs "
                                   "from the context built with the edited values")
    a = F.render_frame(ectx.config, ectx._state, *einputs, device=dev)["image"]
    b = F.render_frame(fctx.config, fstate, *einputs, device=dev)["image"]
    moved = (a.float() - torch.from_numpy(before).to(dev).float()).abs().mean().item()
    if not torch.equal(a, b) or not moved > 0.1:
        raise RuntimeError(f"live edit: frame equal to the fresh context's "
                           f"{torch.equal(a, b)}, mean |d| from the frame before {moved}")
    phase("4p", f"update_texture (the floor's checker), update_material (a sphere's colour "
                f"and roughness; the floor's albedo map rebound) on a rendered {W}x{H} "
                f"bench context: device state and frame bit-equal to a context given the "
                f"edits before its first frame; mean |d| {moved:.2f} levels from the frame "
                f"before the edits")

    # ---- 5p. the examples against their goldens; two at full width
    golden = {}
    for name in GOLDEN_EXAMPLES:
        sl = (DATUMTEST_GOLDEN_SLIVERS, DATUMTEST_GOLDEN_STACK) if name == "datumtest" \
            else None
        reset()
        st, rmse, mean, secs = golden_example(name, out_dir, sl)
        golden[name] = rmse
        if not rmse < 2 / 255:
            raise RuntimeError(f"{name} vs tests/golden/{name}.png: RMSE {rmse} (< "
                               f"{2 / 255}), mean |d| {mean}")
        extra = ""
        if name == "datumtest":
            own = datumtest.render(st).astype(np.float32)
            gold = read_png(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             "tests", "golden", "datumtest.png"))
            golden["datumtest_own"] = float(np.sqrt(np.mean(((own - gold) / 255.0) ** 2)))
            extra = (f"; with the jitted reference's {len(DATUMTEST_GOLDEN_SLIVERS)} "
                     f"degenerate-triangle texels in the cascade stack; the port's own "
                     f"frame (a 4th) RMSE {golden['datumtest_own']:.6f} (printed)")
        phase("5p", f"{name} example {GOLDEN_ARGV[3]}x{GOLDEN_ARGV[5]} (3 frames, "
                    f"{secs:.1f} s) vs tests/golden/{name}.png: RMSE {rmse:.6f} (gate < "
                    f"{2 / 255:.6f}), mean |d| {mean:.4f} levels, bin_overflow "
                    f"{st['ctx'].bin_overflow}, kernel launches {launched()}{extra}")
    for mod in (stardust, asteroids):
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        st = mod.main(["--frames", "1", "--width", str(W), "--height", str(H),
                       "--out", os.path.join(out_dir, f"{name}_full.png")])
        img = read_png(os.path.join(out_dir, f"{name}_full.png"))
        lit = float((img.max(-1) > 0).mean())
        if img.shape != (H, W, 3) or not lit > 0:
            raise RuntimeError(f"{name} {W}x{H}: image {img.shape}, {lit} of it lit")
        phase("5p", f"{name} example {W}x{H} (1 frame, {time.perf_counter() - t0:.1f} s "
                    f"with the set-up): image mean {img.mean():.4f}, {lit:.4f} of the "
                    f"pixels lit, bin_overflow {st['ctx'].bin_overflow}")

    # ---- 6p. timing (informational: no gain is claimed)
    frame_t = []
    for _ in range(3):
        datumtest.update(dstate, 1 / 60)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        datumtest.render(dstate)
        end.record()
        torch.cuda.synchronize()
        frame_t.append(start.elapsed_time(end))
    ms_dt = statistics.median(frame_t)
    host = {}
    host["update"] = wall_ms(lambda: ps.update(inst, 1 / 60, emitter), reps=21)
    sstate = stardust.init(types.SimpleNamespace(width=W, height=H, device=dev))
    for _ in range(60):
        stardust.update(sstate, 1 / 60)
    host["stardust"] = wall_ms(lambda: stardust.update(sstate, 1 / 60), reps=21)
    n_dust = sum(i.count for _, i, _ in sstate["systems"])
    brl = live_renderlist(bmake, 0.0, binst)
    host["billboards"] = wall_ms(lambda: brl.forward_arrays(BURST_QUADS, bcam), reps=11)
    sky = SkyBox(size=64, convolve_samples=16, device=dev)
    ms_rebake = cuda_ms(lambda: render_skybox(sky, None, device=dev), 5)
    # the live stream's frames render the bench config's state (render_b)
    runs = dict(bench=[frame_ms(bench[0], bench[1])], live=[])
    runs["live"] += [frame_ms(render_b, live), frame_ms(render_b, live)]
    runs["bench"].append(frame_ms(bench[0], bench[1]))
    ms_l, ms_b = statistics.mean(runs["live"]), statistics.mean(runs["bench"])
    prof_l, prof_b = profile_frames(render_b, live), profile_frames(bench[0], bench[1])
    t_k4 = cuda_ms(lambda: raster_blend_cuda(**k4_live["live stream"]), 20)
    t_k4p = cuda_ms(lambda: raster_blend_reference(**k4_live["live stream"]), 1)
    k4_in = k4_live["live stream"]
    b_k4 = bound(_nbytes(*(k4_in[k] for k in ("rows", "bins", "counts", "big_ids",
                                              "opaque_depth"))) + 5 * W * H * 4,
                 _walked(k4_in) * 4096 * OPS_WALK_BLEND)
    phase("6p", f"datumtest example {W}x{H}: {ms_dt:.3f} ms/frame (median of 3 frames "
                f"{', '.join(f'{t:.1f}' for t in frame_t)}; CUDA events around its render: "
                f"the host draws, the scan-raster frame and its read-back) on {card}")
    phase("6p", f"host ms (wall, median): the example's particle update "
                f"{host['update']:.4f} ({inst.count} live of 400); stardust's 4 systems on "
                f"the worker pool {host['stardust']:.4f} ({n_dust} live of 4096); the "
                f"billboards of {binst.count} particles (forward_arrays) "
                f"{host['billboards']:.4f}; render_skybox (64^2, 16 samples) on the card "
                f"{ms_rebake:.3f} ms (CUDA events, mean of 5) on {card}")
    phase("6p", f"bench frame with the live stream {ms_l:.3f} ms/frame, bench frame "
                f"{ms_b:.3f} (each the mean of 2 medians of 7, timed bench, live x2, bench: "
                f"{runs['bench'][0]:.3f}, {runs['live'][0]:.3f}, {runs['live'][1]:.3f}, "
                f"{runs['bench'][1]:.3f}); under torch.profiler {prof_l[0]:.3f} ms of device "
                f"time and {prof_l[1]:.0f} launches a frame vs {prof_b[0]:.3f} ms and "
                f"{prof_b[1]:.0f}; K4 on the live stream {t_k4:.4f} ms vs plain "
                f"{t_k4p:.3f} ms, bound {b_k4[0]:.4f} ms by {b_k4[1]} on {card}")
    phase("6p", f"phases 3p-6p took {time.perf_counter() - t_all:.1f} s")
    return dict(errs=errs, golden=golden, ms_datumtest=ms_dt, host=host,
                ms_rebake=ms_rebake, ms_live=ms_l, ms_bench=ms_b, prof_l=prof_l,
                prof_b=prof_b, t_k4=t_k4, t_k4p=t_k4p, b_k4=b_k4,
                launches_live=pf_live[0]["raster_blend"], rebake_err=rebake_err)


# ---- the pack pipeline (phases 3a-6a)
# the pack scene: its seed, its maps' size and the materials (of the 35
# spheres, row-major) that carry maps; the pack frame renders the bench
# config (SCENE without datumtest_scene's own arguments) with the maps at
# their size
PACK_SEED, PACK_MAP_SIZE, PACK_MAPPED = 0, 1024, (0, 12, 24, 34)
PACK_CFG = dict({k: v for k, v in SCENE.items()
                 if k not in ("sphere_detail", "n_point_lights", "skybox", "skybox_size")},
                matmap_max_size=1024)
PACK_WORKERS = 4
# the teapot and character examples' run, on the card and on the CPU
EXAMPLE_ARGV = ["--frames", "3", "--width", "320", "--height", "160"]
# ~1 s of the sleep kernel at ~2 GHz: the reads of the upload check wait
# behind it while the uploader evicts and re-uploads
UPLOAD_SLEEP_CYCLES = 2_000_000_000


def pack_dir(*sub):
    """Where the phases write their packs: under the gitignored build
    directory (tens of MB; removed at the end of the pack phases)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datum_tpu_torch",
                     "_build", "smoke_packs", *sub)
    os.makedirs(d, exist_ok=True)
    return d


def write_example_packs(directory):
    """The teapot example's pack (the seeded lathe OBJ through
    obj_to_pack) and the character example's (the rigged column and its
    clips, the scene pack's assets 1-4); returns their paths."""
    from datum_tpu_torch import packscene
    from datum_tpu_torch.asset.pack import PackWriter
    from datum_tpu_torch.tools.objparser import obj_to_pack

    obj = os.path.join(directory, "lathe.obj")
    with open(obj, "w") as f:
        f.write(packscene.lathe_obj(PACK_SEED))
    lathe = os.path.join(directory, "lathe.pack")
    obj_to_pack(obj, lathe)
    w = PackWriter()
    packscene.write_character(w)
    char = os.path.join(directory, "character.pack")
    with open(char, "wb") as f:
        f.write(w.finish())
    return lathe, char


def cpu_example(name, directory, out_dir, argv):
    """The teapot or the character example (name) through its harness on
    the CPU (the plain path) with argv, on write_example_packs' packs in
    directory; its PNG goes to out_dir as <name>_cpu.png.  chip_smoke runs
    each example in a child process of its own while the card works
    (start_cpu_examples)."""
    import torch

    from datum_tpu_torch.examples import character, teapot

    torch.set_num_threads(2)           # beside the main process's host work
    t0 = time.perf_counter()
    lathe, char = write_example_packs(directory)
    mod, pack = dict(teapot=(teapot, lathe), character=(character, char))[name]
    mod.main(["--cpu", *argv, "--pack", pack,
              "--out", os.path.join(out_dir, f"{name}_cpu.png")])
    print(f"{name} on the CPU: {time.perf_counter() - t0:.1f} s", flush=True)


def start_cpu_examples():
    """Start cpu_example for the teapot and for the character, each in a
    child process that sees no card (its log in
    chiprun_out/examples/<name>_cpu.log); returns ({name: (the process,
    its pack directory)}, the PNGs' directory).  The processes are
    killed at exit if they still run."""
    import atexit

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "chiprun_out", "examples")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in ("teapot", "character"):
        directory = pack_dir(f"cpu_{name}")
        log = open(os.path.join(out_dir, f"{name}_cpu.log"), "w")
        code = (f"import chip_smoke; chip_smoke.cpu_example({name!r}, {directory!r}, "
                f"{out_dir!r}, {EXAMPLE_ARGV!r})")
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, stdout=log,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        jobs[name] = (proc, directory)
    return jobs, out_dir


def _tree_equal(a, b, where="payload"):
    """Raise unless two decoded payload trees are equal (arrays by dtype,
    shape and bytes)."""
    import numpy as np

    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise RuntimeError(f"{where}: keys {list(a)} vs {list(b)}")
        for k in a:
            _tree_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise RuntimeError(f"{where}: {len(a)} items vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise RuntimeError(f"{where}: arrays differ ({a.dtype}{a.shape} vs "
                               f"{b.dtype}{b.shape})")
    elif a != b:
        raise RuntimeError(f"{where}: {a!r} vs {b!r}")


def _cdat_blocks(path):
    """Every CDAT block of a pack: (compressed bytes, its output cap)."""
    import struct

    from datum_tpu_torch.asset.pack import BLOCK_SIZE, PackReader

    r = PackReader(path)
    data = r._data
    out = []
    for info in r.assets.values():
        length = struct.unpack_from("<I", data, info.dataoffset)[0]
        if data[info.dataoffset + 4:info.dataoffset + 8] != b"CDAT":
            continue
        cursor, remaining, left = info.dataoffset + 8, length, info.datasize
        while remaining > 0:
            (csize,) = struct.unpack_from("<I", data, cursor)
            out.append((data[cursor + 4:cursor + 4 + csize], left))
            n = min(BLOCK_SIZE, remaining)
            cursor += n
            remaining -= n
            left = -1                      # set from the decode below
    return out


def _leaf_bytes(tree):
    """The array leaves of a payload tree (numpy or torch), in order, as
    bytes."""
    import numpy as np
    import torch

    from datum_tpu_torch.asset.upload import leaves

    return [x.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
            if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()
            for x in leaves(tree) if isinstance(x, (torch.Tensor, np.ndarray, np.generic))]


def _device_reads(tree):
    """Byte copies of every tensor leaf, queued on the current stream."""
    import torch

    from datum_tpu_torch.asset.upload import leaves

    return [x.reshape(-1).view(torch.uint8).clone() for x in leaves(tree)
            if isinstance(x, torch.Tensor)]


def _uploadable(info, payload):
    """A payload the card can hold: a mesh's structured arrays and an
    animation's joint table as plain arrays (their own payloads park a
    TypeError, as jax.device_put's would)."""
    import numpy as np

    if info.type == "mesh":
        out = dict(vertices=payload["vertices"].view(np.float32).reshape(
            len(payload["vertices"]), -1), indices=payload["indices"])
        if "rig" in payload:
            out["rig"] = payload["rig"].view(np.uint32).reshape(len(payload["rig"]), -1)
            out["bones"] = payload["bones"].view(np.uint8).reshape(len(payload["bones"]), -1)
        return out
    if info.type == "anim":
        return dict(times=payload["times"], transforms=payload["transforms"])
    return None


def upload_under_load(up, keys, host, record=True):
    """Read every uploaded payload of keys on the default stream behind a
    ~1 s sleep kernel while the uploader evicts them and uploads their
    bitwise complement under new keys (allocations on its side stream
    that could reuse the evicted blocks).  record=False skips get()'s
    record_stream (the hazard the uploader guards against).  Returns
    (reads that differ from the host bytes, whether the re-uploads landed
    before the reads ran)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(UPLOAD_SLEEP_CYCLES)
    reads = []
    for k in keys:
        if record:
            dev = up.get(k)
        else:
            with up._lock:
                dev = up._resident[k]
        reads.append(_device_reads(dev))
        up.evict(k)
        del dev
    queued = torch.cuda.Event()
    queued.record()

    def flip(tree):
        if isinstance(tree, dict):
            return {kk: flip(v) for kk, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(flip(v) for v in tree)
        if isinstance(tree, np.ndarray) and tree.dtype.kind in "ui":
            return ~tree
        return tree

    for k in keys:
        up.submit(("again", record, k), flip(host[k]))
    up.flush()
    overlapped = not queued.query()
    torch.cuda.synchronize()
    bad = sum(r.cpu().numpy().tobytes() != h
              for k, rs in zip(keys, reads) for r, h in zip(rs, _leaf_bytes(host[k])))
    for k in keys:
        up.evict(("again", record, k))
    return bad, overlapped


def pack_phases(dev, card, kernels, bench):
    """Phases 3a-6a: the pack pipeline.  3a: the bench scene written as a
    pack (packscene.scene_assets at PACK_MAP_SIZE: the MODL of the sphere
    grid and the floor with 13 mipped maps, the rigged column with 3 clips)
    and the core pack at its default sizes, both LZ4-compressed (and once
    raw), the teapot's OBJ through obj_to_pack; 4a: the AssetManager on 4
    workers decodes every asset equal to what the writer took (the core
    pack's equal to its raw build's), the native and the Python LZ4 codec
    each decode the other's stream of every CDAT block, the
    DeviceUploader lands every payload bit-equal to the host copy (a mesh
    and an animation park a TypeError; their arrays upload) and keeps it
    while the default stream reads behind a long kernel and the uploader
    evicts and re-uploads, and K1, K2, K3 and K4 hold against their plain
    versions on the pack frame's inputs; 5a: the pack frame (Model.load
    into a Scene, the animated column) 3 times with the launches of the
    bench frame, each bit-equal to the frame of the same scene built in
    memory, and the teapot and character examples on the card against
    the CPU (start_cpu_examples' children, started after 4a's timings
    and waited for before 6a's) at RMSE < 2/255; 6a:
    the write and compress times, the codecs' MB/s, the manager's, the
    uploader's GB/s against a plain .to(), Model.load's ms, and the pack
    frame's ms beside the bench frame's in turns and under torch.profiler.
    bench: (render, inputs) of the bench frame.  Returns the numbers
    PERF.md records."""
    import concurrent.futures
    import multiprocessing
    import shutil

    import numpy as np
    import torch

    from datum_tpu_torch import packscene
    from datum_tpu_torch.asset import AssetManager, DeviceUploader, PackReader, lz4
    from datum_tpu_torch.asset.upload import leaves
    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.examples import character, teapot
    from datum_tpu_torch.ops import shadow as shadow_ops
    from datum_tpu_torch.ops.raster_blend_cuda import (blend_inputs, raster_blend_cuda,
                                                       raster_blend_reference)
    from datum_tpu_torch.ops.raster_cuda import (PLANE_NAMES, raster_inputs,
                                                 raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_depth_cuda import (depth_inputs, raster_depth_cuda,
                                                       raster_depth_reference)
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
    from datum_tpu_torch.ops.shade_cuda import (shade_deferred_cuda,
                                                shade_deferred_reference, shade_inputs)
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.render.context import RenderContext
    from datum_tpu_torch.render.skybox import SkyBox
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scene import Model, Scene
    from datum_tpu_torch.tools.assetbuilder import build_core_pack

    t_all = time.perf_counter()
    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda)
    directory = pack_dir()
    mb = lambda n: n / 1e6

    # ---- 3a. write the packs
    t0 = time.perf_counter()
    assets = packscene.scene_assets(PACK_SEED, map_size=PACK_MAP_SIZE, mapped=PACK_MAPPED)
    column = packscene.rigged_column()
    t_assets = time.perf_counter() - t0
    paths = {n: os.path.join(directory, f"{n}.pack")
             for n in ("scene", "scene_raw", "core", "core_raw")}
    t = {}
    for name, compress in (("scene_raw", False), ("scene", True)):
        t0 = time.perf_counter()
        packscene.write_scene_pack(paths[name], assets, column, compress=compress)
        t[name] = time.perf_counter() - t0
    for name, compress in (("core_raw", False), ("core", True)):
        t0 = time.perf_counter()
        build_core_pack(paths[name], compress=compress)
        t[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lathe_path, char_path = write_example_packs(directory)
    t["obj_to_pack"] = time.perf_counter() - t0
    size = {n: os.path.getsize(p) for n, p in paths.items()}
    raw_bytes = {n: sum(i.datasize for i in PackReader(paths[n]).assets.values())
                 for n in ("scene", "core")}
    n_tris = sum(len(assets["meshes"][i["mesh"]][1]) // 3 for i in assets["instances"])
    n_maps = len(assets["textures"])
    phase("3a", f"scene pack: the bench scene's MODL ({len(assets['instances'])} instances, "
                f"{n_tris} triangles, {len(assets['materials'])} materials, {n_maps} maps "
                f"of {PACK_MAP_SIZE}^2 with {assets['textures'][0]['levels']} mips: "
                f"{sum(t_['format'] == 3 for t_ in assets['textures'])} BC3, "
                f"{sum(t_['format'] == 0 for t_ in assets['textures'])} RGBA, "
                f"{sum(t_['format'] == 5 for t_ in assets['textures'])} RGBE), the rigged "
                f"column ({len(column['vertices'])} vertices, {len(column['bones'])} bones) "
                f"and {len(column['clips'])} clips: {size['scene']} bytes on disk LZ4, "
                f"{size['scene_raw']} raw (payloads {raw_bytes['scene']} bytes; ratio "
                f"{size['scene'] / size['scene_raw']:.4f}); core pack at its default sizes "
                f"{size['core']} bytes LZ4, {size['core_raw']} raw (ratio "
                f"{size['core'] / size['core_raw']:.4f}); the lathe OBJ's pack "
                f"{os.path.getsize(lathe_path)} bytes ({time.perf_counter() - t_all:.1f} s)")

    # ---- 4a. load: the manager, the codecs, the uploader
    mgr = AssetManager(workers=PACK_WORKERS)
    base_s, base_c = mgr.load(paths["scene"]), mgr.load(paths["core"])
    ids = sorted(mgr._assets)
    t0 = time.perf_counter()
    for a in ids:
        mgr.request(a)
    while not all(mgr.ready(a) or mgr.error(a) is not None for a in ids):
        if time.perf_counter() - t0 > 300:
            raise RuntimeError("the manager did not decode the packs in 300 s")
        time.sleep(0.001)
    t["stream"] = time.perf_counter() - t0
    failed = {a: mgr.error(a) for a in ids if mgr.error(a) is not None}
    if failed:
        raise RuntimeError(f"decodes failed: {failed}")
    got = {a: mgr.request(a) for a in ids}
    decoded_bytes = sum(mgr.find(a).info.datasize for a in ids)
    # the scene pack against what the writer took
    c = got[base_s + packscene.ID_COLUMN]
    _tree_equal({k: c[k] for k in ("vertices", "indices", "rig", "bones")},
                {k: np.asarray(column[k], dict(indices=np.uint32).get(k)) for k in
                 ("vertices", "indices", "rig", "bones")}, "column")
    for aid, clip in zip(packscene.ID_CLIPS, column["clips"]):
        a = got[base_s + aid]
        _tree_equal(dict(duration=a["duration"], joints=a["joints"], times=a["times"],
                         transforms=a["transforms"]),
                    dict(duration=float(np.float32(clip["duration"])), joints=clip["joints"],
                         times=np.asarray(clip["times"], np.float32),
                         transforms=np.asarray(clip["transforms"], np.float32)), f"clip {aid}")
    n_mesh = len(assets["meshes"])
    tex_ids = [packscene.ID_MESHES + n_mesh + i for i in range(n_maps)]
    m = got[base_s + packscene.ID_MODEL]
    _tree_equal(m["textures"], [dict(type=t_["type"], texture=aid)
                                for t_, aid in zip(assets["textures"], tex_ids)], "textures")
    _tree_equal(m["meshes"], [packscene.ID_MESHES + i for i in range(n_mesh)], "meshes")
    for got_m, want in zip(m["materials"], assets["materials"]):
        _tree_equal(got_m, {k: (np.asarray(v, np.float32) if k == "color"
                                else float(np.float32(v)) if isinstance(v, float) else v)
                            for k, v in want.items()}, "material")
    _tree_equal([dict(i, transform=np.asarray(i["transform"], np.float32))
                 for i in assets["instances"]], m["instances"], "instances")
    for i, (v, idx) in enumerate(assets["meshes"]):
        md = got[base_s + packscene.ID_MESHES + i]
        _tree_equal([md["vertices"], md["indices"]], [v, idx], f"mesh {i}")
    for t_, aid in zip(assets["textures"], tex_ids):
        img = got[base_s + aid]
        if b"".join(mm.tobytes() for mm in img["mips"]) != t_["payload"]:
            raise RuntimeError(f"image {aid}: the decoded mips differ from the payload")
    # the core pack against its raw build
    raw = PackReader(paths["core_raw"])
    for a in ids:
        if a >= base_c:
            info = raw.assets[a - base_c]
            name = dict(catl="catalog", imag="image", matl="material", anim="animation",
                        modl="model", part="particlesystem").get(info.type, info.type)
            _tree_equal(got[a], getattr(raw, name)(a - base_c), f"core asset {a - base_c}")
    phase("4a", f"AssetManager ({PACK_WORKERS} workers): {len(ids)} assets of the scene "
                f"pack (base {base_s}) and the core pack (base {base_c}), "
                f"{decoded_bytes} payload bytes, decoded in {t['stream']:.3f} s; every "
                f"scene asset equal to what the writer took, every core asset equal to "
                f"the raw core pack's")

    # the codecs on every CDAT block: each decodes the other's stream
    blocks = _cdat_blocks(paths["scene"]) + _cdat_blocks(paths["core"])
    t0 = time.perf_counter()
    plain = []
    cap = None
    for blk, left in blocks:
        cap = left if left >= 0 else cap - len(plain[-1])
        plain.append(lz4.decompress(blk, cap))
    # one call a block into a new buffer of the payload's remaining size
    # (the JAX reader's buffer pattern, through the port's codec), then
    # PackReader.payload (each block into the payload's one buffer)
    t["native_decode_calls"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path in (paths["scene"], paths["core"]):
        r = PackReader(path)
        for aid in r.assets:
            r.payload(aid)
    t["native_decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for (blk, _), p in zip(blocks, plain):
        if lz4.py_decompress(blk, len(p)) != p:
            raise RuntimeError("the Python codec decodes a native block differently")
    t["python_decode"] = time.perf_counter() - t0
    plain_bytes = sum(len(p) for p in plain)
    caps = [len(p) + len(p) // 255 + 64 for p in plain]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            8, mp_context=multiprocessing.get_context("spawn")) as pool:
        streams = list(pool.map(lz4.py_compress, plain, caps, chunksize=16))
    t["python_compress"] = time.perf_counter() - t0
    for (s, used), p in zip(streams, plain):
        if used != len(p) or lz4.decompress(s, len(p)) != p:
            raise RuntimeError("the native codec decodes a Python block differently")
    phase("4a", f"LZ4 on all {len(blocks)} CDAT blocks ({plain_bytes} bytes out): the "
                f"native and the Python codec decode each native block to the same bytes, "
                f"and the native codec decodes each block's Python stream (8 processes, "
                f"{t['python_compress']:.1f} s) to its bytes")

    # the uploader on its CUDA side stream
    up = DeviceUploader(dev)
    host, parked = {}, []
    for a in ids:
        info = mgr.find(a).info
        up.submit(a, got[a])
        flat = _uploadable(info, got[a])
        if flat is not None:
            up.submit(("arrays", a), flat)
            host[("arrays", a)] = flat
        if info.type in ("imag", "matl", "modl", "font"):
            host[a] = got[a]
    up.flush()
    for a in ids:
        try:
            dev_p = up.get(a)
        except TypeError:
            parked.append(mgr.find(a).type)
            continue
        if a not in host:
            raise RuntimeError(f"asset {a} ({mgr.find(a).type}) uploaded; expected a "
                               "TypeError")
    n_leaves = 0
    for k, h in host.items():
        dev_p = up.get(k)
        if _leaf_bytes(dev_p) != _leaf_bytes(h):
            raise RuntimeError(f"upload {k}: the card's bytes differ from the host's")
        if any(tt.device != dev for tt in leaves(dev_p) if isinstance(tt, torch.Tensor)):
            raise RuntimeError(f"upload {k}: a tensor off the card")
        n_leaves += len(_leaf_bytes(h))
    img_keys = [a for a in host if not isinstance(a, tuple) and mgr.find(a).type == "imag"]
    bad, overlapped = upload_under_load(up, img_keys, host)
    if bad or not overlapped:
        raise RuntimeError(f"upload under load: {bad} reads differ from the host bytes "
                           f"(re-uploads landed before the reads: {overlapped})")
    for k in img_keys:
        up.submit(k, host[k])
    up.flush()
    bad_unrecorded, overlapped_u = upload_under_load(up, img_keys, host, record=False)
    phase("4a", f"DeviceUploader on its CUDA stream: {len(host)} payloads ({n_leaves} "
                f"arrays) bit-equal to the host copies; parked TypeErrors for "
                f"{sorted(set(parked))} as jax.device_put would (their arrays uploaded "
                f"apart); {len(img_keys)} images read on the default stream behind a ~1 s "
                f"kernel while the uploader evicted them and uploaded their complements: "
                f"0 reads differ (re-uploads landed first: {overlapped}); without "
                f"get()'s record_stream {bad_unrecorded} reads of "
                f"{sum(len(_leaf_bytes(host[k])) for k in img_keys)} differ")

    # the teapot and character examples on the CPU, for 5a, in a child
    # process each from here to 5a's wait, beside none of the times 6a prints
    t_child = time.perf_counter() - t_all
    cpu_job = start_cpu_examples()

    # ---- the pack scene and its in-memory twin
    t0 = time.perf_counter()
    sky = SkyBox(size=64, convolve_samples=16, device=dev)
    reader = PackReader(paths["scene"])
    pctx, pcam, pparams, pmake, _, pmodel = packscene.pack_scene(
        W, H, pack=reader, skybox=sky, device=dev, **PACK_CFG)
    mctx, mcam, mparams, mmake, _, _ = packscene.pack_scene(
        W, H, assets=assets, column=column, skybox=sky, device=dev, **PACK_CFG)
    cfg = pctx.config
    pstate, mstate = pctx.device_state(dev), mctx.device_state(dev)
    t_build = time.perf_counter() - t0
    for k in ("geometry", "materials", "matmaps"):
        for name, v in pstate[k].items():
            if not torch.equal(v, mstate[k][name]):
                raise RuntimeError(f"pack scene vs in-memory scene: state {k}.{name} differs")
    p_in, m_in = [], []
    for f in range(3):
        for ctx_, cam_, par_, make_, acc in ((pctx, pcam, pparams, pmake, p_in),
                                             (mctx, mcam, mparams, mmake, m_in)):
            rl = make_(0.0, 1 / 60)
            acc.append((ctx_.frame_draws(rl, cam_),
                        make_sceneset(cam_, par_, point_lights=rl.point_lights,
                                      spot_lights=rl.spot_lights, probes=rl.probes)))
    draws, ss = p_in[0]
    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, pstate, d_t, s_t)
    setup, bins, counts, big_ids, ovf = F._bin_stage(cfg, ex, clip)
    if int(ovf):
        raise RuntimeError(f"pack frame bin overflow {int(ovf)}")
    k3 = []
    for name, stk in zip(STACKS, shadow_stacks(cfg, ex, wp, s_t)):
        sb, sc, sg = shadow_ops.bin_stack(stk, cfg.shadow_bin_capacity, cfg.big_capacity)
        inp = depth_inputs(stk["setup"], sb, sg, sc, stk["tiles_x"], stk["res"],
                           stk["height"])
        require_equal(raster_depth_cuda(**inp), raster_depth_reference(**inp),
                      f"K3 vs plain on the pack frame's {name}")
        k3.append(name)
    k1_in = raster_inputs(setup, bins, big_ids, counts, ex["tris"], uv, wn, d_t["tri_mat"],
                          pstate["materials"], cfg.tiles_x, cfg.padded_width,
                          cfg.padded_height, wt)
    pk = raster_shade_cuda(**k1_in)
    check_k1(pk, raster_shade_reference(**k1_in), "pack frame, opaque layer")
    kp = dict(zip(PLANE_NAMES, pk))
    shadows = F._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf, ao, _ = F._shade_inputs(cfg, kp, pstate, d_t, s_t, shadows)
    k2_in = shade_inputs(gpl, ss2, proj=s_t["proj"], invview=s_t["invview"], ao=ao,
                         spotsf=spotsf)
    hk, hr = shade_deferred_cuda(**k2_in), shade_deferred_reference(**k2_in)
    torch.cuda.synchronize()
    k2_err = (hk - hr).abs().max().item()
    if not torch.isfinite(hk).all() or not torch.allclose(hk, hr, atol=1e-4, rtol=1e-3):
        raise RuntimeError(f"K2 vs plain on the pack frame: max abs err {k2_err}")
    ts = F.translucent_stream(pstate, d_t, s_t)
    st = F.oit_stream(cfg, pstate, d_t, s_t, ts, None)
    obins, ocounts, obig = F.oit_bins(cfg, st)
    k4_in = blend_inputs(st["setup"], obins, obig, ocounts, st["tris"], st["uv"],
                         st["color"], kp["depth"], cfg.tiles_x, cfg.padded_width,
                         cfg.padded_height, "per_tri", None, st["soft_flag"],
                         st["peel_flag"])
    k4_err = check_same(raster_blend_cuda(**k4_in), raster_blend_reference(**k4_in),
                        "K4, pack frame's merged stream", tag="4a")
    n_mat = pctx.n_materials
    mapped = int((pstate["matmaps"]["size"][:n_mat] > 1).sum())
    table_mb = pstate["matmaps"]["table"].numel() / 1e6
    phase("4a", f"pack frame {W}x{H} (built in {t_build:.1f} s; its state equal to the "
                f"in-memory scene's): K3 on the {len(k3)} stacks bit-identical to plain, K1 "
                f"above, K2 vs plain hdr max abs err {k2_err:.3g} (atol 1e-4, rtol 1e-3), K4 "
                f"{k4_err:.3g}; {mapped} of {n_mat} materials with maps over 1x1 (the material-"
                f"map table {table_mb:.1f} MB on the card)")

    # ---- 5a. render: the pack frame, its twin, the examples
    render_p = lambda d, s: F.render_frame(cfg, pstate, d, s, device=dev)
    render_m = lambda d, s: F.render_frame(mctx.config, mstate, d, s, device=dev)
    per_frame = {"raster_shade": 2, "shade_deferred": 2, "raster_depth": 3,
                 "raster_blend": 1, "shade_epilogue": 1}
    pf, _, _, _ = drive(render_p, p_in, kernels, per_frame,
                        forbid=("raster_shade_2p", "raster_v1", "raster_mxu", "gather_rows",
                                "shade_deferred_envd", "sprite_pass"))
    if any(f[n] != v for f in pf for n, v in per_frame.items()):
        raise RuntimeError(f"pack frame launches {pf}, expected {per_frame} a frame")
    imgs = []
    for (pd, ps_), (md, ms) in zip(p_in, m_in):
        a, b = render_p(pd, ps_)["image"], render_m(md, ms)["image"]
        if not torch.equal(a, b):
            raise RuntimeError(f"the pack frame differs from the in-memory frame: "
                               f"{image_diff(a, b)}")
        imgs.append(a)
    moved = [image_diff(a, b)[0] for a, b in zip(imgs, imgs[1:])]
    if not all(v > 0 for v in moved):
        raise RuntimeError(f"the animated pack frames do not move: {moved}")
    phase("5a", f"3 pack frames {W}x{H} (the column's Animator + 1/60 s a frame): launches "
                f"per frame {pf}; each equal bit for bit to the frame of the scene built in "
                f"memory; image mean {imgs[-1].float().mean().item():.2f}, mean |d| between "
                f"frames {', '.join(f'{v:.4f}' for v in moved)} levels")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "examples")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    card_png = {}
    for name, mod, pack in (("teapot", teapot, lathe_path), ("character", character,
                                                              paths["scene"])):
        out = os.path.join(out_dir, f"{name}_card.png")
        st_ = mod.main([*EXAMPLE_ARGV, "--pack", pack, "--out", out])
        if st_["ctx"].bin_overflow:
            raise RuntimeError(f"{name} example: bin overflow {st_['ctx'].bin_overflow}")
        card_png[name] = out
    t_card = time.perf_counter() - t0
    jobs, cpu_out = cpu_job
    t0 = time.perf_counter()
    rcs = {n: proc.wait(timeout=600) for n, (proc, _) in jobs.items()}
    t_wait = time.perf_counter() - t0
    t_child_end = time.perf_counter() - t_all
    cpu_log = ""
    for n, rc in rcs.items():
        with open(os.path.join(cpu_out, f"{n}_cpu.log")) as f:
            log = f.read()
        if rc != 0:
            raise RuntimeError(f"the CPU {n} example failed (exit {rc}):\n{log[-2000:]}")
        cpu_log += log
    cpu_lathe = os.path.join(jobs["teapot"][1], "lathe.pack")
    cpu_char = os.path.join(jobs["character"][1], "character.pack")
    if open(cpu_lathe, "rb").read() != open(lathe_path, "rb").read():
        raise RuntimeError("the CPU run's lathe pack differs from this run's")
    cr = PackReader(cpu_char)
    for aid in (packscene.ID_COLUMN, *packscene.ID_CLIPS):
        if cr.payload(aid) != reader.payload(aid):
            raise RuntimeError(f"the CPU run's character asset {aid} differs")
    ex_rmse = {}
    for name in card_png:
        a = read_png(card_png[name]).astype(np.float32)
        b = read_png(os.path.join(cpu_out, f"{name}_cpu.png")).astype(np.float32)
        ex_rmse[name] = (float(np.sqrt(np.mean(((a - b) / 255.0) ** 2))),
                         float(np.abs(a - b).mean()), float(b.mean()))
        if not ex_rmse[name][0] < 2 / 255 or not ex_rmse[name][2] > 10:
            raise RuntimeError(f"{name} example card vs CPU: {ex_rmse[name]}")
    phase("5a", f"teapot (the lathe OBJ: {len(PackReader(lathe_path).mesh(0)['vertices'])} "
                f"vertices) and character (the scene pack) examples through their "
                f"harness, {EXAMPLE_ARGV[3]}x{EXAMPLE_ARGV[5]}, {EXAMPLE_ARGV[1]} frames, on "
                f"the card "
                f"({t_card:.1f} s) vs the CPU plain path (a child process each from "
                f"{t_child:.1f} s to {t_child_end:.1f} s of phases 3a-6a, waited "
                f"{t_wait:.1f} s; {cpu_log.strip().replace(chr(10), '; ')}): "
                + "; ".join(f"{n} RMSE {r:.6f}, mean |d| {d:.4f} levels" for n, (r, d, _)
                            in ex_rmse.items()) + f" (gate < {2 / 255:.6f})")

    # ---- 6a. timing (informational: no gain is claimed)
    codec = dict(native=mb(decoded_bytes) / t["native_decode"],
                 native_calls=mb(plain_bytes) / t["native_decode_calls"],
                 python=mb(plain_bytes) / t["python_decode"])
    up_bytes = sum(len(b) for k in img_keys for b in _leaf_bytes(host[k]))
    for k in img_keys:
        up.evict(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in img_keys:
        up.submit(("timed", k), host[k])
    up.flush()
    t_up = time.perf_counter() - t0
    arrays = [a for k in img_keys for a in host[k]["mips"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_up = [torch.from_numpy(a).to(dev) for a in arrays]
    torch.cuda.synchronize()
    t_plain_up = time.perf_counter() - t0
    del plain_up
    up.close()
    load_ms = []
    for _ in range(3):
        lctx = RenderContext(cfg, device=dev)
        t0 = time.perf_counter()
        Model.load(Scene(), lctx, reader, packscene.ID_MODEL)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    render_b, b_inputs = bench
    runs = dict(bench=[frame_ms(render_b, b_inputs)], pack=[])
    runs["pack"] += [frame_ms(render_p, p_in), frame_ms(render_p, p_in)]
    runs["bench"].append(frame_ms(render_b, b_inputs))
    ms_p, ms_b = statistics.mean(runs["pack"]), statistics.mean(runs["bench"])
    prof_p = profile_frames(render_p, p_in, by_name=True)
    prof_b = profile_frames(render_b, b_inputs, by_name=True)
    names_p, names_b = prof_p[2], prof_b[2]
    moved_k = sorted(((names_p.get(k, 0) - names_b.get(k, 0), k) for k in {*names_p, *names_b}
                      if names_p.get(k, 0) != names_b.get(k, 0)), key=lambda x: -abs(x[0]))
    mgr.close()
    phase("6a", f"write: scene assets generated (maps, BC3) in {t_assets:.2f} s; the scene "
                f"pack written raw in {t['scene_raw']:.3f} s and with LZ4 in "
                f"{t['scene']:.3f} s; the core pack built raw in {t['core_raw']:.2f} s and "
                f"with LZ4 in {t['core']:.2f} s; the lathe OBJ through obj_to_pack "
                f"{t['obj_to_pack']:.3f} s (host)")
    phase("6a", f"decode: PackReader.payload of every asset (native LZ4 into the "
                f"payload's buffer) {codec['native']:.1f} MB/s; the native codec one call a "
                f"block into a new buffer of the payload's remaining size (the JAX "
                f"reader's buffer pattern, the port's codec) {codec['native_calls']:.1f} MB/s; the Python codec "
                f"{codec['python']:.2f} MB/s ({mb(plain_bytes):.1f} MB out of {len(blocks)} "
                f"blocks; Python compress on 8 processes {t['python_compress']:.1f} s); the "
                f"manager streaming both packs on {PACK_WORKERS} workers "
                f"{mb(decoded_bytes) / t['stream']:.1f} MB/s ({t['stream']:.3f} s for "
                f"{mb(decoded_bytes):.1f} MB of payloads) (host)")
    phase("6a", f"upload of the {len(img_keys)} images ({mb(up_bytes):.1f} MB): "
                f"DeviceUploader (pageable copies on its side stream, one event a "
                f"payload) "
                f"{up_bytes / t_up / 1e9:.2f} GB/s ({t_up * 1e3:.1f} ms), plain .to(card) "
                f"from pageable memory {up_bytes / t_plain_up / 1e9:.2f} GB/s "
                f"({t_plain_up * 1e3:.1f} ms), wall, synced, on {card}")
    phase("6a", f"Model.load ({n_maps} maps decoded, {len(assets['materials'])} materials, "
                f"{n_mesh} meshes, {len(assets['instances'])} instances; host) "
                f"{statistics.median(load_ms):.1f} ms (median of 3: "
                f"{', '.join(f'{v:.1f}' for v in load_ms)})")
    phase("6a", f"pack frame {ms_p:.3f} ms/frame, bench frame {ms_b:.3f} (each the mean of 2 "
                f"medians of 7, timed bench, pack x2, bench: {runs['bench'][0]:.3f}, "
                f"{runs['pack'][0]:.3f}, {runs['pack'][1]:.3f}, {runs['bench'][1]:.3f}; CUDA "
                f"events, {W}x{H}); under torch.profiler {prof_p[0]:.3f} ms of device time "
                f"and {prof_p[1]:.0f} launches a frame vs {prof_b[0]:.3f} ms and "
                f"{prof_b[1]:.0f} on {card}")
    phase("6a", "device kernels a frame, pack minus bench, by name (largest first): "
          + "; ".join(f"{d:+.0f} {k[:60]}" for d, k in moved_k[:12]))
    shutil.rmtree(pack_dir(), ignore_errors=True)
    phase("6a", f"phases 3a-6a took {time.perf_counter() - t_all:.1f} s")
    return dict(t=t, codec=codec, up_gbs=up_bytes / t_up / 1e9,
                plain_up_gbs=up_bytes / t_plain_up / 1e9, load_ms=statistics.median(load_ms),
                ms_pack=ms_p, ms_bench=ms_b, prof_p=prof_p[:2], prof_b=prof_b[:2], launches=pf[0],
                ex_rmse=ex_rmse, k2_err=k2_err, k4_err=k4_err, size=size,
                bad_unrecorded=bad_unrecorded)


# the tile-sharded frame (datum_tpu_torch/parallel/): the bench config at
# translucent_lit_scale 1, where the sharded frame equals the
# single-device frame bit for bit (at the bench's 2 the lit layers shade
# at full resolution in band mode: the parity exception), in two bands
MULTI = dict(SCENE, translucent_lit_scale=1)
MULTI_BANDS = 2
# the reduced path's check: tests/test_parallel.py's tiny config at
# 256x128, bloom off and on (its beacon), two ranks
MULTI_REDUCED = dict(width=256, height=128, sphere_detail=8, grid=(2, 2),
                     n_point_lights=2, max_vertices=2048, max_triangles=2048,
                     max_instances=8, bin_capacity=128, big_capacity=8,
                     enable_shadows=True, shadow_res=128, shadow_bin_capacity=32,
                     enable_bloom=False, skybox=False)


def reduced_inputs(bloom, dev, reduced=MULTI_REDUCED):
    """(cfg, state, draws, sceneset) of the reduced config, with bloom on
    and tests/test_parallel.py's emissive beacon."""
    from datum_tpu_torch.math import Transform
    from datum_tpu_torch.render import primitives
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(device=dev, **reduced)
    cfg = ctx.config
    if bloom:
        cfg = dataclasses.replace(cfg, enable_bloom=True)
        qv, qi = primitives.unit_quad()
        beacon = ctx.add_mesh(qv, qi)
        glow = ctx.add_material(color=(1.0, 0.8, 0.4, 1), emissive=0.8)
    rl = make_rl(0.0)
    if bloom:
        rl.push_mesh(beacon, Transform.translation([0, 2.0, 2.0]), glow)
    return (cfg, ctx.device_state(dev), ctx.frame_draws(rl, camera),
            make_sceneset(camera, params, point_lights=rl.point_lights))


def replicated_digest(cfg, state, draws, ss):
    """sha256 of each replicated stage output of the sharded frame (the
    patched pool's vertex stage, the shadow ESMs, the fog volume, setup
    and bins) on this rank."""
    import hashlib

    from datum_tpu_torch.render import frame as F

    state = F.patch_dynamic(cfg, state, draws)
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, state, draws, ss)
    shadows = F._shadow_stage(cfg, ex, wp, ss)
    setup, bins, counts, big, over = F._bin_stage(cfg, ex, clip)
    parts = dict(clip=[clip, wn, wt, wp, uv], sun_esm=list(shadows["sun"]),
                 spot_esm=[shadows["spot"]], setup=[setup["row16"], setup["zbound"]],
                 bins=[bins, counts, big, over])
    if cfg.enable_fog:
        parts["fog_volume"] = [F.fog_volume(cfg, ss, shadows)]
    out = {}
    for name, ts in parts.items():
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]
    return out


def multi_rank(bands, size, scene, reduced):
    """One rank of phase 5m's 2-rank group on the one card: the bench frame
    (scene at size, t = 0) at translucent_lit_scale 1 and 2, the replicated
    stage's digests, the byte ledger and the reduced path's two frames."""
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.parallel import ici_report, render_frame_sharded
    from datum_tpu_torch.scenes import datumtest_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = bands.device
    out = {}
    for scale in (1, 2):
        ctx, camera, params, make_rl = datumtest_scene(
            width=size[0], height=size[1], device=dev,
            **dict(scene, translucent_lit_scale=scale))
        draws, ss = frame_inputs(ctx, camera, params, make_rl, 0.0)
        state = ctx.device_state(dev)
        ici_report(reset=True)
        o = render_frame_sharded(ctx.config, bands, state, draws, ss)
        out[f"bench{scale}"] = o["image"].cpu().numpy()
        out[f"ledger{scale}"] = ici_report(reset=True)
        out[f"overflow{scale}"] = int(o["bin_overflow"])
        if scale == 1:
            out["replicated"] = replicated_digest(ctx.config, state, to_torch(draws, dev),
                                                  to_torch(ss, dev))
    for bloom in (False, True):
        rcfg, rstate, rdraws, rss = reduced_inputs(bloom, dev, reduced)
        o = render_frame_sharded(rcfg, bands, rstate, rdraws, rss)
        out[f"reduced{int(bloom)}"] = o["image"].cpu().numpy()
    out["reduced_kernel"], out["reduced_kernel_bands"] = reduced_with_kernel(bands, reduced)
    return out


def reduced_with_kernel(bands, reduced):
    """The reduced path's frame (bloom off) with use_pallas on this rank:
    its band lit by the lighting kernel in band mode.  Returns (the u8
    image, [(y0, max abs err, values outside atol 1e-4 / rtol 1e-3) of
    each launch against lighting_reference on its arguments])."""
    from datum_tpu_torch.ops import lighting_cuda as lc
    from datum_tpu_torch.parallel import render_frame_sharded

    rcfg, rstate, rdraws, rss = reduced_inputs(False, bands.device,
                                               dict(reduced, use_pallas=True))
    launch, seen = lc.lighting_cuda, []

    def checked(**inp):
        hdr = launch(**inp)
        ref = lc.lighting_reference(**inp)
        d = (hdr - ref).abs()
        seen.append((inp["y0"], d.max().item(), int((d > 1e-4 + 1e-3 * ref.abs()).sum())))
        return hdr

    lc.lighting_cuda = checked
    try:
        o = render_frame_sharded(rcfg, bands, rstate, rdraws, rss)
    finally:
        lc.lighting_cuda = launch
    return o["image"].cpu().numpy(), seen


def multi_phases(dev, card, kernels):
    """Phases 4m-6m: the tile-sharded frame.  Returns the numbers the
    kernels' JSON line reports for it."""
    import tempfile

    import numpy as np
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.entry import dryrun_multichip
    from datum_tpu_torch.ops.common import TILE_H
    from datum_tpu_torch.ops.raster_blend_cuda import (
        blend_inputs, raster_blend_cuda, raster_blend_reference)
    from datum_tpu_torch.ops.raster_cuda import (
        PLANE_NAMES, raster_inputs, raster_shade_2p_cuda, raster_shade_2p_reference,
        raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
    from datum_tpu_torch.ops.shade_cuda import (
        SHADE_ROWS, epilogue_inputs, shade_deferred_cuda, shade_deferred_reference,
        shade_epilogue_cuda, shade_epilogue_reference, shade_inputs)
    from datum_tpu_torch.parallel import (close_bands, init_bands, render_frame_sharded,
                                          spawn_bands)
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.scenes import datumtest_scene

    t_start = time.perf_counter()
    kernels = dict(kernels, raster_v1=raster_v1_cuda, raster_mxu=raster_mxu_cuda)
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, device=dev, **MULTI)
    cfg = ctx.config
    cfg_c = dataclasses.replace(cfg, use_light_clusters=True, tile_light_capacity=8)
    state = ctx.device_state(dev)
    inputs = [frame_inputs(ctx, camera, params, make_rl, t) for t in (0.0, 0.1, 0.2)]
    d_t, s_t = to_torch(inputs[0][0], dev), to_torch(inputs[0][1], dev)

    # ---- 4m. K1, K6, K4 and K2 (+ epilogue) on two bands of the bench
    # frame's inputs: each band's output against its plain version in band
    # mode and against the rows of the whole frame's kernel output
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, state, d_t, s_t)
    setup, bins, counts, big, _ = F._bin_stage(cfg, ex, clip)
    k1_in = raster_inputs(setup, bins, big, counts, ex["tris"], uv, wn, d_t["tri_mat"],
                          state["materials"], cfg.tiles_x, cfg.padded_width,
                          cfg.padded_height, wt, early_z=True)
    full1, full6 = raster_shade_cuda(**k1_in), raster_shade_2p_cuda(**k1_in)
    planes = dict(zip(PLANE_NAMES, full1))
    shadows = F._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf, ao, _ = F._shade_inputs(cfg, planes, state, d_t, s_t, shadows)
    F._translucent_stage(cfg, state, d_t, s_t, ss2, shadows, planes["depth"], gpl)
    st = F.oit_stream(cfg, state, d_t, s_t, F.translucent_stream(state, d_t, s_t), None)
    obins, ocounts, obig = F.oit_bins(cfg, st)
    k4_in = blend_inputs(st["setup"], obins, obig, ocounts, st["tris"], st["uv"],
                         st["color"], planes["depth"], cfg.tiles_x, cfg.padded_width,
                         cfg.padded_height, "per_tri", None, st["soft_flag"],
                         st["peel_flag"])
    full4 = raster_blend_cuda(**k4_in)
    clusters = F.light_clusters(cfg_c, planes["depth"], s_t)
    kw = dict(proj=s_t["proj"], invview=s_t["invview"], ao=ao, spotsf=spotsf)
    epi = epilogue_inputs(gpl)
    full2 = {c: shade_deferred_cuda(**shade_inputs(gpl, ss2, clusters=cl, **kw))
             for c, cl in (("dense", None), ("clustered", clusters))}
    full_epi = shade_epilogue_cuda(full2["dense"], **epi)
    torch.cuda.synchronize()
    n_rows = cfg.tiles_y // MULTI_BANDS
    band_h, n_tiles = n_rows * TILE_H, n_rows * cfg.tiles_x
    errs = dict(k1=0.0, k6=0.0, k4=0.0, k2=0.0)
    for b in range(MULTI_BANDS):
        t0, y0 = b * n_tiles, b * band_h
        rows, tiles = slice(y0, y0 + band_h), slice(t0, t0 + n_tiles)
        kb = dict(k1_in, bins=k1_in["bins"][tiles].contiguous(),
                  counts=k1_in["counts"][tiles].contiguous(),
                  szb=k1_in["szb"][tiles].contiguous(), tile0=t0)
        for name, fk, fr, full in (("K1", raster_shade_cuda, raster_shade_reference, full1),
                                   ("K6", raster_shade_2p_cuda, raster_shade_2p_reference,
                                    full6)):
            k, r = fk(**kb), fr(**kb)
            require_equal(k, r, f"{name} band {b} vs its plain version in band mode")
            require_equal(k, full[:, rows], f"{name} band {b} vs the whole frame's rows")
        k4b = dict(k4_in, bins=k4_in["bins"][tiles].contiguous(),
                   counts=k4_in["counts"][tiles].contiguous(),
                   opaque_depth=k4_in["opaque_depth"][rows].contiguous(), tile0=t0)
        k, r = raster_blend_cuda(**k4b), raster_blend_reference(**k4b)
        require_equal(k, r, f"K4 band {b} vs its plain version in band mode")
        require_equal(k, full4[:, rows], f"K4 band {b} vs the whole frame's rows")
        gb = {n: v[rows].contiguous() for n, v in gpl.items()}
        kwb = dict(kw, ao=ao[rows].contiguous(), spotsf=spotsf[:, rows].contiguous())
        for c, cl in (("dense", None), ("clustered", clusters)):
            clb = None if cl is None else tuple(
                x[y0 // SHADE_ROWS:(y0 + band_h) // SHADE_ROWS].contiguous() for x in cl)
            k2b = shade_inputs(gb, ss2, clusters=clb, y0=y0, full_height=cfg.padded_height,
                               **kwb)
            hk, hr = shade_deferred_cuda(**k2b), shade_deferred_reference(**k2b)
            require_equal(hk, full2[c][:, rows], f"K2 ({c}) band {b} vs the whole "
                          "frame's rows")
            err = (hk - hr).abs().max().item()
            if not torch.allclose(hk, hr, atol=1e-4, rtol=1e-3):
                raise RuntimeError(f"K2 ({c}) band {b} vs plain: max abs err {err}")
            errs["k2"] = max(errs["k2"], err)
            if c == "dense":
                epib = epilogue_inputs(gb)
                ek = shade_epilogue_cuda(hk, **epib)
                require_equal(ek, shade_epilogue_reference(hk, **epib),
                              f"K2 epilogue band {b} vs its plain version")
                require_equal(ek, full_epi[:, rows], f"K2 epilogue band {b} vs the "
                              "whole frame's rows")
    phase("4m", f"{MULTI_BANDS} bands of {n_rows} tile rows ({band_h} rows) of the bench "
                f"frame {W}x{H}: K1 and K6 (early-z), K4 (merged stream) and the K2 "
                f"epilogue bit-identical to their plain versions in band mode and to the "
                f"whole frame's rows; K2 (dense and with clusters of 8) bit-identical to "
                f"the whole frame's rows, within atol 1e-4 / rtol 1e-3 of plain (max abs "
                f"err {errs['k2']:.3g})")

    # ---- 5m. the sharded frame, world size 1 on NCCL in this process
    def ref(cfg_, st_, draws, ss):
        return F.render_frame(cfg_, st_, draws, ss, device=dev)

    store = tempfile.mkdtemp(prefix="bands_")
    bands = init_bands(0, 1, device=dev, backend="nccl", init_method=f"file://{store}/s")
    render_s = lambda draws, ss: render_frame_sharded(cfg, bands, state, draws, ss)
    per_frame, _, _, _ = drive(render_s, inputs, kernels,
                               dict(raster_shade=2, shade_deferred=2, raster_depth=3,
                                    raster_blend=1, shade_epilogue=1),
                               forbid=("raster_shade_2p", "raster_v1", "raster_mxu"))
    launches = per_frame[-1]
    cfg_2p = dataclasses.replace(cfg, raster_two_phase=True)
    render_2p = lambda draws, ss: render_frame_sharded(cfg_2p, bands, state, draws, ss)
    per_2p, _, img_2p, _ = drive(render_2p, inputs[:1], kernels,
                                 dict(raster_shade_2p=2, shade_deferred=2),
                                 forbid=("raster_shade", "raster_v1", "raster_mxu"))
    require_equal(img_2p, ref(cfg_2p, state, *inputs[0])["image"],
                  "world-1 sharded frame with raster_two_phase vs render_frame")
    imgs_ref = {}
    for k, (draws, ss) in enumerate(inputs):
        o = render_s(draws, ss)
        r = ref(cfg, state, draws, ss)
        require_equal(o["image"], r["image"], f"world-1 sharded frame {k} vs render_frame")
        imgs_ref[k] = r["image"]
    phase("5m", f"world size 1 (nccl): the sharded bench frame at "
                f"translucent_lit_scale 1, 3 frames, each bit-equal to render_frame's; "
                f"launches a frame {launches}; with raster_two_phase (K6), bit-equal, "
                f"launches {per_2p[0]}")

    # world size 2: two processes on the one card over gloo, host-staged
    t0 = time.perf_counter()
    ranks = spawn_bands(multi_rank, 2, backend="gloo", devices=[str(dev)] * 2,
                        args=((W, H), MULTI, MULTI_REDUCED))
    secs = time.perf_counter() - t0
    ref1 = imgs_ref[0].cpu().numpy()
    for r, res in enumerate(ranks):
        if not np.array_equal(res["bench1"], ref1):
            raise RuntimeError(f"2-rank sharded bench frame (rank {r}) != render_frame: "
                               f"max |d| {np.abs(res['bench1'].astype(int) - ref1).max()}")
        if res["replicated"] != ranks[0]["replicated"]:
            raise RuntimeError(f"replicated stage differs between ranks: "
                               f"{res['replicated']} vs {ranks[0]['replicated']}")
        if res["overflow1"] or res["overflow2"]:
            raise RuntimeError(f"rank {r}: bin_overflow {res['overflow1']}")
    ctx2, camera2, params2, make_rl2 = datumtest_scene(
        width=W, height=H, device=dev, **dict(MULTI, translucent_lit_scale=2))
    draws2, ss2_ = frame_inputs(ctx2, camera2, params2, make_rl2, 0.0)
    ref2 = ref(ctx2.config, ctx2.device_state(dev), draws2, ss2_)["image"].cpu().numpy()
    rmse2 = float(np.sqrt(np.mean((ranks[0]["bench2"] / 255.0 - ref2 / 255.0) ** 2)))
    phase("5m", f"world size 2 (gloo, two processes on the one card, CUDA tensors "
                f"staged through host memory; {secs:.1f} s with their start): the bench "
                f"frame at translucent_lit_scale 1 bit-equal to render_frame's on both "
                f"ranks, the replicated stage's outputs equal on both "
                f"({', '.join(ranks[0]['replicated'])}); at the bench's "
                f"translucent_lit_scale 2 RMSE {rmse2:.5f} against render_frame (the "
                f"parity exception: band mode shades the lit layer at full resolution; "
                f"printed, not gated)")
    for bloom in (False, True):
        rcfg, rstate, rdraws, rss = reduced_inputs(bloom, dev, MULTI_REDUCED)
        single = ref(rcfg, rstate, rdraws, rss)["image"].cpu().numpy().astype(int)
        for r, res in enumerate(ranks):
            mm = np.abs(single - res[f"reduced{int(bloom)}"].astype(int)).max(-1)
            ok = ((mm.mean() < 1.0 and (mm > 12).mean() < 5e-3) if bloom
                  else (mm.max() <= 1 and (mm > 0).mean() < 1e-3))
            if not ok:
                raise RuntimeError(f"reduced path (bloom {bloom}) rank {r}: max |d| "
                                   f"{mm.max()}, mean {mm.mean()}")
        phase("5m", f"reduced path, 2 ranks at 256x128, bloom {'on' if bloom else 'off'}:"
                    f" max |d| {mm.max()}, mean {mm.mean():.4f} levels, pixels off "
                    f"{(mm > 0).mean():.5f}, by > 12 {(mm > 12).mean():.5f} (tests/"
                    f"test_parallel.py's tolerances)")
        if not bloom:
            single0 = single
    # the reduced path with use_pallas: each rank's band through the
    # lighting kernel, held to the single-device plain frame as above
    band_rows = MULTI_REDUCED["height"] // 2
    for r, res in enumerate(ranks):
        mm = np.abs(single0 - res["reduced_kernel"].astype(int)).max(-1)
        bands_seen = res["reduced_kernel_bands"]
        if (len(bands_seen) != 1 or bands_seen[0][0] != r * band_rows or bands_seen[0][2]
                or not (mm.max() <= 1 and (mm > 0).mean() < 1e-3)):
            raise RuntimeError(f"reduced path with the lighting kernel, rank {r}: launches "
                               f"{bands_seen}, max |d| {mm.max()} against the single-device "
                               f"frame")
    phase("5m", f"reduced path with use_pallas, 2 ranks at 256x128, bloom off: one "
                f"lighting kernel launch a rank in band mode (y0 "
                f"{[res['reduced_kernel_bands'][0][0] for res in ranks]}), each within atol "
                f"1e-4 / rtol 1e-3 of lighting_reference on its arguments (max abs err "
                f"{max(res['reduced_kernel_bands'][0][1] for res in ranks):.3g}); the image "
                f"against the single-device plain frame: max |d| {mm.max()}, pixels off "
                f"{(mm > 0).mean():.5f} (the bloom-off tolerances)")
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=str(dev), backend="gloo", verbose=False)
    phase("5m", f"dryrun_multichip(4) on the card (gloo, 4 processes on the one card; "
                f"{time.perf_counter() - t0:.1f} s): image {dry['image'].shape}, parity "
                f"RMSE {dry['rmse']:.5f} (gate < 1e-3), luminance {dry['luminance']:.4f}, "
                f"ledger total {dry['ledger']['TOTAL']} B a rank")

    # ---- 6m. the band machinery's overhead at world size 1; the ledger
    t_s = frame_ms(render_s, inputs)
    t_r = frame_ms(lambda draws, ss: ref(cfg, state, draws, ss), inputs)
    t_s2 = frame_ms(render_s, inputs)
    t_r2 = frame_ms(lambda draws, ss: ref(cfg, state, draws, ss), inputs)
    close_bands(bands)
    ledger = ranks[0]["ledger1"]
    per = ", ".join(f"{k} {v}" for k, v in sorted(ledger.items(), key=lambda kv: -kv[1])
                    if k != "TOTAL")
    phase("6m", f"ms/frame (CUDA events, median of 7, in turns) at translucent_lit_scale "
                f"1: world-1 sharded frame {t_s:.3f}, {t_s2:.3f}; render_frame {t_r:.3f}, "
                f"{t_r2:.3f} on {card}; two ranks on one card are not timed (no scaling "
                f"number)")
    phase("6m", f"byte ledger at {W}x{H}, n = 2: {ledger['TOTAL']} B a frame a rank "
                f"({per}); at the bench's lit scale 2: {ranks[0]['ledger2']['TOTAL']} B")
    phase("6m", f"phases 4m-6m took {time.perf_counter() - t_start:.1f} s")
    errs["lighting"] = max(res["reduced_kernel_bands"][0][1] for res in ranks)
    return dict(errs=errs, launches=launches, launches_2p=per_2p[0],
                reduced_kernel_launches=len(ranks[0]["reduced_kernel_bands"]),
                ms=dict(sharded=min(t_s, t_s2),
                                                      single=min(t_r, t_r2)),
                ledger=ledger, dry_rmse=dry["rmse"])


def versions_phase(path, card, sets):
    """--versions FILE: other versions of K1's, K6's, K2's, K3's, K4's,
    K5's and K7's sources, timed beside this build's on the same inputs.
    FILE is a JSON list of {"name", "kernel": "raster_shade" |
    "raster_shade_2p" | "shade_deferred" | "raster_depth" | "raster_blend"
    | "raster_v1" | "raster_mxu", "source" (relative to FILE), "fmad":
    true | false}; a kernel no version names is skipped.  Each version is
    built alone (ptxas registers and spill printed), checked against the
    plain version as the kernel is held (K1, K6, K3, K5 and K7 bit for
    bit, K2 atol 1e-4 /
    rtol 1e-3, K4 as check_same) and against this build's output
    bit for bit (printed, not raised, so that a version's error is
    measured), and timed in turns, the versions in order and then in
    reverse, the mean of the two.  sets: per kernel, [(name, inputs)].
    Informational: it is how a kernel's redesign is timed step by step
    against the earlier design in one call on one card (PERF.md section
    6's step tables).  The default run builds and launches none of it."""
    import contextlib
    from pathlib import Path

    import torch

    from datum_tpu_torch.ops import _kernels
    from datum_tpu_torch.ops.raster_blend_cuda import (raster_blend_cuda,
                                                       raster_blend_reference)
    from datum_tpu_torch.ops.raster_cuda import (raster_shade_2p_cuda,
                                                 raster_shade_2p_reference,
                                                 raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_depth_cuda import (raster_depth_cuda,
                                                       raster_depth_reference)
    from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda, raster_mxu_reference
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda, raster_v1_reference
    from datum_tpu_torch.ops.shade_cuda import shade_deferred_cuda, shade_deferred_reference

    def close(out, plain, kernel):
        if kernel == "shade_deferred":
            return torch.allclose(out, plain, atol=1e-4, rtol=1e-3)
        if kernel == "raster_blend":
            return bool(torch.isfinite(out).all()) and (
                (out == plain).float().mean().item() >= 0.9999
                and torch.allclose(out, plain, atol=1e-5, rtol=1e-5))
        return torch.equal(out, plain)

    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        spec = json.load(f)
    runs = dict(raster_shade=(raster_shade_cuda, raster_shade_reference, "raster_shade.cu",
                              "bit-identity"),
                raster_shade_2p=(raster_shade_2p_cuda, raster_shade_2p_reference,
                                 "raster_shade_2p.cu", "bit-identity"),
                raster_mxu=(raster_mxu_cuda, raster_mxu_reference, "raster_mxu.cu",
                            "bit-identity"),
                raster_v1=(raster_v1_cuda, raster_v1_reference, "raster_v1.cu",
                           "bit-identity"),
                shade_deferred=(shade_deferred_cuda, shade_deferred_reference, "shade.cu",
                                "atol 1e-4 / rtol 1e-3"),
                raster_depth=(raster_depth_cuda, raster_depth_reference, "raster_depth.cu",
                              "bit-identity"),
                raster_blend=(raster_blend_cuda, raster_blend_reference, "raster_blend.cu",
                              "check_same"))
    for kernel, (run, ref, src, held) in runs.items():
        if not any(v["kernel"] == kernel for v in spec):
            continue
        versions = [("this build", None)] + [
            (v["name"], _kernels.build_version(Path(base, v["source"]), v["fmad"],
                                               v["name"]))
            for v in spec if v["kernel"] == kernel]
        for name, lib in versions:
            rep = lib.ptxas(*lib.logs) if lib else _kernels.library().ptxas(src)
            phase(7, f"{kernel} version {name}: ptxas {rep}")
        plains = {}
        cache = {}                  # one plain run a distinct input (split aside)
        for n, inp in sets[kernel]:
            plain_in = {k: v for k, v in inp.items() if k != "split"}
            key = tuple(sorted((k, id(v)) for k, v in plain_in.items()))
            if key not in cache:
                cache[key] = ref(**plain_in)
            plains[n] = cache[key]
        built = {n: run(**inp) for n, inp in sets[kernel]}
        ms = {(v, n): [] for v, _ in versions for n, _ in sets[kernel]}
        for order in (versions, versions[::-1]):
            for name, lib in order:
                with _kernels.using(lib) if lib else contextlib.nullcontext():
                    for n, inp in sets[kernel]:
                        out = run(**inp)
                        torch.cuda.synchronize()
                        err = (out - plains[n]).abs().max().item()
                        ms[name, n].append((device_ms(lambda: run(**inp)),
                                            cuda_ms(lambda: run(**inp), 20), err,
                                            close(out, plains[n], kernel),
                                            bits(out, built[n])))
        for name, _ in versions:
            phase(7, f"{kernel} version {name} on {card}: device ms a call (CUDA-event "
                     "ms a call), mean of the two turns: " + "; ".join(
                f"{n} {statistics.mean(r[0] for r in ms[name, n]):.4f} "
                f"({', '.join(f'{r[0]:.4f}' for r in ms[name, n])}; "
                f"{statistics.mean(r[1] for r in ms[name, n]):.4f}), max abs err "
                f"{ms[name, n][0][2]:.3g}, {'within' if ms[name, n][0][3] else 'BEYOND'} "
                f"{held}, {'the same bits as' if ms[name, n][0][4] else 'OTHER BITS than'} "
                "this build" for n, _ in sets[kernel]))


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--versions", metavar="FILE",
                    help="also time other versions of K1's, K6's, K2's, K3's, K4's, "
                         "K5's and K7's sources (see versions_phase)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # ---- 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False — "
                           "this script runs only on a machine with an "
                           "NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    phase(1, f"device {kind}, count {torch.cuda.device_count()}, torch "
             f"{torch.__version__}, CUDA {torch.version.cuda}, TF32 off")
    print(smi, flush=True)

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.ops import _kernels
    from datum_tpu_torch.ops import fog as fog_ops
    from datum_tpu_torch.ops import shadow as shadow_ops
    from datum_tpu_torch.ops.blur import resize_matmul
    from datum_tpu_torch.ops.raster_blend_cuda import (
        blend_inputs, raster_blend_cuda, raster_blend_reference)
    from datum_tpu_torch.ops.raster_cuda import (
        PLANE_NAMES, raster_inputs, raster_shade_2p_cuda, raster_shade_2p_reference,
        raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_depth_cuda import (
        depth_inputs, raster_depth_cuda, raster_depth_reference)
    from datum_tpu_torch.ops.gather_cuda import gather_rows_cuda
    from datum_tpu_torch.ops.lighting_cuda import lighting_cuda
    from datum_tpu_torch.ops.sprite_pass_cuda import composite_sprites_cuda
    from datum_tpu_torch.ops.shade_cuda import (
        epilogue_inputs, shade_deferred_cuda, shade_deferred_envd,
        shade_deferred_reference, shade_epilogue_cuda, shade_epilogue_reference,
        shade_inputs)
    from datum_tpu_torch.render import frame as F
    from datum_tpu_torch.scenes import datumtest_scene
    kernels = dict(raster_shade=raster_shade_cuda,
                   raster_shade_2p=raster_shade_2p_cuda,
                   shade_deferred=shade_deferred_cuda,
                   shade_deferred_envd=shade_deferred_envd,
                   raster_depth=raster_depth_cuda,
                   raster_blend=raster_blend_cuda,
                   shade_epilogue=shade_epilogue_cuda,
                   gather_rows=gather_rows_cuda,
                   sprite_pass=composite_sprites_cuda,
                   lighting=lighting_cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _kernels.library()
    phase(2, f"built {lib.path.name} from {', '.join(_kernels.SOURCES)} in "
             f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)}; "
             f"-fmad=true for {', '.join(_kernels.FMAD_SOURCES)})")
    for src in _kernels.SOURCES:
        for line in lib.logs[src].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc {src}:", line.strip(), flush=True)

    # ---- 3. the bench scene at full width
    t0 = time.perf_counter()
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, **SCENE)
    cfg = ctx.config
    state = ctx.device_state(dev)
    overflows, stack_overflows, lit_overflows, fwd_overflows = [], [], [], []
    for t in (0.0, 0.1, 0.2):
        draws, ss = frame_inputs(ctx, camera, params, make_rl, t)
        n_tris = int(draws["t_valid"].sum())
        n_ttris = int(draws["translucent"]["t_valid"].sum())
        d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
        ex, _, clip, _, _, wp = F._vertex_stage(cfg, state, d_t, s_t)
        overflows.append(int(F._bin_stage(cfg, ex, clip)[-1]))
        stack_overflows.append([int(shadow_ops.bin_stack(
            st, cfg.shadow_bin_capacity, cfg.big_capacity,
            return_overflow=True)[3]) for st in shadow_stacks(cfg, ex, wp, s_t)])
        ts = F.translucent_stream(state, d_t, s_t)
        lit_overflows.append(int(lit_bins(cfg, ts, return_overflow=True)[-1]))
        st = F.oit_stream(cfg, state, d_t, s_t, ts, None)
        fwd_overflows.append(int(F.oit_bins(cfg, st, return_overflow=True)[3]))
    if any(overflows):
        raise RuntimeError(f"bin overflow {overflows}: raise bin_capacity")
    w_t, h_t = F.lit_viewport(cfg)
    phase(3, f"bench scene {W}x{H}, {n_tris} opaque + {n_ttris} translucent "
             f"triangles drawn, {int(draws['forward']['quad_count'])} particle quads, "
             f"{int(draws['decals']['count'])} decals, {cfg.n_tiles} tiles, bins "
             f"{cfg.bin_capacity}+{cfg.big_capacity}, bin_overflow {overflows}; "
             f"skybox {ctx.skybox.size}^2 x 6 with {len(state['ibl']['mips'])} "
             f"mips; SSAO at {cfg.ssao_scale}, fog taps at 1/{cfg.fog_sample_scale}, "
             f"binned SSR ({time.perf_counter() - t0:.1f} s)")
    phase(3, f"shadow stack overflow per frame ({', '.join(STACKS)}; shadow "
             f"bins {cfg.shadow_bin_capacity}+{cfg.big_capacity}): "
             f"{stack_overflows}")
    phase(3, f"lit layer ({w_t}x{h_t}) overflow {lit_overflows}, forward WBOIT "
             f"stream overflow {fwd_overflows} (forward bins "
             f"{cfg.forward_bin_capacity}+{cfg.forward_big_capacity} a stream)")

    # ---- 4. kernels vs their plain versions on the bench frame's inputs
    draws, ss = frame_inputs(ctx, camera, params, make_rl, 0.3)
    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, state, d_t, s_t)
    k3_in, k3_errs = [], []
    for name, st in zip(STACKS, shadow_stacks(cfg, ex, wp, s_t)):
        bins, counts, big = shadow_ops.bin_stack(st, cfg.shadow_bin_capacity,
                                                 cfg.big_capacity)
        inp = depth_inputs(st["setup"], bins, big, counts, st["tiles_x"],
                           st["res"], st["height"])
        inpz = depth_inputs(st["setup"], bins, big, counts, st["tiles_x"],
                            st["res"], st["height"], early_z=True)
        dk = raster_depth_cuda(**inp)
        dz = raster_depth_cuda(**inpz)
        dr = raster_depth_reference(**inp)
        torch.cuda.synchronize()
        require_equal(dk, dr, f"K3 vs plain on the {name}")
        require_equal(dz, dr, f"K3 with early-z vs plain on the {name}")
        err = (dk - dr).abs().max().item()
        covered = (dr > 0).float().mean().item()
        phase(4, f"K3 vs plain, {name} ({st['res']}x{st['height']}, {bins.shape[0]} "
                 f"tiles, {int((counts == bins.shape[1]).sum())} full bins): with early-z "
                 f"off and on bit-identical on every texel (covered {covered:.3f})")
        k3_in.append(inp)
        k3_errs.append(err)

    setup, bins, counts, big_ids, _ = F._bin_stage(cfg, ex, clip)
    k1_in = raster_inputs(setup, bins, big_ids, counts, ex["tris"], uv, wn,
                          d_t["tri_mat"], state["materials"], cfg.tiles_x,
                          cfg.padded_width, cfg.padded_height, wt)
    pk = raster_shade_cuda(**k1_in)
    pr = raster_shade_reference(**k1_in)
    torch.cuda.synchronize()
    k1_err = check_k1(pk, pr, "opaque layer")
    kp = dict(zip(PLANE_NAMES, pk))
    k6_err = check_k6(raster_shade_2p_cuda(**k1_in), raster_shade_2p_reference(**k1_in),
                      pk, "opaque layer")

    ts = F.translucent_stream(state, d_t, s_t)
    lsetup, ltx, lw, lh, lbins, lcounts, lbig = lit_bins(cfg, ts)
    lit_in = raster_inputs(lsetup, lbins, lbig, lcounts, ts["d"]["tris"], ts["uv"],
                           ts["wn"], ts["d"]["tri_mat"], state["materials"], ltx,
                           lw, lh, ts["wt"], alpha_in_alb=True)
    lk = raster_shade_cuda(**lit_in)
    lr = raster_shade_reference(**lit_in)
    torch.cuda.synchronize()
    k1_lit_err = check_k1(lk, lr, "lit layer, alpha_in_alb")
    k1_err = max(k1_err, k1_lit_err)
    k6_err = max(k6_err, check_k6(raster_shade_2p_cuda(**lit_in),
                                  raster_shade_2p_reference(**lit_in), lk,
                                  "lit layer, alpha_in_alb"))

    shadows = F._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf, ao, _ = F._shade_inputs(cfg, kp, state, d_t, s_t, shadows)
    if "sky_r" not in gpl or spotsf is None or ao is None or "fog_t" not in gpl:
        raise RuntimeError("K2 inputs lack the sky planes, the spot factors, "
                           "SSAO's ao or the fog planes")
    k2_in = shade_inputs(gpl, ss2, proj=s_t["proj"], invview=s_t["invview"],
                         ao=ao, spotsf=spotsf)
    hk = shade_deferred_cuda(**k2_in)
    hr = shade_deferred_reference(**k2_in)
    torch.cuda.synchronize()
    k2_err = (hk - hr).abs().max().item()
    if not torch.isfinite(hk).all() or not torch.allclose(hk, hr, atol=1e-4,
                                                            rtol=1e-3):
        raise RuntimeError(f"K2 vs plain: max abs err {k2_err} beyond "
                           "atol 1e-4 / rtol 1e-3")
    sf, spf = gpl["sf"], spotsf[0]
    phase(4, f"K2 vs plain (sky, IBL, SSAO, sun + spot shadow planes, decals): hdr "
             f"max abs err {k2_err:.3g} (atol 1e-4, rtol 1e-3), max |hdr| "
             f"{hr.abs().max().item():.3g}; sun factor < 0.5 on "
             f"{(sf < 0.5).float().mean().item():.3f}, spot factor < 0.5 on "
             f"{(spf < 0.5).float().mean().item():.3f}, ao < 0.9 on "
             f"{(ao < 0.9).float().mean().item():.3f} of pixels")
    # the lit layer's K2 launch (render/frame.py::_lit_layers): the layer's
    # planes in front of the opaque depth, assembled at its viewport
    planes_t = dict(zip(PLANE_NAMES, lk))
    planes_t["visf"] = torch.where(
        planes_t["depth"] > resize_matmul(kp["depth"], lh, lw, nearest=True),
        planes_t["visf"], torch.full_like(planes_t["visf"], -1.0))
    gpl_t, _ = F._assemble_gplanes(cfg, planes_t, state, s_t, shadows, lw, lh)
    k2l_in = shade_inputs(gpl_t, ss2, proj=s_t["proj"], invview=s_t["invview"])
    hk = shade_deferred_cuda(**k2l_in)
    hr = shade_deferred_reference(**k2l_in)
    torch.cuda.synchronize()
    k2_lit_err = (hk - hr).abs().max().item()
    if not torch.isfinite(hk).all() or not torch.allclose(hk, hr, atol=1e-4, rtol=1e-3):
        raise RuntimeError(f"K2 vs plain on the lit layer: max abs err {k2_lit_err} "
                           "beyond atol 1e-4 / rtol 1e-3")
    k2_err = max(k2_err, k2_lit_err)
    phase(4, f"K2 vs plain, lit layer ({lw}x{lh}, covered "
             f"{(planes_t['visf'] >= 0).float().mean().item():.3f}): hdr max abs err "
             f"{k2_lit_err:.3g} (atol 1e-4, rtol 1e-3)")

    # K4 on the merged stream (particles; no residual at one lit layer)
    st = F.oit_stream(cfg, state, d_t, s_t, ts, None)
    obins, ocounts, obig = F.oit_bins(cfg, st)
    k4_in = blend_inputs(st["setup"], obins, obig, ocounts, st["tris"], st["uv"],
                         st["color"], kp["depth"], cfg.tiles_x, cfg.padded_width,
                         cfg.padded_height, "per_tri", None, st["soft_flag"],
                         st["peel_flag"])
    bk = raster_blend_cuda(**k4_in)
    br = raster_blend_reference(**k4_in)
    torch.cuda.synchronize()
    k4_err = check_same(bk, br, "K4, merged stream", f"; particles cover "
                        f"{(br[3] > 0).float().mean().item():.4f} of pixels")

    # the epilogue on the bench frame's planes: the lit layer, refraction,
    # fog (the bench's density 0) and WBOIT
    F._translucent_stage(cfg, state, d_t, s_t, ss2, shadows, kp["depth"], gpl)
    epi_in = epilogue_inputs(gpl)
    n_refr = int((epi_in["refr"][0] != 0).sum())
    if n_refr == 0 or epi_in["fog"] is None:
        raise RuntimeError("the epilogue check has no refracted pixel or no fog")
    epi_bg = shade_deferred_cuda(**k2_in)
    ek = shade_epilogue_cuda(epi_bg, **epi_in)
    er = shade_epilogue_reference(epi_bg, **epi_in)
    torch.cuda.synchronize()
    epi_err = check_same(ek, er, "K2 epilogue (tr, refraction, fog, WBOIT)",
                         f"; tr_ox != 0 on {n_refr} pixels, tr_a > 0 on "
                         f"{int((epi_in['tr'][3] > 0).sum())}")
    # the fog group where it moves values: the volume at a fog density,
    # with and without the refraction (the resolve's two fma forms)
    s_fog = dict(s_t, camera=dict(s_t["camera"], fogdensity=torch.tensor(
        FOG_DENSITY, device=dev)))
    gpl_fog = dict(gpl)
    F._fog(cfg, kp["depth"], s_fog, shadows, gpl_fog)
    fog_in = epilogue_inputs(gpl_fog)
    fog_t = fog_in["fog"][3].float()
    for name, kw in (("tr, refraction, fog, WBOIT", fog_in),
                     ("fog, WBOIT", dict(fog=fog_in["fog"], oit=fog_in["oit"]))):
        fk = shade_epilogue_cuda(epi_bg, **kw)
        fr = shade_epilogue_reference(epi_bg, **kw)
        torch.cuda.synchronize()
        epi_err = max(epi_err, check_same(
            fk, fr, f"K2 epilogue at fog density {FOG_DENSITY} ({name})",
            f"; fog_t < 0.99 on {(fog_t < 0.99).float().mean().item():.3f} of "
            f"pixels, min fog_t {fog_t.min().item():.3f}"))

    # two lit layers: K1 and K6 with peel_depth, K4 with a peeled residual
    cfg2 = dataclasses.replace(cfg, translucent_lit_layers=2)
    peel_in = dict(lit_in, peel=lr[0].contiguous())
    pk2 = raster_shade_cuda(**peel_in)
    pr2 = raster_shade_reference(**peel_in)
    torch.cuda.synchronize()
    k1_peel_err = check_k1(pk2, pr2, "lit layer 2, peel_depth")
    k1_err = max(k1_err, k1_peel_err)
    k6_err = max(k6_err, check_k6(raster_shade_2p_cuda(**peel_in),
                                  raster_shade_2p_reference(**peel_in), pk2,
                                  "lit layer 2, peel_depth"))
    lit_peel = resize_matmul(pr2[0], H, W, nearest=True)
    st2 = F.oit_stream(cfg2, state, d_t, s_t, ts, lit_peel)
    n_peeled = int(((st2["peel_flag"] > 0) & st2["valid"]).sum())
    if n_peeled == 0:
        raise RuntimeError("the 2-layer stream has no peel-flagged triangle")
    b2 = F.oit_bins(cfg2, st2)
    k4p_in = blend_inputs(st2["setup"], b2[0], b2[2], b2[1], st2["tris"], st2["uv"],
                          st2["color"], kp["depth"], cfg.tiles_x, cfg.padded_width,
                          cfg.padded_height, "per_tri", lit_peel, st2["soft_flag"],
                          st2["peel_flag"])
    bk2 = raster_blend_cuda(**k4p_in)
    br2 = raster_blend_reference(**k4p_in)
    torch.cuda.synchronize()
    k4_err = max(k4_err, check_same(
        bk2, br2, "K4, 2 lit layers (peeled residual)",
        f"; {n_peeled} peel-flagged translucent triangles, residual + "
        f"particles cover {(br2[3] > 0).float().mean().item():.4f} of pixels"))

    # ---- 5. the paths, each driven with the counts set to 0 just before
    octx, ocam, oparams, omake = datumtest_scene(width=W, height=H, **OPAQUE)
    ostate = octx.device_state(dev)
    o_inputs = [frame_inputs(octx, ocam, oparams, omake, t) for t in (0.0, 0.1)]
    sctx, scam, sparams, smake = datumtest_scene(width=W, height=H, **SHADOWED)
    sstate = sctx.device_state(dev)
    s_inputs = [frame_inputs(sctx, scam, sparams, smake, t) for t in (0.0, 0.1)]
    # the translucent frame of the earlier slice: the bench frame's scene
    # and state without SSAO, fog and SSR
    tcfg = dataclasses.replace(cfg, enable_ssao=False, enable_fog=False,
                               enable_ssr=False)
    inputs = [frame_inputs(ctx, camera, params, make_rl, t)
              for t in (0.0, 0.1, 0.2)]
    cfg6 = dataclasses.replace(cfg, raster_two_phase=True)
    cfg_dof = dataclasses.replace(cfg, enable_depth_of_field=True)
    focus = (camera.focalwidth, camera.focaldistance)
    camera.set_depth_of_field(4.0, 14.0)          # bench.py:116-117
    dof_inputs = [frame_inputs(ctx, camera, params, make_rl, t) for t in (0.0, 0.1)]
    camera.set_depth_of_field(*focus)
    render_o = lambda d, s: F.render_frame(octx.config, ostate, d, s, device=dev)
    render_s = lambda d, s: F.render_frame(sctx.config, sstate, d, s, device=dev)
    render_t = lambda d, s: F.render_frame(tcfg, state, d, s, device=dev)
    render_b = lambda d, s: F.render_frame(cfg, state, d, s, device=dev)
    render_6 = lambda d, s: F.render_frame(cfg6, state, d, s, device=dev)
    render_d = lambda d, s: F.render_frame(cfg_dof, state, d, s, device=dev)
    pf, _, _, _ = drive(render_o, o_inputs[:1], kernels,
                        dict(raster_shade=1, shade_deferred=1))
    phase(5, f"opaque frame: launches {pf}")
    pf, _, _, _ = drive(render_s, s_inputs[:1], kernels,
                        dict(raster_shade=1, shade_deferred=1, raster_depth=3))
    phase(5, f"shadowed, sky-lit frame: launches {pf}")
    pf, _, _, _ = drive(render_t, inputs[:1], kernels,
                        dict(raster_shade=2, shade_deferred=2, shade_epilogue=1,
                             raster_depth=3, raster_blend=1))
    phase(5, f"translucent frame (no SSAO, fog, SSR): launches {pf}")
    bench_expect = dict(raster_shade=2, shade_deferred=2, shade_epilogue=1,
                        raster_depth=3, raster_blend=1)
    pf, launches, img, lum = drive(render_b, inputs, kernels, bench_expect,
                                   forbid=("raster_shade_2p", "sprite_pass", "lighting"))
    phase(5, f"3 bench frames {W}x{H} (K1): image {tuple(img.shape)} u8 mean "
             f"{img.float().mean().item():.2f}, luminance {lum.item():.6g}, "
             f"bin_overflow 0, launches per frame {pf}")
    pf, launches6, _, _ = drive(
        render_6, inputs[:2], kernels,
        dict(bench_expect, raster_shade=0, raster_shade_2p=2),
        forbid=("raster_shade", "lighting"))
    phase(5, f"2 bench frames with raster_two_phase (K6): launches per frame {pf}")
    img_k1 = render_b(*inputs[0])["image"]
    img_k6 = render_6(*inputs[0])["image"]
    if not torch.equal(img_k1, img_k6):
        raise RuntimeError("the bench frame with K6 differs from the frame with K1")
    phase(5, "bench frame t=0: the K6 image equals the K1 image (u8, every pixel)")
    pf, _, imgd, _ = drive(render_d, dof_inputs[:1], kernels, bench_expect,
                           forbid=("raster_shade_2p", "lighting"))
    moved = (imgd.float() - img_k1.float()).abs().mean().item()
    if moved < 0.5:
        raise RuntimeError(f"the DoF frame barely differs from the bench frame: {moved}")
    phase(5, f"bench frame with DoF (focus 14, width 4): launches {pf}, mean |d| "
             f"{moved:.2f} levels from the frame without DoF")

    # the same small bench frame (with a fog density) on the card (kernels)
    # and on the CPU (plain), with K1 and with K6
    mctx, mcam, mparams, mmake = datumtest_scene(width=256, height=128, **SMALL)
    mparams.fogdensity = FOG_DENSITY
    mdraws, mss = frame_inputs(mctx, mcam, mparams, mmake, 0.3)
    for two_phase in (False, True):
        mcfg = dataclasses.replace(mctx.config, raster_two_phase=two_phase)
        imgs = [F.render_frame(mcfg, mctx.host_state(), mdraws, mss,
                               device=d)["image"].cpu().float()
                for d in (dev, "cpu")]
        d_img = (imgs[0] - imgs[1]).abs()
        rmse = ((imgs[0] - imgs[1]) ** 2).mean().sqrt().item() / 255.0
        if d_img.mean().item() > 0.5 or rmse > 2 / 255 or imgs[1].mean() <= 10:
            raise RuntimeError(f"small frame GPU vs CPU plain: mean |d| "
                               f"{d_img.mean().item()}, RMSE {rmse}")
        phase(5, f"256x128 bench frame ({'K6' if two_phase else 'K1'}; glass, "
                 f"water, particles, decals, SSAO, fog at density "
                 f"{FOG_DENSITY}, SSR), card vs CPU plain path: mean |d| "
                 f"{d_img.mean().item():.4f} levels, RMSE {rmse * 255:.4f} levels")

    # ---- 5r. the reference's only full-resolution frame
    reference_1080_phase(dev)

    # ---- 6. timing (informational: this PR claims no speed)
    # K1 and K6 frames in turns (K1, K6, K6, K1): one call's order
    # effects fall on both
    ms_k1_runs, ms_k6_runs = [frame_ms(render_b, inputs)], []
    ms_k6_runs += [frame_ms(render_6, inputs), frame_ms(render_6, inputs)]
    ms_k1_runs.append(frame_ms(render_b, inputs))
    ms_frame, ms_k6 = statistics.mean(ms_k1_runs), statistics.mean(ms_k6_runs)
    ms_dof = frame_ms(render_d, dof_inputs, n=5)
    ms_trans = frame_ms(render_t, inputs, n=5)
    ms_shadowed = frame_ms(render_s, s_inputs, n=5)
    ms_opaque = frame_ms(render_o, o_inputs, n=5)
    stages = stage_table(render_b, inputs)
    prof_ms, prof_launches = profile_frames(render_b, inputs)
    t_k1 = cuda_ms(lambda: raster_shade_cuda(**k1_in), 20)
    t_k6 = cuda_ms(lambda: raster_shade_2p_cuda(**k1_in), 20)
    t_k1p = cuda_ms(lambda: raster_shade_reference(**k1_in), 1)
    t_k6p = cuda_ms(lambda: raster_shade_2p_reference(**k1_in), 1)
    t_k1l = cuda_ms(lambda: raster_shade_cuda(**lit_in), 20)
    t_k6l = cuda_ms(lambda: raster_shade_2p_cuda(**lit_in), 20)
    t_k2 = cuda_ms(lambda: shade_deferred_cuda(**k2_in), 20)
    t_k2p = cuda_ms(lambda: shade_deferred_reference(**k2_in), 1)
    t_k2l = cuda_ms(lambda: shade_deferred_cuda(**k2l_in), 20)
    t_k2lp = cuda_ms(lambda: shade_deferred_reference(**k2l_in), 1)
    # device time a call (the kernels alone, without the wrappers' host time)
    dev_ms = dict(k1=device_ms(lambda: raster_shade_cuda(**k1_in)),
                  k1l=device_ms(lambda: raster_shade_cuda(**lit_in)),
                  k6=device_ms(lambda: raster_shade_2p_cuda(**k1_in)),
                  k6l=device_ms(lambda: raster_shade_2p_cuda(**lit_in)),
                  k6p=device_ms(lambda: raster_shade_2p_cuda(**peel_in)),
                  k2=device_ms(lambda: shade_deferred_cuda(**k2_in)),
                  k2l=device_ms(lambda: shade_deferred_cuda(**k2l_in)),
                  k3=[device_ms(lambda i=i: raster_depth_cuda(**i)) for i in k3_in],
                  k4=device_ms(lambda: raster_blend_cuda(**k4_in)),
                  ep=device_ms(lambda: shade_epilogue_cuda(epi_bg, **epi_in)))
    t_k3 = [cuda_ms(lambda i=i: raster_depth_cuda(**i), 20) for i in k3_in]
    t_k3p = [cuda_ms(lambda i=i: raster_depth_reference(**i), 1) for i in k3_in]
    t_k4 = cuda_ms(lambda: raster_blend_cuda(**k4_in), 20)
    t_k4p = cuda_ms(lambda: raster_blend_reference(**k4_in), 1)
    t_ep = cuda_ms(lambda: shade_epilogue_cuda(epi_bg, **epi_in), 20)
    t_epp = cuda_ms(lambda: shade_epilogue_reference(epi_bg, **epi_in), 1)
    phase(6, f"{ms_frame:.3f} ms/frame bench (K1), {ms_k6:.3f} ms/frame bench with "
             f"K6 (each the mean of 2 medians of 7, timed K1, K6, K6, K1: "
             f"{', '.join(f'{t:.3f}' for t in (ms_k1_runs[0], *ms_k6_runs, ms_k1_runs[1]))}"
             f"), {ms_dof:.3f} ms/frame bench with DoF, "
             f"{ms_trans:.3f} translucent, {ms_shadowed:.3f} shadowed + sky-lit, "
             f"{ms_opaque:.3f} opaque (median of 5; CUDA events, {W}x{H}) on {card}")
    phase(6, f"bench frame under torch.profiler (3 frames): "
             f"{prof_ms:.3f} ms of device time and {prof_launches:.0f} kernel "
             f"launches per frame; busy {prof_ms / ms_frame:.3f} of the "
             f"{ms_frame:.3f} ms frame")
    phase(6, "bench frame stages (3 frames under torch.profiler, tracing on):\n"
          + stages)
    phase(6, f"K1 {t_k1:.3f} ms, K6 {t_k6:.3f} ms vs plain {t_k1p:.3f} / "
             f"{t_k6p:.3f} ms (opaque layer, the same inputs); lit layer "
             f"{lw}x{lh}: K1 {t_k1l:.3f} ms, K6 {t_k6l:.3f} ms; K2 "
             f"{t_k2:.3f} ms vs plain {t_k2p:.3f} ms, lit layer {t_k2l:.3f} ms vs plain "
             f"{t_k2lp:.3f} ms; K2 epilogue (tr, refraction, "
             f"fog, WBOIT) {t_ep:.3f} ms vs plain {t_epp:.3f} ms; K4 {t_k4:.3f} ms "
             f"vs plain {t_k4p:.3f} ms (merged stream); K3 " + ", ".join(
                 f"{n} {a:.3f} ms vs plain {b:.3f} ms"
                 for n, a, b in zip(STACKS, t_k3, t_k3p))
          + f" ({W}x{H}) on {card}")
    phase(6, "device time a call (20 calls behind a sleep kernel; ms): " + "; ".join(
        f"{n} {v:.4f}" for n, v in (
            ("K1", dev_ms["k1"]), ("K1 lit layer", dev_ms["k1l"]), ("K6", dev_ms["k6"]),
            ("K6 lit layer", dev_ms["k6l"]), ("K6 peeled layer", dev_ms["k6p"]),
            ("K2", dev_ms["k2"]), ("K2 lit layer", dev_ms["k2l"]),
            *((f"K3 {n}", v) for n, v in zip(STACKS, dev_ms["k3"])),
            ("K4", dev_ms["k4"]), ("K2 epilogue", dev_ms["ep"]))) + f" on {card}")

    # bounds from this run's inputs (timed calls above)
    px = W * H
    k1_bound = bound(_nbytes(*(k1_in[k] for k in ("rows", "bins", "counts",
                                                  "big_ids")))
                     + 22 * px * 4,
                     _walked(k1_in) * 4096 * OPS_WALK_DEPTH + px * OPS_K1_PIXEL)
    k1l_bound = bound(_nbytes(*(lit_in[k] for k in ("rows", "bins", "counts",
                                                    "big_ids")))
                      + 22 * lw * lh * 4,
                      _walked(lit_in) * 4096 * OPS_WALK_DEPTH + lw * lh * OPS_K1_PIXEL)
    n_lights = int(k2_in["counts"][0]) + int(k2_in["counts"][1])
    k2_bound = bound(_nbytes(k2_in["f32_planes"], k2_in["planes"], k2_in["ao"],
                             k2_in["spotsf"]) + 3 * px * 4,
                     px * (OPS_K2_PIXEL + OPS_K2_LIGHT * n_lights))
    k2l_bound = bound(_nbytes(k2l_in["f32_planes"], k2l_in["planes"]) + 3 * lw * lh * 4,
                      lw * lh * (OPS_K2_PIXEL + OPS_K2_LIGHT * n_lights))
    k3_bound = bound(sum(_nbytes(i["rows"], i["bins"], i["counts"], i["big_ids"])
                         + 4 * i["bins"].shape[0] * 4096 for i in k3_in),
                     sum(_walked(i) * 4096 * OPS_WALK_DEPTH for i in k3_in))
    k4_bound = bound(_nbytes(*(k4_in[k] for k in ("rows", "bins", "counts",
                                                  "big_ids", "opaque_depth")))
                     + 5 * px * 4, _walked(k4_in) * 4096 * OPS_WALK_BLEND)
    ep_bound = bound(_nbytes(epi_bg, *epi_in.values()) + 3 * px * 4,
                     px * OPS_EPILOGUE_PIXEL)
    phase(6, "bounds (ms, by): " + "; ".join(
        f"{n} {b[0]:.4f} {b[1]}" for n, b in (
            ("K1 and K6", k1_bound), ("K1, lit layer", k1l_bound), ("K2", k2_bound),
            ("K2, lit layer", k2l_bound), ("K3 (3 stacks)", k3_bound),
            ("K4", k4_bound), ("epilogue", ep_bound))))
    st = stress_phases(dev, card, kernels)
    dp = deferred_phases(dev, card, kernels, (cfg, state, inputs, setup, bins, counts,
                                              big_ids, ex, uv, wn, d_t, kp))
    ep = env_phases(dev, card, kernels, bench_expect)
    vertex_phases(dev, card, kernels, (render_b, inputs))
    op = overlay_phases(dev, card, kernels, (render_b, inputs))
    pp = particle_phases(dev, card, kernels, (render_b, inputs))
    pack_phases(dev, card, kernels, (render_b, inputs))
    mp = multi_phases(dev, card, kernels)
    if args.versions:
        k1_sets = [("bench opaque", k1_in), ("lit layer", lit_in), ("peeled layer", peel_in),
                   ("stress", st["inputs"]["k1"]), ("stress, early-z", st["inputs"]["k1z"])]
        versions_phase(args.versions, card, dict(
            raster_shade=k1_sets, raster_shade_2p=k1_sets,
            raster_mxu=[("bench", dp["inputs"]["k7"]),
                        ("stress-depth", st["inputs"]["k7"])],
            # K5 also at 2, 4 and 8 blocks a tile forced (a version that
            # takes no split ignores it)
            raster_v1=[(f"{n}{f', split {k}' if k else ''}", dict(inp, split=k or None))
                       for n, inp in (("bench", dp["inputs"]["k5"]),
                                      ("stress", st["inputs"]["k5"]))
                       for k in (0, 2, 4, 8)],
            raster_blend=[("merged stream", k4_in), ("soft", dict(k4_in, soft=True)),
                          ("not soft", dict(k4_in, soft=False)),
                          ("peeled residual", k4p_in)],
            shade_deferred=[("bench", k2_in), ("lit layer", k2l_in),
                            ("clustered", st["inputs"]["k2c"]),
                            ("edm", ep["inputs"]["k2e"])],
            raster_depth=[*zip(STACKS, k3_in), ("stress", st["inputs"]["k3"]),
                          ("stress, early-z", st["inputs"]["k3z"])]))

    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "datum_tpu"))
    if loaded:
        raise RuntimeError(f"chip_smoke imported the JAX side: {loaded[:5]}")

    # ---- 7. result lines (library_ms: no single PyTorch call computes
    # any of these kernels' functions).  launches: each kernel's count in
    # the bench frame's run (K6: in the two-phase bench frame's run);
    # stress_launches: per stress frame with early-z; the stress_* and
    # early_z_* fields time the kernel on the stress frame's inputs; lit_*:
    # the bench frame's second launch, on the lit layer; ptxas_*: the
    # source's registers and spill-store bytes.  An earlier design's time
    # is measured only with --versions (phase 7) and printed there
    t, sb = st["t"], st["b"]
    ptxas = lambda src: {f"ptxas_{k}": v for k, v in lib.ptxas(src).items()}

    def row(name, source, replaces, err, ms, plain_ms, b, n=None, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name] if n is None else n, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                    library_ms=None, stress_launches=st["launches"][name], **extra)

    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        row("raster_shade", "datum_tpu_torch/csrc/raster_shade.cu",
            "datum_tpu/ops/raster_pallas.py:343", max(k1_err, st["errs"]["k1"]), t_k1,
            t_k1p, k1_bound, stress_ms=t["k1"], stress_plain_ms=t["k1p"],
            stress_bound_ms=sb["k1"][0], early_z_ms=t["k1z"],
            early_z_bound_ms=sb["k1z"][0], lit_ms=t_k1l, lit_bound_ms=k1l_bound[0],
            lit_bound_by=k1l_bound[1], **ptxas("raster_shade.cu"),
            device_ms=dev_ms["k1"], lit_device_ms=dev_ms["k1l"],
            stress_device_ms=t["k1_dev"], early_z_device_ms=t["k1z_dev"],
            band_max_abs_err=mp["errs"]["k1"], sharded_launches=mp["launches"]["raster_shade"]),
        row("raster_shade_2p", "datum_tpu_torch/csrc/raster_shade_2p.cu",
            "datum_tpu/ops/raster_pallas.py:454", max(k6_err, st["errs"]["k6"]), t_k6,
            t_k6p, k1_bound, n=launches6["raster_shade_2p"], stress_ms=t["k6"],
            early_z_ms=t["k6z"], device_ms=dev_ms["k6"], stress_device_ms=t["k6_dev"],
            early_z_device_ms=t["k6z_dev"], lit_device_ms=dev_ms["k6l"],
            peeled_device_ms=dev_ms["k6p"], stress_bound_ms=sb["k1"][0],
            **ptxas("raster_shade_2p.cu"), band_max_abs_err=mp["errs"]["k6"],
            sharded_launches=mp["launches_2p"]["raster_shade_2p"]),
        row("shade_deferred", "datum_tpu_torch/csrc/shade.cu",
            "datum_tpu/ops/shade_pallas.py:161", k2_err, t_k2, t_k2p, k2_bound,
            **ptxas("shade.cu"),
            lit_ms=t_k2l, lit_plain_ms=t_k2lp, lit_bound_ms=k2l_bound[0],
            lit_bound_by=k2l_bound[1], lit_max_abs_err=k2_lit_err,
            device_ms=dev_ms["k2"], lit_device_ms=dev_ms["k2l"],
            clustered_device_ms=t["k2c_dev"], envd_device_ms=ep["t"]["k2e_dev"],
            clustered_ms=t["k2c"], clustered_plain_ms=t["k2cp"],
            clustered_bound_ms=sb["k2c"][0], clustered_max_abs_err=st["errs"]["k2c"],
            dense128_ms=t["k2d"], dense128_bound_ms=sb["k2d"][0],
            envd_ms=ep["t"]["k2e"], envd_max_abs_err=ep["errs"]["k2e"],
            envd_plain_ms=ep["t"]["k2ep"], envd_bound_ms=ep["b"]["k2e"][0],
            envd_without_group_ms=ep["t"]["k2n"], envd_coverage=ep["cover"],
            envd_launches=ep["launches"]["shade_deferred_envd"],
            band_max_abs_err=mp["errs"]["k2"], sharded_launches=mp["launches"]["shade_deferred"]),
        # the three stacks of one frame together
        row("raster_depth", "datum_tpu_torch/csrc/raster_depth.cu",
            "datum_tpu/ops/raster_pallas.py:730", max(*k3_errs, st["errs"]["k3"]),
            sum(t_k3), sum(t_k3p), k3_bound, **ptxas("raster_depth.cu"), device_ms=sum(dev_ms["k3"]),
            stack_device_ms=dev_ms["k3"], stress_device_ms=t["k3_dev"],
            early_z_device_ms=t["k3z_dev"], stress_ms=t["k3"],
            stress_plain_ms=t["k3p"], stress_bound_ms=sb["k3"][0],
            early_z_ms=t["k3z"], early_z_bound_ms=sb["k3z"][0]),
        # live_*: on the bench frame's merged stream with the datumtest
        # example's live particle system in place of the static cloud;
        # burst_max_abs_err: with the 8000-particle burst
        row("raster_blend", "datum_tpu_torch/csrc/raster_blend.cu",
            "datum_tpu/ops/raster_pallas.py:877",
            max(k4_err, *pp["errs"].values()), t_k4, t_k4p, k4_bound,
            **ptxas("raster_blend.cu"), device_ms=dev_ms["k4"],
            live_max_abs_err=pp["errs"]["live stream"],
            burst_max_abs_err=pp["errs"]["8000-particle burst"],
            live_launches=pp["launches_live"], live_ms=pp["t_k4"],
            live_plain_ms=pp["t_k4p"], live_bound_ms=pp["b_k4"][0],
            live_bound_by=pp["b_k4"][1], band_max_abs_err=mp["errs"]["k4"],
            sharded_launches=mp["launches"]["raster_blend"]),
        row("shade_epilogue", "datum_tpu_torch/csrc/shade_epilogue.cu",
            "datum_tpu/ops/shade_pallas.py:414", epi_err, t_ep, t_epp, ep_bound,
            device_ms=dev_ms["ep"], sharded_launches=mp["launches"]["shade_epilogue"]),
        # launches: per K5 (K7) frame of the deferred branch
        dict(name="raster_v1", route="cuda", source="datum_tpu_torch/csrc/raster_v1.cu",
             replaces="datum_tpu/ops/raster_pallas.py:58",
             launches=dp["launches"]["raster_v1"], max_abs_err=dp["errs"]["k5"],
             ms=dp["t"]["k5"], plain_ms=dp["t"]["k5p"], bound_ms=dp["b5"][0],
             bound_by=dp["b5"][1], library_ms=None, frame_ms=dp["ms"]["k5"],
             device_ms=dp["t"]["k5_dev"], **ptxas("raster_v1.cu"),
             stress_max_abs_err=st["errs"]["k5"], stress_ms=t["k5"],
             stress_plain_ms=t["k5p"], stress_device_ms=t["k5_dev"],
             stress_bound_ms=sb["k5"][0], stress_bound_by=sb["k5"][1]),
        dict(name="raster_mxu", route="cuda", source="datum_tpu_torch/csrc/raster_mxu.cu",
             replaces="datum_tpu/ops/raster_pallas.py:1098",
             launches=dp["launches"]["raster_mxu"], max_abs_err=dp["errs"]["k7"],
             ms=dp["t"]["k7"], plain_ms=dp["t"]["k7p"], bound_ms=dp["b7"][0],
             bound_by=dp["b7"][1], library_ms=None, tpu_product_bound_ms=dp["b7_tpu"],
             frame_ms=dp["ms"]["k7"], device_ms=dp["t"]["k7_dev"],
             **ptxas("raster_mxu.cu"), stress_max_abs_err=st["errs"]["k7"],
             stress_ms=t["k7"], stress_plain_ms=t["k7p"], stress_device_ms=t["k7_dev"],
             stress_bound_ms=sb["k7"][0], stress_bound_by=sb["k7"][1]),
        # launches: a frame runs no gather (the microbenchmark's kernel);
        # benchmark_launches: one counted gather_rows call
        dict(name="gather_rows", route="cuda",
             source="datum_tpu_torch/csrc/gather_rows.cu",
             replaces="profiling/prof_gather.py:164", launches=0,
             max_abs_err=ep["errs"]["gather"], ms=ep["t"]["gather"],
             plain_ms=ep["t"]["gather_plain"], bound_ms=ep["b"]["gather"][0],
             bound_by=ep["b"]["gather"][1], library_ms=ep["t"]["gather_lib"],
             benchmark_launches=ep["bench_launches"], device_ms=ep["t"]["gather_dev"],
             library_device_ms=ep["t"]["gather_lib_dev"]),
        # launches: per HUD frame; no Pallas counterpart (the JAX pass is an
        # XLA fori_loop); plain_launches: the plain pass's kernel launches
        dict(name="sprite_pass", route="cuda", source="datum_tpu_torch/csrc/sprite_pass.cu",
             replaces="datum_tpu/ops/sprite_pass.py:53", launches=op["launches"],
             max_abs_err=op["err"], ms=op["t"]["sp"], plain_ms=op["t"]["plain"],
             bound_ms=op["bound"][0], bound_by=op["bound"][1], library_ms=None,
             device_ms=op["t"]["sp_dev"], plain_launches=op["plain_launches"],
             instances=op["n_live"], **ptxas("sprite_pass.cu")),
        # launches: per K5 frame of the deferred branch; no Pallas
        # counterpart (the JAX package runs the pass in XLA); the bound
        # counts the frame's covered pixels (lighting_bound); band_*,
        # sharded_launches: a rank of the reduced sharded path
        dict(name="lighting", route="cuda", source="datum_tpu_torch/csrc/lighting.cu",
             replaces="datum_tpu/ops/lighting_pass.py:60",
             launches=dp["launches"]["lighting"], max_abs_err=dp["errs"]["lighting"],
             ms=dp["t"]["lt"], plain_ms=dp["t"]["ltp"], bound_ms=dp["blt"][0],
             bound_by=dp["blt"][1], library_ms=None, device_ms=dp["t"]["lt_dev"],
             bound_bytes=dp["blt"][2], covered_pixels=dp["blt"][3], **ptxas("lighting.cu"),
             band_max_abs_err=mp["errs"]["lighting"],
             sharded_launches=mp["reduced_kernel_launches"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and nvcc and skips without
one.  On the machine with the card (no jax there, so no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are chip_smoke.py's: K1 and K6 bit-identical to their plain
versions (and K6 to K1) on every plane and pixel, K1 also on full bins
of the stress and the bench depth (1024 + 128 and 160 + 64, early-z off
and on), on 136 tiles with a peel plane and one tile wide; K4
bit-identical in every soft mode with a peel plane, NaNs included
(elsewhere, as the K2 epilogue with its fog group, bit-identical on >=
99.99% of values, atol/rtol 1e-5 on the rest); ptxas at most 128
registers and no spill for K1, K4, K5, K6 and K7; K5, K6 and K7
bit-identical on full bins of the stress and the bench depth, on 136
tiles (K6 with a peel plane, early-z off and on) and one tile wide, K5
with y scissors and also at 2, 4 and 8 blocks a tile forced; K2 atol 1e-4 / rtol 1e-3 (CUDA's
and torch's sqrt and division differ by ulps); K3 bit-identical on >=
99.99% of texels, max abs error 1e-6.  Clustered K2 is held as K2; K1,
K6 and K3 with the early-z exit bit-identical to themselves without it
and to their plain versions.
K5 and K7 bit-identical to their plain versions on every plane, on the
small inputs of tests/test_torch_raster_v1.py, and K5, K7 and the
deferred frames (use_pallas=False, K5, K7) on the card against the CPU
plain path.  K2 with the box probes' edm group is held as K2; the row
gather is bit-identical to tab[idx]; the local-environment frames (the
box probe, SH probes and a fog plane on the megakernel and the K5
branch, and with the DDA SSR) on the card against the CPU plain path.
The animated vertex stage (no kernel of its own): skinning, the wind
bends (both forms) and the ocean (torch.fft maps, the slab of an Ocean
on the card) within atol/rtol 1e-5 of the CPU (the maps within 1e-5 of
their max |value|), and the vertex-modes frame on the card against the
CPU plain path (the patched pool bit for bit).  The pack pipeline: the
DeviceUploader's payloads land bit-equal to their host bytes on its side
stream and stay so while the default stream reads them behind a long
kernel and the uploader evicts them and re-uploads (allocator reuse);
the native LZ4 codec builds with the machine's g++ and agrees with the
Python codec both ways.  The frame graph: replayed megakernel frames
and deferred frames (the K5, K1 and K7 routes) bit-equal to eager frames
on the same inputs, K1, K2, K5 and K4 launched between the graphs into
preallocated outputs, no host sync in a replayed deferred frame, a new
capture for a new light count, the scan raster left eager."""

import dataclasses

import numpy as np
import pytest
import torch

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops.raster_cuda import (PLANE_NAMES, raster_inputs,
                                             raster_shade_2p_cuda,
                                             raster_shade_2p_reference,
                                             raster_shade_cuda,
                                             raster_shade_reference)
from datum_tpu_torch.ops import shadow as shadow_ops
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops.raster_blend_cuda import (blend_inputs,
                                                   raster_blend_cuda,
                                                   raster_blend_reference)
from datum_tpu_torch.ops.raster_depth_cuda import (depth_inputs,
                                                   raster_depth_cuda,
                                                   raster_depth_reference)
from datum_tpu_torch.ops.gather_cuda import gather_rows_cuda, gather_rows_reference
from datum_tpu_torch.ops.shade_cuda import (shade_deferred_cuda,
                                            shade_deferred_envd,
                                            shade_deferred_reference,
                                            shade_epilogue_cuda,
                                            shade_epilogue_reference,
                                            shade_inputs)
from datum_tpu_torch.math.matrix import perspective_proj
from datum_tpu_torch.ops.raster_mxu_cuda import (raster_mxu_cuda, raster_mxu_inputs,
                                                 raster_mxu_reference)
from datum_tpu_torch.ops.raster_v1_cuda import (raster_v1_cuda, raster_v1_inputs,
                                                raster_v1_reference)
from datum_tpu_torch.ops.sprite_pass import composite_sprites, composite_sprites_reference
from datum_tpu_torch.ops.sprite_pass_cuda import composite_sprites_cuda
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene, stress_scene

pytestmark = pytest.mark.cuda

SLICE = dict(width=512, height=256, sphere_detail=12, grid=(5, 3),
             n_point_lights=8, skybox=False, max_vertices=4096,
             max_triangles=4096, bin_capacity=320, big_capacity=32,
             bin_max_span=8, use_pallas=True, texture_filter="mip_half",
             enable_shadows=False)
SHADOWED = dict(SLICE, skybox=True, skybox_size=32, enable_shadows=True,
                shadow_res=512, shadow_far_res=256, shadow_slice_blend=0.25,
                max_spot_shadows=1, spot_shadow_res=256)
# the translucent frame: glass sphere, water patch, particles, decals;
# forward bins deep enough that nothing overflows
TRANSLUCENT = dict(SHADOWED, max_translucent_draws=2, max_translucent_tris=2048,
                   translucent_lit=True, translucent_lit_layers=2,
                   translucent_lit_scale=2, max_particle_quads=512,
                   max_decals_active=2, decal_textures=False,
                   forward_bin_capacity=512, forward_big_capacity=32)
# the bench frame: the translucent frame (one lit layer) with SSAO, fog
# (at a density: the scene's is 0) and SSR
BENCH = dict(TRANSLUCENT, translucent_lit_layers=1, enable_ssao=True,
             enable_fog=True, enable_ssr=True, fog_sample_scale=8)
FOG_DENSITY = (0.6, 0.65, 0.7, 0.04)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _frame(card, t=0.4, scene=SLICE):
    ctx, camera, params, make_rl = datumtest_scene(**scene)
    rl = make_rl(t)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    return ctx, ctx.device_state(card), ctx.frame_draws(rl, camera), ss


def _k1_inputs(card):
    ctx, state, draws, ss = _frame(card)
    cfg = ctx.config
    d, s = to_torch(draws, card), to_torch(ss, card)
    ex, uv, clip, wn, wt, _ = frame_mod._vertex_stage(cfg, state, d, s)
    setup, bins, counts, big_ids, _ = frame_mod._bin_stage(cfg, ex, clip)
    inp = raster_inputs(setup, bins, big_ids, counts, ex["tris"], uv, wn,
                        d["tri_mat"], state["materials"], cfg.tiles_x,
                        cfg.padded_width, cfg.padded_height, wt)
    return cfg, state, d, s, inp


def test_k1_kernel_matches_plain(card):
    """K1 on the opaque layer: every plane bit-identical to its plain
    version on every pixel."""
    *_, inp = _k1_inputs(card)
    k = raster_shade_cuda(**inp)
    r = raster_shade_reference(**inp)
    torch.cuda.synchronize()
    assert (k[1] >= 0).float().mean().item() > 0.2
    assert torch.equal(k, r)


def test_k2_kernel_matches_plain(card):
    cfg, state, d, s, inp = _k1_inputs(card)
    planes = dict(zip(PLANE_NAMES, raster_shade_cuda(**inp)))
    gpl, ss2, *_ = frame_mod._shade_inputs(cfg, planes, state, d, s,
                                           dict(sun=None, spot=None))
    g = torch.Generator(device="cpu").manual_seed(3)
    h, w = gpl["depth"].shape
    gpl["sky_r"], gpl["sky_g"], gpl["sky_b"] = (
        torch.rand((3, h, w), generator=g).to(card).unbind(0))
    ao = torch.rand((h, w), generator=g).to(card)
    spotsf = torch.rand((1, h, w), generator=g).to(card)
    k2 = shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"], ao=ao,
                      spotsf=spotsf)
    a = shade_deferred_cuda(**k2)
    b = shade_deferred_reference(**k2)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_frame_on_card_matches_cpu_plain(card):
    ctx, _, draws, ss = _frame(card)
    before = (raster_shade_cuda.launches, shade_deferred_cuda.launches)
    gpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device=card)
    after = (raster_shade_cuda.launches, shade_deferred_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1)
    cpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device="cpu")
    a = gpu["image"].cpu().float().numpy()
    b = cpu["image"].float().numpy()
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    assert int(gpu["bin_overflow"]) == int(cpu["bin_overflow"]) == 0


def test_k6_kernel_matches_plain_and_k1(card):
    """K6 on the opaque layer: every plane bit-identical to its plain
    version and to K1."""
    *_, inp = _k1_inputs(card)
    before = raster_shade_2p_cuda.launches
    k6 = raster_shade_2p_cuda(**inp)
    torch.cuda.synchronize()
    assert raster_shade_2p_cuda.launches == before + 1
    assert (k6[1] >= 0).float().mean().item() > 0.2
    assert torch.equal(k6, raster_shade_2p_reference(**inp))
    assert torch.equal(k6, raster_shade_cuda(**inp))


def test_k6_wrapper_refuses_bad_input(card):
    *_, inp = _k1_inputs(card)
    before = raster_shade_2p_cuda.launches
    for bad in (dict(inp, bins=inp["bins"].to(torch.int64)),
                dict(inp, rows=inp["rows"][:, :60].contiguous()),
                dict(inp, bins=inp["bins"].t()),
                dict(inp, peel=torch.zeros((8, 8), device=card)),
                {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in inp.items()}):
        with pytest.raises(ValueError):
            raster_shade_2p_cuda(**bad)
    assert raster_shade_2p_cuda.launches == before


def test_cuda_wrappers_raise_on_bad_input(card):
    *_, inp = _k1_inputs(card)
    bad = dict(inp, bins=inp["bins"].to(torch.int64))
    with pytest.raises(ValueError):
        raster_shade_cuda(**bad)


def _k3_inputs(card, stack):
    """K3 arguments of one of the shadowed frame's stacks on the card."""
    ctx, state, draws, ss = _frame(card, scene=SHADOWED)
    cfg = ctx.config
    d, s = to_torch(draws, card), to_torch(ss, card)
    ex, _, _, _, _, worldp = frame_mod._vertex_stage(cfg, state, d, s)
    if stack == "spot":
        sl = s["spotlights"]
        st = shadow_ops.spot_stack_parabolic(
            worldp, ex["tris"], sl["view"], sl["attenuation"][:, 3], 1,
            res=cfg.spot_shadow_res)
    else:
        st = shadow_ops.cascade_stacks(
            worldp, ex["tris"], s["mainlight"]["shadowview"], res=cfg.shadow_res,
            far_res=cfg.shadow_far_res)[stack == "far"]
    bins, counts, big = shadow_ops.bin_stack(st, cfg.shadow_bin_capacity,
                                             cfg.big_capacity)
    return depth_inputs(st["setup"], bins, big, counts, st["tiles_x"],
                        st["res"], st["height"])


@pytest.mark.parametrize("stack", ["near", "far", "spot"])
def test_k3_kernel_matches_plain(card, stack):
    inp = _k3_inputs(card, stack)
    before = raster_depth_cuda.launches
    k = raster_depth_cuda(**inp)
    r = raster_depth_reference(**inp)
    torch.cuda.synchronize()
    assert raster_depth_cuda.launches == before + 1
    assert (r > 0).float().mean().item() > 0.05
    assert (k == r).float().mean().item() >= 0.9999
    assert (k - r).abs().max().item() <= 1e-6


def test_k3_wrapper_refuses_cpu_tensors_and_bad_shapes(card):
    inp = _k3_inputs(card, "spot")
    for bad in (dict(inp, bins=inp["bins"].to(torch.int64)),
                dict(inp, rows=inp["rows"][:, :15].contiguous()),
                dict(inp, counts=inp["counts"][:-1].contiguous()),
                dict(inp, bins=inp["bins"].t()),
                {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in inp.items()}):
        with pytest.raises(ValueError):
            raster_depth_cuda(**bad)


def test_shadowed_frame_on_card_matches_cpu_plain(card):
    ctx, _, draws, ss = _frame(card, scene=SHADOWED)
    before = (raster_shade_cuda.launches, shade_deferred_cuda.launches,
              raster_depth_cuda.launches)
    gpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device=card)
    after = (raster_shade_cuda.launches, shade_deferred_cuda.launches,
             raster_depth_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 3)
    cpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device="cpu")
    a = gpu["image"].cpu().float().numpy()
    b = cpu["image"].float().numpy()
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    assert int(gpu["bin_overflow"]) == int(cpu["bin_overflow"]) == 0


def _translucent(card):
    """(cfg, state, draws, sceneset, translucent stream) of the
    translucent frame on the card."""
    ctx, state, draws, ss = _frame(card, scene=TRANSLUCENT)
    d, s = to_torch(draws, card), to_torch(ss, card)
    return ctx.config, state, d, s, frame_mod.translucent_stream(state, d, s)


def _assert_same(k, r, what):
    """Bit-identical on >= 99.99% of values, atol/rtol 1e-5 on the rest."""
    assert torch.isfinite(k).all(), what
    assert (k == r).float().mean().item() >= 0.9999, what
    torch.testing.assert_close(k, r, atol=1e-5, rtol=1e-5)


def test_k1_lit_layer_with_peel_matches_plain(card):
    """K1 on the lit layer: alpha_in_alb, then peeled behind layer 1; K1
    and K6 bit-identical to their plain versions, and K6 to K1, on both
    layers."""
    cfg, state, d, s, ts = _translucent(card)
    setup, tx, ty, w_t, h_t = frame_mod.lit_setup(cfg, ts)
    bins, counts, big = raster_ops.bin_triangles(
        setup, cfg.max_translucent_tris, tx, ty, cfg.forward_bin_capacity,
        cfg.forward_big_capacity)
    peel = None
    for layer in range(2):
        inp = raster_inputs(setup, bins, big, counts, ts["d"]["tris"], ts["uv"],
                            ts["wn"], ts["d"]["tri_mat"], state["materials"], tx,
                            w_t, h_t, ts["wt"], alpha_in_alb=True, peel_depth=peel)
        k = raster_shade_cuda(**inp)
        r = raster_shade_reference(**inp)
        torch.cuda.synchronize()
        assert (k[1] >= 0).any(), layer
        assert torch.equal(k, r), layer
        k6 = raster_shade_2p_cuda(**inp)
        assert torch.equal(k6, raster_shade_2p_reference(**inp)), layer
        assert torch.equal(k6, k), layer
        peel = r[0]


def test_k4_kernel_matches_plain(card):
    """K4 on the merged stream: particles (soft) and the translucent
    residual peeled behind the second lit layer."""
    cfg, state, d, s, ts = _translucent(card)
    peel = torch.rand((cfg.padded_height, cfg.padded_width), device=card) * 0.5
    st = frame_mod.oit_stream(cfg, state, d, s, ts, peel)
    assert st["nstreams"] == 2 and st["peel_flag"].sum() > 0
    bins, counts, big, overflow = frame_mod.oit_bins(cfg, st, return_overflow=True)
    assert int(overflow) == 0
    opaque = torch.rand_like(peel) * 0.05
    inp = blend_inputs(st["setup"], bins, big, counts, st["tris"], st["uv"],
                       st["color"], opaque, cfg.tiles_x, cfg.padded_width,
                       cfg.padded_height, "per_tri", peel, st["soft_flag"],
                       st["peel_flag"])
    before = raster_blend_cuda.launches
    k = raster_blend_cuda(**inp)
    r = raster_blend_reference(**inp)
    torch.cuda.synchronize()
    assert raster_blend_cuda.launches == before + 1
    assert (r[3] > 0).float().mean().item() > 0.01
    _assert_same(k, r, "K4")
    for soft in (True, False):
        _assert_same(raster_blend_cuda(**dict(inp, soft=soft)),
                     raster_blend_reference(**dict(inp, soft=soft)), soft)


def _epilogue_inputs(card, h=64, w=256):
    g = torch.Generator(device="cpu").manual_seed(7)
    rnd = lambda *shape: torch.rand(shape, generator=g)
    cover = torch.zeros((h, w))
    cover[8:56, 32:224] = 1.0
    tr = torch.cat([rnd(3, h, w) * 2, (rnd(1, h, w) * 0.8 + 0.1) * cover])
    refr = torch.stack([(rnd(h, w) * 18 - 9) * cover, (rnd(h, w) * 8 - 4) * cover])
    oit = torch.cat([rnd(3, h, w) * 3, rnd(1, h, w) * 2, rnd(1, h, w) * 0.8 + 0.2])
    fog = torch.cat([rnd(3, h, w) * 0.4, rnd(1, h, w) * 0.7 + 0.3])
    bf = lambda x: x.to(torch.bfloat16).to(card).contiguous()
    return dict(bg=(rnd(3, h, w) * 4).to(card), tr=bf(tr), refr=bf(refr),
                fog=bf(fog), oit=bf(oit))


def test_epilogue_kernel_matches_plain(card):
    """Every group combination the frames give, the fog group among them
    (with and without refraction: the resolve's two fma forms)."""
    inp = _epilogue_inputs(card)
    before = shade_epilogue_cuda.launches
    drops = ((), ("refr",), ("tr", "refr"), ("oit",), ("fog",), ("refr", "fog"),
             ("tr", "refr", "oit"), ("tr", "refr", "fog"))
    for drop in drops:
        kw = {k: (None if k in drop else v) for k, v in inp.items()}
        _assert_same(shade_epilogue_cuda(**kw), shade_epilogue_reference(**kw),
                     drop)
    assert shade_epilogue_cuda.launches == before + len(drops)


def test_k4_and_epilogue_wrappers_refuse_cpu_tensors_and_bad_shapes(card):
    cfg, state, d, s, ts = _translucent(card)
    st = frame_mod.oit_stream(cfg, state, d, s, ts, None)
    bins, counts, big = frame_mod.oit_bins(cfg, st)
    inp = blend_inputs(st["setup"], bins, big, counts, st["tris"], st["uv"],
                       st["color"], torch.zeros((cfg.padded_height, cfg.padded_width),
                                                device=card),
                       cfg.tiles_x, cfg.padded_width, cfg.padded_height, "per_tri",
                       None, st["soft_flag"], st["peel_flag"])
    for bad in (dict(inp, bins=inp["bins"].to(torch.int64)),
                dict(inp, rows=inp["rows"][:, :35].contiguous()),
                dict(inp, opaque_depth=inp["opaque_depth"][:-1]),
                dict(inp, peel=inp["opaque_depth"].t()),
                {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in inp.items()}):
        with pytest.raises(ValueError):
            raster_blend_cuda(**bad)
    e = _epilogue_inputs(card)
    for bad in (dict(e, tr=e["tr"].float()), dict(e, oit=e["oit"][:4]),
                dict(e, bg=e["bg"][:, :48]), dict(e, fog=e["fog"][:3]),
                {k: v.cpu() for k, v in e.items()}):
        with pytest.raises(ValueError):
            shade_epilogue_cuda(**bad)


def test_translucent_frame_on_card_matches_cpu_plain(card):
    ctx, _, draws, ss = _frame(card, scene=TRANSLUCENT)
    kernels = (raster_shade_cuda, shade_deferred_cuda, raster_depth_cuda,
               raster_blend_cuda, shade_epilogue_cuda)
    before = [k.launches for k in kernels]
    gpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device=card)
    # K1 and K2 on the opaque and the two lit layers, K3 on 3 stacks
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 3, 3, 1, 1]
    cpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device="cpu")
    a = gpu["image"].cpu().float().numpy()
    b = cpu["image"].float().numpy()
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    assert int(gpu["bin_overflow"]) == int(cpu["bin_overflow"]) == 0


@pytest.mark.parametrize("two_phase", [False, True], ids=["K1", "K6"])
def test_bench_frame_on_card_matches_cpu_plain(card, two_phase):
    """The bench frame (SSAO, fog at a density, SSR) on the card against
    the plain path on the CPU, with K1 and with K6: the kernels launch as
    the frame needs them (K1 or K6 on the opaque and the lit layer)."""
    ctx, camera, params, make_rl = datumtest_scene(**dict(BENCH,
                                                          raster_two_phase=two_phase))
    params.fogdensity = np.float32(FOG_DENSITY)
    rl = make_rl(0.4)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    draws = ctx.frame_draws(rl, camera)
    kernels = (raster_shade_cuda, raster_shade_2p_cuda, shade_deferred_cuda,
               raster_depth_cuda, raster_blend_cuda, shade_epilogue_cuda)
    before = [k.launches for k in kernels]
    gpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device=card)
    raster = [0, 2] if two_phase else [2, 0]
    assert [k.launches - b for k, b in zip(kernels, before)] == raster + [2, 3, 1, 1]
    cpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                 device="cpu")
    a = gpu["image"].cpu().float().numpy()
    b = cpu["image"].float().numpy()
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    assert int(gpu["bin_overflow"]) == int(cpu["bin_overflow"]) == 0
    torch.testing.assert_close(gpu["ao_prev"]["ao"].cpu(), cpu["ao_prev"]["ao"],
                               atol=1e-3, rtol=0)


def test_k2_clustered_kernel_matches_plain(card):
    """K2 with the frame's clustered light lists (8 lights, lists of 4:
    some cells truncate) against its plain version."""
    cfg, state, d, s, inp = _k1_inputs(card)
    planes = dict(zip(PLANE_NAMES, raster_shade_cuda(**inp)))
    gpl, ss2, *_ = frame_mod._shade_inputs(cfg, planes, state, d, s,
                                           dict(sun=None, spot=None))
    ccfg = dataclasses.replace(cfg, use_light_clusters=True, tile_light_capacity=4)
    clusters = frame_mod.light_clusters(ccfg, planes["depth"], s)
    assert clusters[1].max() > 0
    k2 = shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"],
                      clusters=clusters)
    before = shade_deferred_cuda.launches
    a = shade_deferred_cuda(**k2)
    b = shade_deferred_reference(**k2)
    torch.cuda.synchronize()
    assert shade_deferred_cuda.launches == before + 1
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
    dense = shade_deferred_cuda(**shade_inputs(gpl, ss2, proj=s["proj"],
                                               invview=s["invview"]))
    assert not torch.equal(a, dense)


def _quad_stack(card, seed=0):
    """A depth-complex stack: 24 nearly full-screen quads from depth 0.9
    (near, reverse-Z) down to 0.1, pushed near-first, and random
    triangles behind them; setup, near-first bins and K1's rows."""
    rng = np.random.RandomState(seed)
    pts, tris = [], []
    for i in range(24):
        z, sz = 0.9 - 0.8 * i / 23, 1.2 - 0.01 * i
        b = len(pts)
        pts += [[-sz, -sz, z, 1], [sz, -sz, z, 1], [-sz, sz, z, 1], [sz, sz, z, 1]]
        tris += [[b, b + 1, b + 2], [b + 2, b + 1, b + 3]]
    extra = rng.randn(30, 3)
    for t in rng.randint(0, 30, (20, 3)):
        if len(set(t.tolist())) == 3:
            b = len(pts)
            pts += [[extra[j, 0], extra[j, 1], 0.05, 1.0] for j in t]
            tris.append([b, b + 1, b + 2])
    clip = torch.tensor(pts, dtype=torch.float32, device=card)
    tris = torch.tensor(tris, dtype=torch.int32, device=card)
    T, V = tris.shape[0], clip.shape[0]
    tx, ty, w, h = 4, 8, 512, 256
    setup = raster_ops.triangle_setup(clip, tris, w, h, tx, ty)
    bins, counts, big = raster_ops.bin_triangles(setup, T, tx, ty, 64, 16,
                                                 depth_prio=setup["zbound"])
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=g).to(card)
    materials = dict(packed10=rnd(4, 12), color=rnd(4, 4))
    k1 = raster_inputs(setup, bins, big, counts, tris, rnd(V, 2), rnd(V, 3),
                       torch.randint(0, 4, (T,), generator=g).to(card), materials,
                       tx, w, h, rnd(V, 4), early_z=True)
    k3 = depth_inputs(setup, bins, big, counts, tx, w, h, early_z=True)
    return k1, k3


def test_early_z_kernels_bit_identical(card):
    """K1, K6 and K3 with the early-z exit against themselves without it
    and against their plain versions, on the quad stack: every plane and
    texel bit-identical, and the exit ends walks (the near quads hide the
    rest)."""
    k1, k3 = _quad_stack(card)
    no_z = dict(k1, szb=None)
    for run, ref in ((raster_shade_cuda, raster_shade_reference),
                     (raster_shade_2p_cuda, raster_shade_2p_reference)):
        a, b, r = run(**k1), run(**no_z), ref(**no_z)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a, r), run.__name__
        assert (a[1] >= 0).float().mean().item() > 0.9
    a, b = raster_depth_cuda(**k3), raster_depth_cuda(**dict(k3, szb=None))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, raster_depth_reference(**k3))
    # slots a tile's final min depth already reaches: the walk ends there
    tmin = raster_ops.tile_image(a, 4, 8).amin((1, 2))
    assert ((k1["szb"] <= tmin[:, None]) & (k1["szb"] > 0)).any()


def test_stress_frame_on_card_matches_cpu_plain(card):
    """The small stress frame (geomorphed terrain, 16 clustered lights,
    early-z on K1 and K3) on the card against the CPU plain path."""
    kw = dict(width=256, height=128, terrain_n=24, sphere_detail=8, grid=(3, 2),
              n_point_lights=16, skybox_size=16, max_vertices=2048,
              max_triangles=2048, tile_light_capacity=8, raster_early_z=True,
              shadow_res=128, shadow_bin_capacity=1024, bin_capacity=512,
              big_capacity=16, bin_max_span=8, use_pallas=True,
              texture_filter="mip_half", shadow_factor_scale=4)
    ctx, camera, params, make_rl = stress_scene(**kw)
    rl = make_rl(0.3)
    rl.draws[0]["morph"] = np.float32([18.0, 80.0])    # no cell collapses
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    draws = ctx.frame_draws(rl, camera)
    before = (raster_shade_cuda.launches, shade_deferred_cuda.launches,
              raster_depth_cuda.launches)
    gpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss, device=card)
    after = (raster_shade_cuda.launches, shade_deferred_cuda.launches,
             raster_depth_cuda.launches)
    assert after == tuple(n + 1 for n in before)
    cpu = frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss, device="cpu")
    a = gpu["image"].cpu().float().numpy()
    b = cpu["image"].float().numpy()
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    assert int(gpu["bin_overflow"]) == int(cpu["bin_overflow"]) == 0


def _mesh(seed, n_v, n_t, w, h, spread=2.0, n_behind=3):
    """tests/test_torch_raster_v1.py's perspective mesh: overlapping
    triangles, with eye-plane crossings (the big list)."""
    rng = np.random.RandomState(seed)
    proj = perspective_proj(np.radians(70), w / h, 0.1)
    pts = rng.randn(n_v, 3).astype(np.float32) * spread
    pts[:, 2] -= 6
    pts[:n_behind, 2] = 3.0
    hp = np.concatenate([pts, np.ones((n_v, 1), np.float32)], 1)
    clip = (hp @ proj.T).astype(np.float32)
    tris = rng.randint(0, n_v, (n_t, 3)).astype(np.int32)
    tris[:n_behind, 0] = np.arange(n_behind)
    return clip, tris, rng


@pytest.mark.parametrize("scissor", [False, True], ids=["open", "ylim"])
def test_k5_kernel_matches_plain(card, scissor):
    w, h, tx, ty = 256, 128, 2, 4
    clip, tris, _ = _mesh(4, 80, 140, w, h)
    ylim = None
    if scissor:
        lo = np.where(np.arange(tris.shape[0]) % 2 == 0, -1.0, -0.3).astype(np.float32)
        ylim = (torch.from_numpy(lo).to(card), torch.from_numpy(lo + 0.9).to(card))
    setup = raster_ops.triangle_setup(torch.from_numpy(clip).to(card),
                                      torch.from_numpy(tris).to(card), w, h, tx, ty,
                                      max_span=4, ylim=ylim)
    bins, counts, big = raster_ops.bin_triangles(setup, tris.shape[0], tx, ty, 64, 8,
                                                 max_span=4)
    inp = raster_v1_inputs(setup, bins, big, counts, tx, w, h)
    k = raster_v1_cuda(**inp)
    r = raster_v1_reference(**inp)
    torch.cuda.synchronize()
    assert (k[1] >= 0).float().mean().item() > 0.2
    assert torch.equal(k, r)


def _random_k5(card, seed, n_tris, w, h, cap, big_cap, size=0.08, spread=1.0):
    """K5 inputs of _random_setup's triangles with y scissors in 7 bands,
    binned at cap + big_cap.  Returns (inputs, counts)."""
    tx, ty = w // 128, h // 32
    setup, _ = _random_setup(card, seed, n_tris, w, h, size, 7, spread)
    bins, counts, big = raster_ops.bin_triangles(setup, n_tris, tx, ty, cap, big_cap)
    return raster_v1_inputs(setup, bins, big, counts, tx, w, h), counts


def _k5_bit_identical(inp, splits=(None,)):
    """K5 at each split (None: the launcher's rule) against its plain
    version on all 4 planes; returns the covered share."""
    before = raster_v1_cuda.launches
    r = raster_v1_reference(**inp)
    for split in splits:
        assert torch.equal(raster_v1_cuda(**inp, split=split), r), split
    torch.cuda.synchronize()
    assert raster_v1_cuda.launches == before + len(splits)
    return (r[1] >= 0).float().mean().item()


@pytest.mark.parametrize("cap", [(1024, 128), (160, 64)], ids=["deep", "shallow"])
def test_k5_full_bins_bit_identical(card, cap):
    """Full bins (every bin slot valid) on a frame of 510 tiles: the
    stress frame's bin depth (1024 + 128: 4 blocks a tile) and the bench
    frame's (160 + 64: 2 blocks a tile), with y scissors in the rows (a
    seventh of the rows each: the shallow bins cover ~2% of the frame)."""
    inp, counts = _random_k5(card, 25, 60000, 1920, 1088, *cap, size=0.02, spread=0.3)
    assert inp["bins"].shape[0] == 510 and int((counts == cap[0]).sum()) >= 2
    assert _k5_bit_identical(inp) > 0.01


@pytest.mark.parametrize("size", [(1024, 544), (128, 256)], ids=["136-tiles", "one-wide"])
def test_k5_small_frames_bit_identical(card, size):
    """136 tiles, fewer than twice the SMs (4 blocks a tile), and a frame
    one tile wide."""
    w, h = size
    inp, counts = _random_k5(card, 26, 4000 if w > 128 else 600, w, h, 128, 16,
                             size=0.1)
    assert int(counts.max()) > 64
    assert _k5_bit_identical(inp) > 0.05


def test_k5_forced_splits_bit_identical(card):
    """2, 4 and 8 blocks a tile forced on the same inputs, each
    bit-identical to the plain version; a split the kernel lacks is
    refused before any launch."""
    inp, _ = _random_k5(card, 27, 6000, 1024, 544, 256, 32, size=0.1)
    assert _k5_bit_identical(inp, splits=(2, 4, 8)) > 0.05
    before = raster_v1_cuda.launches
    with pytest.raises(ValueError):
        raster_v1_cuda(**inp, split=3)
    assert raster_v1_cuda.launches == before


def test_k5_ptxas_no_spill(card):
    """ptxas: at most 128 registers (two blocks of 256 threads an SM), no
    spill."""
    from datum_tpu_torch.ops import _kernels

    rep = _kernels.library().ptxas("raster_v1.cu")
    assert rep["registers"] is not None and rep["registers"] <= 128, rep
    assert not rep["spill_bytes"], rep


def test_k7_kernel_matches_plain(card):
    """256x32, over 128 entries a tile, duplicated triangles (ties)."""
    w, h, tx, ty = 256, 32, 2, 1
    clip, tris, rng = _mesh(9, 400, 300, w, h, spread=1.2)
    tris[250:300] = tris[0:250:5]
    n_v, n_t, nm = clip.shape[0], tris.shape[0], 6
    uv = torch.from_numpy(rng.rand(n_v, 2).astype(np.float32)).to(card)
    nrm = torch.from_numpy(rng.randn(n_v, 3).astype(np.float32)).to(card)
    mats = {k: torch.from_numpy(v).to(card) for k, v in dict(
        color=rng.rand(nm, 4).astype(np.float32),
        emissive=rng.rand(nm).astype(np.float32),
        metalness=rng.rand(nm).astype(np.float32),
        roughness=rng.rand(nm).astype(np.float32),
        reflectivity=rng.rand(nm).astype(np.float32),
        albedomap=rng.randint(0, 5, nm).astype(np.int32)).items()}
    tri_mat = torch.from_numpy(rng.randint(0, nm, n_t).astype(np.int32)).to(card)
    t_tris = torch.from_numpy(tris).to(card)
    setup = raster_ops.triangle_setup(torch.from_numpy(clip).to(card), t_tris, w, h,
                                      tx, ty, max_span=2)
    bins, counts, big = raster_ops.bin_triangles(setup, n_t, tx, ty, 256, 8, max_span=2)
    assert int(counts.min()) + 8 > 128
    inp = raster_mxu_inputs(setup, bins, big, counts, t_tris, uv, nrm, tri_mat, mats,
                            tx, w, h)
    k = raster_mxu_cuda(**inp)
    r = raster_mxu_reference(**inp)
    torch.cuda.synchronize()
    assert (k[1] >= 0).float().mean().item() > 0.3
    assert torch.equal(k, r)


def test_k5_k7_wrappers_refuse_bad_input(card):
    w, h, tx, ty = 256, 128, 2, 4
    clip, tris, _ = _mesh(5, 60, 90, w, h)
    setup = raster_ops.triangle_setup(torch.from_numpy(clip).to(card),
                                      torch.from_numpy(tris).to(card), w, h, tx, ty)
    bins, counts, big = raster_ops.bin_triangles(setup, tris.shape[0], tx, ty, 32, 8)
    inp = raster_v1_inputs(setup, bins, big, counts, tx, w, h)
    before = raster_v1_cuda.launches
    with pytest.raises(ValueError):
        raster_v1_cuda(**dict(inp, bins=inp["bins"].to(torch.int64)))
    with pytest.raises(ValueError):
        raster_v1_cuda(**{k: (v.cpu() if torch.is_tensor(v) else v)
                          for k, v in inp.items()})
    assert raster_v1_cuda.launches == before


# the deferred frames: entry()'s config (use_pallas=False, nearest, ESM),
# the K5 frame (bilinear, material maps, translucents, particles, decals,
# SSAO, fog, a perspective spot map, SSR) and the K7 frame
DEFERRED = dict(width=256, height=128, sphere_detail=8, grid=(4, 3), n_point_lights=4,
                max_vertices=4096, max_triangles=4096, bin_capacity=512,
                big_capacity=32, shadow_res=256, shadow_bin_capacity=1024)
K5_FRAME = dict(DEFERRED, use_pallas=True, texture_filter="bilinear",
                max_translucent_draws=2, max_translucent_tris=2048,
                max_particle_quads=512, max_decals_active=2, enable_ssao=True,
                enable_fog=True, enable_ssr=True, max_spot_shadows=1,
                spot_shadow_mode="perspective", spot_shadow_res=128,
                forward_bin_capacity=256, forward_big_capacity=16)
K7_FRAME = dict(DEFERRED, height=64, use_pallas=True, raster_kernel="mxu",
                enable_material_maps=False, enable_shadows=False)


@pytest.mark.parametrize("scene", [DEFERRED, dict(DEFERRED, shadow_mode="pcf"),
                                   K5_FRAME, K7_FRAME],
                         ids=["entry", "pcf", "K5", "K7"])
def test_deferred_frame_on_card_matches_cpu_plain(card, scene):
    ctx, state, draws, ss = _frame(card, scene=scene)
    cfg = ctx.config
    if cfg.enable_fog:
        ss["camera"]["fogdensity"] = np.float32(FOG_DENSITY)
    n = raster_v1_cuda.launches, raster_mxu_cuda.launches
    a = frame_mod.render_frame(cfg, state, draws, ss, device=card)
    torch.cuda.synchronize()
    n = raster_v1_cuda.launches - n[0], raster_mxu_cuda.launches - n[1]
    assert n == (int(scene is K5_FRAME), int(scene is K7_FRAME))
    b = frame_mod.render_frame(cfg, ctx.host_state(), draws, ss, device="cpu")
    ia = a["image"].cpu().numpy().astype(np.float32)
    ib = b["image"].numpy().astype(np.float32)
    assert ib.mean() > 10
    assert np.abs(ia - ib).mean() <= 0.5
    assert np.sqrt(((ia - ib) ** 2).mean()) <= 2.0
    assert (a["vis"].cpu() == b["vis"]).float().mean().item() >= 0.999


# the local-environment frame: the box probe around the sphere grid, 4 SH
# probes and a fog plane (datumtest_scene(local_env=True))
LOCAL_ENV = dict(SLICE, skybox=True, skybox_size=16, local_env=True, max_fog_planes=1)


def test_k2_edm_kernel_matches_plain(card):
    """K2 with the edm group on the probe frame's planes (a band of edm
    set to exactly 0.5, which keeps the SH-9 term), as K2 is held; the
    envd count moves by one."""
    ctx, state, draws, ss = _frame(card, scene=LOCAL_ENV)
    cfg = ctx.config
    d, s = to_torch(draws, card), to_torch(ss, card)
    ex, uv, clip, wn, wt, _ = frame_mod._vertex_stage(cfg, state, d, s)
    planes, _ = frame_mod._raster_stage(cfg, state, d, ex, uv, clip, wn, wt)
    gpl, ss2, *_ = frame_mod._shade_inputs(cfg, planes, state, d, s,
                                           dict(sun=None, spot=None))
    assert (gpl["edm"] > 0.5).float().mean().item() > 0.01
    gpl["edm"][:, :64] = 0.5
    k2 = shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"])
    assert k2["envd"] and int(k2["counts"][3]) == 4
    n = shade_deferred_envd.launches, shade_deferred_cuda.launches
    a = shade_deferred_cuda(**k2)
    assert (shade_deferred_envd.launches, shade_deferred_cuda.launches) == (n[0] + 1,
                                                                            n[1] + 1)
    b = shade_deferred_reference(**k2)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_gather_kernel_matches_tab_idx(card):
    """The row gather bit-identical to tab[idx] on the microbenchmark's
    shapes and on a small table; its checks refuse bad input."""
    g = torch.Generator(device="cpu").manual_seed(0)
    for rows, cols, n in ((16384, 16, 524288), (1000, 8, 777), (5, 4, 0)):
        tab = torch.rand((rows, cols), generator=g).to(card)
        idx = torch.randint(0, rows, (n,), generator=g).to(torch.int32).to(card)
        before = gather_rows_cuda.launches
        out = gather_rows_cuda(tab, idx, check_bounds=True)
        torch.cuda.synchronize()
        assert gather_rows_cuda.launches == before + 1
        assert torch.equal(out, gather_rows_reference(tab, idx))
        assert torch.equal(out, tab[idx.long()])
    tab = torch.rand((64, 16), device=card)
    with pytest.raises(IndexError):
        gather_rows_cuda(tab, torch.tensor([3, 64], dtype=torch.int32, device=card),
                         check_bounds=True)
    with pytest.raises(IndexError):
        gather_rows_cuda(tab, torch.tensor([-1], dtype=torch.int32, device=card),
                         check_bounds=True)
    with pytest.raises(ValueError):
        gather_rows_cuda(tab, torch.tensor([3], device=card))            # int64
    with pytest.raises(ValueError):
        gather_rows_cuda(torch.rand((64, 6), device=card),
                         torch.tensor([3], dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        gather_rows_cuda(tab.cpu(), torch.tensor([3], dtype=torch.int32))


@pytest.mark.parametrize("extra", [{}, dict(texture_filter="bilinear"),
                                   dict(enable_ssr=True, ssr_mode="dda")],
                         ids=["megakernel", "K5", "dda"])
def test_local_env_frame_on_card_matches_cpu_plain(card, extra):
    """The local-environment frame on the card against the CPU plain path:
    K2 launches once with the edm group on the megakernel branch, never
    on the K5 branch (the probes go through the XLA lighting)."""
    ctx, state, draws, ss = _frame(card, scene=dict(LOCAL_ENV, **extra))
    cfg = ctx.config
    n = shade_deferred_envd.launches, raster_v1_cuda.launches
    a = frame_mod.render_frame(cfg, state, draws, ss, device=card)
    torch.cuda.synchronize()
    n = shade_deferred_envd.launches - n[0], raster_v1_cuda.launches - n[1]
    k5 = cfg.texture_filter == "bilinear"
    assert n == (int(not k5), int(k5))
    b = frame_mod.render_frame(cfg, ctx.host_state(), draws, ss, device="cpu")
    ia = a["image"].cpu().numpy().astype(np.float32)
    ib = b["image"].numpy().astype(np.float32)
    assert ib.mean() > 10
    assert np.abs(ia - ib).mean() <= 0.5
    assert np.sqrt(((ia - ib) ** 2).mean()) <= 2.0
    assert int(a["bin_overflow"]) == int(b["bin_overflow"]) == 0


# ---- K3's cluster split and warp-rectangle reject, K2's two-pixel
# persistent layout: the shapes where they could go wrong

def _random_clip(seed, n_tris, size=0.08, spread=1.0):
    """Clip vertices (3 * n_tris, 4) f32 of n_tris small random triangles
    (clip w = 1, and a tenth in perspective) centred in [-spread,
    spread]^2."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-spread, spread, (n_tris, 1, 2)).astype(np.float32)
    xy = c + rng.uniform(-size, size, (n_tris, 3, 2)).astype(np.float32)
    z = rng.uniform(0.05, 0.95, (n_tris, 3, 1)).astype(np.float32)
    wv = np.where(rng.rand(n_tris, 1, 1) < 0.1,
                  rng.uniform(0.5, 2.0, (n_tris, 3, 1)), 1.0).astype(np.float32)
    return np.concatenate([xy * wv, z * wv, wv], -1).reshape(-1, 4)


def _random_setup(card, seed, n_tris, w, h, size=0.08, bands=0, spread=1.0):
    """The setup of _random_clip's triangles on a w x h viewport; with
    bands > 0 each triangle carries the y scissor of one of that many
    bands.  Returns (setup, tris)."""
    clip = _random_clip(seed, n_tris, size, spread)
    tris = torch.arange(3 * n_tris, dtype=torch.int32, device=card).reshape(-1, 3)
    ylim = None
    if bands:
        band = torch.arange(n_tris, device=card) % bands
        lo = -1.0 + band.to(torch.float32) * (2.0 / bands)
        ylim = (lo, lo + 2.0 / bands)
    setup = raster_ops.triangle_setup(torch.from_numpy(clip).to(card), tris, w, h,
                                      w // 128, h // 32, ylim=ylim)
    return setup, tris


def _random_stack(card, seed, n_tris, w, h, cap, big_cap, size=0.08, bands=0,
                  spread=1.0):
    """K3 inputs of _random_setup's triangles binned at cap + big_cap.
    Returns (inputs, inputs with early-z, counts)."""
    tx, ty = w // 128, h // 32
    setup, _ = _random_setup(card, seed, n_tris, w, h, size, bands, spread)
    bins, counts, big = raster_ops.bin_triangles(setup, n_tris, tx, ty, cap, big_cap)
    return (depth_inputs(setup, bins, big, counts, tx, w, h),
            depth_inputs(setup, bins, big, counts, tx, w, h, early_z=True), counts)


def _k3_bit_identical(inp, inpz):
    before = raster_depth_cuda.launches
    k, kz, r = raster_depth_cuda(**inp), raster_depth_cuda(**inpz), raster_depth_reference(**inp)
    torch.cuda.synchronize()
    assert raster_depth_cuda.launches == before + 2
    assert (r > 0).float().mean().item() > 0.05
    assert torch.equal(k, r) and torch.equal(kz, r)


@pytest.mark.parametrize("size", [(256, 64), (1024, 2048)], ids=["4-tiles", "512-tiles"])
def test_k3_full_bins_bit_identical(card, size):
    """Tiles whose bins hold their full 128 entries (the bench cascades'
    busiest tiles): every 8th slot to each block of the cluster (every
    4th on a stack of 512 tiles, twice the SMs), the blocks' partial maps
    combined by the max; early-z off and on."""
    w, h = size
    inp, inpz, counts = _random_stack(card, 11, 900 if w == 256 else 8000, w, h, 128,
                                      64, spread=1.0 if w == 256 else 0.3)
    assert int((counts == 128).sum()) >= 2
    _k3_bit_identical(inp, inpz)


def test_k3_deep_bins_bit_identical(card):
    """The stress stack's bin depth (1024 + 128): each block walks ~144
    slots in three chunks; early-z off and on."""
    inp, inpz, counts = _random_stack(card, 12, 3000, 256, 64, 1024, 128, size=0.12)
    assert int(counts.max()) > 512
    _k3_bit_identical(inp, inpz)


def test_k3_one_tile_wide_stack_bit_identical(card):
    """A stack one tile wide (128 columns, 8 tiles tall) with a y scissor
    band a triangle, as a stacked atlas gives them."""
    inp, inpz, _ = _random_stack(card, 13, 400, 128, 256, 128, 16, size=0.2, bands=4)
    assert inp["tiles_x"] == 1
    _k3_bit_identical(inp, inpz)


def _k2_frame_inputs(card, scene, **kw):
    """K2's inputs of a frame's opaque layer (random sky planes, ao and a
    spot factor plane where kw asks for them)."""
    ctx, state, draws, ss = _frame(card, scene=scene)
    cfg = ctx.config
    d, s = to_torch(draws, card), to_torch(ss, card)
    ex, uv, clip, wn, wt, _ = frame_mod._vertex_stage(cfg, state, d, s)
    planes, _ = frame_mod._raster_stage(cfg, state, d, ex, uv, clip, wn, wt)
    gpl, ss2, *_ = frame_mod._shade_inputs(cfg, planes, state, d, s,
                                           dict(sun=None, spot=None))
    return cfg, planes, gpl, ss2, s


def _k2_matches_plain(k2):
    before = shade_deferred_cuda.launches
    a = shade_deferred_cuda(**k2)
    b = shade_deferred_reference(**k2)
    torch.cuda.synchronize()
    assert shade_deferred_cuda.launches == before + 1
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
    return a


def test_k2_at_the_lit_layer_size(card):
    """K2 at the bench lit layer's 1024x544: 34 bands x 8 sub-tiles x 4
    units of 4 rows x 128 columns, which the persistent grid's blocks,
    each taking every gridDim-th unit, do not share out evenly."""
    _, _, gpl, ss2, s = _k2_frame_inputs(card, dict(SLICE, width=1024, height=544))
    assert tuple(gpl["depth"].shape) == (544, 1024)
    _k2_matches_plain(shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"]))


@pytest.mark.parametrize("size", [(75, 300), (75, 301), (9, 2), (1, 1)],
                         ids=["75x300", "75x301-odd", "9x2", "1x1"])
def test_k2_off_its_pixel_footprint(card, size):
    """Sizes that are no multiple of K2's unit (4 rows x 128 columns, two
    pixels a thread), odd widths among them (scalar loads): random planes
    with the slice scene's lights, a sky, ao and a spot factor plane."""
    from datum_tpu_torch.ops.shade_cuda import BF16_NAMES, SKY_NAMES

    _, _, gpl0, ss2, s = _k2_frame_inputs(card, SLICE)
    h, w = size
    g = torch.Generator(device="cpu").manual_seed(h * 1000 + w)
    rnd = lambda lo, hi: (lo + (hi - lo) * torch.rand((h, w), generator=g)).to(card)
    gpl = {n: rnd(0.0, 1.0) for n in BF16_NAMES + SKY_NAMES}
    gpl.update(nx=rnd(-1, 1), ny=rnd(-1, 1), nz=rnd(-1, 1), depth=rnd(0.2, 0.99),
               visf=rnd(-0.5, 1.0))
    k2 = shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"], ao=rnd(0, 1),
                      spotsf=rnd(0, 1)[None])
    out = _k2_matches_plain(k2)
    assert tuple(out.shape) == (3, h, w)


def test_k2_counts_above_the_tables_rows(card):
    """Live counts above the light and spot tables' rows: the kernel adds
    the last row again for each count past it, as the plain version reads
    lights[min(i, L - 1)] and spots[min(m, S - 1)] (a spot factor plane
    on the first slot; a cutoff of -2 opens every cone)."""
    _, _, gpl, ss2, s = _k2_frame_inputs(card, SLICE)
    h, w = gpl["depth"].shape
    g = torch.Generator(device="cpu").manual_seed(5)
    k2 = shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"],
                      spotsf=torch.rand((1, h, w), generator=g).to(card))
    lights = k2["lights"][:3].contiguous()
    spots = torch.zeros((2, 16), dtype=torch.float32, device=card)
    spots[:, :10] = k2["lights"][3:5, :10]
    spots[:, 10:13] = torch.tensor([0.0, -1.0, 0.0])
    spots[:, 13] = -2.0
    counts = torch.tensor([8, 4, 0, int(k2["counts"][3])], dtype=torch.int32,
                          device=card)
    k2.update(lights=lights, spots=spots, counts=counts)
    _k2_matches_plain(k2)


def test_k2_edm_with_clusters(card):
    """The probe frame's planes with the edm group, 4 SH probes and the
    clustered lights' lists (lists of 4: some cells truncate)."""
    cfg, planes, gpl, ss2, s = _k2_frame_inputs(card, LOCAL_ENV)
    ccfg = dataclasses.replace(cfg, use_light_clusters=True, tile_light_capacity=4)
    clusters = frame_mod.light_clusters(ccfg, planes["depth"], s)
    assert clusters[1].max() > 0
    k2 = shade_inputs(gpl, ss2, proj=s["proj"], invview=s["invview"], clusters=clusters)
    assert k2["envd"] and int(k2["counts"][3]) == 4
    n = shade_deferred_envd.launches
    _k2_matches_plain(k2)
    assert shade_deferred_envd.launches == n + 1


# ---- K1's cluster split and edges-only reject, K4's two blocks a tile
# and its no-op reject: the shapes where they could go wrong

def _random_k1(card, seed, n_tris, w, h, cap, big_cap, size=0.08, bands=0,
               spread=1.0, peel=False):
    """K1 inputs of _random_setup's triangles (random attributes and
    materials; with bands, y scissors in row slots 14-15 that K1 must
    ignore; with peel, a random peel plane), binned at cap + big_cap, with
    early-z.  Returns (inputs with early-z, counts)."""
    tx, ty = w // 128, h // 32
    setup, tris = _random_setup(card, seed, n_tris, w, h, size, bands, spread)
    bins, counts, big = raster_ops.bin_triangles(setup, n_tris, tx, ty, cap, big_cap)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=g).to(card)
    V = 3 * n_tris
    inp = raster_inputs(setup, bins, big, counts, tris, rnd(V, 2), rnd(V, 3),
                        torch.randint(0, 4, (n_tris,), generator=g).to(card),
                        dict(packed10=rnd(4, 12), color=rnd(4, 4)), tx, w, h,
                        rnd(V, 4), peel_depth=rnd(h, w) * 0.9 + 0.1 if peel else None,
                        early_z=True)
    return inp, counts


def _k1_bit_identical(inp):
    """K1 with and without early-z against its plain version and K6 on
    every plane and pixel; returns the covered share."""
    before = raster_shade_cuda.launches
    kz = raster_shade_cuda(**inp)
    k = raster_shade_cuda(**dict(inp, szb=None))
    r = raster_shade_reference(**inp)
    k6 = raster_shade_2p_cuda(**inp)
    torch.cuda.synchronize()
    assert raster_shade_cuda.launches == before + 2
    assert torch.equal(k, r) and torch.equal(kz, r) and torch.equal(k6, r)
    return (r[1] >= 0).float().mean().item()


@pytest.mark.parametrize("cap", [(1024, 128), (160, 64)], ids=["deep", "shallow"])
def test_k1_full_bins_bit_identical(card, cap):
    """Full bins on a frame of 510 tiles: the stress frame's bin depth
    (1024 + 128: 4 blocks a tile) and the bench frame's (160 + 64: 2
    blocks a tile), early-z off and on; y scissors in the rows that K1
    does not apply."""
    inp, counts = _random_k1(card, 21, 60000, 1920, 1088, *cap, size=0.02, bands=7,
                             spread=0.3)
    assert inp["bins"].shape[0] == 510 and int((counts == cap[0]).sum()) >= 2
    assert _k1_bit_identical(inp) > 0.05


@pytest.mark.parametrize("size", [(1024, 544), (128, 256)], ids=["136-tiles", "one-wide"])
def test_k1_lit_layer_sizes_bit_identical(card, size):
    """The bench lit layer's 136 tiles (4 blocks a tile) with a peel
    plane, and a frame one tile wide."""
    w, h = size
    inp, counts = _random_k1(card, 22, 4000 if w > 128 else 600, w, h, 128, 16,
                             size=0.1, peel=True)
    assert int(counts.max()) > 64
    assert _k1_bit_identical(inp) > 0.05


def _same_bits(a, b):
    """Bit-identical, NaN where the other is NaN (the NaN's payload aside)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


@pytest.mark.parametrize("soft", [False, True, "per_tri"])
def test_k4_soft_modes_with_peel_bit_identical(card, soft):
    """K4 on _mesh's perspective triangles (eye-plane crossings: s crosses
    0 on screen) and small random ones, in each soft mode with a peel
    plane, and three entries, in tiles 5-7, whose invisible pixels' terms
    are NaN (l0 and l1 overflow, cr overflows, a NaN depth plane):
    bit-identical to the plain version, NaNs included."""
    w, h = 512, 256
    clip, tris, _ = _mesh(31, 60, 40, w, h)
    clip = np.concatenate([clip, _random_clip(31, 600, size=0.05)])
    tris = np.concatenate([tris, np.arange(len(clip) - 1800, len(clip),
                                           dtype=np.int32).reshape(-1, 3)])
    T, V = len(tris), len(clip)
    tris = torch.from_numpy(tris).to(card)
    setup = raster_ops.triangle_setup(torch.from_numpy(clip).to(card), tris, w, h, 4, 8)
    bins, counts, big = raster_ops.bin_triangles(setup, T, 4, 8, 256, 32)
    g = torch.Generator(device="cpu").manual_seed(31)
    rnd = lambda *shape: torch.rand(shape, generator=g).to(card)
    flag = lambda: (torch.rand(T, generator=g) < 0.5).to(card)
    inp = blend_inputs(setup, bins, big, counts, tris, rnd(V, 2), rnd(V, 4),
                       rnd(h, w) * 0.2, 4, w, h, soft, rnd(h, w) * 0.5 + 0.5, flag(),
                       flag())
    # entries whose edge 0 is below 0 everywhere, each in one tile's bin:
    # s = 1e-38 (l0, l1 overflow), red coefficients whose sum overflows,
    # a NaN depth coefficient (wk is NaN)
    bad = torch.zeros((3, 36), device=card)
    bad[:, 12], bad[:, 22:34], bad[:, 11] = 1.0, 0.5, 0.5
    bad[0, [2, 5, 8]] = torch.tensor([-100.0, 100.0, 1e-38], device=card)
    bad[1:, 2], bad[1:, 5], bad[1:, 8] = -1.0, 1.0, 1.0
    bad[1, 22], bad[1, 26], bad[2, 9] = -3e38, 3e38, float("nan")
    inp["rows"] = torch.cat([inp["rows"], bad]).contiguous()
    for i, tile in enumerate((5, 6, 7)):
        inp["bins"][tile, inp["counts"][tile]] = T + i
        inp["counts"][tile] += 1
    before = raster_blend_cuda.launches
    k = raster_blend_cuda(**inp)
    r = raster_blend_reference(**inp)
    torch.cuda.synchronize()
    assert raster_blend_cuda.launches == before + 1
    assert (r[3] > 0).float().mean().item() > 0.01
    nan = torch.isnan(r).any(0)
    assert nan.any() and nan.sum() <= 3 * 32 * 128
    assert _same_bits(k, r)


@pytest.mark.parametrize("src", ["raster_shade.cu", "raster_blend.cu"])
def test_k1_k4_ptxas_no_spill(card, src):
    """ptxas: at most 128 registers (two blocks of 256 threads an SM), no
    spill."""
    from datum_tpu_torch.ops import _kernels

    rep = _kernels.library().ptxas(src)
    assert rep["registers"] is not None and rep["registers"] <= 128, rep
    assert not rep["spill_bytes"], rep


# ---- K6's and K7's cluster split (K6: K1's walk, then its second phase per
# block; K7: the split in its own arithmetic, with its own reject)

def _random_k7(card, seed, n_tris, w, h, cap, big_cap, size=0.08, spread=1.0):
    """K7 inputs of _random_setup's triangles (random uv, normals and
    materials), binned at cap + big_cap.  Returns (inputs, counts)."""
    tx, ty = w // 128, h // 32
    setup, tris = _random_setup(card, seed, n_tris, w, h, size, 0, spread)
    bins, counts, big = raster_ops.bin_triangles(setup, n_tris, tx, ty, cap, big_cap)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=g).to(card)
    V, nm = 3 * n_tris, 5
    mats = dict(color=rnd(nm, 4), emissive=rnd(nm), metalness=rnd(nm),
                roughness=rnd(nm), reflectivity=rnd(nm),
                albedomap=torch.randint(0, 4, (nm,), generator=g).to(torch.int32).to(card))
    inp = raster_mxu_inputs(setup, bins, big, counts, tris, rnd(V, 2), rnd(V, 3) * 2 - 1,
                            torch.randint(0, nm, (n_tris,), generator=g).to(card), mats,
                            tx, w, h)
    return inp, counts


@pytest.mark.parametrize("cap", [(1024, 128), (160, 64)], ids=["deep", "shallow"])
def test_k7_full_bins_bit_identical(card, cap):
    """Full bins on a frame of 510 tiles: the stress frame's bin depth
    (1024 + 128: 4 blocks a tile) and the bench frame's (160 + 64: 2
    blocks a tile)."""
    inp, counts = _random_k7(card, 23, 60000, 1920, 1088, *cap, size=0.02, spread=0.3)
    assert inp["bins"].shape[0] == 510 and int((counts == cap[0]).sum()) >= 2
    before = raster_mxu_cuda.launches
    k = raster_mxu_cuda(**inp)
    r = raster_mxu_reference(**inp)
    torch.cuda.synchronize()
    assert raster_mxu_cuda.launches == before + 1
    assert (r[1] >= 0).float().mean().item() > 0.05
    assert torch.equal(k, r)


@pytest.mark.parametrize("size", [(1024, 544), (128, 256)], ids=["136-tiles", "one-wide"])
def test_k6_k7_small_frames_bit_identical(card, size):
    """136 tiles (4 blocks a tile) with a peel plane for K6, and a frame
    one tile wide; K6 also with early-z."""
    w, h = size
    n = 4000 if w > 128 else 600
    inp, counts = _random_k1(card, 24, n, w, h, 128, 16, size=0.1, peel=True)
    assert int(counts.max()) > 64
    r = raster_shade_2p_reference(**inp)
    for szb in (None, inp["szb"]):
        assert torch.equal(raster_shade_2p_cuda(**dict(inp, szb=szb)), r)
    inp7, _ = _random_k7(card, 24, n, w, h, 128, 16, size=0.1)
    assert torch.equal(raster_mxu_cuda(**inp7), raster_mxu_reference(**inp7))


@pytest.mark.parametrize("src", ["raster_shade_2p.cu", "raster_mxu.cu"])
def test_k6_k7_ptxas_no_spill(card, src):
    """ptxas: at most 128 registers (two blocks of 256 threads an SM), no
    spill."""
    from datum_tpu_torch.ops import _kernels

    rep = _kernels.library().ptxas(src)
    assert rep["registers"] is not None and rep["registers"] <= 128, rep
    assert not rep["spill_bytes"], rep


def _rig_inputs(seed=0, V=4096, P=4, B=8):
    """Seeded skinning inputs (tests/test_torch_vertex_modes.py's kind:
    antipodal rows, zero and unnormalised weights, a few rows past the
    table)."""
    rng = np.random.RandomState(seed)
    pal = rng.randn(P * B, 8).astype(np.float32)
    pal[1::2] = -pal[0::2]
    bw = rng.uniform(0, 1, (V, 4)).astype(np.float32)
    bw[1::5] = 0.0
    bi = rng.randint(0, B, (V, 4)).astype(np.int32)
    bi[:8, 0] = B + 3
    return [torch.from_numpy(a) for a in (
        rng.randn(V, 3).astype(np.float32), rng.randn(V, 3).astype(np.float32),
        rng.randn(V, 4).astype(np.float32), bi, bw, pal,
        rng.randint(0, P, V).astype(np.int32))], B


def test_skinning_and_wind_bends_on_card_match_cpu(card):
    """skin_vertices, wind_bend, wind_detail_bend and the frame's inline
    bend on the card against the same functions on the CPU: atol/rtol
    1e-5 (the CPU tests' tolerance against the JAX package)."""
    from datum_tpu_torch.ops import geometry

    args, B = _rig_inputs()
    cpu = geometry.skin_vertices(*args, B)
    gpu = geometry.skin_vertices(*(a.to(card) for a in args), B)
    for c, g in zip(cpu, gpu):
        torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=1e-5)
    rng = np.random.RandomState(3)
    pos = torch.from_numpy(rng.randn(4096, 3).astype(np.float32))
    wind, scale, anchor = np.float32([0.7, 0.1, -0.4]), np.float32([0, 0.3, 0.05]), \
        np.float32([3.0, 0.5, -1.0])
    for fn, a in ((geometry.wind_bend, (wind, scale)),
                  (geometry.wind_detail_bend, (anchor, -2.3, wind, scale))):
        torch.testing.assert_close(fn(pos.to(card), *a).cpu(), fn(pos, *a),
                                   atol=1e-5, rtol=1e-5)
    D = 6
    d = dict(world=torch.from_numpy(np.concatenate(
                 [np.tile(np.eye(3, dtype=np.float32), (D, 1, 1)),
                  rng.randn(D, 3, 1).astype(np.float32) * 3], -1)),
             wind=torch.from_numpy(rng.randn(D, 4).astype(np.float32)),
             bendscale=torch.from_numpy(rng.uniform(0, 0.4, (D, 3)).astype(np.float32)),
             detailbendscale=torch.from_numpy(rng.uniform(0, 0.1, (D, 3))
                                              .astype(np.float32)))
    vd = torch.from_numpy(rng.randint(0, D, 4096))
    torch.testing.assert_close(
        frame_mod._foliage_bend(pos.to(card), to_torch(d, card), vd.to(card)).cpu(),
        frame_mod._foliage_bend(pos, d, vd), atol=1e-5, rtol=1e-5)


def test_ocean_on_card_matches_cpu(card):
    """ocean_maps (torch.fft on the card), displace_grid with the flow and
    the swell, ocean_lut_uv and Ocean.vertex_data on a context on the
    card against the CPU: the maps within 1e-5 of their max |value|, the
    slab within atol/rtol 1e-5, its tensors on the card."""
    from datum_tpu_torch.ops import ocean
    from datum_tpu_torch.ops.common import FrameConfig
    from datum_tpu_torch.render.context import RenderContext
    from datum_tpu_torch.render.ocean import Ocean, OceanParams

    h0 = ocean.phillips_spectrum(64, 64.0, (9.0, 3.0), 4e-4, 0)
    f = ocean.wave_frequencies(64, 64.0)
    args = [torch.from_numpy(a) for a in (h0, *f)]
    t = torch.tensor(1.25)
    cpu = ocean.ocean_maps(*args, t, 1.6)
    gpu = ocean.ocean_maps(*(a.to(card) for a in args), t.to(card), 1.6)
    for c, g in zip(cpu, gpu):
        torch.testing.assert_close(g.cpu(), c, atol=1e-5 * c.abs().max().item(), rtol=0)
    slabs = []
    for dev in (card, torch.device("cpu")):
        ctx = RenderContext(FrameConfig(width=64, height=32, max_vertices=1 << 14,
                                        max_triangles=1 << 15), device=dev)
        oc = Ocean(ctx, grid=96, patch_size=64.0,
                   params=OceanParams(wind=(9.0, 3.0), choppiness=1.6,
                                      swellamplitude=0.4, flow=(0.3, -0.2)))
        oc.update(0.75)
        slabs.append(oc.vertex_data(1 << 14, (32.0, 16.0, 78.0)))
    for k in ("positions", "normals", "texcoords"):
        assert slabs[0][k].device.type == "cuda"
        torch.testing.assert_close(slabs[0][k].cpu(), slabs[1][k], atol=1e-5, rtol=1e-5)


VERTEX_MODES = dict(width=256, height=128, sphere_detail=8, grid=(4, 3),
                    n_point_lights=4, skybox=False, vertex_modes=True, ocean_grid=16,
                    bin_capacity=512, big_capacity=32, use_pallas=True,
                    texture_filter="mip_half", enable_shadows=True, shadow_res=256,
                    shadow_bin_capacity=1024)


def test_vertex_modes_frame_on_card_matches_cpu_plain(card):
    """scenes.datumtest_scene(vertex_modes=True) at 256x128 (the skinned
    actor, the foliage blades, the ocean's slab, sun cascades through K3)
    on the card against the CPU plain path: mean |d| <= 0.5, RMSE <= 2
    levels; the patched pool bit-equal on both."""
    ctx, camera, params, make_rl = datumtest_scene(device="cpu", **VERTEX_MODES)
    rl = make_rl(0.3)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    draws = ctx.frame_draws(rl, camera)
    pools = [frame_mod.patch_dynamic(ctx.config, ctx.device_state(d),
                                     to_torch(draws, d))["geometry"]["attr12"].cpu()
             for d in (card, "cpu")]
    assert torch.equal(*pools)
    imgs = [frame_mod.render_frame(ctx.config, ctx.host_state(), draws, ss,
                                   device=d)["image"].cpu().float()
            for d in (card, "cpu")]
    diff = imgs[0] - imgs[1]
    assert imgs[1].mean() > 10
    assert diff.abs().mean() <= 0.5 and (diff ** 2).mean().sqrt() <= 2.0


def _sprites(seed, S, count, w, h, aw, ah, device):
    """Seeded sprite instances: glyph-sized to region-sized rects,
    rotated, anywhere around the image (some offscreen), every fifth
    degenerate, atlas rects partly outside the atlas, garbage past
    count."""
    rng = np.random.RandomState(seed)
    rot = rng.uniform(-np.pi, np.pi, S)
    size = rng.uniform(3, 120, (S, 2))
    c, s = np.cos(rot), np.sin(rot)
    ax = np.stack([size[:, 0] * c, size[:, 0] * s], -1)
    ay = np.stack([-size[:, 1] * s, size[:, 1] * c], -1)
    ay[3::5] = ax[3::5] * 0.5
    uv0 = rng.uniform([-4, -4], [aw, ah], (S, 2))
    inst = dict(origin=rng.uniform([-100, -100], [w + 20, h + 20], (S, 2)),
                axis_x=ax, axis_y=ay, uv0=uv0, uv1=uv0 + rng.uniform(1, 64, (S, 2)),
                tint=rng.uniform(0, 1.2, (S, 4)))
    inst = {k: v.astype(np.float32) for k, v in inst.items()}
    inst["count"] = np.int32(count)
    rgb = torch.from_numpy(rng.rand(h, w, 3).astype(np.float32)).to(device)
    atlas = torch.from_numpy(rng.rand(ah, aw, 4).astype(np.float32)).to(device)
    return rgb, to_torch(inst, device), atlas


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.parametrize("S,count,region", [(256, 200, 128), (768, 700, 128),
                                            (64, 64, 40), (32, 0, 128)])
def test_sprite_kernel_matches_plain(card, S, count, region):
    """One launch per pass, bit-equal to the plain version on the card
    (every bit, NaN-free): a HUD-sized set, more sprites than a block
    collects at once (256), a small window, and no live sprite."""
    rgb, inst, atlas = _sprites(S + count, S, count, 1920, 1088, 256, 96, card)
    n0 = composite_sprites_cuda.launches
    got = composite_sprites(rgb, inst, atlas, region)
    torch.cuda.synchronize()
    assert composite_sprites_cuda.launches == n0 + 1
    want = composite_sprites_reference(rgb, inst, atlas, region)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(rgb), _bits(rgb.clone()))          # input untouched
    assert (got != rgb).any() == (count > 0)


def test_sprite_kernel_small_images_and_edges(card):
    """Images that are not a multiple of the 16 x 16 tile, a window as
    wide as the image, sprites clamped at every edge."""
    for h, w, region in ((37, 53, 37), (128, 256, 64), (17, 300, 16)):
        rgb, inst, atlas = _sprites(h * w, 48, 40, w, h, 32, 32, card)
        got = composite_sprites_cuda(rgb, inst, atlas, region)
        want = composite_sprites_reference(rgb, inst, atlas, region)
        assert torch.equal(_bits(got), _bits(want)), (h, w, region)


def test_sprite_pass_raises_rather_than_falling_back(card):
    rgb, inst, atlas = _sprites(1, 16, 8, 256, 128, 32, 32, card)
    with pytest.raises(ValueError):
        composite_sprites_cuda(rgb.cpu(), inst, atlas, 64)            # CPU image
    with pytest.raises(ValueError):
        composite_sprites(rgb, dict(inst, count=inst["count"].long()), atlas, 64)
    with pytest.raises(ValueError):
        composite_sprites(rgb, inst, atlas.double(), 64)
    with pytest.raises(ValueError):
        composite_sprites(rgb, inst, atlas, 200)                      # region > h
    with pytest.raises(ValueError):
        composite_sprites(rgb, dict(inst, tint=inst["tint"][:, :3]), atlas, 64)
    flat = torch.zeros(32 * 32 * 4 + 1, device=card)
    with pytest.raises(ValueError):
        composite_sprites(rgb, inst, flat[1:].view(32, 32, 4), 64)    # misaligned


# ---------------------------------------------------------------------------
# the pack pipeline on the card: the uploader's side stream, the LZ4 build
# ---------------------------------------------------------------------------

def test_uploader_lands_payloads_bit_equal(card):
    """Every leaf of a payload tree lands on the card equal to its host
    bytes (u32 mips, u16, f32, a numpy scalar, a read-only and a reversed
    array); ready() only once landed; a structured array parks a
    TypeError."""
    from datum_tpu_torch.asset import DeviceUploader
    from datum_tpu_torch.asset.upload import leaves

    rng = np.random.RandomState(0)
    host = {i: dict(mips=[rng.randint(0, 2 ** 32, (1, 64 >> j, 64 >> j), dtype=np.uint64)
                          .astype(np.uint32) for j in range(7)],
                    x=rng.randint(0, 60000, 9).astype(np.uint16),
                    color=rng.rand(4).astype(np.float32), level=np.int32(i), width=64,
                    ro=np.frombuffer(rng.bytes(64), np.uint32),
                    rev=rng.rand(5, 6).astype(np.float32)[::-1, ::-2])
            for i in range(6)}
    up = DeviceUploader(card)
    try:
        assert up.stream is not None and up.device == card
        for k, p in host.items():
            up.submit(k, p)
        up.submit("mesh", dict(v=np.zeros(4, [("position", np.float32, 3)])))
        up.flush()
        for k, p in host.items():
            assert up.ready(k)
            got = up.get(k)
            assert got["width"] == 64
            tensors = [t for t in leaves(got) if isinstance(t, torch.Tensor)]
            want = [*p["mips"], p["x"], p["color"], p["level"], p["ro"],
                    np.ascontiguousarray(p["rev"])]
            assert len(tensors) == len(want)
            for t, h in zip(tensors, want):
                assert t.device == card and t.shape == h.shape
                assert t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes() == h.tobytes()
        with pytest.raises(TypeError):
            up.get("mesh")
    finally:
        up.close()


def test_uploader_cross_stream_under_allocator_reuse(card):
    """Tensors the side stream allocated, read on the default stream
    behind a ~0.5 s kernel while the uploader evicts them and uploads the
    bitwise complements (allocations that would reuse their blocks): the
    reads see the host bytes, because get() records the reading stream."""
    from datum_tpu_torch.asset import DeviceUploader

    rng = np.random.RandomState(1)
    host = {i: dict(mips=[rng.randint(0, 2 ** 32, (1, 256, 256), dtype=np.uint64)
                          .astype(np.uint32)]) for i in range(8)}
    up = DeviceUploader(card)
    try:
        for k, p in host.items():
            up.submit(k, p)
        up.flush()
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000_000)
        reads = []
        for k in host:
            t = up.get(k)["mips"][0]
            reads.append(t.reshape(-1).view(torch.uint8).clone())
            up.evict(k)
            del t
        queued = torch.cuda.Event()
        queued.record()
        for k, p in host.items():
            up.submit(("again", k), dict(mips=[~p["mips"][0]]))
        up.flush()
        assert not queued.query(), "the re-uploads did not land before the reads ran"
        torch.cuda.synchronize()
        for r, p in zip(reads, host.values()):
            assert r.cpu().numpy().tobytes() == p["mips"][0].tobytes()
        for k, p in host.items():
            got = up.get(("again", k))["mips"][0]
            assert got.cpu().numpy().tobytes() == (~p["mips"][0]).tobytes()
    finally:
        up.close()


def test_lz4_native_codec_builds_and_agrees(card):
    """The native codec builds with the machine's g++ and agrees with the
    plain Python codec both ways; a pack round trip through CDAT."""
    from datum_tpu_torch.asset import lz4
    from datum_tpu_torch.asset.pack import IMAGE_RGBA, PackReader, PackWriter

    assert lz4.build().exists()
    rng = np.random.RandomState(2)
    data = (b"abcabcabc" * 500) + rng.bytes(1000) + (np.arange(20000, dtype=np.uint32) // 7
                                                     ).tobytes()
    comp, used = lz4.compress(data, len(data) * 2)
    assert used == len(data) and lz4.py_decompress(comp, used) == data
    pcomp, pused = lz4.py_compress(data, len(data) * 2)
    assert lz4.decompress(pcomp, pused) == data
    img = (np.arange(3 * 128 * 128, dtype=np.uint32) // 11).reshape(3, 128, 128)
    w = PackWriter()
    w.write_image(0, 128, 128, 3, 1, IMAGE_RGBA, img.tobytes(), compress=True)
    assert np.array_equal(PackReader(w.finish()).image(0)["mips"][0], img)


def _graph_outputs(out):
    keep = {k: out[k].clone() for k in ("image", "depth", "vis", "luminance")}
    keep["ao"] = out["ao_prev"]["ao"].clone()
    return keep


def test_frame_graph_replays_bit_equal_to_eager(card):
    """The megakernel frame through render_frame, 6 frames with t and the
    camera moving (render/framegraph.py): frame 1 (no SSAO history) and
    frame 2 (the first with it) eager, frame 3 captured (its cached
    constants cleared first: built between its graphs), frames 4-6
    replayed.  Each frame bit-equal in image, depth, vis, luminance and
    ao_prev to the eager frame on the same inputs; each frame's outputs
    unchanged once the next has run; K1 and K2 launched twice a replayed
    frame (the opaque and the lit layer) and K4 once (the merged stream)
    from the wrappers; a profiled replayed frame shows K1, K2, K4 and the
    graphs' kernels, with only those 5 launch calls, and its stages'
    device time by correlation id."""
    from torch.profiler import ProfilerActivity, profile

    from datum_tpu_torch.debug import g_debuglog
    from datum_tpu_torch.debug.stages import profile_stages, tracing_on
    from datum_tpu_torch.ops import blur
    from datum_tpu_torch.ops.common import constant, shifted_taps
    from datum_tpu_torch.render import framegraph

    framegraph.clear()
    ctx, camera, params, make_rl = datumtest_scene(**BENCH)
    cfg, state = ctx.config, ctx.device_state(card)
    prev, kept, kinds, k1k2 = None, [], [], []

    def inputs(i):
        camera.move((0.05, 0.0, -0.1))
        rl = make_rl(0.4 + i / 60)
        return ctx.frame_draws(rl, camera), make_sceneset(
            camera, params, point_lights=rl.point_lights, spot_lights=rl.spot_lights)

    for i in range(6):
        draws, ss = inputs(i)
        if i == 2:
            # the capture finds the cached constants gone (evicted by other
            # frames) and builds them between its graphs
            for cached in (constant, shifted_taps, blur._matrix, frame_mod.quad_triangles):
                cached.cache_clear()
        stats = dict(g_debuglog.statistics)
        n = (raster_shade_cuda.launches, shade_deferred_cuda.launches,
             raster_blend_cuda.launches)
        out = frame_mod.render_frame(cfg, state, draws, ss, device=card, prev=prev)
        k1k2.append((raster_shade_cuda.launches - n[0], shade_deferred_cuda.launches - n[1],
                     raster_blend_cuda.launches - n[2]))
        kinds += [k for k, v in g_debuglog.statistics.items() if v != stats.get(k, 0)]
        eager = frame_mod._eager_frame(cfg, state, draws, ss, prev, card)
        got, want = _graph_outputs(out), _graph_outputs(eager)
        for k in got:
            assert torch.equal(got[k], want[k]), (i, k)
        assert got["image"].float().mean() > 10
        kept.append((out, got))
        prev = out["ao_prev"]
    assert kinds == ["frame.graph.eager"] * 2 + ["frame.graph.capture"] + [
        "frame.graph.replay"] * 3
    assert k1k2 == [(2, 2, 1)] * 6
    for out, got in kept:
        for k, v in _graph_outputs(out).items():
            assert torch.equal(v, got[k]), k
    draws, ss = inputs(6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame_mod.render_frame(cfg, state, draws, ss, device=card, prev=prev)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = [e.name for e in events if e.name.startswith(("cudaLaunchKernel",
                                                             "cuLaunchKernel"))]
    k1 = sum("raster_shade_kernel" in k for k in kernels)
    assert k1 == 2 and sum("shade_kernel" in k for k in kernels) - k1 == 2
    assert sum("raster_depth_kernel" in k for k in kernels) == 3
    assert sum("raster_blend_kernel" in k for k in kernels) == 1
    assert len(kernels) > 500 and len(launches) == 5
    # with the program's tracing on (another key: eager, captured, then
    # replayed), debug/stages.py puts each graph's kernels down to its stage
    with tracing_on():
        for i in (7, 8):
            draws, ss = inputs(i)
            prev = frame_mod.render_frame(cfg, state, draws, ss, device=card,
                                          prev=prev)["ao_prev"]
    draws, ss = inputs(9)
    st = profile_stages(lambda: frame_mod.render_frame(cfg, state, draws, ss, device=card,
                                                       prev=prev), 1, card)
    rows = dict(st.table())
    assert st.linked == len(st.device_ops)
    assert all(rows[s]["device_ms"] > 0 for s in framegraph.STAGES)
    assert rows["frame.raster.k1"]["launches"] == 1
    assert rows["frame.shade.k2"]["launches"] == 1
    assert rows["frame.translucent.lit"]["launches"] == 2
    assert rows["frame.translucent.wboit"]["launches"] == 1
    framegraph.clear()


def _deferred_inputs(camera, params, make_rl, i, n_point=None):
    """The deferred frames' draws-to-be renderlist and sceneset at frame i
    (the camera moved, t + i/60), with the first n_point point lights."""
    camera.move((0.05, 0.0, -0.1))
    rl = make_rl(0.4 + i / 60)
    return rl, make_sceneset(camera, params, point_lights=rl.point_lights[:n_point],
                             spot_lights=rl.spot_lights)


def test_frame_graph_replays_the_deferred_branch_bit_equal(card):
    """The deferred branch's K5 route (K5_FRAME: bilinear, decals, SSAO,
    fog, a spot map, translucents and particles) through render_frame, 6
    frames with t and the camera moving: frames 1-2 eager, 3 captured,
    4-6 replayed, each bit-equal in image, depth, vis, luminance and
    ao_prev to the eager frame on the same inputs, which reads the light
    counts back from the device; earlier outputs unchanged; K5 launched
    once and K4 twice a frame from their wrappers.  A replayed frame,
    profiled with the program's tracing on (debug/stages.py), makes no
    host sync and only those 3 launch calls, K5 under frame.raster.k5
    and K4 under frame.translucent.wboit and .particles.  One point
    light fewer is another key: eager, then captured."""
    from datum_tpu_torch.debug import g_debuglog
    from datum_tpu_torch.debug.stages import profile_stages, tracing_on
    from datum_tpu_torch.render import framegraph

    framegraph.clear()
    ctx, camera, params, make_rl = datumtest_scene(**K5_FRAME)
    cfg, state = ctx.config, ctx.device_state(card)
    assert not frame_mod.use_shade_kernel(cfg, state) and cfg.use_pallas

    def frame(i, prev, n_point=None):
        rl, ss = _deferred_inputs(camera, params, make_rl, i, n_point)
        draws = ctx.frame_draws(rl, camera)
        stats = dict(g_debuglog.statistics)
        n = raster_v1_cuda.launches, raster_blend_cuda.launches
        out = frame_mod.render_frame(cfg, state, draws, ss, device=card, prev=prev)
        n = raster_v1_cuda.launches - n[0], raster_blend_cuda.launches - n[1]
        kind = [k for k, v in g_debuglog.statistics.items() if v != stats.get(k, 0)]
        eager = frame_mod._eager_frame(cfg, state, draws, ss, prev, card)
        got, want = _graph_outputs(out), _graph_outputs(eager)
        for k in got:
            assert torch.equal(got[k], want[k]), (i, k)
        assert got["image"].float().mean() > 10
        return out, got, kind, n, frame_mod.host_light_counts(ss)

    prev, kept, kinds = None, [], []
    for i in range(6):
        out, got, kind, n, lights = frame(i, prev)
        assert n == (1, 2) and lights == (4, 1), i
        kinds += kind
        kept.append((out, got))
        prev = out["ao_prev"]
    assert kinds == ["frame.graph.eager"] * 2 + ["frame.graph.capture"] + [
        "frame.graph.replay"] * 3
    for out, got in kept:
        for k, v in _graph_outputs(out).items():
            assert torch.equal(v, got[k]), k
    kinds = []
    for i in (6, 7):
        out, _, kind, n, lights = frame(i, prev, n_point=3)
        assert n == (1, 2) and lights == (3, 1)
        kinds += kind
        prev = out["ao_prev"]
    assert kinds == ["frame.graph.eager", "frame.graph.capture"]
    with tracing_on():
        for i in (8, 9):
            rl, ss = _deferred_inputs(camera, params, make_rl, i)
            prev = frame_mod.render_frame(cfg, state, ctx.frame_draws(rl, camera), ss,
                                          device=card, prev=prev)["ao_prev"]
    rl, ss = _deferred_inputs(camera, params, make_rl, 10)
    draws = ctx.frame_draws(rl, camera)
    before = g_debuglog.statistics.get("frame.graph.replay", 0)
    st = profile_stages(lambda: frame_mod.render_frame(cfg, state, draws, ss, device=card,
                                                       prev=prev), 1, card)
    assert g_debuglog.statistics["frame.graph.replay"] == before + 1
    rows = dict(st.table())
    assert rows["frame"]["syncs"] == 0 and rows["frame"]["launches"] == 3
    assert rows["frame.raster.k5"]["launches"] == 1
    assert rows["frame.translucent.wboit"]["launches"] == 1
    assert rows["frame.translucent.particles"]["launches"] == 1
    assert all(rows[s]["device_ms"] > 0 for s in framegraph.STAGES)
    framegraph.clear()


@pytest.mark.parametrize("scene", [dict(K5_FRAME, enable_material_maps=False), K7_FRAME],
                         ids=["K1", "K7"])
def test_frame_graph_replays_the_deferred_k1_and_k7_routes_bit_equal(card, scene):
    """The deferred branch's other use_pallas routes replay too: K1 with
    gbuffer_from_planes (material maps off) and K7; 4 frames, each
    bit-equal to the eager frame on the same inputs."""
    from datum_tpu_torch.debug import g_debuglog
    from datum_tpu_torch.render import framegraph

    framegraph.clear()
    ctx, camera, params, make_rl = datumtest_scene(**scene)
    cfg, state = ctx.config, ctx.device_state(card)
    assert not frame_mod.use_shade_kernel(cfg, state)
    prev, kinds = None, []
    for i in range(4):
        rl, ss = _deferred_inputs(camera, params, make_rl, i)
        draws = ctx.frame_draws(rl, camera)
        stats = dict(g_debuglog.statistics)
        out = frame_mod.render_frame(cfg, state, draws, ss, device=card, prev=prev)
        kinds += [k for k, v in g_debuglog.statistics.items() if v != stats.get(k, 0)]
        eager = frame_mod._eager_frame(cfg, state, draws, ss, prev, card)
        for k in ("image", "depth", "vis", "luminance"):
            assert torch.equal(out[k], eager[k]), (i, k)
        prev = out.get("ao_prev")
    assert kinds[-1] == "frame.graph.replay" and "frame.graph.capture" in kinds
    framegraph.clear()


def test_frame_graph_leaves_the_scan_raster_eager(card):
    """The deferred branch without use_pallas (the scan raster, which
    reads device values on the host) runs eagerly every frame."""
    from datum_tpu_torch.debug import g_debuglog
    from datum_tpu_torch.render import framegraph

    framegraph.clear()
    ctx, state, draws, ss = _frame(card, scene=DEFERRED)
    assert not frame_mod.use_shade_kernel(ctx.config, state)
    assert not ctx.config.use_pallas
    before = dict(g_debuglog.statistics)
    for _ in range(3):
        frame_mod.render_frame(ctx.config, state, draws, ss, device=card)
    delta = {k: v - before.get(k, 0) for k, v in g_debuglog.statistics.items()
             if k.startswith("frame.graph.") and v != before.get(k, 0)}
    assert delta == {"frame.graph.eager": 3}


def test_k5_and_k4_write_into_out(card):
    """raster_v1_cuda and raster_blend_cuda with out= (the frame graph's
    preallocated outputs) return out, bit-equal to their own
    allocations; a wrong out is refused before any launch."""
    inp, _ = _random_k5(card, 28, 4000, 1024, 544, 128, 16, size=0.1)
    buf = torch.full((4, 544, 1024), float("nan"), device=card)
    assert raster_v1_cuda(**inp, out=buf) is buf
    assert torch.equal(buf, raster_v1_cuda(**inp))
    cfg, state, d, s, ts = _translucent(card)
    st = frame_mod.oit_stream(cfg, state, d, s, ts, None)
    bins, counts, big = frame_mod.oit_bins(cfg, st)
    opaque = torch.rand((cfg.padded_height, cfg.padded_width), device=card) * 0.05
    binp = blend_inputs(st["setup"], bins, big, counts, st["tris"], st["uv"], st["color"],
                        opaque, cfg.tiles_x, cfg.padded_width, cfg.padded_height,
                        "per_tri", None, st["soft_flag"], st["peel_flag"])
    bbuf = torch.full((5, cfg.padded_height, cfg.padded_width), float("nan"), device=card)
    assert raster_blend_cuda(**binp, out=bbuf) is bbuf
    assert _same_bits(bbuf, raster_blend_cuda(**binp))
    n = raster_v1_cuda.launches, raster_blend_cuda.launches
    with pytest.raises(ValueError):
        raster_v1_cuda(**inp, out=buf[:, :32])
    with pytest.raises(ValueError):
        raster_blend_cuda(**binp, out=bbuf.double())
    assert (raster_v1_cuda.launches, raster_blend_cuda.launches) == n

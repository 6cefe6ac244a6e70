#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Renders the shadowed, sky-lit datumtest frame at 1920x1088 (the bench
scene, capacities and shadow settings: 4 sun cascades as a 1024 near
and a 512 far atlas with ESM and slice blend, one parabolic spot map,
the procedural skybox and its IBL environment; no SSAO, fog, SSR,
translucents, particles, decals or DoF) through
datum_tpu_torch.render.frame.render_frame, after building the port's
CUDA kernels from datum_tpu_torch/csrc with nvcc.  Phases, one line
each; any failure raises and exits non-zero:

1. require a CUDA device; print its name and nvidia-smi's name and
   power limit; turn TF32 off;
2. build the kernels (timed, first use);
3. build the scene through the port's datumtest_scene; the main
   bin_overflow must be 0; print each shadow stack's overflow;
4. each kernel against its plain PyTorch version on that frame's real
   inputs, with the stated tolerances (K3 on all three shadow stacks);
5. render 3 frames; check the image, the luminance and that K1, K2 and
   K3 (3 stacks) launched in every frame; check a small shadowed,
   sky-lit frame against the plain path on the CPU;
6. time ms/frame (CUDA events, median) of this frame and of the opaque
   frame, the frame's stages, and each kernel vs its plain version;
7. print the kernels' JSON line, then the device JSON line last.

Needs one card, torch with CUDA and nvcc; imports no jax.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

W, H = 1920, 1088
SCENE = dict(sphere_detail=24, n_point_lights=8, skybox=True, skybox_size=64,
             max_vertices=1 << 15, max_triangles=1 << 15, bin_capacity=160,
             big_capacity=64, bin_max_span=8, use_pallas=True,
             enable_material_maps=True, texture_filter="mip_half",
             enable_shadows=True, shadow_mode="esm", shadow_res=1024,
             shadow_far_res=512, shadow_slice_blend=0.25,
             shadow_bin_capacity=128, max_spot_shadows=1,
             spot_shadow_mode="parabolic", spot_shadow_res=256)
# the opaque frame (no skybox, no shadows), timed for comparison
OPAQUE = dict(SCENE, skybox=False, enable_shadows=False, max_spot_shadows=0)
SMALL = dict(SCENE, sphere_detail=8, grid=(4, 3), max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             skybox_size=32, shadow_res=256, shadow_far_res=128,
             shadow_bin_capacity=1024, spot_shadow_res=128)
K1_INTERP = ("u", "v", "nx", "ny", "nz", "tanx", "tany", "tanz")
K1_EXACT = ("cr", "cg", "cb", "em", "met", "rgh", "rfl", "alb", "mbase",
            "msize", "tanw", "absorb")
STACKS = ("near cascades", "far cascades", "spot")


def phase(n, msg):
    print(f"phase {n}: {msg}", flush=True)


def frame_inputs(ctx, camera, params, make_rl, t):
    """(draws, sceneset) numpy trees of the frame at time t."""
    from datum_tpu_torch.render.types import make_sceneset

    rl = make_rl(t)
    sceneset = make_sceneset(camera, params, point_lights=rl.point_lights,
                             spot_lights=rl.spot_lights)
    draws = rl.draw_arrays(ctx.config.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    return draws, sceneset


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


def stage_ms(cfg, state, draws, ss, dev, reps=5):
    """Wall ms of each stage of the frame with a device sync after each
    (median of reps): the frame's own stage functions, in its order."""
    import torch

    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.ops.shade_cuda import shade_deferred
    from datum_tpu_torch.render import frame as F

    names = ("upload draws + sceneset", "vertex stage",
             "sun cascades (K3) + ESM", "spot map (K3) + ESM",
             "setup + binning + K1", "plane assembly (matmaps, env, sun factor)",
             "sky planes + SH + spot factor", "K2 (tables + bf16 + kernel)",
             "luminance + bloom + composite")
    runs = []
    for _ in range(reps):
        t = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        d, s = to_torch(draws, dev), to_torch(ss, dev)
        mark()
        ex, uv, clip, wn, wt, wp = F._vertex_stage(cfg, state, d, s)
        mark()
        sun = F._sun_shadows(cfg, ex, wp, s)
        mark()
        spot = F._spot_shadows(cfg, ex, wp, s)
        mark()
        planes, _ = F._raster_stage(cfg, state, d, ex, uv, clip, wn, wt)
        mark()
        gpl = F._assemble_gplanes(cfg, planes, state, s, dict(sun=sun, spot=spot))
        mark()
        ss2, spotsf = F._sky_sh_spots(cfg, gpl, planes, state, s, spot)
        mark()
        hdr = shade_deferred(gpl, ss2, proj=s["proj"], invview=s["invview"],
                             spotsf=spotsf)
        mark()
        F._post(cfg, state, s, hdr)
        mark()
        runs.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
    return {n: statistics.median(r[i] for r in runs) for i, n in enumerate(names)}


def main():
    import torch

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
    from datum_tpu_torch.ops import shadow as shadow_ops
    from datum_tpu_torch.ops.raster_cuda import (
        PLANE_NAMES, raster_inputs, raster_shade_cuda, raster_shade_reference)
    from datum_tpu_torch.ops.raster_depth_cuda import (
        depth_inputs, raster_depth_cuda, raster_depth_reference)
    from datum_tpu_torch.ops.shade_cuda import (
        shade_deferred_cuda, shade_deferred_reference, shade_inputs)
    from datum_tpu_torch.render import frame as frame_mod
    from datum_tpu_torch.scenes import datumtest_scene
    kernels = (raster_shade_cuda, shade_deferred_cuda, raster_depth_cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _kernels.library()
    phase(2, f"built {lib.path.name} from {', '.join(_kernels.SOURCES)} in "
             f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  nvcc:", line.strip(), flush=True)

    # ---- 3. scene at full width
    t0 = time.perf_counter()
    ctx, camera, params, make_rl = datumtest_scene(width=W, height=H, **SCENE)
    cfg = ctx.config
    state = ctx.device_state(dev)
    overflows, stack_overflows = [], []
    for t in (0.0, 0.1, 0.2):
        draws, ss = frame_inputs(ctx, camera, params, make_rl, t)
        n_tris = int(draws["t_valid"].sum())
        d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
        ex, _, clip, _, _, wp = frame_mod._vertex_stage(cfg, state, d_t, s_t)
        overflows.append(int(frame_mod._bin_stage(cfg, ex, clip)[-1]))
        stack_overflows.append([int(shadow_ops.bin_stack(
            st, cfg.shadow_bin_capacity, cfg.big_capacity,
            return_overflow=True)[3]) for st in shadow_stacks(cfg, ex, wp, s_t)])
    if any(overflows):
        raise RuntimeError(f"bin overflow {overflows}: raise bin_capacity")
    phase(3, f"scene {W}x{H}, {n_tris} triangles drawn, {cfg.n_tiles} tiles, "
             f"bins {cfg.bin_capacity}+{cfg.big_capacity}, bin_overflow "
             f"{overflows}; skybox {ctx.skybox.size}^2 x 6 with "
             f"{len(state['ibl']['mips'])} mips ({time.perf_counter() - t0:.1f} s)")
    phase(3, f"shadow stack overflow per frame ({', '.join(STACKS)}; shadow "
             f"bins {cfg.shadow_bin_capacity}+{cfg.big_capacity}): "
             f"{stack_overflows}")

    # ---- 4. kernels vs their plain versions on the frame's inputs
    draws, ss = frame_inputs(ctx, camera, params, make_rl, 0.3)
    d_t, s_t = to_torch(draws, dev), to_torch(ss, dev)
    ex, uv, clip, wn, wt, wp = frame_mod._vertex_stage(cfg, state, d_t, s_t)
    k3_in, k3_errs = [], []
    for name, st in zip(STACKS, shadow_stacks(cfg, ex, wp, s_t)):
        bins, counts, big = shadow_ops.bin_stack(st, cfg.shadow_bin_capacity,
                                                 cfg.big_capacity)
        inp = depth_inputs(st["setup"], bins, big, counts, st["tiles_x"],
                           st["res"], st["height"])
        dk = raster_depth_cuda(**inp)
        dr = raster_depth_reference(**inp)
        torch.cuda.synchronize()
        same = (dk == dr).float().mean().item()
        err = (dk - dr).abs().max().item()
        covered = (dr > 0).float().mean().item()
        if same < 0.9999 or err > 1e-6 or not torch.isfinite(dk).all():
            raise RuntimeError(f"K3 vs plain on the {name}: identical on "
                               f"{same}, max abs err {err}")
        phase(4, f"K3 vs plain, {name} ({st['res']}x{st['height']}): "
                 f"bit-identical on {same:.6f} of texels (covered "
                 f"{covered:.3f}), max abs err {err:.3g} (atol 1e-6)")
        k3_in.append(inp)
        k3_errs.append(err)

    setup, bins, counts, big_ids, _ = frame_mod._bin_stage(cfg, ex, clip)
    k1_in = raster_inputs(setup, bins, big_ids, counts, ex["tris"], uv, wn,
                          d_t["tri_mat"], state["materials"], cfg.tiles_x,
                          cfg.padded_width, cfg.padded_height, wt)
    pk = raster_shade_cuda(**k1_in)
    pr = raster_shade_reference(**k1_in)
    torch.cuda.synchronize()
    kp, rp = dict(zip(PLANE_NAMES, pk)), dict(zip(PLANE_NAMES, pr))
    same = kp["visf"] == rp["visf"]
    vis_agree = same.float().mean().item()
    depth_err = (kp["depth"] - rp["depth"])[same].abs().max().item()
    interp_err = max((kp[n] - rp[n])[same].abs().max().item() for n in K1_INTERP)
    exact_bad = sum(int((kp[n] != rp[n])[same].sum()) for n in K1_EXACT)
    k1_err = max((kp[n] - rp[n])[same].abs().max().item() for n in PLANE_NAMES)
    for n in K1_INTERP:
        if not torch.allclose(kp[n][same], rp[n][same], atol=1e-4, rtol=1e-4):
            raise RuntimeError(f"K1 plane {n} differs beyond atol/rtol 1e-4")
    if vis_agree < 0.999 or depth_err > 1e-6 or exact_bad:
        raise RuntimeError(f"K1 vs plain: visf agreement {vis_agree}, depth "
                           f"err {depth_err}, {exact_bad} per-triangle values differ")
    covered = (kp["visf"] >= 0).float().mean().item()
    phase(4, f"K1 vs plain: visf identical on {vis_agree:.6f} of pixels "
             f"(covered {covered:.3f}), depth max err {depth_err:.3g} "
             f"(atol 1e-6), interpolated max err {interp_err:.3g} (atol/rtol "
             f"1e-4), per-triangle planes exact")

    shadows = frame_mod._shadow_stage(cfg, ex, wp, s_t)
    gpl, ss2, spotsf = frame_mod._shade_inputs(cfg, kp, state, s_t, shadows)
    if "sky_r" not in gpl or spotsf is None:
        raise RuntimeError("K2 inputs lack the sky planes or the spot factors")
    k2_in = shade_inputs(gpl, ss2, proj=s_t["proj"], invview=s_t["invview"],
                         spotsf=spotsf)
    hk = shade_deferred_cuda(**k2_in)
    hr = shade_deferred_reference(**k2_in)
    torch.cuda.synchronize()
    k2_err = (hk - hr).abs().max().item()
    if not torch.isfinite(hk).all() or not torch.allclose(hk, hr, atol=1e-4,
                                                            rtol=1e-3):
        raise RuntimeError(f"K2 vs plain: max abs err {k2_err} beyond "
                           "atol 1e-4 / rtol 1e-3")
    sf, spf = gpl["sf"], spotsf[0]
    phase(4, f"K2 vs plain (sky, IBL, sun + spot shadow planes): hdr max abs "
             f"err {k2_err:.3g} (atol 1e-4, rtol 1e-3), max |hdr| "
             f"{hr.abs().max().item():.3g}; sun factor < 0.5 on "
             f"{(sf < 0.5).float().mean().item():.3f}, spot factor < 0.5 on "
             f"{(spf < 0.5).float().mean().item():.3f} of pixels")

    # ---- 5. the main path: 3 frames through render_frame
    inputs = [frame_inputs(ctx, camera, params, make_rl, t)
              for t in (0.0, 0.1, 0.2)]
    for k in kernels:
        k.launches = 0
    per_frame = []
    for draws, ss in inputs:
        before = [k.launches for k in kernels]
        out = frame_mod.render_frame(cfg, state, draws, ss, device=dev)
        torch.cuda.synchronize()
        per_frame.append(tuple(k.launches - b for k, b in zip(kernels, before)))
        img, lum = out["image"], out["luminance"]
        if tuple(img.shape) != (H, W, 3) or img.dtype != torch.uint8:
            raise RuntimeError(f"image {tuple(img.shape)} {img.dtype}")
        mean = img.float().mean().item()
        if not mean > 10 or not torch.isfinite(lum) or int(out["bin_overflow"]):
            raise RuntimeError(f"frame: image mean {mean}, luminance "
                               f"{lum.item()}, bin_overflow "
                               f"{int(out['bin_overflow'])}")
    launches = dict(raster_shade=raster_shade_cuda.launches,
                    shade_deferred=shade_deferred_cuda.launches,
                    raster_depth=raster_depth_cuda.launches)
    if any(k1 < 1 or k2 < 1 or k3 < 3 for k1, k2, k3 in per_frame):
        raise RuntimeError(f"a frame ran without its kernels: {per_frame}")
    phase(5, f"3 frames {W}x{H}: image {tuple(img.shape)} u8 mean {mean:.2f}, "
             f"luminance {lum.item():.6g}, bin_overflow 0, launches per frame "
             f"(K1, K2, K3) {per_frame}")

    # the same small shadowed, sky-lit frame on the card (kernels) and on
    # the CPU (plain)
    sctx, scam, sparams, smake = datumtest_scene(width=256, height=128, **SMALL)
    sdraws, sss = frame_inputs(sctx, scam, sparams, smake, 0.3)
    imgs = [frame_mod.render_frame(sctx.config, sctx.host_state(), sdraws, sss,
                                   device=d)["image"].cpu().float()
            for d in (dev, "cpu")]
    d_img = (imgs[0] - imgs[1]).abs()
    rmse = ((imgs[0] - imgs[1]) ** 2).mean().sqrt().item() / 255.0
    if d_img.mean().item() > 0.5 or rmse > 2 / 255 or imgs[1].mean() <= 10:
        raise RuntimeError(f"small frame GPU vs CPU plain: mean |d| "
                           f"{d_img.mean().item()}, RMSE {rmse}")
    phase(5, f"256x128 shadowed, sky-lit frame, card vs CPU plain path: mean "
             f"|d| {d_img.mean().item():.4f} levels, RMSE {rmse * 255:.4f} "
             f"levels")

    # ---- 6. timing (informational: this PR claims no speed)
    ms_frame = frame_ms(lambda d, s: frame_mod.render_frame(
        cfg, state, d, s, device=dev), inputs)
    octx, ocam, oparams, omake = datumtest_scene(width=W, height=H, **OPAQUE)
    ostate = octx.device_state(dev)
    o_inputs = [frame_inputs(octx, ocam, oparams, omake, t) for t in (0.0, 0.1)]
    ms_opaque = frame_ms(lambda d, s: frame_mod.render_frame(
        octx.config, ostate, d, s, device=dev), o_inputs)
    stages = stage_ms(cfg, state, *inputs[0], dev)
    t_k1 = cuda_ms(lambda: raster_shade_cuda(**k1_in), 20)
    t_k1p = cuda_ms(lambda: raster_shade_reference(**k1_in), 3)
    t_k2 = cuda_ms(lambda: shade_deferred_cuda(**k2_in), 20)
    t_k2p = cuda_ms(lambda: shade_deferred_reference(**k2_in), 3)
    t_k3 = [cuda_ms(lambda i=i: raster_depth_cuda(**i), 20) for i in k3_in]
    t_k3p = [cuda_ms(lambda i=i: raster_depth_reference(**i), 3) for i in k3_in]
    phase(6, f"{ms_frame:.3f} ms/frame shadowed + sky-lit, {ms_opaque:.3f} "
             f"ms/frame opaque (median of 7, CUDA events, {W}x{H}) on {card}")
    phase(6, "stages (ms, wall, synced, median of 5): " + "; ".join(
        f"{n} {v:.3f}" for n, v in stages.items()))
    phase(6, f"K1 {t_k1:.3f} ms vs plain {t_k1p:.3f} ms; K2 {t_k2:.3f} ms vs "
             f"plain {t_k2p:.3f} ms; K3 " + ", ".join(
                 f"{n} {a:.3f} ms vs plain {b:.3f} ms"
                 for n, a, b in zip(STACKS, t_k3, t_k3p))
          + f" ({W}x{H}) on {card}")

    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and (m == "jax" or m.startswith("jax.")
                         or (m.startswith("datum_tpu.")
                             and not m.startswith("datum_tpu.math"))))
    if loaded:
        raise RuntimeError(f"chip_smoke imported the JAX side: {loaded[:5]}")

    # ---- 7. result lines
    print(json.dumps({"kernels": [
        dict(name="raster_shade", route="cuda",
             source="datum_tpu_torch/csrc/raster_shade.cu",
             replaces="datum_tpu/ops/raster_pallas.py:343",
             launches=launches["raster_shade"], max_abs_err=k1_err,
             ms=t_k1, plain_ms=t_k1p),
        dict(name="shade_deferred", route="cuda",
             source="datum_tpu_torch/csrc/shade.cu",
             replaces="datum_tpu/ops/shade_pallas.py:161",
             launches=launches["shade_deferred"], max_abs_err=k2_err,
             ms=t_k2, plain_ms=t_k2p),
        # the three stacks of one frame together
        dict(name="raster_depth", route="cuda",
             source="datum_tpu_torch/csrc/raster_depth.cu",
             replaces="datum_tpu/ops/raster_pallas.py:730",
             launches=launches["raster_depth"], max_abs_err=max(k3_errs),
             ms=sum(t_k3), plain_ms=sum(t_k3p)),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

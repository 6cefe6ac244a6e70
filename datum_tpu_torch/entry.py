"""The port's entry points (counterpart of __graft_entry__.py): the
single-device frame step and the n-rank tile-sharded dry run.

    python -m datum_tpu_torch.entry [--cpu]
    python -m datum_tpu_torch.entry multichip [N] [--cpu] [--backend nccl|gloo]

`entry(device)` returns (fn, args): entry()'s frame (the datumtest scene
at 1280x704, FrameConfig's defaults) as render_frame on `device`.

`dryrun_multichip(n, *, device, backend)` renders the full fast-path
config (the megakernel frame with SSAO, fog, SSR, particles, the lit
translucents, decals, a shadowed spot, 4 ESM cascades, the IBL
environment and a device sprite) at 256 x 2*TILE_H*max(n, 2) over n
spawned ranks, two tile rows a rank, and holds it to the single-device
frame: bin_overflow 0 and RMSE < 1e-3 (the JAX package's gate), then
prints the byte ledger.  Backends: gloo on the CPU, and for several
ranks on one card (NCCL refuses two ranks on one device); nccl with a
card a rank.  The command line picks nccl when the host has a card for
every rank, else gloo, and says which; the functions take it
explicitly.  The parent builds the CUDA kernels before it spawns, so
that the ranks do not race on the build directory.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

# entry()'s config (__graft_entry__.py::entry)
ENTRY = dict(width=1280, height=704, sphere_detail=16, n_point_lights=4,
             max_vertices=1 << 15, max_triangles=1 << 15, bin_capacity=128,
             big_capacity=32)
# the dry run's config at any height (__graft_entry__.py::dryrun_multichip)
DRYRUN = dict(width=256, sphere_detail=8, grid=(3, 2), n_point_lights=4, skybox=True,
              skybox_size=16, max_vertices=4096, max_triangles=4096, max_instances=16,
              bin_capacity=128, big_capacity=32, use_pallas=True,
              enable_material_maps=True, texture_filter="mip_half", enable_ssao=True,
              enable_fog=True, enable_ssr=True, enable_shadows=True, shadow_res=128,
              shadow_bin_capacity=128, max_spot_shadows=1, spot_shadow_res=128,
              max_particle_quads=64, max_translucent_draws=2, max_translucent_tris=1024,
              max_decals_active=2, max_overlay_sprites=8, overlay_region=64)
RMSE_GATE = 1e-3


def entry(device="cuda"):
    """(fn, args): fn(*args) renders entry()'s frame on device."""
    from .render import frame as F
    from .render.types import make_sceneset
    from .scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(device=device, **ENTRY)
    rl = make_rl(0.0)
    sceneset = make_sceneset(camera, params, point_lights=rl.point_lights,
                             spot_lights=rl.spot_lights)
    draws = ctx.frame_draws(rl, camera)
    fn = functools.partial(F.render_frame, ctx.config, device=device)
    return fn, (ctx.device_state(device), draws, sceneset)


def dryrun_inputs(n, device):
    """(cfg, state, draws, sceneset) of the dry run's frame for n ranks:
    DRYRUN at height 2*TILE_H*max(n, 2), with a sprite badge the device
    sprite pass composites on the gathered display rgb."""
    from .ops.common import TILE_H
    from .render.types import make_sceneset
    from .scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(
        height=2 * TILE_H * max(n, 2), device=device, **DRYRUN)
    badge = np.zeros((24, 24, 4), np.uint8)
    badge[4:20, 4:20] = [255, 200, 40, 220]
    sprite_id = ctx.add_sprite(badge)
    rl = make_rl(0.0)
    rl.push_sprite((8.0, 8.0, 24.0, 24.0), sprite_id)
    sceneset = make_sceneset(camera, params, point_lights=rl.point_lights,
                             spot_lights=rl.spot_lights)
    return ctx.config, ctx.device_state(device), ctx.frame_draws(rl, camera), sceneset


def dryrun_rank(bands, n):
    """One rank of the dry run: its sharded frame and ledger (a fresh
    ledger), and on rank 0 the single-device frame too."""
    from .parallel import ici_report, render_frame_sharded
    from .render import frame as F

    cfg, state, draws, sceneset = dryrun_inputs(n, bands.device)
    ici_report(reset=True)
    out = render_frame_sharded(cfg, bands, state, draws, sceneset)
    res = dict(image=out["image"].cpu().numpy(), luminance=float(out["luminance"]),
               bin_overflow=int(out["bin_overflow"]), ledger=ici_report(reset=True))
    if bands.rank == 0:
        ref = F.render_frame(cfg, state, draws, sceneset, device=bands.device)
        res["reference"] = ref["image"].cpu().numpy()
    return res


def rank_devices(n, device):
    """Each rank's device: the CPU, one card a rank ("cuda" with a card
    for every rank) or the one card ("cuda:0") for all."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    if torch.cuda.device_count() >= n and torch.device(device).index is None:
        return [f"cuda:{r}" for r in range(n)]
    return [str(torch.device(device, 0) if torch.device(device).index is None
                else torch.device(device))] * n


def dryrun_multichip(n, *, device, backend, verbose=True):
    """The tile-sharded dry run over n spawned ranks (module docstring).
    Raises AssertionError when the gate fails, and the spawn's error when
    a rank does.  Returns dict(image, rmse, luminance, ledger)."""
    from .parallel import spawn_bands

    devices = rank_devices(n, device)
    if backend == "nccl" and len(set(devices)) < n:
        raise ValueError(f"nccl needs a card a rank: {n} ranks on {devices}")
    if torch.device(devices[0]).type == "cuda":
        from .ops import _kernels
        _kernels.library()                 # built once, before the ranks start
    results = spawn_bands(dryrun_rank, n, backend=backend, devices=devices, args=(n,))
    res = dryrun_gate(results, n)
    if verbose:
        ledger = res["ledger"]
        print(f"dryrun_multichip({n}): image {res['image'].shape}, luminance "
              f"{res['luminance']:.4f}, nonzero coverage "
              f"{(res['image'].max(-1) > 0).mean():.3f}, parity RMSE vs single-device "
              f"{res['rmse']:.5f} (full pass set; {backend} on {devices[0]})", flush=True)
        per = ", ".join(f"{k} {v / 1e6:.3f}" for k, v in sorted(
            ledger.items(), key=lambda kv: -kv[1]) if k != "TOTAL")
        print(f"collective bytes/frame/rank: total {ledger['TOTAL'] / 1e6:.3f} MB "
              f"({per})", flush=True)
    return res


def dryrun_gate(results, n):
    """The dry run's gate on its ranks' dryrun_rank results: every rank
    gathered the same image, of the config's shape, luminance >= 0,
    bin_overflow 0, RMSE < RMSE_GATE against the single-device frame.
    Returns dict(image, rmse, luminance, ledger) (rank 0's)."""
    from .ops.common import TILE_H

    img, ref = results[0]["image"], results[0]["reference"]
    rmse = float(np.sqrt(np.mean((img.astype(np.float32) / 255.0
                                  - ref.astype(np.float32) / 255.0) ** 2)))
    checks = [(all(np.array_equal(res["image"], img) for res in results),
               "the ranks gathered different images"),
              (img.shape == (2 * TILE_H * max(n, 2), DRYRUN["width"], 3),
               f"image {img.shape}"),
              (results[0]["luminance"] >= 0.0, f"luminance {results[0]['luminance']}"),
              (results[0]["bin_overflow"] == 0, f"bin_overflow {results[0]['bin_overflow']}"),
              (rmse < RMSE_GATE, f"sharded-vs-single RMSE {rmse}")]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"dryrun_multichip({n}): {what}")
    return dict(image=img, rmse=rmse, luminance=results[0]["luminance"],
                ledger=results[0]["ledger"])


def main(argv=None):
    ap = argparse.ArgumentParser("datum_tpu_torch.entry")
    ap.add_argument("mode", nargs="?", default="entry", choices=("entry", "multichip"))
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.mode == "multichip":
        backend = args.backend or ("nccl" if device == "cuda"
                                   and torch.cuda.device_count() >= args.n else "gloo")
        dryrun_multichip(args.n, device=device, backend=backend)
        return 0
    fn, fargs = entry(device)
    out = fn(*fargs)
    print("entry: image", tuple(out["image"].shape), "luminance", float(out["luminance"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

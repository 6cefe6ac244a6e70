"""The deferred lighting pass's kernel route (ops/lighting_cuda.py,
csrc/lighting.cu) on the CPU, no jax:

- CPU tensors, or use_kernel False, take the plain version and launch
  nothing;
- the launcher's packing (the params vector, the point light, spot and
  probe tables, the host counts, the band's ints) holds the sceneset's
  values, and the kernel's plain version on that packing
  (lighting_reference) gives the plain pass's hdr bit for bit, on every
  case of CASES (the card tests hold the kernel to the plain pass on the
  same cases, tests/test_torch_cuda.py);
- the launcher refuses CPU tensors and bad shapes rather than falling
  back;
- chip_smoke.py's bound of the kernel counts a background pixel's mask
  and hdr write only.

`lighting_case(name, device)` builds a case: datumtest_scene's sceneset
and environment at 128x64 with seeded random gbuffers, depth, ssao,
probes and shadow maps.
"""

import functools

import numpy as np
import pytest
import torch

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import lighting_cuda, lighting_pass, shadow
from datum_tpu_torch.ops.cluster import bin_lights
from datum_tpu_torch.render.frame import host_light_counts
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

H, W = 64, 128
# probes: live SH probes; points: live point lights (dense unless
# clustered); spot: a shadowed spot ("map"), an unshadowed one ("nomap")
# or none; sun: the ESM or PCF factor or none; env: the SH + quad fast
# path ("fast"), the per-pixel taps ("pixel"), the box probes' override
# ("box") or no IBL; band: the frame's bottom half (y0 = H of 2H rows)
BASE = dict(probes=0, points=8, cluster=False, spot="map", sun="esm", env="fast",
            band=False, ssao=True)
CASES = {
    "probes0": {},
    "probes3": dict(probes=3, sun="pcf", spot="nomap"),
    "probes8": dict(probes=8, points=5),
    "points0": dict(points=0, spot=None, sun=None, ssao=False),
    "points5": dict(points=5, probes=3, env="pixel", sun="pcf"),
    "clustered": dict(cluster=True),
    "spot_nomap": dict(spot="nomap"),
    "env_pixel": dict(env="pixel", probes=3),
    "env_box": dict(env="box", probes=3),
    "no_ibl": dict(env=None, probes=3),
    "band": dict(band=True, probes=3),
}


@functools.lru_cache(maxsize=4)
def _scene(local_env, device):
    ctx, camera, params, make_rl = datumtest_scene(
        width=W, height=H, sphere_detail=4, grid=(2, 2), n_point_lights=8, skybox=True,
        skybox_size=8, local_env=local_env, device=device, enable_shadows=False)
    return ctx.device_state(device)["ibl"], camera, params, make_rl(0.3)


def lighting_case(name, device="cpu"):
    """(shade_deferred's positional args (gbuffer, depth, sceneset), its
    keyword args without use_kernel) of CASES[name] on device."""
    case = dict(BASE, **CASES[name])
    dev = torch.device(device)
    ibl, camera, params, rl = _scene(case["env"] == "box", str(dev))
    rs = np.random.RandomState(sorted(CASES).index(name))
    probes = [dict(position=rs.uniform(-4, 4, 3), sh=rs.uniform(-0.3, 1.0, (9, 3)),
                   radius=rs.uniform(2, 8)) for _ in range(case["probes"])]
    n_spot = 0 if case["spot"] is None else 1
    ss = make_sceneset(camera, params, point_lights=rl.point_lights[:case["points"]],
                       spot_lights=rl.spot_lights[:n_spot], probes=probes)
    lights = host_light_counts(ss)
    ss = to_torch(ss, dev)
    fh = 2 * H if case["band"] else H
    f32 = lambda *shape, lo=0.0, hi=1.0: torch.from_numpy(
        rs.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    gbuffer = dict(normal=f32(H, W, 4), diffuse=f32(H, W, 4), specular=f32(H, W, 4),
                   mask=torch.from_numpy(rs.rand(H, W) > 0.15).to(dev))
    gbuffer["diffuse"][..., 3] *= 0.3                # emissive 128 e^3 up to ~3.5
    depth = f32(H, W, lo=0.002, hi=0.05)
    kw = dict(proj=ss["proj"], invview=ss["invview"], light_counts=lights,
              ssao=f32(H, W, lo=0.3) if case["ssao"] else None,
              shadow_factor_scale=2, shadow_slice_blend=0.25)
    ml = ss["mainlight"]
    if case["sun"] == "esm":
        kw["shadowmaps"] = shadow.build_esm(f32(4, 128, 128, hi=0.1), ml["shadowview"])
    elif case["sun"] == "pcf":
        kw["shadowmaps"] = f32(4, 128, 128, hi=0.1)
    if case["spot"] == "map":
        kw["spotmaps"] = f32(1, 128, 128, hi=0.1)
    if case["env"] is not None:
        kw["ibl"] = ({k: v for k, v in ibl.items() if k != "flatq"}
                     if case["env"] == "pixel" else ibl)
    if case["cluster"]:
        pl = ss["pointlights"]
        lists, counts = bin_lights(pl["position"], pl["attenuation"][:, 3], pl["count"],
                                   ss["view"], ss["proj"], 1, 2, W, H, 8)
        kw["cluster"] = (lists, counts, 1, 2)
    if case["band"]:
        kw.update(full_size=(fh, W), y0=H)
    return (gbuffer, depth, ss), kw


def _kernel_route(monkeypatch):
    """Every tensor reads as a CUDA one and the launcher is the kernel's
    plain version: shade_deferred takes the kernel's route on the CPU.
    Returns the list of the packed arguments it was given."""
    given = []

    def launch(**inp):
        given.append(inp)
        return lighting_cuda.lighting_reference(**inp)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(lighting_cuda, "lighting_cuda", launch)
    return given


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_packing_through_the_plain_kernel_equals_the_plain_pass(name, monkeypatch):
    """The kernel route's packing, unpacked by lighting_reference, gives
    the plain pass's hdr bit for bit; each term reaches the image."""
    args, kw = lighting_case(name)
    plain = lighting_pass.shade_deferred(*args, **kw, use_kernel=False)
    given = _kernel_route(monkeypatch)
    routed = lighting_pass.shade_deferred(*args, **kw, use_kernel=True)
    monkeypatch.undo()
    assert len(given) == 1 and routed.shape == (H, W, 3)
    assert torch.isfinite(plain).all() and float(plain.mean()) > 0.01
    assert torch.equal(routed, plain)
    inp = given[0]
    assert (inp["env_spec"] is None) == ("ibl" not in kw)
    # the fast path leaves the sky's SH-9 diffuse to the kernel
    assert (inp["env_diff"] is None) == (dict(BASE, **CASES[name])["env"] in ("fast", None))


def test_packing_holds_the_sceneset():
    """The params vector and the tables hold the sceneset's values, the
    counts the host's, the ints the band's."""
    (gbuffer, depth, ss), kw = lighting_case("band")
    ibl = kw["ibl"]
    inp = lighting_cuda.lighting_inputs(
        gbuffer, depth, ss, proj=kw["proj"], invview=kw["invview"],
        light_counts=kw["light_counts"], ssao=kw["ssao"],
        env=(torch.zeros(H, W, 3), None, torch.zeros(H, W, 3)), sky_sh=ibl["sh"],
        spotmaps=kw["spotmaps"], y0=kw["y0"], full_size=kw["full_size"])
    P = inp["params"]
    par = lambda name: lighting_cuda._param(P, name)
    cam, ml = ss["camera"], ss["mainlight"]
    assert P.shape == (lighting_cuda.PARAMS,)
    assert torch.equal(par("proj"), torch.stack([ss["proj"][0, 0], ss["proj"][1, 1],
                                                 ss["proj"][2, 2], ss["proj"][2, 3]]))
    assert torch.equal(par("invview").reshape(3, 4), ss["invview"][:3])
    for name, v in (("sun_direction", ml["direction"]), ("sun_intensity", ml["intensity"]),
                    ("sun_cutoff", ml["cutoff"]), ("ambient", cam["ambientintensity"]),
                    ("exposure", cam["exposure"]),
                    ("specularintensity", cam["specularintensity"]),
                    ("skyrot", cam["skyrot_inv"].reshape(-1)),
                    ("sky_sh", ibl["sh"].reshape(-1))):
        assert torch.equal(par(name), v), name
    pl, sl, pr = ss["pointlights"], ss["spotlights"], ss["probes"]
    L = inp["lights"]
    assert L.shape == (pl["position"].shape[0], lighting_cuda.LROW)
    assert torch.equal(L[:, :10], torch.cat([pl["position"], pl["intensity"],
                                             pl["attenuation"]], 1))
    S = inp["spots"]
    assert torch.equal(S[:, :14], torch.cat([sl["position"], sl["intensity"],
                                             sl["attenuation"], sl["direction"],
                                             sl["cutoff"][:, None]], 1))
    assert torch.equal(S[:, 14:30].reshape(-1, 4, 4), sl["shadowview"])
    Q = inp["probes"]
    assert torch.equal(Q[:, :4], pr["position"])
    assert torch.equal(Q[:, 4:31].reshape(-1, 9, 3), pr["sh"])
    assert inp["probe_count"].tolist() == [int(pr["count"])] == [3]
    assert (inp["n_point"], inp["n_spot"]) == kw["light_counts"] == (8, 1)
    assert (inp["y0"], inp["full_h"], inp["full_w"]) == (H, 2 * H, W)
    assert all(type(inp[k]) is int for k in ("n_point", "n_spot", "tiles_x", "y0",
                                              "full_h", "full_w"))


@pytest.mark.parametrize("name", ["probes3", "clustered", "env_box", "band"])
def test_kernel_route_reads_no_tensor_on_the_host(name, monkeypatch):
    """The kernel route's packing, which runs inside the frame's CUDA
    graphs, reads no tensor value on the host (a capture would refuse
    it): the probe count stays on the device, the light counts are the
    host's ints."""
    from test_torch_framegraph import _host_reads

    args, kw = lighting_case(name)
    lighting_pass.shade_deferred(*args, **kw)      # the cached resize matrices, once
    given = _kernel_route(monkeypatch)
    assert _host_reads(lambda: lighting_pass.shade_deferred(*args, **kw,
                                                            use_kernel=True)) == []
    assert len(given) == 1


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cpu_tensors_take_the_plain_version(use_kernel):
    """Without a card the route is the plain pass whatever use_kernel
    says, and the enrolled launcher counts no launch."""
    args, kw = lighting_case("probes3")
    before = lighting_cuda.lighting_cuda.launches
    out = lighting_pass.shade_deferred(*args, **kw, use_kernel=use_kernel)
    assert lighting_cuda.lighting_cuda.launches == before
    assert torch.equal(out, lighting_pass.shade_deferred(*args, **kw))


def test_launcher_refuses_cpu_tensors_and_bad_shapes():
    """The launcher raises on CPU tensors before it builds anything, and
    on a plane of the wrong shape on any device."""
    (gbuffer, depth, ss), kw = lighting_case("probes0")
    inp = lighting_cuda.lighting_inputs(gbuffer, depth, ss, proj=kw["proj"],
                                        invview=kw["invview"],
                                        light_counts=kw["light_counts"])
    before = lighting_cuda.lighting_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        lighting_cuda.lighting_cuda(**inp)
    with pytest.raises(ValueError, match="cluster tiles"):
        lighting_cuda.lighting_inputs(gbuffer, depth, ss, proj=kw["proj"],
                                      invview=kw["invview"], light_counts=(8, 1),
                                      cluster=(None, None, 2, 2))
    assert lighting_cuda.lighting_cuda.launches == before


def test_smoke_bound_counts_only_covered_pixels(monkeypatch):
    """chip_smoke.py's bound of the kernel: every pixel reads its mask and
    writes 12 B of hdr; a covered pixel also reads its planes (84 B on the
    fast environment path with ssao and the sun factor); the spot map and
    the tables are read once."""
    import chip_smoke

    args, kw = lighting_case("probes0")
    given = _kernel_route(monkeypatch)
    lighting_pass.shade_deferred(*args, **kw, use_kernel=True)
    monkeypatch.undo()
    inp = given[0]
    assert inp["env_diff"] is None and inp["cl_lists"] is None
    fixed = sum(inp[k].numel() * inp[k].element_size()
                for k in ("spotmaps", "params", "lights", "spots", "probes", "probe_count"))
    for mask in (torch.zeros(H, W, dtype=torch.bool), torch.ones(H, W, dtype=torch.bool),
                 inp["mask"]):
        ms, by, nbytes, covered = chip_smoke.lighting_bound(dict(inp, mask=mask))
        assert covered == int(mask.sum())
        assert nbytes == H * W * 13 + covered * 84 + fixed
        assert by == "bytes" and ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)

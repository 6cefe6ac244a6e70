"""K2: the deferred-shade megakernel, plain.

Counterpart of datum_tpu/ops/shade_pallas.py (`shade_deferred_pallas`;
its Pallas body `_shade_kernel` becomes csrc/shade.cu, and its epilogue
of the translucent groups csrc/shade_epilogue.cu).  `shade_deferred`
builds the params, light, spot and probe tables, rounds the input
planes to bf16 exactly where the TPU path does (every plane but depth
and visf, plus ao and the spot factor planes — the rounding is part of
the contract, not an optimisation), then runs the plain PyTorch
versions (`shade_deferred_reference`, then `shade_epilogue_reference`)
on every device.

Supported: PLANE_NAMES, the sky fill (SKY_NAMES), the box env-probe
diffuse override (ENVD_NAMES: where edm > 0.5 after its bf16 rounding,
edr/edg/edb replace the SH-9 env diffuse, before the SH probe blend),
ao, shadowed spot slots (spotsf), SH probes, dense point lights or the
clustered lights' per-sub-tile lists (`clusters=`, from ops/cluster.py),
the lit translucent layers (TR_NAMES and the deeper tr2..tr4), the
refraction offsets (REFR_NAMES), the volumetric fog (FOG_NAMES), the
WBOIT resolve (OIT_NAMES) and planes_out.  K2 shades and blends the
deeper layers; what reads neighbouring pixels (the refraction of the
nearest layer), that layer's blend, the fog and the WBOIT resolve run in
the epilogue, which runs only when one of those groups is given.

Band mode (the tile-sharded frame): the planes are a band of rows of the
frame; `y0`, its first row, rides params[26] and `full_height`, the
frame's, sets the NDC scale 2 / H, so the view rays are the frame's.  The
epilogue's refraction wraps inside 16-row bands, which a band of whole
32-row tiles holds whole: it needs nothing.
"""

from __future__ import annotations


import numpy as np
import torch

from .common import fma

PLANE_NAMES = ["depth", "visf", "nx", "ny", "nz", "dr", "dg", "db", "em",
               "sr", "sg", "sb", "rgh",
               "esr", "esg", "esb", "eb0", "eb1", "eb2", "sf"]
SKY_NAMES = ["sky_r", "sky_g", "sky_b"]
ENVD_NAMES = ["edr", "edg", "edb", "edm"]       # box env-probe diffuse override
F32_PLANES = ("depth", "visf")
BF16_NAMES = [n for n in PLANE_NAMES if n not in F32_PLANES]
TR_NAMES = ["tr_r", "tr_g", "tr_b", "tr_a"]     # nearest lit translucent layer
MAX_TR_LAYERS = 4


def trk_names(k):
    """The planes of the k-th nearest lit layer (k = 2..MAX_TR_LAYERS)."""
    return [f"tr{k}_r", f"tr{k}_g", f"tr{k}_b", f"tr{k}_a"]


REFR_NAMES = ["tr_ox", "tr_oy"]                 # refraction offsets (px)
FOG_NAMES = ["fog_r", "fog_g", "fog_b", "fog_t"]     # in-scatter, transmittance
OIT_NAMES = ["oit_r", "oit_g", "oit_b", "oit_w", "oit_rev"]
SHADE_ROWS = 16     # the TPU kernel's row band: vertical refraction wraps in it
SUBTILE_W = 128     # columns of a sub-tile: each walks its own light list

INV_PI = 0.3183098861837907
POINT_CHUNK = 8   # point lights per loop trip (reads past the count clamp)


def shade_inputs(gplanes, sceneset, *, proj, invview, ao=None, spotsf=None,
                 clusters=None, y0=0, full_height=None):
    """Pack the K2 arguments both versions take (see shade_deferred)."""
    given = [k in gplanes for k in ENVD_NAMES]
    if any(given) and not all(given):
        raise ValueError(f"shade_deferred: the planes {ENVD_NAMES} come as a group")
    depth = gplanes["depth"]
    dev = depth.device
    H, W = depth.shape
    f32 = dict(dtype=torch.float32, device=dev)
    cl_lists = cl_counts = None
    if clusters is not None:
        cl_lists, cl_counts = clusters
        nb, ns = cl_lists.shape[:2]
        if (nb * SHADE_ROWS, ns * SUBTILE_W) != (H, W) or tuple(cl_counts.shape) != (nb, ns):
            raise ValueError(f"shade_deferred: clusters of {nb} bands x {ns} "
                             f"sub-tiles do not cover {H}x{W} in {SHADE_ROWS}-row "
                             f"bands of {SUBTILE_W}-column sub-tiles")
        cl_lists = cl_lists.to(torch.int32).contiguous()
        cl_counts = cl_counts.to(torch.int32).contiguous()

    ml = sceneset["mainlight"]
    cam = sceneset["camera"]
    iv = invview
    params = torch.zeros(64, **f32)
    params[0] = 1.0 / proj[0, 0]
    params[1] = 1.0 / proj[1, 1]
    params[2] = proj[2, 2]
    params[3] = proj[2, 3]
    params[4:16] = iv[:3, :4].reshape(-1)
    params[16:19] = -ml["direction"]
    params[19:22] = ml["intensity"]
    params[22] = ml["cutoff"]
    params[23] = cam["ambientintensity"]
    params[24] = cam["exposure"]
    params[25] = cam["specularintensity"]
    params[26] = float(y0)                # the band's first row of the frame
    params[27:54] = sceneset["_sh"].reshape(-1)

    pl_ = sceneset["pointlights"]
    L = pl_["position"].shape[0]
    lights = torch.cat([pl_["position"], pl_["intensity"], pl_["attenuation"],
                        torch.zeros((L, 6), **f32)], 1).contiguous()
    sl = sceneset["spotlights"]
    S = sl["position"].shape[0]
    spots = torch.cat([sl["position"], sl["intensity"], sl["attenuation"],
                       sl["direction"], sl["cutoff"][:, None],
                       torch.zeros((S, 2), **f32)], 1).contiguous()
    pr = sceneset["probes"]
    N = pr["position"].shape[0]
    probes = torch.cat([pr["position"], pr["sh"].reshape(N, 27),
                        torch.zeros((N, 1), **f32)], 1).contiguous()
    i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(())
    counts = torch.stack([torch.clamp(i32(pl_["count"]), max=L),
                          torch.clamp(i32(sl["count"]), max=S),
                          i32(0), i32(pr["count"])])

    trk = [trk_names(k) for k in range(2, MAX_TR_LAYERS + 1)
           if f"tr{k}_r" in gplanes]
    names = (BF16_NAMES + (SKY_NAMES if "sky_r" in gplanes else [])
             + (ENVD_NAMES if all(given) else []) + [n for grp in trk for n in grp])
    return dict(
        f32_planes=torch.stack([gplanes["depth"], gplanes["visf"]]).contiguous(),
        planes=_bf16(torch.stack([gplanes[k] for k in names])),
        has_sky="sky_r" in gplanes, envd=all(given), n_trk=len(trk),
        ao=None if ao is None else _bf16(ao),
        spotsf=None if spotsf is None else _bf16(spotsf),
        params=params, lights=lights, spots=spots, probes=probes,
        counts=counts, cl_lists=cl_lists, cl_counts=cl_counts,
        full_height=H if full_height is None else int(full_height))


def _bf16(x):
    return x.to(torch.bfloat16).contiguous()


def epilogue_inputs(gplanes):
    """The epilogue's arguments (tr, refr, fog, oit: (4|2|4|5, H, W) bf16
    stacks or None), rounded to bf16 as the TPU path rounds them; None
    when gplanes carries none of the groups (the epilogue then does not
    run).  refr is used only with tr, as in the TPU kernel.  A group is
    given whole or not at all."""
    groups = []
    for grp in (TR_NAMES, REFR_NAMES, FOG_NAMES, OIT_NAMES):
        given = [k in gplanes for k in grp]
        if any(given) and not all(given):
            raise ValueError(f"shade_deferred: the planes {grp} come as a group, "
                             f"got {[k for k in grp if k in gplanes]}")
        groups.append(_bf16(torch.stack([gplanes[k] for k in grp]))
                      if all(given) else None)
    if groups[0] is None:
        groups[1] = None
    return None if groups == [None] * 4 else dict(zip(("tr", "refr", "fog", "oit"),
                                                      groups))


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(a):
    inv = torch.rsqrt(torch.clamp(_dot3(a, a), min=1e-12))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _angles(nrm, eye, lv):
    hv = _normalize3((lv[0] + eye[0], lv[1] + eye[1], lv[2] + eye[2]))
    return (torch.clamp(_dot3(nrm, eye), min=0.0),
            torch.clamp(_dot3(nrm, lv), min=0.0),
            torch.clamp(_dot3(nrm, hv), min=0.0), _sat(_dot3(lv, hv)))


def _disney(ndv, ndl, ldh, alpha):
    bias = 0.5 * alpha
    factor = 1.0 + alpha * (1.0 / 1.51 - 1.0)
    f90 = bias + 2.0 * ldh * ldh * alpha
    ls = 1.0 + (f90 - 1.0) * _pow5(_sat(1.0 - ndl))
    vs = 1.0 + (f90 - 1.0) * _pow5(_sat(1.0 - ndv))
    return ls * vs * factor


def _spec_ggx(spec, ndv, ndl, ldh, ndh, alpha):
    fc = _pow5(_sat(1.0 - ldh))
    f = tuple(s + (1.0 - s) * fc for s in spec)
    k = alpha * 0.5
    gv = ndv * (1 - k) + k
    gl = ndl * (1 - k) + k
    vis = 0.25 / (gv * gl + 1e-5)
    a2 = alpha * alpha
    d = (ndh * a2 - ndh) * ndh + 1.0
    dist = a2 / (d * d)
    return tuple(fi * (vis * dist) for fi in f)


def _eval_light(wp, nrm, eye, spec, alpha, row):
    """One point light; row = (16,) [pos, intensity, attenuation, ...]."""
    tolight = (row[0] - wp[0], row[1] - wp[1], row[2] - wp[2])
    d2 = torch.clamp(_dot3(tolight, tolight), min=1e-12)
    inv_d = torch.rsqrt(d2)
    dist = d2 * inv_d
    lv = (tolight[0] * inv_d, tolight[1] * inv_d, tolight[2] * inv_d)
    ndv, ndl, ndh, ldh = _angles(nrm, eye, lv)
    fd = _disney(ndv, ndl, ldh, alpha) * INV_PI
    fr = _spec_ggx(spec, ndv, ndl, ldh, ndh, alpha)
    att = 1.0 / torch.clamp(row[8] + row[7] * dist + row[6] * d2, min=1e-9)
    dr2 = d2 / torch.clamp(row[9] * row[9], min=1e-12)
    fall = _sat(1.0 - dr2 * dr2)
    w = ndl * att * (fall * fall)
    dif = tuple(w * fd * row[3 + c] for c in range(3))
    spc = tuple(w * INV_PI * fr[c] * row[3 + c] for c in range(3))
    return dif, spc, lv


def _sh_basis(x, y, z):
    return (0.886227, 1.023326 * y, 1.023326 * z, 1.023326 * x,
            0.858086 * x * y, 0.858086 * y * z,
            0.247708 * (3 * z * z - 1.0), 0.858086 * z * x,
            0.429043 * (x * x - y * y))


def _cluster_lights(lights, n_point, cl_lists, cl_counts):
    """Per pixel, list slot j of its (band, sub-tile): yields (the (H, W)
    light rows as 16 planes, the (H, W) mask j < count).  Ids are
    clamped to the live rows, as the kernel stages them."""
    l_rows = min(lights.shape[0], max(n_point, 1))
    up = lambda t: t.repeat_interleave(SHADE_ROWS, 0).repeat_interleave(SUBTILE_W, 1)
    count = up(cl_counts)
    for j in range(int(cl_counts.max()) if cl_counts.numel() else 0):
        lid = torch.clamp(up(cl_lists[:, :, j]), 0, l_rows - 1).long()
        yield lights[lid].unbind(-1), j < count


def _group_names(has_sky, envd):
    """The bf16 planes before the deeper lit layers, in packing order."""
    return (BF16_NAMES + (SKY_NAMES if has_sky else [])
            + (ENVD_NAMES if envd else []))


def shade_deferred_reference(f32_planes, planes, has_sky, ao, spotsf, params,
                             lights, spots, probes, counts, n_trk=0,
                             cl_lists=None, cl_counts=None, envd=False,
                             full_height=None):
    """Plain PyTorch K2: (3, H, W) f32 HDR planes (the kernel's math,
    operation for operation).  With cl_lists (H/16, W/128, cap) and
    cl_counts (H/16, W/128), each pixel adds the point lights of its
    16-row band's and 128-column sub-tile's list, slots j < count in list
    order, instead of every light.  With envd, the planes after the sky
    carry ENVD_NAMES.  full_height: the frame's height when the planes
    are a band of it from row params[26] (default H)."""
    P = params
    dev = P.device
    _, H, W = f32_planes.shape
    names = _group_names(has_sky, envd)
    nb = len(names)
    g = dict(zip(names, planes[:nb].to(torch.float32).unbind(0)))
    trk = planes[nb:].to(torch.float32).reshape(n_trk, 4, H, W)
    depth, visf = f32_planes[0], f32_planes[1]
    mask = visf >= 0.0
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    yn = (P[26] + yy + 0.5) * float(np.float32(2.0 / (full_height or H))) - 1.0
    xn = (xx + 0.5) * float(np.float32(2.0 / W)) - 1.0

    denom = depth + P[2]
    eps = torch.where(denom < 0, torch.full_like(denom, -1e-7),
                      torch.full_like(denom, 1e-7))
    denom = torch.where(torch.abs(denom) < 1e-7, eps, denom)
    dist = P[3] / denom
    vx = P[0] * xn * dist
    vy = P[1] * yn * dist
    vz = -dist
    wp = (P[4] * vx + P[5] * vy + P[6] * vz + P[7],
          P[8] * vx + P[9] * vy + P[10] * vz + P[11],
          P[12] * vx + P[13] * vy + P[14] * vz + P[15])
    eye = _normalize3((P[7] - wp[0], P[11] - wp[1], P[15] - wp[2]))

    nrm = _normalize3((g["nx"], g["ny"], g["nz"]))
    dcol = (g["dr"], g["dg"], g["db"])
    scol = (g["sr"], g["sg"], g["sb"])
    rough = g["rgh"]
    alpha = rough * rough
    espec = (g["esr"], g["esg"], g["esb"])
    eb0, eb1, eb2 = g["eb0"], g["eb1"], g["eb2"]

    ambient = P[23]
    if ao is not None:
        ambient = ambient * ao.to(torch.float32)
    ndv_s = _dot3(nrm, eye)
    fdd = _sat(((ndv_s * (1.02341 * rough - 1.51174))
                + (-0.511705 * rough + 0.755868)) * rough)
    ddir = _normalize3(tuple(n + (e - n) * fdd for n, e in zip(nrm, eye)))
    basis = _sh_basis(*ddir)
    env = []
    for c in range(3):
        acc = basis[0] * P[27 + c]
        for k in range(1, 9):
            acc = acc + basis[k] * P[27 + 3 * k + c]
        env.append(torch.clamp(acc, min=0.0) * INV_PI)
    if envd:
        # the box probes' diffuse, on the bf16 edm (0.5 itself keeps SH-9)
        env = [torch.where(g["edm"] > 0.5, g["ed" + ch], e) for ch, e in zip("rgb", env)]

    n_probe = min(int(counts[3]), probes.shape[0])
    if probes.shape[0] > 0:
        pb = _sh_basis(*nrm)
        total_w = torch.ones_like(depth)
        for pi in range(n_probe):
            q = probes[pi]
            dx, dy, dz = q[0] - wp[0], q[1] - wp[1], q[2] - wp[2]
            pd = torch.sqrt(dx * dx + dy * dy + dz * dz)
            drr = pd / torch.clamp(q[3], min=1e-6)
            dr2 = drr * drr
            att = _sat(1.0 - dr2 * dr2)
            att = att * att
            for c in range(3):
                irr = pb[0] * q[4 + c]
                for k in range(1, 9):
                    irr = irr + pb[k] * q[4 + 3 * k + c]
                env[c] = env[c] + torch.clamp(irr, min=0.0) * att
            total_w = total_w + att
        inv_tw = 1.0 / total_w
        env = [e * inv_tw for e in env]

    dif = [e * eb2 * ambient for e in env]
    spc = [es * (sc * eb0 + 0.8 * eb1) * ambient * P[25]
           for es, sc in zip(espec, scol)]

    # sun: shadow-factor plane + bent light vector
    sf = g["sf"]
    ldir = (P[16], P[17], P[18])
    d2e = 2.0 * _dot3(nrm, eye)
    r_ = tuple(n * d2e + e * -1.0 for n, e in zip(nrm, eye))
    ldr = _dot3(ldir, r_)
    bent = tuple(l + (r - l) * rough for l, r in zip(ldir, r_))
    use_bent = ldr >= P[22]
    lv = _normalize3(tuple(torch.where(use_bent, b, l.expand_as(b))
                           for b, l in zip(bent, ldir)))
    ndv, ndl, ndh, ldh = _angles(nrm, eye, lv)
    fd = _disney(ndv, ndl, ldh, alpha) * INV_PI
    fr = _spec_ggx(scol, ndv, ndl, ldh, ndh, alpha)
    wsun = ndl * sf
    for c in range(3):
        dif[c] = dif[c] + wsun * fd * P[19 + c]
        spc[c] = spc[c] + wsun * INV_PI * fr[c] * P[19 + c]

    n_point = int(counts[0])
    L = lights.shape[0]
    if cl_lists is not None:
        # clustered: the pixel's band and sub-tile list, j < count
        for row, on in _cluster_lights(lights, n_point, cl_lists, cl_counts):
            d_i, s_i, _ = _eval_light(wp, nrm, eye, scol, alpha, row)
            for c in range(3):
                dif[c] = torch.where(on, dif[c] + d_i[c], dif[c])
                spc[c] = torch.where(on, spc[c] + s_i[c], spc[c])
    else:
        # dense point lights in chunks (clamped reads, `on` mask)
        nchunks = (n_point + POINT_CHUNK - 1) // POINT_CHUNK
        for idx in range(nchunks * POINT_CHUNK):
            on = 1.0 if idx < n_point else 0.0
            d_i, s_i, _ = _eval_light(wp, nrm, eye, scol, alpha,
                                      lights[min(idx, L - 1)])
            for c in range(3):
                dif[c] = dif[c] + on * d_i[c]
                spc[c] = spc[c] + on * s_i[c]

    # spots: shadowed slots (factor planes), then the unshadowed rest
    n_spot = int(counts[1])
    S = spots.shape[0]
    n_maps = 0 if spotsf is None else spotsf.shape[0]
    for m in range(n_maps + max(n_spot - n_maps, 0)):
        row = spots[min(m, S - 1)]
        shadow = spotsf[m].to(torch.float32) if m < n_maps else 1.0
        d_i, s_i, lv2 = _eval_light(wp, nrm, eye, scol, alpha, row)
        cone = _sat((-_dot3((row[10], row[11], row[12]), lv2) - row[13]) * 20.0)
        on = (1.0 if m < n_spot else 0.0) * cone * shadow
        for c in range(3):
            dif[c] = dif[c] + on * d_i[c]
            spc[c] = spc[c] + on * s_i[c]

    exposure = P[24]
    em = g["em"]
    em_term = 128.0 * em * em * em
    zero = torch.zeros_like(depth)
    out = []
    for c, ch in enumerate("rgb"):
        col = dcol[c] * (dif[c] + em_term) + spc[c]
        col = torch.where(mask, col * exposure, zero)
        if has_sky:
            col = torch.where(mask, col, g[f"sky_{ch}"] * exposure)
        out.append(col)
    # the deeper lit translucent layers, deepest first
    for k in range(n_trk - 1, -1, -1):
        a = trk[k, 3]
        out = [b * (1.0 - a) + trk[k, c] * a for c, b in enumerate(out)]
    return torch.stack(out)


def _pick(off, steps):
    """The ladder step nearest off per pixel (ties keep the earlier step)."""
    best = torch.full_like(off, 1e9)
    pick = torch.zeros_like(off)
    for s in steps:
        d = torch.abs(off - s)
        pick = torch.where(d < best, torch.full_like(off, float(s)), pick)
        best = torch.minimum(best, d)
    return pick


def _shift(planes, off, axis, steps):
    """planes (3, H, W) shifted per pixel by the step nearest off: pixel i
    reads i + step along axis, wrapping over the row (axis 2) or inside
    its SHADE_ROWS band (axis 1)."""
    _, H, W = planes.shape
    pick = _pick(off, steps)
    out = torch.zeros_like(planes)
    for s in steps:
        if axis == 2:
            rolled = torch.roll(planes, -s, dims=2)
        else:
            rolled = torch.roll(planes.reshape(3, H // SHADE_ROWS, SHADE_ROWS, W),
                                -s, dims=2).reshape(3, H, W)
        out = torch.where(pick == s, rolled, out)
    return out


def shade_epilogue_reference(bg, tr=None, refr=None, fog=None, oit=None):
    """Plain PyTorch epilogue: (3, H, W) f32 from K2's lit background bg
    (3, H, W): refraction x then y (band-local), the nearest lit layer's
    blend, the fog and the WBOIT resolve, as the TPU kernel's epilogue."""
    col = bg
    if tr is not None:
        t = tr.to(torch.float32)
        a = t[3]
        b = col
        if refr is not None:
            r = refr.to(torch.float32)
            b = _shift(b, r[0], 2, (-8, -3, 0, 3, 8))
            b = _shift(b, r[1], 1, (-4, -2, 0, 2, 4))
            b = torch.where(a > 0.0, b, col)
        col = b * (1.0 - a) + t[:3] * a
    if fog is not None:
        f = fog.to(torch.float32)
        # one fma, as XLA contracts the TPU kernel's col * fog_t + fog_rgb
        col = fma(col, f[3], f[:3])
    if oit is not None:
        q = oit.to(torch.float32)
        inv_w = 1.0 / torch.clamp(q[3], min=1e-5)
        oit_alpha = 1.0 - q[4]
        # one fma, as XLA contracts the TPU kernel's resolve col * rev +
        # oit * inv_w * (1 - rev): after the refraction's selects it
        # fuses the second product, otherwise the first
        if tr is not None and refr is not None:
            col = fma(q[:3] * inv_w, oit_alpha, col * q[4])
        else:
            col = fma(col, q[4], q[:3] * inv_w * oit_alpha)
    return col


def shade_deferred(gplanes, sceneset, *, proj, invview, ao=None, spotsf=None,
                   planes_out=False, clusters=None, y0=0, full_height=None):
    """Deferred shade of one layer.

    gplanes: dict of (H, W) f32 planes PLANE_NAMES [+ SKY_NAMES, ENVD_NAMES,
    TR_NAMES, trk_names(2..4), REFR_NAMES, FOG_NAMES, OIT_NAMES]; ao: optional
    (H, W) ambient multiplier; spotsf: optional (n_maps, H, W) spot
    factors; sceneset carries "_sh" (9, 3).  Returns hdr (H, W, 3), or
    its three (H, W) planes with planes_out.  Band mode: the planes are
    rows y0 .. y0 + H - 1 of a frame full_height rows high.  Runs the
    plain PyTorch versions of K2 and, with a tr/refr/fog/oit group, of
    the epilogue, on every device."""
    inp = shade_inputs(gplanes, sceneset, proj=proj, invview=invview, ao=ao,
                       spotsf=spotsf, clusters=clusters, y0=y0,
                       full_height=full_height)
    epi = epilogue_inputs(gplanes)
    out = shade_deferred_reference(**inp)
    if epi is not None:
        out = shade_epilogue_reference(out, **epi)
    return tuple(out.unbind(0)) if planes_out else out.permute(1, 2, 0)

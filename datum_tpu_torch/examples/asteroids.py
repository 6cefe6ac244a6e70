"""example-asteroids on the port (counterpart of examples/asteroids.py): 96
spinning icospheres picked from a 3-level LOD chain by camera distance,
their transforms computed on the platform's worker pool (4 chunks,
joined before the frame).

    python -m datum_tpu_torch.examples.asteroids [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def _icosphere(subdiv):
    """Unit icosphere after subdiv midpoint subdivisions: (vertices dict,
    (F, 3) int32 faces)."""
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(map(tuple, verts))
    for _ in range(subdiv):
        cache = {}
        nf = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                v = np.asarray(verts[a]) + np.asarray(verts[b])
                v /= np.linalg.norm(v)
                cache[key] = len(verts)
                verts.append(tuple(v))
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nf
    v = np.asarray(verts, np.float32)
    return (dict(position=v, normal=v,
                 texcoord=np.stack([v[:, 0], v[:, 2]], -1) * 0.5 + 0.5,
                 tangent=np.tile([1, 0, 0, 1.0], (len(v), 1))),
            np.asarray(faces, np.int32))


def init(args):
    from ..ops.common import FrameConfig
    from ..platform import Platform
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=1 << 15, max_triangles=1 << 16,
                      max_instances=128, bin_capacity=1024, big_capacity=32,
                      enable_shadows=False)
    ctx = RenderContext(cfg, device=args.device)
    # LOD chain: detailed near, coarse far
    lods = [ctx.add_mesh(*_icosphere(s)) for s in (3, 2, 1)]
    mat = ctx.add_material(color=(0.5, 0.45, 0.4, 1), roughness=0.9)

    rng = np.random.RandomState(11)
    n = 96
    centers = rng.uniform([-30, -8, -60], [30, 8, -10], (n, 3)).astype(np.float32)
    radii = rng.uniform(0.4, 1.8, n).astype(np.float32)
    spins = rng.uniform(0.2, 1.5, n).astype(np.float32)
    axes = rng.randn(n, 3).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)

    cam = Camera()
    cam.set_projection(np.radians(60), args.width / args.height)
    cam.lookat(np.array([0.0, 0.0, 8.0]), np.array([0.0, 0.0, -30.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([-0.5, -0.3, -0.8], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([4.0, 3.9, 3.7], np.float32)
    params.ambientintensity = 0.15
    return dict(ctx=ctx, lods=lods, mat=mat, centers=centers, radii=radii,
                spins=spins, axes=axes, cam=cam, params=params,
                platform=Platform(workers=4), transforms=[None] * n, t=0.0)


def update(state, dt):
    from ..math import Transform

    state["t"] += dt
    t = state["t"]
    n = len(state["centers"])
    plat = state["platform"]
    chunk = (n + 3) // 4

    def work(lo, hi):
        for i in range(lo, hi):
            rot = Transform.rotation(state["axes"][i], state["spins"][i] * t)
            s = state["radii"][i]
            m = (Transform.translation(state["centers"][i]) * rot).matrix()[:3, :]
            m[:, :3] *= s
            state["transforms"][i] = m

    for k in range(4):
        plat.submit_work(work, k * chunk, min((k + 1) * chunk, n))
    plat.workqueue.wait(4)


def render(state):
    from ..render.renderlist import RenderList

    rl = RenderList()
    campos = state["cam"].position
    for i, m in enumerate(state["transforms"]):
        if m is None:
            continue
        d = np.linalg.norm(state["centers"][i] - campos)
        lod = 0 if d < 25 else (1 if d < 45 else 2)
        rl.push_mesh(state["lods"][lod], m, state["mat"])
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("asteroids", init, update, render, argv=argv)


if __name__ == "__main__":
    main()

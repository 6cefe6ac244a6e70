"""Process groups and collectives of the tile-sharded frame (counterpart
of datum_tpu/parallel/mesh.py, whose `make_device_mesh` builds a 1-D JAX
mesh over the devices).

Here each band of tile rows is a process (a rank) of a torch.distributed
group.  `init_bands` joins the group and returns a `Bands` handle; the
collectives the frame needs are `all_gather` (jax.lax.all_gather, tiled),
`all_reduce_sum` (jax.lax.psum) and `ring_shift` (jax.lax.ppermute over
the ring i -> i + step mod n).  `spawn_bands` starts n ranks on one host
and collects what each returns.

The backend is the caller's choice, never a fallback: "nccl" when every
rank has a GPU of its own; "gloo" for the CPU and for several ranks on
ONE card, which NCCL refuses.  PyTorch's backend table lists gloo's
all_gather, send and recv as CPU-only, so with gloo the collectives here
copy CUDA tensors to host memory, run the collective there and copy the
result back: the host staging is deliberate, not a workaround of a
failure.  Every group and every collective has a timeout
(COLLECTIVE_TIMEOUT_S): a rank that dies or stalls ends the run with an
error instead of hanging it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 120
BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Bands:
    """A rank's handle on the band group: the process group, its rank and
    world size, the device its tensors live on and the backend."""
    group: object
    rank: int
    world: int
    device: torch.device
    backend: str


def init_bands(rank: int, world: int, *, device, backend: str, init_method: str,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Bands:
    """Join a world-size group as `rank` (backend "nccl" or "gloo", see the
    module docstring) and return its Bands.  init_method: a torch
    rendezvous URL every rank is given ("file://..." or
    "tcp://localhost:<port>")."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device a rank")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # nccl binds the group to the rank's card (its barrier need not guess)
    bind = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s), **bind)
    return Bands(group=dist.group.WORLD, rank=rank, world=world, device=device,
                 backend=backend)


def close_bands(bands: Bands):
    """Leave the group (after a barrier, so that no rank tears it down
    under a peer's last collective)."""
    dist.barrier(group=bands.group)
    dist.destroy_process_group()


def _staged(bands: Bands, x):
    """x as the backend takes it: on the host for gloo (see the module
    docstring), else as it is."""
    return x.cpu() if bands.backend == "gloo" and x.is_cuda else x


def all_gather(bands: Bands, x, dim: int = 0):
    """Every rank's x concatenated along dim in rank order (jax.lax.
    all_gather with tiled=True)."""
    if bands.world == 1:
        return x
    if x.dtype == torch.bool:          # as bytes: not every backend reduces bool
        return all_gather(bands, x.to(torch.uint8), dim).bool()
    xs = _staged(bands, x.contiguous())
    parts = [torch.empty_like(xs) for _ in range(bands.world)]
    dist.all_gather(parts, xs, group=bands.group)
    return torch.cat(parts, dim).to(x.device)


def all_reduce_sum(bands: Bands, x):
    """The sum of every rank's x (jax.lax.psum)."""
    if bands.world == 1:
        return x
    xs = _staged(bands, x.clone())
    dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=bands.group)
    return xs.to(x.device)


def ring_shift(bands: Bands, x, step: int):
    """What rank (r - step) mod n sent: every rank sends x to (r + step)
    mod n (jax.lax.ppermute over that ring; it wraps, the callers mask
    the frame's edge bands)."""
    n = bands.world
    if n == 1:
        return x.clone()
    xs = _staged(bands, x.contiguous())
    out = torch.empty_like(xs)
    ops = [dist.P2POp(dist.isend, xs, (bands.rank + step) % n, bands.group),
           dist.P2POp(dist.irecv, out, (bands.rank - step) % n, bands.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


def _rank_main(rank, fn, world, backend, devices, store, out_dir, args):
    """One spawned rank: join the group, run fn(bands, *args), pickle what
    it returns into out_dir, leave the group."""
    torch.set_num_threads(1)
    bands = init_bands(rank, world, device=devices[rank], backend=backend,
                       init_method=f"file://{store}")
    result = fn(bands, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    close_bands(bands)


def spawn_bands(fn, world: int, *, backend: str, devices, args=()):
    """Run fn(bands, *args) on `world` spawned ranks of one host (rank r on
    devices[r]) and return their results in rank order.  fn is a
    module-level function whose result pickles (numpy, not CUDA
    tensors).  Raises if any rank fails: torch.multiprocessing.spawn ends
    the others and reports the first failure's exit code."""
    import torch.multiprocessing as mp

    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    with tempfile.TemporaryDirectory(prefix="bands_") as work:
        mp.spawn(_rank_main, args=(fn, world, backend, [str(d) for d in devices],
                                   os.path.join(work, "store"), work, args),
                 nprocs=world, join=True)
        results = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results

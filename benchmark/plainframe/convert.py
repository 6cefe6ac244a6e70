"""State carried across from numpy (or from the JAX package) to the port.

The JAX package's device state, draws and sceneset are pytrees of
arrays; `jax.tree.map(np.asarray, tree)` turns them into the numpy trees
this module takes.  `to_torch` maps any such tree — dicts, lists and
tuples of numpy arrays or numpy scalars — onto torch tensors on one
device, keeping every dtype (f32 stays f32, i32 stays i32, u8 stays u8,
bool stays bool).  The one exception is the environment's mip-pair and
quad tables `flatp` and `flatq`, and the box probes' list of quad
tables `flatqs`: the JAX package bitcasts their f32 rows to u8 for the
TPU's gathers, and to_torch views such a table as the f32 rows it holds,
so one JAX state feeds both packages.  The port's own host side (render.context,
render.types, renderlist.draw_arrays) produces the same numpy trees, so
one function moves both onto the card.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device):
    """Numpy tree -> the same tree of tensors on `device`.

    Tensors already in the tree are moved to `device`; other leaves
    (None, strings, Python numbers) pass through unchanged."""
    if isinstance(tree, dict):
        return {k: to_torch(_f32_rows(v) if k in ("flatp", "flatq")
                            else [_f32_rows(t) for t in v] if k == "flatqs" else v,
                            device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)):
        # np.array copies: a 0-d scalar stays 0-d, and the tensor never
        # aliases (or warns about) a read-only numpy buffer
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def _f32_rows(flatp):
    """(table, bases, sizes) with a u8-bitcast (N, 4W) table viewed as
    its (N, W) f32 rows (the bytes in memory order, as XLA's bitcast
    lays them out)."""
    table = flatp[0]
    if isinstance(table, np.ndarray) and table.dtype == np.uint8:
        table = np.ascontiguousarray(table).view(np.float32)
    return (table, *flatp[1:])

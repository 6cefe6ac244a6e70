"""Vector helpers over numpy arrays (the part of datum_tpu/math/vec.py
the port's host side uses, copied: the machine with the card has no jax,
and the port imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np


def dot(a, b, axis=-1):
    return np.sum(np.asarray(a) * np.asarray(b), axis=axis)


def length(a, axis=-1):
    return np.sqrt(dot(a, a, axis=axis))


def normalize(a, axis=-1, eps=0.0):
    a = np.asarray(a, dtype=np.float32)
    n = length(a, axis=axis)
    return a / np.maximum(np.expand_dims(n, axis), eps if eps else np.finfo(np.float32).tiny)


def cross(a, b):
    return np.cross(np.asarray(a, np.float32), np.asarray(b, np.float32)).astype(np.float32)

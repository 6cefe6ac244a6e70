"""Perlin gradient noise in numpy (the port's own copy of
datum_tpu/math/perlin.py; a test holds the two equal).  Improved Perlin
noise with a seeded permutation table, evaluated over arrays; the
terrain's heights are its fBm."""

from __future__ import annotations

import numpy as np


def _fade(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


class PerlinEngine:
    def __init__(self, seed: int = 0):
        rng = np.random.RandomState(seed)
        p = rng.permutation(256)
        self.perm = np.concatenate([p, p]).astype(np.int32)

    def _grad3(self, h, x, y, z):
        h = h & 15
        u = np.where(h < 8, x, y)
        v = np.where(h < 4, y, np.where((h == 12) | (h == 14), x, z))
        return np.where(h & 1, -u, u) + np.where(h & 2, -v, v)

    def noise3(self, x, y, z):
        x, y, z = (np.asarray(a, np.float32) for a in (x, y, z))
        xi = np.floor(x).astype(np.int32) & 255
        yi = np.floor(y).astype(np.int32) & 255
        zi = np.floor(z).astype(np.int32) & 255
        xf, yf, zf = x - np.floor(x), y - np.floor(y), z - np.floor(z)
        u, v, w = _fade(xf), _fade(yf), _fade(zf)

        P = self.perm
        aaa = P[P[P[xi] + yi] + zi]
        aba = P[P[P[xi] + yi + 1] + zi]
        aab = P[P[P[xi] + yi] + zi + 1]
        abb = P[P[P[xi] + yi + 1] + zi + 1]
        baa = P[P[P[xi + 1] + yi] + zi]
        bba = P[P[P[xi + 1] + yi + 1] + zi]
        bab = P[P[P[xi + 1] + yi] + zi + 1]
        bbb = P[P[P[xi + 1] + yi + 1] + zi + 1]

        def lerp(a, b, t):
            return a + t * (b - a)

        x1 = lerp(self._grad3(aaa, xf, yf, zf), self._grad3(baa, xf - 1, yf, zf), u)
        x2 = lerp(self._grad3(aba, xf, yf - 1, zf), self._grad3(bba, xf - 1, yf - 1, zf), u)
        y1 = lerp(x1, x2, v)
        x3 = lerp(self._grad3(aab, xf, yf, zf - 1), self._grad3(bab, xf - 1, yf, zf - 1), u)
        x4 = lerp(self._grad3(abb, xf, yf - 1, zf - 1), self._grad3(bbb, xf - 1, yf - 1, zf - 1), u)
        y2 = lerp(x3, x4, v)
        return lerp(y1, y2, w)

    def fbm3(self, x, y, z, octaves=4, lacunarity=2.0, gain=0.5):
        total = np.zeros(np.broadcast(np.asarray(x), np.asarray(y),
                                      np.asarray(z)).shape, np.float32)
        amp, freq = 1.0, 1.0
        for _ in range(octaves):
            total += amp * self.noise3(x * freq, y * freq, z * freq)
            amp *= gain
            freq *= lacunarity
        return total

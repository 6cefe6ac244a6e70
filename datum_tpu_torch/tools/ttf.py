"""TrueType font baking: a .ttf file -> a glyph-atlas Font (counterpart
of datum_tpu/tools/ttf.py; the atlas bytes equal the JAX tool's).

A minimal TrueType parser (cmap format 4, glyf/loca, hmtx, optional kern
format 0) and a nonzero-winding scanline rasteriser with 4x4
supersampling bake the atlas; bake_font returns render/sprite.py's Font.
"""

from __future__ import annotations

import struct

import numpy as np


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _i16(b, o):
    return struct.unpack_from(">h", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


class TrueTypeFont:
    def __init__(self, path):
        with open(path, "rb") as f:
            self.data = f.read()
        b = self.data
        numtables = _u16(b, 4)
        self.tables = {}
        for i in range(numtables):
            o = 12 + 16 * i
            tag = b[o:o + 4].decode("latin1")
            self.tables[tag] = (_u32(b, o + 8), _u32(b, o + 12))
        head = self.tables["head"][0]
        self.units_per_em = _u16(b, head + 18)
        self.loca_long = _u16(b, head + 50) == 1
        maxp = self.tables["maxp"][0]
        self.num_glyphs = _u16(b, maxp + 4)
        hhea = self.tables["hhea"][0]
        self.ascent = _i16(b, hhea + 4)
        self.descent = _i16(b, hhea + 6)
        self.line_gap = _i16(b, hhea + 8)
        self.num_hmetrics = _u16(b, hhea + 34)
        self._parse_cmap()
        self._parse_loca()
        self._parse_kern()

    # --- tables -----------------------------------------------------------
    def _parse_cmap(self):
        b = self.data
        base = self.tables["cmap"][0]
        n = _u16(b, base + 2)
        sub = None
        for i in range(n):
            pid = _u16(b, base + 4 + 8 * i)
            eid = _u16(b, base + 6 + 8 * i)
            off = _u32(b, base + 8 + 8 * i)
            if (pid, eid) in ((3, 1), (0, 3), (0, 4), (3, 10)):
                sub = base + off
                if (pid, eid) == (3, 1):
                    break
        if sub is None or _u16(b, sub) != 4:
            raise ValueError("no format-4 cmap subtable")
        segx2 = _u16(b, sub + 6)
        ends = [_u16(b, sub + 14 + i) for i in range(0, segx2, 2)]
        starts = [_u16(b, sub + 16 + segx2 + i) for i in range(0, segx2, 2)]
        deltas = [_i16(b, sub + 16 + 2 * segx2 + i) for i in range(0, segx2, 2)]
        self._cmap = (sub, segx2, ends, starts, deltas)

    def glyph_id(self, ch):
        sub, segx2, ends, starts, deltas = self._cmap
        code = ord(ch)
        for s, (end, start, delta) in enumerate(zip(ends, starts, deltas)):
            if code <= end:
                if code < start:
                    return 0
                ro_off = sub + 16 + 3 * segx2 + 2 * s
                ro = _u16(self.data, ro_off)
                if ro == 0:
                    return (code + delta) & 0xFFFF
                gi = _u16(self.data, ro_off + ro + 2 * (code - start))
                return (gi + delta) & 0xFFFF if gi else 0
        return 0

    def _parse_loca(self):
        b = self.data
        base, _ = self.tables["loca"]
        if self.loca_long:
            self.loca = [_u32(b, base + 4 * i) for i in range(self.num_glyphs + 1)]
        else:
            self.loca = [2 * _u16(b, base + 2 * i) for i in range(self.num_glyphs + 1)]

    def _parse_kern(self):
        self.kern = {}
        if "kern" not in self.tables:
            return
        b = self.data
        base = self.tables["kern"][0]
        ntab = _u16(b, base + 2)
        o = base + 4
        for _ in range(ntab):
            length = _u16(b, o + 2)
            coverage = _u16(b, o + 4)
            if coverage >> 8 == 0:      # format 0
                npairs = _u16(b, o + 6)
                p = o + 14
                for i in range(npairs):
                    l = _u16(b, p)
                    r = _u16(b, p + 2)
                    v = _i16(b, p + 4)
                    self.kern[(l, r)] = v
                    p += 6
            o += length

    def advance(self, gid):
        b = self.data
        base = self.tables["hmtx"][0]
        if gid < self.num_hmetrics:
            return _u16(b, base + 4 * gid)
        return _u16(b, base + 4 * (self.num_hmetrics - 1))

    # --- outlines -----------------------------------------------------------
    def glyph_contours(self, gid, depth=0):
        """List of contours; each contour is a list of (x, y, on_curve)."""
        if gid >= self.num_glyphs or self.loca[gid] == self.loca[gid + 1]:
            return []
        b = self.data
        g = self.tables["glyf"][0] + self.loca[gid]
        ncont = _i16(b, g)
        if ncont >= 0:
            return self._simple_contours(g, ncont)
        if depth > 4:
            return []
        # composite glyph
        out = []
        o = g + 10
        while True:
            flags = _u16(b, o)
            cgid = _u16(b, o + 2)
            o += 4
            if flags & 0x0001:          # words
                a1, a2 = _i16(b, o), _i16(b, o + 2)
                o += 4
            else:
                a1 = struct.unpack_from(">b", b, o)[0]
                a2 = struct.unpack_from(">b", b, o + 1)[0]
                o += 2
            sx = sy = 1.0
            s01 = s10 = 0.0
            if flags & 0x0008:
                sx = sy = _i16(b, o) / 16384.0
                o += 2
            elif flags & 0x0040:
                sx = _i16(b, o) / 16384.0
                sy = _i16(b, o + 2) / 16384.0
                o += 4
            elif flags & 0x0080:
                sx = _i16(b, o) / 16384.0
                s01 = _i16(b, o + 2) / 16384.0
                s10 = _i16(b, o + 4) / 16384.0
                sy = _i16(b, o + 6) / 16384.0
                o += 8
            dx, dy = (a1, a2) if flags & 0x0002 else (0, 0)
            for cont in self.glyph_contours(cgid, depth + 1):
                out.append([(x * sx + y * s10 + dx, x * s01 + y * sy + dy, on)
                            for x, y, on in cont])
            if not flags & 0x0020:
                break
        return out

    def _simple_contours(self, g, ncont):
        b = self.data
        ends = [_u16(b, g + 10 + 2 * i) for i in range(ncont)]
        npts = ends[-1] + 1 if ncont else 0
        o = g + 10 + 2 * ncont
        o += 2 + _u16(b, o)             # instructions
        flags = []
        while len(flags) < npts:
            f = b[o]
            o += 1
            flags.append(f)
            if f & 0x08:
                rep = b[o]
                o += 1
                flags.extend([f] * rep)
        xs, x = [], 0
        for f in flags:
            if f & 0x02:
                d = b[o]
                o += 1
                x += d if f & 0x10 else -d
            elif not f & 0x10:
                x += _i16(b, o)
                o += 2
            xs.append(x)
        ys, y = [], 0
        for f in flags:
            if f & 0x04:
                d = b[o]
                o += 1
                y += d if f & 0x20 else -d
            elif not f & 0x20:
                y += _i16(b, o)
                o += 2
            ys.append(y)
        pts = [(xs[i], ys[i], bool(flags[i] & 0x01)) for i in range(npts)]
        out, s = [], 0
        for e in ends:
            out.append(pts[s:e + 1])
            s = e + 1
        return out


def _flatten(contours, scale, steps=6):
    """TrueType quadratic outlines -> polygon rings (pixel units)."""
    rings = []
    for cont in contours:
        if not cont:
            continue
        # expand implied on-curve midpoints between consecutive off points
        pts = []
        n = len(cont)
        for i in range(n):
            x, y, on = cont[i]
            if not on and not cont[i - 1][2]:
                px, py, _ = cont[i - 1]
                pts.append(((px + x) / 2, (py + y) / 2, True))
            pts.append((x, y, on))
        if not pts[0][2]:
            pts.append(pts.pop(0))      # rotate to start on-curve
        poly = []
        i = 0
        m = len(pts)
        while i < m:
            x0, y0, _ = pts[i]
            nxt = pts[(i + 1) % m]
            if nxt[2]:
                poly.append((x0, y0))
                i += 1
            else:                       # quadratic through control nxt
                x1, y1, _ = nxt
                x2, y2, _ = pts[(i + 2) % m]
                for t in np.linspace(0, 1, steps, endpoint=False):
                    u = 1 - t
                    poly.append((u * u * x0 + 2 * u * t * x1 + t * t * x2,
                                 u * u * y0 + 2 * u * t * y1 + t * t * y2))
                i += 2
        rings.append(np.asarray(poly, np.float64) * scale)
    return rings


def rasterize(rings, w, h, ss=4):
    """Nonzero-winding coverage image (h, w) float in [0,1]."""
    if not rings:
        return np.zeros((h, w), np.float32)
    img = np.zeros((h * ss, w * ss), bool)
    segs = []
    for r in rings:
        if len(r) >= 3:
            segs.append(np.stack([r, np.roll(r, -1, axis=0)], 1))
    if not segs:
        return np.zeros((h, w), np.float32)
    seg = np.concatenate(segs) * ss     # (S, 2, 2)
    y0, y1 = seg[:, 0, 1], seg[:, 1, 1]
    x0, x1 = seg[:, 0, 0], seg[:, 1, 0]
    for row in range(img.shape[0]):
        yc = row + 0.5
        up = (y0 <= yc) & (y1 > yc)
        dn = (y1 <= yc) & (y0 > yc)
        hit = up | dn
        if not hit.any():
            continue
        t = (yc - y0[hit]) / (y1[hit] - y0[hit])
        xs = x0[hit] + t * (x1[hit] - x0[hit])
        wind = np.where(up[hit], 1, -1)
        order = np.argsort(xs)
        xs, wind = xs[order], wind[order]
        acc = np.cumsum(wind)
        inside = acc != 0
        for k in range(len(xs) - 1):
            if inside[k]:
                lo = max(int(np.ceil(xs[k] - 0.5)), 0)
                hi = min(int(np.floor(xs[k + 1] - 0.5)), img.shape[1] - 1)
                if hi >= lo:
                    img[row, lo:hi + 1] = True
    return img.reshape(h, ss, w, ss).mean(axis=(1, 3)).astype(np.float32)


def bake_font(path, size=24,
              chars=" !\"#$%&'()*+,-./0123456789:;<=>?@"
                    "ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_`"
                    "abcdefghijklmnopqrstuvwxyz{|}~"):
    """Bake a TTF into a render.sprite.Font (glyph 0 = missing)."""
    from ..render.sprite import Font

    ttf = TrueTypeFont(path)
    scale = size / ttf.units_per_em
    n = len(chars) + 1
    imgs, metrics = [None], [(0, 0, 0, 0, int(round(size * 0.5)))]
    for ch in chars:
        gid = ttf.glyph_id(ch)
        conts = ttf.glyph_contours(gid)
        rings = _flatten(conts, scale)
        adv = int(round(ttf.advance(gid) * scale))
        if rings:
            allpts = np.concatenate(rings)
            xmin = int(np.floor(allpts[:, 0].min())) - 1
            xmax = int(np.ceil(allpts[:, 0].max())) + 1
            ymin = int(np.floor(allpts[:, 1].min())) - 1
            ymax = int(np.ceil(allpts[:, 1].max())) + 1
            w, h = xmax - xmin, ymax - ymin
            shifted = [r - np.array([xmin, ymin]) for r in rings]
            cov = rasterize(shifted, w, h)[::-1]    # TTF y-up -> image y-down
            imgs.append(cov)
            metrics.append((w, h, xmin, ymax, adv))
        else:
            imgs.append(None)
            metrics.append((0, 0, 0, 0, adv))

    pad = 1
    aw = sum(m[0] + pad for m in metrics) + pad
    ah = max((m[1] for m in metrics), default=1) + 2 * pad
    atlas = np.zeros((ah, aw, 4), np.uint8)
    x_arr = np.zeros(n, np.uint16)
    y_arr = np.zeros(n, np.uint16)
    w_arr = np.zeros(n, np.uint16)
    h_arr = np.zeros(n, np.uint16)
    ox_arr = np.zeros(n, np.int16)
    oy_arr = np.zeros(n, np.int16)
    cx = pad
    for i, (img, (w, h, ox, oy, _)) in enumerate(zip(imgs, metrics)):
        x_arr[i], y_arr[i] = cx, pad
        w_arr[i], h_arr[i] = w, h
        ox_arr[i], oy_arr[i] = ox, -oy  # offsety: pen-relative top (y-down)
        if img is not None and w and h:
            a = (img * 255 + 0.5).astype(np.uint8)
            atlas[pad:pad + h, cx:cx + w, :3] = 255
            atlas[pad:pad + h, cx:cx + w, 3] = a
        cx += w + pad

    gids = [0] + [ttf.glyph_id(c) for c in chars]
    advance = np.zeros((n, n), np.uint8)
    for j in range(n):
        base = metrics[j][4]
        for i in range(n):
            k = ttf.kern.get((gids[j], gids[i]), 0)
            advance[j, i] = np.clip(base + int(round(k * scale)), 0, 255)

    ascent = int(round(ttf.ascent * scale))
    descent = int(round(-ttf.descent * scale))
    leading = int(round(ttf.line_gap * scale))
    font = Font(atlas, n, x_arr, y_arr, w_arr, h_arr, ox_arr, oy_arr,
                advance, ascent=ascent, descent=descent, leading=leading)
    font.charmap = {c: i + 1 for i, c in enumerate(chars)}
    return font

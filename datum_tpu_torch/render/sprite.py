"""Sprite and Font resources and the host overlay blitter (counterpart
of datum_tpu/render/sprite.py, copied): a layered sprite image, the
glyph-atlas font with its per-pair advance table (the builtin 5x7 font
among them), and the u8 alpha blits that the debug overlay and
render_fallback draw with.  The device pass (ops/sprite_pass.py) draws
the render list's sprites and text inside the frame."""

from __future__ import annotations

import numpy as np


class Sprite:
    def __init__(self, image, layers=1, pivot=(0.0, 0.0)):
        """image: (H, W, 4) uint8 atlas (layers stacked vertically when
        layers > 1)."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)
        self.image = img
        self.layers = layers
        self.pivot = np.asarray(pivot, np.float32)
        self.height = img.shape[0] // layers
        self.width = img.shape[1]

    def layer(self, i):
        i = int(i) % max(self.layers, 1)
        return self.image[i * self.height:(i + 1) * self.height]


class Font:
    """Glyph-atlas font (reference: font.h:17-83)."""

    def __init__(self, atlas, glyphcount, x, y, width, height, offsetx, offsety,
                 advance, ascent=10, descent=3, leading=2):
        self.atlas = np.asarray(atlas)
        self.glyphcount = glyphcount
        self.x, self.y = np.asarray(x), np.asarray(y)
        self.width, self.height = np.asarray(width), np.asarray(height)
        self.offsetx, self.offsety = np.asarray(offsetx), np.asarray(offsety)
        self.advance = np.asarray(advance)
        self.ascent, self.descent, self.leading = ascent, descent, leading

    @classmethod
    def from_asset(cls, decoded, atlas_image):
        return cls(atlas_image, decoded["glyphcount"], decoded["x"], decoded["y"],
                   decoded["width"], decoded["height"], decoded["offsetx"],
                   decoded["offsety"], decoded["advance"], decoded["ascent"],
                   decoded["descent"], decoded["leading"])

    @classmethod
    def builtin(cls, scale=1):
        """Tiny built-in 5x7 bitmap font (the debug-font fallback)."""
        glyphs = _BUILTIN_GLYPHS
        n = len(_BUILTIN_CHARS) + 1
        gw, gh = 6, 8
        atlas = np.zeros((gh, gw * n, 4), np.uint8)
        for i, ch in enumerate(_BUILTIN_CHARS):
            bits = glyphs.get(ch)
            if not bits:
                continue
            for r, row in enumerate(bits):
                for c, v in enumerate(row):
                    if v == "#":
                        atlas[r, (i + 1) * gw + c] = 255
        x = np.arange(n, dtype=np.uint16) * gw
        return cls(atlas, n, x, np.zeros(n, np.uint16),
                   np.full(n, gw, np.uint16), np.full(n, gh, np.uint16),
                   np.zeros(n, np.int16), np.zeros(n, np.int16),
                   np.full((n, n), gw, np.uint8), ascent=7, descent=1)

    def glyph_index(self, ch):
        cm = getattr(self, "charmap", None)
        if cm is not None:
            return cm.get(ch, 0)
        i = _BUILTIN_CHARS.find(ch.upper())
        return i + 1 if i >= 0 else 0


_BUILTIN_CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.:,-+/%() "

_F = {
    "A": ["  #  ", " # # ", "#   #", "#####", "#   #", "#   #", "#   #"],
    "B": ["#### ", "#   #", "#### ", "#   #", "#   #", "#   #", "#### "],
    "C": [" ####", "#    ", "#    ", "#    ", "#    ", "#    ", " ####"],
    "D": ["#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "],
    "E": ["#####", "#    ", "#### ", "#    ", "#    ", "#    ", "#####"],
    "F": ["#####", "#    ", "#### ", "#    ", "#    ", "#    ", "#    "],
    "G": [" ####", "#    ", "#  ##", "#   #", "#   #", "#   #", " ####"],
    "H": ["#   #", "#   #", "#####", "#   #", "#   #", "#   #", "#   #"],
    "I": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "#####"],
    "J": ["    #", "    #", "    #", "    #", "#   #", "#   #", " ### "],
    "K": ["#   #", "#  # ", "###  ", "#  # ", "#   #", "#   #", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"],
    "M": ["#   #", "## ##", "# # #", "#   #", "#   #", "#   #", "#   #"],
    "N": ["#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"],
    "O": [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "P": ["#### ", "#   #", "#### ", "#    ", "#    ", "#    ", "#    "],
    "Q": [" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"],
    "R": ["#### ", "#   #", "#### ", "#  # ", "#   #", "#   #", "#   #"],
    "S": [" ####", "#    ", " ### ", "    #", "    #", "    #", "#### "],
    "T": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "U": ["#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "V": ["#   #", "#   #", "#   #", "#   #", " # # ", " # # ", "  #  "],
    "W": ["#   #", "#   #", "#   #", "# # #", "# # #", "## ##", "#   #"],
    "X": ["#   #", " # # ", "  #  ", "  #  ", " # # ", "#   #", "#   #"],
    "Y": ["#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "Z": ["#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"],
    "0": [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    "1": ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", "#####"],
    "2": [" ### ", "#   #", "    #", "  ## ", " #   ", "#    ", "#####"],
    "3": [" ### ", "#   #", "   # ", "  ## ", "    #", "#   #", " ### "],
    "4": ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    "5": ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    "6": [" ### ", "#    ", "#### ", "#   #", "#   #", "#   #", " ### "],
    "7": ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    "8": [" ### ", "#   #", " ### ", "#   #", "#   #", "#   #", " ### "],
    "9": [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
    ".": ["     ", "     ", "     ", "     ", "     ", "  ## ", "  ## "],
    ":": ["     ", "  ## ", "  ## ", "     ", "  ## ", "  ## ", "     "],
    ",": ["     ", "     ", "     ", "     ", "  ## ", "  ## ", " #   "],
    "-": ["     ", "     ", "     ", "#####", "     ", "     ", "     "],
    "+": ["     ", "  #  ", "  #  ", "#####", "  #  ", "  #  ", "     "],
    "/": ["    #", "    #", "   # ", "  #  ", " #   ", "#    ", "#    "],
    "%": ["##  #", "## # ", "  #  ", "  #  ", " #   ", "# ###", "#  ##"],
    "(": ["  #  ", " #   ", "#    ", "#    ", "#    ", " #   ", "  #  "],
    ")": ["  #  ", "   # ", "    #", "    #", "    #", "   # ", "  #  "],
}
_BUILTIN_GLYPHS = _F


def blit_sprite(image, sprite_img, x, y, tint=(1, 1, 1, 1)):
    """Alpha-blend a sprite into a uint8 frame at integer (x, y)."""
    h, w = image.shape[:2]
    sh, sw = sprite_img.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(w, x + sw), min(h, y + sh)
    if x1 <= x0 or y1 <= y0:
        return
    sub = sprite_img[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.float32)
    tint = np.asarray(tint, np.float32)
    a = (sub[..., 3:4] / 255.0) * tint[3]
    rgb = sub[..., :3] * tint[:3]
    dst = image[y0:y1, x0:x1].astype(np.float32)
    image[y0:y1, x0:x1] = np.clip(dst * (1 - a) + rgb * a, 0, 255).astype(np.uint8)


def draw_text(image, font: Font, text, x, y, tint=(1, 1, 1, 1), scale=1):
    """Blit text using the font atlas; returns advance width.

    y is the glyph-top for bitmap fonts (offsety 0) and the baseline for
    baked TTF fonts (negative offsety).  Advances use the per-pair table
    (reference: font.h advance[pair]) so kerning applies.
    """
    s = str(text)
    idx = [font.glyph_index(ch) if hasattr(font, "glyph_index") else ord(ch)
           for ch in s]
    cx = x
    for k, gi in enumerate(idx):
        gx, gy = int(font.x[gi]), int(font.y[gi])
        gw, gh = int(font.width[gi]), int(font.height[gi])
        glyph = font.atlas[gy:gy + gh, gx:gx + gw]
        if scale != 1:
            glyph = np.repeat(np.repeat(glyph, scale, 0), scale, 1)
        blit_sprite(image, glyph, cx + int(font.offsetx[gi]) * scale,
                    y + int(font.offsety[gi]) * scale, tint)
        nxt = idx[k + 1] if k + 1 < len(idx) else 0
        cx += int(font.advance[gi, nxt] if font.advance.ndim > 1
                  else font.advance[gi]) * scale
    return cx - x

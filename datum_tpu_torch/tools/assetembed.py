"""Image -> embeddable source array (counterpart of
datum_tpu/tools/assetembed.py): a Python module or a C header of the
image's raw RGBA bytes, as the reference's tools/assetembed produced the
64x32 logo the engine presents before assets stream in.

    python -m datum_tpu_torch.tools.assetembed in.png out.py|out.h [name]

The PNG is read with zlib (examples/common.py::read_png): the card's
machine has no PIL.  An RGB PNG gains an opaque alpha, as PIL's
convert("RGBA") gives it.
"""

from __future__ import annotations

import sys

import numpy as np


def embed_image(image: np.ndarray, name="embedded", lang="py") -> str:
    """The source text: float images scale by 255 and round; lang "c"
    gives a C header, anything else a Python module."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    data = img.tobytes()
    if lang == "c":
        vals = ",".join(str(b) for b in data)
        return (f"static const unsigned {name}_width = {w};\n"
                f"static const unsigned {name}_height = {h};\n"
                f"static const unsigned char {name}_data[] = {{{vals}}};\n")
    rows = [data[i:i + 32] for i in range(0, len(data), 32)]
    body = "\n".join("    " + repr(r) for r in rows)
    return (f"{name}_width = {w}\n{name}_height = {h}\n"
            f"{name}_data = (\n{body}\n)\n")


def main(argv=None):
    from ..examples.common import read_png

    argv = sys.argv[1:] if argv is None else argv
    img = read_png(argv[0])
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    out = embed_image(img, name=argv[2] if len(argv) > 2 else "embedded",
                      lang="c" if argv[1].endswith(".h") else "py")
    with open(argv[1], "w") as f:
        f.write(out)
    print(f"embedded {argv[0]} -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

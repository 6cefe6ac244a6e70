"""The tile-sharded frame over torch.distributed (counterpart of
datum_tpu/parallel/): framebuffer tile rows go one band to a rank, the
scene-space work is replicated, and the cross-band passes all-gather
reduced-resolution fields (parallel/sharded.py)."""

from .mesh import Bands, close_bands, init_bands, spawn_bands
from .sharded import ici_report, render_frame_sharded

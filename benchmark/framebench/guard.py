"""The top-level modules that no process of the benchmark may hold."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "datum_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules, compared
    whole: datum_tpu_torch is not datum_tpu."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))

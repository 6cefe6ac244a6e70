"""No process of the benchmark holds jax, jaxlib, flax or the JAX package,
compared by whole top-level names; the reference imports nothing of the
port either."""

import ast
import json
import subprocess
import sys

from conftest import BENCH, ROOT

from framebench.guard import forbidden_modules

PORT_AND_JAX = {"jax", "jaxlib", "flax", "datum_tpu", "datum_tpu_torch"}


def _top_level_after(code):
    p = subprocess.run([sys.executable, "-c", f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
{code}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_guard_compares_whole_names():
    assert forbidden_modules({"datum_tpu_torch": 0, "datum_tpu_torch.ops": 0}) == []
    assert forbidden_modules({"datum_tpu.render": 0, "jaxlib.xla": 0, "flax": 0}) == [
        "datum_tpu", "flax", "jaxlib"]
    assert forbidden_modules({"jaxtyping": 0, "jax_x": 0}) == []


def test_harness_holds_no_jax():
    names = _top_level_after("""
from framebench import check, loop, runner, spec, trace, roofline
loop.program_side(); loop.reference_side()
for m in spec.load_spec()["per_layer"]:
    spec.metric_module(m["name"])
""")
    assert "datum_tpu_torch" in names and "plainframe" in names
    assert not names & {"jax", "jaxlib", "flax", "datum_tpu"}


def test_reference_holds_nothing_of_the_port():
    names = _top_level_after("""
import plainframe.scenes, plainframe.render.frame, plainframe.render.types
""")
    assert "plainframe" in names and not names & PORT_AND_JAX


def test_reference_sources_import_inside_the_folder():
    for path in (BENCH / "plainframe").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & PORT_AND_JAX, f"{path}: {ast.unparse(node)}"
            # the reference holds no launch code: no kernel library binding
            assert "ctypes" not in tops, f"{path}: {ast.unparse(node)}"

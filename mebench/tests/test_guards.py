"""What the benchmark may import: no module it runs loads JAX or the JAX
package, and its reference and yardstick load nothing of the program.
Names are compared whole, by their first dotted part:
``vvc_affine_tpu_torch`` begins with ``vvc_affine_tpu`` but is not it."""

import ast
import os
import subprocess
import sys

import pytest

from mebench import run

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "vvc_affine_tpu"}
# the yardstick: what decides correct and what the metrics are counted by
INDEPENDENT = ("reference.py", "geometry.py", "frames.py", "roofline.py",
               "trace.py", "power.py")


def harness_files():
    """Every Python file the benchmark runs (its tests are not run)."""
    out = []
    for dirpath, dirs, files in os.walk(HARNESS):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    assert "vvc_affine_tpu_torch".split(".")[0] not in JAX_NAMES
    assert "vvc_affine_tpu.models.pipeline".split(".")[0] in JAX_NAMES
    assert set(run.FORBIDDEN) == JAX_NAMES


@pytest.mark.parametrize("path", harness_files(), ids=os.path.basename)
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("name", INDEPENDENT)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "vvc_affine_tpu_torch" not in top_level_imports(os.path.join(HARNESS, name))


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import mebench.reference, mebench.roofline, "
            "mebench.frames; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HARNESS), check=True)
    loaded = set(eval(out.stdout))
    assert "vvc_affine_tpu_torch" not in loaded and not loaded & JAX_NAMES


def test_run_loads_no_jax():
    """The harness and the program it drives, imported as a run imports
    them, leave no JAX module behind."""
    code = ("import sys; from mebench import run, control, trace, power; "
            "import vvc_affine_tpu_torch.models.pipeline, "
            "vvc_affine_tpu_torch.parallel.mesh; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HARNESS), check=True)
    assert not set(eval(out.stdout)) & JAX_NAMES

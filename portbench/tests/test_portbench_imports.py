"""What the benchmark may import: nothing of JAX or of the JAX package
``repro`` anywhere under ``portbench/`` (top-level names compared whole,
so ``repro_torch`` is not ``repro``), and nothing of the program
``repro_torch`` in the reference."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def _sources(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(HERE),
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax_or_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", _sources(HERE / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "repro_torch" not in tops
    inner = {n for n in _imports(path) if n.startswith("portbench.")}
    assert all(n.startswith(("portbench.reference", "portbench.yardstick"))
               for n in inner), inner


def test_a_run_loads_no_jax_module():
    """A whole small run of every cell on the CPU, in a fresh process,
    leaves no JAX module and no module of the JAX package loaded."""
    code = (
        "import sys\n"
        "from portbench import harness\n"
        "from portbench.tests.small import CELLS, files\n"
        "for w in CELLS:\n"
        "    harness.run_cell(w, 5, 0.2, False, device='cpu', files=files(w))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""The port stands alone: nothing under src/repro_torch, and not
chip_smoke.py, imports JAX or the JAX package, and the whole package
imports with JAX made unimportable."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


SPARSE_SLICE = ("core/sparse.py", "core/replication.py",
                "runtime/sparse_push.py", "models/recsys/embedding.py",
                "models/recsys/models.py", "configs/dlrm_mlperf.py",
                "configs/recsys_shapes.py", "kernels/embedding_bag/ops.py",
                "kernels/embedding_bag/kernel.py",
                "kernels/embedding_bag/ref.py")


@pytest.mark.parametrize("module", SPARSE_SLICE)
def test_sparse_slice_modules_are_checked(module):
    """The sparse tier's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


STRAGGLER_SLICE = ("core/placement.py", "runtime/straggler.py",
                   "checkpoint/__init__.py", "checkpoint/checkpointer.py",
                   "core/fabric.py", "core/config.py", "core/server.py")


@pytest.mark.parametrize("module", STRAGGLER_SLICE)
def test_straggler_slice_modules_are_checked(module):
    """The straggler modes' and checkpointer's modules are among the files
    checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


TOPOLOGY_SLICE = ("core/topology.py", "core/replication.py",
                  "core/__init__.py")


@pytest.mark.parametrize("module", TOPOLOGY_SLICE)
def test_topology_slice_modules_are_checked(module):
    """The rack topology tier's modules (topology, switch pools, the fault
    plan) are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    and ``import repro`` fail."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env_path = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


FAULT_SLICE = ("runtime/elastic.py", "core/placement.py",
               "core/replication.py", "core/fabric.py", "core/sparse.py")


@pytest.mark.parametrize("module", FAULT_SLICE)
def test_fault_slice_modules_are_checked(module):
    """The fault tier's modules (elastic restore and re-entry, the
    placement plan, the replica chain) are among the files checked
    above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["repro_torch.runtime.elastic",
                                    "repro_torch.core.placement"])
def test_fault_slice_imports_with_jax_blocked(module):
    """``runtime/elastic`` and ``core/placement`` import on their own in a
    process where ``import jax`` and ``import repro`` fail."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"importlib.import_module({module!r})\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


TENANCY_SLICE = ("core/tenancy.py", "core/config.py", "core/fabric.py",
                 "core/__init__.py")


@pytest.mark.parametrize("module", TENANCY_SLICE)
def test_tenancy_slice_modules_are_checked(module):
    """The tenancy tier's modules (the shared box, the namespace knobs and
    the legacy adapter, the shared-clock hooks) are among the files
    checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_tenancy_imports_with_jax_blocked():
    """``core/tenancy`` imports on its own in a process where ``import
    jax`` and ``import repro`` fail, and pulls in neither."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "importlib.import_module('repro_torch.core.tenancy')\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


SERVING_SLICE = ("core/serving.py", "core/workload.py", "core/hierarchy.py",
                 "core/config.py", "core/sparse.py", "core/tenancy.py",
                 "models/transformer.py", "launch/__init__.py",
                 "launch/serve.py", "checkpoint/checkpointer.py")


@pytest.mark.parametrize("module", SERVING_SLICE)
def test_serving_slice_modules_are_checked(module):
    """The serving path's modules (the read planes, the workload and tier
    ladder, the inference path, the serve driver) are among the files
    checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["repro_torch.core.serving",
                                    "repro_torch.core.workload",
                                    "repro_torch.core.hierarchy",
                                    "repro_torch.launch.serve"])
def test_serving_imports_with_jax_blocked(module):
    """Each serving module imports on its own in a process where ``import
    jax`` and ``import repro`` fail, and pulls in neither; the serve
    driver's ``--help`` runs as ``python -m``."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"importlib.import_module({module!r})\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    if module.endswith(".serve"):
        out = subprocess.run(
            [sys.executable, "-m", module, "--help"], capture_output=True,
            text=True, timeout=180, cwd=ROOT, env=env)
        assert out.returncode == 0 and "--serve-replication" in out.stdout


PLACEMENT_SLICE = ("core/placement.py", "core/sparse.py", "core/chunking.py",
                   "core/__init__.py", "runtime/autoscaler.py",
                   "runtime/__init__.py", "optim/schedules.py",
                   "optim/optimizers.py", "optim/__init__.py")


@pytest.mark.parametrize("module", PLACEMENT_SLICE)
def test_placement_slice_modules_are_checked(module):
    """The placement solver's and the autoscaler's modules (the solver,
    the solved row maps, the control loop, the schedules and the tree-wise
    optimizer) are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["repro_torch.runtime.autoscaler",
                                    "repro_torch.optim.schedules",
                                    "repro_torch.core.placement"])
def test_placement_slice_imports_with_jax_blocked(module):
    """The autoscaler, the schedules and the extended placement module
    each import on their own in a process where ``import jax`` and
    ``import repro`` fail, pull in neither, and expose the JAX package's
    names."""
    names = {
        "repro_torch.runtime.autoscaler": ("Autoscaler", "AutoscalerPolicy",
                                           "ScaleEvent"),
        "repro_torch.optim.schedules": ("constant_schedule", "linear_warmup",
                                        "cosine_schedule",
                                        "warmup_cosine_schedule"),
        "repro_torch.core.placement": (
            "PlacementProblem", "PlanScore", "Objective", "Constraint",
            "CoreByteCost", "LoadBalance", "HotRowSkew", "RackCapacity",
            "ReplicaAntiAffinity", "ChunkBalance", "current_plan",
            "diff_plans"),
    }[module]
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"mod = importlib.import_module({module!r})\n"
        f"assert all(hasattr(mod, n) for n in {names!r})\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

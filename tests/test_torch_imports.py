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


SPMD_SLICE = ("launch/mesh.py", "launch/steps.py", "launch/train.py",
              "launch/__init__.py", "core/exchange.py", "core/zero_compute.py",
              "core/hierarchy.py", "core/__init__.py", "runtime/trainer.py",
              "runtime/__init__.py", "models/common.py",
              "checkpoint/checkpointer.py", "data/pipeline.py")


@pytest.mark.parametrize("module", SPMD_SLICE)
def test_spmd_slice_modules_are_checked(module):
    """The SPMD path's modules (the mesh, the exchange and zero-compute
    engine, the trainer, the step builders and the train driver, the
    pipeline) are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["repro_torch.launch.mesh",
                                    "repro_torch.core.exchange",
                                    "repro_torch.core.zero_compute",
                                    "repro_torch.runtime.trainer",
                                    "repro_torch.launch.steps",
                                    "repro_torch.launch.train",
                                    "repro_torch.data.pipeline"])
def test_spmd_slice_imports_with_jax_blocked(module):
    """Each SPMD module imports on its own in a process where ``import
    jax`` and ``import repro`` fail, pulls in neither, and exposes the JAX
    package's names; the train driver's ``--help`` runs as ``python -m``."""
    names = {
        "repro_torch.launch.mesh": ("make_mesh", "make_production_mesh",
                                    "worker_axes", "pod_axis", "num_workers",
                                    "Mesh"),
        "repro_torch.core.exchange": ("ExchangeConfig", "PSExchange"),
        "repro_torch.core.zero_compute": ("make_zero_compute_step",
                                          "init_zero_compute_state"),
        "repro_torch.runtime.trainer": ("TrainState", "apply_grad_sync",
                                        "attach_telemetry",
                                        "make_ps_train_step",
                                        "init_train_state"),
        "repro_torch.launch.steps": ("CellPlan", "default_optimizer",
                                     "make_exchange", "build_lm_train",
                                     "build_cell"),
        "repro_torch.launch.train": ("main",),
        "repro_torch.data.pipeline": ("Prefetcher",),
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
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    if module.endswith(".train"):
        out = subprocess.run(
            [sys.executable, "-m", module, "--help"], capture_output=True,
            text=True, timeout=180, cwd=ROOT, env=env)
        assert out.returncode == 0 and "--ckpt-every" in out.stdout


@pytest.mark.parametrize("module,names", [
    ("repro_torch.models.transformer",
     ("TransformerConfig", "init_params", "abstract_params",
      "make_param_specs", "grad_sync", "forward", "lm_loss", "init_cache",
      "prefill", "decode_step", "init_cache_unrolled",
      "decode_step_unrolled")),
    ("repro_torch.models.common", ("Dist",)),
    ("repro_torch.launch.steps", ("build_lm_prefill", "build_lm_decode",
                                  "build_lm_decode_long")),
    ("repro_torch.runtime.trainer", ("local_template", "local_params",
                                     "take_local")),
    ("repro_torch.launch.serve", ("main", "serve")),
])
def test_tp_slice_imports_with_jax_blocked(module, names):
    """The tensor-parallel slice's modules import with ``import jax`` and
    ``import repro`` failing, pull in neither, and expose the names the
    JAX package's TP path uses."""
    assert ROOT / "src" / (module.replace(".", "/") + ".py") in PORT_FILES
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


RECSYS_SLICE = ("models/recsys/embedding.py", "models/recsys/models.py",
                "models/recsys/__init__.py", "models/common.py",
                "runtime/sparse_push.py", "launch/steps.py",
                "launch/train.py", "configs/registry.py",
                "configs/autoint.py", "configs/dien.py", "configs/xdeepfm.py",
                "configs/dlrm_mlperf.py")


@pytest.mark.parametrize("module", RECSYS_SLICE)
def test_recsys_slice_modules_are_checked(module):
    """The recsys SPMD slice's modules (the sharded lookups and specs, the
    four models, the sparse push, the recsys cells and the driver's recsys
    branch, the three new configs) are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module,names", [
    ("repro_torch.models.recsys.embedding",
     ("table_specs", "table_grad_sync", "mlp_specs", "mlp_grad_sync",
      "split_batch_model", "lookup_fields", "lookup_sequence", "bce_loss")),
    ("repro_torch.models.recsys.models",
     ("dlrm_specs", "dlrm_grad_sync", "dlrm_user_tower", "bulk_retrieval",
      *(f"{a}_{f}" for a in ("autoint", "dien", "xdeepfm")
        for f in ("init", "specs", "grad_sync", "score", "loss",
                  "user_tower")),
      "AutoIntConfig", "DIENConfig", "XDeepFMConfig")),
    ("repro_torch.runtime.sparse_push",
     ("coalesce_ids_rows", "sparse_table_update",
      "make_sparse_recsys_train_step")),
    ("repro_torch.launch.steps", ("build_recsys_cell",
                                  "build_recsys_train_sparse", "_RS_FNS")),
])
def test_recsys_slice_imports_with_jax_blocked(module, names):
    """The recsys slice's modules import with ``import jax`` and ``import
    repro`` failing, pull in neither, and expose the JAX package's names;
    the registry holds the four recsys archs."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"mod = importlib.import_module({module!r})\n"
        f"assert all(hasattr(mod, n) for n in {names!r})\n"
        "from repro_torch.configs.registry import get_arch\n"
        "for a in ('dlrm-mlperf', 'autoint', 'dien', 'xdeepfm'):\n"
        "    assert get_arch(a).family == 'recsys'\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


MODELS_SLICE = ("models/resnet.py", "models/moe.py", "models/common.py",
                "models/transformer.py", "configs/resnet50.py",
                "configs/granite_moe_1b.py", "configs/qwen2_moe_a2_7b.py",
                "configs/internlm2_1_8b.py", "configs/qwen2_72b.py",
                "configs/registry.py", "data/synthetic.py",
                "launch/steps.py", "launch/train.py")


@pytest.mark.parametrize("module", MODELS_SLICE)
def test_models_slice_modules_are_checked(module):
    """ResNet-50, the MoE FFN, the four LM configs, the full registry and
    the vision cell's builder and driver are among the files checked
    above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_registry_builds_every_arch_with_jax_blocked():
    """Every registered arch's module imports, and its SMOKE config builds
    an init, in a process where ``import jax`` and ``import repro`` fail."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from repro_torch.configs.registry import get_arch, list_archs\n"
        "from repro_torch.models import resnet, transformer\n"
        "from repro_torch.models.gnn import equiformer_v2\n"
        "assert len(list_archs()) == 11\n"
        "for a in ('resnet50', 'granite-moe-1b-a400m', 'qwen2-moe-a2.7b',\n"
        "          'internlm2-1.8b', 'qwen2-72b', 'equiformer-v2'):\n"
        "    arch = get_arch(a)\n"
        "    mod = {'vision': resnet, 'gnn': equiformer_v2}.get(\n"
        "        arch.family, transformer)\n"
        "    mod.init_params(arch.smoke_config, torch.Generator())\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


GNN_SLICE = ("models/gnn/__init__.py", "models/gnn/equiformer_v2.py",
             "models/gnn/spherical.py", "data/graphs.py",
             "configs/equiformer_v2.py", "configs/registry.py",
             "launch/steps.py", "launch/train.py", "runtime/trainer.py",
             "models/common.py")


@pytest.mark.parametrize("module", GNN_SLICE)
def test_gnn_slice_modules_are_checked(module):
    """The GNN family's modules (EquiformerV2, the spherical harmonics, the
    graph featurization, its config, the graph cells and the driver's GNN
    branch, the spec-following ``shard_batch``) are among the files
    checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module,names", [
    ("repro_torch.models.gnn.equiformer_v2",
     ("EquiformerConfig", "init_params", "make_param_specs", "grad_sync",
      "forward", "loss_fn", "_segment_softmax", "_so2_conv", "_layer")),
    ("repro_torch.models.gnn.spherical",
     ("real_sph_harm", "rotation_to_z", "wigner_blocks", "pack_wigner",
      "wigner_layout", "packed_wigner_size")),
    ("repro_torch.data.graphs",
     ("radial_basis", "edge_geometry", "random_graph",
      "random_molecule_batch", "CSRGraph", "random_csr_graph",
      "fanout_sample", "cell_batch")),
    ("repro_torch.configs.equiformer_v2", ("CONFIG", "SMOKE", "CELLS",
                                           "ARCH")),
    ("repro_torch.launch.steps", ("build_gnn_cell", "_gnn_graph_template",
                                  "_gnn_flops")),
])
def test_gnn_slice_imports_with_jax_blocked(module, names):
    """The GNN slice's modules import with ``import jax`` and ``import
    repro`` failing, pull in neither, and expose the JAX package's names;
    the registry then holds every arch of the JAX package."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"mod = importlib.import_module({module!r})\n"
        f"assert all(hasattr(mod, n) for n in {names!r})\n"
        "from repro_torch.configs.registry import get_arch\n"
        "assert get_arch('equiformer-v2').family == 'gnn'\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


ANALYSIS_SLICE = ("launch/cost_analysis.py", "launch/dryrun.py",
                  "launch/roofline.py", "launch/mesh.py",
                  "models/transformer.py", "launch/steps.py",
                  "kernels/fused_agg_opt/ops.py", "kernels/quant/ops.py",
                  "kernels/wire_path/ops.py", "kernels/embedding_bag/ops.py")


@pytest.mark.parametrize("module", ANALYSIS_SLICE)
def test_analysis_slice_modules_are_checked(module):
    """The launch analysis (the cost mode, the dry run, the roofline, the
    recording mesh, the kernels' meta charges) and sequence parallelism's
    modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module,names", [
    ("repro_torch.launch.cost_analysis",
     ("CostMode", "step_costs", "record_kernel", "charge")),
    ("repro_torch.launch.dryrun", ("run_cell", "dry_run", "local_args",
                                   "main")),
    ("repro_torch.launch.roofline", ("analyze", "fmt_s", "table", "main")),
    ("repro_torch.launch.mesh", ("RecordingMesh", "wire_factor", "Mesh")),
])
def test_analysis_slice_imports_with_jax_blocked(module, names):
    """The launch analysis imports with ``import jax`` and ``import
    repro`` failing, pulls in neither, exposes the JAX package's names,
    and its two CLIs answer ``--help`` as ``python -m``."""
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
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    if module.endswith((".dryrun", ".roofline")):
        out = subprocess.run(
            [sys.executable, "-m", module, "--help"], capture_output=True,
            text=True, timeout=180, cwd=ROOT, env=env)
        flag = "--variant" if module.endswith(".dryrun") else "--mesh"
        assert out.returncode == 0 and flag in out.stdout


EXAMPLES = ("quickstart", "train_100m_e2e", "gnn_molecules",
            "recsys_serving", "serve_lm", "train_distributed_ps")


@pytest.mark.parametrize("module", [f"examples/{n}.py" for n in EXAMPLES]
                         + ["examples/__init__.py"])
def test_example_programs_are_checked(module):
    """The example programs (``repro_torch.examples``) are among the files
    checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_example_programs_import_with_jax_blocked():
    """Every example program imports in a process where ``import jax`` and
    ``import repro`` fail, pulls in neither, and has its ``main``."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for n in {EXAMPLES!r}:\n"
        "    mod = importlib.import_module('repro_torch.examples.' + n)\n"
        "    assert callable(mod.main), n\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_programs_run_as_modules(name):
    """``python -m repro_torch.examples.<name> --help`` runs with JAX
    absent from the path and prints the program's usage."""
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--help"],
        capture_output=True, text=True, timeout=180, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.startswith("usage:"), out.stderr

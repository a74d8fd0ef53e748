"""The repo's example programs on the port (torch counterparts of
``examples/*.py``), one module each, run as
``python -m repro_torch.examples.<name>``:

  quickstart            a tiny LM through the chunk-sharded PBox fabric
  train_100m_e2e        a ~100M-parameter LM through the PS exchange, the
                        prefetch pipeline and async checkpoints
  gnn_molecules         EquiformerV2 fitting synthetic molecule energies
  recsys_serving        DLRM scoring and bulk candidate retrieval
  serve_lm              batched LM serving at ``--mesh 1x2`` (2 ranks)
  train_distributed_ps  the SPMD PS step on a (2, 4) mesh (8 ranks) with a
                        checkpoint, a crash and a restart

Each module's body is ``main(argv=None, *, device=None, ...) -> dict``: it
runs on the CUDA card unless ``device`` says otherwise, prints what the
JAX example prints, and returns the numbers it printed.  Keyword
arguments beyond ``device`` (fewer steps, a narrower config, a checkpoint
directory, initial parameters) let a test or ``chip_smoke.py`` drive the
same program at another size; their defaults are the JAX example's.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path


def has_ranks() -> bool:
    """Whether this process is a rank already: of a process group its
    caller started, or of ``torchrun``'s world."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import env_rank

    return dist.is_initialized() or env_rank() is not None


def torchrun(module: str, ranks: int, argv: list, device) -> None:
    """Run ``python -m <module> <argv>`` as ``ranks`` processes under
    ``torchrun`` (one rank a card, NCCL), as the JAX examples start their
    emulated devices themselves.  The ranks pick their cards; a ``device``
    can only be given to ranks a caller started."""
    if device is not None:
        raise ValueError(
            f"{module} runs {ranks} ranks: outside a process group it starts "
            f"torchrun on {ranks} cards; to run on {device}, call main inside "
            "a group of that many ranks")
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-m", "torch.distributed.run",
                    "--nproc-per-node", str(ranks), "-m", module, *argv],
                   check=True, env=env)

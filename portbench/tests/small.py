"""Small versions of the cells for the CPU tests: each cell's own files,
with the sizes that its configuration's and its traffic's ``small`` keys
give, so that a whole run takes about a second on the CPU."""
from __future__ import annotations

from portbench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def files(workload: str) -> dict:
    """The cell's files (``harness.cell_files``), cut to their small size."""
    f = harness.cell_files(workload)
    f["config"].update(f["config"]["small"])
    f["traffic"].update(f["traffic"]["small"])
    return f

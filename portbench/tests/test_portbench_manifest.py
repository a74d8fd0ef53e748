"""BENCHMARK.json and the files it names: every cell's pieces are found by
name, and the names, units and numbers keep to the manifest's rules."""
import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_keys_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and isinstance(e[key], str):
                assert _line(e[key]), (e["name"], key)
        for cell in e.get("workloads", []):
            assert cell in CELLS


def test_metrics_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(_line(x) for x in layers)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    """The configuration, traffic mix, limits, family, driver and every
    metric reader the cell needs exist under the names the manifest
    gives."""
    f = harness.cell_files(workload, BENCH)
    cell = f["cell"]
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4)
    importlib.import_module(f"portbench.families.{f['config']['family']}")
    importlib.import_module(f"portbench.drivers.{f['traffic']['driver']}")
    assert f["limits"]
    for m in BENCH["per_layer"]:
        if "workloads" not in m or workload in m["workloads"]:
            base = m["name"].split(".")[0]
            reader = importlib.import_module(f"portbench.metrics.{base}")
            assert callable(reader.read)
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2


def test_configs_files_and_reduced():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                        r"proj|head|expansion|channels|widths|experts_per")
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if widths.search(k)]


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel

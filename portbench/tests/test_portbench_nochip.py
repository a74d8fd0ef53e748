"""Without a card the command refuses to run: it exits with another code
than 0 and prints no result, in the checkout and in a directory that
holds only BENCHMARK.json and the benchmark's own files."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cwd: Path):
    cell = BENCH["workloads"][0]["name"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out) -> bool:
    for line in out.stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            pass
    return True


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out), out.stderr[-2000:]


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out), out.stderr[-2000:]


@pytest.mark.parametrize("bad", [["--seed", "x"], ["--trace", "2"]])
def test_bad_arguments_no_result(bad):
    cell = BENCH["workloads"][0]["name"]
    args = ["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"]
    i = args.index(bad[0])
    args[i + 1] = bad[1]
    out = subprocess.run([sys.executable, *BENCH["command"][1:], *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and _no_result(out)

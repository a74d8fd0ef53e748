"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``src/repro_torch/csrc/<name>.cu`` becomes its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The library goes into ``build/torch_kernels/`` at the root of the checkout
(``build/`` is ignored by git).  Its file name carries a hash of the source
and the flags, so an edited source is rebuilt at its next use and an
unchanged one is loaded as it is.  ``-fmad=false`` keeps every
multiply-then-add two rounded ops (the kernels' bit contract with the JAX
package), and no fast-math flag overrides nvcc's IEEE division and square
root.  The compiler's register and spill report (``-Xptxas -v``) is kept
beside the library as ``lib<name>-<hash>.log``.

Nothing here runs at import time: the kernel modules call ``load`` from the
function that launches a kernel, so the package imports on machines without
``nvcc``.  ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found on PATH or in /usr/local/cuda/bin; the port's CUDA "
        "kernels are compiled at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current source and flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = lib.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, log


def _finish(name: str, started: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, log = started
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{out}")
    tmp.replace(library_path(name))  # atomic: a reader never sees half a file


def build_all(names: list[str] | None = None) -> float:
    """Compile every stale kernel library, one ``nvcc`` per source, all
    running at once.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    names = sources() if names is None else names
    started = {n: _start(n) for n in names}
    try:
        for name, job in started.items():
            if job is not None:
                _finish(name, job)
    finally:
        for job in started.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with the ptxas register report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    if name not in _loaded:
        if not library_path(name).exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]

"""The program's own spans and counters, on the profiler's clock.

``span(name)`` marks a stretch of host code (a ``with`` block, or a
function as a decorator).  While a ``torch.profiler`` profile runs it is
a ``torch.profiler.record_function`` range: the profiler stamps it on the
same timeline as the device's kernels and ties each kernel to the host
call that launched it, so a trace charges device time to the span that
was open at the launch.  With no profiler running a span costs one check
of the profiler's flag and never enters ``record_function``.  A span or a
counter never reads a device value, never synchronizes and never
allocates on the device.

The port's spans are named ``ps.<what>``, one at each layer boundary:

  ``ps.worker_grad``  a fabric worker's forward and backward
  ``ps.pull``, ``ps.push``, ``ps.flatten``, ``ps.unflatten``
                      the fabric's exchange and the flat space's packing
  ``ps.encode``       the wire codec (encode with error feedback, decode)
  ``ps.aggregate``    the fabric's round: a shard update per shard
  ``ps.shard_apply``  a shard's (or the owned slab's) fused update
  ``ps.forward``, ``ps.backward``, ``ps.grad_sync``, ``ps.metrics``
                      the SPMD train step's pieces
  ``ps.exchange``     ``PSExchange.device_update``
  ``ps.reduce_scatter``, ``ps.all_gather``, ``ps.all_reduce``
                      each collective inside it
  ``ps.gc``           a collection of Python's garbage collector

A hook in ``gc.callbacks``, installed when this module is first imported,
counts every collection by generation and the host ms it took (two
``perf_counter`` reads a collection), and while a profiler runs marks
each collection as a ``ps.gc`` span.  ``count(name)`` adds one to a
program counter:

  ``wgrad_channels_last``, ``wgrad_nchw``
                        ResNet's convolution weight gradients on the card
                        in f32, by the layout cuDNN got
                        (``models/resnet.py``)

``counters()`` returns them all.
"""
from __future__ import annotations

import functools
import gc
import time

import torch

_profiling = torch._C._autograd._profiler_enabled


class span:
    """A ``ps.*`` range while a profiler runs, else nothing but a flag
    check.  ``with span("ps.pull"): ...`` or ``@span("ps.pull")``."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


_GC = {"gc_collections": 0, "gc_collections.0": 0, "gc_collections.1": 0,
       "gc_collections.2": 0, "gc_ms": 0.0}
_gc_open: list = [0.0, None]  # the running collection's start, its range


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: collections cannot nest, so one slot holds
    the running one."""
    if phase == "start":
        _gc_open[0] = time.perf_counter()
        if _profiling():
            rng = torch.profiler.record_function("ps.gc")
            rng.__enter__()
            _gc_open[1] = rng
        return
    rng, _gc_open[1] = _gc_open[1], None
    if rng is not None:
        rng.__exit__(None, None, None)
    _GC["gc_ms"] += (time.perf_counter() - _gc_open[0]) * 1e3
    _GC["gc_collections"] += 1
    _GC[f"gc_collections.{info['generation']}"] += 1


gc.callbacks.append(_on_gc)

_COUNTS = {"wgrad_channels_last": 0, "wgrad_nchw": 0}


def count(name: str) -> None:
    """Add one to the program counter ``name``."""
    _COUNTS[name] += 1


def counters() -> dict:
    """A snapshot of the module's counters since import: ``gc_collections``
    (all, and ``gc_collections.<generation>``), ``gc_ms`` and the program
    counters."""
    return {**_GC, **_COUNTS}

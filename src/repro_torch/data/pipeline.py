"""Prefetching host->device pipeline (torch counterpart of
``repro/data/pipeline.py``).

A background thread keeps ``depth`` batches materialized ahead of the
training loop (the host-side half of compute/transfer overlap): items come
out in the iterator's order, and an exception the iterator raises is
raised by ``__next__`` after the items before it.  A finite iterator ends
the pipeline with ``StopIteration`` (the JAX one's ``__next__`` then
waits forever; its callers' iterators are infinite), and ``close`` joins
the worker thread (the JAX one leaves it to end on its own).  The default
transform moves every numpy array (or tensor) of a batch dict to the
caller's device: the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

import torch

from repro_torch.device import resolve_device

_JOIN_TIMEOUT = 60.0  # seconds close() waits for the worker thread


def to_device(batch, device: torch.device):
    """A batch (a dict of arrays, or one array) as tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device)


class Prefetcher:
    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Callable | None = None, *,
                 device: torch.device | str | None = None):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        if transform is None:
            dev = resolve_device(device)
            transform = lambda x: to_device(x, dev)  # noqa: E731
        self.transform = transform
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(self.transform(item))
        except BaseException as e:  # noqa: BLE001  (re-raised by __next__)
            self._err = e
        self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker thread and join it.  The queue is drained until
        the worker ends, so a put it is blocked on (an item, or the end
        marker of a finite iterator) always returns; after an item it draws
        at most one more, sees the stop and ends (an infinite iterator
        included)."""
        self._stop.set()
        deadline = time.monotonic() + _JOIN_TIMEOUT
        while self.t.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.05)
        if self.t.is_alive():
            raise TimeoutError(
                f"the prefetch thread is still running {_JOIN_TIMEOUT:.0f} s "
                "after close(): its iterator's next item never came")

"""The port's prefetching pipeline (``repro_torch.data.pipeline``) against
the JAX one.

Mirrors ``test_prefetcher_order_and_error`` (tests/test_data.py:70) on
both packages: items come out in order and the iterator's error is
raised after them.  Beside it: the default transform puts a batch on the
caller's device, a finite iterator ends with ``StopIteration``, and
``close`` joins the worker thread of an infinite iterator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data.pipeline import Prefetcher as JaxPrefetcher  # noqa: E402
from repro_torch.data.pipeline import Prefetcher  # noqa: E402


def gen():
    yield from range(5)
    raise RuntimeError("boom")


@pytest.mark.parametrize("cls", [Prefetcher, JaxPrefetcher],
                         ids=["port", "jax"])
def test_prefetcher_order_and_error(cls):
    p = cls(gen(), depth=2, transform=lambda x: x)
    got = []
    with pytest.raises(RuntimeError) as e:
        for x in p:
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    assert str(e.value) == "boom"
    p.t.join(timeout=10)
    assert not p.t.is_alive()


def test_default_transform_moves_batches_to_the_device():
    batches = ({"tokens": np.full((2, 3), i, np.int32)} for i in range(3))
    p = Prefetcher(batches, depth=1, device="cpu")
    got = list(p)  # a finite iterator ends the pipeline
    assert [int(b["tokens"][0, 0]) for b in got] == [0, 1, 2]
    assert all(isinstance(b["tokens"], torch.Tensor)
               and b["tokens"].device.type == "cpu"
               and b["tokens"].dtype == torch.int32 for b in got)
    p.close()


def test_default_transform_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Prefetcher(iter(()), depth=1)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("taken", [0, 1, 3])
@pytest.mark.parametrize("stream", ["infinite", "finite"])
def test_close_joins_the_worker_thread(stream, depth, taken):
    """An infinite stream (as ``lm_batches`` is) leaves the worker blocked
    on a full queue, a finite one blocked on its end marker; ``close``
    frees it and returns only once it ended."""
    import itertools
    import time

    it = itertools.count() if stream == "infinite" else iter(range(4))
    p = Prefetcher(it, depth=depth, transform=lambda x: x)
    assert [next(p) for _ in range(taken)] == list(range(taken))
    deadline = time.monotonic() + 10
    while p.t.is_alive() and not p.q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p.q.full()  # the worker is blocked on a put, or has ended
    p.close()
    assert not p.t.is_alive()

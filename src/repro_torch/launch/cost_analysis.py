"""What a step costs: FLOPs, bytes moved and the peak of live tensor
bytes, counted from the aten ops it runs (torch counterpart of
``repro/launch/hlo_analysis.py``).

JAX's analyzer reads the compiled HLO and multiplies each ``while`` body
(a ``lax.scan`` over layers, microbatches, attention chunks) by its trip
count, because XLA's own cost analysis counts a loop body once.  The
port's step is eager Python: each layer's ops run, and are seen, once per
layer, so nothing is multiplied.  ``CostMode`` is a ``TorchDispatchMode``
that sees every aten op of the step, its backward's too, and records:

  * ``flops``: matrix products and convolutions only, as ``analyze_hlo``
    counts ``dot`` and ``convolution``: ``2 * prod(out) * prod(contract)``
    by ``torch.utils.flop_counter``'s formulas, split by the product's
    input dtype (``flops_by_dtype``: the card's peak differs by dtype);
  * ``bytes``: each op's operands plus its outputs, every distinct tensor
    once (an in-place op's output is its operand), and 0 for views,
    reshapes, ``expand``, ``detach`` and allocations, as JAX's
    ``_SKIP_BYTES``;
  * the hand-written kernels: on meta tensors, while a mode is active
    (``charging``), a kernel's ops layer (``kernels/*/ops.py``) computes
    nothing and calls ``record_kernel``, which charges the launch as XLA
    charges a custom call: its operands and outputs once, 0 FLOPs
    (``kernels`` counts the launches), never the many ops of its plain
    version;
  * the collectives: ``launch/mesh.RecordingMesh`` keeps their raw and
    wire bytes itself and charges their operands and outputs here
    (``charge``);
  * ``peak_estimate``: the most live tensor bytes at any point.  A storage
    counts from the op that makes it until the last tensor on it is freed;
    the step's arguments count from the start.

``step_costs`` runs a step under the mode and adds ``bytes_min``: the
step's argument and result bytes, each storage counted once (the least
memory traffic of any implementation, JAX's entry-parameter bytes).  On
meta tensors a step costs no device time, which is what ``launch/dryrun``
runs; on the card the same mode counts a real step (only FLOPs and bytes
that do not depend on the data can agree with the meta count).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

_aten = torch.ops.aten

# ops that move no bytes besides the views (``OpOverload.is_view``):
# reshapes, the allocations, whose memory the next op writes, and reads of
# metadata (JAX's _SKIP_BYTES)
_SKIP_BYTES = {
    _aten._unsafe_view, _aten.lift_fresh, _aten.empty, _aten.empty_like,
    _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
    _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.sym_storage_offset, _aten.resize_, _aten.set_,
}

_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64"}

_ACTIVE: list["CostMode"] = []


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _distinct_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def _storage(t: torch.Tensor):
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None, 0
    return st._cdata, st.nbytes()


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            key, n = _storage(t)
            if key is not None and key not in seen:
                seen.add(key)
                total += n
    return total


class CostMode(TorchDispatchMode):
    """Records the FLOPs, bytes, kernel launches and live-byte peak of the
    ops dispatched while it is active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._refs: dict[int, int] = {}  # storage -> tracked tensors on it
        self._sizes: dict[int, int] = {}
        self._tracked = WeakIdKeyDictionary()

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    # -- live storages ---------------------------------------------------
    def track(self, tensors) -> None:
        """Count the storages under ``tensors`` as live until their last
        tracked tensor is freed."""
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t in self._tracked:
                continue
            key, n = _storage(t)
            if key is None:
                continue
            self._tracked[t] = key
            if key not in self._refs:
                self._refs[key] = 0
                self._sizes[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
            self._refs[key] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    # -- charges ----------------------------------------------------------
    def charge(self, reads, writes) -> int:
        """Bytes of an operation the mode does not see as aten ops: its
        operands and outputs, every distinct tensor once."""
        n = _distinct_bytes([*reads, *writes])
        self.bytes += n
        self.track(writes)
        return n

    def kernel(self, name: str, reads, writes) -> None:
        n = self.charge(reads, writes)
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0})
        k["launches"] += 1
        k["bytes"] += n

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        formula = flop_counter.flop_registry.get(packet)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            dt = next((t.dtype for t in ins if t.is_floating_point()),
                      torch.float32)
            key = dtype_name(dt)
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + n
        if packet not in _SKIP_BYTES and not func.is_view:
            self.bytes += _distinct_bytes(ins + outs)
        self.track(outs)
        return out


def charging() -> bool:
    """Whether a ``CostMode`` is active: the kernels' ops layers take
    meta tensors only then (a dry run), and refuse them otherwise."""
    return bool(_ACTIVE)


def charge(reads, writes) -> None:
    """Charge the active modes the bytes of an operation that runs no aten
    op (a recorded collective)."""
    for mode in _ACTIVE:
        mode.charge(reads, writes)


def record_kernel(name: str, reads, writes) -> None:
    """Charge the active modes one launch of the hand-written kernel
    ``name``: its operands and outputs once, 0 FLOPs."""
    for mode in _ACTIVE:
        mode.kernel(name, reads, writes)


def step_costs(fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` under a ``CostMode``: (its result, the
    costs).  The costs are ``flops``, ``flops_by_dtype``, ``bytes``,
    ``bytes_min`` (argument and result storages, each once),
    ``peak_estimate``, ``kernels`` and ``ops``."""
    arg_leaves = tree_leaves((args, kwargs))
    mode = CostMode()
    mode.track(arg_leaves)
    with mode:
        out = fn(*args, **kwargs)
    costs = {
        "flops": mode.flops,
        "flops_by_dtype": dict(mode.flops_by_dtype),
        "bytes": mode.bytes,
        "bytes_min": float(storage_bytes(arg_leaves + tree_leaves(out))),
        "peak_estimate": mode.peak,
        "kernels": {k: dict(v) for k, v in mode.kernels.items()},
        "ops": mode.ops,
    }
    return out, costs

"""Embedding-native sparse tier: row-sharded tables as fabric citizens
(torch counterpart of ``repro/core/sparse.py``).

The dense fabric (core/fabric.py) shards a flat chunk space; this tier
shards *rows of named embedding tables* over the same shard set, so table
row ``i`` lives on exactly one aggregation engine and its replicas, with
exact wire byte accounting.

Pieces:

  ``RowPlacement``          global row id -> owning shard: ``"range"``
                            (contiguous row blocks), ``"hash"``
                            (splitmix64 of the row id, the JAX package's
                            owners bit for bit) or ``"plan"`` (an explicit
                            owner array, via ``from_owner``).
  ``ShardedEmbeddingTable`` one named (V, D) table split into per-shard row
                            slabs, with a per-row int64 version array.
  ``SparseTier``            jagged batched lookups through the
                            ``kernels/embedding_bag`` kernel, coalesced
                            (ids, grad-rows) pushes with per-row int8/bf16
                            codecs + error feedback, synchronous lazy
                            sparse SGD, and chain replication with
                            byte-exact failover.

Bit-identity (tests/test_torch_sparse.py holds it against the JAX tier and
across shard counts): a push is coalesced (duplicates folded in batch
order), codec'd, and *then* routed; the round folds the workers'
contributions in ascending worker order onto the union of touched rows,
scales by ``f32(lr / K)`` and adds ``-step`` to each owner's unique local
rows; a lookup gathers its unique rows and runs one embedding-bag call
over the assembled block.  Every float op is therefore the same for any
shard count, and the same as the JAX tier's.

Tensors: slabs, lookups and error-feedback residuals live on the tier's
device (the fabric's when attached, else the card unless the caller
passes another); ids, placement and versions stay numpy on the host, as
in the JAX package, and only index tensors cross to the device.  The JAX
slabs are immutable arrays, so a chain copy is an O(1) reference that no
later round can touch.  The port keeps that: with replication the round
replaces the slabs it updates; with replication 1 nothing else holds a
slab, so the round updates it in place (same bits, no copy).

Under a ``NetworkTopology`` the shards' home and chain racks come from the
placement plan (the topology's default plan unless one is given), and every
pull, push and chain hop is priced per hop: a rack-local hop on the rack
link, a cross-rack hop on the oversubscribed core (``_account``), with the
event-clock time scaled by ``hop_cost`` in the JAX package's order
(``_us``).  With no topology every shard and worker sits on rack 0 at hop
cost 1.0.  Serving (``SparseReadPlane``, core/serving.py) reads through
``serve_rack``, the cheapest backup rack of a shard's chain.  A placement
plan that carries a solved row map (``row_owner``, from
``PlacementProblem.solve``) places that table's rows, at ``add_table`` and
at every ``reshard``, when the map fits the table and the shard count.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.core.replication import ShardLost
from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models.recsys.embedding import jagged_to_padded
from repro_torch.runtime.sparse_push import coalesce_ids_rows

ROW_ID_BYTES = 4  # one int32 row id per routed row
SCALE_BYTES = 4  # one f32 scale per int8-encoded row


# ---------------------------------------------------------------------------
# placement planner
# ---------------------------------------------------------------------------
def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (splitmix64 finalizer) — platform-stable
    row -> shard hashing with no Python-hash randomization."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class RowPlacement:
    """Row -> shard map for one table: ``owner[i]`` is row ``i``'s shard.

    ``"range"`` splits ``[0, num_rows)`` into ``num_shards`` contiguous
    blocks (sizes differ by at most one row — torchrec row-wise);
    ``"hash"`` assigns ``splitmix64(i) % num_shards``.  Both are pure
    functions of (num_rows, num_shards, policy).  ``"plan"`` takes an
    explicit owner array (``explicit``) verbatim, via :meth:`from_owner`."""

    num_rows: int
    num_shards: int
    policy: str = "hash"
    explicit: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    owner: np.ndarray = dataclasses.field(init=False, repr=False)
    shard_rows: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.num_rows < 1:
            raise ValueError("num_rows must be >= 1")
        if not 1 <= self.num_shards <= self.num_rows:
            raise ValueError("num_shards must be in [1, num_rows]")
        if self.policy == "range":
            sizes = [len(a) for a in np.array_split(np.arange(self.num_rows),
                                                    self.num_shards)]
            owner = np.repeat(np.arange(self.num_shards, dtype=np.int64),
                              sizes)
        elif self.policy == "hash":
            owner = (_splitmix64(np.arange(self.num_rows))
                     % np.uint64(self.num_shards)).astype(np.int64)
        elif self.policy == "plan":
            if self.explicit is None:
                raise ValueError(
                    "policy 'plan' needs an explicit owner array")
            owner = np.asarray(self.explicit, dtype=np.int64).copy()
            if owner.shape != (self.num_rows,):
                raise ValueError(
                    f"explicit owner maps {owner.shape} rows, table has "
                    f"{self.num_rows}")
            if owner.min() < 0 or owner.max() >= self.num_shards:
                raise ValueError(
                    f"explicit owners [{owner.min()}, {owner.max()}] out "
                    f"of range for {self.num_shards} shards")
        else:
            raise ValueError(
                f"unknown placement policy {self.policy!r} "
                "(want 'hash', 'range' or 'plan')")
        owner.setflags(write=False)
        object.__setattr__(self, "owner", owner)
        object.__setattr__(self, "shard_rows", tuple(
            np.flatnonzero(owner == s) for s in range(self.num_shards)))

    @classmethod
    def from_owner(cls, owner: Any, num_shards: int) -> "RowPlacement":
        """Wrap a solved row -> shard array."""
        arr = np.asarray(owner, dtype=np.int64)
        return cls(int(arr.shape[0]), int(num_shards), "plan", explicit=arr)

    def local_of(self, shard: int, ids: np.ndarray) -> np.ndarray:
        """Global row ids (all owned by ``shard``) -> slab-local indices."""
        return np.searchsorted(self.shard_rows[shard], ids)

    @property
    def balance(self) -> float:
        """max/mean rows per shard (1.0 = perfectly even)."""
        sizes = np.array([len(r) for r in self.shard_rows], dtype=np.float64)
        return float(sizes.max() / sizes.mean())


# ---------------------------------------------------------------------------
# per-row codec
# ---------------------------------------------------------------------------
def row_wire_bytes(codec: str, dim: int, num_rows: int) -> int:
    """Exact wire bytes for ``num_rows`` routed rows of width ``dim``:
    payload per codec plus one int32 row id each; int8 adds one f32
    per-row scale."""
    if codec == "none":
        per = 4 * dim
    elif codec == "bf16":
        per = 2 * dim
    elif codec == "int8":
        per = dim + SCALE_BYTES
    else:
        raise ValueError(codec)
    return num_rows * (per + ROW_ID_BYTES)


def encode_rows(codec: str, rows: torch.Tensor) -> torch.Tensor:
    """One wire crossing for an (n, D) row block: what the receiver
    decodes.  bf16 rounds to nearest even, and a NaN keeps its sign as
    the quiet NaN XLA writes.  int8 is symmetric per-row quantization — scale ``amax/127``
    (a true division: the JAX tier runs it eagerly, where XLA does not turn
    it into a product), all-zero rows pinned to scale 1.0, round half to
    even.  A NaN row has scale 1.0 (the max propagates NaN) and its NaN
    quotients encode as 0, as XLA's float-to-int conversion gives; torch's
    NaN-to-int8 cast is not defined, so that mapping is written out."""
    if codec == "none":
        return rows
    if codec == "bf16":
        # XLA keeps a NaN's sign and quiets it to 0x7fc00000 (torch writes
        # 0xffff0000 on the CPU, 0x7fff0000 on the card): written out
        sign = rows.view(torch.int32) & torch.iinfo(torch.int32).min
        nan = (sign | 0x7FC00000).view(torch.float32)
        return torch.where(rows.isnan(), nan, rows.to(torch.bfloat16).float())
    if codec == "int8":
        amax = torch.amax(torch.abs(rows), dim=1, keepdim=True)
        # a tensor divisor: on the card torch turns division by a Python
        # scalar into a product with its f32 reciprocal (one ulp off)
        scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                            torch.ones_like(amax))
        q = torch.clamp(torch.round(rows / scale), -127, 127)
        q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
        return q.to(torch.int8).float() * scale
    raise ValueError(codec)


# ---------------------------------------------------------------------------
# jagged batch format
# ---------------------------------------------------------------------------
def check_jagged(values: Any, offsets: Any, num_rows: int) -> None:
    """Validate a KeyedJaggedTensor-style (values, offsets) batch: offsets
    int, starting at 0, non-decreasing, ending at ``len(values)``; values
    int row ids inside ``[0, num_rows)``.  Raises before any kernel sees
    the batch."""
    off = np.asarray(offsets)
    val = np.asarray(values)
    if not np.issubdtype(off.dtype, np.integer):
        raise TypeError(f"offsets must be integers, got {off.dtype}")
    if off.ndim != 1 or off.size < 2:
        raise ValueError("offsets must be 1-D with >= 2 entries (B+1)")
    if off[0] != 0 or off[-1] != val.size:
        raise ValueError(
            f"offsets must span [0, {val.size}], got [{off[0]}, {off[-1]}]")
    if np.any(np.diff(off) < 0):
        raise ValueError("offsets must be non-decreasing")
    if val.size:
        if not np.issubdtype(val.dtype, np.integer):
            raise TypeError(f"row ids must be integers, got {val.dtype}")
        lo, hi = int(val.min()), int(val.max())
        if lo < 0 or hi >= num_rows:
            raise ValueError(
                f"row ids [{lo}, {hi}] out of range for a {num_rows}-row "
                "table")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SparseStats:
    """Sparse-tier accounting (the row-granular twin of ServerStats): the
    JAX package's fields, all of them, so the two tiers' stats compare
    field by field."""

    pushes: int = 0  # worker pushes accepted
    rounds: int = 0  # admitted update rounds
    lookups: int = 0  # jagged lookup batches served
    rows_pushed: int = 0  # unique rows routed on the push wire
    rows_coalesced: int = 0  # duplicate ids folded at the worker NIC
    rows_pulled: int = 0  # unique rows fetched for lookups
    rows_replicated: int = 0  # delta rows shipped down chains
    bytes_pushed: int = 0  # worker -> shard (codec'd rows + ids)
    bytes_pulled: int = 0  # shard -> worker (raw f32 rows + ids)
    bytes_replicated: int = 0  # chain syncs + resilvers (raw f32)
    bytes_rack_link: int = 0  # all of the above on rack-local links
    bytes_core_link: int = 0  # ... crossing the oversubscribed core
    failovers: int = 0
    resilvers: int = 0
    rescales: int = 0  # in-place shard-count / placement changes
    sim_push_us: float = 0.0  # event-clock push wire time
    sim_lookup_us: float = 0.0  # event-clock pull wire time
    sim_replication_us: float = 0.0  # event-clock chain time

    @property
    def coalesce_rate(self) -> float:
        total = self.rows_pushed + self.rows_coalesced
        return self.rows_coalesced / total if total else 0.0


# ---------------------------------------------------------------------------
# one sharded table
# ---------------------------------------------------------------------------
class ShardedEmbeddingTable:
    """One named (V, D) table row-split into per-shard slabs.

    ``slabs[s]`` holds rows ``placement.shard_rows[s]`` in ascending global
    order, on the table's device; ``versions[i]`` is the round that last
    updated row ``i``.  ``init`` is copied (the slabs are gathers of it),
    so the caller may drop it."""

    def __init__(self, name: str, init: Any, placement: RowPlacement,
                 device: torch.device):
        arr = torch.as_tensor(init, dtype=torch.float32, device=device)
        if arr.dim() != 2:
            raise ValueError(f"table {name!r} must be 2-D, got {tuple(arr.shape)}")
        if arr.shape[0] != placement.num_rows:
            raise ValueError(
                f"table {name!r} has {arr.shape[0]} rows, placement maps "
                f"{placement.num_rows}")
        self.name = name
        self.num_rows, self.dim = (int(arr.shape[0]), int(arr.shape[1]))
        self.placement = placement
        self.device = device
        # each shard's global row ids, on the device (the dense view's
        # scatter and the slab gathers index with them)
        self._shard_ids = [torch.from_numpy(r).to(device)
                           for r in placement.shard_rows]
        self.slabs = [arr[ids] for ids in self._shard_ids]
        self.versions = np.zeros(self.num_rows, dtype=np.int64)
        self._dense: torch.Tensor | None = None

    def dense(self) -> torch.Tensor:
        """The assembled (V, D) view (memoized until the next mutation).
        The shards' rows partition the table, so every row is written and
        the view needs no zero fill."""
        if self._dense is None:
            rows = torch.empty((self.num_rows, self.dim), dtype=torch.float32,
                               device=self.device)
            for ids, slab in zip(self._shard_ids, self.slabs):
                if len(ids):
                    rows.index_copy_(0, ids, slab)
            self._dense = rows
        return self._dense

    def rows(self, ids: np.ndarray) -> torch.Tensor:
        """Gather global rows (any order, duplicates allowed)."""
        idx = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(self.device)
        return self.dense().index_select(0, idx)

    def dirty(self) -> None:
        self._dense = None


class _SparseChain:
    """Chain replication for one shard's slice of every table: ``factor-1``
    backups each referencing the byte-exact post-round slabs (the round
    never writes a slab a chain holds: with replication it replaces the
    slabs it updates)."""

    def __init__(self, shard_id: int, factor: int, racks: Any):
        self.shard_id = shard_id
        self.factor = factor
        self.racks = tuple(int(r) for r in racks)
        self.synced_round = -1
        self.copies: list[dict] = []

    def hop_racks(self) -> tuple:
        return tuple((self.racks[i], self.racks[i + 1])
                     for i in range(self.factor - 1))

    def sync(self, payload: dict, round_: int) -> None:
        self.copies = [payload for _ in range(self.factor - 1)]
        self.synced_round = round_

    def tail(self) -> dict:
        if not self.copies:
            raise ShardLost(self.shard_id, 0, self.synced_round, self.factor)
        return self.copies[-1]

    def promote(self) -> dict:
        if not self.copies:
            raise ShardLost(self.shard_id, 0, -1, self.factor)
        return self.copies.pop(0)


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------
class SparseTier:
    """Row-sharded embedding tables over the fabric's shard set.

    Standalone (``num_shards``/``num_workers``/``topology`` given) or
    attached to a live ``PBoxFabric`` — attached, the tier co-resides with
    the dense shards (shard ``s`` of every table lives on ``PBoxShard s``),
    inherits the fabric's shard and worker counts, topology, link model,
    chunk size, replication and device, and registers in
    ``fabric.sparse_tiers``.

    The update is synchronous lazy sparse SGD: ``push`` stages one
    worker's coalesced (ids, grad-rows) set per table; when every live
    worker has pushed, the round fires."""

    def __init__(
        self,
        *,
        num_shards: int | None = None,
        num_workers: int | None = None,
        topology: Any = None,
        fabric: Any = None,
        placement: str = "hash",
        codec: str = "none",
        error_feedback: bool = True,
        replication: int = 1,
        lr: float = 0.1,
        wire_us_per_chunk: float | None = None,
        chunk_elems: int | None = None,
        plan: Any = None,
        device: torch.device | str | None = None,
    ):
        if fabric is not None:
            if plan is None:
                plan = getattr(fabric, "plan", None)
            num_shards = fabric.num_shards if num_shards is None else num_shards
            num_workers = (fabric.num_workers if num_workers is None
                           else num_workers)
            topology = fabric.topology if topology is None else topology
            replication = (fabric.replication if replication == 1
                           else replication)
            if wire_us_per_chunk is None:
                wire_us_per_chunk = fabric.link.wire_us_per_chunk
            if chunk_elems is None:
                chunk_elems = fabric.space.chunk_elems
            if device is None:
                device = fabric.device
        self.num_shards = int(num_shards or 1)
        self.num_workers = int(num_workers or 1)
        if self.num_shards < 1 or self.num_workers < 1:
            raise ValueError("num_shards and num_workers must be >= 1")
        if topology is not None and topology.num_workers < self.num_workers:
            raise ValueError(
                f"topology places {topology.num_workers} workers, tier has "
                f"{self.num_workers}")
        if codec not in ("none", "bf16", "int8"):
            raise ValueError(f"unknown codec {codec!r}")
        if replication < 1:
            raise ValueError("replication must be >= 1")
        if placement not in ("hash", "range"):
            raise ValueError(f"unknown placement policy {placement!r}")
        self.device = resolve_device(device)
        self.topology = topology
        self.fabric = fabric
        self.plan = plan
        self.default_placement = placement
        self.codec = codec
        self.error_feedback = bool(error_feedback)
        self.replication = int(replication)
        self.lr = float(lr)
        self.wire_us_per_chunk = float(
            1.0 if wire_us_per_chunk is None else wire_us_per_chunk)
        self.chunk_elems = int(8192 if chunk_elems is None else chunk_elems)
        self.tables: dict[str, ShardedEmbeddingTable] = {}
        self.stats = SparseStats()
        self.round = 0
        # shard home racks + anti-affine chain racks, shared by every table
        # (the placement plan's layout, else the topology's, else rack 0)
        self.chain_racks = self._resolve_chain_racks()
        self.home_racks = self.chain_racks[:, 0]
        self._chains = [
            _SparseChain(s, self.replication, self.chain_racks[s])
            for s in range(self.num_shards)
        ] if self.replication > 1 else []
        # staged pushes: worker -> {table: (uniq ids np, decoded rows)}
        self._inbox: dict[int, dict[str, tuple[np.ndarray, torch.Tensor]]] = {}
        # per-(worker, table) dense codec residuals (worker-NIC EF)
        self._ef: dict[tuple[int, str], torch.Tensor] = {}
        # sparse serving planes (core/serving.SparseReadPlane) register
        # here as weakrefs so on_restore() can invalidate their caches
        self.read_planes: list[Any] = []
        if fabric is not None and hasattr(fabric, "sparse_tiers"):
            fabric.sparse_tiers.append(weakref.ref(self))

    def _resolve_chain_racks(self) -> np.ndarray:
        """Shard -> chain-rack rows for the tier's shard count: the
        attached plan's when its shard space and depth match, else the
        topology's plan-backed/default map, else rack 0."""
        plan = self.plan
        if (plan is not None
                and getattr(plan, "num_shards", None) == self.num_shards
                and plan.replica_racks.shape[1] >= self.replication):
            return np.asarray(plan.replica_racks[:, :self.replication],
                              dtype=np.int64).copy()
        if self.topology is not None:
            return self.topology.replica_racks(self.num_shards,
                                               self.replication)
        return np.zeros((self.num_shards, self.replication), dtype=np.int64)

    def _plan_row_owner(self, name: str, num_rows: int) -> np.ndarray | None:
        """The attached plan's solved row map for ``name`` when it fits
        this tier's shard space and the table's row count, else None."""
        plan = self.plan
        if plan is None:
            return None
        owner = getattr(plan, "row_owner", {}).get(name)
        if owner is None:
            return None
        owner = np.asarray(owner, dtype=np.int64)
        if (owner.shape != (num_rows,) or owner.size == 0
                or owner.min() < 0 or owner.max() >= self.num_shards):
            return None
        return owner

    # -- tables ----------------------------------------------------------
    def add_table(self, name: str, init: Any,
                  *, placement: str | None = None) -> ShardedEmbeddingTable:
        """Create a row-sharded table from ``init`` (V, D).  An explicit
        ``placement`` policy wins; otherwise the attached plan's solved row
        map for ``name`` (if it fits) is used, falling back to the tier's
        default policy.  The slabs are copies: the caller may drop
        ``init``."""
        if name in self.tables:
            raise ValueError(f"table {name!r} already exists")
        num_rows = int(np.shape(init)[0])
        solved = (self._plan_row_owner(name, num_rows)
                  if placement is None else None)
        if solved is not None:
            plan = RowPlacement.from_owner(solved, self.num_shards)
        else:
            plan = RowPlacement(num_rows, self.num_shards,
                                placement or self.default_placement)
        table = ShardedEmbeddingTable(name, init, plan, self.device)
        self.tables[name] = table
        if self._chains:
            for chain in self._chains:
                # provisioning copies ride the model broadcast, not the
                # training wire (same convention as the dense chains)
                chain.sync(self._shard_payload(chain.shard_id), self.round)
        return table

    def table(self, name: str) -> torch.Tensor:
        """Assembled (V, D) view of one table (tests' oracle surface)."""
        return self._table(name).dense()

    def row_versions(self, name: str) -> np.ndarray:
        return self._table(name).versions

    def _table(self, name: str) -> ShardedEmbeddingTable:
        if name not in self.tables:
            raise KeyError(f"no table {name!r}")
        return self.tables[name]

    # -- wire pricing ----------------------------------------------------
    def _worker_rack(self, worker: int) -> int:
        if not 0 <= worker < self.num_workers:
            raise ValueError(f"no worker {worker}")
        if self.topology is None:
            return 0
        return self.topology.rack_of[worker]

    def _hop_cost(self, src: int, dst: int) -> float:
        if self.topology is None:
            return 1.0
        return self.topology.hop_cost(src, dst)

    def _us(self, nbytes: int, src_rack: int, dst_rack: int) -> float:
        """Event-clock cost of ``nbytes`` between two racks: the link
        model's per-chunk time pro-rated by bytes, scaled by hop cost (the
        JAX package's product order)."""
        chunk_bytes = 4 * self.chunk_elems
        return (self.wire_us_per_chunk * nbytes / chunk_bytes
                * self._hop_cost(src_rack, dst_rack))

    def _account(self, nbytes: int, src_rack: int, dst_rack: int) -> None:
        if src_rack == dst_rack:
            self.stats.bytes_rack_link += nbytes
        else:
            self.stats.bytes_core_link += nbytes

    # -- lookups (the PS pull) -------------------------------------------
    def lookup(self, worker: int, name: str, values: Any, offsets: Any,
               weights: Any = None, *, mode: str = "sum") -> torch.Tensor:
        """Serve one jagged batch: bag ``b`` is ``values[offsets[b]:
        offsets[b+1]]`` (optionally weighted), reduced by ``mode``, as a
        (B, D) f32 tensor on the tier's device.

        The worker pulls each *unique* touched row from its owner shard
        (raw f32), assembles the (U, D) block, and runs one embedding-bag
        kernel call over block-local indices — so the float path is the
        same for every shard count and the wire bill is per unique row."""
        table = self._table(name)
        check_jagged(values, offsets, table.num_rows)
        off = np.asarray(offsets, dtype=np.int64)
        val = np.asarray(values, dtype=np.int64)
        nbags = off.size - 1
        rack = self._worker_rack(worker)
        self.stats.lookups += 1
        if val.size == 0:
            return torch.zeros((nbags, table.dim), dtype=torch.float32,
                               device=self.device)
        uniq, inv = np.unique(val, return_inverse=True)
        # wire: one raw row + id per unique touched row, out of its owner
        self.stats.rows_pulled += uniq.size
        per_row = 4 * table.dim + ROW_ID_BYTES
        owners = table.placement.owner[uniq]
        for s, count in zip(*np.unique(owners, return_counts=True)):
            nbytes = int(per_row * count)
            self.stats.bytes_pulled += nbytes
            src = int(self.home_racks[s])
            self._account(nbytes, src, rack)
            self.stats.sim_lookup_us += self._us(nbytes, src, rack)
        block = table.rows(uniq)  # (U, D), order-preserving by global id
        # jagged -> padded *block-local* bags, built on the host and checked
        # there by the kernel's wrapper before they cross to the device
        idx, wgt = jagged_to_padded(inv.reshape(-1), off, weights,
                                    device="cpu")
        return embedding_bag(block, idx, wgt, mode)

    # -- pushes (the PS push) --------------------------------------------
    def push(self, worker: int, updates: dict[str, tuple]) -> None:
        """Stage one worker's sparse gradients: ``{table: (ids, rows)}``
        with ``ids`` (n,) host ints and ``rows`` (n, D) f32.  Duplicate ids
        are coalesced at the NIC (summed in batch order), the row codec +
        error feedback runs before routing, and exact wire bytes are
        accounted.  The round fires when every worker has staged."""
        rack = self._worker_rack(worker)
        if worker in self._inbox:
            raise RuntimeError(
                f"worker {worker} already pushed round {self.round}")
        staged: dict[str, tuple[np.ndarray, torch.Tensor]] = {}
        for name, (ids, rows) in updates.items():
            table = self._table(name)
            ids_np = np.asarray(ids)
            if ids_np.size and not np.issubdtype(ids_np.dtype, np.integer):
                raise TypeError(
                    f"push ids must be integers, got {ids_np.dtype}")
            rows_t = torch.as_tensor(rows, dtype=torch.float32,
                                     device=self.device)
            if rows_t.dim() != 2 or tuple(rows_t.shape) != (ids_np.size,
                                                           table.dim):
                raise ValueError(
                    f"rows must be ({ids_np.size}, {table.dim}), got "
                    f"{tuple(rows_t.shape)}")
            if ids_np.size:
                lo, hi = int(ids_np.min()), int(ids_np.max())
                if lo < 0 or hi >= table.num_rows:
                    raise ValueError(
                        f"push ids [{lo}, {hi}] out of range for table "
                        f"{name!r} ({table.num_rows} rows)")
            uniq, summed = coalesce_ids_rows(ids_np, rows_t)
            self.stats.rows_coalesced += ids_np.size - uniq.size
            # worker-NIC codec + dense error-feedback residual
            if self.codec != "none" and uniq.size:
                key = (worker, name)
                at = torch.from_numpy(uniq).to(self.device)
                if self.error_feedback:
                    if key not in self._ef:
                        self._ef[key] = torch.zeros(
                            (table.num_rows, table.dim), dtype=torch.float32,
                            device=self.device)
                    summed = summed + self._ef[key][at]
                dec = encode_rows(self.codec, summed)
                if self.error_feedback:
                    self._ef[key][at] = summed - dec
                summed = dec
            staged[name] = (uniq, summed)
            # wire: codec'd rows + ids, worker rack -> each owner's rack
            if uniq.size:
                self.stats.rows_pushed += uniq.size
                owners = table.placement.owner[uniq]
                for s, count in zip(*np.unique(owners, return_counts=True)):
                    nbytes = row_wire_bytes(self.codec, table.dim, int(count))
                    self.stats.bytes_pushed += nbytes
                    dst = int(self.home_racks[s])
                    self._account(nbytes, rack, dst)
                    self.stats.sim_push_us += self._us(nbytes, rack, dst)
        self._inbox[worker] = staged
        self.stats.pushes += 1
        if len(self._inbox) >= self._barrier():
            self._apply_round()

    def _barrier(self) -> int:
        if self.fabric is not None:
            alive = self.num_workers - len(self.fabric.dead_workers)
            return max(1, alive)
        return self.num_workers

    def _apply_round(self) -> None:
        """Admit the staged round: per table, fold worker contributions in
        ascending worker order over the union of touched rows (the only
        f32 reduction — sharding never re-associates it), scale by
        ``f32(lr / K)``, then add ``-step`` to each shard's unique local
        rows."""
        self.round += 1
        self.stats.rounds += 1
        workers = sorted(self._inbox)
        # the JAX tier's weak-typed Python scalar, rounded to f32
        scale = float(np.float32(self.lr / len(workers)))
        delta_rows = np.zeros(self.num_shards, dtype=np.int64)
        delta_bytes = np.zeros(self.num_shards, dtype=np.int64)
        for name, table in self.tables.items():
            per_worker = [
                self._inbox[w][name] for w in workers
                if name in self._inbox[w] and self._inbox[w][name][0].size
            ]
            if not per_worker:
                continue
            union = np.unique(np.concatenate([u for u, _ in per_worker]))
            acc = torch.zeros((union.size, table.dim), dtype=torch.float32,
                              device=self.device)
            for uniq, rows in per_worker:  # ascending worker order
                pos = torch.from_numpy(np.searchsorted(union, uniq)).to(
                    self.device)
                acc[pos] = acc[pos] + rows  # unique positions: no atomics
            step = acc * scale
            owners = table.placement.owner[union]
            for s in range(self.num_shards):
                sel = owners == s
                if not sel.any():
                    continue
                local = torch.from_numpy(
                    table.placement.local_of(s, union[sel])).to(self.device)
                upd = -step[torch.from_numpy(np.flatnonzero(sel)).to(
                    self.device)]
                slab = table.slabs[s]
                if self._chains:  # a chain holds this slab: replace it
                    table.slabs[s] = slab.index_put((local,), slab[local] + upd)
                else:
                    slab[local] = slab[local] + upd
                n_t = int(sel.sum())
                delta_rows[s] += n_t
                delta_bytes[s] += (4 * table.dim + ROW_ID_BYTES) * n_t
            table.versions[union] = self.round
            table.dirty()
        self._inbox.clear()
        self._sync_chains(delta_rows, delta_bytes)

    # -- replication -----------------------------------------------------
    def _shard_payload(self, shard_id: int) -> dict:
        """One shard's byte-exact post-round state: per table, the slab
        reference plus a copy of the owned rows' versions."""
        return {
            name: (t.slabs[shard_id],
                   t.versions[t.placement.shard_rows[shard_id]].copy())
            for name, t in self.tables.items()
        }

    def _sync_chains(self, delta_rows: np.ndarray,
                     delta_bytes: np.ndarray) -> None:
        """Chain-sync every shard; the wire ships only the rows updated
        this round (log shipping — raw f32, never codec'd: a lossy
        replica could not be promoted bit-exactly)."""
        if not self._chains:
            return
        for chain in self._chains:
            s = chain.shard_id
            chain.sync(self._shard_payload(s), self.round)
            n, nbytes = int(delta_rows[s]), int(delta_bytes[s])
            if n == 0:
                continue
            for src, dst in chain.hop_racks():
                self.stats.rows_replicated += n
                self.stats.bytes_replicated += nbytes
                self._account(nbytes, src, dst)
                self.stats.sim_replication_us += self._us(nbytes, src, dst)

    def serve_rack(self, shard_id: int, frontend_rack: int) -> int:
        """The rack serving reads of ``shard_id``: the cheapest *backup*
        rack when a chain exists (serving never queues on the primary
        engine), the home rack otherwise."""
        if not self._chains:
            return int(self.home_racks[shard_id])
        racks = self._chains[shard_id].racks[1:]
        if self.topology is None:
            return int(racks[0])
        return self.topology.nearest_rack(racks, frontend_rack)

    def failover(self, shard_id: int) -> str:
        """One engine dies at a round edge: promote the chain head's
        byte-exact copy into a replacement slab set and re-silver the
        chain (one full-shard state stream).  Raises ``ShardLost`` with
        no surviving replica — same contract as the dense fabric."""
        if not 0 <= shard_id < self.num_shards:
            raise ValueError(f"no shard {shard_id}")
        if not self._chains:
            rows = sum(len(t.placement.shard_rows[shard_id])
                       for t in self.tables.values())
            raise ShardLost(shard_id, rows, self.round, self.replication)
        chain = self._chains[shard_id]
        payload = chain.promote()
        resilver_bytes = 0
        for name, (slab, versions) in payload.items():
            table = self._table(name)
            table.slabs[shard_id] = slab
            table.versions[table.placement.shard_rows[shard_id]] = versions
            table.dirty()
            resilver_bytes += (4 * table.dim + ROW_ID_BYTES) * len(versions)
        self.stats.failovers += 1
        # re-silver: the promoted state streams back into the chain's
        # empty slot (first hop's racks price it)
        if self.replication > 1:
            src, dst = (chain.racks[0], chain.racks[1 % len(chain.racks)])
            self.stats.bytes_replicated += resilver_bytes
            self._account(resilver_bytes, src, dst)
            self.stats.sim_replication_us += self._us(resilver_bytes, src,
                                                      dst)
        chain.sync(self._shard_payload(shard_id), self.round)
        self.stats.resilvers += 1
        return "failed_over"

    def reshard(self, new_num_shards: int, *, plan: Any = None) -> None:
        """Re-partition every table's rows over ``new_num_shards`` engines
        in place, at a round edge (staged pushes must have drained).

        Each table's slabs are rebuilt by gathering rows out of its
        assembled dense view (byte-exact), the per-row versions carry over,
        and the error-feedback residuals are dense and shard-independent,
        so resharding moves only the accounting, never numerics.  Chains
        are rebuilt at the new count with a provisioning sync, at the racks
        of ``plan`` (default: the attached fabric's plan).  A table the plan
        gives a fitting solved row map is placed by it; any other keeps its
        policy (a table placed by an earlier map falls back to the tier's
        default policy)."""
        new_num_shards = int(new_num_shards)
        if new_num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self._inbox:
            raise RuntimeError(
                "reshard is a round-edge operation: staged pushes must "
                "drain before the engine set changes")
        for name, t in self.tables.items():
            if t.num_rows < new_num_shards:
                raise ValueError(
                    f"table {name!r} has {t.num_rows} rows, cannot split "
                    f"over {new_num_shards} shards")
        if plan is None and self.fabric is not None:
            plan = getattr(self.fabric, "plan", None)
        self.plan = plan
        if self.fabric is not None and self.fabric.topology is not None:
            self.topology = self.fabric.topology  # plan-backed refresh
        old_tables = self.tables
        self.num_shards = new_num_shards
        self.chain_racks = self._resolve_chain_racks()
        self.home_racks = self.chain_racks[:, 0]
        new_tables: dict[str, ShardedEmbeddingTable] = {}
        for name, t in old_tables.items():
            solved = self._plan_row_owner(name, t.num_rows)
            if solved is not None:
                rp = RowPlacement.from_owner(solved, new_num_shards)
            else:
                policy = (t.placement.policy
                          if t.placement.policy in ("hash", "range")
                          else self.default_placement)
                rp = RowPlacement(t.num_rows, new_num_shards, policy)
            nt = ShardedEmbeddingTable(name, t.dense(), rp, self.device)
            nt.versions = t.versions  # global per-row rounds, shard-free
            new_tables[name] = nt
        self.tables = new_tables
        self._chains = [
            _SparseChain(s, self.replication, self.chain_racks[s])
            for s in range(new_num_shards)
        ] if self.replication > 1 else []
        for chain in self._chains:
            chain.sync(self._shard_payload(chain.shard_id), self.round)
        self.stats.rescales += 1

    def on_restore(self) -> None:
        """The owning fabric restored a snapshot: sparse serving caches
        stamped with rounds from the abandoned timeline must never serve
        again (mirrors PBoxFabric.restore's read-plane invalidation)."""
        self.read_planes = [r for r in self.read_planes if r() is not None]
        for ref in self.read_planes:
            plane = ref()
            if plane is not None:
                plane.invalidate()

    def describe(self) -> str:
        s = self.stats
        tbl = ", ".join(
            f"{name}({t.num_rows}x{t.dim}/{t.placement.policy})"
            for name, t in self.tables.items()) or "no tables"
        return (
            f"SparseTier: {tbl} over {self.num_shards} shards x "
            f"{self.num_workers} workers, codec {self.codec}, R="
            f"{self.replication}; round {self.round}, "
            f"{s.rows_pushed} rows pushed ({s.coalesce_rate:.0%} coalesced), "
            f"{s.rows_pulled} pulled, {s.bytes_rack_link >> 10} rack / "
            f"{s.bytes_core_link >> 10} core KiB"
        )

"""The port's core: the PHub/PBox parameter exchange (torch counterpart of
``repro.core``: the fabric with its straggler modes, rack topology and
switch tier, the fault tier, the tenancy tier), the read plane and the
sparse embedding tier, the placement layer, and the SPMD exchange over
``torch.distributed``)."""
from repro_torch.core.chunking import (
    DEFAULT_CHUNK_ELEMS,
    ParamSpace,
    TensorSlot,
    zeros_like_space,
)
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.config import FabricConfig, FabricConfigError
from repro_torch.core.exchange import ExchangeConfig, PSExchange
from repro_torch.core.fabric import (
    LinkModel,
    PBoxFabric,
    PBoxShard,
    ServerStats,
    ShardStats,
    WorkerHarness,
)
from repro_torch.core.placement import (
    PlacementPlan,
    PlacementProblem,
    PlanDelta,
    current_plan,
    diff_plans,
)
from repro_torch.core.replication import (
    FaultEvent,
    FaultPlan,
    ReplicaGroup,
    ShardLost,
)
from repro_torch.core.server import PHubServer
from repro_torch.core.serving import (
    FabricSource,
    ReadPlane,
    ReadResult,
    ServeStats,
    SnapshotSource,
)
from repro_torch.core.sparse import (
    RowPlacement,
    ShardedEmbeddingTable,
    SparseStats,
    SparseTier,
)
from repro_torch.core.tenancy import (
    JobHandle,
    JobSpec,
    MultiJobFabric,
    dedicated_fabric,
)
from repro_torch.core.topology import NetworkTopology, RackAggregator

__all__ = [
    "JobHandle",
    "JobSpec",
    "MultiJobFabric",
    "dedicated_fabric",
    "FaultEvent",
    "FaultPlan",
    "ReplicaGroup",
    "ShardLost",
    "NetworkTopology",
    "RackAggregator",
    "ParamSpace",
    "TensorSlot",
    "DEFAULT_CHUNK_ELEMS",
    "zeros_like_space",
    "ExchangeConfig",
    "PSExchange",
    "CompressionConfig",
    "PlacementPlan",
    "PlacementProblem",
    "PlanDelta",
    "current_plan",
    "diff_plans",
    "FabricConfig",
    "FabricConfigError",
    "LinkModel",
    "PBoxFabric",
    "PBoxShard",
    "ServerStats",
    "ShardStats",
    "PHubServer",
    "WorkerHarness",
    "FabricSource",
    "ReadPlane",
    "ReadResult",
    "ServeStats",
    "SnapshotSource",
    "RowPlacement",
    "ShardedEmbeddingTable",
    "SparseStats",
    "SparseTier",
]

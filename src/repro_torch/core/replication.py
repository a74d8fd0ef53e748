"""Chain replication for the PS tiers (torch counterpart of
``repro/core/replication.py``).

Only ``ShardLost`` is ported so far: the sparse tier raises it when a shard
fails with no surviving replica.  ``ReplicaGroup`` and ``FaultPlan`` wait
for the port's fault tier.
"""
from __future__ import annotations


class ShardLost(RuntimeError):
    """A shard crashed with no surviving replica: its slab of the flat
    parameter space is unrecoverable.  Raised instead of silently serving
    a corrupt (zero-filled or stale) flat space."""

    def __init__(self, shard_id: int, num_chunks: int, round_: int,
                 replication: int):
        self.shard_id = shard_id
        self.num_chunks = num_chunks
        self.round = round_
        self.replication = replication
        super().__init__(
            f"shard {shard_id} crashed at round {round_} holding "
            f"{num_chunks} chunks with replication={replication}: no "
            "surviving replica to fail over to. Training state is lost — "
            "restore from the last checkpoint, or run the fabric with "
            "replication>=2 so a chain backup can be promoted in place."
        )

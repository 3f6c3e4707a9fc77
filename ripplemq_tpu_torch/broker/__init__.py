"""Broker-side planes of the port. Ported so far: `broker.dataplane` (the
`DataPlane` in local mode, `recover_image`, `replay_records`) and
`broker.replication`'s `FencedError`. The broker server, manager,
metadata Raft and `RoundReplicator` come with slice D (ROADMAP.md)."""

from ripplemq_tpu_torch.broker.dataplane import (
    DataPlane,
    NotCommittedError,
    PartitionFullError,
    StoreReadRaceError,
)

__all__ = [
    "DataPlane",
    "NotCommittedError",
    "PartitionFullError",
    "StoreReadRaceError",
]

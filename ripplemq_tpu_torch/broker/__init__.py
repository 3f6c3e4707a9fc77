"""Broker-side planes of the port. Ported so far: `broker.dataplane` (the
`DataPlane` in local mode, `recover_image`, `replay_records`),
`broker.replication` (`RoundReplicator`, `FencedError`),
`broker.hostraft` (the metadata Raft) and `broker.manager` (the
`PartitionManager`). The broker server comes with slice D2
(ROADMAP.md)."""

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

"""Broker-side planes of the port: `broker.dataplane` (the `DataPlane` in
local mode, `recover_image`, `replay_records`), `broker.replication`
(`RoundReplicator`, `FencedError`), `broker.hostraft` (the metadata
Raft), `broker.manager` (the `PartitionManager`), `broker.server`
(the `BrokerServer`; `python -m ripplemq_tpu_torch.broker` runs one) and
`broker.follower` (the `FollowerReadPlane`, which serves consumes on a
standby below the replicated settled floor).

Twin of `ripplemq_tpu/broker/__init__.py` (PyTorch port)."""

from ripplemq_tpu_torch.broker.hostraft import RaftNode, RaftRunner
from ripplemq_tpu_torch.broker.dataplane import (
    DataPlane,
    NotCommittedError,
    PartitionFullError,
    StoreReadRaceError,
)
from ripplemq_tpu_torch.broker.manager import (
    ConsumerTableFullError,
    PartitionManager,
)
from ripplemq_tpu_torch.broker.follower import FollowerReadPlane
from ripplemq_tpu_torch.broker.server import BrokerServer

__all__ = [
    "RaftNode",
    "RaftRunner",
    "DataPlane",
    "NotCommittedError",
    "PartitionFullError",
    "StoreReadRaceError",
    "ConsumerTableFullError",
    "PartitionManager",
    "BrokerServer",
    "FollowerReadPlane",
]

"""Committed-round replication to standby brokers (PyTorch port).

Twin of `ripplemq_tpu/broker/replication.py`. Ported so far: only
`FencedError`, the refusal the DataPlane's settle pipeline latches on
(a deposed controller drains its settle window without acking). The
`RoundReplicator` (per-standby ordered streams, catch-up join, fencing)
comes with slice D of the port, the broker host runtime (ROADMAP.md).
"""

from __future__ import annotations

from ripplemq_tpu_torch.broker.dataplane import NotCommittedError


class FencedError(NotCommittedError):
    """This controller's epoch is stale: a newer controller exists."""


__all__ = ["FencedError"]

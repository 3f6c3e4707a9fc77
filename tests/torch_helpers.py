"""Shared helpers of the port's DataPlane tests (not collected: the name
does not start with `test_`).

Port planes run on the CPU (`device="cpu"`) with the reference tests'
engine shape: `port_cfg(**kw)` is the port's `EngineConfig` built from
the fields of `tests.helpers.small_cfg(**kw)`. `make_config` builds the
port's `ClusterConfig` as `ripplemq_tpu/chaos/cluster.py`'s
`make_cluster_config` builds the reference's (the reference tests reach
it through `tests/broker_harness.py`, which imports the broker server).
"""

from __future__ import annotations

import dataclasses

from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
from ripplemq_tpu_torch.metadata.models import BrokerInfo, Topic
from tests.helpers import small_cfg


def port_cfg(**kw) -> EngineConfig:
    return EngineConfig(**dataclasses.asdict(small_cfg(**kw)))


def make_config(n_brokers=3, topics=None, engine=None, spare_slots=0,
                **kw) -> ClusterConfig:
    """The port's twin of `chaos.cluster.make_cluster_config`: the same
    brokers, topics, engine (`small_cfg`'s shape sized to the topic
    table plus `spare_slots`) and in-process timings."""
    topics = topics or (Topic("topic1", 2, 3), Topic("topic2", 1, 3))
    engine = engine or port_cfg(
        partitions=sum(t.partitions for t in topics) + int(spare_slots),
        replicas=max(t.replication_factor for t in topics),
    )
    kw.setdefault("election_timeout_s", 0.1)
    kw.setdefault("metadata_election_timeout_s", 0.6)
    kw.setdefault("membership_poll_s", 0.2)
    return ClusterConfig(
        brokers=tuple(
            BrokerInfo(i, "broker", 9000 + i) for i in range(n_brokers)
        ),
        topics=tuple(topics),
        engine=engine,
        rpc_timeout_s=kw.pop("rpc_timeout_s", 5.0),
        **kw,
    )


def port_dp(cfg: EngineConfig, **kw) -> DataPlane:
    """A port DataPlane on the CPU (mode "local"), not started."""
    return DataPlane(cfg, mode="local", device="cpu", **kw)


def read_all(dp, slot, replica=0, start=0):
    """Walk a slot's readable log from `start`, continuing from each
    answer's next_offset, until an answer does not advance."""
    msgs, offset = [], start
    while True:
        got, nxt = dp.read(slot, offset, replica=replica)
        if nxt == offset:
            return msgs
        msgs.extend(got)
        offset = nxt

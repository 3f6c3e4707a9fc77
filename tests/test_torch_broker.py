"""Broker cluster: bootstrap fixpoint, produce/consume/commit, leader checks.

Covers the reference's end-to-end broker behaviors (SURVEY.md §3.1-3.4):
assignment → replicated metadata → partition leaders elected on device →
leader advertisement → client-visible produce/consume round trip.

Twin of `tests/test_broker.py` on the PyTorch port (CPU brokers).
"""

import time

import pytest

from tests.torch_helpers import InProcCluster, make_config
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture(scope="module")
def cluster():
    with InProcCluster() as c:
        c.wait_for_leaders()
        yield c


def call(cluster, addr, req, timeout=10.0):
    return cluster.client().call(addr, req, timeout=timeout)


def test_bootstrap_fixpoint_assigns_and_elects(cluster):
    topics = next(iter(cluster.brokers.values())).manager.get_topics()
    assert {t.name for t in topics} == {"topic1", "topic2"}
    for t in topics:
        assert len(t.assignments) == t.partitions
        for a in t.assignments:
            assert len(a.replicas) == t.replication_factor
            assert a.leader in a.replicas
            assert a.term >= 1


def test_meta_topics_served_by_any_broker(cluster):
    for b in cluster.brokers.values():
        resp = call(cluster, b.addr, {"type": "meta.topics"})
        assert resp["ok"]
        names = {t["name"] for t in resp["topics"]}
        assert names == {"topic1", "topic2"}


def test_produce_consume_commit_roundtrip(cluster):
    leader = cluster.leader_broker("topic1", 0)
    resp = call(
        cluster, leader.addr,
        {"type": "produce", "topic": "topic1", "partition": 0,
         "messages": [b"hello", b"world"]},
    )
    assert resp["ok"], resp
    assert resp["base_offset"] == 0 and resp["count"] == 2

    resp = call(
        cluster, leader.addr,
        {"type": "consume", "topic": "topic1", "partition": 0,
         "consumer": "g1", "max_messages": 10},
    )
    assert resp["ok"], resp
    assert resp["messages"] == [b"hello", b"world"] and resp["offset"] == 0

    resp = call(
        cluster, leader.addr,
        {"type": "offset.commit", "topic": "topic1", "partition": 0,
         "consumer": "g1", "offset": 2},
    )
    assert resp["ok"], resp

    # Next consume starts past the committed offset.
    resp = call(
        cluster, leader.addr,
        {"type": "consume", "topic": "topic1", "partition": 0,
         "consumer": "g1", "max_messages": 10},
    )
    assert resp["ok"] and resp["messages"] == [] and resp["offset"] == 2


def test_big_produce_spans_rounds(cluster):
    leader = cluster.leader_broker("topic2", 0)
    msgs = [f"m{i}".encode() for i in range(25)]  # > max_batch
    resp = call(cluster, leader.addr,
                {"type": "produce", "topic": "topic2", "partition": 0,
                 "messages": msgs}, timeout=30.0)
    assert resp["ok"], resp
    assert resp["count"] == 25


def test_non_leader_refuses_with_hint(cluster):
    leader = cluster.leader_broker("topic1", 1)
    non_leader = next(
        b for b in cluster.brokers.values() if b.broker_id != leader.broker_id
    )
    resp = call(
        cluster, non_leader.addr,
        {"type": "produce", "topic": "topic1", "partition": 1,
         "messages": [b"x"]},
    )
    assert not resp["ok"] and resp["error"] == "not_leader"
    assert resp["leader"] == leader.broker_id
    assert resp["leader_addr"] == leader.addr
    # The hinted broker accepts (fixed reference fallthrough bug: here the
    # refusal really refuses — nothing was appended by the non-leader).
    resp2 = call(
        cluster, leader.addr,
        {"type": "produce", "topic": "topic1", "partition": 1,
         "messages": [b"x"]},
    )
    assert resp2["ok"] and resp2["base_offset"] == 0


def test_unknown_topic_and_bad_requests(cluster):
    b = next(iter(cluster.brokers.values()))
    resp = call(cluster, b.addr,
                {"type": "produce", "topic": "nope", "partition": 0,
                 "messages": [b"x"]})
    assert not resp["ok"]
    resp = call(cluster, b.addr, {"type": "wat"})
    assert not resp["ok"] and "unknown request type" in resp["error"]
    leader = cluster.leader_broker("topic1", 0)
    resp = call(cluster, leader.addr,
                {"type": "produce", "topic": "topic1", "partition": 0,
                 "messages": []})
    assert not resp["ok"]


def test_consumers_isolated_offsets(cluster):
    leader = cluster.leader_broker("topic2", 0)
    call(cluster, leader.addr,
         {"type": "offset.commit", "topic": "topic2", "partition": 0,
          "consumer": "iso-a", "offset": 3})
    ra = call(cluster, leader.addr,
              {"type": "consume", "topic": "topic2", "partition": 0,
               "consumer": "iso-a"})
    rb = call(cluster, leader.addr,
              {"type": "consume", "topic": "topic2", "partition": 0,
               "consumer": "iso-b"})
    assert ra["offset"] == 3 and rb["offset"] == 0
    # Distinct replicated slots cluster-wide.
    slots = {
        b.manager.consumer_slot("iso-a") for b in cluster.brokers.values()
    } | {b.manager.consumer_slot("iso-b") for b in cluster.brokers.values()}
    assert len(slots) == 2 and None not in slots


def test_metadata_consistent_across_brokers(cluster):
    time.sleep(0.3)  # let the last proposals settle everywhere
    views = [
        [t.to_dict() for t in b.manager.get_topics()]
        for b in cluster.brokers.values()
    ]
    assert all(v == views[0] for v in views[1:])


def test_tcp_cluster_roundtrip():
    """Same cluster over real TCP sockets (multi-process-shaped deployment;
    peer brokers reach the controller's engine via engine.* RPCs)."""
    import socket

    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
    from ripplemq_tpu_torch.metadata.models import BrokerInfo, Topic
    from ripplemq_tpu_torch.wire import TcpClient
    from tests.torch_helpers import port_cfg

    ports = []
    socks = []
    for _ in range(3):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()

    config = ClusterConfig(
        brokers=tuple(BrokerInfo(i, "127.0.0.1", ports[i]) for i in range(3)),
        topics=(Topic("tcp-topic", 2, 3),),
        engine=port_cfg(partitions=2, replicas=3),
        metadata_election_timeout_s=0.6,
        rpc_timeout_s=5.0,
    )
    brokers = {
        i: BrokerServer(i, config, net=None, device="cpu", tick_interval_s=0.02,
                        duty_interval_s=0.05)
        for i in range(3)
    }
    client = TcpClient()
    try:
        for b in brokers.values():
            b.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            topics = brokers[0].manager.get_topics()
            if topics and all(
                a.leader is not None for t in topics for a in t.assignments
            ):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("no leaders over TCP")
        leader = brokers[0].manager.leader_of(("tcp-topic", 0))
        addr = config.broker(leader).address
        resp = client.call(addr, {"type": "produce", "topic": "tcp-topic",
                                  "partition": 0, "messages": [b"a", b"b"]},
                           timeout=10.0)
        assert resp["ok"], resp
        resp = client.call(addr, {"type": "consume", "topic": "tcp-topic",
                                  "partition": 0, "consumer": "tc"},
                           timeout=10.0)
        assert resp["ok"] and resp["messages"] == [b"a", b"b"]
        # Also through a NON-leader non-controller broker's engine RPC path:
        non_leader = next(i for i in brokers if i != leader)
        resp = client.call(config.broker(non_leader).address,
                           {"type": "meta.topics"}, timeout=5.0)
        assert resp["ok"] and resp["topics"][0]["name"] == "tcp-topic"
    finally:
        client.close()
        for b in brokers.values():
            b.stop()


def test_non_bytes_payload_rejected_not_fatal(cluster):
    """A malformed produce must error cleanly AND leave the data plane
    serving (regression: a str payload used to kill the step thread)."""
    leader = cluster.leader_broker("topic1", 0)
    resp = call(cluster, leader.addr,
                {"type": "produce", "topic": "topic1", "partition": 0,
                 "messages": ["not-bytes"]})
    assert not resp["ok"]
    resp = call(cluster, leader.addr,
                {"type": "produce", "topic": "topic1", "partition": 0,
                 "messages": [b"fine"]})
    assert resp["ok"], resp
    controller = cluster.brokers[cluster.config.controller]
    assert controller.dataplane.step_errors == 0


def test_unknown_partition_is_terminal_not_retryable(cluster):
    b = next(iter(cluster.brokers.values()))
    for req in (
        {"type": "produce", "topic": "topic1", "partition": 99,
         "messages": [b"x"]},
        {"type": "consume", "topic": "ghost", "partition": 0, "consumer": "c"},
        {"type": "offset.commit", "topic": "topic1", "partition": 99,
         "consumer": "c", "offset": 1},
    ):
        resp = call(cluster, b.addr, req)
        assert not resp["ok"] and "unknown_partition" in resp["error"], resp


def test_consume_max_messages_zero_returns_none(cluster):
    leader = cluster.leader_broker("topic1", 0)
    call(cluster, leader.addr,
         {"type": "produce", "topic": "topic1", "partition": 0,
          "messages": [b"probe-data"]})
    resp = call(cluster, leader.addr,
                {"type": "consume", "topic": "topic1", "partition": 0,
                 "consumer": "probe", "max_messages": 0})
    assert resp["ok"] and resp["messages"] == []


def test_consumer_table_full_is_typed_refusal():
    """The [P, C] offset table is a fixed device tensor; the C+1'th
    consumer name must draw a clean `consumer_table_full` refusal, not
    `internal: RuntimeError` (the reference's unbounded consumerOffsets
    map, PartitionStateMachine.java:27, never refuses — a bounded table
    must refuse WELL). Fresh cluster: registrations fill the shared
    table, which would starve the module-scoped cluster's other tests."""
    from ripplemq_tpu_torch.metadata.models import Topic
    from tests.torch_helpers import port_cfg

    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 1, 3),),
        engine=port_cfg(partitions=1, max_consumers=4),
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        leader = c.leader_broker("t", 0)
        for i in range(4):
            resp = call(c, leader.addr,
                        {"type": "consume", "topic": "t", "partition": 0,
                         "consumer": f"full-{i}", "max_messages": 0})
            assert resp["ok"], resp
        resp = call(c, leader.addr,
                    {"type": "consume", "topic": "t", "partition": 0,
                     "consumer": "full-overflow", "max_messages": 0})
        assert not resp["ok"], resp
        assert resp["error"].startswith("consumer_table_full"), resp
        assert "internal" not in resp["error"], resp
        # Registered names keep working at the full table.
        resp = call(c, leader.addr,
                    {"type": "consume", "topic": "t", "partition": 0,
                     "consumer": "full-0"})
        assert resp["ok"], resp

"""Linearizable reads behind the `linearizable_reads` flag.

SURVEY.md §7 "read semantics" required a decision: replicate the
reference's non-linearizable leader-local reads
(PartitionStateMachine.java:85-110) or add read-index behind a flag.
Both now exist. Default (off): reads are commit-bounded (already
stricter than the reference) but a deposed-but-partitioned controller
can serve an old-but-committed prefix while a promoted standby accepts
newer writes. Flag on: every consume first proves the controller epoch
through the standby ack stream, so the stale controller REFUSES instead.

Twin of `tests/test_linearizable_reads.py` on the PyTorch port (CPU
brokers).
"""

from __future__ import annotations

import pytest

from ripplemq_tpu_torch.metadata.models import Topic
from tests.test_torch_controller_failover import (
    _any_survivor,
    _produce,
    _wait_standbys,
)
from tests.torch_helpers import InProcCluster, make_config, port_cfg, wait_until
from tests.torch_port_modules import admit

admit(__name__)


def _make_cluster(linearizable: bool) -> InProcCluster:
    config = make_config(
        n_brokers=4,
        topics=(Topic("t", 2, 3),),
        engine=port_cfg(partitions=2, replicas=3, slots=2048),
        metadata_election_timeout_s=0.6,
        standby_count=2,
        linearizable_reads=linearizable,
    )
    return InProcCluster(config)


def _partition_away(c, victim: int) -> None:
    """Cut `victim` off from every OTHER BROKER while the test client
    can still reach it — the deposed-but-unaware scenario (set_down
    would also silence the client)."""
    for i, b in c.brokers.items():
        if i != victim:
            c.net.block(c.brokers[victim].addr, b.addr)


def _controller_led_partition(c, ctrl):
    """Pick a partition whose LEADER is the controller broker. The final
    stale read must be served by a broker that is both the deposed
    controller and the partition's leader — reading any other partition
    through the controller draws a correct (and test-breaking)
    `not_leader` refusal. plan_elections' collocation preference applies
    only on log-end ties (manager.py plan_elections), so partition 0's
    leader can legitimately land elsewhere: select by observed leadership
    instead of assuming it (assuming it flaked)."""
    n_parts = next(t for t in c.config.topics if t.name == "t").partitions
    found = []

    def find():
        mgr = c.brokers[ctrl].manager
        for p in range(n_parts):
            if mgr.leader_of(("t", p)) == ctrl:
                found.append(p)
                return True
        return False

    assert wait_until(find), (
        "no partition elected the controller as leader — with empty logs "
        "every election is a tie and the collocation preference should "
        "have placed one here"
    )
    return found[0]


def _stage_stale_controller(c):
    """Partition the controller away, wait for a standby's promotion,
    and land one post-promotion append the old controller cannot know
    about. Returns (old controller id, client, staged partition id)."""
    _wait_standbys(c, 2)
    c.wait_for_leaders()
    ctrl = c.config.controller
    pid = _controller_led_partition(c, ctrl)
    client = c.client()
    for i in range(4):
        _produce(c, client, "t", pid, b"pre-%d" % i)
    # Register the checking consumer while metadata is reachable —
    # name→slot binding is replicated metadata, and the partitioned
    # controller cannot register new names.
    reg = client.call(
        c.brokers[ctrl].addr,
        {"type": "consume", "topic": "t", "partition": pid,
         "consumer": "lin-check", "max_messages": 0},
        timeout=10.0,
    )
    assert reg["ok"], reg
    _partition_away(c, ctrl)
    assert wait_until(
        lambda: _any_survivor(c, {ctrl}).manager.current_controller() != ctrl
    ), "controller never moved"
    new_ctrl = _any_survivor(c, {ctrl}).manager.current_controller()
    assert wait_until(lambda: c.brokers[new_ctrl].dataplane is not None)
    _produce(c, client, "t", pid, b"post-promotion", dead={ctrl})
    # The old controller is still unaware (its fence duty can't learn the
    # new epoch through the partition) and still holds a device program.
    assert c.brokers[ctrl].dataplane is not None
    assert c.brokers[ctrl].manager.current_controller() == ctrl
    return ctrl, client, pid


@pytest.mark.parametrize("linearizable", [False, True])
def test_stale_controller_read(linearizable):
    """Flag OFF: the stale controller serves its old-but-committed
    prefix (the documented reference-parity anomaly — stricter than the
    reference, which has no bound at all). Flag ON: the read barrier
    cannot confirm the epoch through the partition and the read REFUSES
    with a retryable not_committed error instead of serving."""
    with _make_cluster(linearizable) as c:
        ctrl, client, pid = _stage_stale_controller(c)
        resp = client.call(
            c.brokers[ctrl].addr,
            {"type": "consume", "topic": "t", "partition": pid,
             "consumer": "lin-check"},
            timeout=10.0,
        )
        if linearizable:
            assert not resp["ok"], resp
            assert "not_committed" in resp["error"], resp
        else:
            assert resp["ok"], resp
            got = resp["messages"]
            # Old-but-committed data, MISSING the post-promotion append.
            assert b"pre-0" in got
            assert b"post-promotion" not in got


def test_linearizable_reads_serve_normally_when_healthy():
    """The flag must not break the healthy path: produce→consume round
    trips succeed, every message arrives, and repeated reads share
    barriers rather than serializing on them."""
    with _make_cluster(True) as c:
        c.wait_for_leaders()
        _wait_standbys(c, 2)
        client = c.client()
        sent = [b"h-%d" % i for i in range(12)]
        for m in sent:
            _produce(c, client, "t", 0, m)
        leader = _any_survivor(c, ()).manager.leader_of(("t", 0))
        got, offset = [], None
        for _ in range(40):
            resp = client.call(
                c.brokers[leader].addr,
                {"type": "consume", "topic": "t", "partition": 0,
                 "consumer": "healthy"},
                timeout=10.0,
            )
            assert resp["ok"], resp
            if not resp["messages"]:
                break
            got.extend(resp["messages"])
            client.call(
                c.brokers[leader].addr,
                {"type": "offset.commit", "topic": "t", "partition": 0,
                 "consumer": "healthy", "offset": resp["next_offset"]},
                timeout=10.0,
            )
        assert got == sent

"""Consumer groups on a cluster: generation fencing, heartbeat eviction
and consumer-slot recycling through the broker server and the
`GroupConsumer` SDK.

Twin of the cluster half of `tests/test_groups.py` on the PyTorch port
(CPU brokers); the unit half is in `tests/test_torch_groups.py`.
"""

from __future__ import annotations

import time

import pytest

from ripplemq_tpu_torch.groups.coordinator import GroupLiveness, GroupTable
from ripplemq_tpu_torch.groups.state import compute_assignment
from tests.torch_helpers import wait_until
from tests.torch_port_modules import admit

admit(__name__)


# -------------------------------------------------- assignment function


# ----------------------------------------------------------- group table


# --------------------------------------------------- cluster integration


@pytest.fixture(scope="module")
def cluster():
    from ripplemq_tpu_torch.chaos.cluster import InProcCluster, make_cluster_config
    from ripplemq_tpu_torch.metadata.models import Topic

    config = make_cluster_config(
        3, topics=(Topic("t", 4, 3),),
        group_session_timeout_s=0.8,
        # Short empty-group retention so the slot-recycle test's
        # ephemeral groups reap inside the test budget (production
        # default is 60 s — transient total-churn keeps the group).
        group_retention_s=0.4,
    )
    with InProcCluster(config, device="cpu") as c:
        c.wait_for_leaders()
        yield c


def test_join_rebalance_fence_and_eviction(cluster):
    from ripplemq_tpu_torch.client import GroupConsumer, ProducerClient
    from ripplemq_tpu_torch.groups.client import FencedError

    c = cluster
    bootstrap = [b.address for b in c.config.brokers]
    g1 = GroupConsumer(bootstrap, "cg", topics=["t"], member_id="m1",
                       transport=c.client("g1"), heartbeat_s=0.2)
    g2 = GroupConsumer(bootstrap, "cg", topics=["t"], member_id="m2",
                       transport=c.client("g2"), heartbeat_s=0.2)
    try:
        a1 = g1.join()
        g2.join()
        g1.heartbeat(force=True)  # adopt the post-m2 generation
        assert g1.generation == g2.generation
        # Disjoint cover of all 4 partitions, 2 each (balanced).
        union = list(g1.assignment) + list(g2.assignment)
        assert sorted(union) == [("t", p) for p in range(4)]
        assert len(g1.assignment) == len(g2.assignment) == 2
        del a1

        # The group consumes through SHARED offsets: a message lands
        # with whoever owns its partition, exactly once.
        p = ProducerClient(bootstrap, transport=c.client("gp"))
        for pid in range(4):
            p.produce("t", f"msg-{pid}".encode(), partition=pid)
        got = []
        deadline = time.time() + 20
        while len(got) < 4 and time.time() < deadline:
            for g in (g1, g2):
                _, msgs = g.poll()
                got.extend(msgs)
        assert sorted(got) == [f"msg-{pid}".encode() for pid in range(4)]
        p.close()

        # Stale-generation commit: typed refusal, never an overwrite.
        topic, pid = g1.assignment[0]
        with pytest.raises(FencedError):
            g1.commit(topic, pid, 0, generation=g1.generation - 1)

        # Heartbeat eviction: m2 goes silent past the session timeout;
        # the coordinator evicts it and m1 absorbs all partitions.
        gen_before = g1.generation
        def m1_owns_everything():
            g1.heartbeat(force=True)
            return len(g1.assignment) == 4
        assert wait_until(m1_owns_everything, timeout=20)
        assert g1.generation > gen_before
        # The evicted member's next heartbeat rejoins transparently.
        g2.heartbeat(force=True)
        assert g2.generation >= g1.generation
        assert wait_until(
            lambda: (g1.heartbeat(force=True) or True)
            and len(g1.assignment) == 2 and len(g2.assignment) == 2,
            timeout=20,
        )
    finally:
        g1.close()
        g2.close()


def test_group_dissolution_recycles_consumer_slot(cluster):
    """Slot-recycle satellite: groups come and go without exhausting
    the fixed [P, C] consumer table — the dissolved group's shared slot
    is released, reset (offset rows zeroed through real rounds), and
    reallocated; and the exhaustion refusal still fires when the table
    truly fills. Failing-before: `_apply_register_consumer` bound slots
    permanently, so C distinct group lifetimes bricked the table."""
    from ripplemq_tpu_torch.client import GroupConsumer, ProducerClient
    from ripplemq_tpu_torch.groups.state import group_consumer_name

    c = cluster
    bootstrap = [b.address for b in c.config.brokers]
    C = c.config.engine.max_consumers
    p = ProducerClient(bootstrap, transport=c.client("slotp"))
    p.produce("t", b"slot-test", partition=0)

    # Churn MORE groups through the table than it has slots. Each group
    # joins, consumes (committing a nonzero offset into its slot), and
    # dissolves; the recycle duty must keep up.
    ctrl = next(b for b in c.brokers.values() if b.is_controller)
    for i in range(C + 2):
        g = GroupConsumer(bootstrap, f"ephemeral-{i}", topics=["t"],
                          member_id="m", transport=c.client(f"eg{i}"),
                          heartbeat_s=0.2)
        g.join()
        # Drive one committed offset so the slot is genuinely dirty.
        deadline = time.time() + 15
        while time.time() < deadline:
            key, msgs = g.poll()
            if msgs:
                break
        g.close()  # leave → empty → retention reap → release
        # Wait for the slot to recycle (reaped, released AND reset)
        # before the next group needs one — the table holds C slots.
        name = group_consumer_name(f"ephemeral-{i}")
        assert wait_until(
            lambda: name not in ctrl.manager.consumers
            and not ctrl.manager.dirty_slots(),
            timeout=30,
        ), (ctrl.manager.consumers, ctrl.manager.dirty_slots())

    # A fresh group still registers fine (the table recycled), and its
    # reset slot serves offset 0 — NOT the previous tenant's position.
    g = GroupConsumer(bootstrap, "fresh", topics=["t"], member_id="m",
                      transport=c.client("fresh"), heartbeat_s=0.2)
    g.join()
    deadline = time.time() + 15
    seen = []
    while time.time() < deadline and b"slot-test" not in seen:
        key, msgs = g.poll()
        seen.extend(msgs)
    assert b"slot-test" in seen, (
        "fresh group did not restart at offset 0 — recycled slot "
        "leaked the previous tenant's committed position"
    )
    g.close()
    p.close()

    # Exhaustion refusal intact: fill the table with PERSISTENT plain
    # consumers and watch the typed refusal (not a timeout).
    cl = c.client("filler")
    used = len(ctrl.manager.consumers)
    refused = None
    for i in range(C - used + 1):
        resp = cl.call(
            c.leader_broker("t", 0).addr,
            {"type": "offset.commit", "topic": "t", "partition": 0,
             "consumer": f"filler-{i}", "offset": 0},
            timeout=10.0,
        )
        if not resp.get("ok"):
            refused = resp
            break
    assert refused is not None
    assert refused["error"].startswith("consumer_table_full"), refused

"""Failure handling: broker death → membership change → reassignment →
re-election → service resumes (the reference's §3.5 recovery flow, here
exercised deterministically in-process — the reference needed a live
docker-compose cluster to even observe this).

Architecture note (single-controller mode): a broker process death costs
its serving endpoints, its metadata-Raft vote and its partition
leaderships — NOT the device-side replica data, which lives in the always
-running SPMD program. The membership machinery (liveness → sticky
reassignment → election → advertisement) is identical to the reference's;
what differs is that "replica healing" needs no data copy unless a device
shard was actually lost (then: resync path).

Twin of `tests/test_failover.py` on the PyTorch port (CPU brokers).
"""

import time

import pytest

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.torch_helpers import wait_until
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture()
def cluster5():
    config = make_config(
        n_brokers=5,
        topics=(Topic("t", 3, 3),),
        metadata_election_timeout_s=0.6,
        membership_poll_s=0.2,
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        yield c


def test_broker_death_heals_assignment_and_leadership(cluster5):
    c = cluster5
    controller_id = c.config.controller
    # Pick a victim that leads at least one partition and is not controller.
    any_b = next(iter(c.brokers.values()))
    leaders = {
        a.partition_id: a.leader
        for t in any_b.manager.get_topics()
        for a in t.assignments
    }
    victim = next(
        b for b in leaders.values() if b is not None and b != controller_id
    )
    led = [pid for pid, b in leaders.items() if b == victim]
    assert led, "victim should lead something"

    # Kill it: unreachable on the network AND stopped.
    c.net.set_down(c.brokers[victim].addr)
    c.brokers[victim].stop()

    survivors = [b for i, b in c.brokers.items() if i != victim]

    def healed():
        for b in survivors:
            topics = b.manager.get_topics()
            for t in topics:
                for a in t.assignments:
                    if victim in a.replicas or a.leader in (None, victim):
                        return False
        return True

    assert wait_until(healed, timeout=60), {
        i: [
            (a.partition_id, a.replicas, a.leader)
            for t in b.manager.get_topics()
            for a in t.assignments
        ]
        for i, b in c.brokers.items()
        if i != victim
    }

    # Every partition accepts produces at its new leader.
    client = c.client()
    for pid in range(3):
        leader_id = survivors[0].manager.leader_of(("t", pid))
        resp = client.call(
            c.brokers[leader_id].addr,
            {"type": "produce", "topic": "t", "partition": pid,
             "messages": [b"post-failover"]},
            timeout=10.0,
        )
        assert resp["ok"], (pid, resp)

    # Sticky: surviving replicas were retained (only the dead one replaced).
    for b in survivors:
        for t in b.manager.get_topics():
            for a in t.assignments:
                assert len(a.replicas) == 3
                assert victim not in a.replicas


def test_metadata_leader_death_reelects_and_heals(cluster5):
    """Kill the metadata leader WHOEVER it is — including when it is also
    the data-plane controller (round 2 skipped that double-role death;
    controller failover now makes it survivable, so the test confronts
    it: the stream standbys elect a new controller under a bumped epoch
    while the metadata group re-elects)."""
    c = cluster5
    meta_leader = next(
        i for i, b in c.brokers.items()
        if b.runner.node.role == "leader"
    )
    double_role = (
        meta_leader
        == next(iter(c.brokers.values())).manager.current_controller()
    )
    if double_role:
        # Controller promotion needs the standby set to be caught up.
        assert wait_until(
            lambda: len(next(b for i, b in c.brokers.items()
                             if i != meta_leader)
                        .manager.current_standbys()) >= 1,
            timeout=60,
        ), "standby set never formed before double-role kill"
    c.net.set_down(c.brokers[meta_leader].addr)
    c.brokers[meta_leader].stop()

    survivors = [b for i, b in c.brokers.items() if i != meta_leader]
    assert wait_until(
        lambda: sum(1 for b in survivors if b.runner.node.role == "leader") == 1,
        timeout=60,
    )
    if double_role:
        # The data plane moved too: a live standby was promoted.
        assert wait_until(
            lambda: survivors[0].manager.current_controller() != meta_leader,
            timeout=60,
        ), "controller never moved off the dead double-role broker"
        new_ctrl = survivors[0].manager.current_controller()
        assert wait_until(
            lambda: c.brokers[new_ctrl].dataplane is not None, timeout=60
        ), "promoted controller never booted a data plane"
    # New metadata leader resumes assignment duty: victim leaves replica sets.
    def victim_gone():
        return all(
            meta_leader not in a.replicas and a.leader not in (None, meta_leader)
            for b in survivors
            for t in b.manager.get_topics()
            for a in t.assignments
        )

    assert wait_until(victim_gone, timeout=60)
    client = c.client()
    leader_id = survivors[0].manager.leader_of(("t", 0))
    resp = client.call(
        c.brokers[leader_id].addr,
        {"type": "produce", "topic": "t", "partition": 0,
         "messages": [b"still alive"]},
        timeout=10.0,
    )
    assert resp["ok"], resp


def test_rf_equals_cluster_size_death_still_reelects(tmp_path):
    """RF == broker count: a broker death makes the placement
    UN-replannable (assign_partitions cannot meet RF with the
    survivors), but the LIVE view must still advance — elections key on
    it, and freezing it left the dead broker's partitions leaderless
    forever (found by the r5 lockstep boot drill; the reference's
    per-partition JRaft groups re-elect independently of placement,
    PartitionRaftServer.java:83-93). Killing the CONTROLLER (which the
    election tie-break makes leader of every partition at RF == N): the
    standby promotion never depended on the live view, but the dead
    broker's partitions re-elect only if it advances — the surviving
    2-of-3 quorum must end up serving every partition."""
    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 2, 3),),
        metadata_election_timeout_s=0.6,
        membership_poll_s=0.2,
        standby_count=2,
    )
    with InProcCluster(config, data_dir=tmp_path) as c:
        c.wait_for_leaders()
        client = c.client()
        ctrl = c.config.controller
        assert wait_until(
            lambda: len(c.brokers[ctrl].manager.current_standbys()) >= 2,
            timeout=60,
        ), "standbys never formed"
        c.kill(ctrl)
        survivor = next(b for i, b in c.brokers.items() if i != ctrl)
        # The live view advances even though placement cannot be
        # re-planned with 2 brokers for RF 3...
        assert wait_until(
            lambda: sorted(survivor.manager.live)
            == sorted(i for i in c.brokers if i != ctrl),
            timeout=30,
        ), f"live view never advanced: {survivor.manager.live}"
        # ...placement itself is untouched (nothing to re-plan to)...
        for t in survivor.manager.get_topics():
            for a in t.assignments:
                assert ctrl in a.replicas
        # ...and every partition re-elects among the surviving quorum,
        # then serves a produce through the promoted controller's plane.
        for pid in range(2):
            assert wait_until(
                lambda: survivor.manager.leader_of(("t", pid))
                not in (None, ctrl),
                timeout=60,
            ), f"partition {pid} never re-elected"
            # Re-elected leadership can be advertised a beat before the
            # promoted plane's control tables settle: poll retryable
            # refusals (not_committed / not_leader) like a real client's
            # RetryPolicy; nothing partially commits, so retries stay
            # duplicate-free.
            deadline = time.time() + 60
            while True:
                leader = survivor.manager.leader_of(("t", pid))
                resp = client.call(
                    c.brokers[leader].addr,
                    {"type": "produce", "topic": "t", "partition": pid,
                     "messages": [b"rf-n-%d" % pid]},
                    timeout=30.0,
                )
                if resp.get("ok") or time.time() > deadline:
                    break
                assert ("not_committed" in resp.get("error", "")
                        or "not_leader" in resp.get("error", "")), resp
                assert resp.get("committed", 0) == 0, resp
                time.sleep(0.1)
            assert resp["ok"], resp

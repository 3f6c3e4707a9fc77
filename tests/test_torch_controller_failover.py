"""Controller failover: the data plane survives the death of the broker
driving the device program (VERDICT r2's top gap — the reference
tolerates the loss of ANY broker via per-broker JRaft groups,
PartitionRaftServer.java:83-93; here the committed-round stream is
replicated to a metadata-recorded standby set and any member can be
promoted, broker/replication.py).

Twin of `tests/test_controller_failover.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import threading
import time

import pytest

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.torch_helpers import port_cfg, wait_until
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture()
def cluster4():
    config = make_config(
        n_brokers=4,
        topics=(Topic("t", 2, 3),),
        # Deep log: single-message produces each burn an ALIGN-padded
        # round, and the live-traffic test produces through the whole
        # failover window.
        engine=port_cfg(partitions=2, replicas=3, slots=2048),
        metadata_election_timeout_s=0.6,
        standby_count=2,
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        yield c


def _any_survivor(c, dead):
    return next(b for i, b in c.brokers.items() if i not in dead)


def _wait_standbys(c, n, dead=()):
    assert wait_until(
        lambda: len(_any_survivor(c, dead).manager.current_standbys()) >= n,
        timeout=60,
    ), "standby set never reached target"


def _produce(c, client, topic, pid, payload, dead=(), timeout=60.0):
    """Produce with retries through any surviving broker's leader view
    (the client-SDK retry loop, inlined for determinism)."""
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        b = _any_survivor(c, dead)
        leader = b.manager.leader_of((topic, pid))
        if leader is None or leader in dead:
            time.sleep(0.05)
            continue
        try:
            resp = client.call(
                c.brokers[leader].addr,
                {"type": "produce", "topic": topic, "partition": pid,
                 "messages": [payload]},
                timeout=5.0,
            )
        except Exception as e:
            last = e
            time.sleep(0.05)
            continue
        if resp.get("ok"):
            return True
        last = resp
        time.sleep(0.05)
    raise AssertionError(f"produce never succeeded: {last}")


def _consume_all(c, client, topic, pid, consumer, dead=(), quiet_polls=3):
    """Drain one partition via a fresh consumer until it stays empty."""
    got = []
    quiet = 0
    deadline = time.time() + 60
    while quiet < quiet_polls and time.time() < deadline:
        b = _any_survivor(c, dead)
        leader = b.manager.leader_of((topic, pid))
        if leader is None or leader in dead:
            time.sleep(0.05)
            continue
        try:
            resp = client.call(
                c.brokers[leader].addr,
                {"type": "consume", "topic": topic, "partition": pid,
                 "consumer": consumer},
                timeout=5.0,
            )
        except Exception:
            time.sleep(0.05)
            continue
        if not resp.get("ok"):
            time.sleep(0.05)
            continue
        msgs = resp["messages"]
        got.extend(msgs)
        if msgs:
            quiet = 0
            client.call(
                c.brokers[leader].addr,
                {"type": "offset.commit", "topic": topic, "partition": pid,
                 "consumer": consumer, "offset": resp["next_offset"]},
                timeout=5.0,
            )
        else:
            quiet += 1
            time.sleep(0.05)
    return got


def test_standby_set_establishes_and_replicates(cluster4):
    """The controller admits standby_count members via catch-up, and each
    member's round store receives the committed stream."""
    c = cluster4
    _wait_standbys(c, 2)
    ctrl = c.config.controller
    b = _any_survivor(c, ())
    standbys = b.manager.current_standbys()
    assert ctrl not in standbys and len(standbys) == 2
    client = c.client()
    for i in range(8):
        _produce(c, client, "t", i % 2, b"est-%d" % i)
    # Every settled append exists on every standby's store (the zero-loss
    # invariant: settle-after-ack).
    for s in standbys:
        recs = list(c.brokers[s]._round_store.scan())
        assert recs, f"standby {s} store empty"


def test_controller_death_promotes_standby_zero_loss(cluster4):
    """Kill the controller mid-traffic: a standby is promoted, produce and
    consume resume, and every acked message survives."""
    c = cluster4
    _wait_standbys(c, 2)
    ctrl = c.config.controller
    client = c.client()

    acked: list[bytes] = []
    stop_traffic = threading.Event()
    dead: set[int] = set()

    def traffic():
        i = 0
        while not stop_traffic.is_set():
            payload = b"live-%d" % i
            try:
                _produce(c, client, "t", i % 2, payload, dead=dead,
                         timeout=30.0)
                acked.append(payload)
            except AssertionError:
                pass
            i += 1
            time.sleep(0.02)  # bound slot consumption (one round/message)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    # Let some pre-failover traffic settle.
    assert wait_until(lambda: len(acked) >= 10, timeout=30)

    # Kill the controller mid-traffic.
    c.net.set_down(c.brokers[ctrl].addr)
    dead.add(ctrl)
    c.brokers[ctrl].stop()

    # A standby is promoted under a bumped epoch...
    assert wait_until(
        lambda: _any_survivor(c, dead).manager.current_controller() != ctrl,
        timeout=60,
    ), "controller never moved"
    new_ctrl = _any_survivor(c, dead).manager.current_controller()
    assert new_ctrl != ctrl
    assert _any_survivor(c, dead).manager.current_epoch() >= 1
    # ...boots the device program from its stream copy...
    assert wait_until(lambda: c.brokers[new_ctrl].dataplane is not None,
                      timeout=60), (
        "promoted standby never booted a dataplane"
    )
    # ...and traffic keeps flowing (produce success after the handover).
    n_after = len(acked) + 5
    assert wait_until(lambda: len(acked) >= n_after, timeout=60), (
        "produce never resumed after failover"
    )
    stop_traffic.set()
    t.join(timeout=30)

    # Zero committed-entry loss: every acked message is consumable.
    got: list[bytes] = []
    for pid in range(2):
        got.extend(_consume_all(c, client, "t", pid, "loss-check", dead=dead))
    missing = set(acked) - set(got)
    assert not missing, f"{len(missing)} acked messages lost: {sorted(missing)[:5]}"


def test_deposed_controller_fences(cluster4):
    """A controller that was partitioned away (not stopped) releases the
    device program once it learns of the newer epoch, and routes engine
    traffic to the new controller."""
    c = cluster4
    _wait_standbys(c, 2)
    ctrl = c.config.controller
    client = c.client()
    for i in range(4):
        _produce(c, client, "t", i % 2, b"pre-%d" % i)

    # Partition the controller away (still running).
    c.net.set_down(c.brokers[ctrl].addr)
    assert wait_until(
        lambda: _any_survivor(c, {ctrl}).manager.current_controller() != ctrl,
        timeout=60,
    ), "controller never moved"
    new_ctrl = _any_survivor(c, {ctrl}).manager.current_controller()
    assert wait_until(lambda: c.brokers[new_ctrl].dataplane is not None,
                      timeout=60)
    _produce(c, client, "t", 0, b"post-promotion", dead={ctrl})

    # Heal the partition: the old controller learns the newer epoch and
    # fences (releases its device program).
    c.net.set_up(c.brokers[ctrl].addr)
    assert wait_until(lambda: c.brokers[ctrl].dataplane is None, timeout=60), (
        "deposed controller never fenced"
    )
    assert not c.brokers[ctrl].is_controller
    # Its engine endpoint now redirects instead of serving stale state.
    resp = client.call(c.brokers[ctrl].addr,
                       {"type": "engine.read_offset", "slot": 0, "cslot": 0},
                       timeout=5.0)
    assert not resp["ok"] and resp["error"] == "not_controller"
    assert resp["controller_addr"] == c.brokers[new_ctrl].addr

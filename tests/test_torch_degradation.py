"""Graceful degradation on the port: twins of `tests/test_degradation.py`.

- A pre-broadcast lockstep send failure must NOT condemn the plane:
  `_seq` is restored and the next call succeeds on the SAME controller;
  a partial dispatch (one worker got the call, the next did not) does
  condemn it (`parallel/lockstep.py`, the port's `LockstepController`).
- Consume/offset-commit during lost quorum fast-fail with a typed,
  retryable `unavailable` refusal instead of hanging into the RPC
  timeout, and `admin.stats` advertises the `degraded` state (the
  port's cluster on the CPU).
"""

from __future__ import annotations

from concurrent.futures import Future

import pytest

from ripplemq_tpu_torch.metadata.models import Topic
from ripplemq_tpu_torch.parallel.lockstep import (
    LockstepController,
    LockstepSendError,
)
from tests.torch_helpers import InProcCluster, make_config, port_cfg
from tests.torch_port_modules import admit

admit(__name__)


# --------------------------------------------------------------- lockstep

class _Inner:
    mesh = None

    def __init__(self) -> None:
        self.init_calls = 0

    def init(self):
        self.init_calls += 1
        return f"state{self.init_calls}"


class _FlakyClient:
    """call_async that raises on chosen call indexes (1-based) and
    otherwise acks instantly."""

    def __init__(self, fail_on=()) -> None:
        self.fail_on = set(fail_on)
        self.calls = 0

    def call_async(self, addr, req) -> Future:
        self.calls += 1
        if self.calls in self.fail_on:
            raise OSError("connection reset by peer")
        fut: Future = Future()
        fut.set_result({"ok": True})
        return fut


def test_pre_broadcast_send_failure_is_transient():
    """Transient call_async failure BEFORE any dispatch (and before any
    local launch): seq restored, broken stays None, the next call on
    the same plane succeeds."""
    inner = _Inner()
    # configure = calls 1-2; the first init broadcast = call 3 (worker
    # w1, nothing dispatched yet) → transient.
    client = _FlakyClient(fail_on={3})
    ctrl = LockstepController(inner, port_cfg(), 1, ["w1", "w2"], client)
    seq_before = ctrl._seq
    with pytest.raises(LockstepSendError) as ei:
        ctrl.init()
    assert getattr(ei.value, "retryable", False)
    assert ctrl.broken is None, "pre-broadcast failure condemned the plane"
    assert ctrl._seq == seq_before, "sequence not restored"
    assert inner.init_calls == 0, "local launch ran despite failed send"
    # Same plane, next call: succeeds.
    assert ctrl.init() == "state1"
    assert ctrl.broken is None


def test_partial_dispatch_failure_still_breaks_the_plane():
    """If worker 1 received the seq and worker 2's send failed, the
    stream is non-replayable: the plane MUST be condemned (restoring
    seq here would desynchronize worker 1)."""
    inner = _Inner()
    client = _FlakyClient(fail_on={4})  # second worker of the init call
    ctrl = LockstepController(inner, port_cfg(), 1, ["w1", "w2"], client)
    with pytest.raises(OSError):
        ctrl.init()
    assert ctrl.broken is not None


# ------------------------------------------------- unavailable + degraded

@pytest.fixture(scope="module")
def cluster3():
    # RF == broker count: the election tie-break makes the controller
    # the leader of every partition, so the controller broker serves
    # consume directly against its local engine.
    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 2, 3),),
        engine=port_cfg(partitions=2, replicas=3),
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        yield c


def _controller(cluster):
    ctrl = next(iter(cluster.brokers.values())).manager.current_controller()
    return cluster.brokers[ctrl]


def test_consume_fast_fails_unavailable_when_quorum_lost(cluster3):
    c = cluster3
    broker = c.leader_broker("t", 0)
    dp = broker.dataplane
    assert dp is not None, "expected the controller to lead at RF == N"
    client = c.client("degraded-test")
    # Healthy: consume serves (empty is fine; no error).
    resp = client.call(broker.addr, {
        "type": "consume", "topic": "t", "partition": 0,
        "consumer": "deg-consumer", "max_messages": 4}, timeout=10.0)
    assert resp["ok"], resp
    alive_before = dp.alive.copy()
    try:
        # Quorum loss: every replica of partition 0 masked dead.
        masked = alive_before.copy()
        masked[0, :] = False
        dp.set_alive(masked)
        assert dp.quorum_lost(0)
        assert dp.degraded_slots() == [0]
        resp = client.call(broker.addr, {
            "type": "consume", "topic": "t", "partition": 0,
            "consumer": "deg-consumer", "max_messages": 4}, timeout=10.0)
        assert not resp["ok"]
        assert resp["error"].startswith("unavailable:"), resp
        # Offset commits ride the same doomed quorum rounds: same refusal.
        resp = client.call(broker.addr, {
            "type": "offset.commit", "topic": "t", "partition": 0,
            "consumer": "deg-consumer", "offset": 0}, timeout=10.0)
        assert not resp["ok"]
        assert resp["error"].startswith("unavailable:"), resp
        # admin.stats advertises the degradation.
        stats = client.call(broker.addr, {"type": "admin.stats"},
                            timeout=10.0)
        assert stats["ok"]
        assert stats["engine"]["degraded"] is True
        assert stats["engine"]["degraded_slots"] == [0]
        # The OTHER partition still serves.
        resp = client.call(broker.addr, {
            "type": "consume", "topic": "t", "partition": 1,
            "consumer": "deg-consumer", "max_messages": 4}, timeout=10.0)
        assert resp["ok"], resp
    finally:
        dp.set_alive(alive_before)
    # Healed: not degraded, serves again.
    stats = client.call(broker.addr, {"type": "admin.stats"}, timeout=10.0)
    assert stats["engine"]["degraded"] is False
    resp = client.call(broker.addr, {
        "type": "consume", "topic": "t", "partition": 0,
        "consumer": "deg-consumer", "max_messages": 4}, timeout=10.0)
    assert resp["ok"], resp


def test_mirror_gap_locked_accessor(cluster3):
    """admin.stats reads the mirror-gap count through the locked
    accessor (advisor round-5: the bare `len(dp._mirror_gap)` raced the
    resolver's heal-time mutation)."""
    dp = _controller(cluster3).dataplane
    assert dp.mirror_gap_slots() == 0
    with dp._lock:
        dp._mirror_gap[1] = [10, 12]
    try:
        assert dp.mirror_gap_slots() == 1
        client = cluster3.client("gap-test")
        stats = client.call(_controller(cluster3).addr,
                            {"type": "admin.stats"}, timeout=10.0)
        assert stats["engine"]["mirror_gap_slots"] == 1
    finally:
        with dp._lock:
            dp._mirror_gap.clear()


def test_unavailable_passes_through_remote_leader(tmp_path):
    """A partition whose LEADER is not the controller must surface the
    same typed `unavailable:` refusal: the leader forwards the commit to
    the controller's engine.offsets, and the controller's refusal passes
    through VERBATIM instead of being wrapped as `internal:`."""
    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 3, 1),),  # RF 1: leaders spread off-controller
        engine=port_cfg(partitions=3, replicas=1),
        standby_count=0,
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        ctrl = _controller(c)
        dp = ctrl.dataplane
        # Find a partition led by a NON-controller broker.
        pid, leader = next(
            (p, c.brokers[ctrl.manager.leader_of(("t", p))])
            for p in range(3)
            if ctrl.manager.leader_of(("t", p)) != ctrl.broker_id
        )
        slot = ctrl.manager.slot_of(("t", pid))
        client = c.client("remote-degraded")
        # Register the consumer while healthy.
        resp = client.call(leader.addr, {
            "type": "consume", "topic": "t", "partition": pid,
            "consumer": "rd", "max_messages": 2}, timeout=10.0)
        assert resp["ok"], resp
        alive_before = dp.alive.copy()
        try:
            masked = alive_before.copy()
            masked[slot, :] = False
            dp.set_alive(masked)
            resp = client.call(leader.addr, {
                "type": "offset.commit", "topic": "t", "partition": pid,
                "consumer": "rd", "offset": 0}, timeout=10.0)
            assert not resp["ok"]
            assert resp["error"].startswith("unavailable:"), resp
        finally:
            dp.set_alive(alive_before)


def test_unavailable_is_retryable_for_clients():
    from ripplemq_tpu_torch.wire.retry import fatal_response_error

    assert not fatal_response_error("unavailable: partition slot 0 lost "
                                    "its replica quorum")

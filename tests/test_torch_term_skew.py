"""Device-term-skew wedge: detection + self-healing re-election.

Found by the chaos plane (seed 7 of the tier-1 smoke, ~25% under
host contention): `dp.elect()` bumps the device replicas' current_term,
but the OP_SET_LEADER advert that would catch the control table up is a
separate metadata proposal — lost mid-chaos (retries=1), or reverted by
a stale OP_SET_TOPICS snapshot racing the apply. Every subsequent round
then dispatches with a stale term and is refused by the engine forever,
while the metadata plane sees a live, healthy leader and never
re-elects: a permanent, silent, write-only outage (reads stay fine).
Postmortem signature: ctrl_table_term=[5,5], device_current_terms=[8,8],
log_ends all zero, thousands of dispatched rounds, zero commits.

The fix has three independent layers, each tested here:
- `DataPlane.stalled_slots()`: consecutive device-uncommitted rounds per
  slot, the host-only wedge probe feeding `needs_elections`.
- `plan_elections` heals a stalled slot whose device term ran ahead of
  the advertised term even though its leader is alive — by re-ADVERTISING
  the same leader at the device's granted term, with NO new vote (a
  re-vote would bump the device again and, under load, race its own
  advert forever; appends ack at `inp.term >= current_term`, so a
  matching table term is all commit needs).
- Term-monotonic applies: a lower-term OP_SET_LEADER is skipped, and a
  stale OP_SET_TOPICS snapshot keeps the newer (leader, term).

Twin of `tests/test_term_skew.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from ripplemq_tpu_torch.broker.dataplane import DataPlane, NotCommittedError
from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.torch_helpers import port_cfg, wait_until
from tests.torch_port_modules import admit

admit(__name__)


# ------------------------------------------------------- dataplane probe


def _local_dp(**kw):
    dp = DataPlane(port_cfg(partitions=1, replicas=3), mode="local", device="cpu",
                   coalesce_s=0.0, **kw)
    dp.start()
    dp.set_leader(0, 0, 1)
    return dp


def test_plan_elections_consumes_term_aligned_stall(cluster3):
    """A stalled slot whose device term is NOT ahead of the table (an
    engine-quorum outage, not a skew) must have its streak CONSUMED by
    the plan_elections probe: traffic stopping right after the outage
    would otherwise freeze the streak at-threshold and every later duty
    tick re-pays the device fetch at the election timeout, forever, on a
    healthy idle cluster — and admin.stats keeps reporting the slot
    stalled."""
    c = cluster3
    ctrl = _controller(c)
    dp = ctrl.dataplane
    assert dp is not None
    slot = 0
    with dp._lock:
        dp._nocommit_streak[slot] = 2 * dp.max_retry_rounds
    assert dp.stalled_slots() == [slot]
    # Term-aligned (no election has run under the table's back): the
    # probe must not nominate OR draft, and must decay the streak.
    cands, drafts = ctrl.manager.plan_elections()
    assert slot not in cands and slot not in drafts
    assert dp.stalled_slots() == []
    # The probe's debounce stamp survives the decay: a streak that
    # re-builds faster than the election window stays gated (the
    # needs_elections healthy branch only clears STALE stamps), so the
    # duty re-pays the device fetch at most once per window — then its
    # next spaced probe consumes the rebuilt streak the same way.
    with dp._lock:
        dp._nocommit_streak[slot] = 2 * dp.max_retry_rounds
    assert not ctrl.manager.needs_elections()
    assert wait_until(lambda: dp.stalled_slots() == [], timeout=10)


# -------------------------------------------------- term-monotonic applies


@pytest.fixture()
def cluster3():
    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 1, 3),),
        engine=port_cfg(partitions=1, replicas=3, slots=256),
        election_timeout_s=0.3,
        metadata_election_timeout_s=0.6,
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        yield c


def _controller(c):
    ctrl = next(iter(c.brokers.values())).manager.current_controller()
    return c.brokers[ctrl]


def test_stale_set_leader_apply_is_skipped(cluster3):
    c = cluster3
    mgr = _controller(c).manager
    a = mgr.assignment_of(("t", 0))
    mgr._apply_set_leader("t", 0, a.leader, a.term + 2)
    mgr._apply_set_leader("t", 0, None, a.term + 1)  # stale: lower term
    after = mgr.assignment_of(("t", 0))
    assert after.term == a.term + 2
    assert after.leader == a.leader


def test_stale_set_topics_snapshot_keeps_newer_term(cluster3):
    c = cluster3
    mgr = _controller(c).manager
    a = mgr.assignment_of(("t", 0))
    # Snapshot of the current surface, then an election advances the
    # term; applying the stale snapshot must not regress it.
    stale = [
        t.with_assignments(tuple(
            dataclasses.replace(x, term=a.term) for x in t.assignments
        ))
        for t in mgr.topics
    ]
    mgr._apply_set_leader("t", 0, a.leader, a.term + 3)
    mgr._apply_set_topics(stale, list(mgr.live))
    after = mgr.assignment_of(("t", 0))
    assert after.term == a.term + 3
    assert after.leader == a.leader


# ------------------------------------------------------- e2e self-healing


def test_device_term_skew_self_heals(cluster3):
    """The directed wedge reproduction: bump the device current_term past
    the advertised term with the leader ALIVE (exactly what a lost
    OP_SET_LEADER advert leaves behind). Pre-fix this partition never
    accepts another produce — the metadata plane sees a healthy leader
    and never re-elects. Post-fix the stalled-slot probe triggers a
    debounced re-election and the produce path heals within seconds."""
    c = cluster3
    client = c.net.client("skew-test")
    ctrl = _controller(c)
    dp = ctrl.dataplane
    assert dp is not None

    def produce(payload, timeout):
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            leader = ctrl.manager.leader_of(("t", 0))
            if leader is None:
                time.sleep(0.05)
                continue
            try:
                resp = client.call(
                    c.brokers[leader].addr,
                    {"type": "produce", "topic": "t", "partition": 0,
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

    assert produce(b"before", timeout=30)
    a = ctrl.manager.assignment_of(("t", 0))
    leader_slot = int(dp.leader[0])
    assert leader_slot >= 0
    # Fabricate the skew: a device election whose advert never lands.
    skew_term = a.term + 3
    won = dp.elect({0: (leader_slot, skew_term)})
    assert won[0], "the current leader must win its own re-vote"
    assert int(dp.current_terms()[0]) == skew_term
    assert ctrl.manager.assignment_of(("t", 0)).term == a.term  # advert lost

    # The wedge heals: the streak trips needs_elections, plan_elections
    # confirms device_term > advertised term and re-ADVERTISES the live
    # leader at the device's term — no new vote, so the device term
    # never moves and a slow advert cannot race itself (the runaway the
    # first fix attempt showed: re-voting bumped the device faster than
    # adverts landed). Generous deadline — 2 failed submits build the
    # streak, then one debounce window (0.3 s) gates the re-advert.
    assert produce(b"after", timeout=60)
    healed = ctrl.manager.assignment_of(("t", 0))
    assert healed.term == skew_term
    assert healed.leader == a.leader
    assert int(dp.term[0]) == skew_term
    assert int(dp.current_terms()[0]) == skew_term  # device never re-bumped
    # The probe drains once rounds commit again.
    assert wait_until(lambda: dp.stalled_slots(threshold=1) == [],
                      timeout=60)

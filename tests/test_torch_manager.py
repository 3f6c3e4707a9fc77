"""The `PartitionManager` of the port: the twin of `tests/test_op_split.py`
(`OP_SET_TOPICS` owns placement, `OP_SET_LEADER` the leader surface),
plus `test_dataplane.py::test_consumer_slot_collision_resolved_in_apply`
and `::test_plan_repairs_catches_slot_revived_while_leaderless` on a
port `DataPlane(device="cpu")`.
"""

from __future__ import annotations

import dataclasses

import pytest

from ripplemq_tpu_torch.broker.manager import OP_SET_TOPICS, PartitionManager
from ripplemq_tpu_torch.metadata.models import (
    PartitionAssignment,
    Topic,
    placement_only,
    topics_from_wire,
    topics_to_wire,
)
from tests.torch_helpers import make_config, port_dp, read_all
from tests.torch_port_modules import admit

admit(__name__)


def _mgr() -> PartitionManager:
    # No dataplane: the op-split contract is pure metadata state.
    return PartitionManager(0, make_config(3), dataplane=None)


def _seed_topics(m: PartitionManager, leader: int = 0, term: int = 3) -> None:
    """Install placement, then advertise leaders the owned way."""
    m.apply(1, {
        "op": OP_SET_TOPICS,
        "topics": topics_to_wire([
            t.with_assignments(tuple(
                PartitionAssignment(pid, (0, 1, 2), None, 0)
                for pid in range(t.partitions)
            ))
            for t in m.config.topics
        ]),
        "live": [0, 1, 2],
    })
    idx = 2
    for t in m.config.topics:
        for pid in range(t.partitions):
            m.apply(idx, {"op": "set_leader", "topic": t.name,
                          "partition": pid, "leader": leader, "term": term})
            idx += 1


def test_plan_assignment_payload_carries_no_leader_surface():
    """Every OP_SET_TOPICS proposal — first boot AND membership change —
    must be placement-only: no assignment may carry a leader or a
    nonzero term."""
    m = _mgr()
    cmd = m.plan_assignment([0, 1, 2])  # first boot
    assert cmd is not None and cmd["op"] == OP_SET_TOPICS
    for t in topics_from_wire(cmd["topics"]):
        for a in t.assignments:
            assert a.leader is None and a.term == 0
    m.apply(1, cmd)
    _seed_topics(m)
    cmd = m.plan_assignment([0, 1])  # membership change after elections
    assert cmd is not None
    for t in topics_from_wire(cmd["topics"]):
        for a in t.assignments:
            assert a.leader is None and a.term == 0


def test_apply_ignores_any_payload_leader_surface():
    """A topics payload that DOES carry a leader/term surface (a buggy
    or pre-split proposer) must not install it — not even a HIGHER term:
    the surface is sourced from the current table, unconditionally."""
    m = _mgr()
    m.apply(1, m.plan_assignment([0, 1, 2]))
    _seed_topics(m, leader=0, term=3)
    hostile = [
        t.with_assignments(tuple(
            dataclasses.replace(a, leader=2, term=99) for a in t.assignments
        ))
        for t in m.get_topics()
    ]
    m.apply(99, {"op": OP_SET_TOPICS, "topics": topics_to_wire(hostile),
                 "live": [0, 1, 2]})
    a = m.assignment_of(("topic1", 0))
    assert a.leader == 0 and a.term == 3


def test_stale_placement_snapshot_cannot_revert_election():
    """The term-skew race the split closes: a placement proposal
    snapshotted before an election applies AFTER it — the election's
    (leader, term) must survive untouched."""
    m = _mgr()
    m.apply(1, m.plan_assignment([0, 1, 2]))
    _seed_topics(m, leader=0, term=3)
    stale = m.plan_assignment([0, 1]) or {
        "op": OP_SET_TOPICS,
        "topics": topics_to_wire(placement_only(m.get_topics())),
        "live": [0, 1],
    }
    # Election races in between snapshot and apply.
    m.apply(50, {"op": "set_leader", "topic": "topic1", "partition": 0,
                 "leader": 1, "term": 7})
    m.apply(51, stale)
    a = m.assignment_of(("topic1", 0))
    assert a.leader == 1 and a.term == 7


def test_placement_move_drops_leader_keeps_term():
    """A placement rewrite that removes the leader's broker from the
    replica set leaves the partition leaderless (it re-elects) but keeps
    the term — terms only move forward."""
    m = _mgr()
    m.apply(1, m.plan_assignment([0, 1, 2]))
    _seed_topics(m, leader=2, term=4)
    moved = [
        t.with_assignments(tuple(
            PartitionAssignment(a.partition_id, (0, 1, 3), None, 0)
            for a in t.assignments
        ))
        for t in m.get_topics()
    ]
    m.apply(60, {"op": OP_SET_TOPICS, "topics": topics_to_wire(moved),
                 "live": [0, 1, 3]})
    a = m.assignment_of(("topic1", 0))
    assert a.replicas == (0, 1, 3)
    assert a.leader is None and a.term == 4


def test_snapshot_restore_preserves_leader_surface():
    """The deliberate exception: a metadata SNAPSHOT is the full applied
    state and must install leaders on a fresh node (restore routes
    through the full_surface path)."""
    m = _mgr()
    m.apply(1, m.plan_assignment([0, 1, 2]))
    _seed_topics(m, leader=1, term=5)
    snap = m.snapshot()
    fresh = _mgr()
    fresh.restore(snap)
    a = fresh.assignment_of(("topic1", 0))
    assert a.leader == 1 and a.term == 5


def test_snapshot_restore_stays_term_monotonic():
    """Restoring a snapshot onto a table that is already AHEAD (a node
    that applied newer entries) must keep the newer (leader, term) — the
    pre-split merge rule, still guarding the full-surface path."""
    m = _mgr()
    m.apply(1, m.plan_assignment([0, 1, 2]))
    _seed_topics(m, leader=0, term=3)
    snap = m.snapshot()
    m.apply(90, {"op": "set_leader", "topic": "topic1", "partition": 0,
                 "leader": 1, "term": 8})
    m.restore(snap)
    a = m.assignment_of(("topic1", 0))
    assert a.leader == 1 and a.term == 8


def test_placement_only_helper_strips_everything():
    t = Topic("x", 2, 3, (
        PartitionAssignment(0, (0, 1, 2), 2, 9),
        PartitionAssignment(1, (1, 2, 3), None, 4),
    ))
    stripped = placement_only([t])[0]
    assert [a.replicas for a in stripped.assignments] == [
        (0, 1, 2), (1, 2, 3)
    ]
    assert all(a.leader is None and a.term == 0
               for a in stripped.assignments)
    # Input untouched (frozen models; no aliasing surprises).
    assert t.assignments[0].leader == 2 and t.assignments[0].term == 9


def test_consumer_slot_collision_resolved_in_apply():
    from ripplemq_tpu_torch.broker.manager import PartitionManager
    from tests.torch_helpers import make_config

    config = make_config(3)
    m = PartitionManager(0, config)
    m.apply(1, {"op": "register_consumer", "consumer": "a", "slot": 0})
    m.apply(2, {"op": "register_consumer", "consumer": "b", "slot": 0})
    m.apply(3, {"op": "register_consumer", "consumer": "a", "slot": 5})  # dup
    assert m.consumer_slot("a") == 0
    assert m.consumer_slot("b") == 1  # collision moved to lowest free


def test_plan_repairs_catches_slot_revived_while_leaderless():
    """A replica slot that comes alive while its partition is leaderless
    gets no event-driven resync (there is no leader to copy from). The
    periodic plan_repairs pass must catch it up once a leader exists —
    without it the slot would stay permanently stale and silently reduce
    fault tolerance."""
    from ripplemq_tpu_torch.broker.manager import OP_SET_LEADER, OP_SET_TOPICS, PartitionManager
    from ripplemq_tpu_torch.metadata.models import PartitionAssignment, Topic, topics_to_wire
    from tests.torch_helpers import make_config

    config = make_config(3)
    dp = port_dp(config.engine, max_retry_rounds=3)
    dp.start()
    try:
        m = PartitionManager(0, config, dp)

        def placement():
            # OP_SET_TOPICS owns placement only; the (leader, term)
            # surface rides OP_SET_LEADER (the op split — see
            # tests/test_op_split.py for the directed coverage).
            return topics_to_wire([
                t.with_assignments(tuple(
                    PartitionAssignment(pid, (0, 1, 2), None, 0)
                    for pid in range(t.partitions)
                ))
                for t in config.topics
            ])

        # Healthy cluster; leader broker 0 advertised, commit a round.
        m.apply(1, {"op": OP_SET_TOPICS, "topics": placement(),
                    "live": [0, 1, 2]})
        m.apply(2, {"op": OP_SET_LEADER, "topic": "topic1", "partition": 0,
                    "leader": 0, "term": 1})
        slot = m.slot_of(("topic1", 0))
        assert dp.submit_append(slot, [b"r1a", b"r1b"]).result(timeout=10) == 0

        # Broker 2 dies; the quorum of {0, 1} keeps committing (the
        # placement re-apply keeps the current leader surface).
        m.apply(3, {"op": OP_SET_TOPICS, "topics": placement(),
                    "live": [0, 1]})
        dp.submit_append(slot, [b"r2"]).result(timeout=10)
        ends = dp.log_ends()
        assert ends[2, slot] < ends[0, slot]  # replica 2 is stale

        # Leader lost too: partition goes leaderless, THEN broker 2
        # revives. came-alive resync is skipped (no leader to copy from).
        m.apply(4, {"op": OP_SET_LEADER, "topic": "topic1", "partition": 0,
                    "leader": None, "term": 1})
        m.apply(5, {"op": OP_SET_TOPICS, "topics": placement(),
                    "live": [0, 1, 2]})
        assert m.plan_repairs() == {}  # leaderless: nothing to plan yet
        ends = dp.log_ends()
        assert ends[2, slot] < ends[0, slot]  # still stale

        # Election lands: now the periodic repair pass must plan a resync.
        m.apply(6, {"op": OP_SET_LEADER, "topic": "topic1", "partition": 0,
                    "leader": 0, "term": 2})
        repairs = m.plan_repairs()
        assert any(slot in slots for (_, d), slots in repairs.items() if d == 2)
        for (src, dst), slots in repairs.items():
            dp.resync(src, dst, slots)
        ends = dp.log_ends()
        assert ends[2, slot] == ends[0, slot]
        assert read_all(dp, slot, replica=2) == [b"r1a", b"r1b", b"r2"]
        assert m.plan_repairs() == {}  # converged
    finally:
        dp.stop()


# --------------------------------------- differential: the JAX package

DIFF_TOPICS = (("a", 3, 3), ("b", 2, 3))
TIMEOUT = 60


def _pair():
    """(reference manager, port manager), each with a CPU DataPlane
    attached and started; elections plan with no debounce."""
    from ripplemq_tpu.broker import dataplane as ref_dataplane
    from ripplemq_tpu.broker import manager as ref_manager
    from ripplemq_tpu.metadata.models import Topic as RefTopic
    from tests.broker_harness import make_config as ref_make_config
    from tests.helpers import small_cfg
    from tests.torch_helpers import port_cfg as port_cfg_

    ref_cfg = ref_make_config(
        4, topics=tuple(RefTopic(*t) for t in DIFF_TOPICS),
        engine=small_cfg(partitions=5, replicas=3, slots=512),
        election_timeout_s=0.0)
    port_cfg = make_config(
        4, topics=tuple(Topic(*t) for t in DIFF_TOPICS),
        engine=port_cfg_(partitions=5, replicas=3, slots=512),
        election_timeout_s=0.0)
    ref_dp = ref_dataplane.DataPlane(ref_cfg.engine, mode="local",
                                     max_retry_rounds=3)
    port_dp_ = port_dp(port_cfg.engine, max_retry_rounds=3)
    ref_dp.start()
    port_dp_.start()
    return (ref_manager.PartitionManager(0, ref_cfg, ref_dp),
            PartitionManager(0, port_cfg, port_dp_))


def _tables(m):
    dp = m.dataplane
    with dp._lock:
        host = [dp.leader.tolist(), dp.term.tolist(), dp.alive.tolist(),
                dp.quorum.tolist()]
    return host + [dp.log_ends().tolist(), dp.current_terms().tolist()]


def _views(m, live):
    cands, drafts = m.plan_elections()
    return {
        "snapshot": m.snapshot(),
        "tables": _tables(m),
        "elections": (cands, drafts),
        "repairs": m.plan_repairs(),
        "assignment": m.plan_assignment(live),
        "controller": m.plan_controller(live),
        "standby_add": m.plan_standby_add(2),
        "consumer_slot": m.next_consumer_slot(),
    }


def _command(rng, m, live):
    """One seeded metadata command, drawn from the port manager's state
    (the two managers hold equal state whenever this is called)."""
    kind = int(rng.integers(0, 14))
    topics = [(t.name, t.partitions) for t in m.config.topics]
    name, parts = topics[int(rng.integers(0, len(topics)))]
    pid = int(rng.integers(0, parts))
    if kind in (0, 12, 13):  # a live-set change, planned as placement
        new = sorted(set(live) ^ {int(rng.integers(0, 4))})
        if len(new) >= 2:  # 2 of 4 live: RF 3 unplaceable, slots die
            live[:] = new
        return m.plan_assignment(live)
    if kind == 1:
        a = m.assignment_of((name, pid))
        choices = [None, *a.replicas]
        return {"op": "set_leader", "topic": name, "partition": pid,
                "leader": choices[int(rng.integers(0, len(choices)))],
                "term": a.term + int(rng.integers(-1, 2))}
    if kind == 2:
        return {"op": "register_consumer", "consumer": f"c{rng.integers(0, 5)}",
                "slot": int(rng.integers(0, 8))}
    if kind == 3:
        return {"op": "release_consumer", "consumer": f"c{rng.integers(0, 5)}"}
    if kind == 4:
        return {"op": "register_producer", "producer": f"p{rng.integers(0, 4)}"}
    if kind == 5:
        return {"op": "retire_producer", "producer": f"p{rng.integers(0, 4)}",
                "seen": int(rng.integers(0, 3))}
    if kind == 6:
        return {"op": "group_join", "group": f"g{rng.integers(0, 2)}",
                "member": f"m{rng.integers(0, 3)}",
                "topics": [n for n, _ in topics][:int(rng.integers(1, 3))]}
    if kind == 7:
        return {"op": "group_leave", "group": f"g{rng.integers(0, 2)}",
                "member": f"m{rng.integers(0, 3)}", "reason": "leave"}
    if kind == 8:
        sb = sorted(int(b) for b in rng.choice(4, int(rng.integers(0, 3)),
                                               replace=False))
        return {"op": "set_standbys", "epoch": m.current_epoch(),
                "standbys": [b for b in sb if b != m.current_controller()]}
    if kind == 9:
        return m.plan_controller(live) or {
            "op": "set_controller", "controller": int(rng.choice(live)),
            "epoch": m.current_epoch() + 1, "standbys": []}
    if kind == 10:
        return {"op": "batch", "cmds": [
            {"op": "group_join", "group": "g9", "member": f"w{k}",
             "topics": [name]} for k in range(int(rng.integers(1, 4)))]}
    return {"op": "consumer_slot_clean", "slot": int(rng.integers(0, 8))}


@pytest.mark.parametrize("seed", range(2))
def test_seeded_command_log_matches_the_reference(seed):
    """Differential, exact: one seeded metadata command log (placement
    under live-set changes, leader sets, consumer and producer
    registration, group joins, leaves and waves, standby sets, controller
    moves) applied to the reference's and the port's PartitionManager,
    each driving a CPU DataPlane. Between commands both run the same
    elections through `DataPlane.elect`, the same repairs through
    `resync`, and one append per led partition. After every command:
    equal snapshots, equal control tables read back from the planes
    (leader slot, term, alive, quorum, log ends, device terms), and equal
    `plan_elections`, `plan_repairs`, `plan_assignment`,
    `plan_controller` and `plan_standby_add` answers."""
    import numpy as np

    ref, port = _pair()
    rng = np.random.default_rng(seed)
    live = [0, 1, 2, 3]
    try:
        boot = port.plan_assignment(live)
        assert boot == ref.plan_assignment(live)
        index = 1
        for m in (ref, port):
            m.apply(index, boot)
        for step in range(48):
            cmd = _command(rng, port, live)
            if cmd is not None:
                index += 1
                for m in (ref, port):
                    m.apply(index, cmd)
            if step % 3 == 2:  # the controller's duties
                views = [_views(m, live) for m in (ref, port)]
                assert views[1] == views[0], f"step {step}"
                cands, drafts = views[1]["elections"]
                won = [m.dataplane.elect(cands) for m in (ref, port)]
                assert won[1] == won[0]
                for slot, ok in sorted(won[1].items()):
                    if ok:
                        index += 1
                        for m in (ref, port):
                            m.apply(index, drafts[slot])
                for (src, dst), slots in sorted(views[1]["repairs"].items()):
                    for m in (ref, port):
                        m.dataplane.resync(src, dst, slots)
                outcomes = []
                for m in (ref, port):
                    futs = [m.dataplane.submit_append(s, [b"s%d-%d" % (step, s)])
                            for s in range(m.config.engine.partitions)
                            if m.dataplane.leader[s] >= 0]
                    got = []
                    for f in futs:
                        try:
                            got.append(f.result(timeout=TIMEOUT))
                        except Exception as e:  # the outcome is the type
                            got.append(type(e).__name__)
                    outcomes.append(got)
                assert outcomes[1] == outcomes[0], f"step {step}"
            views = [_views(m, live) for m in (ref, port)]
            assert views[1] == views[0], f"after command {index} ({cmd})"
        # The log did reach every kind of state the test is about.
        snap = port.snapshot()
        assert snap["controller_epoch"] > 0 and snap["groups"]
        assert any(a["leader"] is not None for t in snap["topics"]
                   for a in t["assignments"])
    finally:
        for m in (ref, port):
            m.dataplane.stop()

"""Control-plane wave batching: OP_BATCH wave semantics —
one deferred rebalance per touched group, duplicate-wave replay
idempotence, mixed-op waves, waves straddling a controller failover —
plus the incremental sticky-assignment equivalence, the proposal
retry spacing, and cluster-level admission quotas.

Twin of `tests/test_group_waves.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from ripplemq_tpu_torch.broker.manager import OP_BATCH, PartitionManager
from ripplemq_tpu_torch.chaos.cluster import InProcCluster, make_cluster_config
from ripplemq_tpu_torch.groups.state import (
    compute_assignment,
    compute_assignment_delta,
)
from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import wait_until
from tests.torch_port_modules import admit

admit(__name__)


def _manager() -> PartitionManager:
    config = make_cluster_config(
        3, topics=(Topic("t", 4, 3), Topic("u", 2, 3)), engine=None,
    )
    return PartitionManager(0, config)


def _join(group, member, topics=("t",)):
    return {"op": "group_join", "group": group, "member": member,
            "topics": list(topics)}


def _leave(group, member):
    return {"op": "group_leave", "group": group, "member": member}


# ----------------------------------------------------- wave semantics


def test_wave_defers_to_one_rebalance_per_touched_group():
    m = _manager()
    # Five joins to g1 and two to g2 in ONE wave: each touched group
    # rebalances exactly once — generation delta == touched groups,
    # not membership events.
    m.apply(1, {"op": OP_BATCH, "cmds": (
        [_join("g1", f"m{i}") for i in range(5)]
        + [_join("g2", "a"), _join("g2", "b")]
    )})
    g1 = m.groups.state("g1")
    g2 = m.groups.state("g2")
    assert g1.generation == 1 and len(g1.members) == 5
    assert g2.generation == 1 and len(g2.members) == 2
    # The single wave-end rebalance still produced a full disjoint
    # cover, identical to what per-op applies would have converged to.
    union = sorted(k for keys in g1.assignment.values() for k in keys)
    assert union == [("t", p) for p in range(4)]


def test_duplicate_wave_replay_is_idempotent():
    m = _manager()
    wave = {"op": OP_BATCH, "cmds": [
        _join("g", "m1"), _join("g", "m2"), _join("g", "m3"),
        {"op": "register_producer", "producer": "tenant/p1"},
    ]}
    m.apply(1, wave)
    st = m.groups.state("g")
    gen = st.generation
    assign = dict(st.assignment)
    pid = m.producer_id("tenant/p1")
    # The same wave again — a leader retry straddling a failover
    # re-proposing committed cmds. Every sub-op no-ops, so the wave
    # touches nothing: no generation bump, no assignment movement, no
    # fresh pid.
    m.apply(2, wave)
    st = m.groups.state("g")
    assert st.generation == gen
    assert dict(st.assignment) == assign
    assert m.producer_id("tenant/p1") == pid


def test_mixed_op_wave_applies_in_order():
    m = _manager()
    m.apply(1, {"op": OP_BATCH, "cmds": [
        _join("g", "m1"), _join("g", "m2"),
    ]})
    assert m.groups.state("g").generation == 1
    # join + leave + pid registration in one wave: one rebalance
    # covering the net membership move, the pid applied alongside.
    m.apply(2, {"op": OP_BATCH, "cmds": [
        _leave("g", "m1"),
        _join("g", "m3", topics=("t", "u")),
        {"op": "register_producer", "producer": "tenant/p2"},
    ]})
    st = m.groups.state("g")
    assert st.generation == 2
    assert sorted(st.members) == ["m2", "m3"]
    assert m.producer_id("tenant/p2") is not None
    union = sorted(k for keys in st.assignment.values() for k in keys)
    assert union == ([("t", p) for p in range(4)]
                     + [("u", p) for p in range(2)])


def test_wave_skips_group_deleted_mid_wave():
    m = _manager()
    m.apply(1, {"op": OP_BATCH, "cmds": [_join("g", "m1")]})
    # The wave empties the group and the retention reap's delete rides
    # the same wave: finish_wave must not resurrect (or crash on) the
    # dropped group.
    m.apply(2, {"op": OP_BATCH, "cmds": [
        _leave("g", "m1"),
        {"op": "group_delete", "group": "g"},
    ]})
    assert m.groups.state("g") is None


# ------------------------------------- incremental sticky assignment


def test_incremental_assignment_matches_full_on_randomized_churn():
    """compute_assignment_delta promises IDENTICAL output to the full
    recompute for any (members, previous, changed) triple — driven here
    over randomized churn histories (joins, leaves, subscription
    changes) across multiple topics."""
    rng = random.Random(20250807)
    topics = {"a": 7, "b": 4, "c": 1}
    names = [f"m{i}" for i in range(12)]
    for _trial in range(40):
        members: dict[str, tuple[str, ...]] = {}
        prev: dict[str, tuple] = {}
        for _step in range(12):
            prev_members = dict(members)
            changed = set()
            for _ in range(rng.randint(1, 4)):
                name = rng.choice(names)
                if name in members and rng.random() < 0.4:
                    del members[name]
                else:
                    subs = tuple(sorted(rng.sample(
                        sorted(topics), rng.randint(1, len(topics)))))
                    if members.get(name) == subs:
                        continue
                    members[name] = subs
                changed.add(name)
            full = compute_assignment(members, topics, previous=prev)
            delta = compute_assignment_delta(
                members, topics, prev, prev_members, changed)
            assert delta == full, (
                f"divergence: members={members} changed={changed} "
                f"prev={prev}"
            )
            prev = dict(full)


def test_incremental_assignment_reuses_unaffected_topic_slices():
    # Directed: churn touches only topic-b subscribers; topic-a's
    # slices must come through verbatim (the delta path's whole point).
    topics = {"a": 6, "b": 2}
    members = {"x": ("a",), "y": ("a",), "z": ("b",)}
    prev = compute_assignment(members, topics)
    prev_members = dict(members)
    members2 = dict(members)
    members2["w"] = ("b",)
    out = compute_assignment_delta(
        members2, topics, prev, prev_members, {"w"})
    assert out == compute_assignment(members2, topics, previous=prev)
    assert set(out["x"]) == set(prev["x"])
    assert set(out["y"]) == set(prev["y"])


# ------------------------------------------------- cluster-level path


@pytest.fixture(scope="module")
def cluster():
    config = make_cluster_config(
        3, topics=(Topic("t", 4, 3),), engine=None,
        meta_batch_s=0.05,
    )
    with InProcCluster(config, device="cpu") as c:
        c.wait_for_leaders()
        yield c


def _meta_leader(c):
    from ripplemq_tpu_torch.broker.hostraft import LEADER

    for b in c.brokers.values():
        if b.runner.node.role == LEADER:
            return b.broker_id
    return None


def test_wave_straddles_controller_failover(cluster):
    """A join storm racing a metadata-leader kill: every join must
    eventually land (clients retry the typed not_committed refusal),
    generations stay monotonic, and all brokers converge to one
    identical group state — the duplicate-wave path exercised live."""
    c = cluster
    addrs = {b.broker_id: b.address for b in c.config.brokers}
    joined = []
    lock = threading.Lock()

    def member(mi: int):
        client = c.client(f"fo-{mi}")
        req = {"type": "group.join", "group": "fo", "member": f"m{mi}",
               "topics": ["t"]}
        deadline = time.time() + 30
        while time.time() < deadline:
            for bid in sorted(addrs):
                try:
                    resp = client.call(addrs[bid], req, timeout=5.0)
                except Exception:
                    continue
                if resp.get("ok"):
                    with lock:
                        joined.append(mi)
                    return
            time.sleep(0.05)

    threads = [threading.Thread(target=member, args=(mi,), daemon=True)
               for mi in range(8)]
    for t in threads:
        t.start()
    # Kill the metadata leader while waves are in flight, then bring
    # it back: in-flight waves are re-proposed against the new leader
    # (some possibly committed by the old one — the replay must no-op).
    leader = _meta_leader(c)
    if leader is not None:
        time.sleep(0.05)
        c.kill(leader)
        time.sleep(0.3)
        c.restart(leader)
    for t in threads:
        t.join(timeout=40)
    assert sorted(joined) == list(range(8))
    # Every broker serves the same converged state.
    def agreed():
        views = []
        for b in c.brokers.values():
            st = b.manager.group_state("fo")
            if st is None or len(st.members) != 8:
                return False
            views.append((st.generation, tuple(sorted(st.members))))
        return len(set(views)) == 1
    wait_until(agreed, timeout=20)
    st = next(iter(c.brokers.values())).manager.group_state("fo")
    union = sorted(k for keys in st.assignment.values() for k in keys)
    assert union == [("t", p) for p in range(4)]


def test_propose_retry_spacing_tracks_metadata_election(cluster):
    """The proposal retry backoff must span a metadata election: base
    at least election/8, cap at least the election timeout, spacing
    exponential — a leaderless blip costs spaced attempts, not three
    back-to-back failures inside one blip."""
    b = next(iter(cluster.brokers.values()))
    cfg = cluster.config
    policy = b._propose_retry_policy(3)
    assert policy.max_attempts == 3
    assert policy.base_backoff_s >= cfg.metadata_election_timeout_s / 8
    assert policy.max_backoff_s >= cfg.metadata_election_timeout_s
    assert policy.jitter > 0  # concurrent proposers decorrelate
    # Exponential (pre-jitter) spacing, monotone up to the cap.
    backs = [policy.backoff_for(a) for a in (1, 2, 3)]
    assert backs == sorted(backs)
    assert backs[1] == pytest.approx(
        min(backs[0] * policy.multiplier, policy.max_backoff_s))
    # Budgeted: the whole operation is bounded, not retries x timeout.
    assert policy.deadline_s == cfg.rpc_timeout_s * 3


def test_stats_control_plane_block(cluster):
    c = cluster
    client = c.client("cp-stats")
    addr = next(iter(c.brokers.values())).addr
    # Drive at least one wave so the counters are live.
    resp = client.call(addr, {"type": "group.join", "group": "cpb",
                              "member": "m0", "topics": ["t"]},
                       timeout=10.0)
    assert resp["ok"], resp
    stats = client.call(addr, {"type": "admin.stats"}, timeout=5.0)
    cp = stats["control_plane"]
    assert cp["enabled"] is True
    assert cp["waves"] >= 1
    assert cp["wave_events"] >= cp["waves"]
    assert cp["proposals_saved"] == cp["wave_events"] - cp["waves"]
    assert isinstance(cp["wave_size_hist"], dict)
    for k in ("wave_failures", "intake_depth", "heartbeats_local",
              "beat_frames", "beats_relayed"):
        assert k in cp


# ------------------------------------------- cluster-level quotas (slo)


def test_admission_scales_quota_by_leadership_share():
    from ripplemq_tpu_torch.slo.admission import AdmissionController

    now = [0.0]
    ctl = AdmissionController({"acme": 100.0}, clock=lambda: now[0])
    # Full share: the bucket admits a burst of ~rate then refuses.
    assert ctl.admit("acme/p", 100) is None
    assert ctl.admit("acme/p", 1) is not None  # bucket drained
    # A skewed leadership map: this broker holds 1/10th of the
    # cluster's leaderships — its slice of the cluster quota shrinks
    # in place (banked tokens clip to the new burst).
    ctl.set_leadership_share(0.1)
    assert ctl.leadership_share == 0.1
    now[0] += 1.0  # one second refills share*rate = 10 tokens
    assert ctl.admit("acme/p", 10) is None
    refusal = ctl.admit("acme/p", 1)
    assert refusal is not None and "cluster" in refusal
    assert ctl.stats()["leadership_share"] == 0.1
    # Growing back re-opens headroom at the next refill.
    ctl.set_leadership_share(1.0)
    now[0] += 1.0
    assert ctl.admit("acme/p", 50) is None


def test_admission_shares_sum_to_cluster_rate():
    from ripplemq_tpu_torch.slo.admission import AdmissionController

    # Two brokers splitting the leadership map 3:1 jointly admit ~one
    # cluster quota per refill window, not one EACH (the pre-scaling
    # behavior this satellite removes).
    now = [0.0]
    a = AdmissionController({"acme": 80.0}, clock=lambda: now[0])
    b = AdmissionController({"acme": 80.0}, clock=lambda: now[0])
    a.set_leadership_share(0.75)
    b.set_leadership_share(0.25)
    admitted = 0
    for ctl in (a, b):
        while ctl.admit("acme/p", 1) is None:
            admitted += 1
    # Initial burst: 0.75*80 + 0.25*80 = 80 = one cluster quota
    # (debt model admits one extra marginal message per bucket).
    assert 78 <= admitted <= 84, admitted

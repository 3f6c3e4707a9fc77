"""Elastic partitions: online split/merge with
generation-fenced cutover.

Directed units on the metadata core — genesis key-range math (each
configured partition owns its 1/n-th share of RANGE_SPACE, so a split
child's carve is never shadowed by a full-range sibling), the
OP_SPLIT_PARTITION midpoint carve + generation bump + spare-slot
spend, OP_SPLIT_CUTOVER closing the handoff window, merge adjacency /
retirement, the deterministic no-op guards, and the revoke-FIRST lease
fence ordering — then the end-to-end contract on an in-proc cluster:
keyed produces re-route through a split and back through the merge,
requests stamped with a stale generation draw the typed retryable
`stale_partition_gen:` refusal carrying the new routing in BOTH
directions (a pre-split stamp after the split; a produce aimed at a
merge-retired child), consumer offsets on the parent carry over the
handoff exactly (generation fencing changes ROUTING, never settled
state), and the union of every partition's drained log is count-exact
against the acked set. check_reconfig units pin the verdict section's
bounded time-to-rebalance contract without booting a cluster.

The fixed-seed chaos smokes that race these transitions against
crashes and controller failover live in tests/test_split_chaos.py.

Twin of `tests/test_split.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import zlib

from ripplemq_tpu_torch.broker.manager import (
    OP_MERGE_PARTITIONS,
    OP_SET_CONTROLLER,
    OP_SET_FOLLOWER_LEASES,
    OP_SET_TOPICS,
    OP_SPLIT_CUTOVER,
    OP_SPLIT_PARTITION,
    PartitionManager,
)
from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
from ripplemq_tpu_torch.chaos.harness import _drain_partition, check_reconfig
from ripplemq_tpu_torch.client.producer import key_hash
from ripplemq_tpu_torch.metadata.models import RANGE_SPACE, Topic
from tests.helpers import wait_until
from tests.torch_helpers import InProcCluster
from tests.torch_port_modules import admit

admit(__name__)

# ------------------------------------------------- manager units (pure)


def _mgr(parts=2, spare=1, **cfg_kw) -> PartitionManager:
    """Metadata-only manager (no dataplane) over a `parts`-partition
    topic "t" with `spare` elastic engine slots."""
    cfg = make_cluster_config(
        3, topics=(Topic("t", parts, 3),), spare_slots=spare, **cfg_kw,
    )
    return PartitionManager(0, cfg, dataplane=None)


def _seed(m: PartitionManager, parts=2) -> int:
    """Install placement (payload is range-stripped — genesis ranges
    are the APPLY's job), then advertise leaders the owned way.
    Returns the next free log index."""
    from ripplemq_tpu_torch.metadata.models import PartitionAssignment, topics_to_wire

    m.apply(1, {
        "op": OP_SET_TOPICS,
        "topics": topics_to_wire([
            Topic("t", parts, 3, tuple(
                PartitionAssignment(pid, (0, 1, 2))
                for pid in range(parts)
            )),
        ]),
        "live": [0, 1, 2],
    })
    idx = 2
    for pid in range(parts):
        m.apply(idx, {"op": "set_leader", "topic": "t", "partition": pid,
                      "leader": 0, "term": 1})
        idx += 1
    return idx


def _view(m: PartitionManager) -> dict:
    t = next(t for t in m.get_topics() if t.name == "t")
    return {a.partition_id: a for a in t.assignments}


def test_genesis_ranges_partition_the_space():
    """Each configured partition owns its 1/n-th share — contiguous,
    disjoint, covering [0, RANGE_SPACE) — and route_key resolves every
    hash to exactly one owner."""
    m = _mgr(parts=4, spare=0)
    _seed(m, parts=4)
    v = _view(m)
    assert len(v) == 4
    for pid in range(4):
        assert v[pid].range_lo == RANGE_SPACE * pid // 4
        assert v[pid].range_hi == RANGE_SPACE * (pid + 1) // 4
    assert v[0].range_lo == 0 and v[3].range_hi == RANGE_SPACE
    for h in (0, 1, RANGE_SPACE // 4, RANGE_SPACE // 2, RANGE_SPACE - 1):
        owners = [pid for pid, a in v.items() if a.owns_key(h)]
        assert len(owners) == 1
        assert m.route_key("t", h) == owners[0]


def test_key_hash_is_crc32_into_range_space():
    for k in (b"", b"k00", b"user-42", b"x" * 200):
        h = key_hash(k)
        assert h == zlib.crc32(k) % RANGE_SPACE
        assert 0 <= h < RANGE_SPACE


def test_split_carves_midpoint_bumps_generation_spends_spare():
    m = _mgr()
    idx = _seed(m)
    assert m.spare_slot_count() == 1
    p0 = _view(m)[0]
    mid = (p0.range_lo + p0.range_hi) // 2
    m.apply(idx, {"op": OP_SPLIT_PARTITION, "topic": "t", "partition": 0,
                  "watermark": 7})
    v = _view(m)
    assert len(v) == 3  # parent, sibling, minted child
    parent, child = v[0], v[2]
    assert (parent.range_lo, parent.range_hi) == (p0.range_lo, mid)
    assert (child.range_lo, child.range_hi) == (mid, p0.range_hi)
    assert parent.state == child.state == "handoff"
    assert parent.generation == child.generation == p0.generation + 1
    assert child.origin == 0
    # Dual-write wants one serialization point: the child starts under
    # the parent's leader.
    assert child.leader == parent.leader
    assert m.spare_slot_count() == 0
    ho = m.current_handoffs()
    assert ho == {("t", 0): {"child": 2, "watermark": 7}}
    st = m.reconfig_stats()
    assert st["children"] == 1 and st["handoff_partitions"] == 2
    assert st["open_handoffs"][0]["partition"] == 0
    # Cutover: both active under a further-bumped generation, window
    # closed, routing splits the old range at the midpoint.
    m.apply(idx + 1, {"op": OP_SPLIT_CUTOVER, "topic": "t",
                      "partition": 0, "watermark": 7})
    v = _view(m)
    assert v[0].state == v[2].state == "active"
    assert v[0].generation == v[2].generation == p0.generation + 2
    assert m.current_handoffs() == {}
    assert m.route_key("t", mid - 1) == 0
    assert m.route_key("t", mid) == 2


def test_split_no_op_guards_are_deterministic():
    # No spare slot: the table is left untouched.
    m = _mgr(spare=0)
    idx = _seed(m)
    before = _view(m)
    m.apply(idx, {"op": OP_SPLIT_PARTITION, "topic": "t", "partition": 0,
                  "watermark": 0})
    assert _view(m) == before and m.current_handoffs() == {}
    # Unknown topic / partition: no-op, never a crash.
    m2 = _mgr(spare=2)
    idx = _seed(m2)
    m2.apply(idx, {"op": OP_SPLIT_PARTITION, "topic": "nope",
                   "partition": 0, "watermark": 0})
    m2.apply(idx + 1, {"op": OP_SPLIT_PARTITION, "topic": "t",
                       "partition": 9, "watermark": 0})
    assert len(_view(m2)) == 2
    # A handoff parent cannot split again while its window is open.
    m2.apply(idx + 2, {"op": OP_SPLIT_PARTITION, "topic": "t",
                       "partition": 0, "watermark": 0})
    m2.apply(idx + 3, {"op": OP_SPLIT_PARTITION, "topic": "t",
                       "partition": 0, "watermark": 0})
    assert len(_view(m2)) == 3 and m2.spare_slot_count() == 1
    # split_max_partitions caps the topic's growth.
    m3 = _mgr(spare=2, split_max_partitions=2)
    idx = _seed(m3)
    m3.apply(idx, {"op": OP_SPLIT_PARTITION, "topic": "t", "partition": 0,
                   "watermark": 0})
    assert len(_view(m3)) == 2 and m3.spare_slot_count() == 2


def test_merge_requires_adjacency_and_retires_child():
    m = _mgr()
    idx = _seed(m)
    m.apply(idx, {"op": OP_SPLIT_PARTITION, "topic": "t", "partition": 0,
                  "watermark": 0})
    # Open handoff: the merge must refuse to race the cutover.
    m.apply(idx + 1, {"op": OP_MERGE_PARTITIONS, "topic": "t",
                      "parent": 0, "child": 2})
    assert _view(m)[2].state == "handoff"
    assert m.merge_candidates() == []
    m.apply(idx + 2, {"op": OP_SPLIT_CUTOVER, "topic": "t",
                      "partition": 0, "watermark": 0})
    assert m.merge_candidates() == [("t", 0, 2)]
    # Wrong parent (origin mismatch): no-op.
    m.apply(idx + 3, {"op": OP_MERGE_PARTITIONS, "topic": "t",
                      "parent": 1, "child": 2})
    assert _view(m)[2].state == "active"
    gen0 = _view(m)[0].generation
    m.apply(idx + 4, {"op": OP_MERGE_PARTITIONS, "topic": "t",
                      "parent": 0, "child": 2})
    v = _view(m)
    assert v[0].range_hi == v[2].range_hi  # parent reabsorbed the range
    assert v[2].state == "retired"
    assert v[2].range_lo == v[2].range_hi  # owns nothing now
    assert v[0].generation == v[2].generation == gen0 + 1
    # Retired children never route; the parent owns the range again.
    assert m.route_key("t", v[0].range_hi - 1) == 0
    assert m.merge_candidates() == []


def test_split_and_merge_revoke_leases_first_then_regrant():
    """Fence ordering: every split/merge apply clears the WHOLE
    follower-lease table in the same replicated step that changes
    routing — a standby can never serve the pre-transition routing.
    The duty re-grants under the UNCHANGED controller epoch after."""
    m = _mgr()
    idx = _seed(m)
    m.apply(idx, {"op": OP_SET_CONTROLLER, "controller": 0, "epoch": 1,
                  "standbys": [1, 2]})
    m.apply(idx + 1, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 1,
                      "leases": {1: 1, 2: 1}})
    assert m.current_follower_leases() == {1: 1, 2: 1}
    m.apply(idx + 2, {"op": OP_SPLIT_PARTITION, "topic": "t",
                      "partition": 0, "watermark": 0})
    assert m.current_follower_leases() == {}
    # Re-grant rides the same epoch (no controller handover happened).
    m.apply(idx + 3, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 1,
                      "leases": {1: 1}})
    assert m.current_follower_leases() == {1: 1}
    m.apply(idx + 4, {"op": OP_SPLIT_CUTOVER, "topic": "t",
                      "partition": 0, "watermark": 0})
    m.apply(idx + 5, {"op": OP_MERGE_PARTITIONS, "topic": "t",
                      "parent": 0, "child": 2})
    assert m.current_follower_leases() == {}  # merge fences identically
    m.apply(idx + 6, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 1,
                      "leases": {2: 1}})
    assert m.current_follower_leases() == {2: 1}


# --------------------------------------------- check_reconfig units


def _ev(type_, t, gen, pid=0, src="broker0"):
    return {"src": src, "type": type_, "t": t, "topic": "t",
            "partition": pid, "generation": gen}


def test_check_reconfig_no_stats_is_a_violation():
    section, violations = check_reconfig({}, [], [], 20.0)
    assert violations and "no broker" in violations[0]
    assert section["splits_begun"] == 0


def test_check_reconfig_open_handoff_is_unbounded_rebalance():
    rstats = {"0": {"open_handoffs": [
        {"topic": "t", "partition": 0, "child": 2, "watermark": 5}],
        "forwarded_writes": 0, "fence_refusals": 0, "spare_slots": 0}}
    section, violations = check_reconfig(rstats, [], [], 20.0)
    assert any("still open" in v for v in violations)
    assert section["open_handoffs_at_end"] == [("t", 0)]


def test_check_reconfig_pairs_dedups_and_bounds_cutovers():
    rstats = {"0": {"open_handoffs": [], "forwarded_writes": 3,
                    "fence_refusals": 2, "spare_slots": 1},
              "1": {"open_handoffs": [], "forwarded_writes": 1,
                    "fence_refusals": 0, "spare_slots": 1}}
    # Both brokers record the same transitions; broker1 observes the
    # begin later — dedup must keep the EARLIEST so the measured
    # duration is the widest honest window.
    events = [
        _ev("split_begin", 10.0, 1),
        _ev("split_begin", 10.4, 1, src="broker1"),
        _ev("split_cutover", 11.5, 2),
        _ev("split_begin", 20.0, 3, pid=1),  # cutover scrolled out
        _ev("merge_done", 30.0, 4),
    ]
    log = [{"op": "split_partition"}, {"op": "split_partition"},
           {"op": "merge_partitions"}]
    section, violations = check_reconfig(rstats, events, log, 20.0)
    assert violations == []
    assert section["splits_attempted"] == 2
    assert section["merges_attempted"] == 1
    assert section["splits_begun"] == 2 and section["split_cutovers"] == 1
    assert section["merges_done"] == 1
    assert section["cutover_durations_s"] == [1.5]  # earliest begin won
    assert section["cutover_unobserved"] == [("t", 1)]  # informational
    assert section["forwarded_writes"] == 4
    assert section["fence_refusals"] == 2
    # The same observed pair over a tighter bound is a violation.
    _, violations = check_reconfig(rstats, events, log, 1.0)
    assert any("begin→cutover" in v for v in violations)


# ------------------------------------------------- cluster end-to-end


def test_split_merge_end_to_end_fencing_and_offset_carry_over():
    """One in-proc cluster through the full elastic lifecycle: keyed
    traffic before/through/after a split and a merge, with the fence
    checked raw in both directions and the drained union count-exact."""
    topic = "ee"
    config = make_cluster_config(
        3, topics=(Topic(topic, 2, 3),), spare_slots=1,
        split_handoff_timeout_s=5.0,
    )
    with InProcCluster(config) as cluster:
        cluster.wait_for_leaders()
        from ripplemq_tpu_torch.client import ConsumerClient, ProducerClient

        bootstrap = [b.address for b in config.brokers]
        producer = ProducerClient(
            bootstrap, transport=cluster.client("ee-p"),
            metadata_refresh_s=0.2, rpc_timeout_s=5.0,
        )
        acked: list[str] = []

        def put(i: int) -> int:
            payload = f"m{i:03d}"
            producer.produce(topic, payload.encode(),
                             key=f"k{i % 16:02d}".encode())
            acked.append(payload)
            return (producer.last_partition
                    if producer.last_partition is not None else -1)

        for i in range(24):
            put(i)

        # Drain partition 0 with an auto-commit consumer BEFORE the
        # split so its server-tracked offset is parked mid-log.
        consumer = ConsumerClient(
            bootstrap, "ee-c", transport=cluster.client("ee-c"),
            metadata_refresh_s=0.2, rpc_timeout_s=5.0,
        )
        seen0: list[bytes] = []
        assert wait_until(
            lambda: (seen0.extend(consumer.consume(topic, partition=0,
                                                   max_messages=64))
                     or len(seen0) > 0),
            timeout=15.0,
        )
        while True:
            batch = consumer.consume(topic, partition=0, max_messages=64)
            if not batch:
                break
            seen0.extend(batch)
        pre_split_count = len(seen0)

        gen0 = cluster.topic_view(topic)[0].generation
        r = cluster.admin_split(topic, 0)
        assert r.get("ok"), r
        child = int(r["child"])
        assert wait_until(
            lambda: all(a.state == "active"
                        for a in cluster.topic_view(topic)),
            timeout=20.0,
        ), "handoff window never cut over"
        view = {a.partition_id: a for a in cluster.topic_view(topic)}
        parent, ch = view[0], view[child]
        assert ch.origin == 0 and parent.range_hi == ch.range_lo
        assert ch.generation == parent.generation > gen0

        # Fence, direction 1: a produce stamped with the PRE-split
        # generation draws the typed retryable refusal carrying the
        # current routing (generation + ranges), on the raw wire.
        leader = cluster.leader_broker(topic, 0)
        addr = cluster.broker_addr(leader.broker_id)
        fence = cluster.client("ee-fence")
        resp = fence.call(addr, {
            "type": "produce", "topic": topic, "partition": 0,
            "messages": [b"stale"], "pgen": gen0,
        }, timeout=5.0)
        assert not resp.get("ok")
        assert str(resp["error"]).startswith("stale_partition_gen:")
        assert resp["generation"] == parent.generation
        routed = {d["partition_id"]: d for d in resp["routing"]}
        assert routed[child]["range_lo"] == parent.range_hi
        # Consume and offset-commit honor the same stamp.
        resp = fence.call(addr, {
            "type": "consume", "topic": topic, "partition": 0,
            "consumer": "ee-fence", "offset": 0, "pgen": gen0,
        }, timeout=5.0)
        assert str(resp.get("error", "")).startswith("stale_partition_gen:")

        # Offset carry-over exactness: the parked consumer sees ZERO
        # re-delivery after the transition — its committed position on
        # the parent survived the generation bumps untouched.
        assert consumer.consume(topic, partition=0, max_messages=64) == []
        assert len(seen0) == pre_split_count

        # Keyed traffic now spreads over the child's range too, and the
        # producer adopts the new routing transparently.
        landed = {put(i) for i in range(24, 72)}
        assert child in landed, f"no post-split produce landed on {child}"

        # Merge back: candidates name the pair, the child retires but
        # stays drainable, and its range routes to the parent again.
        assert (topic, 0, child) in cluster.merge_candidates()
        r = cluster.admin_merge(topic, 0, child)
        assert r.get("ok"), r
        view = {a.partition_id: a for a in cluster.topic_view(topic)}
        assert view[child].state == "retired"
        assert view[0].range_hi == ch.range_hi

        # Fence, direction 2: a produce aimed at the retired child is
        # refused with routing that sends the writer to the parent.
        leader_c = cluster.leader_broker(topic, child)
        resp = fence.call(cluster.broker_addr(leader_c.broker_id), {
            "type": "produce", "topic": topic, "partition": child,
            "messages": [b"late"],
        }, timeout=5.0)
        assert not resp.get("ok")
        assert "retired" in str(resp["error"])
        post_merge = {put(i) for i in range(72, 88)}
        assert child not in post_merge

        # Exactness across the whole lifecycle: every acked payload is
        # in exactly one partition's log (the fence changes routing,
        # never settled state — no loss, no duplicates).
        drained: list[str] = []
        for pid in sorted(view):
            drained += _drain_partition(cluster, topic, pid,
                                        tag=f"ee-{pid}")
        assert sorted(drained) == sorted(acked)

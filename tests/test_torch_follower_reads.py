"""Fan-out consume plane: follower reads served from the
bytes replication already paid for, fenced like writes.

Directed units on the two safety cores — FollowerReadPlane (floor
refusal, gap skip, generation fence, FIFO page-cache eviction, the
audit_answer witness) and the PartitionManager lease table (stale-epoch
grants ignored, handover revocation, standby-set pruning, snapshot
round-trip) — then the end-to-end contract on in-proc clusters: rows a
leased standby serves are BYTE-IDENTICAL to the leader's in both
replication modes, anything above the floor refuses with the typed
retryable `not_settled_here:`, and a deposed standby (stale lease
generation) never serves at all. Fixed-seed chaos smokes on both
backends hold `answers_past_floor == 0` as a first-class violation.

Twin of `tests/test_follower_reads.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import time

import pytest

from ripplemq_tpu_torch.broker.follower import FollowerReadPlane
from ripplemq_tpu_torch.broker.manager import (
    OP_SET_CONTROLLER,
    OP_SET_FOLLOWER_LEASES,
    OP_SET_STANDBYS,
    PartitionManager,
)
from ripplemq_tpu_torch.storage.segment import REC_APPEND
from tests.helpers import assert_chaos_liveness, wait_until
from tests.torch_port_modules import admit

admit(__name__)

SB = 32  # slot_bytes for every plane in this module


def rows_of(payloads, slot_bytes=SB):
    """Engine row framing: fixed-width rows, LE u32 payload length at
    bytes 0:4, payload at ROW_HEADER (8)."""
    out = bytearray()
    for p in payloads:
        row = bytearray(slot_bytes)
        row[0:4] = len(p).to_bytes(4, "little")
        row[8 : 8 + len(p)] = p
        out += row
    return bytes(out)


def payloads(n, start=0, tag="p"):
    return [f"{tag}-{i}".encode() for i in range(start, start + n)]


# ----------------------------------------------- FollowerReadPlane units


def test_plane_never_serves_at_or_above_floor():
    fp = FollowerReadPlane(SB, 1 << 20)
    ps = payloads(8)
    # 8 rows replicated, but the leader's floor stamp only settles 5.
    fp.ingest_rounds(1, [(REC_APPEND, 0, 0, rows_of(ps))], [[0, 5, []]])
    got = fp.read(0, 0, None)
    assert got == (ps[:5], 5)
    assert fp.read(0, 5, None) is None  # at the floor: refuse
    assert fp.read(0, 7, None) is None  # above it: refuse
    assert fp.read(0, 4, None) == ([ps[4]], 5)
    # max_messages clamps inside the floor, never across it.
    assert fp.read(0, 0, 2) == (ps[:2], 2)
    # A later floor stamp (no new rows needed) releases the tail.
    fp.ingest_rounds(1, [], [[0, 8, []]])
    assert fp.read(0, 5, None) == (ps[5:], 8)
    st = fp.stats()
    assert st["reads_refused"] == 2 and st["answers_past_floor"] == 0
    assert fp.floors() == {0: 8}


def test_plane_gap_skip_answers_like_the_leader():
    fp = FollowerReadPlane(SB, 1 << 20)
    head = payloads(2)
    tail = payloads(4, start=4, tag="t")
    fp.ingest_rounds(1, [(REC_APPEND, 0, 0, rows_of(head))], [[0, 2, []]])
    # Rows 2..4 never committed (leader gap): the next page lands at
    # base 4 and the floor stamp names the gap.
    fp.ingest_rounds(
        1, [(REC_APPEND, 0, 4, rows_of(tail))], [[0, 8, [[2, 4]]]]
    )
    # Inside the gap: the same empty-advance skip the leader serves.
    assert fp.read(0, 2, None) == ([], 4)
    assert fp.read(0, 3, None) == ([], 4)
    assert fp.read(0, 4, None) == (tail, 8)
    # The gap restart dropped the pre-gap run: below-window refuses
    # (the leader still holds those rows).
    assert fp.read(0, 0, None) is None


def test_plane_generation_fence_resets_and_drops_stale_ingest():
    fp = FollowerReadPlane(SB, 1 << 20)
    ps = payloads(4)
    fp.ingest_rounds(3, [(REC_APPEND, 0, 0, rows_of(ps))], [[0, 4, []]])
    assert fp.read(0, 0, None) == (ps, 4)
    # A newer generation observed (even before its first frame): every
    # floor and cached byte of the old one is gone.
    fp.note_epoch(4)
    assert fp.epoch() == 4
    assert fp.read(0, 0, None) is None
    assert fp.floors() == {}
    # Stale-generation ingest is dropped wholesale.
    fp.ingest_rounds(3, [(REC_APPEND, 0, 0, rows_of(ps))], [[0, 4, []]])
    assert fp.read(0, 0, None) is None
    # The new generation's stream serves normally.
    fp.ingest_rounds(4, [(REC_APPEND, 0, 0, rows_of(ps))], [[0, 4, []]])
    assert fp.read(0, 0, None) == (ps, 4)


def test_audit_answer_witness_counts_past_floor_windows():
    fp = FollowerReadPlane(SB, 1 << 20)
    fp.ingest_rounds(1, [(REC_APPEND, 0, 0, rows_of(payloads(8)))],
                     [[0, 5, []]])
    assert fp.audit_answer(0, 0, 5) is True
    assert fp.audit_answer(0, 4, 5) is True
    assert fp.stats()["answers_past_floor"] == 0
    # Window crossing the floor, starting at it, or on a slot with no
    # floor at all: refused AND counted — the harness's first-class
    # violation signal.
    assert fp.audit_answer(0, 4, 6) is False
    assert fp.audit_answer(0, 5, 6) is False
    assert fp.audit_answer(9, 0, 1) is False
    assert fp.stats()["answers_past_floor"] == 3


def test_plane_page_cache_evicts_fifo_and_refills():
    # Budget for 4 rows; 8 rows arrive as four 2-row pages -> the two
    # oldest pages evict, the tail still serves.
    fp = FollowerReadPlane(SB, 4 * SB)
    ps = payloads(8)
    fp.ingest_rounds(1, [
        (REC_APPEND, 0, base, rows_of(ps[base : base + 2]))
        for base in (0, 2, 4, 6)
    ], [[0, 8, []]])
    st = fp.stats()
    assert st["cache"]["evictions"] == 2 and st["cache"]["bytes"] <= 4 * SB
    assert fp.read(0, 0, None) is None  # evicted: leader has them
    assert fp.read(0, 2, None) is None
    assert fp.read(0, 4, None) == (ps[4:], 8)
    # The cache refills forward: a fresh page evicts the now-oldest
    # and serves at the new tail.
    more = payloads(2, start=8, tag="n")
    fp.ingest_rounds(1, [(REC_APPEND, 0, 8, rows_of(more))], [[0, 10, []]])
    assert fp.read(0, 8, None) == (more, 10)
    assert fp.stats()["cache"]["evictions"] == 3


# --------------------------------------------- lease-table (manager) units


def _mk_manager():
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config

    return PartitionManager(0, make_cluster_config())


def test_lease_grants_fence_on_epoch_and_membership():
    m = _mk_manager()
    m.apply(1, {"op": OP_SET_CONTROLLER, "controller": 0, "epoch": 1,
                "standbys": [1, 2]})
    # Grants for the controller itself and non-standbys are filtered.
    m.apply(2, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 1,
                "leases": {0: 1, 1: 1, 2: 1}})
    assert m.follower_lease(0) is None
    assert m.follower_lease(1) == 1 and m.follower_lease(2) == 1
    # A stale-epoch grant (proposed before a handover committed) is
    # ignored wholesale.
    m.apply(3, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 0, "leases": {1: 0}})
    assert m.current_follower_leases() == {1: 1, 2: 1}
    # Dropping a broker from the standby set drops its lease with it.
    m.apply(4, {"op": OP_SET_STANDBYS, "epoch": 1, "standbys": [2]})
    assert m.current_follower_leases() == {2: 1}


def test_controller_handover_revokes_every_lease():
    m = _mk_manager()
    m.apply(1, {"op": OP_SET_CONTROLLER, "controller": 0, "epoch": 1,
                "standbys": [1, 2]})
    m.apply(2, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 1,
                "leases": {1: 1, 2: 1}})
    m.apply(3, {"op": OP_SET_CONTROLLER, "controller": 1, "epoch": 2,
                "standbys": [0, 2]})
    # Generation fence: the old generation's leases can never authorize
    # serving past the new generation's trim/gap map.
    assert m.current_follower_leases() == {}
    assert m.follower_lease(1) is None and m.follower_lease(2) is None


def test_lease_table_snapshot_round_trip():
    m = _mk_manager()
    m.apply(1, {"op": OP_SET_CONTROLLER, "controller": 0, "epoch": 2,
                "standbys": [1, 2]})
    m.apply(2, {"op": OP_SET_FOLLOWER_LEASES, "epoch": 2,
                "leases": {1: 2, 2: 2}})
    m2 = _mk_manager()
    m2.restore(m.snapshot())
    assert m2.current_follower_leases() == {1: 2, 2: 2}
    assert m2.controller_epoch == 2
    assert m2.follower_lease(1) == 2


# ------------------------------------------------- in-proc integration


def _mk_follower_cluster(tmp_path, name, replication):
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from tests.torch_helpers import InProcCluster
    from ripplemq_tpu_torch.metadata.models import Topic

    config = make_cluster_config(
        n_brokers=3, topics=(Topic("t", 1, 3),),
        replication=replication, follower_reads=True,
    )
    cluster = InProcCluster(config, data_dir=str(tmp_path / name))
    cluster.start()
    cluster.wait_for_leaders()
    assert wait_until(cluster.controller_ready), "no standby joined"
    return cluster


def _producer(cluster):
    from ripplemq_tpu_torch.client import ProducerClient

    boot = [b.address for b in cluster.config.brokers]
    return ProducerClient(boot, transport=cluster.client("prod"),
                          metadata_refresh_s=0.3)


def _leader_log(cluster, n_expect, timeout=30.0):
    """Explicit-offset drain from the partition leader."""
    client = cluster.client("lead-drain")
    msgs, offset = [], 0
    deadline = time.time() + timeout
    while len(msgs) < n_expect and time.time() < deadline:
        lead = cluster.leader_broker("t", 0)
        resp = client.call(lead.addr, {
            "type": "consume", "topic": "t", "partition": 0,
            "consumer": "lead-drain", "offset": offset, "max_messages": 16,
        }, timeout=10.0)
        if not resp.get("ok"):
            time.sleep(0.1)
            continue
        msgs += resp["messages"]
        offset = resp["next_offset"]
        if not resp["messages"]:
            time.sleep(0.05)
    return msgs


def _leased_standby(cluster, timeout=30.0):
    """A broker that is NOT the partition leader and holds a
    current-epoch follower-read lease."""
    leader = cluster.leader_broker("t", 0)

    def find():
        for bid, b in cluster.brokers.items():
            if b is leader or getattr(b, "stopped", False):
                continue
            if b.follower_plane is None:
                continue
            if b.manager.follower_lease(bid) == b.manager.current_epoch():
                return b
        return None

    assert wait_until(lambda: find() is not None, timeout=timeout), \
        "no standby holds a current-epoch follower-read lease"
    return find()


def _follower_drain(cluster, standby, prod, n_expect, timeout=60.0):
    """Explicit-offset drain from a leased standby (follower_ok). The
    settled floor trails the leader's append horizon by a replication
    window, so a refusal at the tail nudges one more produce through —
    the next floor stamp releases the rows already replicated."""
    client = cluster.client("fread")
    msgs, offset, nudge = [], 0, 0
    deadline = time.time() + timeout
    while len(msgs) < n_expect and time.time() < deadline:
        resp = client.call(standby.addr, {
            "type": "consume", "topic": "t", "partition": 0,
            "consumer": "fdrain", "offset": offset, "max_messages": 16,
            "follower_ok": True,
        }, timeout=10.0)
        if resp.get("ok"):
            # A non-leader's ok answer can ONLY come from the follower
            # plane, and it says so.
            assert resp.get("follower") is True, resp
            msgs += resp["messages"]
            offset = resp["next_offset"]
            if resp["messages"]:
                continue
        else:
            err = resp.get("error", "")
            assert err.startswith("not_settled_here:") \
                or "not_leader" in err, resp
        nudge += 1
        try:
            prod.produce("t", f"nudge-{nudge}".encode(), partition=0)
        except Exception:
            pass
        time.sleep(0.1)
    return msgs


@pytest.mark.parametrize("mode", ["full", "striped"])
def test_follower_rows_byte_identical_to_leader(tmp_path, mode):
    """The tentpole's correctness core, on BOTH replication modes: the
    rows a leased standby serves below its settled floor are the very
    bytes the leader serves — full-copy from the repl.rounds cache,
    striped through reconstruct-on-read."""
    cluster = _mk_follower_cluster(tmp_path, f"ident-{mode}", mode)
    try:
        prod = _producer(cluster)
        expect = payloads(40, tag="m")
        for p in expect:
            prod.produce("t", p, partition=0)
        leader_log = _leader_log(cluster, 40)
        assert leader_log[:40] == expect
        standby = _leased_standby(cluster)
        flog = _follower_drain(cluster, standby, prod, 40)
        assert flog[:40] == leader_log[:40]
        st = standby.follower_plane.stats()
        assert st["reads_served"] > 0
        assert st["answers_past_floor"] == 0
        prod.close()
    finally:
        cluster.stop()


def test_follower_refusal_is_typed_and_retryable(tmp_path):
    from ripplemq_tpu_torch.wire.retry import fatal_response_error

    cluster = _mk_follower_cluster(tmp_path, "refuse", "full")
    try:
        prod = _producer(cluster)
        for p in payloads(8):
            prod.produce("t", p, partition=0)
        standby = _leased_standby(cluster)
        client = cluster.client("probe")
        # Wait until the standby serves offset 0 at all (lease + floor).
        assert wait_until(lambda: _follower_drain(
            cluster, standby, prod, 1, timeout=5.0), timeout=45.0)
        resp = client.call(standby.addr, {
            "type": "consume", "topic": "t", "partition": 0,
            "consumer": "probe", "offset": 100_000, "max_messages": 4,
            "follower_ok": True,
        }, timeout=10.0)
        assert resp["ok"] is False
        assert resp["error"].startswith("not_settled_here:")
        # Retryable by the client's wire policy, and the refusal names
        # the leader so the fallback needs no extra metadata round.
        assert not fatal_response_error(resp["error"])
        assert resp.get("leader_addr")
        prod.close()
    finally:
        cluster.stop()


def test_deposed_standby_with_stale_lease_never_serves(tmp_path, monkeypatch):
    """Generation fence, forced deterministically: a standby whose
    lease generation is older than the metadata plane's current epoch
    (the split-brain shape a handover leaves behind) must answer the
    ordinary leader hint — never a follower serve."""
    cluster = _mk_follower_cluster(tmp_path, "fence", "full")
    try:
        prod = _producer(cluster)
        for p in payloads(8):
            prod.produce("t", p, partition=0)
        standby = _leased_standby(cluster)
        # Prove it serves under the valid lease first.
        assert wait_until(lambda: _follower_drain(
            cluster, standby, prod, 1, timeout=5.0), timeout=45.0)
        epoch = standby.manager.current_epoch()
        monkeypatch.setattr(standby.manager, "follower_lease",
                            lambda bid: epoch - 1)
        client = cluster.client("probe")
        resp = client.call(standby.addr, {
            "type": "consume", "topic": "t", "partition": 0,
            "consumer": "probe", "offset": 0, "max_messages": 4,
            "follower_ok": True,
        }, timeout=10.0)
        assert resp["ok"] is False
        assert "follower" not in resp
        # Not even the typed follower refusal: with no valid lease the
        # answer is the plain not-leader hint.
        assert "not_settled_here" not in resp.get("error", "")
        prod.close()
    finally:
        cluster.stop()


# ------------------------------------------------- fixed-seed chaos smokes


def _assert_follower_verdict(verdict):
    from ripplemq_tpu_torch.chaos.nemesis import trace_json

    assert verdict["follower_reads"] is True
    assert verdict["violations"] == [], (
        f"follower-read chaos violations: {verdict['violations']}\n"
        f"trace: {trace_json(verdict['trace'])}\n"
        f"follower: {verdict.get('follower')}"
    )
    f = verdict["follower"]
    assert f["answers_past_floor"] == 0
    assert f["per_broker"], "no broker surfaced a follower stats block"
    assert_chaos_liveness(verdict)


def test_fixed_seed_chaos_smoke_follower_reads():
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=3, phases=2, phase_s=0.4, follower_reads=True)
    _assert_follower_verdict(verdict)


def test_fixed_seed_chaos_smoke_follower_reads_striped():
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=5, phases=2, phase_s=0.4, follower_reads=True,
                        replication_mode="striped")
    _assert_follower_verdict(verdict)


def test_fixed_seed_proc_chaos_smoke_follower_reads():
    """The deployment shape: real broker subprocesses over TCP, SIGKILL
    + disk-fault schedules, follower routing on — zero answers past the
    settled floor."""
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=1, phases=2, phase_s=0.8, ops_per_phase=2,
                        backend="proc", converge_timeout_s=120.0,
                        follower_reads=True)
    assert verdict["backend"] == "proc"
    _assert_follower_verdict(verdict)

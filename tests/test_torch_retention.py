"""The port's DataPlane, CPU twins of the reference's retention tests:
`tests/test_retention.py` (the ring recycles trimmed rows, the round
store serves history, partitions never wedge), `tests/test_store_gc.py`
(size-capped store GC, earliest-reset readers, recovery after GC) and
`tests/test_settled_gap.py` (replication-failed rounds stay invisible on
every read path, across a ring wrap and a boot replay). Same scenarios
and assertions on a port plane built with `device="cpu"`; stores are the
port's. The spmd ring-wrap test's twin is in `tests/test_torch_spmd.py`;
waiting for later slices (ROADMAP.md): the retention ClusterConfig check
and the long-poll park (D)."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from ripplemq_tpu_torch.broker.dataplane import (
    NotCommittedError,
    PartitionFullError,
    recover_image,
)
from ripplemq_tpu_torch.storage.erasure import segment_index_gaps
from ripplemq_tpu_torch.storage.logindex import LogIndex
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore
from ripplemq_tpu_torch.storage.segment import (
    REC_APPEND,
    SegmentStore,
    gc_floor,
    scan_store,
)
from tests.torch_helpers import port_cfg, port_dp, read_all
from tests.torch_port_modules import admit

admit(__name__)

CPU = dict(device="cpu")


def drain_from(dp, slot, start, out):
    """Advance a consumer from `start`, appending messages to `out`;
    returns the next offset."""
    offset = start
    while True:
        got, nxt = dp.read(slot, offset, replica=0)
        if nxt == offset:
            return offset
        out.extend(got)
        offset = nxt


# ------------------------------------------------ tests/test_retention.py


def test_three_laps_with_keeping_up_consumer():
    cfg = port_cfg(slots=64, max_batch=8)
    dp = port_dp(cfg, store=MemoryRoundStore(), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        total = 3 * cfg.slots
        sent, got = [], []
        offset = 0
        for i in range(total):
            m = b"m%04d" % i
            sent.append(m)
            dp.submit_append(0, [m]).result(timeout=30)
            if i % 5 == 4:  # consumer keeps up, reading as it goes
                offset = drain_from(dp, 0, offset, got)
        drain_from(dp, 0, offset, got)
        assert got == sent
        assert int(dp._log_end[0]) >= total  # wrapped the ring twice over
        assert int(dp.trim[0]) > 0
    finally:
        dp.stop()


def test_lagging_consumer_replays_history_from_store():
    cfg = port_cfg(slots=64, max_batch=8)
    dp = port_dp(cfg, store=MemoryRoundStore(), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        sent = []
        for i in range(2 * cfg.slots + 24):
            m = b"h%04d" % i
            sent.append(m)
            dp.submit_append(0, [m]).result(timeout=30)
        assert int(dp.trim[0]) > 0  # history extends below the ring
        got = []
        drain_from(dp, 0, 0, got)
        assert got == sent
    finally:
        dp.stop()


def test_boundary_pad_round_when_batch_cannot_fit():
    cfg = port_cfg(slots=32, max_batch=16)
    dp = port_dp(cfg, store=MemoryRoundStore(), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        first = [b"a%02d" % i for i in range(8)]
        dp.submit_append(0, first).result(timeout=30)          # end=8
        second = [b"b%02d" % i for i in range(16)]
        dp.submit_append(0, second).result(timeout=30)         # end=24
        third = [b"c%02d" % i for i in range(16)]              # 8 rows left
        off3 = dp.submit_append(0, third).result(timeout=30)
        assert off3 == 32  # padded to the boundary, landed at lap start
        got = []
        drain_from(dp, 0, 0, got)
        assert got == first + second + third
    finally:
        dp.stop()


def test_device_read_window_spans_wrap_boundary():
    cfg = port_cfg(slots=64, max_batch=8, read_batch=8)
    dp = port_dp(cfg, store=MemoryRoundStore(), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        sent = []
        for i in range(9):  # 72 rows: end=72, wraps 8 past the boundary
            batch = [b"w%04d" % (8 * i + j) for j in range(8)]
            sent.extend(batch)
            dp.submit_append(0, batch).result(timeout=30)
        got, nxt = dp.read(0, 60, replica=0)
        assert got == sent[60:68]
        assert nxt == 68
    finally:
        dp.stop()


def test_recovery_after_wrap(tmp_path):
    cfg = port_cfg(slots=64, max_batch=8)
    store_dir = str(tmp_path / "segments")
    sent = []
    store = SegmentStore(store_dir)
    dp = port_dp(cfg, store=store, max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        for i in range(2 * cfg.slots + 16):
            m = b"r%04d" % i
            sent.append(m)
            dp.submit_append(0, [m]).result(timeout=30)
        end_before = int(dp._log_end[0])
    finally:
        dp.stop()
        store.close()

    image = recover_image(cfg, store_dir, **CPU)
    assert image is not None
    assert int(image.log_end[0]) == end_before

    store2 = SegmentStore(store_dir)
    dp2 = port_dp(cfg, store=store2, max_retry_rounds=3)
    dp2.install(image)
    dp2.start()
    try:
        dp2.set_leader(0, 0, 1)
        assert int(dp2.trim[0]) == end_before - cfg.slots
        got = []
        drain_from(dp2, 0, 0, got)
        assert got == sent
        off = dp2.submit_append(0, [b"post-recovery"]).result(timeout=30)
        assert off == end_before
        tail = []
        drain_from(dp2, 0, end_before, tail)
        assert tail == [b"post-recovery"]
    finally:
        dp2.stop()
        store2.close()


def test_bounded_index_falls_back_to_store_scan():
    cfg = port_cfg(slots=64, max_batch=8)
    dp = port_dp(cfg, store=MemoryRoundStore(), max_retry_rounds=3)
    dp.log_index = LogIndex(max_entries_per_slot=4)  # force the floor low
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        sent = []
        for i in range(2 * cfg.slots):
            m = b"f%04d" % i
            sent.append(m)
            dp.submit_append(0, [m]).result(timeout=30)
        assert dp.log_index.floor(0) > 0  # entries fell out of the index
        assert int(dp.trim[0]) > dp.log_index.floor(0) - cfg.slots
        got = []
        drain_from(dp, 0, 0, got)
        assert got == sent
    finally:
        dp.stop()


def test_pad_round_quorum_outage_fails_cleanly():
    cfg = port_cfg(slots=32, max_batch=16, replicas=3)
    dp = port_dp(cfg, store=MemoryRoundStore(), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        dp.submit_append(0, [b"x"] * 8).result(timeout=30)  # end=8: 24 left
        dp.submit_append(0, [b"y"] * 16).result(timeout=30)  # end=24
        alive = np.ones((cfg.partitions, cfg.replicas), bool)
        alive[:, 1:] = False  # only the leader left: no quorum
        dp.set_alive(alive)
        with pytest.raises(NotCommittedError):
            dp.submit_append(0, [b"z"] * 16).result(timeout=30)
    finally:
        dp.stop()


def test_storeless_dataplane_still_backpressures():
    dp = port_dp(port_cfg(slots=8, max_batch=8), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        assert dp.submit_append(0, [b"x"] * 8).result(timeout=10) == 0
        with pytest.raises(PartitionFullError):
            dp.submit_append(0, [b"y"]).result(timeout=10)
    finally:
        dp.stop()


# ------------------------------------------------- tests/test_store_gc.py


def _seg_names(d):
    return sorted(f for f in os.listdir(d)
                  if f.startswith("segment-") and f.endswith(".log"))


def test_gc_deletes_oldest_and_persists_floor(tmp_path):
    d = str(tmp_path / "s")
    store = SegmentStore(d, segment_bytes=4096, retention_bytes=8192)
    for i in range(200):
        store.append(1, 0, i * 8, bytes([i % 251]) * 900)
    store.flush()
    deleted = store.gc()
    assert deleted == sorted(deleted) and deleted[0] == 0
    names = _seg_names(d)
    sealed_total = sum(
        os.path.getsize(os.path.join(d, n)) for n in names[:-1]
    )
    assert sealed_total <= 8192
    assert gc_floor(d) == max(deleted) + 1
    assert not segment_index_gaps(d)
    bases = [b for _, _, b, _ in scan_store(d)]
    assert bases == sorted(bases)
    store.close()


def test_gc_never_touches_active_segment(tmp_path):
    d = str(tmp_path / "s")
    store = SegmentStore(d, segment_bytes=1 << 20, retention_bytes=2 << 20)
    store.append(1, 0, 0, b"x" * 100)
    store.flush()
    assert store.gc() == []  # one active segment, nothing sealed
    assert _seg_names(d)  # still there
    store.close()


def test_lagging_consumer_jumps_to_earliest_retained(tmp_path):
    cfg = port_cfg(slots=64, max_batch=8)
    d = str(tmp_path / "s")
    store = SegmentStore(d, segment_bytes=4096, retention_bytes=8192)
    dp = port_dp(cfg, store=store)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        sent = []
        for i in range(3 * cfg.slots):
            m = b"g%04d" % i
            sent.append((i, m))
            dp.submit_append(0, [m]).result(timeout=30)
        deleted = store.gc()
        assert deleted, "GC should have removed sealed segments"
        dp.drop_index_segments(set(deleted))
        got = read_all(dp, 0)
        assert got, "nothing served after GC"
        first = next(i for i, m in sent if m == got[0])
        assert got == [m for _, m in sent[first:]]
        assert first > 0  # something was genuinely reclaimed
    finally:
        dp.stop()
        store.close()


def test_read_survives_gc_race_without_manual_pruning(tmp_path):
    cfg = port_cfg(slots=64, max_batch=8)
    d = str(tmp_path / "s")
    store = SegmentStore(d, segment_bytes=4096, retention_bytes=8192)
    dp = port_dp(cfg, store=store)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        sent = []
        for i in range(3 * cfg.slots):
            m = b"z%04d" % i
            sent.append((i, m))
            dp.submit_append(0, [m]).result(timeout=30)
        assert store.gc()
        # NO drop_index_segments: the read path must recover on its own.
        got = read_all(dp, 0)
        first = next(i for i, m in sent if m == got[0])
        assert got == [m for _, m in sent[first:]]
    finally:
        dp.stop()
        store.close()


def test_recovery_after_gc(tmp_path):
    cfg = port_cfg(slots=64, max_batch=8)
    d = str(tmp_path / "s")
    store = SegmentStore(d, segment_bytes=4096, retention_bytes=8192)
    dp = port_dp(cfg, store=store)
    dp.start()
    dp.set_leader(0, 0, 1)
    for i in range(2 * cfg.slots):
        dp.submit_append(0, [b"r%04d" % i]).result(timeout=30)
    end_before = int(dp._log_end[0])
    assert store.gc()
    dp.stop()
    store.close()

    image = recover_image(cfg, d, **CPU)
    assert image is not None
    assert int(image.log_end[0]) == end_before
    store2 = SegmentStore(d, segment_bytes=4096, retention_bytes=8192)
    dp2 = port_dp(cfg, store=store2)
    dp2.install(image)
    dp2.start()
    try:
        dp2.set_leader(0, 0, 1)
        assert dp2.submit_append(0, [b"post"]).result(timeout=30) == end_before
    finally:
        dp2.stop()
        store2.close()


def test_read_terminates_when_all_of_a_slots_history_is_gcd(tmp_path):
    cfg = port_cfg(partitions=2, slots=32, max_batch=8)
    d = str(tmp_path / "s")
    store = SegmentStore(d, segment_bytes=4096, retention_bytes=8192)
    dp = port_dp(cfg, store=store)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        dp.set_leader(1, 0, 1)
        sent0 = []
        for i in range(96):  # slot 0 wraps (trim > 0), then goes idle
            m = b"s0-%03d" % i
            sent0.append(m)
            dp.submit_append(0, [m]).result(timeout=30)
        assert int(dp.trim[0]) > 0
        for i in range(400):  # slot 1 seals enough segments for GC
            dp.submit_append(1, [b"s1-%03d" % i + b"x" * 12]).result(timeout=30)
        deleted = store.gc()
        assert deleted
        dp.drop_index_segments(set(deleted))
        assert dp.log_index.floor(0) is None  # slot 0's records all gone

        result: list = []

        def reader():
            result.append(read_all(dp, 0))

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "read() never terminated"
        got = result[0]
        # Earliest-reset to the ring: a contiguous suffix of slot 0.
        assert got and got == sent0[sent0.index(got[0]):]
    finally:
        dp.stop()
        store.close()


# ---------------------------------------------- tests/test_settled_gap.py


class FailAtBaseReplicator:
    """begin/wait replicator that acks instantly except rounds carrying
    an append record at one of `bad_bases` — their wait raises a
    transient NotCommittedError (standby loss mid-round, not a fencing
    event, so later rounds keep settling). The reference raises its
    ReplicationError, a NotCommittedError that is not a FencedError;
    that class comes with slice D."""

    def __init__(self, bad_bases) -> None:
        self.bad_bases = set(bad_bases)
        self.failed: list[int] = []
        self._lock = threading.Lock()

    def begin(self, records):
        return records

    def wait(self, ticket) -> None:
        bad = [
            rec[2] for rec in ticket
            if rec[0] == REC_APPEND and rec[2] in self.bad_bases
        ]
        if bad:
            with self._lock:
                self.failed.extend(bad)
            raise NotCommittedError(
                f"standby lost under round at base {bad} (injected)"
            )

    def replicate(self, records) -> None:
        self.wait(self.begin(records))


def _attach(dp, rep):
    dp.replicate_fn = rep.replicate
    dp.replicate_begin_fn = rep.begin
    dp.replicate_wait_fn = rep.wait
    dp.start()
    dp.set_leader(0, 0, 1)
    return dp


def _read_walk(dp, slot: int = 0, start: int = 0):
    """Walk the full readable log; returns (messages, offsets_seen)."""
    msgs, offs, offset = [], [], start
    for _ in range(1000):
        got, nxt = dp.read(slot, offset, replica=0)
        msgs.extend(got)
        offs.append((offset, nxt, list(got)))
        if nxt == offset:
            return msgs, offs
        offset = nxt
    raise AssertionError(f"read walk never terminated: {offs[-5:]}")


def test_failed_round_below_later_settled_round_is_not_readable():
    rep = FailAtBaseReplicator(bad_bases={8})
    dp = _attach(port_dp(port_cfg(partitions=2), coalesce_s=0.0), rep)
    try:
        assert dp.submit_append(0, [b"ok-1"]).result(timeout=10) == 0
        bad = dp.submit_append(0, [b"BAD-1", b"BAD-2"])
        with pytest.raises(NotCommittedError):
            bad.result(timeout=10)
        assert rep.failed == [8]
        assert dp.submit_append(0, [b"ok-2"]).result(timeout=10) == 16
        assert dp.settled_end(0) == 24
        assert dp.settled_gap_slots() == 1
        msgs, offs = _read_walk(dp)
        assert b"BAD-1" not in msgs and b"BAD-2" not in msgs, (
            f"nacked rows served below a later settled round: {offs}"
        )
        assert msgs == [b"ok-1", b"ok-2"]
        got, nxt = dp.read(0, 8, replica=0)
        assert got == [b"ok-2"] and nxt == 24
    finally:
        dp.stop()


def test_failed_round_gap_survives_ring_wrap_and_boot_replay(tmp_path):
    cfg = port_cfg(partitions=2)  # slots=64, max_batch=8
    d = str(tmp_path / "store")
    rep = FailAtBaseReplicator(bad_bases={72})
    store = SegmentStore(d, use_native=False)
    dp = _attach(port_dp(cfg, store=store, flush_interval_s=0.0,
                         coalesce_s=0.0), rep)
    expect: list[bytes] = []
    try:
        for i in range(12):  # bases 0..88; base 72 fails, ring wraps at 64
            batch = [b"r%02d-%d" % (i, j) for j in range(8)]
            fut = dp.submit_append(0, batch)
            if i == 9:  # base 72: replication fails, producer nacked
                with pytest.raises(NotCommittedError):
                    fut.result(timeout=10)
            else:
                assert fut.result(timeout=10) == i * 8
                expect.extend(batch)
        assert rep.failed == [72]
        assert dp.settled_end(0) == 96
        msgs, offs = _read_walk(dp)
        assert not any(m.startswith(b"r09-") for m in msgs), (
            f"nacked rows of the wrapped failed round served: {offs}"
        )
        assert msgs == expect, f"wrong rows through the gap: {offs}"
    finally:
        dp.stop()
        store.close()

    gaps: dict = {}
    image = recover_image(cfg, d, gaps_out=gaps, **CPU)
    assert image is not None
    store2 = SegmentStore(d, use_native=False)
    dp2 = port_dp(cfg, store=store2, flush_interval_s=0.0)
    dp2.install(image, settled_gaps=gaps)
    dp2.start()
    try:
        assert dp2.settled_gap_slots() == 1
        got, nxt = dp2.read(0, 72, replica=0)
        assert got and not any(m.startswith(b"r09-") for m in got), (
            f"boot replay served rows inside the settled gap: {got!r}"
        )
        assert all(m.startswith(b"r10-") for m in got), (
            f"wrong-lap rows at the gap's offsets: {got!r}"
        )
        msgs, offs = _read_walk(dp2)
        assert msgs == expect, f"recovered log diverges: {offs}"
    finally:
        dp2.stop()
        store2.close()


def test_gap_recorded_even_when_nothing_later_settles():
    rep = FailAtBaseReplicator(bad_bases={0})
    dp = _attach(port_dp(port_cfg(partitions=2), coalesce_s=0.0), rep)
    try:
        with pytest.raises(NotCommittedError):
            dp.submit_append(0, [b"BAD"]).result(timeout=10)
        assert dp.settled_end(0) == 0
        got, nxt = dp.read(0, 0, replica=0)
        assert got == []
        assert nxt in (0, 8)
    finally:
        dp.stop()

"""The port's DataPlane, CPU twins of the reference's DataPlane-only tests:
`tests/test_dataplane.py` (batched rounds, futures, retries, elections,
liveness masks), `tests/test_term_skew.py`'s stall streak and the
DataPlane units of `tests/test_idempotence.py` (producer dedup and its
boot-replay recovery). Same scenarios, same assertions, on a port plane
built with `device="cpu"` at `small_cfg()`'s shape. The reference's
tests of the broker, `PartitionManager` and the client wait for slice D
(ROADMAP.md)."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from ripplemq_tpu_torch.broker import dataplane
from ripplemq_tpu_torch.broker.dataplane import (
    DataPlane,
    NotCommittedError,
    PartitionFullError,
    recover_image,
)
from ripplemq_tpu_torch.ops.rs import indexed_device
from ripplemq_tpu_torch.storage.segment import SegmentStore
from tests.torch_helpers import port_cfg, port_dp, read_all
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture()
def dp():
    plane = port_dp(port_cfg(), max_retry_rounds=3)
    plane.start()
    yield plane
    plane.stop()


# ------------------------------------------------ tests/test_dataplane.py


def test_append_commits_and_assigns_offsets(dp):
    dp.set_leader(0, 0, 1)
    f1 = dp.submit_append(0, [b"m0", b"m1"])
    f2 = dp.submit_append(0, [b"m2"])
    assert f1.result(timeout=10) == 0
    # f2 either coalesced into f1's round (offset 2) or rode the next
    # ALIGN-padded round (offset 8) — both are valid storage layouts.
    assert f2.result(timeout=10) in (2, 8)
    assert read_all(dp, 0) == [b"m0", b"m1", b"m2"]
    assert dp.commit_index(0) in (8, 16)


def test_log_end_locked_accessor(dp):
    assert dp.log_end(0) == 0
    dp.set_leader(0, 0, 1)
    dp.submit_append(0, [b"a", b"b"]).result(timeout=10)
    end = dp.log_end(0)
    assert end >= 2  # ALIGN-padded round: at least the two records
    with dp._lock:  # white-box: the accessor mirrors the shadow exactly
        assert end == int(dp._log_end[0])


def test_many_submitters_coalesce_into_rounds(dp):
    dp.set_leader(1, 2, 1)
    futs = [dp.submit_append(1, [f"m{i}".encode()]) for i in range(50)]
    offsets = [f.result(timeout=20) for f in futs]
    assert len(set(offsets)) == 50
    msgs = read_all(dp, 1, replica=2)
    assert msgs == [f"m{i}".encode() for i in range(50)]
    assert dp.rounds < 50


def test_offsets_replicate_with_quorum(dp):
    dp.set_leader(2, 0, 1)
    dp.submit_append(2, [b"x"]).result(timeout=10)
    assert dp.submit_offsets(2, [(3, 1)]).result(timeout=10) is True
    assert dp.read_offset(2, 3) == 1


def test_no_leader_fails_after_retries(dp):
    f = dp.submit_append(3, [b"m"])  # no leader set for slot 3
    with pytest.raises(NotCommittedError):
        f.result(timeout=20)


def test_dead_majority_blocks_commit_then_recovery(dp):
    dp.set_leader(0, 0, 1)
    alive = np.ones((dp.cfg.partitions, dp.cfg.replicas), bool)
    alive[0, 1] = alive[0, 2] = False  # only the leader replica lives
    dp.set_alive(alive)
    with pytest.raises(NotCommittedError):
        dp.submit_append(0, [b"m"]).result(timeout=20)
    dp.set_alive(np.ones((dp.cfg.partitions, dp.cfg.replicas), bool))
    assert dp.submit_append(0, [b"m"]).result(timeout=10) == 0


def test_per_partition_alive_masks_are_independent(dp):
    alive = np.ones((dp.cfg.partitions, dp.cfg.replicas), bool)
    alive[1, 0] = alive[1, 1] = False  # partition 1 lost its quorum
    dp.set_alive(alive)
    dp.set_leader(0, 0, 1)
    dp.set_leader(1, 2, 1)
    ok = dp.submit_append(0, [b"fine"])
    bad = dp.submit_append(1, [b"stuck"])
    assert ok.result(timeout=10) == 0
    with pytest.raises(NotCommittedError):
        bad.result(timeout=20)


def test_batched_election_round(dp):
    winners = dp.elect({0: (1, 1), 2: (0, 1)})
    assert winners == {0: True, 2: True}
    # Stale term loses.
    dp.set_leader(0, 1, 1)
    dp.submit_append(0, [b"m"])  # bumps replica current_term to 1 via round
    losers = dp.elect({0: (2, 0)})
    assert losers[0] is False


def test_validation_errors_are_immediate(dp):
    with pytest.raises(ValueError):
        dp.submit_append(999, [b"m"]).result(timeout=1)
    with pytest.raises(ValueError):
        dp.submit_append(0, []).result(timeout=1)
    with pytest.raises(ValueError):
        dp.submit_append(0, [b"x" * 1000]).result(timeout=1)
    with pytest.raises(ValueError):
        dp.submit_append(0, [b""]).result(timeout=1)  # empty = padding marker
    with pytest.raises(ValueError):
        dp.submit_append(0, [b"x"] * 100).result(timeout=1)
    with pytest.raises(ValueError):
        dp.submit_offsets(0, [(999, 1)]).result(timeout=1)


def test_concurrent_submitters_from_threads(dp):
    dp.set_leader(0, 0, 1)
    dp.set_leader(1, 0, 1)
    results = {}

    def worker(i):
        slot = i % 2
        results[i] = dp.submit_append(slot, [f"t{i}".encode()]).result(timeout=20)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(20)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 20
    for slot in (0, 1):
        offs = [v for k, v in results.items() if k % 2 == slot]
        assert len(set(offs)) == 10
        assert len(read_all(dp, slot)) == 10


def test_resync_recovers_lagging_replica(dp):
    dp.set_leader(0, 0, 2)
    alive = np.ones((dp.cfg.partitions, dp.cfg.replicas), bool)
    alive[0, 2] = False
    dp.set_alive(alive)
    dp.submit_append(0, [b"a", b"b"]).result(timeout=10)
    # Replica 2 comes back empty; resync from leader slot 0, then it acks.
    dp.resync(0, 2, [0])
    dp.set_alive(np.ones((dp.cfg.partitions, dp.cfg.replicas), bool))
    dp.submit_append(0, [b"c"]).result(timeout=10)
    assert read_all(dp, 0, replica=2) == [b"a", b"b", b"c"]


def test_partition_full_is_terminal_backpressure():
    dp = port_dp(port_cfg(slots=8, max_batch=8), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        assert dp.submit_append(0, [b"x"] * 8).result(timeout=10) == 0
        with pytest.raises(PartitionFullError):
            dp.submit_append(0, [b"y"]).result(timeout=10)
    finally:
        dp.stop()


def test_offsets_commit_on_full_partition():
    dp = port_dp(port_cfg(slots=8, max_batch=8), max_retry_rounds=3)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        dp.submit_append(0, [b"x"] * 8).result(timeout=10)  # log now full
        assert dp.submit_offsets(0, [(2, 8)]).result(timeout=10) is True
        assert dp.read_offset(0, 2) == 8
    finally:
        dp.stop()


def test_oversized_offset_update_rejected_immediately(dp):
    with pytest.raises(ValueError):
        dp.submit_offsets(0, [(1, 1)] * 99).result(timeout=1)


# ------------------------------ tests/test_term_skew.py (the plane probe)


def test_stalled_slots_streak_and_reset():
    dp = port_dp(port_cfg(partitions=1, replicas=3), coalesce_s=0.0,
                 max_retry_rounds=4)
    dp.start()
    dp.set_leader(0, 0, 1)
    try:
        # Quorum 2 of 3 unreachable: every round fails to commit.
        dp.set_alive(np.array([[True, False, False]]))
        with pytest.raises(NotCommittedError):
            dp.submit_append(0, [b"x"]).result(timeout=10)
        assert dp.stalled_slots(threshold=dp.max_retry_rounds) == [0]
        # Default threshold is 2x the per-submit retry budget.
        assert dp.stalled_slots() == []
        with pytest.raises(NotCommittedError):
            dp.submit_append(0, [b"y"]).result(timeout=10)
        assert dp.stalled_slots() == [0]
        # set_leader clears the streak...
        dp.set_leader(0, 0, 2)
        assert dp.stalled_slots(threshold=1) == []
        # ...and a committed round keeps it clear.
        dp.set_alive(np.ones((1, 3), bool))
        assert dp.submit_append(0, [b"z"]).result(timeout=10) == 0
        assert dp.stalled_slots(threshold=1) == []
    finally:
        dp.stop()


# ----------------------- tests/test_idempotence.py (the DataPlane units)


def test_replayed_sequence_acks_with_original_base(dp):
    dp.set_leader(0, 0, 1)
    base = dp.submit_append(0, [b"a", b"b"], pid=7, seq=0).result(timeout=10)
    dup = dp.submit_append(0, [b"a", b"b"], pid=7, seq=0).result(timeout=10)
    assert dup == base
    assert read_all(dp, 0) == [b"a", b"b"]
    nxt = dp.submit_append(0, [b"c"], pid=7, seq=2).result(timeout=10)
    assert nxt > base
    assert read_all(dp, 0) == [b"a", b"b", b"c"]
    assert dp.pid_table_size() == 1


def test_duplicate_below_window_acks_with_unknown_base(dp):
    dp.set_leader(1, 0, 1)
    dp.submit_append(1, [b"x"], pid=9, seq=0).result(timeout=10)
    dp.submit_append(1, [b"y"], pid=9, seq=1).result(timeout=10)
    got = dp.submit_append(1, [b"x", b"y"], pid=9, seq=0).result(timeout=10)
    assert got == -1
    assert read_all(dp, 1) == [b"x", b"y"]


def test_sequence_gap_is_accepted_as_new(dp):
    dp.set_leader(2, 0, 1)
    dp.submit_append(2, [b"a"], pid=3, seq=0).result(timeout=10)
    dp.submit_append(2, [b"later"], pid=3, seq=100).result(timeout=10)
    assert read_all(dp, 2) == [b"a", b"later"]


def test_concurrent_duplicate_attaches_to_inflight_round(dp):
    dp.set_leader(3, 0, 1)
    f1 = dp.submit_append(3, [b"w"], pid=5, seq=0)
    f2 = dp.submit_append(3, [b"w"], pid=5, seq=0)
    assert f2 is f1  # attached, not re-queued
    assert f1.result(timeout=10) == f2.result(timeout=10)
    assert read_all(dp, 3) == [b"w"]


def test_failed_round_clears_inflight_so_retry_reappends():
    dp = port_dp(port_cfg(), max_retry_rounds=2)
    dp.start()
    try:
        with pytest.raises(NotCommittedError):
            dp.submit_append(0, [b"r"], pid=4, seq=0).result(timeout=30)
        dp.set_leader(0, 0, 1)
        assert dp.submit_append(0, [b"r"], pid=4, seq=0).result(
            timeout=10
        ) == 0
        assert read_all(dp, 0) == [b"r"]
    finally:
        dp.stop()


def test_boot_replay_rebuilds_dedup_table(tmp_path):
    cfg = port_cfg()
    store = SegmentStore(str(tmp_path / "segments"), use_native=False)
    dp = port_dp(cfg, store=store)
    dp.start()
    dp.set_leader(0, 0, 1)
    base = dp.submit_append(0, [b"once"], pid=11, seq=0).result(timeout=10)
    dp.stop()
    store.close()

    store2 = SegmentStore(str(tmp_path / "segments"), use_native=False)
    pid_tab = {}
    image = recover_image(cfg, str(tmp_path / "segments"),
                          use_native=False, pid_tab_out=pid_tab,
                          device="cpu")
    assert (11, 0) in pid_tab, pid_tab
    dp2 = port_dp(cfg, store=store2)
    dp2.install(image, pid_table=pid_tab)
    dp2.start()
    try:
        dp2.set_leader(0, 0, 2)
        dup = dp2.submit_append(0, [b"once"], pid=11, seq=0).result(
            timeout=10
        )
        assert dup == base
        assert read_all(dp2, 0) == [b"once"]
        assert dp2.pid_table_size() == 1
    finally:
        dp2.stop()
        store2.close()


# ------------------------------------------------ the port's own contract


def test_warm_dispatches_noop_rounds_and_leaves_state_unchanged():
    """warm() runs the single and chained rounds at each bucket and the
    batched read through the staged inputs; nothing commits."""
    from ripplemq_tpu_torch import convert

    dp = port_dp(port_cfg(), chain_depth=4)
    before = convert.state_to_numpy(dp._state)
    dp.warm(buckets=(1, 8, 32))
    after = convert.state_to_numpy(dp._state)
    for leaf in before:
        np.testing.assert_array_equal(after[leaf], before[leaf], leaf)
    dp.stop()


def test_postmortem_reads_the_device_scalars(dp):
    dp.set_leader(0, 0, 1)
    dp.submit_append(0, [b"pm"]).result(timeout=10)
    pm = dp.postmortem()
    assert pm["device_error"] is None
    assert pm["device_log_ends"] == dp.log_ends().max(axis=0).tolist()
    assert pm["device_current_terms"] == dp.current_terms().tolist()
    assert pm["device_commit"][0] == dp.commit_index(0) == 8
    assert pm["host_log_end"][0] == pm["settled_end"][0] == 8
    assert pm["term_skew_slots"] == []


def test_spmd_mode_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="slice F"):
        DataPlane(port_cfg(), mode="spmd", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        DataPlane(port_cfg(), mode="bogus", device="cpu")


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as lying on CUDA device 0 and cannot be
    pinned: the stand-in for a tensor already on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    def pin_memory(self, *args, **kwargs):
        raise AssertionError("pinned a tensor that is already on the card")


def test_stage_leaves_a_tensor_on_the_plane_device_alone(monkeypatch):
    """`_stage` hands back a tensor already on the plane's device as it
    is: on the CPU, and on a CUDA device compared by type and index (a
    tensor's device always carries its index; `torch.device("cuda")`
    equals no indexed device, so the plane indexes its own)."""
    t = torch.arange(4)
    assert dataplane._stage(t, torch.device("cpu")) is t
    x = torch.arange(4).as_subclass(_OnCard)
    assert dataplane._stage(x, torch.device("cuda", 0)) is x
    assert dataplane._stage(x, torch.device("cuda:0")) is x
    assert torch.device("cuda") != torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    plane_device = indexed_device("cuda")  # the plane's device, as built
    assert plane_device == torch.device("cuda", 0)
    assert dataplane._stage(x, plane_device) is x
    assert dataplane._stage(x, torch.device("cuda")) is x
    assert indexed_device("cuda:1") == torch.device("cuda", 1)
    assert indexed_device("cpu") == torch.device("cpu")
    assert port_dp(port_cfg()).device == torch.device("cpu")

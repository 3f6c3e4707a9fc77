"""Process-level chaos (tier-1 gate).

The fixed-seed smoke boots REAL `python -m ripplemq_tpu_torch.broker`
subprocesses over TCP with on-disk stores and drives seeded
SIGKILL/restart + disk-fault schedules through the same end-to-end
safety checker as the in-proc chaos plane — the deployment shape,
attacked deterministically. The open-ended randomized soak (and the
correlated full-cluster kill drill) live in
test_torch_proc_chaos_soak.py (slow).

Also here, cheap and fast: proc-backend schedule purity, the
disk-ops-only-on-crashed-brokers rule, and the `durability=strict`
knob's synchronous-flush contract at both flush sites.

Twin of `tests/test_proc_chaos.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import pytest

from ripplemq_tpu_torch.chaos.nemesis import (
    expected_trace,
    make_schedule,
    trace_json,
)
from tests.helpers import assert_chaos_liveness
from tests.torch_port_modules import admit

admit(__name__)

PROC_SMOKE_SEEDS = (0, 1)
PHASES = 2


@pytest.mark.parametrize("seed", PROC_SMOKE_SEEDS)
def test_fixed_seed_proc_chaos_smoke(seed):
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=seed, phases=PHASES, phase_s=0.8,
                        ops_per_phase=2, backend="proc",
                        converge_timeout_s=120.0,
                        include_postmortems=True, include_timeline=True)
    assert verdict["violations"] == [], (
        f"seed {seed} safety violations: {verdict['violations']}\n"
        f"trace: {trace_json(verdict['trace'])}\n"
        f"disk faults: {verdict['disk_faults']}"
    )
    # Convergence gated on the documented contention flake class
    # (semantic gate: safety clean + full final drain — see
    # helpers.assert_chaos_liveness for the recorded signature).
    assert_chaos_liveness(verdict)
    assert verdict["backend"] == "proc"
    assert verdict["counts"]["produce_ok"] > 0
    assert sum(verdict["final_log_sizes"].values()) > 0
    # Byte-for-byte reproducibility holds for the proc pool too.
    sched = make_schedule(seed, [0, 1, 2], PHASES, ops_per_phase=2,
                          backend="proc")
    assert trace_json(verdict["trace"]) == trace_json(expected_trace(sched))
    # Telemetry-plane acceptance on the PROCESS backend: the postmortem
    # bundles traveled over real TCP from real broker subprocesses (the
    # RPC surface, not an in-proc reach-in), and the merged timeline
    # carries both nemesis fault ops and broker lifecycle events.
    assert verdict["postmortems"], "no postmortem bundles collected"
    for bid, pm in verdict["postmortems"].items():
        assert pm["ok"] and pm["broker"] == int(bid)
        assert "metrics" in pm and "trace" in pm
    assert any(pm["engine"] is not None
               for pm in verdict["postmortems"].values())
    assert any(e.get("src") == "nemesis" for e in verdict["timeline"])
    assert any(str(e.get("src", "")).startswith("broker")
               for e in verdict["timeline"])


def test_proc_schedule_purity_and_disk_op_targets():
    """The proc pool's schedules are pure functions of the seed, never
    crash a metadata majority, and only damage disks of brokers the
    same phase already crashed (you cannot corrupt a live process's
    store and call the outcome a recovery drill)."""
    for seed in range(30):
        a = make_schedule(seed, [0, 1, 2], phases=3, ops_per_phase=3,
                          backend="proc")
        b = make_schedule(seed, [0, 1, 2], phases=3, ops_per_phase=3,
                          backend="proc")
        assert a == b
        for ops in a:
            crashed = set()
            for op in ops:
                if op["op"] == "crash":
                    crashed.add(op["broker"])
                elif op["op"].startswith("disk_"):
                    assert op["broker"] in crashed, (seed, ops)
                    assert "salt" in op  # deterministic injection
                else:
                    pytest.fail(f"non-proc op in proc schedule: {op}")
            assert len(crashed) <= 1, (seed, ops)  # (3-1)//2
    # The pools genuinely differ: proc schedules carry disk ops.
    assert any(
        op["op"].startswith("disk_")
        for seed in range(10)
        for ops in make_schedule(seed, [0, 1, 2], 3, ops_per_phase=3,
                                 backend="proc")
        for op in ops
    )


# ------------------------------------------------------ durability=strict

class _SpyStore:
    """Minimal round store recording flush calls (no scan_indexed, so
    the plane runs index-less — persist path only)."""

    def __init__(self) -> None:
        self.records: list = []
        self.flushes = 0
        self.async_flushes = 0

    def append_many(self, records):
        self.records.extend(records)
        return [None] * len(records)

    def append(self, *rec):
        self.records.append(rec)
        return None

    def flush(self) -> None:
        self.flushes += 1

    def flush_async(self) -> None:
        self.async_flushes += 1


def test_strict_durability_flushes_synchronously_per_round():
    from ripplemq_tpu_torch.broker.dataplane import DataPlane
    from tests.torch_helpers import port_cfg as small_cfg

    spy = _SpyStore()
    dp = DataPlane(small_cfg(partitions=2), mode="local", store=spy,
                   device="cpu",
                   flush_interval_s=0.0, coalesce_s=0.0,
                   durability="strict")
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        assert dp.submit_append(0, [b"a"]).result(timeout=10) == 0
        assert spy.flushes >= 1, "strict settle must fsync before the ack"
        assert spy.async_flushes == 0, "strict must not ride the flusher"
    finally:
        dp.stop()


def test_async_durability_uses_the_flusher():
    from ripplemq_tpu_torch.broker.dataplane import DataPlane
    from tests.torch_helpers import port_cfg as small_cfg

    spy = _SpyStore()
    dp = DataPlane(small_cfg(partitions=2), mode="local", store=spy,
                   device="cpu",
                   flush_interval_s=0.0, coalesce_s=0.0)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        assert dp.submit_append(0, [b"a"]).result(timeout=10) == 0
        assert spy.async_flushes >= 1
        assert spy.flushes == 0  # only stop()'s barrier flushes inline
    finally:
        dp.stop()


def test_strict_durability_on_standby_ack_path():
    """The repl.rounds handler (whose ack gates the controller's settle
    release) flushes synchronously under durability=strict."""
    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from ripplemq_tpu_torch.wire import InProcNetwork

    config = make_cluster_config(2, durability="strict")
    b1 = BrokerServer(1, config, net=InProcNetwork(), device="cpu")
    try:
        spy = _SpyStore()
        b1._round_store = spy
        resp = b1._handle_repl_rounds(
            {"epoch": 0, "records": [[1, 0, 0, b"row-bytes"]]}
        )
        assert resp["ok"], resp
        assert spy.flushes == 1 and spy.async_flushes == 0
        assert len(spy.records) == 1
    finally:
        b1._stopped = True  # never started: skip the full teardown


def test_durability_knob_validation():
    from ripplemq_tpu_torch.broker.dataplane import DataPlane
    from ripplemq_tpu_torch.metadata.cluster_config import parse_cluster_config
    from tests.torch_helpers import port_cfg as small_cfg

    with pytest.raises(ValueError):
        DataPlane(small_cfg(), mode="local", durability="eventually",
                  device="cpu")
    cfg = parse_cluster_config({
        "brokers": [{"id": 0, "port": 9000}],
        "topics": [{"name": "t", "partitions": 1,
                    "replication_factor": 1}],
        "durability": "strict",
    })
    assert cfg.durability == "strict"
    with pytest.raises(ValueError):
        parse_cluster_config({
            "brokers": [{"id": 0, "port": 9000}],
            "topics": [{"name": "t", "partitions": 1,
                        "replication_factor": 1}],
            "durability": "nope",
        })


def test_checker_loss_grace_windows():
    """The checker's durability accounting: acked produces inside a
    grace window (the one-flush-interval lag after a correlated
    full-cluster kill) are exempt from the no-loss check; everything
    outside stays absolute, and phantoms are never excused."""
    from ripplemq_tpu_torch.chaos.history import check_history

    ops = [
        {"op": "produce", "client": "p", "topic": "t", "partition": 0,
         "payload": "old", "status": "ok", "t": 100.0},
        {"op": "produce", "client": "p", "topic": "t", "partition": 0,
         "payload": "late", "status": "ok", "t": 109.9},
    ]
    # Both lost, kill at t=110, 1 s flush-lag window: only "late" is
    # excused.
    v = check_history(ops, {("t", 0): []}, loss_grace=[(109.0, 110.0)])
    assert len(v) == 1 and "'old'" in v[0]
    # No window: both are violations (the while-any-quorum-member-
    # survives contract).
    assert len(check_history(ops, {("t", 0): []})) == 2

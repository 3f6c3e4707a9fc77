"""Producer-id expiry (the pid registry no longer grows forever): pids
get sessions/retention like groups — the metadata
leader reaps pids idle past pid_retention_s through a replicated op
whose apply re-checks idleness, broker dedup tables drop reaped
entries, and `producer_ids` / `pid_table_size` in admin.stats stop
growing monotonically under client churn.

Twin of `tests/test_pid_expiry.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import time

import pytest

from ripplemq_tpu_torch.broker.manager import (
    OP_REGISTER_PRODUCER,
    OP_RETIRE_PRODUCER,
    PartitionManager,
)
from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
from ripplemq_tpu_torch.client import ProducerClient
from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, wait_until
from tests.torch_port_modules import admit

admit(__name__)


# ------------------------------------------------------- apply units

def _mgr():
    return PartitionManager(0, make_cluster_config(3))


def test_reregistration_bumps_the_replicated_seen_counter():
    m = _mgr()
    m.apply(1, {"op": OP_REGISTER_PRODUCER, "producer": "p"})
    pid = m.producer_id("p")
    assert pid is not None
    assert m.producer_sessions()["p"] == (pid, 1)
    m.apply(2, {"op": OP_REGISTER_PRODUCER, "producer": "p"})
    # Same pid (idempotent issuance), bumped session counter.
    assert m.producer_sessions()["p"] == (pid, 2)


def test_retire_apply_rechecks_idleness_so_a_racing_refresh_wins():
    m = _mgr()
    m.apply(1, {"op": OP_REGISTER_PRODUCER, "producer": "p"})
    pid = m.producer_id("p")
    # A refresh lands BETWEEN the reaper's observation (seen=1) and the
    # retire apply: the stale retire must no-op.
    m.apply(2, {"op": OP_REGISTER_PRODUCER, "producer": "p"})
    m.apply(3, {"op": OP_RETIRE_PRODUCER, "producer": "p", "seen": 1})
    assert m.producer_id("p") == pid, "stale retire reaped a live pid"
    # A current observation reaps.
    m.apply(4, {"op": OP_RETIRE_PRODUCER, "producer": "p", "seen": 2})
    assert m.producer_id("p") is None
    # Pids are never reissued: a fresh name draws a fresh id.
    m.apply(5, {"op": OP_REGISTER_PRODUCER, "producer": "q"})
    assert m.producer_id("q") > pid


def test_retired_state_survives_snapshot_roundtrip():
    m = _mgr()
    m.apply(1, {"op": OP_REGISTER_PRODUCER, "producer": "p"})
    m.apply(2, {"op": OP_REGISTER_PRODUCER, "producer": "p"})
    snap = m.snapshot()
    m2 = _mgr()
    m2.restore(snap)
    assert m2.producer_sessions()["p"] == m.producer_sessions()["p"]
    m2.apply(3, {"op": OP_RETIRE_PRODUCER, "producer": "p", "seen": 2})
    assert m2.producer_id("p") is None


# -------------------------------------------------- cluster directed

@pytest.fixture
def short_retention_cluster(tmp_path):
    config = make_cluster_config(
        n_brokers=3, topics=(Topic("t", 1, 3),), pid_retention_s=1.0,
    )
    cluster = InProcCluster(config)
    cluster.start()
    try:
        cluster.wait_for_leaders()
        assert wait_until(cluster.controller_ready, timeout=30.0)
        yield cluster
    finally:
        cluster.stop()


def _stats(cluster, broker=None):
    bid = broker if broker is not None else next(iter(cluster.brokers))
    return cluster.client("stats").call(
        cluster.broker_addr(bid), {"type": "admin.stats"}, timeout=5.0
    )


def test_pid_registry_and_dedup_table_stop_growing_under_churn(
    short_retention_cluster,
):
    """The directed acceptance: churn producer clients (each registers
    a pid, produces once, dies), watch `producer_ids` spike, then
    assert the reaper shrinks BOTH the replicated registry and the
    controller's dedup table back down — while the brokers' own
    stamping pids survive through their registration refresh."""
    cluster = short_retention_cluster
    boot = [b.address for b in cluster.config.brokers]
    for i in range(6):
        p = ProducerClient(boot, transport=cluster.client(f"churn{i}"),
                           metadata_refresh_s=0.3)
        p.produce("t", f"m{i}".encode(), partition=0)
        p.close()
    peak = _stats(cluster)["producer_ids"]
    assert peak >= 6 + 1  # churned clients + at least one broker pid
    ctrl = _stats(cluster)["controller"]["id"]

    def reaped():
        st = _stats(cluster, ctrl)
        eng = st["engine"] or {}
        # Only the (refreshed) broker stamping pids survive; the
        # controller's dedup table drains to zero churned entries.
        return (st["producer_ids"] <= 3
                and eng.get("pid_table_size", -1) == 0)

    assert wait_until(reaped, timeout=30.0), (
        f"registry/table did not shrink: {_stats(cluster, ctrl)['producer_ids']}"
    )

    # A LIVE producer refreshing inside the window is never reaped.
    p = ProducerClient(boot, transport=cluster.client("live"),
                       metadata_refresh_s=0.3, pid_refresh_s=0.3)
    p.produce("t", b"keepalive", partition=0)
    pre = _stats(cluster, ctrl)["producer_ids"]
    deadline = time.time() + 3.0
    while time.time() < deadline:
        p.produce("t", b"beat", partition=0)
        time.sleep(0.3)
    assert _stats(cluster, ctrl)["producer_ids"] >= pre
    p.close()

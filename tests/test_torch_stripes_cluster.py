"""Striped replication plane, the cluster half (ripplemq_tpu_torch/stripes/
plane.py): full↔striped committed-prefix parity, the promotion rebuild
end-to-end, the standby's `repl.stripes` handler refusing corrupt
frames, and the checker's k-of-k+m contract.

Twin of the cluster half of `tests/test_stripes.py` on the PyTorch port
(CPU brokers); `tests/test_torch_stripes.py` holds the codec and
recovery halves against the reference.
"""

from __future__ import annotations

import time

from ripplemq_tpu_torch.stripes.codec import RS_K, RS_M, encode_group
from tests.torch_port_modules import admit

admit(__name__)

N = RS_K + RS_M

# Representative multi-round record stream: append rows, a pid entry,
# an offset batch — the exact shapes the settle path replicates.
RECORDS = [
    (1, 0, 0, b"row-" * 32),
    (4, 0, 1, b"\x01\x00\x00\x00" + b"\x00" * 20),
    (1, 1, 8, bytes(range(256)) * 3),
    (2, 1, 2, b"\x02\x00\x00\x00\x09\x00\x00\x00"),
]


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _mk_cluster(tmp_path, name, replication, n_brokers=3):
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from ripplemq_tpu_torch.metadata.models import Topic
    from tests.torch_helpers import InProcCluster

    config = make_cluster_config(
        n_brokers=n_brokers, topics=(Topic("t", 1, 3),),
        replication=replication,
    )
    cluster = InProcCluster(config, data_dir=str(tmp_path / name))
    cluster.start()
    cluster.wait_for_leaders()
    assert _wait(cluster.controller_ready), "no standby joined"
    return cluster


def _drain(cluster, consumer_name, expect_at_least=0, timeout=30.0):
    from ripplemq_tpu_torch.client import ConsumerClient

    boot = [b.address for b in cluster.config.brokers]
    cons = ConsumerClient(boot, consumer_name,
                          transport=cluster.client(consumer_name),
                          metadata_refresh_s=0.3)
    got, idle = [], 0
    deadline = time.time() + timeout
    try:
        while idle < 8 and time.time() < deadline:
            try:
                batch = cons.consume("t", partition=0, max_messages=16)
            except Exception:
                idle += 1
                time.sleep(0.2)
                continue
            if batch:
                got.extend(batch)
                idle = 0
                if expect_at_least and len(got) >= expect_at_least:
                    # Two clean empties confirm the tail.
                    expect_at_least = 0
            else:
                idle += 1
                time.sleep(0.1)
    finally:
        cons.close()
    return [m.decode() for m in got]


def test_full_and_striped_committed_prefixes_are_identical(tmp_path):
    from ripplemq_tpu_torch.client import ProducerClient

    logs = {}
    for mode in ("full", "striped"):
        cluster = _mk_cluster(tmp_path, mode, mode)
        try:
            boot = [b.address for b in cluster.config.brokers]
            prod = ProducerClient(boot, transport=cluster.client("p"),
                                  metadata_refresh_s=0.3)
            for i in range(24):
                prod.produce("t", f"msg-{i}".encode(), partition=0)
            prod.close()
            logs[mode] = _drain(cluster, f"auditor-{mode}",
                                expect_at_least=24)
        finally:
            cluster.stop()
    assert logs["full"] == logs["striped"]
    assert logs["full"][:24] == [f"msg-{i}" for i in range(24)]


def test_striped_promotion_rebuilds_committed_prefix(tmp_path):
    from ripplemq_tpu_torch.client import ProducerClient

    cluster = _mk_cluster(tmp_path, "promo", "striped", n_brokers=4)
    try:
        boot = [b.address for b in cluster.config.brokers]
        st = cluster.client("s").call(boot[0], {"type": "admin.stats"},
                                      timeout=5.0)
        assert st["stripe_mode"] == "striped"
        assert len(st["stripe_holders"]) == N
        assert set(st["stripe_holders"]) <= set(
            st["controller"]["standbys"]
        )
        prod = ProducerClient(boot, transport=cluster.client("p"),
                              metadata_refresh_s=0.3)
        for i in range(30):
            prod.produce("t", f"pre-{i}".encode(), partition=0)
        ctrl = st["controller"]["id"]
        cluster.kill(ctrl)
        # The promoted standby must REBUILD the full stream from any k
        # surviving stripes and accept fresh writes.
        ok = _wait(lambda: _try_produce(prod), timeout=60.0, interval=0.2)
        assert ok, "no post-failover produce"
        log = _drain(cluster, "promo-auditor", expect_at_least=31,
                     timeout=45.0)
        assert log[:30] == [f"pre-{i}" for i in range(30)]
        assert "post" in log
        rebuilds = sum(
            b._stripe_rebuilds for i, b in cluster.brokers.items()
            if not b._stopped
        )
        assert rebuilds >= 1
        prod.close()
    finally:
        cluster.stop()


def _try_produce(prod):
    try:
        prod.produce("t", b"post", partition=0)
        return True
    except Exception:
        return False


def test_repl_stripes_handler_refuses_corrupt_frames(tmp_path):
    cluster = _mk_cluster(tmp_path, "crc", "striped")
    try:
        st = cluster.client("s").call(
            cluster.broker_addr(0), {"type": "admin.stats"}, timeout=5.0
        )
        standby = st["controller"]["standbys"][0]
        epoch = st["controller"]["epoch"]
        frames = encode_group(RECORDS, epoch, 999_999, device="cpu")
        bad = bytearray(frames[0])
        bad[25] ^= 0xFF
        resp = cluster.brokers[standby].dispatch({
            "type": "repl.stripes", "epoch": epoch,
            "frames": [bytes(bad)],
        })
        assert not resp.get("ok")
        assert resp.get("error") == "bad_stripe_frame"
        # The intact frame lands.
        resp = cluster.brokers[standby].dispatch({
            "type": "repl.stripes", "epoch": epoch,
            "frames": [frames[0]],
        })
        assert resp.get("ok"), resp
    finally:
        cluster.stop()


def test_checker_stripe_contract_gates_on_m():
    from ripplemq_tpu_torch.chaos.history import check_history

    ops = [{
        "op": "produce", "client": "p", "topic": "t", "partition": 0,
        "payload": "lost", "status": "ok", "attempts": 1, "i": 0,
        "t": 0.0,
    }]
    logs = {("t", 0): []}
    # Within the k-of-k+m contract (<= m holders down): absolute.
    v = check_history(ops, logs, stripe={"k": RS_K, "m": RS_M,
                                         "holders_down": RS_M})
    assert any("acked loss" in x for x in v)
    # Beyond it: the documented beyond-contract regime.
    v = check_history(ops, logs, stripe={"k": RS_K, "m": RS_M,
                                         "holders_down": RS_M + 1})
    assert v == []

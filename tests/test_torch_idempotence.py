"""Idempotent producers: (pid, seq) dedup at the append path, the
replicated dedup table, and its recovery across boot replay and
controller failover.

The failing-before shape of every test here: without the dedup plane a
replayed produce appends a second copy — the exact at-least-once window
that once forced the chaos checker to SUSPEND clean-ack exactly-once
under wire-dup schedules (the suspension branch is now deleted;
tests/test_chaos.py asserts the schedule-level half).

Twin of the cluster and producer-client tests of
`tests/test_idempotence.py` on the PyTorch port, with CPU brokers; the
plane-level tests are twinned beside the other DataPlane twins.
"""

from __future__ import annotations

import time

import pytest

from ripplemq_tpu_torch.broker.dataplane import (
    DataPlane,
    NotCommittedError,
    recover_image,
)
from ripplemq_tpu_torch.storage.segment import SegmentStore
from tests.torch_helpers import port_cfg, wait_until
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture()
def dp():
    plane = DataPlane(port_cfg(), mode="local", device="cpu", max_retry_rounds=3)
    plane.start()
    yield plane
    plane.stop()


def _read_all(dp, slot, replica=0, start=0):
    msgs, offset = [], start
    while True:
        got, nxt = dp.read(slot, offset, replica=replica)
        if nxt == offset:
            return msgs
        msgs.extend(got)
        offset = nxt


# ----------------------------------------------------------- dedup basics


# ---------------------------------------------- recovery: boot replay


# ------------------------------------- recovery: controller failover


def test_retry_straddling_controller_failover_acked_once():
    """Directed satellite, the failover half: a produce acked by the OLD
    controller is replayed (same pid/seq) against the PROMOTED one —
    the dedup table rebuilt from the standby's committed-round stream
    refuses the re-append. Failing-before: the promoted plane had no
    table and the partition drained two copies."""
    from ripplemq_tpu_torch.chaos.cluster import InProcCluster, make_cluster_config
    from ripplemq_tpu_torch.client import ConsumerClient
    from ripplemq_tpu_torch.metadata.models import Topic

    config = make_cluster_config(
        3, topics=(Topic("t", 1, 3),), standby_count=2,
    )
    with InProcCluster(config, device="cpu") as c:
        c.wait_for_leaders()
        client = c.client("idem")
        # A joined standby is the promotion precondition.
        assert wait_until(c.controller_ready, timeout=30)
        # Register a producer id through the replicated path.
        resp = client.call(
            c.brokers[0].addr,
            {"type": "producer.register", "name": "idem-prod"},
            timeout=10.0,
        )
        assert resp["ok"], resp
        pid = resp["pid"]
        leader = c.leader_broker("t", 0)
        req = {"type": "produce", "topic": "t", "partition": 0,
               "messages": [b"straddle"], "pid": pid, "seq": 0}
        r1 = client.call(leader.addr, dict(req), timeout=10.0)
        assert r1["ok"], r1

        # Kill the controller; a standby promotes and boots from its
        # copy of the committed-round stream (REC_PIDSEQ included).
        ctrl_id = c.brokers[0].manager.current_controller()
        c.kill(ctrl_id)

        def promoted():
            for i, b in c.brokers.items():
                if i == ctrl_id:
                    continue
                if (b.manager.current_controller() != ctrl_id
                        and b._local_engine() is not None):
                    return True
            return False

        assert wait_until(promoted, timeout=60)
        # The retry: same (pid, seq), sent to whoever leads now.
        r2 = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            survivor = next(
                b for i, b in c.brokers.items() if i != ctrl_id
            )
            leader_id = survivor.manager.leader_of(("t", 0))
            if leader_id is None or leader_id == ctrl_id:
                time.sleep(0.1)
                continue
            got = client.call(c.brokers[leader_id].addr, dict(req),
                              timeout=5.0)
            if got.get("ok"):
                r2 = got
                break
            time.sleep(0.1)
        assert r2 is not None and r2["ok"], r2
        assert r2["base_offset"] == r1["base_offset"]

        # The drained log holds exactly ONE copy.
        cc = ConsumerClient(
            [b.address for b in config.brokers], "idem-audit",
            transport=c.client("idem-audit"), retries=5,
            retry_backoff_s=0.05,
        )
        msgs = []
        for _ in range(20):
            got = cc.consume("t", partition=0, max_messages=32)
            if not got:
                break
            msgs += got
        cc.close()
        assert msgs.count(b"straddle") == 1, msgs


# -------------------------------------------- client-side seq semantics


class _ScriptedTransport:
    """Transport double: serves metadata + registration, then runs a
    script of produce outcomes ("timeout" | "ok") while recording every
    produce request — the (pid, seq) replay contract is asserted on the
    recorded stream."""

    def __init__(self, script):
        from ripplemq_tpu_torch.wire.transport import RpcTimeout

        self._timeout_exc = RpcTimeout
        self.script = list(script)
        self.produces: list[dict] = []
        self.next_offset = 0

    def call(self, addr, request, timeout=3.0):
        t = request.get("type")
        if t == "meta.topics":
            return {
                "ok": True,
                "topics": [{
                    "name": "t", "partitions": 1,
                    "replication_factor": 1,
                    "assignments": [{"partition_id": 0, "replicas": [0],
                                     "leader": 0, "term": 1}],
                }],
                "brokers": [{"broker_id": 0, "host": "h", "port": 1}],
            }
        if t == "producer.register":
            return {"ok": True, "pid": 42}
        if t == "produce":
            self.produces.append(dict(request))
            outcome = self.script.pop(0) if self.script else "ok"
            if outcome == "timeout":
                raise self._timeout_exc("scripted timeout")
            base = self.next_offset
            self.next_offset += len(request["messages"])
            return {"ok": True, "base_offset": base,
                    "count": len(request["messages"])}
        return {"ok": False, "error": f"unknown request type {t!r}"}

    def close(self):
        pass


def test_producer_client_replays_same_identity_across_retries():
    from ripplemq_tpu_torch.client import ProducerClient

    tr = _ScriptedTransport(["timeout", "ok", "ok"])
    p = ProducerClient(["h:1"], transport=tr, retries=3,
                       retry_backoff_s=0.0, metadata_refresh_s=3600.0)
    p.produce("t", b"m1", partition=0)
    # Attempt 1 timed out (outcome unknown), attempt 2 succeeded: BOTH
    # carried the identical (pid, seq) — the replay the broker dedupes.
    assert len(tr.produces) == 2
    assert tr.produces[0]["pid"] == tr.produces[1]["pid"] == 42
    assert tr.produces[0]["seq"] == tr.produces[1]["seq"] == 0
    # The next batch takes the NEXT sequence range.
    p.produce_batch("t", [b"m2", b"m3"], partition=0)
    assert tr.produces[2]["seq"] == 1
    p.close()


def test_producer_client_burns_sequence_range_on_abandonment():
    from ripplemq_tpu_torch.client import ProducerClient
    from ripplemq_tpu_torch.client.producer import ProduceError

    tr = _ScriptedTransport(["timeout", "timeout", "ok"])
    p = ProducerClient(["h:1"], transport=tr, retries=2,
                       retry_backoff_s=0.0, metadata_refresh_s=3600.0)
    with pytest.raises(ProduceError):
        p.produce("t", b"doomed", partition=0)
    # Two attempts went on the wire with seq 0; the range is BURNED —
    # the next (fresh) payload must NOT reuse it, or a late-committing
    # copy of "doomed" would dedupe the fresh batch away.
    p.produce("t", b"fresh", partition=0)
    assert tr.produces[-1]["seq"] == 1
    assert tr.produces[-1]["messages"] == [b"fresh"]
    p.close()

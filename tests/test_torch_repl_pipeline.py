"""Directed tests for replication-stream pipelining (and
the head-of-line fix): the sender keeps a window of per-stream-
sequence-numbered frames in flight — a slow standby ack no longer caps
the stream at one group per round trip (the failing-before behavior:
a synchronous sender blocked on each call before sending the next) — and
the standby-side gate applies frames strictly in sequence order,
re-applies duplicates harmlessly, and refuses gaps with the expected
counter so a rewinding sender re-syncs (including against a RESTARTED
standby whose gate restarted at zero).

Twin of the standby (receiver) half of `tests/test_repl_pipeline.py` on
the PyTorch port (CPU brokers): `_ReplStreamGate` and the standby's
in-order apply. The sender half is in `tests/test_torch_replication.py`.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import pytest

from ripplemq_tpu_torch.broker.replication import RoundReplicator
from ripplemq_tpu_torch.broker.server import _ReplStreamGate
from ripplemq_tpu_torch.wire.transport import RpcError
from tests.torch_port_modules import admit

admit(__name__)


class PipelinedStubClient:
    """call_async transport whose responses the TEST resolves: records
    every frame it was handed (send order = the wire order) without
    answering until told to."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.sent: list[tuple[dict, Future]] = []

    def call_async(self, addr, request):
        fut: Future = Future()
        with self.lock:
            self.sent.append((request, fut))
        return fut

    def frames(self) -> list[dict]:
        with self.lock:
            return [r for r, _ in self.sent]

    def resolve(self, i, resp) -> None:
        with self.lock:
            _, fut = self.sent[i]
        if isinstance(resp, Exception):
            fut.set_exception(resp)
        else:
            fut.set_result(resp)

    def wait_sent(self, n, timeout_s=5.0) -> list[dict]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.frames()
            if len(got) >= n:
                return got
            time.sleep(0.005)
        raise AssertionError(
            f"only {len(self.frames())} frames sent, wanted {n}"
        )


def make_rep(client, depth=4):
    return RoundReplicator(
        client, addr_of=lambda b: f"b{b}",
        epoch_fn=lambda: 3,
        members_fn=lambda: (1,),
        active_fn=lambda: True,
        sender_id=0,
        pipeline_depth=depth,
    )


REC = [(0, 0, 0, b"payload")]


def test_gate_applies_in_order_reapplies_dups_refuses_gaps():
    gate = _ReplStreamGate()
    key = (0, 3)
    assert gate.enter(key, 0, timeout_s=0.1)
    gate.applied(key, 0)
    # Out-of-order successor parks until its predecessor applies.
    order = []

    def late():
        assert gate.enter(key, 2, timeout_s=5.0)
        order.append(2)

    t = threading.Thread(target=late)
    t.start()
    time.sleep(0.05)
    assert order == []  # parked on sseq 1
    assert gate.enter(key, 1, timeout_s=0.1)
    order.append(1)
    gate.applied(key, 1)
    t.join(timeout=5)
    assert order == [1, 2]
    gate.applied(key, 2)
    # Duplicate (rewound sender): applies immediately, expected holds.
    assert gate.enter(key, 0, timeout_s=0.1)
    gate.applied(key, 0)
    assert gate.expected(key) == 3
    # Gap with no predecessor in flight: refuse within the wait bound.
    assert not gate.enter(key, 9, timeout_s=0.05)
    assert gate.expected(key) == 3


def test_gate_retires_older_epochs_per_sender():
    gate = _ReplStreamGate()
    gate.enter((0, 1), 0, timeout_s=0.1)
    gate.applied((0, 1), 0)
    gate.enter((0, 2), 0, timeout_s=0.1)
    gate.applied((0, 2), 0)
    assert (0, 1) not in gate._expected
    assert gate.expected((0, 2)) == 1


def test_standby_applies_pipelined_stream_in_order(tmp_path):
    """Integration: a broker's repl.rounds handler behind the gate —
    frames delivered OUT of order by concurrent threads land in the
    store in sequence order."""
    from tests.torch_helpers import InProcCluster, make_config

    with InProcCluster(make_config(3)) as c:
        c.wait_for_leaders()
        standby = next(b for b in c.brokers.values() if not b.is_controller)
        epoch = standby.manager.current_epoch() + 1  # future epoch: accepted
        results = {}

        def deliver(sseq, delay):
            time.sleep(delay)
            results[sseq] = standby.dispatch({
                "type": "repl.rounds", "epoch": epoch, "sender": 99,
                "sseq": sseq,
                "records": [[0, 0, sseq * 8, b"rec-%d" % sseq]],
            })

        # sseq 1 arrives FIRST; the gate parks it until 0 lands.
        threads = [threading.Thread(target=deliver, args=(1, 0.0)),
                   threading.Thread(target=deliver, args=(0, 0.15))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert results[0]["ok"] and results[1]["ok"], results
        recs = [r for r in standby._round_store.scan()
                if r[3].startswith(b"rec-")]
        assert [r[3] for r in recs] == [b"rec-0", b"rec-1"]
        # A gap past the wait bound refuses with the expected counter.
        resp = standby.dispatch({
            "type": "repl.rounds", "epoch": epoch, "sender": 99,
            "sseq": 7, "records": [[0, 0, 64, b"gap"]],
        })
        assert not resp["ok"]
        assert resp["error"].startswith("repl_seq_gap")
        assert resp["expected"] == 2

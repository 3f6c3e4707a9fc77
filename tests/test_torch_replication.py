"""The port's `RoundReplicator`, sender side: the twin of the sender
tests of `tests/test_repl_pipeline.py` (a window of per-stream-sequence
frames in flight past a slow ack, the window rewound on a failure and
renumbered on a `repl_seq_gap`, depth one is synchronous). The standby
side, `_ReplStreamGate` and the `repl.rounds` handler, belongs to the
broker server and waits for slice D2.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

from ripplemq_tpu_torch.broker.replication import RoundReplicator
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


def test_sender_pipelines_past_a_slow_ack():
    """FAILING-BEFORE: with the synchronous sender, frame 2 was never
    on the wire until frame 1's ack returned — a slow standby stalled
    the whole batch. Now later frames ship while the oldest ack is
    outstanding, each under its own stream sequence number."""
    client = PipelinedStubClient()
    rep = make_rep(client, depth=4)
    try:
        t1 = rep.begin(REC)
        client.wait_sent(1)  # frame 0 in flight, ack withheld
        t2 = rep.begin([(0, 1, 0, b"other-stream-slot")])
        # Frame 1 ships WHILE frame 0's ack is outstanding — the
        # synchronous sender never did this.
        frames = client.wait_sent(2)
        assert [f["sseq"] for f in frames] == [0, 1]
        assert all(f["epoch"] == 3 and f["sender"] == 0 for f in frames)
        # Acks release in order once the slow ack lands.
        client.resolve(0, {"ok": True})
        client.resolve(1, {"ok": True})
        rep.wait(t1, timeout_s=5.0)
        rep.wait(t2, timeout_s=5.0)
    finally:
        rep.stop()


def test_sender_rewinds_window_on_failure_and_renumbers_on_gap():
    """A lost frame rewinds the whole in-flight window in order; a
    repl_seq_gap refusal rewinds onto the standby's advertised
    expected counter (the restarted-standby re-sync)."""
    client = PipelinedStubClient()
    rep = make_rep(client, depth=4)
    try:
        t1 = rep.begin(REC)
        client.wait_sent(1)
        t2 = rep.begin(REC)
        client.wait_sent(2)
        # Frame 0 dies on the wire: the WHOLE window rewinds in order
        # (the re-send group-commits both rounds into one sseq-0 frame).
        client.resolve(0, RpcError("conn reset"))
        frames = client.wait_sent(3)
        assert frames[2]["sseq"] == 0
        assert len(frames[2]["records"]) == 2
        # The standby restarted meanwhile: its gate expects 5 (say) —
        # answer a gap; the sender must renumber onto `expected`.
        client.resolve(2, {"ok": False, "error": "repl_seq_gap: missing",
                           "expected": 5})
        frames = client.wait_sent(4)
        assert frames[3]["sseq"] == 5
        assert len(frames[3]["records"]) == 2
        client.resolve(3, {"ok": True})
        rep.wait(t1, timeout_s=5.0)
        rep.wait(t2, timeout_s=5.0)
    finally:
        rep.stop()


def test_depth_one_degenerates_to_synchronous():
    """pipeline_depth=1 is the pre-PR behavior: one frame in flight."""
    client = PipelinedStubClient()
    rep = make_rep(client, depth=1)
    try:
        rep.begin(REC)
        client.wait_sent(1)
        rep.begin(REC)
        time.sleep(0.3)
        assert len(client.frames()) == 1  # second frame held back
        client.resolve(0, {"ok": True})
        client.wait_sent(2)
    finally:
        rep.stop()

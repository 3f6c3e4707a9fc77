"""The port's timers inside the program: the DataPlane step thread's
states, the device lock's other holders, the RPC path, the warm-up, and
the benchmark's readers of them.

- the step thread's states tile its time, and `stage + lock_wait +
  launch` is `engine.dispatch_us` exactly (an injected clock that ticks
  once a read);
- `obs.trace.step_state_at` lays a `dispatch` event's states onto the
  recorder's clock;
- `TcpServer` times each request's queue, decode and reply;
- a produce's wait on its rounds lies inside its ack, and empty consume
  answers are counted;
- with the registry off, nothing new reads the clock;
- each new `mqbench/metrics` file reads its names, and nothing where
  they are absent;
- `torch.profiler`'s event stamps and the flight recorder share a clock.
"""

from __future__ import annotations

import itertools
import threading
import time

import pytest

from mqbench import readers
from ripplemq_tpu_torch.obs.metrics import Metrics
from ripplemq_tpu_torch.obs.trace import (STEP_STATES, FlightRecorder,
                                          step_state_at)
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore
from ripplemq_tpu_torch.wire.transport import TcpClient, TcpServer
from tests.torch_helpers import InProcCluster, port_cfg, port_dp, wait_until
from tests.torch_port_modules import admit

admit(__name__)


class TickClock:
    """A clock that advances by one second a read, and keeps the values
    each thread read, by thread name."""

    def __init__(self) -> None:
        self._n = itertools.count()
        self.reads: dict[str, list[float]] = {}

    def __call__(self) -> float:
        v = float(next(self._n))
        self.reads.setdefault(threading.current_thread().name, []).append(v)
        return v

    def count(self, thread: str) -> int:
        return len(self.reads.get(thread, []))


def _drive(dp, rounds=6):
    """Start `dp`, elect partition 0's leader, append `rounds` batches one
    after another and stop the plane; the number of acked messages."""
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        n = 0
        for i in range(rounds):
            msgs = [b"m%d.%d" % (i, k) for k in range(i + 1)]
            dp.submit_append(0, msgs).result(timeout=30)
            n += len(msgs)
        return n
    finally:
        dp.stop()


# ----------------------------------------------------- the step thread

def test_step_states_tile_the_loop_and_split_the_dispatch():
    clock = TickClock()
    m = Metrics(clock=clock)
    dp = port_dp(port_cfg(), metrics=m, store=MemoryRoundStore())
    _drive(dp)
    h = {s: m.histogram(f"engine.{s}_us") for s in STEP_STATES}
    dispatch = m.histogram("engine.dispatch_us")
    assert dispatch.count >= 6
    parts = ("stage", "lock_wait", "launch")
    assert all(h[s].count == dispatch.count for s in parts)
    assert sum(h[s].total for s in parts) == dispatch.total
    # One read a boundary: every read after the first ends a state.
    step = clock.reads["dataplane-step"]
    assert sum(x.total for x in h.values()) == (step[-1] - step[0]) * 1e6
    assert sum(x.count for x in h.values()) == len(step) - 1
    # Each dispatch event carries the states since the one before it.
    events = [e for e in dp.recorder.snapshot() if e["type"] == "dispatch"]
    assert len(events) == dispatch.count
    for s in STEP_STATES:
        assert sum(e[f"{s}_us"] for e in events) <= h[s].total
    assert sum(e["launch_us"] for e in events) == h["launch"].total
    # No CUDA stream on the CPU: no device time.
    assert m.histogram("engine.device_us").count == 0


def test_lock_holds_and_warm_are_timed_by_holder():
    m = Metrics(clock=TickClock())
    dp = port_dp(port_cfg(), metrics=m)
    dp.log_ends()
    dp.current_terms()
    dp.commit_index(0)
    dp.slot_detail([0])
    dp.postmortem()
    dp.warm(buckets=(1, 8))
    hold = {k: m.histogram(f"dataplane.lock_hold_us.{k}")
            for k in ("read", "fetch", "other")}
    assert hold["fetch"].count == 5
    # warm: a single and a chained round at each bucket, then the read.
    assert hold["other"].count == 5
    assert hold["read"].count == 0
    assert m.histogram("engine.warm_us").count == 2
    assert all(h.total == h.count * 1_000_000 for h in hold.values())
    dp.stop()


# ----------------------------------------------------- step_state_at

def _event(t, **us):
    e = {"type": "dispatch", "t": t, "seq": 0, "round_seq": 0}
    e.update({f"{s}_us": us.get(s, 0) for s in STEP_STATES})
    return e


# Two dispatches, back to back: the first's states span [9.0, 10.0], the
# second's [10.0, 10.5]; a third after a gap spans [11.0, 11.2].
_EVENTS = [
    {"type": "elect", "t": 9.5, "seq": 0},
    _event(10.0, handoff=100_000, idle=200_000, coalesce=100_000,
           drain=100_000, stage=200_000, lock_wait=100_000, launch=200_000),
    _event(10.5, handoff=50_000, drain=50_000, stage=100_000,
           lock_wait=100_000, launch=200_000),
    _event(11.2, idle=100_000, launch=100_000),
]


@pytest.mark.parametrize("t,state", [
    (8.99, None), (9.05, "handoff"), (9.2, "idle"), (9.35, "coalesce"),
    (9.45, "drain"), (9.6, "stage"), (9.75, "lock_wait"), (9.9, "launch"),
    (10.02, "handoff"), (10.07, "drain"), (10.15, "stage"),
    (10.25, "lock_wait"), (10.4, "launch"), (10.7, None), (11.05, "idle"),
    (11.15, "launch"), (11.3, None),
])
def test_step_state_at_names_each_state(t, state):
    assert step_state_at(_EVENTS, int(t * 1e9)) == state


def test_step_state_at_needs_timed_dispatches():
    untimed = [{"type": "dispatch", "t": 10.0, "seq": 0, "round_seq": 0}]
    assert step_state_at(untimed, int(9.99 * 1e9)) is None
    assert step_state_at([], 0) is None


# ----------------------------------------------------- the RPC path

@pytest.mark.parametrize("timed", [True, False])
def test_tcp_server_times_queue_decode_and_reply(timed):
    m = Metrics() if timed else None
    srv = TcpServer("127.0.0.1", 0, lambda req: {"ok": True,
                                                "echo": req["n"]},
                    workers=4, metrics=m)
    srv.start()
    cli = TcpClient()
    try:
        addr = f"{srv.host}:{srv.port}"
        for n in range(5):
            assert cli.call(addr, {"n": n}, timeout=10) == {"ok": True,
                                                            "echo": n}
        if timed:
            names = ("rpc.queue_us", "rpc.decode_us", "rpc.reply_us")
            assert wait_until(lambda: all(
                m.histogram(k).count == 5 for k in names), timeout=10)
    finally:
        cli.close()
        srv.stop()


@pytest.fixture(scope="module")
def cluster():
    with InProcCluster() as c:
        c.wait_for_leaders()
        yield c


def test_round_wait_lies_inside_each_produce_ack(cluster):
    leader = cluster.leader_broker("topic1", 1)
    ack = leader.metrics.histogram("produce.ack_us")
    wait = leader.metrics.histogram("produce.round_wait_us")
    cli = cluster.client()
    for i in range(4):
        a0, w0, n0 = ack.total, wait.total, wait.count
        resp = cli.call(leader.addr, {"type": "produce", "topic": "topic1",
                                      "partition": 1,
                                      "messages": [b"x%d" % i] * (i + 1)},
                        timeout=10)
        assert resp["ok"], resp
        assert wait.count == n0 + 1
        assert 0 <= wait.total - w0 <= ack.total - a0


def test_empty_consume_answers_are_counted(cluster):
    leader = cluster.leader_broker("topic1", 0)
    empty = leader.metrics.counter("consume.empty")
    cli = cluster.client()

    def consume(offset):
        resp = cli.call(leader.addr, {"type": "consume", "topic": "topic1",
                                      "partition": 0, "consumer": "e",
                                      "offset": offset, "max_messages": 8},
                        timeout=10)
        assert resp["ok"], resp
        return resp

    assert cli.call(leader.addr, {"type": "produce", "topic": "topic1",
                                  "partition": 0, "messages": [b"a", b"b"]},
                    timeout=10)["ok"]
    n0 = empty.n
    first = consume(0)
    assert first["messages"] == [b"a", b"b"] and empty.n == n0
    assert consume(first["next_offset"])["messages"] == []
    assert empty.n == n0 + 1


# ----------------------------------------------------- registry off

def test_disabled_registry_reads_no_clock_in_the_plane():
    clock = TickClock()
    m = Metrics(enabled=False, clock=clock)
    dp = port_dp(port_cfg(), metrics=m)
    dp.log_ends()
    dp.commit_index(0)
    dp.warm(buckets=(1,))
    assert clock.count("MainThread") == 0
    _drive(dp, rounds=3)
    # The step thread reads only the two stamps each dispatch has always
    # carried downstream (t_dispatch, t_dispatched).
    assert clock.count("dataplane-step") == 2 * dp.dispatches
    events = [e for e in dp.recorder.snapshot() if e["type"] == "dispatch"]
    assert events and not any("launch_us" in e for e in events)


def test_disabled_registry_reads_no_clock_in_store_and_transport(tmp_path):
    from ripplemq_tpu_torch.storage.segment import SegmentStore

    clock = TickClock()
    m = Metrics(enabled=False, clock=clock)
    store = SegmentStore(str(tmp_path), erasure=True, metrics=m,
                         device="cpu")
    store._erasure_worker()
    srv = TcpServer("127.0.0.1", 0, lambda req: {"ok": True}, workers=2,
                    metrics=m)
    srv.start()
    cli = TcpClient()
    try:
        assert cli.call(f"{srv.host}:{srv.port}", {"n": 1}, timeout=10)["ok"]
    finally:
        cli.close()
        srv.stop()
        store.close()
    assert clock.reads == {}
    assert m.hold_timer("dataplane.lock_hold_us.read").__enter__() is None
    assert clock.reads == {}


def test_erasure_pass_is_timed(tmp_path):
    from ripplemq_tpu_torch.storage.segment import SegmentStore

    m = Metrics(clock=TickClock())
    store = SegmentStore(str(tmp_path), erasure=True, metrics=m,
                         device="cpu")
    try:
        store._erasure_worker()
        h = m.histogram("store.protect_us")
        assert (h.count, h.total) == (1, 1_000_000)
    finally:
        store.close()


# ----------------------------------------------------- the readers

def _run(hist0=None, hist1=None, counters0=None, counters1=None,
         seconds=10.0):
    snap = [{"hist": dict(hist0 or {}), "counters": dict(counters0 or {})},
            {"hist": dict(hist1 or {}), "counters": dict(counters1 or {})}]
    return {"seconds": seconds, "registry": {"window": tuple(snap)}}


# name -> (window start's histograms, window end's, counters at the
# start, at the end, the value they give)
_SYNTH = {
    "batcher_wait_ms.max": (
        {"engine.idle_us": (1, 500), "engine.coalesce_us": (2, 700),
         "engine.dispatch_us": (3, 0)},
        {"engine.idle_us": (5, 40_500), "engine.coalesce_us": (8, 20_700),
         "engine.dispatch_us": (7, 0)}, {}, {}, 15.0),
    "drain_ms.max": ({"engine.drain_us": (1, 100)},
                     {"engine.drain_us": (5, 8_100)}, {}, {}, 2.0),
    "stage_ms.max": ({"engine.stage_us": (0, 0)},
                     {"engine.stage_us": (4, 40_000)}, {}, {}, 10.0),
    "device_lock_wait_ms.max": ({}, {"engine.lock_wait_us": (2, 3_000)},
                                {}, {}, 1.5),
    "launch_ms.max": ({"engine.launch_us": (1, 10)},
                      {"engine.launch_us": (3, 1_010)}, {}, {}, 0.5),
    "handoff_ms.max": ({}, {"engine.handoff_us": (4, 2_000)}, {}, {}, 0.5),
    "dispatch_device_ms.max": ({}, {"engine.device_us": (2, 9_000)}, {}, {},
                               4.5),
    "device_lock_others_share.max": (
        {"dataplane.lock_hold_us.read": (1, 1_000_000)},
        {"dataplane.lock_hold_us.read": (9, 2_000_000),
         "dataplane.lock_hold_us.fetch": (3, 500_000),
         "dataplane.lock_hold_us.other": (1, 500_000)}, {}, {}, 20.0),
    "erasure_share.max": ({"store.protect_us": (1, 3_000_000)},
                          {"store.protect_us": (2, 4_000_000)}, {}, {}, 10.0),
    "rpc_queue_ms.max": ({"rpc.queue_us": (10, 1_000)},
                         {"rpc.queue_us": (20, 6_000)}, {}, {}, 0.5),
    "rpc_codec_ms.max": (
        {"rpc.decode_us": (10, 100), "rpc.reply_us": (10, 200)},
        {"rpc.decode_us": (14, 1_100), "rpc.reply_us": (14, 1_200)},
        {}, {}, 0.5),
    "produce_handle_ms.max": (
        {"produce.ack_us": (2, 10_000), "produce.round_wait_us": (2, 8_000)},
        {"produce.ack_us": (6, 50_000),
         "produce.round_wait_us": (6, 40_000)}, {}, {}, 2.0),
    "consume_empty_share.max": (
        {"consume.ack_us": (100, 0)}, {"consume.ack_us": (300, 0)},
        {"consume.empty": 50}, {"consume.empty": 80}, 15.0),
    "warm_s.max": ({"engine.warm_us": (6, 12_500_000)},
                   {"engine.warm_us": (6, 12_500_000)}, {}, {}, 12.5),
}


@pytest.mark.parametrize("name", sorted(_SYNTH))
def test_metric_reads_a_synthetic_run(name):
    h0, h1, c0, c1, want = _SYNTH[name]
    read = readers.load(name)
    assert read(_run(h0, h1, c0, c1)) == pytest.approx(want)
    # The parent's program has none of these names.
    assert read(_run()) is None


# ----------------------------------------------------- the clocks

def test_profiler_and_recorder_share_a_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = FlightRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.record("dispatch", round_seq=0)
        with record_function("step_state_probe"):
            time.sleep(0.02)
        rec.record("dispatch", round_seq=1)
    before, after = rec.snapshot()
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    ev = next(e for e in prof.events() if e.name == "step_state_probe")
    start = (base_ns + ev.time_range.start * 1e3) / 1e9
    end = (base_ns + ev.time_range.end * 1e3) / 1e9
    assert abs(start - before["t"]) < 2e-3
    assert abs(after["t"] - end) < 2e-3

"""Directed tests for the multi-core host plane (parallel/hostplane.py):
worker-side validation/stamping/packing, settled-mirror reads, and —
the recovery contract — worker crash detection with the typed
retryable refusal and generation-bumped respawn (no silent hangs).

Twin of `tests/test_hostplane.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from ripplemq_tpu_torch.parallel.hostplane import (
    HostPlane,
    OversizeBatchError,
    WorkerUnavailableError,
    _SlotMirror,
    worker_of,
)
from tests.torch_port_modules import admit

admit(__name__)

SB = 32  # slot_bytes for every plane in this module
PB = 24  # payload_bytes
MB = 8   # max_batch


@pytest.fixture
def plane():
    hp = HostPlane(2, slot_bytes=SB, payload_bytes=PB, max_batch=MB)
    hp.start()
    yield hp
    hp.stop()


def _wait_submit(hp, slot, msgs, deadline_s=15.0, **kw):
    """Submit with boot tolerance: a worker still spawning answers
    late, never wrongly."""
    t0 = time.monotonic()
    while True:
        try:
            return hp.submit(slot, msgs, timeout_s=5.0, **kw)
        except WorkerUnavailableError:
            if time.monotonic() - t0 > deadline_s:
                raise
            time.sleep(0.1)


def test_pack_matches_engine_row_format(plane):
    """The worker's pure-python packer is byte-identical to
    core/encode.pack_payload_rows (zero term; the batcher stamps)."""
    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.core.encode import pack_payload_rows

    msgs = [b"alpha", b"be", b"gamma-long-ish"]
    res = _wait_submit(plane, 0, msgs)
    lens, packed = res["chunks"][0]
    assert lens == [len(m) for m in msgs]
    cfg = EngineConfig(partitions=2, replicas=1, slots=64, slot_bytes=SB,
                       max_batch=MB)
    expect = pack_payload_rows(cfg, msgs)
    got = np.frombuffer(packed, np.uint8).reshape(len(msgs), SB)
    assert np.array_equal(got, expect)


def test_chunking_and_stamping(plane):
    """A batch over max_batch splits into max_batch-sized chunks;
    pid-less batches stamp off the worker's per-slot counters once a
    pid is installed; explicit (pid, seq) pass through verbatim."""
    res = _wait_submit(plane, 1, [b"m"] * (MB * 2 + 3))
    assert [len(c[0]) for c in res["chunks"]] == [MB, MB, 3]
    assert res["pid"] == 0 and res["seq"] == -1  # no pid installed yet

    plane.set_worker_pid(worker_of(1, 2), 42)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        res = _wait_submit(plane, 1, [b"m"] * 4)
        if res["pid"] == 42:
            break
        time.sleep(0.05)
    assert res["pid"] == 42
    first = res["seq"]
    res = _wait_submit(plane, 1, [b"m"] * 5)
    assert res["pid"] == 42 and res["seq"] == first + 4
    # Another slot owned by the same worker has independent counters.
    res = _wait_submit(plane, 3, [b"m"])
    assert res["seq"] == 0
    # Explicit client idempotence identity is untouched.
    res = _wait_submit(plane, 1, [b"m"], pid=7, seq=99)
    assert res["pid"] == 7 and res["seq"] == 99


def test_validation_refusals(plane):
    with pytest.raises(ValueError, match="empty"):
        _wait_submit(plane, 0, [b""])
    with pytest.raises(ValueError, match="payload_bytes"):
        _wait_submit(plane, 0, [b"x" * (PB + 1)])


def _rows(msgs):
    out = bytearray(len(msgs) * SB)
    for i, m in enumerate(msgs):
        out[i * SB : i * SB + 4] = len(m).to_bytes(4, "little")
        out[i * SB + 8 : i * SB + 8 + len(m)] = m
    return bytes(out)


def test_mirror_publish_and_read(plane):
    """Settled-mirror serving: contiguous publishes serve reads with
    padding rows walked over; gaps reset the window (reads below it
    fall back — None); max_msgs clips with the right next_offset."""
    _wait_submit(plane, 0, [b"warm"])  # ensure worker 0 is up
    plane.publish(0, 0, _rows([b"a", b"b", b"", b""]))  # round + padding
    plane.publish(0, 4, _rows([b"c", b"d", b"e", b""]))
    deadline = time.monotonic() + 5
    got = None
    while time.monotonic() < deadline:
        got = plane.read(0, 0, None)
        if got is not None and got[0]:
            break
        time.sleep(0.05)
    assert got == ([b"a", b"b", b"c", b"d", b"e"], 8)
    assert plane.read(0, 1, 2) == ([b"b", b"c"], 5)
    assert plane.read(0, 8, None) == ([], 8)  # tail poll
    # A gap (dropped publish) resets the window: pre-gap offsets now
    # fall back, post-gap rows serve.
    plane.publish(0, 16, _rows([b"z"]))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if plane.read(0, 16, None) == ([b"z"], 17):
            break
        time.sleep(0.05)
    assert plane.read(0, 16, None) == ([b"z"], 17)
    assert plane.read(0, 0, None) is None  # below the reset window


def test_worker_crash_typed_refusal_and_respawn(plane):
    """Kill a worker mid-life: in-flight/new requests fail with the
    TYPED retryable WorkerUnavailableError (never a hang), the
    dispatcher respawns under a bumped generation, and service
    resumes; reads fall back (None) while the worker is down."""
    _wait_submit(plane, 1, [b"live"])
    handle = plane._workers[worker_of(1, 2)]
    handle.proc.kill()
    # Detection: the recv thread notices within its poll interval.
    deadline = time.monotonic() + 10
    refused = False
    while time.monotonic() < deadline:
        try:
            plane.submit(1, [b"x"], timeout_s=1.0)
        except WorkerUnavailableError:
            refused = True
            break
        time.sleep(0.05)
    assert refused, "dead worker never produced a typed refusal"
    assert plane.read(1, 0, None) is None  # reads degrade, not hang
    # Respawn: generation bumps and service resumes.
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            plane.submit(1, [b"back"], timeout_s=2.0)
            break
        except WorkerUnavailableError:
            time.sleep(0.1)
    else:
        pytest.fail("worker never respawned")
    assert plane.generations()[worker_of(1, 2)] >= 1
    assert plane.stats(ping_timeout_s=2.0)["restarts"] >= 1


def test_oversize_batch_refused_without_killing_worker(plane):
    """A batch that cannot fit a ring frame raises the typed
    OversizeBatchError (the produce path's in-process fallback signal)
    BEFORE touching the ring — the worker must survive it, and the
    client's retry of a giant batch must never respawn-loop the
    slice."""
    _wait_submit(plane, 0, [b"warm"])
    gens = plane.generations()
    # Response bound: enough rows that k * slot_bytes outgrows half the
    # default ring even though each payload is tiny.
    huge = [b"x"] * ((plane.ring_bytes // 2) // SB + 64)
    with pytest.raises(OversizeBatchError):
        plane.submit(0, huge, timeout_s=2.0)
    # The worker is untouched: same generation, still serving.
    assert plane.generations() == gens
    assert _wait_submit(plane, 0, [b"still-alive"], deadline_s=5.0)["ok"]
    # Oversize mirror publishes drop (never raise, never kill).
    plane.publish(0, 0, b"\x00" * (plane.ring_bytes // 2 + 8))
    assert _wait_submit(plane, 0, [b"after-publish"], deadline_s=5.0)["ok"]


def test_torn_response_triggers_respawn(plane):
    """A worker dying MID-PUBLISH leaves a torn frame in the response
    ring; the dispatcher must treat it as worker death — typed
    refusals then a generation-bumped respawn — not a permanently dead
    handle (review r12)."""
    _wait_submit(plane, 0, [b"warm"])
    handle = plane._workers[worker_of(0, 2)]
    # Forge a torn publish: corrupt bytes made visible by a bare tail
    # advance, exactly what a crash between body write and CRC leaves.
    ring = handle.resp_ring
    import struct

    tail = struct.unpack_from("<Q", ring._buf, 24)[0]
    struct.pack_into("<II", ring._buf, 64 + (tail % ring.capacity),
                     24, 0xDEADBEEF)
    handle.proc.kill()  # the worker is gone too (crash semantics)
    struct.pack_into("<Q", ring._buf, 24, tail + 32)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            res = plane.submit(0, [b"back"], timeout_s=2.0)
            if res.get("ok"):
                break
        except WorkerUnavailableError:
            time.sleep(0.1)
    else:
        pytest.fail("no respawn after a torn response frame")
    assert plane.generations()[worker_of(0, 2)] >= 1


def test_slot_mirror_budget_drops_oldest():
    mir = _SlotMirror(SB)
    for base in range(0, 40, 4):
        mir.publish(base, _rows([b"p"] * 4), budget=8 * SB)
    assert mir.end == 40
    assert mir.start > 0  # oldest frames dropped under the budget
    assert mir.read(0, None) is None
    msgs, end = mir.read(mir.start, None)
    assert end == 40 and len(msgs) == 40 - mir.start


def test_partition_group_map_is_disjoint_and_total():
    owners = [worker_of(s, 4) for s in range(128)]
    assert set(owners) == {0, 1, 2, 3}
    assert all(worker_of(s, 4) == s % 4 for s in range(128))


def test_raw_frame_dispatch_byte_parity_with_dict_path():
    """Raw-frame dispatcher: a produce frame
    routed UNDECODED off its peeked header scalars — the TcpServer
    accept path's hook — commits byte-identically to the same request
    through the ordinary decode path, and anything the peek cannot
    cleanly classify falls back (None) to that path."""
    import dataclasses

    from ripplemq_tpu_torch.wire.codec import encode
    from tests.torch_helpers import InProcCluster, make_config

    cfg = dataclasses.replace(make_config(3), host_workers=2)
    with InProcCluster(cfg) as c:
        c.wait_for_leaders()
        client = c.client()
        payloads = [b"raw-%d" % i for i in range(6)]
        mgr = next(iter(c.brokers.values())).manager
        lead0 = c.brokers[mgr.leader_of(("topic1", 0))]
        lead1 = c.brokers[mgr.leader_of(("topic1", 1))]

        def until_ok(fn, deadline_s=20.0):
            t0 = time.monotonic()
            while True:
                resp = fn()
                if resp is not None and resp.get("ok"):
                    return resp
                if time.monotonic() - t0 > deadline_s:
                    pytest.fail(f"no ok before deadline: {resp}")
                time.sleep(0.1)  # worker subprocesses still booting

        # Partition 0 through the ordinary dict path.
        until_ok(lambda: client.call(lead0.addr, {
            "type": "produce", "topic": "topic1", "partition": 0,
            "messages": payloads}))
        # Partition 1 through the raw dispatcher, same bytes.
        raw = encode({"type": "produce", "topic": "topic1",
                      "partition": 1, "messages": payloads})
        until_ok(lambda: lead1._raw_produce(raw))

        def drain(lead, p):
            msgs, offset = [], 0
            while True:
                r = client.call(lead.addr, {
                    "type": "consume", "topic": "topic1", "partition": p,
                    "consumer": f"raw-drain-{p}", "offset": offset})
                assert r.get("ok"), r
                if not r["messages"]:
                    return msgs
                msgs += r["messages"]
                offset = r["next_offset"]

        assert drain(lead0, 0) == drain(lead1, 1) == payloads
        # Fallback contract: non-produce, junk, and empty batches all
        # decline so the canonical path answers.
        assert lead1._raw_produce(encode({"type": "consume"})) is None
        assert lead1._raw_produce(b"\x00junk") is None
        assert lead1._raw_produce(encode({
            "type": "produce", "topic": "topic1", "partition": 1,
            "messages": []})) is None

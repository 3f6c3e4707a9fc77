"""Directed regressions for the ownership lint's first-run findings
(their triage): each test reproduces the unguarded-shared-write race
the fix closed — failing before the fix, deterministic after.

The repro techniques: a class-level data descriptor intercepting the
racy attribute read sequence (simulating the concurrent invalidation at
the exact interleaving point), and hold-the-guard-and-probe (the fixed
code must BLOCK behind the mutex that now orders the write; the
pre-fix code sailed past it).

Twin of `tests/test_concurrency_triage.py` on the PyTorch port: the
same five directed races against the port's `DataPlane`,
`SegmentStore`, `BrokerServer`, `_Conn` and `LockstepController`.
"""

from __future__ import annotations

import threading
import time

import pytest

from tests.torch_port_modules import admit

admit(__name__)

# ---------------------------------------------------------------------------
# DataPlane._scan_store_for: the cached full-history scan index is
# nulled concurrently by store GC (drop_index_segments, duty thread)
# and install(); the pre-fix code re-read `self._scan_index` between
# the rebuild and the find, so a None landing in that window raised
# AttributeError out of a lagging consume. Fixed by local-ref
# discipline + swapping the shared slot under the plane's lock.
# ---------------------------------------------------------------------------


class _FakeIndex:
    def __init__(self, entry):
        self.entry = entry
        self.finds = 0

    def find(self, slot, offset):
        self.finds += 1
        return self.entry


def test_scan_index_local_ref_race():
    from ripplemq_tpu_torch.broker.dataplane import DataPlane

    covering = (100, 8, ("seg", 0))  # covers offsets [100, 108)
    idx = _FakeIndex(covering)

    class Stub:
        """Read #1 sees the cached index; read #2 simulates the duty
        thread's invalidation landing in between (returns None). The
        PRE-FIX code read the attribute twice on the happy path —
        `if self._scan_index is None` then `self._scan_index.find` —
        and crashed on the second read; the fixed code reads once into
        a local."""

        _lock = threading.Lock()
        _reads = 0

        @property
        def _scan_index(self):
            type(self)._reads += 1
            return idx if type(self)._reads == 1 else None

        @_scan_index.setter
        def _scan_index(self, v):
            pass  # the shared slot: swallowed (the race owns it)

    entry = DataPlane._scan_store_for(Stub(), slot=0, offset=104)
    assert entry == covering
    assert idx.finds == 1
    assert Stub._reads == 1, (
        f"_scan_store_for read the shared _scan_index slot "
        f"{Stub._reads}x on the happy path — each extra read is a "
        f"window for the GC invalidation race"
    )


# ---------------------------------------------------------------------------
# SegmentStore._kick_erasure: the rate-limit stamp + alive-check +
# thread start ran outside the store lock; two concurrent kicks (settle
# flush + flusher tick) could both pass the alive-check and start two
# encode workers. Fixed by running check-and-start under _lock.
# ---------------------------------------------------------------------------


def test_kick_erasure_serialized_under_store_lock(tmp_path):
    from ripplemq_tpu_torch.storage import erasure as erasure_mod
    from ripplemq_tpu_torch.storage.segment import SegmentStore

    entered = threading.Event()
    orig = erasure_mod.protect_store

    def hooked(directory, *a, **kw):
        entered.set()
        return None

    erasure_mod.protect_store = hooked
    store = SegmentStore(str(tmp_path / "store"), erasure=True,
                         use_native=False, device="cpu")
    try:
        store.append(1, 0, 0, b"x" * 16)
        store._erasure_check_t = -10.0  # clear the rate limit
        with store._lock:
            t = threading.Thread(target=store._kick_erasure, daemon=True)
            t.start()
            # The fixed kick BLOCKS behind the store lock: no worker
            # may start while we hold it (pre-fix: the alive-check and
            # start ran lock-free and the worker was already running
            # here).
            assert not entered.wait(0.3), (
                "_kick_erasure started an erasure worker while the "
                "store lock was held by another thread"
            )
        t.join(5.0)
        assert entered.wait(5.0), "worker never started after release"
    finally:
        erasure_mod.protect_store = orig
        store.close()


# ---------------------------------------------------------------------------
# BrokerServer._stamp_pid_seq: the lazy broker-pid adopt wrote
# _broker_pid OUTSIDE _stamp_lock while the duty's reap-adoption also
# writes it — the stamp and its pid could disagree. Fixed: the adopt
# and the sequence stamp share one _stamp_lock critical section.
# ---------------------------------------------------------------------------


class _ManagerStub:
    def producer_id(self, name):
        return 42


def test_stamp_pid_adopts_under_stamp_lock():
    from ripplemq_tpu_torch.broker.server import BrokerServer

    class Stub:
        _broker_pid = None
        _broker_pid_name = "broker-0"
        _stamp_lock = threading.Lock()
        _stamp_seqs: dict = {}
        manager = _ManagerStub()

    stub = Stub()
    out = {}

    def worker():
        out["ret"] = BrokerServer._stamp_pid_seq(stub, 0, 3)

    with stub._stamp_lock:
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        time.sleep(0.25)
        # While another thread holds _stamp_lock, the adopt must not
        # have happened yet (pre-fix: _broker_pid was written before
        # the lock was ever taken).
        assert stub._broker_pid is None, (
            "_stamp_pid_seq adopted the broker pid outside _stamp_lock"
        )
    t.join(5.0)
    assert out["ret"] == (42, 0)
    assert stub._broker_pid == 42
    assert stub._stamp_seqs[0] == 3


# ---------------------------------------------------------------------------
# _Conn._fail_all: the dead latch flipped outside pending_lock while
# send() checks it under the lock — the latch and the pending-dict swap
# must be one atomic transition or a racing send's future can miss both
# the refusal and the sweep. Fixed: dead flips inside pending_lock.
# ---------------------------------------------------------------------------


def test_conn_dead_latch_flips_under_pending_lock():
    from concurrent.futures import Future

    from ripplemq_tpu_torch.wire.transport import RpcError, _Conn

    conn = _Conn.__new__(_Conn)
    conn.pending = {}
    conn.pending_lock = threading.Lock()
    conn.write_lock = threading.Lock()
    conn.dead = False

    class _Sock:
        def close(self):
            pass

    conn.sock = _Sock()
    fut: Future = Future()
    conn.pending[7] = fut

    done = threading.Event()

    def failer():
        conn._fail_all(RpcError("lost"))
        done.set()

    with conn.pending_lock:
        t = threading.Thread(target=failer, daemon=True)
        t.start()
        time.sleep(0.25)
        # The latch may not flip while the pending dict is mid-
        # transaction on another thread (pre-fix: dead=True landed
        # here, decoupled from the sweep).
        assert conn.dead is False, (
            "_fail_all flipped the dead latch outside pending_lock"
        )
    assert done.wait(5.0)
    assert conn.dead is True
    assert isinstance(fut.exception(timeout=1), RpcError)


# ---------------------------------------------------------------------------
# LockstepController.broken: the permanent mesh-break latch was written
# on the error path with no lock while every engine thread can reach
# it. Fixed: the latch flips under the controller's sequence lock.
# ---------------------------------------------------------------------------


def test_lockstep_broken_latch_set_under_controller_lock():
    from ripplemq_tpu_torch.parallel.lockstep import LockstepController

    writes: list[bool] = []

    class Probe(LockstepController):
        @property
        def broken(self):
            return self.__dict__.get("_broken_value")

        @broken.setter
        def broken(self, v):
            writes.append(self._lock.locked())
            self.__dict__["_broken_value"] = v

    ctrl = Probe.__new__(Probe)
    ctrl._lock = threading.Lock()
    ctrl._seq = 0
    ctrl._timeout = 1.0

    def boom(method, args):
        raise RuntimeError("mesh gone")

    ctrl._send = boom
    with pytest.raises(RuntimeError):
        ctrl._call("step", [], lambda: None)
    assert ctrl.broken and "mesh gone" in ctrl.broken
    assert writes == [True], (
        f"broken latch written with lock states {writes} — the fix "
        f"orders the write under LockstepController._lock"
    )

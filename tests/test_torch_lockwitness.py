"""Runtime lock witness units for the port (twin of
`tests/test_lockwitness.py`, over `ripplemq_tpu_torch/obs/lockwitness.py`
and the port's static lock graph): recording
semantics, Condition-wait release accounting, cycle detection, and the
witnessed ⊆ static-closure cross-check the chaos smokes gate on.

Each test builds PRIVATE WitnessLock objects and resets the global
registry — the witness flag itself stays untouched except where a test
exercises the factory gating (restored in finally)."""

from __future__ import annotations

import threading

import pytest

from ripplemq_tpu_torch.obs import lockwitness as lw
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture(autouse=True)
def _clean_registry():
    lw.reset()
    yield
    lw.reset()


def _edge_pairs():
    return set(lw.edges().keys())


def test_nested_acquisition_records_edge():
    a = lw.WitnessLock("A.x")
    b = lw.WitnessLock("B.y")
    with a:
        with b:
            pass
    assert ("A.x", "B.y") in _edge_pairs()
    assert ("B.y", "A.x") not in _edge_pairs()


def test_sequential_acquisitions_record_nothing():
    a = lw.WitnessLock("A.x")
    b = lw.WitnessLock("B.y")
    with a:
        pass
    with b:
        pass
    assert _edge_pairs() == set()


def test_every_held_lock_edges_to_the_new_one():
    a, b, c = (lw.WitnessLock(n) for n in ("A.x", "B.y", "C.z"))
    with a, b, c:
        pass
    assert {("A.x", "B.y"), ("A.x", "C.z"), ("B.y", "C.z")} <= _edge_pairs()


def test_condition_wait_releases_the_held_entry():
    """cond.wait() RELEASES the mutex: an acquisition made by another
    thread during the wait window must NOT record an edge from the
    waiting thread's condition lock — exactly why the wrapper
    implements the _release_save/_acquire_restore protocol."""
    inner = lw.WitnessLock("Plane._cond")
    cond = threading.Condition(inner)
    other = lw.WitnessLock("Other.lock")
    started = threading.Event()
    release = threading.Event()

    def waiter():
        with cond:
            started.set()
            cond.wait(timeout=5.0)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    assert started.wait(5.0)
    # While the waiter sits INSIDE wait() (lock released), this thread
    # acquires both locks nested — the only legal edge involves them.
    with other:
        with inner:
            cond.notify_all()
            release.set()
    t.join(5.0)
    pairs = _edge_pairs()
    assert ("Other.lock", "Plane._cond") in pairs
    # No edge ever claims the condition was held across the window.
    assert ("Plane._cond", "Other.lock") not in pairs


def test_rlock_reentrancy_records_no_self_edge():
    r = lw.WitnessRLock("R.lock")
    with r:
        with r:
            pass
    assert ("R.lock", "R.lock") not in _edge_pairs()


def test_report_detects_cycle():
    a = lw.WitnessLock("A.x")
    b = lw.WitnessLock("B.y")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    rep = lw.report()
    assert not rep["acyclic"]
    assert rep["cycles"] == [["A.x", "B.y"]]


def test_report_static_closure_containment():
    a = lw.WitnessLock("A.x")
    b = lw.WitnessLock("B.y")
    c = lw.WitnessLock("C.z")
    with a:
        with b:
            pass
    with a:
        with c:
            pass
    # Static graph knows A→B directly and A→C only via B (closure).
    closure = {("A.x", "B.y"), ("A.x", "C.z"), ("B.y", "C.z")}
    rep = lw.report(static_closure=closure)
    assert rep["uncovered_edges"] == []
    # Remove the transitive knowledge: A→C becomes an uncovered edge.
    rep = lw.report(static_closure={("A.x", "B.y")})
    assert rep["uncovered_edges"] == [["A.x", "C.z"]]


def test_witnessed_condition_mutex_is_reentrant():
    """Raw `threading.Condition()` defaults to an RLock; the witnessed
    standalone condition must keep that — a legal reentrant path may
    never deadlock ONLY in debug mode (a review finding on the
    witness's first cut). wait() still fully releases the recursion count."""
    lw.enable()
    try:
        cond = lw.make_condition("P._cond")
    finally:
        lw.disable()
    with cond:
        with cond:  # reentrant: raw Condition allows this
            pass
    # Full-depth release across wait(): another thread can take the
    # mutex while the owner waits, even from depth 2.
    entered = threading.Event()

    def notifier():
        with cond:
            entered.set()
            cond.notify_all()

    with cond:
        with cond:
            t = threading.Thread(target=notifier, daemon=True)
            t.start()
            cond.wait(timeout=5.0)
    t.join(5.0)
    assert entered.is_set()


def test_factories_hand_out_raw_locks_while_disabled():
    assert not lw.enabled()
    assert isinstance(lw.make_lock("X.l"), type(threading.Lock()))
    assert lw.make_rlock("X.r").__class__.__name__ == "RLock"
    assert isinstance(lw.make_condition("X.c"), threading.Condition)


def test_factories_wrap_while_enabled():
    lw.enable()
    try:
        lk = lw.make_lock("X.l")
        assert isinstance(lk, lw.WitnessLock) and lk.name == "X.l"
        assert isinstance(lw.make_rlock("X.r"), lw.WitnessRLock)
        cond = lw.make_condition("X.c")
        # Standalone conditions wrap an RLOCK (raw Condition() default).
        assert isinstance(cond._lock, lw.WitnessRLock)
        # Shared-lock form keeps the caller's mutex (the
        # Condition(self._lock) alias idiom).
        shared = lw.make_lock("Y.l")
        cond2 = lw.make_condition("Y.c", lock=shared)
        assert cond2._lock is shared
    finally:
        lw.disable()


def test_witness_overhead_floor():
    """The wrapper must stay cheap enough for debug chaos runs: an
    uncontended acquire/release pair through the witness sustains a
    modest floor even on a loaded CI host (raw Lock does ~1-10M/s;
    the generous floor just catches accidental O(edges) work landing
    on the acquire path)."""
    import time

    lk = lw.WitnessLock("Bench.lock")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with lk:
            pass
    dt = time.perf_counter() - t0
    assert n / dt > 50_000, f"witnessed acquire/release at {n/dt:.0f}/s"


def test_static_closure_covers_live_witness_names():
    """Wiring check: every witnessed factory name in the tree is a node
    the static lock graph knows (the witness_name lint enforces the
    literal matches; this asserts the graph side so a factory rename
    cannot silently detach the containment check)."""
    from ripplemq_tpu_torch.analysis.framework import Repo
    from ripplemq_tpu_torch.analysis.lock_graph import build_graph

    lg = build_graph(Repo())
    for name in ("DataPlane._lock", "DataPlane._device_lock",
                 "SegmentStore._lock", "RoundReplicator._lock",
                 "StripeReplicator._lock", "RaftRunner.lock",
                 "PartitionManager.lock", "BrokerServer._stamp_lock"):
        assert name in lg.locks, f"{name} missing from the static graph"

"""Runtime lock witness: record ACTUAL per-thread lock-acquisition
orderings, off the hot path unless asked for.

Twin of `ripplemq_tpu/obs/lockwitness.py` (the port's stores create
their locks through these factories).

The static lock-order graph (`analysis/lock_graph.py`) derives "lock A
is held while lock B is acquired" edges from the AST — but the AST
cannot see through function-valued indirection (`replicate_wait_fn`,
duck-typed replicator planes) or runtime dispatch. This module closes
that static/dynamic gap the same way `stats_schema` closes
emit-site/doc drift: every host-path lock is created through the named
factories below, and when the witness is ENABLED each acquisition is
recorded against the acquiring thread's currently-held set. The chaos
smokes then assert two things about the witnessed graph:

- it is ACYCLIC (a witnessed cycle is a deadlock that simply has not
  scheduled yet), and
- it is CONTAINED in the static graph's transitive closure — a
  witnessed edge the AST missed means the static analysis lost
  coverage through an indirection, and the run FAILS so the edge gets
  derived or declared (lock_graph.DECLARED_EDGES) rather than silently
  unchecked.

Gating: `enabled()` is a process-global flag. The factories return RAW
`threading.Lock`/`RLock`/`Condition` objects while disabled — zero
wrapper, zero overhead, nothing to reason about in production. Enabling
(`enable()`, or `ClusterConfig.lock_witness: true` at broker boot)
affects locks created AFTER the call, so harnesses enable before
constructing the cluster (chaos `run_chaos(lock_witness=True)`,
`profiles/chaos_soak.py --witness`). Names passed to the factories are
the static graph's node ids (`ClassName.attr`); `analysis/lock_graph.py`
lints that every factory call site's name literal matches the attribute
it is assigned to, so the two planes cannot drift apart.
"""

from __future__ import annotations

import threading
from typing import Optional

_enabled = False
# (held_name, acquired_name) -> count of distinct observations. Guarded
# by _REG_LOCK on first insertion; reads ride the GIL (dict membership
# is atomic) so the recording fast path takes no lock once an edge is
# known.
_edges: dict[tuple[str, str], int] = {}
_names_seen: set[str] = set()
_REG_LOCK = threading.Lock()
_tls = threading.local()


def enable() -> None:
    """Turn the witness on for locks created from now on."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop every recorded edge (harnesses call between runs)."""
    with _REG_LOCK:
        _edges.clear()
        _names_seen.clear()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _note_acquire(name: str) -> None:
    held = _held()
    if held:
        for h in held:
            if h == name:
                # Same NAME already held: either RLock depth (handled
                # by the wrapper) or a sibling instance of the same
                # class lock — instance-blind by design, so no
                # self-edge (a name-level self-edge would read every
                # cross-broker in-proc acquisition as a deadlock).
                continue
            key = (h, name)
            # The count is part of the verdict: exact, under the
            # registry lock (the witness polices unguarded RMWs — it
            # does not get to commit one; debug-mode cost, measured in
            # PROFILE.md).
            with _REG_LOCK:
                _edges[key] = _edges.get(key, 0) + 1
    if name not in _names_seen:
        with _REG_LOCK:
            _names_seen.add(name)
    held.append(name)


def _note_release(name: str) -> None:
    held = _held()
    # Locks release out of acquisition order legitimately (hand-over-
    # hand), so drop the LAST occurrence of this name, not the top.
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class WitnessLock:
    """threading.Lock wrapper recording acquisition-order edges. Also a
    valid Condition(lock): `_release_save`/`_acquire_restore`/`_is_owned`
    mirror CPython's plain-lock fallbacks so Condition.wait() correctly
    pops the held entry for the wait window (wait RELEASES the lock —
    orderings observed inside the window must not claim it was held)."""

    __slots__ = ("_inner", "name")

    def __init__(self, name: str, inner=None) -> None:
        self._inner = inner if inner is not None else threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self.name)
        return got

    def release(self) -> None:
        _note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition(lock) protocol (CPython fallback semantics) --

    def _release_save(self):
        _note_release(self.name)
        self._inner.release()

    def _acquire_restore(self, _saved) -> None:
        self._inner.acquire()
        _note_acquire(self.name)

    def _is_owned(self) -> bool:
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


class WitnessRLock:
    """threading.RLock wrapper; reentrant depth tracked so nested
    acquisitions by the owner record one held entry, no self-edges.
    Implements the Condition(lock) protocol by delegating to the inner
    RLock's own `_release_save`/`_acquire_restore`/`_is_owned` (which
    fully release/restore the recursion count) so a witnessed
    Condition keeps raw `threading.Condition()` semantics — including
    REENTRANCY of the condition's mutex."""

    __slots__ = ("_inner", "name", "_owner", "_depth")

    def __init__(self, name: str) -> None:
        self._inner = threading.RLock()
        self.name = name
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            me = threading.get_ident()
            if self._owner == me:
                self._depth += 1
            else:
                self._owner = me
                self._depth = 1
                _note_acquire(self.name)
        return got

    def release(self) -> None:
        if self._depth > 1:
            self._depth -= 1
        else:
            self._depth = 0
            self._owner = None
            _note_release(self.name)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition(lock) protocol: wait() fully releases the recursion
    # count; the held entry pops for the whole wait window.

    def _release_save(self):
        state = self._inner._release_save()
        depth, self._depth = self._depth, 0
        self._owner = None
        _note_release(self.name)
        return (state, depth)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        self._inner._acquire_restore(state)
        self._owner = threading.get_ident()
        self._depth = depth
        _note_acquire(self.name)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def make_lock(name: str):
    """A mutex named for the static lock graph (`ClassName.attr`).
    Disabled: a raw threading.Lock."""
    if not _enabled:
        return threading.Lock()
    return WitnessLock(name)


def make_rlock(name: str):
    if not _enabled:
        return threading.RLock()
    return WitnessRLock(name)


def make_condition(name: str, lock=None):
    """A condition variable whose underlying mutex is witnessed under
    `name`. Pass `lock` to share an existing (witnessed or raw) mutex —
    the Condition-aliases-its-lock idiom (`analysis/lock_graph.py`
    models the alias the same way). The standalone form wraps an RLOCK,
    because raw `threading.Condition()` defaults to one — the witness
    must never make a legal reentrant path deadlock only in debug
    mode."""
    if lock is not None:
        return threading.Condition(lock)
    if not _enabled:
        return threading.Condition()
    return threading.Condition(WitnessRLock(name))


# ------------------------------------------------------------- reporting


def edges() -> dict[tuple[str, str], int]:
    with _REG_LOCK:
        return dict(_edges)


def report(static_closure: Optional[set] = None) -> dict:
    """JSON-able witness verdict: the observed edges, acyclicity, and —
    when the static graph's transitive closure is supplied — the
    witnessed edges the AST never derived (each one is a coverage hole
    that must become a derived or declared static edge)."""
    from ripplemq_tpu_torch.utils.graphs import cycles as _cycles

    obs = edges()
    found = _cycles(obs.keys())
    out = {
        "enabled": _enabled,
        "locks": sorted(_names_seen),
        "edges": sorted([a, b, n] for (a, b), n in obs.items()),
        "acyclic": not found,
        "cycles": found,
    }
    if static_closure is not None:
        out["uncovered_edges"] = sorted(
            [a, b] for (a, b) in obs if (a, b) not in static_closure
        )
    return out

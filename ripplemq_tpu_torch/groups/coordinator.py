"""Coordinator state machine + liveness: the broker side of groups.

GroupTable is the metadata state machine's group section — mutated ONLY
by replicated OP_GROUP_JOIN / OP_GROUP_LEAVE applies (broker/manager.py)
so every broker holds the identical generation/assignment picture, and
generation fencing on offset commits can be checked wherever the commit
lands. GroupLiveness is the metadata leader's VOLATILE heartbeat ledger:
members beat against the current leader, the leader's duty evicts
members whose session lapsed by proposing OP_GROUP_LEAVE (reason
"evicted") — a leader change simply restarts every member's grace
window, the standard cost of volatile liveness.

Twin of `ripplemq_tpu/groups/coordinator.py` (PyTorch port): the same
code, importing only the port's modules, so both packages behave alike
step for step.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ripplemq_tpu_torch.groups.state import (
    GroupState,
    compute_assignment,
    compute_assignment_delta,
)


class GroupTable:
    """All groups' replicated state. NOT internally locked: the owner
    (PartitionManager) serializes applies and reads under its own lock.

    Two mutation modes: the per-op path (`join`/`leave`) rebalances the
    touched group IMMEDIATELY — one generation bump per membership
    event, the pre-wave shape that standalone OP_GROUP_JOIN /
    OP_GROUP_LEAVE applies still use. The WAVE path
    (`join_deferred`/`leave_deferred` + `finish_wave`) applies every
    membership mutation of one OP_BATCH wave first and rebalances each
    TOUCHED group exactly once at the end: N joins to one group cost
    one generation bump and one assignment compute, and a replayed
    duplicate wave (leader retry straddling a failover) finds every
    sub-op a no-op and bumps nothing."""

    def __init__(self) -> None:
        self.groups: dict[str, GroupState] = {}
        # Transient wave bookkeeping, alive only inside one OP_BATCH
        # apply (the manager holds its lock across the whole wave):
        # group → (pre-wave members snapshot, changed member ids).
        self._wave: dict[str, tuple[dict[str, tuple[str, ...]],
                                    set[str]]] = {}

    def join(self, group: str, member: str, topics: tuple[str, ...],
             topic_partitions: dict[str, int]) -> tuple[GroupState, bool]:
        """Apply one member join. Returns (state, changed): re-joining
        with an unchanged subscription is a no-op (join proposals are
        retried/duplicated by clients; idempotence keeps the generation
        from churning under replays)."""
        st, changed = self._join_members(group, member, topics)
        if changed:
            self._rebalance(st, topic_partitions)
        return st, changed

    def _join_members(self, group: str, member: str,
                      topics: tuple[str, ...]) -> tuple[GroupState, bool]:
        """Membership half of a join (no rebalance)."""
        st = self.groups.get(group)
        if st is None:
            st = self.groups[group] = GroupState(name=group)
        topics = tuple(sorted(set(topics)))
        if st.members.get(member) == topics:
            return st, False
        st.members[member] = topics
        return st, True

    # ------------------------------------------------------ wave deferral

    def join_deferred(self, group: str, member: str,
                      topics: tuple[str, ...]) -> tuple[GroupState, bool]:
        """Wave-mode join: mutate membership now, rebalance at
        `finish_wave`. Returns (state, changed) with the same
        idempotence as `join`."""
        self._wave_touch(group)
        st, changed = self._join_members(group, member, topics)
        if changed:
            self._wave[group][1].add(member)
        return st, changed

    def leave_deferred(self, group: str, member: str
                       ) -> tuple[Optional[GroupState], bool, bool]:
        """Wave-mode leave: mutate membership now, rebalance at
        `finish_wave`. Returns (state, changed, emptied) like `leave`."""
        st = self.groups.get(group)
        if st is None or member not in st.members:
            return st, False, False
        self._wave_touch(group)
        del st.members[member]
        self._wave[group][1].add(member)
        return st, True, not st.members

    def _wave_touch(self, group: str) -> None:
        if group not in self._wave:
            st = self.groups.get(group)
            snapshot = dict(st.members) if st is not None else {}
            self._wave[group] = (snapshot, set())

    def finish_wave(self, topic_partitions: dict[str, int]
                    ) -> list[tuple[str, GroupState]]:
        """Rebalance every group the wave CHANGED — one generation bump
        and one (incremental) assignment compute per touched group, in
        sorted group order (deterministic across brokers). Groups whose
        sub-ops all no-opped (a duplicate wave) are skipped: their
        generation does not move, so a replayed wave fences nothing.
        Returns the rebalanced (name, state) pairs for event
        recording."""
        out: list[tuple[str, GroupState]] = []
        for group in sorted(self._wave):
            prev_members, changed = self._wave[group]
            st = self.groups.get(group)
            if st is None or not changed:
                continue
            st.generation += 1
            st.assignment = dict(compute_assignment_delta(
                st.members, topic_partitions, st.assignment,
                prev_members, changed,
            ))
            out.append((group, st))
        self._wave.clear()
        return out

    def leave(self, group: str, member: str,
              topic_partitions: dict[str, int]
              ) -> tuple[Optional[GroupState], bool, bool]:
        """Apply one member leave/eviction. Returns (state, changed,
        emptied). An EMPTIED group is RETAINED — generation monotone,
        shared offsets intact — not dropped: a rebalance storm (or a
        partition separating every member from the heartbeat path) can
        empty a group TRANSIENTLY, and dropping it would restart
        generations at 1 and recycle the offset slot mid-life, so the
        re-formed group re-consumes the whole log from 0 (caught by the
        randomized storm soak as group-commit regressions + redelivery).
        Truly dead groups are reaped by `delete()` after the metadata
        leader's retention window (`group_retention_s`)."""
        st = self.groups.get(group)
        if st is None or member not in st.members:
            return st, False, False
        del st.members[member]
        self._rebalance(st, topic_partitions)
        return st, True, not st.members

    def delete(self, group: str) -> bool:
        """Reap one group iff it is (still) EMPTY — the deterministic
        apply of OP_GROUP_DELETE (a join racing the reap proposal keeps
        the group: membership wins). Returns whether it was dropped;
        the caller releases the shared consumer slot."""
        st = self.groups.get(group)
        if st is None or st.members:
            return False
        del self.groups[group]
        return True

    def empty_groups(self) -> list[str]:
        return sorted(n for n, st in self.groups.items() if not st.members)

    def _rebalance(self, st: GroupState,
                   topic_partitions: dict[str, int]) -> None:
        st.generation += 1
        st.assignment = dict(compute_assignment(
            st.members, topic_partitions, previous=st.assignment
        ))

    # ------------------------------------------------------------- queries

    def state(self, group: str) -> Optional[GroupState]:
        return self.groups.get(group)

    def summary(self) -> dict:
        """admin.stats surface: per-group generation + membership."""
        return {
            name: {
                "generation": st.generation,
                "members": sorted(st.members),
                "partitions": sum(len(k) for k in st.assignment.values()),
            }
            for name, st in self.groups.items()
        }

    # ---------------------------------------------------------- wire state

    def to_wire(self) -> dict:
        return {name: st.to_wire() for name, st in self.groups.items()}

    @staticmethod
    def from_wire(d: dict) -> "GroupTable":
        t = GroupTable()
        for name, st in (d or {}).items():
            t.groups[str(name)] = GroupState.from_wire(st)
        return t


class GroupLiveness:
    """Volatile heartbeat ledger (metadata leader only). A member is
    evictable once `session_timeout_s` passes with no beat — measured
    from its FIRST SIGHTING on this leader, so a fresh leader (or a
    just-joined member that has not beaten yet) grants a full grace
    window instead of evicting on day-zero silence."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._last: dict[tuple[str, str], float] = {}

    def beat(self, group: str, member: str) -> None:
        self._last[(group, member)] = self._clock()

    def forget(self, group: str, member: str) -> None:
        self._last.pop((group, member), None)

    def clear(self) -> None:
        """Drop every stamp — called when the owning broker LOSES the
        metadata lease. Stamps from a previous tenure are stale (members
        beat the new leader meanwhile); keeping them would let a
        re-elected leader's first duty tick mass-evict healthy members."""
        self._last.clear()

    def plan_evictions(self, table: GroupTable,
                       session_timeout_s: float) -> list[tuple[str, str]]:
        """Members of `table` whose session lapsed. Also seeds the grace
        window for members never seen on this leader, and prunes stamps
        for members no longer in the table."""
        now = self._clock()
        live_keys = {
            (name, m)
            for name, st in table.groups.items()
            for m in st.members
        }
        for key in list(self._last):
            if key not in live_keys:
                del self._last[key]
        out = []
        for key in live_keys:
            t = self._last.setdefault(key, now)  # first sighting = grace
            if now - t > session_timeout_s:
                out.append(key)
        return sorted(out)

"""Replicated consumer-group state + the deterministic assignment rule.

Everything here is applied inside the metadata Raft's state machine
(broker/manager.py), so it must be a PURE function of replicated inputs:
the member set (with subscriptions), the static topic table, and the
previous assignment. Every broker's apply computes the identical
assignment for the identical generation — there is no separate
"assignment proposal" round trip, and a member learns its partitions
from any broker's replicated view (join response / heartbeat).

Twin of `ripplemq_tpu/groups/state.py` (PyTorch port): the same code,
importing only the port's modules, so both packages behave alike step
for step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ripplemq_tpu_torch.metadata.models import GroupKey


def group_consumer_name(group: str) -> str:
    """The group's SHARED offset-tracking consumer name: all members
    commit under it, so a partition moving between members resumes from
    the group's last acked commit (one engine consumer slot per group,
    not per member)."""
    return f"g/{group}"


@dataclasses.dataclass
class GroupState:
    """One group's replicated state. `members` maps member id → its
    subscribed topics; `assignment` maps member id → assigned
    (topic, partition) tuples, recomputed on every membership change
    under a bumped `generation` (the fencing epoch)."""

    name: str
    generation: int = 0
    members: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )
    assignment: dict[str, tuple[GroupKey, ...]] = dataclasses.field(
        default_factory=dict
    )

    def owner_of(self, key: GroupKey) -> Optional[str]:
        for member, keys in self.assignment.items():
            if key in keys:
                return member
        return None

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "generation": self.generation,
            "members": {m: list(ts) for m, ts in self.members.items()},
            "assignment": {
                m: [[t, p] for t, p in keys]
                for m, keys in self.assignment.items()
            },
        }

    @staticmethod
    def from_wire(d: dict) -> "GroupState":
        return GroupState(
            name=str(d["name"]),
            generation=int(d["generation"]),
            members={
                str(m): tuple(str(t) for t in ts)
                for m, ts in d.get("members", {}).items()
            },
            assignment={
                str(m): tuple((str(t), int(p)) for t, p in keys)
                for m, keys in d.get("assignment", {}).items()
            },
        )


def _topic_quota(subs: list[str], nparts: int) -> dict[str, int]:
    """Even-split quota per member for one topic: the first `extra`
    members (sorted order) take one more."""
    base, extra = divmod(nparts, len(subs))
    return {m: base + (1 if i < extra else 0) for i, m in enumerate(subs)}


def _assign_topic(subs: list[str], nparts: int,
                  prev_owner: dict[GroupKey, str],
                  topic: str) -> dict[GroupKey, str]:
    """One topic's sticky rule: previous owners keep their partitions
    while still subscribed and under quota; orphans fill to members
    under quota in sorted order. Deterministic in its arguments."""
    quota = _topic_quota(subs, nparts)
    taken: dict[str, int] = {m: 0 for m in subs}
    assigned: dict[GroupKey, str] = {}
    # Sticky pass: keep previous owners under quota.
    for pid in range(nparts):
        key = (topic, pid)
        owner = prev_owner.get(key)
        if owner in quota and taken[owner] < quota[owner]:
            assigned[key] = owner
            taken[owner] += 1
    # Fill pass: orphaned partitions go to members under quota, in
    # sorted order (deterministic).
    for pid in range(nparts):
        key = (topic, pid)
        if key in assigned:
            continue
        for m in subs:
            if taken[m] < quota[m]:
                assigned[key] = m
                taken[m] += 1
                break
    return assigned


def compute_assignment(
    members: dict[str, tuple[str, ...]],
    topic_partitions: dict[str, int],
    previous: Optional[dict[str, tuple[GroupKey, ...]]] = None,
) -> dict[str, tuple[GroupKey, ...]]:
    """Deterministic STICKY assignment: per topic, partitions spread
    evenly over the subscribing members (sorted by id), and a partition
    stays with its previous owner whenever that owner is still
    subscribed and under its even-split quota — the cooperative half of
    a rebalance (membership churn moves the minimum number of
    partitions, so an N-member storm does not reshuffle the world on
    every join/leave). Pure function of its arguments: every broker's
    metadata apply computes the identical map."""
    previous = previous or {}
    out: dict[str, list[GroupKey]] = {m: [] for m in members}
    for topic in sorted(topic_partitions):
        subs = sorted(m for m, ts in members.items() if topic in ts)
        if not subs:
            continue
        prev_owner = {
            key: m
            for m, keys in previous.items()
            for key in keys
            if key[0] == topic
        }
        assigned = _assign_topic(subs, topic_partitions[topic],
                                 prev_owner, topic)
        for key, m in assigned.items():
            out[m].append(key)
    return {m: tuple(sorted(keys)) for m, keys in out.items()}


def compute_assignment_delta(
    members: dict[str, tuple[str, ...]],
    topic_partitions: dict[str, int],
    previous: Optional[dict[str, tuple[GroupKey, ...]]],
    prev_members: dict[str, tuple[str, ...]],
    changed: set[str],
) -> dict[str, tuple[GroupKey, ...]]:
    """Incremental sticky assignment for a wave that touched only the
    members in `changed` (joined, left, or re-subscribed between
    `prev_members` and `members`). Topics no changed member subscribes
    to — now or before — keep their previous per-topic slice VERBATIM:
    the per-topic rule is a fixpoint on an unchanged subscriber set
    (every owner sits exactly at quota, so the sticky pass keeps
    everything and the fill pass is empty), so recomputing would return
    the same bytes. Affected topics rerun the full per-topic rule,
    which moves only the minimum member set by stickiness. Falls back
    to the full rule per topic whenever the fast path's preconditions
    fail (partition count changed under a split/merge, or the previous
    slice is not a quota-exact cover). Output is IDENTICAL to
    `compute_assignment(members, topic_partitions, previous)` — the
    directed equivalence test in tests/test_group_waves.py holds this
    over randomized churn."""
    previous = previous or {}
    affected: set[str] = set()
    for m in changed:
        affected.update(prev_members.get(m, ()))
        affected.update(members.get(m, ()))
    out: dict[str, list[GroupKey]] = {m: [] for m in members}
    for topic in sorted(topic_partitions):
        subs = sorted(m for m, ts in members.items() if topic in ts)
        nparts = topic_partitions[topic]
        prev_slice = [
            (m, key)
            for m, keys in previous.items()
            for key in keys
            if key[0] == topic
        ]
        if topic not in affected and subs:
            # Fast path: reuse the previous slice if it is a
            # quota-exact cover of [0, nparts) owned by current subs —
            # exactly the states the full rule emits, on which it is
            # idempotent.
            quota = _topic_quota(subs, nparts)
            counts: dict[str, int] = {m: 0 for m in subs}
            pids = []
            valid = True
            for m, key in prev_slice:
                if m not in counts:
                    valid = False
                    break
                counts[m] += 1
                pids.append(key[1])
            if valid and sorted(pids) == list(range(nparts)) \
                    and counts == quota:
                for m, key in prev_slice:
                    out[m].append(key)
                continue
        if not subs:
            continue
        prev_owner = {key: m for m, key in prev_slice}
        assigned = _assign_topic(subs, nparts, prev_owner, topic)
        for key, m in assigned.items():
            out[m].append(key)
    return {m: tuple(sorted(keys)) for m, keys in out.items()}

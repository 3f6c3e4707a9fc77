"""Sticky, least-loaded replica placement — the cluster's only scheduler.

Pure-function re-design of the reference's PartitionAssigner (reference:
mq-broker/src/main/java/metadata/PartitionAssigner.java:25-115), preserving
its semantics:

- **Sticky**: replicas of an existing assignment that are still alive are
  kept (`:61-67`); dead ones are dropped.
- **Top-up**: each partition is topped up to its topic's replication
  factor with the least-loaded live broker that does not already hold the
  partition (`:81-89`, `:103-115`). Load = number of partition replicas a
  broker holds across the whole new assignment.
- **Slot stability (deviation, required by the device engine)**: the
  position of a broker in the `replicas` tuple IS its physical replica
  slot in the device state ([R] axis) — per-slot logs never move when the
  assignment changes. A surviving broker therefore KEEPS its position;
  dead brokers leave holes that replacements fill in place. (The
  reference can compact the list freely because each JRaft group carries
  its own identity-keyed log.) Without this, a reassignment would remap a
  retained leader onto a stale physical slot and a quorum of stale slots
  could commit at a stale base. Replacement brokers inherit a stale
  physical slot by design: they flip that slot dead→alive, which triggers
  the controller's resync-from-leader before the slot serves.
- **Leader retention**: a previous leader that survives in the replica set
  stays leader; otherwise the leader becomes unknown until the partition
  group elects and advertises one (the reference clears it the same way
  through its re-election fixpoint).
- **Error on infeasible RF**: replication factor greater than the live
  broker count raises (`:46-48`).

Determinism note: ties in "least-loaded" are broken by broker id so the
same inputs always produce the same assignment — the reference inherits
whatever order its HashMap iteration yields; determinism is required here
because every broker recomputes assignments and the metadata Raft only
converges if the leader's proposal is reproducible in tests.

Twin of `ripplemq_tpu/metadata/assigner.py` (PyTorch port): the same
code, importing only the port's modules, so both packages behave alike
step for step.
"""

from __future__ import annotations

from ripplemq_tpu_torch.metadata.models import PartitionAssignment, Topic


def assign_partitions(
    topics: list[Topic],
    live_brokers: list[int],
    previous: list[Topic] | None = None,
) -> list[Topic]:
    """Compute a full new assignment for every topic.

    `previous` carries the existing assignments (for stickiness); pass
    None on first boot. Returns new Topic values; never mutates inputs.
    """
    live = sorted(set(live_brokers))
    if not live:
        raise ValueError("no live brokers to assign partitions to")

    prev_by_name = {t.name: t for t in (previous or [])}
    load: dict[int, int] = {b: 0 for b in live}

    # Pass 1: survivors — keep alive brokers in their replica-slot
    # POSITIONS (dead brokers become None holes), counting retained
    # replicas into the load table first so top-up decisions see the true
    # load (the reference builds load the same way,
    # PartitionAssigner.java:50-67).
    survivors: dict[tuple[str, int], list[int | None]] = {}
    prev_leaders: dict[tuple[str, int], int | None] = {}
    prev_terms: dict[tuple[str, int], int] = {}
    for topic in topics:
        if topic.replication_factor > len(live):
            raise ValueError(
                f"topic {topic.name!r}: replication factor "
                f"{topic.replication_factor} exceeds live broker count {len(live)}"
            )
        prev_topic = prev_by_name.get(topic.name)
        prev_assigns = (
            {a.partition_id: a for a in prev_topic.assignments} if prev_topic else {}
        )
        rf = topic.replication_factor
        for pid in range(topic.partitions):
            prev_assign = prev_assigns.get(pid)
            prev_replicas = prev_assign.replicas if prev_assign else ()
            slots: list[int | None] = [
                b if b in load else None for b in prev_replicas[:rf]
            ]
            slots += [None] * (rf - len(slots))
            for b in slots:
                if b is not None:
                    load[b] += 1
            survivors[(topic.name, pid)] = slots
            prev_leaders[(topic.name, pid)] = prev_assign.leader if prev_assign else None
            prev_terms[(topic.name, pid)] = prev_assign.term if prev_assign else 0

    # Pass 2: fill each hole in place with the least-loaded live broker not
    # already holding the partition (ties → lowest broker id).
    out: list[Topic] = []
    for topic in topics:
        assignments: list[PartitionAssignment] = []
        for pid in range(topic.partitions):
            slots = list(survivors[(topic.name, pid)])
            held = {b for b in slots if b is not None}
            for i, b in enumerate(slots):
                if b is not None:
                    continue
                candidates = [c for c in live if c not in held]
                pick = min(candidates, key=lambda c: (load[c], c))
                slots[i] = pick
                held.add(pick)
                load[pick] += 1
            prev_leader = prev_leaders[(topic.name, pid)]
            leader = prev_leader if prev_leader in slots else None
            assignments.append(
                PartitionAssignment(
                    pid, tuple(slots), leader, prev_terms[(topic.name, pid)]
                )
            )
        out.append(topic.with_assignments(tuple(assignments)))
    return out

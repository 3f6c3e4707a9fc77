"""Operation history + queue-semantics safety checker.

Clients record every operation's observable outcome; after the nemesis
heals, the checker replays the history against the final drained logs
and reports INVARIANT VIOLATIONS — the Jepsen/Elle method
(arXiv:2003.10554, PAPERS.md) specialized to this queue's contract:

1. **No acked loss** — a produce the client saw succeed must appear in
   the final log of its partition (settled rounds were quorum-committed
   AND standby-acked before the ack, so a crash/partition schedule that
   loses one is a real safety bug, not bad luck).
2. **No phantoms** — nothing in a final log or a consume batch that no
   producer ever sent.
3. **Clean-ack exactly-once, UNCONDITIONALLY** — a cleanly acked
   produce (first attempt, no client retry) appears exactly once, under
   EVERY schedule including wire duplication. There is no suspension
   under `dup_next` schedules: idempotent producer ids + the broker's
   replicated (pid, seq) dedup table (client/producer.py,
   broker/dataplane.py) collapse duplicated RPCs — on the client hop,
   the forwarded leader→controller hop (broker-stamped), and across
   controller failover. Retried/unknown-outcome produces may still
   legitimately duplicate (an abandoned batch burns its sequence
   range), so only clean acks are held to exactly-once.
4. **Log order consistency** — each consumer's delivered sequence per
   partition is a subsequence of the final log (no reorder, no
   divergent replica serving a different history), and two reads at the
   same storage offset never disagree (committed-prefix consistency).
5. **Offset monotonicity** — per (consumer, partition): read positions
   and acked commits never move backward, and no read re-delivers rows
   below an offset whose commit was already acked (at-most-once
   delivery: the auto-commit contract, client/consumer.py docstring).

Ops are plain JSON-able dicts so a failing run's history can be dumped
next to its fault trace and replayed offline.

Twin of `ripplemq_tpu/chaos/history.py` (PyTorch port): the same code,
importing only the port's modules; its verdicts equal the reference's on
one history.
"""

from __future__ import annotations

import threading

from ripplemq_tpu_torch.obs.lockwitness import make_lock
import time
from typing import Optional

from ripplemq_tpu_torch.wire.retry import RetryPolicy


class History:
    """Thread-safe append-only operation log (workload threads record
    concurrently with nemesis phases)."""

    def __init__(self) -> None:
        self._lock = make_lock("History._lock")
        self._ops: list[dict] = []

    def record(self, **op) -> None:
        with self._lock:
            op["i"] = len(self._ops)  # stable total order of recording
            op["t"] = round(time.time(), 4)  # forensics: align with logs
            self._ops.append(op)

    def ops(self) -> list[dict]:
        with self._lock:
            return list(self._ops)


class TrackingRetryPolicy(RetryPolicy):
    """RetryPolicy that remembers the last operation's RetryRun, so a
    single-threaded workload can ask "did that produce retry?" — the
    fact that decides whether a duplicate in the final log is a
    contract violation (clean ack) or legitimate at-least-once fallout
    (retried ack)."""

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.last_run = None

    def begin(self):
        run = super().begin()
        self.last_run = run
        return run


# ----------------------------------------------------------------- checker

def _subsequence_gap(needle: list[str], hay: list[str]) -> Optional[str]:
    """First element of `needle` that cannot be matched while scanning
    `hay` in order (None = needle is a subsequence of hay)."""
    it = iter(hay)
    for x in needle:
        for y in it:
            if y == x:
                break
        else:
            return x
    return None


def check_history(ops: list[dict],
                  final_logs: dict[tuple[str, int], list[str]],
                  loss_grace: Optional[list[tuple[float, float]]] = None,
                  stripe: Optional[dict] = None,
                  ) -> list[str]:
    """Return the list of invariant violations (empty = safe).

    `ops`: History.ops(). `final_logs`: {(topic, partition): [payload,
    ...]} — every partition's full committed log drained AFTER heal.
    Clean-ack exactly-once is asserted UNCONDITIONALLY — including under
    wire-duplication schedules; idempotent producer dedup is the
    machinery that must make it hold (module docstring, invariant 3).

    `loss_grace`: wall-clock [(t0, t1)] windows inside which an acked
    produce is EXEMPT from the no-loss check — the `flush_async`
    durability contract made explicit: zero acked loss while
    any quorum member of a round survives un-killed (random schedules
    keep a majority alive, so they pass no windows and the check stays
    absolute); after a CORRELATED full-cluster kill, acked loss is
    bounded by one flush interval, and the kill-all drill passes the
    pre-kill window here. `durability=strict` deployments opt out of
    the lag entirely — the drill passes no window for them either.

    `stripe`: the striped-replication k-of-k+m durability contract
    ({"k": K, "m": M, "holders_down": N}, run_chaos's replication_mode=
    "striped"). The plane claims ZERO acked loss while any k stripe-
    holders survive — i.e. while at most m holders are lost at once —
    so with holders_down <= m the no-loss check stays ABSOLUTE (the
    generated schedules size stripe kills to m, keeping it absolute on
    every seeded run). holders_down > m is the documented beyond-
    contract regime (a hand-written schedule or a replay edit):
    acked-loss findings are then SUPPRESSED from the violation list —
    exactly the loss_grace philosophy, keyed on holder count instead
    of wall clock. run_chaos marks such verdicts with
    `beyond_stripe_contract: true` so a clean-looking run cannot
    silently be one whose loss checking was waived.
    """
    violations: list[str] = []
    beyond_stripe_contract = (
        stripe is not None
        and int(stripe.get("holders_down", 0)) > int(stripe.get("m", 0))
    )
    produced: dict[str, dict] = {}
    for op in ops:
        if op.get("op") == "produce":
            produced[op["payload"]] = op

    # 1 + 3: acked durability and clean-ack exactly-once.
    log_counts: dict[tuple[str, int], dict[str, int]] = {}
    for part, log in final_logs.items():
        counts: dict[str, int] = {}
        for p in log:
            counts[p] = counts.get(p, 0) + 1
        log_counts[part] = counts
    for payload, op in produced.items():
        part = (op["topic"], op["partition"])
        n = log_counts.get(part, {}).get(payload, 0)
        if op["status"] == "ok" and n == 0:
            t = op.get("t")
            in_grace = loss_grace is not None and t is not None and any(
                t0 <= t <= t1 for t0, t1 in loss_grace
            )
            if not in_grace and not beyond_stripe_contract:
                violations.append(
                    f"acked loss: produce {payload!r} -> {part} acked "
                    f"(attempts={op.get('attempts', 1)}) but absent from "
                    f"the final log"
                )
        if op["status"] == "ok" and op.get("attempts", 1) == 1 and n > 1:
            violations.append(
                f"duplicate beyond contract: clean first-attempt ack of "
                f"{payload!r} appears {n}x in {part}"
            )

    # 2: phantoms — in the final logs…
    for part, log in final_logs.items():
        for payload in log:
            if payload not in produced:
                violations.append(
                    f"phantom: {payload!r} in final log of {part} was "
                    f"never produced"
                )
    # …and in consume batches.
    for op in ops:
        if op.get("op") != "consume" or op.get("status") != "ok":
            continue
        for payload in op.get("payloads", []):
            if payload not in produced:
                violations.append(
                    f"phantom delivery: consumer {op['client']} got "
                    f"{payload!r} never produced"
                )

    # 4: per-consumer delivered order is a subsequence of the final log;
    # same-offset reads agree (committed-prefix consistency).
    streams: dict[tuple[str, str, int], list[str]] = {}
    by_offset: dict[tuple[str, int, int], list[str]] = {}
    for op in ops:
        if op.get("op") != "consume" or op.get("status") != "ok":
            continue
        key = (op["client"], op["topic"], op["partition"])
        streams.setdefault(key, []).extend(op.get("payloads", []))
        if op.get("payloads"):
            okey = (op["topic"], op["partition"], op["offset"])
            prev = by_offset.get(okey)
            cur = list(op["payloads"])
            if prev is not None:
                short, long_ = sorted((prev, cur), key=len)
                if long_[: len(short)] != short:
                    violations.append(
                        f"divergent reads at {okey}: {prev!r} vs {cur!r}"
                    )
                by_offset[okey] = long_
            else:
                by_offset[okey] = cur
    for (client, topic, pid), seq in streams.items():
        log = final_logs.get((topic, pid), [])
        gap = _subsequence_gap(seq, log)
        if gap is not None:
            violations.append(
                f"order violation: consumer {client} stream for "
                f"({topic}, {pid}) is not a subsequence of the final log "
                f"(first mismatch at {gap!r})"
            )

    # 5: offset monotonicity + no redelivery below an acked commit.
    pos: dict[tuple[str, str, int], int] = {}
    committed: dict[tuple[str, str, int], int] = {}
    for op in ops:
        key = (op.get("client"), op.get("topic"), op.get("partition"))
        if op.get("op") == "consume" and op.get("status") == "ok":
            off, nxt = int(op["offset"]), int(op["next_offset"])
            if nxt < off:
                violations.append(
                    f"offset regression within read: {op}"
                )
            if off < pos.get(key, 0):
                violations.append(
                    f"offset went backward for {key}: read at {off} after "
                    f"position {pos[key]}"
                )
            if op.get("payloads") and off < committed.get(key, 0):
                violations.append(
                    f"redelivery below acked commit for {key}: read at "
                    f"{off} < committed {committed[key]} (at-most-once "
                    f"contract)"
                )
            pos[key] = max(pos.get(key, 0), nxt if op.get("payloads") else off)
        elif op.get("op") == "commit" and op.get("status") == "ok":
            off = int(op["offset"])
            if off < committed.get(key, 0):
                violations.append(
                    f"acked commit went backward for {key}: {off} < "
                    f"{committed[key]}"
                )
            committed[key] = max(committed.get(key, 0), off)
    return violations


def check_group_history(ops: list[dict]) -> list[str]:
    """Consumer-group invariants over a GroupWorkload's history
    (chaos/groups.py records these op shapes):

    1. **No same-generation dual ownership** — `assignment` ops record
       each member's observed (generation, partitions); two members of
       the SAME group and generation claiming one partition is a
       coordinator bug (the assignment is a deterministic function of
       the replicated member set — overlap means divergent applies).
       Cross-generation overlap is the normal handover and is fine.
    2. **Acked group commits survive rebalance** — per (group, topic,
       partition), acked commit offsets never move backward in recorded
       order, ACROSS members: a partition's new owner resumes at-or-
       after the old owner's last acked commit, and no later owner's
       commit regresses it (the shared-offset contract generation
       fencing protects).
    3. **Stale-generation commits are refused** — a commit op marked
       `stale=True` (the nemesis's commit-from-deposed-member op) that
       was ACKED is a fencing hole; refusals are the required outcome.
    """
    violations: list[str] = []

    # 1: same-generation ownership is disjoint across members.
    owners: dict[tuple[str, int, str, int], set[str]] = {}
    for op in ops:
        if op.get("op") != "assignment":
            continue
        group, gen, member = op["group"], int(op["generation"]), op["member"]
        for t, p in op.get("partitions", []):
            key = (group, gen, t, int(p))
            claimants = owners.setdefault(key, set())
            claimants.add(member)
            if len(claimants) > 1:
                violations.append(
                    f"dual ownership: {sorted(claimants)} both own "
                    f"({t}, {p}) in {group} generation {gen}"
                )

    # 2: cross-member group commit monotonicity (recorded order).
    committed: dict[tuple[str, str, int], int] = {}
    for op in ops:
        if (op.get("op") != "commit" or op.get("status") != "ok"
                or op.get("group") is None):
            continue
        key = (op["group"], op["topic"], int(op["partition"]))
        off = int(op["offset"])
        # 3: an acked stale-generation commit is a fencing hole.
        if op.get("stale"):
            violations.append(
                f"stale-generation commit ACKED for {key} at {off} "
                f"(member {op.get('member')}, generation "
                f"{op.get('generation')}): fencing hole"
            )
        if off < committed.get(key, 0):
            violations.append(
                f"group commit regressed for {key}: {off} < "
                f"{committed[key]} (member {op.get('member')}) — an "
                f"acked offset commit did not survive the rebalance"
            )
        committed[key] = max(committed.get(key, 0), off)
    return violations

"""Seeded nemesis: reproducible fault schedules against an in-proc cluster.

The schedule is a PURE FUNCTION of (seed, broker roster, shape knobs) —
`make_schedule` consults nothing dynamic (no wall clock, no cluster
state), so two runs with the same seed apply byte-for-byte identical
fault traces even though the cluster's reactions (elections, promotions,
retries) differ in timing. That is the property that makes a chaos
failure a BUG REPORT: re-run `run_chaos(seed=N)` and the same
adversary returns.

Fault vocabulary (composing the InProcNetwork hooks, wire/transport.py):

  crash b        kill broker b (network-down + stopped; durable state kept)
  restart b      boot a fresh process-equivalent for a crashed broker
  isolate b      symmetric partition of b from every other broker
  partition a b  symmetric link partition between two brokers
  oneway a b     asymmetric partition: only a→b traffic vanishes
  drop a b n     drop the next n requests on a link
  delay a b n s  stall the next n requests on a link by s seconds
  dup a b n      deliver the next n requests on a link twice
  kill_worker w  lockstep engine-worker kill (only when the cluster
                 runs a lockstep mesh; exercises abdication/promotion)
  split_partition i   online split of the i-th splittable partition
                 (elastic runs; resolved at apply time, admin.split)
  merge_partitions i  reabsorb the i-th mergeable split child
                 (elastic runs; resolved at apply time, admin.merge)
  churn_burst [i...]  simultaneous leave+rejoin of several group
                 members (churn_storm runs; stresses wave batching)

Crash scheduling keeps a metadata majority alive (at most (n-1)//2
concurrently crashed) — the checker tests safety under faults the
system CLAIMS to survive; losing quorum entirely is the degraded-mode
path (`unavailable` refusals), exercised separately.

Twin of `ripplemq_tpu/chaos/nemesis.py` (PyTorch port): the same code,
importing only the port's modules; its schedules (`trace_json`) are
byte-identical to the reference's for every seed, a lockstep worker
roster's `kill_worker` draws included.
"""

from __future__ import annotations

import json
import random
import time
from typing import Optional

# Weighted op pool: link faults are cheap and frequent, crashes rarer
# (each costs a recovery), duplication/delay spice the RPC layer.
_OP_WEIGHTS = (
    ("crash", 3),
    ("isolate", 2),
    ("partition", 3),
    ("oneway", 2),
    ("drop", 3),
    ("delay", 2),
    ("dup", 2),
)

# The PROCESS backend's pool (chaos.proc_cluster): real kernels take no
# InProcNetwork hooks, so the op set is what real deployments suffer —
# SIGKILL'd processes and damaged disks (torn tail / flipped byte /
# lost sealed segment), injected between a victim's kill and restart.
_PROC_OP_WEIGHTS = (
    ("crash", 4),
    ("disk_torn", 2),
    ("disk_flip", 2),
    ("disk_trunc", 1),
)

_DISK_OPS = ("disk_torn", "disk_flip", "disk_trunc")

_BACKEND_POOLS = {"inproc": _OP_WEIGHTS, "proc": _PROC_OP_WEIGHTS}

# Rebalance-storm ops (runs with consumer-group members): client-side
# and backend-agnostic — heartbeat silence (→ session eviction),
# membership churn (leave+rejoin), and a commit stamped with a deposed
# generation (the fence MUST refuse it). Joined to either backend's
# pool when the run has group members.
_GROUP_OP_WEIGHTS = (
    ("member_pause", 2),
    ("member_churn", 2),
    ("stale_commit", 1),
)

_GROUP_OPS = tuple(n for n, _ in _GROUP_OP_WEIGHTS)

# Churn-storm op (the `churn_storm` knob, runs with group members): a
# BURST of simultaneous membership churns — several members leave and
# rejoin at once, so the brokers' wave coalescing (meta_batch_s) forms
# a multi-member OP_BATCH whose boundary races whatever else the pool
# is doing to the controller: crash/SIGKILL, partitions, disk damage.
# The duplicate-wave idempotence claim (a leader retry straddling a
# failover replays the whole wave) only gets exercised when waves are
# WIDE, which single member_churn ops rarely produce. The op carries
# the member INDEX LIST chosen at schedule time — purity preserved;
# backend-agnostic like the other group ops.
_CHURN_BURST_WEIGHT = 4

# Stripe-holder ops (runs with replication="striped"): attack the
# striped plane's k-of-k+m durability contract as a first-class
# surface. Ops name a stripe INDEX (0..k+m-1) — the schedule stays a
# pure function of the seed; resolution to a broker happens at apply
# time through the cluster's replicated stripe map (like disk faults,
# WHAT was hit is runtime forensics, the op itself is the trace).
# stripe_kill crashes the holder of that index; stripe_partition
# (in-proc only: needs network hooks) partitions it from the
# controller. Scheduling is SIZED TO M: at most RS_M stripe_kills per
# phase — the checker tests the contract the plane claims (zero acked
# loss while any k stripe-holders survive); losing more is the
# documented beyond-contract regime (chaos/history.py check_history's
# stripe parameter).
_STRIPE_OP_WEIGHTS = (
    ("stripe_kill", 2),
    ("stripe_partition", 1),
)
_STRIPE_OPS = tuple(n for n, _ in _STRIPE_OP_WEIGHTS)

# Elastic-partition ops (runs with spare engine slots provisioned):
# online split/merge raced against everything else in the pool —
# controller crashes and failovers included. Schedule-pure like
# stripe_kill: the op names a candidate INDEX, resolved at apply time
# against the cluster's current splittable/mergeable sets through the
# admin.split/admin.merge RPC surface (both backends); WHAT was split
# goes to runtime forensics (reconfig_log), never the trace. An op
# whose candidate set is empty (no spare slot, nothing mergeable) is a
# typed-refusal no-op — also forensics, never a failure.
_ELASTIC_OP_WEIGHTS = (
    ("split_partition", 2),
    ("merge_partitions", 1),
)
_ELASTIC_OPS = tuple(n for n, _ in _ELASTIC_OP_WEIGHTS)
# pidx space: candidate sets are small; any fixed modulus keeps the
# schedule pure while spreading choices across them.
_ELASTIC_PIDX_SPACE = 8


def make_schedule(
    seed: int,
    broker_ids: list[int],
    phases: int,
    ops_per_phase: int = 2,
    lockstep_workers: tuple[str, ...] = (),
    backend: str = "inproc",
    group_members: int = 0,
    striped: bool = False,
    elastic: bool = False,
    churn_storm: bool = False,
) -> list[list[dict]]:
    """Deterministic [phases][ops] fault schedule. Each phase ends with
    an implicit heal (the nemesis records it in the trace), so phases
    start from a clean network with every broker up. `backend` selects
    the op pool ("inproc": network+crash faults; "proc": SIGKILL + disk
    faults); `group_members > 0` joins the rebalance-storm ops,
    `striped` the stripe-holder ops (sized to RS_M kills per phase),
    `elastic` the online split/merge ops (both backends — they ride
    the admin RPC surface), `churn_storm` the multi-member churn-burst
    op (needs group members) — the schedule stays a pure function of
    (seed, roster, shape, backend, group_members, striped, elastic,
    churn_storm), so any run replays byte-for-byte."""
    from ripplemq_tpu_torch.stripes.codec import RS_K, RS_M

    rng = random.Random(seed)
    pool = list(_BACKEND_POOLS[backend])
    if lockstep_workers and backend == "inproc":
        pool.append(("kill_worker", 1))
    if group_members > 0:
        pool.extend(_GROUP_OP_WEIGHTS)
        if churn_storm:
            pool.append(("churn_burst", _CHURN_BURST_WEIGHT))
    if striped:
        pool.extend(
            _STRIPE_OP_WEIGHTS if backend == "inproc"
            else _STRIPE_OP_WEIGHTS[:1]  # partition needs network hooks
        )
    if elastic:
        pool.extend(_ELASTIC_OP_WEIGHTS)
    names = [n for n, w in pool for _ in range(w)]
    max_crashed = (len(broker_ids) - 1) // 2
    schedule: list[list[dict]] = []
    for phase in range(phases):
        ops: list[dict] = []
        crashed: set[int] = set()
        stripe_kills = 0
        for _ in range(ops_per_phase):
            name = rng.choice(names)
            if name == "crash" and len(crashed) + stripe_kills >= max_crashed:
                # Keep the metadata majority alive: the checker tests
                # safety under faults the system claims to survive.
                # Stripe kills hold a crash slot too — each resolves to
                # a real broker going down.
                name = "partition" if backend == "inproc" else "disk_torn"
            if name == "stripe_kill" and (
                stripe_kills >= RS_M
                or len(crashed) + stripe_kills + 1 > max_crashed
            ):
                # Sized to m, and stripe kills consume the crash budget
                # (the holder they resolve to is a real broker down).
                name = ("stripe_partition" if backend == "inproc"
                        else "disk_torn")
            if name in _ELASTIC_OPS:
                ops.append({"op": name,
                            "pidx": rng.randrange(_ELASTIC_PIDX_SPACE)})
            elif name in _STRIPE_OPS:
                if name == "stripe_kill":
                    stripe_kills += 1
                ops.append({"op": name,
                            "holder": rng.randrange(RS_K + RS_M)})
            elif name in _DISK_OPS:
                # Disk damage is injected into a CRASHED victim's store
                # (you cannot corrupt the disk under a live process and
                # call the outcome a recovery test): target an already-
                # crashed broker, or crash one first as part of the op.
                if not crashed:
                    if stripe_kills >= max_crashed:
                        # The implicit crash would overdraw the budget
                        # stripe kills already consumed (their victims
                        # are unknown at schedule time, so they cannot
                        # serve as disk-op targets either): skip.
                        continue
                    b = rng.choice(sorted(broker_ids))
                    crashed.add(b)
                    ops.append({"op": "crash", "broker": b})
                else:
                    b = rng.choice(sorted(crashed))
                ops.append({"op": name, "broker": b,
                            "salt": rng.randint(0, 1 << 30)})
            elif name == "crash":
                b = rng.choice(sorted(set(broker_ids) - crashed))
                crashed.add(b)
                ops.append({"op": "crash", "broker": b})
            elif name == "isolate":
                b = rng.choice(broker_ids)
                ops.append({"op": "isolate", "broker": b})
            elif name in ("partition", "oneway"):
                a, b = rng.sample(broker_ids, 2)
                ops.append({"op": name, "a": a, "b": b})
            elif name in ("drop", "dup"):
                a, b = rng.sample(broker_ids, 2)
                ops.append({"op": name, "a": a, "b": b,
                            "n": rng.randint(1, 5)})
            elif name == "delay":
                a, b = rng.sample(broker_ids, 2)
                ops.append({"op": "delay", "a": a, "b": b,
                            "n": rng.randint(1, 4),
                            "delay_ms": rng.choice([10, 25, 50])})
            elif name == "kill_worker":
                ops.append({"op": "kill_worker",
                            "worker": rng.choice(list(lockstep_workers))})
            elif name == "churn_burst":
                # Half the roster (at least 2) churns inside one wave
                # window — wide enough that the coalesced OP_BATCH
                # carries a real multi-member wave.
                k = min(group_members, max(2, group_members // 2))
                ops.append({"op": "churn_burst",
                            "members": sorted(
                                rng.sample(range(group_members), k))})
            elif name in _GROUP_OPS:
                ops.append({"op": name,
                            "member": rng.randrange(group_members)})
        schedule.append(ops)
    return schedule


def expected_trace(schedule: list[list[dict]]) -> list[dict]:
    """The exact trace a Nemesis run of `schedule` emits — a pure
    function (fault ops in order, then the phase's crash restarts in
    sorted order, then the heal marker). `trace_json(expected_trace(s))
    == trace_json(nemesis.trace)` is the byte-for-byte reproducibility
    contract tests assert."""
    trace: list[dict] = []
    for phase, ops in enumerate(schedule):
        crashed: set[int] = set()
        holders: set[int] = set()
        for op in ops:
            trace.append({"phase": phase, **op})
            if op["op"] == "crash":
                crashed.add(op["broker"])
            elif op["op"] == "stripe_kill":
                holders.add(op["holder"])
        for b in sorted(crashed):
            trace.append({"phase": phase, "op": "restart", "broker": b})
        # Stripe kills resolve to brokers only at APPLY time, so their
        # restarts are traced by HOLDER INDEX (deterministic from the
        # schedule) — which broker that was is timeline forensics.
        for h in sorted(holders):
            trace.append({"phase": phase, "op": "restart_holder",
                          "holder": h})
        trace.append({"phase": phase, "op": "heal"})
    return trace


def trace_json(trace: list[dict]) -> str:
    """Canonical byte-for-byte trace encoding (sorted keys, no spaces):
    equal seeds ⇒ equal strings ⇒ equal sha256 digests."""
    return json.dumps(trace, sort_keys=True, separators=(",", ":"))


class Nemesis:
    """Applies a schedule to a live InProcCluster and records the trace.

    `schedule` overrides generation — pass a previously recorded trace's
    ops to REPLAY a failure (the reference's profiles/chaos_soak.py
    --replay does)."""

    def __init__(self, cluster, seed: int, phases: int,
                 ops_per_phase: int = 2,
                 lockstep_workers: tuple[str, ...] = (),
                 schedule: Optional[list[list[dict]]] = None,
                 backend: str = "inproc",
                 group_members: int = 0,
                 striped: bool = False,
                 elastic: bool = False,
                 churn_storm: bool = False) -> None:
        self.cluster = cluster
        self.seed = seed
        self.backend = backend
        self.lockstep_workers = tuple(lockstep_workers)
        # Rebalance-storm target: a chaos.groups.GroupWorkload (or any
        # object with pause/resume/churn/stale_commit/resume_all).
        # Attached by the harness AFTER construction — the schedule only
        # references member INDEXES, so purity is unaffected.
        self.group_ops = None
        self.schedule = schedule if schedule is not None else make_schedule(
            seed, sorted(cluster.brokers), phases,
            ops_per_phase=ops_per_phase,
            lockstep_workers=self.lockstep_workers,
            backend=backend,
            group_members=group_members,
            striped=striped,
            elastic=elastic,
            churn_storm=churn_storm,
        )
        self.trace: list[dict] = []
        # Elastic-op resolution forensics: what each scheduled
        # split/merge index resolved to and how the admin RPC answered
        # (typed infeasible refusals included) — like disk_fault_log,
        # informational, never part of the byte-reproducible trace.
        self.reconfig_log: list[dict] = []
        # Disk-fault injection outcomes, parallel to the trace entries
        # that caused them (forensics; NOT part of the byte-reproducible
        # trace — what the damage hit depends on what the run persisted).
        self.disk_fault_log: list[dict] = []
        # WALL-CLOCKED fault timeline: every applied op (and heal/
        # restart) stamped with time.time() at application, in the same
        # {t, src, type, ...} shape as the brokers' flight-recorder
        # events — run_chaos merges the two into ONE fault-vs-lifecycle
        # timeline. Informational (timing varies run to run); the
        # byte-reproducible artifact remains `trace`.
        self.timeline: list[dict] = []
        self._crashed: set[int] = set()
        # Stripe-op bookkeeping: brokers crashed by stripe_kill (kept
        # apart from _crashed — their trace restarts are holder-indexed,
        # see expected_trace) and the holder indexes hit this phase.
        self._stripe_crashed: set[int] = set()
        self._stripe_hit: set[int] = set()
        # Per-run high-water mark of stripe_kills in one phase: the
        # checker's k-of-k+m contract input (run_chaos passes it to
        # check_history's stripe parameter).
        self.max_stripe_kills_per_phase = 0

    def _mark(self, phase: int, op: dict) -> None:
        self.timeline.append({
            "t": time.time(), "src": "nemesis", "phase": phase,
            "type": op["op"],
            **{k: v for k, v in op.items() if k != "op"},
        })

    # ------------------------------------------------------------- applying

    def _addr(self, broker_id: int) -> str:
        return self.cluster.config.broker(broker_id).address

    def run_phase(self, phase: int) -> None:
        for op in self.schedule[phase]:
            self._apply(dict(op))
            self.trace.append({"phase": phase, **op})
            self._mark(phase, op)

    def _apply(self, op: dict) -> None:
        kind = op["op"]
        if kind == "crash":
            b = op["broker"]
            if b in self._stripe_crashed:
                # Already down via a stripe kill: adopt it into the
                # broker-named set so the heal's named restart entry
                # matches expected_trace (the crash op IS scheduled).
                self._stripe_crashed.discard(b)
                self._crashed.add(b)
                return
            if b not in self._crashed:
                self._crashed.add(b)
                self.cluster.kill(b)
            return
        if kind in _STRIPE_OPS:
            self._apply_stripe_op(kind, op)
            return
        if kind in _ELASTIC_OPS:
            self._apply_elastic_op(kind, op)
            return
        if kind == "restart":
            b = op["broker"]
            if b in self._crashed:
                self._crashed.discard(b)
                self.cluster.restart(b)
            return
        if kind == "churn_burst":
            # Storm burst: churn every listed member back-to-back so
            # their leaves+rejoins coalesce into one (or few) waves.
            if self.group_ops is not None:
                for i in op["members"]:
                    self.group_ops.churn(i)
            return
        if kind in _GROUP_OPS:
            # Rebalance-storm ops act on the group workload's members
            # (client-side; no network hooks needed on either backend).
            if self.group_ops is not None:
                i = op["member"]
                if kind == "member_pause":
                    self.group_ops.pause(i)
                elif kind == "member_churn":
                    self.group_ops.churn(i)
                elif kind == "stale_commit":
                    self.group_ops.stale_commit(i)
            return
        if kind in _DISK_OPS:
            # Damage the crashed victim's on-disk store; the restart at
            # heal must rebuild (erasure) or quarantine — never crash-
            # loop, never serve a CRC-failing row.
            desc = self.cluster.inject_disk_fault(
                op["broker"], kind, op.get("salt", 0)
            )
            self.disk_fault_log.append(
                {"broker": op["broker"], **desc}
            )
            return
        # Network-layer ops: only reachable on backends with an in-proc
        # fault-injection network (make_schedule never draws them for
        # the process backend).
        net = self.cluster.net
        if kind == "isolate":
            me = self._addr(op["broker"])
            for other in self.cluster.brokers:
                if other != op["broker"]:
                    net.block(me, self._addr(other))
        elif kind == "partition":
            net.block(self._addr(op["a"]), self._addr(op["b"]))
        elif kind == "oneway":
            net.block_oneway(self._addr(op["a"]), self._addr(op["b"]))
        elif kind == "drop":
            net.drop_next(self._addr(op["a"]), self._addr(op["b"]), op["n"])
        elif kind == "dup":
            net.dup_next(self._addr(op["a"]), self._addr(op["b"]), op["n"])
        elif kind == "delay":
            net.delay_next(self._addr(op["a"]), self._addr(op["b"]),
                           op["n"], op["delay_ms"] / 1000.0)
        elif kind == "kill_worker":
            net.set_down(op["worker"])
        else:
            raise ValueError(f"unknown nemesis op {kind!r}")

    def _apply_elastic_op(self, kind: str, op: dict) -> None:
        """Resolve a split/merge index against the cluster's CURRENT
        candidate sets and fire it through the admin RPC surface (both
        backends; any live broker forwards the proposal). Resolution
        and the RPC's answer go to reconfig_log forensics — the
        schedule's purity lives in the index, like stripe ops. An
        empty candidate set, an unreachable cluster, or a typed
        infeasible refusal are all legitimate no-ops: the op's job is
        to RACE reconfiguration against the rest of the pool, not to
        guarantee one happens."""
        i = op["pidx"]
        entry: dict = {"op": kind, "pidx": i}
        try:
            if kind == "split_partition":
                cands = sorted(
                    (t.name, a.partition_id)
                    for t in self.cluster.config.topics
                    for a in self.cluster.topic_view(t.name)
                    if a.state == "active" and a.range_hi - a.range_lo >= 2
                )
                if cands:
                    topic, pid = cands[i % len(cands)]
                    entry["resolved"] = [topic, pid]
                    resp = self.cluster.admin_split(topic, pid)
                    entry["resp"] = {k: resp.get(k) for k in
                                     ("ok", "error", "child", "generation")
                                     if k in resp}
            else:  # merge_partitions
                cands = sorted(self.cluster.merge_candidates())
                if cands:
                    topic, parent, child = cands[i % len(cands)]
                    entry["resolved"] = [topic, parent, child]
                    resp = self.cluster.admin_merge(topic, parent, child)
                    entry["resp"] = {k: resp.get(k) for k in
                                     ("ok", "error", "generation")
                                     if k in resp}
        except Exception as e:  # a mid-fault cluster may refuse reach
            entry["error"] = f"{type(e).__name__}: {e}"
        self.reconfig_log.append(entry)

    def _apply_stripe_op(self, kind: str, op: dict) -> None:
        """Resolve a stripe-holder op against the CURRENT replicated
        stripe map (the schedule names only the index; what broker that
        is depends on membership history — recorded into disk_fault_log
        -style forensics, never into the byte-reproducible trace)."""
        h = op["holder"]
        if kind == "stripe_kill":
            self._stripe_hit.add(h)
            self.max_stripe_kills_per_phase = max(
                self.max_stripe_kills_per_phase, len(self._stripe_hit)
            )
        holders = tuple(self.cluster.stripe_holders())
        resolved = None
        if holders:
            resolved = holders[h % len(holders)]
        self.disk_fault_log.append({
            "op": kind, "holder": h, "resolved_broker": resolved,
        })
        if resolved is None:
            return  # no standby joined yet: nothing to attack
        if kind == "stripe_kill":
            if resolved in self._crashed or resolved in self._stripe_crashed:
                return
            self._stripe_crashed.add(resolved)
            self.cluster.kill(resolved)
            return
        # stripe_partition: cut the holder off from the controller (the
        # stripe stream's source) — its stripes stop acking, the round
        # must settle through the other k holders.
        ctrl = self.cluster.controller_id()
        net = getattr(self.cluster, "net", None)
        if net is None or ctrl is None or ctrl == resolved:
            return
        net.block(self._addr(resolved), self._addr(ctrl))

    def heal_phase(self, phase: int) -> None:
        """End-of-phase heal: clear every network fault, restart every
        crashed broker (recorded — the heal is part of the trace). A
        restart after a disk-fault op is where the recovery contract is
        earned: the victim's boot must rebuild or quarantine the damage."""
        net = getattr(self.cluster, "net", None)
        if net is not None:
            net.heal()
        for b in sorted(self._crashed):
            self.cluster.restart(b)
            self.trace.append({"phase": phase, "op": "restart", "broker": b})
            self._mark(phase, {"op": "restart", "broker": b})
        self._crashed.clear()
        # Stripe-killed brokers restart too, traced by HOLDER index
        # (expected_trace cannot know the broker the map resolved to —
        # the broker id goes to the wall-clocked timeline only).
        for b in sorted(self._stripe_crashed):
            self.cluster.restart(b)
            self._mark(phase, {"op": "restart_stripe", "broker": b})
        self._stripe_crashed.clear()
        for h in sorted(self._stripe_hit):
            self.trace.append({"phase": phase, "op": "restart_holder",
                               "holder": h})
        self._stripe_hit.clear()
        if net is not None:
            for w in self.lockstep_workers:
                net.set_up(w)
        if self.group_ops is not None:
            # Paused members resume (and transparently rejoin if their
            # session lapsed and the coordinator evicted them mid-phase).
            self.group_ops.resume_all()
        self.trace.append({"phase": phase, "op": "heal"})
        self._mark(phase, {"op": "heal"})

    # ---------------------------------------------------------- convergence

    def wait_converged(self, history=None, timeout: float = 30.0,
                       probe_tag: str = "probe") -> dict:
        """Post-heal re-convergence: every partition has an elected
        leader that ACCEPTS a probe produce, and no partition reports a
        lost quorum (`degraded` drained). Probe payloads are recorded
        into `history` (they are real acked produces — the checker
        holds them to the same no-loss contract). Returns
        {"converged": bool, "detail": ...}."""
        deadline = time.time() + timeout
        pending = [
            (t.name, pid)
            for t in self.cluster.config.topics
            for pid in range(t.partitions)
        ]
        client = self.cluster.client(f"nemesis-{probe_tag}")
        probe_i = 0
        while pending and time.time() < deadline:
            topic, pid = pending[0]
            leader = self.cluster.leader_of_key(topic, pid,
                                                exclude=self._crashed)
            if leader is None or leader in self._crashed:
                time.sleep(0.05)
                continue
            payload = f"{probe_tag}:{self.seed}:{topic}:{pid}:{probe_i}"
            probe_i += 1
            # Record BEFORE the call: a probe whose response is lost can
            # still have committed, and an unrecorded committed payload
            # would read as a phantom. "unknown" → allowed but not
            # required in the final log; upgraded to "ok" on ack.
            if history is not None:
                history.record(op="produce", client=f"nemesis-{probe_tag}",
                               topic=topic, partition=pid,
                               payload=payload, status="unknown", attempts=1)
            try:
                resp = client.call(
                    self.cluster.broker_addr(leader),
                    {"type": "produce", "topic": topic, "partition": pid,
                     "messages": [payload.encode()]},
                    timeout=5.0,
                )
            except Exception:
                time.sleep(0.05)
                continue
            if resp.get("ok"):
                if history is not None:
                    history.record(op="produce", client=f"nemesis-{probe_tag}",
                                   topic=topic, partition=pid,
                                   payload=payload, status="ok", attempts=1,
                                   broker=resp.get("broker"))
                pending.pop(0)
            else:
                time.sleep(0.05)
        return {"converged": not pending,
                "detail": {"unconverged_partitions": pending}}

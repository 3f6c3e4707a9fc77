"""run_chaos: one call = one adversarial run with a safety verdict.

Boots an in-proc cluster (durable per-broker stores — an in-proc
"crash" is stop+unreachable, and recovery replays the flushed segment
store exactly like a process restart), drives producer/consumer
workloads through the REAL client SDK (jittered-retry policies and
all), lets the seeded nemesis attack between heals, then drains every
partition's final log and checks the recorded history against the
queue-semantics invariants (chaos/history.py).

The returned verdict is JSON-able: tests assert on `violations == []`
and trace reproducibility.

Twin of `ripplemq_tpu/chaos/harness.py` (PyTorch port): the same code,
importing only the port's modules, with the device rule: `run_chaos(...,
device=None)` and `run_kill_all_drill(..., device=None)` run every
broker's device work on CUDA, raise on a host without one (naming
`device="cpu"`), and pass the device to each cluster they build. A
witnessed run (`lock_witness=True`) holds the witnessed graph to
acyclicity and to containment in the closure of the port's static lock
graph (`ripplemq_tpu_torch/analysis/lock_graph.py`), as the reference
does.
"""

from __future__ import annotations

import hashlib
import shutil
import tempfile
import threading
import time
from typing import Optional

from ripplemq_tpu_torch.chaos.cluster import InProcCluster, make_cluster_config
from ripplemq_tpu_torch.chaos.history import (
    History,
    TrackingRetryPolicy,
    check_group_history,
    check_history,
)
from ripplemq_tpu_torch.chaos.nemesis import Nemesis, trace_json
from ripplemq_tpu_torch.client import ConsumerClient, ProducerClient
from ripplemq_tpu_torch.metadata.models import Topic


def _cluster_device(device) -> str:
    """The device every broker of a chaos cluster runs on: CUDA when
    None, which raises on a host without one."""
    if device is not None:
        return str(device)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the chaos "
            "cluster's device work on the CPU explicitly")
    return "cuda"


class _Workload:
    """Producer + consumer threads hammering the cluster through the
    client SDK for the whole run (faulted windows included)."""

    def __init__(self, cluster: InProcCluster, seed: int,
                 history: History, topic: str, partitions: int,
                 follower_reads: bool = False,
                 keyed: bool = False) -> None:
        self.history = history
        self.topic = topic
        self.partitions = partitions
        self.follower_reads = follower_reads
        # Elastic runs produce KEYED: the SDK resolves the partition by
        # key-hash range, stamps pgen, and re-routes on the broker's
        # stale_partition_gen fence — the workload then records the
        # partition each ack actually LANDED in (producer.last_partition
        # carries the broker's routed_partition), so the checker's
        # acked-loss lookup hits the right final log across handoffs.
        self.keyed = keyed
        self._stop = threading.Event()
        bootstrap = [b.address for b in cluster.config.brokers]
        # Short timeouts + a deadline budget per op: a faulted window
        # must cost bounded wall-clock, not retries x timeout.
        self._prod_policy = TrackingRetryPolicy(
            max_attempts=4, base_backoff_s=0.02, max_backoff_s=0.2,
            deadline_s=3.0,
        )
        self.producer = ProducerClient(
            bootstrap,
            transport=cluster.client(f"chaos-prod-{seed}"),
            metadata_refresh_s=0.3, rpc_timeout_s=1.0,
            retry_policy=self._prod_policy,
        )
        self.consumer = ConsumerClient(
            bootstrap, f"chaos-consumer-{seed}",
            transport=cluster.client(f"chaos-cons-{seed}"),
            metadata_refresh_s=0.3, rpc_timeout_s=1.0,
            retries=3, retry_backoff_s=0.02, deadline_s=3.0,
            follower_reads=follower_reads,
        )
        self._threads = [
            threading.Thread(target=self._produce_loop, daemon=True,
                             name="chaos-producer"),
            threading.Thread(target=self._consume_loop, daemon=True,
                             name="chaos-consumer"),
        ]
        self._seed = seed

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self.producer.close()
        self.consumer.close()

    def _produce_loop(self) -> None:
        i = 0
        while not self._stop.is_set():
            pid = i % self.partitions
            key = None
            if self.keyed:
                # 64 rotating keys: crc32 spreads them across the full
                # hash range, so any split's child range owns some. The
                # SDK routes; the pinned pid is only the pre-ack guess.
                key = f"k{i % 64:02d}".encode()
            payload = f"w{self._seed}:{i}"
            # Record BEFORE the call: an acked-in-flight produce whose
            # response is lost must not read as a phantom. (History
            # keeps the LAST record per payload, so the ok/fail below
            # overwrites this placeholder — including its guessed
            # partition, which a keyed reroute can change.)
            self.history.record(op="produce", client="producer",
                                topic=self.topic, partition=pid,
                                payload=payload, status="unknown")
            try:
                self.producer.produce(
                    self.topic, payload.encode(),
                    partition=None if self.keyed else pid, key=key)
            except Exception as e:
                self.history.record(
                    op="produce", client="producer", topic=self.topic,
                    partition=pid, payload=payload, status="fail",
                    attempts=getattr(self._prod_policy.last_run,
                                     "attempts", 1),
                    error=f"{type(e).__name__}: {e}")
            else:
                if self.keyed and self.producer.last_partition is not None:
                    # The partition the broker ACKED the write into —
                    # the acked-loss check drains THAT log.
                    pid = self.producer.last_partition
                self.history.record(
                    op="produce", client="producer", topic=self.topic,
                    partition=pid, payload=payload, status="ok",
                    attempts=getattr(self._prod_policy.last_run,
                                     "attempts", 1))
            i += 1
            time.sleep(0.01)

    def _consume_loop(self) -> None:
        i = 0
        cid = self.consumer.consumer_id
        while not self._stop.is_set():
            pid = i % self.partitions
            i += 1
            try:
                msgs, rpid, off, nxt = self.consumer.consume_with_position(
                    self.topic, partition=pid
                )
            except Exception as e:
                # Delivered-but-uncommitted is possible (auto-commit can
                # fail after the read): outcome unknown, no payload info.
                self.history.record(op="consume", client=cid,
                                    topic=self.topic, partition=pid,
                                    status="unknown",
                                    error=f"{type(e).__name__}: {e}")
            else:
                payloads = [m.decode("utf-8", "replace") for m in msgs]
                # Tag follower-served reads: the verdict's counts say
                # how much of the fan-out the standbys absorbed, and a
                # violating run's history shows WHICH reads a follower
                # answered.
                self.history.record(op="consume", client=cid,
                                    topic=self.topic, partition=rpid,
                                    status="ok", offset=off,
                                    next_offset=nxt, payloads=payloads,
                                    follower=bool(
                                        self.consumer.last_from_follower))
                if payloads:
                    # auto_commit acked next_offset (consume raises
                    # otherwise), so the commit is part of the history.
                    self.history.record(op="commit", client=cid,
                                        topic=self.topic, partition=rpid,
                                        status="ok", offset=nxt)
            time.sleep(0.01)


def _drain_partition(cluster: InProcCluster, topic: str, pid: int,
                     tag: str, timeout_s: float = 15.0) -> list[str]:
    """Read one partition's FULL committed log in order via a fresh
    auto-commit consumer (its server-tracked offset starts at 0)."""
    bootstrap = [b.address for b in cluster.config.brokers]
    consumer = ConsumerClient(
        bootstrap, f"auditor-{tag}",
        transport=cluster.client(f"auditor-{tag}"),
        metadata_refresh_s=0.5, rpc_timeout_s=2.0,
        retries=5, retry_backoff_s=0.05,
    )
    out: list[str] = []
    deadline = time.time() + timeout_s
    # End on a sustained window of CLEAN empty reads, not a fixed count:
    # three empty batches are ~150 ms apart, and a post-heal cluster on a
    # starved host can legitimately answer empty for longer than that
    # while its settle horizon catches up — a count-based stop truncated
    # the drain's tail there and read as false acked loss (the last one
    # or two produces "absent from the final log" whenever tier-1 shared
    # the host with other work).
    last_progress = time.time()
    try:
        while time.time() < deadline:
            try:
                batch = consumer.consume(topic, partition=pid,
                                         max_messages=64)
            except Exception:
                # Post-heal leadership/metadata can still be settling;
                # the drain just needs the eventual full prefix. An
                # erroring cluster is "still settling", not "drained" —
                # keep the progress clock running.
                last_progress = time.time()
                time.sleep(0.1)
                continue
            if batch:
                last_progress = time.time()
                out.extend(m.decode("utf-8", "replace") for m in batch)
            else:
                if time.time() - last_progress > 3.0:
                    break
                time.sleep(0.05)
    finally:
        consumer.close()
    return out


def _collect_broker_obs(
    cluster,
) -> tuple[dict[str, dict], dict[str, list[dict]], dict[str, float]]:
    """Pull one admin.postmortem bundle per reachable broker (both
    backends reach it over their real transport — the RPC surface is
    the point: what an operator would collect, not an in-proc reach-in)
    plus each broker's flight-recorder window as a per-source event
    STREAM (kept in the ring's seq order, never re-sorted here) and a
    per-source wall-clock skew estimate: the admin.trace response's
    `now` paired NTP-style against this process's send/receive stamps.
    Unreachable/killed brokers are skipped, not fatal — a postmortem
    that fails because half the cluster is down must still report the
    surviving half."""
    postmortems: dict[str, dict] = {}
    streams: dict[str, list[dict]] = {}
    skews: dict[str, float] = {}
    client = cluster.client("obs-collect")
    for bid in cluster.brokers:
        addr = cluster.broker_addr(bid)
        try:
            pm = client.call(addr, {"type": "admin.postmortem"},
                             timeout=15.0)
            if pm.get("ok"):
                postmortems[str(bid)] = pm
        except Exception:
            pass  # trace below is independent — keep collecting
        # The timeline wants the FULL ring, not the postmortem's recent
        # clip: under traffic the per-round events scroll control-plane
        # transitions (boots, elections, deposals) out of a short window
        # in seconds, and those are exactly what a fault timeline is
        # for. Fetched regardless of the postmortem's fate: a broker
        # whose device-fetching postmortem wedged is the one whose
        # lifecycle events the timeline most needs.
        try:
            t_send = time.time()
            tr = client.call(addr, {"type": "admin.trace"}, timeout=15.0)
            t_recv = time.time()
        except Exception:
            continue
        if tr.get("ok"):
            skew = None
            if tr.get("now") is not None:
                skew = float(tr["now"]) - (t_send + t_recv) / 2
            # Broker and engine recorders are separate rings with
            # independent seq spaces — separate streams, shared skew.
            for field, tag in (("trace", ""), ("engine_trace", "/engine")):
                evs = tr.get(field)
                if not evs:
                    continue
                src = f"broker{bid}{tag}"
                streams[src] = [{"src": src, **ev} for ev in evs]
                if skew is not None:
                    skews[src] = skew
    return postmortems, streams, skews


def merge_timeline(streams: dict[str, list[dict]],
                   skews: Optional[dict[str, float]] = None) -> list[dict]:
    """Causal timeline merge. Each stream (one broker's flight-recorder
    ring, the nemesis's fault log) arrives in its OWN emit order —
    per-source monotone seq numbers / append order — and is NEVER
    reordered internally: a broker whose wall clock stepped backwards
    mid-run still reports its own transitions in causal order. ACROSS
    streams, the next event is the stream head with the smallest
    skew-corrected timestamp (`t - skews[src]`, the collector-relative
    offset _collect_broker_obs estimated). The previous merge was a raw
    wall-clock sort of the union, which under proc-backend clock skew
    interleaved causally-ordered events backwards — the exact failure
    mode the span plane's no-wall-clock rule exists for. Each merged
    event gains `tc`, its skew-corrected (collector-domain) timestamp."""
    skews = skews or {}
    heads = {src: 0 for src in streams}
    out: list[dict] = []
    while True:
        live = [s for s, i in heads.items() if i < len(streams[s])]
        if not live:
            return out
        src = min(live, key=lambda s: (
            streams[s][heads[s]].get("t", 0.0) - skews.get(s, 0.0), s))
        ev = streams[src][heads[src]]
        heads[src] += 1
        out.append({**ev, "tc": round(
            ev.get("t", 0.0) - skews.get(src, 0.0), 6)})


def _collect_slo_stats(cluster) -> dict[str, dict]:
    """One admin.stats `slo` block per reachable broker, over the real
    transport (both backends) — the shed/recovery timeline lives in
    each controller's tick ring, which survives the post-heal drain
    (the flight-recorder ring can scroll under traffic; the tick ring
    cannot)."""
    out: dict[str, dict] = {}
    client = cluster.client("slo-collect")
    for bid in cluster.brokers:
        try:
            st = client.call(cluster.broker_addr(bid),
                             {"type": "admin.stats"}, timeout=10.0)
        except Exception:
            continue
        if st.get("ok") and isinstance(st.get("slo"), dict):
            out[str(bid)] = st["slo"]
    return out


def _collect_follower_stats(cluster) -> dict[str, dict]:
    """One admin.stats `follower` block per reachable broker, over the
    real transport (both backends) — the serve/refuse counters and the
    answers_past_floor safety witness live broker-side and survive the
    post-heal drain."""
    out: dict[str, dict] = {}
    client = cluster.client("follower-collect")
    for bid in cluster.brokers:
        try:
            st = client.call(cluster.broker_addr(bid),
                             {"type": "admin.stats"}, timeout=10.0)
        except Exception:
            continue
        if st.get("ok") and isinstance(st.get("follower"), dict):
            out[str(bid)] = st["follower"]
    return out


def check_follower(fstats: dict[str, dict],
                   client_served: int) -> tuple[dict, list[str]]:
    """The follower-read safety contract, from the brokers' own
    counters. ONE invariant is first-class, alongside exactly-once: no
    follower ever ANSWERED a consume above its replicated settled
    floor (`answers_past_floor`, broker/follower.py audit_answer — the
    boundary witness every answer passes regardless of which serving
    path produced it). Serve volume is informational, not an
    invariant: a gentle schedule whose consumer never falls behind the
    floor legitimately routes everything to the leader, and the
    payload-level safety of what followers DID serve is already held
    by the ordinary checker (follower-served reads are recorded in the
    same history the exactly-once invariants run over)."""
    violations: list[str] = []
    served = refused = past = 0
    per: dict[str, dict] = {}
    for bid, s in fstats.items():
        per[bid] = {k: s.get(k) for k in
                    ("enabled", "lease_epoch", "mode", "reads_served",
                     "reads_refused", "rows_served",
                     "answers_past_floor", "floor_lag_rows")}
        served += int(s.get("reads_served") or 0)
        refused += int(s.get("reads_refused") or 0)
        past += int(s.get("answers_past_floor") or 0)
    if not fstats:
        violations.append(
            "follower: no broker served a follower stats block")
    elif past:
        violations.append(
            f"follower: {past} consume answer(s) reached the serve "
            f"boundary above the settled floor (answers_past_floor — "
            f"a serving path's fence failed; the audit refused them, "
            f"but the fence bug is real)"
        )
    section = {
        "client_reads_served": int(client_served),
        "broker_reads_served": served,
        "broker_reads_refused": refused,
        "answers_past_floor": past,
        "per_broker": per,
    }
    return section, violations


def check_slo(slo_stats: dict[str, dict], timeline: list[dict],
              shed_bound_s: float, recover_s: float,
              expect_shed: bool = False) -> tuple[dict, list[str]]:
    """The degradation contract, from the brokers' own control
    timelines (SloController tick rings) against the nemesis's
    wall-clocked fault/heal marks. Returns (the verdict `slo` section,
    its violations — first-class, alongside exactly-once):

    1. with `expect_shed` (the caller KNOWS the schedule injects a
       sustained overload — the tier-1 smoke's crash-both-standbys
       shape): some broker's shed machine ENGAGED within
       `shed_bound_s` of the first injected fault. Without it the
       section still reports engagement, but a mild seeded schedule
       the plane absorbs WITHOUT distress is the system working, not
       a violation — randomized soaks must stay green on gentle
       seeds;
    2. after the LAST heal, the system RETURNED TO SLO within
       `recover_s`: at least one broker observed a post-heal tick
       meeting the p99 target with shedding off, and every broker's
       final mode is back off shed (both unconditional — every run
       must end healthy).

    (Safety-while-shedding is the ordinary checker, unconditional —
    shedding changes admission, never settled state.)"""
    fault_ts = [e["t"] for e in timeline
                if e.get("src") == "nemesis"
                and e.get("type") not in ("heal", "restart",
                                          "restart_stripe")]
    heal_ts = [e["t"] for e in timeline
               if e.get("src") == "nemesis" and e.get("type") == "heal"]
    first_fault = min(fault_ts, default=None)
    last_heal = max(heal_ts, default=None)

    shed_at: Optional[float] = None      # first shed tick >= first fault
    recovered_at: Optional[float] = None  # first ok+unshed tick >= heal
    final_modes: dict[str, str] = {}
    refused = 0
    for bid, s in slo_stats.items():
        final_modes[bid] = s.get("mode", "?")
        adm = s.get("admission") or {}
        refused += int(adm.get("shed_refusals", 0))
        refused += int(adm.get("quota_refusals", 0))
        for t, p99, ok, shed in s.get("tick_history", ()):
            if (shed == 1.0 and first_fault is not None
                    and t >= first_fault
                    and (shed_at is None or t < shed_at)):
                shed_at = t
            if (ok == 1.0 and shed == 0.0 and last_heal is not None
                    and t >= last_heal
                    and (recovered_at is None or t < recovered_at)):
                recovered_at = t
    engaged_s = (None if shed_at is None or first_fault is None
                 else round(shed_at - first_fault, 3))
    recover_in = (None if recovered_at is None or last_heal is None
                  else round(recovered_at - last_heal, 3))
    still_shedding = sorted(b for b, m in final_modes.items()
                            if m == "shed")
    violations: list[str] = []
    if not slo_stats:
        violations.append("slo: no broker served an slo stats block")
    else:
        if expect_shed and shed_at is None:
            violations.append(
                "slo: shed mode never engaged under the injected faults "
                "(the degradation contract's reaction half; this "
                "schedule is declared to sustain an overload)"
            )
        elif expect_shed and engaged_s is not None \
                and engaged_s > shed_bound_s:
            violations.append(
                f"slo: shedding engaged {engaged_s}s after the first "
                f"fault (> {shed_bound_s}s bound)"
            )
        if recover_in is None:
            violations.append(
                "slo: no post-heal in-SLO window observed (the system "
                "never returned to its p99 target with shedding off)"
            )
        elif recover_in > recover_s:
            violations.append(
                f"slo: returned to SLO {recover_in}s after the last "
                f"heal (> {recover_s}s slo_recover_s bound)"
            )
        if still_shedding:
            violations.append(
                f"slo: brokers {still_shedding} still shedding at the "
                f"end of the run"
            )
    section = {
        "target_p99_ms": next(
            (s.get("target_p99_ms") for s in slo_stats.values()), None),
        "shed_engaged": shed_at is not None,
        "shed_engaged_after_s": engaged_s,
        "shed_bound_s": shed_bound_s,
        "recovered_within_s": recover_in,
        "recover_bound_s": recover_s,
        "refused": refused,
        "final_modes": final_modes,
        "per_broker": {
            b: {k: s.get(k) for k in
                ("mode", "shed_count", "adjustments", "ticks", "p99_ms",
                 "meeting_slo", "knobs")}
            for b, s in slo_stats.items()
        },
    }
    return section, violations


def _collect_reconfig(cluster) -> tuple[dict[str, dict], list[dict]]:
    """One admin.stats `reconfig` block per reachable broker plus every
    broker's flight-recorder reconfiguration events (split_begin /
    split_cutover / merge_done), over the real transport — the
    time-to-rebalance witness and the forward/fence counters both live
    broker-side and survive the post-heal drain."""
    stats: dict[str, dict] = {}
    events: list[dict] = []
    client = cluster.client("reconfig-collect")
    for bid in cluster.brokers:
        addr = cluster.broker_addr(bid)
        try:
            st = client.call(addr, {"type": "admin.stats"}, timeout=10.0)
        except Exception:
            st = {}
        if st.get("ok") and isinstance(st.get("reconfig"), dict):
            stats[str(bid)] = st["reconfig"]
        try:
            tr = client.call(addr, {"type": "admin.trace"}, timeout=10.0)
        except Exception:
            continue
        if tr.get("ok"):
            for ev in tr.get("trace", []):
                if ev.get("type") in ("split_begin", "split_cutover",
                                      "merge_done"):
                    events.append({"src": f"broker{bid}", **ev})
    return stats, events


def check_reconfig(rstats: dict[str, dict], events: list[dict],
                   reconfig_log: list[dict],
                   handoff_bound_s: float) -> tuple[dict, list[str]]:
    """The elastic-partition reconfiguration contract, from the
    brokers' own replicated state and flight recorders. Returns (the
    verdict `reconfig` section, its violations — first-class, alongside
    exactly-once, which already ran unconditionally over the split
    traffic: generation fencing changes ROUTING, never settled state).

    1. time-to-rebalance is BOUNDED: no handoff window is still open at
       the end of the run (the replicated handoff table, authoritative —
       every begun split either cut over or timed out into cutover);
    2. every OBSERVED begin→cutover pair completed within
       `handoff_bound_s` (flight-recorder events, deduped across
       brokers — every broker's metadata apply records the same
       transition; a begin whose cutover scrolled out of the ring is
       reported informationally, the open-handoff check above is the
       authoritative half).

    Forwarded-write and fence-refusal counters are informational
    forensics: a schedule whose splits all landed between produce
    bursts legitimately forwards nothing."""
    violations: list[str] = []
    # Dedup: every broker's apply records the same transition; keep the
    # earliest observation of each.
    seen: dict[tuple, dict] = {}
    for ev in events:
        k = (ev.get("type"), ev.get("topic"), ev.get("partition"),
             ev.get("generation"))
        if k not in seen or ev.get("t", 0.0) < seen[k].get("t", 0.0):
            seen[k] = ev
    begins = sorted((e for e in seen.values() if e["type"] == "split_begin"),
                    key=lambda e: e.get("t", 0.0))
    cuts = sorted((e for e in seen.values() if e["type"] == "split_cutover"),
                  key=lambda e: e.get("t", 0.0))
    merges = [e for e in seen.values() if e["type"] == "merge_done"]
    durations: list[float] = []
    unobserved: list[tuple] = []
    for b in begins:
        part = (b.get("topic"), b.get("partition"))
        t_cut = next(
            (c["t"] for c in cuts
             if (c.get("topic"), c.get("partition")) == part
             and c.get("t", 0.0) >= b.get("t", 0.0)),
            None,
        )
        if t_cut is None:
            unobserved.append(part)
        else:
            durations.append(round(t_cut - b.get("t", 0.0), 3))
    open_now = sorted({
        (h.get("topic"), h.get("partition"))
        for s in rstats.values()
        for h in (s.get("open_handoffs") or ())
    })
    forwarded = sum(int(s.get("forwarded_writes") or 0)
                    for s in rstats.values())
    fences = sum(int(s.get("fence_refusals") or 0)
                 for s in rstats.values())
    if not rstats:
        violations.append(
            "reconfig: no broker served a reconfig stats block")
    if open_now:
        violations.append(
            f"reconfig: handoff window(s) still open at the end of the "
            f"run: {open_now} — time-to-rebalance unbounded (cutover "
            f"duty neither saw the watermark settle nor fired the "
            f"deadline)"
        )
    over = [d for d in durations if d > handoff_bound_s]
    if over:
        violations.append(
            f"reconfig: split handoff took {max(over)}s begin→cutover "
            f"(> {handoff_bound_s}s bound)"
        )
    section = {
        "splits_attempted": sum(1 for e in reconfig_log
                                if e.get("op") == "split_partition"),
        "merges_attempted": sum(1 for e in reconfig_log
                                if e.get("op") == "merge_partitions"),
        "splits_begun": len(begins),
        "split_cutovers": len(cuts),
        "merges_done": len(merges),
        "cutover_durations_s": durations,
        "max_cutover_s": max(durations, default=None),
        "handoff_bound_s": handoff_bound_s,
        "cutover_unobserved": unobserved,  # ring scrolled, not a failure
        "open_handoffs_at_end": open_now,
        "forwarded_writes": forwarded,
        "fence_refusals": fences,
        "spare_slots_left": {b: s.get("spare_slots")
                             for b, s in rstats.items()},
        "ops": reconfig_log,
    }
    return section, violations


def run_chaos(
    seed: int,
    n_brokers: int = 3,
    partitions: int = 2,
    replication: int = 3,
    phases: int = 3,
    phase_s: float = 0.6,
    ops_per_phase: int = 2,
    data_dir: Optional[str] = None,
    schedule: Optional[list[list[dict]]] = None,
    converge_timeout_s: float = 30.0,
    include_history: bool = False,
    backend: str = "inproc",
    include_postmortems: bool = False,
    include_timeline: bool = False,
    groups: int = 0,
    churn_storm: bool = False,
    replication_mode: str = "full",
    lock_witness: bool = False,
    host_workers: int = 1,
    slo: bool = False,
    slo_target_p99_ms: float = 100.0,
    slo_recover_s: float = 45.0,
    slo_shed_bound_s: float = 15.0,
    slo_expect_shed: bool = False,
    follower_reads: bool = False,
    splits: int = 0,
    split_handoff_bound_s: float = 20.0,
    device=None,
) -> dict:
    """One seeded chaos run; returns the JSON-able verdict (see module
    docstring). Pass `schedule` (a recorded trace's fault ops grouped
    by phase) to REPLAY instead of generating from the seed.

    `backend` picks the cluster substrate: "inproc" (single process,
    fake transport — network faults, fastest) or "proc" (real broker
    subprocesses over TCP — SIGKILL + disk-fault schedules against the
    deployment shape; chaos.proc_cluster). Verdict schema is identical.

    `replication_mode="striped"` runs the cluster with Reed–Solomon striped
    replication (ripplemq_tpu_torch/stripes/) and joins the STRIPE-HOLDER ops
    to the nemesis pool (stripe_kill / stripe_partition, sized to m per
    phase) — disk faults then land in stripe stores by construction
    (standby segments hold REC_STRIPE frames), and check_history holds
    the run to the k-of-k+m contract (zero acked loss while any k
    stripe-holders survive; see its `stripe` parameter).

    `groups > 0` adds a consumer-group workload of that many members
    (one group, drained through the real GroupConsumer SDK on either
    backend) and joins the REBALANCE-STORM ops to the nemesis pool
    (member_pause / member_churn / stale_commit — chaos/groups.py); the
    checker then also asserts the group invariants
    (check_group_history) and the verdict carries a `group` section
    with post-heal convergence to one stable generation.

    `churn_storm=True` (needs `groups > 0`) joins the churn-burst op:
    several members leave+rejoin simultaneously, so the brokers' wave
    coalescing (meta_batch_s) forms WIDE multi-member OP_BATCH
    proposals whose boundaries race the same phase's controller
    crashes/SIGKILLs — the batched control plane must uphold every
    group invariant unconditionally (duplicate-wave replays across a
    failover included). Either backend.

    A VIOLATING verdict always carries `postmortems` (one
    admin.postmortem bundle per reachable broker — the diagnosis the
    controller wedges need a debugger session for otherwise) and `timeline` (the
    nemesis's wall-clocked fault ops merged with every broker's flight-
    recorder events, sorted by time: fault vs lifecycle in one view).
    `include_postmortems`/`include_timeline` force them onto clean
    verdicts too.

    `lock_witness=True` (in-proc backend) enables the runtime lock
    witness (obs/lockwitness.py) for the whole run: every host-path
    lock the cluster constructs records actual per-thread acquisition
    orderings, and the verdict gains a `lock_witness` section. Two
    cross-checks become VIOLATIONS: a witnessed cycle (a deadlock that
    has not scheduled yet), and a witnessed edge outside the static
    lock graph's transitive closure (`analysis/lock_graph.py` — an
    ordering the AST missed via indirection must become a derived or
    declared static edge, or the gap grows silently).

    `device`: every broker's device (CUDA when None; raises without a
    GPU — tests pass "cpu").

    `slo=True` runs the cluster with the SLO autopilot engaged
    (slo_p99_ack_ms = `slo_target_p99_ms`, 0.2 s ticks, chain rails
    clamped to the configured depth so the loop never compiles new
    chain programs mid-fault) on EITHER backend, and the verdict gains
    an `slo` section whose invariants are first-class violations, the
    degradation contract alongside exactly-once: (1) with
    `slo_expect_shed=True` (the caller declares the schedule sustains
    an overload), shedding ENGAGES within `slo_shed_bound_s` of the
    first injected fault (measured from the brokers' own tick history
    — the shed machine reacted; a gentle seeded schedule the plane
    absorbs without distress is the system working, so random-pool
    soaks leave this off and engagement stays informational);
    (2) acked traffic stays safe while shedding (the ordinary checker,
    unconditional — shedding changes admission, never settled state);
    (3) the system RETURNS TO SLO within `slo_recover_s` of the last
    heal (a post-heal tick meeting the p99 target with shedding off,
    every broker's final mode back to steady). Wall-clock bounds are
    measured honestly; contended tier-1 hosts gate them the same way
    they gate the convergence probe (tests/helpers.py).

    `follower_reads=True` runs the cluster with the follower-read
    plane on (EITHER backend, both replication modes) and the workload
    consumer routing through it (client SDK `follower_reads=True`, so
    backlogged reads go to leased standbys and refusals fall back to
    the leader — through every crash, partition and handover the
    nemesis schedules). The verdict gains a `follower` section and ONE
    first-class invariant (check_follower): no follower ever ANSWERED
    above its replicated settled floor, witnessed broker-side at the
    serve boundary independently of the fences under test
    (answers_past_floor). Payload safety of follower-served reads
    needs no extra machinery — they are recorded in the same history
    the exactly-once checker already runs over.

    `splits > 0` makes the run ELASTIC (either backend): the engine is
    sized with that many spare slots, the nemesis pool gains the
    split_partition / merge_partitions ops (schedule-pure — they race
    live splits and merges against whatever crashes/partitions the
    same phase draws, controller failover included), and the producer
    workload goes KEYED so the SDK's generation-fenced rerouting is on
    the hot path (stale_partition_gen refusals, dual-write forwarding,
    offset carry-over all exercised under fire). The verdict gains a
    `reconfig` section with TWO first-class invariants (check_reconfig):
    no handoff window still open at the end of the run, and every
    observed begin→cutover within `split_handoff_bound_s` — bounded
    time-to-rebalance, measured from the brokers' own replicated state
    and flight recorders. Exactly-once runs unconditionally over the
    split traffic: acked writes recorded against the partition the
    broker ROUTED them into, every partition that ever existed (retired
    children included) drained into the final logs."""
    t0 = time.time()
    device = _cluster_device(device)
    topic = "chaos"
    tmp = None
    witness_on = bool(lock_witness) and backend != "proc"
    if witness_on:
        from ripplemq_tpu_torch.obs import lockwitness

        lockwitness.reset()
        lockwitness.enable()
    if data_dir is None:
        # Durable stores are load-bearing: an in-proc restart recovers
        # the committed-round stream from disk, which is what makes the
        # no-acked-loss invariant CHECKABLE under controller crashes
        # even before a standby forms.
        tmp = data_dir = tempfile.mkdtemp(prefix=f"chaos-{seed}-")
    # SLO autopilot config (both backends): tight ticks so the shed
    # machine reacts inside a chaos phase; chain rails clamped to the
    # configured depth so the loop never compiles a fresh chain program
    # mid-fault (the loop steers coalesce + the settle window instead).
    slo_kw = {}
    if slo:
        slo_kw = dict(
            slo_p99_ack_ms=float(slo_target_p99_ms),
            slo_tick_s=0.2,
            slo_recover_s=float(slo_recover_s),
            slo_chain_depth_max=4,
        )
    if follower_reads:
        # Same splat shape as slo: the knob rides the ClusterConfig
        # into both backends (proc serializes it through the YAML
        # round-trip like every other field).
        slo_kw["follower_reads"] = True
    if splits > 0:
        # Tight handoff deadline: a split whose watermark never settles
        # (leader crashed mid-handoff) still cuts over inside a chaos
        # phase, comfortably under the verdict's bound.
        slo_kw["split_handoff_timeout_s"] = 3.0
    if backend == "proc":
        from ripplemq_tpu_torch.chaos.proc_cluster import (
            ProcCluster,
            free_ports,
            make_proc_cluster_config,
        )

        config = make_proc_cluster_config(
            free_ports(n_brokers),
            topics=(Topic(topic, partitions, replication),),
            linearizable_reads=True,  # same checker rationale as below
            # Short member sessions so a paused member's eviction (and
            # the rebalance it forces) lands INSIDE a chaos phase; the
            # beat-relay cadence scales down with it (default 0.5 s
            # leaves no margin against a 0.25 s workload heartbeat).
            group_session_timeout_s=0.8,
            heartbeat_relay_s=0.2,
            replication=replication_mode,
            # host_workers > 1 drives the multi-core host plane on real
            # broker subprocesses: every produce stamps/packs through a
            # worker, controller consumes serve off the settled mirror.
            host_workers=host_workers,
            spare_slots=splits,
            **slo_kw,
        )
        cluster = ProcCluster(config=config, data_dir=data_dir,
                              device=device)
    else:
        config = make_cluster_config(
            n_brokers=n_brokers,
            topics=(Topic(topic, partitions, replication),),
            rpc_timeout_s=3.0,
            **slo_kw,
            # The checker asserts offset monotonicity and committed-
            # prefix consistency ACROSS controller moves; with
            # linearizable_reads off, a deposed-but-partitioned
            # controller may serve stale reads (the DOCUMENTED anomaly,
            # README "deviations") and the checker would flag the
            # contract the deployment opted out of. The chaos cluster
            # opts IN, so every surviving violation is a real bug.
            linearizable_reads=True,
            group_session_timeout_s=0.8,  # see the proc branch above
            heartbeat_relay_s=0.2,  # see the proc branch above
            replication=replication_mode,
            host_workers=host_workers,  # see the proc branch above
            spare_slots=splits,
        )
        cluster = InProcCluster(config, data_dir=data_dir, device=device)
    history = History()
    verdict: dict = {"seed": seed, "phases": phases,
                     "ops_per_phase": ops_per_phase, "backend": backend,
                     "replication": replication_mode,
                     "host_workers": host_workers,
                     "follower_reads": follower_reads,
                     "splits": splits, "churn_storm": churn_storm}
    try:
        cluster.start()
        cluster.wait_for_leaders()
        nemesis = Nemesis(cluster, seed, phases,
                          ops_per_phase=ops_per_phase, schedule=schedule,
                          backend=backend, group_members=groups,
                          striped=(replication_mode == "striped"),
                          elastic=(splits > 0),
                          churn_storm=churn_storm)
        # Wait for one replication standby before the first crash:
        # settled appends are then provably on a promotable peer.
        deadline = time.time() + (120 if backend == "proc" else 20)
        while time.time() < deadline:
            if cluster.controller_ready():
                break
            time.sleep(0.05)
        workload = _Workload(cluster, seed, history, topic, partitions,
                             follower_reads=follower_reads,
                             keyed=(splits > 0))
        workload.start()
        group_workload = None
        if groups > 0:
            from ripplemq_tpu_torch.chaos.groups import GroupWorkload

            group_workload = GroupWorkload(
                cluster, seed, history, topic, partitions, members=groups,
            )
            nemesis.group_ops = group_workload
            group_workload.start()
        convergence = []
        try:
            # Clean warmup: consumer registration and the first
            # produce/consume cycle land before the adversary wakes
            # (faulted-window ops otherwise spend the whole phase inside
            # registration/retry stalls and the run exercises nothing).
            time.sleep(0.3)
            for phase in range(len(nemesis.schedule)):
                nemesis.run_phase(phase)
                time.sleep(phase_s)
                nemesis.heal_phase(phase)
                convergence.append(nemesis.wait_converged(
                    history=history, timeout=converge_timeout_s,
                    probe_tag=f"p{phase}",
                ))
            # Clean tail: post-heal reads drain through the workload
            # consumer too (its offsets advanced through the faults).
            time.sleep(0.3)
            # Group convergence is part of the verdict: after the last
            # heal, the members must settle on ONE stable generation
            # covering every partition (the rebalance-storm bound).
            group_verdict = None
            if group_workload is not None:
                group_verdict = group_workload.wait_converged(
                    timeout=converge_timeout_s
                )
                group_verdict["generations_seen"] = sorted(
                    group_workload.generations_seen
                )
        finally:
            workload.stop()
            if group_workload is not None:
                group_workload.stop()
        # Drain EVERY partition that exists at the end of the run — an
        # elastic run's splits mint children beyond the configured
        # count, and a retired merge child stays readable for exactly
        # this drain (the acked-loss check looks writes up in the log
        # they landed in, wherever routing put them).
        final_pids = sorted({
            a.partition_id for a in cluster.topic_view(topic)
        } | set(range(partitions)))
        final_logs = {
            (topic, pid): _drain_partition(cluster, topic, pid,
                                           tag=f"{seed}-{pid}")
            for pid in final_pids
        }
        # Clean-ack exactly-once is UNCONDITIONAL: wire-dup schedules
        # are collapsed by the idempotent-producer dedup plane (client
        # pids + broker stamping on the forwarded hop) — there is no
        # suspension branch, on purpose.
        stripe_contract = None
        if replication_mode == "striped":
            from ripplemq_tpu_torch.stripes.codec import RS_K, RS_M

            stripe_contract = {
                "k": RS_K, "m": RS_M,
                "holders_down": nemesis.max_stripe_kills_per_phase,
            }
            if nemesis.max_stripe_kills_per_phase > RS_M:
                # The loss check is about to be waived (hand-written or
                # edited schedule beyond the k-of-k+m contract): say so
                # in the verdict — a clean run with waived loss
                # checking must never read as a clean run.
                verdict["beyond_stripe_contract"] = True
        violations = check_history(history.ops(), final_logs,
                                   stripe=stripe_contract)
        if group_workload is not None:
            violations += check_group_history(history.ops())
            if not group_verdict.get("converged"):
                violations.append(
                    f"group convergence failed within "
                    f"{converge_timeout_s}s: {group_verdict}"
                )
        if lock_witness and not witness_on:
            # Asked for but unavailable: the witness cross-check is
            # in-proc only (the orderings live in broker SUBPROCESS
            # memory on the proc backend, with nothing to report
            # them). Say so in the verdict — a run that looks
            # witnessed but was not must never read as verified.
            verdict["lock_witness"] = {
                "enabled": False,
                "skipped": "proc backend: witness cross-check is "
                           "in-proc only",
            }
        if witness_on:
            # The witnessed graph must be acyclic AND contained in the
            # static graph's closure — either failure is a first-class
            # violation, exactly like acked loss: a cycle is a deadlock
            # that has not scheduled yet, and an uncovered edge is
            # static-analysis coverage silently lost to indirection.
            # (default_closure memoizes the repo parse across seeds.)
            from ripplemq_tpu_torch.analysis.lock_graph import default_closure
            from ripplemq_tpu_torch.obs import lockwitness

            wreport = lockwitness.report(static_closure=default_closure())
            verdict["lock_witness"] = wreport
            if not wreport["acyclic"]:
                violations.append(
                    f"lock witness observed acquisition cycles: "
                    f"{wreport['cycles']}"
                )
            if wreport["uncovered_edges"]:
                violations.append(
                    f"lock witness observed orderings outside the "
                    f"static lock graph's closure: "
                    f"{wreport['uncovered_edges']} — derive or declare "
                    f"them (analysis/lock_graph.py DECLARED_EDGES)"
                )
        if slo:
            # The degradation contract: shed
            # engages under the fault, safety held while shedding (the
            # checker above ran unconditionally), recovery to SLO
            # within slo_recover_s of heal. Its misses are first-class
            # violations — a violating run attaches postmortems below
            # exactly like an acked-loss one.
            slo_section, slo_violations = check_slo(
                _collect_slo_stats(cluster), nemesis.timeline,
                shed_bound_s=slo_shed_bound_s, recover_s=slo_recover_s,
                expect_shed=slo_expect_shed,
            )
            verdict["slo"] = slo_section
            violations += slo_violations
        if follower_reads:
            # Follower-read safety: no standby
            # ever answered above its settled floor — broker-side
            # boundary witness, first-class alongside exactly-once.
            f_section, f_violations = check_follower(
                _collect_follower_stats(cluster),
                workload.consumer.follower_served,
            )
            verdict["follower"] = f_section
            violations += f_violations
        if splits > 0:
            # Elastic reconfiguration contract:
            # bounded time-to-rebalance across every split the nemesis
            # raced against the same phase's crashes — first-class
            # alongside exactly-once, which already covered the split
            # traffic above.
            r_stats, r_events = _collect_reconfig(cluster)
            r_section, r_violations = check_reconfig(
                r_stats, r_events, nemesis.reconfig_log,
                handoff_bound_s=split_handoff_bound_s,
            )
            verdict["reconfig"] = r_section
            violations += r_violations
        ops = history.ops()
        # Telemetry collection — while the cluster is still up. Every
        # VIOLATING verdict carries the full diagnosis (per-broker
        # postmortem bundles + the merged fault-vs-lifecycle timeline);
        # clean runs collect only on request.
        postmortems: dict[str, dict] = {}
        broker_streams: dict[str, list[dict]] = {}
        broker_skews: dict[str, float] = {}
        if violations or include_postmortems or include_timeline:
            postmortems, broker_streams, broker_skews = \
                _collect_broker_obs(cluster)
        if violations or include_timeline:
            # Causal merge (merge_timeline): per-source seq order held,
            # cross-source interleave by skew-corrected wall clock —
            # never a raw wall-clock sort of the union.
            verdict["timeline"] = merge_timeline(
                {"nemesis": list(nemesis.timeline), **broker_streams},
                broker_skews,
            )
        if violations or include_postmortems:
            verdict["postmortems"] = postmortems
            # Sampled causal traces, assembled: every postmortem bundle
            # carries its broker's span ring; joined by trace id they
            # reassemble into critical-path trees (obs/assemble.py).
            # Empty when the run had tracing off.
            span_records = [r for pm in postmortems.values()
                            for r in pm.get("spans") or ()]
            if span_records:
                from ripplemq_tpu_torch.obs.assemble import assemble

                verdict["traces"] = assemble(span_records)[:10]
        if group_workload is not None:
            verdict["group"] = {"members": groups, **group_verdict}
        net = getattr(cluster, "net", None)
        verdict.update(
            # Forensics: how many scheduled wire duplications actually
            # DELIVERED (handler ran twice). Under the unconditional
            # exactly-once checker this is the proof a dup schedule
            # really exercised the dedup plane rather than having its
            # charges eaten by concurrent blocks/drops.
            wire_dups_applied=(net.dups_applied if net is not None else 0),
            trace=nemesis.trace,
            # Injection forensics (what the disk ops actually hit) —
            # informational, NOT part of the byte-reproducible trace.
            disk_faults=nemesis.disk_fault_log,
            schedule_digest=hashlib.sha256(
                trace_json(nemesis.trace).encode()
            ).hexdigest(),
            converged=all(c["converged"] for c in convergence),
            convergence=convergence,
            violations=violations,
            safe=(not violations) and all(c["converged"]
                                          for c in convergence),
            counts={
                "produce_ok": sum(1 for o in ops if o.get("op") == "produce"
                                  and o.get("status") == "ok"),
                "produce_fail": sum(1 for o in ops
                                    if o.get("op") == "produce"
                                    and o.get("status") == "fail"),
                "consume_ok": sum(1 for o in ops if o.get("op") == "consume"
                                  and o.get("status") == "ok"),
                "consume_unknown": sum(1 for o in ops
                                       if o.get("op") == "consume"
                                       and o.get("status") == "unknown"),
                "consume_follower": sum(1 for o in ops
                                        if o.get("op") == "consume"
                                        and o.get("follower")),
                "delivered": sum(len(o.get("payloads", [])) for o in ops
                                 if o.get("op") == "consume"),
            },
            final_log_sizes={f"{t}[{p}]": len(v)
                             for (t, p), v in final_logs.items()},
            elapsed_s=round(time.time() - t0, 3),
        )
        if include_history or violations:
            # A violating run's history IS the bug report — always
            # attach it (with the final logs) when something failed.
            verdict["history"] = ops
            verdict["final_logs"] = {
                f"{t}[{p}]": v for (t, p), v in final_logs.items()
            }
        return verdict
    finally:
        cluster.stop()
        if witness_on:
            from ripplemq_tpu_torch.obs import lockwitness

            lockwitness.disable()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def run_kill_all_drill(seed: int = 0, durability: str = "async",
                       n_msgs: int = 30,
                       data_dir: Optional[str] = None,
                       flush_lag_bound_s: float = 1.0,
                       device=None) -> dict:
    """Correlated FULL-CLUSTER SIGKILL durability drill (proc backend):
    produce acked messages against a live 3-broker process cluster,
    SIGKILL every broker at once, restart them all, drain, and hold the
    history to the `flush_async` durability contract — acked loss only
    inside the one-flush-interval window before the kill
    (`flush_lag_bound_s` is the checker's conservative envelope for it).
    With `durability="strict"` every settled round fsync'd before its
    ack, so the grace window is EMPTY: zero acked loss, full stop.
    `device`: as run_chaos's."""
    from ripplemq_tpu_torch.chaos.proc_cluster import (
        ProcCluster,
        free_ports,
        make_proc_cluster_config,
    )
    from ripplemq_tpu_torch.client import ProducerClient

    t0 = time.time()
    device = _cluster_device(device)
    topic = "drill"
    tmp = None
    if data_dir is None:
        tmp = data_dir = tempfile.mkdtemp(prefix=f"drill-{seed}-")
    config = make_proc_cluster_config(
        free_ports(3), topics=(Topic(topic, 1, 3),), durability=durability,
    )
    cluster = ProcCluster(config=config, data_dir=data_dir, device=device)
    history = History()
    try:
        cluster.start()
        cluster.wait_for_leaders()
        deadline = time.time() + 120
        while time.time() < deadline and not cluster.controller_ready():
            time.sleep(0.05)
        bootstrap = [b.address for b in config.brokers]
        producer = ProducerClient(
            bootstrap, transport=cluster.client(f"drill-{seed}"),
            metadata_refresh_s=0.5, rpc_timeout_s=5.0,
        )
        acked = 0

        def produce_batch(lo: int, hi: int) -> None:
            nonlocal acked
            for i in range(lo, hi):
                payload = f"drill:{seed}:{i}"
                try:
                    producer.produce(topic, payload.encode(), partition=0)
                except Exception as e:
                    history.record(op="produce", client="drill",
                                   topic=topic, partition=0,
                                   payload=payload, status="fail",
                                   error=f"{type(e).__name__}: {e}")
                else:
                    acked += 1
                    # Recorded AFTER the ack: `t` is the ack time the
                    # flush-lag window is measured against.
                    history.record(op="produce", client="drill",
                                   topic=topic, partition=0,
                                   payload=payload, status="ok")

        try:
            # Two batches bracketing the flush cadence, so BOTH halves
            # of the async contract are live: back-to-back localhost
            # produces all finish inside flush_lag_bound_s, and killing
            # right away would drop every ack into the grace window —
            # making the no-loss check vacuous. The settle between the
            # batches pushes the first one OUTSIDE the window (a
            # regression losing rounds older than one flush interval now
            # fails the drill in async mode too); the second batch lands
            # inside it, where async may lose and strict may not.
            produce_batch(0, n_msgs // 2)
            time.sleep(flush_lag_bound_s + 0.2)
            produce_batch(n_msgs // 2, n_msgs)
        finally:
            producer.close()
        t_kill = cluster.kill_all()
        for bid in cluster.brokers:
            cluster.restart(bid)
        cluster.wait_for_leaders()
        final = _drain_partition(cluster, topic, 0, tag=f"drill-{seed}",
                                 timeout_s=60.0)
        # The contract under test: strict ⇒ no grace at all; async ⇒
        # only acks inside the pre-kill flush-lag window may be lost.
        grace = (
            [] if durability == "strict"
            else [(t_kill - flush_lag_bound_s, t_kill)]
        )
        violations = check_history(
            history.ops(), {(topic, 0): final}, loss_grace=grace,
        )
        return {
            "seed": seed,
            "durability": durability,
            "backend": "proc",
            "acked": acked,
            "final_log_size": len(final),
            "kill_time": t_kill,
            "flush_lag_bound_s": 0.0 if durability == "strict"
            else flush_lag_bound_s,
            "violations": violations,
            "safe": not violations and acked > 0,
            "elapsed_s": round(time.time() - t0, 3),
        }
    finally:
        cluster.stop()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

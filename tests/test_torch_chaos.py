"""Fixed-seed chaos smoke (tier-1): the acceptance gate for issue 2.

Across >= 3 distinct seeds of crash/partition/delay/dup schedules, the
end-to-end safety checker must report ZERO violations (no acked loss,
committed-prefix and offset monotonicity, no phantoms, bounded
re-convergence after heal), and the fault trace must be byte-for-byte
reproducible from the seed alone.

The schedules here are real adversaries — each seed's two phases mix
broker crashes (controller included), isolation, symmetric/one-way
partitions, drops, delays, and duplication — but the run shape is kept
small (3 brokers, 2 partitions, ~0.5 s faulted windows) so the whole
module fits the tier-1 budget; the open-ended randomized soak lives in
test_torch_chaos_soak.py (slow).

Twin of `tests/test_chaos.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import pytest

from ripplemq_tpu_torch.chaos.history import check_history
from ripplemq_tpu_torch.chaos.nemesis import (
    expected_trace,
    make_schedule,
    trace_json,
)

from tests.helpers import assert_chaos_liveness
from tests.torch_port_modules import admit

admit(__name__)

SMOKE_SEEDS = (1, 3, 7)
PHASES = 2


@pytest.mark.parametrize("seed", SMOKE_SEEDS)
def test_fixed_seed_chaos_smoke(seed):
    from tests.torch_helpers import run_chaos

    # Convergence is a LIVENESS probe with a wall-clock deadline: on a
    # contended tier-1 host (hypervisor throttling phases measured >2x)
    # the default 30 s can flake while safety stays clean — give the
    # probe headroom; the safety checker's verdict is what gates.
    verdict = run_chaos(seed=seed, phases=PHASES, phase_s=0.5,
                        converge_timeout_s=90.0,
                        include_postmortems=True, include_timeline=True,
                        lock_witness=True)
    assert verdict["violations"] == [], (
        f"seed {seed} safety violations: {verdict['violations']}\n"
        f"trace: {trace_json(verdict['trace'])}"
    )
    # Concurrency-plane acceptance: the run recorded real
    # lock-acquisition orderings, the witnessed graph is ACYCLIC, and
    # every witnessed edge lies inside the port's static lock graph's
    # closure (an uncovered edge — an ordering the AST missed via
    # indirection — would have landed in `violations` above; these
    # assertions pin the section's shape and that the witness actually
    # observed the run).
    w = verdict["lock_witness"]
    assert w["acyclic"] and not w["cycles"]
    assert w["uncovered_edges"] == []
    assert "DataPlane._lock" in w["locks"], w["locks"]
    assert w["edges"], "witness enabled but no orderings observed"
    # Telemetry-plane acceptance: the verdict carries one
    # postmortem bundle per reachable broker — the exact surface a
    # violating run attaches automatically — and the merged
    # fault-vs-lifecycle timeline interleaves nemesis fault ops with
    # broker flight-recorder events by SKEW-CORRECTED time (per-source
    # seq order preserved — raw wall-clock sorting is gone).
    assert verdict["postmortems"], "no postmortem bundles collected"
    for bid, pm in verdict["postmortems"].items():
        assert pm["ok"] and pm["broker"] == int(bid)
        assert "metrics" in pm and "trace" in pm and "controller" in pm
    assert any(pm["engine"] is not None
               for pm in verdict["postmortems"].values()), (
        "no reachable broker reported an engine section"
    )
    tl = verdict["timeline"]
    srcs = {e["src"] for e in tl}
    assert "nemesis" in srcs and any(s.startswith("broker") for s in srcs)
    assert [e["tc"] for e in tl] == sorted(e["tc"] for e in tl)
    # Per-source order is never disturbed by the merge: each source's
    # events appear in their original (causal seq) order.
    for src in srcs:
        ts = [e["t"] for e in tl if e["src"] == src]
        assert ts == sorted(ts), src
    # Convergence gated on the documented contention flake class (the
    # gate is semantic — safety clean AND the drain served the full
    # log — not a wider timeout; see helpers.assert_chaos_liveness).
    assert_chaos_liveness(verdict)
    # The workload actually exercised the cluster through the faults.
    # Mid-run consume/delivery counts are contention-sensitive (a
    # consumer can spend a short faulted run inside retry stalls), so
    # the stable end-to-end read proof is the final DRAIN — which also
    # feeds the checker; per-read invariants still apply to every
    # consume that did happen.
    assert verdict["counts"]["produce_ok"] > 0
    assert sum(verdict["final_log_sizes"].values()) > 0
    # Byte-for-byte trace reproducibility: the applied trace equals the
    # pure-function expansion of the seed's schedule — rerunning the
    # same seed replays the identical fault trace.
    sched = make_schedule(seed, [0, 1, 2], PHASES, ops_per_phase=2)
    assert trace_json(verdict["trace"]) == trace_json(expected_trace(sched))


def test_striped_chaos_smoke():
    """Acceptance: striped replication under a fixed schedule
    with STRIPE FAULTS in it — a standby crashed with a disk fault
    landing in its stripe store (standby segments hold REC_STRIPE
    frames in striped mode, so disk_flip rot hits stripe bytes by
    construction), then a stripe-holder kill. Zero violations under the
    k-of-k+m loss accounting, bounded re-convergence, and the verdict
    names the replication plane."""
    from tests.torch_helpers import run_chaos

    schedule = [
        [{"op": "crash", "broker": 1},
         {"op": "disk_flip", "broker": 1, "salt": 11}],
        [{"op": "stripe_kill", "holder": 0}],
    ]
    verdict = run_chaos(seed=11, n_brokers=4, phases=2, phase_s=0.5,
                        schedule=schedule, replication_mode="striped",
                        converge_timeout_s=90.0, lock_witness=True)
    assert verdict["replication"] == "striped"
    assert verdict["violations"] == [], verdict["violations"]
    # The stripes plane's locks (encoder condition, tracker lock,
    # sender conditions) are inside the witnessed cross-checks too —
    # striped mode exercises orderings the full-copy smoke never
    # constructs.
    assert verdict["lock_witness"]["acyclic"]
    assert verdict["lock_witness"]["uncovered_edges"] == []
    assert "StripeReplicator._lock" in verdict["lock_witness"]["locks"]
    assert_chaos_liveness(verdict)
    ops = [t["op"] for t in verdict["trace"]]
    assert "stripe_kill" in ops and "disk_flip" in ops
    assert "restart_holder" in ops  # holder-indexed restart in trace
    assert verdict["counts"]["produce_ok"] > 0
    assert sum(verdict["final_log_sizes"].values()) > 0
    # The stripe kill resolved against the replicated map (forensics).
    hits = [d for d in verdict["disk_faults"] if d.get("op") == "stripe_kill"]
    assert hits and "resolved_broker" in hits[0]


def test_striped_schedule_sizes_stripe_kills_to_m():
    from ripplemq_tpu_torch.stripes.codec import RS_M

    for seed in range(25):
        sched = make_schedule(seed, list(range(5)), phases=3,
                              ops_per_phase=5, striped=True)
        for ops in sched:
            kills = [op for op in ops if op["op"] == "stripe_kill"]
            crashed = {op["broker"] for op in ops if op["op"] == "crash"}
            assert len(kills) <= RS_M, (seed, ops)
            # Stripe kills consume the crash budget: the combined
            # concurrent downage keeps the metadata majority alive.
            assert len(crashed) + len(kills) <= (5 - 1) // 2, (seed, ops)
    # The pool actually draws them.
    assert any(
        op["op"] in ("stripe_kill", "stripe_partition")
        for seed in range(10)
        for ops in make_schedule(seed, [0, 1, 2, 3], phases=2,
                                 ops_per_phase=3, striped=True)
        for op in ops
    )


def test_schedule_is_a_pure_function_of_the_seed():
    for seed in (0, 1, 2, 3, 42, 1337):
        a = make_schedule(seed, [0, 1, 2], phases=4, ops_per_phase=3)
        b = make_schedule(seed, [0, 1, 2], phases=4, ops_per_phase=3)
        assert trace_json(expected_trace(a)) == trace_json(expected_trace(b))
    # Distinct seeds diverge (the space is not degenerate).
    traces = {
        trace_json(expected_trace(
            make_schedule(s, [0, 1, 2], phases=4, ops_per_phase=3)
        ))
        for s in range(8)
    }
    assert len(traces) > 1


def test_schedule_never_crashes_the_majority():
    for seed in range(25):
        for n in (3, 5):
            sched = make_schedule(seed, list(range(n)), phases=3,
                                  ops_per_phase=4)
            for ops in sched:
                crashed = {op["broker"] for op in ops
                           if op["op"] == "crash"}
                assert len(crashed) <= (n - 1) // 2, (seed, n, ops)


def test_lockstep_worker_kill_op():
    """With a lockstep worker roster the schedule pool includes
    kill_worker, and applying it downs the worker endpoint (exercising
    the broken-plane → abdication path in a lockstep deployment); the
    draws are the reference's, and without a roster the pool never
    holds it."""
    from ripplemq_tpu.chaos.nemesis import make_schedule as ref_schedule
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from ripplemq_tpu_torch.chaos.nemesis import Nemesis
    from ripplemq_tpu_torch.wire import InProcNetwork

    assert any(
        op["op"] == "kill_worker"
        for seed in range(40)
        for ops in make_schedule(seed, [0, 1, 2], phases=2,
                                 ops_per_phase=3,
                                 lockstep_workers=("w0", "w1"))
        for op in ops
    ), "kill_worker never drawn from the lockstep op pool"
    for seed in range(40):
        kw = dict(phases=2, ops_per_phase=3, lockstep_workers=("w0", "w1"))
        assert (make_schedule(seed, [0, 1, 2], **kw)
                == ref_schedule(seed, [0, 1, 2], **kw))

    class _Stub:
        config = make_cluster_config(3)
        net = InProcNetwork()
        brokers = {0: None, 1: None, 2: None}

    stub = _Stub()
    nem = Nemesis(stub, seed=0, phases=1, lockstep_workers=("w0",),
                  schedule=[[{"op": "kill_worker", "worker": "w0"}]])
    nem.run_phase(0)
    assert "w0" in stub.net._down
    nem.heal_phase(0)
    assert "w0" not in stub.net._down
    assert not any(
        op["op"] == "kill_worker"
        for seed in range(40)
        for ops in make_schedule(seed, [0, 1, 2], phases=2,
                                 ops_per_phase=3)
        for op in ops
    )


def test_wire_dup_schedule_exactly_once():
    """Acceptance: the exact schedule SHAPE that once forced a
    suspension — wire duplication (`dup_next`) across every broker link
    while produce traffic flows, so forwarded produce/engine.append
    frames deliver twice — now passes the UNCONDITIONAL clean-ack
    exactly-once checker: the idempotent-producer dedup plane (client
    pids + broker stamping on the forwarded hop) collapses the replays.
    The verdict's `wire_dups_applied` proves duplications really
    delivered (charges not eaten by other faults: the schedule is dups
    ONLY). The proc backend's fixed-seed smoke (tests/test_proc_chaos)
    runs the same unconditional checker — there is no suspension left
    to fall back to on either backend."""
    from tests.torch_helpers import run_chaos

    brokers = [0, 1, 2]
    dup_ops = [
        {"op": "dup", "a": a, "b": b, "n": 6}
        for a in brokers for b in brokers if a != b
    ]
    verdict = run_chaos(
        seed=2024, phases=2, phase_s=0.8,
        schedule=[list(dup_ops), list(dup_ops)],
        converge_timeout_s=90.0,
    )
    assert verdict["wire_dups_applied"] > 0, (
        "no wire duplication actually delivered — the schedule failed "
        "to exercise the dedup plane"
    )
    assert verdict["violations"] == [], verdict["violations"]
    assert verdict["counts"]["produce_ok"] > 0


def test_group_rebalance_storm_smoke():
    """Acceptance (tier-1 slice): a fixed rebalance-storm
    schedule — heartbeat-pause (eviction), membership churn, and
    commit-from-deposed-member ops — over a 3-member group, with the
    group invariants armed: zero same-generation dual ownership, acked
    offset commits survive every rebalance, the stale commit is FENCED,
    and the members converge to one stable generation after heal. At
    least 3 forced rebalances (each churn bumps the generation twice,
    each eviction once). The open-ended randomized storm lives in
    test_chaos_soak.py (slow)."""
    from tests.torch_helpers import run_chaos

    storm = [
        [{"op": "member_churn", "member": 1},
         {"op": "stale_commit", "member": 0}],
        [{"op": "member_pause", "member": 2},
         {"op": "member_churn", "member": 0}],
    ]
    verdict = run_chaos(
        seed=77, phases=2, phase_s=1.2, schedule=storm, groups=3,
        converge_timeout_s=90.0, include_history=True,
    )
    assert verdict["violations"] == [], verdict["violations"]
    g = verdict["group"]
    assert g["converged"], g
    # Forced rebalances: strictly more than the three bootstrap joins'
    # generations — the storm moved the group at least 3 more times.
    assert len(g["generations_seen"]) >= 4, g
    # The stale commit actually ran and was fenced (required outcome).
    stale = [o for o in verdict["history"] if o.get("stale")]
    assert stale, "stale_commit op never fired"
    assert all(o["status"] != "ok" for o in stale), stale
    assert any(o.get("fence_outcome") == "fenced" for o in stale), stale


# ------------------------------------------------------- checker unit tests

def _produce(payload, status="ok", attempts=1, pid=0):
    return {"op": "produce", "client": "p", "topic": "t", "partition": pid,
            "payload": payload, "status": status, "attempts": attempts}


def test_checker_flags_acked_loss():
    ops = [_produce("a"), _produce("b")]
    v = check_history(ops, {("t", 0): ["a"]})
    assert len(v) == 1 and "acked loss" in v[0] and "'b'" in v[0]


def test_checker_flags_phantom_and_clean_dup():
    """Clean-ack exactly-once is UNCONDITIONAL: the wire-dup
    suspension branch is gone — idempotent producer dedup is what
    must make the invariant hold, so a clean dup is ALWAYS a violation
    (there is no keyword to turn the check off anymore)."""
    import inspect

    ops = [_produce("a")]
    v = check_history(ops, {("t", 0): ["a", "a", "ghost"]})
    kinds = "".join(v)
    assert "phantom" in kinds and "duplicate beyond contract" in kinds
    assert "allow_wire_dups" not in inspect.signature(
        check_history
    ).parameters


def test_checker_allows_retried_duplicates_and_unknown_absence():
    ops = [
        _produce("a", attempts=3),        # retried: may duplicate
        _produce("b", status="unknown"),  # in-flight at crash: may be lost
        _produce("c", status="fail"),     # nacked: may still have landed
    ]
    assert check_history(ops, {("t", 0): ["a", "a", "c"]}) == []


def test_checker_flags_order_violation():
    ops = [
        _produce("a"), _produce("b"),
        {"op": "consume", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 0, "next_offset": 2,
         "payloads": ["b", "a"]},
    ]
    v = check_history(ops, {("t", 0): ["a", "b"]})
    assert any("order violation" in x for x in v)


def test_checker_flags_offset_regression_and_redelivery():
    ops = [
        _produce("a"), _produce("b"),
        {"op": "consume", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 0, "next_offset": 4, "payloads": ["a"]},
        {"op": "commit", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 4},
        # Redelivery below the acked commit: at-most-once violation.
        {"op": "consume", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 0, "next_offset": 4, "payloads": ["a"]},
    ]
    v = check_history(ops, {("t", 0): ["a", "b"]})
    assert any("redelivery below acked commit" in x for x in v)
    assert any("offset went backward" in x for x in v)


def test_checker_passes_clean_history():
    ops = [
        _produce("a"), _produce("b", pid=1),
        {"op": "consume", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 0, "next_offset": 4, "payloads": ["a"]},
        {"op": "commit", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 4},
        {"op": "consume", "client": "c", "topic": "t", "partition": 0,
         "status": "ok", "offset": 4, "next_offset": 4, "payloads": []},
    ]
    assert check_history(ops, {("t", 0): ["a"], ("t", 1): ["b"]}) == []


# --------------------------------------------------------- timeline merge


def test_merge_timeline_corrects_forced_skew():
    """DIRECTED forced-skew case: a broker whose wall clock runs 10 s
    ahead must not have its events sorted into the future. The skew
    estimate (from the admin.trace RPC's NTP-style midpoint) pulls the
    stream back into the nemesis frame; a raw wall-clock sort — what
    the merge replaced — gets the interleaving wrong."""
    from ripplemq_tpu_torch.chaos.harness import merge_timeline

    nem = [{"src": "nemesis", "t": 100.00, "type": "crash"},
           {"src": "nemesis", "t": 100.30, "type": "heal"}]
    brk = [{"src": "broker0", "t": 110.10, "type": "dispatch"},
           {"src": "broker0", "t": 110.20, "type": "commit"}]
    merged = merge_timeline({"nemesis": nem, "broker0": brk},
                            skews={"broker0": 10.0})
    order = [(e["src"], e["type"]) for e in merged]
    assert order == [("nemesis", "crash"), ("broker0", "dispatch"),
                     ("broker0", "commit"), ("nemesis", "heal")]
    # Corrected stamps are monotone and carried on every event.
    assert [e["tc"] for e in merged] == sorted(e["tc"] for e in merged)
    assert merged[1]["tc"] == pytest.approx(100.10)
    # The raw wall-clock sort this replaces interleaves wrongly: both
    # broker events land after the heal.
    raw = [(e["src"], e["type"])
           for e in sorted(nem + brk, key=lambda e: e["t"])]
    assert raw != order and raw[-2:] == [("broker0", "dispatch"),
                                         ("broker0", "commit")]


def test_merge_timeline_never_reorders_within_a_source():
    """Per-source seq order is the causal truth; the skew estimate is
    not. Even a stream whose raw stamps are non-monotone (clock step
    mid-run) keeps its original order, and absent skews default to 0."""
    from ripplemq_tpu_torch.chaos.harness import merge_timeline

    stepped = [{"src": "x", "t": 5.0, "type": "a"},
               {"src": "x", "t": 4.0, "type": "b"},
               {"src": "x", "t": 6.0, "type": "c"}]
    merged = merge_timeline({"x": stepped})
    assert [e["type"] for e in merged] == ["a", "b", "c"]
    assert [e["tc"] for e in merged] == [5.0, 4.0, 6.0]
    assert merge_timeline({}) == []

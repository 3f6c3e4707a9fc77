"""Fixed-seed elastic-partition chaos smokes (tier-1): online split/merge raced against crashes, network faults
and controller failover, on BOTH backends.

`splits=2` provisions two spare engine slots and turns the run
elastic: the nemesis pool gains the schedule-pure `split_partition` /
`merge_partitions` ops, the producer workload goes KEYED through the
generation-fenced routing (re-resolving on `stale_partition_gen:`
refusals instead of blind-retrying), and the verdict gains a
`reconfig` section whose invariants are first-class violations:

1. no handoff window is still open at the end of the run — the
   replicated handoff table is the authoritative time-to-rebalance
   bound (every begun split either cut over on its watermark or timed
   out into cutover on the split_handoff_timeout_s deadline);
2. every observed begin→cutover pair completed inside the
   split_handoff_bound_s budget (flight-recorder events, deduped
   across brokers).

The unconditional exactly-once checker already runs over the keyed
split traffic: generation fencing changes ROUTING, never settled
state, so acked-write loss / duplication / reorder across a handoff
would surface there. The seeds are pinned to schedules that actually
race an elastic op against a crash (verified when this smoke was
built); schedule purity keeps them racing forever.

Directed units on the split protocol itself (range math, fencing,
offset carry-over, lease ordering) live in tests/test_split.py; the
checker units for the `reconfig` section are there too.

Twin of `tests/test_split_chaos.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

from ripplemq_tpu_torch.chaos.nemesis import (
    expected_trace,
    make_schedule,
    trace_json,
)
from tests.helpers import assert_chaos_liveness
from tests.torch_port_modules import admit

admit(__name__)

# Seed 3's in-proc schedule (3 phases, 2 ops): a crash phase, then a
# network partition, then split_partition raced against another
# partition — the split's metadata proposal and its cutover duty both
# cross a disturbed cluster.
INPROC_SEED = 3
# Proc seed 2: merge raced against a SIGKILL + torn-tail disk fault,
# then a double-split phase — elastic ops over real subprocesses.
PROC_SEED = 2
PHASES = 3


def _assert_elastic_verdict(verdict, seed, backend):
    assert verdict["violations"] == [], (
        f"seed {seed} ({backend}) violations: {verdict['violations']}\n"
        f"trace: {trace_json(verdict['trace'])}\n"
        f"reconfig: {verdict.get('reconfig')}"
    )
    # Convergence gated on the documented contention flake class, like
    # every other smoke (helpers.assert_chaos_liveness).
    assert_chaos_liveness(verdict)
    assert verdict["splits"] == 2
    r = verdict["reconfig"]
    # The section is present and internally consistent even when the
    # drawn candidates no-opped (e.g. a merge with nothing to merge):
    # attempts come from the nemesis log, transitions from the flight
    # recorders, and the rebalance bound holds either way.
    assert r["splits_attempted"] + r["merges_attempted"] > 0, r
    assert r["open_handoffs_at_end"] == [], r
    assert r["splits_begun"] >= len(r["cutover_durations_s"])
    assert all(d <= r["handoff_bound_s"]
               for d in r["cutover_durations_s"]), r
    assert verdict["counts"]["produce_ok"] > 0
    assert sum(verdict["final_log_sizes"].values()) > 0
    # Byte-for-byte reproducibility holds for the elastic pool too.
    sched = make_schedule(seed, [0, 1, 2], PHASES, ops_per_phase=2,
                          backend=backend, elastic=True)
    assert trace_json(verdict["trace"]) == trace_json(expected_trace(sched))


def test_fixed_seed_split_chaos_smoke_inproc():
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=INPROC_SEED, phases=PHASES, phase_s=0.8,
                        ops_per_phase=2, splits=2)
    _assert_elastic_verdict(verdict, INPROC_SEED, "inproc")


def test_fixed_seed_split_chaos_smoke_proc():
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=PROC_SEED, phases=PHASES, phase_s=0.8,
                        ops_per_phase=2, backend="proc", splits=2,
                        converge_timeout_s=120.0)
    assert verdict["backend"] == "proc"
    _assert_elastic_verdict(verdict, PROC_SEED, "proc")

"""One-command chaos soak: seeded nemesis + safety checker, JSON verdict.

    python -m ripplemq_tpu_torch.profiles.chaos_soak --seed 7
    python -m ripplemq_tpu_torch.profiles.chaos_soak --seed 7 --phases 6 --phase-s 1.0
    python -m ripplemq_tpu_torch.profiles.chaos_soak --sweep 10   # seeds 0..9
    python -m ripplemq_tpu_torch.profiles.chaos_soak --replay trace.json
    python -m ripplemq_tpu_torch.profiles.chaos_soak --backend proc --seed 3
        # real broker subprocesses over TCP: SIGKILL + disk-fault
        # schedules (torn tail / bit flip / lost sealed segment)

Every run prints ONE JSON document: seed, the applied fault trace, its
sha256 digest (byte-for-byte reproducible from the seed — re-running
`--seed N` yields the identical digest, and the same digest as the
reference's `profiles/chaos_soak.py --seed N` with the same flags),
per-phase convergence, the safety-invariant violations (empty = safe),
and workload counts. A failing soak is therefore a complete bug report:
ship the JSON, replay with `--seed N` (or `--replay trace.json` after
editing the schedule down to a minimal reproducer). The exit code is 0
when every run is safe, else 1.

Twin of the reference's `profiles/chaos_soak.py` over the port's
`chaos.run_chaos`, with one difference: every broker's device work runs
on CUDA unless `--device cpu` is given, and the tool raises on a host
without a GPU (the reference forces its CPU backend).
"""

from __future__ import annotations

import argparse
import json
import sys

# Restarts and heals are emitted by the nemesis itself: a replayed
# schedule carries only the fault ops.
_NEMESIS_OPS = ("restart", "restart_holder", "heal")


def replay_schedule(doc, args) -> list:
    """The fault schedule of a recorded trace (a bare op list, or a full
    verdict), grouped by phase. A recorded verdict's `backend`,
    `replication` and `splits` override the flags: a proc trace (SIGKILL
    + disk ops) replayed in-process, a striped trace on full copies, or
    an elastic trace without its spare slots would silently change what
    is being reproduced."""
    trace = doc["trace"] if isinstance(doc, dict) else doc
    if isinstance(doc, dict) and "backend" in doc:
        args.backend = doc["backend"]
    if isinstance(doc, dict) and doc.get("replication"):
        args.replication = doc["replication"]
    if isinstance(doc, dict) and doc.get("splits"):
        args.splits = int(doc["splits"])
    n_phases = 1 + max((t.get("phase", 0) for t in trace), default=0)
    schedule = [[] for _ in range(n_phases)]
    for t in trace:
        op = {k: v for k, v in t.items() if k != "phase"}
        if op.get("op") not in _NEMESIS_OPS:
            schedule[t.get("phase", 0)].append(op)
    return schedule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", type=int, default=0,
                    help="run seeds 0..N-1 instead of --seed")
    ap.add_argument("--phases", type=int, default=3)
    ap.add_argument("--phase-s", type=float, default=0.6)
    ap.add_argument("--ops-per-phase", type=int, default=2)
    ap.add_argument("--brokers", type=int, default=3)
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--backend", choices=["inproc", "proc"],
                    default="inproc",
                    help="'proc' boots real broker subprocesses over TCP "
                         "and drives SIGKILL + disk-fault schedules "
                         "(torn tail / bit flip / lost sealed segment) "
                         "instead of in-proc network faults; identical "
                         "JSON verdict schema")
    ap.add_argument("--groups", type=int, default=0,
                    help="run a consumer-group workload of N members "
                         "and join the REBALANCE-STORM ops to the "
                         "nemesis pool (member_pause / member_churn / "
                         "stale_commit) on either backend; the checker "
                         "adds the group invariants (no same-generation "
                         "dual ownership, acked commits survive "
                         "rebalance, stale commits fenced, bounded "
                         "post-storm convergence)")
    ap.add_argument("--churn-storm", action="store_true",
                    help="join the churn_burst op to the nemesis pool "
                         "(needs --groups): several members leave+rejoin "
                         "simultaneously so the control plane's wave "
                         "batching forms wide multi-member OP_BATCH "
                         "proposals whose boundaries race the same "
                         "phase's controller crashes/SIGKILLs; the group "
                         "invariants must hold unconditionally over the "
                         "batched path on either backend")
    ap.add_argument("--replication", choices=["full", "striped"],
                    default="full",
                    help="'striped' runs the cluster with Reed–Solomon "
                         "striped replication (stripes/) and joins the "
                         "STRIPE-HOLDER ops to the nemesis pool "
                         "(stripe_kill / stripe_partition, sized to m); "
                         "the checker holds the run to the k-of-k+m "
                         "durability contract")
    ap.add_argument("--host-workers", type=int, default=1,
                    help="run every broker with N host-plane worker "
                         "subprocesses (parallel/hostplane.py): "
                         "produces stamp/pack through the shared-memory "
                         "rings, controller consumes serve off the "
                         "settled mirror; works on both backends")
    ap.add_argument("--timeline", action="store_true",
                    help="attach the merged fault-vs-lifecycle timeline "
                         "(nemesis fault ops + every broker's flight-"
                         "recorder events, sorted by wall clock) even on "
                         "clean runs; violating runs always carry it")
    ap.add_argument("--witness", action="store_true",
                    help="enable the runtime lock witness for the run "
                         "(in-proc backend): the verdict gains a "
                         "lock_witness section, and a witnessed "
                         "acquisition cycle or an edge outside the "
                         "static lock graph's closure "
                         "(analysis/lock_graph.py) is a violation")
    ap.add_argument("--postmortems", action="store_true",
                    help="attach per-broker admin.postmortem bundles even "
                         "on clean runs; violating runs always carry them")
    ap.add_argument("--slo", action="store_true",
                    help="run the cluster with the SLO autopilot engaged "
                         "(slo/controller.py): the verdict gains an `slo` "
                         "section and the degradation contract — shed "
                         "engages under a sustained fault, safety holds "
                         "while shedding, recovery to SLO within "
                         "slo_recover_s of heal — is checked as "
                         "first-class violations")
    ap.add_argument("--follower-reads", action="store_true",
                    help="run the cluster with the follower-read plane "
                         "on (broker/follower.py) and the workload "
                         "consumer routing through it (backlogged reads "
                         "go to leased standbys, refusals fall back to "
                         "the leader); the verdict gains a `follower` "
                         "section, and a follower answering above its "
                         "replicated settled floor is a first-class "
                         "violation; works on both backends and both "
                         "replication modes")
    ap.add_argument("--splits", type=int, default=0,
                    help="provision N spare engine slots and run the "
                         "cluster ELASTIC: the nemesis pool gains online "
                         "split_partition/merge_partitions ops (raced "
                         "against crashes and controller failover), the "
                         "producer workload goes keyed through the "
                         "generation-fenced routing, and the verdict "
                         "gains a `reconfig` section whose bounded "
                         "time-to-rebalance invariants are first-class "
                         "violations; works on both backends")
    ap.add_argument("--replay", type=str, default=None,
                    help="JSON file holding a recorded trace (or a full "
                         "verdict) to re-apply instead of generating "
                         "from --seed")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the verdict JSON to this path")
    ap.add_argument("--device", default=None,
                    help="torch device for every broker's device work "
                         "(default CUDA; 'cpu' runs it on the CPU)")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.chaos import run_chaos

    schedule = None
    if args.replay:
        with open(args.replay) as f:
            schedule = replay_schedule(json.load(f), args)

    seeds = list(range(args.sweep)) if args.sweep else [args.seed]
    results = []
    for seed in seeds:
        v = run_chaos(
            seed=seed,
            n_brokers=args.brokers,
            partitions=args.partitions,
            phases=args.phases,
            phase_s=args.phase_s,
            ops_per_phase=args.ops_per_phase,
            schedule=schedule,
            backend=args.backend,
            groups=args.groups,
            churn_storm=args.churn_storm,
            replication_mode=args.replication,
            include_timeline=args.timeline,
            include_postmortems=args.postmortems,
            lock_witness=args.witness,
            host_workers=args.host_workers,
            slo=args.slo,
            follower_reads=args.follower_reads,
            splits=args.splits,
            # Process boots (a torch import and a CUDA context per
            # broker) put convergence probes on a different clock than
            # in-proc runs.
            converge_timeout_s=120.0 if args.backend == "proc" else 30.0,
            device=args.device,
        )
        results.append(v)
    out = results[0] if len(results) == 1 else {
        "sweep": len(results),
        "safe": all(r["safe"] for r in results),
        "unsafe_seeds": [r["seed"] for r in results if not r["safe"]],
        "runs": results,
    }
    doc = json.dumps(out, indent=1)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc)
    return 0 if (out["safe"] if "safe" in out else True) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Fixed-seed chaos smoke on the MULTI-CORE host plane (tier-1): the same crash/partition/delay/dup adversary as
test_chaos.py, but every broker runs `host_workers=2` — produces
stamp/pack through worker subprocesses over the shared-memory rings,
controller consumes serve off the settled mirror, and the pipelined
replication stream carries the rounds. The safety checker must stay at
ZERO violations (no acked loss, committed-prefix + offset monotonicity,
no phantoms) and the runtime lock witness must stay acyclic — the
worker plane adds leaf locks, never orderings.

Twin of `tests/test_hostplane_chaos.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

from ripplemq_tpu_torch.chaos.nemesis import trace_json
from tests.helpers import assert_chaos_liveness
from tests.torch_port_modules import admit

admit(__name__)

SEED = 5
PHASES = 2


def test_fixed_seed_chaos_smoke_with_host_workers():
    from tests.torch_helpers import run_chaos

    verdict = run_chaos(seed=SEED, phases=PHASES, phase_s=0.5,
                        converge_timeout_s=90.0, lock_witness=True,
                        host_workers=2)
    assert verdict["host_workers"] == 2
    assert verdict["violations"] == [], (
        f"host-plane chaos violations: {verdict['violations']}\n"
        f"trace: {trace_json(verdict['trace'])}"
    )
    # The worker plane's locks join the witnessed graph without adding
    # orderings outside the static closure.
    w = verdict["lock_witness"]
    assert w["acyclic"] and not w["cycles"]
    assert w["uncovered_edges"] == []
    # Contention-gated (semantic gate; helpers.assert_chaos_liveness).
    assert_chaos_liveness(verdict)
    # The workload really flowed through the worker plane: produces
    # acked and the final drain read rows back.
    assert verdict["counts"]["produce_ok"] > 0
    assert sum(verdict["final_log_sizes"].values()) > 0


def test_host_plane_committed_prefix_matches_single_process():
    """Byte-identical committed prefixes: the SAME deterministic
    workload against host_workers=2 and host_workers=1 clusters drains
    to identical per-partition message streams — the worker plane
    moves interpreter work, never bytes."""
    import dataclasses

    from tests.torch_helpers import InProcCluster, make_config

    def drive(host_workers: int) -> dict:
        cfg = dataclasses.replace(make_config(3),
                                  host_workers=host_workers)
        out = {}
        with InProcCluster(cfg) as c:
            c.wait_for_leaders()
            client = c.client()
            for p in (0, 1):
                lead = c.brokers[
                    next(iter(c.brokers.values()))
                    .manager.leader_of(("topic1", p))
                ]
                for i in range(6):
                    resp = client.call(lead.addr, {
                        "type": "produce", "topic": "topic1",
                        "partition": p,
                        "messages": [b"w%d-p%d-i%d-m%d" % (host_workers,
                                                           p, i, j)
                                     for j in range(3)],
                    })
                    assert resp.get("ok"), resp
            for p in (0, 1):
                lead = c.brokers[
                    next(iter(c.brokers.values()))
                    .manager.leader_of(("topic1", p))
                ]
                msgs, offset = [], 0
                while True:
                    resp = client.call(lead.addr, {
                        "type": "consume", "topic": "topic1",
                        "partition": p, "consumer": f"drain-{p}",
                        "offset": offset,
                    })
                    assert resp.get("ok"), resp
                    if not resp["messages"]:
                        break
                    msgs += resp["messages"]
                    offset = resp["next_offset"]
                # Strip the worker-count tag so the two runs compare.
                out[p] = [m.split(b"-", 1)[1] for m in msgs]
        return out

    assert drive(2) == drive(1)

"""Long process-level chaos soak (slow tier): randomized SIGKILL +
disk-fault schedules against real broker subprocesses, plus the
correlated full-cluster kill durability drill. The fixed-seed tier-1
gate lives in test_torch_proc_chaos.py; run this module when touching
recovery, storage, replication, or failover code:

    pytest tests/test_torch_proc_chaos_soak.py -m slow -q

Every failure prints the seed and the byte-reproducible fault trace;
`python -m ripplemq_tpu_torch.profiles.chaos_soak --backend proc --seed N
--device cpu` replays it outside pytest (`PROC_CHAOS_SEEDS=lo:hi` widens
the hunt).

Twin of `tests/test_proc_chaos_soak.py` on the PyTorch port (CPU broker
processes), slow-marked as the reference is;
`tests/test_torch_proc_chaos.py` is the fixed-seed tier-1 gate.
"""

from __future__ import annotations

import os

import pytest

from ripplemq_tpu_torch.chaos import run_kill_all_drill
from ripplemq_tpu_torch.chaos.nemesis import trace_json
from tests.torch_helpers import run_chaos
from tests.torch_port_modules import admit

pytestmark = pytest.mark.slow

admit(__name__)

_spec = os.environ.get("PROC_CHAOS_SEEDS", "0:6")
_lo, _hi = (int(x) for x in _spec.split(":"))
SOAK_SEEDS = range(_lo, _hi)


@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_randomized_proc_soak_seed(seed):
    verdict = run_chaos(
        seed=seed,
        n_brokers=3,
        partitions=2,
        phases=3,
        phase_s=1.0,
        ops_per_phase=3,
        backend="proc",
        converge_timeout_s=120.0,
    )
    assert verdict["violations"] == [], (
        f"seed {seed}: {verdict['violations']}\n"
        f"replay: python -m ripplemq_tpu_torch.profiles.chaos_soak "
        f"--device cpu --backend proc "
        f"--seed {seed} --phases 3 --ops-per-phase 3\n"
        f"trace: {trace_json(verdict['trace'])}\n"
        f"disk faults: {verdict['disk_faults']}"
    )
    assert verdict["converged"], (
        f"seed {seed} unconverged: {verdict['convergence']}\n"
        f"trace: {trace_json(verdict['trace'])}"
    )


def test_proc_chaos_with_host_workers():
    """Multi-core host plane on the PROC backend: real
    broker subprocesses, each running host_workers=2 worker
    subprocesses over shared-memory rings, through a seeded SIGKILL +
    disk-fault schedule — the safety checker's contract is unchanged."""
    verdict = run_chaos(
        seed=2,
        n_brokers=3,
        partitions=2,
        phases=2,
        phase_s=1.0,
        ops_per_phase=2,
        backend="proc",
        host_workers=2,
        converge_timeout_s=120.0,
    )
    assert verdict["host_workers"] == 2
    assert verdict["violations"] == [], (
        f"host-plane proc chaos: {verdict['violations']}\n"
        f"replay: python -m ripplemq_tpu_torch.profiles.chaos_soak "
        f"--device cpu --backend proc --seed 2 "
        f"--phases 2 --host-workers 2\n"
        f"trace: {trace_json(verdict['trace'])}"
    )
    assert verdict["converged"], verdict["convergence"]
    assert verdict["counts"]["produce_ok"] > 0


@pytest.mark.parametrize("durability", ["async", "strict"])
def test_kill_all_durability_drill(durability):
    """Correlated full-cluster SIGKILL: with `durability=async`, acked
    loss is bounded by one flush interval (the checker's grace window);
    with `durability=strict` the window is EMPTY — every acked round
    fsync'd before its ack, zero loss, full stop."""
    v = run_kill_all_drill(seed=3, durability=durability, n_msgs=25,
                           device="cpu")
    assert v["safe"], v
    assert v["acked"] > 0
    if durability == "strict":
        assert v["flush_lag_bound_s"] == 0.0

"""Long randomized chaos soak (slow tier): wider clusters, deeper
schedules, many seeds. The fixed-seed tier-1 gate lives in
test_torch_chaos.py; this module is the open-ended adversary — run it when
touching consensus, replication, retry, or failover code:

    pytest tests/test_torch_chaos_soak.py -m slow -q

Every failure prints the seed and the byte-reproducible fault trace;
`python -m ripplemq_tpu_torch.profiles.chaos_soak --seed N --device cpu`
replays it outside pytest.

Twin of `tests/test_chaos_soak.py` on the PyTorch port (CPU brokers),
slow-marked as the reference is; `tests/test_torch_chaos.py` is the
fixed-seed tier-1 gate.
"""

from __future__ import annotations

import os

import pytest

from ripplemq_tpu_torch.chaos.nemesis import trace_json
from tests.torch_helpers import run_chaos
from tests.torch_port_modules import admit

pytestmark = pytest.mark.slow

admit(__name__)

# Deterministic default sweep; override for a broader hunt:
#   CHAOS_SOAK_SEEDS="100:140" pytest tests/test_torch_chaos_soak.py -m slow
_spec = os.environ.get("CHAOS_SOAK_SEEDS", "0:8")
_lo, _hi = (int(x) for x in _spec.split(":"))
SOAK_SEEDS = range(_lo, _hi)


@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_randomized_soak_seed(seed):
    verdict = run_chaos(
        seed=seed,
        n_brokers=5,
        partitions=3,
        phases=4,
        phase_s=0.8,
        ops_per_phase=3,
        converge_timeout_s=60.0,
    )
    assert verdict["violations"] == [], (
        f"seed {seed}: {verdict['violations']}\n"
        f"replay: python -m ripplemq_tpu_torch.profiles.chaos_soak "
        f"--device cpu --seed {seed} "
        f"--brokers 5 --partitions 3 --phases 4 --ops-per-phase 3\n"
        f"trace: {trace_json(verdict['trace'])}"
    )
    assert verdict["converged"], (
        f"seed {seed} unconverged: {verdict['convergence']}\n"
        f"trace: {trace_json(verdict['trace'])}"
    )


# Rebalance-storm soak: network faults AND group ops drawn from one
# seeded pool, a 3-member group polling throughout. The group
# invariants (no same-generation dual ownership, acked commits survive
# rebalance, stale commits fenced, bounded post-storm convergence) ride
# in run_chaos's verdict; widen with CHAOS_SOAK_SEEDS as above.
@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_randomized_group_storm_seed(seed):
    verdict = run_chaos(
        seed=seed,
        n_brokers=3,
        partitions=3,
        phases=3,
        phase_s=0.8,
        ops_per_phase=3,
        groups=3,
        converge_timeout_s=60.0,
    )
    assert verdict["violations"] == [], (
        f"seed {seed}: {verdict['violations']}\n"
        f"replay: python -m ripplemq_tpu_torch.profiles.chaos_soak "
        f"--device cpu --seed {seed} "
        f"--partitions 3 --phases 3 --ops-per-phase 3 --groups 3\n"
        f"trace: {trace_json(verdict['trace'])}"
    )
    assert verdict["converged"] and verdict["group"]["converged"], (
        f"seed {seed} unconverged: {verdict['convergence']} / "
        f"{verdict['group']}\ntrace: {trace_json(verdict['trace'])}"
    )


# Striped-replication soak: the same randomized pool plus
# the STRIPE-HOLDER ops (stripe_kill / stripe_partition, sized to m),
# on a cluster wide enough for a 3-deep standby set. The checker holds
# every run to the k-of-k+m loss contract; the fixed-schedule tier-1
# gate lives in test_torch_chaos.py::test_striped_chaos_smoke.
@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_randomized_striped_soak_seed(seed):
    verdict = run_chaos(
        seed=seed,
        n_brokers=5,
        partitions=3,
        phases=3,
        phase_s=0.8,
        ops_per_phase=3,
        replication_mode="striped",
        converge_timeout_s=60.0,
    )
    assert verdict["violations"] == [], (
        f"seed {seed}: {verdict['violations']}\n"
        f"replay: python -m ripplemq_tpu_torch.profiles.chaos_soak "
        f"--device cpu --seed {seed} "
        f"--brokers 5 --partitions 3 --phases 3 --ops-per-phase 3 "
        f"--replication striped\n"
        f"trace: {trace_json(verdict['trace'])}"
    )
    assert verdict["converged"], (
        f"seed {seed} unconverged: {verdict['convergence']}\n"
        f"trace: {trace_json(verdict['trace'])}"
    )

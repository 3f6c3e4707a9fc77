"""Admission of the PyTorch port's test modules to the tier-1 audit.

The reference's `markers` lint rule (`ripplemq_tpu/analysis/markers.py`)
flags every `tests/test_*` module that is neither slow-marked nor listed
in its FAST_MODULES set. The port's tests are fast CPU parity suites
that belong in tier-1, and the JAX package is not edited for them; so
each `tests/test_torch_*.py` calls `admit(__name__)` at import, which
adds THIS list to the rule's set in place. Pytest imports every test
module during collection, in each xdist worker too, before any test
runs — so the audit tests see the port's modules as admitted, and the
admission is still reviewed in one list (kept equal to the files on
disk by tests/test_torch_port_hygiene.py).

This module is not collected (its name does not start with `test_`).
"""

from __future__ import annotations

from ripplemq_tpu.analysis import markers

PORT_TEST_MODULES = (
    "test_torch_append",
    "test_torch_broker",
    "test_torch_chain_settle",
    "test_torch_chaos",
    "test_torch_client",
    "test_torch_controller_failover",
    "test_torch_dataplane",
    "test_torch_dataplane_parity",
    "test_torch_degradation",
    "test_torch_engine",
    "test_torch_failover",
    "test_torch_follower_reads",
    "test_torch_group_cluster",
    "test_torch_group_waves",
    "test_torch_groups",
    "test_torch_hostplane",
    "test_torch_hostplane_chaos",
    "test_torch_hostraft",
    "test_torch_idempotence",
    "test_torch_lockstep",
    "test_torch_manager",
    "test_torch_metadata",
    "test_torch_multichip_smoke",
    "test_torch_obs",
    "test_torch_planes_parity",
    "test_torch_port_hygiene",
    "test_torch_proc_chaos",
    "test_torch_process_cluster",
    "test_torch_read_cache",
    "test_torch_repl_pipeline",
    "test_torch_replication",
    "test_torch_retention",
    "test_torch_retry_policy",
    "test_torch_rs",
    "test_torch_server_parity",
    "test_torch_settled_gap",
    "test_torch_shmring",
    "test_torch_slo",
    "test_torch_slo_chaos",
    "test_torch_spans",
    "test_torch_split",
    "test_torch_split_chaos",
    "test_torch_spmd",
    "test_torch_spmd_parity",
    "test_torch_step",
    "test_torch_storage",
    "test_torch_stripes",
    "test_torch_stripes_cluster",
    "test_torch_term_skew",
    "test_torch_wire",
)


# The port's slow-marked twins of slow reference modules: the audit
# accepts them through their `slow` mark, so they stay out of the
# allowlist (a module both allowlisted and slow-marked is refused).
SLOW_PORT_MODULES = (
    "test_torch_lockstep_drill",
    "test_torch_multihost",
)


def admit(name: str) -> None:
    """Admit the port's test modules; `name` is the caller's module name."""
    name = name.rsplit(".", 1)[-1]
    assert name in PORT_TEST_MODULES + SLOW_PORT_MODULES, (
        f"{name} is not listed in tests/torch_port_modules.py")
    markers.FAST_MODULES.update(PORT_TEST_MODULES)

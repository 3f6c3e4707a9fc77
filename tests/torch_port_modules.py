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
    "test_torch_chain_settle",
    "test_torch_dataplane",
    "test_torch_dataplane_parity",
    "test_torch_engine",
    "test_torch_groups",
    "test_torch_hostraft",
    "test_torch_manager",
    "test_torch_metadata",
    "test_torch_obs",
    "test_torch_port_hygiene",
    "test_torch_read_cache",
    "test_torch_replication",
    "test_torch_retention",
    "test_torch_rs",
    "test_torch_step",
    "test_torch_storage",
    "test_torch_stripes",
    "test_torch_wire",
)


def admit(name: str) -> None:
    """Admit the port's test modules; `name` is the caller's module name."""
    name = name.rsplit(".", 1)[-1]
    assert name in PORT_TEST_MODULES, (
        f"{name} is not listed in tests/torch_port_modules.py")
    markers.FAST_MODULES.update(PORT_TEST_MODULES)

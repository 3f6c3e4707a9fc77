"""Admission of the PyTorch port's test modules to the tier-1 audit.

The reference's `markers` lint rule (`ripplemq_tpu/analysis/markers.py`)
flags every `tests/test_*` module that is neither slow-marked nor listed
in its FAST_MODULES set. The port's tests are fast CPU parity suites
that belong in tier-1, and the JAX package is not edited for them; so
each `tests/test_torch_*.py` calls `admit(__name__)` at import, which
adds THIS list to the rule's set in place. Pytest imports every test
module during collection, in each xdist worker too, before any test
runs — so the audit tests see the port's modules as admitted, and the
admission is still reviewed in one list: the port's own `markers` rule
(`ripplemq_tpu_torch/analysis/markers.py`), whose FAST_MODULES and
PINNED_SLOW this module re-exports (kept equal to the files on disk by
tests/test_torch_port_hygiene.py and by the port's lint).

This module is not collected (its name does not start with `test_`).
"""

from __future__ import annotations

from ripplemq_tpu.analysis import markers
from ripplemq_tpu_torch.analysis import markers as port_markers

# The port's reviewed lists live in its own lint rule
# (`ripplemq_tpu_torch/analysis/markers.py`), which audits exactly the
# `tests/test_torch_*.py` modules; this helper only carries them into
# the reference's rule.
PORT_TEST_MODULES = port_markers.FAST_MODULES

# The port's slow-marked twins of slow reference modules: the audit
# accepts them through their `slow` mark, so they stay out of the
# allowlist (a module both allowlisted and slow-marked is refused).
SLOW_PORT_MODULES = port_markers.PINNED_SLOW


def admit(name: str) -> None:
    """Admit the port's test modules; `name` is the caller's module name."""
    name = name.rsplit(".", 1)[-1]
    assert name in PORT_TEST_MODULES + SLOW_PORT_MODULES, (
        f"{name} is not listed in ripplemq_tpu_torch/analysis/markers.py")
    markers.FAST_MODULES.update(PORT_TEST_MODULES)

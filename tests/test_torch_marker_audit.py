"""The port's tier-1 runtime-budget audit — twin of
`tests/test_marker_audit.py`, a thin wrapper over the port's ripplelint.

The slow-marker contract for the port's test modules (every
`tests/test_torch_*.py` either slow-marked or consciously admitted to
the tier-1 budget; no stale or double-marked allowlist entries; the
slow twins keep their marks) is the port's `markers` rule
(`ripplemq_tpu_torch/analysis/markers.py` — FAST_MODULES and
PINNED_SLOW live there, so the lint CLI, this audit and
`tests/torch_port_modules.py` can never disagree). This module keeps the
reference's test names as a direct, fast tier-1 surface: a
marker-contract violation fails here with the checker's own message,
same as it fails `python -m ripplemq_tpu_torch.analysis` and
`tests/test_torch_lint.py::test_tree_is_clean`.
"""

from __future__ import annotations

from ripplemq_tpu_torch.analysis import Repo, markers
from tests.torch_port_modules import admit

admit(__name__)

def _findings(prefixes: tuple[str, ...]) -> list[str]:
    found = markers.check(Repo())
    return [f"{f.key}: {f.message}" for f in found
            if f.key.startswith(prefixes)]


def test_every_module_fast_or_slow_marked():
    assert not _findings(("unvetted::",))


def test_allowlist_entries_exist_and_are_not_slow():
    assert not _findings(("stale::", "double::"))


def test_known_soaks_stay_slow_marked():
    """The port's slow twins of the soaks and drills must keep their
    marks (deleting a mark puts them in tier-1's budget)."""
    assert not _findings(("pinned::", "pinned-gone::"))

"""Randomized telemetry-plane soak (slow; audit-pinned out of tier-1).

The tier-1 suite proves the obs surfaces on fixed seeds; this soak
hammers them where they earn their keep — under randomized chaos — and
holds the collection path itself to a contract: postmortem bundles must
collect from whatever brokers survived the schedule, the merged
fault-vs-lifecycle timeline must interleave nemesis ops with broker
flight-recorder events in wall-clock order, and the run must stay SAFE
with full telemetry enabled (the plane must never perturb correctness).

`OBS_SOAK_SEEDS=lo:hi` widens the hunt, as with the chaos soaks.

Twin of `tests/test_obs_soak.py` on the PyTorch port (CPU brokers),
slow-marked as the reference is.
"""

from __future__ import annotations

import os
import random

import pytest

from tests.torch_port_modules import admit

pytestmark = pytest.mark.slow

admit(__name__)


def _seeds():
    """The seeds of `OBS_SOAK_SEEDS`, else one drawn inside the test
    (None here), so every xdist worker collects the same test ids."""
    spec = os.environ.get("OBS_SOAK_SEEDS")
    if spec:
        lo, _, hi = spec.partition(":")
        return list(range(int(lo), int(hi)))
    return [None]


@pytest.mark.parametrize("seed", _seeds())
def test_obs_under_randomized_chaos(seed):
    from tests.torch_helpers import run_chaos

    if seed is None:
        seed = random.randrange(1 << 16)
        print(f"obs soak seed {seed} (OBS_SOAK_SEEDS={seed}:{seed + 1} "
              f"replays it)")

    verdict = run_chaos(seed=seed, phases=3, phase_s=0.6,
                        converge_timeout_s=120.0,
                        include_postmortems=True, include_timeline=True)
    assert verdict["violations"] == [], (
        f"seed {seed}: telemetry run went unsafe: {verdict['violations']}"
    )
    # Bundles from every reachable broker (all restarted at heal).
    assert len(verdict["postmortems"]) >= 2, verdict["postmortems"].keys()
    for bid, pm in verdict["postmortems"].items():
        assert pm["ok"] and pm["broker"] == int(bid)
        assert pm["metrics"]["enabled"]
        assert isinstance(pm["trace"], list)
    engines = [pm["engine"] for pm in verdict["postmortems"].values()
               if pm["engine"] is not None]
    assert engines, "no surviving controller reported an engine section"
    for eng in engines:
        # The bundle's invariants hold under faults: settled never ahead
        # of the host log end, skew list consistent with its tables.
        for s in range(eng["partitions"]):
            assert eng["settled_end"][s] <= eng["host_log_end"][s]
            skewed = eng["device_current_terms"][s] > eng["ctrl_table"]["term"][s]
            assert (s in eng["term_skew_slots"]) == skewed
    # Merged timeline: both sources present, ordered by wall clock.
    tl = verdict["timeline"]
    assert any(e["src"] == "nemesis" for e in tl)
    assert any(str(e["src"]).startswith("broker") for e in tl)
    assert [e["t"] for e in tl] == sorted(e["t"] for e in tl)
    # Fault ops that were applied appear in the timeline (crash/restart
    # pairs for every crashed broker, one heal per phase).
    heals = [e for e in tl if e["src"] == "nemesis" and e["type"] == "heal"]
    assert len(heals) == 3

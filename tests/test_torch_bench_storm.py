"""The port bench's control-plane storm and its CLI modes against the
reference's (`bench.py` at the repository root), on the CPU:

- `_run_control_plane_storm` at the reference's shapes ((10, 10, 4),
  (40, 10, 8), (100, 10, 16): 1000 members in 100 groups) in both
  packages: the same keys arm by arm, the same membership event counts
  (the churn sampled from `random.Random(1234)` in both), the direct
  baseline at one proposal an event and no error;
- `_cp_stats` sums the reference's way on generated admin.stats replies
  (missing blocks and keys, histograms, unreachable brokers);
- the CLI's `consume_fanout`, `split_rebalance` and `control_plane_storm`
  modes print the reference's JSON shapes.
"""

from __future__ import annotations

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import bench as ref
from ripplemq_tpu_torch import bench
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture(scope="module")
def storms():
    """Both packages' storms at the reference's default shapes, once."""
    return (bench._run_control_plane_storm(device="cpu"),
            ref._run_control_plane_storm())


def _arms(out):
    s = out["control_plane_storm"]
    return [s["direct_baseline"]] + s["shapes"]


def test_storm_has_the_reference_layout_and_keys(storms):
    got, want = storms
    assert list(got) == list(want) == ["control_plane_storm"]
    assert list(got["control_plane_storm"]) == list(
        want["control_plane_storm"])
    for g, w in zip(_arms(got), _arms(want)):
        assert list(g) == list(w)
    assert got["control_plane_storm"]["headline"] == \
        got["control_plane_storm"]["shapes"][-1]


def test_storm_membership_events_equal_the_reference(storms):
    got, want = storms
    events = [a["membership_events"] for a in _arms(got)]
    assert events == [a["membership_events"] for a in _arms(want)]
    # joins + registrations + 2 churn rounds of 20% leaving and rejoining
    assert events == [184, 184, 728, 1816]
    assert [(a["groups"], a["members"], a["tenants"]) for a in _arms(got)] \
        == [(10, 100, 4), (10, 100, 4), (40, 400, 8), (100, 1000, 16)]


def test_storm_direct_baseline_is_one_proposal_an_event(storms):
    got, _ = storms
    direct = got["control_plane_storm"]["direct_baseline"]
    assert direct["proposals_per_event"] == 1.0
    assert direct["raft_proposals"] == direct["membership_events"]
    assert direct["errors"] == 0


def test_storm_waves_coalesce_and_nothing_errs(storms):
    got, _ = storms
    for arm in got["control_plane_storm"]["shapes"]:
        assert arm["errors"] == 0
        assert 0 < arm["raft_proposals"] < arm["membership_events"]
        assert sum(arm["wave_size_hist"].values()) >= 1
        assert arm["convergence_ms_p50"] <= arm["convergence_ms_p99"]
        assert arm["leader_heartbeat_rpcs_per_s_before"] > 0


_CP_KEYS = ("waves", "wave_events", "beats_relayed", "beat_frames",
            "heartbeats_local")
_block = st.one_of(
    st.none(),
    st.fixed_dictionaries({}, optional={
        **{k: st.integers(0, 10**6) for k in _CP_KEYS},
        "wave_size_hist": st.one_of(st.none(), st.dictionaries(
            st.sampled_from(["1", "2", "4", "16", "64"]),
            st.integers(0, 1000), max_size=5)),
    }))
_reply = st.one_of(st.just("unreachable"), st.just({}),
                   st.builds(lambda b: {"control_plane": b}, _block))


class _Cluster:
    """A cluster whose brokers answer admin.stats with `replies` (one a
    broker; "unreachable" raises, as a dead broker's call does)."""

    def __init__(self, replies):
        self.replies = replies

    def client(self, name):
        return self

    def call(self, addr, req, timeout=None):
        assert req == {"type": "admin.stats"}
        reply = self.replies[int(addr)]
        if reply == "unreachable":
            raise ConnectionError(addr)
        return reply


@settings(max_examples=200, deadline=None)
@given(replies=st.lists(_reply, min_size=1, max_size=4))
def test_cp_stats_sums_the_reference_way(replies):
    addrs = [str(i) for i in range(len(replies))]
    got = bench._cp_stats(_Cluster(replies), addrs)
    assert got == ref._cp_stats(_Cluster(replies), addrs)
    assert list(got) == list(ref._cp_stats(_Cluster(replies), addrs))


@pytest.mark.parametrize("mode,runner,wrap", [
    # bench.py's __main__: {"consume_fanout": _run_consume_fanout()},
    # {"split_rebalance": _run_split_rebalance()}, _run_control_plane_storm()
    ("consume_fanout", "_run_consume_fanout", "consume_fanout"),
    ("split_rebalance", "_run_split_rebalance", "split_rebalance"),
    ("control_plane_storm", "_run_control_plane_storm", None),
])
def test_cli_modes_print_the_reference_json(monkeypatch, capsys, mode,
                                            runner, wrap):
    seen = []
    result = ({"control_plane_storm": {"shapes": []}} if wrap is None
              else {"arms": [], "mode": mode})
    monkeypatch.setattr(bench, runner,
                        lambda **kw: seen.append(kw) or result)
    bench._cli([mode, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out == (result if wrap is None else {wrap: result})
    assert seen == [{"device": "cpu"}]

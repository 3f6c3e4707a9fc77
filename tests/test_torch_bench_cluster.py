"""The port bench's in-process cluster runners against the reference's
(`bench.py` at the repository root), on the CPU:

- `_run_repl_bytes`: the same 5-broker clusters in both packages give the
  same byte counts exactly (full 659200 B, striped 286364 B, 128000 acked
  bytes, 40 stripe groups, `striped_vs_full` 0.434, the figures of the
  reference's recorded BENCH_r06.json);
- `_run_group_consume`: the reference's keys, count-exact per group, and
  every member joined before the first poll (the port's divergence);
- `_run_slo_convergence`: the reference's keys, the final knobs inside
  the SLO controller's bounds for the runner's config;
- `_run_split_rebalance`: the reference's keys, every acked produce read
  back after the online split.

Every cluster runs on `device="cpu"`; without it each runner raises on a
host without CUDA.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

import bench as ref
from ripplemq_tpu_torch import bench
from tests.torch_helpers import dict_keys, ref_return_keys
from tests.torch_port_modules import admit

admit(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_repl_bytes_equal_the_reference_exactly():
    got = bench._run_repl_bytes(device="cpu")
    want = ref._run_repl_bytes()
    assert got == want  # every count, exact
    recorded = ref._load_baseline(os.path.join(REPO, "BENCH_r06.json"))
    assert got == recorded["repl_bytes_per_acked_byte"]
    assert got["full"]["repl_bytes"] == 659200
    assert got["striped"]["repl_bytes"] == 286364
    assert got["striped"]["stripe_groups"] == 40
    assert got["striped_vs_full"] == 0.434


def test_group_consume_is_count_exact_with_the_reference_keys():
    got = bench._run_group_consume(device="cpu")
    assert dict_keys(got) == ref_return_keys("_run_group_consume")
    g = got["group_consume"]
    assert g["count_exact"] is True and g["msgs_per_group"] == 600
    assert (g["groups"], g["members_per_group"], g["partitions"]) == (3, 2, 4)
    assert got["e2e_group_consume_msgs_per_sec"] > 0


def test_group_consume_settles_the_generation_before_any_poll(monkeypatch):
    """The port's deliberate divergence: every member joins before any
    member polls. The reference's members poll while their peers still
    join, and a commit a join-time rebalance overtakes lands but is
    answered fenced, so its batch is never delivered and the drain ends
    one batch short (3 of 12 reference runs on a CPU host)."""
    from ripplemq_tpu_torch.groups import client as gcm

    events = []
    join, poll = gcm.GroupConsumer.join, gcm.GroupConsumer.poll

    def rec_join(self):
        if self.member_id == "m2" and self.generation < 0:
            time.sleep(0.3)  # a late joiner: its peers could poll first
        events.append(("join", self.group, self.member_id))
        return join(self)

    def rec_poll(self, max_messages=None):
        events.append(("poll", self.group, self.member_id))
        return poll(self, max_messages)

    monkeypatch.setattr(gcm.GroupConsumer, "join", rec_join)
    monkeypatch.setattr(gcm.GroupConsumer, "poll", rec_poll)
    got = bench._run_group_consume(n_groups=2, members=3, device="cpu")
    assert got["group_consume"]["count_exact"] is True
    first = next(i for i, e in enumerate(events) if e[0] == "poll")
    assert sorted(e[1:] for e in events[:first]) == sorted(
        (f"bg{g}", f"m{m}") for g in range(2) for m in range(3))


def test_slo_convergence_keeps_its_knobs_inside_the_controller_bounds():
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from ripplemq_tpu_torch.metadata.models import Topic

    # Durations cut (1.5 s light, 10 s step in the bench); the runner's
    # keys and its controller's bounds do not depend on them.
    got = bench._run_slo_convergence(light_s=0.5, heavy_s=2.0, device="cpu")
    assert list(got) == list(ref_return_keys("_run_slo_convergence"))
    assert got["target_p99_ms"] == 25.0
    # The bounds of the config the runner builds (its arguments, the
    # reference's).
    cfg = make_cluster_config(
        1, topics=(Topic("slobench", 1, 1),), standby_count=0,
        slo_p99_ack_ms=25.0, slo_tick_s=0.1, slo_chain_depth_max=4)
    k = got["final_knobs"]
    assert (cfg.slo_read_coalesce_min_s <= k["read_coalesce_s"]
            <= cfg.slo_read_coalesce_max_s)
    assert cfg.slo_chain_depth_min <= k["chain_depth"] <= 4
    assert cfg.slo_settle_window_min <= k["settle_window"] \
        <= k["settle_window_cap"]
    assert isinstance(got["adjustments"], int) and got["adjustments"] >= 0
    if got["time_to_slo_s"] is not None:
        assert got["breached_after_step"] and got["time_to_slo_s"] > 0


def test_split_rebalance_reads_back_every_acked_produce():
    got = bench._run_split_rebalance(device="cpu")
    assert list(got) == list(ref_return_keys("_run_split_rebalance"))
    assert got["split_ok"] is True
    assert got["acked"] > 0 and got["readback"] == got["acked"]
    assert got["time_to_rebalance_s"] is not None
    json.dumps(got)  # the artifact's JSON


@pytest.mark.parametrize("runner", [
    "_run_repl_bytes", "_run_group_consume", "_run_slo_convergence",
    "_run_split_rebalance", "_run_control_plane_storm",
    "_run_consume_fanout", "_run_host_plane_scaling", "_run_spmd_parity",
    "_run_spmd_scaling"])
def test_runner_raises_without_a_gpu_unless_given_a_device(monkeypatch,
                                                           runner):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        getattr(bench, runner)()

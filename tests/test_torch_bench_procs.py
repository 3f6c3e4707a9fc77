"""The port bench's multi-process runners against the reference's
(`bench.py` at the repository root), on the CPU:

- `_run_consume_fanout`: a fresh 3-broker process cluster an arm
  (`python -m ripplemq_tpu_torch.broker --device cpu`), follower reads
  off and on, 4 consumers (the bench also runs 16) over the reference's
  480 messages: the reference's keys, count-exact, the followers serving
  in the ON arm;
- `_run_host_plane_scaling`: host workers 1 and 2 through the port's
  `_run_e2e` at 8 partitions (the bench runs 1024 and workers 1, 2, 4):
  the reference's keys, every arm count-exact, `scaling_x` by the
  reference's formula.
"""

from __future__ import annotations

from ripplemq_tpu_torch import bench
from tests.torch_helpers import ref_return_keys
from tests.torch_port_modules import admit

admit(__name__)


def test_consume_fanout_is_count_exact_and_followers_serve():
    got = bench._run_consume_fanout(consumer_counts=(4,), device="cpu")
    assert list(got) == list(ref_return_keys("_run_consume_fanout"))
    arm_keys = list(ref_return_keys("_run_consume_fanout.one_arm"))
    assert [list(a) for a in got["arms"]] == [arm_keys] * 2
    off, on = got["arms"]
    assert (off["follower_reads"], on["follower_reads"]) == (False, True)
    assert off["count_exact"] and on["count_exact"]
    assert got["msgs_per_consumer"] == 480 and got["partitions"] == 2
    assert off["follower_served"] == 0
    assert on["follower_served"] > 0
    assert got["speedup_on_vs_off"] == {
        "4": round(on["msgs_per_sec"] / off["msgs_per_sec"], 2)}


def test_host_plane_scaling_is_count_exact_in_every_arm():
    got = bench._run_host_plane_scaling(
        worker_counts=(1, 2), duration_s=0.5, phases=1, device="cpu",
        partitions=8, threads=2, client_procs=1, window=4, batch=64)
    assert list(got) == list(ref_return_keys("_run_host_plane_scaling"))
    assert [a["host_workers"] for a in got["arms"]] == [1, 2]
    for arm in got["arms"]:
        assert list(arm) == ["host_workers", "appends_per_sec",
                             "consume_msgs_per_sec", "acked", "readback",
                             "cpu_decomposition"]
        assert arm["readback"] == "count-exact" and arm["acked"] > 0
    base = got["arms"][0]["appends_per_sec"]
    best = max(got["arms"], key=lambda a: a["appends_per_sec"])
    assert got["baseline_appends_per_sec"] == base
    assert got["best_workers"] == best["host_workers"]
    assert got["scaling_x"] == round(best["appends_per_sec"] / base, 2)
    # the second arm's controller ran its workers as processes
    assert got["arms"][1]["cpu_decomposition"]["controller_workers_s"] >= 0

"""Multichip smoke on the port: twin of `tests/test_multichip_smoke.py`.

One fused-spmd step + read on the production mesh for 8 cells, in the
default test selection. The reference's mesh spans 8 virtual XLA
devices of one process; the port's spans 8 gloo ranks on the CPU
(`tests/torch_spmd_world.py`, one world for the module), so the ballot's
and the leader broadcast's `all_reduce`s cross process boundaries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ripplemq_tpu_torch.parallel.mesh import pick_axes
from tests.helpers import decode_read, make_input, small_cfg
from tests.torch_port_modules import admit
from tests.torch_spmd_world import run_world

admit(__name__)


def _stack(inp, k):
    return tuple(None if x is None else
                 np.broadcast_to(np.asarray(x), (k,) + np.asarray(x).shape).copy()
                 for x in inp)


def _smoke_job():
    replicas, part_shards = pick_axes(8)
    assert (replicas, part_shards) == (2, 4)
    cfg = small_cfg(replicas=replicas, partitions=8, fused_control=True,
                    packed_writes=True)
    alive = np.ones((replicas,), bool)
    calls = [
        ("step", [tuple(make_input(cfg, appends={0: [b"m0-a", b"m0-b"], 7: [b"m7"]},
                                   offset_updates={0: [(1, 2)]})),
                  alive, None, None]),
        ("read", [0, 0, 0]),
        ("read", [replicas - 1, 7, 0]),
        ("read_offset", [0, 0, 1]),
        ("step_many", [_stack(make_input(cfg, appends={p: [b"c"] for p in range(8)}), 2),
                       alive, None, None]),
        ("vote", [np.ones((8,), np.int32), np.full((8,), 3, np.int32), alive,
                  None]),
    ]
    return dict(mesh=(replicas, part_shards), cfg=dataclasses.asdict(cfg),
                calls=calls)


def _quorum_job():
    cfg = small_cfg(replicas=2, partitions=8, fused_control=True)
    calls = [
        ("step", [tuple(make_input(cfg, appends={3: [b"lost"]})),
                  np.array([True, False]), None, None]),
        ("read", [0, 3, 0]),
        ("step", [tuple(make_input(cfg, appends={3: [b"lost"]})),
                  np.ones(2, bool), None, None]),
        ("read", [1, 3, 0]),
    ]
    return dict(mesh=(2, 4), cfg=dataclasses.asdict(cfg), calls=calls)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(8, [_smoke_job(), _quorum_job()],
                     tmp_path_factory.mktemp("multichip"))


def test_fused_spmd_step_and_read_on_8_device_mesh(world):
    """One committed fused-spmd round + cross-shard reads + a chained
    launch + an election, on the production mesh shape for 8 cells
    (pick_axes: 2 replicas x 4 partition shards), with the production
    levers on (fused_control + packed_writes)."""
    step, read0, read7, off, chain, (elected, votes) = world[0]["outs"]
    assert step.committed[0] and step.committed[7]
    # partition 0 lives on the first part shard, partition 7 on the last
    assert decode_read(*read0) == [b"m0-a", b"m0-b"]
    assert decode_read(*read7) == [b"m7"]
    assert int(off) == 2
    assert chain.committed.all()
    assert elected.all()
    assert (votes == 2).all()
    assert world[0]["stats"]["all_reduce_sum_replica"] > 0


def test_fused_spmd_quorum_failure_leaves_no_trace_across_shards(world):
    """Atomicity under the sharded fused binding: a round refused for
    quorum leaves no trace on ANY shard; the retry commits once quorum
    returns."""
    failed, read_failed, retry, read_retry = world[1]["outs"]
    assert not failed.committed[3]
    assert decode_read(*read_failed) == []
    assert retry.committed[3]
    assert decode_read(*read_retry) == [b"lost"]

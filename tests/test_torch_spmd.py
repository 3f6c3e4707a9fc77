"""The port's spmd binding against its local binding: twins of
`tests/test_spmd.py`, of `test_chain.py::test_step_many_equals_sequential_steps_spmd`
and of `test_retention.py::test_spmd_ring_wrap_matches_local`.

The reference runs shard_map on 8 virtual CPU devices of one process;
the port's mesh is one process per cell, so every scenario here is a
call stream replayed by a gloo world of 8 CPU processes
(`tests/torch_spmd_world.py`, started once for the module), on every
mesh the reference tests, and by `make_local_fns(cfg, device="cpu")` in
this process. Outputs and the whole final state (gathered from every
cell with `convert.gather_state`) must be equal: all values are
integers, so the tolerance is exact equality.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import pytest

from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.core.state import FusedReplicaState, unfuse_state
from ripplemq_tpu_torch.parallel.engine import make_local_fns
from ripplemq_tpu_torch.parallel.mesh import pick_axes
from tests.helpers import decode_read, make_input, small_cfg
from tests.torch_port_modules import admit
from tests.torch_spmd_world import _numpy, _replay, run_world

admit(__name__)

WORLD = 8


def _scenario(cfg):
    """A few rounds exercising commits, minorities, offsets, multi-leader."""
    R = cfg.replicas
    alive_all = np.ones((R,), bool)
    alive_partial = alive_all.copy()
    alive_partial[-1] = False
    return [
        (make_input(cfg, appends={0: [b"r0-a", b"r0-b"], 3: [b"p3"]}), alive_all),
        (make_input(cfg, appends={1: [b"x"]}, leader={1: R - 1, 0: 0}), alive_all),
        (make_input(cfg, appends={0: [b"c"]}, offset_updates={0: [(2, 2)]}), alive_partial),
        (make_input(cfg, appends={2: [b"only-leader"]}), alive_partial),
    ]


def _step(inp, alive, quorum=None, trim=None):
    return ("step", [tuple(inp), alive, quorum, trim])


def _stack(inputs):
    return tuple(np.stack([np.asarray(getattr(i, f)) for i in inputs])
                 for f in inputs[0]._fields)


def _matrix_calls(cfg):
    calls = [_step(inp, alive) for inp, alive in _scenario(cfg)]
    calls += [("read", [0, part, 0]) for part in (0, 7)]
    calls.append(("read_offset", [0, 0, 2]))
    return calls


def _vote_resync_calls(cfg):
    two = np.ones(2, bool)
    cand = np.full((8,), -1, np.int32)
    cand[5] = 1
    mask = np.zeros((8,), bool)
    mask[0] = True
    return [
        _step(make_input(cfg, appends={0: [b"a"]}), np.array([True, False])),
        ("read", [0, 0, 0]),
        _step(make_input(cfg, appends={0: [b"a"], 5: [b"b"]}), two),
        ("vote", [cand, np.full((8,), 3, np.int32), two, None]),
        ("resync", [np.int32(0), np.int32(1), mask]),
        _step(make_input(cfg, appends={0: [b"c"]}), two),
        ("read", [1, 0, 0]),
        ("read", [1, 0, 8]),  # rounds are ALIGN-padded: "c" is at 8
    ]


def _range_calls(cfg):
    return ([_step(make_input(cfg, appends={0: [b"a"]}), np.ones(2, bool))]
            + [("read", [rep, part, 0])
               for rep, part in [(99, 0), (0, 99), (-1, 0)]])


def _fused_matrix_calls(cfg):
    """The reference's fused parity matrix as one call stream: empty,
    partial + offsets + leaderless, quorum failure, retry, a chain of 3,
    a vote, a resync, a fill to capacity, its refusal, a wrap behind
    trim and reads of the wrapped state."""
    R = cfg.replicas
    alive_all = np.ones((R,), bool)
    minority = np.zeros((R,), bool)
    minority[0] = True
    majority = alive_all.copy()
    majority[-1] = False
    calls = [
        _step(make_input(cfg), alive_all),
        _step(make_input(cfg, appends={0: [b"a", b"b"], 7: [b"z"]},
                         offset_updates={1: [(2, 5)]}), alive_all),
        _step(make_input(cfg, appends={0: [b"minority"]}), minority),
        _step(make_input(cfg, appends={0: [b"retry"]}), majority),
        ("step_many", [_stack([make_input(cfg, appends={p: [b"c"] for p in range(8)})] * 3),
                       alive_all, None, None]),
    ]
    cand = np.full((8,), -1, np.int32)
    cand[5] = 0
    calls.append(("vote", [cand, np.full((8,), 4, np.int32), alive_all, None]))
    mask = np.zeros((8,), bool)
    mask[0] = mask[3] = True
    calls.append(("resync", [np.int32(0), np.int32(R - 1), mask]))
    calls.append(_step(make_input(cfg, appends={0: [b"post-resync"]}, term=4),
                       alive_all))
    # Fill partition 0 to capacity from its log end (which depends on
    # whether the majority round committed at this R).
    job = _job(cfg, None, calls)
    end = int(_local(job)[1]["log_end"][0, 0])
    fill = [b"f"] * cfg.max_batch
    for _ in range((cfg.slots - end) // cfg.max_batch):
        calls.append(_step(make_input(cfg, appends={0: fill}, term=4), alive_all))
    calls.append(_step(make_input(cfg, appends={0: [b"full"]}, term=4), alive_all))
    trim = np.full((8,), cfg.max_batch, np.int32)
    calls.append(_step(make_input(cfg, appends={0: [b"wrap"]}, term=4),
                       alive_all, None, trim))
    calls += [("read", [0, part, cfg.max_batch if part == 0 else 0])
              for part in (0, 7)]
    return calls


def _chain_calls(cfg):
    inputs = [make_input(cfg, appends={k % 4: [b"c%d" % k]}) for k in range(4)]
    return [("step_many", [_stack(inputs), np.ones((2,), bool), None, None])]


def _wrap_calls(cfg):
    calls = []
    trim = np.zeros((4,), np.int32)
    for lap in range(5):  # 40 rows through a 16-slot ring
        inp = make_input(cfg, appends={0: [b"s%02d" % (8 * lap + j)
                                           for j in range(8)]})
        trim[0] = max(0, 8 * lap + 8 + 8 - 16)
        calls.append(_step(inp, np.ones((2,), bool), None, trim.copy()))
    calls.append(("read", [0, 0, 32]))
    return calls


def _stride_cfg(partitions):
    return dict(partitions=partitions, replicas=1, slots=8192,
                slot_bytes=128, max_batch=256, read_batch=32)


def _job(cfg, mesh, calls, **kw):
    return dict(mesh=mesh, cfg=dataclasses.asdict(cfg), calls=calls, **kw)


def _random_state(cfg, seed):
    """A seeded whole [R, P, ...] state (named layout, numpy)."""
    rng = np.random.default_rng(seed)
    R, P = cfg.replicas, cfg.partitions
    ints = lambda *s: rng.integers(0, 1000, size=(R, P) + s, dtype=np.int32)
    return dict(
        log_data=rng.integers(0, 256, size=(R, P, cfg.slots + cfg.max_batch,
                                            cfg.slot_bytes), dtype=np.uint8),
        log_end=ints(), last_term=ints(), current_term=ints(), commit=ints(),
        offsets=ints(cfg.max_consumers))


MATRIX = [(2, 4), (4, 2), (2, 1), (8, 1)]
FUSED = [(2, 4), (4, 2), (2, 1)]


@functools.lru_cache(maxsize=None)
def _jobs():
    jobs = {}
    for R, S in MATRIX:
        cfg = small_cfg(replicas=R, partitions=8)
        jobs[("matrix", R, S)] = _job(cfg, (R, S), _matrix_calls(cfg))
    cfg = small_cfg(replicas=2, partitions=8)
    jobs["vote_resync"] = _job(cfg, (2, 4), _vote_resync_calls(cfg))
    jobs["range"] = _job(cfg, (2, 4), _range_calls(cfg))
    for R, S in FUSED:
        for flags in ("fused", "legacy"):
            c = small_cfg(replicas=R, partitions=8,
                          fused_control=flags == "fused")
            jobs[("fused_matrix", flags, R, S)] = _job(
                c, (R, S), _fused_matrix_calls(c))
    c = small_cfg(replicas=2, partitions=8, fused_control=True,
                  packed_writes=True)
    jobs["no_fallback"] = _job(c, (2, 4), [
        _step(make_input(c, appends={0: [b"ok"]}), np.ones((2,), bool))])
    c = small_cfg(partitions=4, replicas=2, slots=64)
    jobs["chain"] = _job(c, (2, 2), _chain_calls(c))
    c = small_cfg(partitions=4, replicas=2, slots=16, max_batch=8)
    jobs["wrap"] = _job(c, (2, 2), _wrap_calls(c))
    c = small_cfg(partitions=8, replicas=2, fused_control=True)
    jobs["round_trip"] = _job(c, (2, 4), [], start=_random_state(c, 7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the config's global verdict
        for parts in (512, 256):
            jobs[("stride", parts)] = dict(mesh=(1, 8), cfg=_stride_cfg(parts),
                                           calls=[], init=False)
    return jobs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = _jobs()
    results = run_world(WORLD, list(jobs.values()),
                        tmp_path_factory.mktemp("spmd_world"))
    return dict(zip(jobs, results))


def _port_cfg(job) -> EngineConfig:
    return EngineConfig(**job["cfg"])


def _named(state) -> dict:
    if isinstance(state, FusedReplicaState):
        state = unfuse_state(state)
    return convert.state_to_numpy(state)


def _local(job):
    """The same call stream through the port's local binding."""
    fns = make_local_fns(_port_cfg(job), device="cpu")
    state = fns.init()
    outs = []
    for method, args in job["calls"]:
        state, out = _replay(fns, state, method, args)
        outs.append(_numpy(out))
    return outs, _named(state)


def _assert_equal(a, b, msg=""):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), msg
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{msg}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), msg
        for k in a:
            _assert_equal(a[k], b[k], f"{msg}.{k}")
    elif a is None:
        assert b is None, msg
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=msg)


def _spmd_matches_local(world, key):
    res = world[key]
    outs, state = _local(_jobs()[key])
    _assert_equal(outs, res["outs"], f"{key} outputs")
    _assert_equal(state, res["state"], f"{key} state")
    return res


@pytest.mark.parametrize("replicas,part_shards", MATRIX)
def test_spmd_matches_local(world, replicas, part_shards):
    res = _spmd_matches_local(world, ("matrix", replicas, part_shards))
    # The replica axis really crossed processes where it has > 1 cell.
    if replicas > 1:
        assert res["stats"]["all_reduce_sum_replica"] > 0
    if part_shards > 1:
        assert res["stats"]["all_gather_part"] > 0


def test_spmd_vote_and_resync(world):
    res = _spmd_matches_local(world, "vote_resync")
    outs = res["outs"]
    # replica 1 dead: the round fails atomically, nothing to read.
    assert not outs[0].committed[0]
    assert decode_read(*outs[1]) == []
    assert outs[2].committed[0] and outs[2].committed[5]
    elected, votes = outs[3]
    assert elected[5] and votes[5] == 2
    assert outs[5].committed[0]
    assert decode_read(*outs[6]) + decode_read(*outs[7]) == [b"a", b"c"]


def test_pick_axes():
    assert pick_axes(8, 2) == (2, 4)
    assert pick_axes(8) == (2, 4)
    assert pick_axes(15) == (5, 3)
    assert pick_axes(6, 3) == (3, 2)
    assert pick_axes(7) == (1, 7)  # prime, no preferred factor -> all part
    with pytest.raises(ValueError):
        pick_axes(8, 3)  # never silently weaken a requested RF


def test_spmd_read_out_of_range_matches_local(world):
    _spmd_matches_local(world, "range")


@pytest.mark.parametrize("replicas,part_shards", FUSED)
def test_fused_spmd_parity_matrix(world, replicas, part_shards):
    """fused-spmd vs legacy-spmd vs fused-local: every output and the
    final named state equal across empty, partial, quorum-failure, vote,
    resync, ring-wrap and chained rounds."""
    fused = world[("fused_matrix", "fused", replicas, part_shards)]
    legacy = world[("fused_matrix", "legacy", replicas, part_shards)]
    outs, state = _local(_jobs()[("fused_matrix", "fused", replicas,
                                  part_shards)])
    for name, res in (("fused-spmd", fused), ("legacy-spmd", legacy)):
        _assert_equal(outs, res["outs"], name)
        _assert_equal(state, res["state"], name)
    # The fill reached capacity: the refusal round committed nothing.
    assert not outs[-4].committed[0] and outs[-3].committed[0]


def test_make_spmd_fns_fused_emits_no_fallback_warning(world):
    res = world["no_fallback"]
    assert not any("fused_control" in w for w in res["warnings"]), res
    assert res["outs"][0].committed[0]


def test_spmd_per_device_stride_verdict(world):
    """The ring-stride rule priced at the per-rank shard: 512 partitions
    over 8 cells (64 rings a cell) warn; 256 (32 a cell) stay silent."""
    assert any("per-device shard" in w for w in world[("stride", 512)]["warnings"])
    assert world[("stride", 256)]["warnings"] == []


def test_step_many_equals_sequential_steps_spmd(world):
    _spmd_matches_local(world, "chain")


def test_spmd_ring_wrap_matches_local(world):
    res = _spmd_matches_local(world, "wrap")
    assert all(o.committed[0] for o in res["outs"][:5])


def test_shard_and_gather_state_round_trip(world):
    """`convert.shard_state` cuts a whole state into the cells and
    `convert.gather_state` puts it back together exactly."""
    job = _jobs()["round_trip"]
    _assert_equal(job["start"], world["round_trip"]["state"], "round trip")

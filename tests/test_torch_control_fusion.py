"""Parity suite for the fused control phase and packed write path.

EngineConfig.fused_control restructures the round's bookkeeping (stacked
[K, P] ctrl array, wide fused ops — core.step.replica_control_fused) and
EngineConfig.packed_writes clips append windows to the round's payload
extent (ops/append.py packed mode). Both are PERF levers: their contract
is bit-identical behavior with the legacy path. This suite replays one
scripted history — empty rounds, partial batches, full batches, quorum
failures, leaderless partitions, offset-commit blends, capacity
backpressure, a trim-gated ring wrap, chained dispatches, sparse
(active-set) dispatches, an election and a resync — through every flag
combination on the CPU and asserts:

- every StepOutput of every round is bit-identical;
- every scalar state field (log_end/last_term/current_term/commit) and
  the offsets table are bit-identical after every phase;
- the COMMITTED log prefix is byte-identical (packed mode legitimately
  leaves bytes beyond the write extent untouched — those rows are past
  log_end and unreadable by contract, so full-log equality is asserted
  only for the unpacked variants).

Twin of `tests/test_control_fusion.py` on the PyTorch port. Each
variant's history runs through `TwinFns` (the port's engine and the
reference's in lockstep, every output and state leaf equal after every
call); the cross-variant assertions then read the port's snapshots. The
spmd cases run the port's spmd binding on a gloo world of 6 CPU
processes (`tests/torch_spmd_world.py`), one process a mesh cell, where
the reference runs shard_map on virtual devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.core.state import (
    FusedReplicaState,
    ReplicaState,
    StepInput,
    fuse_state,
    unfuse_state,
)
from ripplemq_tpu_torch.parallel.engine import make_local_fns
from tests.torch_helpers import TwinFns
from tests.torch_helpers import make_input as build_step_input
from tests.torch_port_modules import admit
from tests.torch_spmd_world import run_world

admit(__name__)

BASE = dict(
    partitions=4,
    replicas=3,
    slots=64,
    slot_bytes=32,
    max_batch=8,
    read_batch=8,
    max_consumers=8,
    max_offset_updates=4,
)

VARIANTS = {
    "legacy": {},
    "fused": dict(fused_control=True),
    "packed": dict(packed_writes=True),
    "fused+packed": dict(fused_control=True, packed_writes=True),
}

ALL = np.ones((3,), bool)
MINORITY = np.array([True, False, False])
MAJORITY = np.array([True, True, False])

# (appends, offset_updates, leader, term, alive) per round — the
# scenario mix the docstring promises.
SCRIPT = [
    # partial batch on one partition
    (dict(appends={0: [b"a", b"b", b"c"]}), None, 0, 1, ALL),
    # offset blend riding an append + an offsets-only partition
    (dict(appends={1: [b"x"]}, offset_updates={0: [(1, 3)], 2: [(0, 7)]}),
     None, 0, 1, ALL),
    # empty round (no work anywhere): nothing acks
    (dict(), None, 0, 1, ALL),
    # leaderless partitions
    (dict(appends={0: [b"noleader"]}), None, -1, 1, ALL),
    # quorum failure: minority alive
    (dict(appends={0: [b"minority"]}), None, 0, 1, MINORITY),
    # majority commit after the failure (retry semantics)
    (dict(appends={0: [b"retry"]}), None, 0, 1, MAJORITY),
    # full batch, term bump
    (dict(appends={2: [b"f%d" % i for i in range(8)]}), None, 1, 2, ALL),
    # offsets-only round on an idle partition
    (dict(offset_updates={3: [(0, 5), (2, 9)]}), None, 0, 2, ALL),
    # dead leader: no progress
    (dict(appends={3: [b"dead"]}), None, 1, 2, np.array([True, False, True])),
]


def _cfg(name):
    return EngineConfig(**BASE, **VARIANTS[name])


def _unfused(cfg, state):
    """Host-materialized named-field snapshot: the engine updates its
    state in place, so every capture copies to numpy."""
    state = state.port if hasattr(state, "port") else state
    state = unfuse_state(state) if cfg.fused_control else state
    return ReplicaState(**convert.state_to_numpy(state))


def _host(out):
    """Outputs (tensors, StepOutputs, tuples of them) as numpy."""
    import torch

    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy().copy()
    if isinstance(out, tuple):
        return type(out)(*(_host(x) for x in out)) if hasattr(
            out, "_fields") else tuple(_host(x) for x in out)
    if isinstance(out, list):
        return [_host(x) for x in out]
    return out


def _run_history(name):
    """One full scripted history; returns per-phase snapshots."""
    cfg = _cfg(name)
    fns = TwinFns(cfg)
    snaps = {}

    state = fns.init()
    outs = []
    for appends, _, leader, term, alive in SCRIPT:
        inp = build_step_input(cfg, leader=leader, term=term, **appends)
        state, out = fns.step(state, inp, alive)
        outs.append(_host(out))
    snaps["script_outs"] = outs
    snaps["script_state"] = _unfused(cfg, state)

    # Chained dispatch: the same four rounds through step_many must land
    # the same place as four sequential steps.
    chain = [
        build_step_input(cfg, appends={0: [b"k%d" % k], 2: [b"c%d" % k] * 3},
                         leader=0, term=2)
        for k in range(4)
    ]
    stacked = stack_inputs(chain)
    state, outs_many = fns.step_many(state, stacked, ALL)
    snaps["chain_outs"] = _host(outs_many)
    snaps["chain_state"] = _unfused(cfg, state)

    # Capacity backpressure + trim-gated ring wrap: fill the ring, see
    # the refusal, then trim and wrap a round past the boundary.
    fill = [b"z"] * cfg.max_batch
    end = int(np.asarray(snaps["chain_state"].log_end)[0, 0])
    rounds_left = (cfg.slots - end) // cfg.max_batch
    for _ in range(rounds_left):
        state, out = fns.step(
            state, build_step_input(cfg, appends={0: fill}, leader=0, term=2),
            ALL,
        )
    state, refused = fns.step(
        state, build_step_input(cfg, appends={0: [b"full"]}, leader=0, term=2),
        ALL,
    )
    snaps["refused"] = _host(refused)
    trim = np.full((cfg.partitions,), cfg.max_batch, np.int32)
    state, wrapped = fns.step(
        state, build_step_input(cfg, appends={0: [b"wrap"]}, leader=0, term=2),
        ALL, None, trim,
    )
    snaps["wrapped"] = _host(wrapped)
    snaps["wrap_state"] = _unfused(cfg, state)

    # Election + post-election round.
    cand = np.full((cfg.partitions,), -1, np.int32)
    cand[1] = 2
    cand_term = np.full((cfg.partitions,), 5, np.int32)
    state, elected, votes = fns.vote(state, cand, cand_term, ALL)
    snaps["vote"] = _host((elected, votes))
    snaps["vote_state"] = _unfused(cfg, state)

    # Resync a lagging replica, then commit with the full set again.
    state, _ = fns.step(
        state, build_step_input(cfg, appends={1: [b"m1", b"m2"]}, leader=0,
                                term=5),
        MAJORITY,
    )
    mask = np.array([False, True, False, False])
    state = fns.resync(state, np.int32(0), np.int32(2), mask)
    state, out = fns.step(
        state, build_step_input(cfg, appends={1: [b"m3"]}, leader=0, term=5),
        ALL,
    )
    snaps["resync_out"] = _host(out)
    snaps["resync_state"] = _unfused(cfg, state)

    # Sparse (active-set) dispatch parity.
    sparse_inp = build_step_input(cfg, leader=0, term=5)
    entries = build_step_input(
        cfg, appends={2: [b"s1", b"s2"]}, leader=0, term=5
    )
    ec = np.asarray(entries.entries)[2:3]
    ids = np.array([2], np.int32)
    sp = sparse_inp._replace(counts=np.asarray(entries.counts),
                             extents=np.asarray(entries.extents))
    state, out = fns.step_sparse(state, sp, ec, ids, ALL)
    snaps["sparse_out"] = _host(out)
    snaps["final_state"] = _unfused(cfg, state)

    # Read-path parity on the final state.
    reads = []
    for p in range(cfg.partitions):
        data, lens, count = fns.read(state, 0, p, 0)
        reads.append((_host(data), _host(lens), int(count)))
    snaps["reads"] = reads
    snaps["read_offset"] = int(fns.read_offset(state, 0, 3, 0))
    return cfg, snaps


def stack_inputs(inputs):
    return StepInput(*[
        np.stack([np.asarray(getattr(i, f)) for i in inputs])
        for f in StepInput._fields
    ])


@pytest.fixture(scope="module")
def histories():
    return {name: _run_history(name) for name in VARIANTS}


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for e in x for y in _leaves(e)]
    return [x]


def _assert_tree_equal(a, b, msg):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=msg)


STATE_KEYS = ("script_state", "chain_state", "wrap_state", "vote_state",
              "resync_state", "final_state")
OUT_KEYS = ("script_outs", "chain_outs", "refused", "wrapped", "vote",
            "resync_out", "sparse_out", "reads", "read_offset")


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "legacy"])
def test_outputs_bit_identical(histories, name):
    _, legacy = histories["legacy"]
    _, variant = histories[name]
    for key in OUT_KEYS:
        _assert_tree_equal(legacy[key], variant[key], f"{name}:{key}")


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "legacy"])
def test_scalar_state_bit_identical(histories, name):
    _, legacy = histories["legacy"]
    _, variant = histories[name]
    for key in STATE_KEYS:
        for f in ("log_end", "last_term", "current_term", "commit",
                  "offsets"):
            np.testing.assert_array_equal(
                np.asarray(getattr(legacy[key], f)),
                np.asarray(getattr(variant[key], f)),
                err_msg=f"{name}:{key}:{f}",
            )


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "legacy"])
def test_committed_log_prefix_identical(histories, name):
    cfg_l, legacy = histories["legacy"]
    cfg_v, variant = histories[name]
    for key in STATE_KEYS:
        log_l = np.asarray(legacy[key].log_data)
        log_v = np.asarray(variant[key].log_data)
        if not cfg_v.packed_writes:
            # Unpacked variants write the identical full windows: the
            # whole physical ring must match byte-for-byte.
            np.testing.assert_array_equal(log_l, log_v,
                                          err_msg=f"{name}:{key}")
            continue
        ends = np.asarray(legacy[key].log_end)
        S = cfg_l.slots
        for r in range(cfg_l.replicas):
            for p in range(cfg_l.partitions):
                live = min(int(ends[r, p]), S)
                np.testing.assert_array_equal(
                    log_l[r, p, :live], log_v[r, p, :live],
                    err_msg=f"{name}:{key}:r{r}p{p}",
                )


def test_fuse_unfuse_roundtrip():
    cfg = _cfg("legacy")
    fns = make_local_fns(cfg, device="cpu")
    state = fns.init()
    state, _ = fns.step(
        state, build_step_input(cfg, appends={0: [b"rt"]}, leader=0, term=1),
        ALL,
    )
    rt = unfuse_state(fuse_state(state))
    _assert_tree_equal(list(convert.state_to_numpy(state).values()),
                       list(convert.state_to_numpy(rt).values()),
                       "fuse/unfuse roundtrip")


def test_fused_accessors_match_fields():
    cfg = _cfg("fused")
    fns = make_local_fns(cfg, device="cpu")
    state = fns.init()
    state, _ = fns.step(
        state, build_step_input(cfg, appends={1: [b"v"]}, leader=0, term=3),
        ALL,
    )
    assert isinstance(state, FusedReplicaState)
    plain = unfuse_state(state)
    for f in ("log_end", "last_term", "current_term", "commit"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, f)), np.asarray(getattr(plain, f)),
            err_msg=f,
        )


# ------------------------------------------------ the spmd binding


def _step_call(inp, alive):
    return ("step", [tuple(inp), alive, None, None])


def _job(name, mesh, calls, **kw):
    return dict(mesh=mesh, cfg=dataclasses.asdict(_cfg(name)), calls=calls,
                **kw)


def _script_calls(cfg, rounds):
    return [_step_call(build_step_input(cfg, leader=leader, term=term,
                                        **appends), alive)
            for appends, _, leader, term, alive in rounds]


def _none_extents_call(cfg):
    """A hand-built input with extents=None (the full window)."""
    inp = build_step_input(cfg, appends={1: [b"nofill"]}, leader=0,
                           term=2)._replace(extents=None)
    return _step_call(inp, np.ones((3,), bool))


SPMD_JOBS = {
    "packed": lambda: _job("packed", (3, 2), _script_calls(
        _cfg("packed"), SCRIPT[:6]) + [_none_extents_call(_cfg("packed"))]),
    "no_fallback": lambda: _job("fused", (3, 1), [_step_call(
        build_step_input(_cfg("fused"), appends={0: [b"ok"]}, leader=0,
                         term=1), np.ones((3,), bool))]),
    "fused": lambda: _job("fused", (3, 2), _script_calls(_cfg("fused"),
                                                         SCRIPT)),
    "fused+packed": lambda: _job("fused+packed", (3, 2), _script_calls(
        _cfg("fused+packed"), SCRIPT)),
}


@pytest.fixture(scope="module")
def spmd_world(tmp_path_factory):
    jobs = {k: make() for k, make in SPMD_JOBS.items()}
    results = run_world(6, list(jobs.values()),
                        tmp_path_factory.mktemp("fusion_world"))
    return {k: (jobs[k], r) for k, r in zip(jobs, results)}


def _local_legacy(job):
    """The job's call stream through the LEGACY local engine, in
    lockstep with the reference's (TwinFns)."""
    from tests.torch_spmd_world import _numpy

    fns = TwinFns(_cfg("legacy"))
    state = fns.init()
    outs = []
    for _, (inp, alive, _q, _t) in job["calls"]:
        state, out = fns.step(state, StepInput(*inp), alive)
        outs.append(_numpy(out))
    return outs, _unfused(_cfg("legacy"), state)


def _assert_spmd_matches_local_legacy(spmd_world, key):
    job, res = spmd_world[key]
    outs, ls = _local_legacy(job)
    _assert_tree_equal(outs, res["outs"], f"spmd {key} out")
    fs = res["state"]
    for f in ("log_end", "last_term", "current_term", "commit", "offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(ls, f)), fs[f],
                                      err_msg=f)
    ends = np.asarray(ls.log_end)
    cfg = _cfg(key)
    for r in range(cfg.replicas):
        for p in range(cfg.partitions):
            live = min(int(ends[r, p]), cfg.slots)
            np.testing.assert_array_equal(ls.log_data[r, p, :live],
                                          fs["log_data"][r, p, :live])


def test_spmd_packed_matches_local_legacy(spmd_world):
    """packed_writes is honored by the spmd binding: a mesh running
    packed rounds must land the same scalar state and outputs as the
    local legacy engine (same committed-prefix guarantee), and an input
    with extents=None fills the full window (the legacy write)."""
    _assert_spmd_matches_local_legacy(spmd_world, "packed")


def test_spmd_fused_no_fallback_warning(spmd_world):
    """fused_control under the spmd binding is implemented: building it
    raises no fallback UserWarning, and it serves committed rounds
    through the fused control phase."""
    _, res = spmd_world["no_fallback"]
    assert not any("fused_control" in w for w in res["warnings"]), (
        res["warnings"])
    assert bool(np.asarray(res["outs"][0].committed)[0])


@pytest.mark.parametrize("name", ["fused", "fused+packed"])
def test_spmd_fused_matches_local_legacy(spmd_world, name):
    """The fused spmd binding replayed against the LEGACY local engine
    over the scripted history: same outputs, same scalar state, same
    committed log prefix."""
    _assert_spmd_matches_local_legacy(spmd_world, name)


def test_init_from_image_parity():
    """Recovered-image install must land both layouts in the same state
    (broker/replication.py recovery path rides init_from), each held to
    the reference's."""
    cfg_l, cfg_f = _cfg("legacy"), _cfg("fused")
    P, S, B, SB, C = (cfg_l.partitions, cfg_l.slots, cfg_l.max_batch,
                      cfg_l.slot_bytes, cfg_l.max_consumers)
    rng = np.random.default_rng(5)
    image = ReplicaState(
        log_data=rng.integers(0, 256, size=(P, S + B, SB), dtype=np.uint8),
        log_end=np.array([8, 0, 16, 8], np.int32),
        last_term=np.array([1, 0, 2, 1], np.int32),
        current_term=np.array([1, 0, 2, 1], np.int32),
        commit=np.array([8, 0, 16, 8], np.int32),
        offsets=rng.integers(0, 99, size=(P, C)).astype(np.int32),
    )
    st_l = TwinFns(cfg_l).init_from(image)
    st_f = TwinFns(cfg_f).init_from(image)
    a = convert.state_to_numpy(st_l.port)
    b = convert.state_to_numpy(unfuse_state(st_f.port))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"init_from {k}")

"""The spmd binding against the JAX package's, exactly.

One seeded call stream goes through the reference's `make_spmd_fns` on
the 8 virtual CPU devices `tests/conftest.py` provides (shard_map, in
this process) and through the port's `make_spmd_fns` on a gloo world of
8 CPU processes (`tests/torch_spmd_world.py`), on the same mesh. The
stream holds elections, dense, sparse and chained rounds (single and
multi-round, packed extents), quorum failures under [R] and [P, R]
liveness masks, a per-partition quorum override that leaves a replica
behind, the resync that repairs it, a ring that wraps behind a rising
trim, and reads of every kind. Every output of every call and every
leaf of the final state (gathered from the port's cells with
`convert.gather_state`, in the named layout) must be byte-equal.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from ripplemq_tpu.core import state as ref_state
from ripplemq_tpu.core.config import EngineConfig as RefConfig
from ripplemq_tpu.core.encode import build_step_input
from ripplemq_tpu.parallel.engine import make_spmd_fns as ref_make_spmd_fns
from ripplemq_tpu.parallel.mesh import make_mesh as ref_make_mesh
from tests.torch_port_modules import admit
from tests.torch_spmd_world import run_world

admit(__name__)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

P, B, SB, S, K = 8, 8, 32, 32, 3
VARIANTS = {  # name -> (mesh, engine flags, replicas)
    "fused+packed": ((2, 4), dict(fused_control=True, packed_writes=True), 2),
    "legacy": ((4, 2), dict(), 4),
}


def _cfg(variant) -> RefConfig:
    mesh, flags, R = VARIANTS[variant]
    return RefConfig(partitions=P, replicas=R, slots=S, slot_bytes=SB,
                     max_batch=B, read_batch=8, max_consumers=8,
                     max_offset_updates=4, **flags)


def _stream(cfg: RefConfig, seed: int) -> list:
    """The seeded call stream: (method, args) with numpy args."""
    rng = np.random.default_rng(seed)
    R = cfg.replicas
    alive = np.ones((R,), bool)
    leader = np.zeros((P,), np.int32)
    term = np.ones((P,), np.int32)
    seq = [0]

    def payloads(n):
        seq[0] += 1
        return [b"m%d-%d-" % (seq[0], i) + bytes(rng.integers(
            0, 256, size=int(rng.integers(0, 12)), dtype=np.uint8))
            for i in range(n)]

    def dense(parts, offsets=False):
        ups = ({p: [(int(rng.integers(0, 8)), int(rng.integers(0, 99)))]
                for p in parts} if offsets else None)
        inp = build_step_input(
            cfg, appends={p: payloads(int(rng.integers(1, B + 1)))
                          for p in parts},
            offset_updates=ups, leader={p: int(leader[p]) for p in range(P)},
            term={p: int(term[p]) for p in range(P)})
        return inp._replace(extents=np.asarray(inp.counts).copy())

    def sparse(parts, A=4):
        inp = dense(parts, offsets=True)
        ids = np.full((A,), -1, np.int32)
        ids[:len(parts)] = parts
        entries_c = np.zeros((A, B, SB), np.uint8)
        entries_c[:len(parts)] = np.asarray(inp.entries)[parts]
        return inp._replace(entries=np.zeros((P, 1, 1), np.uint8)), entries_c, ids

    def stack(xs):
        return tuple(None if xs[0][i] is None
                     else np.stack([np.asarray(x[i]) for x in xs])
                     for i in range(len(xs[0])))

    def pick(n):
        return np.sort(rng.choice(P, size=n, replace=False)).astype(np.int32)

    calls = [("vote", [np.zeros((P,), np.int32), term.copy(), alive, None])]
    for _ in range(3):
        inp, ec, ids = sparse(pick(int(rng.integers(1, 5))))
        calls.append(("step_sparse", [tuple(inp), ec, ids, alive, None, None]))
    chain = [sparse(pick(3)) for _ in range(K)]
    calls.append(("step_many_sparse", [
        stack([tuple(c[0]) for c in chain]), np.stack([c[1] for c in chain]),
        np.stack([c[2] for c in chain]), alive, None, None]))
    calls.append(("step", [tuple(dense(pick(5), offsets=True)), alive,
                           None, None]))
    calls.append(("step_many", [stack([tuple(dense(pick(2))) for _ in range(2)]),
                                alive, None, None]))
    # Quorum failure: every replica but the first dead.
    minority = np.zeros((R,), bool)
    minority[0] = True
    calls.append(("step", [tuple(dense(pick(4))), minority, None, None]))
    # Per-partition liveness: partition 3 loses its last replica, and a
    # quorum of 1 there commits on the others only — it falls behind.
    mask = np.ones((P, R), bool)
    mask[3, R - 1] = False
    quorum = np.full((P,), cfg.quorum, np.int32)
    quorum[3] = 1
    calls.append(("step", [tuple(dense([3, 5])), mask, quorum, None]))
    calls.append(("read", [R - 1, 3, 0]))
    # An election moves partitions 1 and 6 to the last replica, term 2.
    cand = np.full((P,), -1, np.int32)
    cand[[1, 6]] = R - 1
    term[[1, 6]] = 2
    calls.append(("vote", [cand, term.copy(), alive, None]))
    leader[[1, 6]] = R - 1
    # The lagging replica is resynced from replica 0 on partition 3.
    part_mask = np.zeros((P,), bool)
    part_mask[3] = True
    calls.append(("resync", [np.int32(0), np.int32(R - 1), part_mask]))
    inp, ec, ids = sparse(np.array([1, 3, 6], np.int32))
    calls.append(("step_sparse", [tuple(inp), ec, ids, alive, None, None]))
    # A ring wrap on partition 2 behind a rising trim.
    trim = np.zeros((P,), np.int32)
    for lap in range(6):
        trim[2] = max(0, 8 * lap)
        calls.append(("step", [tuple(dense([2])), alive, None, trim.copy()]))
    # Reads of every kind, in and out of range.
    for rep, part, off in [(0, 0, 0), (R - 1, 3, 0), (0, 2, 40), (99, 1, 0),
                           (0, 99, 8), (-1, 6, 0)]:
        calls.append(("read", [rep, part, off]))
    Q = 6
    calls.append(("read_many", [
        rng.integers(0, R, size=Q).astype(np.int32),
        rng.integers(0, P, size=Q).astype(np.int32),
        (8 * rng.integers(0, 4, size=Q)).astype(np.int32)]))
    for part in range(P):
        calls.append(("read_offset", [int(part % R), part, int(part % 8)]))
    return calls


def _ref_replay(cfg, mesh_shape, calls):
    fns = ref_make_spmd_fns(cfg, ref_make_mesh(*mesh_shape))
    state = fns.init()
    outs = []
    for method, args in calls:
        if method in ("step", "step_many", "step_sparse", "step_many_sparse"):
            inp, *rest = args
            state, out = getattr(fns, method)(state, ref_state.StepInput(*inp),
                                              *rest)
        elif method == "vote":
            state, elected, votes = fns.vote(state, *args)
            out = (elected, votes)
        elif method == "resync":
            state, out = fns.resync(state, *args), None
        else:
            out = getattr(fns, method)(state, *args)
        outs.append(None if out is None
                    else jax.tree.map(lambda x: np.asarray(x).copy(), out))
    if cfg.fused_control:
        state = ref_state.unfuse_state(state)
    return outs, {f: np.asarray(getattr(state, f)) for f in state._fields}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    streams = {v: _stream(_cfg(v), seed=11) for v in VARIANTS}
    jobs = [dict(mesh=VARIANTS[v][0], cfg=dataclasses.asdict(_cfg(v)),
                 calls=streams[v]) for v in VARIANTS]
    port = run_world(8, jobs, tmp_path_factory.mktemp("spmd_parity"))
    return {v: (streams[v], port[i]) for i, v in enumerate(VARIANTS)}


def _flat(x):
    if x is None:
        return []
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _flat(v)]
    return [np.asarray(x)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_spmd_call_stream_matches_the_reference_exactly(runs, variant):
    calls, port = runs[variant]
    ref_outs, ref_final = _ref_replay(_cfg(variant), VARIANTS[variant][0],
                                      calls)
    assert len(port["outs"]) == len(ref_outs)
    for i, ((method, _), a, b) in enumerate(zip(calls, ref_outs,
                                                 port["outs"])):
        fa, fb = _flat(a), _flat(b)
        assert len(fa) == len(fb), (i, method)
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype and x.shape == y.shape, (i, method)
            np.testing.assert_array_equal(x, y, err_msg=f"call {i} {method}")
    for name, leaf in ref_final.items():
        got = port["state"][name]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, name
        np.testing.assert_array_equal(leaf, got, err_msg=f"final {name}")
    # The scenario really exercised what it names.
    committed = [o.committed for (m, _), o in zip(calls, ref_outs)
                 if m.startswith("step")]
    assert any(np.asarray(c).any() for c in committed)
    assert any(not np.asarray(c).all() for c in committed)
    assert port["stats"]["all_reduce_sum_replica"] > 0
    assert port["stats"]["all_gather_part"] > 0

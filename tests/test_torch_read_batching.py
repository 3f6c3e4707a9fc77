"""Batched reads (engine read_many + the DataPlane read coalescer) and
the host-side consumer-offset shadow.

The consume-side mirror of append batching: each device read dispatch
costs a full host<->device round trip, so concurrent consumer polls must
share dispatches.

Twin of `tests/test_read_batching.py` on the PyTorch port: the local
engine runs through `TwinFns` (the port's engine and the reference's in
lockstep, every output and state leaf equal after every call); the spmd
cases run the port's spmd binding on a gloo world of 4 CPU processes
(`tests/torch_spmd_world.py`), one process a mesh cell; the plane cases
run the port's DataPlane on the CPU.
"""

import dataclasses
import threading

import numpy as np
import pytest

from ripplemq_tpu_torch.core.encode import decode_entries as decode_read
from ripplemq_tpu_torch.core.state import StepInput
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore
from tests.torch_helpers import TwinFns, make_input, port_cfg, port_dp
from tests.torch_port_modules import admit
from tests.torch_spmd_world import run_world

admit(__name__)


def _fill(fns, cfg, appends):
    state = fns.init()
    alive = np.ones((cfg.replicas,), bool)
    for inp in appends:
        state, out = fns.step(state, inp, alive)
        assert bool(np.asarray(out.committed).any())
    return state


def test_read_many_matches_sequential_reads_local():
    cfg = port_cfg(slots=64)
    fns = TwinFns(cfg)
    state = _fill(fns, cfg, [
        make_input(cfg, appends={0: [b"a0", b"a1"], 1: [b"b0"],
                                 3: [b"d%d" % i for i in range(5)]}),
        make_input(cfg, appends={0: [b"a2"]}),
    ])
    queries = [(0, 0, 0), (1, 1, 0), (2, 3, 2), (0, 0, 8), (1, 2, 0)]
    reps = np.array([q[0] for q in queries], np.int32)
    parts = np.array([q[1] for q in queries], np.int32)
    offs = np.array([q[2] for q in queries], np.int32)
    datas, lenss, counts = fns.read_many(state, reps, parts, offs)
    for i, (rep, part, off) in enumerate(queries):
        d, l, c = fns.read(state, rep, part, off)
        assert int(c) == int(np.asarray(counts)[i])
        assert decode_read(d, l, c) == decode_read(
            np.asarray(datas)[i], np.asarray(lenss)[i],
            int(np.asarray(counts)[i]),
        )


# ------------------------------------------------ the spmd binding

SPMD_CFG = dict(partitions=4, replicas=2, slots=64)
SPARSE_CFG = dict(partitions=4, replicas=2, slots=32, max_batch=8)
ALIVE2 = np.ones((2,), bool)


def _read_many_inputs(cfg):
    return [make_input(cfg, appends={p: [b"m%d" % p] for p in range(4)})]


READ_Q = (np.array([0, 1, 0, 1], np.int32), np.array([0, 1, 2, 3], np.int32),
          np.zeros((4,), np.int32))


def _dense_inputs(cfg):
    return [
        make_input(cfg, appends={0: [b"s0"], 2: [b"s2a", b"s2b"]}),
        make_input(cfg, appends={1: [b"s1"]}),
    ]


def sparse_form(cfg, inp):
    entries = np.asarray(inp.entries)
    counts = np.asarray(inp.counts)
    active = [p for p in range(cfg.partitions) if counts[p] > 0]
    A = 4
    ec = np.zeros((A,) + entries.shape[1:], np.uint8)
    ids = np.full((A,), -1, np.int32)
    for a, p in enumerate(active):
        ec[a] = entries[p]
        ids[a] = p
    dummy = np.zeros((cfg.partitions, 1, 1), np.uint8)
    return inp._replace(entries=dummy), ec, ids


def _stacked_sparse(cfg, inputs):
    forms = [sparse_form(cfg, i) for i in inputs]
    stacked = StepInput(*[np.stack([np.asarray(getattr(f[0], name))
                                    for f in forms])
                          for name in StepInput._fields])
    return stacked, np.stack([f[1] for f in forms]), np.stack(
        [f[2] for f in forms])


def _spmd_jobs():
    cfg = port_cfg(**SPMD_CFG)
    scfg = port_cfg(**SPARSE_CFG)
    step = lambda inp: ("step", [tuple(inp), ALIVE2, None, None])  # noqa: E731
    seq = [("step_sparse", [tuple(si), ec, ids, ALIVE2, None, None])
           for si, ec, ids in (sparse_form(scfg, i)
                               for i in _dense_inputs(scfg))]
    st, ecs, idss = _stacked_sparse(scfg, _dense_inputs(scfg))
    return {
        "read_many": dict(mesh=(2, 2), cfg=dataclasses.asdict(cfg), calls=[
            *(step(i) for i in _read_many_inputs(cfg)),
            ("read_many", list(READ_Q))]),
        "sparse": dict(mesh=(2, 2), cfg=dataclasses.asdict(scfg), calls=seq),
        "sparse_chain": dict(mesh=(2, 2), cfg=dataclasses.asdict(scfg),
                             calls=[("step_many_sparse",
                                     [tuple(st), ecs, idss, ALIVE2, None,
                                      None])]),
    }


@pytest.fixture(scope="module")
def spmd_world(tmp_path_factory):
    jobs = _spmd_jobs()
    results = run_world(4, list(jobs.values()),
                        tmp_path_factory.mktemp("read_world"))
    return dict(zip(jobs, results))


def test_read_many_matches_sequential_reads_spmd(spmd_world):
    cfg = port_cfg(**SPMD_CFG)
    local = TwinFns(cfg)
    ls = _fill(local, cfg, _read_many_inputs(cfg))
    l_out = local.read_many(ls, *READ_Q)
    s_out = spmd_world["read_many"]["outs"][-1]
    for a, b in zip(l_out, s_out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _named(st):
    from ripplemq_tpu_torch import convert

    return convert.state_to_numpy(st.port)


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sparse_step_matches_dense_local_and_spmd(spmd_world):
    """Active-set rounds must evolve state exactly like dense rounds —
    across both engine bindings."""
    cfg = port_cfg(**SPARSE_CFG)
    alive = np.ones((2,), bool)
    dense_inputs = _dense_inputs(cfg)
    local = TwinFns(cfg)

    ds = local.init()
    for inp in dense_inputs:
        ds, d_out = local.step(ds, inp, alive)
    dense = _named(ds)
    ss = local.init()
    for inp in dense_inputs:
        si, ec, ids = sparse_form(cfg, inp)
        ss, s_out = local.step_sparse(ss, si, ec, ids, alive)
    _assert_states_equal(dense, _named(ss))

    # Chained sparse == sequential sparse == dense.
    stacked, ecs, idss = _stacked_sparse(cfg, dense_inputs)
    cs, c_outs = local.step_many_sparse(local.init(), stacked, ecs, idss,
                                        alive)
    _assert_states_equal(dense, _named(cs))

    # The spmd binding, sequential and chained, gathered from its cells.
    _assert_states_equal(dense, spmd_world["sparse"]["state"])
    _assert_states_equal(dense, spmd_world["sparse_chain"]["state"])


# ------------------------------------------------------- the plane


def test_concurrent_consumers_share_dispatches():
    """Many threads polling concurrently must coalesce into few
    read_many dispatches while every reader sees exactly its data."""
    cfg = port_cfg(partitions=4, slots=256, max_batch=8, read_batch=8)
    # Cache off: this test covers the DEVICE read coalescer, which is
    # the fallback path when the host mirror has a gap.
    dp = port_dp(cfg, store=MemoryRoundStore(), read_q=16,
                 host_read_cache=False)
    dp.start()
    try:
        sent = {p: [] for p in range(4)}
        for p in range(4):
            dp.set_leader(p, 0, 1)
        for i in range(64):
            p = i % 4
            m = b"rc-%02d-%03d" % (p, i)
            sent[p].append(m)
            dp.submit_append(p, [m]).result(timeout=30)
        results = {}

        def consumer(tid: int) -> None:
            p = tid % 4
            got, offset = [], 0
            while True:
                msgs, nxt = dp.read(p, offset, replica=0)
                if nxt == offset:
                    break
                got.extend(msgs)
                offset = nxt
            results[tid] = (p, got)

        threads = [threading.Thread(target=consumer, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 16
        for tid, (p, got) in results.items():
            assert got == sent[p], f"consumer {tid} mismatch"
    finally:
        dp.stop()


def test_offset_shadow_matches_device_table():
    """read_offset serves the host shadow; it must agree with the
    device's replicated offset table after commits and after recovery."""
    cfg = port_cfg(slots=64, max_batch=8)
    store = MemoryRoundStore()
    dp = port_dp(cfg, store=store)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        dp.submit_append(0, [b"x"] * 8).result(timeout=30)
        assert dp.submit_offsets(0, [(2, 5)]).result(timeout=30) is True
        assert dp.submit_offsets(0, [(2, 8), (3, 4)]).result(timeout=30)
        assert dp.read_offset(0, 2) == 8
        assert dp.read_offset(0, 3) == 4
        # Agrees with the device's table (the replicated source of truth).
        with dp._device_lock:
            dev = int(dp.fns.read_offset(
                dp._state, np.int32(0), np.int32(0), np.int32(2)))
        assert dev == 8
    finally:
        dp.stop()

    # Recovery path: the shadow re-seeds from the replayed image.
    from ripplemq_tpu_torch.broker.dataplane import replay_records

    image = replay_records(cfg, store.scan())
    dp2 = port_dp(cfg, store=MemoryRoundStore())
    dp2.install(image)
    dp2.start()
    try:
        assert dp2.read_offset(0, 2) == 8
        assert dp2.read_offset(0, 3) == 4
    finally:
        dp2.stop()

"""The port's DataPlane, CPU twins of the reference's `tests/test_chain.py`
(chained rounds: K complete quorum rounds per device dispatch; the four
local tests) and `tests/test_settle_pipeline.py` (the pipelined settle
window: in-order acks, settle-gated reads, fencing drains the window,
window 1 serializes). Same scenarios and assertions on a port plane
built with `device="cpu"`. The spmd chain test's twin is in
`tests/test_torch_spmd.py`;
`test_read_coalesce_s_constructor_and_config`'s ClusterConfig half waits
for slice D (ROADMAP.md); its constructor half is twinned here."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest

from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.broker.dataplane import NotCommittedError
from ripplemq_tpu_torch.broker.replication import FencedError
from ripplemq_tpu_torch.core.encode import build_step_input
from ripplemq_tpu_torch.core.state import StepInput
from ripplemq_tpu_torch.parallel.engine import make_local_fns
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore
from tests.torch_helpers import port_cfg, port_dp, read_all
from tests.torch_port_modules import admit

admit(__name__)


# ---------------------------------------------------- tests/test_chain.py


def _stack(inputs):
    return StepInput(*[
        np.stack([np.asarray(getattr(i, f)) for i in inputs])
        for f in StepInput._fields
    ])


def test_step_many_equals_sequential_steps_local():
    cfg = port_cfg(slots=256)
    fns = make_local_fns(cfg, device="cpu")
    alive = np.ones((cfg.replicas,), bool)
    inputs = [
        build_step_input(cfg, appends={0: [b"k%d" % k],
                                       2: [b"x%d" % k, b"y%d" % k]},
                         leader=0, term=1)
        for k in range(4)
    ]
    seq_state = fns.init()
    seq_outs = []
    for inp in inputs:
        seq_state, out = fns.step(seq_state, inp, alive)
        seq_outs.append(out)

    chain_state, chain_outs = fns.step_many(fns.init(), _stack(inputs), alive)
    for k, out in enumerate(seq_outs):
        for field in ("base", "committed", "commit"):
            np.testing.assert_array_equal(
                getattr(out, field).numpy(),
                getattr(chain_outs, field).numpy()[k])
    a, b = convert.state_to_numpy(seq_state), convert.state_to_numpy(chain_state)
    for leaf in a:
        np.testing.assert_array_equal(a[leaf], b[leaf])


def test_deep_single_slot_queue_drains_in_order_via_chains():
    dp = port_dp(port_cfg(slots=512, max_batch=8), store=MemoryRoundStore(),
                 chain_depth=4)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        futs = [dp.submit_append(0, [b"deep-%03d" % i]) for i in range(100)]
        offs = [f.result(timeout=60) for f in futs]
        assert len(set(offs)) == 100
        assert offs == sorted(offs)  # FIFO across chained rounds
        assert read_all(dp, 0) == [b"deep-%03d" % i for i in range(100)]
    finally:
        dp.stop()


def test_chain_with_ring_boundary_pad_inside():
    dp = port_dp(port_cfg(slots=32, max_batch=16), store=MemoryRoundStore(),
                 chain_depth=4)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        dp.submit_append(0, [b"pre"] * 8).result(timeout=30)  # end=8
        futs = [dp.submit_append(0, [b"w%02d-%d" % (j, i) for i in range(16)])
                for j in range(3)]  # 48 rows: wraps at 32
        offs = [f.result(timeout=30) for f in futs]
        assert offs == [8, 32, 48]  # 24->pad to 32, then contiguous laps
        got = read_all(dp, 0, start=8)
        want = [b"w%02d-%d" % (j, i) for j in range(3) for i in range(16)]
        # the first lap's rows may have been trimmed below the read start
        assert got[-len(want):] == want
    finally:
        dp.stop()


def test_chain_quorum_failure_fails_all_and_preserves_retry_order():
    """Rounds of a chain that lose quorum fail (nacked and requeued);
    restoring quorum lets the retries commit in the original submit
    order. The reference waits a fixed 0.5 s before healing; the port's
    CPU rounds are fast enough to spend the whole retry budget of 50 in
    that time, so the twin heals once the failed rounds are OBSERVED
    (the slot's no-commit streak), well inside the budget — the same
    scenario, with the same assertions."""
    cfg = port_cfg(slots=256, max_batch=8, replicas=3)
    dp = port_dp(cfg, store=MemoryRoundStore(), chain_depth=4,
                 max_retry_rounds=50)
    dp.start()
    try:
        dp.set_leader(0, 0, 1)
        dp.submit_append(0, [b"ok"]).result(timeout=30)
        alive = np.ones((cfg.partitions, cfg.replicas), bool)
        alive[:, 1:] = False
        dp.set_alive(alive)
        futs = [dp.submit_append(0, [b"retry-%d" % i]) for i in range(20)]
        deadline = time.monotonic() + 30
        while dp.stalled_slots(threshold=3) != [0]:
            assert time.monotonic() < deadline, "rounds never failed"
            time.sleep(0.001)
        dp.set_alive(np.ones((cfg.partitions, cfg.replicas), bool))
        offs = [f.result(timeout=60) for f in futs]
        assert offs == sorted(offs)
        msgs = read_all(dp, 0)
        assert msgs[0] == b"ok"
        assert msgs[1:] == [b"retry-%d" % i for i in range(20)]
    finally:
        dp.stop()


# ------------------------------------------- tests/test_settle_pipeline.py


class GateReplicator:
    """begin/wait replicator whose acks are released by the test."""

    def __init__(self) -> None:
        self.tickets: list[dict] = []
        self.fenced = False
        self._lock = threading.Lock()

    def begin(self, records):
        if self.fenced:
            raise FencedError("controller deposed (gate)")
        t = {"records": records, "done": threading.Event()}
        with self._lock:
            self.tickets.append(t)
        return t

    def wait(self, ticket) -> None:
        while not ticket["done"].wait(timeout=0.02):
            if self.fenced:
                raise FencedError("controller deposed (gate)")

    def release(self, n: int = 1) -> None:
        with self._lock:
            pending = [t for t in self.tickets if not t["done"].is_set()]
        for t in pending[:n]:
            t["done"].set()

    def replicate(self, records) -> None:  # barrier path compatibility
        self.wait(self.begin(records))

    def n_tickets(self) -> int:
        with self._lock:
            return len(self.tickets)


def _mk(gate: GateReplicator, window: int = 3):
    dp = port_dp(port_cfg(partitions=2), coalesce_s=0.0,
                 settle_window=window)
    dp.replicate_fn = gate.replicate
    dp.replicate_begin_fn = gate.begin
    dp.replicate_wait_fn = gate.wait
    dp.start()
    dp.set_leader(0, 0, 1)
    dp.set_leader(1, 0, 1)
    return dp


def _wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


def test_device_advances_while_replication_in_flight_acks_in_order():
    gate = GateReplicator()
    dp = _mk(gate, window=3)
    try:
        fut1 = dp.submit_append(0, [b"a1", b"a2"])
        _wait_for(lambda: gate.n_tickets() >= 1, msg="round 1 streaming")
        fut2 = dp.submit_append(0, [b"b1"])
        _wait_for(lambda: gate.n_tickets() >= 2,
                  msg="round 2 streaming while round 1 unsettled")
        assert not fut1.done() and not fut2.done()
        with dp._lock:
            assert int(dp._settled_end[0]) == 0  # nothing released yet
        gate.release(1)
        assert fut1.result(timeout=10) == 0
        assert not fut2.done()  # strictly in round order
        with dp._lock:
            assert int(dp._settled_end[0]) == 8  # ALIGN-padded round 1
        gate.release(1)
        assert fut2.result(timeout=10) == 8
        with dp._lock:
            assert int(dp._settled_end[0]) == 16
        stats = dp.settle_stats()
        assert stats["window"] == 3 and stats["samples"] >= 2
    finally:
        gate.release(16)
        dp.stop()


def test_reads_gated_on_settle_not_device_commit():
    gate = GateReplicator()
    dp = _mk(gate, window=2)
    try:
        dp.submit_append(0, [b"m1", b"m2"])
        _wait_for(lambda: gate.n_tickets() >= 1, msg="round streaming")
        time.sleep(0.05)  # give a wrong implementation time to leak
        msgs, nxt = dp.read(0, 0, replica=0)
        assert msgs == [] and nxt == 0
        gate.release(1)
        _wait_for(lambda: dp.read(0, 0, replica=0)[0] != [],
                  msg="settled rows readable")
        msgs, _ = dp.read(0, 0, replica=0)
        assert msgs == [b"m1", b"m2"]
    finally:
        gate.release(16)
        dp.stop()


def test_fencing_mid_window_drains_without_acking():
    gate = GateReplicator()
    dp = _mk(gate, window=4)
    try:
        futs = []
        for i, slot in enumerate((0, 0, 1)):
            futs.append(dp.submit_append(slot, [b"x%d" % i]))
            _wait_for(lambda n=i: gate.n_tickets() >= n + 1,
                      msg=f"round {i} streaming")
        assert not any(f.done() for f in futs)
        gate.fenced = True  # deposition: acks will never come
        for f in futs:
            with pytest.raises(NotCommittedError):
                f.result(timeout=10)
        with dp._lock:
            assert int(dp._settled_end[0]) == 0
            assert int(dp._settled_end[1]) == 0
        # The fence latches: even a round whose replication would
        # succeed again must not ack on this plane.
        late = dp.submit_append(0, [b"z0"])
        with pytest.raises(NotCommittedError):
            late.result(timeout=10)
    finally:
        dp.stop()


def test_settle_window_one_serializes():
    gate = GateReplicator()
    dp = _mk(gate, window=1)
    try:
        fut1 = dp.submit_append(0, [b"a"])
        _wait_for(lambda: gate.n_tickets() >= 1, msg="round 1 streaming")
        dp.submit_append(1, [b"b"])  # different slot: dispatches freely
        time.sleep(0.3)
        assert gate.n_tickets() == 1
        gate.release(1)
        assert fut1.result(timeout=10) == 0
        _wait_for(lambda: gate.n_tickets() >= 2, msg="round 2 streaming")
        gate.release(1)
    finally:
        gate.release(16)
        dp.stop()


def test_read_coalesce_s_constructor():
    dp = port_dp(port_cfg(), read_coalesce_s=0.0)
    assert dp.read_coalesce_s == 0.0
    dp2 = port_dp(port_cfg())
    assert dp2.read_coalesce_s == pytest.approx(0.001)


def test_settle_window_config_validation():
    with pytest.raises(ValueError):  # the port's own config check
        dataclasses.replace(port_cfg(), settle_window=0)
    assert dataclasses.replace(port_cfg(), settle_window=2).settle_window == 2
    assert port_cfg().settle_window > 1

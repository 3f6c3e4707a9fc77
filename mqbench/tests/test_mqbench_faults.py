"""A whole run on the CPU at a small size, with the timed path broken
underneath, must come out not correct: once for each fault the cells can
have. The look for a card is skipped (the run is driven through
`run_cell` with the CPU device); everything else is the run as on the
card: the port's cluster, the load generators, the read-back and the
reference."""

import threading
import time
from concurrent.futures import Future

import pytest

from mqbench.control import control_config
from mqbench.run import run_cell
from mqbench.tests.small import small_cell

CELL = "omb-100p-1kb-rf3.produce-max"


def once(fn):
    """Apply fn to the first call only (thread-safe)."""
    lock, done = threading.Lock(), []

    def first() -> bool:
        with lock:
            if done:
                return False
            done.append(1)
            return True

    return fn, first


def _alter_read(monkeypatch, mode):
    from ripplemq_tpu_torch.broker.server import BrokerServer

    real = BrokerServer._engine_read
    _, first = once(None)

    def broken(self, slot, offset, replica, max_msgs=None, wait_s=0.0):
        msgs, end = real(self, slot, offset, replica, max_msgs, wait_s)
        if len(msgs) >= 2 and first():
            msgs = list(msgs)
            if mode == "altered":
                m = bytearray(msgs[1])
                m[-1] ^= 0xFF
                msgs[1] = bytes(m)
            else:
                del msgs[1]
        return msgs, end

    monkeypatch.setattr(BrokerServer, "_engine_read", broken)


def _ack_unwritten(monkeypatch):
    from ripplemq_tpu_torch.broker.dataplane import DataPlane

    real = DataPlane.submit_append
    _, first = once(None)

    def broken(self, slot, payloads, *a, **kw):
        if first():
            fut = Future()
            fut.set_result(1 << 20)  # acked, never written
            return fut
        return real(self, slot, payloads, *a, **kw)

    monkeypatch.setattr(DataPlane, "submit_append", broken)


def _ack_before_standbys(monkeypatch):
    """Settle acks a round without waiting for its standby acks; the
    rows still reach the standbys later (acks=1, replication after)."""
    from ripplemq_tpu_torch.broker.dataplane import DataPlane

    real = DataPlane._release_one

    def broken(self, ctx, committed, records, ticket, exc):
        wait = self.replicate_wait_fn
        self.replicate_wait_fn = lambda t: None
        try:
            return real(self, ctx, committed, records, ticket, exc)
        finally:
            self.replicate_wait_fn = wait

    monkeypatch.setattr(DataPlane, "_release_one", broken)


@pytest.mark.parametrize("fault,key", [
    ("altered", "corrupt"),
    ("dropped", "missing"),
    ("acked_unwritten", "missing"),
    ("no_standby_copy", "under_replicated"),
    ("no_standby_copy", "acked_without_quorum"),
    ("ack_before_standbys", "acked_without_quorum"),
])
def test_fault_makes_run_incorrect(monkeypatch, fault, key):
    config, wl = small_cell(CELL)
    if fault in ("altered", "dropped"):
        _alter_read(monkeypatch, fault)
    elif fault == "acked_unwritten":
        _ack_unwritten(monkeypatch)
    elif fault == "ack_before_standbys":
        _ack_before_standbys(monkeypatch)
    else:
        config = control_config(config)
    rec = run_cell(config, wl, 2**32 + 99, 2.0, False, "cpu",
                   t_start_ns=time.monotonic_ns())
    assert rec["check"][key] > 0, rec["check"]


def test_clean_small_run_is_correct():
    config, wl = small_cell(CELL)
    rec = run_cell(config, wl, 2**32 + 98, 2.0, False, "cpu",
                   t_start_ns=time.monotonic_ns())
    assert not any(rec["check"].values()), rec["check"]
    assert len(rec["acks"]) > 0

"""Per-slot settled-gap reads.

Two residual windows, closed by the
settled-gap structure (the mirror-gap analogue):

1. A replication-FAILED round whose slot later settles a NEWER round sat
   below the single `_settled_end` watermark and was readable from the
   device ring — nacked data served as committed.
2. After a ring wrap, the failed round's absolute range is a hole in the
   store; boot replay then left the PREVIOUS lap's rows at those ring
   positions and `install()` marked everything settled — a reader at the
   hole got a different round's payloads at the wrong offsets.

Both tests are directed failing-before/passing-after: they fail on the
watermark design and pass with per-slot [begin, end) gaps that every
read path (device ring, host mirror, store) skips and that promotion/
boot replay rebuilds from the recovered store's coverage holes.

Twin of the cluster test of `tests/test_settled_gap.py` (the long poll
through the broker server) on the PyTorch port, with CPU brokers; the
plane-level tests are twinned beside the other DataPlane twins.
"""

from __future__ import annotations

import threading

import pytest

from ripplemq_tpu_torch.broker.dataplane import (
    DataPlane,
    NotCommittedError,
    recover_image,
)
from ripplemq_tpu_torch.broker.replication import ReplicationError
from ripplemq_tpu_torch.storage.segment import REC_APPEND, SegmentStore
from tests.torch_helpers import port_cfg
from tests.torch_port_modules import admit

admit(__name__)


class FailAtBaseReplicator:
    """begin/wait replicator that acks instantly except rounds carrying
    an append record at one of `bad_bases` — their wait raises a
    TRANSIENT ReplicationError (standby loss mid-round, NOT a fencing
    event, so later rounds keep settling)."""

    def __init__(self, bad_bases) -> None:
        self.bad_bases = set(bad_bases)
        self.failed: list[int] = []
        self._lock = threading.Lock()

    def begin(self, records):
        return records

    def wait(self, ticket) -> None:
        bad = [
            rec[2] for rec in ticket
            if rec[0] == REC_APPEND and rec[2] in self.bad_bases
        ]
        if bad:
            with self._lock:
                self.failed.extend(bad)
            raise ReplicationError(
                f"standby lost under round at base {bad} (injected)"
            )

    def replicate(self, records) -> None:
        self.wait(self.begin(records))


def _attach(dp: DataPlane, rep) -> DataPlane:
    dp.replicate_fn = rep.replicate
    dp.replicate_begin_fn = rep.begin
    dp.replicate_wait_fn = rep.wait
    dp.start()
    dp.set_leader(0, 0, 1)
    return dp


def _read_all(dp: DataPlane, slot: int = 0, start: int = 0):
    """Walk the full readable log; returns (messages, offsets_seen)."""
    msgs, offs, offset = [], [], start
    for _ in range(1000):
        got, nxt = dp.read(slot, offset, replica=0)
        for m in got:
            msgs.append(m)
        offs.append((offset, nxt, list(got)))
        if nxt == offset:
            return msgs, offs
        offset = nxt
    raise AssertionError(f"read walk never terminated: {offs[-5:]}")


def test_long_poll_parks_past_empty_but_advanced_read():
    """A long-poll parked below an all-padding tail (or a settled gap)
    must arm its wake watermark on the read's ADVANCE, not the caller's
    offset: the pre-fix loop re-read the same empty-but-advanced answer
    every 10 ms tick for the whole window (settled_end sat permanently
    above the parked offset), ~1000 wasted reads per consume. Post-fix
    the park stays quiet until rows settle PAST the advance — and still
    delivers them, and still hands the advance back at window expiry so
    the consumer can commit across the dead range."""
    import threading as _threading
    import time as _time

    from ripplemq_tpu_torch.metadata.models import Topic
    from tests.torch_helpers import InProcCluster, make_config

    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 1, 3),),
        engine=port_cfg(partitions=1, replicas=3, slots=256),
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        ctrl_id = next(iter(c.brokers.values())).manager.current_controller()
        ctrl = c.brokers[ctrl_id]
        dp = ctrl.dataplane
        client = c.net.client("lp-gap")
        leader = ctrl.manager.leader_of(("t", 0))

        def produce(payload):
            resp = client.call(
                c.brokers[leader].addr,
                {"type": "produce", "topic": "t", "partition": 0,
                 "messages": [payload]},
                timeout=5.0,
            )
            assert resp.get("ok"), resp

        produce(b"m0")  # settles [0, 8): rows 1..7 are padding
        reads = []
        real_read = dp.read
        dp.read = lambda *a, **kw: (reads.append(a), real_read(*a, **kw))[1]
        try:
            # Idle tail: the park must not spin on the padding advance.
            msgs, end = ctrl._engine_read(0, 1, 0, None, wait_s=1.5)
            assert msgs == [] and end == 8, (msgs, end)
            assert len(reads) <= 3, (
                f"parked long-poll re-read {len(reads)}x in 1.5 s"
            )
            # Armed park: rows settling past the advance wake and serve.
            del reads[:]
            out = {}

            def park():
                out["res"] = ctrl._engine_read(0, 1, 0, None, wait_s=8.0)

            t = _threading.Thread(target=park)
            t.start()
            _time.sleep(0.4)  # parked on the padding tail
            produce(b"m1")
            t.join(timeout=8.0)
            assert not t.is_alive(), "long-poll never woke on settle"
            msgs, end = out["res"]
            assert msgs == [b"m1"] and end == 16, out["res"]
        finally:
            dp.read = real_read



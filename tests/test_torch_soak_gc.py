"""Store-GC churn x controller failover, live.

The randomized soak (test_soak_random.py) deliberately excludes GC so
its per-round loss check stays exact. This covers the combination: an
aggressively-GC'd store (tiny segments + retention cap) under kill/
restart faults. The invariant under GC is WEAKER by design — consumers
below the retention floor earliest-reset forward — so the check is:

1. every drain is an ORDERED subsequence of the acked sequence in
   first-occurrence terms (no reordering, no corruption; duplicates are
   TOLERATED — the broker is at-least-once like the reference, and a
   client retry after a mid-kill ack loss legitimately double-commits);
2. once the floor QUIESCES (no appends + equal consecutive floor
   observations), a fresh consumer's drain is a CONTIGUOUS SUFFIX of
   the acked sequence — nothing above the floor is missing.

A 10-minute 120-fault-round run of this schedule was used to validate
the semantics offline; the CI version keeps 3 rounds.

Twin of `tests/test_soak_gc.py` on the PyTorch port (CPU brokers),
slow-marked as the reference is.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

# Tier-1 runs with -m 'not slow' (ROADMAP.md): GC-churn fault soak: ~40s+ on a 1-2 core host.
pytestmark = pytest.mark.slow

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.test_torch_soak import _drain, _produce, wait_until
from tests.test_torch_soak_random import _cluster_healthy, _live_controller
from tests.torch_helpers import port_cfg
from tests.torch_port_modules import admit

admit(__name__)


def _first_occurrences(msgs):
    """Client retries after a mid-kill ack loss legitimately duplicate a
    payload (the broker has no producer idempotence; at-least-once by
    design, like the reference) — keep first occurrences so the
    ordering/suffix checks test the BROKER, not the client's retry."""
    seen: set = set()
    out = []
    for m in msgs:
        if m not in seen:
            seen.add(m)
            out.append(m)
    return out


def _floors(c):
    from ripplemq_tpu_torch.storage.segment import gc_floor

    out = {}
    for bid, b in c.brokers.items():
        d = b._store_dir
        if d is not None:
            out[bid] = gc_floor(d)
    return out


@pytest.mark.parametrize("seed", [7777])
def test_gc_churn_with_failover(seed, tmp_path):
    rng = random.Random(seed)
    config = make_config(
        n_brokers=4,
        topics=(Topic("t", 2, 3),),
        engine=port_cfg(partitions=2, replicas=3, slots=64, max_batch=8),
        standby_count=2,
        segment_bytes=4096,        # rotate constantly
        store_retention_bytes=8192,  # GC aggressively
    )
    acked = {0: [], 1: []}
    dead: set[int] = set()
    with InProcCluster(config, data_dir=tmp_path) as c:
        c.wait_for_leaders()
        assert wait_until(
            lambda: len(next(iter(c.brokers.values()))
                        .manager.current_standbys()) >= 1,
            timeout=60,
        )
        client = c.client()
        stop = threading.Event()

        def traffic(pid: int) -> None:
            i = 0
            while not stop.is_set():
                payload = b"gcf-%d-%06d" % (pid, i)
                try:
                    _produce(c, client, "t", pid, payload, dead=dead,
                             stop=stop, timeout=120.0)
                    acked[pid].append(payload)
                except AssertionError:
                    pass
                i += 1

        ts = [threading.Thread(target=traffic, args=(p,), daemon=True)
              for p in (0, 1)]
        for t in ts:
            t.start()
        # Enough traffic that segments seal and the retention cap bites.
        assert wait_until(
            lambda: sum(len(v) for v in acked.values()) >= 250, timeout=120
        )
        for rnd in range(3):
            fault = rng.choice(["kill_controller", "kill_other", "burst"])
            victim = None
            if fault == "kill_controller":
                victim = _live_controller(c, dead)
            elif fault == "kill_other":
                ctrl = _live_controller(c, dead)
                cands = [i for i in c.brokers if i not in dead and i != ctrl]
                victim = rng.choice(cands) if cands else None
            if fault == "burst":
                tgt = sum(len(v) for v in acked.values()) + 150
                assert wait_until(
                    lambda: sum(len(v) for v in acked.values()) >= tgt,
                    timeout=120,
                )
            elif victim is not None:
                dead.add(victim)
                c.kill(victim)
                time.sleep(rng.uniform(0.5, 2.0))
                c.restart(victim)
                dead.discard(victim)
            assert wait_until(lambda: _cluster_healthy(c), timeout=120), (
                f"seed {seed} round {rnd} ({fault}): never healed"
            )
            resumed = sum(len(v) for v in acked.values()) + 5
            assert wait_until(
                lambda: sum(len(v) for v in acked.values()) >= resumed,
                timeout=120,
            )
        stop.set()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()

        # Invariant 1 under live GC: ordered subsequence (first-occurrence
        # terms; duplicates tolerated — see module docstring).
        for pid in (0, 1):
            got = _drain(c, client, "t", pid, f"live-{pid}")
            sset = set(acked[pid])
            got_acked = _first_occurrences(
                m for m in got if m in sset
            )
            assert got_acked, f"p{pid}: nothing acked drained"
            idxs = [acked[pid].index(m) for m in got_acked]
            assert idxs == sorted(idxs), f"p{pid}: reordered"

        # Quiesce: no appends are flowing, so the retention floor stops
        # moving once trailing seal/GC duties finish.
        def floor_stable():
            f1 = _floors(c)
            time.sleep(0.8)
            return f1 == _floors(c)

        assert wait_until(floor_stable, timeout=60), "gc floor never quiesced"

        # Invariant 2 with the floor quiesced: a fresh consumer's drain
        # is a CONTIGUOUS SUFFIX — nothing above the floor is missing.
        for pid in (0, 1):
            got = _drain(c, client, "t", pid, f"final-{pid}")
            sset = set(acked[pid])
            got_acked = _first_occurrences(
                m for m in got if m in sset
            )
            assert got_acked, f"p{pid}: nothing acked drained post-quiesce"
            start = acked[pid].index(got_acked[0])
            tail = acked[pid][start:]
            assert got_acked == tail, (
                f"p{pid}: not a contiguous suffix "
                f"(got {len(got_acked)}, want {len(tail)}, "
                f"missing {sorted(set(tail) - set(got_acked))[:5]})"
            )

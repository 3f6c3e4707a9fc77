"""The port's DataPlane, CPU twins of the reference's
`tests/test_read_cache.py`: hot reads served from the host ring mirror
with ZERO device read dispatches, byte-identical to the device path,
store below trim after a wrap, mirror gaps falling back to the device
and healing once trim passes them, the mirror seeded by recovery, and
concurrent producers and consumers through the cache. Same scenarios and
assertions on a port plane built with `device="cpu"`."""

from __future__ import annotations

import threading
import time

from ripplemq_tpu_torch.broker.dataplane import replay_records
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore
from tests.torch_helpers import port_cfg, port_dp, read_all
from tests.torch_port_modules import admit

admit(__name__)


def _mk(cfg, **kw):
    dp = port_dp(cfg, store=MemoryRoundStore(), **kw)
    dp.start()
    for p in range(cfg.partitions):
        dp.set_leader(p, 0, 1)
    return dp


def test_hot_reads_hit_no_device_dispatch():
    cfg = port_cfg(partitions=4, slots=256, max_batch=8, read_batch=8)
    dp = _mk(cfg)
    try:
        sent = {p: [] for p in range(4)}
        for i in range(64):
            p = i % 4
            m = b"hc-%02d-%03d" % (p, i)
            sent[p].append(m)
            dp.submit_append(p, [m]).result(timeout=30)
        for p in range(4):
            assert read_all(dp, p) == sent[p]
        assert dp.read_dispatches == 0, "a hot read dispatched to device"
        assert dp.read_cache_hits > 0
        # Tail polls (offset at committed end) are host-authoritative too.
        before = dp.read_cache_hits
        msgs, nxt = dp.read(0, 10_000, replica=0)
        assert msgs == [] and nxt == 10_000
        assert dp.read_dispatches == 0 and dp.read_cache_hits == before + 1
    finally:
        dp.stop()


def test_cache_parity_with_device_path():
    cfg = port_cfg(partitions=2, slots=128, max_batch=8, read_batch=8)
    dps = [_mk(cfg), _mk(cfg, host_read_cache=False)]
    try:
        for i in range(20):
            for dp in dps:
                dp.submit_append(i % 2, [b"p-%03d-a" % i, b"p-%03d-b" % i]
                                 ).result(timeout=30)
        for limit in (None, 1, 3, 100):
            walks = []
            for dp in dps:
                got, offset, steps = [], 0, []
                while True:
                    msgs, nxt = dp.read(0, offset, replica=0,
                                        max_msgs=limit)
                    if nxt == offset:
                        break
                    got.extend(msgs)
                    steps.append((offset, nxt, len(msgs)))
                    offset = nxt
                walks.append((got, steps))
            assert walks[0] == walks[1], f"limit={limit}"
        assert dps[0].read_dispatches == 0
        assert dps[1].read_dispatches > 0
    finally:
        for dp in dps:
            dp.stop()


def test_ring_wrap_serves_store_below_trim_cache_above():
    cfg = port_cfg(partitions=1, slots=32, max_batch=8, read_batch=8)
    dp = _mk(cfg)
    try:
        sent = []
        for i in range(20):  # 160 rows through a 32-slot ring
            batch = [b"w-%03d-%d" % (i, j) for j in range(8)]
            sent.extend(batch)
            dp.submit_append(0, batch).result(timeout=30)
        assert int(dp.trim[0]) > 0, "ring never wrapped"
        assert read_all(dp, 0) == sent
        assert dp.read_dispatches == 0
    finally:
        dp.stop()


def test_mirror_gap_falls_back_to_device():
    cfg = port_cfg(partitions=1, slots=128, max_batch=8, read_batch=8)
    dp = _mk(cfg)
    try:
        sent = []
        for i in range(8):
            batch = [b"g-%03d-%d" % (i, j) for j in range(4)]
            sent.extend(batch)
            dp.submit_append(0, batch).result(timeout=30)
        # Simulate the gap: pretend rounds past row 16 never mirrored.
        with dp._lock:
            dp._cache_end[0] = 16
            dp._host_ring[0, 16:] = 0  # stale mirror bytes must not serve
        assert read_all(dp, 0) == sent
        assert dp.read_dispatches > 0, "gap reads must hit the device"
    finally:
        dp.stop()


def test_mirror_gap_heals_after_trim_passes():
    cfg = port_cfg(partitions=1, slots=128, max_batch=8, read_batch=8)
    dp = _mk(cfg)
    try:
        for i in range(4):
            dp.submit_append(
                0, [b"pre-%d-%d" % (i, j) for j in range(4)]
            ).result(timeout=30)
        with dp._lock:
            dp._cache_end[0] = 8  # simulate a resolve failure at row 8
        sent = []
        for i in range(60):
            batch = [b"heal-%03d-%d" % (i, j) for j in range(4)]
            sent.extend(batch)
            dp.submit_append(0, batch).result(timeout=30)
        with dp._lock:
            assert 0 not in dp._mirror_gap, "gap never healed"
            assert int(dp._cache_end[0]) == int(dp._log_end[0])
            trim = int(dp.trim[0])
        assert trim > 8, "test never advanced trim past the gap"
        hits0, disp0 = dp.read_cache_hits, dp.read_dispatches
        got = read_all(dp, 0, start=trim)
        assert dp.read_dispatches == disp0, "healed reads still dispatched"
        assert dp.read_cache_hits > hits0
        assert got and got == sent[-len(got):]
    finally:
        dp.stop()


def test_mirror_seeded_by_recovery():
    cfg = port_cfg(partitions=2, slots=64, max_batch=8, read_batch=8)
    store = MemoryRoundStore()
    dp = port_dp(cfg, store=store)
    dp.start()
    sent = []
    try:
        dp.set_leader(0, 0, 1)
        for i in range(6):
            batch = [b"r-%03d-%d" % (i, j) for j in range(8)]
            sent.extend(batch)
            dp.submit_append(0, batch).result(timeout=30)
    finally:
        dp.stop()
    image = replay_records(cfg, store.scan())
    dp2 = port_dp(cfg, store=MemoryRoundStore())
    dp2.install(image)
    dp2.start()
    try:
        assert read_all(dp2, 0) == sent
        assert dp2.read_dispatches == 0
    finally:
        dp2.stop()


def test_concurrent_producers_and_consumers_through_cache():
    cfg = port_cfg(partitions=4, slots=64, max_batch=8, read_batch=8)
    dp = _mk(cfg)
    sent = {p: [] for p in range(4)}
    results: dict[int, list[bytes]] = {}
    try:
        def producer(p: int) -> None:
            for i in range(30):
                batch = [b"cc-%d-%03d-%d" % (p, i, j) for j in range(4)]
                sent[p].extend(batch)
                dp.submit_append(p, batch).result(timeout=30)

        def consumer(p: int) -> None:
            got, offset = [], 0
            deadline = time.monotonic() + 60
            while len(got) < 120 and time.monotonic() < deadline:
                msgs, nxt = dp.read(p, offset, replica=0)
                if nxt == offset:
                    time.sleep(0.001)  # tail poll: producer still working
                    continue
                got.extend(msgs)
                offset = nxt
            results[p] = got

        ps = [threading.Thread(target=producer, args=(p,)) for p in range(4)]
        cs = [threading.Thread(target=consumer, args=(p,)) for p in range(4)]
        for t in ps + cs:
            t.start()
        for t in ps + cs:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in ps + cs)
        for p in range(4):
            assert results[p] == sent[p], f"partition {p} mismatch"
        assert dp.read_dispatches == 0
    finally:
        dp.stop()

"""In-memory committed-round record store.

Twin of `ripplemq_tpu/storage/memstore.py` (PyTorch port), pure Python.

Same record interface as the durable SegmentStore (append/flush/close/
scan over (rec_type, slot, base, payload) tuples) with no disk behind
it. Used by single-process clusters (tests, in-proc deployments) so the
controller-failover machinery — committed-round replication to standby
brokers and standby takeover (broker/replication.py) — works without a
data dir: a standby's copy of the stream lives in its process memory,
which is exactly the durability the reference's in-memory state machines
have (reference: mq-broker/src/main/java/metadata/raft/
PartitionStateMachine.java:26-27 — messages/offsets are JVM-heap only,
surviving broker loss through replication, not disk).
"""

from __future__ import annotations

import threading

from ripplemq_tpu_torch.obs.lockwitness import make_lock
from typing import Iterator


class MemoryRoundStore:
    """Thread-safe append-only list of committed-round records."""

    def __init__(self) -> None:
        self._records: list[tuple[int, int, int, bytes]] = []
        self._lock = make_lock("MemoryRoundStore._lock")

    def append(self, rec_type: int, slot: int, base: int,
               payload: bytes) -> bytes:
        """Append one record; the returned locator is the payload itself
        (same append→locator contract as SegmentStore.append — the
        retention read path is storage-agnostic)."""
        payload = bytes(payload)
        with self._lock:
            self._records.append((int(rec_type), int(slot), int(base),
                                  payload))
        return payload

    def flush(self) -> None:  # no durability tier to flush to
        pass

    def close(self) -> None:
        pass

    def scan(self) -> Iterator[tuple[int, int, int, bytes]]:
        """Records in write order (snapshot: safe against concurrent
        appends; records appended after the call may or may not appear)."""
        with self._lock:
            snap = list(self._records)
        return iter(snap)

    def scan_indexed(self) -> Iterator[
        tuple[int, int, int, bytes, bytes]
    ]:
        """scan() plus each record's locator (the payload bytes)."""
        for rec_type, slot, base, payload in self.scan():
            yield rec_type, slot, base, payload, payload

    def read_payload(self, locator: bytes, byte_start: int,
                     nbytes: int) -> bytes:
        return locator[byte_start : byte_start + nbytes]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

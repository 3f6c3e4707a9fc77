"""Per-partition index of committed append records in the round store.

Twin of `ripplemq_tpu/storage/logindex.py` (PyTorch port), pure Python.

The device ring (core.state) only holds the last `slots` rows per
partition; rows trimmed off the ring live on in the round store — the
log of record. This index maps (partition slot, absolute storage offset)
to the record that holds the row, so the broker can serve lagging or
newly-attached consumers from disk with one seek instead of a framing
walk (the reference never needs this path because it retains everything
in JVM heap, PartitionStateMachine.java:26-27 — and grows without bound
for it; SURVEY.md §5 long-axis scaling).

One entry per committed append round: (base, nrows, locator). `locator`
is whatever the store's append()/scan_indexed() returned — a
(segment_index, payload_offset) pair for SegmentStore, the payload bytes
for MemoryRoundStore; this module never interprets it.

Later records win, matching replay_records: a controller-failover standby
can persist a round whose base regresses below an earlier record's end
(re-covering rows whose producers were never acked), so add() drops any
entries the new record's range supersedes.
"""

from __future__ import annotations

import bisect
import threading

from ripplemq_tpu_torch.obs.lockwitness import make_lock
from typing import Any, Iterable, Optional


class LogIndex:
    """Thread-safe (slot, offset) → append-record lookup.

    Memory is bounded: each slot keeps at most `max_entries_per_slot`
    recent entries (one per committed round); older entries are dropped
    and `floor(slot)` reports the lowest still-indexed base. Readers
    below the floor fall back to a store scan (DataPlane._read_store) —
    correct, just slow, and only reachable for consumers lagging by more
    than max_entries_per_slot rounds."""

    def __init__(self, max_entries_per_slot: int = 1024) -> None:
        # slot -> parallel lists: bases (sorted ascending) and entries
        self._bases: dict[int, list[int]] = {}
        self._entries: dict[int, list[tuple[int, int, Any]]] = {}
        self._max = max(2, max_entries_per_slot)
        self._lock = make_lock("LogIndex._lock")

    def add(self, slot: int, base: int, nrows: int, locator: Any) -> None:
        """Record one committed append round. Drops previously-indexed
        entries with base >= the new base (later records win)."""
        with self._lock:
            bases = self._bases.setdefault(slot, [])
            entries = self._entries.setdefault(slot, [])
            while bases and bases[-1] >= base:
                bases.pop()
                entries.pop()
            bases.append(base)
            entries.append((base, nrows, locator))
            if len(bases) > self._max:
                del bases[: len(bases) - self._max]
                del entries[: len(entries) - self._max]

    def prune(self, drop) -> int:
        """Drop entries whose locator matches `drop(locator)` (store GC
        deleted their backing records). Returns the number dropped."""
        removed = 0
        with self._lock:
            for slot in list(self._entries):
                entries = self._entries[slot]
                keep = [e for e in entries if not drop(e[2])]
                if len(keep) != len(entries):
                    removed += len(entries) - len(keep)
                    self._entries[slot] = keep
                    self._bases[slot] = [e[0] for e in keep]
        return removed

    def floor(self, slot: int) -> Optional[int]:
        """Lowest indexed base for `slot` (None if nothing indexed).
        Offsets below this may still exist in the store — only a store
        scan can tell."""
        with self._lock:
            bases = self._bases.get(slot)
            return bases[0] if bases else None

    def load(self, records: Iterable[tuple[int, int, int, bytes, Any]],
             slot_bytes: int, rec_append: int) -> None:
        """Boot-time build from a store's scan_indexed() stream."""
        for rec_type, slot, base, payload, locator in records:
            if rec_type != rec_append:
                continue
            self.add(slot, base, len(payload) // slot_bytes, locator)

    def find(self, slot: int, offset: int) -> Optional[tuple[int, int, Any]]:
        """The entry covering `offset`, or the next entry after it (a
        consumer below the earliest retained record jumps forward — the
        same semantics as Kafka's earliest reset), or None when nothing
        at-or-after `offset` is indexed (the caller falls through to the
        device ring). Callers must check floor() first: an offset below
        the floor would otherwise "jump" over records that exist in the
        store but fell out of the bounded index."""
        with self._lock:
            bases = self._bases.get(slot)
            if not bases:
                return None
            return locate(bases, self._entries[slot], offset)


def locate(bases: list[int], entries: list[tuple[int, int, Any]],
           offset: int) -> Optional[tuple[int, int, Any]]:
    """Covering-or-next lookup over parallel sorted (bases, entries)
    lists — shared by the in-memory index and the store-scan slow path."""
    i = bisect.bisect_right(bases, offset) - 1
    if i >= 0:
        base, nrows, _ = entries[i]
        if offset < base + nrows:
            return entries[i]
        i += 1
    else:
        i = 0
    if i < len(entries):
        return entries[i]
    return None

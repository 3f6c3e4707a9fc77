"""Partition selection strategies.

The reference ships one strategy behind an interface: per-topic atomic
round-robin (mq-common/.../PartitionSelector.java:10,
RoundRobinSelector.java:14-33). Same here, plus a keyed selector (stable
hashing — the strategy Kafka users expect that the reference never got).

Twin of `ripplemq_tpu/client/selector.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import itertools
import threading

from ripplemq_tpu_torch.obs.lockwitness import make_lock
import zlib

from ripplemq_tpu_torch.metadata.models import Topic


class PartitionSelector:
    def select(self, topic: Topic, key: bytes | None = None) -> int:
        raise NotImplementedError


class RoundRobinSelector(PartitionSelector):
    """Per-topic round-robin (RoundRobinSelector.java:17-33)."""

    def __init__(self) -> None:
        self._counters: dict[str, itertools.count] = {}
        self._lock = make_lock("RoundRobinSelector._lock")

    def select(self, topic: Topic, key: bytes | None = None) -> int:
        with self._lock:
            counter = self._counters.setdefault(topic.name, itertools.count())
            return next(counter) % max(1, topic.partitions)


class KeyedSelector(PartitionSelector):
    """Stable key → partition hashing; falls back to round-robin for
    keyless messages."""

    def __init__(self) -> None:
        self._rr = RoundRobinSelector()

    def select(self, topic: Topic, key: bytes | None = None) -> int:
        if key is None:
            return self._rr.select(topic)
        return zlib.crc32(key) % max(1, topic.partitions)

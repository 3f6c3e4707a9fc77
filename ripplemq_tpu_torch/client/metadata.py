"""Client-side metadata: fetch with retries + cached manager.

Mirrors the reference pair MetadataClient (random bootstrap broker, 3
retries, 1 s backoff — mq-common/.../MetadataClient.java:34-61) and
MetadataManager (cache with periodic refresh —
MetadataManager.java:26-61, refresh cadence ProducerClientImpl.java:18).
Extends the response with the broker roster so ids resolve to advertised
addresses.

Twin of `ripplemq_tpu/client/metadata.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import dataclasses
import random
import threading

from ripplemq_tpu_torch.obs.lockwitness import make_lock
from typing import Optional

from ripplemq_tpu_torch.metadata.models import (
    BrokerInfo,
    PartitionAssignment,
    Topic,
    topics_from_wire,
)
from ripplemq_tpu_torch.wire.retry import RetryPolicy
from ripplemq_tpu_torch.wire.transport import RpcError, Transport


class MetadataError(Exception):
    pass


class MetadataManager:
    """Cached cluster view with background refresh."""

    def __init__(
        self,
        transport: Transport,
        bootstrap: list[str],
        refresh_interval_s: float = 10.0,
        fetch_retries: int = 3,
        retry_backoff_s: float = 1.0,
        rpc_timeout_s: float = 3.0,
        seed: Optional[int] = None,
        deadline_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        if not bootstrap:
            raise ValueError("need at least one bootstrap address")
        self._transport = transport
        self._bootstrap = list(bootstrap)
        self._rng = random.Random(seed)
        self._timeout = rpc_timeout_s
        # Unified retry discipline (wire/retry.py). The reference retried
        # on a fixed 1 s sleep (MetadataClient.java:34-61); this jitters
        # and backs off exponentially under an optional deadline budget.
        self._retry = retry_policy or RetryPolicy(
            max_attempts=fetch_retries,
            base_backoff_s=retry_backoff_s,
            deadline_s=deadline_s,
            rng=self._rng,
        )
        self._lock = make_lock("MetadataManager._lock")
        self._topics: dict[str, Topic] = {}
        self._brokers: dict[int, BrokerInfo] = {}
        # Follower-read routing state (meta.topics carries the lease
        # table + the controller epoch that scopes it): broker_id →
        # lease epoch. A lease from another epoch is DEAD — the server
        # re-checks per answer anyway, this just avoids pointless trips.
        self._follower_leases: dict[int, int] = {}
        self._controller_epoch: int = -1
        self._stop = threading.Event()
        self._refresh_interval = refresh_interval_s
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Initial synchronous fetch, then background refresh (the
        reference schedules the same loop at 10 s,
        ProducerClientImpl.java:44-54)."""
        self.refresh()
        self._thread = threading.Thread(
            target=self._refresh_loop, daemon=True, name="metadata-refresh"
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self._refresh_interval):
            try:
                self.refresh()
            except MetadataError:
                pass  # keep the stale cache; next cycle retries

    def refresh(self) -> None:
        """Fetch from a random bootstrap broker with retries.

        The reference redraws a fully random broker per attempt
        (MetadataClient.fetchMetadata, `:34-61`), so all retries can land
        on the same dead broker; here retries walk a shuffled PERMUTATION
        of the bootstrap list (random start, no repeats until every
        broker was tried) — a deliberate strict improvement: one live
        bootstrap broker guarantees progress when retries >= brokers."""
        order: list[str] = []
        run = self._retry.begin()
        while run.attempt():
            if not order:
                order = self._rng.sample(self._bootstrap, len(self._bootstrap))
            addr = order.pop(0)
            try:
                resp = self._transport.call(
                    addr, {"type": "meta.topics"},
                    timeout=run.clip(self._timeout),
                )
                if not resp.get("ok"):
                    raise MetadataError(f"{addr}: {resp.get('error')}")
                topics = topics_from_wire(resp["topics"])
                brokers = [BrokerInfo.from_dict(b) for b in resp.get("brokers", [])]
                leases = {
                    int(b): int(e)
                    for b, e in dict(resp.get("follower_leases") or {}).items()
                }
                with self._lock:
                    self._topics = {t.name: t for t in topics}
                    if brokers:
                        self._brokers = {b.broker_id: b for b in brokers}
                    self._follower_leases = leases
                    self._controller_epoch = int(
                        resp.get("controller_epoch", -1))
                return
            except (RpcError, MetadataError, KeyError, ValueError) as e:
                run.note(f"{type(e).__name__}: {e}")
        raise MetadataError(f"metadata fetch failed: {run.summary()}")

    # ------------------------------------------------------------- queries

    def topic(self, name: str) -> Optional[Topic]:
        with self._lock:
            return self._topics.get(name)

    def topics(self) -> list[Topic]:
        with self._lock:
            return list(self._topics.values())

    def broker_addr(self, broker_id: int) -> Optional[str]:
        with self._lock:
            b = self._brokers.get(broker_id)
            return b.address if b else None

    def follower_leases(self) -> dict[int, int]:
        """broker_id → lease epoch, CURRENT controller epoch only."""
        with self._lock:
            return {b: e for b, e in self._follower_leases.items()
                    if e == self._controller_epoch}

    def follower_addr(self) -> Optional[str]:
        """Address of a randomly chosen broker holding a current-epoch
        follower-read lease (None when none does). Random, not sticky:
        the whole point of follower reads is spreading N consumers over
        the standby set."""
        with self._lock:
            addrs = [
                self._brokers[b].address
                for b, e in self._follower_leases.items()
                if e == self._controller_epoch and b in self._brokers
            ]
        if not addrs:
            return None
        return self._rng.choice(addrs)

    def leader_addr(self, topic: str, partition_id: int) -> Optional[str]:
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                return None
            a = t.assignment_for(partition_id)
            if a is None or a.leader is None:
                return None
            b = self._brokers.get(a.leader)
            return b.address if b else None

    # ------------------------------------------- elastic-partition routing

    def generation(self, topic: str, partition_id: int) -> Optional[int]:
        """Cached reconfiguration generation of one partition — what a
        keyed produce stamps as `pgen` so a post-split broker fences it
        with `stale_partition_gen:` instead of serving stale routing."""
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                return None
            a = t.assignment_for(partition_id)
            return a.generation if a else None

    def route_key(self, topic: str, key_hash: int) -> Optional[int]:
        """The non-retired partition whose key-hash range owns
        `key_hash` (None when the topic is unknown) — the client half
        of online split/merge routing."""
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                return None
            for a in t.assignments:
                if a.state != "retired" and a.owns_key(int(key_hash)):
                    return a.partition_id
            return None

    def adopt_routing(self, topic: str, assignments: list[dict]) -> bool:
        """Install the routing payload a `stale_partition_gen:` refusal
        carried, so the refused client re-resolves FROM THE REFUSAL
        instead of spending a meta.topics round first. Generation-
        guarded per partition: a racing refusal carrying an older
        snapshot never regresses a fresher cache entry. Returns True
        when anything changed."""
        try:
            incoming = [PartitionAssignment.from_dict(d)
                        for d in assignments]
        except (KeyError, ValueError, TypeError):
            return False
        if not incoming:
            return False
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                return False
            cur = {a.partition_id: a for a in t.assignments}
            changed = False
            for a in incoming:
                old = cur.get(a.partition_id)
                if old is None or a.generation > old.generation:
                    cur[a.partition_id] = a
                    changed = True
            if not changed:
                return False
            assigns = tuple(sorted(cur.values(),
                                   key=lambda x: x.partition_id))
            self._topics[topic] = dataclasses.replace(
                t, partitions=max(t.partitions, len(assigns)),
                assignments=assigns,
            )
            return True

"""ProducerClient: produce(topic, message) against the broker cluster.

API parity with the reference's ProducerClient/Impl (reference:
mq-common/src/main/java/client/ProducerClientImpl.java:57-99): cached
metadata, round-robin partition selection, leader-directed send, close().
Upgrades: real batching (`produce_batch`), not-leader hint following,
honest address resolution (see package docstring), and IDEMPOTENT
produce (`idempotence=True`, the default): the client registers a
metadata-issued producer id once, stamps every batch with an ack-gated
per-partition sequence, and the broker's dedup table collapses replays —
a retried batch whose first attempt actually committed is acked with its
original offset instead of appending twice, including across controller
failover. The sequence only ADVANCES on an acked outcome, so every
retry of an unacked batch replays the same identity; a batch abandoned
after its sequence was put on the wire burns its range (the broker may
hold a settled entry for it — reusing the numbers for fresh payloads
would dedupe them away).

Twin of `ripplemq_tpu/client/producer.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import itertools
import threading
import zlib

from ripplemq_tpu_torch.obs.lockwitness import make_lock
import time
import uuid
from typing import Optional

from ripplemq_tpu_torch.client.metadata import MetadataError, MetadataManager
from ripplemq_tpu_torch.obs.spans import (
    NULL_SPAN,
    SpanRing,
    TraceContext,
    derive_trace_id,
    sampled,
)
from ripplemq_tpu_torch.metadata.models import RANGE_SPACE
from ripplemq_tpu_torch.client.selector import PartitionSelector, RoundRobinSelector
from ripplemq_tpu_torch.wire.retry import RetryPolicy, fatal_response_error
from ripplemq_tpu_torch.wire.transport import RpcError, TcpClient, Transport


class ProduceError(Exception):
    pass


def key_hash(key: bytes) -> int:
    """Deterministic key→range-space hash (crc32 mod RANGE_SPACE):
    stable across processes and runs, so the chaos checker can replay
    a keyed workload's routing decisions exactly."""
    return zlib.crc32(bytes(key)) % RANGE_SPACE


class ProducerClient:
    def __init__(
        self,
        bootstrap: list[str],
        transport: Optional[Transport] = None,
        selector: Optional[PartitionSelector] = None,
        metadata_refresh_s: float = 10.0,
        rpc_timeout_s: float = 5.0,
        retries: int = 3,
        retry_backoff_s: float = 0.2,
        deadline_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
        idempotence: bool = True,
        producer_name: Optional[str] = None,
        pid_refresh_s: float = 60.0,
        trace_sample_n: int = 0,
    ) -> None:
        self._transport = transport if transport is not None else TcpClient()
        self._owns_transport = transport is None
        # Idempotent-producer identity (see module docstring). The pid
        # registers LAZILY on the first produce that can reach a broker;
        # until then batches flow unstamped (at-least-once — the broker
        # still stamps the forwarded hop with its own pid). The name
        # embeds a per-instance nonce: a restarted producer's sequence
        # counters start at zero, so it must not inherit an old pid.
        self._idempotence = bool(idempotence)
        self._pid: Optional[int] = None
        self._pid_name = producer_name or f"producer/{uuid.uuid4().hex}"
        # Partition the LAST acked produce_batch landed in (the broker
        # names `routed_partition` when it forwarded a migrating-range
        # write during a split handoff; otherwise the pinned choice).
        # Chaos/bench callers read this to attribute each ack to the
        # right final log. Single-threaded-per-producer contract, like
        # the sequence counters.
        self.last_partition: Optional[int] = None
        # Session refresh: re-register (idempotent; the apply bumps the
        # replicated seen counter) at this cadence so the metadata
        # leader's pid reaper sees a live session. Keep it well under
        # the server's pid_retention_s (default 600 s); 0 disables.
        self._pid_refresh_s = float(pid_refresh_s)
        self._pid_registered_t = 0.0
        self._seq_lock = make_lock("ProducerClient._seq_lock")
        self._seqs: dict[tuple[str, int], int] = {}
        # Causal tracing (obs/spans.py): every trace_sample_n-th call
        # (deterministic on the producer name + a per-call counter)
        # opens a client.produce ROOT span whose context rides the
        # request's optional `tctx` field; 0 disables — no ring, no
        # counter tick, no clock read on the produce path. `spans` is
        # public: the assembler reads the client's half of each trace
        # here (admin.spans only covers server-side rings).
        self._trace_sample_n = int(trace_sample_n)
        self._trace_counter = itertools.count()
        self.spans: Optional[SpanRing] = (
            SpanRing(self._pid_name) if self._trace_sample_n > 0 else None
        )
        self._selector = selector or RoundRobinSelector()
        self._timeout = rpc_timeout_s
        # One retry discipline for every operation (wire/retry.py):
        # jittered exponential backoff under an optional per-call
        # deadline budget. `retries`/`retry_backoff_s` stay as the
        # simple knobs; pass `retry_policy` to control everything.
        self._retry = retry_policy or RetryPolicy(
            max_attempts=retries,
            base_backoff_s=retry_backoff_s,
            deadline_s=deadline_s,
        )
        self._meta = MetadataManager(
            self._transport,
            bootstrap,
            refresh_interval_s=metadata_refresh_s,
            rpc_timeout_s=rpc_timeout_s,
        )
        self._meta.start()

    # ------------------------------------------------------------------ API

    def produce(self, topic: str, message: bytes,
                partition: Optional[int] = None,
                key: Optional[bytes] = None) -> int:
        """Send one message; returns its assigned absolute offset."""
        return self.produce_batch(topic, [message], partition=partition,
                                  key=key)

    def produce_batch(self, topic: str, messages: list[bytes],
                      partition: Optional[int] = None,
                      key: Optional[bytes] = None) -> int:
        """Send a batch to ONE partition; returns the first assigned
        offset. The batch rides a single RPC and as few device rounds as
        its size requires (vs. the reference's one message per RPC,
        PartitionClient.java:39).

        With idempotence on, the partition choice is PINNED for the
        whole call and every retry replays the same (pid, seq): an
        attempt whose response was lost but whose round committed is
        acked as a duplicate by the broker's dedup table — the window
        that used to make retried produces at-least-once. The sequence
        range is reserved the first time it goes on the wire; a call
        abandoned after that burns its range (see module docstring).

        With a `key`, the partition is resolved by KEY-HASH RANGE
        (elastic partitions): the request carries `key_hash` plus the
        resolver's `pgen` generation stamp, so a broker whose topology
        moved on fences it with `stale_partition_gen:` — this loop then
        re-resolves from the refusal's routing payload and retries
        under the new generation. A reroute reserves a FRESH sequence
        range (the new partition is a different log; the old range is
        burnt), so a reroute straddling an unknown-outcome attempt is
        at-least-once — exactly the retried-ack contract, never worse."""
        if not messages:
            raise ValueError("empty batch")
        root = NULL_SPAN
        if self.spans is not None:
            tid = derive_trace_id(self._pid_name,
                                  next(self._trace_counter))
            if sampled(tid, self._trace_sample_n):
                # Root context: parent span id 0 marks the trace root.
                root = self.spans.span("client.produce",
                                       TraceContext(tid, 0),
                                       {"topic": topic})
        run = self._retry.begin()
        pin = partition
        khash = None if key is None else key_hash(key)
        pid = seq = None
        n = len(messages)
        while run.attempt():
            t = self._meta.topic(topic)
            if t is None:
                run.note(f"unknown topic {topic!r}")
                self._refresh_quietly()
                continue
            if khash is not None and partition is None:
                # Keyed routing re-resolves per attempt: an adopted
                # stale_partition_gen payload (or a background refresh)
                # moves the pin to the range's CURRENT owner; the dedup
                # identity is re-reserved on reroute below.
                owner = self._meta.route_key(topic, khash)
                if owner is not None and owner != pin:
                    if pin is not None:
                        seq = None  # different log: fresh identity
                    pin = owner
            if pin is None:
                # One selector advance per CALL (not per attempt): a
                # retry must replay the same partition, or the dedup
                # identity — and the at-most-once-per-partition story —
                # dissolves across attempts.
                pin = self._selector.select(t)
            addr = self._meta.leader_addr(topic, pin)
            if addr is None:
                run.note(f"no leader known for {topic}[{pin}]")
                self._refresh_quietly()
                continue
            if self._idempotence and pid is None:
                pid = self._ensure_pid(addr, run)
            if pid is not None and seq is None:
                seq = self._reserve_seq(topic, pin, n)
            # The producer NAME rides every request (pid or not): its
            # prefix before the first "/" is the tenant key the broker's
            # SLO admission controller meters (slo/admission.py) — an
            # `overloaded:` refusal is retryable, and this loop's
            # jittered exponential backoff IS the client half of the
            # shed contract (retrying flat-out would defeat it).
            req = {"type": "produce", "topic": topic, "partition": pin,
                   "messages": list(messages), "producer": self._pid_name}
            if pid is not None:
                req["pid"], req["seq"] = pid, seq
            if khash is not None:
                req["key_hash"] = khash
                gen = self._meta.generation(topic, pin)
                if gen is not None:
                    req["pgen"] = gen
            # One client.rpc span per transport ATTEMPT, and its id (not
            # the root's) rides as tctx: the broker's rpc.recv then pairs
            # with the wire round trip for the skew estimate, not with
            # the whole retry loop.
            rpc = NULL_SPAN if self.spans is None else \
                self.spans.span("client.rpc", root.ctx)
            if rpc.ctx is not None:
                req["tctx"] = rpc.ctx.wire()
            try:
                resp = self._transport.call(
                    addr, req, timeout=run.clip(self._timeout),
                )
            except RpcError as e:
                rpc.end(error=type(e).__name__)
                run.note(str(e))
                self._refresh_quietly()
                continue
            rpc.end()
            if resp.get("ok"):
                self.last_partition = int(resp.get("routed_partition", pin))
                root.end(n=n)  # duration == client-measured ack latency
                return int(resp["base_offset"])
            err = str(resp.get("error", ""))
            run.note(err)
            if err == "not_leader":
                # Follow the hint next attempt via a metadata refresh; the
                # hint's addr is also directly usable when present.
                self._refresh_quietly()
                continue
            if err.startswith("stale_partition_gen:"):
                # Generation fence: re-resolve from the refusal's
                # routing payload (no metadata round) — the next
                # attempt re-routes at the top of the loop.
                if not self._meta.adopt_routing(
                        topic, resp.get("routing") or []):
                    self._refresh_quietly()
                continue
            if fatal_response_error(err):
                raise ProduceError(err)  # terminal
        raise ProduceError(f"produce to {topic} failed: {run.summary()}")

    def _reserve_seq(self, topic: str, partition: int, n: int) -> int:
        """Reserve `n` sequence numbers for one batch (thread-safe).
        Reservation happens once per call, right before the identity
        first goes on the wire; retries replay it, abandonment burns it."""
        with self._seq_lock:
            seq = self._seqs.get((topic, partition), 0)
            self._seqs[(topic, partition)] = seq + n
        return seq

    def _ensure_pid(self, addr: str, run) -> Optional[int]:
        """Register this producer's id (once) with the metadata plane,
        then RE-register at pid_refresh_s cadence — registration of an
        existing name is the session refresh keeping the pid out of the
        reaper's idle window (ClusterConfig.pid_retention_s). None on
        initial-registration failure — the current call proceeds
        unstamped (at-least-once, the pre-idempotence contract) and the
        next call tries again; a FAILED refresh keeps the cached pid
        (best-effort: the pid stays valid until actually reaped, and a
        reaped pid only costs the dedup window, never safety)."""
        now = time.monotonic()
        if self._pid is not None:
            if (self._pid_refresh_s <= 0
                    or now - self._pid_registered_t < self._pid_refresh_s):
                return self._pid
            # Attempting a refresh: stamp the attempt BEFORE the RPC so
            # a failing metadata plane costs one extra RPC per refresh
            # WINDOW, not one per produce (the original registration's
            # never-wedge-the-produce-path rule applies to refreshes
            # too; the cached pid stays valid until actually reaped).
            self._pid_registered_t = now
        try:
            resp = self._transport.call(
                addr,
                {"type": "producer.register", "name": self._pid_name},
                timeout=run.clip(self._timeout),
            )
        except RpcError as e:
            run.note(f"pid registration: {e}")
            return self._pid
        if resp.get("ok"):
            self._pid = int(resp["pid"])
            self._pid_registered_t = now
            return self._pid
        run.note(f"pid registration: {resp.get('error')}")
        return self._pid

    def produce_batch_async(self, topic: str, messages: list[bytes],
                            partition: Optional[int] = None):
        """Pipelined produce: returns a waiter `() -> int` (first
        assigned offset). Many batches can be in flight per connection —
        frames carry request ids, so an in-flight batch costs one
        pending future, never a thread (the in-proc transport serves the
        same `call_async` surface with an inline-resolved future; no
        transport wraps a sync call in a pool thread). The waiter
        follows ONE not_leader hint with a pipelined re-send; any other
        failure raises ProduceError and the caller decides (a windowed
        sender usually just re-sends)."""
        if not messages:
            raise ValueError("empty batch")
        call_async = getattr(self._transport, "call_async", None)
        if call_async is None:  # exotic custom transport: stay sync
            resp_val = self.produce_batch(topic, messages,
                                          partition=partition)
            return lambda: resp_val
        t = self._meta.topic(topic)
        if t is None:
            raise ProduceError(f"unknown topic {topic!r}")
        pid = self._selector.select(t) if partition is None else partition
        addr = self._meta.leader_addr(topic, pid)
        if addr is None:
            raise ProduceError(f"no leader known for {topic}[{pid}]")
        req = {"type": "produce", "topic": topic, "partition": pid,
               "messages": list(messages), "producer": self._pid_name}
        if self._idempotence:
            if self._pid is None:
                # One synchronous registration RPC on the first window;
                # every later batch stamps from the cached pid. Failure
                # leaves this batch unstamped (at-least-once), same as
                # the sync path.
                self._ensure_pid(addr, self._retry.begin())
            if self._pid is not None:
                req["pid"] = self._pid
                req["seq"] = self._reserve_seq(topic, pid, len(messages))
        fut = call_async(addr, req)

        def wait() -> int:
            resp = fut.result(timeout=self._timeout)
            if not resp.get("ok") and resp.get("error") == "not_leader":
                # Leadership moved under the window: one pipelined
                # re-send at the hinted leader (refresh so later
                # batches route straight there).
                self._refresh_quietly()
                addr2 = resp.get("leader_addr") or self._meta.leader_addr(
                    topic, pid
                )
                if addr2:
                    resp = call_async(addr2, req).result(
                        timeout=self._timeout
                    )
            if not resp.get("ok"):
                raise ProduceError(str(resp.get("error", "produce failed")))
            return int(resp["base_offset"])

        return wait

    def close(self) -> None:
        self._meta.close()
        if self._owns_transport:
            self._transport.close()

    def _refresh_quietly(self) -> None:
        try:
            self._meta.refresh()
        except MetadataError:
            pass

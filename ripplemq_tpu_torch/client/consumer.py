"""ConsumerClient: consume(topic) with server-tracked offsets.

API parity with the reference's ConsumerClientImpl (reference:
mq-common/src/main/java/client/ConsumerClientImpl.java:62-117): each
consume() picks ONE partition round-robin, reads up to max_messages
(default 10 — `:21`), and with auto_commit=True (the reference's
hardwired behavior, commit at `:103-109`) immediately commits
offset + n — at-most-once delivery. auto_commit=False flips to
at-least-once: process, then call commit() yourself.

Pipelined readahead (`prefetch` > 0, needs a pipelining transport):
after each delivery the NEXT window's fetch is already in flight at an
explicit offset (the broker accepts `offset` in consume requests), so a
drain pays one round-trip of latency total instead of one per window,
and auto-commits ride the same request-id pipeline asynchronously
instead of blocking a quorum round per window. `long_poll_s` > 0 makes
empty fetches park broker-side until rows settle (tail consumers cost
one RPC per delivery, not one per poll). Both levers are opt-in and
independently A/B-able against the legacy one-RPC-per-call behavior.
Note the contract shift when prefetch is on: commits are acknowledged
ASYNCHRONOUSLY (flushed on close()/flush_commits()), so delivery runs
ahead of the committed offset — a crash between delivery and commit
flush re-delivers, i.e. prefetch trades the strict at-most-once
auto-commit for at-least-once pipelining.

Follower reads (`follower_reads=True`, needs a cluster running with the
broker-side knob on): EXPLICIT-OFFSET reads route to a standby broker
holding a current-epoch follower-read lease (meta.topics advertises the
lease table), spreading a backlog fan-out over the standby set instead
of funneling every cursor through the leader. Safety lives broker-side
(broker/follower.py: a follower only answers strictly below its
replicated settled floor, refusing with retryable `not_settled_here:`),
so the client policy is pure routing: go to a follower only when the
last window came back FULL (backlog evidence — tail polls would just
bounce off the floor), fall back to the leader on any refusal, and send
commits to the leader always. Reads with no tracked position (the first
call, or after a pipeline break) go to the leader, which owns the
server-tracked offset table.

Twin of `ripplemq_tpu/client/consumer.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import itertools
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Optional

from ripplemq_tpu_torch.client.metadata import MetadataError, MetadataManager
from ripplemq_tpu_torch.obs.spans import (
    NULL_SPAN,
    SpanRing,
    TraceContext,
    derive_trace_id,
    sampled,
)
from ripplemq_tpu_torch.client.selector import PartitionSelector, RoundRobinSelector
from ripplemq_tpu_torch.wire.retry import RetryPolicy, fatal_response_error
from ripplemq_tpu_torch.wire.transport import RpcError, TcpClient, Transport

DEFAULT_MAX_MESSAGES = 10  # ConsumerClientImpl.java:21


class ConsumeError(Exception):
    pass


class ConsumerClient:
    def __init__(
        self,
        bootstrap: list[str],
        consumer_id: str,
        transport: Optional[Transport] = None,
        selector: Optional[PartitionSelector] = None,
        auto_commit: bool = True,
        max_messages: int = DEFAULT_MAX_MESSAGES,
        metadata_refresh_s: float = 10.0,
        rpc_timeout_s: float = 5.0,
        retries: int = 3,
        retry_backoff_s: float = 0.2,
        deadline_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
        prefetch: int = 0,
        long_poll_s: float = 0.0,
        follower_reads: bool = False,
        trace_sample_n: int = 0,
    ) -> None:
        self._transport = transport if transport is not None else TcpClient()
        self._owns_transport = transport is None
        self._selector = selector or RoundRobinSelector()
        self.consumer_id = consumer_id
        self.auto_commit = auto_commit
        self.max_messages = max_messages
        self.prefetch = max(0, int(prefetch))
        self.long_poll_s = max(0.0, float(long_poll_s))
        self.follower_reads = bool(follower_reads)
        self._timeout = rpc_timeout_s
        # Follower routing's position hint: last delivered next_offset
        # per (topic, partition). Only a HINT — the leader's
        # server-tracked offset stays authoritative whenever routing
        # falls back to it.
        self._pos: dict[tuple[str, int], int] = {}
        # Routing forensics: how many deliveries a follower actually
        # served (vs leader fallback), and whether the LAST one did —
        # the chaos workload tags its history ops with this so a run's
        # verdict can say how much fan-out the follower plane absorbed.
        self.follower_served = 0
        self.last_from_follower = False
        # Per-(topic, partition) readahead state: the in-flight fetch at
        # an explicit offset, and the newest async auto-commit (kept so
        # errors surface and close() can flush).
        self._pf: dict[tuple[str, int], dict] = {}
        self._commits: dict[tuple[str, int], tuple[int, object, str]] = {}
        # Causal tracing (obs/spans.py), mirroring ProducerClient: every
        # trace_sample_n-th consume opens a client.consume root span
        # whose context rides `tctx` on the sync and follower fetches
        # (prefetched fetches were armed before this call existed, so
        # they stay unstamped). `spans` is public for the assembler.
        self._trace_sample_n = int(trace_sample_n)
        self._trace_counter = itertools.count()
        self.spans: Optional[SpanRing] = (
            SpanRing(consumer_id) if self._trace_sample_n > 0 else None
        )
        self._trace_root = NULL_SPAN  # current call's root (single-threaded)
        # Unified retry discipline (wire/retry.py): jittered exponential
        # backoff, optional per-operation deadline budget.
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

    def consume(
        self,
        topic: str,
        partition: Optional[int] = None,
        max_messages: Optional[int] = None,
    ) -> list[bytes]:
        """Read from one (round-robin-chosen) partition of `topic`."""
        msgs, _, _, _ = self.consume_with_position(topic, partition, max_messages)
        return msgs

    def consume_with_position(
        self,
        topic: str,
        partition: Optional[int] = None,
        max_messages: Optional[int] = None,
    ) -> tuple[list[bytes], int, int, int]:
        """Like consume(), also returning (messages, partition, offset,
        next_offset). Manual committers commit `next_offset` — offsets are
        STORAGE offsets (the broker pads replication rounds for the device's
        alignment), so `offset + len(messages)` is NOT a valid position."""
        limit = self.max_messages if max_messages is None else max_messages
        self.last_from_follower = False
        root = NULL_SPAN
        if self.spans is not None:
            tid = derive_trace_id(self.consumer_id,
                                  next(self._trace_counter))
            if sampled(tid, self._trace_sample_n):
                root = self.spans.span("client.consume",
                                       TraceContext(tid, 0),
                                       {"topic": topic})
        self._trace_root = root
        call_async = getattr(self._transport, "call_async", None)
        if self.prefetch > 0 and call_async is not None:
            # Pin the round-robin choice ONCE per call: the prefetch
            # probe and the sync fallback below each advancing the
            # stateful selector would desynchronize armed readahead
            # state from delivered partitions (with an even partition
            # count the two paths alternate in lockstep and some
            # partitions are never consumed at all).
            if partition is None:
                t = self._meta.topic(topic)
                if t is not None:
                    partition = self._selector.select(t)
            got = self._consume_prefetched(topic, partition, limit, call_async)
            if got is not None:
                root.end(n=len(got[0]))
                return got
        if self.follower_reads:
            if partition is None:
                # Same single-selector-advance pinning as the prefetch
                # probe above (and idempotent with it).
                t = self._meta.topic(topic)
                if t is not None:
                    partition = self._selector.select(t)
            got = self._consume_follower(topic, partition, limit, call_async)
            if got is not None:
                root.end(n=len(got[0]))
                return got
        run = self._retry.begin()
        while run.attempt():
            t = self._meta.topic(topic)
            if t is None:
                run.note(f"unknown topic {topic!r}")
                self._refresh_quietly()
                continue
            pid = self._selector.select(t) if partition is None else partition
            addr = self._meta.leader_addr(topic, pid)
            if addr is None:
                run.note(f"no leader known for {topic}[{pid}]")
                self._refresh_quietly()
                continue
            # A readahead fallback must not race its own unflushed
            # commits: the server-tracked offset lags until they apply.
            self._flush_commit_key(topic, pid)
            req = {"type": "consume", "topic": topic, "partition": pid,
                   "consumer": self.consumer_id, "max_messages": limit}
            # Per-ATTEMPT client.rpc span (its id rides as tctx): the
            # broker's rpc.recv pairs with the wire round trip for the
            # skew estimate, not with the retry loop (producer twin).
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
                msgs = list(resp["messages"])
                offset = int(resp["offset"])
                next_offset = int(resp.get("next_offset", offset))
                got = self._deliver(topic, pid, addr, limit, call_async,
                                    msgs, offset, next_offset)
                root.end(n=len(msgs))
                return got
            err = str(resp.get("error", ""))
            run.note(err)
            if err == "not_leader":
                self._refresh_quietly()
                continue
            if fatal_response_error(err):
                raise ConsumeError(err)
        raise ConsumeError(f"consume from {topic} failed: {run.summary()}")

    # ------------------------------------------------- prefetch pipeline

    def _consume_prefetched(self, topic: str, partition: Optional[int],
                            limit: int, call_async):
        """Serve one consume from the in-flight readahead fetch, if one
        is armed and healthy. Returns None to fall back to the sync
        path (which re-resolves leadership with the retry policy). The
        caller pins `partition` before calling (one selector advance
        per consume)."""
        if partition is None:
            return None  # topic unknown: the sync path resolves it
        pid = partition
        st = self._pf.pop((topic, pid), None)
        if st is None or st["limit"] != limit:
            return None
        try:
            resp = st["fut"].result(
                timeout=self._timeout + st.get("wait_s", 0.0)
            )
        except (TimeoutError, FuturesTimeoutError, RpcError, OSError):
            return None  # pipeline broken: sync path re-resolves
        if not resp.get("ok"):
            return None  # not_leader/refusal: sync path handles + retries
        msgs = list(resp["messages"])
        offset = st["offset"]
        next_offset = int(resp.get("next_offset", offset))
        if resp.get("follower"):
            self.follower_served += 1
            self.last_from_follower = True
        return self._deliver(topic, pid, st["addr"], limit, call_async,
                             msgs, offset, next_offset)

    # ---------------------------------------------------- follower reads

    def _consume_follower(self, topic: str, partition: Optional[int],
                          limit: int, call_async):
        """One explicit-offset read against a leased follower. Returns
        None (routing miss, refusal, transport error, or an empty
        answer) to fall back to the leader path — never an error: the
        leader serves everything a follower can and more."""
        if partition is None:
            return None
        pid = partition
        pos = self._pos.get((topic, pid))
        if pos is None:
            return None  # no tracked position: the leader resolves it
        addr = self._meta.follower_addr()
        if addr is None:
            return None
        # Same guard as the sync path: an explicit-offset read must not
        # race this partition's own unflushed async commit.
        self._flush_commit_key(topic, pid)
        req = {"type": "consume", "topic": topic, "partition": pid,
               "consumer": self.consumer_id, "max_messages": limit,
               "offset": int(pos), "follower_ok": True}
        rpc = NULL_SPAN if self.spans is None else \
            self.spans.span("client.rpc", self._trace_root.ctx)
        if rpc.ctx is not None:
            req["tctx"] = rpc.ctx.wire()
        try:
            resp = self._transport.call(addr, req, timeout=self._timeout)
        except RpcError:
            rpc.end(error="rpc")
            return None
        rpc.end()
        if not resp.get("ok") or not resp.get("follower"):
            return None  # not_settled_here / deposed: leader fallback
        msgs = list(resp["messages"])
        if not msgs:
            return None  # gap skip or dry window: let the leader decide
        offset = int(resp["offset"])
        next_offset = int(resp.get("next_offset", offset))
        self.follower_served += 1
        self.last_from_follower = True
        return self._deliver(topic, pid, addr, limit, call_async,
                             msgs, offset, next_offset)

    def _deliver(self, topic: str, pid: int, addr: str, limit: int,
                 call_async, msgs: list, offset: int, next_offset: int):
        """Common delivery tail: arm the next readahead fetch, run the
        auto-commit (async when prefetching), return the position tuple.
        With follower reads on, `addr` may be the follower that just
        served — commits always re-resolve the LEADER (offset state is
        a quorum-replicated fact only the leader accepts)."""
        commit_addr = addr
        if self.follower_reads:
            self._pos[(topic, pid)] = int(next_offset)
            commit_addr = self._meta.leader_addr(topic, pid) or addr
        if self.prefetch > 0 and call_async is not None:
            # Re-arm at next_offset. After an EMPTY window only a
            # long-polling fetch is worth keeping in flight (a plain one
            # would answer empty again immediately; drains break on
            # empty anyway).
            if msgs or self.long_poll_s > 0:
                wait_s = self.long_poll_s if not msgs else 0.0
                req = {"type": "consume", "topic": topic, "partition": pid,
                       "consumer": self.consumer_id, "max_messages": limit,
                       "offset": int(next_offset)}
                if wait_s > 0:
                    req["wait_s"] = wait_s
                fetch_addr = commit_addr
                # Route the readahead to a leased follower only on
                # backlog evidence (a FULL window just came back) and
                # never for a long-poll park — tail reads sit above the
                # follower's floor by definition and would only bounce.
                if (self.follower_reads and wait_s == 0.0
                        and len(msgs) >= limit):
                    fa = self._meta.follower_addr()
                    if fa is not None:
                        fetch_addr = fa
                        req["follower_ok"] = True
                try:
                    fut = call_async(fetch_addr, req)
                    self._pf[(topic, pid)] = {
                        "offset": int(next_offset), "fut": fut,
                        "addr": fetch_addr, "limit": limit, "wait_s": wait_s,
                    }
                except RpcError:
                    pass  # connection hiccup: next call goes sync
        if msgs and self.auto_commit:
            self._auto_commit(topic, pid, next_offset, commit_addr,
                              call_async)
        return msgs, pid, offset, next_offset

    def _auto_commit(self, topic: str, pid: int, offset: int, addr: str,
                     call_async) -> None:
        if self.prefetch <= 0 or call_async is None:
            self.commit(topic, pid, offset)  # strict: ack before deliver
            return
        # Pipelined commit, at most ONE in flight per (consumer,
        # partition). The broker serves a connection's frames on a worker
        # pool, so two commits in flight for one partition may apply in
        # either order and leave the OLDER offset committed (the
        # reference's client keeps several in flight and can end on a
        # stale offset: a reader that restarts re-reads rows it already
        # delivered). So a newer commit goes out only once the previous
        # one answered; a failed one is re-driven synchronously first,
        # so errors never silently drop the committed position. Reads
        # stay pipelined: the readahead fetch is already in flight.
        self._flush_commit_key(topic, pid)
        try:
            fut = call_async(addr, {
                "type": "offset.commit", "topic": topic, "partition": pid,
                "consumer": self.consumer_id, "offset": int(offset),
            })
        except RpcError:
            self.commit(topic, pid, offset)  # sync fallback w/ retries
            return
        self._commits[(topic, pid)] = (int(offset), fut, addr)

    def _flush_commit_key(self, topic: str, pid: int) -> None:
        entry = self._commits.pop((topic, pid), None)
        if entry is None:
            return
        off, fut, _ = entry
        try:
            ok = bool(fut.result(timeout=self._timeout).get("ok"))
        except Exception:
            ok = False
        if not ok:
            self.commit(topic, pid, off)

    def flush_commits(self) -> None:
        """Drain every in-flight async auto-commit (prefetch mode),
        re-driving failures through the sync commit path. Called by
        close(); call it directly at consumer-group checkpoints."""
        for (topic, pid) in list(self._commits):
            self._flush_commit_key(topic, pid)

    # ------------------------------------------------------------- commits

    def commit(self, topic: str, partition: int, offset: int) -> None:
        """Commit an absolute offset (replicated through the partition's
        quorum round, like every offset update)."""
        run = self._retry.begin()
        while run.attempt():
            addr = self._meta.leader_addr(topic, partition)
            if addr is None:
                run.note(f"no leader known for {topic}[{partition}]")
                self._refresh_quietly()
                continue
            try:
                resp = self._transport.call(
                    addr,
                    {"type": "offset.commit", "topic": topic,
                     "partition": partition, "consumer": self.consumer_id,
                     "offset": int(offset)},
                    timeout=run.clip(self._timeout),
                )
            except RpcError as e:
                run.note(str(e))
                self._refresh_quietly()
                continue
            if resp.get("ok"):
                return
            err = str(resp.get("error", ""))
            run.note(err)
            if err == "not_leader":
                self._refresh_quietly()
                continue
            if fatal_response_error(err):
                raise ConsumeError(err)
        raise ConsumeError(
            f"offset commit {topic}[{partition}]={offset} failed: "
            f"{run.summary()}"
        )

    def close(self) -> None:
        try:
            self.flush_commits()
        except Exception:
            pass  # best-effort: close must not raise over a dead broker
        self._meta.close()
        if self._owns_transport:
            self._transport.close()

    def _refresh_quietly(self) -> None:
        try:
            self._meta.refresh()
        except MetadataError:
            pass

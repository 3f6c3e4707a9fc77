"""Causal tracing plane: cross-process span propagation + attribution.

Twin of `ripplemq_tpu/obs/spans.py` (PyTorch port), stdlib only. The
port's DataPlane emits its six round-stage spans into a `SpanRing`; the
assembler (`obs/assemble.py`) comes with a later slice.

The flight recorder (obs/trace.py) answers "what was this broker
doing"; the metrics registry answers "how fast on average". Neither
answers "where did THIS message's p99 go" — the question MegaScale
(arXiv:2402.15627) argues must be a built-in per-request capability.
This module is that capability for ripplemq: a trace CONTEXT (trace id
+ parent span id) stamped by the client on a sampled produce/consume,
carried as an optional `tctx` field in the ordinary request dicts on
both transports, and recorded by every layer that touches the request
into a per-process lock-cheap span ring.

Design rules, in priority order:

1. **No wall clocks.** Span timestamps are `time.perf_counter()` —
   monotonic, and the SAME clock the metrics plane stamps the engine's
   round-stage boundaries with, so the six settle-stage spans can reuse
   the round ctx timestamps verbatim — in the RECORDING process's clock
   domain; nothing ever compares timestamps from two processes
   directly. The assembler (obs/assemble.py)
   estimates per-process offsets NTP-style from matched parent/child
   RPC span pairs (request midpoint vs. serve midpoint) and maps every
   span into the root's domain before ordering anything. The chaos
   timeline learned this lesson the hard way: proc-backend wall clocks
   skew, and a skewed sort interleaves causally-ordered events
   backwards.
2. **Zero overhead when off.** Sampling is decided by the CLIENT
   (deterministically — see below); an unsampled request simply has no
   `tctx` key, and every server-side emit site goes through
   `ring.span(kind, ctx)` which returns the singleton `NULL_SPAN`
   without reading a clock or allocating when `ctx is None`. The
   `obs=False` / `trace_sample_n=0` path is therefore a dict-get plus
   one `is None` branch per hop.
3. **Deterministic sampling.** `trace_id = crc32(name) ⊕ mix(counter)`
   and the sampling predicate is `trace_id % trace_sample_n == 0` —
   same seed, same sampled set, no ambient randomness (the chaos
   schedules and the determinism lint stay pure).

Ring mechanics follow the flight recorder exactly: one atomic
`itertools.count` tick assigns the slot, stores are single reference
assignments (wait-free against each other, racy-consistent reads), and
spans are recorded AT END — a span that never ends (crashed process)
is simply absent, which the assembler treats as a partial trace, not
an error.

Span ids are globally unique without coordination: the top 31 bits are
crc32 of the ring's process label, the bottom 32 the local sequence.
Two processes can therefore parent each other's spans with nothing but
the integer that rode the wire.

The span-kind vocabulary (`SPAN_KINDS`) is CLOSED, like the flight
recorder's event vocabulary, and machine-checked by the same ripplelint
rule (analysis/trace_vocab.py): every `*.span("<kind>", ...)` emit site
must name a member, every member must have a live emit site, and every
member is documented in the README "Causal tracing" section.
"""

from __future__ import annotations

import itertools
import time
import zlib
from typing import Callable, Optional

_DEFAULT_SLOTS = 2048

# The CLOSED span-kind vocabulary — one name per distinct hop a sampled
# message can take. Checked by ripplelint trace_vocab (emit sites ↔
# vocabulary ↔ README "Causal tracing" section).
SPAN_KINDS = frozenset({
    # Client SDK roots (client/producer.py, client/consumer.py): the
    # whole sampled call, ack latency == duration. client.rpc is one
    # transport attempt inside the call (the requesting half of the
    # client↔broker skew pair — it parents the broker's rpc.recv, so
    # the pairing measures the wire round trip, not the retry loop's
    # bookkeeping; a retried call records one per attempt).
    "client.produce", "client.consume", "client.rpc",
    # Broker RPC surface: one span per inbound request that carried a
    # tctx (produce, consume, engine.append forward, ...). `op` field
    # names the request type. Pairs with its client/forwarder parent
    # for the cross-process skew estimate.
    "rpc.recv",
    # SLO admission decision on the produce front door.
    "admission",
    # Multi-core host plane: broker-side shm-ring round trip
    # (worker.hop) and the worker-subprocess side (worker.serve covers
    # the op; validate/stamp/pack are its children). hop/serve pair for
    # the worker-process skew estimate.
    "worker.hop", "worker.serve",
    "worker.validate", "worker.stamp", "worker.pack",
    # Engine round lifecycle, attributed to the sampled round: the
    # round-stage boundaries as spans (broker/dataplane.py emits all six
    # at settle release from the round ctx timestamps).
    "engine.dispatch", "settle.commit_wait", "settle.enter_wait",
    "settle.standby_ack", "settle.persist", "settle.release",
    # Replication fan-out: sender-side frame round trip and the
    # standby's apply+ack (full-copy and striped planes).
    "repl.send", "repl.apply", "stripe.send", "stripe.apply",
    # Follower reads: serve from replicated bytes, including a
    # stripe-reconstruct-on-read when the local copy is a stripe set.
    "follower.serve", "stripe.reconstruct",
    # Metadata plane: one coalesced control-plane wave, and an elastic
    # split/merge cutover.
    "meta.wave", "meta.cutover",
})


def derive_trace_id(name: str, counter: int) -> int:
    """Deterministic 63-bit trace id from a stable name (producer /
    consumer identity, or an op identity like "wave/broker0") and a
    per-name counter. splitmix-style finalizer so consecutive counters
    land uniformly across the sampling residues."""
    x = (zlib.crc32(name.encode()) << 32) ^ (counter & 0xFFFFFFFF)
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0x7FFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0x7FFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF


def sampled(trace_id: int, sample_n: int) -> bool:
    """The deterministic sampling predicate: every `sample_n`-th trace
    id residue is sampled; 0 (or negative) disables sampling."""
    return sample_n > 0 and trace_id % sample_n == 0


class TraceContext:
    """The propagated half of a span: (trace id, parent span id).
    Wire form is the 2-list `[trace_id, span_id]` under the optional
    `tctx` request key — wire-primitive on both transports, absent
    entirely when unsampled."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int) -> None:
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)

    def wire(self) -> list[int]:
        return [self.trace_id, self.span_id]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id:#x}, {self.span_id:#x})"


def ctx_from_wire(raw) -> Optional[TraceContext]:
    """Parse an inbound `tctx` field; None (not an error) on anything
    malformed — a bad context degrades to an unsampled request, never
    a refused one."""
    if (isinstance(raw, (list, tuple)) and len(raw) == 2
            and all(isinstance(v, int) for v in raw)):
        return TraceContext(raw[0], raw[1])
    return None


class Span:
    """One open span: `end()` computes the duration and stores the
    record in the ring; `ctx` is the context CHILDREN of this span
    propagate (trace id + THIS span's id). Usable as a context manager.
    Fields passed to `end` must stay wire-primitive (admin.spans serves
    records verbatim)."""

    __slots__ = ("_ring", "kind", "ctx", "parent", "t0", "_fields")

    def __init__(self, ring: "SpanRing", kind: str, ctx: TraceContext,
                 parent: int, t0: float, fields: Optional[dict]) -> None:
        self._ring = ring
        self.kind = kind
        self.ctx = ctx
        self.parent = parent
        self.t0 = t0
        self._fields = fields

    def end(self, **fields) -> None:
        if fields:
            merged = dict(self._fields or ())
            merged.update(fields)
        else:
            merged = self._fields
        self._ring._store(self.kind, self.ctx, self.parent, self.t0,
                          self._ring.clock() - self.t0, merged)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """The unsampled twin: a singleton with the Span surface and no
    behavior. `ctx` is None, so a hop that threads `span.ctx` onward
    propagates "unsampled" for free."""

    __slots__ = ()
    kind = ""
    ctx = None
    t0 = 0.0

    def end(self, **fields) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class SpanRing:
    """Per-process span ring (one per broker, one per host worker, one
    per tracing client). Lock-cheap like the flight recorder: slot via
    atomic counter, single-reference stores, racy-consistent snapshot."""

    def __init__(self, proc: str, capacity: int = _DEFAULT_SLOTS,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.proc = str(proc)
        self._cap = max(16, int(capacity))
        self._buf: list = [None] * self._cap
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        # 31 bits of proc hash (not 32: ids must stay inside the wire
        # codec's signed-64 range) over 32 bits of local sequence.
        self._id_base = (zlib.crc32(self.proc.encode()) & 0x7FFFFFFF) << 32
        self.clock: Callable[[], float] = (
            clock if clock is not None else time.perf_counter
        )

    # ------------------------------------------------------------ emit

    def span(self, kind: str, ctx: Optional[TraceContext],
             fields: Optional[dict] = None) -> Span:
        """Open a span under `ctx`. THE hot-path entry: `ctx is None`
        (unsampled request) returns the NULL_SPAN singleton without a
        clock read or any allocation."""
        if ctx is None:
            return NULL_SPAN
        child = TraceContext(ctx.trace_id, self._id_base | next(self._ids))
        return Span(self, kind, child, ctx.span_id, self.clock(), fields)

    def span_at(self, kind: str, ctx: Optional[TraceContext],
                t0: float, dur_s: float,
                fields: Optional[dict] = None) -> Optional[TraceContext]:
        """Record a span from timestamps measured elsewhere in THIS
        process's monotonic domain (the engine's round ctx stamps its
        stage boundaries itself). Returns the recorded span's context
        (for parenting follow-on stages), None when unsampled."""
        if ctx is None:
            return None
        child = TraceContext(ctx.trace_id, self._id_base | next(self._ids))
        self._store(kind, child, ctx.span_id, t0, dur_s, fields)
        return child

    def _store(self, kind: str, ctx: TraceContext, parent: int, t0: float,
               dur_s: float, fields: Optional[dict]) -> None:
        seq = next(self._seq)  # atomic slot assignment
        self._buf[seq % self._cap] = (
            seq, kind, ctx.trace_id, ctx.span_id, parent, t0,
            max(0, int(dur_s * 1e6)), self.proc, fields,
        )

    def ingest(self, records: list[dict]) -> None:
        """Adopt already-built span records from another process (the
        host workers ship theirs back inside the existing shm-ring
        response frames; the broker ring is the one admin.spans serves).
        Records keep their ORIGIN proc label and clock domain."""
        for r in records:
            try:
                seq = next(self._seq)
                self._buf[seq % self._cap] = (
                    seq, str(r["kind"]), int(r["trace"]), int(r["span"]),
                    int(r["parent"]), float(r["t0"]), int(r["dur_us"]),
                    str(r["proc"]),
                    {k: v for k, v in r.items()
                     if k not in ("seq", "kind", "trace", "span", "parent",
                                  "t0", "dur_us", "proc")} or None,
                )
            except (KeyError, TypeError, ValueError):
                continue  # a malformed record is dropped, never fatal

    # ------------------------------------------------------------ read

    def snapshot(self, after: int = -1,
                 max_spans: Optional[int] = None) -> list[dict]:
        """The ring's live window in seq order, clipped to seq > `after`
        and at most `max_spans` records — the paging contract behind
        admin.spans (cursor = last record's `seq`). Wire-encodable;
        parent ids live in each record's span context fields."""
        entries = [e for e in self._buf if e is not None and e[0] > after]
        entries.sort(key=lambda e: e[0])
        if max_spans is not None and max_spans >= 0:
            entries = entries[:max_spans]
        out = []
        for seq, kind, trace, span, parent, t0, dur_us, proc, fields \
                in entries:
            rec = dict(fields) if fields else {}
            rec.update(seq=seq, kind=kind, trace=trace, span=span,
                       parent=parent, t0=t0, dur_us=dur_us, proc=proc)
            out.append(rec)
        return out

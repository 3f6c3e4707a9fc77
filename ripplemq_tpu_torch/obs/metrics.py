"""Lock-cheap metrics registry: counters, gauges, log-bucketed histograms.

Twin of `ripplemq_tpu/obs/metrics.py` (PyTorch port), pure Python: the
same metric objects, quantiles, snapshots and Prometheus text.

Design constraints, in order:

1. The hot path must stay plain-int python — one attribute add for a
   counter increment, one `bit_length()` bucket lookup plus two adds for
   a histogram observation. No locks on the write path: CPython's `+=`
   on an int attribute can lose an increment under thread interleaving,
   and that is ACCEPTED — these are monitoring counters read as rates
   and distributions, not accounting ledgers (the accounting counters —
   committed_entries, acks — live in their subsystems under their own
   locks). Snapshots are likewise racy-consistent: each value is read
   atomically, the set is not a point-in-time cut.
2. Histograms are FIXED log2 bins over integer microseconds (bucket i
   holds observations with `us.bit_length() == i`, i.e. [2^(i-1), 2^i)),
   so an observation is O(1) with no allocation and the full
   distribution is 40 small ints. Quantiles are read off the bucket
   upper bounds — good to a factor of 2, which is what stage-level
   latency attribution needs (is the settle stall in fsync or in the
   standby RPC?), not benchmarking precision.
3. The clock is injectable (`Metrics(clock=...)`) so timing-dependent
   tests run on a fake clock with zero real sleeps, and the overhead
   smoke can measure pure bookkeeping cost without perf_counter noise.
4. `Metrics(enabled=False)` hands out no-op metric objects with the
   same API, so instrumented code needs no `if obs:` branches and the
   A/B knob (`ClusterConfig.obs`) costs one no-op method call per site.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# 40 log2 bins over integer microseconds: bin 39 tops out past 2^39 us
# (~6.4 days) — everything above clips into the last bin.
_NBINS = 40


class Counter:
    """Monotonic count. `inc()` is one plain-int add (see module doc for
    the accepted-race contract)."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def inc(self, k: int = 1) -> None:
        self.n += k


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("v",)

    def __init__(self) -> None:
        self.v = 0

    def set(self, v) -> None:
        self.v = v


class Histogram:
    """Log2-bucketed distribution over integer microseconds (or any
    non-negative int — `observe_int` takes the value verbatim, e.g.
    group-commit sizes). `observe(seconds)` converts once."""

    __slots__ = ("bins", "count", "total", "max")

    def __init__(self) -> None:
        self.bins = [0] * _NBINS
        self.count = 0
        self.total = 0
        self.max = 0

    def observe(self, seconds: float) -> None:
        self.observe_int(int(seconds * 1e6))

    def observe_int(self, v: int) -> None:
        if v < 0:
            v = 0
        i = v.bit_length()
        self.bins[i if i < _NBINS else _NBINS - 1] += 1
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> int:
        """Upper bound (2^i) of the bucket holding the q-quantile —
        factor-of-2 resolution by construction."""
        count = self.count
        if count == 0:
            return 0
        target = q * count
        seen = 0
        for i, b in enumerate(self.bins):
            seen += b
            if seen >= target:
                return 1 << i
        return self.max

    def summary(self) -> dict:
        count = self.count
        return {
            "count": count,
            "mean": round(self.total / count, 1) if count else 0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": self.max,
        }


class _NullCounter:
    __slots__ = ()

    def inc(self, k: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()

    def set(self, v) -> None:
        pass


class _NullHistogram:
    __slots__ = ()

    def observe(self, seconds: float) -> None:
        pass

    def observe_int(self, v: int) -> None:
        pass


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class Metrics:
    """Named-metric registry. Metric OBJECTS are memoized and returned
    by reference — instrumented code resolves its metrics once (at
    construction) and the hot path touches only the object. Creation
    takes a lock (cold path); snapshot takes the same lock only to copy
    the name tables, never blocking writers (writers don't lock)."""

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.enabled = enabled
        # The stage-timing clock. perf_counter, not time.time: stage
        # deltas must not jump with wall-clock adjustments. Tests inject
        # a fake to run timing assertions with zero real sleeps. A
        # DISABLED registry's clock is a constant: every observation it
        # could feed is a no-op anyway, and the obs=False A/B arm must
        # shed the clock syscalls too, not just the bookkeeping.
        if clock is not None:
            self.clock: Callable[[], float] = clock
        elif enabled:
            self.clock = time.perf_counter
        else:
            self.clock = lambda: 0.0
        from ripplemq_tpu_torch.obs.lockwitness import make_lock

        self._lock = make_lock("Metrics._lock")
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER  # type: ignore[return-value]
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE  # type: ignore[return-value]
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM  # type: ignore[return-value]
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def snapshot(self) -> dict:
        """Wire-encodable summary: counters/gauges verbatim, histograms
        as {count, mean, p50, p90, p99, max} (all integer microseconds
        for the `*_us` stage timers)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "enabled": self.enabled,
            "counters": {k: c.n for k, c in sorted(counters.items())},
            "gauges": {k: g.v for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(histograms.items())
            },
        }


def _prom_name(name: str) -> str:
    """Registry name → Prometheus metric name: the `ripplemq_` prefix
    plus the name with every non-[a-zA-Z0-9_] collapsed to `_` (the
    registry's dotted names are not legal exposition identifiers)."""
    return "ripplemq_" + "".join(
        ch if ch.isalnum() or ch == "_" else "_" for ch in name
    )


def render_prometheus(metrics: Metrics) -> str:
    """Prometheus text exposition of a live registry — the
    admin.metrics_text surface (broker/server.py). GENERIC over the
    registry by construction: every counter renders as `<name>_total`,
    every gauge bare, every histogram as its cumulative log2 buckets
    (`le` = each bin's inclusive upper bound 2^i - 1) plus `_sum` and
    `_count` — so a metric added anywhere in the codebase shows up here
    with no schema to update, and the exposition can never drift from
    the registry (locked by tests/test_observability.py's exposition
    test the way stats_schema locks admin.stats)."""
    with metrics._lock:
        counters = sorted(metrics._counters.items())
        gauges = sorted(metrics._gauges.items())
        histograms = sorted(metrics._histograms.items())
    lines: list[str] = []
    for name, c in counters:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn}_total counter")
        lines.append(f"{pn}_total {c.n}")
    for name, g in gauges:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {g.v}")
    for name, h in histograms:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for i, b in enumerate(h.bins):
            if b == 0:
                continue  # sparse: 40 bins/metric would dominate bytes
            cum += b
            lines.append(
                f'{pn}_bucket{{le="{(1 << i) - 1}"}} {cum}'
            )
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{pn}_sum {h.total}")
        lines.append(f"{pn}_count {h.count}")
    return "\n".join(lines) + ("\n" if lines else "")

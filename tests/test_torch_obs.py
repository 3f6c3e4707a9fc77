"""The DataPlane slice's small host modules, the port against the JAX
package: the same seeded op sequences through both give equal results.

- `obs.metrics`: counters, gauges and histograms, the snapshot and the
  Prometheus text, the disabled registry, the injected clock;
- `obs.trace`: `FlightRecorder` dumps with the clock injected, ring
  wrap and `last` clipping;
- `obs.spans`: trace ids and sampling, `SpanRing` contents (span,
  span_at, ingest, paging) and `TraceContext` wire forms;
- `storage.memstore`: `MemoryRoundStore` scans, indexed scans, payload
  reads;
- `storage.logindex`: `LogIndex.find`, `floor` and `prune` answers,
  bounded and unbounded.
"""

from __future__ import annotations

import itertools
import sys

import numpy as np
import pytest

from ripplemq_tpu.obs import metrics as ref_metrics
from ripplemq_tpu.obs import spans as ref_spans
from ripplemq_tpu.obs import trace as ref_trace
from ripplemq_tpu.storage import logindex as ref_logindex
from ripplemq_tpu.storage import memstore as ref_memstore
from ripplemq_tpu_torch.obs import metrics, spans, trace
from ripplemq_tpu_torch.storage import logindex, memstore
from tests.torch_port_modules import admit

admit(__name__)


def _ticker(step=0.000137):
    """A deterministic injected clock: each call advances by `step`."""
    it = itertools.count()
    return lambda: next(it) * step


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("enabled", [True, False])
def test_metrics_snapshot_and_prometheus_match(seed, enabled):
    outs = []
    for mod in (ref_metrics, metrics):
        rng = np.random.default_rng(seed)
        m = mod.Metrics(enabled=enabled, clock=_ticker())
        names = [f"stage.{i}_us" for i in range(4)]
        for _ in range(400):
            op = int(rng.integers(0, 5))
            name = names[int(rng.integers(0, len(names)))]
            if op == 0:
                m.counter(name).inc(int(rng.integers(1, 5)))
            elif op == 1:
                m.gauge(name).set(int(rng.integers(-10, 10)))
            elif op == 2:
                m.histogram(name).observe(float(rng.exponential(0.01)))
            elif op == 3:
                m.histogram(name).observe_int(int(rng.integers(-3, 1 << 20)))
            else:
                t0 = m.clock()
                m.histogram("clock_us").observe(m.clock() - t0)
        h = m.histogram("quantiles")
        for v in rng.integers(0, 1 << 30, size=64):
            h.observe_int(int(v))
        quantiles = ([h.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)]
                     if enabled else None)  # a disabled registry's are no-ops
        outs.append((m.snapshot(), mod.render_prometheus(m), quantiles))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("capacity,last", [(16, None), (16, 5), (64, 0),
                                           (100, 40)])
def test_flight_recorder_dumps_match(capacity, last):
    dumps = []
    for mod in (ref_trace, trace):
        rng = np.random.default_rng(capacity)
        rec = mod.FlightRecorder(capacity=capacity, clock=_ticker(0.5))
        for i in range(int(rng.integers(30, 90))):
            etype = sorted(mod.EVENT_TYPES)[int(rng.integers(0, 20))]
            rec.record(etype, slot=int(rng.integers(0, 8)), i=i,
                       seq=-1 if i % 7 == 0 else i)  # `seq` field shadowed
        dumps.append(rec.snapshot(last=last))
    assert dumps[0] == dumps[1]
    assert trace.EVENT_TYPES == ref_trace.EVENT_TYPES


def test_span_ring_and_trace_context_match():
    outs = []
    for mod in (ref_spans, spans):
        rng = np.random.default_rng(7)
        ids = [mod.derive_trace_id(f"producer-{k}", c)
               for k in range(3) for c in range(50)]
        sampled = [mod.sampled(t, n) for t in ids for n in (0, 1, 3, 16)]
        ring = mod.SpanRing("broker0", capacity=32, clock=_ticker(0.001))
        root = mod.TraceContext(ids[0], 12345)
        wires = [root.wire()]
        ctx = root
        for i in range(60):
            kind = sorted(mod.SPAN_KINDS)[int(rng.integers(0, 10))]
            if i % 3 == 0:
                child = ring.span_at(kind, ctx, 0.25 * i, 0.0001 * i,
                                     {"i": i})
            else:
                sp = ring.span(kind, ctx, {"i": i})
                sp.end(extra=i) if i % 2 else sp.end()
                child = sp.ctx
            wires.append(child.wire())
            ctx = child if i % 5 else root
        assert ring.span("rpc.recv", None) is mod.NULL_SPAN
        assert ring.span_at("rpc.recv", None, 0.0, 1.0) is None
        ring.ingest([{"kind": "repl.apply", "trace": 1, "span": 2,
                      "parent": 3, "t0": 0.5, "dur_us": 9, "proc": "w1",
                      "op": "x"},
                     {"kind": "bad"}])  # malformed: dropped
        parsed = [mod.ctx_from_wire(w) for w in
                  ([1, 2], (3, 4), [1], "x", [1.0, 2], None)]
        outs.append((ids, sampled, wires, ring.snapshot(),
                     ring.snapshot(after=40, max_spans=7),
                     [None if c is None else c.wire() for c in parsed]))
    assert outs[0] == outs[1]
    assert spans.SPAN_KINDS == ref_spans.SPAN_KINDS


def _records(seed, n=60, slots=4):
    rng = np.random.default_rng(seed)
    out, end = [], [0] * slots
    for _ in range(n):
        slot = int(rng.integers(0, slots))
        rows = int(rng.integers(1, 5)) * 8
        if rng.random() < 0.15 and end[slot] > 8:  # a regressing record
            end[slot] -= 8 * int(rng.integers(1, end[slot] // 8 + 1))
        rec_type = int(rng.choice([1, 1, 1, 2, 4]))
        out.append((rec_type, slot, end[slot],
                    rng.integers(0, 256, size=rows * 16,
                                 dtype=np.uint8).tobytes()))
        if rec_type == 1:
            end[slot] += rows
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_memory_round_store_scans_match(seed):
    outs = []
    for mod in (ref_memstore, memstore):
        store = mod.MemoryRoundStore()
        locs = [store.append(*r) for r in _records(seed)]
        store.flush()
        reads = [store.read_payload(loc, 16 * k, 40)
                 for k, loc in enumerate(locs)]
        outs.append((locs, list(store.scan()), list(store.scan_indexed()),
                     reads, len(store)))
        store.close()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bound", [2, 4, sys.maxsize])
def test_log_index_answers_match(seed, bound):
    """find (covering, next, none), floor, prune and load: bounded (2 or
    4 entries a slot, the DataPlane's default is 1024) and unbounded
    (the DataPlane's store-scan slow path)."""
    recs = [r + (f"loc{i}",) for i, r in enumerate(_records(seed))]
    outs = []
    for mod in (ref_logindex, logindex):
        idx = mod.LogIndex(max_entries_per_slot=bound)
        idx.load(recs[:30], 16, 1)
        for rec_type, slot, base, payload, loc in recs[30:]:
            if rec_type == 1:
                idx.add(slot, base, len(payload) // 16, loc)
        probes = [(s, o) for s in range(5) for o in range(-4, 200, 3)]
        answers = [idx.find(s, o) for s, o in probes]
        floors = [idx.floor(s) for s in range(5)]
        dropped = idx.prune(lambda loc: int(loc[3:]) % 3 == 0)
        after = [idx.find(s, o) for s, o in probes]
        outs.append((answers, floors, dropped, after,
                     [idx.floor(s) for s in range(5)]))
    assert outs[0] == outs[1]

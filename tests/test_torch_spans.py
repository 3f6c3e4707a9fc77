"""Causal tracing plane: cross-process span propagation and
latency attribution.

obs/spans.py is the emit/propagation half (per-process monotonic span
rings, `tctx` on the wire, deterministic client-side sampling);
obs/assemble.py is the attribution half (NTP-style per-process offsets
from matched RPC span pairs, critical-path trees, coverage). These
tests lock:

- sampling determinism and the zero-overhead unsampled path,
- span round trips over BOTH transports (in-proc wire-fidelity codec
  and real TCP sockets) and the worker shm-ring hop,
- the assembler's skew correction and orphan handling on directed
  synthetic inputs,
- the ACCEPTANCE tree: a sampled produce on the PROC backend with
  host_workers=2 and striped replication must assemble into a tree
  covering >= 90% of the client-measured ack latency across >= 6
  distinct hop kinds and >= 3 process clock domains — with zero
  wall-clock comparisons anywhere in the plane.

Twin of `tests/test_spans.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import time

import pytest

from ripplemq_tpu_torch.obs.assemble import assemble
from ripplemq_tpu_torch.obs.spans import (
    NULL_SPAN,
    SPAN_KINDS,
    SpanRing,
    TraceContext,
    ctx_from_wire,
    derive_trace_id,
    sampled,
)
from tests.torch_helpers import InProcCluster, make_config
from tests.torch_port_modules import admit

admit(__name__)


def collect_broker_spans(client, addrs, page: int = 512) -> list[dict]:
    """Page every broker's admin.spans ring to exhaustion (cursor
    contract: `after` = last seq seen, stop when the cursor holds)."""
    records: list[dict] = []
    for addr in addrs:
        after = -1
        while True:
            resp = client.call(addr, {"type": "admin.spans", "after": after,
                                      "max_spans": page}, timeout=10.0)
            assert resp.get("ok"), resp
            if not resp.get("spans"):
                break
            records.extend(resp["spans"])
            if resp.get("cursor", after) == after:
                break
            after = resp["cursor"]
    return records


# ---------------------------------------------------------------- sampling


def test_sampling_is_deterministic():
    """Same identity + counter -> same trace id, no ambient randomness;
    the predicate is a pure residue check and 0 disables sampling."""
    a = derive_trace_id("producer/alpha", 7)
    assert a == derive_trace_id("producer/alpha", 7)
    assert a != derive_trace_id("producer/alpha", 8)
    assert a != derive_trace_id("producer/beta", 7)
    assert 0 <= a < 1 << 63
    ids = [derive_trace_id("producer/alpha", i) for i in range(64)]
    assert len(set(ids)) == 64
    # n=1 samples everything; n=0 nothing; n=4 a deterministic subset
    # that is the same set on every evaluation.
    assert all(sampled(t, 1) for t in ids)
    assert not any(sampled(t, 0) for t in ids)
    subset = [t for t in ids if sampled(t, 4)]
    assert subset == [t for t in ids if sampled(t, 4)]
    assert 0 < len(subset) < 64  # the finalizer spreads residues


def test_unsampled_path_is_null_and_allocation_free():
    """`ctx is None` returns the NULL_SPAN singleton — no clock read,
    no allocation, nothing stored. The measured contract behind
    'sampling off costs a dict-get per hop'."""
    import gc
    import tracemalloc

    ring = SpanRing("p")
    assert ring.span("rpc.recv", None) is NULL_SPAN
    assert ring.span("rpc.recv", None, {"op": "produce"}) is NULL_SPAN
    assert ring.span_at("engine.dispatch", None, 0.0, 1.0) is None
    NULL_SPAN.end(n=3)
    with ring.span("admission", None):
        pass
    assert ring.snapshot() == []
    # Allocation-free: warm the path, then trace a fixed-iteration loop
    # whose only body is the unsampled emit.
    loop = [None] * 1000
    ring.span("rpc.recv", None).end()
    gc.collect()
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    for _ in loop:
        ring.span("rpc.recv", None).end()
    used = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert used == 0, f"unsampled span path allocated {used} bytes"


def test_tracing_plane_reads_no_wall_clock():
    """Design rule #1, statically enforced: neither the span plane nor
    the assembler ever touches a wall clock — all cross-process
    placement goes through the NTP-style offset model."""
    import inspect

    import ripplemq_tpu_torch.obs.assemble as A
    import ripplemq_tpu_torch.obs.spans as S

    src = inspect.getsource(S) + inspect.getsource(A)
    for banned in ("time.time(", "datetime.now", "utcnow"):
        assert banned not in src, banned


# ---------------------------------------------------------------- ring


def test_span_ring_paging_and_ingest():
    ring = SpanRing("broker0", capacity=64)
    root = TraceContext(derive_trace_id("t", 0), 0)
    for i in range(5):
        ring.span("rpc.recv", root, {"op": "produce", "i": i}).end()
    page1 = ring.snapshot(after=-1, max_spans=3)
    assert len(page1) == 3
    page2 = ring.snapshot(after=page1[-1]["seq"], max_spans=100)
    assert len(page2) == 2
    assert [r["seq"] for r in page1 + page2] == sorted(
        r["seq"] for r in page1 + page2)
    assert all(r["proc"] == "broker0" for r in page1)
    assert all(r["kind"] in SPAN_KINDS for r in page1)
    # Span ids: 31-bit proc hash over 32-bit local sequence — globally
    # unique without coordination AND inside the codec's signed-64.
    spans = {r["span"] for r in page1 + page2}
    assert len(spans) == 5
    assert all(0 < s < 1 << 63 for s in spans)
    # Foreign records keep their origin proc label and clock domain.
    sink = SpanRing("broker1", capacity=64)
    sink.ingest(page1)
    sink.ingest([{"bogus": True}, {"kind": "x"}])  # dropped, not fatal
    adopted = sink.snapshot()
    assert len(adopted) == 3
    assert all(r["proc"] == "broker0" for r in adopted)
    assert adopted[0]["op"] == "produce"  # fields flatten through
    # Malformed wire contexts degrade to unsampled, never an error.
    assert ctx_from_wire([1, 2]).trace_id == 1
    assert ctx_from_wire([1]) is None
    assert ctx_from_wire("nope") is None
    assert ctx_from_wire([1.5, 2]) is None


# ---------------------------------------------------------------- assembler


def test_assembler_corrects_forced_skew_and_reports_orphans():
    """Directed synthetic trace across three 'processes': procB's clock
    domain sits 1000 s away from the root's — the midpoint pairing must
    still place its serve span inside the root window. A span whose
    parent record is gone stays an orphan (reported, never mis-placed),
    and coverage counts only the attributed intervals."""
    tid = derive_trace_id("client", 0)
    recs = [
        # Root: 10 ms client.produce in procA's domain at t0=100.
        {"seq": 0, "kind": "client.produce", "trace": tid, "span": 1,
         "parent": 0, "t0": 100.0, "dur_us": 10_000, "proc": "procA"},
        # Serve side in procB, absurd clock domain: the 8 ms rpc.recv
        # midpoint must pair onto the request midpoint.
        {"seq": 0, "kind": "rpc.recv", "trace": tid, "span": 2,
         "parent": 1, "t0": 1100.0, "dur_us": 8_000, "proc": "procB"},
        # Child within procB: same offset, no new pairing.
        {"seq": 1, "kind": "engine.dispatch", "trace": tid, "span": 3,
         "parent": 2, "t0": 1100.001, "dur_us": 2_000, "proc": "procB"},
        # Orphan: parent record lost (ring wrapped / process died).
        {"seq": 0, "kind": "repl.apply", "trace": tid, "span": 4,
         "parent": 999, "t0": 55.0, "dur_us": 1_000, "proc": "procC"},
    ]
    trees = assemble(recs)
    assert len(trees) == 1
    tree = trees[0]
    assert tree["root_kind"] == "client.produce"
    assert tree["ack_us"] == 10_000
    assert tree["orphans"] == 1
    # procB's spans landed INSIDE the root window despite the 1000 s
    # raw clock difference; the orphan has no normalized placement.
    by_kind = {r["kind"]: r for r in tree["spans"]}
    rcv = by_kind["rpc.recv"]
    assert 100.0 <= rcv["t0n"] <= 100.010
    assert abs(rcv["t0n"] - 100.001) < 0.002  # midpoint-centred
    assert by_kind["engine.dispatch"]["t0n"] is not None
    assert by_kind["repl.apply"]["t0n"] is None
    # Coverage: the 8 ms serve (and its nested dispatch) explain 80% of
    # the 10 ms ack; the orphan contributes nothing.
    assert tree["coverage"] == pytest.approx(0.8, abs=0.05)
    # Critical path starts at the root and never enters orphan procs.
    path_kinds = [p["kind"] for p in tree["critical_path"]]
    assert path_kinds[0] == "client.produce"
    assert "repl.apply" not in path_kinds
    # Duplicate records (a ring paged twice) collapse on span id.
    assert assemble(recs + recs)[0]["orphans"] == 1
    # A trace with no recognizable root still comes back, unplaced.
    headless = assemble([dict(recs[2], parent=777)])
    assert headless[0]["root_kind"] == "engine.dispatch"


# ---------------------------------------------------------------- transports


def test_spans_roundtrip_inproc_transport():
    """Sampled produce + consume over the in-proc transport (frames
    still wire-encoded for codec fidelity): tctx rides both request
    types, every touched layer records spans, admin.spans pages them
    out, and the assembled trees are rooted at the client spans."""
    from ripplemq_tpu_torch.client.consumer import ConsumerClient
    from ripplemq_tpu_torch.client.producer import ProducerClient

    with InProcCluster(make_config(3, obs=True, trace_sample_n=1)) as c:
        c.wait_for_leaders()
        prod = ProducerClient(
            [c.broker_addr(0)], transport=c.client("p"),
            trace_sample_n=1, producer_name="producer/inproc")
        cons = ConsumerClient(
            [c.broker_addr(0)], "consumer/inproc",
            transport=c.client("cx"), trace_sample_n=1)
        for i in range(3):
            prod.produce("topic1", b"m%d" % i, partition=0)
        got = []
        deadline = time.monotonic() + 30
        while len(got) < 3 and time.monotonic() < deadline:
            got += cons.consume("topic1", partition=0, max_messages=3)
        assert len(got) == 3
        records = collect_broker_spans(
            c.client("obs"), [c.broker_addr(b) for b in c.brokers])
        records += prod.spans.snapshot() + cons.spans.snapshot()
        prod.close()
        cons.close()

    kinds = {r["kind"] for r in records}
    assert {"client.produce", "client.consume", "rpc.recv", "admission",
            "engine.dispatch", "settle.release", "repl.send",
            "repl.apply"} <= kinds, kinds
    assert kinds <= SPAN_KINDS  # closed vocabulary on the live surface
    trees = assemble(records)
    produce = [t for t in trees if t["root_kind"] == "client.produce"]
    consume = [t for t in trees if t["root_kind"] == "client.consume"]
    assert len(produce) == 3 and consume
    best = max(produce, key=lambda t: t["coverage"] or 0)
    assert best["coverage"] and best["coverage"] > 0.5
    assert len(best["procs"]) >= 3  # client + leader + standby
    assert best["critical_path"][0]["kind"] == "client.produce"


def test_spans_roundtrip_tcp_transport():
    """Same contract over real TCP sockets: the 63-bit trace/span ids
    and the tctx 2-list survive the wire codec, and admin.spans serves
    the ring to a TCP client."""
    import socket

    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.client.producer import ProducerClient
    from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
    from ripplemq_tpu_torch.metadata.models import BrokerInfo, Topic
    from ripplemq_tpu_torch.wire import TcpClient
    from tests.torch_helpers import port_cfg as small_cfg

    ports = []
    for _ in range(3):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    config = ClusterConfig(
        brokers=tuple(BrokerInfo(i, "127.0.0.1", ports[i])
                      for i in range(3)),
        topics=(Topic("tspan", 1, 3),),
        engine=small_cfg(partitions=1, replicas=3),
        metadata_election_timeout_s=0.6,
        rpc_timeout_s=5.0,
        obs=True, trace_sample_n=1,
    )
    brokers = {i: BrokerServer(i, config, net=None, tick_interval_s=0.02,
                               duty_interval_s=0.05, device="cpu")
               for i in range(3)}
    client = TcpClient()
    try:
        for b in brokers.values():
            b.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            topics = brokers[0].manager.get_topics()
            if topics and all(a.leader is not None
                              for t in topics for a in t.assignments):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("no leaders over TCP")
        prod = ProducerClient([b.address for b in config.brokers],
                              transport=client, trace_sample_n=1,
                              producer_name="producer/tcp",
                              metadata_refresh_s=0.5)
        for i in range(2):
            prod.produce("tspan", b"t%d" % i, partition=0)
        records = collect_broker_spans(
            client, [b.address for b in config.brokers])
        records += prod.spans.snapshot()
    finally:
        client.close()
        for b in brokers.values():
            b.stop()

    kinds = {r["kind"] for r in records}
    assert {"client.produce", "rpc.recv", "engine.dispatch"} <= kinds
    # Ids crossed the codec intact: proc-hash-high span ids are > 2^32.
    assert all(isinstance(r["span"], int) and 0 < r["span"] < 1 << 63
               for r in records)
    assert any(r["span"] > 1 << 32 for r in records)
    trees = assemble(records)
    best = max((t for t in trees if t["root_kind"] == "client.produce"),
               key=lambda t: t["coverage"] or 0)
    assert best["coverage"] and len(best["procs"]) >= 2


def test_worker_spans_survive_shm_hop():
    """Multi-core host plane: the worker subprocess records its serve/
    validate/stamp/pack spans in ITS OWN ring and ships them back
    inside the existing shm response frames; the broker ring adopts
    them with the worker's proc label (own clock domain), and the
    assembled tree pairs worker.hop/worker.serve across the boundary."""
    import dataclasses

    from ripplemq_tpu_torch.client.producer import ProducerClient

    cfg = dataclasses.replace(
        make_config(3, obs=True, trace_sample_n=1), host_workers=2)
    with InProcCluster(cfg) as c:
        c.wait_for_leaders()
        prod = ProducerClient(
            [c.broker_addr(0)], transport=c.client("p"),
            trace_sample_n=1, producer_name="producer/shm")
        for i in range(4):
            prod.produce("topic1", b"w%d" % i, partition=0)
        records = collect_broker_spans(
            c.client("obs"), [c.broker_addr(b) for b in c.brokers])
        records += prod.spans.snapshot()
        prod.close()

    worker = [r for r in records if r["proc"].startswith("worker")]
    assert {r["kind"] for r in worker} >= {
        "worker.serve", "worker.validate", "worker.stamp", "worker.pack"}
    assert all("." in r["proc"] for r in worker)  # workerN.<os pid>
    broker_kinds = {r["kind"] for r in records
                    if r["proc"].startswith("broker")}
    assert "worker.hop" in broker_kinds
    trees = assemble(records)
    best = max((t for t in trees if t["root_kind"] == "client.produce"),
               key=lambda t: t["coverage"] or 0)
    # Three clock domains minimum: producer, broker, worker subprocess.
    assert len(best["procs"]) >= 3, best["procs"]
    assert any(p.startswith("worker") for p in best["procs"])
    assert best["orphans"] == 0, best
    # The worker spans were normalized (not orphaned): their serve span
    # sits inside the root window.
    serve = next(r for r in best["spans"] if r["kind"] == "worker.serve")
    assert serve["t0n"] is not None


# ---------------------------------------------------------------- acceptance


def test_acceptance_tree_proc_backend(tmp_path):
    """THE acceptance bar: a sampled produce on the PROC
    backend — separate broker processes over TCP, host_workers=2,
    STRIPED replication — assembles into a critical-path tree that
    explains >= 90% of the client-measured ack latency, crosses >= 6
    distinct hop kinds and >= 3 process clock domains, with zero
    orphans on the best tree. The first produce pays the device
    compile; steady-state trees carry the bar."""
    from ripplemq_tpu_torch.chaos.proc_cluster import (
        ProcCluster,
        free_ports,
        make_proc_cluster_config,
    )
    from ripplemq_tpu_torch.client.producer import ProducerClient
    from ripplemq_tpu_torch.metadata.models import Topic
    from ripplemq_tpu_torch.wire import TcpClient

    config = make_proc_cluster_config(
        free_ports(3), topics=(Topic("topic1", 1, 3),),
        metadata_election_timeout_s=0.8,
        obs=True, trace_sample_n=1, host_workers=2,
        replication="striped",
    )
    cluster = ProcCluster(config=config,
                          data_dir=str(tmp_path / "data"), device="cpu")
    cluster.start()
    client = TcpClient()
    try:
        cluster.wait_for_leaders(timeout=120.0)
        bootstrap = [b.address for b in config.brokers]
        prod = ProducerClient(bootstrap, transport=client,
                              trace_sample_n=1,
                              producer_name="producer/acceptance",
                              metadata_refresh_s=1.0)
        # Warm the produce path (first append compiles the device
        # program; retries are at-least-once).
        for attempt in range(5):
            try:
                prod.produce("topic1", b"warmup", partition=0)
                break
            except Exception:
                if attempt == 4:
                    raise
                time.sleep(2.0)
        for i in range(8):
            prod.produce("topic1", b"acc-%d" % i, partition=0)
        records = collect_broker_spans(client, bootstrap)
        records += prod.spans.snapshot()
    finally:
        client.close()
        cluster.stop()

    trees = [t for t in assemble(records)
             if t["root_kind"] == "client.produce"]
    assert len(trees) >= 8
    all_kinds = {k for t in trees for k in t["hops"]}
    assert {"stripe.send", "stripe.apply"} <= all_kinds, all_kinds
    assert {"worker.hop", "worker.serve"} <= all_kinds, all_kinds
    best = max(trees, key=lambda t: t["coverage"] or 0)
    assert best["coverage"] >= 0.90, (
        f"best tree explains only {best['coverage']:.0%} of the "
        f"client-measured ack: {best['critical_path']}")
    assert len(best["hops"]) >= 6, best["hops"]
    assert len(best["procs"]) >= 3, best["procs"]
    assert best["orphans"] == 0
    assert best["critical_path"][0]["kind"] == "client.produce"
    # Sampling is CLIENT-decided and deterministic: the same producer
    # identity re-derives the same trace ids.
    assert {t["trace"] for t in trees} >= {
        derive_trace_id("producer/acceptance", i) for i in range(9)
        if sampled(derive_trace_id("producer/acceptance", i), 1)}

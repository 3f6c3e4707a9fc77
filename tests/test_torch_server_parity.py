"""Exact differentials of the broker server and the client SDK: the port
against the JAX package, in one test process.

1. The standby handler. One seeded sequence of `repl.rounds` frames goes
   to a reference standby `BrokerServer` and to the port's (both on an
   `InProcNetwork`, each with a `data_dir`, so each holds an
   erasure-coded segment store; neither is started, so no duty or Raft
   thread interleaves). The sequence holds in-order frames, a duplicate,
   a gap past the gate's wait, a stale epoch, empty barrier frames and a
   newer epoch. The responses must be equal dict for dict, and the two
   stores' `scan()` record for record.
2. The client path. One seeded script of awaited produces (keyed, and to
   explicit partitions) goes through both packages' 3-broker
   `InProcCluster`s and their `ProducerClient`s, then both are drained
   by `ConsumerClient`s that commit offsets (auto-commit, and explicit
   commits on one partition). Every acked `(partition, offset)`, the
   consumed bytes, the committed offsets and the `meta.topics` answer
   must be equal. A second seeded script runs the same with the
   auto-commit consumer's readahead on (prefetch 2).

The tolerance is exact equality. The port's brokers run on the CPU; the
reference's on JAX's CPU backend.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_port_modules import admit

admit(__name__)

SEED = 20261017


# ------------------------------------------------------- standby handler


def _standby_pair(tmp_path):
    """(reference, port) broker 1 of a 3-broker cluster, unstarted."""
    from ripplemq_tpu.broker.server import BrokerServer as RefBroker
    from ripplemq_tpu.wire import InProcNetwork as RefNet
    from ripplemq_tpu_torch.broker.server import BrokerServer as PortBroker
    from ripplemq_tpu_torch.wire import InProcNetwork as PortNet
    from tests.broker_harness import make_config as ref_make_config
    from tests.torch_helpers import make_config as port_make_config

    ref = RefBroker(1, ref_make_config(3), net=RefNet(),
                    data_dir=str(tmp_path / "ref"))
    port = PortBroker(1, port_make_config(3), net=PortNet(),
                      data_dir=str(tmp_path / "port"), device="cpu")
    return ref, port


def _frame_script(rng: np.random.Generator) -> list:
    """The seeded sequence: ("cmd", metadata command) applies a command
    through the broker's metadata apply hook; ("rpc", request) goes to
    `dispatch`."""
    base = {s: 0 for s in range(4)}

    def records(n):
        out = []
        for _ in range(n):
            slot = int(rng.integers(0, 4))
            kind = int(rng.choice([1, 1, 1, 2, 4]))  # append/offsets/pidseq
            size = int(rng.integers(1, 96))
            out.append([kind, slot, base[slot],
                        rng.integers(0, 256, size, dtype=np.uint8).tobytes()])
            base[slot] += 8
        return out

    def frame(epoch, sseq=None, n=None, sender=0):
        req = {"type": "repl.rounds", "epoch": epoch, "sender": sender,
               "records": records(int(rng.integers(1, 6)) if n is None
                                  else n)}
        if sseq is not None:
            req["sseq"] = sseq
        return ("rpc", req)

    script = [("cmd", {"op": "set_controller", "controller": 0, "epoch": 2,
                       "standbys": [1, 2]})]
    script += [frame(2, s) for s in range(5)]           # in order
    dup = frame(2, 3)                                   # a duplicate
    script += [dup, frame(2, 5)]
    script += [frame(2, 9)]                             # gap past the wait
    script += [frame(1, 6)]                             # stale epoch
    script += [frame(2, 6, n=0), frame(2, None, n=0)]   # empty barriers
    script += [frame(2, 7), frame(2, None)]             # after the barrier
    script += [frame(3, 0), frame(3, 1)]                # newer epoch
    script += [frame(2, 8)]                             # retired epoch
    script += [("cmd", {"op": "set_controller", "controller": 0,
                        "epoch": 4, "standbys": [1, 2]})]
    script += [frame(3, 2), frame(4, 0, sender=2)]      # stale, then new
    return script


def test_standby_handler_matches_reference(tmp_path):
    ref, port = _standby_pair(tmp_path)
    try:
        script = _frame_script(np.random.default_rng(SEED))
        index = 0
        for kind, item in script:
            if kind == "cmd":
                index += 1
                ref._apply_committed(index, dict(item))
                port._apply_committed(index, dict(item))
                assert (ref.manager.current_epoch()
                        == port.manager.current_epoch())
                continue
            got_ref = ref.dispatch(dict(item))
            got_port = port.dispatch(dict(item))
            assert got_port == got_ref, (item["epoch"], item.get("sseq"))
        # the script reached every branch of the handler
        errors = [ref.dispatch(dict(item)).get("error", "")
                  for kind, item in script[-2:-1]]
        assert errors == ["stale_epoch"]
        ref._round_store.flush()
        port._round_store.flush()
        ref_recs = list(ref._round_store.scan())
        port_recs = list(port._round_store.scan())
        assert len(ref_recs) > 20
        assert [tuple(r) for r in port_recs] == [tuple(r) for r in ref_recs]
    finally:
        for b in (ref, port):
            b._round_store.close()


def test_standby_frame_script_covers_every_case():
    """The script above holds each case the gate and the fence decide:
    in order, duplicate, gap, stale epoch, empty barrier, newer epoch."""
    script = _frame_script(np.random.default_rng(SEED))
    frames = [r for k, r in script if k == "rpc"]
    sseqs = [(r["epoch"], r.get("sseq")) for r in frames]
    assert sseqs.count((2, 3)) == 2                      # duplicate
    assert (2, 9) in sseqs                               # gap
    assert (1, 6) in sseqs                               # stale
    assert any(not r["records"] for r in frames)         # barrier
    assert (3, 0) in sseqs and (4, 0) in sseqs           # newer epochs


# ------------------------------------------------------------ client path


def _client_script(rng: np.random.Generator) -> list:
    """Seeded awaited produces: (topic, payload, partition, key)."""
    out = []
    for i in range(48):
        topic = "topic1" if rng.random() < 0.7 else "topic2"
        payload = (b"m%03d-" % i) + rng.integers(
            0, 256, int(rng.integers(1, 19)), dtype=np.uint8).tobytes()
        if rng.random() < 0.5:
            key = b"k%d" % int(rng.integers(0, 6))
            out.append((topic, payload, None, key))
        else:
            parts = 2 if topic == "topic1" else 1
            out.append((topic, payload, int(rng.integers(0, parts)), None))
    return out


def _drive_clients(cluster, script, client_mod, prefetch=0):
    """Produce the script, then consume every partition to its end with
    commits (`prefetch`: the auto-commit consumer's readahead); returns
    what the differential compares."""
    ProducerClient = client_mod.ProducerClient
    ConsumerClient = client_mod.ConsumerClient
    cluster.wait_for_leaders()
    boot = [b.address for b in cluster.config.brokers]
    prod = ProducerClient(boot, transport=cluster.client("parity-p"))
    acked = []
    try:
        for topic, payload, partition, key in script:
            off = prod.produce(topic, payload, partition=partition, key=key)
            acked.append((topic, prod.last_partition, off))
    finally:
        prod.close()
    consumed = {}
    committed = {}
    cons = ConsumerClient(boot, "parity-c", transport=cluster.client("pc"),
                          max_messages=5, prefetch=prefetch)
    manual = ConsumerClient(boot, "parity-m", transport=cluster.client("pm"),
                            auto_commit=False, max_messages=3)
    try:
        for topic, parts in (("topic1", 2), ("topic2", 1)):
            for p in range(parts):
                got = []
                for _ in range(64):
                    msgs = cons.consume(topic, partition=p)
                    if not msgs:
                        break
                    got.extend(msgs)
                consumed[(topic, p)] = got
                # explicit commits, three messages at a time
                for _ in range(2):
                    msgs, pp, off, nxt = manual.consume_with_position(
                        topic, partition=p)
                    if msgs:
                        manual.commit(topic, pp, nxt)
        cons.flush_commits()
        probe_a = ConsumerClient(boot, "parity-c",
                                 transport=cluster.client("qa"))
        probe_m = ConsumerClient(boot, "parity-m",
                                 transport=cluster.client("qm"),
                                 auto_commit=False)
        try:
            for topic, parts in (("topic1", 2), ("topic2", 1)):
                for p in range(parts):
                    for name, probe in (("auto", probe_a),
                                        ("manual", probe_m)):
                        _, _, off, _ = probe.consume_with_position(
                            topic, partition=p, max_messages=0)
                        committed[(name, topic, p)] = off
        finally:
            probe_a.close()
            probe_m.close()
    finally:
        cons.close()
        manual.close()
    topics = cluster.client("meta").call(
        cluster.broker_addr(0), {"type": "meta.topics"}, timeout=10.0)
    return acked, consumed, committed, topics


def _topics_view(resp):
    """The `meta.topics` answer without the field naming the broker that
    served it (each cluster's own id space; both serve from broker 0)."""
    return {k: v for k, v in resp.items() if k != "broker"}


def _both_packages(script, prefetch=0):
    import ripplemq_tpu.client as ref_client
    import ripplemq_tpu_torch.client as port_client
    from tests.broker_harness import InProcCluster as RefCluster
    from tests.broker_harness import make_config as ref_make_config
    from tests.torch_helpers import InProcCluster as PortCluster
    from tests.torch_helpers import make_config as port_make_config

    with RefCluster(ref_make_config(3)) as ref:
        got_ref = _drive_clients(ref, script, ref_client, prefetch)
    with PortCluster(port_make_config(3)) as port:
        got_port = _drive_clients(port, script, port_client, prefetch)
    return got_ref, got_port


def test_client_path_matches_reference(tmp_path):
    script = _client_script(np.random.default_rng(SEED))
    got_ref, got_port = _both_packages(script)
    acked_ref, consumed_ref, committed_ref, topics_ref = got_ref
    acked_port, consumed_port, committed_port, topics_port = got_port
    assert acked_port == acked_ref
    assert consumed_port == consumed_ref
    assert committed_port == committed_ref
    assert all(isinstance(v, int) and v > 0 for v in committed_port.values())
    assert topics_ref["ok"] and topics_port["ok"]
    assert _topics_view(topics_port) == _topics_view(topics_ref)
    # every acked message was consumed exactly once, byte-exact
    sent = sorted(p for _, p, _, _ in script)
    assert sorted(m for ms in consumed_port.values() for m in ms) == sent


def test_client_path_with_prefetch_matches_reference(tmp_path):
    """The same script with the auto-commit consumer's readahead on
    (prefetch 2), the path where the port's `_auto_commit` differs from
    the reference's: the port sends a partition's next commit only once
    the previous one answered, the reference keeps several in flight.
    The in-process network answers each call before it returns (a
    resolved future), so no two commits are ever in flight here and both
    packages must agree exactly. They differ only where a transport
    keeps commits in flight and the broker applies them out of order
    (`test_torch_client.py::test_pipelined_auto_commits_keep_one_in_flight_per_partition`)."""
    script = _client_script(np.random.default_rng(SEED + 2))
    got_ref, got_port = _both_packages(script, prefetch=2)
    assert got_port[0] == got_ref[0]                 # acked
    assert got_port[1] == got_ref[1]                 # consumed bytes
    assert got_port[2] == got_ref[2]                 # committed offsets
    assert _topics_view(got_port[3]) == _topics_view(got_ref[3])
    sent = sorted(p for _, p, _, _ in script)
    assert sorted(m for ms in got_port[1].values() for m in ms) == sent
    assert all(v > 0 for v in got_port[2].values())
    assert {(t, p) for _, t, p in got_port[2]} == set(got_port[1])


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_client_script_mixes_keyed_and_explicit(seed):
    script = _client_script(np.random.default_rng(seed))
    assert any(k is not None for _, _, _, k in script)
    assert any(p is not None for _, _, p, _ in script)
    assert {t for t, _, _, _ in script} == {"topic1", "topic2"}

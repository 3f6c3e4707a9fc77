"""Host-edge cost decomposition for the e2e produce/consume paths.

Measures each component of one produce ack and one consume round trip
on the SAME topology as the reference bench's e2e run
(`e2e_raw_config`: 3 brokers over real loopback TCP, topic "bench" of
1024 partitions at RF 3, the engine 1024 x 3, B 512) and prints one
JSON object.

Decomposed terms (all per 256-message batch, the e2e unit of work):
- codec encode/decode of the produce request (the client edge),
- the socket+framing round trip alone (tiny error-path request),
- pack_payload_rows (host packing into the [B, SB] device layout),
- DataPlane.submit_append end-to-end (batcher coalesce + device round +
  store + standby stream), which with the socket edge composes the full
  produce RPC (also measured directly),
- the mirror read, the consume RPC, and the offset-commit RPC (which
  rides a quorum round by design — offsets are replicated state).

Run: python -m ripplemq_tpu_torch.profiles.host_edge      (on the GPU)
     python -m ripplemq_tpu_torch.profiles.host_edge --host-workers 2
        # boot the multi-core host plane (parallel/hostplane.py) and
        # add the worker-hop terms: the shared-memory ring round trip
        # (validate + stamp + pack in the worker subprocess) and the
        # produce RPC measured THROUGH the worker path.
     python -m ripplemq_tpu_torch.profiles.host_edge --device cpu

Twin of the reference's `profiles/host_edge.py`: the same keys, each
measured the same way (`_t`: the median of n calls after 3 warm-ups;
`_ok`: every timed RPC must succeed). The controller's plane runs on
CUDA unless `--device cpu` is given; without a GPU the tool raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

# The e2e topology lives in the port's bench (one copy; the decomposition
# must measure the shape the bench runs).
from ripplemq_tpu_torch.bench import e2e_raw_config


def _t(fn, n: int, *, warmup: int = 3) -> float:
    """Median-of-n wall time per call, in milliseconds."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts) * 1e3)


def _ok(resp: dict) -> dict:
    """Timed RPCs must measure the REAL path: a refusal (e.g. a
    not-yet-settled leadership) answers in ~0.1 ms and would silently
    median into the table as if it were the full round."""
    assert resp.get("ok"), resp
    return resp


def measure(raw: dict, device: str | None, data_dir: str) -> dict:
    """Boot the topology `raw` (every broker in this process, over
    loopback TCP, the brokers' stores under `data_dir`), time every
    term, stop the brokers, and return the terms by the reference's
    names (ms, median of n)."""
    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.core.encode import pack_payload_rows
    from ripplemq_tpu_torch.metadata.cluster_config import (
        parse_cluster_config,
    )
    from ripplemq_tpu_torch.wire import codec
    from ripplemq_tpu_torch.wire.transport import TcpClient

    payloads = [b"edge-%08d|" % i + b"x" * 86 for i in range(256)]
    produce_req = {"type": "produce", "topic": "bench", "partition": 0,
                   "messages": payloads}
    config = parse_cluster_config(raw)
    addr = f"{config.brokers[0].host}:{config.brokers[0].port}"
    brokers = []
    out: dict = {}
    client = TcpClient()
    try:
        for b in config.brokers:
            broker = BrokerServer(
                b.broker_id, config, net=None, device=device,
                data_dir=os.path.join(data_dir, f"d{b.broker_id}"))
            broker.start()
            brokers.append(broker)
        controller = brokers[0]
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            r = client.call(addr, {"type": "meta.topics"}, timeout=5.0)
            t = r.get("topics", [])
            if (r.get("ok") and t
                    and all(a["leader"] is not None
                            for a in t[0]["assignments"])):
                break
            time.sleep(0.5)
        else:
            raise AssertionError("cluster never elected leaders")
        dp = controller.dataplane
        dp.warm(buckets=dp.all_buckets())

        # --- client edge -------------------------------------------------
        enc = codec.encode(produce_req)
        out["codec_encode_produce256_ms"] = _t(
            lambda: codec.encode(produce_req), 40)
        out["codec_decode_produce256_ms"] = _t(
            lambda: codec.decode(enc), 40)
        out["produce256_wire_bytes"] = len(enc)
        # Socket + framing + dispatch-miss alone: an unknown type returns
        # a small error dict without touching the data plane.
        out["socket_rtt_small_ms"] = _t(
            lambda: client.call(addr, {"type": "edge.probe"}, timeout=10.0),
            40)  # error-path reply BY DESIGN: times the socket edge alone

        # --- host packing + engine round ---------------------------------
        cfg = dp.cfg
        out["pack_payload_rows256_ms"] = _t(
            lambda: pack_payload_rows(cfg, payloads), 40)
        out["submit_append256_ms"] = _t(
            lambda: dp.submit_append(0, payloads).result(timeout=60), 24)
        out["submit_append1_ms"] = _t(
            lambda: dp.submit_append(0, [payloads[0]]).result(timeout=60), 24)

        # --- full produce RPC (socket + codec + dispatch + engine) -------
        # With host workers this path runs THROUGH a worker: the ring
        # round trip (validate + stamp + pack in the subprocess) and
        # submit_packed, so the delta against one worker prices the hop
        # the multi-core plane adds to one serial ack.
        out["produce_rpc256_ms"] = _t(
            lambda: _ok(client.call(addr, produce_req, timeout=60.0)), 24)
        if controller.hostplane is not None:
            out["host_workers"] = raw["host_workers"]
            # The worker hop alone: the shared-memory ring round trip
            # carrying the batch out and the packed row block back.
            out["worker_submit256_ms"] = _t(
                lambda: controller.hostplane.submit(0, payloads), 40)

        # --- consume side -------------------------------------------------
        reg = client.call(addr, {"type": "consume", "topic": "bench",
                                 "partition": 0, "consumer": "edge",
                                 "max_messages": 0}, timeout=30.0)
        assert reg["ok"], reg
        # Measure the HOT (host-mirror) read path: the produces above
        # pushed partition 0 past its ring and raised trim, so an offset-0
        # read would take the STORE path. Park the consumer one window
        # below the log end — mirror-resident by construction — and read
        # there. The trim is read through the plane's locked snapshot.
        tail = max(0, dp.log_end(0) - 256)
        trim = dp.slot_detail([0])["0"]["trim"]
        assert tail >= trim, "tail window fell below trim"
        cm = client.call(addr, {"type": "offset.commit", "topic": "bench",
                                "partition": 0, "consumer": "edge",
                                "offset": tail}, timeout=60.0)
        assert cm["ok"], cm
        out["mirror_read256_ms"] = _t(lambda: dp.read(0, tail, replica=0), 40)
        out["consume_rpc256_ms"] = _t(
            lambda: _ok(client.call(
                addr, {"type": "consume", "topic": "bench", "partition": 0,
                       "consumer": "edge", "max_messages": 256},
                timeout=30.0)),
            24)
        out["offset_commit_rpc_ms"] = _t(
            lambda: _ok(client.call(
                addr, {"type": "offset.commit", "topic": "bench",
                       "partition": 0, "consumer": "edge", "offset": 1},
                timeout=60.0)),
            24)
        out["submit_offsets_direct_ms"] = _t(
            lambda: dp.submit_offsets(0, [(0, 1)]).result(timeout=60), 24)
    finally:
        client.close()
        for b in brokers:
            b.stop()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host-workers", type=int, default=1,
                    help="boot the multi-core host plane and add the "
                         "worker-hop terms to the decomposition")
    ap.add_argument("--device", default=None,
                    help="torch device for the brokers' device work "
                         "(default CUDA; 'cpu' runs it on the CPU)")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports

    raw = e2e_raw_config(free_ports(3), host_workers=args.host_workers)
    tmp = tempfile.mkdtemp(prefix="rmq-edge-")
    try:
        out = measure(raw, args.device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Produce load generator: windowed pipelined producers over TCP.

The measurement client for the end-to-end bench (bench.py `_run_e2e`):
every message is FRESH and DISTINCT (tag + thread + sequence embedded,
padded to --payload-bytes), streamed through the real client SDK →
TCP transport → broker dispatch → DataPlane batcher → device rounds.
Nothing here touches engine internals; it is exactly the producer a user
would write with `produce_batch_async` (the reference's equivalent
exerciser is its sample-producer, one sync message per second —
reference: sample-producer/src/main/java/org/example/Main.java:31-38).

Prints ONE JSON line:
  {"acked": N, "bytes": N, "seconds": S, "failures": N, "rate": N}

Twin of `ripplemq_tpu/samples/loadgen.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections import deque


def _worker(pc, topic: str, tag: str, tid: int, batch: int, window: int,
            payload_bytes: int, deadline: float, out: dict,
            partition_of=None) -> None:
    from ripplemq_tpu_torch.client.producer import ProduceError

    acked = nbytes = failures = seq = 0
    pending: deque = deque()

    def land(waiter, n: int, nb: int) -> None:
        nonlocal acked, nbytes, failures
        try:
            waiter()
            acked += n
            nbytes += nb
        except (ProduceError, Exception):
            failures += n

    while time.monotonic() < deadline:
        while len(pending) >= window:
            land(*pending.popleft())
        payloads = []
        for _ in range(batch):
            head = b"%s-%d-%08d|" % (tag.encode(), tid, seq)
            seq += 1
            payloads.append(head.ljust(payload_bytes, b"x"))
        nb = sum(len(p) for p in payloads)
        part = None if partition_of is None else partition_of(seq)
        try:
            w = pc.produce_batch_async(topic, payloads, partition=part)
        except Exception:
            failures += batch
            time.sleep(0.05)
            continue
        pending.append((w, batch, nb))
    while pending:
        land(*pending.popleft())
    out[tid] = (acked, nbytes, failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ripplemq_tpu_torch.samples.loadgen")
    ap.add_argument("--bootstrap", required=True,
                    help="comma-separated host:port broker addresses")
    ap.add_argument("--topic", default="topic1")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256,
                    help="messages per produce RPC")
    ap.add_argument("--window", type=int, default=4,
                    help="outstanding produce RPCs per thread")
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--payload-bytes", type=int, default=100)
    ap.add_argument("--tag", default="e2e", help="payload prefix tag")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.client.producer import ProducerClient

    bootstrap = args.bootstrap.split(",")
    pc = ProducerClient(bootstrap, metadata_refresh_s=5.0,
                        rpc_timeout_s=120.0)
    try:
        # One warm-up produce: metadata fetched, connection up, program
        # compiled — the timed window measures steady state.
        pc.produce_batch(args.topic, [b"loadgen-warm"])
        out: dict = {}
        t0 = time.monotonic()
        deadline = t0 + args.duration
        threads = [
            threading.Thread(
                target=_worker,
                args=(pc, args.topic, args.tag, i, args.batch, args.window,
                      args.payload_bytes, deadline, out),
                daemon=True,
            )
            for i in range(args.threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.monotonic() - t0
        acked = sum(v[0] for v in out.values())
        nbytes = sum(v[1] for v in out.values())
        failures = sum(v[2] for v in out.values())
        print(json.dumps({
            "acked": acked, "bytes": nbytes,
            "seconds": round(dt, 3), "failures": failures,
            "rate": round(acked / dt, 1),
        }))
        return 0
    finally:
        pc.close()


if __name__ == "__main__":
    sys.exit(main())

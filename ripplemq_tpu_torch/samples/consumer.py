"""Sample consumer (reference: sample-consumer/.../Main.java:18-42).

Every `--interval` seconds consumes from one of `--topics` (rotating, vs
the reference's random pick) and prints what arrived. Auto-commit-after-
read semantics come from the client itself (ConsumerClientImpl.java:
62-117 parity). `--max-polls` bounds the loop for scripted runs; the
default (0) polls forever like the reference.

Twin of `ripplemq_tpu/samples/consumer.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ripplemq_tpu_torch.samples.consumer")
    ap.add_argument("--bootstrap", required=True,
                    help="comma-separated broker addresses (host:port)")
    ap.add_argument("--topics", default="topic1,topic2",
                    help="comma-separated topics to poll (rotating)")
    ap.add_argument("--consumer-id", default="sample-consumer")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--max-polls", type=int, default=0,
                    help="stop after N polls (0 = forever, like the reference)")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.client import ConsumerClient

    consumer = ConsumerClient(args.bootstrap.split(","), args.consumer_id)
    topics = [t for t in args.topics.split(",") if t]
    polls = itertools.count() if args.max_polls == 0 else range(args.max_polls)
    try:
        for i in polls:
            topic = topics[i % len(topics)]
            try:
                messages = consumer.consume(topic)
            except Exception as e:  # keep polling, like the reference loop
                print(f"consume {topic} failed: {e}", file=sys.stderr,
                      flush=True)
                messages = []
            for m in messages:
                print(f"consumed from {topic}: {m!r}", flush=True)
            if not messages:
                print(f"({topic}: no new messages)", flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        consumer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

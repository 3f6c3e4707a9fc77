"""Sample producer (reference: sample-producer/.../Main.java:31-38).

Sends `--count` messages to `--topic` at `--rate` per second and prints
each assigned offset. The reference sends exactly 2 messages to topic1 at
1 msg/s and then parks the main thread; `--count 0` reproduces the
park-forever behavior (send nothing, stay alive) if anyone wants it.

Twin of `ripplemq_tpu/samples/producer.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ripplemq_tpu_torch.samples.producer")
    ap.add_argument("--bootstrap", required=True,
                    help="comma-separated broker addresses (host:port)")
    ap.add_argument("--topic", default="topic1")
    ap.add_argument("--count", type=int, default=2)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="messages per second (reference: 1/s)")
    ap.add_argument("--prefix", default="Message ")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.client import ProducerClient

    producer = ProducerClient(args.bootstrap.split(","))
    try:
        for i in range(args.count):
            message = f"{args.prefix}{i}".encode()
            offset = producer.produce(args.topic, message)
            print(f"produced {message!r} -> {args.topic}@{offset}", flush=True)
            if i + 1 < args.count and args.rate > 0:
                time.sleep(1.0 / args.rate)
        if args.count == 0:
            while True:  # reference keep-alive loop
                time.sleep(60)
    except KeyboardInterrupt:
        pass
    finally:
        producer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

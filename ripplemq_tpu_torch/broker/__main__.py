"""Broker process entry: `python -m ripplemq_tpu_torch.broker --id N --config F`.

The reference boots from `ApplicationMain.main` (reference:
mq-broker/src/main/java/app/ApplicationMain.java:12-54 — load YAML, build
BrokerServer, start, register a shutdown hook) and is launched as
`-id N` per container (mq-broker/docker-compose.yml:8). Same shape here,
with two documented deviations: the broker id is a proper `--id` flag
(the reference checks `args.length < 1` but reads `args[1]` —
ApplicationMain.java:15-20), and the process exits non-zero on a bad
config instead of stack-tracing.

A 5-broker cluster equivalent to the reference's docker-compose is:

    for i in 0 1 2 3 4; do
        python -m ripplemq_tpu_torch.broker --id $i --config examples/cluster.yaml \
            --data-dir /var/lib/ripplemq &
    done

Twin of `ripplemq_tpu/broker/__main__.py` (PyTorch port): the same code,
importing only the port's modules, plus `--device`: where the broker's
device work runs (a torch device string). It defaults to CUDA and is
resolved before the server is built, so on a host without a GPU the
command exits nonzero and names `--device cpu`. With `--coordinator`
the broker joins the distributed world as rank `--host-index` of
`--num-hosts` (one rank a mesh cell; `parallel.mesh.init_distributed`,
its collectives waiting at most the config's `rpc_timeout_s`) before it
builds anything; a controller with `--engine-mode spmd` then drives its
cell of the mesh, and `--engine-workers` names the other cells' engine
workers (`python -m ripplemq_tpu_torch.parallel.worker`).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.broker",
        description="Start one RippleMQ broker (PyTorch port).",
    )
    ap.add_argument("--id", type=int, required=True, dest="broker_id",
                    help="this broker's id (must appear in the config roster)")
    ap.add_argument("--config", required=True,
                    help="cluster config YAML (roster + topics + engine)")
    ap.add_argument("--data-dir", default=None,
                    help="durable storage root; segments + metadata live "
                         "under <data-dir>/broker-<id>/ (omit for in-memory)")
    ap.add_argument("--engine-mode", default="local",
                    choices=["local", "spmd"],
                    help="device binding for the controller's engine: "
                         "'local' holds every replica on one device, "
                         "'spmd' shards a (replica x part) mesh of ranks")
    ap.add_argument("--device", default=None,
                    help="torch device for the broker's device work (the "
                         "controller's DataPlane, the erasure-coded store): "
                         "CUDA by default; 'cpu' runs it on the CPU")
    ap.add_argument("--log-level", default="INFO",
                    help="console log level for the ripplemq loggers "
                         "(DEBUG/INFO/WARNING/ERROR)")
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON object per log line (ts/level/"
                         "subsystem/broker/thread/msg) instead of the "
                         "log4j2-style pattern — machine-greppable next "
                         "to the telemetry plane's event timeline")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process SPMD: rank 0's host:port for "
                         "the distributed world (this broker is rank 0 "
                         "when it drives the mesh as controller; see "
                         "parallel.multihost_check)")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="multi-process SPMD: ranks in the world (one a "
                         "mesh cell)")
    ap.add_argument("--host-index", type=int, default=0,
                    help="multi-process SPMD: this process's rank")
    ap.add_argument("--engine-workers", default=None,
                    help="multi-process SPMD: comma-separated host:port "
                         "of the engine workers of the other ranks (run "
                         "python -m ripplemq_tpu_torch.parallel.worker "
                         "there); required with --coordinator so every "
                         "rank launches each mesh computation")
    args = ap.parse_args(argv)

    import torch

    if args.device is None and not torch.cuda.is_available():
        print("error: no CUDA device available: pass --device cpu to run "
              "the broker's device work on the CPU explicitly",
              file=sys.stderr)
        return 2
    from ripplemq_tpu_torch.ops.rs import indexed_device

    try:
        device = indexed_device("cuda" if args.device is None
                                else args.device)
    except RuntimeError as e:
        print(f"error: --device {args.device}: {e}", file=sys.stderr)
        return 2

    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.metadata.cluster_config import load_cluster_config
    from ripplemq_tpu_torch.utils.logs import configure_logging

    configure_logging(args.log_level, json_lines=args.log_json,
                      broker_id=args.broker_id)

    try:
        config = load_cluster_config(args.config)
        config.broker(args.broker_id)  # fail fast on an id not in the roster
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    data_dir = None
    if args.data_dir is not None:
        data_dir = os.path.join(args.data_dir, f"broker-{args.broker_id}")
        os.makedirs(data_dir, exist_ok=True)

    workers = None
    if args.engine_workers:
        workers = [w.strip() for w in args.engine_workers.split(",") if w.strip()]
    if args.coordinator is not None and args.num_hosts > 1:
        if not workers:
            print("error: --coordinator with --num-hosts > 1 requires "
                  "--engine-workers (every rank of the world must launch "
                  "each computation; run python -m "
                  "ripplemq_tpu_torch.parallel.worker for the other "
                  "ranks)", file=sys.stderr)
            return 2
        if args.engine_mode != "spmd":
            print("error: --coordinator with --num-hosts > 1 requires "
                  "--engine-mode spmd (mode 'local' would silently serve "
                  "from this process's device alone while the workers "
                  "wait forever)", file=sys.stderr)
            return 2

    if args.coordinator is not None:
        # Join the world BEFORE the server exists: the controller's spmd
        # engine is this rank's cell of a mesh over every rank.
        from ripplemq_tpu_torch.parallel.mesh import init_distributed

        n = init_distributed(args.coordinator, args.num_hosts,
                             args.host_index, device=device,
                             timeout_s=config.rpc_timeout_s)
        print(f"joined a {n}-rank world as rank {args.host_index}",
              flush=True)

    server = BrokerServer(
        args.broker_id, config,
        net=None,  # real TCP sockets
        engine_mode=args.engine_mode,
        data_dir=data_dir,
        engine_workers=workers,
        device=device,
    )

    stop = threading.Event()

    def _on_signal(signum, frame):  # the reference's shutdown hook
        stop.set()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)

    server.start()
    role = "controller" if server.is_controller else "frontend"
    print(
        f"ripplemq broker {args.broker_id} ({role}) serving on "
        f"{server.addr}",
        flush=True,
    )
    try:
        while not stop.wait(timeout=1.0):
            pass
    finally:
        server.stop()
        print(f"broker {args.broker_id} stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

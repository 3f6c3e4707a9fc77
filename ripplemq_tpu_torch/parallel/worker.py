"""Engine-worker process: one non-controller cell of the mesh (PyTorch
port).

Twin of `ripplemq_tpu/parallel/worker.py`. Each cell of the (replica,
part) mesh is one process (`parallel.mesh`); the controller broker is
rank 0 and every other rank runs one of these:

    python -m ripplemq_tpu_torch.parallel.worker \
        --coordinator host0:9777 --num-hosts 6 --host-index 1 \
        --listen-port 9810

`--num-hosts` is the world's size (one rank a cell) and `--host-index`
this rank. The worker starts its TCP endpoint FIRST (so the
controller's first lockstep broadcast always lands), then joins the
world (which blocks until every rank arrives), then replays the
controller's engine-call stream (`parallel.lockstep`) until terminated.
The engine shape arrives in the controller's `configure` call,
including the fused_control/packed_writes levers, so the worker builds
the EXACT program the controller runs. `--device` is this rank's device
(CUDA by default; "cpu" runs it on the CPU, with gloo).

A replay that fails ends the process (the reply goes out first): the
world is broken, and the exit makes every collective a peer has open
with this rank raise at once instead of waiting out the group timeout.

Besides the call stream the endpoint answers `engine.stats`: this
process's kernel launch counts (`ops.append.LAUNCHES`), its collectives
(`Mesh.stats`) and the next sequence number it expects; `"reset": true`
zeroes the counts first.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

STATS_TYPE = "engine.stats"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.parallel.worker")
    ap.add_argument("--coordinator", required=True,
                    help="rank 0's host:port (or file://PATH)")
    ap.add_argument("--num-hosts", type=int, required=True,
                    help="ranks in the world (one a mesh cell)")
    ap.add_argument("--host-index", type=int, required=True,
                    help="this process's rank (>= 1)")
    ap.add_argument("--listen-host", default="0.0.0.0")
    ap.add_argument("--listen-port", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="torch device for this rank's shard (CUDA by "
                         "default; 'cpu' runs it on the CPU)")
    ap.add_argument("--timeout-s", type=float, default=120.0,
                    help="how long a collective waits for a peer (the "
                         "cluster's rpc_timeout_s)")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)

    import torch

    from ripplemq_tpu_torch.ops import append as append_ops
    from ripplemq_tpu_torch.parallel import mesh as mesh_mod
    from ripplemq_tpu_torch.parallel.lockstep import (
        LOCKSTEP_TYPE,
        LockstepWorker,
    )
    from ripplemq_tpu_torch.utils.logs import configure_logging, get_logger
    from ripplemq_tpu_torch.wire.transport import TcpServer

    configure_logging(args.log_level)
    log = get_logger("worker")
    if args.device is None and not torch.cuda.is_available():
        print("error: no CUDA device available: pass --device cpu to run "
              "the worker on the CPU explicitly", file=sys.stderr)
        return 2

    worker = LockstepWorker(gap_timeout_s=args.timeout_s)

    def stats(req: dict) -> dict:
        meshes = list(mesh_mod._MESHES.values())
        out = {"ok": True, "launches": dict(append_ops.LAUNCHES),
               "collectives": {k: list(v) for m in meshes
                               for k, v in m.stats.items()},
               "expected_seq": worker.expected_seq}
        if req.get("reset"):
            append_ops.reset_launches()
            for m in meshes:
                m.reset_stats()
        return out

    def dispatch(req: dict) -> dict:
        if req.get("type") == LOCKSTEP_TYPE:
            resp = worker.handle(req)
            if not resp.get("ok"):
                # Out of lockstep for good: this rank cannot rejoin the
                # call stream, and while it lives, a peer blocked in a
                # collective with it waits out the group's timeout. Its
                # exit closes its sockets, so their collectives raise
                # at once (the reply leaves first).
                log.warning("lockstep broken (%s); leaving", resp["error"])
                threading.Timer(0.5, os._exit, args=(3,)).start()
            return resp
        if req.get("type") == STATS_TYPE:
            return stats(req)
        return {"ok": False, "error": f"unknown request {req.get('type')!r}"}

    server = TcpServer(args.listen_host, args.listen_port, dispatch)
    server.start()  # listening BEFORE the world forms (see module doc)
    n = mesh_mod.init_distributed(args.coordinator, args.num_hosts,
                                  args.host_index, device=args.device,
                                  timeout_s=args.timeout_s)
    dev = mesh_mod._WORLD["device"]
    torch.zeros(1, device=dev)  # the device's context, before any call
    log.info("engine worker %d/%d up on %s (%s), listening on %s:%d",
             args.host_index, n, dev, mesh_mod._WORLD["backend"],
             args.listen_host, server.port)
    print(f"WORKER_READY rank={args.host_index} world={n} device={dev} "
          f"backend={mesh_mod._WORLD['backend']}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(timeout=1.0):
            pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

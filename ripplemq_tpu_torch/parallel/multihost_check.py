"""Multi-process SPMD proof: one replication round and one election
committed across OS processes (PyTorch port).

Twin of `ripplemq_tpu/parallel/multihost_check.py`. Run the SAME
command once per rank (here: two processes on one machine, gloo on the
CPU; on GPUs each process holds one device):

    python -m ripplemq_tpu_torch.parallel.multihost_check \
        --coordinator 127.0.0.1:9777 --num-hosts 2 --host-index {0,1} \
        --device cpu

Each process joins the world as one rank (`parallel.mesh`), builds the
(replica x part) mesh `pick_axes` gives for the world's size, and runs a
full data round and an election round with the production levers on
(fused_control + packed_writes). The ballot's and the leader
broadcast's `all_reduce`s then cross the process boundary.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.parallel.multihost_check")
    ap.add_argument("--coordinator", required=True,
                    help="rank 0's host:port (or file://PATH)")
    ap.add_argument("--num-hosts", type=int, required=True,
                    help="ranks in the world (one process each)")
    ap.add_argument("--host-index", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="torch device of this rank (CUDA by default; "
                         "'cpu' runs it on the CPU, with gloo)")
    ap.add_argument("--timeout-s", type=float, default=120.0)
    args = ap.parse_args(argv)

    import numpy as np

    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.core.encode import build_step_input
    from ripplemq_tpu_torch.parallel.engine import make_spmd_fns
    from ripplemq_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        pick_axes,
        shutdown,
    )

    n = init_distributed(args.coordinator, args.num_hosts, args.host_index,
                         device=args.device, timeout_s=args.timeout_s)
    replicas, part_shards = pick_axes(n)
    P = 2 * part_shards
    cfg = EngineConfig(
        partitions=P, replicas=replicas, slots=64, slot_bytes=32,
        max_batch=8, read_batch=8, max_consumers=8, max_offset_updates=4,
        fused_control=True, packed_writes=True,
    )
    mesh = make_mesh(replicas, part_shards)
    fns = make_spmd_fns(cfg, mesh)
    state = fns.init()

    # Data round: identical host inputs on every process (the controller
    # broadcast); the ballot's all_reduce crosses the process boundary.
    inp = build_step_input(
        cfg, appends={p: [b"mh-%d" % p] for p in range(P)}, leader=0, term=1
    )
    alive = np.ones((P, replicas), bool)
    quorum = np.full((P,), cfg.quorum, np.int32)
    state, out = fns.step(state, inp, alive, quorum)
    committed = out.committed.cpu().numpy()  # [P] on every rank
    assert committed.all(), f"round did not commit: {committed}"
    assert (out.votes.cpu().numpy() == replicas).all()

    # Election round across the same mesh.
    state, elected, votes = fns.vote(
        state, np.zeros((P,), np.int32), np.full((P,), 2, np.int32),
        alive, quorum,
    )
    assert elected.cpu().numpy().all(), "election failed"
    print(
        f"MULTIHOST_OK host={args.host_index}/{args.num_hosts} "
        f"devices={n} mesh=({replicas}x{part_shards}) "
        f"backend={mesh.backend}",
        flush=True,
    )
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

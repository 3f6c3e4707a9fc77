"""One-command harness for the spmd scaling curve (PyTorch port).

Twin of the reference's `profiles/spmd_scaling.py`: the fused-control
spmd binding's sustained committed appends/s with partitions sharded
over the "part" axis of a 1 x n mesh, at several rank counts. The
reference forces n virtual CPU devices in one subprocess a count; here a
mesh cell is a process, so each count is a world of n processes (one
rank each, every rank on the one card: two ranks on a GPU make the world
gloo). Every rank runs the same sustained best-of-N loop as the bench's
headline (`_sustained_window` ring-wraps behind staged trim watermarks);
the window's rate is the slowest rank's, and the best window's ring tail
is byte-verified after the clock stops (every rank takes part in the
reads' collective, rank 0 reports).

Run:
  python -m ripplemq_tpu_torch.profiles.spmd_scaling              # counts 1,2,4,8 on the GPU
  python -m ripplemq_tpu_torch.profiles.spmd_scaling --counts 1,2 --launches 8 --device cpu

Prints one JSON line (the dict the bench embeds as `spmd_scaling`) plus
a readable table on stderr. Without a GPU and without `--device` it
raises.

The ranks share one card's silicon and one host's cores: the curve
prices what sharding costs (one gathered output a round over gloo,
dispatch a rank), not what added GPUs buy.
"""

from __future__ import annotations

import argparse
import json
import sys

# The measured shape (the reference's): R 1 isolates the partition
# axis, P divides every measured rank count, and the stride sits below
# the aliasing band at every shard width.
SHAPE = dict(
    partitions=256, replicas=1, slots=2496, slot_bytes=128,
    max_batch=64, read_batch=32, max_consumers=64, max_offset_updates=8,
    fused_control=True, packed_writes=True,
)


def run_inner(devices: int, rank: int, store: str, chain: int,
              launches: int, windows: int, device=None) -> dict | None:
    """One rank of one scaling point: join the world of `devices` ranks
    through the FileStore at `store`, run the sustained windows through
    `make_spmd_fns(cfg, make_mesh(1, devices))`, verify the best window's
    ring tail, leave the world. Returns the point on rank 0, else None."""
    import numpy as np
    import torch

    from ripplemq_tpu_torch.bench import (
        PAYLOAD,
        _stack,
        _stage_trims,
        _sustained_warmup,
        _sustained_window,
        _verify_ring_tail,
    )
    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.core.encode import build_step_input
    from ripplemq_tpu_torch.parallel.engine import make_spmd_fns
    from ripplemq_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    init_distributed(f"file://{store}", devices, rank, device=device)
    try:
        cfg = EngineConfig(**SHAPE)
        mesh = make_mesh(1, devices)
        fns = make_spmd_fns(cfg, mesh)
        dev = mesh.device
        B = cfg.max_batch
        one = build_step_input(
            cfg, appends={p: [PAYLOAD] * B for p in range(cfg.partitions)},
            leader=0, term=1)

        def put(x):
            return torch.as_tensor(np.array(x, order="C"), device=dev)

        # Every argument staged on this rank's device before the timed
        # window (global shapes: the binding takes its shard's rows).
        inp = _stack(one, chain, put)
        alive = torch.ones((cfg.partitions, cfg.replicas), dtype=torch.bool,
                           device=dev)
        quorum = torch.full((cfg.partitions,), cfg.quorum,
                            dtype=torch.int32, device=dev)
        adv = chain * B
        trims = _stage_trims(cfg, adv, launches, put)
        _sustained_warmup(fns, inp, alive, quorum, trims)
        best = 0.0
        for _ in range(windows):
            rate, state = _sustained_window(
                fns, inp, alive, quorum, trims,
                launches * adv * cfg.partitions)
            # The window ends at the slowest rank's fence: every rank takes
            # the same rate, so every rank takes the same verify branch
            # (the reads are collectives).
            rate = -float(mesh.all_reduce(
                torch.tensor([-rate], dtype=torch.float64, device=dev),
                "max", "mesh")[0])
            if rate > best:
                best = rate
                _verify_ring_tail(fns, state, total_rows=launches * adv,
                                  batch=B, adv_round=B,
                                  nparts=cfg.partitions)
            del state
        if rank != 0:
            return None
        return {
            "devices": devices,
            "local_P": cfg.partitions // devices,
            "partitions": cfg.partitions,
            "max_batch": B,
            "appends_per_sec": round(best, 1),
        }
    finally:
        shutdown()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.profiles.spmd_scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--counts", default="1,2,4,8",
                    help="comma-separated rank counts")
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--launches", type=int, default=24)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (CUDA by default; "
                         "'cpu' runs the ranks on the CPU)")
    # Child mode: one rank of one point.
    ap.add_argument("--inner", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.inner is not None:
        point = run_inner(args.inner, args.rank, args.store, args.chain,
                          args.launches, args.windows, device=args.device)
        if point is not None:
            print(json.dumps(point), flush=True)
        return 0

    from ripplemq_tpu_torch.bench import _run_spmd_scaling

    out = _run_spmd_scaling(
        device_counts=tuple(int(c) for c in args.counts.split(",")),
        chain=args.chain, launches=args.launches, windows=args.windows,
        device=args.device)
    print(json.dumps(out))
    print(f"\n{out['config']}", file=sys.stderr)
    for p in out["points"]:
        speed = out["vs_1dev"][str(p["devices"])]
        print(f"  ranks={p['devices']:<2d} local_P={p['local_P']:<4d} "
              f"{p['appends_per_sec']:>14,.1f} appends/s  "
              f"x{speed} vs 1 rank", file=sys.stderr)
    print(f"  note: {out['method']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

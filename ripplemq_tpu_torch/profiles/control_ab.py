"""Same-process A/B harness for the control-fusion + packed-write levers.

Twin of the reference's `profiles/control_ab.py`, on the port's engine:
one command reproduces the bench's `control_fusion_ab` figures,
same-process, best-of-N:

- control-only rounds (offsets-only: they commit but write no log row)
  price the control phase per round, legacy vs fused;
- full sustained rounds price the end effect, all four flag
  combinations;
- quarter-batch sustained rounds price the packed-write lever where it
  moves fewer bytes (a full round's extent is the full window).

Run:
  python -m ripplemq_tpu_torch.profiles.control_ab               # headline shape, on the GPU
  python -m ripplemq_tpu_torch.profiles.control_ab --preset cpu --device cpu
  python -m ripplemq_tpu_torch.profiles.control_ab --launches 120 --windows 2

Prints one JSON line (the dict the bench embeds as `control_fusion_ab`)
plus a readable table on stderr. Numbers are comparable only WITHIN one
invocation. The engine runs on CUDA unless `--device` names another
device; without a GPU and without `--device` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys

PRESETS = {
    # The bench's headline shape (1024 x 5, B 256, chain 8) on one GPU.
    "gpu": dict(shape={}, chain=8, launches=240, control_launches=240,
                windows=2),
    # Small enough for a CPU host to finish in minutes; same structure.
    "cpu": dict(
        shape=dict(partitions=64, replicas=3, slots=1024, slot_bytes=128,
                   max_batch=32),
        chain=4, launches=48, control_launches=48, windows=2,
    ),
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.profiles.control_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="gpu")
    ap.add_argument("--chain", type=int, default=None)
    ap.add_argument("--launches", type=int, default=None)
    ap.add_argument("--control-launches", type=int, default=None)
    ap.add_argument("--windows", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA by default; 'cpu' runs the "
                         "engine on the CPU)")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.bench import _run_fusion_ab

    kw = dict(PRESETS[args.preset])
    for name in ("chain", "launches", "windows"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    if args.control_launches is not None:
        kw["control_launches"] = args.control_launches

    out = _run_fusion_ab(**kw, device=args.device)
    print(json.dumps(out))

    rows = [(k, v) for k, v in out.items() if k != "config"]
    width = max(len(k) for k, _ in rows)
    print(f"\n{out['config']}", file=sys.stderr)
    for k, v in rows:
        print(f"  {k:<{width}}  {v}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

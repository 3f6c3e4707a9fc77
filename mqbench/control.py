"""The control of the comparison: `python3 -m mqbench.control`.

    python3 -m mqbench.control --workload <cell> --seeds a,b,c [--seconds 10]

Runs the cell with the configuration's one stated guarantee broken: the
cluster acks with no standby copy (`standby_count: 0`, a path the
program has), so an acked message lives on one replica while the
configuration promises `min_insync_replicas`. The comparison must come
out not correct on every seed; this exits 0 when it does and prints each
compared number, 1 when any control run came out correct. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from mqbench.run import BENCH_DIR, load_json, run_cell


def control_config(config: dict) -> dict:
    cfg = copy.deepcopy(config)
    cfg["cluster"]["standby_count"] = 0
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mqbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    wl = load_json(BENCH_DIR, "workloads", f"{args.workload}.json")
    config = control_config(load_json(
        BENCH_DIR, "configs", f"{args.workload.rsplit('.', 1)[0]}.json"))
    failed_as_it_must = True
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = run_cell(config, wl, seed, args.seconds, False, "cuda",
                       t_start_ns=time.monotonic_ns())
        correct = not any(rec["check"].values())
        failed_as_it_must &= not correct
        print(json.dumps({"seed": seed, "correct": correct,
                          "compared": rec["check"]}), flush=True)
    return 0 if failed_as_it_must else 1


if __name__ == "__main__":
    sys.exit(main())

"""Find a steady cell's knee on the card: `python3 -m mqbench.sweep`.

    python3 -m mqbench.sweep --workload <cell> --rates 2000,4000,... \
        [--seconds 8] [--seed 1]

Runs the cell once at each offered rate (msgs/s) with the rate of its
workload file replaced, and prints one JSON line a rate: the offered and
acked rates, ack latency quartiles of the window's first and second
halves, and how late the generator ran. The knee is the highest rate at
which acks keep pace with the offer (no backlog: the second half's
median ack latency within 25% + 5 ms of the first half's, and every
request due in the window acked inside it plus 1 s) and the generator
keeps its schedule (99th percentile lateness under 20 ms). A steady
cell runs at 0.8 x the knee; its workload file holds that number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from mqbench.run import BENCH_DIR, load_json, run_cell


def point(rec: dict, rate: float) -> dict:
    a = rec["acks"]
    ws, we = rec["ws"], rec["we"]
    mid = (ws + we) // 2
    due = (a[:, 5] >= ws) & (a[:, 5] < we)
    lat = (a[:, 7] - a[:, 5]) / 1e6
    first, second = due & (a[:, 5] < mid), due & (a[:, 5] >= mid)
    on_time = due & (a[:, 7] < we + 1_000_000_000)
    p50a = float(np.median(lat[first])) if first.any() else float("inf")
    p50b = float(np.median(lat[second])) if second.any() else float("inf")
    offered = float(a[due, 4].sum()) / rec["seconds"]
    kept = bool(a[on_time, 4].sum() >= 0.999 * a[due, 4].sum()
                and rec["failed"] == 0)
    return {"rate": rate, "offered": offered,
            "acked_in_window": float(a[(a[:, 7] >= ws) & (a[:, 7] < we), 4]
                                     .sum()) / rec["seconds"],
            "ack_p50_first_ms": p50a, "ack_p50_second_ms": p50b,
            "ack_p95_ms": float(np.percentile(lat[due], 95)),
            "late_p99_ms": rec["late_p99_ms"],
            "sustained": bool(kept and p50b <= 1.25 * p50a + 5.0
                              and rec["late_p99_ms"] < 20.0),
            "correct": not any(rec["check"].values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mqbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    wl = load_json(BENCH_DIR, "workloads", f"{args.workload}.json")
    config = load_json(BENCH_DIR, "configs",
                       f"{args.workload.rsplit('.', 1)[0]}.json")
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        wl["producers"]["rate_msgs_per_s"] = rate
        rec = run_cell(config, wl, args.seed, args.seconds, False, "cuda",
                       t_start_ns=time.monotonic_ns())
        p = point(rec, rate)
        print(json.dumps(p), flush=True)
        if p["sustained"] and p["correct"]:
            knee = rate
    print(json.dumps({"knee_msgs_per_s": knee,
                      "cell_rate_msgs_per_s": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

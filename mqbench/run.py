"""Run one cell of the benchmark once.

    python3 -m mqbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are data: the cell's entry
in `BENCHMARK.json`, `mqbench/workloads/<cell>.json` (the traffic mix)
and `mqbench/configs/<config>.json` (the deployment). Its metrics are
the files `mqbench/metrics/<name>.py` of the metrics `BENCHMARK.json`
gives the cell: the end-to-end ones with `--trace 0`, the per-layer ones
with `--trace 1`.

A run boots the port's 3-broker cluster (`mqbench.cluster`), starts the
load generators (`mqbench.loadgen`), drives the warm traffic and then
the window, with the tail readers reading throughout, and waits for
every request. It then probes the quorum: with both standbys stopped,
one request to every partition, none of which may be acked before they
resume. It waits for the readers to reach each partition's end, stops
the cluster, reads every standby's store (`mqbench.store`), and holds
all of it against the plain reference (`mqbench.reference`). It
prints its accounting on stderr, the compared numbers with their limits
as the last lines of stderr, and one JSON object as the last line of
stdout.
"""

from __future__ import annotations

import time

T_START_NS = time.monotonic_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from mqbench import readers, reference, store, traffic  # noqa: E402
from mqbench.cluster import (ROOT, TOPIC, Cluster, proc_cpu_s,  # noqa: E402
                             proc_write_bytes)

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ripplemq_tpu")
# After the window: how long requests in flight and the readers' catch-up
# may take before the run counts them as failed.
DRAIN_TIMEOUT_S = 90.0
# How long the quorum probe keeps both standbys stopped: several rounds'
# settle time, far under any timeout that would drop a standby.
PROBE_HOLD_S = 1.0


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[str]:
    """The metrics BENCHMARK.json gives `cell`: those of its kind that
    list the cell, or list no cells and report an end-to-end metric the
    cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return [m["name"] for m in e2e]
    names = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def forbidden_modules() -> list[str]:
    """Modules whose top-level name, compared whole, is JAX's, flax's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------- processes

class Gen:
    """One load-generator process and its line protocol."""

    def __init__(self, spec: dict, workdir: str, name: str) -> None:
        spec = dict(spec, out=os.path.join(workdir, f"{name}.npz"))
        self.spec = spec
        path = os.path.join(workdir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        self.log = open(os.path.join(workdir, f"{name}.log"), "w")
        env = dict(os.environ, PYTHONPATH=ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mqbench.loadgen", path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log,
            text=True, bufsize=1, cwd=ROOT, env=env)
        self.name = name
        self.cpu_s = 0
        self.write_bytes = (0, 0)
        self.torch_libs: list = []

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def expect(self, word: str, timeout_s: float) -> None:
        box: list = []
        t = threading.Thread(target=lambda: box.append(
            self.proc.stdout.readline()), daemon=True)
        t.start()
        t.join(timeout_s)
        line = box[0].strip() if box else ""
        if line != word:
            raise RuntimeError(f"{self.name}: wanted {word}, got "
                               f"{line!r} (exit {self.proc.poll()})")

    def account(self) -> None:
        """CPU and bytes written, read while the process lives; and
        whether it mapped torch's libraries (a load generator must not:
        it stands for a user's client)."""
        self.cpu_s = proc_cpu_s(self.proc.pid)
        self.write_bytes = proc_write_bytes(self.proc.pid)
        try:
            with open(f"/proc/{self.proc.pid}/maps") as f:
                self.torch_libs = sorted({
                    ln.split()[-1] for ln in f
                    if "libtorch" in ln or "libc10" in ln})
        except OSError:
            self.torch_libs = []

    def result(self):
        with open(self.spec["out"] + ".json") as f:
            info = json.load(f)
        return np.load(self.spec["out"]), info

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send("EXIT")
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def gen_specs(config: dict, wl: dict, seed: int, cluster: Cluster,
              seconds: float) -> dict:
    """The load generators' specs for a cell, by role."""
    base = {"bootstrap": cluster.bootstrap, "topic": TOPIC, "seed": seed,
            "size": config["message_bytes"],
            "partitions": config["partitions"],
            "read_batch": config["engine"]["read_batch"],
            "rpc_timeout_s": 120.0}
    out: dict = {"producer": [], "tail": []}
    prod = wl["producers"]
    if prod["loop"] == "closed":
        streams = prod["procs"] * prod["threads"]
        for g in range(prod["procs"]):
            out["producer"].append(dict(
                base, role="producer", loop="closed",
                streams=list(range(g * prod["threads"],
                                   (g + 1) * prod["threads"])),
                total_streams=streams, in_flight=prod["in_flight"],
                batch=prod["batch"],
                rate_msgs_per_s=prod["rate_msgs_per_s"]))
    else:
        for g in range(prod["procs"]):
            out["producer"].append(dict(
                base, role="producer", loop="open", proc=g,
                procs=prod["procs"], traffic=prod,
                schedule_seconds=wl["warm_s"] + seconds))
    out["tail"].append(dict(base, role="tail", threads=wl["tail"]["threads"],
                            name="tail"))
    return out


# --------------------------------------------------------------- readback

class Registry:
    """Snapshots of the controller's metrics registry: every histogram's
    exact count and total, and every counter."""

    def __init__(self, metrics) -> None:
        self.m = metrics

    def snap(self) -> dict:
        s = self.m.snapshot()
        hist = {}
        for name in s["histograms"]:
            h = self.m.histogram(name)
            hist[name] = (h.count, h.total)
        return {"hist": hist, "counters": dict(s["counters"])}


def read_store(directory: str, pl: traffic.Payloads,
               slot_bytes: int) -> dict:
    """What one broker's store holds: partition -> message ids in log
    order, from its append frames, and the rows and frames that fail
    the byte check under the key None."""
    by_slot, bad = store.scan_appends(directory)
    held: dict = {None: {"corrupt": bad, "misrouted": 0}}
    for slot, recs in by_slot.items():
        rows = np.frombuffer(b"".join(recs[b] for b in sorted(recs)),
                             np.uint8).reshape(-1, slot_bytes)
        lens = rows[:, :4].copy().view("<i4").reshape(-1)
        rows, lens = rows[lens > 0], lens[lens > 0]
        held[None]["corrupt"] += int((lens != pl.size).sum())
        body = rows[lens == pl.size, 8:8 + pl.size]
        ids, _, part, ok = pl.verify_rows(body)
        held[None]["corrupt"] += int((~ok).sum())
        if not ok.any():
            continue
        vals, counts = np.unique(part[ok], return_counts=True)
        home = int(vals[np.argmax(counts)])
        held[None]["misrouted"] += int((part[ok] != home).sum())
        held[home] = ids[ok]
    return held


class MemPeak:
    """The fullest the card got, by every process on it: total minus free
    memory, sampled through the run."""

    def __init__(self, device: str) -> None:
        self.peak = 0
        self.stop = threading.Event()
        self.cuda = device.startswith("cuda")
        self.t = threading.Thread(target=self._run, daemon=True,
                                  name="mqbench-mem")
        self.t.start()

    def _run(self) -> None:
        import torch

        while self.cuda and not self.stop.is_set():
            free, total = torch.cuda.mem_get_info()
            self.peak = max(self.peak, total - free)
            self.stop.wait(0.1)

    def close(self) -> int:
        self.stop.set()
        self.t.join()
        return self.peak


def dir_bytes(path: str) -> int:
    """Bytes of the files under `path`: what the run's brokers stored
    (segments, erasure shards, metadata), all of it written this run."""
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


def _sleep_until(t_ns: int) -> None:
    while True:
        d = t_ns - time.monotonic_ns()
        if d <= 0:
            return
        time.sleep(min(d / 1e9, 0.05))


# --------------------------------------------------------------- one run

def run_cell(config: dict, wl: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start_ns: int = T_START_NS) -> dict:
    """Boot, drive, probe, drain, read back and compare one run. Returns
    the run's record (what the metric files read) with its `check`
    counts."""
    import torch

    workdir = tempfile.mkdtemp(prefix="mqbench-")
    cluster = Cluster(config, workdir, device)
    gens: list[Gen] = []
    mem = MemPeak(device)
    pl = traffic.Payloads(seed, config["message_bytes"])
    rec: dict = {"config": config, "seconds": float(seconds)}
    try:
        cluster.start()
        cluster.wait_ready()
        ctrl = cluster.controller
        reg = Registry(ctrl.metrics)
        specs = gen_specs(config, wl, seed, cluster, seconds)
        prods = [Gen(s, workdir, f"producer{i}")
                 for i, s in enumerate(specs["producer"])]
        tails = [Gen(s, workdir, "tail") for s in specs["tail"]]
        gens += prods + tails
        for g in gens:
            g.expect("READY", 120)
        if trace:
            from mqbench.trace import DeviceTrace

            dt = DeviceTrace()
            dt.warm()
        t0 = time.monotonic_ns() + 200_000_000
        ws = t0 + int(wl["warm_s"] * 1e9)
        we = ws + int(seconds * 1e9)
        for g in gens:
            g.send(f"GO {t0} {ws} {we}")
        _sleep_until(ws)
        rec["setup_s"] = (ws - t_start_ns) / 1e9
        cpu0 = proc_cpu_s(os.getpid())
        snap0 = reg.snap()
        if trace:
            lead = min(1.0, seconds / 4)
            _sleep_until(ws + int(lead * 1e9))
            tr0 = reg.snap()
            with dt:
                time.sleep(min(2.0, seconds / 2))
            tr1 = reg.snap()
        _sleep_until(we)
        snap1 = reg.snap()
        rec["cpu"] = {"controller_window_s": proc_cpu_s(os.getpid()) - cpu0}
        rec["registry"] = {"window": (snap0, snap1)}
        if trace:
            rec["registry"]["trace"] = (tr0, tr1)
            rec["trace"] = dt.summary()
        for g in prods:
            g.expect("DONE", DRAIN_TIMEOUT_S + 30)
        # The quorum probe: no request sent while both standbys are
        # stopped may be acked before they resume.
        t_stop = cluster.pause_standbys()
        try:
            prods[0].send("PROBE")
            _sleep_until(t_stop + int(PROBE_HOLD_S * 1e9))
            t_resume = time.monotonic_ns()
        finally:
            cluster.resume_standbys()
        prods[0].expect("DONE", DRAIN_TIMEOUT_S + 30)
        for g in tails:
            g.send(f"DRAIN {DRAIN_TIMEOUT_S}")
        for g in tails:
            g.expect("DONE", DRAIN_TIMEOUT_S + 30)
        for g in gens:
            g.account()
        rec["memory_peak_bytes"] = mem.close()
        rec["controller_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                        if device.startswith("cuda") else 0)
        rec["cpu"]["standbys_s"] = sum(proc_cpu_s(p) for p in cluster.pids())
        rec["cpu"]["clients_s"] = sum(g.cpu_s for g in gens)
        rec["cpu"]["controller_s"] = proc_cpu_s(os.getpid())
        wbytes = np.sum([proc_write_bytes(p) for p in cluster.pids()]
                        + [g.write_bytes for g in gens], axis=0)
        # Results, then the cluster down: its stores are then closed.
        pres = [g.result() for g in prods]
        tres = [g.result() for g in tails]
        for g in gens:
            g.close()
        cluster.controller.stop()
        wbytes += np.array(proc_write_bytes(os.getpid()))
        cluster.stop_standbys()
        rec["disk_bytes"] = dir_bytes(workdir)
        standbys = [read_store(cluster.store_dir(b), pl,
                               config["engine"]["slot_bytes"])
                    for b in range(1, config["brokers"])]
        rec["write_bytes"] = [int(x) for x in wbytes]
        acks = np.concatenate([r[0]["acks"] for r in pres])
        failed = np.concatenate([r[0]["failed"] for r in pres])
        probe = acks[:, 0] == traffic.PROBE_STREAM
        rec.update(acks=acks, ws=ws, we=we, failed=len(failed),
                   probe_acked=int(probe.sum()))
        rec["errors"] = [e for r in pres + tres for e in r[1]["errors"]]
        deliveries: dict = {}
        for z, _ in tres:
            ids, parts = z["ids"], z["parts"]
            for p in np.unique(parts):
                deliveries[int(p)] = ids[parts == p]
        faults = {"corrupt": sum(r[1]["corrupt"] for r in tres),
                  "misrouted": sum(r[1]["misrouted"] for r in tres)}
        check = reference.check_run([tuple(r[:5]) for r in acks],
                                    len(failed), deliveries, faults,
                                    standbys, config["min_insync_replicas"])
        check["acked_without_quorum"] = int(
            (probe & (acks[:, 7] < t_resume)).sum())
        check["reader_errors"] = len(rec["errors"])
        check["clients_with_torch"] = sum(bool(g.torch_libs) for g in gens)
        rec["check"] = check
        rec["deliver_ms"] = (np.concatenate([z["lat_ms"] for z, _ in tres])
                             if tres else np.zeros(0))
        rec["consumed_in_window"] = sum(info["in_window"] for _, info in tres)
        lateness = (acks[:, 6] - acks[:, 5]) / 1e6
        rec["late_p99_ms"] = (float(np.percentile(lateness, 99))
                              if len(lateness) else 0.0)
        return rec
    finally:
        mem.close()
        for g in gens:
            g.close()
        cluster.stop()
        shutil.rmtree(workdir, ignore_errors=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mqbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    err = sys.stderr

    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=err)
        return 2
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=err)
        return 2
    wl = load_json(BENCH_DIR, "workloads", f"{cell['name']}.json")
    config = load_json(BENCH_DIR, "configs", f"{cell['config']}.json")
    names = cell_metrics(bench, cell["name"], bool(args.trace))
    read = {n: readers.load(n) for n in names}
    print(f"card: {card_line()}", file=err, flush=True)

    rec = run_cell(config, wl, args.seed, args.seconds, bool(args.trace),
                   "cuda")

    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=err)
        return 3
    metrics = {}
    for n, fn in read.items():
        v = fn(rec)
        if v is not None:
            unit = next(m["unit"] for m in bench["end_to_end"]
                        + bench["per_layer"] if m["name"] == n)
            metrics[n] = {"value": float(v), "unit": unit}
    acks = rec["acks"]
    attempted = len(acks) + rec["failed"]
    out = {"correct": not any(rec["check"].values()),
           "attempted": int(attempted), "failed": int(rec["failed"]),
           "metrics": metrics,
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"],
                      "memory_peak_bytes": int(rec["memory_peak_bytes"])}}
    tr = rec.get("trace")
    if tr:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        top = sorted(tr["ops"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": [[n, s] for s, n in tr["gaps"]]}
    lat = rec["deliver_ms"]
    a_lat = (acks[:, 7] - acks[:, 5]) / 1e6
    inwin = (acks[:, 5] >= rec["ws"]) & (acks[:, 5] < rec["we"])
    for line in (
        f"window: {rec['seconds']} s, setup {rec['setup_s']:.3f} s, "
        f"{int(acks[inwin, 4].sum())} messages in "
        f"{int(inwin.sum())} requests due in it, "
        f"{rec['consumed_in_window']} delivered in it",
        "ack ms p50/p95/p99: " + ("/".join(
            f"{np.percentile(a_lat[inwin], q):.3f}" for q in (50, 95, 99))
            if inwin.any() else "none") + f" (n={int(inwin.sum())})",
        "deliver ms p50/p95/p99: " + ("/".join(
            f"{np.percentile(lat, q):.3f}" for q in (50, 95, 99))
            if len(lat) else "none") + f" (n={len(lat)})",
        f"generator late p99: {rec['late_p99_ms']:.3f} ms",
        "acked messages a second of the window: " + str(np.bincount(
            ((acks[:, 7] - rec["ws"]) // 1_000_000_000)[
                (acks[:, 7] >= rec["ws"]) & (acks[:, 7] < rec["we"])],
            weights=acks[:, 4][(acks[:, 7] >= rec["ws"])
                               & (acks[:, 7] < rec["we"])]).astype(
                                   int).tolist()),
        f"cpu s: controller {rec['cpu']['controller_s']:.1f} "
        f"(window {rec['cpu']['controller_window_s']:.2f}), standbys "
        f"{rec['cpu']['standbys_s']:.1f}, clients {rec['cpu']['clients_s']:.1f}",
        f"bytes the brokers stored (files under the run's directory): "
        f"{rec['disk_bytes']}",
        f"bytes written by all processes: to storage "
        f"{rec['write_bytes'][0]}, to write calls {rec['write_bytes'][1]} "
        f"(the standbys' last flush at stop not counted)",
        f"device memory peak: card {rec['memory_peak_bytes']}, "
        f"controller allocated {rec['controller_peak_bytes']}",
        f"quorum probe: {rec['probe_acked']} requests acked, "
        f"{rec['check']['acked_without_quorum']} of them while both "
        f"standbys were stopped",
        f"errors: {rec['errors'][:5]}",
    ):
        print(line, file=err)
    for k, v in rec["check"].items():
        print(f"{k} {v} limit 0", file=err)
    err.flush()
    out["compared"] = {k: {"value": v, "limit": 0}
                       for k, v in rec["check"].items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

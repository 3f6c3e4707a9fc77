"""The system under test: the port's 3-broker cluster on loopback TCP.

The controller's `BrokerServer` runs in the harness's process on the
card (so the harness reads its registry and traces its device work);
each other broker is a `python -m ripplemq_tpu_torch.broker` process on
the same card. Everything is the port's own code, booted as deployed.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPIC = "bench"


def free_ports(n: int) -> list[int]:
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def cluster_raw(config: dict, ports: list[int]) -> dict:
    """The port's cluster config (the YAML/JSON its broker CLI reads)
    for a configuration file of `mqbench/configs/`."""
    raw = dict(config["cluster"])
    raw["brokers"] = [{"id": i, "host": "127.0.0.1", "port": p}
                      for i, p in enumerate(ports)]
    raw["topics"] = [{"name": TOPIC, "partitions": config["partitions"],
                      "replication_factor": config["replication_factor"]}]
    raw["engine"] = dict(config["engine"])
    return raw


def proc_cpu_s(pid: int) -> float:
    """utime + stime of a live process, from /proc/<pid>/stat."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            fields = f.read().rsplit(b") ", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except OSError:
        return 0.0


def proc_state(pid: int) -> str:
    """The state letter of a process, from /proc/<pid>/stat ("T":
    stopped); "" where it is gone."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().rsplit(b") ", 1)[1].split()[0].decode()
    except OSError:
        return ""


def proc_write_bytes(pid: int) -> tuple[int, int]:
    """What a live process wrote, from /proc/<pid>/io: bytes it caused
    to be written to storage (`write_bytes`; 0 where the files live in
    memory, as on a tmpfs) and bytes it passed to write calls (`wchar`,
    sockets and pipes included). (0, 0) where it cannot be read."""
    got = {}
    try:
        with open(f"/proc/{pid}/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                got[k] = int(v)
    except (OSError, ValueError):
        pass
    return got.get("write_bytes", 0), got.get("wchar", 0)


class Cluster:
    """Boots the cluster in `workdir`; `stop()` tears it all down."""

    def __init__(self, config: dict, workdir: str, device: str) -> None:
        self.config = config
        self.workdir = workdir
        self.device = device
        self.ports = free_ports(config["brokers"])
        self.raw = cluster_raw(config, self.ports)
        self.bootstrap = [f"127.0.0.1:{p}" for p in self.ports]
        self.controller = None
        self.standbys: list = []
        self.logs: list = []

    def start(self) -> None:
        import torch

        from ripplemq_tpu_torch.broker.server import BrokerServer
        from ripplemq_tpu_torch.metadata.cluster_config import (
            parse_cluster_config,
        )

        cfg_path = os.path.join(self.workdir, "cluster.json")
        with open(cfg_path, "w") as f:
            json.dump(self.raw, f)
        config = parse_cluster_config(self.raw)
        # The other brokers first: they boot while this process builds
        # the controller's engine.
        env = dict(os.environ, PYTHONPATH=ROOT)
        for i in range(1, len(self.ports)):
            log = open(os.path.join(self.workdir, f"broker{i}.log"), "w")
            self.logs.append(log)
            self.standbys.append(subprocess.Popen(
                [sys.executable, "-m", "ripplemq_tpu_torch.broker",
                 "--id", str(i), "--config", cfg_path,
                 "--data-dir", self.workdir, "--log-level", "WARNING",
                 "--device", self.device],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        self.controller = BrokerServer(
            0, config, net=None,
            data_dir=os.path.join(self.workdir, "broker-0"),
            device=torch.device(self.device))
        self.controller.start()

    def wait_ready(self, timeout_s: float = 240.0) -> None:
        """Every partition led, and the controller's boot-time warm of
        its device programs finished (the server warms every active-set
        bucket of its shape itself; the harness adds none)."""
        from ripplemq_tpu_torch.client.metadata import MetadataManager
        from ripplemq_tpu_torch.wire.transport import TcpClient

        transport = TcpClient()
        meta = MetadataManager(transport, self.bootstrap,
                               refresh_interval_s=3600, rpc_timeout_s=5.0)
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                self.check_alive()
                try:
                    meta.refresh()
                    t = meta.topic(TOPIC)
                    if (t is not None and t.assignments
                            and all(a.leader is not None
                                    for a in t.assignments)
                            and self.controller.dataplane is not None):
                        break
                except Exception:
                    pass
                if time.monotonic() > deadline:
                    raise RuntimeError("the cluster never led every "
                                       "partition")
                time.sleep(0.2)
        finally:
            meta.close()
            transport.close()
        wt = getattr(self.controller, "_warm_thread", None)
        if wt is not None:
            wt.join(timeout=max(1.0, deadline - time.monotonic()))

    def check_alive(self) -> None:
        for i, p in enumerate(self.standbys, 1):
            if p.poll() is not None:
                raise RuntimeError(f"broker {i} exited with {p.returncode}")

    def pids(self) -> list[int]:
        return [p.pid for p in self.standbys]

    def pause_standbys(self, timeout_s: float = 10.0) -> int:
        """SIGSTOP every other broker and wait until the kernel shows
        each stopped; returns that moment (CLOCK_MONOTONIC ns). From
        then on no standby can take or answer anything."""
        for p in self.standbys:
            p.send_signal(signal.SIGSTOP)
        deadline = time.monotonic() + timeout_s
        while not all(proc_state(p.pid) in ("T", "") for p in self.standbys):
            if time.monotonic() > deadline:
                raise RuntimeError("a standby did not stop")
            time.sleep(0.001)
        return time.monotonic_ns()

    def resume_standbys(self) -> None:
        for p in self.standbys:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)

    def stop_standbys(self) -> None:
        """SIGTERM: each broker stops its server and closes its store,
        so what it acked is on disk for the read-back."""
        self.resume_standbys()
        for p in self.standbys:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.standbys:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def stop(self) -> None:
        if self.controller is not None:
            self.controller.stop()
            self.controller = None
        self.stop_standbys()
        for log in self.logs:
            log.close()

    def store_dir(self, broker: int) -> str:
        return os.path.join(self.workdir, f"broker-{broker}", "segments")

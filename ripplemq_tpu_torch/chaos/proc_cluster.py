"""Process-level N-broker cluster: real `python -m ripplemq_tpu_torch.broker`
subprocesses, real TCP sockets, real on-disk stores.

This is the deployment shape (docker-compose runs exactly these
processes) promoted from tests/test_process_cluster.py's fixture
plumbing into the chaos plane, so the seeded nemesis can drive the
faults real deployments see — SIGKILL'd processes (no atexit, no flush,
no socket shutdown) and damaged disks injected between a kill and the
restart — with the same replayable schedules and the same end-to-end
safety checker as the in-proc backend (MegaScale-style fault drills,
arXiv:2402.15627; Jepsen method, arXiv:2003.10554).

Capability surface (what the reference's Nemesis and chaos.harness
program against; InProcCluster implements the same names):

  brokers, config, start/stop, wait_for_leaders, client(name),
  kill(b) / restart(b), broker_addr(b), leader_of_key(topic, pid),
  controller_ready(), inject_disk_fault(b, kind, salt),
  topic_view(topic), merge_candidates(), admin_split(topic, pid),
  admin_merge(topic, parent, child)

Network-layer ops (partition/drop/delay/dup) are deliberately absent —
real kernels don't take InProcNetwork hooks; `make_schedule(backend=
"proc")` draws only from the ops this backend can apply.

Twin of `ripplemq_tpu/chaos/proc_cluster.py` (PyTorch port): the same code,
importing only the port's modules. The brokers' config file is the YAML
schema written as JSON (`cluster.json`; JSON is YAML, so the CLI's
`load_cluster_config` reads it). The brokers are the port's CLI,
`python -m ripplemq_tpu_torch.broker ... --device <d>`: `ProcCluster(...,
device=None)` means CUDA and raises at construction on a host without a
GPU; `device="cpu"` runs every broker's device work on the CPU.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional

from ripplemq_tpu_torch.chaos.cluster import small_engine
from ripplemq_tpu_torch.chaos.diskfaults import inject_disk_fault
from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
from ripplemq_tpu_torch.metadata.models import BrokerInfo, Topic, topics_from_wire
from ripplemq_tpu_torch.utils.logs import get_logger
from ripplemq_tpu_torch.wire.transport import TcpClient

log = get_logger("proc_cluster")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_ports(n: int) -> list[int]:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def make_proc_cluster_config(ports: list[int], topics=None,
                             durability: str = "async",
                             spare_slots: int = 0,
                             **kw) -> ClusterConfig:
    """ClusterConfig for a localhost process cluster. Small segments so
    chaos runs actually rotate (sealed segments + RS shards are what the
    disk-fault matrix attacks); timings between the in-proc cluster's
    (too twitchy for cross-process scheduling) and production's (too
    slow for a test budget). `spare_slots` provisions engine partition
    slots beyond the topic total — the pool online splits spend."""
    topics = topics or (Topic("topic1", 2, 3),)
    engine = kw.pop("engine", None) or small_engine(
        partitions=sum(t.partitions for t in topics) + int(spare_slots),
        replicas=max(t.replication_factor for t in topics),
        slots=256, slot_bytes=64, max_batch=16, read_batch=16,
        max_consumers=16, max_offset_updates=8,
    )
    kw.setdefault("election_timeout_s", 0.5)
    kw.setdefault("metadata_election_timeout_s", 1.0)
    kw.setdefault("membership_poll_s", 0.3)
    kw.setdefault("rpc_timeout_s", 5.0)
    kw.setdefault("segment_bytes", 1 << 16)
    return ClusterConfig(
        brokers=tuple(
            BrokerInfo(i, "127.0.0.1", p) for i, p in enumerate(ports)
        ),
        topics=tuple(topics),
        engine=engine,
        durability=durability,
        **kw,
    )


def _config_yaml_dict(config: ClusterConfig) -> dict:
    """ClusterConfig → the YAML schema `python -m ripplemq_tpu_torch.broker`
    loads (the inverse of metadata.cluster_config.parse_cluster_config
    for the fields a process cluster needs)."""
    e = config.engine
    return {
        "brokers": [
            {"id": b.broker_id, "host": b.host, "port": b.port}
            for b in config.brokers
        ],
        "topics": [
            {"name": t.name, "partitions": t.partitions,
             "replication_factor": t.replication_factor}
            for t in config.topics
        ],
        "engine": {
            "partitions": e.partitions, "replicas": e.replicas,
            "slots": e.slots, "slot_bytes": e.slot_bytes,
            "max_batch": e.max_batch, "read_batch": e.read_batch,
            "max_consumers": e.max_consumers,
            "max_offset_updates": e.max_offset_updates,
            # The engine binding: a broker that dropped these would boot
            # (or, promoted, bind) the legacy append in place of the
            # fused + packed engine it was configured with.
            "fused_control": e.fused_control,
            "packed_writes": e.packed_writes,
            "settle_window": e.settle_window,
        },
        "election_timeout_s": config.election_timeout_s,
        "metadata_election_timeout_s": config.metadata_election_timeout_s,
        "membership_poll_s": config.membership_poll_s,
        "group_session_timeout_s": config.group_session_timeout_s,
        "group_retention_s": config.group_retention_s,
        # Control-plane wave batching: the wave cadence/size and the
        # heartbeat relay interval must round-trip or the subprocess
        # backend runs a different control-plane shape than in-proc.
        "meta_batch_s": config.meta_batch_s,
        "meta_batch_max": config.meta_batch_max,
        "heartbeat_relay_s": config.heartbeat_relay_s,
        "metadata_refresh_s": config.metadata_refresh_s,
        "rpc_timeout_s": config.rpc_timeout_s,
        "controller_id": config.controller_id,
        "standby_count": config.standby_count,
        "segment_bytes": config.segment_bytes,
        "store_retention_bytes": config.store_retention_bytes,
        "durability": config.durability,
        "replication": config.replication,
        "pid_retention_s": config.pid_retention_s,
        "follower_reads": config.follower_reads,
        "follower_page_cache_bytes": config.follower_page_cache_bytes,
        # The batcher operating point and worker sizing used to be
        # dropped here: an in-proc soak and its subprocess twin ran
        # DIFFERENT coalesce/chain/pipeline shapes whenever a test
        # tuned them (found by ripplelint's config_plumbing rule; the
        # round-trip lock lives in tests/test_process_cluster.py).
        "coalesce_s": config.coalesce_s,
        "read_coalesce_s": config.read_coalesce_s,
        "chain_depth": config.chain_depth,
        "pipeline_depth": config.pipeline_depth,
        "rpc_workers": config.rpc_workers,
        "host_workers": config.host_workers,
        "host_ring_bytes": config.host_ring_bytes,
        "repl_pipeline_depth": config.repl_pipeline_depth,
        "linearizable_reads": config.linearizable_reads,
        "obs": config.obs,
        "lock_witness": config.lock_witness,
        # Causal tracing: sampling cadence and ring sizing must
        # round-trip — a proc-backend broker that silently ran
        # trace_sample_n=0 would record no spans and the acceptance
        # tree would mysteriously miss every broker-side hop.
        "trace_sample_n": config.trace_sample_n,
        "span_ring_slots": config.span_ring_slots,
        "slo_rails_file": config.slo_rails_file,
        # SLO autopilot (the control loop must run the same operating
        # point on the subprocess backend as in-proc — the exact drop
        # class the config_plumbing lint exists to prevent).
        "slo_p99_ack_ms": config.slo_p99_ack_ms,
        "slo_p99_consume_ms": config.slo_p99_consume_ms,
        "slo_tick_s": config.slo_tick_s,
        "slo_recover_s": config.slo_recover_s,
        "slo_read_coalesce_min_s": config.slo_read_coalesce_min_s,
        "slo_read_coalesce_max_s": config.slo_read_coalesce_max_s,
        "slo_chain_depth_min": config.slo_chain_depth_min,
        "slo_chain_depth_max": config.slo_chain_depth_max,
        "slo_settle_window_min": config.slo_settle_window_min,
        "slo_shed_occupancy": config.slo_shed_occupancy,
        "slo_quotas": {t: r for t, r in config.slo_quotas},
        "slo_tenant_tiers": {t: v for t, v in config.slo_tenant_tiers},
        # Elastic partitions: the trigger/hysteresis/handoff rails must
        # round-trip or an in-proc soak and its subprocess twin run
        # different reconfiguration behavior.
        "split_auto": config.split_auto,
        "split_evidence_ticks": config.split_evidence_ticks,
        "split_merge_idle_ticks": config.split_merge_idle_ticks,
        "split_handoff_timeout_s": config.split_handoff_timeout_s,
        "split_max_partitions": config.split_max_partitions,
    }


class _ProcHandle:
    """One broker subprocess (None while killed)."""

    __slots__ = ("broker_id", "addr", "proc")

    def __init__(self, broker_id: int, addr: str) -> None:
        self.broker_id = broker_id
        self.addr = addr
        self.proc: Optional[subprocess.Popen] = None


class ProcCluster:
    """See module docstring. `data_dir` is REQUIRED in spirit (durable
    per-broker stores are what make kill/restart meaningful); pass a
    tempdir. Broker stdout/stderr land in <data_dir>/broker-<id>.log.
    `device`: every broker's `--device` (CUDA when None)."""

    def __init__(self, config: Optional[ClusterConfig] = None,
                 n_brokers: int = 3, data_dir: Optional[str] = None,
                 topics=None, durability: str = "async",
                 device=None) -> None:
        if device is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device available: pass device='cpu' to run "
                    "the brokers' device work on the CPU explicitly")
            device = "cuda"
        self.device = str(device)
        if config is None:
            config = make_proc_cluster_config(
                free_ports(n_brokers), topics=topics, durability=durability,
            )
        self.config = config
        if data_dir is None:
            import tempfile

            data_dir = tempfile.mkdtemp(prefix="proc-chaos-")
        self.data_dir = str(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        # The broker CLI's schema, written as JSON (which YAML reads).
        self.config_path = os.path.join(self.data_dir, "cluster.json")
        with open(self.config_path, "w") as f:
            json.dump(_config_yaml_dict(config), f)
        self.env = dict(
            os.environ,
            PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        )
        self.brokers: dict[int, _ProcHandle] = {
            b.broker_id: _ProcHandle(b.broker_id, b.address)
            for b in config.brokers
        }
        self._clients: list[TcpClient] = []

    # ------------------------------------------------------------ lifecycle

    def _spawn(self, broker_id: int) -> None:
        h = self.brokers[broker_id]
        logf = open(os.path.join(self.data_dir, f"broker-{broker_id}.log"),
                    "ab")
        h.proc = subprocess.Popen(
            [sys.executable, "-m", "ripplemq_tpu_torch.broker",
             "--id", str(broker_id), "--config", self.config_path,
             "--device", self.device,
             # JSON-lines logs: each soak's broker-N.log is machine-
             # greppable (jq) next to the verdict's merged timeline.
             "--data-dir", self.data_dir, "--log-json"],
            env=self.env, cwd=_REPO, stdout=logf, stderr=subprocess.STDOUT,
        )
        logf.close()  # the child holds its own fd

    def start(self) -> None:
        for bid in self.brokers:
            self._spawn(bid)

    def stop(self) -> None:
        for h in self.brokers.values():
            if h.proc is not None:
                h.proc.terminate()
        for h in self.brokers.values():
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait(timeout=10)
                h.proc = None
        for c in self._clients:
            try:
                c.close()
            except Exception:
                pass
        self._clients = []

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ---------------------------------------------------------- fault hooks

    def kill(self, broker_id: int) -> None:
        """SIGKILL — no flush, no socket teardown, no shutdown hook: the
        process shape of a kernel panic or OOM kill."""
        h = self.brokers[broker_id]
        if h.proc is not None:
            h.proc.kill()
            h.proc.wait(timeout=30)
            h.proc = None

    def kill_all(self) -> float:
        """Correlated full-cluster SIGKILL (the durability drill's
        hammer); returns the wall-clock kill time for the checker's
        flush-lag accounting."""
        t = time.time()
        for bid in self.brokers:
            self.kill(bid)
        return t

    def restart(self, broker_id: int) -> None:
        """Boot a fresh process for a killed broker (recovers from its
        data dir — including quarantine of injected disk damage)."""
        self._spawn(broker_id)

    def store_dir(self, broker_id: int) -> str:
        return os.path.join(self.data_dir, f"broker-{broker_id}",
                            "segments")

    def inject_disk_fault(self, broker_id: int, kind: str,
                          salt: int = 0) -> dict:
        h = self.brokers[broker_id]
        if h.proc is not None:
            raise RuntimeError(
                f"broker {broker_id} is alive: disk faults are injected "
                f"between kill and restart"
            )
        desc = inject_disk_fault(self.store_dir(broker_id), kind, salt)
        log.info("injected %s into broker %d store: %s", kind, broker_id,
                 desc)
        return desc

    # ------------------------------------------------------------- clients

    def client(self, name: str = "client") -> TcpClient:
        del name  # TCP sources are ephemeral ports, not labels
        c = TcpClient()
        self._clients.append(c)
        return c

    def broker_addr(self, broker_id: int) -> str:
        return self.config.broker(broker_id).address

    def _live_addrs(self, exclude=()) -> list[str]:
        return [
            h.addr for bid, h in self.brokers.items()
            if bid not in exclude and h.proc is not None
        ]

    def _topics_from_any(self, client, exclude=()) -> Optional[list]:
        for addr in self._live_addrs(exclude):
            try:
                resp = client.call(addr, {"type": "meta.topics"},
                                   timeout=2.0)
            except Exception:
                continue
            if resp.get("ok"):
                return topics_from_wire(resp.get("topics", []))
        return None

    def leader_of_key(self, topic: str, pid: int,
                      exclude=()) -> Optional[int]:
        client = self._meta_client()
        topics = self._topics_from_any(client, exclude)
        if not topics:
            return None
        for t in topics:
            if t.name == topic:
                a = t.assignment_for(pid)
                return a.leader if a is not None else None
        return None

    def _meta_client(self) -> TcpClient:
        if not self._clients:
            return self.client("meta")
        return self._clients[0]

    def stripe_holders(self) -> tuple[int, ...]:
        """Replicated stripe→member map over the admin.stats surface
        (the nemesis's stripe-op resolution; empty until a standby
        joins or in full-copy mode)."""
        client = self._meta_client()
        for addr in self._live_addrs():
            try:
                resp = client.call(addr, {"type": "admin.stats"},
                                   timeout=2.0)
            except Exception:
                continue
            if resp.get("ok"):
                return tuple(int(b) for b in
                             resp.get("stripe_holders", ()))
        return ()

    def topic_view(self, topic: str) -> list:
        """Current assignment list for a topic (PartitionAssignment
        objects, elastic surface included) over the meta.topics wire —
        the capability InProcCluster serves from a live manager."""
        client = self._meta_client()
        topics = self._topics_from_any(client) or []
        for t in topics:
            if t.name == topic:
                return list(t.assignments)
        return []

    def merge_candidates(self) -> list:
        """(topic, parent, child) triples currently mergeable, derived
        from the wire topic view (adjacent active split pairs). Open
        handoffs are not visible here — admin.merge's pre-check refuses
        those with a typed merge_infeasible, which the nemesis logs as
        a no-op."""
        out = []
        for t in self.config.topics:
            assigns = {a.partition_id: a for a in self.topic_view(t.name)}
            for a in assigns.values():
                if a.origin < 0 or a.state != "active":
                    continue
                p = assigns.get(a.origin)
                if (p is not None and p.state == "active"
                        and p.range_hi == a.range_lo):
                    out.append((t.name, a.origin, a.partition_id))
        return out

    def admin_split(self, topic: str, pid: int) -> dict:
        return self._admin_call({"type": "admin.split", "topic": topic,
                                 "partition": int(pid)})

    def admin_merge(self, topic: str, parent: int, child: int) -> dict:
        return self._admin_call({"type": "admin.merge", "topic": topic,
                                 "parent": int(parent),
                                 "child": int(child)})

    def _admin_call(self, req: dict) -> dict:
        client = self._meta_client()
        last: dict = {"ok": False,
                      "error": "unavailable: no live broker reachable"}
        for addr in self._live_addrs():
            try:
                last = client.call(addr, req, timeout=8.0)
            except Exception as e:
                last = {"ok": False,
                        "error": f"unavailable: {type(e).__name__}: {e}"}
                continue
            return last
        return last

    def controller_id(self) -> Optional[int]:
        client = self._meta_client()
        for addr in self._live_addrs():
            try:
                resp = client.call(addr, {"type": "admin.stats"},
                                   timeout=2.0)
            except Exception:
                continue
            ctrl = resp.get("controller") or {}
            if ctrl.get("id") is not None:
                return int(ctrl["id"])
        return None

    def controller_ready(self) -> bool:
        """Controller advertised AND at least one replication standby
        joined (settled appends then provably exist on a promotable
        peer — the precondition chaos runs wait for before the first
        crash)."""
        client = self._meta_client()
        for addr in self._live_addrs():
            try:
                resp = client.call(addr, {"type": "admin.stats"},
                                   timeout=2.0)
            except Exception:
                continue
            ctrl = resp.get("controller") or {}
            if ctrl.get("id") is not None and ctrl.get("standbys"):
                return True
        return False

    def wait_for_leaders(self, timeout: float = 120.0) -> None:
        client = self._meta_client()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            topics = self._topics_from_any(client)
            if topics and all(
                t.assignments
                and all(a.leader is not None for a in t.assignments)
                for t in topics
            ):
                return
            time.sleep(0.3)
        raise AssertionError(
            "process cluster never elected leaders for all partitions"
        )

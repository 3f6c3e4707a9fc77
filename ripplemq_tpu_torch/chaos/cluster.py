"""In-process N-broker cluster: the single-process fake-transport
multi-broker rig SURVEY.md §4 prescribes (the reference could only
exercise multi-broker behavior inside docker-compose).

Library-resident (moved from tests/broker_harness.py, which re-exports
it) so the chaos plane and profiles/chaos_soak.py can build clusters
without importing the test tree.

Twin of `ripplemq_tpu/chaos/cluster.py` (PyTorch port): the same code,
importing only the port's modules. `InProcCluster(..., device=None)`
passes `device` to every broker: CUDA when None (each broker raises
without a GPU), `device="cpu"` for CPU runs.
"""

from __future__ import annotations

import time

from ripplemq_tpu_torch.broker.server import BrokerServer
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
from ripplemq_tpu_torch.metadata.models import BrokerInfo, Topic
from ripplemq_tpu_torch.wire import InProcNetwork


def small_engine(partitions: int, replicas: int, **kw) -> EngineConfig:
    """Small-dimension engine for in-proc clusters (identical defaults
    to tests/helpers.small_cfg — CPU-cheap rounds, real semantics)."""
    base = dict(
        partitions=partitions,
        replicas=replicas,
        slots=64,
        slot_bytes=32,
        max_batch=8,
        read_batch=8,
        max_consumers=8,
        max_offset_updates=4,
    )
    base.update(kw)
    return EngineConfig(**base)


def make_cluster_config(n_brokers=3, topics=None, engine=None,
                        spare_slots=0, **kw) -> ClusterConfig:
    """`spare_slots`: extra engine partition slots beyond the topics'
    total — the pool online splits spend (broker/manager.py). The
    default engine is sized exactly to the topic table, so elastic runs
    must ask for spares explicitly."""
    topics = topics or (Topic("topic1", 2, 3), Topic("topic2", 1, 3))
    engine = engine or small_engine(
        partitions=sum(t.partitions for t in topics) + int(spare_slots),
        replicas=max(t.replication_factor for t in topics),
    )
    # Fast timings for in-proc runs; production defaults mirror the
    # reference's constants (1 s elections, 10 s membership poll) and
    # would slow every bootstrap and failover path by seconds.
    kw.setdefault("election_timeout_s", 0.1)
    kw.setdefault("metadata_election_timeout_s", 0.6)
    kw.setdefault("membership_poll_s", 0.2)
    return ClusterConfig(
        brokers=tuple(
            BrokerInfo(i, "broker", 9000 + i) for i in range(n_brokers)
        ),
        topics=tuple(topics),
        engine=engine,
        rpc_timeout_s=kw.pop("rpc_timeout_s", 5.0),
        **kw,
    )


class InProcCluster:
    def __init__(self, config: ClusterConfig | None = None, n_brokers=3,
                 data_dir=None, broker_kwargs=None, device=None):
        """`data_dir`: optional root for per-broker durable stores
        (<data_dir>/broker-<id>); enables restart-with-recovery (the
        randomized soak's kill/restart schedule). `broker_kwargs`:
        optional {broker_id: extra BrokerServer kwargs} — e.g. the
        lockstep drill gives the controller `engine_mode="spmd"` and
        `engine_workers=[...]` while the standbys stay local.
        `device`: every broker's device (CUDA when None)."""
        self.config = config or make_cluster_config(n_brokers)
        self.net = InProcNetwork()
        self._data_dir = data_dir
        self._broker_kwargs = dict(broker_kwargs or {})
        self.device = device
        self.brokers: dict[int, BrokerServer] = {}
        for b in self.config.brokers:
            self.brokers[b.broker_id] = self._make(b.broker_id)

    def _make(self, broker_id: int) -> BrokerServer:
        data_dir = None
        if self._data_dir is not None:
            import os

            data_dir = os.path.join(str(self._data_dir),
                                    f"broker-{broker_id}")
        return BrokerServer(
            broker_id,
            self.config,
            net=self.net,
            tick_interval_s=0.02,
            duty_interval_s=0.05,
            data_dir=data_dir,
            device=self.device,
            **self._broker_kwargs.get(broker_id, {}),
        )

    def kill(self, broker_id: int) -> None:
        """Hard-kill one broker: unreachable AND stopped (its durable
        state, if any, survives for restart)."""
        self.net.set_down(self.brokers[broker_id].addr)
        self.brokers[broker_id].stop()

    def restart(self, broker_id: int) -> BrokerServer:
        """Boot a fresh process-equivalent for a killed broker (recovers
        from its data_dir when the cluster has one)."""
        self.net.set_up(self.brokers[broker_id].addr)
        b = self._make(broker_id)
        self.brokers[broker_id] = b
        b.start()
        return b

    def start(self) -> None:
        for b in self.brokers.values():
            b.start()

    def stop(self) -> None:
        for b in self.brokers.values():
            b.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- chaos capability surface (mirrored by chaos.proc_cluster) --
    def client(self, name="client"):
        return self.net.client(name)

    def broker_addr(self, broker_id: int) -> str:
        return self.config.broker(broker_id).address

    def leader_of_key(self, topic: str, pid: int, exclude=()):
        """Partition leader as seen by any non-excluded broker (the
        nemesis excludes its currently-crashed set)."""
        any_b = next(
            (b for i, b in self.brokers.items() if i not in exclude), None
        )
        if any_b is None:
            return None
        return any_b.manager.leader_of((topic, pid))

    def stripe_holders(self) -> tuple[int, ...]:
        """The replicated stripe→member map as any live broker sees it
        (empty before a standby joins / in full-copy mode) — the
        nemesis's stripe-op resolution surface."""
        for b in self.brokers.values():
            if not b.stopped:
                return tuple(b.manager.current_stripe_map())
        return ()

    def controller_id(self):
        """Current controller broker id per any live broker's view
        (None when every broker is down)."""
        for b in self.brokers.values():
            if not b.stopped:
                return b.manager.current_controller()
        return None

    def topic_view(self, topic: str) -> list:
        """One live broker's current assignment list for a topic
        (PartitionAssignment objects, elastic surface included) — the
        nemesis's split-candidate resolution and the harness's dynamic
        final-log collection read this."""
        for b in self.brokers.values():
            if not b.stopped:
                for t in b.manager.get_topics():
                    if t.name == topic:
                        return list(t.assignments)
        return []

    def merge_candidates(self) -> list:
        """(topic, parent, child) triples currently mergeable, per a
        live broker's replicated view."""
        for b in self.brokers.values():
            if not b.stopped:
                return b.manager.merge_candidates()
        return []

    def admin_split(self, topic: str, pid: int) -> dict:
        """Fire admin.split at any live broker (the handler proposes
        through the metadata leader and polls its local apply)."""
        return self._admin_call({"type": "admin.split", "topic": topic,
                                 "partition": int(pid)})

    def admin_merge(self, topic: str, parent: int, child: int) -> dict:
        return self._admin_call({"type": "admin.merge", "topic": topic,
                                 "parent": int(parent),
                                 "child": int(child)})

    def _admin_call(self, req: dict) -> dict:
        client = self.client("reconfig")
        last: dict = {"ok": False,
                      "error": "unavailable: no live broker reachable"}
        for bid, b in self.brokers.items():
            if b.stopped:
                continue
            try:
                last = client.call(self.broker_addr(bid), req, timeout=5.0)
            except Exception as e:
                last = {"ok": False,
                        "error": f"unavailable: {type(e).__name__}: {e}"}
                continue
            return last
        return last

    def controller_ready(self) -> bool:
        """Controller known with >= 1 replication standby joined (the
        precondition chaos runs wait for before the first crash)."""
        any_b = next(iter(self.brokers.values()))
        ctrl = any_b.manager.current_controller()
        return (ctrl in self.brokers
                and bool(self.brokers[ctrl].manager.current_standbys()))

    def inject_disk_fault(self, broker_id: int, kind: str,
                          salt: int = 0) -> dict:
        """Damage a KILLED broker's on-disk store (requires a data_dir
        cluster; the kill closed the store, the restart must rebuild or
        quarantine)."""
        from ripplemq_tpu_torch.chaos.diskfaults import inject_disk_fault

        if self._data_dir is None:
            raise RuntimeError("disk faults need a data_dir cluster")
        if not self.brokers[broker_id].stopped:
            # Mirror ProcCluster's guard: damaging a store a LIVE
            # BrokerServer holds open desyncs its append position from
            # the file — later appends interleave garbage frames and the
            # run reports corruption unrelated to the scheduled fault
            # instead of testing recovery.
            raise RuntimeError(
                f"broker {broker_id} is alive: disk faults are injected "
                f"between kill and restart"
            )
        import os

        store_dir = os.path.join(str(self._data_dir),
                                 f"broker-{broker_id}", "segments")
        return inject_disk_fault(store_dir, kind, salt)

    def wait_for_leaders(self, timeout=30.0) -> None:
        """Block until every configured partition has an advertised leader
        on every broker's view (the bootstrap fixpoint, SURVEY.md §3.1)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(self._all_leaders_known(b) for b in self.brokers.values()):
                return
            time.sleep(0.05)
        states = {
            i: [
                (t.name, a.partition_id, a.leader)
                for t in b.manager.get_topics()
                for a in t.assignments
            ]
            for i, b in self.brokers.items()
        }
        raise AssertionError(f"leaders not established: {states}")

    def _all_leaders_known(self, broker: BrokerServer) -> bool:
        topics = broker.manager.get_topics()
        if not topics or not any(t.assignments for t in topics):
            return False
        for t in topics:
            for a in t.assignments:
                if a.leader is None:
                    return False
        return True

    def leader_broker(self, topic: str, partition: int) -> BrokerServer:
        any_b = next(iter(self.brokers.values()))
        leader = any_b.manager.leader_of((topic, partition))
        assert leader is not None
        return self.brokers[leader]

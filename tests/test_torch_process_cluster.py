"""Multi-PROCESS cluster: real TCP sockets, separate broker processes.

The reference's only multi-node exercise is its docker-compose cluster
plus the sample apps (SURVEY.md §4; BASELINE.json config #1's 5-broker
round trip). This boots 3 brokers via the actual CLI entry
(`python -m ripplemq_tpu_torch.broker`), round-trips produce→consume→commit
through the client SDK over TCP, and runs the sample producer/consumer
programs against the live cluster.

The process plumbing itself (port allocation, config YAML, spawn/kill/
restart) lives in `ripplemq_tpu_torch.chaos.proc_cluster` — promoted there so
the chaos plane can SIGKILL and disk-fault the same deployment shape;
this module exercises the client-facing round trip over it.

Twin of `tests/test_process_cluster.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

import pytest
from tests.torch_port_modules import admit

admit(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def process_cluster(tmp_path):
    from ripplemq_tpu_torch.chaos.proc_cluster import (
        ProcCluster,
        free_ports,
        make_proc_cluster_config,
    )
    from ripplemq_tpu_torch.metadata.models import Topic

    config = make_proc_cluster_config(
        free_ports(3),
        topics=(Topic("topic1", 2, 3), Topic("topic2", 1, 3)),
        metadata_election_timeout_s=0.8,
    )
    cluster = ProcCluster(config=config, data_dir=str(tmp_path / "data"),
                          device="cpu")
    # Every broker logs each module it imports (CPython's import-time
    # report, on stderr into <data_dir>/broker-<id>.log): the round trip
    # below reads the logs back to show no port broker imported JAX.
    cluster.env["PYTHONPROFILEIMPORTTIME"] = "1"
    cluster.start()
    try:
        yield {"ports": [b.port for b in config.brokers],
               "cluster": cluster, "env": cluster.env,
               "data_dir": cluster.data_dir}
    finally:
        cluster.stop()


def test_three_process_tcp_roundtrip(process_cluster):
    from ripplemq_tpu_torch.client import ConsumerClient, ProducerClient

    bootstrap = [f"127.0.0.1:{p}" for p in process_cluster["ports"]]
    process_cluster["cluster"].wait_for_leaders(timeout=90.0)

    producer = ProducerClient(bootstrap, metadata_refresh_s=1.0)
    consumer = ConsumerClient(bootstrap, "proc-consumer",
                              metadata_refresh_s=1.0)
    try:
        # Warm the produce path first: the controller compiles its round
        # program on the first append, which under full-suite CPU load
        # can exceed one RPC timeout (retries are at-least-once, so the
        # warmup may legitimately duplicate — consumed below and ignored).
        for attempt in range(5):
            try:
                producer.produce("topic1", b"warmup")
                break
            except Exception:
                if attempt == 4:
                    raise
                time.sleep(2.0)
        sent = [b"proc-msg-%d" % i for i in range(12)]
        for m in sent:
            producer.produce("topic1", m)
        got = []
        deadline = time.monotonic() + 60
        while (not set(sent) <= set(got)
               and time.monotonic() < deadline):
            got.extend(consumer.consume("topic1"))
        # At-least-once: every sent message arrives; the warmup (and any
        # timeout-retry duplicates of it) may appear too.
        assert set(sent) <= set(got), sorted(set(sent) - set(got))
        assert set(got) <= set(sent) | {b"warmup"}
        # Offsets were committed (auto-commit-after-read): nothing replays.
        assert consumer.consume("topic1") == []
        assert consumer.consume("topic1") == []
    finally:
        producer.close()
        consumer.close()

    # The sample apps run against the same live cluster (the reference's
    # sample-producer/sample-consumer round trip, BASELINE.json config #1).
    env = process_cluster["env"]
    out = subprocess.run(
        [sys.executable, "-m", "ripplemq_tpu_torch.samples.producer",
         "--bootstrap", ",".join(bootstrap), "--topic", "topic2",
         "--count", "2", "--rate", "100"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("produced") == 2, out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ripplemq_tpu_torch.samples.consumer",
         "--bootstrap", ",".join(bootstrap), "--topics", "topic2",
         "--consumer-id", "sample-proc", "--interval", "0.05",
         "--max-polls", "40"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "consumed from topic2: b'Message 0'" in out.stdout, out.stdout
    assert "consumed from topic2: b'Message 1'" in out.stdout, out.stdout

    # No broker process of the port imported JAX or the JAX package, at
    # boot or while serving the round trip above.
    cluster = process_cluster["cluster"]
    cluster.stop()
    for bid in cluster.brokers:
        with open(os.path.join(process_cluster["data_dir"],
                               f"broker-{bid}.log")) as f:
            log_text = f.read()
        imported = re.findall(r"^import time:.*\|\s*([\w.]+)\s*$",
                              log_text, re.M)
        assert "ripplemq_tpu_torch.broker.server" in imported, bid
        assert not [m for m in imported
                    if m.split(".")[0] in ("jax", "jaxlib", "ripplemq_tpu")]


def test_config_yaml_dict_round_trips_every_field():
    """The config_plumbing rule's directed test: `_config_yaml_dict`
    once silently DROPPED coalesce_s /
    read_coalesce_s / chain_depth / pipeline_depth / rpc_workers /
    controller_id / metadata_refresh_s / store_retention_bytes — a
    proc-cluster chaos run launched subprocess brokers with the
    DEFAULTS for all of them, so an in-proc soak and its subprocess
    twin ran different operating points whenever a test tuned one.
    Every ClusterConfig field must survive serialize → YAML → parse."""
    import dataclasses

    import yaml

    from ripplemq_tpu_torch.chaos.proc_cluster import _config_yaml_dict
    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.metadata.cluster_config import (
        ClusterConfig,
        parse_cluster_config,
    )
    from ripplemq_tpu_torch.metadata.models import BrokerInfo, Topic

    config = ClusterConfig(
        brokers=(BrokerInfo(0, "127.0.0.1", 9101),
                 BrokerInfo(1, "127.0.0.1", 9102)),
        topics=(Topic("t", 2, 2),),
        engine=EngineConfig(partitions=2, replicas=2, slots=64,
                            slot_bytes=64, max_batch=8, read_batch=8,
                            max_consumers=8, max_offset_updates=4),
        # Every scalar deliberately NON-default so a dropped field
        # cannot hide behind its default on the parse side.
        election_timeout_s=0.7,
        metadata_election_timeout_s=1.3,
        membership_poll_s=0.9,
        group_session_timeout_s=2.2,
        group_retention_s=33.0,
        metadata_refresh_s=4.5,
        rpc_timeout_s=6.0,
        controller_id=1,
        standby_count=1,
        replication="striped",
        pid_retention_s=120.0,
        segment_bytes=1 << 16,
        store_retention_bytes=2 << 16,
        coalesce_s=0.004,
        chain_depth=2,
        pipeline_depth=3,
        read_coalesce_s=0.002,
        linearizable_reads=True,
        durability="strict",
        obs=False,
        lock_witness=True,
        rpc_workers=7,
    )
    raw = yaml.safe_load(yaml.safe_dump(_config_yaml_dict(config)))
    parsed = parse_cluster_config(raw)
    for f in dataclasses.fields(ClusterConfig):
        if f.name == "engine":
            continue  # engine shape fields are compared below
        assert getattr(parsed, f.name) == getattr(config, f.name), (
            f"ClusterConfig.{f.name} lost in the proc-cluster "
            f"serialization round trip"
        )
    for name in ("partitions", "replicas", "slots", "slot_bytes",
                 "max_batch", "read_batch", "max_consumers",
                 "max_offset_updates", "settle_window"):
        assert getattr(parsed.engine, name) == getattr(config.engine, name)

    # The SLO-autopilot fields ride a SECOND config: slo_p99_ack_ms > 0
    # is config-validated to require obs=True, and the first config's
    # non-default obs=False is itself load-bearing above — the two
    # non-default choices cannot coexist in one value.
    slo_config = dataclasses.replace(
        config,
        obs=True,
        slo_p99_ack_ms=17.0,
        slo_tick_s=0.25,
        slo_recover_s=21.0,
        slo_read_coalesce_min_s=0.0005,
        slo_read_coalesce_max_s=0.011,
        slo_chain_depth_min=2,
        slo_chain_depth_max=8,
        slo_settle_window_min=2,
        slo_shed_occupancy=0.6,
        slo_quotas=(("gold", 500.0), ("silver", 50.0)),
    )
    parsed2 = parse_cluster_config(
        yaml.safe_load(yaml.safe_dump(_config_yaml_dict(slo_config)))
    )
    for f in dataclasses.fields(ClusterConfig):
        if f.name == "engine":
            continue
        assert getattr(parsed2, f.name) == getattr(slo_config, f.name), (
            f"ClusterConfig.{f.name} lost in the proc-cluster "
            f"serialization round trip (slo config)"
        )


def test_config_yaml_dict_round_trips_engine_binding(tmp_path):
    """The engine's binding flags survive the process cluster's config
    file as the CLI loads it: a standby spawned from a fused + packed
    config boots (and, promoted, binds) the same engine."""
    import dataclasses

    from ripplemq_tpu_torch.chaos.proc_cluster import (
        ProcCluster,
        free_ports,
        make_proc_cluster_config,
    )
    from ripplemq_tpu_torch.metadata.cluster_config import load_cluster_config

    base = make_proc_cluster_config(free_ports(3))
    config = dataclasses.replace(base, engine=dataclasses.replace(
        base.engine, fused_control=True, packed_writes=True,
        settle_window=6))
    cluster = ProcCluster(config=config, data_dir=str(tmp_path),
                          device="cpu")
    loaded = load_cluster_config(cluster.config_path)
    assert loaded.engine == config.engine
    assert loaded == config


def test_cli_rejects_bad_config(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("brokers: []\n")
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "ripplemq_tpu_torch.broker",
         "--id", "7", "--config", str(bad), "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 2
    assert "error:" in out.stderr

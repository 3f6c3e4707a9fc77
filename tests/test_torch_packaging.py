"""Deployment packaging consistency: the compose topology and the docker
cluster config must agree, and both example configs load — through the
PyTorch port's `load_cluster_config`.

Twin of the example-config half of `tests/test_packaging.py` on the
port, plus one cross-package test: each example loads into the same
configuration in both packages. The Dockerfile half is not twinned: the
image installs the JAX package and copies only `ripplemq_tpu/`.
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import yaml

from ripplemq_tpu_torch.metadata.cluster_config import load_cluster_config
from tests.torch_port_modules import admit

admit(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_docker_cluster_config_loads_and_matches_compose():
    config = load_cluster_config(os.path.join(REPO, "examples",
                                              "cluster.docker.yaml"))
    with open(os.path.join(REPO, "docker-compose.yml")) as f:
        compose = yaml.safe_load(f)

    services = compose["services"]
    assert len(services) == len(config.brokers) == 5
    for b in config.brokers:
        name = f"broker{b.broker_id}"
        svc = services[name]
        # Broker addresses use the compose hostname on the internal port.
        assert svc["hostname"] == b.host
        assert svc["command"] == ["--id", str(b.broker_id)]
        # Every mapped port targets the container port the broker binds.
        assert svc["ports"][0].endswith(f":{b.port}")
        # Durable state is volume-backed (controller failover + shard
        # distribution assume per-broker persistent dirs).
        assert any(v.endswith(":/data") for v in svc["volumes"])
    # Host-side ports are distinct (clients bootstrap against any).
    host_ports = {s["ports"][0].split(":")[0] for s in services.values()}
    assert len(host_ports) == 5


def test_local_example_config_loads():
    config = load_cluster_config(os.path.join(REPO, "examples",
                                              "cluster.yaml"))
    assert len(config.brokers) == 5
    assert {t.name for t in config.topics} == {"topic1", "topic2"}


@pytest.mark.parametrize("name", ["cluster.yaml", "cluster.docker.yaml"])
def test_example_loads_as_the_reference_loads_it(name):
    from ripplemq_tpu.metadata.cluster_config import (
        load_cluster_config as ref_load,
    )

    path = os.path.join(REPO, "examples", name)
    got, want = load_cluster_config(path), ref_load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)

"""Shared helpers of the port's DataPlane tests (not collected: the name
does not start with `test_`).

Port planes run on the CPU (`device="cpu"`) with the reference tests'
engine shape: `port_cfg(**kw)` is the port's `EngineConfig` built from
the fields of `tests.helpers.small_cfg(**kw)`. `make_config` is the
port's `chaos.cluster.make_cluster_config` and `InProcCluster` the
port's in-proc cluster on the CPU: the names the reference tests import
from `tests/broker_harness.py`. `run_chaos` is the port's harness on the
CPU.
"""

from __future__ import annotations

import dataclasses

from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.chaos.cluster import InProcCluster as _InProcCluster
from ripplemq_tpu_torch.chaos.cluster import (  # noqa: F401
    make_cluster_config as make_config,
)
from ripplemq_tpu_torch.core.config import EngineConfig
from tests.helpers import small_cfg, wait_until  # noqa: F401


def port_cfg(**kw) -> EngineConfig:
    return EngineConfig(**dataclasses.asdict(small_cfg(**kw)))


class InProcCluster(_InProcCluster):
    """The port's in-proc cluster with every broker on the CPU (the
    reference tests' `tests.broker_harness.InProcCluster`, on the port)."""

    def __init__(self, config=None, n_brokers=3, data_dir=None,
                 broker_kwargs=None, device="cpu"):
        super().__init__(config, n_brokers, data_dir=data_dir,
                         broker_kwargs=broker_kwargs, device=device)


def port_dp(cfg: EngineConfig, **kw) -> DataPlane:
    """A port DataPlane on the CPU (mode "local"), not started."""
    return DataPlane(cfg, mode="local", device="cpu", **kw)


def read_all(dp, slot, replica=0, start=0):
    """Walk a slot's readable log from `start`, continuing from each
    answer's next_offset, until an answer does not advance."""
    msgs, offset = [], start
    while True:
        got, nxt = dp.read(slot, offset, replica=replica)
        if nxt == offset:
            return msgs
        msgs.extend(got)
        offset = nxt


def run_chaos(*args, device="cpu", **kw):
    """The port's `run_chaos` on the CPU."""
    from ripplemq_tpu_torch.chaos.harness import run_chaos as _run

    return _run(*args, device=device, **kw)

"""Shared helpers of the port's DataPlane tests (not collected: the name
does not start with `test_`).

Port planes run on the CPU (`device="cpu"`) with the reference tests'
engine shape: `port_cfg(**kw)` is the port's `EngineConfig` built from
the fields of `tests.helpers.small_cfg(**kw)`.
"""

from __future__ import annotations

import dataclasses

from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.core.config import EngineConfig
from tests.helpers import small_cfg


def port_cfg(**kw) -> EngineConfig:
    return EngineConfig(**dataclasses.asdict(small_cfg(**kw)))


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

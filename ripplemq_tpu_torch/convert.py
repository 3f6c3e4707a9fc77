"""Carry engine state and inputs between numpy and the port's tensors.

The reference engine's state and round inputs are NamedTuples of arrays;
given as numpy arrays (leaf by leaf, by field name, in either the named
or the fused-ctrl layout), these functions build the port's tensors on a
given device in the layout an `EngineConfig` asks for, and back. The
parity tests use them to start both engines from one state. A recovered
single-replica image (`broker.dataplane.recover_image`: the same named
leaves without the [R] axis) crosses the same way. Under the spmd
binding a rank holds one cell's [1, local_P, ...] shard:
`shard_state` cuts a whole [R, P, ...] state into this rank's shard,
and `gather_state` assembles the whole state back from every cell.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.core.state import (
    CTRL_FIELDS,
    FusedReplicaState,
    ReplicaState,
    StepInput,
    fuse_state,
)
from ripplemq_tpu_torch.ops.rs import default_device


def _fields(obj: Any) -> Mapping[str, Any]:
    if isinstance(obj, Mapping):
        return obj
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"expected a NamedTuple or mapping, got {type(obj).__name__}")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device).to(dtype)


def state_from_numpy(cfg: EngineConfig, state, device) -> ReplicaState | FusedReplicaState:
    """Engine state ([R, ...] leaves, either layout) → the port's state on
    `device`, fused iff `cfg.fused_control`."""
    f = _fields(state)
    if "ctrl" in f:
        ctrl = np.asarray(f["ctrl"])
        named = {name: ctrl[..., k, :] for k, name in enumerate(CTRL_FIELDS)}
    else:
        named = {name: f[name] for name in CTRL_FIELDS}
    out = ReplicaState(
        log_data=_tensor(f["log_data"], torch.uint8, device),
        offsets=_tensor(f["offsets"], torch.int32, device),
        **{name: _tensor(v, torch.int32, device) for name, v in named.items()},
    )
    return fuse_state(out) if cfg.fused_control else out


def input_from_numpy(inp, device) -> StepInput:
    """A round's (or a chain's, with a leading [K] axis) StepInput as
    numpy leaves → the port's StepInput of tensors on `device`.
    Missing or None `extents` stays None."""
    f = _fields(inp)
    ints = ("counts", "off_slots", "off_vals", "off_counts", "leader", "term")
    ext = f.get("extents")
    return StepInput(
        entries=_tensor(f["entries"], torch.uint8, device),
        extents=None if ext is None else _tensor(ext, torch.int32, device),
        **{name: _tensor(f[name], torch.int32, device) for name in ints},
    )


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """The port's state → {field name: numpy copy}, in its own layout."""
    return {name: leaf.detach().cpu().numpy().copy()
            for name, leaf in state._asdict().items()}


def image_from_numpy(image, device=None) -> ReplicaState:
    """A single-replica image ([P, ...] leaves by name, e.g. the
    reference's `recover_image` result) → the port's ReplicaState of
    tensors on `device`, CUDA when none is given (raises with no GPU
    unless `device="cpu"`)."""
    device = default_device(device)
    f = _fields(image)
    return ReplicaState(
        log_data=_tensor(f["log_data"], torch.uint8, device),
        offsets=_tensor(f["offsets"], torch.int32, device),
        **{name: _tensor(f[name], torch.int32, device) for name in CTRL_FIELDS},
    )


def image_to_numpy(image) -> dict[str, np.ndarray]:
    """The port's single-replica image → {field name: numpy copy} (the
    same leaf-wise copy as `state_to_numpy`)."""
    return state_to_numpy(image)


STATE_FIELDS = ReplicaState._fields


def shard_state(cfg: EngineConfig, state, mesh) -> ReplicaState | FusedReplicaState:
    """A whole engine state ([R, P, ...] numpy leaves by name, either
    layout — the reference's, from either binding) → this rank's cell of
    `mesh` as the port's [1, local_P, ...] shard on the mesh's device,
    fused iff `cfg.fused_control`."""
    f = _fields(state)
    if "ctrl" in f:
        ctrl = np.asarray(f["ctrl"])
        f = {**f, **{name: ctrl[..., k, :] for k, name in enumerate(CTRL_FIELDS)}}
    r, s = mesh.coords
    local_P = cfg.partitions // mesh.shape["part"]
    lo = s * local_P
    one = {name: np.asarray(f[name])[r:r + 1, lo:lo + local_P]
           for name in STATE_FIELDS}
    return state_from_numpy(cfg, one, mesh.device)


def gather_state(fns, state) -> dict[str, np.ndarray]:
    """The whole state of an spmd engine (`make_spmd_fns`, or a
    `LockstepController` around one) as {field name: [R, P, ...] numpy}
    in the named layout. Every rank of the mesh must call it (it is one
    `all_gather` a leaf); each gets the whole state."""
    return {name: fns.fetch_state(state, name) for name in STATE_FIELDS}


__all__ = ["state_from_numpy", "input_from_numpy", "state_to_numpy",
           "image_from_numpy", "image_to_numpy", "shard_state",
           "gather_state"]

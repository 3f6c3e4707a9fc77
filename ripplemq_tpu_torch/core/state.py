"""Replicated data-plane state as fixed-shape tensors (PyTorch port).

Twin of `ripplemq_tpu/core/state.py`. The layout is the reference's,
leaf for leaf, with one difference in where the replica axis lives: the
reference writes its step functions for ONE replica and adds the [R]
axis with `vmap`; the port keeps the [R] axis explicit, so the engine's
state leaves are `[R, P, ...]` and the step functions in `core.step`
reduce over dim 0 where the reference summed over the named axis.

Row format: every log slot is `slot_bytes` of uint8 with an embedded
8-byte header (payload length, then Raft term; both little-endian int32).
The physical log holds the last `slots` rows of each partition as a ring
plus a `max_batch`-row margin, so one round's window never wraps.

Dtypes are the reference's: uint8 rows and int32 bookkeeping. Code casts
to int64 only to index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripplemq_tpu_torch.core.config import EngineConfig


class ReplicaState(NamedTuple):
    """Data-plane state; leaves carry a leading [R] axis in the engine."""

    log_data: torch.Tensor      # uint8 [R, P, S+B, SB] — ring rows + margin
    log_end: torch.Tensor       # int32 [R, P] — next absolute storage offset
    last_term: torch.Tensor     # int32 [R, P] — term of the tail row
    current_term: torch.Tensor  # int32 [R, P] — latest term seen
    commit: torch.Tensor        # int32 [R, P] — commit index
    offsets: torch.Tensor       # int32 [R, P, C] — consumer offsets


# Bookkeeping scalars stacked (in this order) into FusedReplicaState.ctrl.
CTRL_FIELDS = ("log_end", "last_term", "current_term", "commit")
CTRL_K = len(CTRL_FIELDS)


class FusedReplicaState(NamedTuple):
    """ReplicaState with the four bookkeeping vectors stacked into ONE
    int32 ctrl tensor ([R, K, P] in the engine; EngineConfig.
    fused_control). The named accessors are views into ctrl."""

    log_data: torch.Tensor  # uint8 [R, P, S+B, SB]
    ctrl: torch.Tensor      # int32 [R, K, P] — CTRL_FIELDS, stacked
    offsets: torch.Tensor   # int32 [R, P, C]

    @property
    def log_end(self) -> torch.Tensor:
        return self.ctrl[..., 0, :]

    @property
    def last_term(self) -> torch.Tensor:
        return self.ctrl[..., 1, :]

    @property
    def current_term(self) -> torch.Tensor:
        return self.ctrl[..., 2, :]

    @property
    def commit(self) -> torch.Tensor:
        return self.ctrl[..., 3, :]


def fuse_state(state: ReplicaState) -> FusedReplicaState:
    """Stack the bookkeeping scalars into the fused layout (exact)."""
    ctrl = torch.stack(
        [getattr(state, f) for f in CTRL_FIELDS], dim=-2
    ).to(torch.int32)
    return FusedReplicaState(
        log_data=state.log_data, ctrl=ctrl, offsets=state.offsets
    )


def unfuse_state(state: FusedReplicaState) -> ReplicaState:
    """Split the fused layout back into named fields (exact inverse; the
    fields are copies, not views of ctrl)."""
    return ReplicaState(
        log_data=state.log_data,
        log_end=state.log_end.clone(),
        last_term=state.last_term.clone(),
        current_term=state.current_term.clone(),
        commit=state.commit.clone(),
        offsets=state.offsets,
    )


class StepInput(NamedTuple):
    """One replication round's input (per partition), fed identically to
    every replica. `extents` None means full write windows."""

    entries: torch.Tensor     # uint8 [P, B, SB] — packed rows
    counts: torch.Tensor      # int32 [P] — how many of B carry payloads
    off_slots: torch.Tensor   # int32 [P, U] — consumer-table slots to update
    off_vals: torch.Tensor    # int32 [P, U] — new absolute offsets
    off_counts: torch.Tensor  # int32 [P] — how many of U are valid
    leader: torch.Tensor      # int32 [P] — leader replica id (-1 = none)
    term: torch.Tensor        # int32 [P] — leader's term
    extents: torch.Tensor | None = None  # int32 [P] — rows the write covers


class StepOutput(NamedTuple):
    """Per-partition results of one round (replica-invariant)."""

    base: torch.Tensor       # int32 [P] — leader log_end before append
    votes: torch.Tensor      # int32 [P] — replicas that acked the round
    committed: torch.Tensor  # bool  [P] — quorum reached this round
    commit: torch.Tensor     # int32 [P] — post-round commit index


def init_state(cfg: EngineConfig, device: torch.device | str) -> ReplicaState:
    """Zero state for one replica (the engine stacks R of them)."""
    P, S, SB, C = cfg.partitions, cfg.slots, cfg.slot_bytes, cfg.max_consumers

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplicaState(
        log_data=zeros(P, S + cfg.max_batch, SB, dtype=torch.uint8),
        log_end=zeros(P),
        last_term=zeros(P),
        current_term=zeros(P),
        commit=zeros(P),
        offsets=zeros(P, C),
    )


def empty_input(cfg: EngineConfig, device: torch.device | str) -> StepInput:
    """An all-empty round (no appends, no offset commits, no leaders)."""
    P, B, SB, U = cfg.partitions, cfg.max_batch, cfg.slot_bytes, cfg.max_offset_updates

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return StepInput(
        entries=zeros(P, B, SB, dtype=torch.uint8),
        counts=zeros(P),
        off_slots=zeros(P, U),
        off_vals=zeros(P, U),
        off_counts=zeros(P),
        leader=torch.full((P,), -1, dtype=torch.int32, device=device),
        term=zeros(P),
        extents=zeros(P),
    )


def _le_int32(hdr: torch.Tensor) -> torch.Tensor:
    hdr = hdr.to(torch.int32)
    return hdr[..., 0] | (hdr[..., 1] << 8) | (hdr[..., 2] << 16) | (hdr[..., 3] << 24)


def row_lens(rows: torch.Tensor) -> torch.Tensor:
    """Payload lengths from packed rows' headers: uint8 [..., SB] → int32
    [...]. Little-endian, matching the host encoder."""
    return _le_int32(rows[..., 0:4])


def row_terms(rows: torch.Tensor) -> torch.Tensor:
    """Raft terms from packed rows' headers."""
    return _le_int32(rows[..., 4:8])

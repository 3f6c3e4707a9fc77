"""Raft data-plane steps over an explicit replica axis (PyTorch port).

Twin of `ripplemq_tpu/core/step.py`. The reference writes each step for
ONE replica against the named axis "replica" and lets `vmap` (or
`shard_map`) add that axis; its collectives then reduce across it. Here
every state leaf carries the replica axis as dim 0 ([R, P, ...]) and the
collectives are plain reductions over it:

- `lax.psum(x, "replica")` → `x.sum(0)` (replica-invariant, so the [P]
  result stands for every replica's copy);
- `lax.pmax(x, "replica")` → `x.amax(0)`;
- the leader broadcast → a sum over dim 0 of the value masked to the
  partition's leader (at most one replica contributes).

The round's semantics are the reference's, expression for expression:
acks (alive + Raft log matching + term current + capacity + work), the
ballot summed BEFORE any write, atomic commit, the ordered consumer-
offset blend, and the ALIGN-padded advance. The log write itself is the
separate write phase (`ops.append`), called by the engine.

Arithmetic stays in int32 as in the reference (torch int32 sums are
taken with `dtype=torch.int32`, so wrap-around behaves the same); int64
appears only as an index.

Every replica reduction goes through one small object, the replica
axis (`ReplicaAxis`): the leader broadcasts (`_bcast_from_leader`), the
ballot and the vote count (`sum`), and the commit index (`max`). The
default, `LOCAL`, holds the whole axis as dim 0 and reduces it with
`x.sum(0)` / `x.amax(0)`, adding no launch. The spmd binding
(`parallel.engine.make_spmd_fns`) passes an axis whose leaves hold ONE
replica's [1, local_P, ...] shard: its `sum` / `max` take that local
partial and `all_reduce` it over the mesh's replica group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripplemq_tpu_torch.core.config import ALIGN, EngineConfig
from ripplemq_tpu_torch.core.state import (
    FusedReplicaState,
    ReplicaState,
    StepInput,
    StepOutput,
    row_lens,
)

_I32 = torch.int32


class ReplicaAxis:
    """The replica axis held whole on this device: dim 0 of every leaf.

    `ids(R, device)` are the replica ids of dim 0's rows ([n, 1] int32),
    `rows(alive)` is a [P, R] liveness mask for those rows ([n, P]), and
    `sum` / `max` reduce dim 0. A binding that shards the axis overrides
    all four (see the module docstring)."""

    def ids(self, R: int, device) -> torch.Tensor:
        return torch.arange(R, dtype=_I32, device=device)[:, None]

    def rows(self, alive: torch.Tensor) -> torch.Tensor:
        return alive.t()

    def sum(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        return x.sum(0, dtype=x.dtype if dtype is None else dtype)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0)


LOCAL = ReplicaAxis()


def _bcast_from_leader(value: torch.Tensor, is_leader: torch.Tensor,
                       axis: ReplicaAxis = LOCAL) -> torch.Tensor:
    """Each partition's leader's value: [R, ...] masked by is_leader
    [R, P] (broadcast over trailing dims), summed over the replica axis."""
    mask = is_leader.reshape(is_leader.shape + (1,) * (value.ndim - is_leader.ndim))
    return axis.sum(torch.where(mask, value, torch.zeros_like(value)))


def _normalize_alive(alive: torch.Tensor, P: int, R: int) -> torch.Tensor:
    """Accept a [R] cluster-wide or [P, R] per-partition liveness mask;
    returns bool [P, R]."""
    alive = alive.to(torch.bool)
    if alive.ndim == 1:
        return alive[None, :].expand(P, R)
    return alive


def _padded_advance(counts: torch.Tensor) -> torch.Tensor:
    """Slots consumed by a round: counts rounded up to ALIGN (0 stays 0)."""
    return ((counts + ALIGN - 1) // ALIGN) * ALIGN


class ControlOut(NamedTuple):
    out: StepOutput          # per-partition round results, [P] each
    do_write: torch.Tensor   # bool [R, P] — replica writes the round's block
    extent: torch.Tensor     # int32 [P] — rows of the [B, SB] window written


def _write_extent(cfg: EngineConfig, inp: StepInput,
                  advance: torch.Tensor) -> torch.Tensor:
    """Rows the write phase covers: the host-declared extent, ALIGN-
    rounded and clamped to [advance, B]. None extents (or a config
    without packed writes) mean the full legacy window."""
    B = cfg.max_batch
    if not cfg.packed_writes or inp.extents is None:
        return torch.full_like(advance, B)
    ext = _padded_advance(inp.extents.clamp(0, B))
    return torch.maximum(ext, advance).clamp_max(B)


def _blend_offsets(cfg: EngineConfig, state_offsets: torch.Tensor,
                   inp: StepInput, do_write: torch.Tensor) -> torch.Tensor:
    """Committed consumer-offset updates blended into the [R, P, C] table.
    The U updates apply IN ORDER, so a later duplicate slot wins (an
    unordered scatter would not guarantee that)."""
    U = cfg.max_offset_updates
    C = cfg.max_consumers
    off_counts = inp.off_counts.clamp(0, U)
    new_offsets = state_offsets
    cols = torch.arange(C, dtype=_I32, device=state_offsets.device)[None, :]
    for u in range(U):
        apply_u = do_write & (u < off_counts)[None, :]            # [R, P]
        mask = (inp.off_slots[:, u : u + 1] == cols)[None] & apply_u[..., None]
        new_offsets = torch.where(mask, inp.off_vals[:, u : u + 1][None],
                                  new_offsets)
    return new_offsets


class _Ballot(NamedTuple):
    base: torch.Tensor        # int32 [P]
    votes: torch.Tensor       # int32 [P]
    committed: torch.Tensor   # bool [P]
    do_write: torch.Tensor    # bool [R, P]
    wrote_rows: torch.Tensor  # bool [R, P]
    advance: torch.Tensor     # int32 [P]


def _ballot(cfg: EngineConfig, log_end, last_term, current_term, led,
            inp: StepInput, alive, quorum, trim,
            axis: ReplicaAxis = LOCAL) -> _Ballot:
    """Acks and the ballot, shared by both layouts. `led(lead_mask)`
    returns the leader's (log_end, last_term) as two [P] tensors."""
    S, B, R, P = cfg.slots, cfg.max_batch, cfg.replicas, cfg.partitions
    dev = log_end.device
    if quorum is None:
        quorum = torch.full((P,), cfg.quorum, dtype=_I32, device=dev)
    if trim is None:
        trim = torch.zeros((P,), dtype=_I32, device=dev)

    # Sanitize host-fed control values (out-of-range leaders, oversized
    # counts) exactly as the reference does.
    counts = inp.counts.clamp(0, B)
    advance = _padded_advance(counts)                              # [P]

    alive = _normalize_alive(alive, P, R)                          # [P, R]
    self_alive = axis.rows(alive)                                  # [R, P]
    rep = axis.ids(R, dev)                                         # [R, 1]
    leader_known = (inp.leader >= 0) & (inp.leader < R)            # [P]
    is_leader = (inp.leader[None, :] == rep) & leader_known        # [R, P]
    lead_idx = inp.leader.clamp(0, R - 1).long()[:, None]
    leader_alive = torch.where(
        leader_known, alive.gather(1, lead_idx)[:, 0],
        torch.zeros_like(leader_known))

    # 1. leader's pre-append log end and tail term.
    base, leader_last_term = led(is_leader & self_alive)

    # 2. ack: alive + log matching + term current + capacity + work.
    term_ok = inp.term[None, :] >= current_term
    log_match = (log_end == base[None, :]) & (
        (base == 0)[None, :] | (last_term == leader_last_term[None, :])
    )
    capacity_ok = (counts == 0) | (base + B - trim <= S)
    has_work = (counts > 0) | (inp.off_counts > 0)
    ack = (self_alive & leader_alive[None, :] & term_ok & log_match
           & (capacity_ok & has_work)[None, :])                    # [R, P]

    # 3. ballot before any write.
    votes = axis.sum(ack, dtype=_I32)                              # [P]
    committed = votes >= quorum
    do_write = ack & committed[None, :]
    wrote_rows = do_write & (advance > 0)[None, :]
    return _Ballot(base, votes, committed, do_write, wrote_rows, advance)


def replica_control(
    cfg: EngineConfig,
    state: ReplicaState,
    inp: StepInput,
    alive: torch.Tensor,                # bool [R] or [P, R]
    quorum: torch.Tensor | None = None,  # int32 [P]
    trim: torch.Tensor | None = None,    # int32 [P] — retention watermark
    axis: ReplicaAxis = LOCAL,
) -> tuple[ReplicaState, ControlOut]:
    """One round's control phase for every replica: the ballot and all
    scalar-state updates. The returned state holds NEW tensors for every
    field except `log_data` (the write phase owns that)."""

    def led(mask):
        return (_bcast_from_leader(state.log_end, mask, axis),
                _bcast_from_leader(state.last_term, mask, axis))

    b = _ballot(cfg, state.log_end, state.last_term, state.current_term,
                led, inp, alive, quorum, trim, axis)
    adv_target = (b.base + b.advance)[None, :]
    new_log_end = torch.where(b.wrote_rows, adv_target, state.log_end)
    new_last_term = torch.where(b.wrote_rows, inp.term[None, :], state.last_term)
    new_current_term = torch.maximum(state.current_term, inp.term[None, :])
    commit_target = torch.where(b.do_write, adv_target, torch.zeros_like(adv_target))
    new_commit = torch.maximum(state.commit, commit_target)
    new_offsets = _blend_offsets(cfg, state.offsets, inp, b.do_write)

    new_state = state._replace(
        log_end=new_log_end,
        last_term=new_last_term,
        current_term=new_current_term,
        commit=new_commit,
        offsets=new_offsets,
    )
    out = StepOutput(base=b.base, votes=b.votes, committed=b.committed,
                     commit=axis.max(new_commit))
    return new_state, ControlOut(out, b.wrote_rows,
                                 _write_extent(cfg, inp, b.advance))


def replica_control_fused(
    cfg: EngineConfig,
    state: FusedReplicaState,
    inp: StepInput,
    alive: torch.Tensor,
    quorum: torch.Tensor | None = None,
    trim: torch.Tensor | None = None,
    axis: ReplicaAxis = LOCAL,
) -> tuple[FusedReplicaState, ControlOut]:
    """replica_control on the stacked [R, K, P] ctrl state: the two
    leader broadcasts ride one masked [2, P] sum and the four scalar
    advances are one [R, K, P] select. Bit-identical to the legacy
    layout (`maximum(x, y)` == `where(y > x, y, x)` for int32)."""
    ctrl = state.ctrl                                              # [R, K, P]
    log_end, last_term = ctrl[:, 0], ctrl[:, 1]
    current_term, commit = ctrl[:, 2], ctrl[:, 3]

    def led(mask):
        pair = _bcast_from_leader(ctrl[:, 0:2], mask[:, None, :],
                                  axis)                            # [2, P]
        return pair[0], pair[1]

    b = _ballot(cfg, log_end, last_term, current_term, led, inp, alive,
                quorum, trim, axis)
    adv_target = b.base + b.advance                                # [P]
    conds = torch.stack([
        b.wrote_rows,                                              # log_end
        b.wrote_rows,                                              # last_term
        inp.term[None, :] > current_term,                          # current_term
        b.do_write & (adv_target[None, :] > commit),               # commit
    ], dim=1)                                                      # [R, K, P]
    cands = torch.stack([adv_target, inp.term, inp.term, adv_target])
    new_ctrl = torch.where(conds, cands[None], ctrl)
    new_offsets = _blend_offsets(cfg, state.offsets, inp, b.do_write)

    new_state = state._replace(ctrl=new_ctrl, offsets=new_offsets)
    out = StepOutput(base=b.base, votes=b.votes, committed=b.committed,
                     commit=axis.max(new_ctrl[:, 3]))
    return new_state, ControlOut(out, b.wrote_rows,
                                 _write_extent(cfg, inp, b.advance))


def replica_step(
    cfg: EngineConfig,
    state: ReplicaState,
    inp: StepInput,
    alive: torch.Tensor,
    quorum: torch.Tensor | None = None,
    trim: torch.Tensor | None = None,
    axis: ReplicaAxis = LOCAL,
) -> tuple[ReplicaState, StepOutput]:
    """Complete round for every replica: control phase + plain append.

    The portable all-in-one composition (the reference's `replica_step`,
    which it runs under plain vmap on any backend). The engine instead
    runs `replica_control` and hands the write phase to the append
    kernel (`ops.append`) — same semantics, asserted by tests. The write
    lands at the PHYSICAL ring position `base % slots` (base itself is
    absolute), through the kernel's plain version on whatever device the
    state lives, in place on `state.log_data` (the torch form of the
    engine's donation); the returned state carries it.
    """
    # Local: the step layer imports no op for the engine, which never
    # runs this composition.
    from ripplemq_tpu_torch.ops.append import append_rows_active_plain

    new_state, ctl = replica_control(cfg, state, inp, alive, quorum, trim,
                                     axis=axis)
    log_data = state.log_data
    ids = torch.arange(log_data.shape[1], dtype=_I32, device=log_data.device)
    append_rows_active_plain(log_data, inp.entries, ids,
                             ctl.out.base % cfg.slots, ctl.do_write)
    return new_state._replace(log_data=log_data), ctl.out


def _vote_core(
    cfg: EngineConfig,
    log_end: torch.Tensor,       # int32 [R, P]
    last_term: torch.Tensor,     # int32 [R, P]
    current_term: torch.Tensor,  # int32 [R, P]
    cand: torch.Tensor,          # int32 [P] — candidate id (-1 = no election)
    cand_term: torch.Tensor,     # int32 [P]
    alive: torch.Tensor,
    quorum: torch.Tensor | None,
    axis: ReplicaAxis = LOCAL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    R, P = cfg.replicas, cfg.partitions
    dev = log_end.device
    alive = _normalize_alive(alive, P, R)                          # [P, R]
    if quorum is None:
        quorum = torch.full((P,), cfg.quorum, dtype=_I32, device=dev)
    rep = axis.ids(R, dev)
    electing = (cand >= 0) & (cand < R)                            # [P]
    is_cand = (cand[None, :] == rep) & electing                    # [R, P]
    self_alive = axis.rows(alive)                                  # [R, P]
    cand_alive = torch.where(
        electing, alive.gather(1, cand.clamp(0, R - 1).long()[:, None])[:, 0],
        torch.zeros_like(electing))

    c_end = _bcast_from_leader(log_end, is_cand & self_alive, axis)[None, :]
    c_last_term = _bcast_from_leader(last_term, is_cand & self_alive,
                                     axis)[None, :]
    up_to_date = (c_last_term > last_term) | (
        (c_last_term == last_term) & (c_end >= log_end)
    )
    grant = (electing[None, :] & self_alive & cand_alive[None, :]
             & (cand_term[None, :] > current_term) & up_to_date)   # [R, P]
    votes = axis.sum(grant, dtype=_I32)
    elected = votes >= quorum
    new_term = torch.where(grant, cand_term[None, :], current_term)
    return new_term, elected, votes


def vote_step(
    cfg: EngineConfig,
    state: ReplicaState,
    cand: torch.Tensor,
    cand_term: torch.Tensor,
    alive: torch.Tensor,
    quorum: torch.Tensor | None = None,
    axis: ReplicaAxis = LOCAL,
) -> tuple[ReplicaState, torch.Tensor, torch.Tensor]:
    """One RequestVote round (Raft §5.4.1 up-to-date check): returns
    (state', elected [P] bool, votes [P] int32)."""
    new_term, elected, votes = _vote_core(
        cfg, state.log_end, state.last_term, state.current_term,
        cand, cand_term, alive, quorum, axis,
    )
    return state._replace(current_term=new_term), elected, votes


def vote_step_fused(
    cfg: EngineConfig,
    state: FusedReplicaState,
    cand: torch.Tensor,
    cand_term: torch.Tensor,
    alive: torch.Tensor,
    quorum: torch.Tensor | None = None,
    axis: ReplicaAxis = LOCAL,
) -> tuple[FusedReplicaState, torch.Tensor, torch.Tensor]:
    """vote_step on the stacked-ctrl state: the grant lands in ctrl row 2."""
    new_term, elected, votes = _vote_core(
        cfg, state.ctrl[:, 0], state.ctrl[:, 1], state.ctrl[:, 2],
        cand, cand_term, alive, quorum, axis,
    )
    new_ctrl = state.ctrl.clone()
    new_ctrl[:, 2] = new_term
    return state._replace(ctrl=new_ctrl), elected, votes


def read_batch(
    cfg: EngineConfig,
    state: ReplicaState | FusedReplicaState,  # ONE replica: leaves [P, ...]
    partition,
    offset,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read up to RB committed rows of one partition from one replica's
    state. Returns (rows [RB, SB] uint8, lens [RB] int32, count int32);
    `count` counts storage rows including length-0 padding."""
    return read_batch_at(cfg, state.log_data[None], state.commit[None], 0,
                         partition, offset)


def read_batch_at(
    cfg: EngineConfig,
    log_data: torch.Tensor,  # uint8 [R, P, S+B, SB] — full log, no copy
    commit: torch.Tensor,    # int32 [R, P]
    replica,                 # int  — scalar or [Q]
    partition,               # int  — scalar or [Q]
    offset,                  # int  — absolute storage offset, scalar or [Q]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Committed reads addressing the full multi-replica log, batched over
    any query shape: rows [..., RB, SB], lens [..., RB], count [...].

    The reference slices a clamped window and rolls it (XLA clamps
    dynamic slices; torch raises instead). The port gathers the ring
    directly — row i of a query is physical row (pos + i) % S, for
    i < count — which is the same rows: i < count <= RB <= S, and every
    row the reference takes from its clamped window or the ring head is
    that ring row. Rows at i >= count are zero, like the reference's."""
    RB, S = cfg.read_batch, cfg.slots
    dev = log_data.device
    R = log_data.shape[0]

    def idx(x):
        return torch.as_tensor(x, device=dev).to(torch.int64)

    replica = idx(replica).clamp(0, R - 1)
    partition = idx(partition).clamp(0, cfg.partitions - 1)
    replica, partition, offset = torch.broadcast_tensors(
        replica, partition, idx(offset))
    com = commit[replica, partition].to(torch.int64)
    start = offset.clamp_min(0)
    count = (com - start).clamp(0, RB)
    pos = start % S
    i = torch.arange(RB, dtype=torch.int64, device=dev)
    ring = (pos[..., None] + i) % S                                # [..., RB]
    rows = log_data[replica[..., None], partition[..., None], ring]
    valid = i < count[..., None]
    rows = rows.masked_fill(~valid[..., None], 0)
    lens = torch.where(valid, row_lens(rows), torch.zeros_like(valid, dtype=_I32))
    return rows, lens, count.to(_I32)


def read_offset(
    state: ReplicaState | FusedReplicaState,  # ONE replica: offsets [P, C]
    partition,
    consumer_slot,
) -> torch.Tensor:
    """Current committed offset for one consumer slot (indices clipped)."""
    P, C = state.offsets.shape
    p = min(max(int(partition), 0), P - 1)
    c = min(max(int(consumer_slot), 0), C - 1)
    return state.offsets[p, c].clone()

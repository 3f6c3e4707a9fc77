"""Engine entry points: local (one device) and spmd (a mesh of ranks).

Twin of `ripplemq_tpu/parallel/engine.py`. `make_local_fns(cfg)` and
`make_spmd_fns(cfg, mesh)` return the same eleven callables, with the
same names and signatures, as the reference's `LocalEngineFns` and
`SpmdEngineFns`. What changes with the framework, in the local binding:

- the replica axis is an explicit leading [R] dimension of every state
  leaf, and the step functions (`core.step`) reduce over it;
- the reference DONATES the state to each step; the port updates the
  state's tensors IN PLACE and returns the same state object (so, as
  with donation, the caller holds one live state). The returned outputs
  are fresh tensors, never views of the state: a caller may read a
  round's `committed` after later rounds have run;
- `lax.scan` over chained rounds is a Python loop; per-round outputs are
  stacked to [K, P];
- inputs may be numpy arrays or tensors; they are moved to the engine's
  device at this boundary. The engine runs on CUDA unless the caller
  asks for another device: with no device given and no GPU present,
  `make_local_fns` raises.

The write phase of every round is `ops.append.append_rows_active` (the
CUDA kernel on a GPU), landing at the physical ring position
`base % slots`.

The spmd binding replaces `shard_map` by one process per mesh cell
(`parallel.mesh`): each rank holds the [1, local_P, ...] shard of every
state leaf (its replica's rows of its partition shard), runs the same
core steps on it with a replica axis whose reductions are `all_reduce`s
over the mesh's replica group, writes its own shard with the same
kernel, and gathers the round's outputs over the part group, so they
are [P] and identical on every rank. Every rank of the mesh must make
the same calls in the same order (`parallel.lockstep` broadcasts the
controller's calls to the other ranks).
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ripplemq_tpu_torch.core import step as core_step
from ripplemq_tpu_torch.core.config import EngineConfig, stride_alias_hazard
from ripplemq_tpu_torch.core.state import (
    CTRL_FIELDS,
    ReplicaState,
    StepInput,
    StepOutput,
    fuse_state,
    init_state,
)
from ripplemq_tpu_torch.ops.append import append_rows, append_rows_active

_I32 = torch.int32


class LocalEngineFns(NamedTuple):
    init: Callable[[], ReplicaState]          # -> state with leading [R] axis
    step: Callable[..., tuple[ReplicaState, StepOutput]]
    step_many: Callable[..., tuple[ReplicaState, StepOutput]]  # chained rounds
    step_sparse: Callable[..., tuple[ReplicaState, StepOutput]]  # active-set
    step_many_sparse: Callable[..., tuple[ReplicaState, StepOutput]]
    vote: Callable[..., tuple[ReplicaState, torch.Tensor, torch.Tensor]]
    read: Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    read_many: Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    read_offset: Callable[..., torch.Tensor]
    resync: Callable[..., ReplicaState]
    init_from: Callable[[ReplicaState], ReplicaState]  # one replica's image -> [R] state


class SpmdEngineFns(NamedTuple):
    init: Callable[[], ReplicaState]   # -> this rank's [1, local_P] shard
    step: Callable[..., tuple[ReplicaState, StepOutput]]
    step_many: Callable[..., tuple[ReplicaState, StepOutput]]
    step_sparse: Callable[..., tuple[ReplicaState, StepOutput]]
    step_many_sparse: Callable[..., tuple[ReplicaState, StepOutput]]
    vote: Callable[..., tuple[ReplicaState, torch.Tensor, torch.Tensor]]
    read: Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    read_many: Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    read_offset: Callable[..., torch.Tensor]
    resync: Callable[..., ReplicaState]
    init_from: Callable[[ReplicaState], ReplicaState]
    mesh: object
    fetch_state: Callable[..., np.ndarray]  # one leaf, gathered to [R, P, ...]


def _resync(cfg: EngineConfig, state, src: int, dst: int,
            part_mask: torch.Tensor):
    """Overwrite replica `dst`'s state for masked partitions with replica
    `src`'s, in place (the snapshot-install analogue). `src` is clipped
    like the reference's gather (negative counts from the end); a `dst`
    outside [0, R) changes nothing."""
    R = cfg.replicas
    src = int(src)
    dst = int(dst)
    src = min(max(src + R if src < 0 else src, 0), R - 1)
    if not 0 <= dst < R or src == dst:
        return state
    for name, leaf in state._asdict().items():
        if name == "ctrl":  # [R, K, P]: partitions on the last axis
            leaf[dst][:, part_mask] = leaf[src][:, part_mask]
        else:               # [R, P, ...]
            leaf[dst][part_mask] = leaf[src][part_mask]
    return state


def make_local_fns(cfg: EngineConfig, device=None) -> LocalEngineFns:
    """The engine's entry points on `device`, or on CUDA when none is
    given; raises when none is given and no GPU is present (there is no
    silent CPU path)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the engine "
            "on the CPU explicitly")
    dev = torch.device("cuda" if device is None else device)
    R, P = cfg.replicas, cfg.partitions
    fused = cfg.fused_control
    ctrl_fn = (core_step.replica_control_fused if fused
               else core_step.replica_control)
    vote_fn = core_step.vote_step_fused if fused else core_step.vote_step
    default_quorum = torch.full((P,), cfg.quorum, dtype=_I32, device=dev)
    default_trim = torch.zeros((P,), dtype=_I32, device=dev)

    def t(x, dtype):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch refuses to share read-only host memory
        return torch.as_tensor(x, device=dev).to(dtype)

    def to_input(inp) -> StepInput:
        return StepInput(
            entries=t(inp.entries, torch.uint8),
            counts=t(inp.counts, _I32),
            off_slots=t(inp.off_slots, _I32),
            off_vals=t(inp.off_vals, _I32),
            off_counts=t(inp.off_counts, _I32),
            leader=t(inp.leader, _I32),
            term=t(inp.term, _I32),
            extents=None if inp.extents is None else t(inp.extents, _I32),
        )

    def ctl_args(alive, quorum, trim):
        return (t(alive, torch.bool),
                default_quorum if quorum is None else t(quorum, _I32),
                default_trim if trim is None else t(trim, _I32))

    def apply_ctrl(state, new_state) -> None:
        # In place, like the reference's donated state.
        names = ("ctrl",) if fused else CTRL_FIELDS
        for name in names + ("offsets",):
            getattr(state, name).copy_(getattr(new_state, name))

    def one_round(state, inp: StepInput, entries, slot_ids, alive, quorum,
                  trim) -> StepOutput:
        # Control phase for every replica, then ONE write phase on the full
        # [R, P, S+B, SB] ring at the physical position base % slots.
        # slot_ids None = dense (every partition's block in `entries`).
        new_state, ctl = ctrl_fn(cfg, state, inp, alive, quorum, trim)
        base = ctl.out.base % cfg.slots
        ext = ctl.extent if cfg.packed_writes else None
        if slot_ids is None:
            append_rows(state.log_data, entries, base, ctl.do_write,
                        extents=ext)
        else:
            append_rows_active(state.log_data, entries, slot_ids, base,
                               ctl.do_write, extents=ext)
        apply_ctrl(state, new_state)
        return ctl.out

    def chain(state, inputs, entries, slot_ids, alive, quorum, trim):
        # K chained rounds: every leaf carries a leading [K] axis. Each
        # iteration is a complete quorum round; alive/quorum/trim are
        # chain-constant. entries None = the dense rows of `inputs`.
        inputs = to_input(inputs)
        entries = inputs.entries if entries is None else entries
        args = ctl_args(alive, quorum, trim)
        outs = [
            one_round(state, StepInput(*(None if x is None else x[k]
                                         for x in inputs)),
                      entries[k], None if slot_ids is None else slot_ids[k],
                      *args)
            for k in range(inputs.counts.shape[0])
        ]
        return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))

    def _step(state, inp, alive, quorum=None, trim=None):
        inp = to_input(inp)
        return state, one_round(state, inp, inp.entries, None,
                                *ctl_args(alive, quorum, trim))

    def _step_many(state, inputs, alive, quorum=None, trim=None):
        return chain(state, inputs, None, None, alive, quorum, trim)

    # Active-set variants: `inp.entries` is a dummy the control phase
    # never reads; the rows arrive compacted as entries_c [A, B, SB] with
    # slot_ids [A] (-1 pads).
    def _step_sparse(state, inp, entries_c, slot_ids, alive, quorum=None,
                     trim=None):
        return state, one_round(state, to_input(inp),
                                t(entries_c, torch.uint8), t(slot_ids, _I32),
                                *ctl_args(alive, quorum, trim))

    def _step_many_sparse(state, inputs, entries_c, slot_ids, alive,
                          quorum=None, trim=None):
        return chain(state, inputs, t(entries_c, torch.uint8),
                     t(slot_ids, _I32), alive, quorum, trim)

    def _vote(state, cand, cand_term, alive, quorum=None):
        new_state, elected, votes = vote_fn(
            cfg, state, t(cand, _I32), t(cand_term, _I32),
            t(alive, torch.bool),
            default_quorum if quorum is None else t(quorum, _I32))
        if fused:
            state.ctrl.copy_(new_state.ctrl)
        else:
            state.current_term.copy_(new_state.current_term)
        return state, elected, votes

    def _read(state, replica, partition, offset):
        return core_step.read_batch_at(cfg, state.log_data, state.commit,
                                       replica, partition, offset)

    def _read_many(state, replicas, partitions, offsets):
        # Q independent (replica, partition, offset) queries in one call;
        # each gathers only its own RB rows of the log.
        return core_step.read_batch_at(cfg, state.log_data, state.commit,
                                       replicas, partitions, offsets)

    def _read_offset(state, replica, partition, consumer_slot):
        r = min(max(int(replica), 0), R - 1)
        one = type(state)(*(leaf[r] for leaf in state))  # views, no copy
        return core_step.read_offset(one, partition, consumer_slot)

    def _resync_fn(state, src, dst, part_mask):
        return _resync(cfg, state, src, dst, t(part_mask, torch.bool))

    def _init_from(image):
        """Install a recovered single-replica image (named fields, numpy
        or tensors) on every replica slot."""
        def full(x, dtype):
            x = t(x, dtype)
            return x[None].expand((R,) + tuple(x.shape)).clone()

        state = ReplicaState(
            log_data=full(image.log_data, torch.uint8),
            log_end=full(image.log_end, _I32),
            last_term=full(image.last_term, _I32),
            current_term=full(image.current_term, _I32),
            commit=full(image.commit, _I32),
            offsets=full(image.offsets, _I32),
        )
        return fuse_state(state) if fused else state

    def _init():
        return _init_from(init_state(cfg, dev))

    return LocalEngineFns(_init, _step, _step_many, _step_sparse,
                          _step_many_sparse, _vote, _read, _read_many,
                          _read_offset, _resync_fn, _init_from)


# ---------------------------------------------------------------------------
# SPMD (mesh: replica x part, one rank a cell)
# ---------------------------------------------------------------------------


class _ShardAxis(core_step.ReplicaAxis):
    """The replica axis of a mesh cell: its leaves hold ONE replica's rows
    ([1, ...]); a reduction is the local partial `all_reduce`d over the
    mesh's replica group (the reference's psum / pmax over "replica")."""

    def __init__(self, mesh) -> None:
        self._mesh = mesh
        self._r = mesh.replica
        self._ids = torch.full((1, 1), self._r, dtype=_I32,
                               device=mesh.device)

    def ids(self, R: int, device) -> torch.Tensor:
        return self._ids

    def rows(self, alive: torch.Tensor) -> torch.Tensor:
        return alive[:, self._r:self._r + 1].t()

    def sum(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        part = x.sum(0, dtype=x.dtype if dtype is None else dtype)
        return self._mesh.all_reduce(part, "sum", "replica")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._mesh.all_reduce(x.amax(0), "max", "replica")


def make_spmd_fns(cfg: EngineConfig, mesh) -> SpmdEngineFns:
    """The engine's entry points on this rank's cell of `mesh`
    (`parallel.mesh.make_mesh`), on the mesh's device. Arguments are the
    reference's global ones ([P] vectors, [P, ...] inputs, the global
    partition ids of an active set); the returned outputs are [P] and
    identical on every rank of the mesh."""
    R, P = cfg.replicas, cfg.partitions
    part_shards = mesh.shape["part"]
    if mesh.shape["replica"] != R:
        raise ValueError(
            f"mesh replica axis {mesh.shape['replica']} != cfg.replicas {R}"
        )
    if P % part_shards:
        raise ValueError("partitions must divide evenly over the part axis")
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} holds no cell of the "
                         f"{R} x {part_shards} mesh")
    local_P = P // part_shards
    # The ring-stride rule priced at the PER-RANK shape: each cell holds
    # ONE replica's [local_P, S+B, SB] ring block, so local_P is its
    # concurrent strided stream count (the reference's per-device verdict).
    hazard = stride_alias_hazard(cfg.slots, cfg.max_batch, cfg.slot_bytes,
                                 streams=local_P)
    if hazard is not None:
        warnings.warn(
            f"spmd binding: per-device shard holds {local_P} partition "
            f"rings; {hazard}", UserWarning, stacklevel=2,
        )
    dev = mesh.device
    my_rep, my_shard = mesh.coords
    lo, hi = my_shard * local_P, (my_shard + 1) * local_P
    fused = cfg.fused_control
    ctrl_fn = (core_step.replica_control_fused if fused
               else core_step.replica_control)
    vote_fn = core_step.vote_step_fused if fused else core_step.vote_step
    axis = _ShardAxis(mesh)
    default_quorum = torch.full((P,), cfg.quorum, dtype=_I32, device=dev)
    default_trim = torch.zeros((P,), dtype=_I32, device=dev)

    def t(x, dtype):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch refuses to share read-only host memory
        return torch.as_tensor(x, device=dev).to(dtype)

    def to_input(inp, chained: bool) -> StepInput:
        # The shard's slice of every [P, ...] leaf ([K, P, ...] chained);
        # missing extents are the full window (the reference's
        # _fill_extents: the same write as a None extent).
        sl = (slice(None), slice(lo, hi)) if chained else slice(lo, hi)
        counts = t(inp.counts, _I32)
        ext = (torch.full_like(counts, cfg.max_batch) if inp.extents is None
               else t(inp.extents, _I32))
        return StepInput(
            entries=t(inp.entries, torch.uint8)[sl],
            counts=counts[sl],
            off_slots=t(inp.off_slots, _I32)[sl],
            off_vals=t(inp.off_vals, _I32)[sl],
            off_counts=t(inp.off_counts, _I32)[sl],
            leader=t(inp.leader, _I32)[sl],
            term=t(inp.term, _I32)[sl],
            extents=ext[sl],
        )

    def ctl_args(alive, quorum, trim):
        # Engine-level liveness is [P, R]; a [R] mask is broadcast.
        alive = t(alive, torch.bool)
        if alive.ndim == 1:
            alive = alive[None, :].expand(P, R)
        return (alive[lo:hi],
                (default_quorum if quorum is None else t(quorum, _I32))[lo:hi],
                (default_trim if trim is None else t(trim, _I32))[lo:hi])

    def local_ids(ids: torch.Tensor) -> torch.Tensor:
        # Global active-set ids -> this shard's rows (-1: not mine/padding).
        mine = (ids >= lo) & (ids < hi)
        return torch.where(mine, ids - lo, torch.full_like(ids, -1))

    def gather_part(vecs):
        # [local_P] outputs of every shard -> [P] on every rank: ONE
        # all_gather of the stacked int32 vectors over the part group.
        if part_shards == 1:
            return vecs
        stacked = torch.stack([v.to(_I32) for v in vecs])
        full = torch.cat(mesh.all_gather(stacked, "part"), dim=1)
        return tuple(full[i].to(v.dtype) for i, v in enumerate(vecs))

    def apply_ctrl(state, new_state) -> None:
        names = ("ctrl",) if fused else CTRL_FIELDS
        for name in names + ("offsets",):
            getattr(state, name).copy_(getattr(new_state, name))

    def one_round(state, inp: StepInput, entries, slot_ids, alive, quorum,
                  trim) -> StepOutput:
        new_state, ctl = ctrl_fn(cfg, state, inp, alive, quorum, trim,
                                 axis=axis)
        base = ctl.out.base % cfg.slots
        ext = ctl.extent if cfg.packed_writes else None
        if slot_ids is None:
            append_rows(state.log_data, entries, base, ctl.do_write,
                        extents=ext)
        else:
            append_rows_active(state.log_data, entries, local_ids(slot_ids),
                               base, ctl.do_write, extents=ext)
        apply_ctrl(state, new_state)
        return StepOutput(*gather_part(tuple(ctl.out)))

    def chain(state, inputs, entries, slot_ids, alive, quorum, trim):
        inputs = to_input(inputs, chained=True)
        entries = inputs.entries if entries is None else entries
        args = ctl_args(alive, quorum, trim)
        outs = [
            one_round(state, StepInput(*(x[k] for x in inputs)), entries[k],
                      None if slot_ids is None else slot_ids[k], *args)
            for k in range(inputs.counts.shape[0])
        ]
        return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))

    def _step(state, inp, alive, quorum=None, trim=None):
        inp = to_input(inp, chained=False)
        return state, one_round(state, inp, inp.entries, None,
                                *ctl_args(alive, quorum, trim))

    def _step_many(state, inputs, alive, quorum=None, trim=None):
        return chain(state, inputs, None, None, alive, quorum, trim)

    # Active-set variants: entries_c [A, B, SB] and the global slot_ids
    # [A] reach every rank whole; each rank writes only its own blocks.
    def _step_sparse(state, inp, entries_c, slot_ids, alive, quorum=None,
                     trim=None):
        return state, one_round(state, to_input(inp, chained=False),
                                t(entries_c, torch.uint8), t(slot_ids, _I32),
                                *ctl_args(alive, quorum, trim))

    def _step_many_sparse(state, inputs, entries_c, slot_ids, alive,
                          quorum=None, trim=None):
        return chain(state, inputs, t(entries_c, torch.uint8),
                     t(slot_ids, _I32), alive, quorum, trim)

    def _vote(state, cand, cand_term, alive, quorum=None):
        alive, quorum, _ = ctl_args(alive, quorum, None)
        new_state, elected, votes = vote_fn(
            cfg, state, t(cand, _I32)[lo:hi], t(cand_term, _I32)[lo:hi],
            alive, quorum, axis=axis)
        if fused:
            state.ctrl.copy_(new_state.ctrl)
        else:
            state.current_term.copy_(new_state.current_term)
        elected, votes = gather_part((elected, votes))
        return state, elected, votes

    # Reads: the serving cell's answer, every other cell's zeros, summed
    # over the whole mesh (the reference's masked psum). One collective:
    # the int32 lens and counts ride as bytes beside the rows — exactly
    # one cell contributes, so a byte-wise sum is its bytes.
    def masked_read(state, replicas, partitions, offsets):
        replicas = replicas.clamp(0, R - 1)
        partitions = partitions.clamp(0, P - 1)
        shard = torch.div(partitions, local_P, rounding_mode="floor")
        sel = (replicas == my_rep) & (shard == my_shard)
        data, lens, count = core_step.read_batch_at(
            cfg, state.log_data, state.commit, 0, partitions % local_P,
            offsets)
        data = data * sel[..., None, None]
        lens = lens * sel[..., None]
        count = count * sel
        parts = (lens, count, data)
        flat = torch.cat([x.reshape(-1).view(torch.uint8) for x in parts])
        flat = mesh.all_reduce(flat, "sum", "mesh")
        out, at = [], 0
        for x in parts:
            n = x.numel() * x.element_size()
            out.append(flat[at:at + n].view(x.dtype).reshape(x.shape))
            at += n
        lens, count, data = out
        return data, lens, count

    def idx(x):
        return t(x, torch.int64)

    def _read(state, replica, partition, offset):
        return masked_read(state, idx(replica), idx(partition), idx(offset))

    def _read_many(state, replicas, partitions, offsets):
        return masked_read(state, idx(replicas), idx(partitions),
                           idx(offsets))

    def _read_offset(state, replica, partition, consumer_slot):
        replica = min(max(int(replica), 0), R - 1)
        partition = min(max(int(partition), 0), P - 1)
        one = type(state)(*(leaf[0] for leaf in state))  # views, no copy
        val = core_step.read_offset(one, partition % local_P, consumer_slot)
        if (replica, partition // local_P) != (my_rep, my_shard):
            val = torch.zeros_like(val)
        return mesh.all_reduce(val.reshape(1), "sum", "mesh")[0]

    def _resync_fn(state, src, dst, part_mask):
        # Replica `src`'s masked rows, summed over the replica group with
        # every other replica contributing zeros, overwrite `dst`'s (the
        # reference's masked psum; as there, a `src` no cell holds copies
        # zeros and a `dst` no cell holds changes nothing). Only the
        # masked partitions travel: the mask is the same on every cell
        # of a replica group.
        src, dst = int(src), int(dst)
        if not 0 <= dst < R:
            return state
        rows = t(part_mask, torch.bool)[lo:hi].nonzero()[:, 0]
        if rows.numel() == 0:
            return state
        for name, leaf in state._asdict().items():
            view = leaf[0]
            got = view[:, rows] if name == "ctrl" else view[rows]
            if my_rep != src:
                got = torch.zeros_like(got)
            got = mesh.all_reduce(got.contiguous(), "sum", "replica")
            if my_rep == dst:
                if name == "ctrl":
                    view[:, rows] = got
                else:
                    view[rows] = got
        return state

    def _init_from(image):
        """Shard a one-replica image (named fields, [P, ...] numpy or
        tensors): this rank's partitions, as its replica's rows."""
        def mine(x, dtype):
            return t(x, dtype)[lo:hi][None].clone()

        state = ReplicaState(
            log_data=mine(image.log_data, torch.uint8),
            log_end=mine(image.log_end, _I32),
            last_term=mine(image.last_term, _I32),
            current_term=mine(image.current_term, _I32),
            commit=mine(image.commit, _I32),
            offsets=mine(image.offsets, _I32),
        )
        return fuse_state(state) if fused else state

    def _init():
        def zeros(*shape, dtype=_I32):
            return torch.zeros((1, local_P) + shape, dtype=dtype, device=dev)

        state = ReplicaState(
            log_data=zeros(cfg.slots + cfg.max_batch, cfg.slot_bytes,
                           dtype=torch.uint8),
            log_end=zeros(), last_term=zeros(), current_term=zeros(),
            commit=zeros(), offsets=zeros(cfg.max_consumers),
        )
        return fuse_state(state) if fused else state

    def _fetch_state(state, field: str) -> np.ndarray:
        """One state leaf gathered from every cell, as [R, P, ...] numpy
        (fused layouts serve the named scalars as ctrl views; the ctrl
        leaf itself, [R, K, P], carries its partitions last)."""
        leaf = getattr(state, field)[0]
        cells = mesh.all_gather(leaf, "mesh")  # by rank: r * S + s
        dim = -1 if field == "ctrl" else 0
        return torch.stack([
            torch.cat(cells[r * part_shards:(r + 1) * part_shards], dim=dim)
            for r in range(R)
        ]).cpu().numpy()

    return SpmdEngineFns(_init, _step, _step_many, _step_sparse,
                         _step_many_sparse, _vote, _read, _read_many,
                         _read_offset, _resync_fn, _init_from, mesh,
                         _fetch_state)


__all__ = ["LocalEngineFns", "SpmdEngineFns", "make_local_fns",
           "make_spmd_fns"]

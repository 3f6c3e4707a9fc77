"""Engine entry points on one device (PyTorch port of the local binding).

Twin of the local half of `ripplemq_tpu/parallel/engine.py`:
`make_local_fns(cfg)` returns the same eleven callables, with the same
names and signatures, as the reference's `LocalEngineFns`. What changes
with the framework:

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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ripplemq_tpu_torch.core import step as core_step
from ripplemq_tpu_torch.core.config import EngineConfig
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


__all__ = ["LocalEngineFns", "make_local_fns"]

#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (`ripplemq_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N]

Runs only where `torch.cuda.is_available()`; exits nonzero at once
elsewhere, and when run outside a checkout of the repository (the port's
package must be importable next to it). Every phase prints one line; a
phase that fails raises, and the script exits nonzero with no result.

1. the card's name and power limit (nvidia-smi);
2. the kernel builds, one nvcc each, started together:
   `ops/csrc/append.cu` and `ops/csrc/rs.cu` for sm_90a;
3. the append kernel against its plain PyTorch version at full width —
   the bench's headline engine shape (1024 partitions x 5 replicas,
   slots 12352, B 256, SB 128: an 8.26 GB ring log) — legacy and packed,
   A = 64 and A = 1024 active entries, every base in the ring's last B
   rows (windows clipped at the ring end), and 64 entries that no
   replica writes, all from one cloned random log, the whole log
   compared with torch.equal; then small configurations that reach the
   kernel's register path (SB = 25; logs and entries at 1, 3 and 8-byte
   offsets; bases from -B) and its bulk path with SB % 16 != 0
   (SB = 24); then the GF(2^8) kernel against its plain version
   (torch.equal) at a 64 MiB segment's shard length with the encode
   matrix and all 10 reconstruct inverses, every pair of input and output
   row offsets in {0, 1, 7, 15} bytes at widths 1, 15, 16, 17, 33, 4095,
   4097 (and the full width for the encode), small odd and aligned
   widths, a 16x16 matrix, and N = 0 (no launch);
4. agreement on a small input: the engine on the GPU (kernel) and on the
   CPU (plain version) replay one scenario to equal state;
5. the engine's main path, once per binding (legacy; fused_control +
   packed_writes), through `make_local_fns(cfg)` on CUDA at the headline
   shape: 16 sparse rounds (8 `step_sparse`, one `step_many_sparse`
   chain of 8) with seeded payloads and a varying active set, a vote and
   a round under the new leaders, then every committed message read back
   through `read_many` and compared byte- and count-exact with what was
   produced, and the committed consumer offsets through `read_offset`;
6. the storage path at full size: 32 `step_sparse` rounds (legacy,
   A = 1024) whose committed records go into `SegmentStore(erasure=True)`
   with 64 MiB segments, a flush per round; the store closed, every
   sealed segment checked for 5 CRC-valid shards and no erasure errors;
   three sealed segments damaged (a file and 2 shards lost; a flipped
   byte and 2 shards lost; 2 parity shards lost); `recover_image` must
   repair exactly the first two byte-exact, restore every shard set and
   return the engine's replica-0 state;
7. the stripe path at full size: the same rounds' records encoded as one
   stripe group each on the card, spread over 4 standbys, one standby
   lost, `rebuild_records` from the other three equal to the record
   stream; every two-loss pattern of the widest group; one group's
   frames equal to the CPU encoder's;
   (launch counts are zeroed just before each path and read just after)
8. times: each kernel's device time alone (the profiler's events by
   kernel name) and through its wrapper (CUDA events, after warm-up),
   inputs rotated over 3 buffers so that they come from HBM; ms per
   chained round, the plain versions', `index_put_`'s and a `copy_` of
   the append's byte count, peak device memory, `encode_segment`'s steps
   for one 64 MiB segment and `encode_group`'s rate at the bench's shape;
9. a JSON line naming each ported kernel (gf_matmul's launches split by
   consumer and by path), then the card line again, then the result line
   `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import hashlib
import itertools
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.broker import dataplane
from ripplemq_tpu_torch.core.config import ALIGN, ROW_HEADER, EngineConfig
from ripplemq_tpu_torch.core.encode import decode_entries, row_extents
from ripplemq_tpu_torch.core.state import StepInput
from ripplemq_tpu_torch.ops import append as append_ops
from ripplemq_tpu_torch.ops import cuda_build
from ripplemq_tpu_torch.ops import rs as rs_ops
from ripplemq_tpu_torch.parallel.engine import make_local_fns
from ripplemq_tpu_torch.storage import erasure
from ripplemq_tpu_torch.storage.segment import (
    REC_APPEND,
    REC_OFFSETS,
    REC_STRIPE,
    SegmentStore,
)
from ripplemq_tpu_torch.stripes.codec import (
    encode_group,
    parse_frame,
    reconstruct_group,
    stripe_assignment,
)
from ripplemq_tpu_torch.stripes.recovery import rebuild_records

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)

HEADLINE = dict(partitions=1024, replicas=5, slots=12352, slot_bytes=128,
                max_batch=256, read_batch=32, max_consumers=64,
                max_offset_updates=8)
BINDINGS = {
    "legacy": dict(),
    "fused+packed": dict(fused_control=True, packed_writes=True),
}
KERNELS = {  # launch-count key -> (binding whose main path runs it, TPU kernel)
    "append_active": ("legacy", "ripplemq_tpu/ops/append.py:124"),
    "append_active_packed": ("fused+packed", "ripplemq_tpu/ops/append.py:191"),
}
SOURCE = "ripplemq_tpu_torch/ops/csrc/append.cu"
RS_SOURCE = "ripplemq_tpu_torch/ops/csrc/rs.cu"
RS_REPLACES = "ripplemq_tpu/ops/rs.py:159"
SEG_BYTES = 64 << 20          # the cluster's segment size (cluster_config.py)
SHARD_N = -(-SEG_BYTES // 3)  # a sealed 64 MiB segment's shard length
STORE_ROUNDS = 32             # <= 8192 rows a partition: the ring never laps
STORE_A = 1024


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------ phase 3: kernel vs plain


def random_case(g, cfg, A, *, to_ring_end, write_p=0.7, ring_end_only=False,
                unwritten=0, base_lo=0):
    """Seeded device inputs for one append: entries, slot ids (distinct,
    with -1 pads), aligned bases, do_write, extents in 0..B.
    `ring_end_only` puts every base in the last B rows of the ring (each
    window clipped at its end); `unwritten` active entries get no writing
    replica; `base_lo` < 0 lets bases start before row 0."""
    dev = DEV
    R, P, B, SB = cfg.replicas, cfg.partitions, cfg.max_batch, cfg.slot_bytes
    SP = cfg.slots + B
    entries = torch.empty((A, B, SB), dtype=torch.uint8, device=dev).random_(
        generator=g)
    n_active = min(A - A // 8, P)
    ids = torch.full((A,), -1, dtype=torch.int32, device=dev)
    where = torch.randperm(A, generator=g, device=dev)[:n_active]
    ids[where] = torch.randperm(P, generator=g, device=dev)[:n_active].to(
        torch.int32)
    lo = (SP - B) // 8 if ring_end_only else base_lo // 8
    hi = SP // 8 if to_ring_end or ring_end_only else (SP - B) // 8 + 1
    base = (torch.randint(lo, hi, (P,), generator=g, device=dev) * 8).to(
        torch.int32)
    do_write = torch.rand((R, P), generator=g, device=dev) < write_p
    if unwritten:
        do_write[:, ids[where[:unwritten]].long()] = False
    extents = torch.randint(0, B + 1, (P,), generator=g, device=dev).to(
        torch.int32)
    return entries, ids, base, do_write, extents


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    worst = 0
    for r in range(a.shape[0]):  # chunked: the log is 8 GB
        worst = max(worst, int((a[r].to(torch.int16) - b[r].to(torch.int16))
                               .abs().max()))
    return worst


def _append_case(ops, log_k, log_p, entries, ids, base, do_write, ext, label,
                 errs, name, fresh):
    """One append through the kernel and the plain version, the whole logs
    compared; `fresh` = the log pair is new to this case."""
    ops.append_rows_active(log_k, entries, ids, base, do_write, extents=ext)
    ops.append_rows_active_plain(log_p, entries, ids, base, do_write, ext)
    torch.cuda.synchronize()
    rows = int(ops._plain_writes(log_p, entries, ids, base, do_write,
                                 ext)[0].numel())
    equal = torch.equal(log_k, log_p)
    err = 0 if equal else max_abs_err(log_k, log_p)
    errs[name] = max(errs[name], err)
    print(f"kernel-vs-plain: {name} {label}: rows written={rows} whole "
          f"{log_k.numel()} B {'(fresh) ' if fresh else ''}log equal={equal} "
          f"max_abs_err={err}", flush=True)
    if not equal or rows == 0:
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             f"version (or wrote nothing)")


def _offset_view(shape, offset, g):
    """A random uint8 tensor of `shape` that starts `offset` bytes into
    its buffer (contiguous, misaligned when offset % 16 != 0)."""
    n = int(np.prod(shape))
    buf = torch.empty(n + 64, dtype=torch.uint8, device=DEV).random_(
        generator=g)
    return buf[offset:offset + n].view(shape)


# The shape fields `random_case` reads, for configurations an
# EngineConfig would refuse (SB = 25 is no multiple of anything).
_Shape = collections.namedtuple(
    "_Shape", "replicas partitions slots slot_bytes max_batch")

# Small configurations that reach the kernel's other paths: SB = 24 keeps
# 16-byte-aligned windows (bulk copies with SB % 16 != 0); SB = 25 and the
# offset views take the register path (16-byte lanes between a misaligned
# head and tail when source and destination agree mod 16, bytes when not).
SMALL_APPEND = [  # (label, R, P, S, SB, B, A, log offset, entries offset)
    ("SB=24", 3, 64, 128, 24, 32, 48, 0, 0),
    ("SB=25", 3, 64, 128, 25, 32, 48, 0, 0),
    ("log and entries +8 B", 5, 64, 512, 128, 256, 64, 8, 8),
    ("entries +1 B", 5, 64, 512, 128, 256, 64, 0, 1),
    ("log +3 B", 5, 64, 512, 128, 256, 64, 3, 0),
]


def kernel_vs_plain(ops, cfg, seed) -> dict:
    g = torch.Generator(device=DEV).manual_seed(seed)
    shape = (cfg.replicas, cfg.partitions, cfg.slots + cfg.max_batch,
             cfg.slot_bytes)
    log_k = torch.empty(shape, dtype=torch.uint8, device=DEV).random_(
        generator=g)
    log_p = log_k.clone()
    errs = {k: 0 for k in KERNELS}
    cases = [(A, dict(to_ring_end=True), f"A={A}") for A in (64, 1024)] + [
        (1024, dict(to_ring_end=True, ring_end_only=True),
         "A=1024, every base in the ring's last B rows"),
        (1024, dict(to_ring_end=True, unwritten=64),
         "A=1024, 64 entries with do_write all 0")]
    for A, kw, label in cases:
        for packed in (False, True):
            entries, ids, base, do_write, ext = random_case(g, cfg, A, **kw)
            name = "append_active_packed" if packed else "append_active"
            _append_case(ops, log_k, log_p, entries, ids, base, do_write,
                         ext if packed else None, label, errs, name, False)
    del log_k, log_p
    torch.cuda.empty_cache()
    for label, R, P, S, SB, B, A, log_off, ent_off in SMALL_APPEND:
        for packed in (False, True):
            log_k = _offset_view((R, P, S + B, SB), log_off, g)
            log_p = log_k.clone()
            entries, ids, base, do_write, ext = random_case(
                g, _Shape(R, P, S, SB, B), A, to_ring_end=True,
                base_lo=-B, unwritten=2)
            entries = _offset_view((A, B, SB), ent_off, g)
            name = "append_active_packed" if packed else "append_active"
            _append_case(ops, log_k, log_p, entries, ids, base, do_write,
                         ext if packed else None,
                         f"{label} (R={R} P={P} S={S} B={B} A={A}, bases "
                         f"from -B)", errs, name, True)
    return errs


def kernel_only_ms(fn, name: str, reps: int) -> float:
    """Mean device time of one launch of the kernels whose name holds
    `name`, over `reps` calls of `fn` (one launch each), by the
    profiler's device events: only the kernel is in the window, not the
    wrapper's host time nor the gaps between launches. Fails when the
    profiler sees no such kernel, or not one per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in ev)
    if count != reps:
        raise AssertionError(f"the profiler saw {count} launches of a "
                             f"'{name}' kernel in {reps} calls")
    return sum(e.self_device_time_total for e in ev) / count / 1e3


ROTATE = 3  # input buffers cycled by the timings: > 50 MB, past the L2


def time_kernels(ops, cfg, seed, card) -> dict:
    """Per-launch times at the main path's widest round (A = 1024, every
    replica writing): the kernel alone (profiler) and through the wrapper
    (CUDA events), the entries rotated over 3 buffers (100 MB) so that
    they come from HBM as in the main path's chained rounds; beside the
    plain version, index_put_, one torch copy_ of the same byte count and
    the bound."""
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    shape = (cfg.replicas, cfg.partitions, cfg.slots + cfg.max_batch,
             cfg.slot_bytes)
    log = torch.zeros(shape, dtype=torch.uint8, device=DEV)
    entries, ids, base, do_write, extents = random_case(
        g, cfg, 1024, to_ring_end=False, write_p=1.0)
    extents = extents.clamp_min(1)  # every main-path round carries >= 1 row
    rot = [entries] + [torch.empty_like(entries).random_(generator=g)
                       for _ in range(ROTATE - 1)]
    out = {}
    for name in KERNELS:
        ext = extents if name == "append_active_packed" else None
        r_i, p_i, row_i, a_i, b_i = ops._plain_writes(log, entries, ids, base,
                                                      do_write, ext)
        written = r_i.numel() * cfg.slot_bytes
        read = torch.unique(a_i * cfg.max_batch + b_i).numel() * cfg.slot_bytes
        small = 4 * (ids.numel() + base.numel()) + do_write.numel() + (
            0 if ext is None else 4 * ext.numel())
        moved = written + read + small
        turn = itertools.count()

        def launch():
            ops.append_rows_active(log, rot[next(turn) % ROTATE], ids, base,
                                   do_write, extents=ext)

        kernel_ms = kernel_only_ms(launch, "append_active_kernel", reps=60)
        wrapper_ms = cuda_time_ms(launch, reps=60)
        plain_ms = cuda_time_ms(lambda: ops.append_rows_active_plain(
            log, entries, ids, base, do_write, ext), reps=5)
        vals = entries[a_i, b_i]
        lib_ms = cuda_time_ms(
            lambda: log.index_put_((r_i, p_i, row_i), vals), reps=10)
        src = torch.empty(moved // 2, dtype=torch.uint8, device=DEV)
        dst = torch.empty_like(src)
        copy_ms = cuda_time_ms(lambda: dst.copy_(src), reps=60)
        del src, dst, vals
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=kernel_ms, wrapper_ms=wrapper_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         copy_ms=copy_ms, bound_ms=bound_ms, bytes=moved,
                         written=written)
        print(f"time: {name} A={entries.shape[0]} R={cfg.replicas} "
              f"B={cfg.max_batch} SB={cfg.slot_bytes}: kernel "
              f"{kernel_ms:.4f} ms/launch ({100 * bound_ms / kernel_ms:.1f}% "
              f"of bound), through the wrapper {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, index_put_ {lib_ms:.3f} ms, copy_ of "
              f"{moved // 2} B ({moved} B moved) {copy_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({moved} B at 3.35 TB/s) [{card}]",
              flush=True)
    del log, rot
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ phase 4: small agreement


def small_agreement(seed) -> None:
    """The same scenario on the GPU engine and the CPU engine (the CPU one
    is held byte for byte against the JAX reference by the test suite)."""
    for name, flags in BINDINGS.items():
        cfg = EngineConfig(partitions=16, replicas=3, slots=128,
                                slot_bytes=128, max_batch=16, read_batch=16,
                                max_consumers=8, max_offset_updates=4,
                                **flags)
        rng = np.random.default_rng(seed)
        rounds = [make_round(rng, cfg, A=8, term=1,
                             leader=np.arange(16) % 3) for _ in range(6)]
        states = {}
        for dev in (DEV, "cpu"):
            fns = make_local_fns(cfg, device=dev)
            st = fns.init()
            for inp, ec, ids, _ in rounds[:3]:
                st, _ = fns.step_sparse(st, inp, ec, ids, np.ones(3, bool))
            st, _ = fns.step_many_sparse(
                st, stack_inputs([r[0] for r in rounds[3:]]),
                np.stack([r[1] for r in rounds[3:]]),
                np.stack([r[2] for r in rounds[3:]]),
                np.array([True, True, False]))
            st, _, _ = fns.vote(st, np.full(16, 1, np.int32),
                                np.full(16, 2, np.int32), np.ones(3, bool))
            states[dev] = convert.state_to_numpy(st)
        for leaf in states["cpu"]:
            if not np.array_equal(states[DEV][leaf], states["cpu"][leaf]):
                raise AssertionError(f"{name}: GPU and CPU engines disagree "
                                     f"on {leaf}")
        print(f"small-input agreement: {name}: GPU engine == CPU engine on "
              f"every state leaf", flush=True)


# ------------------------------------------------ phase 5: the main path


def make_round(rng, cfg, A, term, leader, n_active=None, with_offsets=True):
    """One sparse round built on the host, as the broker's batcher builds
    it: returns (StepInput numpy, entries_c [A, B, SB], slot_ids [A],
    produced rows by partition {p: rows [count, SB]}) plus offsets."""
    P, B, SB = cfg.partitions, cfg.max_batch, cfg.slot_bytes
    U, C = cfg.max_offset_updates, cfg.max_consumers
    n = A - A // 8 if n_active is None else n_active
    parts = rng.choice(P, n, replace=False)
    counts_a = rng.integers(1, B + 1, size=n).astype(np.int32)
    lens = rng.integers(1, cfg.payload_bytes + 1, size=(n, B)).astype(np.int32)
    lens[np.arange(B)[None, :] >= counts_a[:, None]] = 0
    rows = rng.integers(0, 256, size=(n, B, SB), dtype=np.uint8)
    rows[np.arange(SB)[None, None, :] >= (ROW_HEADER + lens)[..., None]] = 0
    rows[..., 0:4] = lens.astype("<i4").view(np.uint8).reshape(n, B, 4)
    rows[..., 4:8] = np.frombuffer(np.int32(term).tobytes(), np.uint8)
    entries_c = np.zeros((A, B, SB), np.uint8)
    slot_ids = np.full((A,), -1, np.int32)
    pos = rng.permutation(A)[:n]
    entries_c[pos] = rows
    slot_ids[pos] = parts
    counts = np.zeros(P, np.int32)
    counts[parts] = counts_a
    off_slots = rng.integers(0, C, size=(P, U)).astype(np.int32)
    off_vals = rng.integers(0, 1 << 20, size=(P, U)).astype(np.int32)
    off_counts = np.zeros(P, np.int32)
    if with_offsets:
        committers = rng.random(P) < 0.25
        off_counts[committers] = rng.integers(1, U + 1, size=committers.sum())
    inp = StepInput(
        entries=np.zeros((1, B, SB), np.uint8),  # dummy: rows ride entries_c
        counts=counts, off_slots=off_slots, off_vals=off_vals,
        off_counts=off_counts,
        leader=np.broadcast_to(np.asarray(leader, np.int32), (P,)).copy(),
        term=np.full(P, term, np.int32), extents=row_extents(counts))
    produced = {int(p): rows[i, :counts_a[i]] for i, p in enumerate(parts)}
    return inp, entries_c, slot_ids, produced


def stack_inputs(inputs):
    return StepInput(*(np.stack(f) for f in zip(*inputs)))


class Expected:
    """What the host produced and what must therefore read back."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.rows = {p: [] for p in range(cfg.partitions)}
        self.end = np.zeros(cfg.partitions, np.int64)
        self.offsets = np.zeros((cfg.partitions, cfg.max_consumers), np.int32)

    def commit(self, inp, produced, committed):
        has_work = (inp.counts > 0) | (inp.off_counts > 0)
        if not np.array_equal(committed, has_work):
            raise AssertionError("a round with work failed to commit (or an "
                                 "idle partition committed)")
        for p, rows in produced.items():
            self.rows[p].append(rows)
            self.end[p] += -(-len(rows) // 8) * 8
        for p in np.flatnonzero(inp.off_counts > 0):
            for u in range(int(inp.off_counts[p])):  # in order: later wins
                self.offsets[p, inp.off_slots[p, u]] = inp.off_vals[p, u]


def read_back(fns, state, cfg, exp: Expected) -> int:
    """Every committed row of every partition through read_many (replica
    p % R serves partition p), compared byte- and count-exact."""
    P, R, RB = cfg.partitions, cfg.replicas, cfg.read_batch
    parts = np.arange(P)
    reps = parts % R
    cursor = np.zeros(P, np.int64)
    got_rows, got_part = [], []
    calls = 0
    while True:
        rows, lens, count = fns.read_many(state, reps, parts, cursor)
        calls += 1
        rows, lens, count = rows.cpu().numpy(), lens.cpu().numpy(), count.cpu().numpy()
        if not count.any():
            break
        valid = (np.arange(RB)[None, :] < count[:, None]) & (lens > 0)
        got_rows.append(rows[valid])
        got_part.append(np.broadcast_to(parts[:, None], valid.shape)[valid])
        cursor += count
    if not np.array_equal(cursor, exp.end):
        raise AssertionError("read-back stopped short of the commit index")
    got_rows = np.concatenate(got_rows)
    got_part = np.concatenate(got_part)
    order = np.argsort(got_part, kind="stable")
    got = got_rows[order]
    want = np.concatenate([r for p in range(P) for r in exp.rows[p]])
    if got.shape != want.shape:
        raise AssertionError(f"read back {got.shape[0]} messages, produced "
                             f"{want.shape[0]}")
    if not np.array_equal(got, want):
        raise AssertionError("read-back bytes differ from the produced rows")

    # The decoder on one window (`read`): the first storage rows of a
    # partition, padding rows included, decode to its first payloads.
    p0 = next(p for p in range(P) if exp.rows[p])
    msgs = decode_entries(*fns.read(state, p0 % R, p0, 0))
    storage = np.concatenate([np.concatenate(
        [r, np.zeros((-len(r) % 8, r.shape[1]), np.uint8)])
        for r in exp.rows[p0]])[:RB]
    n = storage[:, 0:4].copy().view("<i4")[:, 0]
    if msgs != [bytes(r[8:8 + k]) for r, k in zip(storage, n) if k > 0]:
        raise AssertionError(f"decode_entries differs on partition {p0}")
    return int(want.shape[0]), calls


def main_path(binding, seed, card) -> dict:
    ops = append_ops
    cfg = EngineConfig(**HEADLINE, **BINDINGS[binding])
    R, P = cfg.replicas, cfg.partitions
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    fns = make_local_fns(cfg)
    state = fns.init()
    exp = Expected(cfg)
    leader = np.arange(P) % R
    alive = np.ones(R, bool)
    t0 = time.perf_counter()

    ops.reset_launches()
    # 8 single sparse rounds, the active set alternating wide and narrow.
    for k in range(8):
        A = 1024 if k % 2 == 0 else 64
        inp, ec, ids, produced = make_round(rng, cfg, A, 1, leader)
        state, out = fns.step_sparse(state, inp, ec, ids, alive)
        exp.commit(inp, produced, out.committed.cpu().numpy())
    # One chained dispatch of 8 rounds, active set varying within it.
    chain = [make_round(rng, cfg, 1024, 1, leader,
                        n_active=int(rng.integers(64, 1024)))
             for _ in range(8)]
    state, outs = fns.step_many_sparse(
        state, stack_inputs([c[0] for c in chain]),
        np.stack([c[1] for c in chain]), np.stack([c[2] for c in chain]),
        alive)
    committed = outs.committed.cpu().numpy()
    for k, (inp, _, _, produced) in enumerate(chain):
        exp.commit(inp, produced, committed[k])
    # An election: every partition moves to the next replica at term 2,
    # and the new leaders commit a round.
    leader2 = (leader + 1) % R
    state, elected, votes = fns.vote(state, leader2, np.full(P, 2, np.int32),
                                     alive)
    if not bool(elected.all()) or int(votes.min()) != R:
        raise AssertionError("the term-2 election did not elect every "
                             "candidate with every vote")
    inp, ec, ids, produced = make_round(rng, cfg, 1024, 2, leader2)
    state, out = fns.step_sparse(state, inp, ec, ids, alive)
    exp.commit(inp, produced, out.committed.cpu().numpy())
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    drive_s = time.perf_counter() - t0

    commit = state.commit.cpu().numpy()
    if not (commit == exp.end[None, :]).all():
        raise AssertionError("commit index differs from the produced extent")
    n_msgs, calls = read_back(fns, state, cfg, exp)
    offsets = state.offsets.cpu().numpy()
    if not (offsets == exp.offsets[None]).all():
        raise AssertionError("replicated consumer offsets differ")
    for p, c in zip(rng.integers(0, P, 64), rng.integers(0, cfg.max_consumers, 64)):
        if int(fns.read_offset(state, int(p) % R, int(p), int(c))) != exp.offsets[p, c]:
            raise AssertionError(f"read_offset({p}, {c}) differs")
    print(f"main path: {binding}: 17 rounds + vote in {drive_s:.2f} s, "
          f"{n_msgs} messages read back byte- and count-exact in {calls} "
          f"read_many calls, commit == produced extent on all {R} replicas, "
          f"offsets via read_offset ok, kernel launches {launches}",
          flush=True)
    want_kernel = next(k for k, (b, _) in KERNELS.items() if b == binding)
    if launches[want_kernel] == 0:
        raise AssertionError(f"{want_kernel} never launched on the main path")

    # Times: chained rounds of the widest shape with device-resident
    # inputs, the ring wrapping behind a trim at the commit index.
    chain = [make_round(rng, cfg, 1024, 2, leader2, with_offsets=False)
             for _ in range(8)]
    dev_in = convert.input_from_numpy(
        stack_inputs([c[0] for c in chain])._asdict(), DEV)
    ec = torch.from_numpy(np.stack([c[1] for c in chain])).to(DEV)
    ids = torch.from_numpy(np.stack([c[2] for c in chain])).to(DEV)
    alive_t = torch.ones(R, dtype=torch.bool, device=DEV)

    def chained():
        trim = state.commit[0].clone()
        fns.step_many_sparse(state, dev_in, ec, ids, alive_t, trim=trim)

    ms_chain = cuda_time_ms(chained, reps=10, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    print(f"time: {binding}: {ms_chain / 8:.3f} ms per step_many_sparse round "
          f"(chain 8, A={ec.shape[1]}, device-resident inputs), peak device memory "
          f"{peak / 1e9:.2f} GB [{card}]", flush=True)
    profile_chain(binding, chained, rounds=8, card=card)
    del state, fns, dev_in, ec, ids
    torch.cuda.empty_cache()
    return launches


def profile_chain(binding, chained, rounds, card) -> None:
    """Where a chained dispatch's time goes: device kernel time (by the
    profiler's device events) against the host-clock wall time of the
    same dispatch, and the append kernel's part of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chained()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if not dev or busy_us <= 0:
        print(f"profile: {binding}: the profiler saw no device activity; "
              f"device busy share not measured", flush=True)
        return
    n_kernels = sum(e.count for e in dev)
    append = [e for e in dev if "append_active_kernel" in e.key]
    if sum(e.count for e in append) != rounds:
        raise AssertionError(
            f"profile: {binding}: {sum(e.count for e in append)} device "
            f"events match append_active_kernel in {rounds} rounds; the "
            f"kernel's name no longer matches what the profiler reports")
    append_us = sum(e.self_device_time_total for e in append)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    print(f"profile: {binding}: per round {wall_us / rounds:.1f} us wall, "
          f"{busy_us / rounds:.1f} us device-busy "
          f"({100 * busy_us / wall_us:.1f}%, idle {100 - 100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels / rounds:.1f} device ops/round, append kernel "
          f"{append_us / rounds:.1f} us/round; top: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / rounds:.1f} us"
                      for e in top) + f" [{card}]", flush=True)


# ------------------------------------------------ the RS kernel


def rs_matrices():
    """The 2x3 encode generator and the 10 reconstruct inverses, keyed by
    the surviving shard rows."""
    ext = rs_ops.extended_matrix(3, 2)
    inverses = {rows: rs_ops.gf_invert([ext[r] for r in rows])
                for rows in itertools.combinations(range(5), 3)}
    return rs_ops.generator_matrix(3, 2), inverses


RS_WIDTHS = (1, 15, 16, 17, 33, 4095, 4097)
RS_OFFSETS = (0, 1, 7, 15)


def rs_kernel_vs_plain(seed) -> int:
    """The GF(2^8) kernel against its plain version, torch.equal: at a
    sealed 64 MiB segment's shard length with the encode matrix and all
    10 inverses; every pair of input and output row offsets in
    {0, 1, 7, 15} bytes at ragged and small widths and at the full
    width; small odd and aligned widths, the largest tiled matrix, and
    N = 0 (no launch)."""
    g = torch.Generator(device=DEV).manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 3)

    def rand(k, n):
        return torch.empty((k, n), dtype=torch.uint8, device=DEV).random_(
            generator=g)

    enc, inverses = rs_matrices()
    full = rand(3, SHARD_N)
    cases = [("encode", enc, full)] + [
        ("inverse" + "".join(map(str, rows)), m, full)
        for rows, m in inverses.items()]
    zeros3 = rng.integers(0, 256, size=(3, 3))
    zeros3[rng.random((3, 3)) < 0.4] = 0
    zeros3[0, 0] = zeros3[2, 1] = 0
    zeros3 = tuple(tuple(int(c) for c in row) for row in zeros3)
    ident = ((1, 0), (0, 1), (0, 0))
    small = []
    for n in (1, 7, 511, 512, 513, 4096, 5000):
        small += [(f"3x3-with-zeros N={n}", zeros3, rand(3, n)),
                  (f"3x2-identity N={n}", ident, rand(2, n))]
    buf = rand(1, 3 * 4096 + 1)[0]
    small.append(("3x3-with-zeros N=4096 at a 1-byte offset", zeros3,
                  buf[1:].view(3, 4096)))
    big = tuple(tuple(int(c) for c in row)
                for row in rng.integers(0, 256, size=(16, 16)))
    small.append(("16x16 N=5000", big, rand(16, 5000)))
    worst = 0

    def check(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = 0 if equal else int((got.to(torch.int16)
                                   - want.to(torch.int16)).abs().max())
        worst = max(worst, err)
        if not equal:
            raise AssertionError(f"gf_matmul {name} disagrees with its "
                                 f"plain version (max_abs_err {err})")

    for group, items in (("N=%d" % SHARD_N, cases), ("small", small)):
        for name, m, s in items:
            check(name, rs_ops.gf_matmul(m, s), rs_ops.gf_matmul_plain(m, s))
        print(f"kernel-vs-plain: gf_matmul {group}: {len(items)} cases "
              f"equal ({', '.join(name for name, _, _ in items[:3])}, ...) "
              f"max_abs_err=0", flush=True)

    # Rows at every offset pair: inputs and outputs as views that start
    # d_in and d_out bytes into their buffers (the wrapper's output is
    # always aligned, so the kernel launch takes the view as `out`).
    n_pairs = 0
    paths = {"gf_matmul_vec16": 0, "gf_matmul_realign": 0}
    for m in (enc, inverses[(1, 2, 3)], big):
        for n in RS_WIDTHS + ((SHARD_N,) if m is enc else ()):
            for d_in, d_out in itertools.product(RS_OFFSETS, repeat=2):
                s = _offset_view((len(m[0]), n), d_in, g)
                o = _offset_view((len(m), n), d_out, g)
                before = dict(rs_ops.LAUNCHES)
                rs_ops._launch(m, s, out=o)
                for k in paths:
                    paths[k] += rs_ops.LAUNCHES[k] - before[k]
                check(f"{len(m)}x{len(m[0])} N={n} offsets in {d_in} out "
                      f"{d_out}", o, rs_ops.gf_matmul_plain(m, s))
                n_pairs += 1
    print(f"kernel-vs-plain: gf_matmul offset pairs: {n_pairs} cases equal "
          f"(2x3, 3x3, 16x16; N in {RS_WIDTHS}, and N={SHARD_N} for 2x3; "
          f"input and output offsets in {RS_OFFSETS} B), launches by path "
          f"{paths}, max_abs_err=0", flush=True)
    if not all(paths.values()):
        raise AssertionError(f"the offset pairs missed a path: {paths}")
    before = rs_ops.LAUNCHES["gf_matmul"]
    empty = rs_ops.gf_matmul(enc, rand(3, 0))
    if tuple(empty.shape) != (2, 0) or rs_ops.LAUNCHES["gf_matmul"] != before:
        raise AssertionError("gf_matmul N=0 must return (2, 0) with no launch")
    print("kernel-vs-plain: gf_matmul N=0 -> (2, 0), no launch", flush=True)
    del full, cases, small
    torch.cuda.empty_cache()
    return worst


def time_rs(seed, card) -> dict:
    """ms per launch at a 64 MiB segment's shard length, N = 22,369,622
    (realigned path: the rows start misaligned, as the segment encoder
    runs it) and at the next 16-byte multiple (the aligned path the
    stripe codec's padded widths take), encode and 3x3 reconstruct: the
    kernel alone (profiler) and through the wrapper (CUDA events), the
    inputs rotated over 3 buffers (>= 200 MB) so that they come from HBM;
    beside the plain version and the byte bound. No single PyTorch call
    computes a GF(2^8) product, so there is no library time."""
    g = torch.Generator(device=DEV).manual_seed(seed + 4)
    enc, inverses = rs_matrices()
    inv = inverses[(1, 2, 3)]
    aligned_n = -(-SHARD_N // 16) * 16
    out = {}
    for label, m, n in (("encode", enc, SHARD_N),
                        ("reconstruct", inv, SHARD_N),
                        ("encode_aligned", enc, aligned_n),
                        ("reconstruct_aligned", inv, aligned_n)):
        rot = [torch.empty((len(m[0]), n), dtype=torch.uint8,
                           device=DEV).random_(generator=g)
               for _ in range(ROTATE)]
        turn = itertools.count()

        def launch():
            rs_ops.gf_matmul(m, rot[next(turn) % ROTATE])

        path = "vec16" if n % 16 == 0 else "realign"
        kernel_ms = kernel_only_ms(launch, f"gf_matmul_{path}_kernel",
                                   reps=60)
        wrapper_ms = cuda_time_ms(launch, reps=60)
        plain_ms = cuda_time_ms(lambda: rs_ops.gf_matmul_plain(m, rot[0]),
                                reps=5)
        moved = (len(m) + len(m[0])) * n
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        out[label] = dict(ms=kernel_ms, wrapper_ms=wrapper_ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, path=path)
        print(f"time: gf_matmul {label} {len(m)}x{len(m[0])} N={n} ({path} "
              f"path): kernel {kernel_ms:.4f} ms/launch "
              f"({100 * bound_ms / kernel_ms:.1f}% of bound), through the "
              f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"library: none, bound {bound_ms:.4f} ms ({moved} B at "
              f"3.35 TB/s) [{card}]", flush=True)
        del rot
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the storage path


def round_records(inp, entries_c, slot_ids, base, committed):
    """One round's committed writes as store records, framed as the
    reference DataPlane frames them (`_round_records`): each appending
    partition's REC_APPEND (its ALIGN-rounded rows at the round's
    absolute base), then each committing partition's REC_OFFSETS
    (consumer slot, offset) pairs."""
    recs = []
    for a, p in enumerate(slot_ids):
        n = int(inp.counts[p]) if p >= 0 else 0
        if n == 0 or not committed[p]:
            continue
        adv = -(-n // ALIGN) * ALIGN
        recs.append((REC_APPEND, int(p), int(base[p]),
                     entries_c[a, :adv].tobytes()))
    for p in np.flatnonzero(inp.off_counts > 0):
        if not committed[p]:
            continue
        c = int(inp.off_counts[p])
        pairs = zip(inp.off_slots[p, :c], inp.off_vals[p, :c])
        recs.append((REC_OFFSETS, int(p), c, b"".join(
            struct.pack("<II", int(s), int(o)) for s, o in pairs)))
    return recs


def valid_shards(store_dir, name) -> int:
    return sum(erasure._read_shard(p) is not None
               for p in erasure.shard_paths(store_dir, name))


def digest(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def storage_path(seed, card, workdir):
    """Sealed-segment protection and recovery at full size: the engine's
    committed rounds into an erasure-coded store of 64 MiB segments, the
    store closed, three sealed segments damaged, `recover_image` run,
    and the image held against the engine's replica 0. Returns the
    rounds' records and the kernel launches by step."""
    cfg = EngineConfig(**HEADLINE)  # the legacy binding
    R, P = cfg.replicas, cfg.partitions
    rng = np.random.default_rng(seed + 5)
    fns = make_local_fns(cfg)
    state = fns.init()
    exp = Expected(cfg)
    leader = np.arange(P) % R
    alive = np.ones(R, bool)
    store_dir = os.path.join(workdir, "store")
    rounds = []

    rs_ops.reset_launches()
    t0 = time.perf_counter()
    store = SegmentStore(store_dir, segment_bytes=SEG_BYTES, erasure=True)
    for _ in range(STORE_ROUNDS):
        inp, ec, ids, produced = make_round(rng, cfg, STORE_A, 1, leader)
        state, out = fns.step_sparse(state, inp, ec, ids, alive)
        committed = out.committed.cpu().numpy()
        exp.commit(inp, produced, committed)
        recs = round_records(inp, ec, ids, out.base.cpu().numpy(), committed)
        store.append_many(recs)
        store.flush()
        rounds.append(recs)
    native = store.is_native  # close() drops the native handle
    store.close()
    torch.cuda.synchronize()
    protect = dict(rs_ops.LAUNCHES)
    protect_launches = protect["gf_matmul"]
    drive_s = time.perf_counter() - t0
    nbytes = sum(len(r[3]) for recs in rounds for r in recs)
    sealed = erasure._segment_names(store_dir)[:-1]
    if store.erasure_errors:
        raise AssertionError(f"erasure_errors: {store.erasure_errors}")
    if len(sealed) < 3:
        raise AssertionError(f"only {len(sealed)} sealed segments")
    short = [n for n in sealed if valid_shards(store_dir, n) != 5]
    if short:
        raise AssertionError(f"sealed segments without 5 valid shards: {short}")
    if protect_launches < len(sealed):
        raise AssertionError(f"{protect_launches} gf_matmul launches for "
                             f"{len(sealed)} sealed segments")
    print(f"storage path: {STORE_ROUNDS} step_sparse rounds (A={STORE_A}) "
          f"-> {nbytes} B of records in {len(sealed)} sealed "
          f"{SEG_BYTES >> 20} MiB segments + 1 active ({'native' if native else 'Python'}"
          f" store), each sealed segment with 5 CRC-valid shards, "
          f"erasure_errors [], gf_matmul launches while protecting: "
          f"{protect}, {drive_s:.2f} s [{card}]", flush=True)

    eng = {leaf: getattr(state, leaf)[0].cpu().numpy()
           for leaf in ("log_end", "commit", "last_term", "offsets")}
    eng_log = state.log_data[0].cpu().numpy()
    if not np.array_equal(eng["log_end"], exp.end):
        raise AssertionError("engine log end differs from the produced extent")
    del state, fns
    torch.cuda.empty_cache()

    a, b, c = sealed[0], sealed[len(sealed) // 2], sealed[-1]
    before = {n: digest(os.path.join(store_dir, n)) for n in (a, b, c)}
    def shard(n, i):
        return erasure.shard_paths(store_dir, n)[i]

    os.remove(os.path.join(store_dir, a))
    os.remove(shard(a, 0))
    os.remove(shard(a, 2))
    path_b = os.path.join(store_dir, b)
    with open(path_b, "r+b") as f:
        f.seek(os.path.getsize(path_b) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    os.remove(shard(b, 1))
    os.remove(shard(b, 4))
    os.remove(shard(c, 3))
    os.remove(shard(c, 4))

    repaired = []
    repair_s = []
    real_repair = dataplane.repair_store

    def recording_repair(*args, **kw):
        t = time.perf_counter()
        repaired.append(real_repair(*args, **kw))
        repair_s.append(time.perf_counter() - t)
        return repaired[-1]

    rs_ops.reset_launches()
    dataplane.repair_store = recording_repair
    try:
        t0 = time.perf_counter()
        image = dataplane.recover_image(cfg, store_dir)
        recover_s = time.perf_counter() - t0
    finally:
        dataplane.repair_store = real_repair
    recover = dict(rs_ops.LAUNCHES)
    if repaired != [[a, b]]:
        raise AssertionError(f"repair_store repaired {repaired}, want {[a, b]}")
    for n in (a, b, c):
        if digest(os.path.join(store_dir, n)) != before[n]:
            raise AssertionError(f"{n} differs from its bytes before the damage")
    short = [n for n in sealed if valid_shards(store_dir, n) != 5]
    if short:
        raise AssertionError(f"after recovery, sets short of 5 shards: {short}")
    img = convert.image_to_numpy(image)
    for leaf, want in eng.items():
        if not np.array_equal(img[leaf], want):
            raise AssertionError(f"recovered image differs on {leaf}")
    # Rows at and past log_end: the engine holds the last round's window
    # padding there (it writes whole B-row windows); the store never does.
    rows = np.arange(eng_log.shape[1])[None, :] < eng["log_end"][:, None]
    if not np.array_equal(img["log_data"][rows], eng_log[rows]):
        raise AssertionError("recovered log rows differ below log_end")
    print(f"storage path: recover_image repaired {repaired[0]} byte-exact "
          f"(a: file + shards 0,2 lost; b: a flipped byte + shards 1,4 "
          f"lost; c: parity 3,4 lost, re-encoded), every sealed set back at "
          f"5 valid shards, image == engine replica 0 on log_end, commit, "
          f"last_term, offsets and {int(rows.sum())} committed rows; "
          f"gf_matmul launches while recovering: {recover}, "
          f"{recover_s:.2f} s ({repair_s[0]:.2f} s in repair_store, "
          f"{recover_s - repair_s[0]:.2f} s scanning and replaying) "
          f"[{card}]", flush=True)
    return rounds, {"protect": protect, "recover": recover}


# ------------------------------------------------ the stripe path


def stripe_path(rounds, card) -> dict:
    """Striped replication at full size: each round's records encoded as
    one stripe group on the card, the frames spread over 4 standbys by
    the replicated assignment, one standby lost, and the record stream
    rebuilt from the other three."""
    members = [1, 2, 3, 4]
    held = stripe_assignment(members)
    stores = {m: [] for m in members}
    groups = []
    rs_ops.reset_launches()
    t0 = time.perf_counter()
    for k, recs in enumerate(rounds):
        frames = encode_group(recs, epoch=1, gsn=k, settled_floor=k)
        groups.append(frames)
        for i, f in enumerate(frames):
            stores[held[i]].append((REC_STRIPE, i, k, f))
    encode_s = time.perf_counter() - t0
    encode_launches = dict(rs_ops.LAUNCHES)

    def fetcher(records):
        def fetch(after):
            return [r[3] for r in records], None
        return fetch

    lost = [i for i, m in enumerate(held) if m == 1]
    rs_ops.reset_launches()
    t0 = time.perf_counter()
    got = rebuild_records(iter(stores[2]), [("member3", fetcher(stores[3])),
                                            ("member4", fetcher(stores[4]))])
    rebuild_s = time.perf_counter() - t0
    rebuild_launches = dict(rs_ops.LAUNCHES)
    want = [r for recs in rounds for r in recs]
    if got != want:
        raise AssertionError("the rebuilt record stream differs from the "
                             "controller's")
    if rebuild_launches["gf_matmul"] != len(rounds):
        raise AssertionError(f"{rebuild_launches} reconstruct launches for "
                             f"{len(rounds)} groups")
    nbytes = sum(len(r[3]) for r in want)
    frame_bytes = sum(len(f) for frames in groups for f in frames)
    print(f"stripe path: {len(rounds)} groups encoded on the card "
          f"({nbytes} B of records -> {frame_bytes} B of frames, "
          f"{encode_launches} launches, {encode_s:.2f} s), member 1 lost "
          f"(stripes {lost}), rebuild_records from members 2-4 == the "
          f"controller's {len(want)} records in order, {rebuild_launches} "
          f"reconstruct launches, {rebuild_s:.2f} s [{card}]", flush=True)

    widest = max(range(len(rounds)), key=lambda k: len(groups[k][0]))
    parsed = {i: parse_frame(f) for i, f in enumerate(groups[widest])}
    for gone in itertools.combinations(range(5), 2):
        frames = {i: f for i, f in parsed.items() if i not in gone}
        if reconstruct_group(frames) != rounds[widest]:
            raise AssertionError(f"group {widest} with stripes {gone} lost "
                                 f"reconstructs wrong records")
    smallest = min(range(len(rounds)), key=lambda k: len(groups[k][0]))
    cpu = encode_group(rounds[smallest], epoch=1, gsn=smallest,
                       settled_floor=smallest, device="cpu")
    if cpu != groups[smallest]:
        raise AssertionError("card frames differ from the CPU encoder's")
    print(f"stripe path: widest group ({len(groups[widest][0])} B stripes) "
          f"reconstructs under all 10 two-loss patterns; group {smallest}'s "
          f"frames byte-equal to encode_group(device='cpu')", flush=True)
    return {"encode": encode_launches, "rebuild": rebuild_launches}


def time_erasure(workdir, card) -> None:
    """Where `encode_segment`'s time goes for one 64 MiB segment (its
    steps timed one by one with a synchronise after each), and
    `encode_group`'s rate at the reference bench's shape."""
    d = os.path.join(workdir, "seg64")
    os.makedirs(d)
    name = "segment-00000000.log"
    path = os.path.join(d, name)
    with open(path, "wb") as f:
        f.write(np.random.default_rng(1).integers(
            0, 256, SEG_BYTES, dtype=np.uint8).tobytes())
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        erasure.encode_segment(d, name)
        walls.append(time.perf_counter() - t0)

    steps = {}

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = (time.perf_counter() - t0) * 1e3
        return out

    raw = step("read", lambda: open(path, "rb").read())
    n = -(-len(raw) // 3)

    def prep():
        padded = np.zeros(3 * n, np.uint8)
        padded[:len(raw)] = np.frombuffer(raw, np.uint8)
        return padded.reshape(3, n)

    data = step("host pad", prep)
    dev = step("host->device", lambda: torch.from_numpy(data).to(DEV))
    parity = step("kernel", lambda: rs_ops.rs_encode(dev))
    host = step("device->host", lambda: parity.cpu().numpy())
    step("crc32", lambda: [zlib.crc32(raw)] + [
        zlib.crc32(x.tobytes()) for x in (*data, *host)])
    out_dir = os.path.join(d, "split")
    os.makedirs(out_dir)

    def write():
        for i, x in enumerate((*data, *host)):
            with open(os.path.join(out_dir, f"shard{i}"), "wb") as f:
                f.write(erasure._HEADER.pack(0, 0, i, 3, 2, 0, 0, 0)
                        + x.tobytes())
                f.flush()
                os.fsync(f.fileno())

    step("shard writes + fsync", write)
    total = sum(steps.values())
    print(f"time: encode_segment of one {SEG_BYTES} B segment: "
          + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms wall (3 calls); "
          "its steps one by one: " + ", ".join(
              f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
              for k, v in steps.items()) + f" [{card}]", flush=True)

    records = [(1, 0, i, bytes(64 << 10)) for i in range(64)]
    nbytes = sum(len(r[3]) for r in records)
    encode_group(records, 1, 0)
    rates = []
    for r in range(1, 6):
        t0 = time.perf_counter()
        encode_group(records, 1, r)
        rates.append(nbytes / (time.perf_counter() - t0) / 1e6)
    print(f"time: encode_group at the bench's shape (64 records of 64 KiB): "
          f"best {max(rates):.1f} MB/s, runs "
          + ", ".join(f"{x:.1f}" for x in rates) + f" [{card}]", flush=True)


def build_kernels() -> None:
    """Both kernel libraries, one nvcc each, started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(append_ops.build), pool.submit(rs_ops.build)]:
            f.result()
    for name in ("append", "rs"):
        built_s, report = cuda_build.BUILD_INFO[name]
        regs = "; ".join(line.strip() for line in report.splitlines()
                         if "registers" in line)
        print(f"build: {name}.cu {'built' if built_s else 'cached'} in "
              f"{built_s:.2f} s (nvcc sm_90a; {regs})", flush=True)
    print(f"build: both kernels ready in {time.perf_counter() - t0:.2f} s",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device here; this script runs on the GPU "
              "only", file=sys.stderr)
        return 1

    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    build_kernels()
    cfg = EngineConfig(**HEADLINE)
    errs = kernel_vs_plain(append_ops, cfg, args.seed)
    errs["gf_matmul"] = rs_kernel_vs_plain(args.seed)
    times = time_kernels(append_ops, cfg, args.seed, card)
    rs_times = time_rs(args.seed, card)
    small_agreement(args.seed)
    launches = {}
    for binding in BINDINGS:
        got = main_path(binding, args.seed, card)
        for name, (b, _) in KERNELS.items():
            if b == binding:
                launches[name] = got[name]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        rounds, rs_storage = storage_path(args.seed, card, workdir)
        rs_stripes = stripe_path(rounds, card)
        del rounds
        time_erasure(workdir, card)

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name]["ms"], wrapper_ms=times[name]["wrapper_ms"],
                    plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"], bound_by="bytes",
                    library_ms=times[name]["library_ms"],
                    copy_ms=times[name]["copy_ms"],
                    matched_plain=errs[name] == 0)
               for name, (_, replaces) in KERNELS.items()]
    enc = rs_times["encode"]
    by_path = {"storage": rs_storage, "stripes": rs_stripes}
    kernels.append(dict(
        name="gf_matmul", route="cuda", source=RS_SOURCE,
        replaces=RS_REPLACES,
        launches=sum(c["gf_matmul"] for p in by_path.values()
                     for c in p.values()),
        launches_by_path=by_path,
        max_abs_err=errs["gf_matmul"], ms=enc["ms"],
        wrapper_ms=enc["wrapper_ms"], plain_ms=enc["plain_ms"],
        bound_ms=enc["bound_ms"], bound_by="bytes", library_ms=None,
        shape=f"2x3 encode, N={SHARD_N} (realigned path)",
        **{k: v for k, v in rs_times.items() if k != "encode"},
        matched_plain=errs["gf_matmul"] == 0))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

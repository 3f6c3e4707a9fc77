#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (`ripplemq_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N]

Runs only where `torch.cuda.is_available()`; exits nonzero at once
elsewhere, and when run outside a checkout of the repository (the port's
package must be importable next to it). Every phase prints one line; a
phase that fails raises, and the script exits nonzero with no result.

1. the card's name and power limit (nvidia-smi);
2. the kernel build: `ops/csrc/append.cu` compiled by nvcc for sm_90a;
3. the append kernel against its plain PyTorch version at full width —
   the bench's headline engine shape (1024 partitions x 5 replicas,
   slots 12352, B 256, SB 128: an 8.26 GB ring log) — legacy and packed,
   A = 64 and A = 1024 active entries, both from one cloned random log,
   the whole log compared with torch.equal;
4. agreement on a small input: the engine on the GPU (kernel) and on the
   CPU (plain version) replay one scenario to equal state;
5. the main path, once per binding (legacy; fused_control +
   packed_writes), through `make_local_fns(cfg)` on CUDA at the headline
   shape: 16 sparse rounds (8 `step_sparse`, one `step_many_sparse`
   chain of 8) with seeded payloads and a varying active set, a vote and
   a round under the new leaders, then every committed message read back
   through `read_many` and compared byte- and count-exact with what was
   produced, and the committed consumer offsets through `read_offset`.
   Kernel launch counts are zeroed just before and read just after;
6. times (CUDA events, after warm-up): ms per chained round, per kernel
   launch, the plain version's and `index_put_`'s, the bytes/s written,
   and peak device memory;
7. a JSON line naming each ported kernel, then the card line again, then
   the result line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.core.config import ROW_HEADER, EngineConfig
from ripplemq_tpu_torch.core.encode import decode_entries, row_extents
from ripplemq_tpu_torch.core.state import StepInput
from ripplemq_tpu_torch.ops import append as append_ops
from ripplemq_tpu_torch.ops import cuda_build
from ripplemq_tpu_torch.parallel.engine import make_local_fns

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


def random_case(g, cfg, A, *, to_ring_end, write_p=0.7):
    """Seeded device inputs for one append: entries, slot ids (distinct,
    with -1 pads), aligned bases, do_write, extents in 0..B."""
    dev = DEV
    R, P, B, SB = cfg.replicas, cfg.partitions, cfg.max_batch, cfg.slot_bytes
    SP = cfg.slots + B
    entries = torch.empty((A, B, SB), dtype=torch.uint8, device=dev).random_(
        generator=g)
    n_active = A - A // 8
    ids = torch.full((A,), -1, dtype=torch.int32, device=dev)
    where = torch.randperm(A, generator=g, device=dev)[:n_active]
    ids[where] = torch.randperm(P, generator=g, device=dev)[:n_active].to(
        torch.int32)
    hi = SP // 8 if to_ring_end else (SP - B) // 8 + 1
    base = (torch.randint(0, hi, (P,), generator=g, device=dev) * 8).to(
        torch.int32)
    do_write = torch.rand((R, P), generator=g, device=dev) < write_p
    extents = torch.randint(0, B + 1, (P,), generator=g, device=dev).to(
        torch.int32)
    return entries, ids, base, do_write, extents


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    worst = 0
    for r in range(a.shape[0]):  # chunked: the log is 8 GB
        worst = max(worst, int((a[r].to(torch.int16) - b[r].to(torch.int16))
                               .abs().max()))
    return worst


def kernel_vs_plain(ops, cfg, seed) -> dict:
    g = torch.Generator(device=DEV).manual_seed(seed)
    shape = (cfg.replicas, cfg.partitions, cfg.slots + cfg.max_batch,
             cfg.slot_bytes)
    log_k = torch.empty(shape, dtype=torch.uint8, device=DEV).random_(
        generator=g)
    log_p = log_k.clone()
    errs = {k: 0 for k in KERNELS}
    for A in (64, 1024):
        for packed in (False, True):
            entries, ids, base, do_write, ext = random_case(
                g, cfg, A, to_ring_end=True)
            ext = ext if packed else None
            ops.append_rows_active(log_k, entries, ids, base, do_write,
                                   extents=ext)
            ops.append_rows_active_plain(log_p, entries, ids, base,
                                         do_write, ext)
            torch.cuda.synchronize()
            rows = int(ops._plain_writes(log_p, entries, ids, base, do_write,
                                         ext)[0].numel())
            equal = torch.equal(log_k, log_p)
            err = 0 if equal else max_abs_err(log_k, log_p)
            name = "append_active_packed" if packed else "append_active"
            errs[name] = max(errs[name], err)
            print(f"kernel-vs-plain: {name} A={A}: rows written={rows} "
                  f"whole {log_k.numel()} B log equal={equal} "
                  f"max_abs_err={err}", flush=True)
            if not equal or rows == 0:
                raise AssertionError(f"{name} A={A} disagrees with its plain "
                                     f"version (or wrote nothing)")
    del log_k, log_p
    torch.cuda.empty_cache()
    return errs


def time_kernels(ops, cfg, seed, card) -> dict:
    """Per-launch times at the main path's widest round (A = 1024, every
    replica writing), beside the plain version, index_put_ and the bound."""
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    shape = (cfg.replicas, cfg.partitions, cfg.slots + cfg.max_batch,
             cfg.slot_bytes)
    log = torch.zeros(shape, dtype=torch.uint8, device=DEV)
    entries, ids, base, do_write, extents = random_case(
        g, cfg, 1024, to_ring_end=False, write_p=1.0)
    extents = extents.clamp_min(1)  # every main-path round carries >= 1 row
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
        ms = cuda_time_ms(lambda: ops.append_rows_active(
            log, entries, ids, base, do_write, extents=ext), reps=50)
        plain_ms = cuda_time_ms(lambda: ops.append_rows_active_plain(
            log, entries, ids, base, do_write, ext), reps=5)
        vals = entries[a_i, b_i]
        lib_ms = cuda_time_ms(
            lambda: log.index_put_((r_i, p_i, row_i), vals), reps=10)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bytes=moved, written=written)
        print(f"time: {name} A={entries.shape[0]} R={cfg.replicas} "
              f"B={cfg.max_batch} SB={cfg.slot_bytes}: {ms:.4f} ms/launch, "
              f"plain {plain_ms:.3f} ms, index_put_ {lib_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({moved} B at 3.35 TB/s), "
              f"{written / ms / 1e6:.2f} GB/s written [{card}]", flush=True)
    del log
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
    append_us = sum(e.self_device_time_total for e in dev
                    if "append_active_kernel" in e.key)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    print(f"profile: {binding}: per round {wall_us / rounds:.1f} us wall, "
          f"{busy_us / rounds:.1f} us device-busy "
          f"({100 * busy_us / wall_us:.1f}%, idle {100 - 100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels / rounds:.1f} device ops/round, append kernel "
          f"{append_us / rounds:.1f} us/round; top: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / rounds:.1f} us"
                      for e in top) + f" [{card}]", flush=True)


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

    t0 = time.perf_counter()
    append_ops.build()
    built_s, report = cuda_build.BUILD_INFO["append"]
    regs = "; ".join(line.strip() for line in report.splitlines()
                     if "registers" in line)
    print(f"build: append.cu {'built' if built_s else 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc sm_90a; {regs})", flush=True)

    cfg = EngineConfig(**HEADLINE)
    errs = kernel_vs_plain(append_ops, cfg, args.seed)
    times = time_kernels(append_ops, cfg, args.seed, card)
    small_agreement(args.seed)
    launches = {}
    for binding in BINDINGS:
        got = main_path(binding, args.seed, card)
        for name, (b, _) in KERNELS.items():
            if b == binding:
                launches[name] = got[name]

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name]["ms"], plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"], bound_by="bytes",
                    library_ms=times[name]["library_ms"],
                    matched_plain=errs[name] == 0)
               for name, (_, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark of the PyTorch port: committed-appends/sec, produce-ack
latency percentiles, consume and end-to-end rates on one GPU.

Twin of the repository root's `bench.py` (the reference's measuring
program) for the phases behind its headline metrics: the same functions
under the same names, each measuring the same way, on the port's
engine, DataPlane, broker and clients. Run:

    python -m ripplemq_tpu_torch.bench                 # full run, archived
    python -m ripplemq_tpu_torch.bench --compare BENCH_torch_r01.json
    python -m ripplemq_tpu_torch.bench operating_curve [OUT.json]
    python -m ripplemq_tpu_torch.bench consume_fanout | split_rebalance | control_plane_storm
    python -m ripplemq_tpu_torch.bench --device cpu --out DIR

Prints ONE JSON line: the reference's artifact keys, in its order
(`value`, `vs_baseline`, `shipped_shape_appends_per_sec`,
`p50/p99/p999_ack_ms`, `round_rtt_ms`, `operating_curve`,
`consume_msgs_per_sec`, `spmd_parity`, `spmd_scaling`,
`control_fusion_ab`, `codec_mb_per_sec`, `repl_bytes_per_acked_byte`,
`stripe_encode_mb_per_sec`, `host_plane_scaling`, `slo_convergence`,
`split_rebalance`, `consume_fanout`, `control_plane_storm`,
`group_consume`, the `e2e_*` figures, `readback`, ...: `RESULT_KEYS`),
plus `card`: the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them, and the
device count. The three phase modes run one phase alone and print the
reference's JSON for it.

What differs from the reference, and why:

- Every runner takes an explicit `device`. Without one the engine, the
  DataPlane and the brokers run on CUDA, and raise where there is no
  GPU: the bench never falls back to the CPU. `--device cpu` is for
  tests; it also picks the short depths (`DEPTHS`), as the reference's
  `main()` does on a CPU backend. The depth never depends on what
  hardware is detected, only on `--device`.
- Inputs are staged on the device as tensors before a timed window
  (`_make`'s `put`, `_stack`), the alive mask and the quorum too: a
  numpy argument would be a pageable, host-synchronous copy per launch.
- The fence of every timed window is the D2H copy of the last launch's
  `committed` (`_fetch`), which waits for the stream.
- The artifact is `BENCH_torch_r<NN>.json`, at the repository root or
  in `--out DIR`: never `BENCH_r<NN>.json`, which are the reference's
  TPU rounds. `--compare` refuses a baseline without an NVIDIA `card`.
- The e2e standbys start as `python -m ripplemq_tpu_torch.broker`, the
  clients as `python -m ripplemq_tpu_torch.bench _e2e_client SPEC`,
  whose import chain stays torch-free (checked from outside, through
  `/proc/<pid>/maps`, while they run). The fan-out's brokers are such
  broker processes too, each with its own CUDA context on the card.
- A mesh cell is a process: the spmd parity A/B forms a world of one
  in this process (and leaves it before returning), the scaling curve
  runs each rank count as a world of that many processes on the one
  card (gloo: two ranks share the GPU), where the reference forces
  virtual CPU devices.

torch is imported inside the functions that need it, as the reference
imports jax: the client subprocess never loads it.
"""

from __future__ import annotations

import json
import time

import numpy as np

PAYLOAD = b"bench-payload-" + b"x" * 86  # 100 bytes, recognizable prefix

# Window lengths: "full" are the reference's accelerator depths, "short"
# its CPU-backend depths (bench.py main: 48 launches x 2 windows, A/B 32,
# baseline 500, spmd parity 32), with the e2e phase and the host-plane
# sweep's arms cut to one 4 s phase. Only durations differ: every
# topology, partition, member, consumer and worker count is the same.
DEPTHS = {
    "full": dict(eng_launches=480, eng_windows=3, ab_launches=240,
                 base_launches=2000, e2e_s=12.0, e2e_phases=2,
                 parity_launches=240, hp_s=6.0, hp_phases=2),
    "short": dict(eng_launches=48, eng_windows=2, ab_launches=32,
                  base_launches=500, e2e_s=4.0, e2e_phases=1,
                  parity_launches=32, hp_s=4.0, hp_phases=1),
}


def _device(device=None):
    """The torch device the bench runs on: CUDA unless `device` names
    another; raises when none is named and no GPU is present."""
    import torch

    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the bench runs on the GPU; pass "
            "--device cpu (device='cpu') to run it on the CPU explicitly")
    return torch.device("cuda" if device is None else device)


def _fetch(x) -> np.ndarray:
    """Host copy of a device tensor: the execution fence of a window."""
    return x.cpu().numpy()


def _make(cfg, device=None):
    """(fns, alive, quorum, build, put): the engine's entry points on
    `device`, the all-alive mask and the quorum vector staged there, the
    host input encoder, and `put`, which stages a numpy array there."""
    import torch

    from ripplemq_tpu_torch.core.encode import build_step_input
    from ripplemq_tpu_torch.parallel.engine import make_local_fns

    dev = _device(device)
    fns = make_local_fns(cfg, dev)
    alive = torch.ones((cfg.partitions, cfg.replicas), dtype=torch.bool,
                       device=dev)
    quorum = torch.full((cfg.partitions,), cfg.quorum, dtype=torch.int32,
                        device=dev)

    def put(x):
        # A writable, C-contiguous copy: a broadcast view copies to a
        # layout with the broadcast axis innermost, which the kernel
        # (and a chain's per-round slices) must not get.
        return torch.as_tensor(np.array(x, order="C"), device=dev)

    return fns, alive, quorum, build_step_input, put


def _stack(one, chain: int, put):
    """`chain` copies of one round's StepInput, stacked to [chain, ...]
    and staged on the device (the chained input of `step_many`)."""
    return type(one)(*(
        None if x is None else put(np.broadcast_to(x, (chain,) + x.shape))
        for x in one
    ))


def _read_and_check(fns, state, replica: int, p: int, offset: int,
                    batch: int, where: str) -> None:
    """Walk the read window from `offset` until `batch` messages arrived
    and byte-compare each against PAYLOAD."""
    from ripplemq_tpu_torch.core.encode import decode_entries

    msgs: list[bytes] = []
    while len(msgs) < batch:  # reads window read_batch rows
        data, lens, count = fns.read(state, replica, p, offset)
        got = decode_entries(data, lens, count)
        assert got, f"readback {where}: {len(msgs)} of {batch} messages"
        msgs.extend(got)
        offset += int(count)
    for m in msgs[:batch]:
        assert m == PAYLOAD, (
            f"readback {where}: corrupt payload {m[:24]!r}..."
        )


def _verify_readback(cfg, fns, state, rounds: int, batch: int) -> None:
    """Byte-compare a sample of appended payloads across partitions,
    rounds and replicas (round r of partition p starts at row r*adv from
    a fresh init: rounds advance by ALIGN-padded windows)."""
    from ripplemq_tpu_torch.core.config import ALIGN

    adv = -(-batch // ALIGN) * ALIGN
    parts = sorted({0, 1, cfg.partitions // 2, cfg.partitions - 1})
    some_rounds = sorted({0, rounds // 2, rounds - 1})
    for p in parts:
        for r in some_rounds:
            for replica in (0, cfg.replicas - 1):
                _read_and_check(
                    fns, state, replica, p, r * adv, batch,
                    f"partition {p} round {r} replica {replica}",
                )


def _run_mode(cfg, batch_per_partition: int, rounds: int, warmup: int,
              verify: bool = False, chain: int = 1, device=None) -> float:
    """Burst-window committed-appends/sec (the reference's r3/r4 method):
    a fresh ring, one timed window of `rounds` rounds, dispatched in
    chains of `chain` complete quorum rounds through `step_many` when
    `chain` > 1."""
    fns, alive, quorum, build, put = _make(cfg, device)
    appends = {
        p: [PAYLOAD] * batch_per_partition for p in range(cfg.partitions)
    }
    one = build(cfg, appends=appends, leader=0, term=1)
    if chain > 1:
        assert rounds % chain == 0
        inp = _stack(one, chain, put)
        launch = lambda st: fns.step_many(st, inp, alive, quorum)
        launches = rounds // chain
    else:
        inp = type(one)(*(None if x is None else put(x) for x in one))
        launch = lambda st: fns.step(st, inp, alive, quorum)
        launches = rounds

    state = fns.init()
    for _ in range(warmup):
        state, out = launch(state)
    assert bool(_fetch(out.committed).all()), "warmup round failed"

    del state, out  # one engine state on the card at a time
    state = fns.init()  # fresh log so timed rounds never hit capacity
    t0 = time.perf_counter()
    for _ in range(launches):
        state, out = launch(state)
    committed = _fetch(out.committed)  # D2H copy = execution fence
    dt = time.perf_counter() - t0
    assert bool(committed.all()), "timed round failed"
    total = rounds * cfg.partitions * batch_per_partition
    if verify:
        _verify_readback(cfg, fns, state, rounds, batch_per_partition)
    return total / dt


def _run_sustained(cfg, chain: int = 8, launches: int = 480,
                   windows: int = 3, verify: bool = True,
                   batch_per_partition: int | None = None,
                   partitions: int | None = None, device=None) -> float:
    """STEADY-STATE committed-appends/sec: the ring wraps behind a trim
    watermark staged ahead of each launch, as the broker raises trim to
    the persisted prefix. Launches are enqueued back to back (the state
    is updated in place on one stream, which orders them), the final
    `committed` fetch fences the window, best of `windows` windows; the
    best window's ring tail is byte-verified after its clock stops."""
    from ripplemq_tpu_torch.core.config import ALIGN

    fns, alive, quorum, build, put = _make(cfg, device)
    bpp = cfg.max_batch if batch_per_partition is None else batch_per_partition
    nparts = cfg.partitions if partitions is None else partitions
    adv_round = -(-bpp // ALIGN) * ALIGN  # ALIGN-padded rows per round
    one = build(cfg, appends={p: [PAYLOAD] * bpp for p in range(nparts)},
                leader=0, term=1)
    inp = _stack(one, chain, put)
    adv = chain * adv_round  # rows per launch per appending partition
    trims = _stage_trims(cfg, adv, launches, put, adv_round=adv_round)
    _sustained_warmup(fns, inp, alive, quorum, trims)
    best = 0.0
    for _ in range(windows):
        rate, state = _sustained_window(
            fns, inp, alive, quorum, trims, launches * chain * bpp * nparts
        )
        if rate > best:
            best = rate
            if verify:
                # Verify this window's tail now: holding the state for a
                # later check would keep a second engine state (8.26 GB at
                # the headline shape) across the next window's init.
                _verify_ring_tail(fns, state,
                                  total_rows=launches * adv,
                                  batch=bpp, adv_round=adv_round,
                                  nparts=nparts)
        del state
    return best


def _stage_trims(cfg, adv: int, launches: int, put,
                 adv_round: int | None = None) -> list:
    """Every launch's trim watermark, staged on the device BEFORE the
    timed window (trim k lets launch k's rounds wrap the ring). The
    capacity rule reserves the full max_batch window (`base + B - trim
    <= S`), so partial-batch windows push the trim `B - adv_round` rows
    further ahead than their own growth."""
    reserve = cfg.max_batch - (cfg.max_batch if adv_round is None
                               else adv_round)
    return [
        put(np.full((cfg.partitions,),
                    max(0, (k + 1) * adv + reserve - cfg.slots), np.int32))
        for k in range(launches)
    ]


def _sustained_warmup(fns, inp, alive, quorum, trims) -> None:
    state, out = fns.step_many(fns.init(), inp, alive, quorum, trims[0])
    assert bool(_fetch(out.committed).all()), "warmup launch failed"


def _sustained_window(fns, inp, alive, quorum, trims, work: float):
    """ONE timed steady-state window from a fresh state: launches are
    enqueued back to back, the final committed fetch fences, every
    chained round of the final launch is asserted committed. Returns
    (rate, final state); the caller may verify the state's ring tail
    but must DROP it before the next window."""
    state = fns.init()
    t0 = time.perf_counter()
    for trim in trims:
        state, out = fns.step_many(state, inp, alive, quorum, trim)
    committed = _fetch(out.committed)  # D2H copy = execution fence
    dt = time.perf_counter() - t0
    assert bool(committed.all()), "sustained round failed"
    return work / dt, state


def _verify_ring_tail(fns, state, total_rows: int, batch: int,
                      adv_round: int, nparts: int,
                      tail_rounds: int = 3) -> None:
    """Byte-compare payloads from the last ring-resident rounds of the
    sustained run (earlier rounds were overwritten after trim passed
    them: the retention contract, not data loss)."""
    # Partition 1 does not exist at nparts=1 (the engine's read clips
    # out-of-range ids to 0, which would re-verify partition 0).
    parts = sorted({0, nparts // 2, nparts - 1}
                   | ({1} if nparts > 1 else set()))
    for p in parts:
        for r in range(tail_rounds):
            offset = total_rows - (r + 1) * adv_round
            _read_and_check(
                fns, state, 0, p, offset, batch,
                f"sustained partition {p} offset {offset}",
            )


def _run_control_only(cfg, chain: int = 8, launches: int = 240,
                      windows: int = 3, device=None) -> float:
    """CONTROL-PHASE rounds/s, sustained method: offsets-only rounds
    commit but advance no log rows, so no round writes the log (the
    append kernel still launches, with nothing to copy). Run with
    cfg.fused_control on and off and compare ms/round."""
    fns, alive, quorum, build, put = _make(cfg, device)
    one = build(
        cfg,
        offset_updates={p: [(0, 1)] for p in range(cfg.partitions)},
        leader=0, term=1,
    )
    inp = _stack(one, chain, put)
    # No log growth -> trim stays zero; one staged tensor per launch so
    # the timed loop has the sustained path's call shape.
    zero_trim = put(np.zeros((cfg.partitions,), np.int32))
    trims = [zero_trim] * launches
    _sustained_warmup(fns, inp, alive, quorum, trims)
    best = 0.0
    for _ in range(windows):
        rate, state = _sustained_window(
            fns, inp, alive, quorum, trims, launches * chain
        )
        best = max(best, rate)  # rounds/s
        del state
    return best


def _run_fusion_ab(chain: int = 8, launches: int = 240,
                   control_launches: int = 240, windows: int = 2,
                   shape: dict | None = None, device=None) -> dict:
    """Same-process A/B of fused control and packed writes vs the legacy
    path, at the headline shape unless `shape` overrides it: control-only
    ms/round (legacy, fused), sustained appends/s for all four flag
    combinations, and quarter-batch rounds (legacy vs both levers), each
    variant's best-of-`windows` in sequence. Each engine is dropped
    before the next is built. `python -m
    ripplemq_tpu_torch.profiles.control_ab` runs this standalone."""
    from ripplemq_tpu_torch.core.config import ALIGN, EngineConfig

    base = dict(
        partitions=1024, replicas=5, slots=12352, slot_bytes=128,
        max_batch=256, read_batch=32, max_consumers=64,
        max_offset_updates=8,
    )
    base.update(shape or {})
    variants = {
        "legacy": {},
        "fused": dict(fused_control=True),
        "packed": dict(packed_writes=True),
        "fused_packed": dict(fused_control=True, packed_writes=True),
    }
    out = {"config": (f"P={base['partitions']} R={base['replicas']} "
                      f"B={base['max_batch']} chain={chain} sustained")}
    for name in ("legacy", "fused"):
        cfg = EngineConfig(**base, **variants[name])
        rate = _run_control_only(cfg, chain=chain,
                                 launches=control_launches,
                                 windows=windows, device=device)
        out[f"control_ms_per_round_{name}"] = round(1e3 / rate, 4)
    for name, kw in variants.items():
        cfg = EngineConfig(**base, **kw)
        rate = _run_sustained(cfg, chain=chain, launches=launches,
                              windows=windows, verify=True, device=device)
        out[f"sustained_appends_per_sec_{name}"] = round(rate, 1)
    # Quarter-full batches, where packed writes move fewer bytes (a full
    # round's extent is the whole window): legacy vs both levers.
    partial = max(ALIGN, base["max_batch"] // 4)
    for name in ("legacy", "fused_packed"):
        cfg = EngineConfig(**base, **variants[name])
        rate = _run_sustained(cfg, chain=chain, launches=launches,
                              windows=windows, verify=True,
                              batch_per_partition=partial, device=device)
        out[f"partial_b{partial}_appends_per_sec_{name}"] = round(rate, 1)
    out["control_speedup"] = round(
        out["control_ms_per_round_legacy"]
        / out["control_ms_per_round_fused"], 3)
    out["sustained_speedup_fused_packed"] = round(
        out["sustained_appends_per_sec_fused_packed"]
        / out["sustained_appends_per_sec_legacy"], 3)
    out[f"partial_b{partial}_speedup_fused_packed"] = round(
        out[f"partial_b{partial}_appends_per_sec_fused_packed"]
        / out[f"partial_b{partial}_appends_per_sec_legacy"], 3)
    return out


def _run_latency(cfg, submitters: int = 16, per_thread: int = 250,
                 device=None) -> dict[str, float]:
    """Submit→ack latency percentiles (ms) through the DataPlane batcher
    under concurrent single-message producers."""
    import threading

    from ripplemq_tpu_torch.broker.dataplane import DataPlane

    dp = DataPlane(cfg, mode="local", device=_device(device))
    lats: list[float] = []
    errors: list = []

    def worker(tid: int) -> None:
        try:
            rng = np.random.default_rng(tid)
            slots = rng.integers(0, cfg.partitions, size=per_thread)
            for slot in slots:
                t0 = time.perf_counter()
                dp.submit_append(int(slot), [PAYLOAD]).result(timeout=60)
                lats.append(time.perf_counter() - t0)
        except Exception as e:  # a dead thread must fail the run,
            errors.append((tid, repr(e)))  # not skew the percentiles

    dp.start()
    try:
        for p in range(cfg.partitions):
            dp.set_leader(p, 0, 1)
        # Warm every shape the measured run can hit (single and chained
        # rounds at active-set buckets 8 and 32), as brokers do at boot.
        dp.warm(buckets=(8, 32))
        dp.submit_append(0, [PAYLOAD]).result(timeout=120)  # host path warm
        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True,
                             name=f"bench-latency-{i}")
            for i in range(submitters)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, f"latency submitters failed: {errors}"
        assert len(lats) == submitters * per_thread
        a = np.asarray(lats) * 1e3
        return {
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "p999": float(np.percentile(a, 99.9)),
        }
    finally:
        dp.stop()


def _run_consume(cfg, consumers: int = 16, rows_per_part: int = 96,
                 read_q: int = 32, device=None) -> float:
    """Sustained consume throughput (messages/sec): `consumers` threads
    drain every partition through DataPlane.read (the host mirror), every
    produced message counted back exactly."""
    import threading

    from ripplemq_tpu_torch.broker.dataplane import DataPlane

    dp = DataPlane(cfg, mode="local", read_q=read_q, device=_device(device))
    drained = [0] * consumers
    per = cfg.partitions // consumers

    def worker(tid: int) -> None:
        for p in range(tid * per, (tid + 1) * per):
            offset = 0
            while True:
                msgs, nxt = dp.read(p, offset, replica=0)
                drained[tid] += len(msgs)
                if nxt - offset < cfg.read_batch:
                    break  # caught up to commit: no empty tail poll
                offset = nxt

    dp.start()
    try:
        for p in range(cfg.partitions):
            dp.set_leader(p, 0, 1)
        batches = rows_per_part // cfg.max_batch
        futs = [
            dp.submit_append(p, [PAYLOAD] * cfg.max_batch)
            for p in range(cfg.partitions)
            for _ in range(batches)
        ]
        for f in futs:
            f.result(timeout=600)
        total = cfg.partitions * batches * cfg.max_batch
        threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                    name=f"bench-consume-{i}")
                   for i in range(consumers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        assert sum(drained) == total, (sum(drained), total)
        return total / dt
    finally:
        dp.stop()


def _run_curve(cfg, points=None, submitters: int = 16,
               per_thread: int = 120, device=None) -> list[dict]:
    """Latency/throughput operating curve: the concurrent-producer
    workload at several (coalesce_s, chain_depth) operating points, two
    of them with `window` submits in flight per producer concentrated on
    `parts` partitions, so that backlogs pass max_batch and the drain
    chains rounds."""
    import threading

    from ripplemq_tpu_torch.broker.dataplane import DataPlane

    dev = _device(device)

    def worker(tid: int, dp, window: int, parts: int, lats: list,
               errors: list) -> None:
        try:
            from collections import deque

            rng = np.random.default_rng(tid)
            slots = rng.integers(0, parts, size=per_thread)
            pending: deque = deque()
            for slot in slots:
                while len(pending) >= window:
                    fut, ts = pending.popleft()
                    fut.result(timeout=60)
                    lats.append(time.perf_counter() - ts)
                pending.append((
                    dp.submit_append(int(slot), [PAYLOAD]),
                    time.perf_counter(),
                ))
            while pending:
                fut, ts = pending.popleft()
                fut.result(timeout=60)
                lats.append(time.perf_counter() - ts)
        except Exception as e:  # a dead thread must fail the
            errors.append((tid, repr(e)))  # point, not skew it

    points = points or [
        {"coalesce_s": 0.0, "chain_depth": 1},
        {"coalesce_s": 0.002, "chain_depth": 4},   # shipped defaults
        {"coalesce_s": 0.005, "chain_depth": 8},
        {"coalesce_s": 0.02, "chain_depth": 8},
        {"coalesce_s": 0.002, "chain_depth": 4, "window": 32, "parts": 4},
        {"coalesce_s": 0.005, "chain_depth": 8, "window": 64, "parts": 4},
    ]
    curve = []
    for pt in points:
        window = pt.get("window", 1)
        parts = pt.get("parts", cfg.partitions)
        dp = DataPlane(cfg, mode="local", coalesce_s=pt["coalesce_s"],
                       chain_depth=pt["chain_depth"], device=dev)
        dp.start()
        try:
            for p in range(cfg.partitions):
                dp.set_leader(p, 0, 1)
            dp.warm(buckets=(8, 32))
            dp.submit_append(0, [PAYLOAD]).result(timeout=120)
            lats: list[float] = []
            errors: list = []
            threads = [
                threading.Thread(target=worker,
                                 args=(i, dp, window, parts, lats, errors),
                                 daemon=True, name=f"bench-curve-{i}")
                for i in range(submitters)
            ]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            dt = time.perf_counter() - t0
            assert not errors, f"curve submitters failed: {errors}"
            assert len(lats) == submitters * per_thread
            a = np.asarray(lats) * 1e3
            curve.append({
                **pt,
                "offered_producers": submitters,
                "appends_per_sec": round(len(lats) / dt, 1),
                "p50_ack_ms": round(float(np.percentile(a, 50)), 3),
                "p99_ack_ms": round(float(np.percentile(a, 99)), 3),
                "rounds_per_dispatch": round(
                    dp.rounds / max(1, dp.dispatches), 2),
            })
        finally:
            dp.stop()
    return curve


# The parity A/B's shape: the headline round at R 1 (the reference's
# `_run_spmd_parity` engine).
PARITY_SHAPE = dict(
    partitions=1024, replicas=1, slots=12352, slot_bytes=128,
    max_batch=256, read_batch=32, max_consumers=64, max_offset_updates=8,
)


def _run_spmd_parity(chain: int = 8, launches: int = 240,
                     shape: dict | None = None, device=None) -> dict:
    """Dispatch parity: the spmd binding (`make_spmd_fns` on a 1 x 1 mesh,
    a world of one) vs the local binding on the SAME device, at the
    headline round shape with R 1 (`PARITY_SHAPE`, or `shape` over it),
    measured with the sustained method. The spmd arm runs fused control;
    the legacy-control spmd binding is the recorded A/B arm. The three
    bindings alternate over 4 trials and each keeps its best window
    (additive noise only slows a trial down).

    Every binding's inputs, mask, quorum and trims are staged on the
    device before the timed windows (a numpy argument would be a host
    copy a launch). A world this runner formed itself is left before it
    returns (`mesh.shutdown()`), so no process group outlives it; one the
    caller had joined is kept."""
    import dataclasses

    import torch.distributed as dist

    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.parallel import mesh as _mesh
    from ripplemq_tpu_torch.parallel.engine import make_spmd_fns

    dev = _device(device)
    cfg = EngineConfig(**{**PARITY_SHAPE, **(shape or {})})
    cfg_fused = dataclasses.replace(cfg, fused_control=True)
    B = cfg.max_batch
    fns_local, alive, quorum, build, put = _make(cfg, dev)
    one = build(cfg, appends={p: [PAYLOAD] * B
                              for p in range(cfg.partitions)},
                leader=0, term=1)
    adv = chain * B
    formed = not dist.is_initialized()
    try:
        mesh = _mesh.make_mesh(1, 1, device=dev)
        bindings = {
            "local": fns_local,
            "spmd": make_spmd_fns(cfg_fused, mesh),
            "spmd_legacy": make_spmd_fns(cfg, mesh),
        }
        staged = {}
        for name, fns in bindings.items():
            staged[name] = (_stack(one, chain, put), alive.clone(),
                            quorum.clone(),
                            _stage_trims(cfg, adv, launches, put))
            _sustained_warmup(fns, *staged[name])
        best = {name: 0.0 for name in bindings}
        for _ in range(4):
            for name, fns in bindings.items():
                rate, state = _sustained_window(
                    fns, *staged[name], launches * adv * cfg.partitions)
                best[name] = max(best[name], rate)
                del state
    finally:
        if formed:
            _mesh.shutdown()
    # Signed: positive = the spmd binding is FASTER than the local one.
    delta = (best["spmd"] - best["local"]) / best["local"]
    fused_delta = (best["spmd"] - best["spmd_legacy"]) / best["spmd_legacy"]
    return {
        "local_appends_per_sec": round(best["local"], 1),
        "spmd_appends_per_sec": round(best["spmd"], 1),
        "spmd_binding": "fused_control",
        "spmd_legacy_appends_per_sec": round(best["spmd_legacy"], 1),
        "fused_vs_legacy_spmd_delta_pct": round(100 * fused_delta, 2),
        "delta_pct": round(100 * delta, 2),
    }


def _run_spmd_scaling(device_counts: tuple[int, ...] = (1, 2, 4, 8),
                      chain: int = 8, launches: int = 24, windows: int = 2,
                      device=None, timeout_s: float = 600.0) -> dict:
    """Per-rank-count scaling curve of the fused spmd binding: sustained
    committed appends/s with partitions sharded over the "part" axis of a
    1 x n mesh, at each n of `device_counts`. Each count is one world of n
    processes (`python -m ripplemq_tpu_torch.profiles.spmd_scaling
    --inner n --rank r`), every rank on `device` (CUDA: the one card,
    where two ranks share a GPU and the world runs gloo), each running the
    same sustained loop; rank 0 verifies the ring tail and reports
    (`profiles/spmd_scaling.py` `run_inner`).

    The ranks share one card's silicon and one host, so the curve prices
    what sharding costs (a gathered output a round, dispatch per rank),
    not what added GPUs buy. A world that outlives `timeout_s`, or in
    which any rank fails, is killed whole and the phase raises."""
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    dev = _device(device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.setdefault("OMP_NUM_THREADS", "1")  # n ranks share the host's cores
    points = []
    for n in device_counts:
        tmp = tempfile.mkdtemp(prefix=f"spmd-scaling-{n}-")
        procs, logs = [], []
        try:
            for rank in range(n):
                logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "ripplemq_tpu_torch.profiles.spmd_scaling",
                     "--inner", str(n), "--rank", str(rank),
                     "--store", os.path.join(tmp, "store"),
                     "--chain", str(chain), "--launches", str(launches),
                     "--windows", str(windows), "--device", dev.type],
                    env=env, cwd=root, stdout=logs[-1],
                    stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            rcs = [p.poll() for p in procs]
            if any(rc != 0 for rc in rcs):
                tails = []
                for rank, f in enumerate(logs):
                    f.seek(0)
                    tails.append(f"rank {rank} rc {rcs[rank]}: "
                                 f"{f.read()[-1500:]}")
                raise RuntimeError(
                    f"spmd_scaling ranks={n} failed or outlived "
                    f"{timeout_s} s: " + "\n".join(tails))
            logs[0].seek(0)
            line = [ln for ln in logs[0].read().splitlines()
                    if ln.startswith("{")][-1]
            points.append(json.loads(line))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            for f in logs:
                f.close()
            shutil.rmtree(tmp, ignore_errors=True)
    base = points[0]["appends_per_sec"]
    where = ("the one card" if dev.type == "cuda" else f"the {dev.type}")
    return {
        "config": (f"P={points[0]['partitions']} R=1 "
                   f"B={points[0]['max_batch']} chain={chain} sustained "
                   f"fused-spmd, partitions sharded over 'part'"),
        "method": (f"one world of n processes per count, gloo ranks "
                   f"sharing {where} (a world of one: no collective); "
                   f"prices sharding overhead, not added silicon"),
        "points": points,
        "vs_1dev": {
            str(p["devices"]): round(p["appends_per_sec"] / base, 3)
            for p in points
        },
    }


def e2e_raw_config(ports: list[int], partitions: int = 1024,
                   host_workers: int = 1) -> dict:
    """The e2e topology's cluster config: the port's one copy of the
    reference bench's (`bench.py` `e2e_raw_config`), shared with
    `profiles/host_edge.py` and `chip_smoke.py`'s broker paths (a copied
    dict drifts). `host_workers` > 1 boots the multi-core host plane
    (parallel/hostplane.py) on every broker."""
    return {
        "host_workers": host_workers,
        "brokers": [{"id": i, "host": "127.0.0.1", "port": p}
                    for i, p in enumerate(ports)],
        "topics": [{"name": "bench", "partitions": partitions,
                    "replication_factor": 3}],
        # Engine sized to the system it measures: R=3 replica slots (3
        # brokers, topic RF 3) and a ring deep enough that trim rides
        # behind the store. read_batch 1024: the consume phase drains
        # through the host mirror, which serves up to read_batch rows
        # per call. fused_control/packed_writes and the pipelined
        # settle window are on at the operating point the bench ships.
        "engine": {
            "partitions": partitions, "replicas": 3, "slots": 4608,
            "slot_bytes": 128, "max_batch": 512, "read_batch": 1024,
            "max_consumers": 64, "max_offset_updates": 8,
            "fused_control": True, "packed_writes": True,
            "settle_window": 8,
        },
        "election_timeout_s": 0.5,
        # Generous liveness horizon: a starved heartbeat thread must
        # read as load, not death (a mid-run metadata election turns a
        # throughput measurement into a failover drill).
        "metadata_election_timeout_s": 8.0,
        "membership_poll_s": 0.5,
        "rpc_timeout_s": 60.0,   # a queued append must outlive a backlog
        # The pool must cover the full offered concurrency: in-flight
        # produce batches plus the drain's pipelined commits.
        "rpc_workers": 320,
        # Throughput operating point: gather ~coalesce_s of burst per
        # dispatch (fewer, fuller dispatches win at saturation).
        "coalesce_s": 0.03,
    }


# The stage histograms of the host-path decomposition: each produce
# ack's time, attributed live by the telemetry plane (device launch,
# launch → committed fetch, commit → settle-window entry, the standby-ack
# barrier, local persist with store append/fsync below it, the dispatch →
# ack-release round trip), plus the batching factors.
_DECOMPOSITION_STAGES = (
    "engine.dispatch_us",
    "settle.commit_wait_us",
    "settle.enter_wait_us",
    "settle.standby_ack_us",
    "settle.persist_us",
    "settle.release_us",
    "store.append_us",
    "store.fsync_us",
    "repl.frame_us",
    "repl.group_rounds",
    "engine.chain_rounds",
)


def _proc_cpu_s(pid: int) -> float:
    """utime+stime of one live process from /proc/<pid>/stat, seconds
    (Linux; 0.0 anywhere it can't be read)."""
    try:
        import os

        with open(f"/proc/{pid}/stat", "rb") as f:
            fields = f.read().rsplit(b") ", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except Exception:
        return 0.0


def _latency_decomposition(metrics_snapshot: dict) -> dict:
    """The per-stage summaries (count/mean/p50/p90/p99/max) pulled out of
    an admin.metrics snapshot."""
    hists = metrics_snapshot.get("histograms", {})
    return {k: hists[k] for k in _DECOMPOSITION_STAGES if k in hists}


# Shared objects whose mapping in a client process means it loaded torch.
_TORCH_LIBS = ("libtorch", "libc10")


def _mapped_torch_libs(pid: int) -> list[str]:
    """The torch shared objects mapped into process `pid`, read from
    outside it (/proc/<pid>/maps; [] where that cannot be read)."""
    import os

    try:
        with open(f"/proc/{pid}/maps") as f:
            paths = {line.split()[-1] for line in f if "/" in line}
    except OSError:
        return []
    return sorted(p for p in paths
                  if any(lib in os.path.basename(p) for lib in _TORCH_LIBS))


def _e2e_client_main(spec_path: str) -> None:
    """CLIENT-SUBPROCESS entry (`python -m ripplemq_tpu_torch.bench
    _e2e_client spec.json`): the e2e producer/consumer load generator,
    outside the controller's process so that client interpreter CPU is
    not billed to the broker's GIL. One process runs `threads` windowed
    producer threads (and as many drainers); the parent drives phases
    over a stdin/stdout line protocol (PRODUCE / DRAIN <phase> / EXIT →
    RESULT <json>), so boot and import cost land outside every timed
    window and producer sequences persist across phases. Its import
    chain (the port's clients) is torch-free."""
    import sys
    import threading
    from collections import deque

    from ripplemq_tpu_torch.client.consumer import ConsumerClient
    from ripplemq_tpu_torch.client.producer import ProducerClient

    with open(spec_path) as f:
        spec = json.load(f)
    bootstrap = spec["bootstrap"]
    threads = int(spec["threads"])
    batch = int(spec["batch"])
    window = int(spec["window"])
    duration_s = float(spec["duration_s"])
    partitions = int(spec["partitions"])
    read_batch = int(spec["read_batch"])
    proc_id = int(spec["proc_id"])
    nprocs = int(spec["nprocs"])
    total_threads = nprocs * threads

    pc = ProducerClient(bootstrap, rpc_timeout_s=120.0)
    seqs = [0] * threads

    def producer(tid: int, stop_at: float, counts: dict,
                 errors: list) -> None:
        acked = nbytes = 0
        seq = seqs[tid]
        gtid = proc_id * threads + tid  # global payload namespace
        pending: deque = deque()

        def land(w, n, nb):
            nonlocal acked, nbytes
            w()
            acked += n
            nbytes += nb

        try:
            while time.monotonic() < stop_at:
                while len(pending) >= window:
                    land(*pending.popleft())
                payloads = []
                for _ in range(batch):
                    head = b"e2e-%d-%08d|" % (gtid, seq)
                    seq += 1
                    payloads.append(head.ljust(100, b"x"))
                nb = sum(map(len, payloads))
                w = pc.produce_batch_async("bench", payloads)
                pending.append((w, batch, nb))
            while pending:
                land(*pending.popleft())
        except Exception as e:  # a dead thread must FAIL the
            errors.append((tid, repr(e)))  # bench, not deflate it
            return
        seqs[tid] = seq
        counts[tid] = (acked, nbytes)

    def produce_phase() -> dict:
        counts: dict = {}
        errors: list = []
        t0 = time.monotonic()
        stop_at = t0 + duration_s
        workers = [
            threading.Thread(target=producer,
                             args=(i, stop_at, counts, errors),
                             daemon=True, name=f"bench-e2e-producer-{i}")
            for i in range(threads)
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        secs = time.monotonic() - t0
        if errors:
            raise AssertionError(f"producer threads failed: {errors}")
        assert len(counts) == threads
        return {"acked": sum(v[0] for v in counts.values()),
                "nbytes": sum(v[1] for v in counts.values()),
                "secs": secs}

    def drainer(tid: int, phase: int, got: dict, cerrors: list) -> None:
        gtid = proc_id * threads + tid
        drained = dbytes = warmups = 0
        cc = ConsumerClient(bootstrap, f"e2e-drain-{phase}-{gtid}",
                            max_messages=read_batch,
                            rpc_timeout_s=60.0, prefetch=1)
        try:
            for p in range(gtid, partitions, total_threads):
                while True:
                    msgs, _, _, _ = cc.consume_with_position(
                        "bench", partition=p)
                    if not msgs:
                        break  # commit-bounded: caught up
                    drained += len(msgs)
                    dbytes += sum(map(len, msgs))
                    warmups += sum(m.startswith(b"e2e-warmup") for m in msgs)
            got[tid] = (drained, dbytes, warmups)
        except Exception as e:  # a dead drainer FAILS the bench
            cerrors.append((tid, repr(e)))
        finally:
            cc.close()

    def drain_phase(phase: int) -> dict:
        got: dict = {}
        cerrors: list = []
        drainers = [
            threading.Thread(target=drainer, args=(i, phase, got, cerrors),
                             daemon=True, name=f"bench-e2e-drainer-{i}")
            for i in range(threads)
        ]
        ct0 = time.monotonic()
        for d in drainers:
            d.start()
        for d in drainers:
            d.join()
        csecs = time.monotonic() - ct0
        if cerrors:
            raise AssertionError(f"consumer threads failed: {cerrors}")
        return {"drained": sum(v[0] for v in got.values()),
                "dbytes": sum(v[1] for v in got.values()),
                "warmups": sum(v[2] for v in got.values()), "secs": csecs}

    print("READY", flush=True)
    try:
        for line in sys.stdin:
            cmd = line.split()
            if not cmd:
                continue
            if cmd[0] == "PRODUCE":
                res = produce_phase()
            elif cmd[0] == "DRAIN":
                res = drain_phase(int(cmd[1]))
            elif cmd[0] == "EXIT":
                break
            else:
                raise AssertionError(f"unknown command {cmd!r}")
            print("RESULT " + json.dumps(res), flush=True)
    except Exception as e:
        print("ERROR " + repr(e), flush=True)
        raise
    finally:
        pc.close()


def _run_e2e(duration_s: float = 12.0, n_brokers: int = 3,
             threads: int = 8, batch: int = 512, window: int = 16,
             phases: int = 2, obs: bool = True, host_workers: int = 1,
             client_procs: int = 2, device=None,
             partitions: int = 1024) -> dict:
    """END-TO-END produce and consume throughput: fresh, distinct
    payloads from producer clients through TCP sockets, broker dispatch,
    the DataPlane batcher, device quorum rounds, the round store and the
    standby replication stream; then consumer clients draining the whole
    topic over TCP, count-exact against the acks.

    Topology: `e2e_raw_config` (3 brokers on loopback TCP, topic "bench"
    of `partitions` partitions at RF 3): the controller's BrokerServer in
    this process on `device`, each standby a `python -m
    ripplemq_tpu_torch.broker` process, the clients in `client_procs`
    processes (`_e2e_client_main`), `threads` windowed producers keeping
    `window` batches in flight each. Best-of-`phases` produce windows,
    each followed by a full drain."""
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports
    from ripplemq_tpu_torch.metadata.cluster_config import parse_cluster_config

    dev = _device(device)
    # The subprocesses import this package from the checkout holding it.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ports = free_ports(n_brokers)
    raw = e2e_raw_config(ports, partitions, host_workers=host_workers)
    raw["obs"] = obs  # telemetry A/B knob
    tmp = tempfile.mkdtemp(prefix="rmq-e2e-")
    config = parse_cluster_config(raw)
    brokers = []
    procs: list = []
    try:
        # The controller runs in this process (the bench reads its engine
        # counters and warms its plane); the standbys run as broker
        # processes through the CLI entry, as deployed.
        controller = BrokerServer(0, config, net=None,
                                  data_dir=os.path.join(tmp, "d0"),
                                  device=dev)
        controller.start()
        brokers.append(controller)
        # The broker CLI reads YAML, of which JSON is a subset.
        cfg_path = os.path.join(tmp, "cluster.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        for i in range(1, n_brokers):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ripplemq_tpu_torch.broker",
                 "--id", str(i), "--config", cfg_path,
                 "--data-dir", tmp, "--log-level", "WARNING",
                 "--device", str(dev.type)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                cwd=root,
            ))

        from ripplemq_tpu_torch.client.consumer import ConsumerClient
        from ripplemq_tpu_torch.client.metadata import MetadataManager
        from ripplemq_tpu_torch.client.producer import ProducerClient
        from ripplemq_tpu_torch.wire.transport import TcpClient

        bootstrap = [f"127.0.0.1:{p}" for p in ports]
        transport = TcpClient()
        meta = MetadataManager(transport, bootstrap,
                               refresh_interval_s=3600, rpc_timeout_s=5.0)
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            try:
                meta.refresh()
                t = meta.topic("bench")
                if (t is not None and t.assignments
                        and all(a.leader is not None
                                for a in t.assignments)):
                    break
            except Exception:
                pass
            time.sleep(0.5)
        else:
            raise AssertionError("e2e cluster never elected all leaders")
        meta.close()
        transport.close()

        # Warm every active-set bucket, then wait out the boot-time
        # background warm too, before any clock starts.
        controller.dataplane.warm(
            buckets=controller.dataplane.all_buckets()
        )
        wt = getattr(controller, "_warm_thread", None)
        if wt is not None:
            wt.join(timeout=600)
        pc = ProducerClient(bootstrap, rpc_timeout_s=120.0)
        pc.produce_batch("bench", [b"e2e-warmup"] * 8)
        pc.close()
        dp = controller.dataplane
        standby_procs = list(procs)
        cpu_self0 = _proc_cpu_s(os.getpid())

        # The load generator runs in `client_procs` processes of their
        # own (a torch-free import chain), driven over a line protocol.
        tpp = max(1, threads // max(1, client_procs))
        clients = []
        for i in range(client_procs):
            spec = {
                "bootstrap": bootstrap, "proc_id": i,
                "nprocs": client_procs, "threads": tpp,
                "batch": batch, "window": window,
                "duration_s": duration_s, "partitions": partitions,
                "read_batch": raw["engine"]["read_batch"],
            }
            spec_path = os.path.join(tmp, f"client{i}.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            c = subprocess.Popen(
                [sys.executable, "-m", "ripplemq_tpu_torch.bench",
                 "_e2e_client", spec_path],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True, bufsize=1, cwd=root,
            )
            clients.append(c)
            procs.append(c)  # the teardown path covers a failed run

        def _expect(c, tag: str) -> str:
            line = (c.stdout.readline() or "").strip()
            assert line.startswith(tag), (
                f"e2e client answered {line!r}, wanted {tag}"
            )
            return line[len(tag):].strip()

        for c in clients:
            _expect(c, "READY")

        def client_phase(cmd: str) -> list[dict]:
            for c in clients:
                c.stdin.write(cmd + "\n")
                c.stdin.flush()
            return [json.loads(_expect(c, "RESULT ")) for c in clients]

        # Best-of-N phases: produce window then full drain, repeated.
        # Sequences continue across phases and every drain re-reads the
        # FULL topic under fresh consumer ids, so phase k's drain must
        # equal the cumulative ack count.
        acked_total = 0
        nbytes_total = 0
        best_produce = (0.0, 0.0)  # (appends/s, MB/s)
        best_consume = (0.0, 0.0)
        consume_secs = 0.0
        consumed_final = 0
        produce_secs = 0.0

        for phase in range(max(1, phases)):
            outs = client_phase("PRODUCE")
            acked = sum(o["acked"] for o in outs)
            nbytes = sum(o["nbytes"] for o in outs)
            secs = max(o["secs"] for o in outs)
            assert acked > 0
            acked_total += acked
            nbytes_total += nbytes
            produce_secs += secs
            best_produce = max(best_produce,
                               (acked / secs, nbytes / secs / 1e6))
            # The controller's committed-entry count must cover every ack.
            assert dp is not None and dp.committed_entries >= acked_total
            douts = client_phase(f"DRAIN {phase}")
            consumed = sum(o["drained"] for o in douts)
            cbytes = sum(o["dbytes"] for o in douts)
            nwarm = sum(o["warmups"] for o in douts)
            csecs = max(o["secs"] for o in douts)
            consume_secs += csecs
            consumed_final = consumed
            # Every acked append comes back exactly once (the warmup
            # batch may be retried, so it is counted apart).
            assert consumed - nwarm == acked_total, (consumed, acked_total)
            best_consume = max(best_consume,
                               (consumed / csecs, cbytes / csecs / 1e6))

        # The clients' import chain stays torch-free: read from outside,
        # while they are alive.
        for c in clients:
            libs = _mapped_torch_libs(c.pid)
            assert not libs, f"e2e client {c.pid} loaded torch: {libs}"

        # Per-process CPU decomposition, collected while every process
        # is alive (the controller minus its pre-run baseline).
        def _child_pids(ppid: int) -> list[int]:
            import glob

            out = []
            for st in glob.glob("/proc/[0-9]*/stat"):
                try:
                    with open(st, "rb") as f:
                        rest = f.read().rsplit(b") ", 1)[1].split()
                    if int(rest[1]) == ppid:
                        out.append(int(st.split("/")[2]))
                except Exception:
                    continue
            return out

        hp = controller.hostplane
        cpu_decomp = {
            "controller_s": round(_proc_cpu_s(os.getpid()) - cpu_self0, 1),
            "controller_workers_s": round(sum(
                _proc_cpu_s(p) for p in (hp.worker_pids() if hp else [])
            ), 1),
            "standbys_s": round(sum(
                _proc_cpu_s(p.pid) + sum(_proc_cpu_s(c)
                                         for c in _child_pids(p.pid))
                for p in standby_procs
            ), 1),
            "clients_s": round(sum(_proc_cpu_s(c.pid) for c in clients), 1),
        }

        for c in clients:
            c.stdin.write("EXIT\n")
            c.stdin.flush()
        for c in clients:
            c.wait(timeout=30)

        # Readback: consume a window back through the client SDK and
        # check the load generator's payload structure, byte-exact.
        cc = ConsumerClient(bootstrap, "e2e-verify", rpc_timeout_s=60.0)
        checked = 0
        for _ in range(40):
            for m in cc.consume("bench"):
                if m.startswith(b"e2e-warmup"):
                    continue
                head, _, pad = m.partition(b"|")
                tag, tid, seq = head.split(b"-")
                assert tag == b"e2e" and tid.isdigit() and seq.isdigit(), m[:24]
                assert pad == b"x" * len(pad) and len(m) == 100, m[:24]
                checked += 1
            if checked >= 256:
                break
        assert checked >= 256, f"only {checked} messages read back"
        cc.close()

        settle = dp.settle_stats()
        from ripplemq_tpu_torch.wire import codec as _codec

        metrics_snap = controller.metrics.snapshot()
        return {
            "e2e_obs": obs,
            "latency_decomposition": _latency_decomposition(metrics_snap),
            "admin_metrics": {
                "metrics": metrics_snap,
                "wire": _codec.codec_stats(),
            },
            "e2e_appends_per_sec": round(best_produce[0], 1),
            "e2e_mb_per_sec": round(best_produce[1], 2),
            "e2e_acked": acked_total,
            "e2e_offered_batches": client_procs * tpp * window,
            "e2e_client_procs": client_procs,
            "e2e_host_workers": host_workers,
            "e2e_cpu_decomposition": cpu_decomp,
            "e2e_phases": max(1, phases),
            "e2e_seconds": round(produce_secs, 1),
            "e2e_readback": "verified",
            "e2e_consume_msgs_per_sec": round(best_consume[0], 1),
            "e2e_consume_mb_per_sec": round(best_consume[1], 2),
            "e2e_consumed": consumed_final,
            "e2e_consume_seconds": round(consume_secs, 1),
            "e2e_consume_verified": "count-exact",
            "settle_pipeline": settle,
        }
    finally:
        for b in brokers:
            b.stop()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _run_host_plane_scaling(worker_counts: tuple[int, ...] = (1, 2, 4),
                            duration_s: float = 6.0, phases: int = 2,
                            device=None, **e2e_kw) -> dict:
    """Same-host worker-count sweep of the multi-core host plane: each arm
    runs the whole e2e topology (`_run_e2e`: standby broker processes,
    client processes, TCP) with `host_workers` worker processes a broker,
    the same best-of-`phases` method and count-exact readback, in one run
    so the arms share their noise floor. `scaling_x` = best / workers-1;
    `host_cores` is the parallelism the host offers. `e2e_kw` passes
    further `_run_e2e` arguments (a smaller topology in tests)."""
    import os

    dev = _device(device)
    arms = []
    for w in worker_counts:
        r = _run_e2e(duration_s=duration_s, phases=phases, host_workers=w,
                     device=dev, **e2e_kw)
        arms.append({
            "host_workers": w,
            "appends_per_sec": r["e2e_appends_per_sec"],
            "consume_msgs_per_sec": r["e2e_consume_msgs_per_sec"],
            "acked": r["e2e_acked"],
            "readback": r["e2e_consume_verified"],
            "cpu_decomposition": r["e2e_cpu_decomposition"],
        })
    base = arms[0]["appends_per_sec"]
    best = max(arms, key=lambda a: a["appends_per_sec"])
    return {
        "arms": arms,
        "baseline_appends_per_sec": base,
        "best_workers": best["host_workers"],
        "best_appends_per_sec": best["appends_per_sec"],
        "scaling_x": round(best["appends_per_sec"] / base, 2),
        "host_cores": os.cpu_count(),
    }


def _run_group_consume(n_groups: int = 3, members: int = 2,
                       partitions: int = 4, n_msgs: int = 600,
                       device=None) -> dict:
    """Multi-group drain: `n_groups` consumer groups of `members`
    GroupConsumer members each drain the same produced topic through the
    group coordinator's shared offsets, on an in-proc cluster whose
    brokers run on `device`. COUNT-EXACT per group: a group ending with
    anything but exactly `n_msgs` delivered fails the phase.

    Unlike the reference, no generation change may overtake a commit: a
    commit that one overtakes lands and is answered `fenced_generation`
    (the server's documented at-most-once boundary), so the member drops
    its batch for good and the reference's drain stalls one batch short
    of count-exact (3 of 12 reference runs on a CPU host, 2 of 12 of the
    port's before these guards). So every member joins, then waits until
    every broker's replicated view holds its whole group at one
    generation (`_settle_group`), before any member polls; and sessions
    last 30 s, as in the storm, so that a loaded host's late heartbeat
    relay cannot evict a member mid-drain. The gate then measures the
    shared-offset path."""
    import threading

    from ripplemq_tpu_torch.chaos.cluster import (
        InProcCluster,
        make_cluster_config,
    )
    from ripplemq_tpu_torch.client import GroupConsumer, ProducerClient
    from ripplemq_tpu_torch.metadata.models import Topic

    dev = _device(device)
    counts = {g: 0 for g in range(n_groups)}
    lock = threading.Lock()
    stop = threading.Event()
    joined = threading.Barrier(n_groups * members)

    def member(gi: int, mi: int) -> None:
        gc = GroupConsumer(
            bootstrap, f"bg{gi}", topics=["gbench"], member_id=f"m{mi}",
            transport=cluster.client(f"gbench-{gi}-{mi}"),
            heartbeat_s=0.5, rpc_timeout_s=10.0)
        try:
            gc.join()
            joined.wait(timeout=60)  # every member in: no later rebalance
            _settle_group(cluster, bootstrap, f"bg{gi}", f"m{mi}",
                          [f"m{m}" for m in range(members)])
            gc.heartbeat(force=True)
            while not stop.is_set():
                _, msgs = gc.poll(max_messages=64)
                if msgs:
                    with lock:
                        counts[gi] += len(msgs)
                with lock:
                    if counts[gi] >= n_msgs:
                        return
        finally:
            gc.close()

    config = make_cluster_config(
        3, topics=(Topic("gbench", partitions, 3),), engine=None,
        group_session_timeout_s=30.0)
    with InProcCluster(config, device=dev) as cluster:
        cluster.wait_for_leaders()
        bootstrap = [b.address for b in config.brokers]
        producer = ProducerClient(
            bootstrap, transport=cluster.client("gbench-p"),
            rpc_timeout_s=10.0)
        per_part = n_msgs // partitions
        n_msgs = per_part * partitions
        B = config.engine.max_batch
        for pid in range(partitions):
            payloads = [b"g-%d-%06d" % (pid, i) for i in range(per_part)]
            for i in range(0, per_part, B):
                producer.produce_batch("gbench", payloads[i:i + B],
                                       partition=pid)
        producer.close()

        threads = [threading.Thread(target=member, args=(gi, mi),
                                    daemon=True,
                                    name=f"bench-group-{gi}-{mi}")
                   for gi in range(n_groups) for mi in range(members)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.time() + 120
        while time.time() < deadline:
            with lock:
                if all(v >= n_msgs for v in counts.values()):
                    break
            time.sleep(0.05)
        elapsed = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=10)
        exact = all(v == n_msgs for v in counts.values())
        if not exact:
            raise AssertionError(
                f"group drain not count-exact: wanted {n_msgs}/group, "
                f"got {counts} (duplicates or loss across the shared-"
                f"offset path)")
        total = sum(counts.values())
        return {
            "e2e_group_consume_msgs_per_sec": round(total / elapsed, 1),
            "group_consume": {
                "groups": n_groups, "members_per_group": members,
                "partitions": partitions, "msgs_per_group": n_msgs,
                "elapsed_s": round(elapsed, 3), "count_exact": exact,
            },
        }


def _settle_group(cluster, bootstrap: list[str], group: str, member: str,
                  members: list[str], timeout_s: float = 30.0) -> None:
    """Wait until every broker's replicated view of `group` holds exactly
    `members` at one generation (a `group.heartbeat` answered locally by
    each broker): from then on no commit of the group can meet a
    generation that changes between its fence check and its re-check."""
    probe = cluster.client(f"settle-{group}-{member}")
    req = {"type": "group.heartbeat", "group": group, "member": member}
    deadline = time.monotonic() + timeout_s
    views: list = []
    while time.monotonic() < deadline:
        views = [probe.call(addr, req, timeout=10.0) for addr in bootstrap]
        if (all(v.get("ok") and v.get("members") == sorted(members)
                for v in views)
                and len({v["generation"] for v in views}) == 1):
            return
        time.sleep(0.05)
    raise AssertionError(f"group {group} never settled on every broker: "
                         f"{views}")


def _run_control_plane_storm(
    shapes: tuple[tuple[int, int, int], ...] = (
        (10, 10, 4),      # 100 members, also run as the direct baseline
        (40, 10, 8),      # 400 members
        (100, 10, 16),    # 1000 members / 100 groups: the headline shape
    ),
    churn_rounds: int = 2,
    churn_frac: float = 0.2,
    beat_window_s: float = 1.5,
    device=None,
) -> dict:
    """Control-plane volume sweep: group count x churn x tenant count,
    driving the membership RPC surface of a 3-broker in-proc cluster
    (brokers on `device`; no payload moves), one arm a shape
    (`_storm_arm`). Read from the brokers' admin.stats `control_plane`
    blocks (`_cp_stats`): raft proposals per membership event (waves; the
    direct arm at `meta_batch_s` 0, on the first shape, is 1 a event by
    construction), leader heartbeat RPCs/s before (the member beats) and
    after (the relayed `group.beats` frames), and the convergence p50/p99
    of a membership RPC."""
    dev = _device(device)
    kw = dict(churn_rounds=churn_rounds, churn_frac=churn_frac,
              beat_window_s=beat_window_s, device=dev)
    out: dict = {"shapes": []}
    g0, m0, t0_ = shapes[0]
    out["direct_baseline"] = _storm_arm(g0, m0, t0_, meta_batch_s=0.0, **kw)
    for groups, members, tenants in shapes:
        out["shapes"].append(_storm_arm(groups, members, tenants,
                                        meta_batch_s=0.05, **kw))
    out["headline"] = out["shapes"][-1]
    return {"control_plane_storm": out}


def _storm_arm(groups: int, members: int, tenants: int,
               meta_batch_s: float, churn_rounds: int, churn_frac: float,
               beat_window_s: float, device) -> dict:
    """One shape of the storm (the reference's `one_arm`): `groups x
    members` group.join and `tenants` producer.register RPCs through a
    pool of up to 128 workers, then `churn_rounds` rounds of leave+rejoin
    over `churn_frac` of the members (sampled by `random.Random(1234)`,
    the reference's stream), then a `beat_window_s` heartbeat window with
    every member beating."""
    import queue
    import random
    import threading

    from ripplemq_tpu_torch.chaos.cluster import (
        InProcCluster,
        make_cluster_config,
    )
    from ripplemq_tpu_torch.metadata.models import Topic

    n_workers = min(128, groups * members)
    roster = [(gi, mi) for gi in range(groups) for mi in range(members)]
    lat_ms: list[float] = []
    lat_lock = threading.Lock()
    work: queue.Queue = queue.Queue()
    errs: list[str] = []
    stop = threading.Event()
    beat_counts = [0] * n_workers

    def worker(w: int) -> None:
        while True:
            req = work.get()
            if req is None:
                work.task_done()
                return
            t0 = time.perf_counter()
            try:
                resp = clients[w].call(addrs[w % len(addrs)], req,
                                       timeout=15.0)
                if resp.get("ok"):
                    with lat_lock:
                        lat_ms.append((time.perf_counter() - t0) * 1e3)
                else:
                    errs.append(str(resp.get("error")))
            except Exception as e:
                errs.append(f"{type(e).__name__}: {e}")
            finally:
                work.task_done()

    def beater(w: int) -> None:
        mine = roster[w::n_workers]
        while not stop.is_set():
            for gi, mi in mine:
                if stop.is_set():
                    return
                clients[w].call(
                    addrs[(w + gi) % len(addrs)],
                    {"type": "group.heartbeat", "group": f"sg{gi}",
                     "member": f"m{mi}"},
                    timeout=15.0)
                beat_counts[w] += 1

    def run_events(events: list[dict]) -> None:
        for ev in events:
            work.put(ev)
        work.join()

    config = make_cluster_config(
        3, topics=(Topic("storm", 8, 3),), engine=None, rpc_timeout_s=10.0,
        # Nobody beats during the join/churn storm: keep sessions from
        # lapsing so no eviction waves pollute the counters.
        group_session_timeout_s=30.0, meta_batch_s=meta_batch_s)
    with InProcCluster(config, device=device) as cluster:
        cluster.wait_for_leaders()
        addrs = [b.address for b in config.brokers]
        clients = [cluster.client(f"storm-w{w}") for w in range(n_workers)]
        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"bench-storm-{w}")
                   for w in range(n_workers)]
        for t in threads:
            t.start()

        # The join storm: every member and every tenant pid.
        joins = [{"type": "group.join", "group": f"sg{gi}",
                  "member": f"m{mi}", "topics": ["storm"]}
                 for gi, mi in roster]
        regs = [{"type": "producer.register", "name": f"t{k}/storm"}
                for k in range(tenants)]
        n_events = 0
        before = len(lat_ms)
        run_events(joins + regs)
        n_events += len(joins) + len(regs)

        # Churn rounds: churn_frac of the members leave and rejoin.
        rng = random.Random(1234)
        for _ in range(churn_rounds):
            sample = rng.sample(roster, max(1, int(len(roster) * churn_frac)))
            leaves = [{"type": "group.leave", "group": f"sg{gi}",
                       "member": f"m{mi}"} for gi, mi in sample]
            run_events(leaves)
            rejoins = [{"type": "group.join", "group": f"sg{gi}",
                        "member": f"m{mi}", "topics": ["storm"]}
                       for gi, mi in sample]
            run_events(rejoins)
            n_events += len(leaves) + len(rejoins)
        assert len(lat_ms) - before + len(errs) >= n_events * 0.95, (
            f"storm lost events: {len(lat_ms)} acks, errors {errs[:5]}")

        # The heartbeat window: every member beats continuously.
        hb_before = _cp_stats(cluster, addrs)
        beaters = [threading.Thread(target=beater, args=(w,), daemon=True,
                                    name=f"bench-storm-beat-{w}")
                   for w in range(n_workers)]
        t0 = time.perf_counter()
        for t in beaters:
            t.start()
        time.sleep(beat_window_s)
        stop.set()
        for t in beaters:
            t.join(timeout=10)
        # Let the last relay frames flush before reading counters.
        time.sleep(config.heartbeat_relay_s * 2 + 0.1)
        window = time.perf_counter() - t0
        stats = _cp_stats(cluster, addrs)

        for _ in threads:
            work.put(None)
        for t in threads:
            t.join(timeout=5)

        # beat_frames counts FRAMES (one a broker a relay interval: the
        # leader's RPC load); beats_relayed the member stamps.
        frames = stats["beat_frames"] - hb_before["beat_frames"]
        proposals = stats["waves"] if meta_batch_s > 0 else n_events
        return {
            "groups": groups, "members": groups * members,
            "tenants": tenants,
            "membership_events": n_events,
            "raft_proposals": proposals,
            "proposals_per_event": round(proposals / n_events, 4),
            "proposal_collapse": round(n_events / max(1, proposals), 1),
            "wave_size_hist": stats["wave_size_hist"],
            "convergence_ms_p50": round(float(np.percentile(lat_ms, 50)), 2),
            "convergence_ms_p99": round(float(np.percentile(lat_ms, 99)), 2),
            "leader_heartbeat_rpcs_per_s_before": round(
                sum(beat_counts) / window, 1),
            "leader_heartbeat_rpcs_per_s_after": round(frames / window, 1),
            "errors": len(errs),
        }


def _cp_stats(cluster, addrs: list[str]) -> dict:
    """Sum the `control_plane` admin.stats block across brokers (waves
    and events count where the proposing broker coalesced them; beat
    frames where the leader ingested them)."""
    probe = cluster.client("storm-stats")
    total = {"waves": 0, "wave_events": 0, "beats_relayed": 0,
             "beat_frames": 0, "heartbeats_local": 0,
             "wave_size_hist": {}}
    for addr in addrs:
        try:
            st = probe.call(addr, {"type": "admin.stats"}, timeout=5.0)
        except Exception:
            continue
        cp = st.get("control_plane") or {}
        for key in ("waves", "wave_events", "beats_relayed", "beat_frames",
                    "heartbeats_local"):
            total[key] += int(cp.get(key, 0))
        for k, v in (cp.get("wave_size_hist") or {}).items():
            total["wave_size_hist"][k] = (
                total["wave_size_hist"].get(k, 0) + int(v))
    return total


def _run_consume_fanout(consumer_counts: tuple[int, ...] = (4, 16),
                        partitions: int = 2, n_msgs: int = 480,
                        device=None) -> dict:
    """Fan-out consume A/B: C independent consumers each drain the SAME
    pre-produced log end to end, with follower reads OFF vs ON, over the
    consumer counts, each arm on a fresh 3-broker process cluster
    (`_fanout_arm`). COUNT-EXACT per arm; ON arms report
    `follower_served`, the deliveries the followers answered (an ON arm
    the leader quietly absorbed would otherwise read as a null A/B)."""
    import os

    dev = _device(device)
    per_part = n_msgs // partitions
    total_msgs = per_part * partitions
    arms = [_fanout_arm(c, f, partitions, per_part, dev)
            for c in consumer_counts for f in (False, True)]
    by_count = {}
    for c in consumer_counts:
        off, on = (next(a for a in arms if a["consumers"] == c
                        and a["follower_reads"] == f) for f in (False, True))
        by_count[str(c)] = round(on["msgs_per_sec"] / off["msgs_per_sec"], 2)
    return {
        "arms": arms,
        "msgs_per_consumer": total_msgs,
        "partitions": partitions,
        "speedup_on_vs_off": by_count,
        "host_cores": os.cpu_count(),
    }


def _fanout_arm(consumers: int, follower: bool, partitions: int,
                per_part: int, device) -> dict:
    """One fan-out arm (the reference's `one_arm`): boot a 3-broker
    `ProcCluster` (one `python -m ripplemq_tpu_torch.broker --device <d>`
    process a broker, each with its own CUDA context on the one card),
    produce `per_part` messages to each partition once, wait 1.5 s for
    the replication floors to land on the standbys, then run `consumers`
    consumers, each its own group re-reading the whole topic: every one
    must read exactly every message."""
    import shutil
    import tempfile
    import threading

    from ripplemq_tpu_torch.chaos.proc_cluster import (
        ProcCluster,
        free_ports,
        make_proc_cluster_config,
    )
    from ripplemq_tpu_torch.client import ConsumerClient, ProducerClient
    from ripplemq_tpu_torch.metadata.models import Topic

    total_msgs = per_part * partitions
    counts = [0] * consumers
    served = [0] * consumers
    fail: list[str] = []

    def member(ci: int) -> None:
        cc = ConsumerClient(
            bootstrap, f"fan-{ci}", transport=cluster.client(f"fan-{ci}"),
            rpc_timeout_s=10.0, follower_reads=follower)
        try:
            empties = 0
            while counts[ci] < total_msgs and empties < 200:
                msgs = cc.consume("fanout", max_messages=16)
                if msgs:
                    counts[ci] += len(msgs)
                    empties = 0
                else:
                    empties += 1
                    time.sleep(0.01)
            served[ci] = cc.follower_served
        except Exception as e:
            fail.append(f"consumer {ci}: {type(e).__name__}: {e}")
        finally:
            cc.close()

    tmp = tempfile.mkdtemp(prefix="fanout-")
    config = make_proc_cluster_config(
        free_ports(3), topics=(Topic("fanout", partitions, 3),),
        follower_reads=follower)
    cluster = ProcCluster(config=config, data_dir=tmp, device=device.type)
    try:
        cluster.start()
        cluster.wait_for_leaders()
        deadline = time.time() + 120
        while time.time() < deadline and not cluster.controller_ready():
            time.sleep(0.1)
        bootstrap = [b.address for b in config.brokers]
        producer = ProducerClient(
            bootstrap, transport=cluster.client("fanout-p"),
            rpc_timeout_s=10.0)
        B = config.engine.max_batch
        for pid in range(partitions):
            payloads = [b"f-%d-%06d" % (pid, i) for i in range(per_part)]
            for i in range(0, per_part, B):
                producer.produce_batch("fanout", payloads[i:i + B],
                                       partition=pid)
        producer.close()
        # Follower serving is gated on the replicated floor: an arm
        # racing it would measure leader fallbacks, not the plane.
        time.sleep(1.5)
        threads = [threading.Thread(target=member, args=(ci,), daemon=True,
                                    name=f"bench-fanout-{ci}")
                   for ci in range(consumers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        elapsed = time.perf_counter() - t0
        if fail or any(c != total_msgs for c in counts):
            raise AssertionError(
                f"fan-out arm (consumers={consumers}, follower={follower}) "
                f"not count-exact: wanted {total_msgs}/consumer, got "
                f"{counts}; errors: {fail}")
        return {
            "consumers": consumers,
            "follower_reads": follower,
            "msgs_per_sec": round(consumers * total_msgs / elapsed, 1),
            "elapsed_s": round(elapsed, 3),
            "follower_served": sum(served),
            "count_exact": True,
        }
    finally:
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _run_slo_convergence(target_ms: float = 25.0, light_s: float = 1.5,
                         heavy_s: float = 10.0, device=None) -> dict:
    """SLO autopilot time-to-SLO after a STEP-LOAD change: a 1-broker
    in-proc cluster (on `device`) runs with the control loop engaged
    (`slo_p99_ack_ms` = `target_ms`, 0.1 s ticks), a light phase of
    `light_s` sets the operating point, then the offered load steps to a
    saturating pipelined stream for `heavy_s`. Read from the controller's
    own tick history (admin.stats `slo`): the wall-clock from the step to
    the first post-step window back inside the target, and whether the
    step breached it at all (a measurement, not an assertion)."""
    from ripplemq_tpu_torch.chaos.cluster import (
        InProcCluster,
        make_cluster_config,
    )
    from ripplemq_tpu_torch.client import ProducerClient
    from ripplemq_tpu_torch.metadata.models import Topic

    dev = _device(device)
    config = make_cluster_config(
        1, topics=(Topic("slobench", 1, 1),), standby_count=0,
        slo_p99_ack_ms=target_ms, slo_tick_s=0.1, slo_chain_depth_max=4)
    with InProcCluster(config, device=dev) as cluster:
        cluster.wait_for_leaders()
        bootstrap = [b.address for b in config.brokers]
        producer = ProducerClient(
            bootstrap, transport=cluster.client("slobench-p"),
            rpc_timeout_s=10.0)
        admin = cluster.client("slobench-admin")
        addr = config.brokers[0].address
        payload = b"s" * 16  # inside the small engine's payload bytes
        try:
            t0 = time.monotonic()
            while time.monotonic() - t0 < light_s:
                producer.produce("slobench", payload, partition=0)
                time.sleep(0.005)
            t_step = time.time()
            waiters = []
            deadline = time.monotonic() + heavy_s
            while time.monotonic() < deadline:
                # The saturating step: a window of async batches deep
                # enough to queue the settle pipeline. Once the shed
                # machine engages, this quota-less producer draws
                # `overloaded:` refusals; the phase keeps offering load
                # (that is the measured scenario).
                try:
                    while len(waiters) < 64:
                        waiters.append(producer.produce_batch_async(
                            "slobench", [payload] * 16, partition=0))
                    waiters.pop(0)()
                except Exception:
                    time.sleep(0.005)
            for w in waiters:
                try:
                    w()
                except Exception:
                    pass
            st = admin.call(addr, {"type": "admin.stats"}, timeout=10.0)
        finally:
            producer.close()
        slo = st["slo"]
        hist = [row for row in slo["tick_history"] if row[0] >= t_step]
        breach_t = next((row[0] for row in hist if row[2] == 0.0), None)
        time_to_slo = None
        if breach_t is not None:
            rec_t = next((row[0] for row in hist
                          if row[0] > breach_t and row[2] == 1.0), None)
            if rec_t is not None:
                time_to_slo = round(rec_t - t_step, 3)
        return {
            "target_p99_ms": target_ms,
            "breached_after_step": breach_t is not None,
            "time_to_slo_s": time_to_slo,
            "adjustments": slo["adjustments"],
            "final_knobs": slo["knobs"],
            "final_p99_ms": slo["p99_ms"],
            "meeting_slo": slo["meeting_slo"],
        }


def _run_split_rebalance(warm_s: float = 1.5, tail_s: float = 1.5,
                         bucket_s: float = 0.25, device=None) -> dict:
    """Elastic-partition rebalance cost: a 3-broker in-proc cluster (on
    `device`) under sustained KEYED produce load splits partition 0
    online. Reports the begin→cutover interval from the brokers' own
    flight recorders (admin.trace), the wall-clock until every
    assignment is active again, and the throughput dip (the worst
    `bucket_s` ack-rate bucket of the `tail_s` after the split vs the
    pre-split average). Count-exact: every acked produce is read back from
    the final logs (`chaos.harness._drain_partition`, every partition,
    the child included); a lost write fails the phase."""
    import threading

    from ripplemq_tpu_torch.chaos.cluster import (
        InProcCluster,
        make_cluster_config,
    )
    from ripplemq_tpu_torch.chaos.harness import _drain_partition
    from ripplemq_tpu_torch.client import ProducerClient
    from ripplemq_tpu_torch.metadata.models import Topic

    dev = _device(device)
    topic = "splitbench"
    acks: list[float] = []  # ack wall-clock stamps
    stop = threading.Event()

    def offered() -> None:
        i = 0
        while not stop.is_set():
            try:
                producer.produce(topic, f"sb:{i}".encode(),
                                 key=f"k{i % 64:02d}".encode())
            except Exception:
                continue  # refusals/reroutes retry as new payloads
            acks.append(time.time())
            i += 1

    config = make_cluster_config(
        3, topics=(Topic(topic, 2, 3),), spare_slots=1,
        split_handoff_timeout_s=5.0)
    with InProcCluster(config, device=dev) as cluster:
        cluster.wait_for_leaders()
        bootstrap = [b.address for b in config.brokers]
        producer = ProducerClient(
            bootstrap, transport=cluster.client("splitbench-p"),
            metadata_refresh_s=0.2, rpc_timeout_s=5.0)
        t = threading.Thread(target=offered, daemon=True,
                             name="bench-split-producer")
        t.start()
        try:
            time.sleep(warm_s)
            t_split = time.time()
            resp = cluster.admin_split(topic, 0)
            rebalanced_at = None
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                view = cluster.topic_view(topic)
                if view and all(a.state == "active" for a in view):
                    rebalanced_at = time.time()
                    break
                time.sleep(0.01)
            time.sleep(tail_s)
        finally:
            stop.set()
            t.join(timeout=10)
            producer.close()
        n_acked = len(acks)
        pids = sorted(a.partition_id for a in cluster.topic_view(topic))
        readback = sum(
            len(_drain_partition(cluster, topic, pid, tag=f"sb-{pid}"))
            for pid in pids)
        admin = cluster.client("splitbench-a")
        cut_s = None
        forwarded = fences = 0
        for b in config.brokers:
            try:
                st = admin.call(b.address, {"type": "admin.stats"},
                                timeout=10.0)
                tr = admin.call(b.address, {"type": "admin.trace"},
                                timeout=10.0)
            except Exception:
                continue
            rc = st.get("reconfig") or {}
            forwarded += int(rc.get("forwarded_writes") or 0)
            fences += int(rc.get("fence_refusals") or 0)
            evs = {e["type"]: e["t"] for e in tr.get("trace", [])
                   if e.get("type") in ("split_begin", "split_cutover")}
            if "split_begin" in evs and "split_cutover" in evs:
                d = evs["split_cutover"] - evs["split_begin"]
                if d >= 0 and (cut_s is None or d < cut_s):
                    cut_s = round(d, 3)
        pre = [a for a in acks if a < t_split]
        pre_rate = round(len(pre) / max(warm_s, 1e-6), 1)
        buckets: dict[int, int] = {}
        for a in acks:
            if a >= t_split:
                k = int((a - t_split) / bucket_s)
                buckets[k] = buckets.get(k, 0) + 1
        n_buckets = max(1, int(tail_s / bucket_s))
        worst = min((buckets.get(i, 0) for i in range(n_buckets)),
                    default=0) / bucket_s
        if readback != n_acked:
            raise AssertionError(
                f"split_rebalance readback mismatch: acked {n_acked}, "
                f"read back {readback} (partitions {pids})")
        return {
            "split_ok": bool(resp.get("ok")),
            "time_to_rebalance_s": (
                None if rebalanced_at is None
                else round(rebalanced_at - t_split, 3)),
            "begin_to_cutover_s": cut_s,
            "pre_split_acks_per_sec": pre_rate,
            "worst_post_split_bucket_acks_per_sec": round(worst, 1),
            "dip_ratio": (round(worst / pre_rate, 3) if pre_rate else None),
            "forwarded_writes": forwarded,
            "fence_refusals": fences,
            "acked": n_acked,
            "readback": readback,
        }


def _run_stripe_encode(mb: int = 4, reps: int = 3, device=None) -> float:
    """stripe_encode_mb_per_sec: GF(2⁸) RS(3,2) group-encode throughput at
    the sender's group-commit blob shape (one gf_matmul per blob: the
    CUDA kernel on a GPU). Best-of-N over a ~`mb` MB record batch; the
    first call (the size class's launch plan) is excluded."""
    from ripplemq_tpu_torch.stripes.codec import encode_group

    dev = _device(device)
    records = [(1, 0, i, bytes(64 << 10)) for i in range(mb * 16)]
    nbytes = sum(len(r[3]) for r in records)
    encode_group(records, 1, 0, device=dev)  # plan the size class
    best = 0.0
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        encode_group(records, 1, r, device=dev)  # parity's D2H copy fences
        dt = time.perf_counter() - t0
        best = max(best, nbytes / dt / 1e6)
    return round(best, 2)


# The replication-bytes clusters' engine past `small_engine`'s defaults
# (1 partition x 3 replicas): 512-byte rows for 400-byte payloads.
REPL_ENGINE = dict(slots=1024, slot_bytes=512, max_batch=16)


def _run_repl_bytes(n_batches: int = 40, batch: int = 8,
                    payload_bytes: int = 400, device=None) -> dict:
    """Replication bytes per acked payload byte in BOTH replication
    modes, on a 5-broker in-proc cluster (brokers on `device`: the
    controller and 4 standbys, where full copies ship R-1 = 4 copies and
    striping (k+m)/k). Bytes are the modes' own acked-stream counters
    (`repl.bytes` / `stripes.bytes`, read from the controller's
    admin.metrics until they stop moving); acked bytes are counted
    client-side. Both numerators carry the same overheads (slot padding,
    pid/sequence and offset records, stripe frame headers). The striped
    arm encodes every stripe group with `gf_matmul`."""
    import shutil
    import tempfile

    from ripplemq_tpu_torch.chaos.cluster import (
        InProcCluster,
        make_cluster_config,
        small_engine,
    )
    from ripplemq_tpu_torch.client import ProducerClient
    from ripplemq_tpu_torch.metadata.models import Topic

    dev = _device(device)
    out: dict = {}
    for mode in ("full", "striped"):
        tmp = tempfile.mkdtemp(prefix=f"replbytes-{mode}-")
        config = make_cluster_config(
            n_brokers=5, topics=(Topic("rb", 1, 3),),
            engine=small_engine(1, 3, **REPL_ENGINE),
            replication=mode, standby_count=4)
        cluster = InProcCluster(config, data_dir=tmp, device=dev)
        counters = {}
        try:
            cluster.start()
            cluster.wait_for_leaders()
            deadline = time.time() + 60
            ctrl = None
            while time.time() < deadline:
                st = cluster.client("rb").call(
                    cluster.broker_addr(0), {"type": "admin.stats"},
                    timeout=5.0)
                if len(st["controller"]["standbys"]) >= 4:
                    ctrl = st["controller"]["id"]
                    break
                time.sleep(0.1)
            assert ctrl is not None, "standby set never reached 4"
            prod = ProducerClient(
                [b.address for b in config.brokers],
                transport=cluster.client("rb-prod"), metadata_refresh_s=0.5)
            acked = 0
            for i in range(n_batches):
                prod.produce_batch(
                    "rb", [bytes([i & 0xFF]) * payload_bytes] * batch,
                    partition=0)
                acked += batch * payload_bytes
            prod.close()
            # Let the in-flight tail (the striped mode's last m stripes
            # stream past the k-ack settle) drain: poll the counters
            # until they stop moving.
            last = -1
            for _ in range(50):
                m = cluster.client("rb-m").call(
                    cluster.broker_addr(ctrl), {"type": "admin.metrics"},
                    timeout=5.0)
                counters = m["metrics"]["counters"]
                total = (counters.get("repl.bytes", 0)
                         + counters.get("stripes.bytes", 0))
                if total == last:
                    break
                last = total
                time.sleep(0.2)
        finally:
            cluster.stop()
            shutil.rmtree(tmp, ignore_errors=True)
        repl_bytes = (counters.get("repl.bytes", 0)
                      + counters.get("stripes.bytes", 0))
        out[mode] = {
            "repl_bytes": int(repl_bytes),
            "acked_payload_bytes": int(acked),
            "per_acked_byte": round(repl_bytes / max(1, acked), 3),
            "stripe_groups": int(counters.get("stripes.groups", 0)),
        }
    out["striped_vs_full"] = round(
        out["striped"]["per_acked_byte"] / out["full"]["per_acked_byte"], 3)
    return out


def _run_codec(batch: int = 256, payload_bytes: int = 100,
               iters: int = 400) -> dict:
    """Codec throughput on the produce-frame shape: encode+decode MB/s of
    a `batch`-message request through the bulk vector path vs the
    generic per-value recursion (both decode to the same value)."""
    from ripplemq_tpu_torch.wire import codec

    payloads = [
        (b"codec-%06d|" % i).ljust(payload_bytes, b"x") for i in range(batch)
    ]
    req = {"type": "produce", "topic": "bench", "partition": 0,
           "messages": payloads}
    out = {}
    for name, bulk in (("bulk", True), ("generic", False)):
        raw = codec.encode(req, bulk=bulk)
        mb = len(raw) / 1e6
        t0 = time.perf_counter()
        for _ in range(iters):
            codec.encode(req, bulk=bulk)
        enc_s = (time.perf_counter() - t0) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            codec.decode(raw)
        dec_s = (time.perf_counter() - t0) / iters
        out[f"encode_mb_per_sec_{name}"] = round(mb / enc_s, 1)
        out[f"decode_mb_per_sec_{name}"] = round(mb / dec_s, 1)
    # Headline: the bulk round trip (one encode + one decode per frame).
    out["codec_mb_per_sec"] = round(
        2.0 / (1.0 / out["encode_mb_per_sec_bulk"]
               + 1.0 / out["decode_mb_per_sec_bulk"]), 1)
    return out


def _round_rtt(cfg, samples: int = 8, device=None) -> float:
    """Median single-round launch+fetch time (ms): the latency floor of
    one quorum round on this card."""
    fns, alive, quorum, build, put = _make(cfg, device)
    one = build(cfg, appends={0: [PAYLOAD]}, leader=0, term=1)
    inp = type(one)(*(None if x is None else put(x) for x in one))
    state = fns.init()
    for _ in range(3):  # warm
        state, out = fns.step(state, inp, alive, quorum)
    _fetch(out.committed)
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        state, out = fns.step(state, inp, alive, quorum)
        _fetch(out.committed)  # D2H copy = execution fence
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


# ---------------------------------------------------------------- gate
# The headline metrics the `--compare` regression gate watches, with the
# direction that counts as better (the reference's list).
HEADLINE_GATES = (
    ("value", "higher"),                       # engine sustained rate
    ("shipped_shape_appends_per_sec", "higher"),
    ("consume_msgs_per_sec", "higher"),
    ("codec_mb_per_sec", "higher"),
    ("stripe_encode_mb_per_sec", "higher"),
    ("e2e_appends_per_sec", "higher"),
    ("e2e_consume_msgs_per_sec", "higher"),
    ("p99_ack_ms", "lower"),
)
REGRESSION_PCT = 15.0

# The artifact's keys: the reference `main()`'s, in its order, plus `card`.
RESULT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "baseline_appends_per_sec",
    "config", "burst_window_appends_per_sec", "burst_window_config",
    "shipped_shape_appends_per_sec", "shipped_config",
    "p50_ack_ms", "p99_ack_ms", "p999_ack_ms", "round_rtt_ms",
    "operating_curve", "consume_msgs_per_sec", "spmd_parity",
    "spmd_scaling", "control_fusion_ab",
    "codec_mb_per_sec", "codec_ab", "repl_bytes_per_acked_byte",
    "stripe_encode_mb_per_sec", "readback", "host_plane_scaling",
    "slo_convergence", "split_rebalance", "consume_fanout",
    "control_plane_storm", "e2e_group_consume_msgs_per_sec",
    "group_consume",
    "e2e_obs", "latency_decomposition", "admin_metrics",
    "e2e_appends_per_sec", "e2e_mb_per_sec", "e2e_acked",
    "e2e_offered_batches", "e2e_client_procs", "e2e_host_workers",
    "e2e_cpu_decomposition", "e2e_phases", "e2e_seconds", "e2e_readback",
    "e2e_consume_msgs_per_sec", "e2e_consume_mb_per_sec", "e2e_consumed",
    "e2e_consume_seconds", "e2e_consume_verified", "settle_pipeline",
    "card",
)


def _card(device) -> dict:
    """What the run measured on: `nvidia-smi`'s name and power limit of
    each card and the device count (None and 0 on the CPU)."""
    import subprocess

    import torch

    dev = _device(device)
    if dev.type != "cuda":
        return {"nvidia_smi": None, "name": None, "count": 0,
                "device": dev.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return {"nvidia_smi": smi.stdout.strip(),
            "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "device": str(dev)}


def _archive_result(result: dict, out_dir: str | None = None) -> str:
    """Write the run's artifact as the next free `BENCH_torch_r<NN>.json`
    in `out_dir` (default: the repository root). Never a `BENCH_r<NN>`
    name: those are the reference's TPU rounds."""
    import os
    import re

    root = out_dir or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    taken = [
        int(m.group(1))
        for f in os.listdir(root)
        if (m := re.fullmatch(r"BENCH_torch_r(\d+)\.json", f))
    ]
    path = os.path.join(
        root, "BENCH_torch_r%02d.json" % (max(taken, default=0) + 1))
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    return path


def _load_baseline(path: str) -> dict:
    """A baseline is either a bare bench artifact (what _archive_result
    writes) or a wrapper document holding one under `parsed`/`tail`."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "metric" in doc:
        return doc
    if isinstance(doc, dict):
        if isinstance(doc.get("parsed"), dict):
            return doc["parsed"]
        tail = doc.get("tail") or ""
        i = tail.find('{"metric"')
        if i >= 0:
            return json.loads(tail[i:])
        # Front-truncated tail: the cut usually lands inside the first
        # string value, so re-opening the object with a dummy key
        # recovers every complete key after the cut point.
        try:
            rec = json.loads('{"_truncated": "' + tail)
        except ValueError:
            rec = None
        if isinstance(rec, dict) and any(
                k in rec for k, _ in HEADLINE_GATES):
            return rec
    raise SystemExit(f"--compare: no bench artifact found in {path}")


def _require_card_baseline(baseline: dict, path: str) -> None:
    """The port's baseline is a run on an NVIDIA card: an artifact without
    one (a TPU round of the reference, a CPU run) is refused."""
    card = baseline.get("card")
    smi = card.get("nvidia_smi") if isinstance(card, dict) else None
    if not (isinstance(smi, str) and "NVIDIA" in smi):
        raise SystemExit(
            f"--compare: {path} names no NVIDIA card (its `card` is "
            f"{card!r}); the port's baseline is a BENCH_torch_r*.json "
            f"measured on the GPU")


def compare_results(result: dict, baseline: dict,
                    threshold_pct: float = REGRESSION_PCT) -> list[str]:
    """Regression gate: every HEADLINE_GATES metric present in BOTH
    artifacts must not be worse than the baseline by > threshold_pct.
    Returns the failure lines (empty = gate passes); prints one verdict
    line per compared metric to stderr."""
    import sys

    failures: list[str] = []
    for key, direction in HEADLINE_GATES:
        if key not in result or key not in baseline:
            continue
        cur, base = float(result[key]), float(baseline[key])
        if base == 0:
            continue
        # Positive delta_pct = worse, in either direction's terms.
        delta = ((base - cur) if direction == "higher" else (cur - base)) \
            / abs(base) * 100.0
        worse = delta > threshold_pct
        print("compare: %-32s %14.3f -> %14.3f  %+7.2f%% %s"
              % (key, base, cur, -delta if direction == "higher" else delta,
                 "REGRESSED" if worse else "ok"), file=sys.stderr)
        if worse:
            failures.append(
                f"{key}: {base} -> {cur} "
                f"({delta:.1f}% worse, limit {threshold_pct}%)")
    return failures


# The latency shape (the broker's default 32-row windows), shared by the
# latency, RTT and curve phases and by `operating_curve`.
LAT_SHAPE = dict(
    partitions=1024, replicas=5, slots=2048, slot_bytes=128,
    max_batch=32, read_batch=32, max_consumers=64, max_offset_updates=8,
)

# The shipped example shape (examples/cluster.yaml engine:), run at the
# broker's default chain depth. 96 rounds x 32 rows < 4096 slots.
SHIPPED_SHAPE = dict(
    partitions=8, replicas=3, slots=4096, slot_bytes=256,
    max_batch=32, read_batch=32, max_consumers=64, max_offset_updates=8,
)

# The baseline: the reference architecture's shape (1 partition, RF 5,
# ONE entry per strictly sequential round).
BASE_SHAPE = dict(
    partitions=1, replicas=5, slots=2048, slot_bytes=128,
    max_batch=8, read_batch=32, max_consumers=64, max_offset_updates=8,
)


def _rails_prior(curve: list[dict]) -> dict:
    """The `slo_rails_file` prior derived from a measured operating curve:
    among the light-load points, the largest coalesce budget whose p99
    stays within 25% of the measured floor is the coalesce rail ceiling;
    the chain depth of the highest-throughput point is the depth
    ceiling; the floors stay at 0 s and depth 1."""
    light = [pt for pt in curve if "window" not in pt]
    floor_p99 = min(pt["p99_ack_ms"] for pt in light)
    ok_budget = [pt for pt in light
                 if pt["p99_ack_ms"] <= 1.25 * floor_p99]
    best = max(curve, key=lambda pt: pt["appends_per_sec"])
    rails = {
        "read_coalesce_min_s": 0.0,
        "read_coalesce_max_s": max(pt["coalesce_s"] for pt in ok_budget),
        "chain_depth_min": 1,
        "chain_depth_max": int(best["chain_depth"]),
    }
    return {
        "method": "python -m ripplemq_tpu_torch.bench operating_curve",
        "floor_p99_ack_ms": floor_p99,
        "rails": rails,
        "curve": curve,
    }


def _operating_curve_main(out_path: str, device=None) -> None:
    """Standalone rails-prior phase: measure the (coalesce, chain_depth)
    operating curve at the headline latency shape on `device` and write
    an `slo_rails_file` JSON prior (`_rails_prior`), which the SLO
    controller loads at boot (slo/controller.py `_load_rails`)."""
    from ripplemq_tpu_torch.core.config import EngineConfig

    prior = _rails_prior(_run_curve(EngineConfig(**LAT_SHAPE),
                                    device=device))
    with open(out_path, "w") as f:
        json.dump(prior, f, indent=1)
        f.write("\n")
    print(json.dumps({"rails": prior["rails"],
                      "floor_p99_ack_ms": prior["floor_p99_ack_ms"],
                      "out": out_path}))


def _collect(device=None, depth: str | None = None, phase=None) -> dict:
    """Every phase of the reference's `main()`, in its order, on
    `device` at `depth` ("full", or "short": the default on the CPU).
    `phase(name)`, when given, returns a context manager entered around
    each phase (the chip run counts kernel launches and device memory
    there). Returns the artifact."""
    import contextlib

    from ripplemq_tpu_torch.core.config import EngineConfig

    dev = _device(device)
    d = DEPTHS[depth or ("short" if dev.type == "cpu" else "full")]
    phase = phase or (lambda name: contextlib.nullcontext())
    card = _card(dev)

    # The headline: 1024 partitions x RF 5, full 256-row batches, chains
    # of 8 rounds, the ring wrapping behind the staged trim; the burst
    # window is kept as the cross-round comparability row.
    tpu_cfg = EngineConfig(
        partitions=1024, replicas=5, slots=12352, slot_bytes=128,
        max_batch=256, read_batch=32, max_consumers=64, max_offset_updates=8,
    )
    with phase("sustained"):
        tpu_rate = _run_sustained(tpu_cfg, chain=8,
                                  launches=d["eng_launches"],
                                  windows=d["eng_windows"], verify=True,
                                  device=dev)
    with phase("burst"):
        burst_rate = _run_mode(tpu_cfg, batch_per_partition=256, rounds=48,
                               warmup=1, verify=True, chain=8, device=dev)

    with phase("shipped"):
        shipped_rate = _run_mode(EngineConfig(**SHIPPED_SHAPE),
                                 batch_per_partition=32, rounds=96,
                                 warmup=2, chain=4, device=dev)

    # The baseline, with the same sustained method as the numerator.
    with phase("baseline"):
        base_rate = _run_sustained(EngineConfig(**BASE_SHAPE), chain=1,
                                   launches=d["base_launches"],
                                   windows=d["eng_windows"],
                                   verify=True, batch_per_partition=1,
                                   partitions=1, device=dev)

    lat_cfg = EngineConfig(**LAT_SHAPE)
    with phase("latency"):
        lat = _run_latency(lat_cfg, device=dev)
    with phase("rtt"):
        rtt_ms = _round_rtt(lat_cfg, device=dev)
    with phase("curve"):
        curve = _run_curve(lat_cfg, device=dev)
    # read_batch 128: the host-mirror consume path serves up to
    # read_batch rows per call.
    consume_cfg = EngineConfig(
        partitions=1024, replicas=5, slots=2048, slot_bytes=128,
        max_batch=32, read_batch=128, max_consumers=64, max_offset_updates=8,
    )
    with phase("consume"):
        consume_rate = _run_consume(consume_cfg, consumers=32,
                                    rows_per_part=128, device=dev)
    with phase("spmd_parity"):
        spmd = _run_spmd_parity(launches=d["parity_launches"], device=dev)
    with phase("spmd_scaling"):  # its ranks are processes of their own
        spmd_scaling = _run_spmd_scaling(device=dev)
    with phase("fusion_ab"):
        fusion_ab = _run_fusion_ab(launches=d["ab_launches"],
                                   control_launches=d["ab_launches"],
                                   windows=2, device=dev)
    with phase("codec"):
        codec_stats = _run_codec()
    with phase("repl_bytes"):
        repl_bytes = _run_repl_bytes(device=dev)
    with phase("stripe_encode"):
        stripe_encode = _run_stripe_encode(device=dev)
    with phase("group_consume"):
        group_consume = _run_group_consume(device=dev)
    with phase("slo_convergence"):
        slo_convergence = _run_slo_convergence(device=dev)
    with phase("split_rebalance"):
        split_rebalance = _run_split_rebalance(device=dev)
    with phase("consume_fanout"):  # its brokers are processes of their own
        consume_fanout = _run_consume_fanout(device=dev)
    with phase("control_plane_storm"):
        control_plane_storm = _run_control_plane_storm(device=dev)
    with phase("e2e"):
        e2e = _run_e2e(duration_s=d["e2e_s"], phases=d["e2e_phases"],
                       device=dev)
    with phase("host_plane_scaling"):
        host_plane_scaling = _run_host_plane_scaling(
            duration_s=d["hp_s"], phases=d["hp_phases"], device=dev)

    result = {
        "metric": "committed_appends_per_sec",
        "value": round(tpu_rate, 1),
        "unit": "appends/s",
        "vs_baseline": round(tpu_rate / base_rate, 2),
        "baseline_appends_per_sec": round(base_rate, 1),
        "config": "P=1024 R=5 B=256 chain=8 sustained",
        "burst_window_appends_per_sec": round(burst_rate, 1),
        "burst_window_config": "P=1024 R=5 B=256 chain=8 (r3/r4 method)",
        "shipped_shape_appends_per_sec": round(shipped_rate, 1),
        "shipped_config": "P=8 R=3 B=32 SB=256 chain=4",
        "p50_ack_ms": round(lat["p50"], 3),
        "p99_ack_ms": round(lat["p99"], 3),
        "p999_ack_ms": round(lat["p999"], 3),
        "round_rtt_ms": round(rtt_ms, 3),
        "operating_curve": curve,
        "consume_msgs_per_sec": round(consume_rate, 1),
        "spmd_parity": spmd,
        "spmd_scaling": spmd_scaling,
        "control_fusion_ab": fusion_ab,
        "codec_mb_per_sec": codec_stats["codec_mb_per_sec"],
        "codec_ab": codec_stats,
        "repl_bytes_per_acked_byte": repl_bytes,
        "stripe_encode_mb_per_sec": stripe_encode,
        "readback": "verified",
        "host_plane_scaling": host_plane_scaling,
        "slo_convergence": slo_convergence,
        "split_rebalance": split_rebalance,
        "consume_fanout": consume_fanout,
        **control_plane_storm,
        **group_consume,
        **e2e,
        "card": card,
    }
    assert tuple(result) == RESULT_KEYS, sorted(
        set(result) ^ set(RESULT_KEYS))
    return result


def _launches() -> dict:
    """The port's kernel launch counters of this process (the wrappers
    count a launch on CUDA only; the standby processes' are their own)."""
    from ripplemq_tpu_torch.ops import append, rs

    return {**append.LAUNCHES, "gf_matmul": rs.LAUNCHES["gf_matmul"]}


def main(compare: "str | None" = None, device=None,
         out_dir: "str | None" = None) -> None:
    import sys

    baseline = None
    if compare:  # refuse a wrong baseline before the run, not after it
        baseline = _load_baseline(compare)
        _require_card_baseline(baseline, compare)
    result = _collect(device)
    print(json.dumps(result))
    print(f"archived -> {_archive_result(result, out_dir)}", file=sys.stderr)
    print(f"kernel launches in this process: {_launches()}", file=sys.stderr)
    if baseline is not None:
        failures = compare_results(result, baseline)
        if failures:
            raise SystemExit(
                "bench regression gate FAILED:\n  " + "\n  ".join(failures))
        print("bench regression gate: ok", file=sys.stderr)


def _cli(argv: list[str] | None = None) -> None:
    import argparse
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["_e2e_client"]:
        # e2e load-generator subprocess (torch-free): see _e2e_client_main.
        if len(argv) < 2:
            raise SystemExit("usage: _e2e_client SPEC.json")
        _e2e_client_main(argv[1])
        return
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.bench",
        description="The port's bench (see the module docstring).")
    ap.add_argument("mode", nargs="?", choices=[
                        "operating_curve", "consume_fanout",
                        "split_rebalance", "control_plane_storm"],
                    help="operating_curve: measure the (coalesce, chain "
                         "depth) curve and write an slo_rails_file prior; "
                         "consume_fanout, split_rebalance, "
                         "control_plane_storm: run that phase alone and "
                         "print its JSON")
    ap.add_argument("out", nargs="?", default="slo_rails.json",
                    help="operating_curve's output file")
    ap.add_argument("--compare", metavar="BASELINE.json", default=None,
                    help="full run, then the regression gate against a "
                         "prior BENCH_torch_r*.json (exits nonzero on a "
                         ">15%% regression of any HEADLINE_GATES metric)")
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA by default; 'cpu' for tests)")
    ap.add_argument("--out", dest="out_dir", default=None,
                    help="directory for BENCH_torch_r*.json (default: the "
                         "repository root)")
    args = ap.parse_args(argv)
    if args.mode == "operating_curve":
        _operating_curve_main(args.out, device=args.device)
        return
    if args.mode == "consume_fanout":
        print(json.dumps({"consume_fanout":
                          _run_consume_fanout(device=args.device)}))
        return
    if args.mode == "split_rebalance":
        print(json.dumps({"split_rebalance":
                          _run_split_rebalance(device=args.device)}))
        return
    if args.mode == "control_plane_storm":
        print(json.dumps(_run_control_plane_storm(device=args.device)))
        return
    main(compare=args.compare, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    _cli()

"""Benchmark of the PyTorch port: committed-appends/sec, produce-ack
latency percentiles, consume and end-to-end rates on one GPU.

Twin of the repository root's `bench.py` (the reference's measuring
program) for the phases behind its headline metrics: the same functions
under the same names, each measuring the same way, on the port's
engine, DataPlane, broker and clients. Run:

    python -m ripplemq_tpu_torch.bench                 # full run, archived
    python -m ripplemq_tpu_torch.bench --compare BENCH_torch_r01.json
    python -m ripplemq_tpu_torch.bench operating_curve [OUT.json]
    python -m ripplemq_tpu_torch.bench --device cpu --out DIR

Prints ONE JSON line: the reference's artifact keys (`value`,
`vs_baseline`, `shipped_shape_appends_per_sec`, `p50/p99/p999_ack_ms`,
`round_rtt_ms`, `operating_curve`, `consume_msgs_per_sec`,
`control_fusion_ab`, `codec_mb_per_sec`, `stripe_encode_mb_per_sec`,
the `e2e_*` figures, `readback`, ...) less those of the phases not
ported yet (`RESULT_KEYS` lists them all), plus `card`: the card's name
and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them, and the device count.

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
  `/proc/<pid>/maps`, while they run).

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
# baseline 500), with the e2e phase cut to one 4 s phase.
DEPTHS = {
    "full": dict(eng_launches=480, eng_windows=3, ab_launches=240,
                 base_launches=2000, e2e_s=12.0, e2e_phases=2),
    "short": dict(eng_launches=48, eng_windows=2, ab_launches=32,
                  base_launches=500, e2e_s=4.0, e2e_phases=1),
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

# The artifact's keys: the reference `main()`'s, less those of the phases
# not ported yet (spmd parity and scaling, replication bytes, group
# consume, SLO convergence, split rebalance, consume fan-out, the
# control-plane storm, the host-plane sweep), plus `card`.
RESULT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "baseline_appends_per_sec",
    "config", "burst_window_appends_per_sec", "burst_window_config",
    "shipped_shape_appends_per_sec", "shipped_config",
    "p50_ack_ms", "p99_ack_ms", "p999_ack_ms", "round_rtt_ms",
    "operating_curve", "consume_msgs_per_sec", "control_fusion_ab",
    "codec_mb_per_sec", "codec_ab", "stripe_encode_mb_per_sec",
    "readback",
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
    """Every ported phase of `main()`, in the reference's order, on
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
    with phase("fusion_ab"):
        fusion_ab = _run_fusion_ab(launches=d["ab_launches"],
                                   control_launches=d["ab_launches"],
                                   windows=2, device=dev)
    with phase("codec"):
        codec_stats = _run_codec()
    with phase("stripe_encode"):
        stripe_encode = _run_stripe_encode(device=dev)
    with phase("e2e"):
        e2e = _run_e2e(duration_s=d["e2e_s"], phases=d["e2e_phases"],
                       device=dev)

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
        "control_fusion_ab": fusion_ab,
        "codec_mb_per_sec": codec_stats["codec_mb_per_sec"],
        "codec_ab": codec_stats,
        "stripe_encode_mb_per_sec": stripe_encode,
        "readback": "verified",
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
    ap.add_argument("mode", nargs="?", choices=["operating_curve"],
                    help="operating_curve: measure the (coalesce, chain "
                         "depth) curve and write an slo_rails_file prior")
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
    main(compare=args.compare, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    _cli()

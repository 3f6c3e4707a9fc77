#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (`ripplemq_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--dataplane-only | --control-only
                                      | --broker-only | --planes-only
                                      | --spmd-only | --witness-only
                                      | --tools-only | --bench-only
                                      | --gloo-probe]

`--dataplane-only` builds the kernels and runs only phase 8,
`--control-only` only phase 9, `--broker-only` only phase 10,
`--planes-only` only phase 11 (after the RS kernel's check at the stripe
ladder's widths), `--spmd-only` only phase 12, `--witness-only` only
phase 13, `--tools-only` only phase 14 and `--bench-only` only phase
15 (after the append kernel's check at the bench's small engines and
the spmd scaling shards), without the result line:
loops for measuring the DataPlane, the control path, the broker path
(`--broker-only` also times the consumers' drain with the reference's
auto-commit against the port's), the planes path, the lockstep path,
the witness path, the tools path and the bench path. `--gloo-probe`
checks only the spmd binding's gloo collectives on CUDA tensors across
2 and 6 ranks of the card, their latency, and that a killed peer makes
a collective raise. Runs only where
`torch.cuda.is_available()`; exits nonzero at once
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
   compared with torch.equal; then the dataplane path's shapes (1024 x 5,
   slots 2048, B 32: the 1.36 GB ring) and the control path's (1024 x 3:
   the 0.82 GB ring) at every active-set bucket A in
   {8, 32, 128, 512, 1024}, the whole log compared, and the broker
   path's (1024 x 3, slots 4608, B 512: the 1.81 GB ring, entries of
   64 KiB) at the same buckets; then small
   configurations that reach the
   kernel's register path (SB = 25; logs and entries at 1, 3 and 8-byte
   offsets; bases from -B) and its bulk path with SB % 16 != 0
   (SB = 24); then the small engines at A = P, 8 appends on one log
   pair each: the chaos clusters', the bench's shipped shape (8 x 3,
   slots 4096, SB 256, B 32), its baseline (1 x 5, slots 2048, B 8) and
   its slice-J clusters' (the replication bytes' 1 x 3, SB 512, B 16;
   the fan-out's 2 x 3, SB 64, B 16; the group drain's, the storm's,
   the SLO step's and the split's); the spmd scaling curve's shards
   (R 1, slots 2496, SB 128, B 64) at 256 and 32 partitions, A = P;
   then the GF(2^8) kernel against its plain version
   (torch.equal) at a 64 MiB segment's shard length with the encode
   matrix and all 10 reconstruct inverses, every pair of input and output
   row offsets in {0, 1, 7, 15} bytes at widths 1, 15, 16, 17, 33, 4095,
   4097 (and the full width for the encode), small odd and aligned
   widths, a 16x16 matrix, N = 0 (no launch), and every class of the
   stripe codec's ladder (512 B to 2,840,576 B, an 8 MiB group commit's
   shard), the encode and a 3x3 reconstruct;
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
8. the dataplane path: `DataPlane` on CUDA at the broker's latency shape
   (1024 partitions x 5 replicas, slots 2048, B 32, SB 128: a 1.36 GB
   ring log on the card and a 268 MB host mirror), two planes in turn:
   A, the legacy binding with `SegmentStore(erasure=True)` at 64 MiB
   segments, durability "async" and the host read mirror; B,
   fused_control + packed_writes with no store and no mirror, so every
   consume is a device `read_many` (read_batch 128). Each plane: an
   election of all 1024 partitions in one vote round, `warm`; 16
   threads x 250 single-message produces, each awaited (appends/s, ack
   p50/p99/p999, `engine.dispatch_us`, `settle.commit_wait_us`); a bulk
   backlog of 4 batches of 32 on every partition (appends/s, rounds per
   dispatch); on A, a ring lap of 72 more batches on 4 partitions (trim
   rises; their oldest rows come from the store); offset commits for 64
   consumer slots on 64 partitions, read back through `read_offset`; 32
   consumer threads walking every partition through `read` (B rotates
   the serving replica over all 5), every acked message back exactly
   once, byte-exact, at its acked offset; on A, a restart
   (`recover_image` + `install` into a fresh plane), everything re-read
   exactly, one more batch a partition read back; the device log's
   rows of every acked message still in the ring equal to the packed
   row on all 5 replicas (and to the host mirror's, on A) after the bulk,
   after A's lap and after A's restart; the append kernel's launches at
   least the plane's rounds;
   (launch counts are zeroed just before each path and read just after)
9. the control path: five brokers (examples/cluster.yaml's roster) on
   loopback TCP, each a metadata `RaftNode` + `RaftRunner` with its
   `PartitionManager` as the state machine; two topics of 512
   partitions at replication factor 3; the controller's manager drives
   a `DataPlane` on CUDA (1024 x 3, slots 2048, B 32, SB 128,
   `SegmentStore(erasure=True)`, the host mirror), whose settle step
   streams every round through a `RoundReplicator` to 2 standbys before
   the ack. In turn: the assignment, applied on all 5 with equal
   snapshots; the attach, both standbys caught up (`catchup`) and
   admitted through Raft; `plan_elections` off the card and one vote
   round for all 1024 partitions, the adverts through Raft; 16 x 250
   awaited single-message produces and the bulk backlog (as plane A's),
   the device log's acked rows on all 3 replicas and the standbys'
   stores equal to the controller's; a broker that is neither the
   metadata leader nor a standby stopped, its loss committed in the
   form the broker commits only when RF cannot be met (a drill: with RF
   met the broker re-places in one command, which resyncs nothing on
   one card): its replica slots dead (the live-set advance, placement
   kept), re-elections, one batch a partition at quorum 2 of 3, then
   the re-placement `plan_assignment` computed at the loss, on whose
   apply `_resync_slots` resyncs the revived slots on the card (device
   time from the profiler's events), until `plan_repairs() == {}`;
   the device log's rows equal on all 3
   replicas again; every acked message read back exactly; then the
   controller stopped, standby 1's store recovered (`recover_image`),
   the image moved to the card and installed into a fresh plane,
   `plan_controller` promoting broker 1 through Raft, re-placement and
   elections on the promoted plane, one more batch a partition, every
   acked message read back from it. Cuts: the topics' 3 partitions
   scaled to 512 each, the replica axis cut from 5 to 3, the broker's
   duty loops played by the script; the standbys' side of the stream is
   the port server's own (`apply_repl_rounds`, `flush_repl_store`);
10. the broker path: bench.py's end-to-end topology with its config, no
   cut: three brokers on loopback TCP, topic "bench" of 1024 partitions
   at RF 3, a data_dir (an erasure-coded `SegmentStore`, 64 MiB
   segments) on each; the controller the port's `BrokerServer` in this
   process with its DataPlane on CUDA (1024 x 3, slots 4608, B 512, SB
   128, fused_control + packed_writes: a 1.81 GB ring log), the two
   standbys `python -m ripplemq_tpu_torch.broker --device cuda`
   processes started through the port's `ProcCluster`; the port's
   `ProducerClient` and `ConsumerClient` in a child process (its own
   interpreter). Traffic (depth cut since the bench path joined the
   run): 16 x 64 awaited single-message produces (appends/s, ack
   p50/p99/p999); a windowed bulk backlog of 8 producers x window 16 x
   batches of 512, enough to seal at least one 64 MiB segment; 16
   consumers with auto-commit reading every partition from
   0, every acked message once, byte-exact, at its acked offset, and the
   committed offsets read back equal; the controller's stage means. Then
   the controller stopped: a standby promotes and boots its plane on the
   card from its store (`replay_records` + `install`), every partition
   led by a live broker again (promotion -> serving, s), one more bulk
   window, every acked message read back from the promoted controller,
   both consumer sets' committed offsets equal. Checks after stopping:
   every sealed segment of the controller has 5 CRC-valid shards and an
   RS launch each; both standbys' stores hold every record of the
   controller's; the packed append launched at least once a controller
   round and the legacy variant never;
11. the planes path: the broker path's topology and engine with slice
   E's planes on: five brokers (examples/cluster.yaml's roster: the
   controller in this process and 4 standby processes), striped
   replication (`standby_count` 4: RS(3,2) stripes of every group commit
   to distinct standbys), follower reads, two host workers a broker (the
   controller's workers spawned from this script, which their re-run of
   it keeps torch-free; every worker process checked from outside for
   torch and JAX libraries). Traffic (depth cut for the bench path): 16 x 64
   awaited single-message produces through the host workers; a bulk
   backlog of 8 producers x window 16 x 32 batches of 512 (rounds of up
   to 8 MiB); 16 `follower_reads` consumers
   reading 256 messages an answer, every acked message once, byte-exact,
   at its acked offset, some answers from leased followers that decode
   striped groups on a read miss; then the controller stopped: a standby
   promotes, gathers the missing stripes (`stripe.fetch`), rebuilds its
   store and boots its plane on the card; more bulk, every acked message
   read back again. Gates: no follower answer past its floor, a decode
   on some standby, a rebuild on the promoted one, one RS launch at
   least per group commit on the controller, its host workers alive and
   serving, the packed append at least once a round. Every encode width
   past the ladder is checked against the plain version. Then one
   seed-0 chaos run (`run_chaos`, proc backend, striped, follower reads,
   2 host workers, on the card; one phase, was two) with no
   violation;
12. the lockstep path (slice F, the multi-device binding): the append
   kernels against their plain versions at the shapes the spmd binding
   gives them (a cell's one-replica 512-partition shard of the broker
   path's ring, the batcher's active sets localized, packed and legacy;
   the bench's spmd parity dense write); then, in its own process so
   that no process group outlives it here, the lockstep broker:
   the broker path's topology and engine, the controller (rank 0 of a
   6-rank gloo world, all on this card) with `engine_mode="spmd"` on a
   (replica 3, part 2) mesh whose other 5 cells are
   `python -m ripplemq_tpu_torch.parallel.worker` processes, the two
   standbys local; 16 x 64 awaited single-message produces, a bulk of
   8 x 96 batches of 512, every acked message read back exactly, the
   collectives a round and their mean us, the packed append's launches
   on every rank >= the controller's rounds; then the drill: one engine
   worker SIGKILLed during a second bulk (retried under the producers'
   idempotent identity), the plane must raise and break, the controller
   abdicate and release it, a standby promote on its local engine and
   serve, and every acked message read back exactly once (the 1x1
   parity arm, local vs spmd on a world of one, is the bench path's
   `spmd_parity` phase and its state check);
13. the witness path: the port's lint (`ripplemq_tpu_torch.analysis`)
   run clean on this host (per-rule counts and runtimes), the static
   lock graph's closure, then the runtime lock witness on the card,
   reset before and disabled after, on the broker path's topology at
   full width (1024 partitions x RF 3, slots 4608, B 512, fused +
   packed, 64 MiB erasure-coded segments, the standbys CLI processes)
   with `lock_witness: true`: 16 x 64 awaited single-message produces
   and a bulk of 8 x 32 batches of 512 (a depth cut of the broker
   path's traffic), every acked message read back exactly, the packed
   append at least once a controller round, the controller's witness
   report acyclic with no ordering outside the closure (its rates are
   taken with the witness on);
14. the tools path: the port's operator tools
   (`ripplemq_tpu_torch.profiles`) on the card, through their `main`:
   (a) the chaos soak CLI, every broker's plane on the card: an
   in-process `--sweep 2 --witness` (was 3 seeds); seed 1
   `--phases 2 --phase-s 0.5 --witness` and seed 11's striped schedule (a crash with a disk flip,
   then a stripe-holder kill) written to a trace file and run with
   `--replay --witness --postmortems` (the CPU twins' chaos gates, which
   the witness path ran before; their launches count as the witness
   path's); a `--replay` of that run's own verdict, whose digest and
   trace must equal it; and `--backend proc --seed 0 --host-workers 2`
   as a child process (its brokers `--device cuda`), read from `--out`,
   started first and read last. Every verdict safe, every witnessed
   one acyclic and inside the closure, the append kernels launched in
   every in-process run and the RS kernel in the striped one; (b) the
   trace viewer's live demo (`--host-workers 2 --striped --messages 5`):
   at least 5 produce trees, all but the first covering >= 90% of their
   ack, >= 6 hop kinds with stripe.send and stripe.apply, >= 3 clock
   domains with a worker's; then `--from-json` on those span records
   (the same trees) and on the striped soak verdict; (c) the host-edge
   breakdown (`host_edge.measure`) at `e2e_raw_config`'s full width
   (the broker path's topology, its 3 brokers in this process), with 1
   and 2 host workers: every reference key, every timed term > 0, every
   timed RPC ok; (d) two sealed 64 MiB segments of legacy
   payload-only-CRC round records (B rows of SB bytes) migrated by
   `store_migrate.migrate_store`, then `recover_image` onto the card:
   every record's rows equal on the card, the migration's MB/s;
15. the bench path: the port's bench (`ripplemq_tpu_torch.bench`), every
   phase of the reference's `main()` through `bench._collect` on the card
   at the bench's widths and the reference's CPU-backend depths (48
   launches x 2 windows, A/B 32 launches, baseline 500, spmd parity 32,
   e2e and each host-plane arm 4 s x 1 phase): the sustained engine rate
   at the headline shape (1024 partitions x 5 replicas, slots 12352, B
   256, chain 8: an 8.26 GB ring, wrapping behind staged trims, its tail
   read back), the burst window, the shipped 8 x 3 shape, the
   one-partition baseline, ack latency, the round RTT, the operating
   curve and consume through `DataPlane` at 1024 x 5, B 32; the spmd
   parity A/B (local, spmd fused and spmd legacy on a world of one this
   process forms and leaves, 1024 x R 1, slots 12352, B 256, chain 8)
   and the spmd scaling curve (worlds of 1, 2, 4 and 8 gloo rank
   processes on this card, P 256 sharded, B 64); the fused/packed A/B
   (eight headline engines in turn), the codec, the replication bytes
   (5 in-process brokers, full and striped: the RS kernel), the stripe
   encode, the multi-group drain, the SLO step, the online split, the
   fan-out A/B (a 3-broker process cluster an arm, followers off and on,
   4 and 16 consumers), the control-plane storm (up to 1000 members in
   100 groups), the e2e topology (the controller's BrokerServer on the
   card at 1024 x RF 3, B 512, two standby processes, the clients in two
   torch-free processes) and the host-plane sweep (that topology at 1, 2
   and 4 host workers); each phase's kernel launches (counts zeroed just
   before it, read just after; the launches of child processes are
   theirs), wall time and peak device memory; gates: every
   HEADLINE_GATES figure > 0, the artifact's keys `bench.RESULT_KEYS`,
   every readback verified and count-exact (consume, e2e, each
   host-plane arm, each group, each fan-out consumer with followers
   serving in the ON arms, the split's acked produces), the storm error
   free, the card's name in `card`, the legacy append launched in the
   engine phases and exactly once a round of the parity A/B's three
   bindings, the packed one in the A/B, the e2e phase and the host-plane
   sweep, the RS kernel in the stripe encode and the replication bytes;
   the parity shape's three bindings replaying one seeded chained window
   to byte-identical states; the run's operating curve turned into a
   rails prior and loaded back through the port's `SloController`; then
   the sustained method's host syncs: one headline window under
   `set_sync_debug_mode("warn")`;
16. times: each kernel's device time alone (the profiler's events by
   kernel name) and through its wrapper (CUDA events, after warm-up),
   inputs rotated over 3 buffers so that they come from HBM; ms per
   chained round, the plain versions', `index_put_`'s and a `copy_` of
   the append's byte count, peak device memory, `encode_segment`'s steps
   for one 64 MiB segment and `encode_group`'s rate at the bench's shape;
   the stripe encode at the ladder's 16 KiB and top classes;
17. a JSON line naming each ported kernel (gf_matmul's launches split by
   consumer and by path; the append variants' launches on the dataplane
   path as `launches_dataplane`, on the control path as
   `launches_control`, each kernel's on the broker path as
   `launches_broker` and on the planes path as `launches_planes`, and on
   the lockstep path as `launches_spmd`: the packed append's a rank of
   the lockstep broker; on the
   witness path as `launches_witness`, its seeds' soak runs included,
   which run inside the tools path and are also given alone as
   `launches_witness_seeds`; on the tools path as `launches_tools`,
   the seeds' runs left out; and on the bench path as
   `launches_bench`), then
   the card line again, then the result line
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
import threading
import time
import zlib

# The planes path's controller runs host-plane workers, which are
# spawned: spawn re-runs this script as `__mp_main__` in every worker
# before it unpickles the worker's target, and the workers must stay
# torch-free (as the reference's stay jax-free). That re-run skips these.
if __name__ != "__mp_main__":
    import numpy as np
    import torch

    from ripplemq_tpu_torch import convert
    from ripplemq_tpu_torch.broker import dataplane
    from ripplemq_tpu_torch.broker.hostraft import LEADER, RaftNode, RaftRunner
    from ripplemq_tpu_torch.broker.manager import (
        OP_BATCH,
        OP_SET_STANDBYS,
        OP_SET_TOPICS,
        PartitionManager,
    )
    from ripplemq_tpu_torch.broker.replication import RoundReplicator
    from ripplemq_tpu_torch.broker.server import (
        BrokerServer,
        _ReplStreamGate,
        apply_repl_rounds,
        flush_repl_store,
    )
    from ripplemq_tpu_torch.core.config import ALIGN, ROW_HEADER, EngineConfig
    from ripplemq_tpu_torch.core.encode import decode_entries, row_extents
    from ripplemq_tpu_torch.core.state import StepInput
    from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
    from ripplemq_tpu_torch.metadata.models import (
        BrokerInfo,
        Topic,
        placement_only,
        topics_to_wire,
    )
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
    from ripplemq_tpu_torch.stripes import codec as stripe_codec
    from ripplemq_tpu_torch.stripes.codec import (
        encode_group,
        parse_frame,
        reconstruct_group,
        stripe_assignment,
    )
    from ripplemq_tpu_torch.stripes.recovery import rebuild_records
    from ripplemq_tpu_torch.wire.transport import TcpClient, TcpServer

# Torch-free, so outside the guard: BROKER_SHAPE below derives from it.
from ripplemq_tpu_torch.bench import (  # noqa: E402
    BASE_SHAPE,
    PARITY_SHAPE,
    SHIPPED_SHAPE,
    e2e_raw_config,
)

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
                 errs, name, fresh, need_rows=True) -> int:
    """One append through the kernel and the plain version, the whole logs
    compared; `fresh` = the log pair is new to this case. Returns the rows
    written; fails on none unless not `need_rows`."""
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
    if not equal or (need_rows and rows == 0):
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             f"version (or wrote nothing)")
    return rows


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


CHAOS_ROUNDS = 8  # appends on one log pair, as a chaos run's rounds are


def chaos_engines() -> list:
    """The engines of the small in-process and process clusters the
    paths drive, each derived from the config builder that path calls:
    `run_chaos`'s clusters at its default topic, in-process (the tools
    path's soak runs) and process (the planes path's and the tools
    path's proc soak), and the trace viewer's live demo (the tools
    path's trace, at `make_cluster_config`'s default topics)."""
    import inspect

    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from ripplemq_tpu_torch.chaos.harness import run_chaos
    from ripplemq_tpu_torch.chaos.proc_cluster import make_proc_cluster_config
    from ripplemq_tpu_torch.profiles import trace_view

    kw = inspect.signature(run_chaos).parameters
    topics = (Topic("chaos", kw["partitions"].default,
                    kw["replication"].default),)
    return [("in-process chaos engine",
             make_cluster_config(n_brokers=kw["n_brokers"].default,
                                 topics=topics).engine),
            ("process chaos engine",
             make_proc_cluster_config([0] * kw["n_brokers"].default,
                                      topics=topics).engine),
            ("trace demo engine",
             trace_view.demo_config(**TOOLS_TRACE_DEMO).engine)]


def bench_engines() -> list:
    """The bench's engines too small for the headline case: the shipped
    8 x 3 shape (SB 256) and the one-partition baseline (the bench path
    steps every partition each round, so A = P); then the clusters of the
    slice-J runners, each derived from the config builder its runner
    calls: the replication-bytes brokers' (1 x 3, slots 1024, SB 512,
    B 16), the fan-out's process brokers' (2 x 3, slots 256, SB 64,
    B 16), and the in-process clusters' small engines of the group
    drain (4 x 3), the storm (8 x 3), the SLO step (1 x 1) and the
    split (3 x 3 with its spare slot)."""
    from ripplemq_tpu_torch import bench
    from ripplemq_tpu_torch.chaos.cluster import (
        make_cluster_config,
        small_engine,
    )
    from ripplemq_tpu_torch.chaos.proc_cluster import make_proc_cluster_config

    return [("bench shipped engine", EngineConfig(**SHIPPED_SHAPE)),
            ("bench baseline engine", EngineConfig(**BASE_SHAPE)),
            ("repl_bytes engine", small_engine(1, 3, **bench.REPL_ENGINE)),
            ("consume_fanout engine", make_proc_cluster_config(
                [0] * 3, topics=(Topic("fanout", 2, 3),)).engine),
            ("group_consume engine", make_cluster_config(
                3, topics=(Topic("gbench", 4, 3),)).engine),
            ("control_plane_storm engine", make_cluster_config(
                3, topics=(Topic("storm", 8, 3),)).engine),
            ("slo_convergence engine", make_cluster_config(
                1, topics=(Topic("slobench", 1, 1),)).engine),
            ("split_rebalance engine", make_cluster_config(
                3, topics=(Topic("splitbench", 2, 3),),
                spare_slots=1).engine)]


def scaling_vs_plain(ops, seed) -> dict:
    """Both append variants against the plain version at the spmd scaling
    curve's shard shapes (`profiles.spmd_scaling.SHAPE`: slots 2496, SB
    128, B 64, R 1) at local_P 256 (one rank) and 32 (eight ranks), the
    binding's dense round (A = local_P): windows to the ring's end, every
    base in its last B rows, and entries no replica writes; the whole log
    compared after each."""
    from ripplemq_tpu_torch.profiles.spmd_scaling import SHAPE

    g = torch.Generator(device=DEV).manual_seed(seed + 11)
    errs = {k: 0 for k in KERNELS}
    S, SB, B = SHAPE["slots"], SHAPE["slot_bytes"], SHAPE["max_batch"]
    for local_P in (SHAPE["partitions"], SHAPE["partitions"] // 8):
        shape = _Shape(1, local_P, S, SB, B)
        log_k = torch.empty((1, local_P, S + B, SB), dtype=torch.uint8,
                            device=DEV).random_(generator=g)
        log_p = log_k.clone()
        for kw, label in ((dict(to_ring_end=True), "to the ring end"),
                          (dict(to_ring_end=True, ring_end_only=True),
                           "every base in the ring's last B rows"),
                          (dict(to_ring_end=True, unwritten=local_P // 8),
                           f"{local_P // 8} entries with do_write all 0")):
            for packed in (False, True):
                entries, ids, base, do_write, ext = random_case(
                    g, shape, local_P, **kw)
                name = "append_active_packed" if packed else "append_active"
                _append_case(ops, log_k, log_p, entries, ids, base, do_write,
                             ext if packed else None,
                             f"spmd scaling shard (R=1 P={local_P} S={S} "
                             f"SB={SB} B={B}) A={local_P}, {label}", errs,
                             name, False)
        del log_k, log_p
    return errs


def small_append_vs_plain(ops, seed, engines) -> dict:
    """Both append variants against the plain version at small engines
    (the chaos clusters', the bench's shipped and baseline ones),
    CHAOS_ROUNDS appends on one log pair (bases from -B, windows to the
    ring's end), the whole log compared after each. A = P: with P <= 8
    that is the DataPlane's only active-set bucket."""
    g = torch.Generator(device=DEV).manual_seed(seed + 7)
    errs = {k: 0 for k in KERNELS}
    for label, ec in engines:
        R, P, S, SB, B = (ec.replicas, ec.partitions, ec.slots,
                          ec.slot_bytes, ec.max_batch)
        if P > 8:
            raise AssertionError(f"{label}: P={P} has more than one "
                                 f"active-set bucket")
        for packed in (False, True):
            name = "append_active_packed" if packed else "append_active"
            log_k = torch.empty((R, P, S + B, SB), dtype=torch.uint8,
                                device=DEV).random_(generator=g)
            log_p = log_k.clone()
            rows = 0
            for i in range(CHAOS_ROUNDS):
                entries, ids, base, do_write, ext = random_case(
                    g, ec, P, to_ring_end=True, base_lo=-B)
                rows += _append_case(
                    ops, log_k, log_p, entries, ids, base, do_write,
                    ext if packed else None,
                    f"{label} (R={R} P={P} S={S} SB={SB} B={B} A={P}, "
                    f"bases from -B) round {i}", errs, name, i == 0,
                    need_rows=False)
            if rows == 0:
                raise AssertionError(f"{name} {label}: {CHAOS_ROUNDS} "
                                     f"appends wrote nothing")
    return errs


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
    # The DataPlane's shapes: the dataplane path's 1.36 GB ring and the
    # control path's 0.82 GB one (3 replicas), B = 32, and the broker
    # path's 1.81 GB one (3 replicas, B = 512: 64 KiB entries), at every
    # active-set bucket the batcher pads a round to.
    for path, shape in (("dataplane", DP_SHAPE), ("control", CTRL_SHAPE),
                        ("broker", BROKER_SHAPE)):
        dp_cfg = EngineConfig(**shape)
        log_k = torch.empty((dp_cfg.replicas, dp_cfg.partitions,
                             dp_cfg.slots + dp_cfg.max_batch,
                             dp_cfg.slot_bytes),
                            dtype=torch.uint8, device=DEV).random_(generator=g)
        log_p = log_k.clone()
        for A in DP_BUCKETS:
            for packed in (False, True):
                entries, ids, base, do_write, ext = random_case(
                    g, dp_cfg, A, to_ring_end=True, unwritten=A // 8)
                name = "append_active_packed" if packed else "append_active"
                _append_case(ops, log_k, log_p, entries, ids, base, do_write,
                             ext if packed else None,
                             f"{path} shape (R={dp_cfg.replicas} P="
                             f"{dp_cfg.partitions} S={dp_cfg.slots} B="
                             f"{dp_cfg.max_batch}) A={A}",
                             errs, name, False)
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
    for name, err in small_append_vs_plain(
            ops, seed, chaos_engines() + bench_engines()).items():
        errs[name] = max(errs[name], err)
    for name, err in scaling_vs_plain(ops, seed).items():
        errs[name] = max(errs[name], err)
    return errs


PROFILE_WINDOWS = 3  # profiler windows a kernel time may take


def kernel_only_ms(fn, name: str, reps: int, counter) -> float:
    """Mean device time of one launch of the kernels whose name holds
    `name`, over `reps` calls of `fn` (one launch each), by the
    profiler's device events: only the kernel is in the window, not the
    wrapper's host time nor the gaps between launches. `counter()` reads
    the wrapper's own launch count, which must rise by exactly `reps` in
    every window. Only a window in which the profiler saw exactly one
    such kernel per call is used: a window whose wrapper launched `reps`
    times but whose profiler lost device events (seen once on the card,
    40 of 60) is reported and measured again; fails when PROFILE_WINDOWS
    windows in a row miss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        before = counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = counter() - before
        if launched != reps:
            raise AssertionError(f"the wrapper counted {launched} launches "
                                 f"of a '{name}' kernel in {reps} calls")
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in ev)
        if count == reps:
            return sum(e.self_device_time_total for e in ev) / count / 1e3
        print(f"time: the profiler saw {count} launches of a '{name}' "
              f"kernel in {reps} calls, the wrapper counted {launched}; "
              f"window discarded (the events were lost by the profiler)",
              flush=True)
    raise AssertionError(f"the profiler saw {count} launches of a "
                         f"'{name}' kernel in {reps} calls, "
                         f"{PROFILE_WINDOWS} windows in a row")


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

        kernel_ms = kernel_only_ms(launch, "append_active_kernel", reps=60,
                                   counter=lambda: ops.LAUNCHES[name])
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
RS_LADDER_INV = (2, 3, 4)  # the stripes a 3x3 reconstruct decodes from


def stripe_ladder() -> list:
    """The stripe codec's shard-length classes (`stripes/codec.py`
    `_shard_class`): 512 B steps to 16 KiB, then x1.25 up to the class
    of an 8 MiB group commit's shard (2,840,576 B) — the widths of the
    planes path's encodes and reconstructs."""
    from ripplemq_tpu_torch.stripes.plane import _GROUP_COMMIT_BYTES

    top = stripe_codec._shard_class(-(-_GROUP_COMMIT_BYTES // 3))
    out, c = [], stripe_codec._PACK
    while c <= top:
        out.append(c)
        c = stripe_codec._shard_class(c + 1)
    return out


def rs_widths_vs_plain(widths, seed, label) -> int:
    """The GF(2^8) kernel against its plain version (torch.equal) at
    each width: the stripe encode (2x3) and a 3x3 reconstruct (stripes
    2, 3 and 4 surviving)."""
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    enc, inverses = rs_matrices()
    inv = inverses[RS_LADDER_INV]
    for n in widths:
        s = torch.empty((3, n), dtype=torch.uint8, device=DEV).random_(
            generator=g)
        for name, m in (("encode", enc), ("reconstruct", inv)):
            got, want = rs_ops.gf_matmul(m, s), rs_ops.gf_matmul_plain(m, s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = int((got.to(torch.int16) - want.to(torch.int16))
                          .abs().max())
                raise AssertionError(f"gf_matmul {name} N={n} disagrees "
                                     f"with its plain version "
                                     f"(max_abs_err {err})")
    print(f"kernel-vs-plain: gf_matmul {label}: {len(widths)} widths "
          f"({widths[0]} .. {widths[-1]} B), encode 2x3 and reconstruct "
          f"3x3 each equal, max_abs_err=0", flush=True)
    return 0


def rs_kernel_vs_plain(seed) -> int:
    """The GF(2^8) kernel against its plain version, torch.equal: at a
    sealed 64 MiB segment's shard length with the encode matrix and all
    10 inverses; every pair of input and output row offsets in
    {0, 1, 7, 15} bytes at ragged and small widths and at the full
    width; small odd and aligned widths, the largest tiled matrix, and
    N = 0 (no launch); every class of the stripe ladder, encode and
    reconstruct."""
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
    rs_widths_vs_plain(stripe_ladder(), seed,
                       "the stripe ladder (every shard class)")
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
    beside the plain version and the byte bound; then the stripe encode
    at two of the planes path's widths, the top of the linear ladder
    (16 KiB) and an 8 MiB group commit's class (2,840,576 B), rotated
    over enough inputs (>= 64 MB) to pass the L2 too. No single PyTorch
    call computes a GF(2^8) product, so there is no library time."""
    g = torch.Generator(device=DEV).manual_seed(seed + 4)
    enc, inverses = rs_matrices()
    inv = inverses[(1, 2, 3)]
    aligned_n = -(-SHARD_N // 16) * 16
    ladder = stripe_ladder()
    out = {}
    for label, m, n in (("encode", enc, SHARD_N),
                        ("reconstruct", inv, SHARD_N),
                        ("encode_aligned", enc, aligned_n),
                        ("reconstruct_aligned", inv, aligned_n),
                        ("encode_ladder_16k", enc, 16 << 10),
                        ("encode_ladder_top", enc, ladder[-1])):
        # Enough buffers to pass the 50 MB L2 at every width.
        nrot = max(ROTATE, -(-(64 << 20) // (len(m[0]) * n)))
        rot = [torch.empty((len(m[0]), n), dtype=torch.uint8,
                           device=DEV).random_(generator=g)
               for _ in range(nrot)]
        turn = itertools.count()

        def launch():
            rs_ops.gf_matmul(m, rot[next(turn) % nrot])

        path = "vec16" if n % 16 == 0 else "realign"
        reps = 60 if n > ladder[-1] else 200
        kernel_ms = kernel_only_ms(
            launch, f"gf_matmul_{path}_kernel", reps=reps,
            counter=lambda: rs_ops.LAUNCHES[f"gf_matmul_{path}"])
        wrapper_ms = cuda_time_ms(launch, reps=reps)
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


# ------------------------------------------------ the dataplane path

# The broker's latency shape (bench.py:2503-2506): a 1.36 GB ring log on
# the card and a 268 MB host mirror; plane B reads at the consume
# shape's read_batch (bench.py:2514-2517).
DP_SHAPE = dict(partitions=1024, replicas=5, slots=2048, slot_bytes=128,
                max_batch=32, read_batch=32, max_consumers=64,
                max_offset_updates=8)
DP_PLANES = {  # plane -> (engine flags, store, host mirror, read_batch)
    "A": (dict(), True, True, 32),
    "B": (dict(fused_control=True, packed_writes=True), False, False, 128),
}
DP_KERNEL = {"A": "append_active", "B": "append_active_packed"}
DP_BUCKETS = (8, 32, 128, 512, 1024)  # `DataPlane._active_bucket` at P 1024
LAT_THREADS, LAT_PER_THREAD = 16, 250  # bench.py:425-476
BULK_BATCHES = 4                        # bench.py:495-502 (128 rows)
LAP_PARTS = 4
CONSUMERS = 32
OFFSET_PARTS = 64
PAYLOAD_BYTES = 100                     # bench.py:108
# The round-stage histograms of the plane's metrics: dispatch (host
# launch), commit wait (dispatch -> committed on the host, from the
# dispatch's start), settle-window entry, standby acks, persist, and
# dispatch -> ack release.
STAGES = ("engine.dispatch_us", "settle.commit_wait_us",
          "settle.enter_wait_us", "settle.standby_ack_us",
          "settle.persist_us", "settle.release_us")


def payload(pid: int, seq: int, filler: bytes) -> bytes:
    """A unique 100-byte message: producer id and sequence, then seeded
    filler."""
    head = b"p%05d-s%07d-" % (pid, seq)
    return head + filler[: PAYLOAD_BYTES - len(head)]


class Acked:
    """Every acked message by partition, at its acked offset."""

    def __init__(self, P: int):
        self.by_part = [[] for _ in range(P)]
        self.lock = threading.Lock()

    def add(self, slot: int, base: int, msgs) -> None:
        if base < 0:
            raise AssertionError(f"partition {slot}: ack with base {base}")
        with self.lock:
            self.by_part[slot].extend((base + i, m) for i, m in enumerate(msgs))

    def count(self) -> int:
        return sum(len(v) for v in self.by_part)


def consume_all(dp, acked: Acked, rotate: bool, start=None) -> tuple:
    """CONSUMERS threads walk every partition from `start` (0) through
    `dp.read`, continuing from next_offset; each answer must be exactly
    the acked messages whose offsets lie in [offset, next_offset), in
    offset order, so every acked message comes back once, byte-exact, at
    its acked offset. `rotate` moves the serving replica to the next one
    on every call. Returns (messages read, seconds)."""
    P, R = dp.cfg.partitions, dp.cfg.replicas
    got = [0] * CONSUMERS
    errors = []

    def walk(p: int) -> int:
        want = sorted(m for m in acked.by_part[p]
                      if start is None or m[0] >= start[p])
        off = 0 if start is None else int(start[p])
        i = n = calls = 0
        while True:
            replica = (p + calls) % R if rotate else 0
            msgs, nxt = dp.read(p, off, replica=replica)
            calls += 1
            if nxt == off:
                break
            j = i
            while j < len(want) and want[j][0] < nxt:
                j += 1
            if msgs != [m for _, m in want[i:j]] or (
                    i < j and want[i][0] < off):
                raise AssertionError(
                    f"partition {p}: read({off}) -> {len(msgs)} messages "
                    f"to {nxt}, acked {j - i} in that window")
            n += len(msgs)
            i, off = j, nxt
        if i != len(want):
            raise AssertionError(f"partition {p}: read {i} of "
                                 f"{len(want)} acked messages")
        return n

    def worker(tid: int) -> None:
        try:
            got[tid] = sum(walk(p) for p in range(tid, P, CONSUMERS))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(CONSUMERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"consume failed: {errors[:3]}")
    return sum(got), secs


def check_device_ring(dp, acked_sets, term, label) -> int:
    """Every acked message still in the ring (offset >= max(log_end -
    slots, trim)), read from the device log on EVERY replica, must be
    exactly its packed row: length, term, payload, zeros; on a plane
    with the host mirror, the mirror's row too. `term` is the rows' term:
    one int, or one per set of `acked_sets`, each an int or a [P] array
    of per-partition terms. Reads served from the mirror or the store
    never look at the device log, so this is what holds the append
    launches of those phases to what was acked. Returns the rows checked
    on each replica."""
    cfg = dp.cfg
    S, SB = cfg.slots, cfg.slot_bytes
    terms = term if isinstance(term, list) else [term] * len(acked_sets)
    terms = [np.broadcast_to(np.asarray(t), (cfg.partitions,))
             for t in terms]
    parts, offs, msgs, row_terms = [], [], [], []
    for p in range(cfg.partitions):
        lo = max(dp.log_end(p) - S, int(dp.trim[p]))
        for acked, t in zip(acked_sets, terms):
            for off, m in acked.by_part[p]:
                if off >= lo:
                    parts.append(p)
                    offs.append(off)
                    msgs.append(m)
                    row_terms.append(int(t[p]))
    n = len(msgs)
    want = np.zeros((n, SB), np.uint8)
    want[:, 0:4] = np.array([len(m) for m in msgs], "<i4").view(
        np.uint8).reshape(n, 4)
    want[:, 4:8] = np.array(row_terms, "<i4").view(np.uint8).reshape(n, 4)
    for i, m in enumerate(msgs):
        want[i, ROW_HEADER:ROW_HEADER + len(m)] = np.frombuffer(m, np.uint8)
    p_idx, pos = np.asarray(parts, np.int64), np.asarray(offs, np.int64) % S
    with dp._device_lock:
        got = dp._state.log_data[:, torch.as_tensor(p_idx, device=DEV),
                                 torch.as_tensor(pos, device=DEV)].cpu().numpy()
    for r in range(got.shape[0]):
        bad = np.flatnonzero((got[r] != want).any(axis=1))
        if bad.size:
            raise AssertionError(
                f"{label}: replica {r}'s device log differs from the acked "
                f"row at {bad.size} of {n} offsets, first (partition, "
                f"offset) {[(parts[i], offs[i]) for i in bad[:4]]}")
    if dp._host_ring is not None:
        bad = np.flatnonzero((dp._host_ring[p_idx, pos] != want).any(axis=1))
        if bad.size:
            raise AssertionError(
                f"{label}: the host mirror differs from the acked row at "
                f"{bad.size} of {n} offsets")
    print(f"{label}: {n} acked rows in the ring equal on all "
          f"{got.shape[0]} replicas of the device log"
          f"{' and in the host mirror' if dp._host_ring is not None else ''}",
          flush=True)
    return n


def hist_window(h, before):
    """p50, p99 (log2-bucket upper bounds) and the exact mean of the
    observations a histogram took since `before` = (bins, count,
    total)."""
    bins = [a - b for a, b in zip(h.bins, before[0])]
    count, total = h.count - before[1], h.total - before[2]
    if count == 0:
        return 0, 0, 0.0

    def q(x):
        seen = 0
        for i, b in enumerate(bins):
            seen += b
            if seen >= x * count:
                return 1 << i
        return h.max

    return q(0.5), q(0.99), total / count


def hist_mark(h):
    return list(h.bins), h.count, h.total


def produce_latency(dp, acked, rng_seed) -> dict:
    """LAT_THREADS threads x LAT_PER_THREAD single-message submits, each
    awaited before the next, at seeded random partitions."""
    P = dp.cfg.partitions
    lats, errors = [], []
    hists = {s: dp.metrics.histogram(s) for s in STAGES}
    marks = {s: hist_mark(h) for s, h in hists.items()}

    def worker(tid):
        try:
            rng = np.random.default_rng(rng_seed * 1000 + tid)
            filler = rng.integers(0, 256, PAYLOAD_BYTES, dtype=np.uint8).tobytes()
            for seq, slot in enumerate(rng.integers(0, P, LAT_PER_THREAD)):
                m = payload(tid, seq, filler)
                t0 = time.perf_counter()
                base = dp.submit_append(int(slot), [m]).result(timeout=120)
                lats.append(time.perf_counter() - t0)
                acked.add(int(slot), base, [m])
        except Exception as e:
            errors.append((tid, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(LAT_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if errors or len(lats) != LAT_THREADS * LAT_PER_THREAD:
        raise AssertionError(f"latency producers failed: {errors[:3]}")
    a = np.asarray(lats) * 1e3
    stages = {s: hist_window(h, marks[s]) for s, h in hists.items()}
    d50, d99, dmean = stages["engine.dispatch_us"]
    w50, _, wmean = stages["settle.commit_wait_us"]
    return dict(appends_per_s=len(lats) / secs, p50_ms=float(np.percentile(a, 50)),
                p99_ms=float(np.percentile(a, 99)),
                p999_ms=float(np.percentile(a, 99.9)),
                dispatch_us_p50=d50, dispatch_us_p99=d99,
                dispatch_us_mean=dmean, commit_wait_us_p50=w50,
                commit_wait_us_mean=wmean,
                stage_means_us={s.split(".")[1][:-3]: round(v[2], 1)
                                for s, v in stages.items()})


def produce_bulk(dp, acked, parts, batches, pid0, rng_seed) -> dict:
    """`batches` batches of max_batch messages on every partition of
    `parts`, all submitted before any is awaited."""
    B = dp.cfg.max_batch
    rng = np.random.default_rng(rng_seed)
    filler = rng.integers(0, 256, PAYLOAD_BYTES, dtype=np.uint8).tobytes()
    r0, d0 = dp.rounds, dp.dispatches
    t0 = time.perf_counter()
    subs = []
    for k in range(batches):
        for p in parts:
            msgs = [payload(pid0 + p, k * B + i, filler) for i in range(B)]
            subs.append((p, msgs, dp.submit_append(p, msgs)))
    for p, msgs, fut in subs:
        acked.add(p, fut.result(timeout=600), msgs)
    secs = time.perf_counter() - t0
    rounds, disp = dp.rounds - r0, dp.dispatches - d0
    return dict(messages=len(subs) * B, appends_per_s=len(subs) * B / secs,
                rounds=rounds, dispatches=disp,
                rounds_per_dispatch=rounds / max(1, disp), seconds=secs)


def dp_plane(plane, cfg, store_dir):
    _, with_store, mirror, _ = DP_PLANES[plane]
    store = (SegmentStore(store_dir, segment_bytes=SEG_BYTES, erasure=True)
             if with_store else None)
    # No `device`: the plane runs on CUDA (it raises without a GPU).
    return dataplane.DataPlane(cfg, store=store, durability="async",
                               host_read_cache=mirror), store


def count_calls(obj, name):
    """Count calls of `obj.name` (an instance attribute wrapper)."""
    real = getattr(obj, name)
    calls = [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    setattr(obj, name, wrapped)
    return calls


def dataplane_plane(plane, seed, card, workdir) -> dict:
    """One plane of the dataplane path, traffic 1-8 (see the module
    docstring); raises on any failed check."""
    flags, with_store, mirror, read_batch = DP_PLANES[plane]
    cfg = EngineConfig(**{**DP_SHAPE, "read_batch": read_batch}, **flags)
    P, B = cfg.partitions, cfg.max_batch
    store_dir = os.path.join(workdir, f"dp-store-{plane}")
    dp, store = dp_plane(plane, cfg, store_dir)
    planes = [dp]
    dp.start()
    out = {}
    try:
        won = dp.elect({p: (0, 1) for p in range(P)})
        if not all(won.values()):
            raise AssertionError(f"plane {plane}: election lost "
                                 f"{[p for p, w in won.items() if not w][:8]}")
        for p in range(P):
            dp.set_leader(p, 0, 1)
        dp.warm(buckets=(8, 32))
        torch.cuda.synchronize()

        append_ops.reset_launches()
        acked = Acked(P)
        out["latency"] = produce_latency(dp, acked, seed)
        out["bulk"] = produce_bulk(dp, acked, range(P), BULK_BATCHES, 10_000,
                                   seed + 1)
        ring_rows = [check_device_ring(
            dp, [acked], 1, f"dataplane path: plane {plane} after the bulk")]
        if with_store:
            lap = cfg.slots // B + 8  # past `slots` rows a partition
            out["lap"] = produce_bulk(dp, acked, range(LAP_PARTS), lap,
                                      20_000, seed + 2)
            trims = [int(t) for t in dp.trim[:LAP_PARTS]]
            if min(trims) <= 0:
                raise AssertionError(f"plane {plane}: trim never rose {trims}")
            out["lap"]["trim"] = trims
            ring_rows.append(check_device_ring(
                dp, [acked], 1,
                f"dataplane path: plane {plane} after the ring lap"))
        # Offset commits: 64 consumer slots on each of 64 partitions,
        # max_offset_updates at a time.
        rng = np.random.default_rng(seed + 3)
        vals = rng.integers(0, 1 << 30, size=(OFFSET_PARTS, cfg.max_consumers))
        U = cfg.max_offset_updates
        futs = [dp.submit_offsets(p, [(c, int(vals[p, c]))
                                      for c in range(c0, c0 + U)])
                for p in range(OFFSET_PARTS)
                for c0 in range(0, cfg.max_consumers, U)]
        if not all(f.result(timeout=120) is True for f in futs):
            raise AssertionError(f"plane {plane}: an offset commit failed")
        bad = [(p, c) for p in range(OFFSET_PARTS)
               for c in range(cfg.max_consumers)
               if dp.read_offset(p, c) != int(vals[p, c])]
        if bad:
            raise AssertionError(f"plane {plane}: read_offset differs at {bad[:4]}")

        store_reads = count_calls(dp, "_read_store")
        h0, d0 = dp.read_cache_hits, dp.read_dispatches
        n_read, secs = consume_all(dp, acked, rotate=not mirror)
        if n_read != acked.count():
            raise AssertionError(f"plane {plane}: read {n_read} of "
                                 f"{acked.count()} acked messages")
        out["consume"] = dict(messages=n_read, msgs_per_s=n_read / secs,
                              mirror_hits=dp.read_cache_hits - h0,
                              read_dispatches=dp.read_dispatches - d0,
                              store_reads=store_reads[0])
        if not mirror and out["consume"]["read_dispatches"] == 0:
            raise AssertionError(f"plane {plane}: no device read dispatched")

        if with_store:
            # Restart: recover the store and install into a fresh plane.
            dp.stop()
            store.close()
            t0 = time.perf_counter()
            gaps, pids = {}, {}
            image = dataplane.recover_image(cfg, store_dir, gaps_out=gaps,
                                            pid_tab_out=pids)
            dp, store = dp_plane(plane, cfg, store_dir)
            planes.append(dp)
            dp.install(image, settled_gaps=gaps, pid_table=pids)
            torch.cuda.synchronize()
            restart_s = time.perf_counter() - t0
            del image
            dp.start()
            for p in range(P):
                dp.set_leader(p, 0, 1)
            n_again, secs_again = consume_all(dp, acked, rotate=False)
            if n_again != acked.count():
                raise AssertionError(f"plane {plane}: after restart read "
                                     f"{n_again} of {acked.count()}")
            ends = [dp.log_end(p) for p in range(P)]
            after = Acked(P)
            out["after_restart"] = produce_bulk(dp, after, range(P), 1,
                                                30_000, seed + 4)
            n_new, _ = consume_all(dp, after, rotate=False, start=ends)
            if n_new != after.count():
                raise AssertionError(f"plane {plane}: new batch read "
                                     f"{n_new} of {after.count()}")
            ring_rows.append(check_device_ring(
                dp, [acked, after], 1,
                f"dataplane path: plane {plane} after the restart"))
            out["restart"] = dict(recover_install_s=restart_s,
                                  reread=n_again, reread_s=secs_again,
                                  new_read=n_new)
        torch.cuda.synchronize()
        out["launches"] = dict(append_ops.LAUNCHES)
        out["rounds"] = sum(d.rounds for d in planes)
        out["dispatches"] = sum(d.dispatches for d in planes)
        out["acked"] = acked.count()
        out["ring_rows"] = ring_rows
        out["step_errors"] = sum(d.step_errors for d in planes)
    finally:
        dp.stop()
        if store is not None:
            store.close()
    name = DP_KERNEL[plane]
    if out["step_errors"]:
        raise AssertionError(f"plane {plane}: {out['step_errors']} step errors")
    if not out["launches"][name] >= out["rounds"] > 0:
        raise AssertionError(f"plane {plane}: {out['launches']} launches for "
                             f"{out['rounds']} rounds")
    lat, bulk, con = out["latency"], out["bulk"], out["consume"]
    text = (f"dataplane path: plane {plane} ({'legacy, store + mirror' if with_store else 'fused+packed, device reads'}, "
            f"P={P} R={cfg.replicas} slots={cfg.slots} B={B} RB={cfg.read_batch}): "
            f"latency {lat['appends_per_s']:.1f} appends/s, ack p50 "
            f"{lat['p50_ms']:.3f} p99 {lat['p99_ms']:.3f} p999 "
            f"{lat['p999_ms']:.3f} ms, engine.dispatch_us p50 "
            f"{lat['dispatch_us_p50']} p99 {lat['dispatch_us_p99']} mean "
            f"{lat['dispatch_us_mean']:.1f}, settle.commit_wait_us p50 "
            f"{lat['commit_wait_us_p50']} mean {lat['commit_wait_us_mean']:.1f}, "
            f"stage means us {lat['stage_means_us']}; "
            f"bulk {bulk['messages']} msgs {bulk['appends_per_s']:.1f} appends/s "
            f"in {bulk['rounds']} rounds / {bulk['dispatches']} dispatches "
            f"({bulk['rounds_per_dispatch']:.2f} rounds/dispatch); ")
    if "lap" in out:
        text += (f"ring lap {out['lap']['messages']} msgs on {LAP_PARTS} "
                 f"partitions, trim {out['lap']['trim']}; ")
    text += (f"consume {con['messages']} msgs {con['msgs_per_s']:.1f} msgs/s "
             f"(mirror hits {con['mirror_hits']}, read_dispatches "
             f"{con['read_dispatches']}, store reads {con['store_reads']}"
             f"{', replica rotated over all ' + str(cfg.replicas) if not mirror else ''}); "
             f"offsets {OFFSET_PARTS}x{cfg.max_consumers} via read_offset ok; ")
    if "restart" in out:
        rs = out["restart"]
        text += (f"restart: recover_image + install {rs['recover_install_s']:.3f} s, "
                 f"{rs['reread']} msgs re-read exactly, one more batch on "
                 f"every partition read back ({rs['new_read']}); ")
    text += (f"device log rows checked on every replica {out['ring_rows']}; "
             f"{out['acked']} acked = read back; {name} launches "
             f"{out['launches'][name]} >= {out['rounds']} rounds "
             f"({out['dispatches']} dispatches) [{card}]")
    print(text, flush=True)
    return out


def dataplane_path(seed, card, workdir) -> dict:
    """Both planes, one after the other (each frees its 1.36 GB log)."""
    res = {}
    for plane in DP_PLANES:
        res[plane] = dataplane_plane(plane, seed, card, workdir)
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------ phase 9: the control path

# Five brokers, the reference's docker-compose roster
# (examples/cluster.yaml:15-19), on free loopback ports; two topics at
# replication factor 3 (examples/cluster.yaml:21-23), scaled from 3 to
# 512 partitions each to fill the broker's 1024 partition slots; the
# engine at the broker's latency shape (bench.py:2503-2506) with the
# replica axis cut from 5 to the topics' replication factor
# (examples/cluster.yaml:35-36); the in-process timings of
# ripplemq_tpu/chaos/cluster.py:52-54; 2 standbys (the default).
CTRL_BROKERS = 5
CTRL_TOPICS = (("topic1", 512, 3), ("topic2", 512, 3))
CTRL_SHAPE = {**DP_SHAPE, "replicas": 3}
CTRL_TIMINGS = dict(election_timeout_s=0.1, metadata_election_timeout_s=0.6,
                    membership_poll_s=0.2, rpc_timeout_s=5.0)
CTRL_TICK_S = 0.05      # BrokerServer's default metadata tick
CTRL_WAIT_S = 30.0      # bound of every wait of the phase
CTRL_CHUNK = 512        # leader adverts per OP_BATCH (BrokerServer's chunk)


def wait_for(pred, what: str, timeout_s: float = CTRL_WAIT_S):
    """Poll `pred` until it returns a true value, which is returned;
    raises after `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError(f"control path: {what} not within {timeout_s} s")
        time.sleep(0.005)


class CtrlBroker:
    """One broker of the control path: a TCP server on a free loopback
    port, the metadata Raft (`RaftNode` + `RaftRunner` over `TcpClient`,
    wired as BrokerServer wires them), its `PartitionManager` as the
    state machine, and a segment store that takes the standby stream.

    The standby side of the stream is the port server's own:
    `apply_repl_rounds` with a `_ReplStreamGate`, then
    `flush_repl_store` (no data plane, follower plane or span ring on a
    broker of this path)."""

    def __init__(self, bid: int, workdir: str) -> None:
        self.id = self.broker_id = bid
        self.server = TcpServer("127.0.0.1", 0, self.dispatch)
        self.store_dir = os.path.join(workdir, f"ctrl-broker-{bid}")
        self.store = self.runner = self.manager = self.client = None
        self.config = None
        self.applied = {}  # raft index -> (host time, command, apply s)
        self.repl_gate = _ReplStreamGate()
        self.repl_last_flush = 0.0
        self.up = False

    def boot(self, config, addr_of) -> None:
        self.config = config
        self.manager = PartitionManager(self.id, config)
        etick = max(2, round(config.metadata_election_timeout_s / CTRL_TICK_S))
        node = RaftNode(self.id, config.broker_ids(), apply_fn=self.apply,
                        snapshot_fn=self.manager.snapshot,
                        restore_fn=self.manager.restore,
                        election_ticks=(etick, 2 * etick),
                        seed=self.id * 7919, compact_threshold=256)
        self.client = TcpClient()
        self.runner = RaftRunner(node, self.client, addr_of=addr_of,
                                 tick_interval_s=CTRL_TICK_S,
                                 rpc_timeout_s=min(1.0, config.rpc_timeout_s))
        self.store = SegmentStore(self.store_dir, segment_bytes=SEG_BYTES,
                                  erasure=True)
        self.server.start()
        self.runner.start()
        self.up = True

    def apply(self, index: int, cmd: dict) -> None:
        t0 = time.perf_counter()
        self.manager.apply(index, cmd)
        t1 = time.perf_counter()
        self.applied[index] = (t1, cmd, t1 - t0)

    def is_leader(self) -> bool:
        with self.runner.lock:
            return self.runner.node.role == LEADER

    def dispatch(self, req: dict) -> dict:
        kind = req.get("type", "")
        if kind.startswith("raft."):
            return self.runner.handle_rpc(req)
        if kind == "repl.rounds":
            return self.repl_rounds(req)
        return {"ok": False, "error": f"unknown request type {kind!r}"}

    def repl_rounds(self, req: dict) -> dict:
        refusal = apply_repl_rounds(req, self.manager, self.store,
                                    self.repl_gate)
        if refusal is not None:
            return refusal
        self.repl_last_flush = flush_repl_store(
            self.store, self.config.durability == "strict",
            self.repl_last_flush)
        return {"ok": True}

    def stop(self) -> None:
        if self.up:
            self.up = False
            self.runner.stop()
            self.server.stop()
            self.client.close()
        if self.store is not None:
            self.store.close()
            self.store = None


class MetaRaft:
    """The five brokers' metadata Raft as the phase drives it: proposals
    at the leader, each waited for until every live broker applied it."""

    def __init__(self, brokers) -> None:
        self.brokers = brokers
        self.commit_s = []  # propose -> applied on every live broker
        self.apply_s = []   # the applies' summed host time on those brokers

    def live(self):
        return [b for b in self.brokers if b.up]

    def leader(self) -> CtrlBroker:
        return wait_for(lambda: next((b for b in self.live()
                                      if b.is_leader()), None),
                        "a metadata leader")

    def propose(self, cmd: dict, what: str) -> None:
        leader = self.leader()
        t0 = time.perf_counter()
        index = leader.runner.propose(cmd)
        if index is None:
            raise AssertionError(f"control path: {what}: leader "
                                 f"{leader.id} refused the proposal")
        live = self.live()
        wait_for(lambda: all(index in b.applied for b in live),
                 f"{what} (raft index {index}) applied on brokers "
                 f"{[b.id for b in live]}")
        for b in live:
            if b.applied[index][1] != cmd:
                raise AssertionError(f"control path: {what}: broker {b.id} "
                                     f"applied another command at {index}")
        self.commit_s.append(max(b.applied[index][0] for b in live) - t0)
        self.apply_s.append(sum(b.applied[index][2] for b in live))

    def same_snapshots(self, what: str) -> None:
        snaps = [b.manager.snapshot() for b in self.live()]
        if any(s != snaps[0] for s in snaps[1:]):
            raise AssertionError(f"control path: {what}: the managers' "
                                 f"snapshots differ")


def leaderless(m) -> int:
    live = set(m.live)
    return sum(a.leader is None or a.leader not in live
               for t in m.topics for a in t.assignments)


def ctrl_elect(meta: MetaRaft, m, what: str) -> int:
    """One election pass of the controller duty over every leaderless
    partition: `plan_elections` (log ends and device terms read off the
    card), `DataPlane.elect`, the winners' adverts proposed in OP_BATCH
    chunks. Returns the winners; every partition has a leader after."""
    want = leaderless(m)
    if want == 0:
        return 0
    cands = {}
    deadline = time.monotonic() + CTRL_WAIT_S
    while len(cands) < want:  # the first pass stamps the debounce
        cands, drafts = m.plan_elections()
        if len(cands) < want:
            if time.monotonic() > deadline:
                raise TimeoutError(f"control path: {what}: {len(cands)} of "
                                   f"{want} leaderless partitions electable")
            time.sleep(0.02)
    won = m.dataplane.elect(cands)
    lost = [s for s, w in won.items() if not w]
    if lost:
        raise AssertionError(f"control path: {what}: lost {lost[:8]}")
    adverts = [drafts[s] for s in sorted(won)]
    for i in range(0, len(adverts), CTRL_CHUNK):
        meta.propose({"op": OP_BATCH, "cmds": adverts[i:i + CTRL_CHUNK]},
                     f"{what}: leader adverts")
    if leaderless(m) or (m.dataplane.leader < 0).any():
        raise AssertionError(f"control path: {what}: partitions without a "
                             f"leader after the adverts")
    return len(adverts)


def ctrl_plane(config, store, m, sender_id: int):
    """A DataPlane on CUDA for the controller's manager `m`, streaming
    every committed round to the standby set through a RoundReplicator
    (its replicate_fn, begin/wait split wired as BrokerServer wires it).
    Not attached, not started."""
    dp = dataplane.DataPlane(config.engine, store=store, durability="async",
                             host_read_cache=True)
    rep = RoundReplicator(
        TcpClient(), lambda b: config.broker(b).address,
        epoch_fn=m.current_epoch, members_fn=m.current_standbys,
        active_fn=lambda: m.current_controller() == sender_id,
        rpc_timeout_s=min(2.0, config.rpc_timeout_s),
        ack_timeout_s=config.rpc_timeout_s, metrics=dp.metrics,
        sender_id=sender_id, pipeline_depth=config.repl_pipeline_depth)
    dp.replicate_fn = rep.replicate
    dp.replicate_begin_fn = rep.begin
    dp.replicate_wait_fn = rep.wait
    return dp, rep


RESYNC_RANGE = "chip_smoke.resync"


def timed_resyncs(dp):
    """Wrap `dp.resync` to time each call with CUDA events on the current
    stream, recorded around the call: a wall window that holds the device
    work and any gap while the host enqueues it. Each call also runs in a
    profiler range, which `ResyncProfile` reads for the device time.
    Returns the list of (partitions, ms)."""
    from torch.profiler import record_function

    real, times = dp.resync, []

    def resync(src, dst, slots):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with record_function(RESYNC_RANGE):
            start.record()
            real(src, dst, slots)
            end.record()
        end.synchronize()
        times.append((len(slots), start.elapsed_time(end)))

    dp.resync = resync
    return times


class ResyncProfile:
    """The profiler over a window of the run, on every thread (the
    resyncs run on the Raft apply thread of the controller's broker):
    `device_ms()` gives the device time of the kernels and copies that
    each `timed_resyncs` range launched, by the profiler's device events.
    Where this torch cannot profile other threads, or the profiler saw
    no device time, `device_ms()` is None: not measured."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            from torch._C._profiler import _ExperimentalConfig
            self.prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
        except (ImportError, TypeError):
            self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        return self.prof.__exit__(*exc)

    def device_ms(self, calls: int):
        from torch.autograd import DeviceType

        ranges = [e for e in self.prof.events()
                  if e.name == RESYNC_RANGE
                  and e.device_type == DeviceType.CPU]
        ms = [e.device_time_total / 1e3 for e in ranges]
        if len(ms) != calls or not all(t > 0 for t in ms):
            return None
        return ms


def ctrl_standby_digest(store) -> list:
    store.flush()
    return [(t, s, b, zlib.crc32(p)) for t, s, b, p in store.scan()]


def control_path(seed, card, workdir) -> dict:
    """Phase 9 (see the module docstring): the PartitionManagers of five
    brokers on one metadata Raft over TCP, the controller's manager
    electing and resyncing a DataPlane of 1024 partitions x 3 replicas on
    the card, every round streamed to two standbys before its ack; a
    broker lost, the controller lost and a standby promoted. Cuts: the
    topics' 3 partitions scaled to 512 each, the replica axis cut to 3,
    the broker's duty loops played by this function, the broker loss
    committed as a live-set advance and then the re-placement, a drill
    of the form the broker commits only when RF cannot be met (step 6).
    The standbys answer the stream with the port's own handler."""
    t_phase = time.perf_counter()
    brokers = [CtrlBroker(i, workdir) for i in range(CTRL_BROKERS)]
    config = ClusterConfig(
        brokers=tuple(BrokerInfo(b.id, "127.0.0.1", b.server.port)
                      for b in brokers),
        topics=tuple(Topic(*t) for t in CTRL_TOPICS),
        engine=EngineConfig(**CTRL_SHAPE), segment_bytes=SEG_BYTES,
        durability="async", standby_count=2, **CTRL_TIMINGS)
    cfg, P = config.engine, config.engine.partitions
    addr_of = lambda b: config.broker(b).address  # noqa: E731
    meta = MetaRaft(brokers)
    planes, reps, out = [], [], {}
    try:
        # 1. boot
        for b in brokers:
            b.boot(config, addr_of)
        leader = meta.leader()
        print(f"control path: boot: {CTRL_BROKERS} brokers, metadata Raft "
              f"over loopback TCP, leader broker {leader.id} after "
              f"{time.perf_counter() - t_phase:.3f} s", flush=True)
        # 2. assignment
        live = [b.id for b in brokers]
        meta.propose(leader.manager.plan_assignment(live), "assignment")
        meta.same_snapshots("assignment")
        print(f"control path: assignment of {P} partitions over {live} "
              f"applied on all {len(live)} brokers, equal snapshots, in "
              f"{meta.commit_s[-1] * 1e3:.3f} ms", flush=True)
        # 3. attach, standbys caught up and admitted
        ctrl = brokers[config.controller]
        m0 = ctrl.manager
        dp, rep = ctrl_plane(config, ctrl.store, m0, ctrl.id)
        planes.append(dp)
        reps.append(rep)
        m0.attach_dataplane(dp)
        dp.start()
        dp.warm(buckets=(8, 32))
        resyncs = timed_resyncs(dp)
        t0 = time.perf_counter()
        while (cand := m0.plan_standby_add(config.standby_count)) is not None:
            rep.catchup(cand, ctrl.store, timeout_s=CTRL_WAIT_S)
            meta.propose({"op": OP_SET_STANDBYS, "epoch": m0.current_epoch(),
                          "standbys": sorted({*m0.current_standbys(), cand})},
                         f"standby {cand} admitted")
            rep.finish_join(cand)
        standbys = m0.current_standbys()
        if len(standbys) != config.standby_count:
            raise AssertionError(f"control path: standbys {standbys}")
        print(f"control path: attach: DataPlane on {dp.device} (P={P} "
              f"R={cfg.replicas} slots={cfg.slots} B={cfg.max_batch}) "
              f"under broker {ctrl.id}'s manager, standbys {list(standbys)} "
              f"caught up and admitted in {time.perf_counter() - t0:.3f} s",
              flush=True)
        # 4. elections of every partition
        t0 = time.perf_counter()
        n = ctrl_elect(meta, m0, "elections")
        if n != P:
            raise AssertionError(f"control path: {n} of {P} elected")
        print(f"control path: elections: {n} partitions elected in one "
              f"vote round and advertised through Raft in "
              f"{time.perf_counter() - t0:.3f} s; every partition has a "
              f"leader", flush=True)
        # 5. traffic, each ack after both standbys acked the round
        append_ops.reset_launches()
        acked = Acked(P)
        hists = {s: dp.metrics.histogram(s)
                 for s in ("repl.frame_us", "repl.group_rounds")}
        marks = {s: hist_mark(h) for s, h in hists.items()}
        out["latency"] = lat = produce_latency(dp, acked, seed + 10)
        repl = {s: hist_window(h, marks[s])[2] for s, h in hists.items()}
        marks = {s: hist_mark(h) for s, h in hists.items()}
        out["bulk"] = bulk = produce_bulk(dp, acked, range(P), BULK_BATCHES,
                                          10_000, seed + 11)
        repl_bulk = {s: hist_window(h, marks[s])[2]
                     for s, h in hists.items()}
        rows = [check_device_ring(dp, [acked], 1,
                                  "control path: after the bulk")]
        want = sorted(ctrl_standby_digest(ctrl.store))
        for s in standbys:
            if sorted(ctrl_standby_digest(brokers[s].store)) != want:
                raise AssertionError(f"control path: standby {s}'s store "
                                     f"differs from the controller's")
        print(f"control path: traffic with the standby stream: "
              f"{lat['appends_per_s']:.1f} single-message appends/s, ack "
              f"p50 {lat['p50_ms']:.3f} p99 {lat['p99_ms']:.3f} p999 "
              f"{lat['p999_ms']:.3f} ms, stage means us "
              f"{lat['stage_means_us']}; bulk {bulk['messages']} msgs "
              f"{bulk['appends_per_s']:.1f} appends/s "
              f"({bulk['rounds_per_dispatch']:.2f} rounds/dispatch); "
              f"repl.frame_us mean {repl['repl.frame_us']:.1f} single / "
              f"{repl_bulk['repl.frame_us']:.1f} bulk, repl.group_rounds "
              f"mean {repl['repl.group_rounds']:.2f} / "
              f"{repl_bulk['repl.group_rounds']:.2f}; "
              f"{len(want)} records equal in the stores of the controller "
              f"and standbys {list(standbys)}", flush=True)
        # 6. broker loss, as a drill of the placement-kept form. The
        # reference's metadata duty (server.py _metadata_leader_duty)
        # commits a loss as ONE plan_assignment while the live brokers
        # can meet RF: b's slots pass to live brokers in place, keep
        # their rows (every replica lives on this card), and nothing
        # comes alive behind a leader, so nothing is resynced. It commits
        # the live-set advance with the placement kept only when RF
        # cannot be met (plan_assignment's ValueError branch), which here
        # takes 3 brokers lost and the metadata Raft's quorum with them.
        # To drive `_resync_slots`, the phase commits that form itself:
        # the placement-kept advance (b's slots dead, a batch a partition
        # at quorum 2 of 3), then the re-placement computed at the loss,
        # whose apply revives b's slots on live brokers and resyncs them.
        # Figures: loss -> every partition led again; re-placement ->
        # plan_repairs() == {}. The script's batch is in neither window.
        lead_id = meta.leader().id
        b = next(x for x in (3, 4) if x != lead_id and x not in standbys)
        held = sum(b in a.replicas for t in m0.topics for a in t.assignments)
        t_loss = time.perf_counter()
        brokers[b].stop()
        live = [x for x in live if x != b]
        leader = meta.leader()
        replace = leader.manager.plan_assignment(live)
        meta.propose({"op": OP_SET_TOPICS, "live": live,
                      "topics": topics_to_wire(placement_only(m0.topics))},
                     f"broker {b}'s loss (live-set advance, placement kept)")
        dead = int((~dp.alive).sum())
        n_reelect = ctrl_elect(meta, m0, f"re-elections after broker {b}")
        led_s = time.perf_counter() - t_loss
        terms2 = dp.term.copy()
        during = Acked(P)
        produce_bulk(dp, during, range(P), 1, 40_000, seed + 12)
        before = len(resyncs)
        with ResyncProfile() as prof:
            t_replace = time.perf_counter()
            meta.propose(replace, f"re-placement after broker {b}'s loss")
            wait_for(lambda: m0.plan_repairs() == {}, "plan_repairs() == {}")
            repaired_s = time.perf_counter() - t_replace
        done = resyncs[before:]
        if not done:
            raise AssertionError("control path: the re-placement resynced "
                                 "nothing")
        device_ms = prof.device_ms(len(done))
        del prof
        after = Acked(P)
        produce_bulk(dp, after, range(P), 1, 50_000, seed + 13)
        rows.append(check_device_ring(
            dp, [acked, during, after], [1, terms2, terms2],
            "control path: after the resync"))
        meta.same_snapshots(f"after broker {b}'s loss")
        out["loss"] = dict(broker=b, replicas_held=held, dead_cells=dead,
                           reelected=n_reelect, resyncs=done,
                           resync_device_ms=device_ms, led_s=led_s,
                           replace_to_repaired_s=repaired_s)
        dev_text = ("not measured (the profiler saw no device time in "
                    "the resyncs' ranges)" if device_ms is None else
                    f"{sum(device_ms):.3f} ms "
                    f"({', '.join(f'{ms:.3f}' for ms in device_ms)})")
        print(f"control path: broker {b} lost (held a replica of {held} of "
              f"{P} partitions), committed as the placement-kept live-set "
              f"advance: {dead} replica slots dead, {n_reelect} partitions "
              f"re-elected, loss -> every partition led again in "
              f"{led_s:.3f} s; one batch a partition acked at quorum 2 of 3; "
              f"the re-placement revived b's slots: {len(done)} resync "
              f"calls over {sum(k for k, _ in done)} partitions on the card, "
              f"device time (profiler events) {dev_text}, wall window (CUDA "
              f"events around each call) "
              f"{sum(ms for _, ms in done):.3f} ms "
              f"({', '.join(f'{ms:.3f}' for _, ms in done)}); re-placement "
              f"-> plan_repairs() == {{}} in {repaired_s:.3f} s (profiler "
              f"on); one more batch a partition acked", flush=True)
        # 7. every acked message read back exactly once, byte-exact
        everything = Acked(P)
        for part in (acked, during, after):
            for p in range(P):
                everything.by_part[p].extend(part.by_part[p])
        n_read, secs = consume_all(dp, everything, rotate=False)
        if n_read != everything.count():
            raise AssertionError(f"control path: read {n_read} of "
                                 f"{everything.count()}")
        print(f"control path: read back {n_read} acked messages exactly in "
              f"{secs:.3f} s", flush=True)
        # 8. promotion: the controller lost, standby 1 promoted
        t_promote = time.perf_counter()
        rounds = dp.rounds
        dp.stop()
        rep.stop()
        ctrl.stop()
        new = brokers[min(standbys)]
        new.store.close()
        gaps, pids = {}, {}
        image = dataplane.recover_image(cfg, new.store_dir, gaps_out=gaps,
                                        pid_tab_out=pids)
        image = type(image)(*(t.to(DEV) for t in image))  # held on the card
        new.store = SegmentStore(new.store_dir, segment_bytes=SEG_BYTES,
                                 erasure=True)
        live = [x for x in live if x != ctrl.id]
        leader = meta.leader()
        meta.propose(leader.manager.plan_controller(live), "promotion")
        m1 = new.manager
        if m1.current_controller() != new.id:
            raise AssertionError(f"control path: controller "
                                 f"{m1.current_controller()}, not {new.id}")
        dp1, rep1 = ctrl_plane(config, new.store, m1, new.id)
        planes.append(dp1)
        reps.append(rep1)
        dp1.install(image, settled_gaps=gaps, pid_table=pids)
        del image
        m1.attach_dataplane(dp1)
        dp1.start()
        meta.propose(meta.leader().manager.plan_assignment(live),
                     f"re-placement after broker {ctrl.id}'s loss")
        n_promo = ctrl_elect(meta, m1, "elections on the promoted plane")
        ends = [dp1.log_end(p) for p in range(P)]
        last = Acked(P)
        produce_bulk(dp1, last, range(P), 1, 60_000, seed + 14)
        promote_s = time.perf_counter() - t_promote
        n_new, _ = consume_all(dp1, last, rotate=False, start=ends)
        for p in range(P):
            everything.by_part[p].extend(last.by_part[p])
        n_again, _ = consume_all(dp1, everything, rotate=False)
        if n_again != everything.count() or n_new != last.count():
            raise AssertionError(f"control path: promoted plane read "
                                 f"{n_again} of {everything.count()} and "
                                 f"{n_new} of {last.count()}")
        torch.cuda.synchronize()
        launches = dict(append_ops.LAUNCHES)
        rounds += dp1.rounds
        meta.same_snapshots("after the promotion")
        out["promotion"] = dict(promote_s=promote_s, reelected=n_promo,
                                reread=n_again, new_read=n_new)
        print(f"control path: promotion: broker {ctrl.id} lost, broker "
              f"{new.id} promoted (epoch {m1.current_epoch()}) from its "
              f"standby store (recover_image, the image moved to the card, "
              f"install), {n_promo} partitions elected; serving again "
              f"{promote_s:.3f} s after the loss; one more batch a "
              f"partition acked ({n_new} read back) and all {n_again} acked "
              f"messages read back from the promoted plane", flush=True)
        if sum(d.step_errors for d in planes):
            raise AssertionError("control path: step errors")
        # Both planes bind the legacy append: every round launches it, and
        # the packed variant never runs on this path.
        if not launches["append_active"] >= rounds > 0 \
                or launches["append_active_packed"] != 0:
            raise AssertionError(f"control path: append launches {launches} "
                                 f"for {rounds} rounds of the legacy binding")
        out["launches_control"] = launches
        out["rounds"] = rounds
        commit = np.asarray(meta.commit_s) * 1e3
        applies = np.asarray(meta.apply_s) * 1e3
        print(f"control path: done in {time.perf_counter() - t_phase:.1f} s: "
              f"metadata commit (propose -> applied on every live broker) "
              f"mean {commit.mean():.3f} max {commit.max():.3f} ms over "
              f"{commit.size} proposals, of which the live brokers' applies "
              f"(summed, one GIL) mean {applies.mean():.3f} max "
              f"{applies.max():.3f} ms; append launches {launches} "
              f"(append_active >= {rounds} rounds); device log rows checked "
              f"on every replica {rows} [{card}]", flush=True)
    finally:
        for d in planes:
            d.stop()
        for r in reps:
            r.stop()
        for b in brokers:
            b.stop()
    return out


# ------------------------------------------------ phase 10: the broker path

# bench.py's end-to-end topology (`_run_e2e`, bench.py:1057-1110) with its
# cluster config, unchanged: the port's one copy of it,
# `ripplemq_tpu_torch.bench.e2e_raw_config` (bench.py:794-850).
# 3 brokers on loopback TCP, topic "bench" of 1024 partitions at RF 3,
# the controller's engine 1024 x 3 (slots 4608, B 512, SB 128,
# fused_control and packed_writes, settle_window 8), a data_dir (an
# erasure-coded SegmentStore at the default 64 MiB segments) on every
# broker.
BROKER_TOPIC = "bench"
BROKER_SHAPE = e2e_raw_config([])["engine"]


def broker_raw_config(ports) -> dict:
    """The broker path's cluster config, as the broker CLI loads it:
    `e2e_raw_config(ports)` (BROKER_SHAPE is its engine, which a CPU
    rehearsal may shrink)."""
    raw = e2e_raw_config(ports, partitions=BROKER_SHAPE["partitions"])
    raw["engine"] = dict(BROKER_SHAPE)
    return raw


def topology_digest() -> str:
    """The sha256 of the broker path's config at fixed ports: the planes
    and lockstep paths build on it, so one digest shows them unchanged."""
    ports = [9000, 9001, 9002]
    raw = broker_raw_config(ports)
    if raw != e2e_raw_config(ports):
        raise AssertionError("broker_raw_config differs from e2e_raw_config")
    return hashlib.sha256(json.dumps(raw, sort_keys=True).encode()).hexdigest()


BROKER_LAT = (16, 250)        # awaited single-message producers x messages
# The broker path's own depth, cut (16 x 250 -> 16 x 64 singles, 2 -> 1
# sealed segments of bulk) when the bench path, whose e2e phase boots the
# same topology, joined the whole run: it keeps the run inside its time.
BROKER_PATH_LAT = (16, 64)
BROKER_PRODUCERS = 8          # windowed bulk producers (bench.py:1057)
BROKER_WINDOW = 16            # batches in flight per producer
BROKER_SEALED = 1             # sealed 64 MiB segments the bulk must fill
BROKER_AFTER_BATCHES = 16     # bulk batches per producer after the failover
BROKER_CONSUMERS = 16         # consumer threads (auto-commit)
BROKER_WAIT_S = 300.0         # bound of every wait of the phase
# bench.py's _DECOMPOSITION_STAGES: the produce ack's stages, as the
# controller's telemetry attributes them.
E2E_STAGES = ("engine.dispatch_us", "settle.commit_wait_us",
              "settle.enter_wait_us", "settle.standby_ack_us",
              "settle.persist_us", "settle.release_us", "store.append_us",
              "store.fsync_us", "repl.frame_us", "repl.group_rounds",
              "engine.chain_rounds")


def broker_bulk_batches(raw) -> int:
    """Bulk batches per producer: enough full batches (B rows of SB bytes
    in the store each) for BROKER_SEALED + 1/4 segments (was + 1), so
    that at least BROKER_SEALED of them seal."""
    e = raw["engine"]
    seg = raw.get("segment_bytes", SEG_BYTES)
    total = -(-(4 * BROKER_SEALED + 1) * seg
              // (4 * e["max_batch"] * e["slot_bytes"]))
    return -(-total // BROKER_PRODUCERS)


def run_threads(what: str, n: int, work) -> float:
    """`work(tid)` on n threads; the seconds until all ended. Raises if
    one raised or did not end within BROKER_WAIT_S."""
    errors = []

    def worker(tid):
        try:
            work(tid)
        except Exception as e:
            errors.append((tid, repr(e)))

    ts = [threading.Thread(target=worker, args=(t,), daemon=True)
          for t in range(n)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=BROKER_WAIT_S)
    secs = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        raise AssertionError(f"{what} failed: {errors[:3]}")
    return secs


def broker_client_main(spec_path: str) -> int:
    """The broker and planes paths' client process (`chip_smoke.py
    --broker-client SPEC`): the port's ProducerClient and ConsumerClient,
    driven phase by phase over a line protocol on stdin/stdout (LAT, BULK
    n, BULKR n, DRAIN tag [ref | follower], COMMITTED tag, BEHIND tag,
    PROBE [live], EXIT -> `RESULT <json>`), as bench.py's `_e2e_client_main` runs them. It
    keeps every acked message at its acked offset and checks each read
    against them."""
    from ripplemq_tpu_torch.client.consumer import ConsumerClient
    from ripplemq_tpu_torch.client.metadata import MetadataManager
    from ripplemq_tpu_torch.client.producer import ProduceError, ProducerClient
    from ripplemq_tpu_torch.wire.transport import TcpClient

    class ReferenceCommits(ConsumerClient):
        """The JAX package's pipelined auto-commit, for the commit A/B
        only: a newer commit of a partition goes out while older ones
        are in flight, so the broker's worker pool may apply them out of
        order (ROADMAP.md §3). The port's `_auto_commit` waits for the
        previous one."""

        def _auto_commit(self, topic, pid, offset, addr, call_async):
            if self.prefetch <= 0 or call_async is None:
                self.commit(topic, pid, offset)
                return
            key = (topic, pid)
            prev = self._commits.get(key)
            if prev is not None and prev[1].done():
                self._commits.pop(key, None)
                try:
                    ok = bool(prev[1].result(timeout=0).get("ok"))
                except Exception:
                    ok = False
                if not ok:
                    self.commit(topic, pid, max(int(prev[0]), int(offset)))
                    return
            fut = call_async(addr, {
                "type": "offset.commit", "topic": topic, "partition": pid,
                "consumer": self.consumer_id, "offset": int(offset)})
            self._commits[key] = (int(offset), fut, addr)

    with open(spec_path) as f:
        spec = json.load(f)
    boot, P, seed = spec["bootstrap"], int(spec["partitions"]), spec["seed"]
    B, read_batch = int(spec["max_batch"]), int(spec["read_batch"])
    # The follower drain's answer size: below read_batch, so that a
    # partition takes several answers and the readahead after a full one
    # goes to a leased follower (the client's routing rule).
    drain_max = int(spec.get("drain_max", read_batch))
    acked = Acked(P)
    committed = {}  # drain tag -> {partition: the offset its reader committed}
    bulk_round = [0]

    def lat() -> dict:
        threads, per = spec.get("lat", BROKER_LAT)
        lats = []

        def worker(tid):
            pc = ProducerClient(boot, rpc_timeout_s=120.0)
            try:
                rng = np.random.default_rng(seed * 1000 + tid)
                filler = rng.integers(0, 256, PAYLOAD_BYTES,
                                      dtype=np.uint8).tobytes()
                for seq, p in enumerate(rng.integers(0, P, per)):
                    m = payload(tid, seq, filler)
                    t0 = time.perf_counter()
                    base = pc.produce(BROKER_TOPIC, m, partition=int(p))
                    lats.append(time.perf_counter() - t0)
                    acked.add(int(p), base, [m])
            finally:
                pc.close()

        secs = run_threads("latency producers", threads, worker)
        a = np.asarray(lats) * 1e3
        return dict(messages=len(lats), appends_per_s=len(lats) / secs,
                    p50_ms=float(np.percentile(a, 50)),
                    p99_ms=float(np.percentile(a, 99)),
                    p999_ms=float(np.percentile(a, 99.9)))

    def bulk(batches: int) -> dict:
        k0 = bulk_round[0]
        bulk_round[0] += batches

        def worker(tid):
            pc = ProducerClient(boot, rpc_timeout_s=120.0)

            def wait(p, msgs, w) -> int:
                """The batch's base offset. A batch refused because its
                broker's host worker died (a typed refusal: the batch
                never reached the data plane) is sent again, as a
                windowed sender does."""
                deadline = time.monotonic() + BROKER_WAIT_S
                while True:
                    try:
                        return w()
                    except ProduceError as e:
                        if (not str(e).startswith("worker_unavailable")
                                or time.monotonic() > deadline):
                            raise
                    time.sleep(0.2)
                    w = pc.produce_batch_async(BROKER_TOPIC, msgs,
                                               partition=p)

            try:
                rng = np.random.default_rng(seed * 7919 + tid)
                filler = rng.integers(0, 256, PAYLOAD_BYTES,
                                      dtype=np.uint8).tobytes()
                pending = collections.deque()
                for k in range(k0, k0 + batches):
                    while len(pending) >= BROKER_WINDOW:
                        p, msgs, w = pending.popleft()
                        acked.add(p, wait(p, msgs, w), msgs)
                    p = (tid + BROKER_PRODUCERS * k) % P
                    msgs = [payload(100 + tid, k * B + i, filler)
                            for i in range(B)]
                    pending.append((p, msgs, pc.produce_batch_async(
                        BROKER_TOPIC, msgs, partition=p)))
                while pending:
                    p, msgs, w = pending.popleft()
                    acked.add(p, wait(p, msgs, w), msgs)
            finally:
                pc.close()

        secs = run_threads("bulk producers", BROKER_PRODUCERS, worker)
        n = BROKER_PRODUCERS * batches * B
        return dict(messages=n, appends_per_s=n / secs, seconds=secs)

    def bulk_retried(batches: int) -> dict:
        """BULK without the window: each producer sends one batch at a
        time and retries it under one (pid, seq) until it is acked (the
        producer's idempotent retries), so a failover in the middle
        loses nothing and duplicates nothing. Returns each ack's wall
        time, for the lockstep drill's kill -> serving figure."""
        from ripplemq_tpu_torch.wire.retry import RetryPolicy

        k0 = bulk_round[0]
        bulk_round[0] += batches
        acks = []

        def worker(tid):
            pc = ProducerClient(boot, rpc_timeout_s=30.0, retry_policy=(
                RetryPolicy(max_attempts=10 ** 6, base_backoff_s=0.2,
                            max_backoff_s=1.0, deadline_s=BROKER_WAIT_S)))
            try:
                rng = np.random.default_rng(seed * 7919 + tid)
                filler = rng.integers(0, 256, PAYLOAD_BYTES,
                                      dtype=np.uint8).tobytes()
                for k in range(k0, k0 + batches):
                    p = (tid + BROKER_PRODUCERS * k) % P
                    msgs = [payload(100 + tid, k * B + i, filler)
                            for i in range(B)]
                    acked.add(p, pc.produce_batch(BROKER_TOPIC, msgs,
                                                  partition=p), msgs)
                    acks.append(time.time())
            finally:
                pc.close()

        secs = run_threads("retried bulk producers", BROKER_PRODUCERS, worker)
        n = BROKER_PRODUCERS * batches * B
        return dict(messages=n, appends_per_s=n / secs, seconds=secs,
                    ack_times=sorted(acks))

    def drain(tag: str, logic: str = "port") -> dict:
        """Every partition read from 0 by a consumer with auto-commit:
        each answer must be exactly the acked messages in [offset,
        next_offset), so every acked message comes back once, byte-exact,
        at its acked offset. `logic` "ref": the reference's commits;
        "follower": `follower_reads=True` consumers reading `drain_max`
        messages an answer (counting the answers followers served)."""
        client = ReferenceCommits if logic == "ref" else ConsumerClient
        follower = logic == "follower"
        ends = {}
        got = [0] * BROKER_CONSUMERS
        answers = [0] * BROKER_CONSUMERS
        by_follower = [0] * BROKER_CONSUMERS

        def walk(cc, p: int, tid: int) -> int:
            want = sorted(acked.by_part[p])
            i = n = 0
            off = 0
            ends[p] = 0  # where the reader committed: the end of its last
            #              answer with messages (auto-commit skips empty ones)
            for _ in range(len(want) + 64):
                msgs, pp, start, nxt = cc.consume_with_position(
                    BROKER_TOPIC, partition=p)
                answers[tid] += 1
                by_follower[tid] += cc.last_from_follower
                # A read may start below `off` only across a gap the
                # reader already passed: a follower answers a gap with
                # an empty advance, which commits nothing, so a leader
                # read after it starts at the committed offset, below
                # the gap. It must re-deliver no acked message.
                if pp != p or start > off or (
                        start < off and i and want[i - 1][0] >= start):
                    raise AssertionError(f"partition {p}: read at {start} "
                                         f"(partition {pp}), expected {off}")
                if not msgs and nxt <= off:
                    break
                j = i
                while j < len(want) and want[j][0] < nxt:
                    j += 1
                if msgs != [m for _, m in want[i:j]]:
                    raise AssertionError(
                        f"partition {p}: read({off}) -> {len(msgs)} messages "
                        f"to {nxt}, acked {j - i} in that window")
                n += len(msgs)
                i, off = j, nxt
                if msgs:
                    ends[p] = nxt
            if i != len(want):
                raise AssertionError(f"partition {p}: read {i} of "
                                     f"{len(want)} acked messages")
            return n

        def worker(tid):
            kw = dict(follower_reads=True) if follower else {}
            cc = client(boot, f"chip-{tag}-{tid}",
                        max_messages=drain_max if follower else read_batch,
                        rpc_timeout_s=60.0, prefetch=1, **kw)
            try:
                got[tid] = sum(walk(cc, p, tid)
                               for p in range(tid, P, BROKER_CONSUMERS))
            finally:
                cc.close()  # flushes the in-flight auto-commits

        secs = run_threads("consumers", BROKER_CONSUMERS, worker)
        if sum(got) != acked.count():
            raise AssertionError(f"read {sum(got)} of {acked.count()}")
        committed[tag] = ends
        return dict(messages=sum(got), msgs_per_s=sum(got) / secs,
                    seconds=secs, answers=sum(answers),
                    follower_answers=sum(by_follower))

    def committed_offsets(tag: str) -> list:
        """(partition, committed as the brokers answer it, committed by
        the reads) where the two differ."""
        wrong = []
        for tid in range(BROKER_CONSUMERS):
            cc = ConsumerClient(boot, f"chip-{tag}-{tid}", auto_commit=False,
                                rpc_timeout_s=60.0)
            try:
                for p in range(tid, P, BROKER_CONSUMERS):
                    _, _, off, _ = cc.consume_with_position(
                        BROKER_TOPIC, partition=p, max_messages=0)
                    if off != committed[tag][p]:
                        wrong.append((p, off, committed[tag][p]))
            finally:
                cc.close()
        return wrong

    def check_committed(tag: str) -> dict:
        """Each consumer's committed offset on each of its partitions, as
        the brokers answer it, equals the offset its reads committed."""
        wrong = committed_offsets(tag)
        if wrong:
            raise AssertionError(f"committed offsets differ (partition, "
                                 f"read, committed): {wrong[:8]}")
        return dict(partitions=len(committed[tag]))

    def behind(tag: str) -> dict:
        """How many partitions' committed offsets the brokers hold behind
        what the reads committed (the commit A/B's count, not a check)."""
        wrong = committed_offsets(tag)
        return dict(partitions=len(committed[tag]), behind=sum(
            1 for _, got, want in wrong if got < want), differ=len(wrong))

    def probe(live: bool = False) -> dict:
        """After the controller's loss: wait until every partition is led
        by a live broker and a produce is acked again (`live`: the first
        broker is alive, so only the produce is waited for)."""
        deadline = time.monotonic() + BROKER_WAIT_S
        if live:
            return produce_one(deadline)
        t = TcpClient()
        meta = MetadataManager(t, boot, refresh_interval_s=3600,
                               rpc_timeout_s=5.0)
        dead = boot[0]
        deadline = time.monotonic() + BROKER_WAIT_S
        try:
            while True:
                try:
                    meta.refresh()
                    top = meta.topic(BROKER_TOPIC)
                    if top is not None and all(
                            a.leader is not None
                            and meta.leader_addr(BROKER_TOPIC,
                                                 a.partition_id) != dead
                            for a in top.assignments):
                        break
                except Exception:
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError("no leaders after the failover")
                time.sleep(0.2)
        finally:
            meta.close()
            t.close()
        return produce_one(deadline)

    probes = [0]

    def produce_one(deadline) -> dict:
        pc = ProducerClient(boot, rpc_timeout_s=60.0)
        m = payload(99, probes[0], b"x" * PAYLOAD_BYTES)
        probes[0] += 1
        try:
            while True:
                try:
                    acked.add(0, pc.produce(BROKER_TOPIC, m, partition=0),
                              [m])
                    return dict(ok=True, acked_at=time.time())
                except Exception:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
        finally:
            pc.close()

    print("READY", flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if not cmd:
            continue
        if cmd[0] == "EXIT":
            break
        try:
            res = {"LAT": lambda: lat(), "BULK": lambda: bulk(int(cmd[1])),
                   "DRAIN": lambda: drain(*cmd[1:3]),
                   "COMMITTED": lambda: check_committed(cmd[1]),
                   "BEHIND": lambda: behind(cmd[1]),
                   "BULKR": lambda: bulk_retried(int(cmd[1])),
                   "PROBE": lambda: probe(cmd[1:] == ["live"])}[cmd[0]]()
        except Exception as e:
            print("ERROR " + repr(e)[:2000], flush=True)
            return 1
        print("RESULT " + json.dumps(res), flush=True)
    return 0


class BrokerClients:
    """The broker path's client process and its line protocol."""

    def __init__(self, spec: dict, workdir: str) -> None:
        spec_path = os.path.join(workdir, "clients.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        self.log_path = os.path.join(workdir, "clients.log")
        with open(self.log_path, "wb") as log:
            # Its own interpreter (not a fork: CUDA is initialised here).
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--broker-client", spec_path],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                text=True, bufsize=1, cwd=os.path.dirname(
                    os.path.abspath(__file__)))
        self.expect("READY")

    def expect(self, tag: str) -> str:
        line = (self.proc.stdout.readline() or "").strip()
        if not line.startswith(tag):
            with open(self.log_path) as f:
                tail = f.read()[-2000:]
            raise AssertionError(f"broker path: the client process answered "
                                 f"{line[:2000]!r}, wanted {tag}; its "
                                 f"stderr ends {tail!r}")
        return line[len(tag):].strip()

    def run(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return json.loads(self.expect("RESULT "))

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("EXIT\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=30)
            except Exception:
                self.proc.kill()
                self.proc.wait(timeout=30)


def store_digest(store_dir) -> collections.Counter:
    from ripplemq_tpu_torch.storage.segment import scan_store

    return collections.Counter((t, s, b, zlib.crc32(p))
                               for t, s, b, p in scan_store(store_dir))


def start_topology(raw, root, what):
    """bench.py's end-to-end topology from the raw config `raw` (three
    brokers): the port's BrokerServer 0 as the controller in this
    process on the card, brokers 1 and 2 standby processes (`python -m
    ripplemq_tpu_torch.broker --device cuda`) started through the port's
    ProcCluster from its own config file; returns (config, standbys,
    controller) once every partition is led and both standbys joined,
    with the plane warmed. Stops what it started if that fails."""
    from ripplemq_tpu_torch.chaos.proc_cluster import ProcCluster
    from ripplemq_tpu_torch.metadata.cluster_config import (
        load_cluster_config,
        parse_cluster_config,
    )

    t0 = time.perf_counter()
    config = parse_cluster_config(raw)
    cfg, P = config.engine, config.engine.partitions
    # The standbys' config file must load as the controller's config, or
    # a promoted standby would boot another engine.
    standbys = ProcCluster(config=config, data_dir=root, device=DEV)
    if load_cluster_config(standbys.config_path) != config:
        raise AssertionError(f"{what}: the standbys' config file differs "
                             f"from the controller's config")
    controller = None
    try:
        controller = BrokerServer(0, config, net=None,
                                  data_dir=os.path.join(root, "broker-0"),
                                  device=DEV)
        controller.start()
        for b in (1, 2):
            standbys.restart(b)  # a fresh broker process; 0 is this one
        m0 = controller.manager

        def ready():
            dp = controller.dataplane
            tops = m0.get_topics()
            return (dp is not None and tops
                    and len(m0.current_standbys()) == config.standby_count
                    and all(a.leader is not None
                            for t in tops for a in t.assignments))

        wait_for(ready, f"{what}: every partition led and both standbys "
                 f"joined", BROKER_WAIT_S)
        dp = controller.dataplane
        if dp.device.type != torch.device(DEV).type:
            raise AssertionError(f"{what}: plane on {dp.device}")
        dp.warm(buckets=dp.all_buckets())
        wt = controller._warm_thread
        if wt is not None:
            wt.join(timeout=BROKER_WAIT_S)
    except BaseException:
        if controller is not None:
            controller.stop()
        standbys.stop()
        raise
    leaders = collections.Counter(a.leader for t in m0.get_topics()
                                  for a in t.assignments)
    print(f"{what}: boot: controller BrokerServer 0 on {dp.device} "
          f"(P={P} R={cfg.replicas} slots={cfg.slots} B={cfg.max_batch} "
          f"SB={cfg.slot_bytes}, fused_control + packed_writes), standby "
          f"processes 1, 2 (--device {DEV}) joined "
          f"{list(m0.current_standbys())}, leaders {dict(leaders)}, warmed, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return config, standbys, controller


def broker_path(seed, card, workdir, commit_ab=False) -> dict:
    """Phase 10 (see the module docstring): the port's BrokerServer as
    the controller in this process on the card, two standby broker
    processes (`python -m ripplemq_tpu_torch.broker --device cuda`), the
    port's clients in a child process; traffic, read-back, a controller
    failover, read-back again. No cut to the topology.

    `commit_ab`: after the first drain, drain everything again with the
    reference's auto-commit (consumer set r), then with the port's (c),
    and report both rates and how many partitions r left committed at an
    older offset."""
    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports
    from ripplemq_tpu_torch.storage.segment import list_segment_files

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "broker-path")
    raw = broker_raw_config(free_ports(3))
    config, standbys, controller = start_topology(raw, root, "broker path")
    cfg, P = config.engine, config.engine.partitions
    ctrl_dir = os.path.join(root, "broker-0")
    clients = None
    out = {}
    try:
        dp = controller.dataplane
        clients = BrokerClients(dict(
            bootstrap=[b.address for b in config.brokers], partitions=P,
            max_batch=cfg.max_batch, read_batch=cfg.read_batch, seed=seed,
            lat=list(BROKER_PATH_LAT)), root)
        batches = broker_bulk_batches(raw)
        # The main path: counts zeroed just before, read just after.
        append_ops.reset_launches()
        rs_ops.reset_launches()
        r0 = dp.rounds
        out["latency"] = lat = clients.run("LAT")
        out["bulk"] = bulk = clients.run(f"BULK {batches}")
        out["drain"] = drain = clients.run("DRAIN a")
        clients.run("COMMITTED a")
        hists = controller.dispatch(
            {"type": "admin.metrics"})["metrics"]["histograms"]
        stages = {s: hists[s]["mean"] for s in E2E_STAGES if s in hists}
        out["stages"] = stages
        print(f"broker path: traffic: {lat['appends_per_s']:.1f} "
              f"single-message appends/s ({BROKER_PATH_LAT[0]} x "
              f"{BROKER_PATH_LAT[1]} awaited), ack p50 {lat['p50_ms']:.3f} p99 "
              f"{lat['p99_ms']:.3f} p999 {lat['p999_ms']:.3f} ms; bulk "
              f"{bulk['messages']} msgs ({BROKER_PRODUCERS} producers x "
              f"{batches} batches of {cfg.max_batch}, window "
              f"{BROKER_WINDOW}) {bulk['appends_per_s']:.1f} appends/s; "
              f"consume {drain['messages']} msgs {drain['msgs_per_s']:.1f} "
              f"msgs/s, every acked message once, byte-exact, at its acked "
              f"offset; committed offsets equal; stage means us {stages} "
              f"[{card}]", flush=True)
        if commit_ab:
            ref = clients.run("DRAIN r ref")
            ref_behind = clients.run("BEHIND r")
            port = clients.run("DRAIN c")
            clients.run("COMMITTED c")
            out["commit_ab"] = dict(port=[drain, port], ref=ref,
                                    ref_behind=ref_behind)
            print(f"broker path: commit A/B (prefetch 1, {BROKER_CONSUMERS} "
                  f"consumers, {drain['messages']} msgs each drain): port's "
                  f"one commit in flight a partition {drain['msgs_per_s']:.1f}"
                  f" then {port['msgs_per_s']:.1f} msgs/s, committed offsets "
                  f"equal; reference's pipelined commits "
                  f"{ref['msgs_per_s']:.1f} msgs/s, between them, "
                  f"{ref_behind['behind']} of {ref_behind['partitions']} "
                  f"partitions left committed behind the reads "
                  f"({ref_behind['differ']} differ) [{card}]", flush=True)
        # (d) the controller lost: a standby promotes, boots its plane on
        # the card from its store (replay_records + install), serves.
        rounds = dp.rounds - r0
        t_loss = time.perf_counter()
        controller.stop()
        out["probe"] = clients.run("PROBE")
        promote_s = time.perf_counter() - t_loss
        launches = dict(append_ops.LAUNCHES)
        rs_launch = dict(rs_ops.LAUNCHES)
        after = clients.run(f"BULK {BROKER_AFTER_BATCHES}")
        clients.run("COMMITTED a")
        reread = clients.run("DRAIN b")
        clients.run("COMMITTED b")
        out["promotion"] = dict(promote_s=promote_s, after=after,
                                reread=reread)
        print(f"broker path: failover: controller 0 stopped; a standby "
              f"promoted, booted its plane (--device {DEV}) and every "
              f"partition "
              f"led by a live broker with a produce acked "
              f"{promote_s:.3f} s after the loss; {after['messages']} more "
              f"msgs {after['appends_per_s']:.1f} appends/s; all "
              f"{reread['messages']} acked messages read back exactly from "
              f"the promoted controller ({reread['msgs_per_s']:.1f} msgs/s); "
              f"committed offsets of both consumer sets equal [{card}]",
              flush=True)
        clients.close()
        standbys.stop()
        booted = [b for b in (1, 2) if "booting data plane as controller"
                  in open(os.path.join(root, f"broker-{b}.log")).read()]
        if len(booted) != 1:
            raise AssertionError(f"broker path: standbys {booted} booted a "
                                 f"plane; exactly one should have")
        # Stores: every sealed segment RS-protected, both standbys hold
        # every record of the controller's.
        names = list_segment_files(os.path.join(ctrl_dir, "segments"))
        sealed = names[:-1]
        shards = {n: valid_shards(os.path.join(ctrl_dir, "segments"), n)
                  for n in sealed}
        if len(sealed) < BROKER_SEALED or any(v != 5 for v in
                                              shards.values()):
            raise AssertionError(f"broker path: sealed segments {shards}")
        if rs_launch["gf_matmul"] < len(sealed):
            raise AssertionError(f"broker path: {rs_launch} RS launches for "
                                 f"{len(sealed)} sealed segments")
        want = store_digest(os.path.join(ctrl_dir, "segments"))
        for b in (1, 2):
            have = store_digest(standbys.store_dir(b))
            if want - have:
                raise AssertionError(f"broker path: standby {b}'s store "
                                     f"lacks {sum((want - have).values())} "
                                     f"of the controller's records")
        if not launches["append_active_packed"] >= rounds > 0 \
                or launches["append_active"] != 0:
            raise AssertionError(f"broker path: append launches {launches} "
                                 f"for {rounds} rounds of fused + packed")
        out.update(launches_broker=launches, rs_broker=rs_launch,
                   rounds=rounds, sealed=len(sealed), promoted=booted[0])
        print(f"broker path: done in {time.perf_counter() - t_phase:.1f} s: "
              f"{len(sealed)} sealed {config.segment_bytes / 2**20:g} MiB "
              f"segments on the controller, 5 "
              f"CRC-valid shards each, RS launches {rs_launch}; the "
              f"standbys' stores hold all {sum(want.values())} controller "
              f"records; append launches {launches} (packed >= {rounds} "
              f"rounds of the controller) [{card}]", flush=True)
    finally:
        if clients is not None:
            clients.close()
        if controller is not None and not controller.stopped:
            controller.stop()
        standbys.stop()
    return out


# ------------------------------------------------ the planes path

# bench.py's e2e topology with slice E's planes on: the 5-broker roster
# of examples/cluster.yaml:15-19 (controller + 4 standbys, the shape of
# bench.py's _run_repl_bytes, :2145-2177), striped replication,
# follower reads (the consume_fanout arm, bench.py:1806-1811) and two
# host workers a broker (the host-plane sweep's axis, bench.py:1408).
PLANES_BROKERS = 5
PLANES_STANDBYS = 4
PLANES_HOST_WORKERS = 2
# Depth cut to make room for the bench path's slice-J phases: was 96 bulk
# batches a producer, 16 after the failover and 16 x 250 singles.
PLANES_LAT = (16, 64)         # awaited single-message producers x messages
PLANES_BATCHES = 32           # bulk batches per producer
PLANES_AFTER_BATCHES = 8      # bulk batches per producer after the failover
PLANES_DRAIN_MAX = 256        # messages a follower-drain answer
# The stripe sender's stages beside bench.py's: encode, one repl.stripes
# frame round trip (the striped twin of repl.frame_us), rounds a group.
PLANES_STAGES = E2E_STAGES + ("stripes.encode_us", "stripes.frame_us",
                              "stripes.group_rounds")
# (e): the reference's steady proc seed (tests/test_proc_chaos.py:27) on
# the card, striped, with follower reads and host workers.
PLANES_CHAOS = dict(seed=0, phases=1, phase_s=0.8, ops_per_phase=2,
                    backend="proc", replication_mode="striped",
                    follower_reads=True, host_workers=2,
                    converge_timeout_s=120.0)
TORCH_LIBS = ("libtorch", "libc10", "jaxlib", "xla_extension")


def planes_raw_config(ports) -> dict:
    """The planes path's cluster config, as the broker CLI loads it."""
    raw = broker_raw_config(ports)
    raw.update(host_workers=PLANES_HOST_WORKERS, replication="striped",
               standby_count=PLANES_STANDBYS, follower_reads=True)
    return raw


def mapped_libs(pid: int) -> list:
    """The torch or JAX shared objects mapped into process `pid`, read
    from outside it (/proc/<pid>/maps)."""
    with open(f"/proc/{pid}/maps") as f:
        paths = {line.split()[-1] for line in f if "/" in line}
    return sorted(p for p in paths
                  if any(lib in os.path.basename(p) for lib in TORCH_LIBS))


def child_pids(pid: int) -> list:
    out = []
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                out += [int(c) for c in f.read().split()]
        except OSError:
            pass
    return out


def worker_boot_ms(hp, t0: float) -> list:
    """Each host worker's boot: ms from `t0` until it answers a ping."""
    out = []
    for w in hp._workers:
        while True:
            try:
                w.request({"op": "ping"}, 0.5)
                break
            except Exception:
                if time.perf_counter() - t0 > BROKER_WAIT_S:
                    raise
                time.sleep(0.005)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def log_ts(path: str, needle: str) -> float:
    """The epoch time of the first JSON log line whose message holds
    `needle`."""
    with open(path) as f:
        for line in f:
            if needle in line:
                try:
                    return float(json.loads(line)["ts"])
                except (ValueError, KeyError):
                    continue
    raise AssertionError(f"{path}: no log line holds {needle!r}")


def planes_path(seed, card, workdir) -> dict:
    """Phase 11 (see the module docstring): the broker path's topology
    with striped replication over 4 standbys, follower reads and 2 host
    workers a broker; traffic, a fan-out consume through leased
    followers, a controller failover rebuilt from stripes, read-back,
    then a seed-0 chaos drill on the card."""
    from ripplemq_tpu_torch.chaos import run_chaos
    from ripplemq_tpu_torch.chaos.proc_cluster import ProcCluster, free_ports
    from ripplemq_tpu_torch.metadata.cluster_config import (
        load_cluster_config,
        parse_cluster_config,
    )

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "planes-path")
    raw = planes_raw_config(free_ports(PLANES_BROKERS))
    config = parse_cluster_config(raw)
    cfg, P = config.engine, config.engine.partitions
    standbys = ProcCluster(config=config, data_dir=root, device=DEV)
    if load_cluster_config(standbys.config_path) != config:
        raise AssertionError("planes path: the standbys' config file "
                             "differs from the controller's config")
    ctrl_dir = os.path.join(root, "broker-0")
    peers = range(1, PLANES_BROKERS)
    admin = TcpClient()
    controller = clients = None
    widths = []  # the encode width of every stripe group (the codec's)
    codec_gf = stripe_codec.gf_matmul

    def recording_gf(m, shards, **kw):
        widths.append(int(shards.shape[1]))
        return codec_gf(m, shards, **kw)

    def stats_of(b) -> dict:
        if b == 0:
            return controller.dispatch({"type": "admin.stats"})
        return admin.call(config.brokers[b].address, {"type": "admin.stats"},
                          timeout=30.0)

    def cluster_views() -> dict:
        views = {}
        for b in range(PLANES_BROKERS):
            try:
                st = stats_of(b)
                views[b] = dict(metadata=st["metadata"],
                                controller=st["controller"], live=st["live"],
                                duty_errors=st["duty_errors"][-3:])
            except Exception as e:
                views[b] = repr(e)
        return views

    out = {}
    stripe_codec.gf_matmul = recording_gf
    try:
        t_boot = time.perf_counter()
        controller = BrokerServer(0, config, net=None, data_dir=ctrl_dir,
                                  device=DEV)
        controller.start()
        boot_ms = worker_boot_ms(controller.hostplane, t_boot)
        for b in peers:
            standbys.restart(b)  # a fresh broker process; 0 is this one
        m0 = controller.manager

        def ready():
            dp = controller.dataplane
            tops = m0.get_topics()
            leases = m0.current_follower_leases()
            return (dp is not None and tops
                    and len(m0.current_standbys()) == PLANES_STANDBYS
                    and len(leases) >= PLANES_STANDBYS
                    and all(a.leader is not None
                            for t in tops for a in t.assignments))

        try:
            wait_for(ready, "planes path: every partition led, 4 standbys "
                     "joined and leased", BROKER_WAIT_S)
        except TimeoutError as e:
            raise AssertionError(f"{e}; each broker's metadata and "
                                 f"controller view: {cluster_views()}")
        dp = controller.dataplane
        if dp.device.type != torch.device(DEV).type:
            raise AssertionError(f"planes path: plane on {dp.device}")
        dp.warm(buckets=dp.all_buckets())
        wt = controller._warm_thread
        if wt is not None:
            wt.join(timeout=BROKER_WAIT_S)
        # Host workers: torch-free, read from outside each process.
        workers = {f"controller worker {w.idx}": w.proc.pid
                   for w in controller.hostplane._workers}
        for b in peers:
            for c in child_pids(standbys.brokers[b].proc.pid):
                workers[f"broker {b} child {c}"] = c
        torch_in = {k: mapped_libs(pid) for k, pid in workers.items()}
        if len(workers) < PLANES_HOST_WORKERS * PLANES_BROKERS or any(
                torch_in.values()):
            raise AssertionError(f"planes path: host workers {workers} map "
                                 f"torch or JAX: {torch_in}")
        st = stats_of(0)
        print(f"planes path: boot: controller BrokerServer 0 on {dp.device} "
              f"(P={P} R={cfg.replicas} slots={cfg.slots} B={cfg.max_batch} "
              f"SB={cfg.slot_bytes}, fused_control + packed_writes), "
              f"replication {st['stripe_mode']} over standbys "
              f"{list(m0.current_standbys())} (stripe holders "
              f"{st['stripe_holders']}), follower leases "
              f"{m0.current_follower_leases()}, host workers "
              f"{PLANES_HOST_WORKERS} a broker; controller workers booted "
              f"in {[round(x, 1) for x in boot_ms]} ms; {len(workers)} "
              f"worker processes map no torch or JAX library; warmed, in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        clients = BrokerClients(dict(
            bootstrap=[b.address for b in config.brokers], partitions=P,
            max_batch=cfg.max_batch, read_batch=cfg.read_batch, seed=seed,
            drain_max=PLANES_DRAIN_MAX, lat=list(PLANES_LAT)), root)

        def counters():
            return controller.dispatch(
                {"type": "admin.metrics"})["metrics"]["counters"]

        # The main path: counts zeroed just before, read just after.
        c0 = counters()
        append_ops.reset_launches()
        rs_ops.reset_launches()
        widths.clear()
        r0 = dp.rounds
        out["latency"] = lat = clients.run("LAT")
        out["bulk"] = bulk = clients.run(f"BULK {PLANES_BATCHES}")

        def settled_tail():  # the last m stripes stream past the settle
            a = counters().get("stripes.bytes", 0)
            time.sleep(0.3)
            return counters().get("stripes.bytes", 0) == a

        wait_for(settled_tail, "planes path: the stripe stream drained",
                 BROKER_WAIT_S)
        c1 = counters()
        out["drain"] = drain = clients.run("DRAIN a follower")
        clients.run("COMMITTED a")
        rounds = dp.rounds - r0
        launches = dict(append_ops.LAUNCHES)
        rs_launch = dict(rs_ops.LAUNCHES)
        encoded = list(widths)
        # Group commits over the same window as the launches: the
        # drain's offset commits are rounds too.
        groups = counters().get("stripes.groups", 0) - c0.get(
            "stripes.groups", 0)
        stripe_bytes = c1.get("stripes.bytes", 0) - c0.get("stripes.bytes",
                                                           0)
        acked_bytes = (lat["messages"] + bulk["messages"]) * PAYLOAD_BYTES
        hists = controller.dispatch(
            {"type": "admin.metrics"})["metrics"]["histograms"]
        stages = {s: hists[s]["mean"] for s in PLANES_STAGES if s in hists}
        stats = {b: stats_of(b) for b in range(PLANES_BROKERS)}
        follower = {b: s["follower"] for b, s in stats.items()}
        hp = stats[0]["host_plane"]
        # Gates (a)-(c).
        past = {b: f.get("answers_past_floor", 0)
                for b, f in follower.items()}
        decoded = {b: follower[b].get("striped", {}).get("decoded_groups", 0)
                   for b in peers}
        if any(past.values()):
            raise AssertionError(f"planes path: answers past the floor "
                                 f"{past}")
        if not drain["follower_answers"]:
            raise AssertionError("planes path: no consume answer came from "
                                 "a follower")
        if not any(decoded.values()):
            raise AssertionError(f"planes path: no standby decoded a group "
                                 f"on read ({decoded})")
        if not 0 < groups <= rs_launch["gf_matmul"]:
            raise AssertionError(f"planes path: {groups} stripe groups, RS "
                                 f"launches {rs_launch}")
        if not (hp["workers"] == hp["alive"] == PLANES_HOST_WORKERS
                and hp["served"] > 0):
            raise AssertionError(f"planes path: controller host plane {hp}")
        if not launches["append_active_packed"] >= rounds > 0 \
                or launches["append_active"] != 0:
            raise AssertionError(f"planes path: append launches {launches} "
                                 f"for {rounds} rounds of fused + packed")
        out.update(launches_planes=launches, rs_planes=rs_launch,
                   rounds=rounds, groups=groups,
                   stripe_bytes_per_acked=stripe_bytes / acked_bytes,
                   stages=stages, boot_ms=boot_ms, host_plane=hp)
        share = 100 * drain["follower_answers"] / drain["answers"]
        print(f"planes path: traffic: {lat['appends_per_s']:.1f} "
              f"single-message appends/s ({PLANES_LAT[0]} x {PLANES_LAT[1]} "
              f"awaited, through the host workers), ack p50 "
              f"{lat['p50_ms']:.3f} p99 {lat['p99_ms']:.3f} p999 "
              f"{lat['p999_ms']:.3f} ms; bulk {bulk['messages']} msgs "
              f"({BROKER_PRODUCERS} producers x {PLANES_BATCHES} batches of "
              f"{cfg.max_batch}, window {BROKER_WINDOW}) "
              f"{bulk['appends_per_s']:.1f} appends/s; follower consume "
              f"{drain['messages']} msgs {drain['msgs_per_s']:.1f} msgs/s "
              f"({BROKER_CONSUMERS} consumers, {PLANES_DRAIN_MAX} an answer), "
              f"{drain['follower_answers']} of {drain['answers']} answers "
              f"from followers ({share:.1f}%), every acked message once, "
              f"byte-exact, at its acked offset; committed offsets equal "
              f"[{card}]", flush=True)
        print(f"planes path: stripes: {groups} group commits encoded "
              f"({len(encoded)} encodes, mean width "
              f"{sum(encoded) / max(1, len(encoded)):.1f} B, widest "
              f"{max(encoded, default=0)} B), RS launches {rs_launch}; "
              f"stripes.bytes per acked byte "
              f"{stripe_bytes / acked_bytes:.4f} ({stripe_bytes} B for "
              f"{acked_bytes} acked payload B); standbys' decoded groups "
              f"{decoded}, answers past the floor {past}; controller host "
              f"plane {hp}; append launches {launches} (packed >= {rounds} "
              f"rounds); stage means us {stages} [{card}]", flush=True)
        # (d) the controller lost: a standby promotes, rebuilds its store
        # from stripes (stripe.fetch), boots its plane on the card.
        t_loss = time.perf_counter()
        t_loss_wall = time.time()
        controller.stop()
        out["probe"] = clients.run("PROBE")
        promote_s = time.perf_counter() - t_loss
        after = clients.run(f"BULK {PLANES_AFTER_BATCHES}")
        reread = clients.run("DRAIN b follower")
        clients.run("COMMITTED b")
        logs = {b: os.path.join(root, f"broker-{b}.log") for b in peers}
        booted = [b for b in peers if "booting data plane as controller"
                  in open(logs[b]).read()]
        if len(booted) != 1:
            raise AssertionError(f"planes path: standbys {booted} booted a "
                                 f"plane; exactly one should have")
        promoted = booted[0]
        rebuilds = stats_of(promoted)["stripe_rebuilds"]
        if rebuilds < 1:
            raise AssertionError(f"planes path: broker {promoted} promoted "
                                 f"without a stripe rebuild")
        t_boot_dp = log_ts(logs[promoted], "booting data plane as controller")
        rebuild_s = log_ts(logs[promoted], "full records from stripe store") \
            - t_boot_dp
        out["promotion"] = dict(promote_s=promote_s, rebuild_s=rebuild_s,
                                boot_after_s=t_boot_dp - t_loss_wall,
                                after=after, reread=reread,
                                promoted=promoted)
        print(f"planes path: failover: controller 0 stopped; standby "
              f"{promoted} promoted {t_boot_dp - t_loss_wall:.3f} s after "
              f"the loss, rebuilt its store from stripes in {rebuild_s:.3f} s "
              f"({100 * rebuild_s / promote_s:.1f}% of promotion -> "
              f"serving), booted its plane (--device {DEV}); every "
              f"partition led by a live broker with a produce acked "
              f"{promote_s:.3f} s after the loss; {after['messages']} more "
              f"msgs {after['appends_per_s']:.1f} appends/s; all "
              f"{reread['messages']} acked messages read back exactly "
              f"({reread['msgs_per_s']:.1f} msgs/s, "
              f"{reread['follower_answers']} of {reread['answers']} answers "
              f"from followers); committed offsets equal [{card}]",
              flush=True)
        clients.close()
        standbys.stop()
    finally:
        stripe_codec.gf_matmul = codec_gf
        if clients is not None:
            clients.close()
        if controller is not None and not controller.stopped:
            controller.stop()
        standbys.stop()
        admin.close()
    # Every encode width past the ladder the kernel check covered.
    beyond = sorted(set(encoded) - set(stripe_ladder()))
    if beyond:
        rs_widths_vs_plain(beyond, seed, "the planes path's widths beyond "
                                         "the ladder")
    # (e) one fixed-seed chaos drill on the card.
    t0 = time.perf_counter()
    verdict = run_chaos(device=DEV, **PLANES_CHAOS)
    chaos_s = time.perf_counter() - t0
    fpast = verdict.get("follower", {}).get("answers_past_floor", 0)
    if verdict["violations"] or fpast:
        raise AssertionError(f"planes path: chaos seed 0 violations "
                             f"{verdict['violations'][:5]}, follower "
                             f"answers past the floor {fpast}")
    out["chaos"] = dict(seconds=chaos_s, counts=verdict["counts"],
                        converged=verdict["converged"],
                        follower=verdict.get("follower", {}))
    print(f"planes path: chaos: seed 0, proc backend, striped, follower "
          f"reads, 2 host workers a broker, --device {DEV}: "
          f"{len(verdict['trace'])} trace ops, no violations, converged "
          f"{verdict['converged']}, counts {verdict['counts']}, follower "
          f"answers past the floor 0, in {chaos_s:.1f} s [{card}]",
          flush=True)
    print(f"planes path: done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return out


# ------------------------------------------------ the lockstep path (slice F)

# The lockstep broker: the broker path's topology and engine, the
# controller's engine a (replica 3, part 2) mesh: itself and 5 workers.
SPMD_MESH = (3, 2)
SPMD_LAT = (16, 64)           # awaited single-message producers x messages
SPMD_BATCHES = 96             # bulk batches per producer (8 x 96 x 512)
SPMD_DRILL_BATCHES = 16       # batches per producer of the drill's bulk
SPMD_KILL_RANK = 5            # the engine worker the drill kills (cell (2, 1))
SPMD_CHILD_S = 900            # bound of each child process


def spmd_shard_checks(ops, seed) -> dict:
    """The append kernels against their plain versions at the shard shapes
    the spmd binding gives them: the lockstep broker's cell (one replica
    of 512 partitions of the broker path's ring, slots 4608, B 512) with
    the batcher's global active sets localized the binding's way (ids of
    the other shard become -1), packed and legacy, and the bench's spmd
    parity whole-ring dense write (`bench.PARITY_SHAPE`: 1024 partitions,
    R 1, slots 12352, B 256)."""
    g = torch.Generator(device=DEV).manual_seed(seed + 9)
    errs = {k: 0 for k in KERNELS}
    cfg = EngineConfig(**BROKER_SHAPE)
    local_P = cfg.partitions // SPMD_MESH[1]
    shard = EngineConfig(**{**BROKER_SHAPE, "replicas": 1,
                            "partitions": local_P})
    log_k = torch.empty((1, local_P, shard.slots + shard.max_batch,
                         shard.slot_bytes), dtype=torch.uint8,
                        device=DEV).random_(generator=g)
    log_p = log_k.clone()
    lo = local_P  # the second shard: cells (r, 1)
    for A in DP_BUCKETS:
        for packed in (False, True):
            entries, ids, _, _, ext = random_case(g, cfg, A, to_ring_end=True)
            _, _, base, do_write, _ = random_case(g, shard, A,
                                                  to_ring_end=True)
            mine = (ids >= lo) & (ids < lo + local_P)
            ids = torch.where(mine, ids - lo, torch.full_like(ids, -1))
            name = "append_active_packed" if packed else "append_active"
            _append_case(ops, log_k, log_p, entries, ids, base, do_write,
                         ext[lo:lo + local_P] if packed else None,
                         f"spmd cell shape (R=1 P={local_P} S={shard.slots} "
                         f"B={shard.max_batch}, {int(mine.sum())} of A={A} "
                         f"ids in the shard)", errs, name, False)
    del log_k, log_p
    pc = EngineConfig(**PARITY_SHAPE)
    log_k = torch.empty((1, pc.partitions, pc.slots + pc.max_batch,
                         pc.slot_bytes), dtype=torch.uint8,
                        device=DEV).random_(generator=g)
    log_p = log_k.clone()
    entries, _, base, do_write, _ = random_case(g, pc, pc.partitions,
                                                to_ring_end=True)
    ids = torch.arange(pc.partitions, dtype=torch.int32, device=DEV)
    _append_case(ops, log_k, log_p, entries, ids, base, do_write, None,
                 f"1x1 parity dense (R=1 P={pc.partitions} S={pc.slots} "
                 f"B={pc.max_batch})", errs, "append_active", False)
    del log_k, log_p
    torch.cuda.empty_cache()
    return errs


def spmd_worker_stats(client, workers, reset=False) -> list:
    return [client.call(w, {"type": "engine.stats", "reset": reset},
                        timeout=60.0) for w in workers]


def spmd_broker_child(spec_path: str) -> int:
    """The lockstep broker and its drill, in their own process
    (`chip_smoke.py --spmd-child broker SPEC`): this process is rank 0
    of a 6-rank world (gloo: every rank on this card) and the controller
    broker; 5 engine-worker processes are the other cells of the (3, 2)
    mesh; two standby broker processes stay local; the clients run in a
    child process. Prints its lines and writes its figures to SPEC's
    `out`; leaves without destroying the (broken) world."""
    from ripplemq_tpu_torch.chaos.proc_cluster import ProcCluster, free_ports
    from ripplemq_tpu_torch.metadata.cluster_config import parse_cluster_config
    from ripplemq_tpu_torch.parallel.lockstep import LockstepController
    from ripplemq_tpu_torch.parallel.mesh import init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    seed, card, root = spec["seed"], spec["card"], spec["root"]
    os.makedirs(root, exist_ok=True)
    t_phase = time.perf_counter()
    R, S = SPMD_MESH
    ports = free_ports(3 + R * S)
    raw = broker_raw_config(ports[:3])
    config = parse_cluster_config(raw)
    cfg, P = config.engine, config.engine.partitions
    coord = f"127.0.0.1:{ports[3]}"
    waddrs = [f"127.0.0.1:{p}" for p in ports[4:]]
    workers, logs = [], []
    for rank in range(1, R * S):
        log = open(os.path.join(root, f"worker-{rank}.log"), "wb")
        logs.append(log)
        workers.append(subprocess.Popen(
            [sys.executable, "-m", "ripplemq_tpu_torch.parallel.worker",
             "--coordinator", coord, "--num-hosts", str(R * S),
             "--host-index", str(rank), "--listen-host", "127.0.0.1",
             "--listen-port", str(ports[3 + rank]), "--device", DEV,
             "--timeout-s", str(config.rpc_timeout_s)],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__))))
    init_distributed(coord, R * S, 0, device=DEV,
                     timeout_s=config.rpc_timeout_s)
    standbys = ProcCluster(config=config, data_dir=root, device=DEV)
    ctrl_dir = os.path.join(root, "broker-0")
    controller = clients = None
    wclient = TcpClient()
    out = {}
    try:
        controller = BrokerServer(0, config, net=None, data_dir=ctrl_dir,
                                  device=DEV, engine_mode="spmd",
                                  engine_workers=waddrs)
        controller.start()
        for b in (1, 2):
            standbys.restart(b)
        m0 = controller.manager

        def ready():
            dp = controller.dataplane
            tops = m0.get_topics()
            return (dp is not None and tops
                    and len(m0.current_standbys()) == config.standby_count
                    and all(a.leader is not None
                            for t in tops for a in t.assignments))

        wait_for(ready, "lockstep path: every partition led and both "
                 "standbys joined", BROKER_WAIT_S)
        dp = controller.dataplane
        if not isinstance(dp.fns, LockstepController):
            raise AssertionError(f"lockstep path: engine {type(dp.fns)}")
        mesh = dp.fns.mesh
        if mesh.shape != {"replica": R, "part": S} or mesh.coords != (0, 0):
            raise AssertionError(f"lockstep path: mesh {mesh.shape} at "
                                 f"{mesh.coords}")
        # The broker's own warm-up only (every warm call crosses 6 ranks).
        wt = controller._warm_thread
        if wt is not None:
            wt.join(timeout=BROKER_WAIT_S)
        boot_s = time.perf_counter() - t_phase
        print(f"lockstep path: boot: controller BrokerServer 0 on "
              f"{dp.device}, engine_mode spmd: cell (0, 0) of a "
              f"{R} x {S} mesh ({mesh.backend}, {R * S} ranks on this card; "
              f"P={P} R={cfg.replicas} slots={cfg.slots} B={cfg.max_batch} "
              f"SB={cfg.slot_bytes}, fused_control + packed_writes, a "
              f"{cfg.partitions // S}-partition one-replica shard a cell), "
              f"{len(workers)} engine workers, standbys 1, 2 local, warmed, "
              f"in {boot_s:.1f} s", flush=True)
        clients = BrokerClients(dict(
            bootstrap=[b.address for b in config.brokers], partitions=P,
            max_batch=cfg.max_batch, read_batch=cfg.read_batch, seed=seed,
            lat=list(SPMD_LAT)), root)
        # The main path: counts zeroed just before, read just after, on
        # every rank.
        append_ops.reset_launches()
        rs_ops.reset_launches()
        mesh.reset_stats()
        spmd_worker_stats(wclient, waddrs, reset=True)
        r0 = dp.rounds
        lat = clients.run("LAT")
        bulk = clients.run(f"BULK {SPMD_BATCHES}")
        drain = clients.run("DRAIN a")
        clients.run("COMMITTED a")
        rounds = dp.rounds - r0
        launches = dict(append_ops.LAUNCHES)
        coll = {k: list(v) for k, v in mesh.stats.items()}
        wstats = spmd_worker_stats(wclient, waddrs)
        hists = controller.dispatch(
            {"type": "admin.metrics"})["metrics"]["histograms"]
        stages = {s: hists[s]["mean"] for s in E2E_STAGES if s in hists}
        per_rank = [launches["append_active_packed"]] + [
            w["launches"]["append_active_packed"] for w in wstats]
        if min(per_rank) < rounds or rounds <= 0 or any(
                w["launches"]["append_active"] for w in wstats) \
                or launches["append_active"]:
            raise AssertionError(f"lockstep path: packed launches a rank "
                                 f"{per_rank} for {rounds} rounds")
        n_coll = sum(c[0] for c in coll.values())
        out.update(latency=lat, bulk=bulk, drain=drain, stages=stages,
                   rounds=rounds, launches=launches, per_rank=per_rank,
                   collectives=coll, boot_s=boot_s)
        print(f"lockstep path: traffic: {lat['appends_per_s']:.1f} "
              f"single-message appends/s ({SPMD_LAT[0]} x {SPMD_LAT[1]} "
              f"awaited), ack p50 {lat['p50_ms']:.3f} p99 "
              f"{lat['p99_ms']:.3f} p999 {lat['p999_ms']:.3f} ms; bulk "
              f"{bulk['messages']} msgs ({BROKER_PRODUCERS} producers x "
              f"{SPMD_BATCHES} batches of {cfg.max_batch}, window "
              f"{BROKER_WINDOW}) {bulk['appends_per_s']:.1f} appends/s; "
              f"consume {drain['messages']} msgs {drain['msgs_per_s']:.1f} "
              f"msgs/s, every acked message once, byte-exact, at its acked "
              f"offset; committed offsets equal; engine.dispatch_us mean "
              f"{stages.get('engine.dispatch_us', 0):.1f}, "
              f"settle.standby_ack_us mean "
              f"{stages.get('settle.standby_ack_us', 0):.1f} [{card}]",
              flush=True)
        print(f"lockstep path: collectives on the controller: "
              f"{n_coll / max(rounds, 1):.2f} a round over {rounds} rounds; "
              f"by kind (calls, mean us): "
              f"{ {k: (c[0], round(c[1] / c[0], 1)) for k, c in coll.items()} }; "
              f"packed append launches by rank {per_rank} >= {rounds} "
              f"controller rounds [{card}]", flush=True)
        # (c) the drill: SIGKILL an engine worker during a second bulk.
        victim = workers[SPMD_KILL_RANK - 1]
        marks = {}

        def kill_later():
            time.sleep(2.0)
            marks["kill"] = time.time()
            os.kill(victim.pid, 9)
            deadline = time.monotonic() + BROKER_WAIT_S
            while time.monotonic() < deadline:
                if "broken" not in marks and dp.broken_reason is not None:
                    marks["broken"] = time.time()
                if "abdicated" not in marks and m0.current_controller() != 0:
                    marks["abdicated"] = time.time()
                if "released" not in marks and controller.dataplane is None:
                    marks["released"] = time.time()
                if len(marks) == 4:
                    return
                time.sleep(0.01)

        killer = threading.Thread(target=kill_later, daemon=True)
        killer.start()
        drill = clients.run(f"BULKR {SPMD_DRILL_BATCHES}")
        killer.join(timeout=BROKER_WAIT_S)
        probe = clients.run("PROBE live")
        if set(marks) != {"kill", "broken", "abdicated", "released"}:
            raise AssertionError(f"lockstep path: drill stopped at {marks}")
        reason = dp.broken_reason
        new_ctrl = m0.current_controller()
        serving = min([t for t in drill["ack_times"] + [probe["acked_at"]]
                       if t > marks["abdicated"]])
        reread = clients.run("DRAIN b")
        clients.run("COMMITTED b")
        booted = [b for b in (1, 2) if "booting data plane as controller"
                  in open(os.path.join(root, f"broker-{b}.log")).read()]
        if booted != [new_ctrl]:
            raise AssertionError(f"lockstep path: controller {new_ctrl}, "
                                 f"planes booted on {booted}")
        drill_fig = dict(
            broken_s=marks["broken"] - marks["kill"],
            abdicated_s=marks["abdicated"] - marks["kill"],
            released_s=marks["released"] - marks["kill"],
            serving_s=serving - marks["kill"], reason=str(reason)[:300],
            promoted=new_ctrl, bulk=drill, reread=reread)
        drill_fig["bulk"] = {k: v for k, v in drill.items()
                             if k != "ack_times"}
        out["drill"] = drill_fig
        print(f"lockstep path: drill: engine worker rank {SPMD_KILL_RANK} "
              f"SIGKILLed {2.0:.1f} s into a retried bulk of "
              f"{drill['messages']} msgs; the plane raised and broke "
              f"{drill_fig['broken_s']:.3f} s after the kill "
              f"({drill_fig['reason'][:160]}), controller 0 abdicated at "
              f"{drill_fig['abdicated_s']:.3f} s and released its plane at "
              f"{drill_fig['released_s']:.3f} s; standby {new_ctrl} "
              f"promoted on its local engine and served an ack "
              f"{drill_fig['serving_s']:.3f} s after the kill; all "
              f"{reread['messages']} acked messages (before, during and "
              f"after) read back once, byte-exact, at their acked offsets "
              f"({reread['msgs_per_s']:.1f} msgs/s); committed offsets "
              f"equal [{card}]", flush=True)
        out["seconds"] = time.perf_counter() - t_phase
    finally:
        if clients is not None:
            clients.close()
        if controller is not None and not controller.stopped:
            controller.stop()
        standbys.stop()
        for w in workers:
            if w.poll() is None:
                w.kill()
            w.wait(timeout=30)
        for log in logs:
            log.close()
        wclient.close()
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


GLOO_PROBE_WORLDS = (2, 6)     # ranks on this one card: a pair, the mesh
GLOO_PROBE_SIZES = (512, 8192)  # int32 values an all_reduce
GLOO_PROBE_CALLS = 100         # timed all_reduces a size, after 5 warm-up


def gloo_probe_child(arg: str) -> int:
    """One rank of the gloo probe (`--spmd-child gloo RANK:WORLD:DIR`):
    joins a world of WORLD ranks over a FileStore in DIR, all on this
    card, checks each collective the spmd binding uses on CUDA tensors
    (all_reduce SUM and MAX on int32, SUM on uint8, all_gather,
    broadcast), times an all_reduce a size, and in a world of two kills
    rank 1 and times how long rank 0's next collective takes to raise.
    Rank 0 writes its figures to DIR/out.json."""
    import torch.distributed as dist

    from ripplemq_tpu_torch.parallel.mesh import init_distributed

    rank, world, root = arg.split(":", 2)
    rank, world = int(rank), int(world)
    init_distributed(f"file://{os.path.join(root, 'store')}", world, rank,
                     device="cuda", timeout_s=30.0)
    dev = torch.device("cuda", 0)

    def full(n, v, dtype=torch.int32):
        return torch.full((n,), v, dtype=dtype, device=dev)

    got = {}
    x = full(5, rank + 1)
    dist.all_reduce(x)
    got["all_reduce_sum_int32"] = x.tolist() == [world * (world + 1) // 2] * 5
    x = full(5, rank + 1)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    got["all_reduce_max_int32"] = x.tolist() == [world] * 5
    x = full(7, rank + 1, torch.uint8)
    dist.all_reduce(x)
    got["all_reduce_sum_uint8"] = x.tolist() == [
        world * (world + 1) // 2 % 256] * 7
    parts = [full(4, -1) for _ in range(world)]
    dist.all_gather(parts, full(4, rank))
    got["all_gather_int32"] = all(t.tolist() == [i] * 4
                                  for i, t in enumerate(parts))
    x = full(3, rank)
    dist.broadcast(x, src=0)
    got["broadcast_int32"] = x.tolist() == [0] * 3
    us = {}
    for n in GLOO_PROBE_SIZES:
        z = full(n, 1)
        for _ in range(5):
            dist.all_reduce(z)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(GLOO_PROBE_CALLS):
            dist.all_reduce(z)
        torch.cuda.synchronize()
        us[n] = (time.perf_counter() - t0) / GLOO_PROBE_CALLS * 1e6
    res = dict(backend=dist.get_backend(), ok=got, us=us, raise_s=None)
    dist.barrier()
    if world == 2 and rank == 1:
        os.kill(os.getpid(), 9)
    if world == 2:
        time.sleep(1.0)
        t0 = time.perf_counter()
        try:
            dist.all_reduce(full(1, 1))
        except Exception:  # noqa: BLE001 - any raise is the answer
            res["raise_s"] = time.perf_counter() - t0
    if rank == 0:
        with open(os.path.join(root, "out.json"), "w") as f:
            json.dump(res, f)
    return 0


def gloo_probe(card) -> None:
    """`--gloo-probe`: gloo collectives on CUDA tensors, for each world
    in GLOO_PROBE_WORLDS (see `gloo_probe_child`); fails unless every
    collective gives the right values and, in the pair, the killed peer
    makes the survivor's collective raise within the group timeout."""
    for world in GLOO_PROBE_WORLDS:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as root:
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--spmd-child",
                 "gloo", f"{r}:{world}:{root}"],
                cwd=os.path.dirname(os.path.abspath(__file__)))
                for r in range(world)]
            try:
                rcs = [p.wait(timeout=120) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(timeout=30)
            with open(os.path.join(root, "out.json")) as f:
                res = json.load(f)
        if rcs[0] != 0 or not all(res["ok"].values()) or (
                world == 2 and res["raise_s"] is None):
            raise AssertionError(f"gloo probe: {world} ranks: exits {rcs}, "
                                 f"{res}")
        us = ", ".join(f"{n} int32 {v:.1f}" for n, v in res["us"].items())
        kill = ("" if res["raise_s"] is None else
                f"; the survivor's collective raised {res['raise_s']:.3f} s "
                f"after its peer's SIGKILL")
        print(f"gloo probe: {world} ranks on one card ({res['backend']}): "
              f"every collective right on CUDA tensors ({', '.join(res['ok'])}"
              f"); all_reduce us (mean of {GLOO_PROBE_CALLS}): {us}{kill} "
              f"[{card}]", flush=True)


def spmd_child(kind: str, arg: str) -> None:
    """Run one lockstep-path child and leave without tearing down its
    process groups (a broken world's teardown waits for a dead peer)."""
    rc = 1
    try:
        rc = {"broker": spmd_broker_child,
              "gloo": gloo_probe_child}[kind](arg)
    except BaseException:
        import traceback

        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def run_spmd_child(kind: str, arg: str, what: str) -> None:
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--spmd-child", kind,
         arg], cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        rc = proc.wait(timeout=SPMD_CHILD_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"lockstep path: {what} did not end within "
                             f"{SPMD_CHILD_S} s")
    if rc != 0:
        raise AssertionError(f"lockstep path: {what} failed (exit {rc})")


def spmd_path(seed, card, workdir) -> dict:
    """Phase 12 (see the module docstring): the spmd binding's kernels at
    its shard shapes, then the lockstep broker with its drill in a child
    process (the 1x1 parity arm is the bench path's `spmd_parity`)."""
    t_phase = time.perf_counter()
    errs = spmd_shard_checks(append_ops, seed)
    root = os.path.join(workdir, "spmd-path")
    os.makedirs(root, exist_ok=True)
    spec = os.path.join(root, "broker.json")
    broker_out = os.path.join(root, "broker-out.json")
    with open(spec, "w") as f:
        json.dump(dict(seed=seed, card=card, root=os.path.join(root, "b"),
                       out=broker_out), f)
    run_spmd_child("broker", spec, "the lockstep broker")
    with open(broker_out) as f:
        broker = json.load(f)
    print(f"lockstep path: done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return dict(errs=errs, broker=broker)


# ------------------------------------------------ the witness path

WITNESS_LAT = (16, 64)        # awaited single-message producers x messages
WITNESS_BATCHES = 32          # bulk batches per producer (was 96)


def witness_lint(card) -> dict:
    """The port's lint on this host: per-rule counts and runtimes; the
    tree must be clean."""
    from ripplemq_tpu_torch.analysis import run_lint

    report = run_lint()
    rules = {r: (c["count"], len(c["waived"]), c["runtime_s"])
             for r, c in report["checkers"].items()}
    if not report["ok"]:
        raise AssertionError(f"witness path: the port's lint is dirty: "
                             f"{report['unwaived_total']} findings, stale "
                             f"waivers {report['stale_waivers']}")
    print(f"witness path: lint (python -m ripplemq_tpu_torch.analysis): "
          f"clean, {len(rules)} rules in {report['runtime_s']:.3f} s on "
          f"this host; rule: (findings, waived, s) {rules} [{card}]",
          flush=True)
    return dict(runtime_s=report["runtime_s"], rules=rules)


def check_witness(rep: dict, what: str) -> None:
    """A witness report held to the chaos harness's two checks: the
    witnessed orderings are acyclic and inside the static closure."""
    if not rep["edges"]:
        raise AssertionError(f"{what}: the witness observed no ordering")
    if not rep["acyclic"] or rep["cycles"]:
        raise AssertionError(f"{what}: witnessed cycles {rep['cycles']}")
    if rep.get("uncovered_edges") != []:
        raise AssertionError(f"{what}: witnessed orderings outside the "
                             f"static lock graph's closure: "
                             f"{rep.get('uncovered_edges')}")


def witness_path(seed, card, workdir) -> dict:
    """Phase 13 (see the module docstring): the runtime lock witness on
    the card, held to acyclicity and to containment in the port's static
    lock graph's closure, on the broker path's topology at full width
    with `lock_witness: true` on the controller (the in-process chaos
    runs it held before run in the tools path, through the soak CLI).
    The witness is reset before and disabled after, so no other path is
    timed with it on."""
    from ripplemq_tpu_torch.analysis.lock_graph import default_closure
    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports
    from ripplemq_tpu_torch.obs import lockwitness

    t_phase = time.perf_counter()
    out = {"lint": witness_lint(card)}
    closure = default_closure()
    print(f"witness path: the static lock graph's closure (derived and "
          f"declared edges): {len(closure)} orderings", flush=True)
    out["closure"] = len(closure)
    launches = collections.Counter()
    lockwitness.reset()
    try:
        # The broker path's topology, witness on in the controller.
        root = os.path.join(workdir, "witness-path")
        raw = broker_raw_config(free_ports(3))
        raw["lock_witness"] = True
        config, standbys, controller = start_topology(
            raw, root, "witness path")
        cfg, P = config.engine, config.engine.partitions
        clients = None
        try:
            dp = controller.dataplane
            clients = BrokerClients(dict(
                bootstrap=[b.address for b in config.brokers], partitions=P,
                max_batch=cfg.max_batch, read_batch=cfg.read_batch,
                seed=seed, lat=list(WITNESS_LAT)), root)
            # The main path: counts zeroed just before, read just after.
            append_ops.reset_launches()
            rs_ops.reset_launches()
            r0 = dp.rounds
            lat = clients.run("LAT")
            bulk = clients.run(f"BULK {WITNESS_BATCHES}")
            drain = clients.run("DRAIN a")
            clients.run("COMMITTED a")
            rounds = dp.rounds - r0
            ran = dict(append_ops.LAUNCHES)
            rs_ran = dict(rs_ops.LAUNCHES)
            rep = lockwitness.report(static_closure=closure)
        finally:
            if clients is not None:
                clients.close()
            controller.stop()
            standbys.stop()
        check_witness(rep, "witness path: broker topology")
        if not ran["append_active_packed"] >= rounds > 0 \
                or ran["append_active"] != 0:
            raise AssertionError(f"witness path: append launches {ran} for "
                                 f"{rounds} rounds of fused + packed")
        launches.update(ran)
        launches.update(rs_ran)
        out["broker"] = dict(latency=lat, bulk=bulk, drain=drain,
                             rounds=rounds, launches=ran, rs=rs_ran,
                             locks=rep["locks"], edges=rep["edges"])
        print(f"witness path: broker topology, witness on (rates taken with "
              f"the witness on): {lat['appends_per_s']:.1f} single-message "
              f"appends/s ({WITNESS_LAT[0]} x {WITNESS_LAT[1]} awaited), ack "
              f"p50 {lat['p50_ms']:.3f} p99 {lat['p99_ms']:.3f} ms; bulk "
              f"{bulk['messages']} msgs ({BROKER_PRODUCERS} producers x "
              f"{WITNESS_BATCHES} batches of {cfg.max_batch}) "
              f"{bulk['appends_per_s']:.1f} appends/s; all "
              f"{drain['messages']} acked messages read back exactly; "
              f"{rounds} controller rounds, append launches {ran} [{card}]",
              flush=True)
        print(f"witness path: the controller witnessed {len(rep['locks'])} "
              f"locks {rep['locks']} and {len(rep['edges'])} orderings "
              f"{[tuple(e) for e in rep['edges']]}: acyclic, none outside "
              f"the static closure's {len(closure)}", flush=True)
    finally:
        lockwitness.disable()
        lockwitness.reset()
    out["launches"] = dict(launches)
    print(f"witness path: done in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return out


# ------------------------------------------------ the tools path

# (a) the soak CLI on the card. The seeds the witness path's chaos runs
# used (the CPU twins' in-process gates, tests/test_torch_chaos.py) run
# here through the CLI: seed 1 on full copies, and seed 11's striped
# schedule (a crash with a disk flip, then a stripe-holder kill) as a
# replayed trace file.
TOOLS_SWEEP = ["--sweep", "2", "--witness"]  # was 3 seeds
TOOLS_SEED1 = ["--seed", "1", "--phases", "2", "--phase-s", "0.5",
               "--witness"]
TOOLS_STRIPED = ["--seed", "11", "--brokers", "4", "--phases", "2",
                 "--phase-s", "0.5", "--replication", "striped",
                 "--witness", "--postmortems"]
TOOLS_STRIPED_TRACE = [
    {"phase": 0, "op": "crash", "broker": 1},
    {"phase": 0, "op": "disk_flip", "broker": 1, "salt": 11},
    {"phase": 1, "op": "stripe_kill", "holder": 0}]
TOOLS_PROC = ["--backend", "proc", "--seed", "0", "--host-workers", "2"]
TOOLS_PROC_S = 600            # bound of the proc soak's process
# (b) the trace viewer's live demo, and the reference's bar for it
# (the verify recipe's "Causal tracing" acceptance drive).
TOOLS_TRACE = ["--host-workers", "2", "--striped", "--messages", "5"]
TOOLS_TRACE_DEMO = dict(host_workers=2, striped=True)  # TOOLS_TRACE's cluster
TOOLS_TRACE_COVERAGE = 0.90
TOOLS_TRACE_HOPS = 6
TOOLS_TRACE_PROCS = 3
# (d) two sealed 64 MiB segments of legacy (payload-only CRC) frames,
# round records of the broker topology's engine (B rows of SB bytes).
TOOLS_MIGRATE_SEGMENTS = 2


def run_tool(main, argv) -> tuple:
    """A tool's `main(argv)` in this process: (exit code, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def check_soak(v: dict, what: str, witnessed: bool) -> None:
    """A soak verdict held to the CLI's gate (safe) and, when witnessed,
    to the witness path's: acyclic, inside the static closure."""
    if not v["safe"] or v["violations"]:
        raise AssertionError(f"{what}: unsafe: {v['violations']}")
    if witnessed:
        w = v["lock_witness"]
        check_witness(w, what)
        if "DataPlane._lock" not in w["locks"]:
            raise AssertionError(f"{what}: witnessed locks {w['locks']}")


def soak_line(v: dict) -> str:
    w = v.get("lock_witness")
    wit = (f"; witnessed {len(w['locks'])} locks, {len(w['edges'])} "
           f"orderings, acyclic, none outside the closure" if w else "")
    return (f"seed {v['seed']} {v['backend']} {v['replication']}: safe, "
            f"converged {v['converged']}, {v['counts']['produce_ok']} "
            f"produces acked, digest {v['schedule_digest'][:16]}{wit}, "
            f"{v['elapsed_s']:.1f} s")


def tools_soak(card, workdir) -> tuple:
    """(a): the soak CLI's runs, its proc run in a child process started
    first and read back last. Returns the kernel launches of the tools'
    own runs and of the witness seeds' runs, and the striped verdict's
    path."""
    from ripplemq_tpu_torch.profiles import chaos_soak

    launches = collections.Counter()
    witness_launches = collections.Counter()
    proc_out = os.path.join(workdir, "soak-proc.json")
    proc_log = open(os.path.join(workdir, "soak-proc.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ripplemq_tpu_torch.profiles.chaos_soak",
         *TOOLS_PROC, "--device", DEV, "--out", proc_out],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=proc_log)
    try:
        runs = []

        def soak(label, argv, witness_seed=False):
            """One in-process soak; its verdict read from `--out`."""
            t0 = time.perf_counter()
            path = os.path.join(workdir, f"soak-{len(runs)}.json")
            append_ops.reset_launches()
            rs_ops.reset_launches()
            rc, _ = run_tool(chaos_soak.main, [*argv, "--out", path])
            ran = {**append_ops.LAUNCHES, **rs_ops.LAUNCHES}
            with open(path) as f:
                doc = json.load(f)
            doc["path"] = path
            if rc != 0:
                raise AssertionError(f"tools path: soak {label}: exit {rc}")
            if not ran["append_active"] + ran["append_active_packed"]:
                raise AssertionError(f"tools path: soak {label}: no append "
                                     f"launch {ran}")
            (witness_launches if witness_seed else launches).update(ran)
            runs.append(label)
            print(f"tools path: soak {label} (chaos_soak {' '.join(argv)}; "
                  f"planes on {DEV}): exit {rc}, kernel launches {ran}, "
                  f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
            return doc

        sweep = soak("sweep", [*TOOLS_SWEEP, "--device", DEV])
        if (sweep["sweep"] != int(TOOLS_SWEEP[1]) or not sweep["safe"]
                or sweep["unsafe_seeds"]):
            raise AssertionError(f"tools path: sweep {sweep['unsafe_seeds']}")
        for v in sweep["runs"]:
            check_soak(v, f"tools path: sweep seed {v['seed']}", True)
            print(f"tools path:   {soak_line(v)}", flush=True)
        v1 = soak("seed 1", [*TOOLS_SEED1, "--device", DEV], True)
        check_soak(v1, "tools path: seed 1", True)
        print(f"tools path:   {soak_line(v1)}", flush=True)
        trace_path = os.path.join(workdir, "striped-trace.json")
        with open(trace_path, "w") as f:
            json.dump(TOOLS_STRIPED_TRACE, f)
        v11 = soak("seed 11 striped", [*TOOLS_STRIPED, "--replay", trace_path,
                                       "--device", DEV], True)
        check_soak(v11, "tools path: seed 11 striped", True)
        if not witness_launches["gf_matmul"]:
            raise AssertionError("tools path: the striped soak launched no "
                                 "RS kernel")
        print(f"tools path:   {soak_line(v11)}", flush=True)
        again = soak("seed 11 replayed", [*TOOLS_STRIPED, "--replay",
                                          v11["path"], "--device", DEV])
        check_soak(again, "tools path: seed 11 replayed", True)
        if again["schedule_digest"] != v11["schedule_digest"] or \
                again["trace"] != v11["trace"]:
            raise AssertionError(f"tools path: the replay's digest "
                                 f"{again['schedule_digest']} differs from "
                                 f"the recorded {v11['schedule_digest']}")
        print(f"tools path:   {soak_line(again)}: the recorded verdict's "
              f"digest reproduced", flush=True)
        rc = proc.wait(timeout=TOOLS_PROC_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc_log.close()
    if rc != 0 or not os.path.exists(proc_out):
        with open(proc_log.name) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"tools path: proc soak exit {rc}: {tail}")
    with open(proc_out) as f:
        vp = json.load(f)
    check_soak(vp, "tools path: proc soak", False)
    print(f"tools path: soak proc (python -m "
          f"ripplemq_tpu_torch.profiles.chaos_soak {' '.join(TOOLS_PROC)}; "
          f"--device {DEV}, broker processes on {DEV}, read from --out): exit {rc}; "
          f"{soak_line(vp)} [{card}]", flush=True)
    return launches, witness_launches, v11["path"]


def tools_trace(card, workdir, verdict_path) -> dict:
    """(b): the trace viewer's live demo on the card, held to the
    reference's bar, then its offline mode on disk. Returns the demo's
    kernel launches."""
    from ripplemq_tpu_torch.obs.assemble import assemble
    from ripplemq_tpu_torch.profiles import trace_view

    t0 = time.perf_counter()
    append_ops.reset_launches()
    rs_ops.reset_launches()
    records = trace_view.live_spans(5, device=DEV, **TOOLS_TRACE_DEMO)
    ran = {**append_ops.LAUNCHES, **rs_ops.LAUNCHES}
    trees = assemble(records)
    produce = [t for t in trees if t["root_kind"] == "client.produce"]
    if len(produce) < 5:
        raise AssertionError(f"tools path: trace: {len(produce)} produce "
                             f"trees of {len(trees)}")
    steady = produce[1:]
    low = [t["coverage"] for t in steady
           if (t["coverage"] or 0) < TOOLS_TRACE_COVERAGE]
    kinds = {k for t in produce for k in t["hops"]}
    procs = {p for t in produce for p in t["procs"]}
    if low or len(kinds) < TOOLS_TRACE_HOPS \
            or not {"stripe.send", "stripe.apply"} <= kinds \
            or len(procs) < TOOLS_TRACE_PROCS \
            or not any(p.startswith("worker") for p in procs):
        raise AssertionError(f"tools path: trace: coverage below "
                             f"{TOOLS_TRACE_COVERAGE} {low}, hops {kinds}, "
                             f"procs {procs}")
    if not ran["append_active_packed"] + ran["append_active"] \
            or not ran["gf_matmul"]:
        raise AssertionError(f"tools path: trace: kernel launches {ran}")
    cov = [round(t["coverage"], 4) for t in produce]
    print(f"tools path: trace (trace_view {' '.join(TOOLS_TRACE)}, live on "
          f"{DEV}): {len(records)} span records -> {len(trees)} trees, "
          f"{len(produce)} produce trees, coverage {cov} (the first pays "
          f"the warm-up), {len(kinds)} hop kinds {sorted(kinds)}, "
          f"{len(procs)} clock domains {sorted(procs)}; kernel launches "
          f"{ran}; {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    # Offline: the live records as a bare list on disk render the same
    # trees; the striped soak verdict renders its postmortem rings.
    spans_path = os.path.join(workdir, "trace-spans.json")
    with open(spans_path, "w") as f:
        json.dump(records, f)
    rc, text = run_tool(trace_view.main, ["--from-json", spans_path])
    head = text.splitlines()[0]
    if rc != 0 or head != f"{len(records)} span records -> " \
            f"{len(trees)} trace(s)" or text.count("\ntrace 0x") != len(trees):
        raise AssertionError(f"tools path: trace --from-json: exit {rc}, "
                             f"{head!r}")
    rc, text = run_tool(trace_view.main, ["--from-json", verdict_path])
    vhead = text.splitlines()[0]
    if rc != 0:
        raise AssertionError(f"tools path: trace --from-json verdict: {rc}")
    print(f"tools path: trace --from-json: the live records -> {head!r}; "
          f"the striped soak verdict -> {vhead!r} (chaos clusters run with "
          f"trace sampling off, in both packages)", flush=True)
    return ran


def tools_host_edge(card, workdir) -> collections.Counter:
    """(c): the host-edge breakdown at the e2e topology, full width, with
    1 and 2 host workers. Returns both runs' kernel launches."""
    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports
    from ripplemq_tpu_torch.profiles import host_edge

    launches = collections.Counter()
    for hw in (1, 2):
        t0 = time.perf_counter()
        raw = host_edge.e2e_raw_config(free_ports(3), host_workers=hw)
        append_ops.reset_launches()
        rs_ops.reset_launches()
        terms = host_edge.measure(raw, DEV, os.path.join(workdir, f"edge{hw}"))
        ran = {**append_ops.LAUNCHES, **rs_ops.LAUNCHES}
        timed = {k: v for k, v in terms.items() if k.endswith("_ms")}
        want = {"worker_submit256_ms"} if hw > 1 else set()
        if not all(v > 0 for v in timed.values()) \
                or terms["produce256_wire_bytes"] <= 0 \
                or not want <= set(timed) \
                or not ran["append_active_packed"] or ran["append_active"]:
            raise AssertionError(f"tools path: host edge {hw}: {terms}, "
                                 f"launches {ran}")
        launches.update(ran)
        print(f"tools path: host edge (host_edge.measure, e2e_raw_config: "
              f"1024 partitions x RF 3, engine 1024 x 3, slots 4608, B 512, "
              f"SB 128, fused + packed, 64 MiB erasure-coded segments; "
              f"host_workers {hw}; 3 brokers in this process on loopback "
              f"TCP, the controller's plane on {DEV}): {json.dumps(terms)}; "
              f"kernel launches {ran}; {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
    return launches


def legacy_frame(rec_type, slot, base, payload) -> bytes:
    """A frame as the payload-only-CRC writer framed it."""
    hdr = struct.pack("<IBIII", 0x474C5152, rec_type, slot, base,
                      len(payload))
    return hdr + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF) + payload


def tools_migrate(seed, card, workdir) -> None:
    """(d): two sealed 64 MiB segments of legacy frames, migrated by the
    port's tool, then recovered onto the card and read back exactly."""
    from ripplemq_tpu_torch.core.encode import pack_payload_rows, stamp_term
    from ripplemq_tpu_torch.profiles.store_migrate import migrate_store
    from ripplemq_tpu_torch.storage.segment import scan_store

    cfg = EngineConfig(**BROKER_SHAPE)
    B, SB = cfg.max_batch, cfg.slot_bytes
    per_segment = SEG_BYTES // (B * SB)
    n = TOOLS_MIGRATE_SEGMENTS * per_segment
    rng = np.random.default_rng(seed)
    d = os.path.join(workdir, "migrate", "segments")
    os.makedirs(d)
    records = []
    for i in range(n):
        p, rnd = i % cfg.partitions, i // cfg.partitions
        lens = rng.integers(1, cfg.payload_bytes + 1, B)
        blob = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
        cuts = np.concatenate([[0], np.cumsum(lens)])
        rows = pack_payload_rows(
            cfg, [blob[cuts[j]:cuts[j + 1]] for j in range(B)])
        stamp_term(rows, 1)
        records.append((REC_APPEND, p, rnd * B, rows.tobytes()))
    for s in range(TOOLS_MIGRATE_SEGMENTS):
        with open(os.path.join(d, f"segment-{s:08d}.log"), "wb") as f:
            for rec in records[s * per_segment:(s + 1) * per_segment]:
                f.write(legacy_frame(*rec))
    size = sum(os.path.getsize(os.path.join(d, x)) for x in os.listdir(d))
    t0 = time.perf_counter()
    stats = migrate_store(d)
    mig_s = time.perf_counter() - t0
    if not stats["migrated"] or stats["legacy_frames"] != n \
            or stats["modern_frames"] != 0:
        raise AssertionError(f"tools path: migration {stats}")
    if list(scan_store(d, use_native=False)) != records:
        raise AssertionError("tools path: the migrated store's records "
                             "differ from those written")
    t1 = time.perf_counter()
    image = dataplane.recover_image(cfg, d, device=DEV)
    log = image.log_data.to(DEV)
    want = torch.from_numpy(np.stack([np.frombuffer(r[3], np.uint8)
                                      for r in records])).to(DEV)
    want = want.view(n, B, SB)
    ps = torch.tensor([r[1] for r in records], device=DEV)
    bases = torch.tensor([r[2] % cfg.slots for r in records], device=DEV)
    rows = bases[:, None] + torch.arange(B, device=DEV)[None, :]
    got = log[ps[:, None], rows]
    want_end = np.zeros(cfg.partitions, np.int64)
    for _, p, base, _ in records:
        want_end[p] = max(want_end[p], base + B)
    ends = image.log_end.to(DEV)
    want_end = torch.from_numpy(want_end).to(device=DEV, dtype=ends.dtype)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(ends, want_end):
        raise AssertionError("tools path: a migrated record read back "
                             "wrong on the card")
    rec_s = time.perf_counter() - t1
    print(f"tools path: migrate (store_migrate.migrate_store): "
          f"{TOOLS_MIGRATE_SEGMENTS} sealed segments of {n} legacy round "
          f"records ({B} rows x {SB} B each, {size} bytes) rewritten to "
          f"header-covered frames in {mig_s:.3f} s = "
          f"{size / mig_s / 1e6:.1f} MB/s (verify_store gate and backup "
          f"{os.path.basename(stats['backup'])} included); recover_image "
          f"onto {DEV}: every record's {B} rows equal on the card, log ends "
          f"equal, {rec_s:.1f} s [{card}]", flush=True)


def tools_path(seed, card, workdir) -> dict:
    """Phase 14 (see the module docstring): the port's four operator
    tools on the card, through the entry points an operator calls."""
    from ripplemq_tpu_torch.obs import lockwitness

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "tools-path")
    os.makedirs(root)
    try:
        launches, witness_launches, verdict = tools_soak(card, root)
    finally:
        lockwitness.disable()
        lockwitness.reset()
    launches.update(tools_trace(card, root, verdict))
    launches.update(tools_host_edge(card, root))
    tools_migrate(seed, card, root)
    print(f"tools path: done in {time.perf_counter() - t_phase:.1f} s; "
          f"kernel launches {dict(launches)} (and "
          f"{dict(witness_launches)} of the witness seeds) [{card}]",
          flush=True)
    return dict(launches=dict(launches),
                witness_launches=dict(witness_launches))


# ------------------------------------------------ phase 15: the bench path

# The bench's own depths cut to the reference's CPU-backend ones
# (`bench.DEPTHS["short"]`: 48 launches x 2 windows, A/B 32, baseline
# 500, e2e 4 s x 1 phase); every width is the bench's.
BENCH_DEPTH = "short"
BENCH_SYNC_LAUNCHES = 16  # sustained launches counted for host syncs
# The bench's phases that drive each kernel: the legacy append on every
# engine and DataPlane phase and the parity A/B's bindings, the packed one
# in the A/B's packed arms, the e2e topology and the host-plane sweep
# (fused + packed), the RS kernel in the stripe encode and the striped
# replication bytes.
BENCH_NEEDS = {"append_active": ("sustained", "fusion_ab", "spmd_parity"),
               "append_active_packed": ("fusion_ab", "e2e",
                                        "host_plane_scaling"),
               "gf_matmul": ("stripe_encode", "repl_bytes")}
# Phases whose kernels run (also, or only) in child processes, whose
# launch counters are their own: not counted in this process's figures.
BENCH_CHILD_LAUNCHES = {
    "spmd_scaling": "every rank is a process of its own",
    "consume_fanout": "every broker is a process of its own",
    "e2e": "the standbys' and the clients' are their processes'",
    "host_plane_scaling": "the standbys' are their processes'",
}
PARITY_SEED = 17  # the seeded payloads of the parity state check


def bench_syncs(bench, card) -> dict:
    """Host syncs of the sustained method at the headline shape: one
    window of BENCH_SYNC_LAUNCHES launches under
    `torch.cuda.set_sync_debug_mode("warn")`, each synchronizing CUDA call
    counted as the warning it raises; and the share of the window the
    host spends enqueueing (the clock stopped before the fence)."""
    import warnings

    cfg = EngineConfig(**HEADLINE)
    fns, alive, quorum, build, put = bench._make(cfg, DEV)
    one = build(cfg, appends={p: [bench.PAYLOAD] * cfg.max_batch
                              for p in range(cfg.partitions)},
                leader=0, term=1)
    inp = bench._stack(one, 8, put)
    trims = bench._stage_trims(cfg, 8 * cfg.max_batch, BENCH_SYNC_LAUNCHES,
                               put, adv_round=cfg.max_batch)
    bench._sustained_warmup(fns, inp, alive, quorum, trims)
    state = fns.init()
    torch.cuda.synchronize()
    def syncs(caught) -> int:  # the mode's own prototype notice aside
        return sum("called a synchronizing CUDA operation" in str(w.message)
                   for w in caught)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for trim in trims:
                state, out = fns.step_many(state, inp, alive, quorum, trim)
            t_enqueue = time.perf_counter() - t0
            in_loop = syncs(caught)
            committed = bench._fetch(out.committed)
            t_window = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not committed.all():
        raise AssertionError("bench path: the sync-count window failed")
    total = syncs(caught)
    del state, out
    res = dict(launches=BENCH_SYNC_LAUNCHES, syncs_in_loop=in_loop,
               syncs_total=total,
               syncs_per_launch=in_loop / BENCH_SYNC_LAUNCHES,
               enqueue_s=t_enqueue, window_s=t_window,
               enqueue_share=t_enqueue / t_window)
    print(f"bench path: host syncs of the sustained method (headline "
          f"1024 x 5, B 256, chain 8, {BENCH_SYNC_LAUNCHES} launches, "
          f"set_sync_debug_mode warn): {in_loop} inside the launch loop "
          f"({res['syncs_per_launch']:.2f} a launch), {total} with the "
          f"fence; enqueue "
          f"{t_enqueue * 1e3:.1f} ms of the {t_window * 1e3:.1f} ms window "
          f"({res['enqueue_share']:.1%}) [{card}]", flush=True)
    return res


def bench_rails(bench, curve, workdir) -> dict:
    """The rails prior of this run's operating curve, written as an
    `slo_rails_file` and loaded back through the port's SloController."""
    from ripplemq_tpu_torch.obs.metrics import Metrics
    from ripplemq_tpu_torch.obs.trace import FlightRecorder
    from ripplemq_tpu_torch.slo.controller import SloController

    prior = bench._rails_prior(curve)
    path = os.path.join(workdir, "slo_rails.json")
    with open(path, "w") as f:
        json.dump(prior, f)
    config = ClusterConfig(brokers=(BrokerInfo(0, "127.0.0.1", 9000),),
                           topics=(), slo_p99_ack_ms=50.0,
                           slo_rails_file=path)
    ctl = SloController(config, Metrics(enabled=True), FlightRecorder(),
                        dataplane_fn=lambda: None)
    got = {"read_coalesce_min_s": ctl.rc_min,
           "read_coalesce_max_s": ctl.rc_max,
           "chain_depth_min": ctl.cd_min, "chain_depth_max": ctl.cd_max}
    if got != prior["rails"]:
        raise AssertionError(f"bench path: the SLO controller loaded {got} "
                             f"from the prior's rails {prior['rails']}")
    return prior


def check_slice_j(bench, result, phases, card) -> None:
    """The gates of the slice-J phases' results, and one line each."""
    d = bench.DEPTHS[BENCH_DEPTH]
    bad = []
    # The parity A/B: its three bindings launch the legacy append once a
    # round: a warm-up launch and 4 trials of the depth's launches each,
    # chains of 8.
    want = 3 * (1 + 4 * d["parity_launches"]) * 8
    got = phases["spmd_parity"]["launches"]["append_active"]
    if got != want:
        bad.append(f"spmd_parity launched the legacy append {got} times, "
                   f"{want} expected")
    par = result["spmd_parity"]
    if not all(par[k] > 0 for k in ("local_appends_per_sec",
                                    "spmd_appends_per_sec",
                                    "spmd_legacy_appends_per_sec")):
        bad.append(f"spmd_parity rates {par}")
    sc = result["spmd_scaling"]
    if [p["devices"] for p in sc["points"]] != [1, 2, 4, 8] or not all(
            p["appends_per_sec"] > 0 for p in sc["points"]):
        bad.append(f"spmd_scaling points {sc['points']}")
    rb = result["repl_bytes_per_acked_byte"]
    if not (rb["full"]["acked_payload_bytes"]
            == rb["striped"]["acked_payload_bytes"] == 128000
            and rb["striped"]["stripe_groups"] > 0):
        bad.append(f"repl_bytes {rb}")
    g = result["group_consume"]
    if not g["count_exact"]:
        bad.append(f"group_consume {g}")
    sp = result["split_rebalance"]
    if not (sp["split_ok"] and sp["readback"] == sp["acked"] > 0):
        bad.append(f"split_rebalance {sp}")
    fo = result["consume_fanout"]
    if not all(a["count_exact"] and (a["follower_served"] > 0
                                     or not a["follower_reads"])
               for a in fo["arms"]):
        bad.append(f"consume_fanout {fo['arms']}")
    st = result["control_plane_storm"]
    if any(a["errors"] for a in [st["direct_baseline"]] + st["shapes"]):
        bad.append(f"control_plane_storm errors {st}")
    hp = result["host_plane_scaling"]
    if [a["host_workers"] for a in hp["arms"]] != [1, 2, 4] or not all(
            a["readback"] == "count-exact" for a in hp["arms"]):
        bad.append(f"host_plane_scaling {hp['arms']}")
    if bad:
        raise AssertionError("bench path: slice-J gates failed: "
                             + "; ".join(bad))
    cpu_repl = (659200, 286364, 40)  # the CPU run of both packages
    print(f"bench path: spmd_parity {json.dumps(par)}; legacy append "
          f"launches {got} (3 bindings x (1 + 4 x "
          f"{d['parity_launches']}) launches x chain 8) [{card}]",
          flush=True)
    print(f"bench path: spmd_scaling {json.dumps(sc)} [{card}]", flush=True)
    print(f"bench path: repl_bytes {json.dumps(rb)}; equal to the CPU "
          f"runs' (full, striped, groups) {cpu_repl}: "
          f"{(rb['full']['repl_bytes'], rb['striped']['repl_bytes'], rb['striped']['stripe_groups']) == cpu_repl}"
          f" [{card}]", flush=True)
    print(f"bench path: group_consume "
          f"{result['e2e_group_consume_msgs_per_sec']} msgs/s "
          f"{json.dumps(g)}; slo_convergence "
          f"{json.dumps(result['slo_convergence'])}; split_rebalance "
          f"{json.dumps(sp)} [{card}]", flush=True)
    print(f"bench path: consume_fanout {json.dumps(fo)} [{card}]",
          flush=True)
    heads = [{k: a[k] for k in (
        "members", "membership_events", "raft_proposals",
        "proposal_collapse", "convergence_ms_p50", "convergence_ms_p99",
        "leader_heartbeat_rpcs_per_s_before",
        "leader_heartbeat_rpcs_per_s_after")}
        for a in [st["direct_baseline"]] + st["shapes"]]
    print(f"bench path: control_plane_storm (direct, then each shape) "
          f"{json.dumps(heads)} [{card}]", flush=True)
    print(f"bench path: host_plane_scaling {json.dumps(hp)} [{card}]",
          flush=True)


def parity_states(bench, card) -> None:
    """The parity shape's three bindings (local, spmd fused, spmd legacy,
    on a world of one formed and left here) replay one seeded chained
    window, the ring wrapping behind staged trims (the bench's parity
    depth of launches), from fresh states: the three states must end
    byte-identical (the spmd fused one in named fields)."""
    import dataclasses

    from ripplemq_tpu_torch.core.encode import build_step_input
    from ripplemq_tpu_torch.core.state import unfuse_state
    from ripplemq_tpu_torch.parallel import mesh as mesh_mod
    from ripplemq_tpu_torch.parallel.engine import make_spmd_fns

    t0 = time.perf_counter()
    cfg = EngineConfig(**PARITY_SHAPE)
    launches = bench.DEPTHS[BENCH_DEPTH]["parity_launches"]
    P, B = cfg.partitions, cfg.max_batch
    rng = np.random.default_rng(PARITY_SEED)
    local, alive, quorum, _, put = bench._make(cfg, DEV)
    one = build_step_input(cfg, appends={
        p: [rng.integers(0, 256, PAYLOAD_BYTES, dtype=np.uint8).tobytes()] * B
        for p in range(P)}, leader=0, term=1)
    inp = bench._stack(one, 8, put)
    trims = bench._stage_trims(cfg, 8 * B, launches, put)
    try:
        mesh = mesh_mod.make_mesh(1, 1, device=DEV)
        bindings = {"local": local,
                    "spmd": make_spmd_fns(
                        dataclasses.replace(cfg, fused_control=True), mesh),
                    "spmd_legacy": make_spmd_fns(cfg, mesh)}
        states = {}
        for name, fns in bindings.items():
            _, st = bench._sustained_window(fns, inp, alive, quorum, trims,
                                            1.0)
            states[name] = unfuse_state(st) if hasattr(st, "ctrl") else st
        equal = {name: all(torch.equal(getattr(states["local"], f),
                                       getattr(states[name], f))
                           for f in states["local"]._fields)
                 for name in ("spmd", "spmd_legacy")}
        backend = mesh.backend
    finally:
        mesh_mod.shutdown()
    if not all(equal.values()):
        raise AssertionError(f"bench path: parity states differ: {equal}")
    print(f"bench path: parity states (P={P} R=1 slots={cfg.slots} B={B}, "
          f"chain 8, {launches} launches from fresh states, seeded "
          f"payloads, a world of one on {backend}): local, spmd fused and "
          f"spmd legacy byte-identical in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    del states, inp, trims
    torch.cuda.empty_cache()


def bench_path(card, workdir) -> dict:
    """Phase 15 (see the module docstring): `ripplemq_tpu_torch.bench`'s
    ported phases at the bench's widths and BENCH_DEPTH, each phase's
    kernel launches (counts zeroed just before it, read just after),
    wall time and peak device memory; the artifact's gates; the rails
    prior through the SLO controller; the sustained method's host syncs."""
    import contextlib

    from ripplemq_tpu_torch import bench

    t_phase = time.perf_counter()
    phases = {}

    @contextlib.contextmanager
    def phase(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        append_ops.reset_launches()
        rs_ops.reset_launches()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        phases[name] = dict(
            s=time.perf_counter() - t0,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
            launches={"append_active": append_ops.LAUNCHES["append_active"],
                      "append_active_packed":
                          append_ops.LAUNCHES["append_active_packed"],
                      "gf_matmul": rs_ops.LAUNCHES["gf_matmul"]})
        note = (f" in this process ({BENCH_CHILD_LAUNCHES[name]}: not "
                f"counted here)" if name in BENCH_CHILD_LAUNCHES else "")
        print(f"bench path: {name}: {phases[name]['s']:.1f} s, peak device "
              f"memory {phases[name]['peak_gb']:.2f} GB allocated "
              f"({phases[name]['reserved_gb']:.2f} GB reserved), kernel "
              f"launches {phases[name]['launches']}{note}", flush=True)

    result = bench._collect(DEV, BENCH_DEPTH, phase=phase)
    bad = [k for k, _ in bench.HEADLINE_GATES
           if not (isinstance(result.get(k), (int, float))
                   and result[k] > 0)]
    if bad or tuple(result) != bench.RESULT_KEYS \
            or result["readback"] != "verified" \
            or result["e2e_readback"] != "verified" \
            or result["e2e_consume_verified"] != "count-exact" \
            or "NVIDIA" not in (result["card"]["nvidia_smi"] or ""):
        brief = {k: v for k, v in result.items() if k not in (
            "admin_metrics", "latency_decomposition", "operating_curve")}
        raise AssertionError(f"bench path: gates failed ({bad}): {brief}")
    launches = collections.Counter()
    for got in phases.values():
        launches.update(got["launches"])
    for kernel, needs in BENCH_NEEDS.items():
        for name in needs:
            if not phases[name]["launches"][kernel]:
                raise AssertionError(f"bench path: {kernel} never launched "
                                     f"in the {name} phase")
    check_slice_j(bench, result, phases, card)
    parity_states(bench, card)
    prior = bench_rails(bench, result["operating_curve"], workdir)
    syncs = bench_syncs(bench, card)
    head = {k: result[k] for k in (
        "value", "vs_baseline", "baseline_appends_per_sec",
        "burst_window_appends_per_sec", "shipped_shape_appends_per_sec",
        "p50_ack_ms", "p99_ack_ms", "p999_ack_ms", "round_rtt_ms",
        "consume_msgs_per_sec", "codec_mb_per_sec",
        "stripe_encode_mb_per_sec", "e2e_appends_per_sec",
        "e2e_mb_per_sec", "e2e_acked", "e2e_consume_msgs_per_sec",
        "e2e_consumed", "e2e_cpu_decomposition")}
    print(f"bench path: headline (depth {BENCH_DEPTH}: "
          f"{json.dumps(bench.DEPTHS[BENCH_DEPTH])}): {json.dumps(head)}; "
          f"readback {result['readback']}, e2e {result['e2e_readback']}, "
          f"{result['e2e_consume_verified']}; the e2e clients torch-free "
          f"[{card}]", flush=True)
    print(f"bench path: control_fusion_ab "
          f"{json.dumps(result['control_fusion_ab'])}", flush=True)
    print(f"bench path: operating curve "
          f"{json.dumps(result['operating_curve'])}; rails "
          f"{json.dumps(prior['rails'])} (floor p99 "
          f"{prior['floor_p99_ack_ms']} ms) loaded by SloController",
          flush=True)
    print(f"bench path: e2e stages "
          f"{json.dumps({k: v.get('mean') for k, v in result['latency_decomposition'].items()})}; "
          f"settle {json.dumps(result['settle_pipeline'])}", flush=True)
    print(f"bench path: done in {time.perf_counter() - t_phase:.1f} s; "
          f"kernel launches {dict(launches)} [{card}]", flush=True)
    return dict(launches=dict(launches), phases=phases, syncs=syncs)


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
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--dataplane-only", action="store_true",
                      help="build the kernels and run only the dataplane "
                           "path (a measurement loop: no result line)")
    only.add_argument("--control-only", action="store_true",
                      help="build the kernels and run only the control "
                           "path (a measurement loop: no result line)")
    only.add_argument("--broker-only", action="store_true",
                      help="build the kernels and run only the broker "
                           "path (a measurement loop: no result line)")
    only.add_argument("--planes-only", action="store_true",
                      help="build the kernels, check the RS kernel at the "
                           "stripe ladder's widths and run only the planes "
                           "path (a measurement loop: no result line)")
    only.add_argument("--spmd-only", action="store_true",
                      help="build the kernels and run only the lockstep "
                           "path (a measurement loop: no result line)")
    only.add_argument("--witness-only", action="store_true",
                      help="build the kernels and run only the witness "
                           "path (no result line)")
    only.add_argument("--tools-only", action="store_true",
                      help="build the kernels and run only the tools path "
                           "(no result line)")
    only.add_argument("--bench-only", action="store_true",
                      help="build the kernels and run only the bench path "
                           "(no result line)")
    only.add_argument("--gloo-probe", action="store_true",
                      help="run only the gloo probe: the spmd binding's "
                           "collectives on CUDA tensors across 2 and 6 "
                           "ranks of this card (no result line)")
    only.add_argument("--broker-client", metavar="SPEC",
                      help=argparse.SUPPRESS)  # the broker path's clients
    only.add_argument("--spmd-child", nargs=2, metavar=("KIND", "ARG"),
                      help=argparse.SUPPRESS)  # the lockstep path's children
    args = ap.parse_args()
    if args.broker_client:
        return broker_client_main(args.broker_client)
    if args.spmd_child:
        spmd_child(*args.spmd_child)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device here; this script runs on the GPU "
              "only", file=sys.stderr)
        return 1

    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    if args.gloo_probe:
        gloo_probe(card)
        return 0

    build_kernels()
    print(f"topology: broker_raw_config = e2e_raw_config, sha256 "
          f"{topology_digest()} at ports 9000-9002", flush=True)
    if args.dataplane_only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            dataplane_path(args.seed, card, workdir)
        print(f"dataplane path: both planes in "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        return 0
    if args.control_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            control_path(args.seed, card, workdir)
        return 0
    if args.broker_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            broker_path(args.seed, card, workdir, commit_ab=True)
        return 0
    if args.planes_only:
        small_append_vs_plain(append_ops, args.seed, chaos_engines())
        rs_widths_vs_plain(stripe_ladder(), args.seed,
                           "the stripe ladder (every shard class)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            planes_path(args.seed, card, workdir)
        return 0
    if args.spmd_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            spmd_path(args.seed, card, workdir)
        return 0
    if args.witness_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            witness_path(args.seed, card, workdir)
        return 0
    if args.tools_only:
        small_append_vs_plain(append_ops, args.seed, chaos_engines())
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            tools_path(args.seed, card, workdir)
        return 0
    if args.bench_only:
        small_append_vs_plain(append_ops, args.seed, bench_engines())
        scaling_vs_plain(append_ops, args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            bench_path(card, workdir)
        return 0
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
        dp_runs = dataplane_path(args.seed, card, workdir)
        ctrl = control_path(args.seed, card, workdir)
        broker = broker_path(args.seed, card, workdir)
        planes = planes_path(args.seed, card, workdir)
        spmd = spmd_path(args.seed, card, workdir)
        witness = witness_path(args.seed, card, workdir)
        tools = tools_path(args.seed, card, workdir)
        bench_run = bench_path(card, workdir)
    launches_dp = {DP_KERNEL[p]: r["launches"][DP_KERNEL[p]]
                   for p, r in dp_runs.items()}
    launches_ctrl = ctrl["launches_control"]
    launches_broker = broker["launches_broker"]
    launches_planes = planes["launches_planes"]
    # The lockstep path: the packed append a rank of the lockstep broker
    # (the controller first); its 1x1 parity arm is the bench path's
    # `spmd_parity` phase, counted in `launches_bench`.
    launches_spmd = {"append_active": 0,
                     "append_active_packed": spmd["broker"]["per_rank"]}
    for name, err in spmd["errs"].items():
        errs[name] = max(errs[name], err)
    # The witness seeds' chaos runs moved into the tools path, as soak
    # CLI runs; their launches still count as the witness path's, and
    # `launches_witness_seeds` names that share (`--witness-only` runs
    # without it).
    seeds = tools["witness_launches"]
    launches_witness = collections.Counter(witness["launches"])
    launches_witness.update(seeds)

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                    launches=launches[name],
                    launches_dataplane=launches_dp[name],
                    launches_control=launches_ctrl[name],
                    launches_broker=launches_broker[name],
                    launches_planes=launches_planes[name],
                    launches_spmd=launches_spmd[name],
                    launches_witness=launches_witness[name],
                    launches_witness_seeds=seeds.get(name, 0),
                    launches_tools=tools["launches"].get(name, 0),
                    launches_bench=bench_run["launches"].get(name, 0),
                    max_abs_err=errs[name],
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
        launches_broker=broker["rs_broker"]["gf_matmul"],
        launches_planes=planes["rs_planes"]["gf_matmul"],
        launches_witness=launches_witness["gf_matmul"],
        launches_witness_seeds=seeds.get("gf_matmul", 0),
        launches_tools=tools["launches"].get("gf_matmul", 0),
        launches_bench=bench_run["launches"].get("gf_matmul", 0),
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

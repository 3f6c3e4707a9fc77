"""DataPlane: the device-round loop + append batcher (PyTorch port).

Twin of `ripplemq_tpu/broker/dataplane.py`, local mode: the host
component that turns many small producer requests into few large device
rounds. Batching, chaining, the active-set buckets, the per-slot FIFO
and retry order, the dispatch-order turnstile, the settle window,
settled and mirror gaps, the host read mirror, trim and retention,
producer dedup, the offsets shadow, stall streaks, knobs and
`postmortem` are the reference's, line for line; so are the lock names
(`analysis/lock_graph.py` keys on them).

One DataPlane owns: the engine state (all partitions × replicas), the
per-partition leader/term tables, the per-partition replica liveness
mask, pending-append/offset queues, and the step thread that drains them.
All device interaction happens on the step thread or under its lock:
the port's engine updates the state IN PLACE (the torch form of the
reference's donation), so every step, read, vote, resync and state fetch
runs under `_device_lock`, and all of them on one CUDA stream — a
`read_many` gather issued after a step is ordered behind it.

What changes with the framework sits in a small device boundary at the
top of this module:

- `_to_host(x)`: a tensor (on any device) or array → numpy; the
  reference's `np.asarray`, which raises on a CUDA tensor;
- `_stage(x, device)`: a host array → a tensor on the engine's device.
  On CUDA it goes through pinned memory and a `non_blocking` copy: a
  pageable host-to-device copy waits for the stream, which would make
  the step thread wait for the previous round's kernels before it can
  dispatch the next (defeating `pipeline_depth`, the resolvers and
  chaining). PyTorch's caching host allocator reuses a pinned block only
  once its copy has completed;
- `_CommittedFetch`: each dispatch's `committed` copied into pinned host
  memory with `non_blocking` right after the launch, plus an event
  recorded on the step thread; the resolver waits on that event alone
  (the reference's `copy_to_host_async`). A plain `.cpu()` there would
  wait for every round queued after it on the stream;
- `_row_lens(rows)`: the row-header length decode on numpy host rows
  (the port's `core.state.row_lens` is a torch function).

Elections ride the same device: `elect()` batches RequestVote rounds for
many partitions into ONE vote call. `mode="spmd"` binds the engine to a
(replica x part) mesh of ranks (`parallel.engine.make_spmd_fns`); with
`workers` the other ranks are engine-worker processes and every engine
call goes through a `parallel.lockstep.LockstepController`, which
broadcasts its host arguments to them — so in that mode the arguments
stay on the host (`_stage` to no device) and each rank moves them to its
own device. State fetches are then the controller's `fetch_state` (an
all_gather over the mesh), and a broken mesh surfaces through
`broken_reason`.
"""

from __future__ import annotations

import bisect
import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

import struct
import time

from ripplemq_tpu_torch.core.config import ALIGN, ROW_HEADER as _HDR, EngineConfig
from ripplemq_tpu_torch.obs.lockwitness import make_condition, make_lock
from ripplemq_tpu_torch.core.encode import (
    decode_entries_with_pos,
    pack_payload_rows,
    row_extents,
    stamp_term,
)
from ripplemq_tpu_torch.core.state import ReplicaState, StepInput
from ripplemq_tpu_torch.ops.rs import default_device, indexed_device
from ripplemq_tpu_torch.parallel.engine import make_local_fns
from ripplemq_tpu_torch.storage.erasure import repair_store
from ripplemq_tpu_torch.storage.segment import (
    REC_APPEND,
    REC_OFFSETS,
    REC_PIDSEQ,
    SegmentStore,
    scan_store,
)
from ripplemq_tpu_torch.utils.logs import get_logger

log = get_logger("dataplane")


# ------------------------------------------------------- device boundary


def _to_host(x) -> np.ndarray:
    """Host copy of a tensor on any device (a CUDA tensor's D2H waits for
    the work queued before it), or `np.asarray` of anything else."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stage(x, device: Optional[torch.device]) -> torch.Tensor:
    """A host array (or tensor) as a tensor on `device`. To CUDA: through
    pinned memory and a `non_blocking` copy on the current stream — the
    copy is queued, not waited for. A tensor already on `device` (same
    type and index; a CUDA device without one means the current device)
    comes back as it is. A failed copy raises; there is no CPU
    fallback. `device` None keeps the argument on the host, as numpy
    (a lockstep plane's engine arguments travel to every rank)."""
    if device is None:
        return _to_host(x)
    if isinstance(x, torch.Tensor):
        if x.device == indexed_device(device):
            return x
        t = x
    else:
        x = np.asarray(x)
        if not (x.flags.c_contiguous and x.flags.writeable):
            x = np.array(x)  # a C-ordered, writeable copy for torch
        t = torch.from_numpy(x)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _CommittedFetch:
    """One dispatch's `committed` on its way to the host: a `non_blocking`
    copy into pinned memory queued right behind the dispatch, and an
    event recorded after it on the same stream (the step thread's).
    `result()` waits for that event only — not for rounds dispatched
    later — and returns the numpy view. On the CPU the tensor is already
    on the host."""

    __slots__ = ("_host", "_event")

    def __init__(self, committed: torch.Tensor) -> None:
        if committed.device.type == "cuda":
            self._host = torch.empty(committed.shape, dtype=committed.dtype,
                                     pin_memory=True)
            self._host.copy_(committed, non_blocking=True)
            # Blocking sync: a waiting resolver sleeps instead of spinning
            # a core the step and producer threads need.
            self._event = torch.cuda.Event(blocking=True)
            self._event.record(torch.cuda.current_stream(committed.device))
        else:
            self._host = committed
            self._event = None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _row_lens(rows: np.ndarray) -> np.ndarray:
    """Payload lengths from host rows' headers: uint8 [..., SB] → int32
    [...] (little-endian, as `core.state.row_lens` on the device)."""
    hdr = np.ascontiguousarray(rows[..., 0:4])
    return hdr.view("<i4")[..., 0].astype(np.int32)


class NotCommittedError(Exception):
    """The round(s) carrying this request never reached quorum."""


class StoreReadRaceError(NotCommittedError):
    """A store read kept colliding with concurrent segment GC. Transient:
    the records exist (or existed); retry rather than treating the window
    as absent — absence triggers an earliest-reset that would silently
    skip retained rows. Subclasses NotCommittedError so the broker's
    dispatch surfaces it as a retryable `not_committed` refusal, not an
    internal error."""


class PartitionFullError(NotCommittedError):
    """The partition's log has no room for the batch (backpressure).

    Only reachable in store-less (pure in-memory) deployments: with a
    round store attached, the device ring recycles rows below the trim
    watermark (everything committed is already persisted — the store is
    the log of record) and appends never wedge; lagging consumers are
    served from the store via the log index."""


# Device offsets (log_end/commit/trim) are int32, the reference's
# width. A partition appending past 2^31 rows would
# wrap negative and silently corrupt capacity/commit/read arithmetic, so
# submits are refused with a clean error well before the edge (at
# slot_bytes=128 the horizon is 256 GiB through ONE partition; spread
# load over more partitions to go past it).
_OFFSET_HORIZON = (1 << 31) - (1 << 20)

# Sentinel: a host-cache read lost the trim race mid-copy (see
# DataPlane._read_cache).
_CACHE_LAPPED = object()
# Distinct from the dirty-shadow None: the offset sits in a MIRROR-GAP
# window (resolve failure disabled the cache for the slot), where the
# rows are settled — hence persisted and log-indexed — and the store can
# serve them without a device dispatch (see read()'s gap-generation
# probe discipline).
_CACHE_GAP = object()

# Settled batches remembered per (pid, slot) for producer-sequence
# dedup. The producer only ever replays sequences it never saw acked —
# at most one batch deep per partition under the SDK's ack-gated
# sequence advance — so a small window covers every legal replay;
# anything older still refuses to re-append (acked as a duplicate with
# base -1: present in the log, position no longer remembered).
_PID_WINDOW = 8


class _Pending:
    __slots__ = ("payloads", "rows", "future", "rounds_left", "pid", "seq",
                 "tctx")

    def __init__(self, payloads: list[bytes], future: Future,
                 rounds_left: int, rows=None, pid: int = 0, seq: int = -1,
                 tctx=None):
        self.payloads = payloads
        # Appends carry their rows PRE-PACKED (pack_payload_rows on the
        # submitting thread); the drain only memcpys blocks and stamps
        # the round term — per-message packing inside the batcher lock
        # serialized the whole plane under deep backlogs.
        self.rows = rows
        self.future = future
        self.rounds_left = rounds_left
        # Idempotent-producer identity: pid > 0 marks this batch as
        # dedup-tracked — (pid, seq) survives requeues, so a retried
        # round re-appends under the SAME identity.
        self.pid = pid
        self.seq = seq
        # Causal-tracing context (obs/spans.py TraceContext) of a
        # SAMPLED produce, else None: the settle release emits the six
        # round-stage spans attributed to it.
        self.tctx = tctx


class _PendingOffsets(_Pending):
    pass


class DataPlane:
    """See module docstring.

    `mode` is "local" (every replica on one device, the engine's explicit
    [R] axis) or "spmd" (a replica × part mesh of ranks: `mesh`, or one
    of `part_shards` shards — by default the world's ranks over the
    replicas — built on this process's world; `workers` are the engine
    workers of the other ranks, reached through `worker_client`, a
    `TcpClient` by default). Semantics are identical; tests assert it
    (tests/test_torch_spmd.py).

    `device` is where the engine's state lives: CUDA when None, and with
    no GPU present that raises unless the caller asks for the CPU
    (`device="cpu"`, as the tests do) — there is no silent CPU path.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        mode: str = "local",
        mesh=None,
        part_shards: Optional[int] = None,
        max_retry_rounds: int = 8,
        store: Optional[SegmentStore] = None,
        flush_interval_s: float = 0.05,
        pipeline_depth: int = 8,
        coalesce_s: float = 0.002,
        replicate_fn=None,
        workers: Optional[list[str]] = None,
        worker_client=None,
        resolver_threads: int = 4,
        chain_depth: int = 4,
        read_q: int = 16,
        host_read_cache: bool = True,
        settle_window: Optional[int] = None,
        read_coalesce_s: float = 0.001,
        durability: str = "async",
        obs: bool = True,
        metrics=None,
        recorder=None,
        spans=None,
        device=None,
    ) -> None:
        if mode not in ("local", "spmd"):
            raise ValueError(f"unknown mode {mode!r}")
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run the "
                "data plane on the CPU explicitly")
        self.device = indexed_device("cuda" if device is None else device)
        self.cfg = cfg
        # --- telemetry plane (obs/) ---------------------------------------
        # `metrics`/`recorder` are normally the OWNING BrokerServer's (one
        # registry + one flight-recorder ring per broker, wired through at
        # boot); a bare plane (tests, benches) builds its own. `obs=False`
        # swaps in no-op metrics — the A/B knob — while the flight
        # recorder stays on (its per-ROUND cost is a few hundred ns and
        # its whole value is being on when nobody expected to need it).
        from ripplemq_tpu_torch.obs.metrics import Metrics
        from ripplemq_tpu_torch.obs.trace import FlightRecorder

        self.metrics = metrics if metrics is not None else Metrics(enabled=obs)
        self.recorder = recorder if recorder is not None else FlightRecorder()
        # Causal-tracing span ring (obs/spans.py), normally the owning
        # broker's — and only handed over when tracing is CONFIGURED
        # (trace_sample_n > 0): `spans is None` gates every per-round
        # tctx scan below to zero when the plane is untraced.
        self.spans = spans
        m = self.metrics
        # Hot-path metric handles resolved ONCE (registry lookups lock).
        self._m_submits = m.counter("produce.submits")
        self._m_messages = m.counter("produce.messages")
        self._m_offsets = m.counter("produce.offset_commits")
        self._m_dispatch_us = m.histogram("engine.dispatch_us")
        self._m_chain_rounds = m.histogram("engine.chain_rounds")
        self._m_commit_wait_us = m.histogram("settle.commit_wait_us")
        self._m_enter_wait_us = m.histogram("settle.enter_wait_us")
        self._m_standby_ack_us = m.histogram("settle.standby_ack_us")
        self._m_persist_us = m.histogram("settle.persist_us")
        self._m_release_us = m.histogram("settle.release_us")
        self._m_retries = m.counter("produce.round_retries")
        self._m_retry_exhausted = m.counter("produce.retry_exhausted")
        self._m_read_calls = m.counter("read.calls")
        self._m_read_msgs = m.counter("read.messages")
        # Durability mode for the settle-path persist: "async" defers
        # fsync to the store's flusher thread at flush_interval_s cadence
        # (disk lags acks by at most one interval);
        # "strict" fsyncs synchronously before every settled round's acks
        # release, so acked data never lags disk at all (the standby ack
        # path honors the same knob in broker/server._handle_repl_rounds).
        if durability not in ("async", "strict"):
            raise ValueError(
                f"durability must be 'async' or 'strict', got {durability!r}"
            )
        self.durability = durability
        # Durability tier: committed rounds are framed into the segment
        # store from the step thread; fsync happens at most every
        # `flush_interval_s` (0 = every round). "Committed" therefore
        # means quorum-replicated on the mesh; durable-on-disk lags by at
        # most the flush interval (SURVEY.md §7 durability story).
        self.store = store
        self.flush_interval_s = flush_interval_s
        self._last_flush = 0.0
        # Retention (see core.state ring doc): `trim[p]` is the absolute
        # watermark below which device ring rows are reclaimable — raised
        # lazily by _drain when a partition needs room, never above the
        # persisted prefix. `_log_end[p]` is the host's shadow of the
        # leader's absolute log end (exact while the slot is not busy:
        # one in-flight round per slot, advanced at resolve time).
        # `log_index` maps (slot, offset) → store record so reads below
        # trim are served from the store (storage/logindex.py).
        P0 = cfg.partitions
        self.trim = np.zeros((P0,), np.int64)
        self._log_end = np.zeros((P0,), np.int64)
        # Read-visibility horizon: rows below this are DURABLY SETTLED
        # (device-committed + persisted + standby-acked). Device-ring
        # reads clamp to it — device commit alone includes rounds whose
        # replication later failed, and serving those leaks state that a
        # controller failover rolls back (see _resolve_one).
        self._settled_end = np.zeros((P0,), np.int64)
        # Host mirror of the committed device ring: every committed
        # round's rows pass through this host (the resolver holds them
        # to persist/replicate), so hot reads — above the trim
        # watermark — can be served from host RAM with ZERO device
        # involvement (the reference serves a consume as a leader-local
        # list slice, PartitionStateMachine.java:85-110; a device read
        # costs a dispatch and a device-to-host copy).
        # `_cache_end[p]` is the CONTIGUOUS mirrored prefix: it only
        # advances when a round lands adjacent to it, so a resolve
        # failure (round outcome unknown, rows never mirrored) leaves a
        # gap that reads fall through to the device for, instead of
        # serving stale rows. Memory = partitions x slots x slot_bytes
        # (1/replicas of the device state); zero pages until written.
        self._host_ring = (
            np.zeros((P0, cfg.slots, cfg.slot_bytes), np.uint8)
            if host_read_cache else None
        )
        self._cache_end = np.zeros((P0,), np.int64)
        # Post-gap mirrored run per slot: after a resolve failure leaves
        # a mirror gap, later rounds still write their rows physically —
        # only `_cache_end` stops advancing. `slot → [run_base, run_end]`
        # tracks that contiguous post-gap run so the cache can HEAL once
        # the trim watermark passes run_base (everything unmirrored below
        # it is then store-served and never consults the mirror), rather
        # than staying disabled for the slot's lifetime.
        self._mirror_gap: dict[int, list[int]] = {}
        # Monotone per-slot gap GENERATION: bumped each time a fresh
        # mirror gap opens. The read path device-probes a gap window
        # once per generation (the probe validates the window against
        # the device commit bound) and then serves the store path
        # directly for the rest of that gap's lifetime — settled rows
        # are always persisted+indexed before they are mirrored
        # (_release_one order), so the store is a valid authority
        # inside the gap and the per-call device round-trip was pure
        # overhead.
        self._mirror_gap_gen: dict[int, int] = {}
        self._gap_probed_gen: dict[int, int] = {}
        # Per-slot SETTLED GAPS (the mirror-gap analogue for the read
        # horizon): sorted disjoint [begin, end) absolute row ranges that
        # are device-committed but whose standby replication FAILED —
        # nacked to their producers, so they must stay invisible even
        # after the slot settles NEWER rounds and `_settled_end` passes
        # them. Every read path (device ring, host mirror, store) skips
        # these ranges; promotion/boot replay rebuilds them from the
        # recovered store's coverage holes (replay_records gaps_out).
        # Ranges are never re-covered within a controller lifetime
        # (bases only advance), so entries are permanent until the next
        # install(); memory is two ints per failed round.
        self._settled_gaps: dict[int, list[list[int]]] = {}
        # Persisted prefix per partition: rows below this are in the
        # ROUND STORE (appended; flush may lag by flush_interval_s).
        # Advanced by _persist_round only after the store append
        # succeeded — NOT by the shadow-dirty device re-derivation,
        # which can cover committed-but-never-persisted rounds after a
        # persist failure. The drain-time trim raise clamps against
        # THIS, so everything below trim is always store-servable.
        self._persisted = np.zeros((P0,), np.int64)
        self.log_index = None
        self._scan_index = None  # lazy full-history index (_scan_store_for)
        if store is not None and hasattr(store, "scan_indexed"):
            from ripplemq_tpu_torch.storage.logindex import LogIndex

            self.log_index = LogIndex()
            self.log_index.load(store.scan_indexed(), cfg.slot_bytes,
                                REC_APPEND)
        # Controller-failover hook: called with each round's committed
        # records BEFORE local persistence and BEFORE settling futures —
        # the resolver blocks until the standby set acked, so a settled
        # append provably exists on every replication standby (zero
        # committed-entry loss across controller death; see
        # broker/replication.py), and the local store only ever holds
        # standby-acked records (a crash between the two steps must not
        # leave a record recovery would serve but promotion would
        # forget — see _resolve_one). Raising fails the round's futures
        # (FencedError ⊂ NotCommittedError → producers retry at the new
        # controller).
        self.replicate_fn = replicate_fn
        # Host-plane settled-mirror hook (parallel/hostplane.py): when
        # the broker runs worker subprocesses, the settle thread
        # publishes each durably-settled round's REC_APPEND rows to the
        # owning worker so consume reads for that slice are served off
        # this process's GIL. Fire-and-forget BY CONTRACT — the hook
        # must never block settle (HostPlane.publish drops on a full
        # ring; the worker's contiguity check turns drops into clean
        # engine-read fallbacks).
        self.mirror_fn = None
        # Pipelined-settle split of replicate_fn (RoundReplicator.begin/
        # wait): `begin` enqueues a round's records on every standby
        # stream without blocking; `wait` blocks until all member acks.
        # When set (the broker wires them beside replicate_fn), a window
        # of up to `settle_window` rounds streams to the standbys while
        # the device advances; acks still release strictly in round
        # order (see _settle_loop). When only replicate_fn is set (tests,
        # custom replicators), the settle thread calls it synchronously —
        # same in-order release, no standby-stream overlap.
        self.replicate_begin_fn = None
        self.replicate_wait_fn = None
        # Where engine arguments are staged: the engine's device, or the
        # host for a lockstep plane (see `_stage`).
        self._arg_device = self.device
        if mode == "local":
            self.fns = make_local_fns(cfg, device=self.device)
        else:
            from ripplemq_tpu_torch.parallel.engine import make_spmd_fns
            from ripplemq_tpu_torch.parallel.mesh import make_mesh, world_size

            if mesh is None:
                if part_shards is None:
                    # Auto: every rank of the world.
                    part_shards = max(1, world_size() // cfg.replicas)
                    while cfg.partitions % part_shards:
                        part_shards -= 1  # partitions must tile evenly
                R, S = cfg.replicas, part_shards

                def build():
                    return make_spmd_fns(cfg, make_mesh(R, S, self.device))
            else:
                part_shards = mesh.shape["part"]

                def build():
                    return make_spmd_fns(cfg, mesh)
            if workers:
                # The other ranks replay every engine call
                # (parallel.lockstep); the controller builds its own
                # engine inside the broadcast `configure` call, because
                # forming the mesh is a rendezvous of every rank.
                from ripplemq_tpu_torch.parallel.lockstep import (
                    LockstepController,
                )
                from ripplemq_tpu_torch.wire.transport import TcpClient

                self.fns = LockstepController(
                    build, cfg, part_shards, workers,
                    worker_client if worker_client is not None else TcpClient(),
                )
                self._arg_device = None
            else:
                self.fns = build()
        self.max_retry_rounds = max_retry_rounds

        P, R = cfg.partitions, cfg.replicas
        self._state = self.fns.init()
        self.leader = np.full((P,), -1, np.int32)
        self.term = np.zeros((P,), np.int32)
        self.alive = np.ones((P, R), bool)
        self.quorum = np.full((P,), cfg.quorum, np.int32)
        self._refresh_quorum_ok_locked()  # pre-start: no lock needed yet

        self._appends: dict[int, list[_Pending]] = {}
        self._offsets: dict[int, list[_PendingOffsets]] = {}
        # Idempotent-producer dedup state (guarded by self._lock).
        # `_pid_tab`: (pid, slot) → recent SETTLED batches as
        # (seq_start, seq_end, base), newest last, capped at _PID_WINDOW —
        # a replayed sequence is acked as a duplicate with its original
        # base instead of appending again. Entries are written into the
        # replicated record stream (REC_PIDSEQ, beside each round's
        # REC_APPEND) and rebuilt by boot/promotion replay, so a
        # controller failover cannot re-open the dup window: every acked
        # round is on every standby, and its pid entry rides the same
        # records. `_pid_inflight`: (pid, slot, seq) → the Future of a
        # batch whose round has not settled yet — a concurrent wire-dup
        # of the same request attaches to the SAME future (one append,
        # two identical acks).
        self._pid_tab: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
        self._pid_inflight: dict[tuple[int, int, int], Future] = {}
        # Consecutive device-uncommitted rounds per slot (reset on any
        # committed round, and on set_leader — a fresh term is a fresh
        # chance). A long streak with a LIVE leader is the signature of
        # the device-term-skew wedge the chaos plane caught (seed 7): an
        # election bumped the device current_term but its OP_SET_LEADER
        # advert never stuck, so every round dispatches with a stale
        # term and is refused forever while the metadata plane sees a
        # healthy leader and never re-elects. stalled_slots() feeds the
        # controller duty's needs_elections gate so exactly that state
        # self-heals by re-election instead of wedging the partition.
        self._nocommit_streak: dict[int, int] = {}
        # Locks ride the witness factories (obs/lockwitness.py): raw
        # threading primitives unless the runtime lock witness is
        # enabled, in which case acquisition orderings are recorded
        # under these names and cross-checked against the static graph
        # (analysis/lock_graph.py) by the chaos smokes.
        self._lock = make_lock("DataPlane._lock")  # queues + ctrl tables
        self._device_lock = make_lock(
            "DataPlane._device_lock")          # every touch of self._state
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="dataplane-step"
        )
        # Two-stage round pipeline: the STEP thread only drains queues and
        # dispatches device rounds; RESOLVER threads block on each
        # round's `committed` host fetch, persist it, and settle its
        # futures. Several resolvers run CONCURRENTLY — sound because the
        # busy sets guarantee in-flight rounds touch disjoint partition
        # slots (per-slot ordering is the only ordering the settle path
        # needs, and the store/replication streams only require per-slot
        # record order — replay is per-slot later-wins). Concurrency
        # lets the fetches of several dispatches wait at once (each waits
        # only on its own dispatch's event, see _CommittedFetch); the
        # reference needed it behind a network tunnel, where serial
        # resolves capped round throughput at 1/RTT. The
        # round's `base` is NOT fetched at all: it is the drain-time
        # log-end shadow (exact — one in-flight round per slot, and
        # log_end only moves on commit), captured in the round ctx. The
        # bounded queue backpressures dispatch at `pipeline_depth`
        # outstanding rounds.
        self.pipeline_depth = max(1, pipeline_depth)
        self.resolver_threads = max(1, resolver_threads)
        # Deep backlogs drain as CHAINS of up to chain_depth rounds per
        # device dispatch (engine step_many_sparse: complete quorum
        # rounds in order). Dispatch latency and the resolver's host fetch
        # both amortize over the chain; a chain may take several pendings
        # of one slot (device-ordered). 1 disables chaining.
        self.chain_depth = max(1, chain_depth)
        self._zero_round = None  # lazy pad template (chain dispatches)
        # Entries placeholder ([P, 1, 1], see _dummy_entries): built
        # EAGERLY — the lazy build was reachable from the step, warm,
        # and duty threads with no common lock (the ownership lint's
        # first whole-tree run flagged it; benign-idempotent, but a
        # pre-spawn constant costs P bytes and zero reasoning).
        self._dummy = np.zeros((cfg.partitions, 1, 1), np.uint8)
        # Read coalescer: device reads queue here and drain as ONE
        # read_many dispatch of up to read_q queries — the consume-side
        # mirror of append batching. No artificial wait: while one batch
        # executes (serialized by _device_lock), concurrent readers
        # accumulate into the next, so batching emerges exactly when the
        # dispatch cost would otherwise multiply.
        self.read_q = max(1, read_q)
        # Tiny assembly window before each read dispatch: consumers whose
        # previous read just resolved need ~a millisecond to decode and
        # resubmit; draining the instant the first request lands would
        # phase-lock the cohort into half-filled batches (the reference
        # measured 8/16 consumers per dispatch without it). Negligible vs the dispatch
        # RTT it amortizes. Constructor/config-surfaced like coalesce_s
        # (ClusterConfig.read_coalesce_s); 0 disables.
        self.read_coalesce_s = max(0.0, read_coalesce_s)
        self._reads: list[tuple[int, int, int, Future]] = []
        self._read_lock = make_lock("DataPlane._read_lock")
        self._read_work = threading.Event()
        self._read_thread = threading.Thread(
            target=self._read_loop, daemon=True, name="dataplane-read"
        )
        # Host shadow of the replicated consumer-offset table: offset
        # commits pass through this host (rounds), so the committed table
        # is reproducible without a device fetch — read_offset serves
        # from here, halving the device round-trips per consume.
        self._offsets_shadow = np.zeros(
            (cfg.partitions, cfg.max_consumers), np.int32
        )
        # Coalescing window: when few submissions are pending, wait this
        # long before dispatching so a whole burst of concurrent
        # producers lands in ONE round — every round costs a full
        # host↔device sync to resolve, which the reference measured at
        # ~100 ms behind a tunnel and ~1 ms attached. 0 disables.
        self.coalesce_s = coalesce_s
        self._inflight: "queue.Queue[tuple[StepInput, dict, object]]" = (
            queue.Queue(maxsize=self.pipeline_depth)
        )
        self._resolvers = [
            threading.Thread(
                target=self._resolve_loop, daemon=True,
                name=f"dataplane-resolve-{i}",
            )
            for i in range(self.resolver_threads)
        ]
        # --- settle pipeline (third stage) -------------------------------
        # Resolvers no longer block on standby replication: each resolved
        # dispatch enters a bounded settle window — its records already
        # streaming to the standbys (replicate_begin_fn) — and ONE settle
        # thread waits out the acks strictly in dispatch order before
        # persisting, mirroring, advancing the settled-read horizon, and
        # releasing producer futures. Ordering invariants this preserves
        # verbatim: per-slot standby-stream record order (begin happens
        # inside the dispatch-order turnstile), settle-gated reads
        # (_settled_end moves only here, in order), ack-only-after-all-
        # member-acks (replicate_wait_fn runs the full waiver/fence
        # discipline), and the empty-set refusal (begin raises it). The
        # window backpressures resolvers when full; a FencedError latches
        # `_settle_fenced` and DRAINS the window without acking any
        # unsettled round (a deposed controller's pre-received standby
        # acks prove nothing against the successor's history).
        self.settle_window = max(
            1, cfg.settle_window if settle_window is None
            else int(settle_window)
        )
        # The window bound is the SEMAPHORE (held from replication begin
        # until release completes), not the queue: a bounded queue alone
        # would let one extra round begin streaming while blocked on the
        # put, making settle_window=1 overlap instead of serialize.
        self._settle_q: "queue.Queue[tuple]" = queue.Queue()
        self._settle_sem = threading.Semaphore(self.settle_window)
        self._settle_thread = threading.Thread(
            target=self._settle_loop, daemon=True, name="dataplane-settle"
        )
        self._settle_fenced = False
        # Dispatch-order turnstile: resolvers run concurrently, but
        # settle-pipeline entry (and the replication begin inside it)
        # must follow dispatch order or a slot's standby stream could
        # carry round k+1's records before round k's (standby replay is
        # later-record-wins per slot — a reordered stream would regress
        # its log end). Seqs are assigned by the step thread.
        self._dispatch_seq = 0
        self._next_turn = 0
        self._turnstile = make_condition("DataPlane._turnstile")
        # Occupancy counters (bench/admin surface): depth is sampled at
        # each settle enqueue; backpressure counts enqueues that found
        # the window full.
        self.settle_depth_sum = 0
        self.settle_samples = 0
        self.settle_backpressure = 0
        # Live settle-window occupancy (rounds between window entry and
        # release) and the SLO autopilot's soft-window bookkeeping: the
        # controller shrinks the effective window by holding
        # `_settle_held` semaphore permits (set_knobs), so the window
        # narrows without rebuilding the semaphore mid-flight. Both
        # guarded by self._lock.
        self._settle_inflight = 0
        self._settle_held = 0
        # Guarded by self._lock (read by _drain, cleared by the resolver).
        self._busy_a: set[int] = set()   # partition slots with appends in flight
        self._busy_o: set[int] = set()   # ... with offset commits in flight
        # Slots whose log-end shadow must be re-read from the device
        # before their next round (a resolve failed with the round's
        # outcome possibly unknown). Guarded by self._lock.
        self._shadow_dirty: set[int] = set()
        # Host-side counters (exposed through the broker's admin.stats
        # RPC). `rounds` counts quorum rounds; `dispatches` device
        # launches (rounds/dispatches = chaining factor); the read pair
        # measures the read coalescer's batching.
        self.rounds = 0
        self.dispatches = 0
        self.read_queries = 0
        self.read_dispatches = 0
        self.read_cache_hits = 0
        self.committed_entries = 0
        self.step_errors = 0

    def start(self) -> None:
        self._thread.start()
        self._read_thread.start()
        for r in self._resolvers:
            r.start()
        self._settle_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        self._read_work.set()
        # A never-started plane (boot failed between construction and
        # start — server._boot_dataplane's cleanup path) must still run
        # the rest of stop (fail queued futures, flush): joining an
        # unstarted Thread raises, so join only what ran. The settle
        # thread joins LAST — it exits only once the resolvers are dead
        # and the window is drained.
        for t in (self._thread, self._read_thread, *self._resolvers,
                  self._settle_thread):
            if t.ident is not None:
                t.join(timeout=10)  # lands every dispatched round
        # Stranded settle entries (settle thread wedged past its join
        # timeout, or never started): fail their committed futures —
        # nothing will release them now.
        while True:
            try:
                ctx, committed, *_ = self._settle_q.get_nowait()
            except queue.Empty:
                break
            self._fail_committed(ctx, committed,
                                 NotCommittedError("data plane stopped"))
        with self._read_lock:
            stranded = self._reads
            self._reads = []
        for *_, fut in stranded:
            if not fut.done():
                fut.set_exception(NotCommittedError("data plane stopped"))
        if self.store is not None:
            self.store.flush()
        # Nothing will ever drain the queues again: fail leftovers instead
        # of letting their futures hang until caller timeouts (matters on
        # controller fencing, where the deposed data plane stops while
        # frontends still hold futures).
        with self._lock:
            leftovers = [p for q in self._appends.values() for p in q]
            leftovers += [p for q in self._offsets.values() for p in q]
            self._appends.clear()
            self._offsets.clear()
            self._pid_inflight.clear()  # plane dead: nothing will settle
        for p in leftovers:
            if not p.future.done():
                p.future.set_exception(
                    NotCommittedError("data plane stopped")
                )

    # ------------------------------------------------------------- control

    def set_leader(self, slot: int, leader_slot: int, term: int) -> None:
        """Record partition `slot`'s leader replica-slot + term (host
        election outcome; fed into every round's StepInput)."""
        with self._lock:
            self.leader[slot] = leader_slot
            self.term[slot] = term
            # A new term is a new chance to commit: clear the slot's
            # no-commit streak so a just-healed term skew doesn't keep
            # re-triggering elections before the next round lands.
            self._nocommit_streak.pop(slot, None)
        self.recorder.record("set_leader", slot=int(slot),
                             leader=int(leader_slot), term=int(term))

    def set_alive(self, alive: np.ndarray) -> None:
        """Install a new [P, R] per-partition replica liveness mask."""
        alive = np.asarray(alive, bool)
        if alive.shape != (self.cfg.partitions, self.cfg.replicas):
            raise ValueError(f"alive mask must be [P, R], got {alive.shape}")
        with self._lock:
            self.alive = alive.copy()
            self._refresh_quorum_ok_locked()

    def set_quorum(self, quorum: np.ndarray) -> None:
        """Install per-partition quorum sizes (RF//2+1 per topic)."""
        quorum = np.asarray(quorum, np.int32)
        if quorum.shape != (self.cfg.partitions,):
            raise ValueError(f"quorum must be [P], got {quorum.shape}")
        with self._lock:
            self.quorum = quorum.copy()
            self._refresh_quorum_ok_locked()

    def _refresh_quorum_ok_locked(self) -> None:
        # Plain python list, swapped whole: quorum_lost() runs on EVERY
        # consume/offset-commit, and a per-call numpy sum under the
        # control lock measurably contends with the drain loop at high
        # request rates (sampled hot in the e2e profile).
        self._quorum_ok = (
            self.alive.sum(axis=1) >= self.quorum
        ).tolist()

    def mirror_gap_slots(self) -> int:
        """Count of slots whose host mirror is gap-disabled (resolve
        failure; pending trim-passage heal) — taken under the plane's
        lock (observability readers must not race the resolver's
        heal-time dict mutation)."""
        with self._lock:
            return len(self._mirror_gap)

    def settled_gap_slots(self) -> int:
        """Count of slots carrying at least one settled gap (device-
        committed rows whose replication failed; skipped by every read
        path) — locked like mirror_gap_slots: observability readers must
        not race the settle thread's dict mutation."""
        with self._lock:
            return sum(1 for g in self._settled_gaps.values() if g)

    def settled_end(self, slot: int) -> int:
        """The slot's settled-read horizon, under the plane's lock (the
        pattern of mirror_gap_slots: external pollers — the
        broker's long-poll probe, admin surfaces — must not reach into
        the array bare)."""
        with self._lock:
            return int(self._settled_end[slot])

    def settle_floors(self, slots) -> list[list]:
        """Per-slot settled-floor stamp for the replication sender
        (follower reads): `[[slot, settled_end, gaps], ...]`
        for the requested slots, snapshotted in ONE pass under the
        plane's lock so a frame never carries a floor that is newer
        than the gap map it rode with (a follower trusting such a pair
        could serve a nacked row the gap entry would have fenced).
        Floors are conservative by construction — the settle pipeline
        advances `_settled_end` only after the round's standby acks
        landed, so every offset at-or-below a stamped floor is already
        replicated to the whole (full-copy) standby set."""
        with self._lock:
            return [
                [int(s), int(self._settled_end[s]),
                 [list(g) for g in self._settled_gaps.get(s, ())]]
                for s in slots
            ]

    def log_end(self, slot: int) -> int:
        """The slot's host-shadow log end (device-committed absolute
        offset), under the plane's lock — the settled_end() pattern:
        external readers (profiles, admin surfaces) must not reach into
        `_log_end` bare while the resolver advances it."""
        with self._lock:
            return int(self._log_end[slot])

    def stalled_slots(self, threshold: Optional[int] = None) -> list[int]:
        """Slots whose last `threshold` dispatched rounds ALL failed to
        commit on device (default: 2x the per-submit retry budget, so a
        single submit's worth of transient failures never trips it).
        This is the liveness probe for the device-term-skew wedge: the
        controller duty treats a stalled slot as election-worthy even
        though its leader looks alive, and plan_elections confirms the
        skew against the device current_term before nominating."""
        if threshold is None:
            threshold = 2 * self.max_retry_rounds
        with self._lock:
            return sorted(
                s for s, n in self._nocommit_streak.items()
                if n >= threshold
            )

    def reset_stall(self, slot: int) -> None:
        """Clear the slot's no-commit streak: the election duty's device
        probe disproved term skew (stalled but term-aligned — an engine-
        quorum outage elections cannot help). Without this decay, a slot
        whose traffic stops right after such an outage stays "stalled"
        forever: stalled_slots() keeps reporting it and every duty tick
        re-pays the plan_elections device fetch at the election timeout
        on a healthy idle cluster. Fresh failing dispatches re-build the
        streak, so a real skew appearing later still trips the probe."""
        with self._lock:
            had = self._nocommit_streak.pop(slot, None)
        if had is not None:
            self.recorder.record("stall_reset", slot=int(slot), streak=had)

    def _add_settled_gap_locked(self, slot: int, begin: int,
                                end: int) -> None:
        """Record one failed round's [begin, end) as a settled gap
        (caller holds self._lock). Ranges arrive in base order within a
        slot (bases only advance), so insertion is an append that merges
        with an adjacent/overlapping predecessor."""
        if end <= begin:
            return
        gaps = self._settled_gaps.setdefault(slot, [])
        if gaps and begin <= gaps[-1][1]:
            gaps[-1][1] = max(gaps[-1][1], end)
        else:
            gaps.append([begin, end])
        # Recorder appends are lock-free — safe under the plane's lock.
        self.recorder.record("settled_gap", slot=int(slot),
                             begin=int(begin), end=int(end))

    def _gap_clamp_locked(self, slot: int, offset: int,
                          count: int) -> tuple[Optional[int], int]:
        """Clamp one read window against the slot's settled gaps (caller
        holds self._lock). Returns (skip_to, count): `skip_to` non-None
        means `offset` sits INSIDE a gap — serve nothing and continue at
        skip_to (the same contract as alignment padding: nacked rows
        advance next_offset without delivering); otherwise `count` is
        clamped so the window stops at the first gap past `offset`."""
        gaps = self._settled_gaps.get(slot)
        if not gaps:
            return None, count
        # Sorted disjoint ranges: bisect to the candidate at-or-before
        # `offset` — a flap-heavy controller accumulates gaps for its
        # whole lifetime and this probe sits on every read path inside
        # the plane's contended lock, so the common no-gap case must not
        # walk the history.
        i = bisect.bisect_right(gaps, offset, key=lambda g: g[0]) - 1
        if i >= 0 and gaps[i][0] <= offset < gaps[i][1]:
            return gaps[i][1], 0
        if i + 1 < len(gaps):
            return None, min(count, gaps[i + 1][0] - offset)
        return None, count

    def quorum_lost(self, slot: int) -> bool:
        """True iff partition `slot` cannot commit ANY round right now:
        fewer replica slots alive than its quorum. Rounds for such a
        slot are doomed before dispatch, so callers fast-fail with a
        typed `unavailable` refusal instead of burning an RPC timeout.
        Lock-free: reads the precomputed list set_alive/set_quorum swap
        in whole (list indexing is atomic under the GIL)."""
        return not self._quorum_ok[slot]

    def degraded_slots(self) -> list[int]:
        """Partitions whose quorum is currently lost ([P]-masked under
        the lock) — the `degraded` surface admin.stats advertises."""
        with self._lock:
            lost = self.alive.sum(axis=1) < self.quorum
        return [int(s) for s in np.nonzero(lost)[0]]

    # --------------------------------------------------- runtime knobs (SLO)

    def knob_state(self) -> dict:
        """The SLO autopilot's view of the adjustable operating point,
        under the plane's lock: the live coalesce/chain values, the
        EFFECTIVE settle window (configured minus soft-held permits),
        the configured cap, and the window's live occupancy."""
        with self._lock:
            return {
                "read_coalesce_s": float(self.read_coalesce_s),
                "chain_depth": int(self.chain_depth),
                "settle_window": int(self.settle_window - self._settle_held),
                "settle_window_cap": int(self.settle_window),
                "settle_inflight": int(self._settle_inflight),
            }

    def set_knobs(self, read_coalesce_s: Optional[float] = None,
                  chain_depth: Optional[int] = None,
                  settle_window: Optional[int] = None) -> dict:
        """Apply one SLO-controller decision (slo/controller.py). All
        writes ride self._lock: _drain reads chain_depth under the same
        lock, so one dispatch never sees a torn value, and the ownership
        lint's common-mutex rule holds for the controller thread plus
        any direct caller (tests, profiles).

        `settle_window` is a SOFT bound in [slo_settle_window_min,
        configured window]: shrinking acquires spare semaphore permits
        non-blocking (occupied slots converge on later ticks as rounds
        release — never blocks the control loop against a full window),
        growing releases held ones. `chain_depth` changes take effect at
        the next dispatch; a depth this plane has not run yet compiles
        its chain program lazily on first use (the controller moves on a
        power-of-two ladder to bound that to log2(max) programs)."""
        with self._lock:
            if read_coalesce_s is not None:
                self.read_coalesce_s = max(0.0, float(read_coalesce_s))
            if chain_depth is not None:
                self.chain_depth = max(1, int(chain_depth))
            if settle_window is not None:
                want = min(self.settle_window,
                           max(1, int(settle_window)))
                target_held = self.settle_window - want
                while self._settle_held > target_held:
                    self._settle_sem.release()
                    self._settle_held -= 1
                while self._settle_held < target_held:
                    if not self._settle_sem.acquire(blocking=False):
                        break  # window occupied: converge next tick
                    self._settle_held += 1
        return self.knob_state()

    @property
    def broken_reason(self) -> Optional[str]:
        """Non-None once the plane is PERMANENTLY unable to commit (the
        lockstep mesh broke: a worker process died or fell out of
        sequence). The controller broker polls this and abdicates —
        controller failover is the recovery path, exactly as for
        controller death (parallel/lockstep.py module docstring)."""
        return getattr(self.fns, "broken", None)

    def _adopt_lockstep_state(self, e: Exception) -> None:
        """A LockstepController call failed AFTER its local launch ran:
        the donated state buffers are gone, and the error carries their
        replacement. Adopt it so the plane stays usable (the error still
        propagates — the round fails loudly with the lockstep-break
        diagnostic, not with confusing donated-buffer errors forever
        after). Caller holds _device_lock."""
        st = getattr(e, "lockstep_result", None)
        if st is None:
            return
        # Engine results are (state, ...) tuples except resync/init_from,
        # which return the state (a NamedTuple — itself a tuple) directly.
        self._state = st if hasattr(st, "_fields") else st[0]

    def _fetch_state(self, field: str) -> np.ndarray:
        """Host copy of one state leaf ([R, P]; the fused layout's named
        leaves are views of its ctrl tensor). The copy waits for every
        round queued before it. The spmd binding (and the lockstep
        controller around it) provides `fetch_state`, an all_gather over
        the mesh; callers must hold _device_lock."""
        fetch = getattr(self.fns, "fetch_state", None)
        if fetch is not None:
            return fetch(self._state, field)
        return _to_host(getattr(self._state, field))

    def busy(self) -> bool:
        """True while rounds are queued or in flight. Duty-loop callers
        use this to defer OPTIONAL device fetches (repair scans): a
        state fetch must wait for every dispatched round to execute —
        while holding the device lock — so fetching on a busy plane
        drains the whole dispatch pipeline (measured as multi-second
        throughput collapses every repair-scan tick)."""
        with self._lock:
            queued = bool(self._appends) or bool(self._offsets)
        return queued or not self._inflight.empty()

    def log_ends(self) -> np.ndarray:
        """Per-replica log ends [R, P] — the lag map the repair loop uses
        to find replicas needing resync."""
        with self._device_lock:
            return self._fetch_state("log_end")

    def current_terms(self) -> np.ndarray:
        """Max observed term per partition [P] (election planners must
        propose above this, or granted-then-unadvertised elections would
        deadlock retries)."""
        with self._device_lock:
            return self._fetch_state("current_term").max(axis=0)

    # ------------------------------------------------------------- submits

    def submit_append(self, slot: int, payloads: list[bytes],
                      pid: int = 0, seq: int = -1, tctx=None) -> Future:
        """Queue payloads for partition `slot`; future resolves to the
        first assigned absolute offset once the round commits.

        `pid`/`seq` (pid > 0) make the submit IDEMPOTENT: a batch whose
        (pid, seq, len) matches a settled entry of the dedup table is
        acked immediately with its original base offset — no second
        append — and a batch identical to one still in flight attaches
        to the in-flight round's future (the wire-dup window: both RPCs
        see the same outcome). The table is replicated through the
        settle path (REC_PIDSEQ records) and rebuilt on boot/promotion
        replay, so the guarantee holds across controller failover. A
        sequence ABOVE the table's end is accepted as new — dedup never
        refuses fresh data, it only collapses replays."""
        fut: Future = Future()
        cfg = self.cfg
        if not 0 <= slot < cfg.partitions:
            fut.set_exception(ValueError(f"partition slot {slot} out of range"))
            return fut
        if not payloads:
            fut.set_exception(ValueError("empty append"))
            return fut
        if len(payloads) > cfg.max_batch:
            # Callers (the broker server) split client batches to fit one
            # round; a single submit never spans rounds.
            fut.set_exception(
                ValueError(
                    f"{len(payloads)} payloads exceed max_batch {cfg.max_batch}"
                )
            )
            return fut
        # Bulk validation (this runs per batch on RPC worker threads —
        # a per-message three-check python loop was a measurable slice
        # of the produce path's CPU): min/max are C-speed passes, and
        # non-bytes payloads fail pack_payload_rows's buffer coercion.
        try:
            lens = [len(m) for m in payloads]
            if min(lens) == 0:
                fut.set_exception(
                    ValueError("empty messages are not supported (length-0 "
                               "rows mark alignment padding)")
                )
                return fut
            if max(lens) > cfg.payload_bytes:
                fut.set_exception(
                    ValueError(
                        f"payload of {max(lens)} bytes exceeds payload_bytes "
                        f"{cfg.payload_bytes}"
                    )
                )
                return fut
            rows = pack_payload_rows(self.cfg, payloads)  # off-lock packing
        except TypeError as e:
            fut.set_exception(
                TypeError(f"payloads must be bytes: {e}")
            )
            return fut
        return self._submit_rows(slot, list(payloads), rows, pid, seq, fut,
                                 tctx)

    def submit_packed(self, slot: int, packed, lens: list[int],
                      pid: int = 0, seq: int = -1, tctx=None) -> Future:
        """Queue a PRE-PACKED append batch: `packed` is the
        `[len(lens), slot_bytes]` row block a host-plane worker already
        validated and packed (parallel/hostplane.py `_pack_rows`, the
        byte-identical twin of pack_payload_rows) — the payload bytes
        cross this boundary once and are never re-encoded. Semantics
        are submit_append's exactly; validation here is only the cheap
        structural re-check (the block shape), since the worker ran the
        per-message checks where packing ran."""
        fut: Future = Future()
        cfg = self.cfg
        SB = cfg.slot_bytes
        k = len(lens)
        if not 0 <= slot < cfg.partitions:
            fut.set_exception(ValueError(f"partition slot {slot} out of range"))
            return fut
        if k == 0 or k > cfg.max_batch or len(packed) != k * SB:
            fut.set_exception(ValueError(
                f"packed block of {len(packed)} bytes does not hold "
                f"{k} rows of {SB} (max_batch {cfg.max_batch})"
            ))
            return fut
        if k and (min(lens) <= 0 or max(lens) > cfg.payload_bytes):
            fut.set_exception(ValueError(
                f"packed row lengths out of (0, {cfg.payload_bytes}]"
            ))
            return fut
        rows = np.frombuffer(packed, np.uint8).reshape(k, SB)
        # Zero-copy payload views into the block (the drain only ever
        # len()s and persists them; the block itself is what rides the
        # round).
        mv = memoryview(packed)
        payloads = [
            mv[i * SB + _HDR : i * SB + _HDR + lens[i]] for i in range(k)
        ]
        return self._submit_rows(slot, payloads, rows, pid, seq, fut, tctx)

    def _submit_rows(self, slot: int, payloads: list, rows,
                     pid: int, seq: int, fut: Future,
                     tctx=None) -> Future:
        """Shared enqueue tail of submit_append / submit_packed (the
        caller validated and packed)."""
        self._m_submits.inc()
        self._m_messages.inc(len(payloads))
        pid, seq = int(pid), int(seq)
        with self._lock:
            if pid > 0:
                dup = self._pid_lookup_locked(pid, slot, seq, len(payloads))
                if dup is not None:
                    fut.set_result(dup)
                    return fut
                inflight = self._pid_inflight.get((pid, slot, seq))
                if inflight is not None:
                    # Same batch, round still in flight (wire dup /
                    # concurrent retry): one append, shared outcome.
                    return inflight
            if self._log_end[slot] >= _OFFSET_HORIZON:
                fut.set_exception(
                    PartitionFullError(
                        f"partition {slot} reached the int32 offset horizon "
                        f"({_OFFSET_HORIZON} rows); re-key onto another "
                        f"partition"
                    )
                )
                return fut
            self._appends.setdefault(slot, []).append(
                _Pending(list(payloads), fut, self.max_retry_rounds, rows,
                         pid=pid, seq=seq,
                         tctx=tctx if self.spans is not None else None)
            )
            if pid > 0:
                # Settled batches are moved to the dedup table — and
                # popped from here — by the settle thread under this
                # same lock, so no dup can slip between the two. FAILED
                # batches are popped at every terminal-failure site
                # (_pid_drop_locked): the producer's retry must
                # re-submit a real append, not attach to a dead future.
                # (Not a done-callback: those run inline at
                # set_exception, and several failure sites already hold
                # this non-reentrant lock.)
                self._pid_inflight[(pid, slot, seq)] = fut
        self._work.set()
        return fut

    def _pid_lookup_locked(self, pid: int, slot: int, seq: int,
                           n: int) -> Optional[int]:
        """Dedup probe (caller holds self._lock): the batch's original
        base offset if (pid, seq, n) replays a settled batch, -1 if it
        falls fully below the settled window without an exact entry
        (still a duplicate — ack it, position forgotten), None if the
        batch is new. A batch extending PAST the settled end is new by
        definition: refusing it could strand fresh data behind a stale
        table after an at-least-once gap."""
        entries = self._pid_tab.get((pid, slot))
        if not entries:
            return None
        if seq + n > entries[-1][1]:
            return None
        for s0, s1, base in reversed(entries):
            if s0 == seq and s1 == seq + n:
                return base
        return -1

    def _pid_drop_locked(self, pend: "_Pending", slot: int) -> None:
        """Drop one TERMINALLY-FAILED batch's in-flight dedup entry
        (caller holds self._lock): nothing settled, so the producer's
        retry must append for real. Guarded by identity — a fresh
        submit may already occupy the key."""
        if pend.pid <= 0:
            return
        key = (pend.pid, slot, pend.seq)
        if self._pid_inflight.get(key) is pend.future:
            self._pid_inflight.pop(key, None)

    def _pid_drop(self, pend: "_Pending", slot: int) -> None:
        if pend.pid > 0:
            with self._lock:
                self._pid_drop_locked(pend, slot)

    def pid_table_size(self) -> int:
        """Number of (pid, partition) keys in the producer dedup table
        (admin.stats surface) — locked accessor, settle thread mutates."""
        with self._lock:
            return len(self._pid_tab)

    def drop_pids(self, pids: set[int]) -> int:
        """Drop the dedup entries of REAPED producer ids (pid expiry,
        OP_RETIRE_PRODUCER): settled-window entries go; in-flight
        entries stay — they belong to LIVE submissions whose futures
        settle through the normal path, and a reaped-mid-flight batch
        keeps its wire-dup protection until it lands. Safe because
        reaped pids are never reissued (the replicated counter is
        monotone), so no new producer can collide with a dropped key.
        Returns how many table keys were dropped."""
        if not pids:
            return 0
        with self._lock:
            drop = [k for k in self._pid_tab if k[0] in pids]
            for k in drop:
                del self._pid_tab[k]
        return len(drop)

    def retain_pids(self, keep: set[int], below: Optional[int] = None
                    ) -> int:
        """Reconciliation sweep: drop dedup entries whose pid is NOT in
        `keep` (the replicated registry) — boot replay rebuilds
        REC_PIDSEQ entries for pids reaped while this broker was down,
        and those would otherwise linger forever. `below` is the
        locally-applied pid counter: a pid >= below belongs to a
        registration THIS replica has not applied yet (the pid space
        is the replicated monotone counter), so its absence from
        `keep` is apply lag, not a reap — never drop it. Returns
        drops."""
        with self._lock:
            drop = [
                k for k in self._pid_tab
                if k[0] not in keep
                and (below is None or k[0] < below)
            ]
            for k in drop:
                del self._pid_tab[k]
        return len(drop)

    def submit_offsets(self, slot: int, updates: list[tuple[int, int]]) -> Future:
        """Queue consumer-offset commits [(consumer_slot, offset)]; the
        future resolves to True when the round commits (offset commits
        replicate through the same quorum round as appends — the
        reference routes them through the same partition Raft log,
        ConsumerOffsetUpdateRequestProcessor.java:38-69)."""
        fut: Future = Future()
        C = self.cfg.max_consumers
        if not 0 <= slot < self.cfg.partitions:
            fut.set_exception(ValueError(f"partition slot {slot} out of range"))
            return fut
        if len(updates) > self.cfg.max_offset_updates:
            # An oversized pending could never fit a round and would wedge
            # the slot's FIFO queue forever.
            fut.set_exception(
                ValueError(
                    f"{len(updates)} offset updates exceed max_offset_updates "
                    f"{self.cfg.max_offset_updates}"
                )
            )
            return fut
        if not updates or any(not 0 <= s < C for s, _ in updates):
            fut.set_exception(ValueError(f"bad consumer slots in {updates}"))
            return fut
        self._m_offsets.inc()
        with self._lock:
            self._offsets.setdefault(slot, []).append(
                _PendingOffsets([(int(s), int(o)) for s, o in updates], fut,
                                self.max_retry_rounds)
            )
        self._work.set()
        return fut

    # --------------------------------------------------------------- reads

    def read(
        self, slot: int, offset: int, replica: int,
        max_msgs: Optional[int] = None,
    ) -> tuple[list[bytes], int]:
        """Committed messages of `slot` from storage offset `offset` as
        seen by `replica`; returns (messages, next_offset). Offsets are
        STORAGE offsets (rounds are ALIGN-padded), so the caller must
        always continue from the returned `next_offset`, never from
        `offset + len(messages)`. Replica-local, no quorum round —
        matching the reference's leader-local reads
        (PartitionStateMachine.handleBatchRead:85) but bounded by the
        commit index (stricter: never serves un-replicated entries).

        Offsets below the retention watermark are served from the round
        store via the log index (only committed rounds are ever
        persisted, so store reads need no commit bound). The HOT window
        — above trim — is served from the host ring mirror with no
        device dispatch (see __init__); only a mirror gap (resolve
        failure) falls through to the device ring. A ring read races
        the step thread — trim can advance and a committed round can
        recycle the window's rows between the watermark check and the
        read — so the watermark is re-checked AFTER the read and a
        covered window is re-served from the store (store records are
        immutable, so that path is race-free). `replica` only selects a
        serving replica on the device paths: the mirror holds the
        COMMITTED prefix, which is replica-invariant by the quorum
        round's log-matching (per-replica divergence exists only above
        commit, which no read path ever serves)."""
        if not 0 <= slot < self.cfg.partitions:
            raise ValueError(f"partition slot {slot} out of range")
        self._m_read_calls.inc()
        gc_races = 0
        while True:
            with self._lock:
                trim = int(self.trim[slot])
                skip_to, _ = self._gap_clamp_locked(slot, offset, 1)
            if skip_to is not None:
                # Inside a settled gap (replication-FAILED round): walk
                # PAST it and keep reading — consumers only advance
                # their committed offset when a batch delivers messages,
                # so an empty-but-advanced answer here would strand them
                # below the gap forever (the same contract as the store
                # path's jump-forward: nacked rows, like padding, are
                # crossed inside ONE read call).
                offset = skip_to
                continue
            if offset < trim and self.log_index is not None:
                try:
                    got = self._read_store(slot, offset, max_msgs)
                except StoreReadRaceError:
                    # Sustained GC churn: records exist but every lookup
                    # lost the race. Retry (bounded) instead of treating
                    # the window as absent — an earliest-reset here
                    # would skip retained rows.
                    gc_races += 1
                    if gc_races > 50:
                        raise
                    time.sleep(0.001)
                    continue
                if got is not None:
                    msgs_got, nxt_got = got
                    if not msgs_got and nxt_got > offset:
                        # An all-padding store window (a persisted
                        # boundary-pad round, or a record clamped at a
                        # gap): keep walking — see the gap comment
                        # above for why empty-but-advanced must not
                        # reach the caller while rows remain.
                        offset = nxt_got
                        continue
                    self._m_read_msgs.inc(len(msgs_got))
                    return got
                # Nothing persisted at-or-after `offset` (store GC can
                # reclaim a partition's entire below-trim history):
                # earliest-reset to the watermark — rows >= trim are
                # ring-resident — or this loop would spin forever.
                offset = trim
            if self._host_ring is not None:
                res = self._read_cache(slot, offset, max_msgs)
                if res is _CACHE_LAPPED:
                    continue  # trim overran the window mid-copy: store-serve
                if res is _CACHE_GAP:
                    # Mirror-gap window: device-probe ONCE per gap
                    # generation (the probe re-validates the window
                    # against the device commit bound), then serve the
                    # store path directly for the gap's remaining
                    # lifetime — settled rows are persisted and indexed
                    # BEFORE they are mirrored (_release_one order), so
                    # the previous per-call device round-trip here was
                    # pure overhead.
                    with self._lock:
                        gen = self._mirror_gap_gen.get(slot, 0)
                        probed = self._gap_probed_gen.get(slot) == gen
                        self._gap_probed_gen[slot] = gen
                    if probed and self.log_index is not None:
                        try:
                            got = self._read_store(slot, offset, max_msgs)
                        except StoreReadRaceError:
                            got = None  # GC churn: the device re-serves
                        if got is not None:
                            msgs_got, nxt_got = got
                            if not msgs_got and nxt_got > offset:
                                offset = nxt_got  # all-padding: walk on
                                continue
                            self._m_read_msgs.inc(len(msgs_got))
                            return got
                    res = None  # first probe this gap: device authority
                if res is not None:
                    msgs_res, nxt_res = res
                    if not msgs_res and nxt_res > offset:
                        offset = nxt_res  # all-padding window: keep walking
                        continue
                    self.read_cache_hits += 1
                    self._m_read_msgs.inc(len(msgs_res))
                    return res
            fut: Future = Future()
            with self._read_lock:
                if self._stop.is_set():
                    # stop() already drained stranded reads; enqueueing
                    # now would hang this caller forever.
                    raise NotCommittedError("data plane stopped")
                self._reads.append((slot, offset, replica, fut))
            self._read_work.set()
            data, lens, count = fut.result()
            # Clamp to the settled horizon: the device's commit index
            # includes rounds whose replication may still fail — those
            # rows are nacked and must stay invisible (see _resolve_one).
            # Settled GAPS (replication-FAILED rounds the horizon later
            # passed) are skipped the same way: inside a gap the read
            # serves nothing and jumps to its end; a window reaching a
            # gap stops at its begin.
            count = int(count)
            with self._lock:
                settled_room = max(0, int(self._settled_end[slot]) - offset)
                skip_to, gap_room = self._gap_clamp_locked(
                    slot, offset, count
                )
            if skip_to is not None:
                offset = skip_to  # raced into a gap recorded mid-read
                continue
            count = min(count, settled_room, gap_room)
            with_pos = decode_entries_with_pos(data, lens, count)
            with self._lock:
                trim_after = int(self.trim[slot])
            if trim_after > offset and self.log_index is not None:
                # trim advanced past this window mid-read: its ring rows
                # may hold the next lap now — retry (store-serves next).
                continue
            if not with_pos and 0 < count < settled_room:
                # All-padding window short of the horizon (clamped at a
                # settled gap, or a boundary-pad round): walk on — an
                # empty-but-advanced answer must not reach the caller
                # while settled rows remain above (see the gap comment
                # at the loop head).
                offset += count
                continue
            break
        count = int(count)
        if max_msgs is not None and len(with_pos) > max(0, max_msgs):
            with_pos = with_pos[: max(0, max_msgs)]
            # Continue right after the last returned message's row.
            next_offset = offset + (with_pos[-1][0] + 1 if with_pos else 0)
        else:
            next_offset = offset + count
        self._m_read_msgs.inc(len(with_pos))
        return [m for _, m in with_pos], next_offset

    def _read_cache(
        self, slot: int, offset: int, max_msgs: Optional[int]
    ) -> Optional[tuple[list[bytes], int]]:
        """Serve one hot read from the host ring mirror. Returns the
        (messages, next_offset) result, None to fall through to the
        device (dirty log-end shadow: the device commit bound is the
        authority), _CACHE_GAP when the offset sits in a mirror-gap
        window (resolve failure — caller probes the device once per gap
        generation, then store-serves), or _CACHE_LAPPED when trim
        overran the window mid-copy (caller retries; the next pass
        store-serves). An offset at-or-past the SETTLED end answers
        empty WITHOUT device dispatch: reads may never see past the
        settled horizon anyway (a device dispatch would clamp to it and
        return the same emptiness), so tail polls stay host-authoritative
        even while the settle pipeline holds committed-but-unsettled
        rounds in flight."""
        S = self.cfg.slots
        with self._lock:
            end = int(self._settled_end[slot])
            cend = int(self._cache_end[slot])
            dirty = slot in self._shadow_dirty
            skip_to, gap_room = self._gap_clamp_locked(
                slot, offset, self.cfg.read_batch
            )
        if dirty:
            # A resolve failed with the slot's round outcome unknown:
            # the log-end shadow may TRAIL device-committed rows until
            # the next drain re-derives it, so an empty answer here
            # could hide a committed suffix indefinitely on an idle
            # partition. The device path's commit bound is the
            # authority.
            return None
        if skip_to is not None:
            # Inside a settled gap (replication-FAILED round): nothing
            # to serve, continue past it — host-authoritative, same as
            # the at-horizon empty answer below.
            return [], skip_to
        if offset >= end:
            return [], offset  # caught up: nothing committed past offset
        if offset >= cend:
            return _CACHE_GAP  # mirror gap: store/device is the authority
        pos = offset % S
        k = min(end - offset, cend - offset, self.cfg.read_batch, gap_room)
        if pos + k <= S:
            rows = self._host_ring[slot, pos : pos + k].copy()
        else:  # window spans the ring wrap, same as the device read
            rows = np.concatenate([
                self._host_ring[slot, pos:],
                self._host_ring[slot, : pos + k - S],
            ])
        with self._lock:
            lapped = int(self.trim[slot]) > offset
        if lapped and self.log_index is not None:
            return _CACHE_LAPPED  # rows may hold the next lap now
        # Decode on flat bytes: one tobytes() for the window, then
        # length-prefixed slices — ~3x the msgs/s of per-row numpy
        # slicing on the host-RAM-bound consume path.
        SB = self.cfg.slot_bytes
        lens = np.minimum(_row_lens(rows), SB - _HDR)
        flat = rows.tobytes()
        # Lengths are clamped to the row capacity above — a corrupt
        # length header must not bleed the next row's bytes into a
        # message (the device/store decode paths clamp per row too).
        with_pos = [
            (i, flat[i * SB + _HDR : i * SB + _HDR + n])
            for i, n in enumerate(lens.tolist())
            if n > 0
        ]
        if max_msgs is not None and len(with_pos) > max(0, max_msgs):
            with_pos = with_pos[: max(0, max_msgs)]
            next_offset = offset + (with_pos[-1][0] + 1 if with_pos else 0)
        else:
            next_offset = offset + k
        return [m for _, m in with_pos], next_offset

    def _read_store(
        self, slot: int, offset: int, max_msgs: Optional[int]
    ) -> Optional[tuple[list[bytes], int]]:
        """Serve one read below the retention watermark from the round
        store: find the append record holding `offset` (or the next one —
        a consumer below the earliest retained record jumps forward, the
        documented earliest-reset semantics), seek-read its rows, decode.
        Serves from ONE record per call; the caller's next_offset loop
        walks forward and falls back to the device ring once past the
        watermark. Returns None if nothing is indexed at-or-after offset
        (caller falls through to the ring)."""
        SB = self.cfg.slot_bytes
        for _ in range(4):  # bounded GC-race retries (one per deleted seg)
            entry = self.log_index.find(slot, offset)
            floor = self.log_index.floor(slot)
            if floor is not None and offset < floor:
                # Below the bounded index's floor: records may exist in
                # the store that fell out of the index — only a scan can
                # tell.
                try:
                    scanned = self._scan_store_for(slot, offset)
                except FileNotFoundError:
                    # Store GC deleted a segment mid-walk: rebuild the
                    # scan from the surviving files on the next pass.
                    with self._lock:
                        self._scan_index = None
                    continue
                if scanned is not None:
                    entry = scanned
            if entry is None:
                return None
            base, nrows, locator = entry
            eff = max(offset, base)  # jump to the earliest retained record
            row = eff - base
            k = min(nrows - row, self.cfg.read_batch)
            if k <= 0:
                return None
            # Settled-gap clamp, store edition: a LOCAL store never holds
            # gap rows (failed rounds are not persisted here), but a
            # promoted standby's can, and the trim watermark passing a
            # gap after a ring wrap must not let the store re-expose
            # rows every other path refuses.
            with self._lock:
                skip_to, k = self._gap_clamp_locked(slot, eff, k)
            if skip_to is not None:
                return [], skip_to
            try:
                data = self.store.read_payload(locator, row * SB, k * SB)
            except FileNotFoundError:
                # Store GC deleted the backing segment between lookup and
                # read: drop its stale entries (this also clears the scan
                # cache) and redo the FULL lookup, including the
                # below-floor scan path. Other OSErrors (truncation or
                # corruption of a RETAINED segment) must surface, not be
                # mistaken for deliberate deletion.
                seg = locator[0] if isinstance(locator, tuple) else None
                if seg is None:
                    raise
                self.drop_index_segments({seg})
                continue
            offset = eff
            break
        else:
            # Exhausted the per-call retry budget WITH a record found
            # each time: that is GC churn, not absence — the caller must
            # not earliest-reset over it.
            raise StoreReadRaceError(
                f"partition {slot} offset {offset}: store read lost the "
                f"GC race 4 times"
            )
        rows = np.frombuffer(data, np.uint8).reshape(k, SB)
        lens = _row_lens(rows)  # one host header decoder
        with_pos = decode_entries_with_pos(rows, lens, k)
        if max_msgs is not None and len(with_pos) > max(0, max_msgs):
            with_pos = with_pos[: max(0, max_msgs)]
            next_offset = offset + (with_pos[-1][0] + 1 if with_pos else 0)
        else:
            next_offset = offset + k
        return [m for _, m in with_pos], next_offset

    def read_offset(self, slot: int, consumer_slot: int, replica: int = 0) -> int:
        """Committed consumer offset — served from the host shadow of the
        replicated table (every offset commit passes through this host's
        rounds, and install() seeds the shadow from the recovered image,
        so the shadow is exact). `replica` is kept for API compatibility;
        no device fetch happens."""
        del replica
        if not 0 <= slot < self.cfg.partitions:
            raise ValueError(f"partition slot {slot} out of range")
        if not 0 <= consumer_slot < self.cfg.max_consumers:
            raise ValueError(f"consumer slot {consumer_slot} out of range")
        with self._lock:
            return int(self._offsets_shadow[slot, consumer_slot])

    def warm(self, buckets: tuple[int, ...] = (8, 32)) -> None:
        """Compile the hot programs before traffic needs them: the sparse
        single and chained rounds at the given active-set buckets, and
        the batched read. Dispatches no-op rounds of those exact shapes
        (counts 0, all-padding ids: nothing commits, state is
        semantically unchanged). Safe concurrently with traffic (device
        lock); brokers kick this in the background at boot so the first
        produce doesn't pay the first-call costs (the reference's
        multi-second XLA compile; here the append kernel's build and the
        allocators' first blocks)."""
        cfg = self.cfg
        P, B, SB, U = (cfg.partitions, cfg.max_batch, cfg.slot_bytes,
                       cfg.max_offset_updates)
        noop = StepInput(
            entries=self._dummy_entries(),
            counts=np.zeros((P,), np.int32),
            off_slots=np.zeros((P, U), np.int32),
            off_vals=np.zeros((P, U), np.int32),
            off_counts=np.zeros((P,), np.int32),
            leader=np.zeros((P,), np.int32),
            term=np.zeros((P,), np.int32),
            extents=np.zeros((P,), np.int32),
        )
        alive = np.ones((P, cfg.replicas), bool)
        K = self.chain_depth
        stacked = StepInput(*[
            np.broadcast_to(np.asarray(f), (K,) + np.asarray(f).shape).copy()
            for f in noop
        ])
        dev = self._arg_device
        for A in buckets:
            if self._stop.is_set():
                return  # fenced/stopped mid-warm: the programs are moot
            A = max(1, min(A, P))
            # One lock hold per dispatch: elections/traffic (takeover
            # duty) interleave between the warm-up calls instead of
            # stalling behind a whole bucket's pair.
            args = (self._stage_input(noop),
                    _stage(np.zeros((A, B, SB), np.uint8), dev),
                    _stage(np.full((A,), -1, np.int32), dev),
                    _stage(alive, dev))
            with self._device_lock:
                try:
                    self._state, _ = self.fns.step_sparse(self._state, *args)
                except Exception as e:
                    self._adopt_lockstep_state(e)
                    raise
            if K > 1 and not self._stop.is_set():
                args = (self._stage_input(stacked),
                        _stage(np.zeros((K, A, B, SB), np.uint8), dev),
                        _stage(np.full((K, A), -1, np.int32), dev),
                        _stage(alive, dev))
                with self._device_lock:
                    try:
                        self._state, _ = self.fns.step_many_sparse(
                            self._state, *args)
                    except Exception as e:
                        self._adopt_lockstep_state(e)
                        raise
        if self._stop.is_set():
            return
        zeros = _stage(np.zeros((self.read_q,), np.int32), dev)
        with self._device_lock:
            self.fns.read_many(self._state, zeros, zeros, zeros)

    def _stage_input(self, inp: StepInput) -> StepInput:
        """A round's (or chain's) host StepInput on the engine's device,
        leaf by leaf through `_stage`."""
        return StepInput(*(None if x is None else _stage(x, self._arg_device)
                           for x in inp))

    def warm_async(self, buckets: tuple[int, ...] = (8, 32),
                   delay_s: float = 0.0) -> threading.Thread:
        """warm() on a daemon thread (boot path); errors are logged, never
        raised — warming is an optimization, not a correctness step.
        `delay_s` defers the first compile so latency-critical boot work
        (a promoted controller's first election pass) wins the device-
        lock race; the thread exits early if the plane stops meanwhile."""
        def run() -> None:
            if delay_s > 0 and self._stop.wait(timeout=delay_s):
                return
            try:
                self.warm(buckets)
            except Exception as e:
                log.warning("program warm-up failed: %s: %s",
                            type(e).__name__, e)

        t = threading.Thread(target=run, daemon=True, name="dataplane-warm")
        t.start()
        return t

    def _read_loop(self) -> None:
        """Read-coalescer thread: drain queued device reads as read_many
        batches of up to read_q queries (padded to a fixed Q so exactly
        one program compiles)."""
        Q = self.read_q
        while not self._stop.is_set():
            if not self._read_work.wait(timeout=0.05):
                continue
            if self.read_coalesce_s > 0:
                with self._read_lock:
                    n = len(self._reads)
                if 0 < n < Q:
                    time.sleep(self.read_coalesce_s)  # assemble the cohort
            with self._read_lock:
                batch = self._reads[:Q]
                del self._reads[:Q]
                if not self._reads:
                    self._read_work.clear()
            if not batch:
                continue
            self.read_dispatches += 1
            self.read_queries += len(batch)
            reps = np.zeros((Q,), np.int32)
            parts = np.zeros((Q,), np.int32)
            offs = np.zeros((Q,), np.int32)
            for i, (slot, offset, replica, _) in enumerate(batch):
                reps[i], parts[i], offs[i] = replica, slot, offset
            try:
                reps, parts, offs = (_stage(x, self._arg_device) for x in (reps, parts, offs))
                with self._device_lock:
                    data, lens, count = self.fns.read_many(
                        self._state, reps, parts, offs
                    )
                    data = _to_host(data)
                    lens = _to_host(lens)
                    count = _to_host(count)
            except Exception as e:
                for *_, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for i, (_, _, _, fut) in enumerate(batch):
                if not fut.done():
                    fut.set_result((data[i], lens[i], int(count[i])))

    def drop_index_segments(self, seg_indices: set[int]) -> None:
        """Store GC deleted these segments: prune their entries from the
        retention indexes (reads below the remaining floor jump forward
        to the earliest retained record)."""
        if self.log_index is None or not seg_indices:
            return
        self.log_index.prune(
            lambda loc: isinstance(loc, tuple) and loc[0] in seg_indices
        )
        with self._lock:
            self._scan_index = None

    def _scan_store_for(
        self, slot: int, offset: int
    ) -> Optional[tuple[int, int, object]]:
        """Slow path behind the bounded index: one full framing walk of
        the store builds an UNBOUNDED throwaway LogIndex (same add()
        truncation semantics as the live one), cached until the next
        install(). Records below the live index's floor are immutable
        (later-records-win regressions only touch unsettled tail rounds),
        so serving a whole catch-up from one scan is sound; entries the
        cache lacks (appended after the scan) live above the floor and
        are served by the live index. Only reachable for consumers
        lagging by more than the index's per-slot entry cap."""
        def build():
            import sys as _sys

            from ripplemq_tpu_torch.storage.logindex import LogIndex

            idx = LogIndex(max_entries_per_slot=_sys.maxsize)
            idx.load(self.store.scan_indexed(), self.cfg.slot_bytes,
                     REC_APPEND)
            return idx

        # LOCAL-REF discipline (the reference's ownership lint): concurrent
        # lagging readers run this on RPC worker threads while store GC
        # (drop_index_segments, duty thread) and install() null the
        # cache under the plane's lock. Re-reading `self._scan_index`
        # between the rebuild and the find raced that invalidation —
        # a None landing in between raised AttributeError out of a
        # consume (tests/test_concurrency_triage.py::
        # test_scan_index_local_ref_race is the reference's directed
        # repro). Every lookup runs against a local
        # reference; the shared slot is only SWAPPED, under the lock.
        idx = self._scan_index
        if idx is None:
            idx = build()
            with self._lock:
                self._scan_index = idx
        entry = idx.find(slot, offset)
        if entry is None or not entry[0] <= offset < entry[0] + entry[1]:
            # The cached scan predates records that have since fallen out
            # of the bounded live index (its floor rose past them) — a
            # non-covering answer here could silently jump a consumer
            # over store-resident data. Rebuild once from the current
            # store before trusting it.
            idx = build()
            with self._lock:
                self._scan_index = idx
            entry = idx.find(slot, offset)
        return entry

    def slot_detail(self, slots) -> dict[str, dict[str, int]]:
        """Per-slot observability snapshot: the COMMIT leaf fetched from
        the device (one fetch for all requested slots — not log_end
        relabeled), plus the host log-end shadow and trim watermark read
        together under the control lock so the host pair is mutually
        consistent. Commit and the host pair are separate snapshots with
        rounds possibly landing between them, so either may lead the
        other by in-flight rounds — treat a small commit/log_end skew as
        pipelining, not corruption."""
        with self._device_lock:
            commit = self._fetch_state("commit").max(axis=0)  # [P]
        with self._lock:
            ends = self._log_end.copy()
            trim = self.trim.copy()
        out = {}
        for s in slots:
            s = int(s)
            if 0 <= s < self.cfg.partitions:
                out[str(s)] = {
                    "commit": int(commit[s]),
                    "log_end": int(ends[s]),
                    "trim": int(trim[s]),
                }
        return out

    def commit_index(self, slot: int) -> int:
        """Max commit index across replicas (the leader's view)."""
        with self._device_lock:
            commit = self._fetch_state("commit")  # [R, P]
        return int(commit[:, slot].max())

    # ----------------------------------------------------------- elections

    def elect(self, candidates: dict[int, tuple[int, int]]) -> dict[int, bool]:
        """One batched RequestVote round. `candidates` maps partition slot
        -> (candidate replica slot, proposed term). Returns slot -> elected.
        Many partitions elect in a single device round."""
        P = self.cfg.partitions
        cand = np.full((P,), -1, np.int32)
        cterm = np.zeros((P,), np.int32)
        for slot, (c, t) in candidates.items():
            cand[slot] = c
            cterm[slot] = t
        with self._lock:
            alive = self.alive.copy()
            quorum = self.quorum.copy()
        args = [_stage(x, self._arg_device) for x in (cand, cterm, alive, quorum)]
        with self._device_lock:
            try:
                self._state, elected, votes = self.fns.vote(
                    self._state, *args
                )
            except Exception as e:
                self._adopt_lockstep_state(e)
                raise
            elected = _to_host(elected)
        out = {slot: bool(elected[slot]) for slot in candidates}
        self.recorder.record(
            "elect", candidates=len(candidates),
            won=sum(1 for w in out.values() if w),
            slots=[int(s) for s in sorted(candidates)][:32],
        )
        return out

    def resync(self, src_slot: int, dst_slot: int, partitions: list[int]) -> None:
        """Copy `src_slot`'s replica state over `dst_slot` for the given
        partitions (recovering replica catch-up)."""
        mask = np.zeros((self.cfg.partitions,), bool)
        mask[list(partitions)] = True
        mask = _stage(mask, self._arg_device)
        with self._device_lock:
            try:
                self._state = self.fns.resync(
                    self._state, np.int32(src_slot), np.int32(dst_slot), mask
                )
            except Exception as e:
                self._adopt_lockstep_state(e)
                raise

    # ---------------------------------------------------------- step thread

    def _drain(self) -> Optional[tuple[StepInput, dict]]:
        """Build one dispatch's worth of rounds from the queues — up to
        `chain_depth` CHAINED rounds when the backlog is deep (one
        device launch commits them all via the engine's scan path; see
        parallel.engine step_many). Returns None if idle.

        Chained rounds may take several pendings of the SAME slot (the
        device executes the chain in order, so per-slot FIFO holds). The
        per-slot committed-prefix property of a chain (alive/quorum/trim
        are chain-constant, so once a slot's round fails every later one
        does too) makes the predicted bases exact for every committed
        round."""
        cfg = self.cfg
        with self._lock:
            if not self._appends and not self._offsets:
                return None
            dirty = self._shadow_dirty & set(self._appends)
        if dirty:
            # Re-derive failed-resolve slots' shadow from the device (one
            # fetch covers all of them; their values are stable — a dirty
            # slot is never busy when drained).
            ends = self.log_ends().max(axis=0)
            with self._lock:
                for s in dirty:
                    self._log_end[s] = int(ends[s])
                self._shadow_dirty -= dirty
        with self._lock:
            pred_end: dict[int, int] = {}
            rounds = []
            for _ in range(self.chain_depth):
                r = self._build_round_locked(pred_end)
                if r is None:
                    break
                rounds.append(r)
            if not rounds:
                return None
            alive = self.alive.copy()
            quorum = self.quorum.copy()
            trim = self.trim.astype(np.int32)
            if len(rounds) > 1:
                # Pad to exactly chain_depth rounds (all-zero rounds
                # carry no work and commit nothing) so chain programs
                # compile once per active-set bucket, not per length.
                # Zero tensors are a shared cached template (np.stack
                # below copies them out; nothing ever writes them), and
                # the leader/term snapshot happens HERE, under the lock,
                # consistent with the chain's real rounds.
                zero = self._zero_round_template()
                pad_inp = StepInput(self._dummy_entries(), *zero,
                                    leader=self.leader.copy(),
                                    term=self.term.copy(),
                                    extents=zero[0])
                while len(rounds) < self.chain_depth:
                    rounds.append((
                        pad_inp,
                        {"appends": {}, "offsets": {}, "bases": {},
                         "entries": {}, "counts": {}},
                    ))
        chain = [r[1] for r in rounds]
        # Compact active-set arrays: one [A, B, SB] block stack + global
        # slot ids per round (A = shared bucket over the chain so the
        # stacked shape is uniform; -1 pads). This is the ONLY bulk
        # device input — a sparse round ships A/P of the dense bytes.
        B, SB = cfg.max_batch, cfg.slot_bytes
        A = self._active_bucket(max(len(rc["entries"]) for rc in chain))
        ec = np.zeros((len(chain), A, B, SB), np.uint8)
        ids = np.full((len(chain), A), -1, np.int32)
        for k, rc in enumerate(chain):
            for a, (slot, block) in enumerate(sorted(rc["entries"].items())):
                ec[k, a] = block
                ids[k, a] = slot
        if len(rounds) == 1:
            inp = rounds[0][0]
            entries_c, slot_ids = ec[0], ids[0]
        else:
            inp = StepInput(*[
                np.stack([np.asarray(getattr(r[0], f)) for r in rounds])
                for f in StepInput._fields
            ])
            entries_c, slot_ids = ec, ids
        # Top-level unions drive busy bookkeeping and whole-dispatch
        # failure paths (_fail_round, shadow-dirty marking).
        union_a: dict[int, list] = {}
        union_o: dict[int, list] = {}
        for rc in chain:
            for slot, taken in rc["appends"].items():
                union_a.setdefault(slot, []).extend(taken)
            for slot, toff in rc["offsets"].items():
                union_o.setdefault(slot, []).extend(toff)
        return inp, {"chain": chain, "appends": union_a, "offsets": union_o,
                     "entries_c": entries_c, "slot_ids": slot_ids,
                     "alive": alive, "quorum": quorum, "trim": trim}

    def _zero_round_template(self):
        """Shared all-zero (counts, off_slots, off_vals, off_counts)
        arrays for chain padding — read-only by contract (np.stack
        copies them into the dispatch tensor)."""
        if self._zero_round is None:
            cfg = self.cfg
            P, U = cfg.partitions, cfg.max_offset_updates
            self._zero_round = (
                np.zeros((P,), np.int32),
                np.zeros((P, U), np.int32),
                np.zeros((P, U), np.int32),
                np.zeros((P,), np.int32),
            )
        return self._zero_round

    def _dummy_entries(self) -> np.ndarray:
        """The StepInput entries placeholder: the control phase never
        reads entries, and the real rows travel compacted (active-set;
        see _drain). Shaped [P, 1, 1] so the spmd binding can shard its
        leading axis like the dense field it replaces. Built eagerly in
        __init__ (multiple threads reach this; a lazy build here was an
        unguarded shared write — the reference's ownership lint)."""
        return self._dummy

    def _active_bucket(self, n: int) -> int:
        """Smallest active-set capacity bucket >= n (8, 32, 128, ... up
        to P): rounds compile once per bucket, not once per active
        count."""
        a = 8
        while a < n:
            a *= 4
        return max(1, min(a, self.cfg.partitions))

    def all_buckets(self) -> tuple[int, ...]:
        """Every active-set bucket this shape can hit — the boot-time
        warm list (in the reference, a bucket first reached under
        traffic charged its multi-second XLA compile to live produces;
        the port keeps the shapes, so the list is the same).
        Derived FROM _active_bucket so the ladder geometry lives in one
        place: sweep n over doubling active counts up to P and collect
        the buckets they map to."""
        P = self.cfg.partitions
        out = []
        n = 1
        while n < P:
            out.append(self._active_bucket(n))
            n *= 2
        out.append(self._active_bucket(P))
        return tuple(dict.fromkeys(out))

    def _build_round_locked(self, pred_end: dict[int, int]):
        """Build ONE round from the queues (caller holds self._lock).
        `pred_end` carries the chain's predicted per-slot log ends —
        exact for committed rounds by the chain prefix property. Returns
        (StepInput, round_ctx) or None if nothing drainable remains."""
        cfg = self.cfg
        P, B, SB, U = cfg.partitions, cfg.max_batch, cfg.slot_bytes, cfg.max_offset_updates
        # Active-set rounds: packed [B, SB] blocks per appending slot
        # (compact device input + the bytes the resolver persists); the
        # StepInput ships only a tiny dummy in the entries field.
        blocks: dict[int, np.ndarray] = {}
        counts = np.zeros((P,), np.int32)
        off_slots = np.zeros((P, U), np.int32)
        off_vals = np.zeros((P, U), np.int32)
        off_counts = np.zeros((P,), np.int32)
        # round_appends: slot -> [(pending, start, n)] taken this round
        round_appends: dict[int, list[tuple[_Pending, int, int]]] = {}
        round_offsets: dict[int, list[_PendingOffsets]] = {}
        # Drain-time log-end shadow per append slot — the round's
        # base, known without a device fetch (see pipeline comment).
        round_bases: dict[int, int] = {}

        S = cfg.slots
        can_trim = self.store is not None and self.log_index is not None
        for slot, queue in list(self._appends.items()):
            if slot in self._busy_a:
                continue  # rounds of PRIOR dispatches stay ordered
            end = pred_end.get(slot, int(self._log_end[slot]))
            if end >= _OFFSET_HORIZON:
                if slot in pred_end:
                    # Predicted (an earlier chain round advanced it) —
                    # not authoritative: if that round loses quorum the
                    # real end stays below the horizon, so just stop
                    # chaining this slot; the next dispatch re-checks
                    # against the exact shadow.
                    continue
                # Authoritative horizon check (submit_append's check
                # races a deep backlog: it compares against a shadow
                # that only advances at resolve time). `end` here is
                # exact — the slot is not busy and untouched this chain.
                for pend in queue:
                    self._pid_drop_locked(pend, slot)
                    if not pend.future.done():  # caller may cancel()
                        pend.future.set_exception(PartitionFullError(
                            f"partition {slot} reached the int32 "
                            f"offset horizon; re-key onto another "
                            f"partition"
                        ))
                self._appends.pop(slot, None)
                continue
            if can_trim:
                # Lazy retention: raise the trim watermark just enough
                # for a full window past the current end — but never
                # above the PERSISTED prefix (self._persisted). `end` may
                # be chain-predicted rounds ahead of what the resolver
                # has persisted; an unclamped raise could let a
                # concurrent read find nothing in the store below the
                # watermark and silently skip committed rows. Clamped,
                # a deep chain that outruns the ring simply fails the
                # device capacity check on its later rounds and
                # retries next dispatch.
                needed = min(end + B - S, int(self._persisted[slot]))
                if needed > self.trim[slot]:
                    self.trim[slot] = needed
                # Rounds must never lap the ring boundary (live rows
                # would land in the wrap margin): cap this round's
                # batch at the rows left before the boundary.
                cap = min(B, S - end % S)
            else:
                cap = B  # store-less: bounded log, old behavior
            taken: list[tuple[_Pending, int, int]] = []
            fill = 0
            while queue and fill + len(queue[0].payloads) <= cap:
                pend = queue.pop(0)
                n = len(pend.payloads)
                taken.append((pend, fill, n))
                fill += n
            if taken:
                # Assemble pre-packed row blocks (C memcpys), then stamp
                # the round term over every row — padding included — in
                # one vectorized write. No per-message work here.
                block = np.zeros((B, SB), np.uint8)
                for pend, start, n in taken:
                    block[start : start + n] = pend.rows
                stamp_term(block, int(self.term[slot]))
                blocks[slot] = block
                counts[slot] = fill
                round_appends[slot] = taken
                round_bases[slot] = end
                adv = -(-fill // ALIGN) * ALIGN
                pred_end[slot] = end + adv
            elif queue and can_trim:
                # The queue head cannot fit before the ring boundary:
                # submit a boundary-padding round (length-0 rows carry
                # the term; decode skips them) so the next round
                # starts the lap at ring position 0.
                pad = S - end % S  # < B here (head <= B did not fit)
                block = np.zeros((B, SB), np.uint8)
                stamp_term(block, int(self.term[slot]))
                blocks[slot] = block
                counts[slot] = pad
                round_appends[slot] = []
                round_bases[slot] = end
                pred_end[slot] = end + pad
            if not queue:
                self._appends.pop(slot, None)

        for slot, queue in list(self._offsets.items()):
            if slot in self._busy_o:
                continue
            taken_off: list[_PendingOffsets] = []
            fill = 0
            while queue and fill + len(queue[0].payloads) <= U:
                pend = queue.pop(0)
                for i, (cslot, off) in enumerate(pend.payloads):
                    off_slots[slot, fill + i] = cslot
                    off_vals[slot, fill + i] = off
                fill += len(pend.payloads)
                taken_off.append(pend)
            if taken_off:
                off_counts[slot] = fill
                round_offsets[slot] = taken_off
            if not queue:
                self._offsets.pop(slot, None)

        if not round_appends and not round_offsets:
            return None
        inp = StepInput(
            entries=self._dummy_entries(),
            counts=counts,
            off_slots=off_slots,
            off_vals=off_vals,
            off_counts=off_counts,
            leader=self.leader.copy(),
            term=self.term.copy(),
            # Rows this round's write must cover (packed_writes clips
            # the append DMA to this; boundary-padding rounds count
            # their padding in `counts`, so the extent covers them too).
            extents=row_extents(counts),
        )
        return inp, {"appends": round_appends, "offsets": round_offsets,
                     "bases": round_bases, "entries": blocks,
                     "counts": {s: int(counts[s]) for s in blocks}}

    def _run(self) -> None:
        """Step thread: drain → dispatch → hand off to the resolver."""
        while not self._stop.is_set():
            ctx = None
            try:
                if self.coalesce_s > 0:
                    with self._lock:
                        # Only pendings on non-busy slots count: queues
                        # behind an in-flight round cannot be drained this
                        # iteration, so sleeping for them delays the
                        # drainable work (and offset commits) for nothing.
                        npend = sum(
                            len(q) for slot, q in self._appends.items()
                            if slot not in self._busy_a
                        )
                    if 0 < npend < self.cfg.max_batch:
                        time.sleep(self.coalesce_s)  # gather the burst
                work = self._drain()
                if work is None:
                    self._work.clear()
                    # Short timeout: pendings for busy slots become
                    # drainable when the resolver clears the slot, which
                    # does not set the work event.
                    self._work.wait(timeout=0.02)
                    continue
                inp, ctx = work
                t_dispatch = self.metrics.clock()
                # The round's inputs go to the device as queued copies
                # (pinned staging), so this thread never waits for the
                # rounds already in flight.
                args = (self._stage_input(inp),) + tuple(
                    _stage(ctx[k], self._arg_device) for k in ("entries_c", "slot_ids",
                                                "alive", "quorum", "trim"))
                step = (self.fns.step_sparse if len(ctx["chain"]) == 1
                        else self.fns.step_many_sparse)
                with self._device_lock:
                    try:
                        self._state, out = step(self._state, *args)
                    except Exception as e:
                        self._adopt_lockstep_state(e)
                        raise
                    # Queued right behind the dispatch on its stream; the
                    # resolver waits on this fetch's event alone.
                    fetch = _CommittedFetch(out.committed)
                self.dispatches += 1
                live_rounds = sum(
                    1 for rc in ctx["chain"]
                    if rc["appends"] or rc["offsets"]
                )
                self.rounds += live_rounds
                # Stage 1 of the round-lifecycle decomposition: the
                # (async) device launch call. Stamp t_dispatch in the
                # ctx so the downstream stages (commit fetch, settle
                # entry, acks, persist, release) measure against it.
                t_dispatched = self.metrics.clock()
                self._m_dispatch_us.observe(t_dispatched - t_dispatch)
                self._m_chain_rounds.observe_int(live_rounds)
                ctx["t_dispatch"] = t_dispatch
                ctx["t_dispatched"] = t_dispatched
                self.recorder.record(
                    "dispatch", round_seq=self._dispatch_seq,
                    rounds=live_rounds,
                    slots=len(ctx["appends"]) + len(ctx["offsets"]),
                )
                with self._lock:
                    self._busy_a |= ctx["appends"].keys()
                    self._busy_o |= ctx["offsets"].keys()
                # Settle-pipeline turn: assigned only to dispatches that
                # reach the resolvers (a seq that never arrives would
                # stall the turnstile forever).
                ctx["seq"] = self._dispatch_seq
                self._dispatch_seq += 1
                # Blocks at pipeline_depth outstanding rounds (backpressure).
                self._inflight.put((inp, ctx, fetch))
                ctx = None  # now owned by the resolver
            except Exception as e:  # the step thread must never die: fail
                # this round's futures and keep serving (one bad round must
                # not wedge the whole data plane).
                with self._lock:  # counters race the resolver threads
                    self.step_errors += 1
                log.warning("step thread error: %s: %s", type(e).__name__, e)
                if ctx is not None:
                    with self._lock:
                        self._busy_a -= ctx["appends"].keys()
                        self._busy_o -= ctx["offsets"].keys()
                        # The failure may postdate device dispatch (e.g.
                        # the committed fetch's copy or event raised),
                        # so the round's outcome is unknown: re-derive
                        # these slots' shadow before their next round.
                        self._shadow_dirty |= ctx["appends"].keys()
                    self._fail_round(ctx, e)

    def _resolve_loop(self) -> None:
        """Resolver thread: land rounds — several run concurrently, so
        landing order is only guaranteed PER SLOT (in-flight rounds touch
        disjoint slots; see the pipeline comment in __init__), not across
        slots. Resolvers stop at the settle handoff: the blocking
        standby-ack wait lives in the settle thread (_settle_loop)."""
        while True:
            try:
                item = self._inflight.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set() and not self._thread.is_alive():
                    return
                continue
            self._resolve_one(*item)

    def _resolve_one(self, inp: StepInput, ctx: dict,
                     fetch: _CommittedFetch) -> None:
        """Fetch one dispatch's outputs (blocking), nack/requeue its
        UNCOMMITTED rounds, and hand the committed work to the settle
        pipeline. Fetch failures fail the whole dispatch here. The
        uncommitted nack runs while the slots are still busy, so retry
        requeues land at the queue front before drain can take later
        submits for the same slot (per-slot FIFO); the busy bits then
        clear at the settle HANDOFF — the device may advance a slot
        whose standby replication is still in flight (the pipelined
        settle window), with reads gated on _settled_end as ever."""
        seq = ctx["seq"]
        entry = None
        try:
            committed = fetch.result()  # the ONE device fetch
            # Stage 2: dispatch → committed-fetch landed (device execute
            # + D2H). Wall time since the launch, so queueing behind
            # other dispatches is IN the number — this is the latency a
            # producer's round actually experiences.
            ctx["t_commit"] = self.metrics.clock()
            self._m_commit_wait_us.observe(ctx["t_commit"]
                                           - ctx["t_dispatch"])
            if committed.ndim == 1:
                committed = committed[None]  # single round as a 1-chain
            chain = ctx["chain"]
            n_committed = sum(
                1
                for k, rc in enumerate(chain)
                for slot in set(rc["appends"]) | set(rc["offsets"])
                if committed[k, slot]
            )
            self.recorder.record("commit", round_seq=seq, committed=n_committed)
            records = []
            for k, rc in enumerate(chain):
                records.extend(self._round_records(rc, committed[k]))
            # Chain bases are exact for committed rounds (prefix
            # property, see _drain). The log-end shadow tracks what the
            # DEVICE committed (base arithmetic for subsequent rounds
            # must build past these rows whether or not replication
            # settles them below) — it is NOT a read-visibility
            # watermark; that is _settled_end.
            with self._lock:
                for k, rc in enumerate(chain):
                    for slot in rc["appends"]:
                        n = rc["counts"].get(slot, 0)
                        if committed[k, slot] and n > 0:
                            adv = -(-n // ALIGN) * ALIGN
                            self._log_end[slot] = rc["bases"][slot] + adv
            # Nack in REVERSE round order: failed pendings requeue at
            # the queue FRONT, so the earliest round's retries must be
            # inserted last to land first. Pad charging belongs to the
            # LAST chained round per slot (see _settle_round).
            last_round = {
                slot: k
                for k, rc in enumerate(chain)
                for slot in rc["appends"]
            }
            for k in range(len(chain) - 1, -1, -1):
                rc = chain[k]
                rc["charge_pads"] = {
                    s for s in rc["appends"] if last_round[s] == k
                }
                self._settle_round(rc, rc["bases"], committed[k], ack=False)
            entry = (ctx, committed, records)
        except Exception as e:
            with self._lock:
                self.step_errors += 1
                # The round's device outcome may be unknown (the
                # committed fetch itself failed): re-derive these slots'
                # shadow from the device before their next round.
                self._shadow_dirty |= ctx["appends"].keys()
            log.warning("round resolve error: %s: %s", type(e).__name__, e)
            self._fail_round(ctx, e)
        # Dispatch-order turnstile (see __init__): replication begin and
        # settle-queue entry must follow dispatch order even though
        # resolvers complete out of order. Failed dispatches still take
        # and release their turn, or the sequence would stall.
        with self._turnstile:
            while self._next_turn != seq:
                self._turnstile.wait(timeout=0.5)
        try:
            if entry is not None:
                self._enqueue_settle(entry)
        finally:
            with self._turnstile:
                self._next_turn = seq + 1
                self._turnstile.notify_all()
            with self._lock:
                self._busy_a -= ctx["appends"].keys()
                self._busy_o -= ctx["offsets"].keys()

    def _enqueue_settle(self, entry: tuple) -> None:
        """Start the entry's standby replication (non-blocking when the
        replicator supports begin/wait) and push it into the bounded
        settle window. Called inside the dispatch-order turnstile, so
        the per-slot standby stream order equals dispatch order. Blocks
        when the window is full — the backpressure that bounds how far
        the device may run ahead of standby acks."""
        ctx, committed, records = entry
        # Window slot FIRST (backpressure: the device may run at most
        # settle_window rounds ahead of the standby acks), then begin.
        if not self._settle_sem.acquire(blocking=False):
            with self._lock:
                self.settle_backpressure += 1
            self._settle_sem.acquire()
        # Stage 3: commit → settle-window entry (turnstile ordering +
        # window backpressure). A growing number here with a small
        # commit_wait means the standbys, not the device, are the wall.
        t_enter = self.metrics.clock()
        ctx["t_enter"] = t_enter
        self._m_enter_wait_us.observe(t_enter - ctx.get("t_commit", t_enter))
        self.recorder.record("settle_enter", round_seq=ctx["seq"],
                             records=len(records),
                             depth=self._settle_q.qsize())
        ticket = exc = None
        if records and self.replicate_begin_fn is not None:
            tctxs = None
            if self.spans is not None:
                # Wire-form trace contexts of the sampled produces in
                # this round: the replicators stamp them onto their
                # frames so the standby's apply spans join the trace.
                # Only the 2-arg call when there IS something to carry —
                # single-arg replicate_begin_fn stand-ins stay valid.
                tctxs = [pend.tctx.wire()
                         for rc in ctx["chain"]
                         for taken in rc["appends"].values()
                         for pend, _, _ in taken if pend.tctx is not None]
            try:
                if tctxs:
                    ticket = self.replicate_begin_fn(records, tctxs)
                else:
                    ticket = self.replicate_begin_fn(records)
            except Exception as e:
                # Fencing/empty-set refusal at begin: carried into the
                # window so the release stage fails the entry IN ORDER
                # (acks of earlier rounds still release first).
                exc = e
        with self._lock:
            self.settle_depth_sum += self._settle_q.qsize()
            self.settle_samples += 1
            # Live occupancy (knob_state): held from window entry until
            # _release_one's release — the SLO shed machine's
            # settle-occupancy signal.
            self._settle_inflight += 1
        self._settle_q.put((ctx, committed, records, ticket, exc))

    def _settle_loop(self) -> None:
        """Settle thread: release the window strictly in dispatch order —
        wait out each entry's standby acks, persist, mirror, advance the
        settled-read horizon, settle futures. ONE thread by design: the
        in-order release is what keeps every controller-handover invariant
        intact under pipelining."""
        while True:
            try:
                entry = self._settle_q.get(timeout=0.05)
            except queue.Empty:
                if (self._stop.is_set()
                        and not self._thread.is_alive()
                        and not any(r.is_alive() for r in self._resolvers)):
                    return
                continue
            self._release_one(*entry)

    def _release_one(self, ctx: dict, committed, records: list,
                     ticket, exc: Optional[Exception]) -> None:
        chain = ctx["chain"]
        try:
            if self._settle_fenced:
                # Drain-the-window fence: once deposed, NO later round
                # of the window may ack — even one whose standby acks
                # already arrived (they predate the successor epoch and
                # prove nothing against its history).
                from ripplemq_tpu_torch.broker.replication import FencedError

                raise FencedError(
                    "settle window draining: controller deposed"
                )
            if exc is not None:
                raise exc
            # Ack barrier BEFORE the local persist: the local store must
            # only ever contain standby-acked records, or a controller
            # crash between persist and replicate leaves a record that
            # exists NOWHERE else — its restart-recovery then replays
            # and serves a round that was nacked to its producer, and a
            # (possibly late-committing) promotion forgets it again: two
            # divergent histories observed by consumers (the seeded
            # chaos soak caught this as a delivered-message order
            # violation). With this order a crash before persist nacks
            # the round everywhere EXCEPT the standby stores, whose
            # replay is later-record-wins — the retry's re-append at the
            # same base supersedes the orphaned copy.
            t_wait = self.metrics.clock()
            if ticket is not None:
                self.replicate_wait_fn(ticket)
            elif records and self.replicate_fn is not None:
                # No begin/wait split available (plain replicate_fn):
                # synchronous, still strictly in release order.
                self.replicate_fn(records)
            # Stage 4: the standby-ack barrier as the settle thread
            # experiences it (overlap with the pipelined stream means
            # this can be ~0 even when the RPC itself took longer —
            # repl.frame_us has the raw sender-side number).
            t_acked = self.metrics.clock()
            self._m_standby_ack_us.observe(t_acked - t_wait)
            self._persist_round(records)
            # Stage 5: local persist (store framing + any strict-mode
            # inline fsync; store.append_us/fsync_us decompose further).
            t_persist = self.metrics.clock()
            self._m_persist_us.observe(t_persist - t_acked)
            # ---- DURABLY SETTLED from here: the round is persisted AND
            # standby-acked. Only now may readers see its effects —
            # mirror rows (the _cache_end advance admits cache readers),
            # the settled-read horizon, and the consumer-offset shadow.
            # Advancing any of these before the acks landed served
            # state that a controller failover then rolled back: the
            # seeded chaos soak caught it as an acked-commit offset
            # REGRESSION across a promotion (read 24, failover, read 16)
            # — rounds that fail replication are nacked to their
            # producers/committers and must stay invisible to reads.
            # (Residual window: rows of a replication-FAILED round that
            # the ring recycles within this controller's lifetime are
            # store-served below trim — local-store consistent, and only
            # nacked data; acked state never regresses. Pipelining widens
            # the cases that can create such rows — ROADMAP's per-slot
            # settled-gap structure remains the full fix if soaks flag
            # it.)
            self._mirror_records(records)
            mirror_fn = self.mirror_fn
            if mirror_fn is not None:
                for rec_type, slot, base, payload in records:
                    if rec_type == REC_APPEND:
                        mirror_fn(slot, base, payload)
            with self._lock:
                for k, rc in enumerate(chain):
                    for slot in rc["appends"]:
                        n = rc["counts"].get(slot, 0)
                        if committed[k, slot] and n > 0:
                            adv = -(-n // ALIGN) * ALIGN
                            end = rc["bases"][slot] + adv
                            if end > self._settled_end[slot]:
                                self._settled_end[slot] = end
                    for slot, taken_off in rc["offsets"].items():
                        if committed[k, slot]:
                            for pend in taken_off:
                                for cs, off in pend.payloads:
                                    self._offsets_shadow[slot, cs] = off
            for k in range(len(chain) - 1, -1, -1):
                self._settle_round(chain[k], chain[k]["bases"],
                                   committed[k], ack=True)
            # Stage 6 (the whole-round number): dispatch → ack release.
            t0 = ctx.get("t_dispatch")
            t_rel = self.metrics.clock()
            if t0 is not None:
                self._m_release_us.observe(t_rel - t0)
            self.recorder.record("settle_release", round_seq=ctx["seq"],
                                 records=len(records))
            if self.spans is not None:
                self._emit_stage_spans(ctx, t_wait, t_acked, t_persist,
                                       t_rel)
        except Exception as e:
            from ripplemq_tpu_torch.broker.replication import FencedError

            if isinstance(e, FencedError):
                self._settle_fenced = True
            with self._lock:
                self.step_errors += 1
                # Settled-gap recording: every device-committed round of
                # this entry is now NACKED (its futures fail below) while
                # its rows sit in the device ring and its range advanced
                # the log-end shadow. If the slot later settles newer
                # rounds, `_settled_end` passes this range — the gap is
                # what keeps every read path from serving it (see the
                # settled-gap comment in __init__).
                for k, rc in enumerate(ctx["chain"]):
                    for slot in rc["appends"]:
                        n = rc["counts"].get(slot, 0)
                        if committed[k, slot] and n > 0:
                            adv = -(-n // ALIGN) * ALIGN
                            self._add_settled_gap_locked(
                                slot, rc["bases"][slot],
                                rc["bases"][slot] + adv,
                            )
            log.warning("round settle error: %s: %s", type(e).__name__, e)
            self.recorder.record("settle_fail", round_seq=ctx.get("seq", -1),
                                 error=f"{type(e).__name__}: {e}"[:200],
                                 fenced=self._settle_fenced)
            self._fail_committed(ctx, committed, e)
        finally:
            with self._lock:
                self._settle_inflight -= 1
            self._settle_sem.release()

    def _emit_stage_spans(self, ctx: dict, t_wait: float, t_acked: float,
                          t_persist: float, t_rel: float) -> None:
        """Emit the six round-stage spans (the stage boundaries of the
        metrics, ATTRIBUTED) for every sampled batch the settled round carried —
        usually one; an untraced round costs one tctx scan, and an
        untraced PLANE (spans is None) never reaches here. All
        timestamps are metrics.clock() = perf_counter, the span ring's
        own domain. Stage spans are siblings under the produce path's
        span (rpc.recv / worker.hop) that submitted the batch."""
        t0 = ctx.get("t_dispatch")
        if t0 is None:
            return
        tctxs = []
        for rc in ctx["chain"]:
            for taken in rc["appends"].values():
                for pend, _, _ in taken:
                    if pend.tctx is not None:
                        tctxs.append(pend.tctx)
        if not tctxs:
            return
        sp = self.spans
        td = ctx.get("t_dispatched", t0)
        tc = ctx.get("t_commit", td)
        te = ctx.get("t_enter", tc)
        for tctx in tctxs:
            sp.span_at("engine.dispatch", tctx, t0, td - t0)
            sp.span_at("settle.commit_wait", tctx, td, tc - td)
            sp.span_at("settle.enter_wait", tctx, tc, te - tc)
            sp.span_at("settle.standby_ack", tctx, t_wait, t_acked - t_wait)
            sp.span_at("settle.persist", tctx, t_acked, t_persist - t_acked)
            sp.span_at("settle.release", tctx, t0, t_rel - t0)

    def _mirror_records(self, records) -> None:
        """Write committed append rows into the host ring mirror at
        their ring positions and advance the contiguous-prefix
        watermark. Advances are CONTIGUOUS only: a record landing past a
        gap (an earlier round's resolve failed before mirroring) must
        not mark the gap served — reads in it fall through to the
        device ring, the authority the mirror shadows. Writes race only
        readers (the slot's busy bit serializes writers per slot), and
        any reader the write could corrupt is one whose window the trim
        watermark already overran — exactly the race the read path
        re-checks."""
        if self._host_ring is None:
            return
        S, SB = self.cfg.slots, self.cfg.slot_bytes
        for rec_type, slot, base, payload in records:
            if rec_type != REC_APPEND:
                continue
            rows = np.frombuffer(payload, np.uint8).reshape(-1, SB)
            pos = base % S
            self._host_ring[slot, pos : pos + rows.shape[0]] = rows
            with self._lock:
                new_end = base + rows.shape[0]
                if self._cache_end[slot] >= base:
                    self._cache_end[slot] = max(
                        new_end, int(self._cache_end[slot])
                    )
                    continue
                # Mirror gap (an earlier round's resolve failed before
                # mirroring): keep writing and track the contiguous
                # POST-GAP run. Heal when trim passes the run's base:
                # every unmirrored row then sits below trim (store
                # -served; mirror-eligible reads are all >= trim), so
                # the mirror is valid again from run_base to run_end.
                # Comparing trim against the run base — not this
                # record's `base`, which tracks the advancing log end
                # and stays forever ahead of trim — is what lets the
                # heal actually fire.
                g = self._mirror_gap.get(slot)
                if g is None or base > g[1]:
                    g = self._mirror_gap[slot] = [base, new_end]
                    self._mirror_gap_gen[slot] = (
                        self._mirror_gap_gen.get(slot, 0) + 1
                    )
                else:
                    g[1] = max(g[1], new_end)
                if int(self.trim[slot]) >= g[0]:
                    self._cache_end[slot] = g[1]
                    del self._mirror_gap[slot]

    def _round_records(self, rc: dict, committed
                       ) -> list[tuple[int, int, int, bytes]]:
        """One round's committed writes as store/replication records —
        built from the round ctx's host-side copies (the packed blocks
        the drain shipped to the device, plus counts and bases)."""
        records: list[tuple[int, int, int, bytes]] = []
        for slot in rc["appends"]:
            n = rc["counts"].get(slot, 0)
            if not committed[slot] or n == 0:
                continue
            adv = int(-(-n // ALIGN) * ALIGN)
            payload = rc["entries"][slot][:adv].tobytes()
            records.append(
                (REC_APPEND, int(slot), int(rc["bases"][slot]), payload)
            )
            # Producer-dedup entries ride the SAME record stream, right
            # after their rows (a torn tail may drop the entry, never
            # leave it pointing at unpersisted rows): standbys and boot
            # replay rebuild the dedup table from these, closing the
            # failover dup window.
            ents = [
                (pend.pid, pend.seq, n_taken,
                 int(rc["bases"][slot]) + start)
                for pend, start, n_taken in rc["appends"][slot]
                if pend.pid > 0
            ]
            if ents:
                records.append((
                    REC_PIDSEQ, int(slot), len(ents),
                    b"".join(struct.pack("<IqIq", p, s, k, b)
                             for p, s, k, b in ents),
                ))
        for slot, taken_off in rc["offsets"].items():
            if not committed[slot]:
                continue
            pairs = [p for pend in taken_off for p in pend.payloads]
            payload = b"".join(struct.pack("<II", s, o) for s, o in pairs)
            records.append((REC_OFFSETS, int(slot), len(pairs), payload))
        return records

    def _persist_round(self, records) -> None:
        """Frame this round's committed records into the segment store
        and index the append records for the retention read path. The
        whole round goes down as ONE batched store write when the store
        supports it (SegmentStore.append_many) — per-record appends paid
        a call/GIL round-trip each, which under load was the settle
        stage's dominant cost."""
        if self.store is None or not records:
            return
        append_many = getattr(self.store, "append_many", None)
        if append_many is not None:
            locators = append_many(records)
        else:
            locators = [self.store.append(*rec) for rec in records]
        if self.log_index is not None:
            ends: list[tuple[int, int]] = []
            for (rec_type, slot, base, payload), locator in zip(
                records, locators
            ):
                if rec_type != REC_APPEND:
                    continue
                nrows = len(payload) // self.cfg.slot_bytes
                self.log_index.add(slot, base, nrows, locator)
                ends.append((slot, base + nrows))
            if ends:
                with self._lock:
                    # Only a SUCCESSFUL append moves the persisted
                    # watermark (the trim clamp's authority).
                    for slot, end in ends:
                        if end > self._persisted[slot]:
                            self._persisted[slot] = end
        if self.durability == "strict":
            # Strict deployments opt out of the flush_async lag wholesale:
            # the settle thread fsyncs BEFORE this round's acks release,
            # so an acked round is on disk on the controller (the standby
            # ack path flushes synchronously too — server._handle_repl_
            # rounds) even across a correlated full-cluster kill.
            self.store.flush()
            return
        now = time.monotonic()
        if now - self._last_flush >= self.flush_interval_s:
            # Deferred fsync (same durability lag contract — see
            # SegmentStore.flush_async): the settle thread must not
            # spend its capacity inside the filesystem's fsync latency.
            flush = getattr(self.store, "flush_async", self.store.flush)
            flush()
            self._last_flush = now

    def install(self, image: ReplicaState,
                settled_gaps: Optional[dict[int, list[list[int]]]] = None,
                pid_table: Optional[dict] = None) -> None:
        """Install a recovered single-replica image (see recover_image).
        Re-derives the retention tables: the replayed ring holds at most
        the last `slots` rows per partition, so anything below
        `log_end - slots` is store-only (replay writes exactly the rows
        each record carried — no full-window clobber — hence everything
        ring-resident is intact and servable). `settled_gaps` is the
        recovered store's coverage-hole map (replay_records gaps_out):
        ranges below the final log end that no record covers — exactly
        the rounds this store's controller nacked — re-registered so the
        restarted plane keeps refusing to serve them (without it, a gap
        inside the final ring window reads back as the PREVIOUS lap's
        rows at the wrong offsets). The image's leaves may be numpy arrays
        or tensors on any device (the port's recover_image returns CPU
        tensors)."""
        ends = _to_host(image.log_end).astype(np.int64)
        with self._lock:
            self._log_end = ends.copy()
            self._persisted = ends.copy()  # the image came FROM the store
            self._settled_end = ends.copy()  # store records are settled
            self._settled_gaps = {
                int(s): [[int(b), int(e)] for b, e in v]
                for s, v in (settled_gaps or {}).items() if v
            }
            if self._host_ring is not None:
                # Seed the mirror from the replayed image: rows land at
                # their ring positions during replay, so the first
                # `slots` rows ARE the ring-resident window.
                self._host_ring[:] = _to_host(image.log_data)[
                    :, : self.cfg.slots]
                self._cache_end = ends.copy()
                self._mirror_gap.clear()
            self.trim = np.maximum(0, ends - self.cfg.slots)
            self._scan_index = None  # history may differ on this store
            self._offsets_shadow = _to_host(image.offsets).astype(np.int32)
            # Producer-dedup table recovered from the store's REC_PIDSEQ
            # records (replay_records pid_tab_out): the failover half of
            # idempotence — a retry straddling a promotion finds its
            # settled entry here instead of re-appending. In-flight
            # entries belong to the PREVIOUS plane's futures; drop them.
            self._pid_tab = {
                (int(p), int(s)): [tuple(int(x) for x in e) for e in v]
                for (p, s), v in (pid_table or {}).items()
            }
            self._pid_inflight = {}
        image = ReplicaState(*(_stage(getattr(image, f), self._arg_device)
                               for f in ReplicaState._fields))
        with self._device_lock:
            self._state = self.fns.init_from(image)
        self.recorder.record(
            "install", partitions_with_data=int((ends > 0).sum()),
            max_log_end=int(ends.max()),
            gap_slots=len(self._settled_gaps),
        )
        log.info("installed recovered image: %d partitions with data, "
                 "max log end %d", int((ends > 0).sum()), int(ends.max()))

    def _wrap_engine_exc(self, exc: Exception) -> Exception:
        if not isinstance(exc, NotCommittedError):
            if self.broken_reason is not None:
                # Producers must see a RETRYABLE refusal (retry lands on
                # the promoted controller after abdication), not an opaque
                # internal RuntimeError from the lockstep transport.
                exc = NotCommittedError(f"data plane broken: {exc}")
            elif getattr(exc, "retryable", False):
                # Transient engine failure that did NOT condemn the plane
                # (e.g. a pre-broadcast lockstep send failure — the seq
                # was restored, the next round can succeed): same typed
                # refusal, same client retry path.
                exc = NotCommittedError(f"transient engine failure: {exc}")
        return exc

    def _fail_round(self, ctx, exc: Exception) -> None:
        """Fail EVERY future of one dispatch (outcome unknown: dispatch
        or committed-fetch failure — nothing was requeued)."""
        exc = self._wrap_engine_exc(exc)
        for slot, taken in ctx["appends"].items():
            for pend, _, _ in taken:
                self._pid_drop(pend, slot)
                if not pend.future.done():
                    pend.future.set_exception(exc)
        for taken_off in ctx["offsets"].values():
            for pend in taken_off:
                if not pend.future.done():
                    pend.future.set_exception(exc)

    def _fail_committed(self, ctx, committed, exc: Exception) -> None:
        """Fail only the COMMITTED rounds' futures of one dispatch
        (settle-stage failure: replication refused or failed). The
        uncommitted rounds were already nacked/requeued by the resolver
        — their pendings may be live in the queues again and must not
        be touched."""
        exc = self._wrap_engine_exc(exc)
        for k, rc in enumerate(ctx["chain"]):
            for slot, taken in rc["appends"].items():
                if not committed[k, slot]:
                    continue
                for pend, _, _ in taken:
                    self._pid_drop(pend, slot)
                    if not pend.future.done():
                        pend.future.set_exception(exc)
            for slot, taken_off in rc["offsets"].items():
                if not committed[k, slot]:
                    continue
                for pend in taken_off:
                    if not pend.future.done():
                        pend.future.set_exception(exc)

    def settle_stats(self) -> dict:
        """Settle-pipeline occupancy snapshot (bench/admin surface):
        mean window depth sampled at each enqueue, plus how many
        enqueues found the window full (backpressure engaged)."""
        with self._lock:
            samples = self.settle_samples
            return {
                "window": self.settle_window,
                "occupancy_mean": (
                    round(self.settle_depth_sum / samples, 3)
                    if samples else 0.0
                ),
                "samples": samples,
                "backpressure_waits": self.settle_backpressure,
            }

    def postmortem(self) -> dict:
        """The engine section of a postmortem bundle (obs/postmortem.py):
        the term-skew cross-section — control tables vs device
        scalars in ONE snapshot — plus stall streaks, settled gaps,
        settle-window occupancy, degradation, and retry budgets. All
        wire-encodable (str keys, plain ints/lists).

        One device-lock hold spanning three leaf fetches (terms,
        commits, log ends — under lockstep, three broadcast calls): a
        one-shot diagnosis RPC, not a polling surface — on a busy plane
        the fetches wait out the dispatch pipeline exactly like any
        other state fetch (see busy()), so expect the RPC to stall up
        to a few dispatch drains on a loaded broker. A FAILING
        fetch (broken lockstep plane — exactly a state this bundle
        exists to diagnose) degrades to a host-only bundle with
        `device_error` set instead of losing the control tables, stall
        streaks, and gaps that never needed the device."""
        device_error = None
        P = self.cfg.partitions
        try:
            with self._device_lock:
                dev_terms = self._fetch_state("current_term").max(axis=0)
                dev_commit = self._fetch_state("commit").max(axis=0)
                dev_ends = self._fetch_state("log_end").max(axis=0)
        except Exception as e:
            device_error = f"{type(e).__name__}: {e}"[:200]
            dev_terms = np.full((P,), -1, np.int64)
            dev_commit = np.full((P,), -1, np.int64)
            dev_ends = np.full((P,), -1, np.int64)
        with self._lock:
            leader = self.leader.copy()
            term = self.term.copy()
            host_end = self._log_end.copy()
            settled = self._settled_end.copy()
            persisted = self._persisted.copy()
            trim = self.trim.copy()
            streaks = dict(self._nocommit_streak)
            gaps = {
                int(s): [[int(b), int(e)] for b, e in v]
                for s, v in self._settled_gaps.items() if v
            }
        # The wedge signature, precomputed: the control table advertises
        # a term BEHIND what the device granted — every dispatch at the
        # table's term is refused, commits freeze, the leader looks
        # healthy (e.g. ctrl_table_term=[5,5] vs device=[8,8]). With
        # the device unreachable (-1 sentinels) no slot reads skewed.
        skew = [
            int(s) for s in range(self.cfg.partitions)
            if int(dev_terms[s]) > int(term[s])
        ]
        return {
            "partitions": self.cfg.partitions,
            "device_error": device_error,
            "ctrl_table": {
                "leader": [int(x) for x in leader],
                "term": [int(x) for x in term],
            },
            "device_current_terms": [int(x) for x in dev_terms],
            "device_commit": [int(x) for x in dev_commit],
            "device_log_ends": [int(x) for x in dev_ends],
            "host_log_end": [int(x) for x in host_end],
            "settled_end": [int(x) for x in settled],
            "persisted": [int(x) for x in persisted],
            "trim": [int(x) for x in trim],
            "term_skew_slots": skew,
            "stall_streaks": {str(s): int(n) for s, n in streaks.items()},
            "stalled_slots": self.stalled_slots(),
            "settled_gaps": {str(s): v for s, v in gaps.items()},
            "mirror_gap_slots": self.mirror_gap_slots(),
            "pid_table_size": self.pid_table_size(),
            "settle": self.settle_stats(),
            "degraded_slots": self.degraded_slots(),
            "retry_budget": {
                "max_retry_rounds": self.max_retry_rounds,
                "pipeline_depth": self.pipeline_depth,
                "chain_depth": self.chain_depth,
                "settle_window": self.settle_window,
                "round_retries": self._m_retries.n
                if hasattr(self._m_retries, "n") else 0,
                "retry_exhausted": self._m_retry_exhausted.n
                if hasattr(self._m_retry_exhausted, "n") else 0,
            },
            "counters": {
                "rounds": self.rounds,
                "dispatches": self.dispatches,
                "committed_entries": self.committed_entries,
                "step_errors": self.step_errors,
                "read_queries": self.read_queries,
                "read_dispatches": self.read_dispatches,
                "read_cache_hits": self.read_cache_hits,
            },
        }

    def _settle_round(self, ctx, base: dict, committed, ack: bool) -> None:
        """One round's future settlement, in two phases. `ack=False`
        (resolver, slots still busy): nack/requeue the round's
        UNCOMMITTED work so retries reach the queue front before later
        submits drain. `ack=True` (settle thread, strictly in dispatch
        order after the standby acks landed): release the COMMITTED
        work's futures."""
        if ack:
            # Producer-dedup bookkeeping FIRST, in one lock hold and
            # strictly before any future resolves: a wire-dup of an
            # acked batch must find either the in-flight entry (pre-
            # settle) or the table entry (post-settle) — never the gap
            # between them (which would re-append an acked batch).
            any_pid = any(
                pend.pid > 0
                for slot, taken in ctx["appends"].items()
                if committed[slot]
                for pend, _, _ in taken
            )
            if any_pid:
                with self._lock:
                    for slot, taken in ctx["appends"].items():
                        if not committed[slot]:
                            continue
                        for pend, start, n in taken:
                            if pend.pid <= 0:
                                continue
                            ents = self._pid_tab.setdefault(
                                (pend.pid, slot), []
                            )
                            ents.append(
                                (pend.seq, pend.seq + n,
                                 int(base[slot]) + start)
                            )
                            del ents[:-_PID_WINDOW]
                            self._pid_inflight.pop(
                                (pend.pid, slot, pend.seq), None
                            )
            new_entries = 0
            for slot, taken in ctx["appends"].items():
                if committed[slot]:
                    for pend, start, n in taken:
                        new_entries += n
                        if not pend.future.done():
                            pend.future.set_result(int(base[slot]) + start)
            for slot, taken_off in ctx["offsets"].items():
                if committed[slot]:
                    for pend in taken_off:
                        if not pend.future.done():
                            pend.future.set_result(True)
            if new_entries:
                with self._lock:
                    self.committed_entries += new_entries
            return
        # No-commit streak bookkeeping (this resolver pass sees every
        # dispatched round exactly once): a committed round clears its
        # slots, an uncommitted one lengthens them — see stalled_slots().
        touched = set(ctx["appends"]) | set(ctx["offsets"])
        if touched:
            with self._lock:
                for slot in touched:
                    if committed[slot]:
                        self._nocommit_streak.pop(slot, None)
                    else:
                        self._nocommit_streak[slot] = (
                            self._nocommit_streak.get(slot, 0) + 1
                        )
        requeue_a: list[tuple[int, _Pending]] = []
        requeue_o: list[tuple[int, _PendingOffsets]] = []
        for slot, taken in ctx["appends"].items():
            if committed[slot]:
                continue  # released by the ack phase after standby acks
            # Distinguish permanent backpressure (log full) from a
            # transient quorum outage. Only index-less deployments
            # (no store, or a store the drain cannot trim against)
            # can fill permanently: the write phase needs a full
            # max_batch window past the leader's log end and nothing
            # is ever trimmed, so base + B > slots means no retry can
            # ever fit. With a log index the drain raises trim and
            # retries commit.
            full = (
                self.log_index is None
                and base[slot] + self.cfg.max_batch > self.cfg.slots
                and base[slot] > 0
            )
            for pend, _, _ in taken:
                pend.rounds_left -= 1
                if full:
                    self._pid_drop(pend, slot)
                    if not pend.future.done():  # caller may cancel()
                        pend.future.set_exception(
                            PartitionFullError(
                                f"partition {slot}: log full "
                                f"({base[slot]}/{self.cfg.slots} used)"
                            )
                        )
                elif pend.rounds_left <= 0:
                    self._m_retry_exhausted.inc()
                    self._pid_drop(pend, slot)
                    if not pend.future.done():
                        pend.future.set_exception(
                            NotCommittedError(
                                f"partition {slot}: no quorum after "
                                f"{self.max_retry_rounds} rounds"
                            )
                        )
                else:
                    requeue_a.append((slot, pend))
        # Failed boundary-pad rounds (empty taken) must still charge the
        # blocked queue head's retry budget: the head is what forced the
        # pad, and without this a quorum outage at the ring boundary would
        # regenerate failing pads forever while the producer's future
        # hangs past max_retry_rounds. `charge_pads` (chain dispatch)
        # restricts charging to slots whose LAST chained round was the
        # failed pad — if a later round of the same chain took the head,
        # that round's own settle already charged it.
        charge = ctx.get("charge_pads")
        pad_failures = [
            slot for slot, taken in ctx["appends"].items()
            if not taken and not committed[slot]
            and (charge is None or slot in charge)
        ]
        if pad_failures:
            with self._lock:
                for slot in pad_failures:
                    q = self._appends.get(slot)
                    if not q:
                        continue
                    head = q[0]
                    head.rounds_left -= 1
                    if head.rounds_left <= 0:
                        q.pop(0)
                        if not q:
                            self._appends.pop(slot, None)
                        self._pid_drop_locked(head, slot)
                        if not head.future.done():  # caller may cancel()
                            head.future.set_exception(
                                NotCommittedError(
                                    f"partition {slot}: no quorum after "
                                    f"{self.max_retry_rounds} rounds (ring-"
                                    f"boundary pad)"
                                )
                            )
        for slot, taken_off in ctx["offsets"].items():
            if committed[slot]:
                continue  # released by the ack phase after standby acks
            for pend in taken_off:
                pend.rounds_left -= 1
                if pend.rounds_left <= 0:
                    self._m_retry_exhausted.inc()
                    if not pend.future.done():  # caller may cancel()
                        pend.future.set_exception(
                            NotCommittedError(
                                f"partition {slot}: no quorum"
                            )
                        )
                else:
                    requeue_o.append((slot, pend))
        if requeue_a or requeue_o:
            self._m_retries.inc(len(requeue_a) + len(requeue_o))
            with self._lock:
                for slot, pend in reversed(requeue_a):
                    self._appends.setdefault(slot, []).insert(0, pend)
                for slot, pend in reversed(requeue_o):
                    self._offsets.setdefault(slot, []).insert(0, pend)
            self._work.set()


def recover_image(cfg: EngineConfig, store_dir: str,
                  use_native: Optional[bool] = None,
                  gaps_out: Optional[dict] = None,
                  pid_tab_out: Optional[dict] = None,
                  *, device=None) -> Optional[ReplicaState]:
    """Replay a segment store directory into a single-replica state image,
    healing erasure-protected sealed segments first: a missing/corrupt
    sealed segment is rebuilt from any 3 of its 5 RS shards (the torn-
    tail contract of replay_records only covers the ACTIVE segment's
    tail). `gaps_out` receives the store's settled-gap map (see
    replay_records) for DataPlane.install; `pid_tab_out` the recovered
    producer-dedup table. The RS work runs on `device`, or on CUDA when
    none is given; with no GPU and no `device` it raises."""
    repair_store(store_dir, device=default_device(device))
    return replay_records(cfg, scan_store(store_dir, use_native),
                          gaps_out=gaps_out, pid_tab_out=pid_tab_out)


def replay_records(cfg: EngineConfig, records,
                   gaps_out: Optional[dict] = None,
                   pid_tab_out: Optional[dict] = None
                   ) -> Optional[ReplicaState]:
    """Replay committed-round records into a single-replica state image
    (a `ReplicaState` of CPU tensors).

    Returns None if there are no records. Only committed rounds are ever
    persisted/replicated, so the rebuilt image is a valid post-commit
    state for EVERY replica slot (install via DataPlane.install). The
    replay is the recovery path the reference inherits from JRaft's log
    replay (SURVEY.md §5 checkpoint) — here it also re-derives the cached
    last_term from the tail row's embedded header.

    Later records win per slot: a record's base may regress below an
    earlier record's end (a controller-failover standby can hold an
    UNSETTLED round the promoted controller never had — the new
    generation's rounds re-cover those rows) and may leave a zero-row gap
    (the standby missed an unsettled round the deposed controller
    persisted locally). Both only ever affect rows whose producers were
    NEVER acked; zero rows read back as alignment padding.

    Record bases are ABSOLUTE storage offsets; rows land at their ring
    positions (base % slots), so a partition that wrapped the ring many
    times replays to exactly the last `slots` rows — older rows stay
    store-only, served through the log index (core.state ring doc).

    `gaps_out` (optional dict) receives {slot: [[begin, end), ...]} —
    the COVERAGE HOLES between this store's records, below each slot's
    final log end. A hole is a round the writing controller committed on
    device but never settled (replication failed → never persisted):
    exactly the settled gaps DataPlane.install must re-register, because
    a hole inside the final ring window otherwise replays as the
    PREVIOUS lap's rows at the wrong offsets. Ring rows inside such
    holes are zeroed here too (zero rows read back as alignment
    padding), so even a read path that misses the gap clamp cannot
    serve a stale lap.
    """
    P, S, SB, C = cfg.partitions, cfg.slots, cfg.slot_bytes, cfg.max_consumers
    log_data = np.zeros((P, S + cfg.max_batch, SB), np.uint8)
    log_end = np.zeros((P,), np.int32)
    last_term = np.zeros((P,), np.int32)
    commit = np.zeros((P,), np.int32)
    offsets = np.zeros((P, C), np.int32)
    coverage: dict[int, list[list[int]]] = {}
    found = False
    for rec_type, slot, base, payload in records:
        if not 0 <= slot < P:
            raise ValueError(
                f"record for partition {slot} outside engine shape P={P} "
                f"(store written under a different config?)"
            )
        if rec_type == REC_APPEND:
            if len(payload) % SB:
                raise ValueError(
                    f"append payload of {len(payload)} bytes is not a "
                    f"multiple of slot_bytes {SB}"
                )
            rows = np.frombuffer(payload, np.uint8).reshape(-1, SB)
            n = rows.shape[0]
            pos = base % S
            if pos + n > S:
                raise ValueError(
                    f"replayed round laps the ring ({base}%{S}+{n}>{S}; "
                    f"store written under a different config?)"
                )
            log_data[slot, pos : pos + n] = rows
            log_end[slot] = base + n
            commit[slot] = base + n
            last_term[slot] = int(
                np.frombuffer(rows[-1, 4:8].tobytes(), np.int32)[0]
            )
            # Coverage bookkeeping mirrors the later-records-win replay:
            # a regressing record drops/truncates everything at-or-above
            # its base before extending (same rule as LogIndex.add).
            cov = coverage.setdefault(slot, [])
            while cov and cov[-1][0] >= base:
                cov.pop()
            if cov and cov[-1][1] > base:
                cov[-1][1] = base
            if cov and cov[-1][1] == base:
                cov[-1][1] = base + n
            else:
                cov.append([base, base + n])
        elif rec_type == REC_OFFSETS:
            for cs, off in struct.iter_unpack("<II", payload):
                if cs < C:
                    offsets[slot, cs] = off
        elif rec_type == REC_PIDSEQ:
            # Producer-dedup entries (idempotent producers): rebuild the
            # (pid, slot) → recent-settled-batches table alongside the
            # image. Scan order matters only within a key; a re-covered
            # round's retry carries the same (pid, seq), so replayed
            # duplicates collapse into equivalent entries.
            if pid_tab_out is not None:
                for pid, seq, n, b in struct.iter_unpack("<IqIq", payload):
                    ents = pid_tab_out.setdefault((int(pid), int(slot)), [])
                    ents.append((int(seq), int(seq) + int(n), int(b)))
                    del ents[:-_PID_WINDOW]
        found = True
    if not found:
        return None
    for slot, cov in coverage.items():
        gaps = [
            [cov[i - 1][1], cov[i][0]]
            for i in range(1, len(cov))
            if cov[i][0] > cov[i - 1][1]
        ]
        if not gaps:
            continue
        end = int(log_end[slot])
        for b, e in gaps:
            # Zero the hole's rows inside the final ring window: they
            # hold whatever an earlier lap's record replayed there. The
            # window clamp bounds e - lo to at most S rows, so the range
            # is at most two contiguous ring spans (split at the wrap).
            lo = max(b, end - S)
            if lo >= e:
                continue
            p0 = lo % S
            n = e - lo
            if p0 + n <= S:
                log_data[slot, p0 : p0 + n] = 0
            else:
                log_data[slot, p0:S] = 0
                log_data[slot, : p0 + n - S] = 0
        if gaps_out is not None:
            gaps_out[slot] = gaps
    return ReplicaState(
        log_data=torch.from_numpy(log_data),
        log_end=torch.from_numpy(log_end),
        last_term=torch.from_numpy(last_term),
        current_term=torch.from_numpy(last_term.copy()),
        commit=torch.from_numpy(commit),
        offsets=torch.from_numpy(offsets),
    )

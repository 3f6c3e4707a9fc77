"""Multi-core host plane: per-partition-group worker subprocesses.

PROFILE.md's honest wall is ~28 µs of interpreter CPU per message
spread across broker threads — the GIL, not the engine (<2 µs), caps
the e2e path. This module shards the broker's HOST path (submit
validation, pid/seq stamping, payload packing, settled-mirror serving
of consumer reads) into N worker subprocesses, each owning the
disjoint partition-group slice `slot % host_workers == worker_id`,
connected to the dispatcher by a pair of shared-memory frame rings
(parallel/shmring.py). Payload bytes are packed ONCE, by the worker,
into the exact `[k, slot_bytes]` row block the engine appends
(core/encode.py row format) — the block crosses the ring, the broker
wraps it in a zero-copy numpy view (DataPlane.submit_packed), and
nothing is re-pickled per hop.

The device program stays where it was: ONE DataPlane on the current
controller, one replication plane, one settle pipeline — committed
prefixes are byte-identical to the single-process plane by
construction. What moves off the broker's GIL is the per-message
interpreter work around the engine.

Worker lifetime: spawned (never forked — the broker process is full of
threads and a CUDA context) from a module whose import chain is kept
torch-free (nothing it imports reaches `ripplemq_tpu_torch.broker`,
whose package imports the DataPlane), so a worker boots in
~100 ms. A dead worker is detected by its receive thread; every
pending request fails with the typed, retryable WorkerUnavailableError
(no silent hangs), the worker respawns with a bumped GENERATION, and
its stamping pid is invalidated until the broker registers a fresh
per-(worker, generation) pid — a respawned worker's restarted sequence
counters must never ride an old pid into the cluster dedup table
(that would collapse fresh batches as replays: acked loss).

Idempotence stamping: each worker stamps pid-less produces with its
OWN metadata-issued pid (`set_pid`, driven by the broker's pid duty)
plus per-slot sequence counters — slices are disjoint, so counters
need no cross-process coordination.

Mirror serving: the controller's settle thread publishes each settled
round's rows (fire-and-forget, never blocking settle) to the owning
worker, which keeps the newest CONTIGUOUS run per slot under a byte
budget and serves consume reads from it. Any uncertainty — a gap from
a dropped publish, an offset below the window, a dead worker — falls
back to the DataPlane read path, which remains the authority.

Twin of `ripplemq_tpu/parallel/hostplane.py` (PyTorch port): the same
code, importing only the port's modules. The worker's packed block
reaches the port's `DataPlane.submit_packed` as bytes and is staged to
the plane's device there.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Optional

from ripplemq_tpu_torch.obs.lockwitness import make_lock
from ripplemq_tpu_torch.obs.spans import SpanRing, ctx_from_wire
from ripplemq_tpu_torch.parallel.shmring import (
    RingClosedError,
    ShmRing,
    TornFrameError,
)
from ripplemq_tpu_torch.utils.logs import get_logger
from ripplemq_tpu_torch.wire import codec

log = get_logger("hostplane")

_ROW_HDR = 8  # length u32 + term u32 (core/config.ROW_HEADER)


class WorkerUnavailableError(Exception):
    """The owning host worker is dead or mid-respawn. RETRYABLE by
    contract (wire/retry.py classifies the `worker_unavailable:` wire
    prefix): the dispatcher respawns the worker and a retry lands."""


class OversizeBatchError(Exception):
    """The batch would not fit a ring frame (frames cap at half the
    ring). NOT a refusal: the produce path falls back to the
    in-process submit/stamp/pack branch, which has no such bound —
    killing the worker over one giant batch (and re-killing every
    respawn when the client retries) is the failure mode this check
    exists to prevent."""


def worker_of(slot: int, n_workers: int) -> int:
    """The partition-group map: slot -> owning worker."""
    return slot % n_workers


# --------------------------------------------------------------------------
# Worker process side (import chain must stay torch-free: spawn boots this)
# --------------------------------------------------------------------------


def _pack_rows(msgs: list, slot_bytes: int) -> tuple[bytes, list[int]]:
    """Pure-python twin of core/encode.pack_payload_rows: one
    header-prefixed `slot_bytes` row per message, zero term (the
    batcher stamps the round term at drain). Returns (block, lens)."""
    out = bytearray(len(msgs) * slot_bytes)
    lens = []
    pos = 0
    for m in msgs:
        n = len(m)
        lens.append(n)
        out[pos : pos + 4] = n.to_bytes(4, "little")
        out[pos + _ROW_HDR : pos + _ROW_HDR + n] = m
        pos += slot_bytes
    return bytes(out), lens


class _SlotMirror:
    """One slot's settled-row window: the newest contiguous run of
    mirror frames, capped at `budget` bytes (oldest frames drop, the
    window start rises)."""

    __slots__ = ("start", "end", "frames", "nbytes", "slot_bytes")

    def __init__(self, slot_bytes: int) -> None:
        self.start = 0
        self.end = 0
        self.frames: list[tuple[int, int, bytes]] = []  # (base, end, rows)
        self.nbytes = 0
        self.slot_bytes = slot_bytes

    def publish(self, base: int, rows: bytes, budget: int) -> None:
        nrows = len(rows) // self.slot_bytes
        if nrows <= 0:
            return
        if not self.frames or base != self.end:
            if base < self.start:
                return  # stale duplicate below the window
            # Gap (a dropped publish or a fresh worker): restart the
            # contiguous run — correctness lives in the fallback path.
            self.frames = []
            self.nbytes = 0
            self.start = base
        self.frames.append((base, base + nrows, rows))
        self.end = base + nrows
        self.nbytes += len(rows)
        while self.nbytes > budget and len(self.frames) > 1:
            b, e, r = self.frames.pop(0)
            self.nbytes -= len(r)
            self.start = self.frames[0][0]

    def read(self, offset: int, max_msgs: Optional[int]
             ) -> Optional[tuple[list[bytes], int]]:
        """(messages, next_offset) served like DataPlane.read's hot
        window — length-0 rows are alignment padding and are walked
        over — or None when the offset is outside the window (the
        dispatcher falls back to the engine read path)."""
        if offset < self.start:
            return None
        if offset >= self.end:
            return [], offset  # tail poll: empty, position unmoved
        SB = self.slot_bytes
        msgs: list[bytes] = []
        pos = offset
        last_row_end = offset
        for base, end, rows in self.frames:
            if end <= pos:
                continue
            i = pos - base
            while i < end - base:
                off = i * SB
                n = int.from_bytes(rows[off : off + 4], "little")
                if n > 0:
                    msgs.append(bytes(rows[off + _ROW_HDR : off + _ROW_HDR + n]))
                    last_row_end = base + i + 1
                    if max_msgs is not None and len(msgs) >= max_msgs:
                        return msgs, last_row_end
                i += 1
            pos = end
        return msgs, pos if msgs else self.end


def _host_worker_main(worker_id: int, req_name: str, resp_name: str,
                      slot_bytes: int, payload_bytes: int, max_batch: int,
                      mirror_budget: int) -> None:
    """Worker loop: pop request frames, serve, push responses. Exits
    when the dispatcher unlinks the rings, on a torn frame (the
    dispatcher died mid-publish), or when the parent process is gone."""
    req = ShmRing.attach(req_name)
    resp = ShmRing.attach(resp_name)
    mirrors: dict[int, _SlotMirror] = {}
    pid = 0
    seqs: dict[int, int] = {}
    served = stamped = 0
    parent = os.getppid()
    # Worker-side span ring. The proc label carries the OS pid so two
    # generations of the same worker index never collide in span-id
    # space. Records for a sampled submit ride back to the dispatcher
    # inside the existing response frame (no extra ring traffic);
    # span_cursor tracks what has already been shipped.
    spans = SpanRing(f"worker{worker_id}.{os.getpid()}")
    span_cursor = -1
    try:
        while True:
            try:
                frame = req.pop(timeout_s=0.25)
            except (TornFrameError, RingClosedError):
                return
            if frame is None:
                if os.getppid() != parent:
                    return  # orphaned: the broker process died
                continue
            m = codec.decode(frame)
            op = m.get("op")
            if op in ("submit", "submit_raw"):
                served += 1
                out = {"id": m["id"], "ok": True}
                # Sampled submits carry the dispatcher's worker.hop ctx;
                # unsampled ones have no tctx and sp is the NULL_SPAN
                # (no clock read, no allocation). A refused batch leaves
                # its spans un-ended — absent, a partial trace.
                sp = spans.span("worker.serve",
                                ctx_from_wire(m.get("tctx")), {"op": op})
                if op == "submit_raw":
                    # Raw dispatch: the broker peeked only the routing
                    # scalars off this client frame — THIS decode, on
                    # the worker's core, is the frame's first and only
                    # full decode (the deleted hop was broker decode →
                    # ring re-encode → worker decode).
                    try:
                        inner = codec.decode(m["frame"])
                    except ValueError:
                        inner = None
                    msgs = (inner.get("messages")
                            if isinstance(inner, dict) else None)
                    if not isinstance(msgs, list):
                        resp.push(codec.encode(
                            {"id": m["id"], "ok": False,
                             "why": "malformed raw produce frame"}))
                        continue
                else:
                    msgs = m["msgs"]
                vs = spans.span("worker.validate", sp.ctx)
                bad = None
                if not msgs:
                    bad = "empty messages"
                else:
                    for x in msgs:
                        if not isinstance(x, (bytes, bytearray, memoryview)):
                            bad = "payloads must be bytes"
                            break
                        if len(x) == 0:
                            bad = ("empty messages are not supported "
                                   "(length-0 rows mark alignment padding)")
                            break
                        if len(x) > payload_bytes:
                            bad = (f"payload of {len(x)} bytes exceeds "
                                   f"payload_bytes {payload_bytes}")
                            break
                if bad is not None:
                    # NB: ring-protocol refusals ride a `why` field, not
                    # `error` — these frames never reach a wire client
                    # (the dispatcher re-raises/falls back), so they are
                    # deliberately outside the wire retry taxonomy.
                    out = {"id": m["id"], "ok": False, "why": bad}
                    resp.push(codec.encode(out))
                    continue
                vs.end()
                ss = spans.span("worker.stamp", sp.ctx)
                if m.get("pid") is not None:
                    bpid, bseq = int(m["pid"]), int(m.get("seq", -1))
                else:
                    slot = int(m["slot"])
                    if pid > 0:
                        bpid = pid
                        bseq = seqs.get(slot, 0)
                        seqs[slot] = bseq + len(msgs)
                        stamped += len(msgs)
                    else:
                        bpid, bseq = 0, -1
                ss.end()
                ps = spans.span("worker.pack", sp.ctx)
                chunks = []
                for i in range(0, len(msgs), max_batch):
                    block, lens = _pack_rows(msgs[i : i + max_batch],
                                             slot_bytes)
                    chunks.append([lens, block])
                ps.end()
                out["pid"] = bpid
                out["seq"] = bseq
                out["chunks"] = chunks
                sp.end(msgs=len(msgs))
                if sp.ctx is not None:
                    # Ship only the records this request added: the ring
                    # is single-threaded here, so everything past the
                    # cursor belongs to this (sampled) submit.
                    recs = spans.snapshot(after=span_cursor)
                    if recs:
                        span_cursor = recs[-1]["seq"]
                        out["spans"] = recs
                resp.push(codec.encode(out))
            elif op == "read":
                served += 1
                slot = int(m["slot"])
                mir = mirrors.get(slot)
                res = None
                if mir is not None:
                    # Clamp the answer to the response ring's frame cap
                    # (half the ring): an uncapped read (max_msgs=None)
                    # of a full mirror window would push an oversize
                    # frame and kill this worker. A clipped answer is
                    # correct by contract — next_offset points at the
                    # last delivered row, the consumer continues.
                    cap = max(1, (resp.capacity // 2 - 1024)
                              // (payload_bytes + 16))
                    mx = m.get("max")
                    mx = cap if mx is None else min(int(mx), cap)
                    res = mir.read(int(m["offset"]), mx)
                if res is None:
                    resp.push(codec.encode(
                        {"id": m["id"], "ok": False,
                         "why": "mirror_behind"}))
                else:
                    msgs, end = res
                    resp.push(codec.encode(
                        {"id": m["id"], "ok": True, "msgs": msgs,
                         "end": end}))
            elif op == "mirror":
                slot = int(m["slot"])
                mir = mirrors.get(slot)
                if mir is None:
                    mir = mirrors[slot] = _SlotMirror(slot_bytes)
                mir.publish(int(m["base"]), bytes(m["rows"]), mirror_budget)
            elif op == "pid":
                # A pid install always resets the sequence counters:
                # the broker only ever installs a FRESH per-(worker,
                # generation) pid, whose counters must start at zero.
                pid = int(m["pid"])
                seqs = {}
            elif op == "ping":
                resp.push(codec.encode({
                    "id": m["id"], "ok": True, "served": served,
                    "stamped": stamped,
                    "mirror_bytes": sum(x.nbytes for x in mirrors.values()),
                    "pid": pid,
                }))
            elif op == "stop":
                return
    finally:
        req.close()
        resp.close()


# --------------------------------------------------------------------------
# Dispatcher (broker) side
# --------------------------------------------------------------------------


class _WorkerHandle:
    """One worker: its process, its ring pair, and the send/recv thread
    pair that serializes ring access (the rings are SPSC)."""

    def __init__(self, plane: "HostPlane", idx: int, gen: int) -> None:
        import multiprocessing as mp

        self.idx = idx
        self.gen = gen
        self.dead = False
        self.req_ring = ShmRing.create(plane.ring_bytes)
        self.resp_ring = ShmRing.create(plane.ring_bytes)
        self._plane = plane
        self._sendq: "queue.Queue" = queue.Queue(maxsize=4096)
        self._plock = make_lock("_WorkerHandle._plock")
        self._pending: dict[int, Future] = {}
        self._next_id = 0
        ctx = mp.get_context("spawn")
        self.proc = ctx.Process(
            target=_host_worker_main,
            args=(idx, self.req_ring.name, self.resp_ring.name,
                  plane.slot_bytes, plane.payload_bytes, plane.max_batch,
                  plane.mirror_budget),
            daemon=True,
            name=f"hostworker-{idx}",
        )
        self.proc.start()
        self._send_thread = threading.Thread(
            target=self._send_loop, daemon=True,
            name=f"hostplane-send-{idx}",
        )
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"hostplane-recv-{idx}",
        )
        self._send_thread.start()
        self._recv_thread.start()

    # -- request plumbing --

    def request(self, op: dict, timeout_s: float) -> dict:
        """Round-trip one op. The request id is the per-stream sequence
        number: ids are assigned in send order and the worker answers
        in arrival order, so responses pipeline — many RPC threads keep
        many ops in flight on one ring pair."""
        if self.dead:
            raise WorkerUnavailableError(
                f"host worker {self.idx} (gen {self.gen}) is down"
            )
        fut: Future = Future()
        try:
            self._sendq.put((op, fut), timeout=timeout_s)
        except queue.Full:
            raise WorkerUnavailableError(
                f"host worker {self.idx} send queue full"
            ) from None
        try:
            return fut.result(timeout=timeout_s)
        # concurrent.futures.TimeoutError is a distinct class from the
        # builtin before Python 3.11 — catch both (the repo-wide rule).
        except (TimeoutError, FuturesTimeoutError):
            raise WorkerUnavailableError(
                f"host worker {self.idx} unresponsive after {timeout_s}s"
            ) from None

    def post(self, op: dict) -> bool:
        """Fire-and-forget: NEVER blocks the caller — a full queue
        drops the frame (the worker's contiguity check turns a mirror
        drop into a clean fallback, not corruption)."""
        if self.dead:
            return False
        try:
            self._sendq.put_nowait((op, None))
            return True
        except queue.Full:
            return False

    def post_parts(self, parts: list) -> bool:
        """Fire-and-forget scatter-gather publish (the settled-mirror
        path): `parts` is a pre-encoded frame split as
        [codec prefix, payload buffer] — the send loop hands it to
        ShmRing.push_parts so the payload (rows the broker mirror
        already holds) is copied exactly ONCE, into shared memory,
        instead of being re-buffered through codec.encode's output
        bytearray + bytes() snapshot first. Same drop contract as
        post()."""
        if self.dead:
            return False
        try:
            self._sendq.put_nowait((parts, None))
            return True
        except queue.Full:
            return False

    def _send_loop(self) -> None:
        while True:
            item = self._sendq.get()
            if item is None:
                return
            op, fut = item
            rid = None
            parts = None
            if fut is not None:
                with self._plock:
                    rid = self._next_id
                    self._next_id += 1
                    self._pending[rid] = fut
                if isinstance(op, tuple):
                    # Raw-frame request (submit_raw): (meta, blob key,
                    # undecoded frame). The id rides the meta prefix and
                    # the frame crosses into shared memory untouched —
                    # same scatter-gather as post_parts, but round-trip.
                    meta, bkey, blob = op
                    parts = [
                        codec.encode_dict_with_blob(
                            {**meta, "id": rid}, bkey, blob),
                        blob,
                    ]
                else:
                    op = dict(op)
                    op["id"] = rid
            try:
                if isinstance(op, list):
                    # Pre-split scatter-gather frame (post_parts): the
                    # payload part crosses into shared memory directly,
                    # skipping the encode-buffer re-copy.
                    pushed = self.req_ring.push_parts(op, timeout_s=0)
                elif parts is not None:
                    pushed = self.req_ring.push_parts(parts, timeout_s=5.0)
                else:
                    pushed = self.req_ring.push(
                        codec.encode(op),
                        timeout_s=0 if fut is None else 5.0,
                    )
            except ValueError as e:
                # Oversize frame: refuse THIS request only — the worker
                # and every other in-flight op are fine (the submit
                # path pre-checks sizes, so this is a backstop).
                if fut is not None:
                    with self._plock:
                        self._pending.pop(rid, None)
                    if not fut.done():
                        fut.set_exception(OversizeBatchError(str(e)))
                continue
            except Exception as e:
                # Ring closed/full/torn: the worker side of this pair
                # is gone or wedged — fail the window AND hand the
                # handle to the respawn path (unless stop() already
                # latched `dead`, in which case this is shutdown).
                already = self.dead
                self._fail_all(e)
                if not already:
                    self._plane._worker_died(self)
                return
            if not pushed and fut is not None:
                with self._plock:
                    self._pending.pop(rid, None)
                if not fut.done():
                    fut.set_exception(WorkerUnavailableError(
                        f"host worker {self.idx} ring full"
                    ))

    def _recv_loop(self) -> None:
        while not self.dead:
            try:
                frame = self.resp_ring.pop(timeout_s=0.2)
            except (TornFrameError, RingClosedError) as e:
                # A torn response = the worker died mid-publish: this
                # MUST reach the respawn path, not just latch `dead` —
                # otherwise the slice is down until broker restart.
                # (stop() latches `dead` before closing the rings, so a
                # shutdown-raised RingClosedError skips the respawn.)
                already = self.dead
                self._fail_all(e)
                if not already:
                    self._plane._worker_died(self)
                return
            if frame is None:
                if not self.proc.is_alive():
                    self._fail_all(None)
                    self._plane._worker_died(self)
                    return
                continue
            m = codec.decode(frame)
            with self._plock:
                fut = self._pending.pop(m.get("id"), None)
            if fut is not None and not fut.done():
                fut.set_result(m)

    def _fail_all(self, exc: Optional[Exception]) -> None:
        with self._plock:
            # `dead` rides the same mutex as the pending table: the
            # latch and the table drain must be one atomic transition
            # (a submit racing the drain must either register (and be
            # failed here) or see the latch — the ownership lint).
            self.dead = True
            pending = list(self._pending.values())
            self._pending.clear()
        err = WorkerUnavailableError(
            f"host worker {self.idx} (gen {self.gen}) died"
            + (f": {exc}" if exc else "")
        )
        for fut in pending:
            if not fut.done():
                fut.set_exception(err)

    def occupancy(self) -> float:
        try:
            return self.req_ring.fill_fraction()
        except Exception:
            return 0.0

    def stop(self, unlink: bool = True) -> None:
        with self._plock:
            self.dead = True
        try:
            # Best-effort wake for an idle send loop. NEVER a blocking
            # put: with the queue full and the send loop already dead,
            # a blocking put hangs whichever thread runs stop()
            # (respawn path or broker shutdown) forever. A live send
            # loop blocked inside push() wakes via ring close below.
            self._sendq.put_nowait(None)
        except queue.Full:
            pass
        try:
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(timeout=1.0)
                if self.proc.is_alive():
                    self.proc.kill()
                    self.proc.join(timeout=1.0)
        except Exception:
            pass
        self._fail_all(None)
        if unlink:
            self.req_ring.close()
            self.resp_ring.close()


class HostPlane:
    """Dispatcher for `n_workers` host-plane workers. Thread-safe: RPC
    worker threads call submit()/read(), the settle thread publish(),
    the duty loop set_worker_pid()/stats()."""

    def __init__(self, n_workers: int, slot_bytes: int, payload_bytes: int,
                 max_batch: int, ring_bytes: int = 1 << 22,
                 mirror_budget: int = 4 << 20,
                 recorder=None, spans=None) -> None:
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        self.slot_bytes = slot_bytes
        self.payload_bytes = payload_bytes
        self.max_batch = max_batch
        self.ring_bytes = ring_bytes
        self.mirror_budget = mirror_budget
        self.recorder = recorder
        # Broker span ring (obs/spans.SpanRing) or None. Worker-side
        # span records riding back in submit responses are ingested
        # here so admin.spans serves one page covering both processes.
        self.spans = spans
        self._lock = make_lock("HostPlane._lock")
        self._workers: list[Optional[_WorkerHandle]] = [None] * n_workers
        self._gens = [0] * n_workers
        self._last_respawn = [0.0] * n_workers
        self._restarts = 0
        self._stopped = False

    def start(self) -> None:
        with self._lock:
            for i in range(self.n_workers):
                if self._workers[i] is None:
                    self._workers[i] = _WorkerHandle(self, i, self._gens[i])

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            workers = [w for w in self._workers if w is not None]
            self._workers = [None] * self.n_workers
        for w in workers:
            w.stop()

    # -- worker lifecycle --

    def _worker_died(self, handle: _WorkerHandle) -> None:
        """Called by the dead worker's recv thread: respawn with a
        bumped generation (rate-limited — a worker that dies at boot
        must not spin the dispatcher)."""
        if self.recorder is not None:
            self.recorder.record("host_worker_down", worker=handle.idx,
                                 generation=handle.gen)
        log.warning("host worker %d (gen %d) died; respawning",
                    handle.idx, handle.gen)
        handle.stop()
        with self._lock:
            if self._stopped or self._workers[handle.idx] is not handle:
                return
            self._workers[handle.idx] = None
        # Backoff OUTSIDE the lock (submitters probe `dead` bare).
        since = time.monotonic() - self._last_respawn[handle.idx]
        if since < 1.0:
            time.sleep(1.0 - since)
        with self._lock:
            if self._stopped or self._workers[handle.idx] is not None:
                return
            self._gens[handle.idx] += 1
            gen = self._gens[handle.idx]
            self._last_respawn[handle.idx] = time.monotonic()
            self._restarts += 1
            self._workers[handle.idx] = _WorkerHandle(self, handle.idx, gen)
        if self.recorder is not None:
            self.recorder.record("host_worker_restart", worker=handle.idx,
                                 generation=gen)

    def _handle(self, slot: int) -> _WorkerHandle:
        idx = worker_of(slot, self.n_workers)
        with self._lock:
            w = self._workers[idx]
        if w is None or w.dead:
            raise WorkerUnavailableError(
                f"host worker {idx} for partition slot {slot} is "
                f"respawning; retry"
            )
        return w

    # -- host-path ops --

    def submit(self, slot: int, messages: list, pid=None, seq=None,
               timeout_s: float = 5.0, tctx=None) -> dict:
        """Validate + stamp + pack one produce batch on the owning
        worker. Returns {"pid", "seq", "chunks": [(lens, packed), ...]}
        (chunks are max_batch-sized row blocks). Raises
        WorkerUnavailableError (typed, retryable) when the worker is
        down, ValueError on a validation refusal."""
        # Pre-check BOTH directions against the per-frame cap (half the
        # ring): the request carries the raw payloads, the response the
        # slot_bytes-rounded packed blocks. An oversize batch must
        # never reach the ring push — a worker-side push failure kills
        # the worker, and the client's retry would re-kill each respawn.
        cap = self.ring_bytes // 2
        k = len(messages)
        req_bound = sum(map(len, messages)) + 8 * k + 256
        resp_bound = k * (self.slot_bytes + 16) + 256
        if req_bound > cap or resp_bound > cap:
            raise OversizeBatchError(
                f"{k}-message batch needs ~{max(req_bound, resp_bound)} "
                f"bytes against a {cap}-byte frame cap "
                f"(host_ring_bytes {self.ring_bytes}); falling back to "
                f"the in-process submit path"
            )
        op = {"op": "submit", "slot": int(slot), "msgs": list(messages)}
        if pid is not None:
            op["pid"] = int(pid)
            op["seq"] = int(seq if seq is not None else -1)
        if tctx is not None:
            op["tctx"] = tctx  # wire form: [trace_id, parent_span_id]
        resp = self._handle(slot).request(op, timeout_s)
        if not resp.get("ok"):
            raise ValueError(str(resp.get("why", "submit refused")))
        if self.spans is not None and resp.get("spans"):
            self.spans.ingest(resp["spans"])
        return resp

    def submit_raw(self, slot: int, frame, n_msgs: int, pid=None, seq=None,
                   timeout_s: float = 5.0) -> dict:
        """submit() from an UNDECODED client produce frame: the frame
        crosses the ring verbatim (scatter-gather, one copy into shared
        memory) and the owning worker performs its only full decode —
        the dispatcher contributed a scalar peek, not a decode→re-encode
        hop. `n_msgs` is the peeked message count (response-size bound);
        same refusal contract as submit()."""
        cap = self.ring_bytes // 2
        k = int(n_msgs)
        req_bound = len(frame) + 512
        resp_bound = k * (self.slot_bytes + 16) + 256
        if req_bound > cap or resp_bound > cap:
            raise OversizeBatchError(
                f"{k}-message raw frame needs ~{max(req_bound, resp_bound)} "
                f"bytes against a {cap}-byte frame cap "
                f"(host_ring_bytes {self.ring_bytes}); falling back to "
                f"the in-process submit path"
            )
        meta = {"op": "submit_raw", "slot": int(slot)}
        if pid is not None:
            meta["pid"] = int(pid)
            meta["seq"] = int(seq if seq is not None else -1)
        resp = self._handle(slot).request((meta, "frame", frame), timeout_s)
        if not resp.get("ok"):
            raise ValueError(str(resp.get("why", "submit refused")))
        return resp

    def read(self, slot: int, offset: int, max_msgs: Optional[int],
             timeout_s: float = 2.0) -> Optional[tuple[list, int]]:
        """Serve a consume read from the owning worker's settled
        mirror; None when the mirror cannot serve it (fall back to the
        engine read path) — including when the worker is down."""
        try:
            resp = self._handle(slot).request(
                {"op": "read", "slot": int(slot), "offset": int(offset),
                 "max": max_msgs},
                timeout_s,
            )
        except WorkerUnavailableError:
            return None
        if not resp.get("ok"):
            return None
        return list(resp["msgs"]), int(resp["end"])

    def publish(self, slot: int, base: int, rows) -> None:
        """Fire-and-forget settled-mirror push (settle thread). A drop
        (full queue, dead worker) is safe: the worker's contiguity
        check resets its window and reads fall back.

        The rows are published as a REFERENCE + range, not a copy: the
        frame is pre-split into (encoded header prefix, the row
        buffer) and ShmRing.push_parts writes both straight into
        shared memory — the broker mirror already holds these exact
        bytes (DataPlane._mirror_records), and the old path re-buffered
        them twice through codec.encode before the one copy that
        matters (byte parity pinned in tests/test_hostplane.py)."""
        if len(rows) + 256 > self.ring_bytes // 2:
            return  # frame would exceed the ring cap: drop, not kill
        idx = worker_of(slot, self.n_workers)
        with self._lock:
            w = self._workers[idx]
        if w is not None:
            prefix = codec.encode_dict_with_blob(
                {"op": "mirror", "slot": int(slot), "base": int(base)},
                "rows", rows,
            )
            w.post_parts([prefix, rows])

    def set_worker_pid(self, idx: int, pid: int,
                       gen: Optional[int] = None) -> None:
        """Install worker `idx`'s stamping pid (0 invalidates). `gen`
        fences the install to the generation the pid was REGISTERED
        for: a respawn between the caller's generation snapshot and
        this install must drop the pid, not hand an old generation's
        pid to a worker whose sequence counters restarted at zero
        (that collapses fresh batches as dedup replays: acked loss).
        The fence is dispatcher-side — a handle that respawned after
        the snapshot is a different object with a different gen, and a
        post to the OLD handle no-ops on its dead latch."""
        with self._lock:
            w = self._workers[idx]
            if w is None or (gen is not None and w.gen != gen):
                return
        w.post({"op": "pid", "pid": int(pid)})

    def generations(self) -> list[int]:
        with self._lock:
            return list(self._gens)

    def worker_pids(self) -> list[int]:
        """OS pids of the live worker subprocesses (bench CPU
        accounting; dead/respawning slots are skipped)."""
        with self._lock:
            workers = list(self._workers)
        return [w.proc.pid for w in workers
                if w is not None and not w.dead and w.proc.pid is not None]

    def stats(self, ping_timeout_s: float = 0.5) -> dict:
        """Liveness/occupancy snapshot (admin.stats `host_plane`)."""
        with self._lock:
            workers = list(self._workers)
        alive = 0
        served = 0
        occupancy = []
        for w in workers:
            if w is None or w.dead:
                occupancy.append(-1.0)
                continue
            alive += 1
            occupancy.append(round(w.occupancy(), 4))
            try:
                pong = w.request({"op": "ping"}, ping_timeout_s)
                served += int(pong.get("served", 0))
            except Exception:
                pass  # liveness snapshot: a stalled ping is not fatal
        return {
            "workers": self.n_workers,
            "alive": alive,
            "restarts": self._restarts,
            "served": served,
            "occupancy": occupancy,
        }

"""StripeReplicator: the striped twin of broker/replication.py's
RoundReplicator — same interface (begin/wait/replicate/catchup/
sync_members/take_suspects/stop), different durability mechanics.

Instead of streaming a FULL copy of every committed-round record to
every standby, one ENCODER thread drains the queued backlog as group
commits (the same caps as the full-copy sender), serializes each group
into one blob, runs ONE GF(2⁸) matmul through ops/rs.py to produce
RS_K data + RS_M parity stripes (stripes/codec.py), and fans each
stripe out to the standby its replicated assignment names
(stripe_assignment beside the standby set in metadata). Standbys
persist stripe frames (REC_STRIPE, header-covered CRC) instead of full
rows — replication bytes scale with (k+m)/k instead of the standby
count.

The durability fence generalizes the full-copy plane's discipline:

- **Settle at any k stripe-acks.** A round's future resolves once
  acked stripes cover >= RS_K DISTINCT indices — the blob is then
  reconstructible from standbys alone, which is the full-copy
  invariant ("every settled append survives controller death")
  restated for stripes. The remaining m stripes keep streaming in the
  background, raising tolerance to m holder losses.
- **Fewer than k reachable stripe-holders refuses to settle** (the
  full-copy empty-set refusal generalized): if members leave the set until
  the not-yet-acked stripes can no longer reach k distinct indices,
  the round fails with ReplicationError — producers get a retryable
  refusal, nothing acks without a rebuildable copy. An EMPTY set
  refuses outright once members ever existed (genesis keeps the
  bootstrap behavior).
- **Epoch fencing** is unchanged: every repl.stripes RPC is stamped
  from the ACTIVE view per delivery attempt, standbys refuse stale
  epochs, and a deposed sender fails its backlog with FencedError.
- **Per-member FIFO order** is unchanged: one encoder assigns group
  sequence numbers (gsn, monotone per controller generation; the
  frame's epoch disambiguates across generations) and each member's
  sender delivers its frames in gsn order, so every store receives a
  consistently ordered stripe stream (recovery replays groups in
  (epoch, catchup-first, gsn) order — stripes/recovery.py).

Catch-up re-stripes: a joining standby receives the controller's FULL
store prefix as fresh catch-up groups encoded under the prospective
membership (only the joiner's stripe indices are streamed to it), with
live groups buffering behind exactly like the full-copy protocol — so
membership change is also the re-striping path that restores coverage
after a member loss.

Twin of `ripplemq_tpu/stripes/plane.py` (PyTorch port): the same code,
importing only the port's modules. `encode_kw` reaches every
`encode_group` call, so it carries the device the GF(2⁸) product runs
on (`{"device": ...}`; the broker passes its own). Without it the codec
runs on CUDA and raises on a host without one.
"""

from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

from ripplemq_tpu_torch.broker.replication import (
    FencedError,
    ReplicationError,
)
from ripplemq_tpu_torch.stripes.codec import (
    RS_K,
    RS_M,
    encode_group,
    stripe_assignment,
)
from ripplemq_tpu_torch.obs.lockwitness import make_condition, make_lock
from ripplemq_tpu_torch.obs.spans import ctx_from_wire
from ripplemq_tpu_torch.utils.logs import get_logger

log = get_logger("stripes")

# Group-commit caps (the full-copy sender's, applied at the encoder:
# one blob per drained backlog up to these bounds).
_GROUP_COMMIT_BYTES = 8 << 20
_GROUP_COMMIT_ROUNDS = 128
_CATCHUP_BATCH_RECORDS = 256
_CATCHUP_BATCH_BYTES = 1 << 20
# One repl.stripes RPC carries at most this many queued frame batches.
_SEND_BATCH_BYTES = 8 << 20


class StripeTicket:
    """One round's in-flight striped replication (opaque; pass back to
    wait())."""

    __slots__ = ("fut", "start")

    def __init__(self, fut: Future, start: float) -> None:
        self.fut = fut
        self.start = start


class _Group:
    """Ack tracker for one encoded group: which stripe indices (and
    which MEMBERS) acked, which member holds each not-yet-acked stripe,
    and the round futures that resolve at quorum.

    Quorum = k distinct stripe indices AND min(#distinct members, k)
    distinct member acks. The member clause matters below k+m
    standbys, where the wrapped assignment loads several stripes onto
    one broker: counting indices alone would settle a round on a
    SINGLE standby's ack (its 3 stripes cover k) with nothing persisted
    anywhere else — strictly worse than full-copy mode's every-member
    fence. Requiring the member spread makes the settle wait for every
    distinct holder up to k of them, which is the best durability the
    small-set geometry admits (see ClusterConfig.replication docs)."""

    __slots__ = ("key", "futs", "targets", "acked", "acked_members",
                 "need_members")

    def __init__(self, key, futs, targets) -> None:
        self.key = key
        self.futs = futs          # list[Future] (one per round)
        self.targets = targets    # stripe idx -> broker id
        self.acked: set[int] = set()
        self.acked_members: set[int] = set()
        self.need_members = min(len(set(targets.values())), RS_K)

    def quorum(self) -> bool:
        return (len(self.acked) >= RS_K
                and len(self.acked_members) >= self.need_members)


class _StripeSender(threading.Thread):
    """Ordered stripe-frame stream to one standby. Entries are
    (key, frames, idxs, fut-or-None, tctxs-or-None): live entries ack
    through the replicator's group tracker, catch-up entries resolve
    their own future at RPC-ok; tctxs are the wire-form trace contexts
    of the group's sampled produces, stamped onto the repl.stripes
    request so holder-side apply spans join the trace."""

    def __init__(self, rep: "StripeReplicator", broker_id: int) -> None:
        super().__init__(daemon=True, name=f"stripe-sender-{broker_id}")
        self.broker_id = broker_id
        self._rep = rep
        self._cond = make_condition("_StripeSender._cond")
        self._queue: list[tuple] = []
        self._buffer: Optional[list[tuple]] = None
        self._stopped = False
        self.unreachable = False

    def enqueue(self, entry: tuple) -> None:
        with self._cond:
            if self._stopped:
                self._fail_entry(entry, ReplicationError("sender stopped"))
                return
            if self._buffer is not None:
                self._buffer.append(entry)
            else:
                self._queue.append(entry)
                self._cond.notify()

    def enqueue_catchup(self, entry: tuple) -> None:
        with self._cond:
            if self._stopped:
                self._fail_entry(entry, ReplicationError("sender stopped"))
                return
            self._queue.append(entry)
            self._cond.notify()

    def begin_buffer(self) -> None:
        with self._cond:
            if self._buffer is None:
                self._buffer = []

    def end_buffer(self) -> None:
        with self._cond:
            if self._buffer is not None:
                self._queue.extend(self._buffer)
                self._buffer = None
                self._cond.notify()

    @staticmethod
    def _fail_entry(entry: tuple, exc: Exception) -> None:
        fut = entry[3]
        if fut is not None and not fut.done():
            fut.set_exception(exc)

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            leftovers = self._queue + (self._buffer or [])
            self._queue = []
            self._buffer = None
            self._cond.notify()
        for entry in leftovers:
            self._fail_entry(entry, ReplicationError("sender stopped"))
        # No group notification needed: wait()'s coverage check treats a
        # member with a stopped sender (pruned from the map) as unable
        # to contribute its stripes.

    def run(self) -> None:
        backoff = 0.05
        failures = 0
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait(timeout=0.2)
                if self._stopped:
                    return
                batch = [self._queue.pop(0)]
                nbytes = sum(len(f) for f in batch[0][1])
                while self._queue and nbytes < _SEND_BATCH_BYTES:
                    nbytes += sum(len(f) for f in self._queue[0][1])
                    batch.append(self._queue.pop(0))
            frames = [f for entry in batch for f in entry[1]]
            tctxs = [t for entry in batch for t in (entry[4] or ())]

            def fail_all(exc: Exception) -> None:
                for entry in batch:
                    self._fail_entry(entry, exc)
                # Live entries' groups are failed by the tracker so
                # every round future of the group resolves at once.
                self._rep._fail_groups(
                    [e[0] for e in batch if e[3] is None], exc
                )

            while True:
                if self._stopped:
                    # A stopped sender (member pruned / replicator
                    # stopping) only fails ITS OWN per-entry futures
                    # (catch-up). Live groups are NOT failed: the other
                    # k+ holders can still settle them — failing (and
                    # tombstoning) them here would nack whole in-flight
                    # batches on an ordinary single-member prune. The
                    # wait()-side coverage check handles the case where
                    # this member's stripes were actually needed.
                    for entry in batch:
                        self._fail_entry(
                            entry, ReplicationError("sender stopped")
                        )
                    break
                if not self._rep.active():
                    fail_all(FencedError("controller deposed (local "
                                         "metadata)"))
                    break
                # Stamped per delivery attempt from the ACTIVE view —
                # never re-read after a deposition (the full-copy
                # sender's discipline, broker/replication.py).
                epoch = self._rep.epoch_fn()
                if not self._rep.active():
                    fail_all(FencedError("controller deposed (local "
                                         "metadata)"))
                    break
                t0 = (self._rep._clock()
                      if self._rep._h_frame_us is not None else 0.0)
                req = {"type": "repl.stripes", "epoch": epoch,
                       "frames": frames}
                if tctxs:
                    req["tctx"] = tctxs
                try:
                    resp = self._rep.client.call(
                        self._rep.addr_of(self.broker_id), req,
                        timeout=self._rep.rpc_timeout_s,
                    )
                except Exception:
                    failures += 1
                    if self._rep._c_retries is not None:
                        self._rep._c_retries.inc()
                    if failures >= 3:
                        self.unreachable = True
                    time.sleep(min(0.5, backoff * failures))
                    continue
                failures = 0
                self.unreachable = False
                if resp.get("ok"):
                    if self._rep._h_frame_us is not None:
                        self._rep._h_frame_us.observe(
                            self._rep._clock() - t0
                        )
                        self._rep._c_bytes.inc(nbytes)
                        self._rep._c_frames.inc(len(frames))
                    for entry in batch:
                        key, idxs, fut = entry[0], entry[2], entry[3]
                        if fut is not None:
                            if not fut.done():
                                fut.set_result(True)
                        else:
                            self._rep._ack(key, idxs,
                                           member=self.broker_id)
                    break
                if resp.get("error") == "stale_epoch":
                    fail_all(FencedError("standby reports newer epoch"))
                    break
                if resp.get("error") == "store_quarantined":
                    with self._rep._lock:
                        self._rep._suspects.add(self.broker_id)
                # Transient refusal (incl. bad_stripe_frame — a frame
                # damaged in flight re-sends from the in-memory copy).
                failures += 1
                time.sleep(min(0.5, backoff * failures))


class StripeReplicator:
    """Controller-side striped fan-out (see module docstring).

    Same constructor surface as RoundReplicator plus `stripe_map_fn`
    (the replicated stripe→member assignment; defaults to deriving it
    from members_fn via stripes/codec.stripe_assignment, which is
    byte-identical to what every manager apply records)."""

    def __init__(
        self,
        client,
        addr_of: Callable[[int], str],
        epoch_fn: Callable[[], int],
        members_fn: Callable[[], tuple],
        active_fn: Callable[[], bool],
        rpc_timeout_s: float = 3.0,
        ack_timeout_s: float = 5.0,
        metrics=None,
        stripe_map_fn: Optional[Callable[[], tuple]] = None,
        live_fn: Optional[Callable[[], list]] = None,
        encode_kw: Optional[dict] = None,
        sender_id: int = -1,
        pipeline_depth: int = 1,
    ) -> None:
        self.client = client
        self.addr_of = addr_of
        self.epoch_fn = epoch_fn
        self.members_fn = members_fn
        self.active = active_fn
        self.rpc_timeout_s = rpc_timeout_s
        self.ack_timeout_s = ack_timeout_s
        # Constructor parity with RoundReplicator (the broker passes one
        # kwargs dict to either plane). The stripe stream settles at
        # any-k acks, so one slow member never heads-of-line the round
        # the way the full-copy stream did — per-stream pipelining is
        # carried for parity and future use, not consulted yet.
        self.sender_id = int(sender_id)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.stripe_map_fn = stripe_map_fn or (
            lambda: stripe_assignment(members_fn())
        )
        # Liveness view (the manager's replicated `live` list): a holder
        # that is a set member but DEAD cannot contribute its stripes,
        # so the below-k refusal counts it out before a round queues.
        # None → every member counts (tests / bare planes).
        self.live_fn = live_fn
        # Extra kwargs for encode_group (the device: the broker's own;
        # tests pass device="cpu").
        self.encode_kw = dict(encode_kw or {})
        if metrics is not None and getattr(metrics, "enabled", True):
            self._h_encode_us = metrics.histogram("stripes.encode_us")
            self._h_group = metrics.histogram("stripes.group_rounds")
            self._h_frame_us = metrics.histogram("stripes.frame_us")
            self._c_bytes = metrics.counter("stripes.bytes")
            self._c_frames = metrics.counter("stripes.frames")
            self._c_groups = metrics.counter("stripes.groups")
            self._c_retries = metrics.counter("stripes.send_retries")
            self._clock = metrics.clock
        else:
            self._h_encode_us = self._h_group = self._h_frame_us = None
            self._c_bytes = self._c_frames = None
            self._c_groups = self._c_retries = None
            self._clock = time.perf_counter
        # Causal-tracing hook (obs/spans.py): the owning broker sets
        # this to its SpanRing when trace sampling is configured;
        # begin() then records stripe.send spans (see its docstring).
        self.spans = None
        self._lock = make_lock("StripeReplicator._lock")
        self._senders: dict[int, _StripeSender] = {}
        self._joining: set[int] = set()
        self._suspects: set[int] = set()
        self._groups: dict[tuple[int, int], _Group] = {}
        # Future → group key (populated at encode, popped at group
        # resolution): wait()'s per-tick group lookup must be O(1), not
        # a scan of every in-flight group's round futures under the
        # lock the ack path contends on.
        self._fut_key: dict[Future, tuple[int, int]] = {}
        self._had_members = False
        self._stopped = False
        # Group sequence numbers must be unique across controller
        # RESTARTS at the same epoch (a plain 0-based counter collided
        # with the previous boot's groups on standby stores, read by
        # recovery as mixed generations — the seed-2 striped soak
        # found it as quarantine-grade data loss): seed the counter
        # from wall-clock milliseconds shifted past a 23-bit per-boot
        # counter space. Monotone as long as the clock advances ~1 ms
        # between boots of one broker — restarts take seconds.
        self._gsn = (int(time.time() * 1000) & 0xFFFFFFFFFF) << 23
        # Contiguous-settle watermark (the frames' `settled_floor`):
        # highest gsn at-or-below which every TRACKED group resolved
        # (settled or terminally failed). Stamped into every encoded
        # frame so recovery can tell acked loss (short group <= floor:
        # quarantine-grade) from a torn tail (short group > every
        # observed floor: never settled, droppable).
        self._floor = 0
        self._floor_pending: list[int] = []  # heapq of outstanding gsns
        self._floor_done: set[int] = set()
        self._enc_cond = make_condition("StripeReplicator._enc_cond")
        # Encoder inbox entries: (records, fut, tctxs) — tctxs the
        # wire-form trace contexts of the round's sampled produces
        # (None when untraced), carried through encode into the
        # sender entries and onto the repl.stripes frames.
        self._pending: list[tuple[list, Future, Optional[list]]] = []
        self._encoder = threading.Thread(
            target=self._encode_loop, daemon=True, name="stripe-encoder"
        )
        self._encoder.start()

    # -- sender management (RoundReplicator surface) --

    def _sender(self, bid: int) -> _StripeSender:
        with self._lock:
            if self._stopped:
                raise ReplicationError("replicator stopped")
            s = self._senders.get(bid)
            if s is None:
                s = _StripeSender(self, bid)
                self._senders[bid] = s
                s.start()
            return s

    def sync_members(self) -> None:
        members = set(self.members_fn())
        with self._lock:
            drop = [
                bid for bid in self._senders
                if bid not in members and bid not in self._joining
            ]
            dropped = [self._senders.pop(bid) for bid in drop]
        for s in dropped:
            s.stop()

    def is_joining(self, bid: int) -> bool:
        with self._lock:
            return bid in self._joining

    def take_suspects(self) -> set[int]:
        with self._lock:
            out = self._suspects
            self._suspects = set()
            return out

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            senders = list(self._senders.values())
            self._senders.clear()
            groups = list(self._groups.values())
            self._groups.clear()
            self._fut_key.clear()
        with self._enc_cond:
            # The encoder queue is _enc_cond's domain (begin/encode
            # touch it under that lock, never _lock).
            pending = list(self._pending)
            self._pending.clear()
            self._enc_cond.notify_all()
        for s in senders:
            s.stop()
        exc = ReplicationError("replicator stopped")
        for g in groups:
            for f in g.futs:
                if not f.done():
                    f.set_exception(exc)
        for entry in pending:
            if not entry[1].done():
                entry[1].set_exception(exc)

    # -- group ack tracking --

    def _mark_resolved_locked(self, gsn: int) -> None:
        """Advance the contiguous-settle floor past `gsn` (caller holds
        self._lock). Terminal failures count too: a failed group's
        rounds were NACKED, so recovery owes them nothing."""
        self._floor_done.add(gsn)
        while (self._floor_pending
               and self._floor_pending[0] in self._floor_done):
            g = heapq.heappop(self._floor_pending)
            self._floor_done.discard(g)
            if g > self._floor:
                self._floor = g

    def _ack(self, key, idxs: list[int],
             member: Optional[int] = None) -> None:
        """A member acked (persisted) stripes `idxs` of group `key`."""
        done: Optional[_Group] = None
        with self._lock:
            g = self._groups.get(key)
            if g is None:
                return  # already settled (quorum reached earlier)
            g.acked.update(idxs)
            if member is not None:
                g.acked_members.add(member)
            if g.quorum():
                done = self._groups.pop(key)
                self._forget_futs_locked(done)
                self._mark_resolved_locked(key[1])
        if done is not None:
            for f in done.futs:
                if not f.done():
                    f.set_result(True)

    def _fail_groups(self, keys: list, exc: Exception) -> None:
        failed: list[_Group] = []
        with self._lock:
            for key in keys:
                if key is None:
                    continue
                g = self._groups.pop(key, None)
                if g is not None:
                    failed.append(g)
                    self._forget_futs_locked(g)
                    self._mark_resolved_locked(key[1])
        for g in failed:
            for f in g.futs:
                if not f.done():
                    f.set_exception(exc)
        # TOMBSTONE the nacked groups (best-effort, not under a fence:
        # a deposed sender's streams are dead anyway): some of a failed
        # group's stripes may already sit on standby disks, and the
        # settled floor advances past the failure — without a tombstone
        # a later promotion would read the partial leftovers as ACKED
        # loss (short group <= floor) and falsely quarantine a healthy
        # store. Any one surviving tombstone frame tells recovery the
        # group was nacked and must drop.
        if failed and not isinstance(exc, FencedError) and self.active():
            for g in failed:
                try:
                    epoch, gsn = g.key
                    frames = encode_group([], epoch, gsn, tombstone=True,
                                          **self.encode_kw)
                    for bid in set(g.targets.values()):
                        idx = next(i for i, b in g.targets.items()
                                   if b == bid)
                        self._sender(bid).enqueue(
                            (None, [frames[idx]], [idx], None, None)
                        )
                except Exception:  # best-effort by design
                    log.debug("tombstone send for %s failed", g.key,
                              exc_info=True)

    def _group_of(self, fut: Future) -> Optional[_Group]:
        with self._lock:
            key = self._fut_key.get(fut)
            return self._groups.get(key) if key is not None else None

    def _forget_futs_locked(self, g: _Group) -> None:
        for f in g.futs:
            self._fut_key.pop(f, None)

    # -- hot path (DataPlane settle pipeline) --

    def begin(self, records: list,
              tctxs: Optional[list] = None) -> StripeTicket:
        """Queue one round for encoding; returns the ticket wait()
        blocks on. Fences and the generalized empty/below-k refusal
        fire HERE (before anything is enqueued) from the current map;
        the encoder and wait() re-check as membership moves. `tctxs`
        carries the wire-form trace contexts of the round's sampled
        produces: stamped onto the stripe frames and recorded as
        sender-side stripe.send spans that end when the round's stripe
        quorum (or terminal failure) resolves."""
        if not self.active():
            raise FencedError("controller deposed (local metadata)")
        held = self.stripe_map_fn()
        if held:
            self._had_members = True
        elif self._had_members:
            raise ReplicationError(
                "stripe-holder set empty (failover armed): no "
                "reconstructible copy to settle against"
            )
        fut: Future = Future()
        if not held:
            with self._lock:
                joining = bool(self._joining)
            if not joining:
                # Genesis (no standby ever joined, none joining):
                # bootstrap behavior — nothing to stripe against, the
                # round settles locally.
                fut.set_result(True)
                return StripeTicket(fut, time.monotonic())
            # A joiner's catch-up is in flight: the round must still
            # reach its buffered stream (the gap-free join invariant —
            # any record the catch-up scan misses must arrive live),
            # but no MEMBER holds stripes yet, so nothing gates the
            # settle. The encoder resolves the future after fan-out.
        reachable = set(self.members_fn())
        if self.live_fn is not None:
            reachable &= set(self.live_fn())
        coverage = {i for i, b in enumerate(held) if b in reachable}
        if len(coverage) < RS_K:
            # The generalized empty-set refusal: fewer than k live stripe-
            # holders means no settleable round can be reconstructed
            # from standbys — refuse retryably until membership heals.
            raise ReplicationError(
                f"only {len(coverage)} of {RS_K + RS_M} stripes held by "
                f"live members (need {RS_K}): refusing to settle"
            )
        if tctxs and self.spans is not None:
            # One stripe.send span per sampled produce, covering encode
            # queue + fan-out + the k-quorum wait (the sender-side half
            # of the striped replication edge; holders record
            # stripe.apply on their side).
            for raw in tctxs:
                ctx = ctx_from_wire(raw)
                if ctx is None:
                    continue
                sp = self.spans.span("stripe.send", ctx)
                fut.add_done_callback(lambda _f, s=sp: s.end())
        with self._enc_cond:
            if self._stopped:
                raise ReplicationError("replicator stopped")
            self._pending.append((records, fut, tctxs))
            self._enc_cond.notify()
        return StripeTicket(fut, time.monotonic())

    def wait(self, ticket: StripeTicket,
             timeout_s: Optional[float] = None) -> None:
        """Block until the round's group reaches k distinct stripe-acks
        (or a fence/refusal). Ack deadline counts from begin(); slow
        members holding unacked stripes are flagged suspect after
        ack_timeout_s (the duty loop prunes them from the set, which in
        turn shrinks the achievable coverage — below k, the round
        refuses instead of hanging)."""
        fut = ticket.fut
        start = ticket.start
        suspected = False
        while True:
            try:
                fut.result(timeout=0.05)
                return
            except Exception as e:  # noqa: BLE001 — timeout vs outcome
                from concurrent.futures import (
                    TimeoutError as FuturesTimeoutError,
                )

                if not isinstance(e, (TimeoutError, FuturesTimeoutError)):
                    raise
            if not self.active():
                raise FencedError("controller deposed (local metadata)")
            elapsed = time.monotonic() - start
            if timeout_s is not None and elapsed > timeout_s:
                raise ReplicationError(
                    f"stripe quorum unconfirmed after {timeout_s}s"
                )
            g = self._group_of(fut)
            if g is None:
                continue  # not yet encoded, or resolving right now
            live = set(self.members_fn())
            achievable = set(g.acked) | {
                i for i, b in g.targets.items() if b in live
            }
            if len(achievable) < RS_K:
                if not self.active():
                    raise FencedError(
                        "controller deposed (local metadata)"
                    )
                self._fail_groups([g.key], ReplicationError(
                    f"stripe coverage fell below k={RS_K} "
                    f"(achievable {sorted(achievable)})"
                ))
                continue  # the future now carries the error
            # Member-quorum waiver (the full-copy member-left waiver
            # restated): a PRUNED member can never contribute its ack,
            # so the member requirement adapts down to what the
            # remaining holders can supply — stripes-acked >= k stays
            # the hard floor. Settle here if the adapted quorum is met
            # (the sender-side check uses the static requirement).
            ach_members = set(g.acked_members) | {
                b for b in g.targets.values() if b in live
            }
            need = min(len(ach_members), g.need_members)
            if len(g.acked) >= RS_K and len(g.acked_members) >= need:
                done: Optional[_Group] = None
                with self._lock:
                    if self._groups.get(g.key) is g:
                        done = self._groups.pop(g.key)
                        self._forget_futs_locked(done)
                        self._mark_resolved_locked(g.key[1])
                if done is not None:
                    for f in done.futs:
                        if not f.done():
                            f.set_result(True)
                continue
            if not suspected and elapsed > self.ack_timeout_s:
                suspected = True
                slow = {
                    b for i, b in g.targets.items()
                    if i not in g.acked and b in live
                }
                if slow:
                    log.warning(
                        "stripe holders %s not acking after %.1fs; "
                        "flagged suspect", sorted(slow),
                        self.ack_timeout_s,
                    )
                    with self._lock:
                        self._suspects.update(slow)

    def replicate(self, records: list,
                  timeout_s: Optional[float] = None) -> None:
        self.wait(self.begin(records), timeout_s=timeout_s)

    # -- encoder --

    def _encode_loop(self) -> None:
        while True:
            with self._enc_cond:
                while not self._pending and not self._stopped:
                    self._enc_cond.wait(timeout=0.2)
                if self._stopped:
                    return
                group = [self._pending.pop(0)]
                nbytes = sum(len(r[3]) for r in group[0][0])
                while (self._pending
                       and len(group) < _GROUP_COMMIT_ROUNDS
                       and nbytes < _GROUP_COMMIT_BYTES):
                    recs = self._pending[0][0]
                    nbytes += sum(len(r[3]) for r in recs)
                    group.append(self._pending.pop(0))
            try:
                self._encode_and_send(group)
            except Exception as e:  # encoder must never die
                log.warning("stripe encode failed: %s: %s",
                            type(e).__name__, e)
                for entry in group:
                    f = entry[1]
                    if not f.done():
                        f.set_exception(ReplicationError(
                            f"stripe encode failed: {e}"
                        ))

    def _encode_and_send(self, group: list[tuple]) -> None:
        futs = [e[1] for e in group]
        tctxs = [t for e in group for t in (e[2] or ())] or None
        if not self.active():
            exc = FencedError("controller deposed (local metadata)")
            for f in futs:
                if not f.done():
                    f.set_exception(exc)
            return
        held = self.stripe_map_fn()
        with self._lock:
            joining = set(self._joining)
        if not held and not joining:
            # Membership emptied between begin() and here: refuse (the
            # begin-side latch has already seen members, or begin
            # resolved the genesis case without enqueueing).
            exc = ReplicationError(
                "stripe-holder set empty (failover armed): no "
                "reconstructible copy to settle against"
            )
            for f in futs:
                if not f.done():
                    f.set_exception(exc)
            return
        epoch = self.epoch_fn()
        if not self.active():
            exc = FencedError("controller deposed (local metadata)")
            for f in futs:
                if not f.done():
                    f.set_exception(exc)
            return
        records = [r for e in group for r in e[0]]
        with self._lock:
            gsn = self._gsn
            self._gsn += 1
            floor = self._floor
            if held:
                # Tracked group: outstanding until its quorum (or its
                # terminal failure) — blocks the settle floor meanwhile.
                heapq.heappush(self._floor_pending, gsn)
        t0 = self._clock() if self._h_encode_us is not None else 0.0
        frames = encode_group(records, epoch, gsn, settled_floor=floor,
                              **self.encode_kw)
        if self._h_encode_us is not None:
            self._h_encode_us.observe(self._clock() - t0)
            self._c_groups.inc()
            self._h_group.observe_int(len(futs))
        key = (epoch, gsn)
        by_member: dict[int, list[int]] = {}
        for i, b in enumerate(held):
            by_member.setdefault(b, []).append(i)
        if held:
            # Only SET MEMBERS gate the settle: the tracker counts their
            # stripe-acks toward the k quorum. Joiners receive the round
            # too (below) but never count — a promotion only ever plans
            # from the replicated set, so a copy held solely by a
            # not-yet-admitted joiner proves nothing (the full-copy
            # waiver discipline restated for stripes).
            g = _Group(key, futs, {i: b for i, b in enumerate(held)})
            with self._lock:
                if self._stopped:
                    raise ReplicationError("replicator stopped")
                self._groups[key] = g
                for f in futs:
                    self._fut_key[f] = key
        for bid, idxs in by_member.items():
            self._sender(bid).enqueue(
                (key, [frames[i] for i in idxs], idxs, None, tctxs)
            )
        # Joining brokers get the round's DATA stripes on their
        # buffered stream (the gap-free join invariant: any record the
        # catch-up scan misses must reach the joiner live, exactly the
        # full-copy protocol's buffering) — key=None marks the entry
        # untracked, so joiner acks never reach the quorum tracker.
        for bid in joining:
            if bid in by_member:
                continue
            self._sender(bid).enqueue(
                (None, [frames[i] for i in range(RS_K)],
                 list(range(RS_K)), None, tctxs)
            )
        if not held:
            # No member gates the settle (first join in flight): the
            # round settles now that the joiner's stream carries it.
            for f in futs:
                if not f.done():
                    f.set_result(True)

    # -- catch-up (controller duty worker thread) --

    def catchup(self, bid: int, store, timeout_s: float = 600.0) -> None:
        """Stream the full local store prefix to a joining broker as
        catch-up groups carrying the k DATA stripes (buffering live
        groups behind, exactly like the full-copy protocol). Data
        stripes are plain slices of the blob, so the joiner holds the
        prefix SELF-reconstructible at exactly 1.0× its bytes — the
        same transfer cost as a full-copy catch-up. Only live rounds
        pay for (and benefit from) cross-set striping: a catch-up
        group sent with just the joiner's assigned indices would sit
        below k forever (no other broker ever held its stripes), which
        the first promotion smoke hit as an unrecoverable-group boot
        loop. This is also the re-striping path: a membership repair
        re-runs it, restoring any-k coverage after holder loss."""
        from ripplemq_tpu_torch.storage.segment import REC_STRIPE

        s = self._sender(bid)
        with self._lock:
            self._joining.add(bid)
        data_idxs = list(range(RS_K))
        s.begin_buffer()
        last_fut: Optional[Future] = None
        try:
            batch: list = []
            nbytes = 0
            for rec in store.scan():
                if rec[0] == REC_STRIPE:
                    continue  # never re-stripe foreign stripes
                batch.append(rec)
                nbytes += len(rec[3])
                if (len(batch) >= _CATCHUP_BATCH_RECORDS
                        or nbytes >= _CATCHUP_BATCH_BYTES):
                    last_fut = self._enqueue_catchup(s, data_idxs, batch)
                    batch, nbytes = [], 0
            if batch or last_fut is None:
                last_fut = self._enqueue_catchup(s, data_idxs, batch)
        finally:
            s.end_buffer()
        last_fut.result(timeout=timeout_s)

    def _enqueue_catchup(self, s: _StripeSender, idxs: list[int],
                         records: list) -> Future:
        epoch = self.epoch_fn()
        with self._lock:
            gsn = self._gsn
            self._gsn += 1
            floor = self._floor
        frames = encode_group(records, epoch, gsn, catchup=True,
                              settled_floor=floor, **self.encode_kw)
        fut: Future = Future()
        s.enqueue_catchup(((epoch, gsn), [frames[i] for i in idxs],
                           idxs, fut, None))
        return fut

    def finish_join(self, bid: int) -> None:
        with self._lock:
            self._joining.discard(bid)

"""Follower read plane: serve consumes from the bytes replication
already paid for.

Every consume used to be served by the partition leader, so at high
subscriber counts the leader's host path is the throughput ceiling no
matter how fast the engine gets. But the bytes are already elsewhere:
full-copy standbys hold every committed round's REC_APPEND rows, and
striped standbys hold k-reconstructible stripes of them. This module is
the read-side counterpart of the replication planes — it turns those
replicated bytes into a servable, floor-fenced row cache on every
standby.

Safety contract (the whole point — fan-out is worthless if a follower
can hand out a row the leader would not):

- **Serve strictly below the replicated settled floor.** Full-copy
  frames piggyback `[[slot, settled_end, gaps], ...]` stamped by the
  leader's `DataPlane.settle_floors` (one pass under the plane lock, so
  a floor is never newer than the gap map it ships with); striped
  frames already carry the encoder's contiguous-settle gsn watermark in
  their header. Anything at-or-above the local floor is REFUSED (the
  caller maps refusal to the retryable `not_settled_here:` error and
  the client falls back to the leader) — never answered empty, never
  answered stale.
- **Settled gaps replicate with the floor.** A round that committed on
  the device but failed replication is a gap on the leader; the floor
  stamp carries the leader's gap map verbatim (full copy), and in
  striped mode a base jump between sequentially-decoded groups can only
  be the span of tombstoned (never-settled) groups — both are served as
  the same `([], skip_to)` skip the leader serves, never as rows.
- **Generation-fenced.** All state is keyed to the controller epoch:
  ingest from an older epoch is dropped, a newer epoch resets the plane
  (floors, caches, decode cursor), and the owning server re-checks its
  metadata-plane lease (manager.follower_lease) against the SAME epoch
  per answered read — a deposed standby's cache can never serve past a
  newer generation's trim/gap map.

Striped mode decodes on read ("stripe-reconstruct-on-read"): the plane
keeps its OWN stripe of each recent group; on a cache miss below the
gsn floor it pulls sibling stripes via the existing `stripe.fetch`
paging (one forward-only cursor per peer, owned by the server closure),
runs ONE `rs_reconstruct` per group, and feeds the decoded rows into
the shared page cache — N consumer cursors are then served from that
one decode. The cache is bounded by `follower_page_cache_bytes`
(plane-wide, oldest-page eviction); an evicted page re-decodes on the
next miss in striped mode and refuses to the leader in full-copy mode.

Row framing is the engine's own: each cached page is the REC_APPEND
payload verbatim — packed `slot_bytes`-wide rows whose first 4 bytes
are the little-endian payload length (length-0 rows are alignment
padding and are walked over), byte-identical to what the leader's
mirror serves.

Twin of `ripplemq_tpu/broker/follower.py` (PyTorch port): the same code,
importing only the port's modules. `decode_kw` reaches every
`reconstruct_group` call, so it carries the device of the GF(2⁸)
reconstruct (`{"device": ...}`; the broker passes its own).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Optional

from ripplemq_tpu_torch.core.config import ROW_HEADER as _ROW_HDR
from ripplemq_tpu_torch.obs.lockwitness import make_lock
from ripplemq_tpu_torch.storage.segment import REC_APPEND
from ripplemq_tpu_torch.stripes.codec import (
    RS_K,
    StripeFrame,
    StripeShortError,
    reconstruct_group,
)
from ripplemq_tpu_torch.utils.logs import get_logger

log = get_logger("follower")

# Striped-mode working-set bounds. The local-stripe window and sibling
# stash are COUNT-bounded (raw frames are small next to decoded pages);
# the decoded page cache is the byte-bounded one.
_LOCAL_FRAME_CAP = 4096
_SIBLING_FRAME_CAP = 4096
# Per-read decode work bounds: one consume may pull the decode cursor
# forward at most this many groups / fetch pages, so a cold follower
# amortizes its catch-up across reads instead of stalling one.
_MAX_DECODE_PER_READ = 64
_MAX_FETCH_ROUNDS_PER_READ = 8
_MAX_GAPS_PER_SLOT = 128


class _SlotRun:
    """One slot's newest contiguous run of replicated settled rows —
    the same window discipline as the host plane's `_SlotMirror`: a
    publish landing past the end restarts the run (correctness lives in
    the refusal upstream), eviction raises the start."""

    __slots__ = ("start", "end", "frames", "nbytes", "slot_bytes")

    def __init__(self, slot_bytes: int) -> None:
        self.start = 0
        self.end = 0
        # (seq, base, end, rows): seq is the plane-wide publish counter
        # the eviction FIFO names frames by.
        self.frames: list[tuple[int, int, int, bytes]] = []
        self.nbytes = 0
        self.slot_bytes = slot_bytes

    def publish(self, seq: int, base: int, rows: bytes) -> int:
        """Append a page; returns the net byte delta (a gap restart can
        free more than it adds). The caller checks `frames[-1][0] ==
        seq` to learn whether the page was actually retained."""
        nrows = len(rows) // self.slot_bytes
        if nrows <= 0:
            return 0
        delta = 0
        if not self.frames or base != self.end:
            if base < self.start:
                return 0  # stale duplicate below the window
            delta -= self.nbytes
            self.frames = []
            self.nbytes = 0
            self.start = base
        self.frames.append((seq, base, base + nrows, rows))
        self.end = base + nrows
        self.nbytes += len(rows)
        return delta + len(rows)

    def evict_if_head(self, seq: int) -> int:
        """Drop the oldest page iff it is the one `seq` names (the FIFO
        entry may be stale after a gap restart); returns bytes freed."""
        if self.frames and self.frames[0][0] == seq:
            _, _, _, rows = self.frames.pop(0)
            self.nbytes -= len(rows)
            self.start = self.frames[0][1] if self.frames else self.end
            return len(rows)
        return 0

    def read(self, offset: int, max_msgs: Optional[int], floor: int
             ) -> Optional[tuple[list[bytes], int]]:
        """(messages, next_offset) STRICTLY below `floor`, or None when
        the window cannot answer (evicted below, or not yet ingested up
        to the offset) — None means refuse, never "empty"."""
        if offset < self.start:
            return None
        lim = min(self.end, floor)
        if offset >= lim:
            return None  # rows not ingested yet: the leader has them
        SB = self.slot_bytes
        cap = SB - _ROW_HDR
        msgs: list[bytes] = []
        pos = offset
        for _, base, end, rows in self.frames:
            if end <= pos:
                continue
            if base >= lim:
                break
            i = pos - base
            stop = min(end, lim) - base
            while i < stop:
                off = i * SB
                n = min(int.from_bytes(rows[off : off + 4], "little"), cap)
                if n > 0:
                    msgs.append(
                        bytes(rows[off + _ROW_HDR : off + _ROW_HDR + n])
                    )
                    if max_msgs is not None and len(msgs) >= max_msgs:
                        return msgs, base + i + 1
                i += 1
            pos = min(end, lim)
        # All-padding walks still advance (the caller's answer moves the
        # cursor): pos > offset by construction here.
        return msgs, pos


class FollowerReadPlane:
    """Per-standby settled-row cache + floor/fence state (module doc)."""

    def __init__(
        self,
        slot_bytes: int,
        cache_bytes: int,
        fetch_fn: Optional[Callable[[int], list[StripeFrame]]] = None,
        decode_kw: Optional[dict] = None,
    ) -> None:
        self._slot_bytes = int(slot_bytes)
        self._cache_bytes = int(cache_bytes)
        # Sibling-stripe pager (server closure over stripe.fetch): one
        # call = one page round across the live holders, returning
        # parsed frames with gsn >= the argument. None = full-copy-only
        # deployment (no reconstruct-on-read).
        self._fetch_fn = fetch_fn
        self._decode_kw = dict(decode_kw or ())
        self._lock = make_lock("FollowerReadPlane._lock")
        # Serializes striped decode so N concurrent cursors missing on
        # the same cold page pay ONE reconstruct. Always acquired
        # BEFORE _lock, never while holding it.
        self._decode_lock = make_lock("FollowerReadPlane._decode_lock")
        self._epoch = -1
        self._mode: Optional[str] = None  # "full" | "striped"
        # Serve state: slot -> exclusive contiguous-settle end, and the
        # replicated/derived settled-gap spans below it.
        self._floor: dict[int, int] = {}
        self._gaps: dict[int, list[list[int]]] = {}
        # Decoded-page cache: slot -> contiguous run, plane-wide byte
        # budget, FIFO eviction by publish order.
        self._runs: dict[int, _SlotRun] = {}
        self._order: deque = deque()  # (seq, slot) in publish order
        self._seq = 0
        self._nbytes = 0
        # Striped decode state: own-stripe window, sibling stash, dense
        # gsn decode cursor (-1 = not attached yet), gsn floor.
        self._local: "OrderedDict[int, StripeFrame]" = OrderedDict()
        self._sibling: dict[int, dict[int, StripeFrame]] = {}
        self._sibling_n = 0
        self._decode_next = -1
        self._floor_gsn = 0
        # Counters (persist across generations; stats()).
        self._served = 0
        self._refused = 0
        self._rows = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._decoded = 0
        self._fetch_rounds = 0
        # Safety witness (never incremented by correct code): answers
        # that reached the serve boundary ABOVE the settled floor and
        # were refused there. The chaos harness treats any nonzero as
        # a first-class violation — see audit_answer.
        self._past_floor = 0

    # --------------------------------------------------------- fencing

    def _adopt_epoch_locked(self, epoch: int) -> bool:
        """False = stale-generation ingest, drop it. A newer epoch
        resets every floor/cache/cursor: the new generation's trim and
        gap map owe nothing to the old one's bytes."""
        if epoch < self._epoch:
            return False
        if epoch > self._epoch:
            self._epoch = epoch
            self._floor = {}
            self._gaps = {}
            self._runs = {}
            self._order.clear()
            self._nbytes = 0
            self._local = OrderedDict()
            self._sibling = {}
            self._sibling_n = 0
            self._decode_next = -1
            self._floor_gsn = 0
        return True

    def note_epoch(self, epoch: int) -> None:
        """Observe the metadata plane's controller epoch (the server
        calls this when it sees a handover): fences the plane even
        before the new generation's first frame arrives."""
        with self._lock:
            self._adopt_epoch_locked(int(epoch))

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # ---------------------------------------------------------- ingest

    def ingest_rounds(self, epoch: int, records, floors) -> None:
        """Full-copy path: one `repl.rounds` frame's committed records
        plus the leader's piggybacked floor stamp (replication.py). The
        stream is sseq-gated upstream, so pages arrive in commit order
        and per-slot runs stay contiguous except at genuine leader
        gaps — which the floor stamp names."""
        with self._lock:
            if not self._adopt_epoch_locked(int(epoch)):
                return
            self._mode = "full"
            for rec in records:
                if int(rec[0]) != REC_APPEND:
                    continue
                self._publish_locked(int(rec[1]), int(rec[2]), bytes(rec[3]))
            for ent in floors or ():
                slot, end = int(ent[0]), int(ent[1])
                if end > self._floor.get(slot, -1):
                    self._floor[slot] = end
                # The leader's gap list is authoritative and already
                # pruned below its trim: replace, don't merge.
                self._gaps[slot] = [
                    [int(a), int(b)] for a, b in ent[2]
                ][-_MAX_GAPS_PER_SLOT:]
            self._evict_locked()

    def ingest_stripe(self, epoch: int, frame: StripeFrame) -> None:
        """Striped path: stash THIS standby's stripe of a group and
        advance the gsn floor from the frame header. Decode is lazy
        (reconstruct-on-read); catch-up frames are skipped — a joining
        standby serves from its attach point forward."""
        with self._lock:
            if not self._adopt_epoch_locked(int(epoch)):
                return
            self._mode = "striped"
            if frame.catchup:
                return
            g = int(frame.gsn)
            if self._decode_next < 0:
                self._decode_next = g
            if g >= self._decode_next and g not in self._local:
                self._local[g] = frame
                while len(self._local) > _LOCAL_FRAME_CAP:
                    self._local.popitem(last=False)
            if int(frame.settled_floor) > self._floor_gsn:
                self._floor_gsn = int(frame.settled_floor)

    def _publish_locked(self, slot: int, base: int, rows: bytes) -> None:
        run = self._runs.get(slot)
        if run is None:
            run = self._runs[slot] = _SlotRun(self._slot_bytes)
        self._seq += 1
        seq = self._seq
        self._nbytes += run.publish(seq, base, rows)
        if run.frames and run.frames[-1][0] == seq:
            self._order.append((seq, slot))

    def _evict_locked(self) -> None:
        while self._nbytes > self._cache_bytes and self._order:
            seq, slot = self._order.popleft()
            run = self._runs.get(slot)
            if run is None:
                continue
            freed = run.evict_if_head(seq)
            if freed:
                self._nbytes -= freed
                self._evictions += 1

    # ----------------------------------------------------------- serve

    def read(self, slot: int, offset: int, max_msgs: Optional[int]
             ) -> Optional[tuple[list[bytes], int]]:
        """Answer a consume from replicated bytes, strictly below the
        slot's settled floor. Returns (messages, next_offset) — empty
        messages always advance (a replicated-gap skip or padding walk)
        — or None: REFUSE, the caller sends `not_settled_here:` and the
        client falls back to the leader."""
        slot, offset = int(slot), int(offset)
        res = self._read_cached(slot, offset, max_msgs)
        if res is None and self._mode == "striped":
            self._advance_striped(slot, offset)
            res = self._read_cached(slot, offset, max_msgs)
        with self._lock:
            if res is None:
                self._refused += 1
            else:
                self._served += 1
                self._rows += len(res[0])
        return res

    def _read_cached(self, slot: int, offset: int, max_msgs: Optional[int]
                     ) -> Optional[tuple[list[bytes], int]]:
        with self._lock:
            floor = self._floor.get(slot)
            if floor is None or offset >= floor:
                return None
            for s, e in self._gaps.get(slot, ()):
                if s <= offset < e:
                    # Same skip answer the leader's gap clamp serves.
                    return [], min(int(e), floor)
            run = self._runs.get(slot)
            if run is None:
                self._misses += 1
                return None
            got = run.read(offset, max_msgs, floor)
            if got is None:
                self._misses += 1
            else:
                self._hits += 1
            return got

    def audit_answer(self, slot: int, offset: int, next_offset: int
                     ) -> bool:
        """Last-line safety witness at the answer boundary: True iff
        the window ABOUT TO BE SERVED lies at-or-below the slot's
        settled floor. Every follower answer passes through here
        regardless of which path produced it (own cache, gap skip, or
        the worker-plane mirror) — a False means some serving path's
        own fence failed; the caller must refuse, and the miss is
        counted (`answers_past_floor` in stats()) so the chaos harness
        can hold the run to follower-answers-≤-floor as a first-class
        violation rather than trusting the fences it is testing."""
        with self._lock:
            floor = self._floor.get(int(slot))
            ok = (floor is not None and int(offset) < floor
                  and int(next_offset) <= floor)
            if not ok:
                self._past_floor += 1
            return ok

    def validate_window(self, slot: int, offset: int, next_offset: int
                        ) -> bool:
        """True iff [offset, next_offset) lies strictly below the
        slot's floor and outside every known gap — the fence applied to
        answers served from the shared worker-plane mirror instead of
        this plane's own cache."""
        with self._lock:
            floor = self._floor.get(int(slot))
            if floor is None or offset >= floor or next_offset > floor:
                return False
            for s, e in self._gaps.get(int(slot), ()):
                if s < next_offset and offset < e:
                    return False
            return True

    # --------------------------------------- striped reconstruct-on-read

    def _advance_striped(self, slot: int, offset: int) -> None:
        """Pull the dense gsn decode cursor toward the gsn floor until
        the (slot, offset) miss is covered or the per-read work bound
        runs out. The decode lock serializes concurrent missers, so N
        cold cursors share one reconstruct per group."""
        if self._fetch_fn is None:
            return
        with self._decode_lock:
            fetch_rounds = 0
            for _ in range(_MAX_DECODE_PER_READ):
                with self._lock:
                    epoch = self._epoch
                    if offset < self._floor.get(slot, 0):
                        return  # covered: the cached read will serve
                    g = self._decode_next
                    if g < 0 or g > self._floor_gsn:
                        return
                    frames: dict[int, StripeFrame] = dict(
                        self._sibling.get(g, ())
                    )
                    mine = self._local.get(g)
                    if mine is not None:
                        frames[mine.idx] = mine
                if any(f.tombstone for f in frames.values()):
                    # Never settled: producers saw a refusal. Skip the
                    # group; the NEXT decoded group's base jump records
                    # the span as a served gap (sound because the
                    # cursor is dense — every earlier gsn was decoded
                    # or tombstoned, so the jump can only be
                    # never-settled rows).
                    self._finish_group(g, epoch, None)
                    continue
                while (len(frames) < RS_K
                       and fetch_rounds < _MAX_FETCH_ROUNDS_PER_READ):
                    fetch_rounds += 1
                    try:
                        got = self._fetch_fn(g)
                    except Exception as e:
                        log.debug("sibling fetch failed: %s", e)
                        return
                    if not got:
                        break
                    with self._lock:
                        if self._epoch != epoch:
                            return
                        self._fetch_rounds += 1
                        self._stash_siblings_locked(got)
                        frames = dict(self._sibling.get(g, ()))
                        mine = self._local.get(g)
                        if mine is not None:
                            frames[mine.idx] = mine
                if any(f.tombstone for f in frames.values()):
                    self._finish_group(g, epoch, None)
                    continue
                if len(frames) < RS_K:
                    return  # cannot prove the group either way: refuse
                try:
                    records = reconstruct_group(frames, **self._decode_kw)
                except (StripeShortError, ValueError) as e:
                    log.debug("group %d reconstruct failed: %s", g, e)
                    return
                self._finish_group(g, epoch, records)

    def _finish_group(self, g: int, epoch: int, records) -> None:
        """Advance the dense cursor past group `g` — applying its
        decoded records (None = tombstone skip) — unless a newer
        generation reset the plane meanwhile."""
        with self._lock:
            if self._epoch != epoch or self._decode_next != g:
                return
            if records is not None:
                self._apply_group_locked(records)
                self._decoded += 1
            self._decode_next = g + 1
            self._local.pop(g, None)
            dropped = self._sibling.pop(g, None)
            if dropped:
                self._sibling_n -= len(dropped)
            self._evict_locked()

    def _stash_siblings_locked(self, frames) -> None:
        for f in frames:
            g = int(f.gsn)
            # gsn restarts at 0 per controller generation: a fetched
            # frame from another epoch must never satisfy this one's
            # group (same-gsn collision would decode garbage — the
            # blob CRC would catch it, but refusing early is free).
            if int(f.epoch) != self._epoch or f.catchup:
                continue
            if g < self._decode_next:
                continue
            by_idx = self._sibling.setdefault(g, {})
            if f.idx not in by_idx:
                by_idx[f.idx] = f
                self._sibling_n += 1
        while self._sibling_n > _SIBLING_FRAME_CAP and self._sibling:
            # Shed the FARTHEST groups first: the near ones are what
            # the dense cursor needs next.
            g = max(self._sibling)
            self._sibling_n -= len(self._sibling.pop(g))

    def _apply_group_locked(self, records) -> None:
        """Feed one decoded group's REC_APPEND pages into the cache and
        advance per-slot floors. A base jump past the current floor is
        the span of tombstoned groups (see _advance_striped) and is
        recorded as a served gap."""
        for rtype, slot, base, payload in records:
            if int(rtype) != REC_APPEND:
                continue
            slot, base = int(slot), int(base)
            nrows = len(payload) // self._slot_bytes
            if nrows <= 0:
                continue
            cur = self._floor.get(slot)
            if cur is None:
                cur = base  # first coverage this epoch: serve from here
            elif base < cur:
                continue  # duplicate/old replay below the floor
            elif base > cur:
                gaps = self._gaps.setdefault(slot, [])
                gaps.append([cur, base])
                if len(gaps) > _MAX_GAPS_PER_SLOT:
                    del gaps[: len(gaps) - _MAX_GAPS_PER_SLOT]
            self._publish_locked(slot, base, bytes(payload))
            self._floor[slot] = base + nrows

    def prune_slots(self, valid) -> int:
        """Drop serve state for engine slots the metadata plane no
        longer maps (a topic table replace that deleted or renumbered
        a partition): a dangling floor/gap/run entry would otherwise
        survive until the next controller handover resets the whole
        plane — and a slot REUSED by a later topic table would inherit
        the dead partition's floor as its own. Called from the broker's
        duty loop with the manager's current slot set; returns how many
        slots were pruned. Stale `_order` FIFO entries for pruned runs
        are harmless — eviction already skips missing runs."""
        valid = {int(s) for s in valid}
        with self._lock:
            stale = (set(self._floor) | set(self._gaps)
                     | set(self._runs)) - valid
            for s in stale:
                self._floor.pop(s, None)
                self._gaps.pop(s, None)
                run = self._runs.pop(s, None)
                if run is not None:
                    self._nbytes -= run.nbytes
            return len(stale)

    # ----------------------------------------------------------- stats

    def floors(self) -> dict[int, int]:
        with self._lock:
            return dict(self._floor)

    def stats(self) -> dict:
        with self._lock:
            lag = 0
            for slot, f in self._floor.items():
                run = self._runs.get(slot)
                if run is not None and run.end > f:
                    lag = max(lag, run.end - f)
            hits, misses = self._hits, self._misses
            total = hits + misses
            return {
                "epoch": self._epoch,
                "mode": self._mode,
                "slots": len(self._floor),
                "floor_lag_rows": int(lag),
                "reads_served": self._served,
                "reads_refused": self._refused,
                "rows_served": self._rows,
                "answers_past_floor": self._past_floor,
                "cache": {
                    "bytes": int(self._nbytes),
                    "budget_bytes": int(self._cache_bytes),
                    "hits": hits,
                    "misses": misses,
                    "hit_rate": (hits / total) if total else None,
                    "evictions": self._evictions,
                },
                "striped": {
                    "decoded_groups": self._decoded,
                    "fetch_rounds": self._fetch_rounds,
                    "floor_gsn": self._floor_gsn,
                    "decode_next": self._decode_next,
                },
            }

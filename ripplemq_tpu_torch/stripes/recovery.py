"""Rebuilt-from-any-k recovery: turn a standby's stripe store (plus any
reachable peers' stripes) back into the full committed-round record
stream a promoted controller can replay (PyTorch port).

Twin of `ripplemq_tpu/stripes/recovery.py`; the reconstruct runs the
GF(2⁸) kernel through `stripes.codec.reconstruct_group` (`device=` in
`reconstruct_kw`, CUDA by default).

A standby in striped mode persists REC_STRIPE frames for only ITS
assigned stripe indices, so promotion must gather the missing indices
from surviving peers: any RS_K distinct valid stripes of a group
reconstruct its blob byte-for-byte (ops/rs.py inverse solver through
stripes/codec.reconstruct_group). Groups replay in a deterministic
total order — (epoch, catchup-groups-first, gsn) — which reproduces
every store's arrival order: one encoder per controller generation
assigns monotone gsns, catch-up groups (full-prefix content) are
delivered ahead of the live groups buffered during the join, and
epochs order controller generations.

Failure ladder (the rebuild-or-quarantine contract):

- a group short of k stripes while some configured peer was
  UNREACHABLE → StripeRecoveryError (transient: the takeover duty
  retries next tick; boot-failure abdication caps the loop);
- short of k with EVERY peer consulted → classified by the frames'
  SETTLED-FLOOR watermark (stripes/codec.py): every encoded frame
  carries the highest gsn at-or-below which all of its epoch's groups
  had resolved when it was cut. A short group AT-OR-BELOW any observed
  floor of its epoch was settled — its rounds were ACKED — so the
  shortfall is StripeDataLossError (quarantine-grade); a short group
  ABOVE every floor never settled (its producers were never acked, the
  torn-tail analogue) and is dropped with a log line. Short CATCH-UP
  groups drop too: their content is the prefix, redundantly covered by
  the other members' stripe streams the same rebuild collects.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ripplemq_tpu_torch.stripes.codec import (
    RS_K,
    StripeFrame,
    StripeShortError,
    parse_frame,
    reconstruct_group,
)
from ripplemq_tpu_torch.utils.logs import get_logger

log = get_logger("stripes")


class StripeRecoveryError(Exception):
    """Rebuild blocked TRANSIENTLY: a group is short of k stripes while
    at least one configured peer could not be consulted. Retryable."""


class StripeDataLossError(Exception):
    """Rebuild failed DEFINITIVELY: a non-tail group is short of k
    stripes with every peer consulted — acked data is unrecoverable
    (more than m holders lost). Quarantine-grade."""


def replay_order_key(frame: StripeFrame) -> tuple[int, int, int]:
    """Total replay order over groups: epochs ascend; within an epoch
    catch-up groups (the full-prefix stream) replay before live groups
    — a catch-up gsn is assigned while newer live gsns already exist,
    yet its content precedes them (see module docstring); gsns order
    the rest."""
    return (frame.epoch, 0 if frame.catchup else 1, frame.gsn)


def collect_stripe_groups(
    records: Iterable[tuple[int, int, int, bytes]],
    groups: Optional[dict] = None,
) -> tuple[dict, list[tuple[int, int, int, bytes]]]:
    """Split a store scan into stripe groups and pass-through records.

    Returns ({(epoch, gsn): {idx: StripeFrame}}, [non-stripe records in
    scan order]). Unparseable stripe payloads (CRC rot) count as
    missing, never as wrong bytes. `groups` merges into an existing
    collection (first valid frame per (key, idx) wins)."""
    from ripplemq_tpu_torch.storage.segment import REC_STRIPE

    if groups is None:
        groups = {}
    passthrough: list[tuple[int, int, int, bytes]] = []
    for rec in records:
        rec_type = rec[0]
        if rec_type != REC_STRIPE:
            passthrough.append(rec)
            continue
        frame = parse_frame(bytes(rec[3]))
        if frame is None:
            continue  # rotted stripe: missing, handled by any-k rebuild
        slot = groups.setdefault(frame.key, {})
        # Tombstones live under negative keys so they can never shadow
        # (or be shadowed by) a real stripe index in the merge.
        key = -1 - frame.idx if frame.tombstone else frame.idx
        slot.setdefault(key, frame)
    return groups, passthrough


def merge_peer_frames(groups: dict, frames: Iterable[bytes]) -> int:
    """Merge raw peer-supplied stripe frames into a group collection;
    returns how many frames were adopted (CRC-validated first — a peer
    cannot inject bytes the frame CRC does not vouch for)."""
    adopted = 0
    for raw in frames:
        frame = parse_frame(bytes(raw))
        if frame is None:
            continue
        slot = groups.setdefault(frame.key, {})
        key = -1 - frame.idx if frame.tombstone else frame.idx
        if key not in slot:
            slot[key] = frame
            adopted += 1
    return adopted


def fetch_peer_stripes(groups: dict,
                       peer_fetchers: list[tuple[str, Callable]],
                       ) -> tuple[int, list[str]]:
    """Pull every reachable peer's stripe frames into `groups`.

    `peer_fetchers` is [(tag, callable(after: int) -> (frames, next))]
    — a paged scan of the peer's REC_STRIPE records (the stripe.fetch
    RPC). Returns (frames adopted, [tags of UNREACHABLE peers]) — the
    unreachable list decides transient-vs-definitive failure."""
    adopted = 0
    unreachable: list[str] = []
    for tag, fetch in peer_fetchers:
        cursor = -1  # opaque to this side: the peer interprets it
        try:
            while True:
                frames, nxt = fetch(cursor)
                adopted += merge_peer_frames(groups, frames)
                if nxt is None:
                    break
                cursor = nxt
        except Exception as e:  # peer down mid-scan: partial adopt OK
            log.warning("stripe fetch from %s failed: %s: %s",
                        tag, type(e).__name__, e)
            unreachable.append(tag)
    return adopted, unreachable


def rebuild_records(
    local_records: Iterable[tuple[int, int, int, bytes]],
    peer_fetchers: Optional[list[tuple[str, Callable]]] = None,
    peers_incomplete: bool = False,
    **reconstruct_kw,
) -> list[tuple[int, int, int, bytes]]:
    """The promotion rebuild: local scan (+ peer stripes) → the full
    committed-round record stream in replay order.

    Non-stripe records (a deposed ex-controller's own full prefix —
    chronologically older than every stripe it later received as a
    standby) pass through FIRST in scan order; stripe groups follow in
    replay_order_key order. Raises per the module-docstring ladder;
    `peers_incomplete` forces the transient classification even when
    every listed fetcher responded (caller knows some configured broker
    was not listed — e.g. known-crashed)."""
    groups, passthrough = collect_stripe_groups(local_records)
    unreachable: list[str] = []
    if peer_fetchers:
        _, unreachable = fetch_peer_stripes(groups, peer_fetchers)
    incomplete = peers_incomplete or bool(unreachable)

    out = list(passthrough)
    ordered = sorted(
        groups.items(),
        key=lambda kv: replay_order_key(next(iter(kv[1].values()))),
    )
    # Per-epoch settled-floor high-water marks across EVERY collected
    # frame: the authority on which groups were acked (module
    # docstring; stamped by the encoder's contiguous-settle tracker).
    floors: dict[int, int] = {}
    for _, frames in ordered:
        for f in frames.values():
            if f.settled_floor > floors.get(f.epoch, 0):
                floors[f.epoch] = f.settled_floor
    dropped: list = []
    for key, frames in ordered:
        if any(f.tombstone for f in frames.values()):
            # The group was terminally NACKED by its controller after
            # some stripes shipped (plane.py _fail_groups): its
            # producers saw a refusal, so the partial leftovers are
            # debris, never acked loss — drop regardless of the floor.
            dropped.append(key)
            continue
        frames = {i: f for i, f in frames.items() if i >= 0}
        try:
            out.extend(reconstruct_group(frames, **reconstruct_kw))
        except (StripeShortError, ValueError) as e:
            if incomplete:
                raise StripeRecoveryError(
                    f"group {key} unrecoverable ({e}) with peers "
                    f"unreachable: {unreachable or 'incomplete set'}"
                ) from e
            epoch, gsn = key
            any_f = next(iter(frames.values()))
            if not any_f.catchup and gsn <= floors.get(epoch, 0):
                raise StripeDataLossError(
                    f"settled group {key} unrecoverable ({e}; floor "
                    f"{floors.get(epoch, 0)}): acked data lost beyond "
                    f"the k={RS_K}-of-k+m contract"
                )
            dropped.append(key)
    if dropped:
        log.warning(
            "dropping %d unsettled stripe group(s) %s (above every "
            "settled floor / catch-up duplicates — never acked)",
            len(dropped), dropped[:8],
        )
    return out

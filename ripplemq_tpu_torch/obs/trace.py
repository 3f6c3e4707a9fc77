"""Flight recorder: a fixed-size ring of structured lifecycle events.

Twin of `ripplemq_tpu/obs/trace.py` (PyTorch port), pure Python.

Always on (unlike the metrics registry there is no off switch): the
whole point of a flight recorder is that the events preceding a failure
were already captured when the failure is noticed — the term-skew
wedge was diagnosed by re-running under probes precisely because nothing
had recorded the election/advert interleaving the first time. Elle's
lesson applies (arXiv:2003.10554): a checker verdict is most useful when
it points at the responsible window of the history, and the ring IS that
window.

Cost per append: one itertools.count tick (C-level, thread-safe slot
assignment), one clock read, one tuple + kwargs dict build, one list
store — ~a few hundred ns. Events are recorded per ROUND or per
control-plane transition, never per message, so even a saturated broker
appends a few thousand events/s against a default 4096-slot ring
(~the last second or two of life under full load; minutes when idle or
faulted — exactly when the history matters).

Ring writes are wait-free against each other (distinct slots via the
atomic counter); `snapshot()` reads racy-consistent — an entry being
overwritten mid-read can surface as a slightly out-of-window event,
never as a torn tuple (slot stores are single reference assignments).

Event timestamps are WALL CLOCK (`time.time()`), deliberately unlike
the metrics clock: traces from different processes (proc-backend
brokers, the nemesis fault log) merge into one timeline by `t`.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Optional

_DEFAULT_CAPACITY = 4096

# The CLOSED event vocabulary: every `recorder.record("<type>", ...)`
# emit site in the library must name a member, every member must have
# a live emit site, and every member is documented in the README
# Observability section — all three machine-checked by ripplelint's
# trace_vocab rule (analysis/trace_vocab.py). Timeline tooling, chaos
# verdict readers, and postmortem walkthroughs key on these names;
# an undocumented event is a timeline entry nobody can interpret.
EVENT_TYPES = frozenset({
    # Round lifecycle (per ROUND, never per message).
    "dispatch", "commit", "settle_enter", "settle_release", "settle_fail",
    # Data-plane control transitions.
    "elect", "set_leader", "settled_gap", "stall_reset", "install",
    # Broker/controller lifecycle.
    "controller_boot", "boot_failed", "deposed", "abdicate",
    "standby_joined", "store_quarantine", "stripe_rebuild",
    # Multi-core host plane (parallel/hostplane.py): a worker
    # subprocess died / its respawn came up under a bumped generation.
    "host_worker_down", "host_worker_restart",
    # Consumer-group coordinator (manager applies + fencing).
    "group_join", "group_leave", "group_delete", "fence",
    # Control-plane wave batching (broker/server.py _batch_duty +
    # manager OP_BATCH apply): one wave of coalesced membership/pid
    # commands proposed; one wave-end deferred rebalance of a touched
    # group; one aggregated heartbeat frame relayed to the metadata
    # leader's liveness ledger.
    "meta_batch", "group_rebalance", "beats_relay",
    # SLO autopilot (slo/controller.py): one event per APPLIED knob
    # adjustment (the control timeline postmortems replay) and the
    # load-shedding state machine's transitions.
    "slo_adjust", "slo_shed_on", "slo_shed_off",
    # Shed-LADDER intermediate move (level 1↔2, slo/controller.py): the
    # shed stayed on but its tier bite escalated or stepped down.
    "slo_shed_level",
    # Follower reads (broker/server.py): the metadata leader committed
    # a follower-read lease table for the current controller epoch.
    "follower_lease",
    # Elastic partitions (broker/manager.py applies): a split opened
    # its dual-write handoff window, the reconfig duty closed it at
    # the settled watermark, a merge reabsorbed a child's range.
    "split_begin", "split_cutover", "merge_done",
})


class FlightRecorder:
    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._cap = max(16, int(capacity))
        self._buf: list = [None] * self._cap
        self._seq = itertools.count()
        self.clock: Callable[[], float] = (
            clock if clock is not None else time.time
        )

    def record(self, etype: str, **fields) -> None:
        """Append one event. `fields` must stay wire-primitive (str keys,
        int/float/str/bool/list values) — snapshots travel over
        `admin.trace` through the codec verbatim."""
        seq = next(self._seq)  # atomic slot assignment (C-level next)
        self._buf[seq % self._cap] = (seq, self.clock(), etype, fields)

    def snapshot(self, last: Optional[int] = None) -> list[dict]:
        """The ring's live window in seq order (oldest first), optionally
        clipped to the most recent `last` events. Wire-encodable."""
        entries = [e for e in self._buf if e is not None]
        entries.sort(key=lambda e: e[0])
        if last is not None and last >= 0:
            # last=0 must mean ZERO events ([-0:] would be the whole ring).
            entries = entries[-last:] if last > 0 else []
        # Reserved keys always win over same-named fields: `seq` is the
        # ring's ordering contract (snapshot is seq-sorted), and a field
        # shadowing it would silently break every timeline consumer.
        return [
            {**fields, "seq": seq, "t": t, "type": etype}
            for seq, t, etype, fields in entries
        ]

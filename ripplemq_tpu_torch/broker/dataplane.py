"""Committed-round recovery of the data plane (PyTorch port).

Twin of the module-level functions of `ripplemq_tpu/broker/dataplane.py`:
`recover_image` heals a segment store's erasure-protected sealed
segments (the GF(2⁸) kernel, on `device` or CUDA) and replays it into a
single-replica state image; `replay_records` is the replay itself. The
image is built on the host, as in the reference, and returned as the
port's `ReplicaState` of CPU tensors (no replica axis), ready for
`make_local_fns(cfg).init_from`. The `DataPlane` class itself (the
device-round loop and append batcher) comes with slice B of the
port (ROADMAP.md).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.core.state import ReplicaState
from ripplemq_tpu_torch.ops.rs import default_device
from ripplemq_tpu_torch.storage.erasure import repair_store
from ripplemq_tpu_torch.storage.segment import (
    REC_APPEND,
    REC_OFFSETS,
    REC_PIDSEQ,
    scan_store,
)

# Settled batches remembered per (pid, slot) for producer-sequence
# dedup. The producer only ever replays sequences it never saw acked —
# at most one batch deep per partition under the SDK's ack-gated
# sequence advance — so a small window covers every legal replay;
# anything older still refuses to re-append (acked as a duplicate with
# base -1: present in the log, position no longer remembered).
_PID_WINDOW = 8


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

"""The DataPlane slice held against the JAX package: one seeded script
through the reference's `DataPlane` (JAX on the CPU) and the port's
(`device="cpu"`), each with its own `MemoryRoundStore`.

The script: an election of every partition, appends of mixed sizes up
to `max_batch` (some idempotent, with producer ids), offset commits, a
second election, a quorum loss that nacks one slot's rounds while
another slot runs a replica short, the heal and a `resync`, idempotent
replays, and a ring lap past `slots` on one slot. At most one batch of a
slot is in flight at a time (each wave awaits its futures), while the
slots of a wave run at once; per-slot bases are then deterministic.

Compared exactly: every acked base (or the exception's type), the
stall probe, every `read` answer (messages and next_offset) walking each
slot from 0 on each replica, the store's records per slot in order, the
`read_offset` table, `log_ends()`, `commit_index`, `current_terms()`,
`settled_end`, `settle_floors` and `stalled_slots`; after recovery,
`replay_records` plus `install` from each store gives equal states
(`convert.state_to_numpy`), gap maps and producer tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ripplemq_tpu.broker import dataplane as ref_dataplane
from ripplemq_tpu.storage.memstore import MemoryRoundStore as RefStore
from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.broker import dataplane
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore
from tests.helpers import small_cfg
from tests.torch_port_modules import admit

admit(__name__)

SHAPE = dict(partitions=4, replicas=3, slots=64, max_batch=8, read_batch=8)
TIMEOUT = 60


def _planes():
    """(reference plane, port plane), not started, with their stores."""
    ref_cfg = small_cfg(**SHAPE)
    port_cfg = EngineConfig(**dataclasses.asdict(ref_cfg))
    ref = ref_dataplane.DataPlane(ref_cfg, mode="local", store=RefStore(),
                                  max_retry_rounds=3)
    port = dataplane.DataPlane(port_cfg, mode="local",
                               store=MemoryRoundStore(), max_retry_rounds=3,
                               device="cpu")
    return ref, port


def _outcomes(futs):
    out = []
    for f in futs:
        try:
            out.append(("ok", f.result(timeout=TIMEOUT)))
        except Exception as e:  # the outcome IS the exception's type
            out.append(("err", type(e).__name__))
    return out


def run_script(dp, seed: int) -> list:
    """Drive one plane through the seeded script; returns the transcript
    of every answer the plane gave."""
    rng = np.random.default_rng(seed)
    cfg = dp.cfg
    P, R, B = cfg.partitions, cfg.replicas, cfg.max_batch
    log: list = []
    next_seq: dict[tuple[int, int], int] = {}
    sent: dict[tuple[int, int], tuple[int, list]] = {}

    def batch(tag):
        n = int(rng.integers(1, B + 1))
        return [bytes([65 + (k % 26)]) * int(rng.integers(1, cfg.payload_bytes + 1))
                + b"%s-%d" % (tag, k) for k in range(n)]

    def wave(slots, tag, idempotent=False):
        futs = []
        for s in slots:
            msgs = [m[: cfg.payload_bytes] for m in batch(b"%s%d" % (tag, s))]
            if idempotent:
                pid = 100 + s
                seq = next_seq.get((pid, s), 0)
                next_seq[(pid, s)] = seq + len(msgs)
                sent[(pid, s)] = (seq, msgs)
                futs.append(dp.submit_append(s, msgs, pid=pid, seq=seq))
            else:
                futs.append(dp.submit_append(s, msgs))
        log.append(("wave", tag, _outcomes(futs)))

    def offsets():
        futs = []
        for s in range(P):
            k = int(rng.integers(1, cfg.max_offset_updates + 1))
            ups = [(int(rng.integers(0, cfg.max_consumers)),
                    int(rng.integers(0, 1 << 16))) for _ in range(k)]
            futs.append(dp.submit_offsets(s, ups))
        log.append(("offsets", _outcomes(futs)))

    log.append(("elect", dp.elect({p: (0, 1) for p in range(P)})))
    for p in range(P):
        dp.set_leader(p, 0, 1)
    for w in range(6):
        slots = sorted(rng.choice(P, int(rng.integers(2, P + 1)),
                                  replace=False).tolist())
        wave(slots, b"w%d" % w, idempotent=w % 2 == 1)
    offsets()
    # Idempotent replays of each producer's last batch: acked as
    # duplicates with the original base, nothing appended.
    futs = [dp.submit_append(s, msgs, pid=pid, seq=seq)
            for (pid, s), (seq, msgs) in sorted(sent.items())]
    log.append(("replays", _outcomes(futs)))

    # A second election: slot 0 moves to replica 1, slot 3 to replica 2.
    won = dp.elect({0: (1, 2), 3: (2, 2)})
    log.append(("elect2", won))
    for s, (c, t) in {0: (1, 2), 3: (2, 2)}.items():
        if won[s]:
            dp.set_leader(s, c, t)

    # Quorum loss on slot 1 (only its leader alive): its rounds are
    # nacked after the retry budget. Slot 0 runs with replica 2 down
    # (still a quorum) and falls behind on it.
    alive = np.ones((P, R), bool)
    alive[1, 1:] = False
    alive[0, 2] = False
    dp.set_alive(alive)
    log.append(("degraded", dp.degraded_slots(), dp.quorum_lost(1)))
    wave([0, 1, 2], b"q")
    log.append(("stalled", dp.stalled_slots(threshold=1)))
    dp.set_alive(np.ones((P, R), bool))
    log.append(("lag", dp.log_ends().tolist()))
    dp.resync(1, 2, [0])
    log.append(("resynced", dp.log_ends().tolist()))
    wave(list(range(P)), b"h", idempotent=True)
    # A ring lap on slot 2 (past `slots` rows), slot 3 alongside.
    for w in range(10):
        wave([2, 3] if w % 3 == 0 else [2], b"lap%d" % w)
    offsets()
    log.append(("stalled_end", dp.stalled_slots(threshold=1),
                dp.stalled_slots()))
    return log


def observe(dp) -> dict:
    """Everything a reader of the plane can see, after the script."""
    cfg = dp.cfg
    P, R = cfg.partitions, cfg.replicas
    walks = {}
    for s in range(P):
        for r in range(R):
            for limit in ((None, 3) if r == 0 else (None,)):
                steps, off = [], 0
                for _ in range(10_000):
                    msgs, nxt = dp.read(s, off, replica=r, max_msgs=limit)
                    steps.append((off, nxt, msgs))
                    if nxt == off:
                        break
                    off = nxt
                walks[(s, r, limit)] = steps
    records = {s: [] for s in range(P)}
    for rec in dp.store.scan():
        records[rec[1]].append(rec)
    return {
        "walks": walks,
        "records": records,
        "offsets": [[dp.read_offset(s, c) for c in range(cfg.max_consumers)]
                    for s in range(P)],
        "log_ends": dp.log_ends().tolist(),
        "commit_index": [dp.commit_index(s) for s in range(P)],
        "current_terms": dp.current_terms().tolist(),
        "settled_end": [dp.settled_end(s) for s in range(P)],
        "settle_floors": dp.settle_floors(range(P)),
        "stalled": dp.stalled_slots(threshold=1),
        "pid_table_size": dp.pid_table_size(),
        "trim": [int(t) for t in dp.trim],
    }


def _ref_state(st) -> dict:
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


@pytest.mark.parametrize("seed", [0, 1])
def test_dataplane_matches_reference(seed):
    ref, port = _planes()
    obs = {}
    try:
        for name, dp in (("ref", ref), ("port", port)):
            dp.start()
            transcript = run_script(dp, seed)
            obs[name] = (transcript, observe(dp))
    finally:
        ref.stop()
        port.stop()
    (ref_log, ref_obs), (port_log, port_obs) = obs["ref"], obs["port"]
    for a, b in zip(ref_log, port_log):
        assert a == b
    assert len(ref_log) == len(port_log)
    # The script did what it claims: nacks, duplicates, a lap.
    flat = [o for entry in ref_log if entry[0] == "wave" for o in entry[2]]
    assert ("err", "NotCommittedError") in flat
    assert int(ref_obs["trim"][2]) > 0
    for key in ref_obs:
        assert ref_obs[key] == port_obs[key], key

    # Recovery: replay each store and install into a fresh plane.
    states, tables = {}, {}
    for name, dp, mod in (("ref", ref, ref_dataplane),
                          ("port", port, dataplane)):
        gaps, pids = {}, {}
        image = mod.replay_records(dp.cfg, dp.store.scan(), gaps_out=gaps,
                                   pid_tab_out=pids)
        fresh = (mod.DataPlane(dp.cfg, mode="local") if mod is ref_dataplane
                 else mod.DataPlane(dp.cfg, mode="local", device="cpu"))
        fresh.install(image, settled_gaps=gaps, pid_table=pids)
        states[name] = (_ref_state(fresh._state) if mod is ref_dataplane
                        else convert.state_to_numpy(fresh._state))
        tables[name] = (gaps, pids, [fresh.settled_end(s)
                                     for s in range(dp.cfg.partitions)])
        fresh.stop()
    assert tables["ref"] == tables["port"]
    assert states["ref"].keys() == states["port"].keys()
    for leaf, want in states["ref"].items():
        np.testing.assert_array_equal(states["port"][leaf], want, leaf)

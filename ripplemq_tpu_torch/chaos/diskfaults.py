"""Disk-fault injection for the chaos plane: damage a CRASHED broker's
committed-round store between its kill and its restart — the fault class
real deployments see (kernel panics mid-write, bit rot, a lost file)
that the in-memory nemesis ops cannot model.

Faults are applied to the victim's `<data_dir>/broker-<id>/segments`
directory while the process is down; the restart's recovery pipeline
(peer shard refill → erasure repair → boot health walk) must then either
REBUILD the damage (storage/erasure.py) or QUARANTINE the store and
rejoin as an empty standby (broker/server._validate_or_quarantine_store)
— never crash-loop, never serve a row that fails CRC.

Injection is deterministic in (store contents, kind, salt): the SCHEDULE
stays a pure function of the nemesis seed (op + salt are in the trace);
the bytes hit depend on what the run persisted, which the returned
description records for forensics.

Twin of `ripplemq_tpu/chaos/diskfaults.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import os
import random

from ripplemq_tpu_torch.storage.segment import list_segment_files

# The op names make_schedule draws for the proc backend (and any durable
# in-proc cluster): torn tail on the active segment, a flipped byte in a
# random segment, a deleted sealed segment.
DISK_FAULT_OPS = ("disk_torn", "disk_flip", "disk_trunc")


def inject_disk_fault(store_dir: str, kind: str, salt: int = 0) -> dict:
    """Apply one disk fault to a (closed/killed) store directory.
    Returns a JSON-able description of what was actually hit —
    {"applied": False, ...} when the store holds nothing damageable yet
    (a schedule can fire before the first flush)."""
    # str seeding is sha512-based and stable across processes (tuple/
    # object seeds hash, and hash randomization would break replay).
    rng = random.Random(f"{kind}:{salt}")
    names = list_segment_files(store_dir)
    if not names:
        return {"applied": False, "kind": kind, "reason": "no segments"}

    if kind == "disk_torn":
        # Torn tail: chop bytes off the ACTIVE segment mid-record — the
        # crash shape fsync-less writes leave behind. Recovery drops the
        # torn record (the documented tail contract).
        path = os.path.join(store_dir, names[-1])
        size = os.path.getsize(path)
        if size == 0:
            return {"applied": False, "kind": kind, "reason": "empty tail"}
        cut = min(size, rng.randint(1, 24))
        with open(path, "r+b") as f:
            f.truncate(size - cut)
        return {"applied": True, "kind": kind, "segment": names[-1],
                "cut_bytes": cut}

    if kind == "disk_flip":
        # Bit rot: flip one byte of a random segment at a random
        # position (header or payload — both must be survivable).
        name = names[rng.randrange(len(names))]
        path = os.path.join(store_dir, name)
        size = os.path.getsize(path)
        if size == 0:
            return {"applied": False, "kind": kind, "reason": "empty segment"}
        pos = rng.randrange(size)
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
        return {"applied": True, "kind": kind, "segment": name, "pos": pos}

    if kind == "disk_trunc":
        # Lost sealed segment: delete a whole non-active segment file
        # (its rs/ shards — if encoded — are what recovery rebuilds it
        # from; without them the store must quarantine). Falls back to
        # truncating the active segment in half when nothing is sealed.
        if len(names) >= 2:
            name = names[rng.randrange(len(names) - 1)]
            os.remove(os.path.join(store_dir, name))
            return {"applied": True, "kind": kind, "segment": name,
                    "deleted": True}
        path = os.path.join(store_dir, names[-1])
        size = os.path.getsize(path)
        if size < 2:
            return {"applied": False, "kind": kind, "reason": "tiny store"}
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return {"applied": True, "kind": kind, "segment": names[-1],
                "truncated_to": size // 2}

    raise ValueError(f"unknown disk fault {kind!r}")

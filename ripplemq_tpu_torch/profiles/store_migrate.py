"""One-shot store rewrite: payload-only-CRC framing → header-covered
framing.

    python -m ripplemq_tpu_torch.profiles.store_migrate /path/to/segments
    python -m ripplemq_tpu_torch.profiles.store_migrate DIR --dry-run

The record CRC covers the 17 header bytes and the format is
DELIBERATELY unversioned: a runtime payload-only fallback would
re-accept exactly the header damage the header-covered CRC closes (a
flipped header byte passes a payload-only check by construction). That
is the right call for the read path and the wrong one for a long-lived
deployed store — a store written with payload-only CRCs fails every
modern scan as "corrupt". This tool is the upgrade path: a ONE-SHOT
offline rewrite, run before booting the new code against an old store.

Per segment file, each frame is validated against the NEW crc first and
the LEGACY (payload-only) crc second; legacy frames are re-emitted with
the header-covered crc, already-modern frames byte-identically. A
frame failing BOTH checks stops the migration (in the final segment's
tail position it is a torn tail and is dropped, matching the scanners'
crash contract; anywhere else it is real corruption and the store is
left untouched for the quarantine/erasure machinery to handle).
Segment file boundaries and record order are preserved, so locators
derived by replay stay congruent. Stale derived state (rs/ shard sets —
whole-file shard CRCs no longer match rewritten segments) is dropped
for re-encode. The original store is kept at `<dir>.premigrate-N`; the
rewritten store must pass `verify_store` before it is swapped in, or
nothing is touched.

Twin of the reference's `profiles/store_migrate.py` over the port's
`storage/segment.py`: the same frames, the same files, the same report.
It reads and writes files only, so it needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import sys
import zlib

from ripplemq_tpu_torch.storage.segment import (
    _CRC,
    _HEADER,
    _HEADER_PREFIX,
    _MAGIC,
    _frame_crc,
    list_segment_files,
    verify_store,
)


class MigrationError(Exception):
    pass


def _valid_any_frame_after(blob: bytes, start: int) -> bool:
    """Look-ahead discriminator (verify_store's, extended to the legacy
    crc): does any frame valid under EITHER crc begin at-or-after
    `start`? True means the damage is mid-file rot — records follow it,
    so 'drop the rest' would silently shorten acked history."""
    magic = struct.pack("<I", _MAGIC)
    pos = blob.find(magic, start)
    while pos != -1:
        if pos + _HEADER.size <= len(blob):
            _m, _t, _s, _b, length, crc = _HEADER.unpack(
                blob[pos : pos + _HEADER.size]
            )
            if (length <= (1 << 30)
                    and pos + _HEADER.size + length <= len(blob)):
                payload = blob[pos + _HEADER.size
                               : pos + _HEADER.size + length]
                hdr17 = blob[pos : pos + _HEADER_PREFIX.size]
                if (_frame_crc(hdr17, payload) == crc
                        or zlib.crc32(payload) & 0xFFFFFFFF == crc):
                    return True
        pos = blob.find(magic, pos + 1)
    return False


def _walk_frames(blob: bytes, name: str, last_file: bool):
    """Yield (header_prefix17, payload, kind) per frame; kind is
    "modern" | "legacy". Raises MigrationError on damage neither CRC
    explains (tolerating a TRUE final-segment torn tail — nothing valid
    after it — by ending early; valid frames following the damage mean
    bit rot, which the migration must refuse, not launder)."""
    pos = 0
    while pos < len(blob):
        def torn(reason: str):
            if last_file and not _valid_any_frame_after(blob, pos + 1):
                return True  # torn tail: drop the rest (crash contract)
            raise MigrationError(f"{name}: {reason} at byte {pos}")

        if pos + _HEADER.size > len(blob):
            if torn("partial header"):
                return
        magic, rec_type, slot, base, length, crc = _HEADER.unpack(
            blob[pos : pos + _HEADER.size]
        )
        if magic != _MAGIC or length > (1 << 30):
            if torn("bad magic / absurd length"):
                return
        payload = blob[pos + _HEADER.size : pos + _HEADER.size + length]
        hdr17 = blob[pos : pos + _HEADER_PREFIX.size]
        if len(payload) < length:
            if torn("short payload"):
                return
        if _frame_crc(hdr17, payload) == crc:
            kind = "modern"
        elif zlib.crc32(payload) & 0xFFFFFFFF == crc:
            kind = "legacy"
        else:
            if torn("frame fails both the header-covered and the "
                    "legacy payload-only crc"):
                return
        yield hdr17, payload, kind
        pos += _HEADER.size + length


def migrate_store(directory: str, dry_run: bool = False) -> dict:
    """Rewrite `directory` in place (via a verified staging copy).
    Returns a JSON-able summary: frames seen per kind, whether a swap
    happened, and where the pre-migration bytes went."""
    files = list_segment_files(directory)
    stats = {"directory": directory, "segments": len(files),
             "modern_frames": 0, "legacy_frames": 0, "migrated": False,
             "backup": None}
    if not files:
        return stats
    staged: list[tuple[str, bytes]] = []
    for fi, name in enumerate(files):
        with open(os.path.join(directory, name), "rb") as f:
            blob = f.read()
        out = bytearray()
        for hdr17, payload, kind in _walk_frames(
            blob, name, last_file=(fi + 1 == len(files))
        ):
            stats[f"{kind}_frames"] += 1
            out += hdr17
            out += _CRC.pack(_frame_crc(hdr17, payload))
            out += payload
        staged.append((name, bytes(out)))
    if stats["legacy_frames"] == 0:
        return stats  # already header-covered end to end: no-op
    if dry_run:
        return stats
    tmp = directory.rstrip("/\\") + ".migrating"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name, blob in staged:
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
    # Non-frame sidecar state: the gc floor travels (deliberate
    # head-of-store deletion must stay recorded); rs/ shard sets do NOT
    # (their whole-file CRCs cover the old bytes — the background
    # encoder re-protects the rewritten segments).
    floor = os.path.join(directory, "gc_floor")
    if os.path.exists(floor):
        shutil.copy2(floor, os.path.join(tmp, "gc_floor"))
    # The gate: the rewritten store must pass the modern health walk
    # IN FULL before anything is swapped.
    verify_store(tmp)
    n = 0
    while True:
        backup = f"{directory.rstrip('/')}.premigrate-{n}"
        if not os.path.exists(backup):
            break
        n += 1
    os.replace(directory, backup)
    os.replace(tmp, directory)
    stats["migrated"] = True
    stats["backup"] = backup
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("directory", help="segment store directory "
                                      "(e.g. <data_dir>/segments)")
    ap.add_argument("--dry-run", action="store_true",
                    help="classify frames and report; rewrite nothing")
    args = ap.parse_args(argv)
    try:
        stats = migrate_store(args.directory, dry_run=args.dry_run)
    except MigrationError as e:
        print(json.dumps({"ok": False, "error": str(e)}, indent=1))
        return 1
    print(json.dumps({"ok": True, **stats}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A broker's store, read back by its on-disk framing alone.

A store directory holds `segment-XXXXXXXX.log` files, read in name
order. Each file is a run of frames: a 21-byte little-endian header
(magic u32 0x474C5152, type u8, slot u32, base u32, length u32, crc
u32), then `length` payload bytes. The crc is CRC-32 of the header's
first 17 bytes, chained with the payload. An append frame (type 1)
carries rows of one partition slot from offset `base` on.

Plain Python; imports nothing of the program.
"""

from __future__ import annotations

import os
import struct
import zlib

MAGIC = 0x474C5152
REC_APPEND = 1
_HEADER = struct.Struct("<IBIIII")
_PREFIX = 17


def scan_appends(directory: str) -> tuple[dict, int]:
    """The append frames of a store: slot -> {base: payload}, a frame
    written again at the same base replacing the earlier one (as the
    store's own replay does), and the number of frames that fail their
    magic, length or crc (the rest of that file is then not read)."""
    by_slot: dict = {}
    bad = 0
    names = sorted(f for f in os.listdir(directory)
                   if f.startswith("segment-") and f.endswith(".log")) \
        if os.path.isdir(directory) else []
    for name in names:
        with open(os.path.join(directory, name), "rb") as f:
            data = memoryview(f.read())
        at = 0
        while at < len(data):
            if len(data) - at < _HEADER.size:
                bad += 1
                break
            magic, rec, slot, base, n, crc = _HEADER.unpack_from(data, at)
            body = data[at + _HEADER.size:at + _HEADER.size + n]
            if magic != MAGIC or len(body) < n or zlib.crc32(
                    body, zlib.crc32(data[at:at + _PREFIX])) != crc:
                bad += 1
                break
            if rec == REC_APPEND:
                by_slot.setdefault(slot, {})[base] = bytes(body)
            at += _HEADER.size + n
    return by_slot, bad

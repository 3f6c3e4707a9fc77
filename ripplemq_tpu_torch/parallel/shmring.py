"""Shared-memory SPSC frame ring: the host-plane process boundary.

One ring carries length-prefixed, CRC-guarded frames ONE direction
between exactly two processes (the broker dispatcher and one host-plane
worker — parallel/hostplane.py runs a pair per worker). The design
target is the PROFILE.md host wall: payload bytes must cross the
process boundary ONCE, as the pre-packed frame the codec already
produced, with no pickling and no per-message re-encode (the
multiprocessing.Queue default pays a pickle + a pipe write + a pickle
per hop — measured at ~3x the bytes touched).

Layout (`multiprocessing.shared_memory.SharedMemory`):

  [0:4)    magic (u32) — attach-time sanity check
  [8:16)   capacity of the data area (u64)
  [16:24)  head (u64): consumer cursor, absolute monotone byte count
  [24:32)  tail (u64): producer cursor, absolute monotone byte count
  [64:64+capacity) data

Frames are `[u32 body_len][u32 crc32(body)][body]`, padded to 8-byte
alignment, always CONTIGUOUS in the data area: a frame that would
straddle the end is preceded by a WRAP marker (`body_len ==
0xFFFFFFFF`, written only when >= 4 bytes remain) and starts at
offset 0 of the next lap. Cursors are absolute, so `fill = tail -
head` needs no emptiness flag and `capacity - fill` is free space.

Torn-write contract: the producer writes header + body FIRST and
advances `tail` LAST — a producer crashing mid-frame leaves the frame
invisible (the consumer never reads past `tail`), which is the
worker-crash-mid-frame story the host plane's recovery tests pin. The
CRC additionally catches a publish of corrupt bytes (a torn tail
advance, stray writes): the consumer raises `TornFrameError` instead
of handing garbage to the codec.

Blocking is polled (two processes share no OS futex here): a short
spin, then an escalating sleep capped at 1 ms — the ring is a
throughput device, and under load the spin path is the only one taken.

Twin of `ripplemq_tpu/parallel/shmring.py` (PyTorch port): the same code,
byte for byte in its layout, and host-only (no torch), as the host-plane
workers that import it must stay.
"""

from __future__ import annotations

import struct
import time
import zlib
from multiprocessing import shared_memory
from typing import Optional

MAGIC = 0x52514D52  # "RQMR"
_HDR_BYTES = 64
_WRAP = 0xFFFFFFFF
_FRAME_HDR = 8
# Hard per-frame cap (matches the wire codec's defensive bound — a
# corrupt length must never drive a multi-GB copy).
MAX_FRAME = 64 * 1024 * 1024


class RingClosedError(Exception):
    """The ring was closed locally; no further push/pop is legal."""


class RingFullError(Exception):
    """push() timed out against a full ring (consumer stalled/dead)."""


class TornFrameError(Exception):
    """A published frame failed its CRC or carried an insane length —
    the peer crashed mid-publish or the mapping was corrupted. The ring
    is unusable from here (cursors can no longer be trusted)."""


def _sleep_backoff(spins: int) -> None:
    if spins < 64:
        return
    time.sleep(min(0.001, 0.00005 * (spins // 64)))


class ShmRing:
    """One direction of a dispatcher<->worker pair. Exactly one process
    calls push(), exactly one calls pop() — SPSC by contract (the host
    plane serializes each side onto a dedicated thread)."""

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int,
                 owner: bool) -> None:
        self._shm = shm
        self._buf = shm.buf
        self._cap = capacity
        self._owner = owner
        self._closed = False

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, capacity: int) -> "ShmRing":
        if capacity < (1 << 12):
            raise ValueError(f"ring capacity {capacity} below 4 KiB floor")
        shm = shared_memory.SharedMemory(create=True,
                                         size=_HDR_BYTES + capacity)
        struct.pack_into("<I", shm.buf, 0, MAGIC)
        struct.pack_into("<Q", shm.buf, 8, capacity)
        struct.pack_into("<QQ", shm.buf, 16, 0, 0)
        return cls(shm, capacity, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        # NB: no resource_tracker.unregister here. The spawned worker
        # SHARES the dispatcher's tracker process, so attach-side
        # registration lands in the same cache entry the create side
        # made — the dispatcher's unlink retires it exactly once. An
        # attach-side unregister (the commonly-cited 3.10 workaround)
        # would remove the dispatcher's registration out from under its
        # own unlink and spray KeyErrors from the tracker.
        shm = shared_memory.SharedMemory(name=name)
        magic, = struct.unpack_from("<I", shm.buf, 0)
        if magic != MAGIC:
            shm.close()
            raise ValueError(f"shm segment {name!r} is not a ShmRing")
        cap, = struct.unpack_from("<Q", shm.buf, 8)
        return cls(shm, int(cap), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def capacity(self) -> int:
        return self._cap

    # -- cursors -----------------------------------------------------------

    def _head(self) -> int:
        return struct.unpack_from("<Q", self._buf, 16)[0]

    def _tail(self) -> int:
        return struct.unpack_from("<Q", self._buf, 24)[0]

    def fill_fraction(self) -> float:
        """Occupancy in [0, 1] — the host plane's admin.stats gauge."""
        if self._closed:
            return 0.0
        return (self._tail() - self._head()) / self._cap

    # -- producer side -----------------------------------------------------

    def _reserve(self, n: int, timeout_s: Optional[float]
                 ) -> Optional[tuple[int, int, int]]:
        """Wait for `n` contiguous body bytes; returns (tail, idx,
        need) with any WRAP marker already written — `need` is the
        8-byte-aligned frame footprint the publish advances tail by —
        or None when `timeout_s == 0` and the ring is full (the
        fire-and-forget contract). Raises RingFullError on a positive
        timeout elapsing."""
        need = _FRAME_HDR + ((n + 7) & ~7)
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        spins = 0
        while True:
            tail = self._tail()
            head = self._head()
            idx = tail % self._cap
            room_to_end = self._cap - idx
            want = need if room_to_end >= need else room_to_end + need
            if self._cap - (tail - head) >= want:
                break
            if timeout_s == 0:
                return None
            if deadline is not None and time.monotonic() > deadline:
                raise RingFullError(
                    f"ring full for {timeout_s}s ({n}-byte frame)"
                )
            spins += 1
            _sleep_backoff(spins)
            if self._closed:
                raise RingClosedError("ring closed")
        if room_to_end < need:
            if room_to_end >= 4:
                struct.pack_into("<I", self._buf, _HDR_BYTES + idx, _WRAP)
            tail += room_to_end
            idx = 0
        return tail, idx, need

    def push(self, body, timeout_s: Optional[float] = 5.0) -> bool:
        """Publish one frame; False on timeout against a full ring when
        `timeout_s` is 0 (the non-blocking fire-and-forget mirror path),
        RingFullError on a positive timeout elapsing. One-part alias of
        push_parts — ONE publish sequence owns the torn-write
        contract."""
        return self.push_parts((body,), timeout_s=timeout_s)

    def push_parts(self, parts, timeout_s: Optional[float] = 5.0) -> bool:
        """Publish ONE frame whose body is the concatenation of `parts`
        (bytes-like), each copied into the ring exactly once — push()'s
        single-part case, and the scatter-gather path for bodies whose
        tail some other buffer already holds (the settled-mirror
        publish: a ~40-byte encoded header prefix + the row block,
        wire/codec.py encode_dict_with_blob). No bytes() copies: the
        slice assignment and the incremental crc32 both take any buffer
        — the body is touched exactly once each way (the module's
        design goal, priced per-message in PROFILE.md); byte parity of
        the split and whole forms is pinned in tests/test_shmring.py."""
        if self._closed:
            raise RingClosedError("ring closed")
        n = sum(len(p) for p in parts)
        if n == 0 or n > min(MAX_FRAME, self._cap // 2):
            raise ValueError(f"frame body of {n} bytes out of range")
        slot = self._reserve(n, timeout_s)
        if slot is None:
            return False
        tail, idx, need = slot
        base = _HDR_BYTES + idx
        pos = base + _FRAME_HDR
        crc = 0
        for p in parts:
            self._buf[pos : pos + len(p)] = p
            crc = zlib.crc32(p, crc)
            pos += len(p)
        struct.pack_into("<II", self._buf, base, n, crc & 0xFFFFFFFF)
        # Publish point: the 8-byte tail write is the ONLY thing that
        # makes the frame visible (torn-write contract, module doc).
        struct.pack_into("<Q", self._buf, 24, tail + need)
        return True

    # -- consumer side -----------------------------------------------------

    def pop(self, timeout_s: Optional[float] = None) -> Optional[bytearray]:
        """Next frame body (a fresh writable bytearray — safe to hand to
        np.frombuffer), or None on timeout. Raises TornFrameError on a
        CRC/length violation."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        spins = 0
        while True:
            if self._closed:
                raise RingClosedError("ring closed")
            head = self._head()
            if self._tail() != head:
                break
            if timeout_s == 0:
                return None
            if deadline is not None and time.monotonic() > deadline:
                return None
            spins += 1
            _sleep_backoff(spins)
        idx = head % self._cap
        room_to_end = self._cap - idx
        if room_to_end < _FRAME_HDR:
            struct.pack_into("<Q", self._buf, 16, head + room_to_end)
            return self.pop(timeout_s=timeout_s)
        base = _HDR_BYTES + idx
        n, crc = struct.unpack_from("<II", self._buf, base)
        if n == _WRAP:
            struct.pack_into("<Q", self._buf, 16, head + room_to_end)
            return self.pop(timeout_s=timeout_s)
        if n == 0 or n > min(MAX_FRAME, self._cap // 2) \
                or _FRAME_HDR + n > room_to_end:
            raise TornFrameError(
                f"frame length {n} insane at ring offset {idx}"
            )
        body = bytearray(self._buf[base + _FRAME_HDR : base + _FRAME_HDR + n])
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise TornFrameError(f"frame CRC mismatch at ring offset {idx}")
        struct.pack_into("<Q", self._buf, 16, head + _FRAME_HDR + ((n + 7) & ~7))
        return body

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Release the exported memoryview BEFORE closing the mapping
        # (BufferError otherwise) — nothing below touches _buf again.
        self._buf = None
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

"""Directed tests for the shared-memory frame ring (parallel/shmring.py):
framing roundtrip, wrap behavior, torn/corrupt-write detection,
backpressure — the substrate the multi-core host plane rides.

Twin of `tests/test_shmring.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import struct
import threading

import pytest

from ripplemq_tpu_torch.parallel.shmring import (
    RingFullError,
    ShmRing,
    TornFrameError,
)
from tests.torch_port_modules import admit

admit(__name__)


def make_pair(cap=1 << 14):
    ring = ShmRing.create(cap)
    peer = ShmRing.attach(ring.name)
    return ring, peer


def test_roundtrip_and_wrap():
    """Thousands of variable-size frames through a small ring: every
    frame arrives intact and in order across many wraps."""
    prod, cons = make_pair(1 << 12)
    try:
        for i in range(3000):
            body = bytes([i % 251]) * (i % 400 + 1)
            assert prod.push(body, timeout_s=2.0)
            got = cons.pop(timeout_s=2.0)
            assert bytes(got) == body, f"frame {i} corrupted"
    finally:
        cons.close()
        prod.close()


def test_interleaved_producer_consumer_threads():
    """SPSC under real concurrency: a producer thread streams frames
    while the consumer drains — contents and order survive."""
    prod, cons = make_pair(1 << 13)
    n = 2000
    errors = []

    def producer():
        try:
            for i in range(n):
                prod.push(i.to_bytes(4, "little") + b"p" * (i % 97 + 1),
                          timeout_s=5.0)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    t = threading.Thread(target=producer)
    t.start()
    try:
        for i in range(n):
            got = cons.pop(timeout_s=5.0)
            assert got is not None, f"frame {i} never arrived"
            assert int.from_bytes(got[:4], "little") == i
            assert bytes(got[4:]) == b"p" * (i % 97 + 1)
        t.join(timeout=5)
        assert not errors
    finally:
        cons.close()
        prod.close()


def test_torn_write_is_invisible_until_published():
    """A producer crashing mid-frame (bytes written, tail never
    advanced) leaves NOTHING visible: the consumer times out instead of
    reading a half-frame — the publish point is the tail advance."""
    prod, cons = make_pair()
    try:
        # Write frame bytes directly WITHOUT advancing the tail — the
        # crash-between-body-and-publish window.
        body = b"half-written frame"
        base = 64  # data area start, ring empty -> index 0
        prod._shm.buf[base + 8 : base + 8 + len(body)] = body
        struct.pack_into("<II", prod._shm.buf, base, len(body), 12345)
        assert cons.pop(timeout_s=0.05) is None
        # A real publish after the torn one overwrites it cleanly.
        assert prod.push(b"published", timeout_s=1.0)
        assert bytes(cons.pop(timeout_s=1.0)) == b"published"
    finally:
        cons.close()
        prod.close()


def test_corrupt_published_frame_raises_torn():
    """A frame whose bytes were damaged AFTER publish (or a torn tail
    advance) fails its CRC — TornFrameError, never garbage upward."""
    prod, cons = make_pair()
    try:
        prod.push(b"to-be-corrupted", timeout_s=1.0)
        prod._shm.buf[64 + 8] ^= 0xFF  # flip a body byte post-publish
        with pytest.raises(TornFrameError):
            cons.pop(timeout_s=1.0)
    finally:
        cons.close()
        prod.close()


def test_insane_length_raises_torn():
    prod, cons = make_pair()
    try:
        prod.push(b"x", timeout_s=1.0)
        struct.pack_into("<I", prod._shm.buf, 64, 1 << 30)  # absurd length
        with pytest.raises(TornFrameError):
            cons.pop(timeout_s=1.0)
    finally:
        cons.close()
        prod.close()


def test_full_ring_backpressure_and_nonblocking_drop():
    """A stalled consumer backpressures the producer: timeout_s=0
    reports the drop (the fire-and-forget mirror path), a positive
    timeout raises RingFullError."""
    prod, cons = make_pair(1 << 12)
    try:
        pushed = 0
        while prod.push(b"y" * 512, timeout_s=0):
            pushed += 1
            assert pushed < 100, "ring never filled"
        assert pushed > 0
        with pytest.raises(RingFullError):
            prod.push(b"y" * 512, timeout_s=0.05)
        # Draining frees the space.
        assert cons.pop(timeout_s=1.0) is not None
        assert prod.push(b"y" * 512, timeout_s=1.0)
    finally:
        cons.close()
        prod.close()


def test_push_parts_byte_parity_with_push():
    """The scatter-gather publish (push_parts — the settled-mirror
    reference/range path) is BYTE-IDENTICAL on the
    consumer side to push() of the concatenated body: same framing,
    same CRC, interleavable on one ring, correct across wraps."""
    prod, cons = make_pair(1 << 12)
    try:
        for i in range(500):  # many wraps of the 4 KiB ring
            prefix = bytes([i % 7]) * (i % 37 + 1)
            blob = bytes([i % 251]) * (i % 300 + 1)
            if i % 2:
                assert prod.push_parts([prefix, blob], timeout_s=2.0)
            else:
                assert prod.push(prefix + blob, timeout_s=2.0)
            got = cons.pop(timeout_s=2.0)
            assert bytes(got) == prefix + blob, f"frame {i} corrupted"
        # memoryview parts cross without materializing.
        assert prod.push_parts(
            [memoryview(b"head"), memoryview(b"tail")], timeout_s=1.0)
        assert bytes(cons.pop(timeout_s=1.0)) == b"headtail"
        # Same refusal contract as push.
        with pytest.raises(ValueError):
            prod.push_parts([b""], timeout_s=1.0)
        with pytest.raises(ValueError):
            prod.push_parts([b"x" * (1 << 12)], timeout_s=1.0)
    finally:
        cons.close()
        prod.close()


def test_encode_dict_with_blob_parity():
    """codec.encode_dict_with_blob(meta, key, blob) + blob must be
    byte-for-byte the frame codec.encode builds for the same dict with
    the blob entry last — the decoder cannot tell which path produced
    it (the settled-mirror publish rides the split form)."""
    from ripplemq_tpu_torch.wire import codec

    meta = {"op": "mirror", "slot": 3, "base": 4096}
    for blob in (b"", b"x", b"\x00" * 1000, bytes(range(256)) * 5):
        prefix = codec.encode_dict_with_blob(meta, "rows", blob)
        whole = codec.encode({**meta, "rows": blob})
        assert prefix + blob == whole
        assert codec.decode(prefix + blob) == {**meta, "rows": blob}
    with pytest.raises(ValueError):
        codec.encode_dict_with_blob({"rows": 1}, "rows", b"z")


def test_occupancy_gauge():
    prod, cons = make_pair(1 << 12)
    try:
        assert prod.fill_fraction() == 0.0
        prod.push(b"z" * 1024, timeout_s=1.0)
        assert 0.2 < prod.fill_fraction() < 0.35
        cons.pop(timeout_s=1.0)
        assert prod.fill_fraction() == 0.0
    finally:
        cons.close()
        prod.close()

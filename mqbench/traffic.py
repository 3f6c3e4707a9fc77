"""The benchmark's one traffic generator: schedules and payloads from a seed.

Everything here is plain Python and NumPy. A traffic mix is a JSON data
file under `mqbench/workloads/`; this module turns it and `--seed` into
the exact requests a run sends, and into the bytes each message carries.
The load generators and the reference both call it, so they agree on
what was sent without the program's help.

A message is `size` bytes: a 24-byte header, then filler.

    due_ns    u64  scheduled send time, CLOCK_MONOTONIC ns (shared by
                   every process on the host)
    stream    u32  the generator stream (one producer thread or one
                   open-loop request sequence) that made it
    k         u32  the request's index within its stream
    j         u16  the message's index within its request
    part      u16  the partition the request was sent to
    salt      u32  a value drawn from the seed: marks this run's bytes

The filler is a window into a block of random bytes drawn from the seed,
at an offset mixed from every header field. A flipped byte anywhere in a
message therefore fails `verify`, header included.
"""

from __future__ import annotations

import math
import struct

import numpy as np

HEADER = np.dtype([("due", "<u8"), ("stream", "<u4"), ("k", "<u4"),
                   ("j", "<u2"), ("part", "<u2"), ("salt", "<u4")])
HEADER_BYTES = HEADER.itemsize  # 24
_PACK = struct.Struct("<QIIHHI")
FILLER_SPAN = 2048
_MASK = (1 << 64) - 1
_M1, _M2, _M3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
# Message id: stream << 44 | k << 12 | j (streams < 2^20, batches < 4096).
ID_STREAM_SHIFT, ID_K_SHIFT = 44, 12
# The stream of the quorum probe's requests (request k to partition k),
# which no generator stream reaches.
PROBE_STREAM = (1 << 20) - 1


def msg_id(stream: int, k: int, j: int) -> int:
    return (stream << ID_STREAM_SHIFT) | (k << ID_K_SHIFT) | j


def request_ids(stream: int, k: int, n: int) -> np.ndarray:
    """The ids of a request's n messages, in order."""
    return (np.uint64(msg_id(stream, k, 0))
            + np.arange(n, dtype=np.uint64))


class Payloads:
    """Makes and checks the messages of one run (one seed, one size)."""

    def __init__(self, seed: int, size: int) -> None:
        if size <= HEADER_BYTES:
            raise ValueError(f"message size {size} must exceed the "
                             f"{HEADER_BYTES}-byte header")
        rng = np.random.default_rng([int(seed), 0x6D71])
        self.size = int(size)
        self.fill = self.size - HEADER_BYTES
        self.salt = int(rng.integers(1, 1 << 32, dtype=np.uint64))
        self.block = rng.integers(0, 256, FILLER_SPAN + self.fill,
                                  dtype=np.uint8)
        self._block_bytes = self.block.tobytes()

    def _offset(self, due: int, stream: int, k: int, j: int) -> int:
        h = (due * _M1 + stream * _M2 + k * _M3 + j) & _MASK
        return ((h ^ (h >> 29) ^ self.salt) & _MASK) % FILLER_SPAN

    def make(self, due_ns: int, stream: int, k: int, part: int,
             n: int) -> list[bytes]:
        """The n messages of request k of `stream`, sent to `part`."""
        pack, block, fill, salt = (_PACK.pack, self._block_bytes,
                                   self.fill, self.salt)
        out = []
        for j in range(n):
            off = self._offset(due_ns, stream, k, j)
            out.append(pack(due_ns, stream, k, j, part, salt)
                       + block[off:off + fill])
        return out

    def verify(self, msgs: list[bytes]):
        """Check a delivered batch. Returns (ids u64, due_ns u64, part
        u16, ok bool) arrays, one entry a message; `ok` is False for a
        message whose bytes are not what its header says was sent (or
        whose length is wrong: its id is then 0)."""
        n = len(msgs)
        good = np.fromiter((len(m) == self.size for m in msgs), bool, n)
        idx = np.flatnonzero(good)
        rows = np.frombuffer(b"".join(msgs[i] for i in idx),
                             np.uint8).reshape(len(idx), self.size)
        return self.verify_rows(rows, idx, n)

    def verify_rows(self, rows: np.ndarray, idx=None, n=None):
        """`verify` over a [m, size] uint8 block of messages, which sit
        at positions `idx` of a batch of n (all of it by default)."""
        if idx is None:
            idx = np.arange(len(rows))
            n = len(rows)
        ids = np.zeros(n, np.uint64)
        due = np.zeros(n, np.uint64)
        part = np.zeros(n, np.uint16)
        ok = np.zeros(n, bool)
        if len(idx) == 0:
            return ids, due, part, ok
        hdr = rows[:, :HEADER_BYTES].copy().view(HEADER).reshape(-1)
        d = hdr["due"].astype(np.uint64)
        s = hdr["stream"].astype(np.uint64)
        k = hdr["k"].astype(np.uint64)
        j = hdr["j"].astype(np.uint64)
        with np.errstate(over="ignore"):
            h = d * np.uint64(_M1) + s * np.uint64(_M2) \
                + k * np.uint64(_M3) + j
            h = h ^ (h >> np.uint64(29)) ^ np.uint64(self.salt)
        off = (h % np.uint64(FILLER_SPAN)).astype(np.int64)
        # In blocks of rows, so a store's millions of rows never build
        # one index array of rows x fill.
        body_ok = np.empty(len(rows), bool)
        cols = np.arange(self.fill)
        for i in range(0, len(rows), 8192):
            b = slice(i, i + 8192)
            body_ok[b] = (rows[b, HEADER_BYTES:]
                          == self.block[off[b, None] + cols]).all(axis=1)
        ok[idx] = body_ok & (hdr["salt"] == self.salt) \
            & (hdr["j"] < (1 << ID_K_SHIFT))
        ids[idx] = (s << np.uint64(ID_STREAM_SHIFT)) \
            | (k << np.uint64(ID_K_SHIFT)) | j
        due[idx] = d
        part[idx] = hdr["part"]
        return ids, due, part, ok


def _stratified(n: int, rng: np.random.Generator) -> np.ndarray:
    """n quantile midpoints of U(0,1), in an order drawn from the seed:
    every seed gets the same values, so the same work, in another order."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def open_schedule(traffic: dict, partitions: int, seed: int,
                  seconds: float) -> dict:
    """An open-loop Poisson schedule of `seconds` at the mix's rate.

    Batch sizes are log-uniform over [batch_min, batch_max] and gaps
    exponential, each as a fixed set of quantiles that the seed only
    orders, so runs of different seeds offer the same messages at the
    same mean rate. Partitions go round-robin from a seeded start.
    Returns due offsets (s, from the schedule's start), sizes and
    partitions, one entry a request."""
    rate = float(traffic["rate_msgs_per_s"])
    lo, hi = int(traffic["batch_min"]), int(traffic["batch_max"])
    rng = np.random.default_rng([int(seed), 0x5C4E])
    span = math.log(hi + 1) - math.log(lo)
    # Mean of floor(exp(U(ln lo, ln(hi+1))))), computed on the same
    # quantiles the schedule uses.
    probe = np.floor(np.exp(math.log(lo) + span * (np.arange(4096) + 0.5)
                            / 4096))
    mean_batch = float(np.clip(probe, lo, hi).mean())
    n_req = max(1, int(round(rate * seconds / mean_batch)))
    sizes = np.clip(np.floor(np.exp(math.log(lo) + span
                                    * _stratified(n_req, rng))),
                    lo, hi).astype(np.int64)
    gaps = -np.log1p(-_stratified(n_req, rng))  # Exp(1) quantiles
    gaps *= seconds / gaps.sum()  # exactly `seconds` of schedule
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    start = int(rng.integers(0, partitions))
    parts = (start + np.arange(n_req)) % partitions
    return {"due_s": due, "n": sizes, "part": parts.astype(np.int64)}


def closed_start(seed: int, partitions: int) -> int:
    """Closed-loop partition choice: request k of stream s of S goes to
    (start + s + k * S) % partitions, round-robin over every partition
    with the streams interleaved, from this start drawn from the seed."""
    return int(np.random.default_rng([int(seed), 0xC105]).integers(
        0, partitions))

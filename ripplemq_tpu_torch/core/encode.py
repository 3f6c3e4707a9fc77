"""Host-side encoding between Python payloads and fixed-shape step inputs
(PyTorch port).

Twin of `ripplemq_tpu/core/encode.py`, which is numpy-only: the functions
here return numpy arrays (a `StepInput` whose leaves are numpy), and the
engine (`parallel.engine`) converts them to tensors on its device at its
boundary. Each payload is packed into one `slot_bytes` uint8 row behind
an 8-byte header (length + round term, little-endian).
"""

from __future__ import annotations

import numpy as np

from ripplemq_tpu_torch.core.config import ALIGN, ROW_HEADER, EngineConfig
from ripplemq_tpu_torch.core.state import StepInput


def row_extents(counts: np.ndarray) -> np.ndarray:
    """Per-partition write extents (rows, ALIGN-rounded) from payload
    counts — what the packed write path needs to clip each window."""
    counts = np.asarray(counts, np.int32)
    return ((counts + ALIGN - 1) // ALIGN * ALIGN).astype(np.int32)


def pack_rows(
    cfg: EngineConfig, payloads: list[bytes], term: int
) -> np.ndarray:
    """Pack payloads into a [B, SB] block of header-prefixed rows. Rows
    beyond len(payloads) carry length 0 and the round term (they are the
    round's ALIGN padding and must still hold a valid term)."""
    B, SB = cfg.max_batch, cfg.slot_bytes
    if len(payloads) > B:
        raise ValueError(f"{len(payloads)} payloads > max_batch {B}")
    rows = np.zeros((B, SB), np.uint8)
    rows[:, 4:8] = np.frombuffer(np.int32(term).tobytes(), np.uint8)
    for i, m in enumerate(payloads):
        if not isinstance(m, (bytes, bytearray, memoryview)):
            raise TypeError(f"payloads must be bytes, got {type(m).__name__}")
        m = bytes(m)
        if not m:
            raise ValueError("empty messages are not supported (length-0 "
                             "rows mark alignment padding)")
        if len(m) > cfg.payload_bytes:
            raise ValueError(
                f"payload of {len(m)} bytes > payload_bytes {cfg.payload_bytes}"
            )
        rows[i, 0:4] = np.frombuffer(np.int32(len(m)).tobytes(), np.uint8)
        rows[i, ROW_HEADER : ROW_HEADER + len(m)] = np.frombuffer(m, np.uint8)
    return rows


def pack_payload_rows(cfg: EngineConfig, payloads: list[bytes]) -> np.ndarray:
    """Pack payloads into a [len(payloads), SB] block with a ZERO term
    field (the batcher stamps the round term at drain time). Uniform-
    length batches take one vectorized join + reshape."""
    SB = cfg.slot_bytes
    k = len(payloads)
    rows = np.zeros((k, SB), np.uint8)
    n0 = len(payloads[0]) if k else 0
    if k and all(len(m) == n0 for m in payloads):
        rows[:, 0:4] = np.frombuffer(
            np.full((k,), n0, "<i4").tobytes(), np.uint8
        ).reshape(k, 4)
        rows[:, ROW_HEADER : ROW_HEADER + n0] = np.frombuffer(
            b"".join(payloads), np.uint8
        ).reshape(k, n0)
        return rows
    for i, m in enumerate(payloads):
        n = len(m)
        rows[i, 0:4] = np.frombuffer(np.int32(n).tobytes(), np.uint8)
        rows[i, ROW_HEADER : ROW_HEADER + n] = np.frombuffer(m, np.uint8)
    return rows


def stamp_term(block: np.ndarray, term: int) -> None:
    """Write `term` into every row's term field of an assembled block."""
    block[:, 4:8] = np.frombuffer(np.int32(term).tobytes(), np.uint8)


def build_step_input(
    cfg: EngineConfig,
    appends: dict[int, list[bytes]] | None = None,
    offset_updates: dict[int, list[tuple[int, int]]] | None = None,
    leader: dict[int, int] | int = -1,
    term: dict[int, int] | int = 0,
) -> StepInput:
    """Build one round's StepInput (numpy leaves) from plain Python values.

    `appends` maps partition -> payload list; `offset_updates` maps
    partition -> [(consumer_slot, absolute_offset)]; `leader`/`term` are
    per-partition dicts or one value for all partitions. Raises
    ValueError on oversized payloads or batches.
    """
    P, B, SB, U = cfg.partitions, cfg.max_batch, cfg.slot_bytes, cfg.max_offset_updates

    def _per_partition(value, default):
        arr = np.full((P,), default, np.int32)
        if isinstance(value, dict):
            for p, v in value.items():
                if not 0 <= p < P:
                    raise ValueError(f"partition {p} out of range [0, {P})")
                arr[p] = v
        else:
            arr[:] = value
        return arr

    terms = _per_partition(term, 0)
    entries = np.zeros((P, B, SB), np.uint8)
    counts = np.zeros((P,), np.int32)
    off_slots = np.zeros((P, U), np.int32)
    off_vals = np.zeros((P, U), np.int32)
    off_counts = np.zeros((P,), np.int32)

    for p, msgs in (appends or {}).items():
        if not 0 <= p < P:
            raise ValueError(f"partition {p} out of range [0, {P})")
        entries[p] = pack_rows(cfg, msgs, int(terms[p]))
        counts[p] = len(msgs)

    for p, ups in (offset_updates or {}).items():
        if not 0 <= p < P:
            raise ValueError(f"partition {p} out of range [0, {P})")
        if len(ups) > U:
            raise ValueError(
                f"partition {p}: {len(ups)} offset updates > max_offset_updates {U}"
            )
        for i, (slot, off) in enumerate(ups):
            off_slots[p, i] = slot
            off_vals[p, i] = off
        off_counts[p] = len(ups)

    return StepInput(
        entries=entries,
        counts=counts,
        off_slots=off_slots,
        off_vals=off_vals,
        off_counts=off_counts,
        leader=_per_partition(leader, -1),
        term=terms,
        extents=row_extents(counts),
    )


def decode_entries(data, lens, count) -> list[bytes]:
    """Messages from a batch read's (rows, lens, count). Length-0 rows are
    alignment padding, not messages — skipped. Accepts tensors or arrays."""
    return [m for _, m in decode_entries_with_pos(data, lens, count)]


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def decode_entries_with_pos(data, lens, count) -> list[tuple[int, bytes]]:
    """Like decode_entries but yields (row_index, payload)."""
    data, lens, count = _host(data), _host(lens), int(_host(count))
    out = []
    for i in range(count):
        n = int(lens[i])
        if n > 0:
            out.append((i, bytes(data[i, ROW_HEADER : ROW_HEADER + n].tobytes())))
    return out

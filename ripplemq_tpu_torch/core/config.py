"""Static engine configuration (PyTorch port).

Twin of `ripplemq_tpu/core/config.py`: the same fields, the same
validation and the same derived properties, so one configuration
describes the same engine in both packages. Every field is a shape; the
port allocates its tensors from it once and never reshapes them.
"""

from __future__ import annotations

import dataclasses
import warnings

# Log slot alignment: every committed round advances the log end to a
# multiple of ALIGN. The reference chose 8 for the TPU's uint8 sublane
# tile; the port keeps it because it fixes the storage offsets clients
# see (rounds are ALIGN-padded, so `next_offset` is reported explicitly).
ALIGN = 8

# Bytes reserved at the head of every log row for metadata:
#   [0:4)  payload length, little-endian int32 (0 = empty/padding row)
#   [4:8)  Raft term of the writing round, little-endian int32
ROW_HEADER = 8

# Ring-stride aliasing rule, copied for API parity with the reference.
# Its penalty figure is a measurement of the reference's TPU memory
# system, not of this port's device; the rule only warns.
STRIDE_POW2_FLOOR = 1 << 20
_STRIDE_REL_TOL = 16  # flag within pow2/16 of the power of two
STRIDE_WARN_MIN_PARTITIONS = 64


def ring_stride_bytes(slots: int, max_batch: int, slot_bytes: int) -> int:
    """Per-partition byte stride of the physical log array
    [P, slots + max_batch, slot_bytes] (the ring plus its wrap margin)."""
    return (slots + max_batch) * slot_bytes


def stride_alias_hazard(slots: int, max_batch: int, slot_bytes: int,
                        streams: int | None = None) -> str | None:
    """Non-None iff the ring stride lands on/near a >= 2^20 power of two.
    Same verdict as the reference's rule; `streams` below
    STRIDE_WARN_MIN_PARTITIONS silences it."""
    if streams is not None and streams < STRIDE_WARN_MIN_PARTITIONS:
        return None
    stride = ring_stride_bytes(slots, max_batch, slot_bytes)
    if stride <= 0:
        return None
    lo = 1 << (stride.bit_length() - 1)
    for pow2 in (lo, lo << 1):
        if pow2 >= STRIDE_POW2_FLOOR and (
            abs(stride - pow2) <= pow2 // _STRIDE_REL_TOL
        ):
            return (
                f"ring stride {stride} B/partition "
                f"((slots={slots} + max_batch={max_batch}) * "
                f"slot_bytes={slot_bytes}) is within {100 / _STRIDE_REL_TOL:.1f}% "
                f"of 2^{pow2.bit_length() - 1}; the reference measured a "
                f"write-rate penalty for strided appends at such strides "
                f"on its own device. Nudge `slots` so the stride moves "
                f"off the power of two."
            )
    return None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shape/config of one replication-engine program.

    `partitions` is the leading partition axis of every state tensor;
    the replica axis is a leading [R] dimension the engine adds.
    """

    partitions: int = 8          # P — total partition slots in the program
    replicas: int = 3            # R — replication factor
    slots: int = 1024            # S — log capacity per partition (entries)
    slot_bytes: int = 128        # SB — bytes per log slot (incl. ROW_HEADER)
    max_batch: int = 32          # B — max appended entries per partition/step
    read_batch: int = 32         # RB — max entries per batch read
    max_consumers: int = 64      # C — consumer-offset table width
    max_offset_updates: int = 8  # U — max offset commits per partition/step
    fused_control: bool = False  # bookkeeping scalars as one [R, K, P] ctrl
    packed_writes: bool = False  # clip each append window to the round's
    #                              payload extent class
    # Host-path knob (not a device shape): how many dispatched rounds may
    # have their standby replication in flight (used by the DataPlane).
    settle_window: int = 4

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.settle_window < 1:
            raise ValueError("settle_window must be >= 1")
        if self.max_batch > self.slots:
            raise ValueError("max_batch cannot exceed slots")
        if self.read_batch > self.slots:
            raise ValueError("read_batch cannot exceed slots")
        if self.slot_bytes <= ROW_HEADER:
            raise ValueError(f"slot_bytes must exceed the {ROW_HEADER}-byte row header")
        if self.max_batch % ALIGN:
            raise ValueError(f"max_batch must be a multiple of {ALIGN}")
        if self.slots % ALIGN:
            raise ValueError(f"slots must be a multiple of {ALIGN}")
        hazard = stride_alias_hazard(self.slots, self.max_batch,
                                     self.slot_bytes,
                                     streams=self.partitions * self.replicas)
        if hazard is not None:
            warnings.warn(hazard, UserWarning, stacklevel=2)

    @property
    def quorum(self) -> int:
        """Majority of the full membership (Raft quorum)."""
        return self.replicas // 2 + 1

    @property
    def payload_bytes(self) -> int:
        """Max message payload per slot (slot minus the row header)."""
        return self.slot_bytes - ROW_HEADER

"""Host-side durability tier (PyTorch port).

- `segment` — append-only CRC-framed segment store (native C++ via
  ctypes with a pure-Python fallback writing the identical format) for
  the committed data-plane log; replay rebuilds device state on restart.
- `erasure` — RS(3,2) shards of sealed segments, encoded and repaired
  with the GF(2⁸) kernel.
- `memstore` — the in-memory round store (the same record interface,
  no disk); `logindex` — the (slot, offset) → record index the
  DataPlane serves below-trim reads through.

The metadata store (`metastore`) comes with a later slice.
"""

from ripplemq_tpu_torch.storage.segment import (
    REC_APPEND,
    REC_META,
    REC_OFFSETS,
    SegmentStore,
    native_available,
    scan_store,
)

__all__ = [
    "REC_APPEND",
    "REC_META",
    "REC_OFFSETS",
    "SegmentStore",
    "native_available",
    "scan_store",
]

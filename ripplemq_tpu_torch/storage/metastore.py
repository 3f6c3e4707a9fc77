"""Durable metadata-Raft state: atomic file persistence for hostraft.

Persists the node's hard state (term, vote, log, snapshot) on every
mutation via RaftNode's persist_fn hook, and restores it on boot — the
role JRaft's raft_meta/raft_log storage plays for the reference
(TopicsRaftServer.java:134-136). Atomicity: write to a temp file, fsync,
rename (POSIX atomic replace); a crash mid-write leaves the previous
image intact. Serialization is the wire codec (commands are wire-shaped
dicts already).

Twin of `ripplemq_tpu/storage/metastore.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import os
from typing import Optional

from ripplemq_tpu_torch.wire import codec


class MetaStore:
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def save(self, state: dict) -> None:
        blob = codec.encode(state)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> Optional[dict]:
        """The persisted image, or None if absent/unreadable (a torn temp
        file never shadows the last good image)."""
        try:
            with open(self.path, "rb") as f:
                return codec.decode(f.read())
        except (OSError, ValueError):
            return None

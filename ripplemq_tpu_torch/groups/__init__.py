"""Consumer groups: membership, cooperative assignment, generation
fencing — the "partition assignment" half of the reference's second
advertised service (PAPER.md; the first half, offset management, has
been per-consumer since the seed).

Layout:
- `state.py` — replicated group state (GroupState) and the
  deterministic sticky assignment function every broker's apply runs.
- `coordinator.py` — GroupTable (the metadata state machine's group
  section) and GroupLiveness (the metadata leader's volatile heartbeat
  ledger driving evictions).
- `client.py` — GroupConsumer, the member-side SDK: join/poll/
  heartbeat/commit-with-fencing/leave over both transports (not yet
  ported: slice D2).

Offsets are tracked per GROUP, not per member: every member commits
under the group's shared consumer name (`group_consumer_name`), so a
partition moving between members resumes from the group's last acked
commit. Generation fencing keeps that sound: a commit stamped with a
stale generation — a deposed member racing its own rebalance — is a
typed `fenced_generation` refusal, never a silent overwrite.

Twin of `ripplemq_tpu/groups/__init__.py` (PyTorch port): the same
exports of the state and coordinator modules; the client re-exports
raise until slice D2 ports `groups/client.py`.
"""

from ripplemq_tpu_torch.groups.coordinator import GroupLiveness, GroupTable
from ripplemq_tpu_torch.groups.state import (
    GroupState,
    compute_assignment,
    group_consumer_name,
)

__all__ = [
    "FencedError",
    "GroupConsumer",
    "GroupLiveness",
    "GroupState",
    "GroupTable",
    "compute_assignment",
    "group_consumer_name",
]


def __getattr__(name):
    # GroupConsumer/FencedError live in the client SDK (`groups/client.py`),
    # which comes with the broker server and clients, slice D2 of the port.
    if name in ("GroupConsumer", "FencedError"):
        raise NotImplementedError(
            f"groups.{name} belongs to groups/client.py, ported with slice "
            "D2 (the broker server and clients)")
    raise AttributeError(name)

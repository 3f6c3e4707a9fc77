"""GroupConsumer: the member-side consumer-group SDK.

One GroupConsumer is one MEMBER of one group: it joins (learning its
generation + assigned partitions from the replicated coordinator
state), polls its assignment round-robin through the ordinary consume
path, heartbeats the metadata leader so the coordinator can evict dead
members, commits offsets under the group's SHARED consumer name with
generation fencing, and leaves on close. Rebalances are learned from
heartbeat/join responses (poll-based — no server push): a member whose
partition moved simply stops being assigned it next heartbeat, and a
commit raced past its own rebalance is refused with
`fenced_generation` (the member rejoins and resumes on its new
assignment). Works over both transports — the in-proc fake network and
real TCP — like every other client.

Twin of `ripplemq_tpu/groups/client.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

from ripplemq_tpu_torch.client.consumer import ConsumerClient
from ripplemq_tpu_torch.groups.state import group_consumer_name
from ripplemq_tpu_torch.metadata.models import GroupKey
from ripplemq_tpu_torch.wire.retry import RetryPolicy, fatal_response_error
from ripplemq_tpu_torch.wire.transport import RpcError, Transport


class GroupError(Exception):
    pass


class FencedError(GroupError):
    """A commit carried a stale generation (or a membership this
    coordinator no longer recognizes): the member must rejoin and
    resume on its NEW assignment — the refused offset is not lost, the
    partition's new owner re-reads from the last acked commit."""


class GroupConsumer:
    def __init__(
        self,
        bootstrap: list[str],
        group: str,
        topics: tuple[str, ...] | list[str],
        member_id: Optional[str] = None,
        transport: Optional[Transport] = None,
        heartbeat_s: float = 0.5,
        max_messages: Optional[int] = None,
        metadata_refresh_s: float = 5.0,
        rpc_timeout_s: float = 5.0,
        retries: int = 3,
        retry_backoff_s: float = 0.1,
        deadline_s: Optional[float] = None,
    ) -> None:
        self.group = group
        self.topics = tuple(topics)
        self.member_id = member_id or f"{group}-m-{uuid.uuid4().hex[:8]}"
        self._bootstrap = list(bootstrap)
        self._timeout = rpc_timeout_s
        self.heartbeat_s = heartbeat_s
        self._last_beat = 0.0
        # Learned coordinator state.
        self.generation = -1
        self.assignment: tuple[GroupKey, ...] = ()
        self._rr = 0  # round-robin cursor over the assignment
        self._retry = RetryPolicy(
            max_attempts=retries, base_backoff_s=retry_backoff_s,
            deadline_s=deadline_s,
        )
        # All reads/commits ride the group's SHARED consumer name: the
        # committed offset is group state, so a partition moving to
        # another member resumes where the group left off.
        self._consumer = ConsumerClient(
            bootstrap, group_consumer_name(group), transport=transport,
            auto_commit=False, metadata_refresh_s=metadata_refresh_s,
            rpc_timeout_s=rpc_timeout_s, retries=retries,
            retry_backoff_s=retry_backoff_s, deadline_s=deadline_s,
            max_messages=max_messages if max_messages else 10,
        )
        self._transport = self._consumer._transport
        self._closed = False

    # ---------------------------------------------------------- membership

    def _call_group(self, req: dict) -> dict:
        """One group.* RPC against any reachable broker (group ops are
        forwarded broker-side: join/leave to the metadata raft,
        heartbeats to the metadata leader's liveness ledger)."""
        run = self._retry.begin()
        i = 0
        while run.attempt():
            addr = self._bootstrap[i % len(self._bootstrap)]
            i += 1
            try:
                resp = self._transport.call(
                    addr, req, timeout=run.clip(self._timeout)
                )
            except RpcError as e:
                run.note(str(e))
                continue
            if resp.get("ok"):
                return resp
            err = str(resp.get("error", ""))
            run.note(err)
            if err.startswith("unknown_member"):
                return resp  # caller rejoins — retrying cannot fix it
            if fatal_response_error(err):
                raise GroupError(err)
        raise GroupError(
            f"group rpc {req.get('type')} failed: {run.summary()}"
        )

    def _adopt(self, resp: dict) -> None:
        gen = int(resp.get("generation", -1))
        assignment = tuple(
            (str(t), int(p)) for t, p in resp.get("assignment", [])
        )
        if gen != self.generation or assignment != self.assignment:
            self.generation = gen
            self.assignment = assignment
            self._rr = 0

    def join(self) -> tuple[GroupKey, ...]:
        """Join (or re-confirm) membership; returns the assignment."""
        resp = self._call_group({
            "type": "group.join", "group": self.group,
            "member": self.member_id, "topics": list(self.topics),
        })
        self._adopt(resp)
        self._last_beat = time.monotonic()
        return self.assignment

    def heartbeat(self, force: bool = False) -> bool:
        """Beat if the interval elapsed (or `force`); adopts any
        rebalance the response reveals. Returns True if a beat was
        sent. An `unknown_member` answer means this member was evicted
        (session lapsed, e.g. a stalled process): rejoin transparently —
        the next poll runs on the fresh assignment."""
        now = time.monotonic()
        if not force and now - self._last_beat < self.heartbeat_s:
            return False
        self._last_beat = now
        resp = self._call_group({
            "type": "group.heartbeat", "group": self.group,
            "member": self.member_id, "generation": self.generation,
        })
        if not resp.get("ok"):
            # unknown_member: evicted — rejoin under the same id.
            self.join()
            return True
        self._adopt(resp)
        return True

    def leave(self) -> None:
        self._call_group({
            "type": "group.leave", "group": self.group,
            "member": self.member_id,
        })
        self.generation = -1
        self.assignment = ()

    # ---------------------------------------------------------------- data

    def poll(
        self, max_messages: Optional[int] = None
    ) -> tuple[Optional[GroupKey], list[bytes]]:
        """Heartbeat if due, then read one assigned partition (round-
        robin) and commit the advance under the current generation
        BEFORE delivering (the at-most-once contract of auto-commit,
        group edition). Returns ((topic, partition), messages) —
        (None, []) when nothing is assigned. A commit fenced by a
        concurrent rebalance rejoins and delivers NOTHING: the rows
        belong to the partition's new owner."""
        key, msgs, _, _ = self.poll_with_position(max_messages)
        return key, msgs

    def poll_with_position(
        self, max_messages: Optional[int] = None
    ) -> tuple[Optional[GroupKey], list[bytes], int, int]:
        """poll(), also returning (key, messages, offset, next_offset)
        — the positions harnesses record into operation histories."""
        self.heartbeat()
        if not self.assignment:
            return None, [], 0, 0
        key = self.assignment[self._rr % len(self.assignment)]
        self._rr += 1
        topic, pid = key
        msgs, _, off, nxt = self._consumer.consume_with_position(
            topic, partition=pid, max_messages=max_messages
        )
        if not msgs:
            return key, [], off, nxt
        try:
            self.commit(topic, pid, nxt)
        except FencedError:
            # Rebalanced under us: the partition (possibly) moved — the
            # new owner re-reads from the group's last acked commit, so
            # delivering these rows here would double-deliver them.
            self.join()
            return key, [], off, off
        return key, msgs, off, nxt

    def commit(self, topic: str, partition: int, offset: int,
               generation: Optional[int] = None) -> None:
        """Commit under the group's shared consumer name, fenced by
        `generation` (defaults to the member's current one). A
        `fenced_generation` refusal raises FencedError — typed, never a
        silent overwrite. `generation` is overridable so harnesses can
        prove the fence (a deposed member committing at a stale
        generation MUST be refused)."""
        gen = self.generation if generation is None else int(generation)
        run = self._retry.begin()
        while run.attempt():
            addr = self._consumer._meta.leader_addr(topic, partition)
            if addr is None:
                run.note(f"no leader known for {topic}[{partition}]")
                self._consumer._refresh_quietly()
                continue
            try:
                resp = self._transport.call(
                    addr,
                    {"type": "offset.commit", "topic": topic,
                     "partition": partition,
                     "consumer": group_consumer_name(self.group),
                     "group": self.group, "member": self.member_id,
                     "generation": gen, "offset": int(offset)},
                    timeout=run.clip(self._timeout),
                )
            except RpcError as e:
                run.note(str(e))
                self._consumer._refresh_quietly()
                continue
            if resp.get("ok"):
                return
            err = str(resp.get("error", ""))
            run.note(err)
            if err.startswith("fenced_generation"):
                raise FencedError(err)
            if err == "not_leader":
                self._consumer._refresh_quietly()
                continue
            if fatal_response_error(err):
                raise GroupError(err)
        raise GroupError(
            f"group commit {topic}[{partition}]={offset} failed: "
            f"{run.summary()}"
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self.generation >= 0:
                self.leave()
        except Exception:
            pass  # best-effort: close must not raise over a dead broker
        self._consumer.close()

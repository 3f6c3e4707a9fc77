"""Deterministic pump for the port's RaftNode clusters: the twin of
`tests/raft_harness.py`, built on `ripplemq_tpu_torch.broker.hostraft`.
It delivers messages in seeded order with drop/partition/crash control,
drawing from its own `random.Random` exactly as the reference harness
does, so one seed gives both packages the same interleaving.

Not collected (the name does not start with `test_`)."""

from __future__ import annotations

import random
from typing import Any

from ripplemq_tpu_torch.broker.hostraft import RaftNode, LEADER


class Cluster:
    def __init__(self, n: int, seed: int = 0, **node_kw) -> None:
        self.ids = list(range(n))
        self.applied: dict[int, list[tuple[int, Any]]] = {i: [] for i in self.ids}
        self.nodes: dict[int, RaftNode] = {}
        for i in self.ids:
            self.nodes[i] = RaftNode(
                i,
                self.ids,
                apply_fn=(lambda idx, cmd, i=i: self.applied[i].append((idx, cmd))),
                seed=seed,
                **node_kw,
            )
        self.rng = random.Random(seed ^ 0x5EED)
        self.inflight: list[tuple[int, int, dict]] = []  # (src, dst, msg)
        self.crashed: set[int] = set()
        self.blocked: set[frozenset[int]] = set()
        self.drop_rate = 0.0

    # -- fault control --
    def crash(self, i: int) -> None:
        self.crashed.add(i)

    def recover(self, i: int) -> None:
        self.crashed.discard(i)

    def partition(self, group_a: list[int], group_b: list[int]) -> None:
        for a in group_a:
            for b in group_b:
                self.blocked.add(frozenset((a, b)))

    def heal(self) -> None:
        self.blocked.clear()

    def _link_ok(self, a: int, b: int) -> bool:
        return (
            a not in self.crashed
            and b not in self.crashed
            and frozenset((a, b)) not in self.blocked
        )

    # -- pumping --
    def _queue(self, src: int, out: list[tuple[int, dict]]) -> None:
        for dst, msg in out:
            self.inflight.append((src, dst, msg))

    def step(self) -> None:
        """One tick on every live node, then deliver all traffic to quiescence."""
        for i in self.ids:
            if i not in self.crashed:
                self._queue(i, self.nodes[i].tick())
        self.deliver_all()

    def deliver_all(self, max_msgs: int = 100_000) -> None:
        n = 0
        while self.inflight and n < max_msgs:
            idx = self.rng.randrange(len(self.inflight))
            src, dst, msg = self.inflight.pop(idx)
            n += 1
            if not self._link_ok(src, dst):
                continue
            if self.drop_rate and self.rng.random() < self.drop_rate:
                continue
            resp = self.nodes[dst].handle(msg)
            if self._link_ok(src, dst):  # response can be lost separately
                self._queue(src, self.nodes[src].on_reply(dst, msg, resp))
        assert n < max_msgs, "message storm: cluster did not quiesce"

    def run(self, ticks: int) -> None:
        for _ in range(ticks):
            self.step()

    # -- queries --
    def leaders(self) -> list[int]:
        return [
            i
            for i in self.ids
            if i not in self.crashed and self.nodes[i].role == LEADER
        ]

    def sole_leader(self) -> int:
        leaders = self.leaders()
        assert len(leaders) == 1, f"expected one leader, got {leaders}"
        return leaders[0]

    def elect(self, max_ticks: int = 200) -> int:
        for _ in range(max_ticks):
            self.step()
            if len(self.leaders()) == 1:
                # settle heartbeats so followers learn the leader
                self.step()
                return self.sole_leader()
        raise AssertionError("no leader elected")

    def propose(self, i: int, cmd: Any) -> int | None:
        index, out = self.nodes[i].propose(cmd)
        self._queue(i, out)
        return index

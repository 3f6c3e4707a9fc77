"""GroupWorkload: consumer-group members under chaos, plus the nemesis
capability surface for rebalance-storm ops.

N members of ONE group run in threads through the real GroupConsumer
SDK (both backends — the transport comes from the cluster), recording
into the shared History:

- `assignment` ops whenever a member observes a new (generation,
  partitions) view — what check_group_history's dual-ownership
  invariant consumes;
- `consume` ops (client = member id, group-tagged) — fed to the MAIN
  checker too: a member's delivered stream must be a subsequence of the
  final log like any consumer's;
- `commit` ops with group/generation/member (and `stale=True` for the
  nemesis's commit-from-deposed-member op) — group-commit monotonicity
  across members and the fencing invariant.

The nemesis manipulates members through three capability ops, all
client-side and backend-agnostic (chaos/nemesis.py adds them to the op
pool when the run has group members):

  member_pause i   the member stops polling AND heartbeating — its
                   session lapses, the coordinator evicts it, the group
                   rebalances; heal resumes it (it rejoins
                   transparently on the first unknown_member answer).
  member_churn i   one leave + rejoin (membership churn → two forced
                   rebalances).
  stale_commit i   the member issues one offset commit stamped with a
                   STALE generation — the fence must refuse it (an ack
                   here is a checker violation).

Twin of `ripplemq_tpu/chaos/groups.py` (PyTorch port): the same code,
over the port's `groups.client`.
"""

from __future__ import annotations

import threading
import time

from ripplemq_tpu_torch.chaos.history import History
from ripplemq_tpu_torch.groups.client import FencedError, GroupConsumer


class GroupWorkload:
    def __init__(self, cluster, seed: int, history: History, topic: str,
                 partitions: int, members: int = 3,
                 group: str = "cgroup") -> None:
        self.history = history
        self.group = group
        self.topic = topic
        self.partitions = partitions
        self.n_members = members
        self._stop = threading.Event()
        self._paused = [threading.Event() for _ in range(members)]
        self._churn = [threading.Event() for _ in range(members)]
        self._stale = [threading.Event() for _ in range(members)]
        bootstrap = [b.address for b in cluster.config.brokers]
        self.members = [
            GroupConsumer(
                bootstrap, group, topics=[topic],
                member_id=f"m{seed}-{i}",
                transport=cluster.client(f"chaos-group-{seed}-{i}"),
                heartbeat_s=0.25, metadata_refresh_s=0.3,
                rpc_timeout_s=1.0, retries=3, retry_backoff_s=0.02,
                deadline_s=3.0,
            )
            for i in range(members)
        ]
        self._last_view: list = [None] * members
        self.generations_seen: set[int] = set()
        self._threads = [
            threading.Thread(target=self._member_loop, args=(i,),
                             daemon=True, name=f"chaos-group-m{i}")
            for i in range(members)
        ]

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        for g in self.members:
            g.close()

    # ----------------------------------------- nemesis capability surface

    def pause(self, i: int) -> None:
        self._paused[i % self.n_members].set()

    def resume(self, i: int) -> None:
        self._paused[i % self.n_members].clear()

    def resume_all(self) -> None:
        for ev in self._paused:
            ev.clear()

    def churn(self, i: int) -> None:
        self._churn[i % self.n_members].set()

    def stale_commit(self, i: int) -> None:
        self._stale[i % self.n_members].set()

    # -------------------------------------------------------- member loop

    def _record_view(self, i: int, g: GroupConsumer) -> None:
        view = (g.generation, g.assignment)
        if g.generation >= 0 and view != self._last_view[i]:
            self._last_view[i] = view
            self.generations_seen.add(g.generation)
            self.history.record(
                op="assignment", group=self.group, member=g.member_id,
                generation=g.generation,
                partitions=[[t, p] for t, p in g.assignment],
            )

    def _member_loop(self, i: int) -> None:
        g = self.members[i]
        while not self._stop.is_set():
            if self._paused[i].is_set():
                # Heartbeat silence: the session lapses and the
                # coordinator evicts — resume() rejoins transparently.
                time.sleep(0.02)
                continue
            try:
                if g.generation < 0:
                    g.join()
                    self._record_view(i, g)
                if self._churn[i].is_set():
                    self._churn[i].clear()
                    g.leave()
                    g.join()
                    self._record_view(i, g)
                if self._stale[i].is_set() and g.assignment:
                    self._stale[i].clear()
                    self._do_stale_commit(g)
                key, msgs, off, nxt = g.poll_with_position(max_messages=8)
                self._record_view(i, g)
            except Exception as e:
                self.history.record(
                    op="group_poll", group=self.group, member=g.member_id,
                    status="unknown", error=f"{type(e).__name__}: {e}",
                )
                time.sleep(0.05)
                continue
            if key is not None and msgs:
                topic, pid = key
                payloads = [m.decode("utf-8", "replace") for m in msgs]
                self.history.record(
                    op="consume", client=g.member_id, group=self.group,
                    topic=topic, partition=pid, status="ok",
                    offset=off, next_offset=nxt, payloads=payloads,
                )
                # poll_with_position only delivers after its commit
                # ACKED under the current generation.
                self.history.record(
                    op="commit", client=g.member_id, group=self.group,
                    member=g.member_id, generation=g.generation,
                    topic=topic, partition=pid, status="ok", offset=nxt,
                )
            time.sleep(0.01)

    def _do_stale_commit(self, g: GroupConsumer) -> None:
        """The commit-from-deposed-member op: one commit stamped with a
        stale generation, offset 0 (maximally damaging — an ack would
        both regress and un-fence). The REQUIRED outcome is a
        fenced_generation refusal."""
        topic, pid = g.assignment[0]
        stale_gen = g.generation - 1
        try:
            g.commit(topic, pid, 0, generation=stale_gen)
            status = "ok"  # fencing hole: check_group_history flags it
        except FencedError:
            status = "fenced"
        except Exception as e:
            status = f"fail: {type(e).__name__}"
        self.history.record(
            op="commit", client=g.member_id, group=self.group,
            member=g.member_id, generation=stale_gen, topic=topic,
            partition=pid, status="ok" if status == "ok" else "fail",
            fence_outcome=status, offset=0, stale=True,
        )

    # --------------------------------------------------------- convergence

    def wait_converged(self, timeout: float = 30.0) -> dict:
        """Post-heal convergence: every UNPAUSED member settles on ONE
        shared generation whose assignments are disjoint and cover the
        topic's full partition set. The member loops keep heartbeating/
        rejoining on their own; this just watches their views."""
        want = {(self.topic, p) for p in range(self.partitions)}
        deadline = time.time() + timeout
        detail: dict = {}
        while time.time() < deadline:
            live = [
                g for i, g in enumerate(self.members)
                if not self._paused[i].is_set()
            ]
            gens = {g.generation for g in live}
            union: list = []
            for g in live:
                union.extend(g.assignment)
            detail = {
                "generations": sorted(gens),
                "assigned": len(union),
                "distinct": len(set(union)),
                "covered": sorted(set(union)) == sorted(want),
            }
            if (live and len(gens) == 1 and -1 not in gens
                    and len(union) == len(set(union))
                    and set(union) == want):
                return {"converged": True, "generation": gens.pop(),
                        "members": len(live), **detail}
            time.sleep(0.05)
        return {"converged": False, "members": None, **detail}

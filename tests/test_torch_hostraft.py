"""The metadata Raft of the port: the twin of `tests/test_hostraft.py`
(elections, replication, faults, compaction), run on the port's
`RaftNode` through `tests/torch_raft_harness.py`.
"""

import pytest

from ripplemq_tpu_torch.broker.hostraft import FOLLOWER, LEADER, RaftNode
from tests.torch_raft_harness import Cluster
from tests.torch_port_modules import admit

admit(__name__)


def applied_cmds(cluster, i):
    return [cmd for _, cmd in cluster.applied[i]]


def test_single_node_cluster_elects_and_commits():
    c = Cluster(1)
    leader = c.elect()
    assert leader == 0
    c.propose(0, {"op": "x"})
    c.run(2)
    assert applied_cmds(c, 0) == [{"op": "x"}]


def test_elects_exactly_one_leader():
    c = Cluster(5, seed=3)
    c.elect()
    # Terms of any two leaders must differ; here there is only one.
    terms = {c.nodes[i].term for i in c.ids}
    assert len(terms) == 1


def test_replicates_and_applies_in_order_everywhere():
    c = Cluster(3, seed=1)
    leader = c.elect()
    for k in range(5):
        assert c.propose(leader, {"op": k}) is not None
        c.run(1)
    c.run(3)
    expect = [{"op": k} for k in range(5)]
    for i in c.ids:
        assert applied_cmds(c, i) == expect


def test_non_leader_propose_refused_with_hint():
    c = Cluster(3, seed=2)
    leader = c.elect()
    follower = next(i for i in c.ids if i != leader)
    assert c.propose(follower, {"op": "nope"}) is None
    assert c.nodes[follower].leader_hint == leader


def test_leader_crash_failover_and_no_lost_committed_entries():
    c = Cluster(5, seed=4)
    leader = c.elect()
    c.propose(leader, {"op": "committed"})
    c.run(3)
    c.crash(leader)
    new_leader = c.elect()
    assert new_leader != leader
    c.propose(new_leader, {"op": "after"})
    c.run(3)
    for i in c.ids:
        if i == leader:
            continue
        cmds = applied_cmds(c, i)
        assert cmds == [{"op": "committed"}, {"op": "after"}]


def test_minority_partition_cannot_commit_majority_can():
    c = Cluster(5, seed=5)
    leader = c.elect()
    minority = [leader, next(i for i in c.ids if i != leader)]
    majority = [i for i in c.ids if i not in minority]
    c.partition(minority, majority)
    # Old leader (minority side) accepts but can never commit.
    stale_index = c.propose(leader, {"op": "stale"})
    assert stale_index is not None
    c.run(30)
    new_leader = [i for i in c.leaders() if i in majority]
    assert len(new_leader) == 1, "majority side must elect its own leader"
    c.propose(new_leader[0], {"op": "real"})
    c.run(3)
    for i in majority:
        assert applied_cmds(c, i) == [{"op": "real"}]
    for i in minority:
        assert {"op": "stale"} not in applied_cmds(c, i)
    # Heal: the stale entry is overwritten, everyone converges.
    c.heal()
    c.run(30)
    for i in c.ids:
        assert applied_cmds(c, i) == [{"op": "real"}]


def test_recovered_node_catches_up():
    c = Cluster(3, seed=6)
    leader = c.elect()
    victim = next(i for i in c.ids if i != leader)
    c.crash(victim)
    for k in range(4):
        c.propose(c.sole_leader(), {"op": k})
        c.run(1)
    c.recover(victim)
    c.run(10)
    assert applied_cmds(c, victim) == [{"op": k} for k in range(4)]


def test_message_drops_do_not_violate_safety():
    c = Cluster(3, seed=7)
    c.drop_rate = 0.25
    for k in range(10):
        leaders = c.leaders()
        if len(leaders) == 1:
            c.propose(leaders[0], {"op": k})
        c.run(2)
    c.drop_rate = 0.0
    c.run(50)
    # Convergence + prefix property: all nodes applied identical sequences.
    seqs = [applied_cmds(c, i) for i in c.ids]
    assert seqs[0] == seqs[1] == seqs[2]
    # Order preserved (ops strictly increasing).
    ops = [cmd["op"] for cmd in seqs[0]]
    assert ops == sorted(ops)


def test_compaction_and_snapshot_install():
    state: dict[int, list] = {i: [] for i in range(3)}

    c = Cluster(3, seed=8, compact_threshold=8)
    # Wire snapshot hooks: state is the list of applied ops.
    for i in c.ids:
        node = c.nodes[i]
        node.snapshot_fn = lambda i=i: list(state[i])
        node.restore_fn = lambda s, i=i: (state[i].clear(), state[i].extend(s))
        node.apply_fn = lambda idx, cmd, i=i: state[i].append(cmd["op"])

    leader = c.elect()
    victim = next(i for i in c.ids if i != leader)
    c.crash(victim)
    for k in range(30):
        c.propose(c.sole_leader(), {"op": k})
        c.run(1)
    lead_node = c.nodes[c.sole_leader()]
    assert lead_node.snap_last_index > 0, "leader must have compacted"
    assert len(lead_node.entries) < 30
    # Victim is far behind the compacted prefix → must receive a snapshot.
    c.recover(victim)
    c.run(20)
    assert state[victim] == list(range(30))
    assert c.nodes[victim].snap_last_index > 0


def test_persistence_restart_restores_term_vote_log():
    saved = {}
    c = Cluster(3, seed=9)
    for i in c.ids:
        c.nodes[i].persist_fn = lambda s, i=i: saved.__setitem__(i, s)
    leader = c.elect()
    c.propose(leader, {"op": "durable"})
    c.run(3)

    # "Restart" node: fresh RaftNode restored from its persisted image.
    victim = next(i for i in c.ids if i != leader)
    old_term = c.nodes[victim].term
    fresh = RaftNode(victim, c.ids, apply_fn=lambda idx, cmd: None, seed=9)
    fresh.restore(saved[victim])
    assert fresh.term == old_term
    assert fresh.last_index() == c.nodes[victim].last_index()
    # Restored node must refuse to vote for a stale candidate.
    resp = fresh.handle(
        {"type": "raft.vote", "term": old_term, "cand": 99,
         "last_log_index": 0, "last_log_term": 0}
    )
    assert not resp["granted"]


def test_alive_peers_tracks_acks():
    c = Cluster(3, seed=10)
    leader = c.elect()
    c.run(3)
    assert c.nodes[leader].alive_peers() == sorted(c.ids)
    victim = next(i for i in c.ids if i != leader)
    c.crash(victim)
    c.run(15)
    assert victim not in c.nodes[leader].alive_peers()
    assert c.nodes[leader].alive_peers(horizon_ticks=10**9) == sorted(c.ids)
    c.recover(victim)
    c.run(5)
    assert victim in c.nodes[leader].alive_peers()


@pytest.mark.parametrize("seed", range(5))
def test_chaos_safety_sweep(seed):
    """Random crashes/partitions/drops; safety must hold throughout:
    applied sequences are always prefixes of each other."""
    import random as _random

    rng = _random.Random(seed)
    c = Cluster(5, seed=seed)
    c.drop_rate = 0.1
    proposed = 0
    for round_no in range(40):
        action = rng.random()
        if action < 0.1 and len(c.crashed) < 2:
            c.crash(rng.choice([i for i in c.ids if i not in c.crashed]))
        elif action < 0.2 and c.crashed:
            c.recover(rng.choice(sorted(c.crashed)))
        elif action < 0.25:
            a = rng.sample(c.ids, 2)
            c.partition([a[0]], [a[1]])
        elif action < 0.3:
            c.heal()
        leaders = c.leaders()
        if leaders and rng.random() < 0.7:
            c.propose(rng.choice(leaders), {"op": proposed})
            proposed += 1
        c.run(1)
        # Safety invariant, checked every round: any two applied
        # sequences are prefix-compatible.
        seqs = sorted((c.applied[i] for i in c.ids), key=len)
        for a, b in zip(seqs, seqs[1:]):
            assert b[: len(a)] == a, f"divergent applied logs (seed {seed})"
    # Liveness after healing.
    c.heal()
    c.drop_rate = 0.0
    for i in sorted(c.crashed):
        c.recover(i)
    c.run(60)
    final = [c.applied[i] for i in c.ids]
    assert all(f == final[0] for f in final)


def test_raft_runner_threads_over_inproc_transport():
    """RaftRunner (real threads + transport) elects and replicates."""
    import time

    from ripplemq_tpu_torch.broker.hostraft import RaftRunner
    from ripplemq_tpu_torch.wire import InProcNetwork

    net = InProcNetwork()
    ids = [0, 1, 2]
    applied = {i: [] for i in ids}
    runners = {}
    for i in ids:
        node = RaftNode(i, ids, apply_fn=lambda idx, cmd, i=i: applied[i].append(cmd),
                        seed=11)
        runner = RaftRunner(
            node, net.client(f"b{i}"), addr_of=lambda d: f"b{d}",
            tick_interval_s=0.01, rpc_timeout_s=0.5,
        )
        net.register(f"b{i}", runner.handle_rpc)
        runners[i] = runner
    try:
        for r in runners.values():
            r.start()
        deadline = time.time() + 10
        leader = None
        while time.time() < deadline:
            leaders = [i for i in ids if runners[i].node.role == LEADER]
            if len(leaders) == 1:
                leader = leaders[0]
                break
            time.sleep(0.02)
        assert leader is not None, "no leader within 10s"
        assert runners[leader].propose({"op": "hello"}) is not None
        deadline = time.time() + 10
        while time.time() < deadline:
            if all(applied[i] == [{"op": "hello"}] for i in ids):
                break
            time.sleep(0.02)
        assert all(applied[i] == [{"op": "hello"}] for i in ids)
    finally:
        for r in runners.values():
            r.stop()


def test_stale_snapshot_does_not_roll_back_or_reapply():
    """A delayed InstallSnapshot arriving after the follower has committed
    past it must be ignored (no state rollback, no double-apply)."""
    applied = []
    n = RaftNode(1, [0, 1, 2], apply_fn=lambda idx, cmd: applied.append((idx, cmd)))
    for k in range(1, 6):
        n.handle({"type": "raft.append", "term": 1, "leader": 0,
                  "prev_index": k - 1, "prev_term": 1 if k > 1 else 0,
                  "entries": [{"term": 1, "cmd": {"op": k}}], "commit": k})
    assert [idx for idx, _ in applied] == [1, 2, 3, 4, 5]
    before = list(applied)
    resp = n.handle({"type": "raft.snapshot", "term": 1, "leader": 0,
                     "last_index": 3, "last_term": 1, "state": ["stale"]})
    assert resp["success"] and resp["match_index"] == 5
    assert applied == before  # nothing re-applied
    assert n.last_applied == 5 and n.commit_index == 5


def test_snapshot_reply_never_regresses_match_index():
    c = Cluster(3, seed=12)
    leader = c.elect()
    n = c.nodes[leader]
    peer = n.peers[0]
    n.match_index[peer] = 30
    n.next_index[peer] = 31
    n.on_reply(peer, {"type": "raft.snapshot"}, 
               {"ok": True, "type": "raft.snapshot", "term": n.term,
                "success": True, "match_index": 20})
    assert n.match_index[peer] == 30 and n.next_index[peer] == 31


# --------------------------------------- differential: the JAX package


def _raft_view(c, state):
    return {
        "leaders": c.leaders(),
        "nodes": [(n.role, n.term, n.voted_for, n.commit_index,
                   n.last_applied, n.snap_last_index, n.last_index())
                  for n in (c.nodes[i] for i in c.ids)],
        "applied": [list(c.applied[i]) for i in c.ids],
        "state": [list(state[i]) for i in c.ids],
        "inflight": len(c.inflight),
    }


@pytest.mark.parametrize("seed", range(3))
def test_seeded_schedule_matches_the_reference(seed):
    """Differential, exact: one seed and one fault schedule (message
    drops, a partition, a crash and its recovery, log compaction with a
    snapshot install) through the reference harness and the port's. The
    port's RaftNode draws from its `random.Random` where and as often as
    the reference's, so every node's role, term, vote, commit index,
    snapshot point, log end, applied log and state machine are equal
    after every step."""
    import random

    from tests import raft_harness as ref_harness
    from tests import torch_raft_harness

    clusters, states = [], []
    for mod in (ref_harness, torch_raft_harness):
        c = mod.Cluster(5, seed=seed, compact_threshold=6)
        state = {i: [] for i in c.ids}
        for i in c.ids:
            node = c.nodes[i]
            node.snapshot_fn = lambda i=i, s=state: list(s[i])
            node.restore_fn = (lambda snap, i=i, s=state:
                               (s[i].clear(), s[i].extend(snap)))
            node.apply_fn = (lambda idx, cmd, i=i, s=state, c=c:
                             (s[i].append(cmd["op"]),
                              c.applied[i].append((idx, cmd))))
        clusters.append(c)
        states.append(state)
    ref, port = clusters
    rng = random.Random(seed * 31 + 5)
    proposed = 0
    victim = None
    for step in range(90):
        actions = []
        if step == 15:
            actions.append(("drop", 0.15))
        if step == 30:
            actions.append(("drop", 0.0))
            a, b = rng.sample(ref.ids, 2)
            actions.append(("partition", [a], [b]))
        if step == 40:
            actions.append(("heal",))
        if step == 45:
            leaders = ref.leaders()
            victim = leaders[0] if leaders else 0
            actions.append(("crash", victim))
        if step == 70:
            actions.append(("recover", victim))
        for act in actions:
            for c in clusters:
                if act[0] == "drop":
                    c.drop_rate = act[1]
                elif act[0] == "partition":
                    c.partition(act[1], act[2])
                elif act[0] == "heal":
                    c.heal()
                elif act[0] == "crash":
                    c.crash(act[1])
                else:
                    c.recover(act[1])
        leaders = ref.leaders()
        if leaders and rng.random() < 0.8:
            who = rng.choice(leaders)
            got = [c.propose(who, {"op": proposed}) for c in clusters]
            assert got[0] == got[1]
            proposed += 1
        for c in clusters:
            c.run(1)
        assert _raft_view(port, states[1]) == _raft_view(ref, states[0]), (
            f"diverged at step {step} (seed {seed})")
    # The schedule did compact and install a snapshot on the victim.
    assert max(n.snap_last_index for n in port.nodes.values()) > 0
    assert port.nodes[victim].snap_last_index > 0

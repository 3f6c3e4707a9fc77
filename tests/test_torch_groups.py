"""Consumer groups in the port: the twin of the unit tests of
`tests/test_groups.py` (assignment determinism and stickiness, the
coordinator's group table, heartbeat eviction), run on the port's
`groups.state` and `groups.coordinator`, and the package's lazy
re-exports of the client SDK. The cluster tests of that file are in
`tests/test_torch_group_cluster.py`.
"""

from __future__ import annotations

import pytest

import ripplemq_tpu_torch.groups as groups
from ripplemq_tpu_torch.groups.coordinator import GroupLiveness, GroupTable
from ripplemq_tpu_torch.groups.state import compute_assignment
from tests.torch_port_modules import admit

admit(__name__)


# -------------------------------------------------- assignment function


def test_assignment_is_balanced_and_deterministic():
    members = {"a": ("t",), "b": ("t",), "c": ("t",)}
    parts = {"t": 6}
    out = compute_assignment(members, parts)
    assert out == compute_assignment(members, parts)  # pure function
    sizes = {m: len(k) for m, k in out.items()}
    assert sizes == {"a": 2, "b": 2, "c": 2}
    union = [k for keys in out.values() for k in keys]
    assert sorted(union) == [("t", p) for p in range(6)]  # disjoint cover


def test_assignment_is_sticky_under_churn():
    parts = {"t": 6}
    two = compute_assignment({"a": ("t",), "b": ("t",)}, parts)
    three = compute_assignment(
        {"a": ("t",), "b": ("t",), "c": ("t",)}, parts, previous=two
    )
    # Cooperative: each incumbent keeps its (now reduced) quota — at
    # most one partition moves per incumbent, never a full reshuffle.
    for m in ("a", "b"):
        kept = set(three[m]) & set(two[m])
        assert len(kept) == len(three[m]), (two, three)
    assert len(three["c"]) == 2


def test_assignment_respects_subscriptions():
    out = compute_assignment(
        {"a": ("t1",), "b": ("t2",), "c": ("t1", "t2")},
        {"t1": 2, "t2": 2},
    )
    assert all(k[0] == "t1" for k in out["a"])
    assert all(k[0] == "t2" for k in out["b"])
    union = sorted(k for keys in out.values() for k in keys)
    assert union == [("t1", 0), ("t1", 1), ("t2", 0), ("t2", 1)]


# ----------------------------------------------------------- group table


def test_group_table_generations_and_idempotent_join():
    t = GroupTable()
    parts = {"t": 4}
    st, changed = t.join("g", "m1", ("t",), parts)
    assert changed and st.generation == 1
    st, changed = t.join("g", "m2", ("t",), parts)
    assert changed and st.generation == 2
    # Re-join with the same subscription: a retried/duplicated proposal
    # must NOT churn the generation.
    st, changed = t.join("g", "m2", ("t",), parts)
    assert not changed and st.generation == 2
    st, changed, emptied = t.leave("g", "m1", parts)
    assert changed and not emptied and st.generation == 3
    assert set(st.assignment["m2"]) == {("t", p) for p in range(4)}
    # An EMPTIED group is retained — generation monotone, identity
    # intact (a transient total-churn must not reset offsets); only an
    # explicit delete (the retention reap) drops it, and only while it
    # is still empty.
    st, changed, emptied = t.leave("g", "m2", parts)
    assert changed and emptied and t.state("g") is not None
    assert t.state("g").generation == 4 and t.empty_groups() == ["g"]
    st, changed = t.join("g", "m3", ("t",), parts)
    assert st.generation == 5  # never back to 1
    assert not t.delete("g")   # occupied: the rejoin won the race
    t.leave("g", "m3", parts)
    assert t.delete("g") and t.state("g") is None
    # Wire round-trip (snapshot/restore path).
    t.join("h", "x", ("t",), parts)
    t2 = GroupTable.from_wire(t.to_wire())
    assert t2.state("h").generation == 1
    assert t2.state("h").assignment == t.state("h").assignment


def test_liveness_grace_and_eviction():
    clock = [0.0]
    lv = GroupLiveness(clock=lambda: clock[0])
    t = GroupTable()
    t.join("g", "m1", ("t",), {"t": 2})
    t.join("g", "m2", ("t",), {"t": 2})
    # First sighting seeds the grace window — no day-zero evictions.
    assert lv.plan_evictions(t, 3.0) == []
    clock[0] = 2.0
    lv.beat("g", "m1")
    clock[0] = 4.0
    # m2 never beat (grace started at 0): evicted. m1 beat at 2: alive.
    assert lv.plan_evictions(t, 3.0) == [("g", "m2")]
    # Stamps for members gone from the table are pruned.
    t.leave("g", "m2", {"t": 2})
    assert lv.plan_evictions(t, 3.0) == []


@pytest.mark.parametrize("name", ["GroupConsumer", "FencedError"])
def test_client_reexports_name_slice_d2(name):
    """The client names that slice D2 ported: `groups.GroupConsumer` and
    `groups.FencedError` resolve (lazily) to the port's own objects in
    `groups/client.py`, never to the reference's."""
    from ripplemq_tpu_torch.groups import client

    obj = getattr(groups, name)
    assert obj is getattr(client, name)
    assert obj.__module__ == "ripplemq_tpu_torch.groups.client"
    if name == "GroupConsumer":
        import ripplemq_tpu_torch.client as client_pkg

        assert client_pkg.GroupConsumer is obj

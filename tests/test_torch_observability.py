"""The port's `admin.stats` schema lock: twin of
`tests/test_observability.py::test_admin_stats_schema_lock`.

The expected key-sets are DERIVED by the port's `stats_schema` rule
(`ripplemq_tpu_torch/analysis/stats_schema.py`: the AST of the port's
`_handle_stats`, `settle_stats` and group `summary` emit sites), not
hand-maintained here. The port's lint fails any emitted key that is
undocumented in the README schema section; THIS test asserts that a
live port broker's RPC response (a 3-broker in-proc cluster on the
CPU) matches the derived sets exactly, so a dynamically-added key the
AST cannot see still fails tier-1.
"""

from __future__ import annotations

from ripplemq_tpu_torch.analysis.stats_schema import derive_schema
from tests.torch_helpers import InProcCluster, make_config
from tests.torch_port_modules import admit

admit(__name__)

_SCHEMA = derive_schema()
STATS_TOP_KEYS = set(_SCHEMA.top)
STATS_ENGINE_KEYS = set(_SCHEMA.engine)
STATS_SETTLE_KEYS = set(_SCHEMA.settle)
STATS_GROUP_KEYS = set(_SCHEMA.group)


def test_admin_stats_schema_lock():
    with InProcCluster(make_config(3)) as c:
        c.wait_for_leaders()
        client = c.client()
        ctrl = next(b for b in c.brokers.values() if b.is_controller)
        front = next(b for b in c.brokers.values() if not b.is_controller)
        stats = client.call(ctrl.addr, {"type": "admin.stats"}, timeout=5.0)
        assert set(stats) == STATS_TOP_KEYS, (
            f"admin.stats top-level schema drifted: "
            f"{set(stats) ^ STATS_TOP_KEYS}"
        )
        assert set(stats["engine"]) == STATS_ENGINE_KEYS, (
            f"admin.stats engine schema drifted: "
            f"{set(stats['engine']) ^ STATS_ENGINE_KEYS}"
        )
        assert set(stats["engine"]["settle"]) == STATS_SETTLE_KEYS
        assert set(stats["metadata"]) == {"role", "term", "leader_hint"}
        assert set(stats["controller"]) == {"id", "epoch", "standbys",
                                            "is_self"}
        # Group entries are exact-keyed too (empty dict when no groups
        # exist; populated shape pinned by registering one member).
        assert stats["groups"] == {}
        assert isinstance(stats["producer_ids"], int)
        assert stats["dirty_consumer_slots"] == []
        # Striped-replication surface: a full-copy cluster
        # advertises the mode with an empty holder map and zero
        # rebuilds; value shapes pinned here, striped values by
        # tests/test_torch_stripes_cluster.py.
        assert stats["stripe_mode"] == "full"
        assert stats["stripe_holders"] == [] or all(
            isinstance(b, int) for b in stats["stripe_holders"]
        )
        assert stats["stripe_rebuilds"] == 0
        resp = client.call(
            ctrl.addr,
            {"type": "group.join", "group": "schema-g", "member": "m0",
             "topics": ["topic1"]},
            timeout=10.0,
        )
        assert resp["ok"], resp
        stats = client.call(ctrl.addr, {"type": "admin.stats"},
                            timeout=5.0)
        assert set(stats["groups"]) == {"schema-g"}
        assert set(stats["groups"]["schema-g"]) == STATS_GROUP_KEYS
        assert stats["groups"]["schema-g"]["generation"] == 1
        assert stats["groups"]["schema-g"]["members"] == ["m0"]
        # `slots` is additive (request-gated), not schema drift.
        detail = client.call(ctrl.addr,
                             {"type": "admin.stats", "slots": [0]},
                             timeout=5.0)
        assert set(detail["engine"]) == STATS_ENGINE_KEYS | {"slots"}
        assert set(detail["engine"]["slots"]["0"]) == {"commit", "log_end",
                                                       "trim"}
        fstats = client.call(front.addr, {"type": "admin.stats"},
                             timeout=5.0)
        assert set(fstats) == STATS_TOP_KEYS and fstats["engine"] is None

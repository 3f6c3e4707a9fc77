"""Whole-cluster cold restart: every broker goes down, the cluster
reboots from its durable stores, and every acked message survives.

The per-broker kill/restart paths are covered by the fault soaks; this
is the full-outage scenario — no survivor holds any state in memory, so
recovery rests entirely on store replay (dataplane.recover_image),
metadata restore (MetaStore), and the bootstrap fixpoint re-running on
recovered state. The reference's analogue is restarting its whole
docker-compose cluster over JRaft's durable logs (SURVEY.md §5
checkpoint/resume).

Twin of `tests/test_cold_restart.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.test_torch_soak import _drain, _produce, wait_until
from tests.test_torch_soak_random import _cluster_healthy
from tests.torch_helpers import port_cfg
from tests.torch_port_modules import admit

admit(__name__)


def test_cold_restart_recovers_everything(tmp_path):
    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 2, 3),),
        # Small ring: the pre-outage history wraps it, so recovery must
        # replay a wrapped store and serve the below-trim prefix from
        # the recovered segments.
        engine=port_cfg(partitions=2, replicas=3, slots=64, max_batch=8),
        standby_count=2,
    )
    sent = {0: [], 1: []}
    with InProcCluster(config, data_dir=tmp_path) as c1:
        c1.wait_for_leaders()
        client = c1.client()
        for i in range(120):  # 60 rounds/partition through 64-slot rings
            pid = i % 2
            payload = b"cold-%d-%04d" % (pid, i)
            _produce(c1, client, "t", pid, payload)
            sent[pid].append(payload)
        ctrl = c1.brokers[0].manager.current_controller()
        assert int(c1.brokers[ctrl].dataplane.trim.max()) > 0, (
            "rings never wrapped pre-outage"
        )
    # Everything is down. A NEW cluster object (fresh processes in
    # spirit) boots from the same data dirs.
    with InProcCluster(config, data_dir=tmp_path) as c2:
        assert wait_until(lambda: _cluster_healthy(c2), timeout=120), (
            "cluster never recovered from cold restart"
        )
        client = c2.client()
        for pid in (0, 1):
            got = _drain(c2, client, "t", pid, f"cold-check-{pid}")
            assert got == sent[pid], (
                f"p{pid}: {len(got)} of {len(sent[pid])} messages after "
                f"cold restart; first missing "
                f"{sorted(set(sent[pid]) - set(got))[:3]}"
            )

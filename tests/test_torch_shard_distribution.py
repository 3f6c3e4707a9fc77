"""Distributed erasure shards: sealed-segment RS shards pushed to peer
brokers, and a broker whose disk lost BOTH a sealed segment and its
local shards rebuilding it from peers on boot.

The reference survives broker-disk loss only through full per-broker
replication (reference: mq-broker/src/main/java/metadata/raft/
PartitionRaftServer.java:88-90); the distributed shard sets give the
same any-K-of-(K+M) durability at 5/3x overhead.

Twin of `tests/test_shard_distribution.py` on the PyTorch port: the RS
work on the CPU (`device="cpu"`), the brokers CPU brokers.
"""

from __future__ import annotations

import os
import shutil

from ripplemq_tpu_torch.metadata.models import Topic
from ripplemq_tpu_torch.storage.erasure import (
    K,
    M,
    protect_store,
    refill_from_peers,
    repair_store,
    shard_file_names,
    valid_shard_name,
)
from ripplemq_tpu_torch.storage.segment import SegmentStore, scan_store
from ripplemq_tpu_torch.wire.transport import InProcNetwork
from tests.torch_helpers import make_config
from tests.torch_helpers import port_cfg, wait_until
from tests.torch_port_modules import admit

admit(__name__)

CPU = {"device": "cpu"}


def _fill_store(store_dir, records=40, payload=2000):
    store = SegmentStore(store_dir, segment_bytes=8192)
    for i in range(records):
        store.append(1, 0, i, bytes([i % 251]) * payload)
    store.flush()
    store.close()
    return [(t, s, b, p) for t, s, b, p in scan_store(store_dir)]


def test_refill_from_peers_rebuilds_lost_segment(tmp_path):
    """Component level: owner loses a sealed segment AND its rs/ dir;
    shards held by two 'peers' refill the set and repair_store rebuilds
    the segment byte-for-byte."""
    owner = str(tmp_path / "owner")
    before = _fill_store(owner)
    sealed = protect_store(owner, **CPU)
    assert sealed, "no sealed segments were produced"

    # Distribute: peer A holds shards 0..2, peer B holds 2..4.
    peers = {"A": str(tmp_path / "peerA"), "B": str(tmp_path / "peerB")}
    for d in peers.values():
        os.makedirs(d)
    for name in shard_file_names(owner):
        assert valid_shard_name(name)
        idx = int(name.rpartition(".shard")[2])
        src = os.path.join(owner, "rs", name)
        if idx <= 2:
            shutil.copy(src, os.path.join(peers["A"], name))
        if idx >= 2:
            shutil.copy(src, os.path.join(peers["B"], name))

    # Disaster: a sealed segment and ALL local shards vanish.
    victim = sealed[0]
    os.remove(os.path.join(owner, victim))
    shutil.rmtree(os.path.join(owner, "rs"))

    def mk_list(d):
        return lambda: sorted(os.listdir(d))

    def get(d, name):
        with open(os.path.join(d, name), "rb") as f:
            return f.read()

    refilled = refill_from_peers(
        owner, [(d, mk_list(d)) for d in peers.values()], get
    )
    assert victim in refilled
    repaired = repair_store(owner, **CPU)
    assert victim in repaired
    assert [(t, s, b, p) for t, s, b, p in scan_store(owner)] == before


def test_refill_rejects_unsafe_and_corrupt_shards(tmp_path):
    owner = str(tmp_path / "owner")
    _fill_store(owner)
    protect_store(owner, **CPU)
    names = shard_file_names(owner)
    good = {n: open(os.path.join(owner, "rs", n), "rb").read() for n in names}
    victim = names[0].rpartition(".shard")[0]
    os.remove(os.path.join(owner, victim))
    shutil.rmtree(os.path.join(owner, "rs"))

    evil = {
        "../../etc/passwd.shard0": b"x",
        "segment-99999999.log.shard9": b"x",  # index out of range
    }
    corrupt = {names[0]: b"\x00" * 64}  # fails shard CRC
    listing = list(evil) + list(corrupt) + list(good)

    def get(_peer, name):
        return {**evil, **corrupt, **good}[name]

    refilled = refill_from_peers(owner, [("p", lambda: listing)], get)
    assert victim in refilled
    # The corrupt copy of shard0 must have been rejected, then the good
    # copy (later in the list) accepted — repair still succeeds.
    assert victim in repair_store(owner, **CPU)
    # Nothing escaped the rs/ dir.
    assert not os.path.exists(str(tmp_path / "etc"))


def test_broker_disk_loss_heals_from_peer_shards(tmp_path):
    """Integration: a 3-broker cluster distributes shards via the push
    duty; one broker's disk then loses a sealed segment + rs/; on reboot
    the broker refills from peers and its store scans complete again."""
    from ripplemq_tpu_torch.broker.server import BrokerServer

    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 1, 3),),
        engine=port_cfg(partitions=1, replicas=3, slots=4096,
                         slot_bytes=64, max_batch=8),
        segment_bytes=4096,  # seal quickly
        standby_count=0,  # isolate the shard path from stream replication
    )
    net = InProcNetwork()
    dirs = {i: str(tmp_path / f"b{i}") for i in range(3)}
    brokers = {
        i: BrokerServer(i, config, net=net, data_dir=dirs[i], device="cpu")
        for i in range(3)
    }
    for b in brokers.values():
        b.start()
    try:
        assert wait_until(
            lambda: all(
                b.manager.leader_of(("t", 0)) is not None
                for b in brokers.values()
            )
        ), "no leader elected"
        leader = brokers[0].manager.leader_of(("t", 0))
        client = net.client("test-client")
        for i in range(120):  # ~12 KB of records: several sealed segments
            resp = client.call(
                brokers[leader].addr,
                {"type": "produce", "topic": "t", "partition": 0,
                 "messages": [b"shard-%03d" % i + b"y" * 40]},
                timeout=10.0,
            )
            assert resp.get("ok"), resp

        ctrl = next(i for i, b in brokers.items() if b.is_controller)
        store_dir = brokers[ctrl]._store_dir
        brokers[ctrl]._round_store.flush()
        assert wait_until(
            lambda: len(protect_store(store_dir, **CPU)) == 0
            and len(shard_file_names(store_dir)) >= K + M
        ), "segments never sealed/protected"
        # Push duty distributed every shard to peers.
        assert wait_until(
            lambda: set(brokers[ctrl]._pushed_shards)
            >= set(shard_file_names(store_dir)),
            timeout=60,
        ), "shards never distributed to peers"
        before = [tuple(r) for r in scan_store(store_dir)]
        sealed = sorted(
            {n.rpartition(".shard")[0] for n in shard_file_names(store_dir)}
        )

        # Disaster on the controller's disk.
        brokers[ctrl].stop()
        victim = sealed[0]
        os.remove(os.path.join(store_dir, victim))
        shutil.rmtree(os.path.join(store_dir, "rs"))

        # Reboot: refill from the two live peers, repair, scan complete.
        reborn = BrokerServer(ctrl, config, net=net, data_dir=dirs[ctrl],
                              device="cpu")
        reborn.start()
        try:
            after = [tuple(r) for r in scan_store(store_dir)]
            assert after == before, (
                f"store incomplete after peer-shard heal: "
                f"{len(after)} vs {len(before)} records"
            )
        finally:
            reborn.stop()
    finally:
        for i, b in brokers.items():
            if i != ctrl:
                b.stop()

"""Lockstep failure drill on the port: twin of `tests/test_lockstep_drill.py`.

An engine-WORKER process dies mid-traffic. The controller drives one
spmd engine whose mesh spans OS processes (`parallel/lockstep.py`;
gloo on the CPU here). When the worker dies, the collective can never
complete — the plane is PERMANENTLY broken while the controller broker
itself is alive. The recovery chain:

  collective breaks → the plane fails loudly (adopted state, retryable
  `not_committed` to producers, `DataPlane.broken_reason` set) → the
  controller ABDICATES (manager.plan_abdication, epoch bump) → the
  fence duty releases the broken plane → a standby's takeover duty
  boots a fresh local plane from its copy of the committed-round
  stream → service resumes with ZERO settled-append loss.

As in the reference, the world is formed in a SUBPROCESS (a process
joins one world, which must not leak into the pytest process): one
orchestrator spawns the worker, joins the world, runs a 3-broker
in-proc cluster (on the CPU) whose controller drives the lockstep
plane, kills the worker with SIGKILL mid-traffic, and asserts recovery
and readback.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

from tests.torch_port_modules import admit

admit(__name__)

# Tier-1 runs with -m 'not slow' (ROADMAP.md), as the reference's drill.
pytestmark = pytest.mark.slow


_ORCHESTRATOR = """
import os, signal, socket, subprocess, sys, tempfile, time
sys.path.insert(0, {repo!r})

coord_port, worker_port = {coord_port}, {worker_port}
worker = subprocess.Popen(
    [sys.executable, "-m", "ripplemq_tpu_torch.parallel.worker",
     "--coordinator", "127.0.0.1:%d" % coord_port, "--num-hosts", "2",
     "--host-index", "1", "--listen-host", "127.0.0.1",
     "--listen-port", str(worker_port), "--device", "cpu",
     "--timeout-s", "30"],
    env=dict(os.environ),
)
from ripplemq_tpu_torch.parallel.mesh import init_distributed
n = init_distributed("127.0.0.1:%d" % coord_port, 2, 0, device="cpu",
                     timeout_s=30.0)
assert n == 2, n

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config, port_cfg

config = make_config(
    n_brokers=3,
    topics=(Topic("t", 2, 2),),
    engine=port_cfg(partitions=4, replicas=2, slots=256),
    metadata_election_timeout_s=0.6,
    standby_count=2,
)
tmp = tempfile.mkdtemp(prefix="rmq-drill-")
c = InProcCluster(
    config, data_dir=tmp,
    broker_kwargs={{0: {{"engine_mode": "spmd",
                         "engine_workers": ["127.0.0.1:%d" % worker_port]}}}},
)

def wait_until(pred, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False

def produce(client, pid, payload, timeout=90.0):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        b = next(iter(c.brokers.values()))
        leader = b.manager.leader_of(("t", pid))
        if leader is None:
            time.sleep(0.05); continue
        try:
            resp = client.call(
                c.brokers[leader].addr,
                {{"type": "produce", "topic": "t", "partition": pid,
                  "messages": [payload]}}, timeout=10.0)
        except Exception as e:
            last = e; time.sleep(0.05); continue
        if resp.get("ok"):
            return
        last = resp
        time.sleep(0.05)
    raise AssertionError("produce never succeeded: %r" % (last,))

with c:
    c.wait_for_leaders()
    assert wait_until(
        lambda: len(c.brokers[0].manager.current_standbys()) >= 2
    ), "standby set never formed"
    client = c.client()
    settled = []
    for i in range(12):
        m = b"pre-%03d" % i
        produce(client, i % 2, m)
        settled.append((i % 2, m))
    # The controller is driving a REAL cross-process lockstep plane.
    assert c.brokers[0].dataplane is not None
    assert c.brokers[0].dataplane.broken_reason is None

    # Kill the engine worker mid-traffic: produce concurrently so some
    # round is in flight when the mesh breaks. Every SUCCESSFUL mid-kill
    # produce is recorded into `settled` — an ack is a settlement claim
    # regardless of when it lands, and an append acked just before/as
    # the mesh breaks then lost across abdication is exactly the
    # regression this drill exists to catch.
    import threading
    killed = threading.Event()
    def traffic():
        i = 100
        while not killed.is_set():
            m = b"mid-%03d" % i
            try:
                produce(client, i % 2, m, timeout=5.0)
                settled.append((i % 2, m))
            except Exception:
                pass
            i += 1
    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    time.sleep(0.3)
    os.kill(worker.pid, signal.SIGKILL)
    worker.wait(timeout=30)

    # The drill chain: broken_reason set -> abdication (controller
    # moves off broker 0) -> broker 0's plane released -> a standby
    # boots the plane.
    assert wait_until(
        lambda: c.brokers[0].manager.current_controller() != 0
    ), "broken controller never abdicated"
    new_ctrl = c.brokers[0].manager.current_controller()
    assert new_ctrl in (1, 2), new_ctrl
    assert wait_until(lambda: c.brokers[0].dataplane is None), (
        "broken plane never released")
    assert wait_until(
        lambda: c.brokers[new_ctrl].dataplane is not None
    ), "promoted standby never booted the plane"
    killed.set()
    t.join(timeout=30)

    # Service restored: fresh produces settle on the promoted plane.
    for i in range(6):
        m = b"post-%03d" % i
        produce(client, i % 2, m)
        settled.append((i % 2, m))

    # ZERO settled-append loss: every payload acked before, DURING
    # (traffic() records each successful mid-kill ack into `settled`),
    # and after the kill is readable through the promoted plane.
    for pid in (0, 1):
        got = []
        for _ in range(200):
            resp = client.call(
                c.brokers[c.brokers[0].manager.leader_of(("t", pid))].addr,
                {{"type": "consume", "topic": "t", "partition": pid,
                  "consumer": "drill", "max_messages": 64}}, timeout=30.0)
            assert resp["ok"], resp
            if not resp["messages"]:
                break
            got.extend(resp["messages"])
            resp2 = client.call(
                c.brokers[c.brokers[0].manager.leader_of(("t", pid))].addr,
                {{"type": "offset.commit", "topic": "t", "partition": pid,
                  "consumer": "drill", "offset": resp["next_offset"]}},
                timeout=30.0)
            assert resp2["ok"], resp2
        want = [m for p, m in settled if p == pid]
        missing = [m for m in want if m not in got]
        assert not missing, "settled appends lost: %r" % missing

print("DRILL_OK", flush=True)
os._exit(0)
"""


def test_lockstep_worker_death_recovers_via_abdication():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    env = dict(os.environ, PYTHONPATH=repo)
    orch = subprocess.Popen(
        [sys.executable, "-c", _ORCHESTRATOR.format(
            repo=repo, coord_port=ports[0], worker_port=ports[1])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out, err = orch.communicate(timeout=360)
    except subprocess.TimeoutExpired:
        # A wedged drill must not leak its process tree (orchestrator +
        # worker + brokers) into the rest of the run on the 1-core host.
        orch.kill()
        out, err = orch.communicate(timeout=30)
        raise AssertionError(f"drill orchestrator hung\n{err[-4000:]}")
    assert orch.returncode == 0, f"orchestrator rc={orch.returncode}\n{err[-5000:]}"
    assert "DRILL_OK" in out, (out, err[-2000:])


def test_boot_time_lockstep_failure_abdicates():
    """A controller whose lockstep plane cannot BOOT (worker dead when
    the plane is built — LockstepController's configure raises before a
    DataPlane exists, so the mid-call broken_reason path never engages)
    must also abdicate after a few consecutive boot failures, instead of
    retrying a doomed boot forever while holding controllership.

    Staged without jax.distributed: broker 1 is configured spmd with an
    unreachable engine worker; killing the healthy controller (broker 0)
    promotes broker 1, whose takeover boot fails repeatedly → it
    abdicates to broker 2, which restores service."""
    import socket as socketmod
    import time

    from ripplemq_tpu_torch.metadata.models import Topic
    from tests.test_torch_controller_failover import _produce, _wait_standbys
    from tests.torch_helpers import InProcCluster, make_config, port_cfg
    from tests.torch_helpers import wait_until

    s = socketmod.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()  # nothing listens here: configure fails fast

    config = make_config(
        n_brokers=3,
        topics=(Topic("t", 1, 3),),
        engine=port_cfg(partitions=1, replicas=3, slots=256),
        metadata_election_timeout_s=0.6,
        standby_count=2,
    )
    import tempfile
    with tempfile.TemporaryDirectory(prefix="rmq-bootfail-") as tmp:
        with InProcCluster(
            config, data_dir=tmp,
            broker_kwargs={1: {
                "engine_mode": "spmd",
                "engine_workers": [f"127.0.0.1:{dead_port}"],
            }},
        ) as c:
            c.wait_for_leaders()
            _wait_standbys(c, 2)
            client = c.client()
            _produce(c, client, "t", 0, b"pre-bootfail")
            c.kill(0)
            # Broker 1 (lowest standby) is promoted, fails its boots,
            # and must hand controllership on to broker 2.
            assert wait_until(
                lambda: c.brokers[2].manager.current_controller() == 2,
                timeout=120,
            ), "boot-failing promotee never abdicated to broker 2"
            assert wait_until(
                lambda: c.brokers[2].dataplane is not None, timeout=60
            ), "broker 2 never booted the plane"
            # Service restored; the pre-kill append survived.
            _produce(c, client, "t", 0, b"post-bootfail", dead={0})
            got = []
            for _ in range(100):
                resp = client.call(
                    c.brokers[c.brokers[2].manager.leader_of(("t", 0))].addr,
                    {"type": "consume", "topic": "t", "partition": 0,
                     "consumer": "bf"}, timeout=30.0)
                assert resp["ok"], resp
                if not resp["messages"]:
                    break
                got.extend(resp["messages"])
                client.call(
                    c.brokers[c.brokers[2].manager.leader_of(("t", 0))].addr,
                    {"type": "offset.commit", "topic": "t", "partition": 0,
                     "consumer": "bf", "offset": resp["next_offset"]},
                    timeout=30.0)
            assert b"pre-bootfail" in got and b"post-bootfail" in got, got

"""Multi-process SPMD on the port: twin of `tests/test_multihost.py`.

A replication round whose quorum `all_reduce` crosses OS process
boundaries (a gloo world on the CPU, one rank a mesh cell), and the
lockstep DataPlane driven across processes by a controller and its
engine workers.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

from tests.torch_port_modules import admit

admit(__name__)

# Tier-1 runs with -m 'not slow' (ROADMAP.md), as the reference's twin.
pytestmark = pytest.mark.slow


def test_two_process_spmd_round_commits():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ripplemq_tpu_torch.parallel.multihost_check",
             "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2",
             "--host-index", str(i), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        outs.append((p.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"host {i} rc={rc}\n{err[-3000:]}"
        assert "MULTIHOST_OK" in out, (out, err[-1500:])
        assert "devices=2" in out  # both processes joined one world


_CONTROLLER_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.parallel.mesh import init_distributed
from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore

n = init_distributed({coord!r}, 2, 0, device="cpu")
assert n == 2, n
cfg = EngineConfig(partitions=4, replicas=2, slots=64, slot_bytes=32,
                   max_batch=8, read_batch=8, max_consumers=8,
                   max_offset_updates=4)
dp = DataPlane(cfg, mode="spmd", store=MemoryRoundStore(),
               workers=[{worker!r}], device="cpu")
dp.start()
try:
    dp.set_leader(0, 0, 1)
    dp.set_leader(1, 1, 1)
    off = dp.submit_append(0, [b"mh-a", b"mh-b"]).result(timeout=180)
    assert off == 0, off
    msgs, nxt = dp.read(0, 0, replica=0)
    assert msgs == [b"mh-a", b"mh-b"], msgs
    assert dp.submit_offsets(0, [(1, nxt)]).result(timeout=60) is True
    assert dp.read_offset(0, 1, replica=0) == nxt
    won = dp.elect({{2: (0, 2)}})
    assert won[2], won
    # Cross-process state fetches (broadcast allgather — these hang if
    # the workers don't replay them).
    ends = dp.log_ends()
    assert ends.shape == (2, 4) and int(ends[:, 0].max()) == nxt, ends
    assert dp.commit_index(0) == nxt
    assert int(dp.current_terms()[2]) >= 2
finally:
    dp.stop()
print("LOCKSTEP_OK", flush=True)
# Leave without destroying the world: the worker process is a daemon
# that only exits on SIGTERM (the test sends it after reading this
# marker), so a shutdown barrier would deadlock the test.
os._exit(0)
"""


def test_lockstep_dataplane_across_processes():
    """The full broker data plane (batched rounds, reads, offset commits,
    elections) driven over a mesh spanning two OS processes: the
    controller broadcasts its engine-call stream to an engine worker and
    every collective crosses the process boundary."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord_port = s.getsockname()[1]
    s2 = socket.socket()
    s2.bind(("127.0.0.1", 0))
    worker_port = s2.getsockname()[1]
    s.close()
    s2.close()
    env = dict(os.environ, PYTHONPATH=repo)
    worker = subprocess.Popen(
        [sys.executable, "-m", "ripplemq_tpu_torch.parallel.worker",
         "--coordinator", f"127.0.0.1:{coord_port}", "--num-hosts", "2",
         "--host-index", "1", "--listen-host", "127.0.0.1",
         "--listen-port", str(worker_port), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    controller = subprocess.Popen(
        [sys.executable, "-c", _CONTROLLER_SCRIPT.format(
            repo=repo, coord=f"127.0.0.1:{coord_port}",
            worker=f"127.0.0.1:{worker_port}",
        )],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        try:
            out, err = controller.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            controller.kill()  # a hung controller must not leak
            out, err = controller.communicate(timeout=30)
            raise AssertionError(f"controller hung\n{err[-4000:]}")
        assert controller.returncode == 0, f"controller rc:\n{err[-4000:]}"
        assert "LOCKSTEP_OK" in out, (out, err[-1500:])
    finally:
        worker.terminate()
        wout, werr = worker.communicate(timeout=30)
    assert "WORKER_READY" in wout, (wout, werr[-1500:])


_SCALE_CONTROLLER_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.parallel.mesh import init_distributed
from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore

n = init_distributed({coord!r}, 5, 0, device="cpu")
assert n == 5, n
cfg = EngineConfig(partitions=5, replicas=5, slots=64, slot_bytes=32,
                   max_batch=8, read_batch=8, max_consumers=8,
                   max_offset_updates=4)
dp = DataPlane(cfg, mode="spmd", store=MemoryRoundStore(),
               workers={workers!r}, device="cpu")
dp.start()
try:
    for p in range(3):
        dp.set_leader(p, 0, 1)
    # Interleave the full engine-call vocabulary so the 5-process
    # broadcast stream exercises ordering at scale, not just one round.
    off = dp.submit_append(0, [b"s-a", b"s-b"]).result(timeout=240)
    assert off == 0, off
    futs = [dp.submit_append(p, [b"s-%d" % p]) for p in (1, 2)]
    for f in futs:
        f.result(timeout=240)
    msgs, nxt = dp.read(0, 0, replica=0)
    assert msgs == [b"s-a", b"s-b"], msgs
    assert dp.submit_offsets(0, [(1, nxt)]).result(timeout=120) is True
    assert dp.read_offset(0, 1, replica=0) == nxt
    won = dp.elect({{3: (1, 2)}})
    assert won[3], won
    ends = dp.log_ends()
    assert ends.shape == (5, 5) and int(ends[:, 0].max()) == nxt, ends
    assert dp.commit_index(0) == nxt
finally:
    dp.stop()
print("SCALE_OK", flush=True)
os._exit(0)
"""


def test_lockstep_four_workers():
    """The control stream at dryrun scale (VERDICT r4 weak-#7): one
    LockstepController broadcasting to FOUR engine-worker processes —
    a 5-process world, one rank a replica — through the full engine-call
    vocabulary (chained appends, reads, offset commits, elections,
    state fetches). The 2-process test proves the mechanism; this
    proves the ordering and rendezvous hold at the multi-worker scale
    the broadcast fan-out actually faces."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n_workers = 4
    ports = []
    for _ in range(1 + n_workers):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    coord_port, worker_ports = ports[0], ports[1:]
    env = dict(os.environ, PYTHONPATH=repo)
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "ripplemq_tpu_torch.parallel.worker",
             "--coordinator", f"127.0.0.1:{coord_port}", "--num-hosts", "5",
             "--host-index", str(i + 1), "--listen-host", "127.0.0.1",
             "--listen-port", str(worker_ports[i]), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(n_workers)
    ]
    controller = subprocess.Popen(
        [sys.executable, "-c", _SCALE_CONTROLLER_SCRIPT.format(
            repo=repo, coord=f"127.0.0.1:{coord_port}",
            workers=[f"127.0.0.1:{p}" for p in worker_ports],
        )],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        try:
            out, err = controller.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            controller.kill()  # a hung controller must not leak
            out, err = controller.communicate(timeout=30)
            raise AssertionError(f"controller hung\n{err[-4000:]}")
        assert controller.returncode == 0, f"controller rc:\n{err[-4000:]}"
        assert "SCALE_OK" in out, (out, err[-1500:])
    finally:
        wouts = []
        for w in workers:
            w.terminate()
        for w in workers:
            wout, werr = w.communicate(timeout=30)
            wouts.append((wout, werr))
    for i, (wout, werr) in enumerate(wouts):
        assert "WORKER_READY" in wout, (i, wout, werr[-1500:])

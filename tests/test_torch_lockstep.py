"""The port's lockstep call stream (`parallel/lockstep.py`) and its
transport.

- The in-order repair: a worker's server hands each frame to a pool, so
  a pipelined call n+1 can reach the worker before call n took its
  turn; the worker waits for its turn instead of refusing the early
  frame (the reference refuses any number but the expected one, which
  breaks the plane). Duplicates and gaps are still refused. A call
  past the piece size travels in several frames and runs once.
- `enc_value` / `dec_value`: a seeded call stream encodes through both
  packages' `enc_value` and wire codec into identical bytes.
- `wire.transport.connect` refuses a socket connected to itself.
- Across processes on the CPU (gloo): a two-rank `multihost_check`
  round, and a lockstep DataPlane driven over a worker process, then
  broken by the worker's SIGKILL — the plane must raise, not hang, and
  report `broken_reason`.
"""

from __future__ import annotations

import errno
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ripplemq_tpu.core.encode import build_step_input
from ripplemq_tpu.parallel import lockstep as ref_lockstep
from ripplemq_tpu.wire import codec as ref_codec
from ripplemq_tpu_torch.parallel import lockstep
from ripplemq_tpu_torch.wire import codec
from ripplemq_tpu_torch.wire.transport import TcpClient, TcpServer, connect
from tests.helpers import small_cfg
from tests.torch_port_modules import admit
from tests.torch_spmd_world import REPO, free_port, run_controller, start_worker

admit(__name__)


class _Recording(lockstep.LockstepWorker):
    """Executes nothing but records each call's tag; the call tagged
    `slow` holds its turn for a while."""

    def __init__(self, slow: int, **kw) -> None:
        super().__init__(**kw)
        self.slow = slow
        self.order: list[int] = []

    def _execute(self, method, args):
        if args[0] == self.slow:
            time.sleep(0.4)
        self.order.append(int(args[0]))


def _frame(seq: int, tag: int) -> dict:
    return {"type": lockstep.LOCKSTEP_TYPE, "seq": seq, "method": "tag",
            "args": [lockstep.enc_value(tag)]}


def test_pipelined_stream_replays_in_order_when_a_handler_is_delayed():
    N, slow = 24, 3
    worker = _Recording(slow)
    server = TcpServer("127.0.0.1", 0, worker.handle)
    server.start()
    client = TcpClient()
    try:
        addr = f"127.0.0.1:{server.port}"
        futs = [client.call_async(addr, _frame(i, i)) for i in range(1, N + 1)]
        resps = [f.result(timeout=30) for f in futs]
    finally:
        client.close()
        server.stop()
    assert all(r.get("ok") for r in resps), [r for r in resps if not r.get("ok")]
    assert worker.order == list(range(1, N + 1))
    assert worker.expected_seq == N + 1


class _Echo:
    """The controller's stand-in engine: every call returns its args."""

    mesh = None

    def __getattr__(self, name):
        return lambda *args: args


class _Keeping(lockstep.LockstepWorker):
    """Executes nothing but keeps each call's method and arguments."""

    def __init__(self) -> None:
        super().__init__()
        self.calls = []

    def _execute(self, method, args):
        self.calls.append((method, args))


def test_an_oversized_call_travels_in_pieces(monkeypatch):
    """A call whose arrays pass the piece size goes out as several
    frames; the worker runs it once, with the arguments intact, in its
    turn between the calls around it."""
    monkeypatch.setattr(lockstep, "PIECE_BYTES", 1000)
    rng = np.random.default_rng(3)
    big = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in (1500, 4000)]
    small = np.arange(4, dtype=np.int32)
    req = {"type": lockstep.LOCKSTEP_TYPE, "seq": 1, "method": "read_many",
           "args": [lockstep.enc_value(a) for a in big + [small]]}
    assert len(lockstep._pieces(req)) > 5
    worker = _Keeping()
    server = TcpServer("127.0.0.1", 0, worker.handle)
    server.start()
    client = TcpClient()
    try:
        ctrl = lockstep.LockstepController(
            _Echo(), small_cfg(), 1, [f"127.0.0.1:{server.port}"], client)
        ctrl.read_offset(None, 0, 1, 2)
        ctrl.read_many(None, *big, small)
        ctrl.read_offset(None, 3, 4, 5)
        assert ctrl.broken is None
    finally:
        client.close()
        server.stop()
    assert [m for m, _ in worker.calls] == [
        "configure", "read_offset", "read_many", "read_offset"]
    got = worker.calls[2][1]
    for a, b in zip(big + [small], got):
        np.testing.assert_array_equal(a, b)
    assert worker._pieces == {}


def test_duplicates_and_gaps_are_refused():
    worker = _Recording(slow=-1, gap_timeout_s=0.3)
    assert worker.handle(_frame(1, 1))["ok"]
    dup = worker.handle(_frame(1, 1))
    assert not dup["ok"] and "got seq 1, expected 2" in dup["error"]
    t0 = time.monotonic()
    gap = worker.handle(_frame(3, 3))  # seq 2 never comes
    assert not gap["ok"] and "got seq 3, expected 2" in gap["error"]
    assert time.monotonic() - t0 >= 0.3
    assert worker.order == [1]


def _seeded_calls(seed: int) -> list:
    rng = np.random.default_rng(seed)
    cfg = small_cfg(partitions=8, replicas=3)
    calls = []
    for _ in range(6):
        parts = rng.choice(8, size=3, replace=False)
        inp = build_step_input(
            cfg, appends={int(p): [bytes(rng.integers(0, 256, size=5,
                                                      dtype=np.uint8))]
                          for p in parts}, leader=0, term=1)
        ids = np.full((4,), -1, np.int32)
        ids[:3] = np.sort(parts)
        calls.append(["step_sparse", [
            inp, rng.integers(0, 256, size=(4, 8, 32), dtype=np.uint8), ids,
            rng.random((8, 3)) < 0.8, np.full((8,), 2, np.int32), None]])
    calls.append(["vote", [np.arange(8, dtype=np.int32) % 3,
                           np.full((8,), 2, np.int32), np.ones(3, bool), None]])
    calls.append(["resync", [np.int32(0), np.int32(2),
                             rng.random(8) < 0.5]])
    calls.append(["read_many", [rng.integers(0, 3, 5).astype(np.int64),
                                rng.integers(0, 8, 5).astype(np.int32),
                                rng.integers(0, 64, 5).astype(np.int32)]])
    calls.append(["read", [1, 7, 0]])
    calls.append(["fetch_state", ["commit"]])
    calls.append(["configure", [{"partitions": 8, "fused_control": True}, 2]])
    return calls


def test_enc_value_matches_the_reference_bytes():
    for seq, (method, args) in enumerate(_seeded_calls(5), start=1):
        def frame(enc):
            return {"type": "engine.lockstep", "seq": seq, "method": method,
                    "args": [enc(a) for a in args]}

        ref = ref_codec.encode(frame(ref_lockstep.enc_value))
        port = codec.encode(frame(lockstep.enc_value))
        assert port == ref, method
        # The port decodes the reference's frame to the same values.
        back = [lockstep.dec_value(a) for a in codec.decode(ref)["args"]]
        want = [ref_lockstep.dec_value(a)
                for a in ref_codec.decode(ref)["args"]]
        assert repr(back) == repr(want), method
    # A tensor encodes as its host copy: the numpy array's bytes.
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert (codec.encode(lockstep.enc_value(torch.from_numpy(x)))
            == ref_codec.encode(ref_lockstep.enc_value(x)))


def _on_a_free_port(dial):
    """`dial(port)` on a fresh free port, retried while the port is taken
    before the dial binds it."""
    for _ in range(10):
        port = free_port()
        try:
            return dial(port)
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
    pytest.fail("no free port to stage a self-connect on")


def test_tcp_client_refuses_a_self_connect():
    """A client socket bound to port X dialing 127.0.0.1:X with nothing
    listening connects to itself (TCP simultaneous open): the raw
    connect shows it, `connect` refuses it."""
    def raw(port):
        with socket.create_connection(("127.0.0.1", port), timeout=2,
                                      source_address=("127.0.0.1", port)) as s:
            return s.getsockname() == s.getpeername()

    assert _on_a_free_port(raw)
    with pytest.raises(ConnectionRefusedError, match="its own socket"):
        _on_a_free_port(lambda port: connect(
            "127.0.0.1", port, 2.0, source_address=("127.0.0.1", port)))


def test_two_rank_multihost_check_round(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ripplemq_tpu_torch.parallel.multihost_check",
         "--coordinator", store, "--num-hosts", "2", "--host-index", str(i),
         "--device", "cpu", "--timeout-s", "30"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (i, err[-3000:])
        assert "MULTIHOST_OK" in out and "mesh=(2x1)" in out, (out, err[-1500:])


_KILL_SCRIPT = """
import os, signal, time
import numpy as np
from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.parallel.mesh import init_distributed
from ripplemq_tpu_torch.storage.memstore import MemoryRoundStore

init_distributed({store!r}, 2, 0, device="cpu", timeout_s=20.0)
cfg = EngineConfig(partitions=4, replicas=2, slots=64, slot_bytes=32,
                   max_batch=8, read_batch=8, max_consumers=8,
                   max_offset_updates=4, fused_control=True,
                   packed_writes=True)
dp = DataPlane(cfg, mode="spmd", device="cpu", store=MemoryRoundStore(),
               workers=[{worker!r}])
dp.start()
dp.set_leader(0, 0, 1)
dp.set_leader(1, 1, 1)
off = dp.submit_append(0, [b"ls-a", b"ls-b"]).result(timeout=60)
assert off == 0, off
msgs, nxt = dp.read(0, 0, replica=0)
assert msgs == [b"ls-a", b"ls-b"], msgs
assert dp.submit_offsets(0, [(1, nxt)]).result(timeout=60) is True
assert dp.read_offset(0, 1, replica=0) == nxt
won = dp.elect({{2: (0, 2)}})
assert won[2], won
ends = dp.log_ends()
assert ends.shape == (2, 4) and int(ends[:, 0].max()) == nxt, ends
assert dp.broken_reason is None
print("LOCKSTEP_OK", flush=True)

os.kill({pid}, signal.SIGKILL)
t0 = time.monotonic()
try:
    dp.submit_append(1, [b"after-kill"]).result(timeout=60)
    raise SystemExit("a round committed without the killed worker")
except Exception as e:
    err = repr(e)
assert dp.broken_reason is not None, err
print("BROKEN_OK %.3f %s" % (time.monotonic() - t0, dp.broken_reason),
      flush=True)
dp.stop()
os._exit(0)  # the broken world is left as it is (mesh.shutdown)
"""


def test_lockstep_dataplane_breaks_loudly_when_a_worker_dies(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    port = free_port()
    worker = start_worker(1, 2, store, port, timeout_s=20.0)
    out = run_controller(_KILL_SCRIPT.format(
        store=store, worker=f"127.0.0.1:{port}", pid=worker.pid),
        [worker], timeout=60)
    assert "LOCKSTEP_OK" in out, out
    line = next(x for x in out.splitlines() if x.startswith("BROKEN_OK"))
    assert float(line.split()[1]) < 20.0, line  # within the group timeout

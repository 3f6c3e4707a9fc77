"""Gloo worlds for the port's spmd tests: N processes on the CPU, each
one rank (one mesh cell), replaying a list of engine-call streams.

`run_world(n, jobs, tmp_path)` starts `python -m tests.torch_spmd_world`
n times with a FileStore under `tmp_path`, joins every process with a
timeout (killing all of them when one is exceeded) and returns rank 0's
results. A job is a dict: `mesh` (R, S), `cfg` (EngineConfig fields),
`calls` — a list of (method, args) with numpy args, replayed through
`make_spmd_fns` on every rank of the mesh (ranks outside it skip the
job) — and optionally `start`, a whole [R, P, ...] numpy state cut into
the shards with `convert.shard_state` instead of `init()`, or `init`
False: only build the engine. Per job rank 0
reports each call's outputs as numpy, the whole final state gathered
with `convert.gather_state` (named layout), the warnings building the
engine raised and the mesh's collective counts.

This module is not collected (its name does not start with `test_`),
and its child imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_world(n: int, jobs: list, tmp_path, timeout: float = 60.0) -> list:
    tmp = Path(tmp_path)
    job_path, out_path = tmp / "jobs.pkl", tmp / "out.pkl"
    store = tmp / "store"
    job_path.write_bytes(pickle.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_spmd_world", str(rank), str(n),
         str(store), str(job_path), str(out_path)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(n)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, f"world ranks failed: {bad}"
    return pickle.loads(out_path.read_bytes())


def _numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if hasattr(x, "_fields"):  # StepOutput
        return type(x)(*(_numpy(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_numpy(v) for v in x)
    return x


def _replay(fns, state, method, args):
    from ripplemq_tpu_torch.core.state import ReplicaState, StepInput

    if method in ("step", "step_many"):
        inp, *rest = args
        return getattr(fns, method)(state, StepInput(*inp), *rest)
    if method in ("step_sparse", "step_many_sparse"):
        inp, *rest = args
        return getattr(fns, method)(state, StepInput(*inp), *rest)
    if method == "vote":
        state, elected, votes = fns.vote(state, *args)
        return state, (elected, votes)
    if method in ("read", "read_many", "read_offset"):
        return state, getattr(fns, method)(state, *args)
    if method == "resync":
        return fns.resync(state, *args), None
    if method == "init_from":
        return fns.init_from(ReplicaState(*args[0])), None
    raise ValueError(method)


def _child(rank: int, world: int, store: str, job_path: str,
           out_path: str) -> int:
    import warnings

    from ripplemq_tpu_torch import convert
    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.parallel.engine import make_spmd_fns
    from ripplemq_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        shutdown,
    )

    init_distributed(f"file://{store}", world, rank, device="cpu",
                     timeout_s=60.0)
    results = []
    for job in pickle.loads(Path(job_path).read_bytes()):
        mesh = make_mesh(*job["mesh"])
        if mesh.coords is None:
            results.append(None)
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the config's global verdict
            cfg = EngineConfig(**job["cfg"])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fns = make_spmd_fns(cfg, mesh)
        mesh.reset_stats()
        if job.get("init") is False:  # building the engine is the job
            results.append({"warnings": [str(w.message) for w in rec]})
            continue
        state = (fns.init() if job.get("start") is None
                 else convert.shard_state(cfg, job["start"], mesh))
        outs = []
        for method, args in job["calls"]:
            state, out = _replay(fns, state, method, args)
            outs.append(_numpy(out))
        results.append({
            "outs": outs,
            "state": convert.gather_state(fns, state),
            "warnings": [str(w.message) for w in rec],
            "stats": {k: v[0] for k, v in mesh.stats.items()},
        })
    if rank == 0:
        Path(out_path).write_bytes(pickle.dumps(results))
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_child(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_worker(rank: int, world: int, coordinator: str, port: int,
                 timeout_s: float = 30.0) -> subprocess.Popen:
    """One engine-worker process (`python -m
    ripplemq_tpu_torch.parallel.worker`) on the CPU, listening on
    127.0.0.1:`port`."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "ripplemq_tpu_torch.parallel.worker",
         "--coordinator", coordinator, "--num-hosts", str(world),
         "--host-index", str(rank), "--listen-host", "127.0.0.1",
         "--listen-port", str(port), "--device", "cpu",
         "--timeout-s", str(timeout_s)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def run_controller(script: str, workers: list, timeout: float) -> str:
    """Run a controller script (`python -c`) beside its workers; return
    its stdout. Every process is stopped (and killed past its time)
    before this returns."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    ctrl = subprocess.Popen([sys.executable, "-c", script], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        try:
            out, err = ctrl.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            ctrl.kill()
            out, err = ctrl.communicate(timeout=30)
            raise AssertionError(f"controller hung\n{err[-4000:]}")
        assert ctrl.returncode == 0, f"controller rc {ctrl.returncode}:\n{err[-4000:]}"
        return out
    finally:
        for w in workers:
            if w.poll() is None:
                w.terminate()
        for w in workers:
            try:
                w.communicate(timeout=20)
            except subprocess.TimeoutExpired:
                w.kill()
                w.communicate(timeout=10)

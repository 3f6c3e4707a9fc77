"""Lockstep engine driver: one controller, N engine-worker processes
(PyTorch port).

Twin of `ripplemq_tpu/parallel/lockstep.py`. Every rank of a mesh must
launch the SAME computations in the SAME order — its collectives
rendezvous across processes (`parallel.mesh`). The broker has ONE
controller driving the engine from host RPCs (rank 0, cell (0, 0)), so
every other cell runs an engine WORKER (`parallel.worker`): the
controller broadcasts each engine call's host inputs to every worker
over the wire transport, then launches its own copy; each worker
replays the call on its cell, and the collectives complete across the
processes. Data rides `torch.distributed` (gloo or NCCL), the call
stream rides TCP.

Ordering: the controller uses one pipelined TCP connection per worker
and stamps a sequence number. The worker's server hands each frame of a
connection to a thread pool, so call n+1 may reach the worker before
call n took its lock (a torch collective blocks its thread until every
rank arrives, which keeps call n's thread busy while the controller,
whose own copy of n returned, already sent n+1). The worker therefore
waits, under a condition variable and for at most `gap_timeout_s`, for
the sequence number it expects: a frame that arrives early is applied in
order, never refused. A number below the expected one (a duplicate) or a
wait that times out (a gap) is refused, and that breaks the plane.

A call whose arrays exceed half the wire codec's frame cap (`MAX_FRAME`,
64 MiB: a chained active-set round of the broker's shape carries up to
268 MB of rows) travels as pieces: its encoded arguments, cut into
frames the cap admits; the worker acknowledges each piece and runs the
call when the last one is in. Smaller calls keep the reference's frame.

The controller builds its own engine INSIDE the `configure` call, after
broadcasting it: forming the mesh's process groups is itself a
rendezvous of every rank, so the workers must be building theirs at the
same time.

Failure: if a worker process dies mid-call, the controller's collective
raises (gloo: the peer's socket closed; any backend: the group's
timeout, the config's `rpc_timeout_s`), the worker's reply fails, or
its address refuses the next call's connection; the
plane is then permanently `broken`, the world is latched broken
(`mesh.mark_broken`), and controller failover (broker/replication.py)
recovers the data plane from the committed-round stream, exactly as for
a controller death.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ripplemq_tpu_torch.obs.lockwitness import make_condition, make_lock
from ripplemq_tpu_torch.utils.logs import get_logger
from ripplemq_tpu_torch.wire import codec

log = get_logger("lockstep")

LOCKSTEP_TYPE = "engine.lockstep"
# Bytes of encoded arguments a frame carries (see the module docstring).
PIECE_BYTES = codec.MAX_FRAME // 2


class LockstepSendError(RuntimeError):
    """A lockstep broadcast failed BEFORE any worker received the call
    (and before the local launch): the sequence was restored, no process
    diverged, and the plane remains fully usable — the failed round is
    simply retried. `retryable` is the marker DataPlane._fail_round maps
    to a NotCommittedError so producers see an ordinary retryable
    refusal instead of a transport stack trace."""

    retryable = True


# --------------------------------------------------------- wire marshalling

def enc_value(v) -> Any:
    """Encode host call arguments for the wire codec (which speaks None/
    bool/int/float/str/bytes/list/dict): numpy arrays and scalars (and
    tensors, as their host copy) become tagged dicts, tuples become
    tagged lists (so NamedTuples like ReplicaState survive), everything
    else passes through. Numpy input encodes to the reference's bytes."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        return {"__nd__": str(a.dtype), "shape": list(a.shape),
                "data": a.tobytes()}
    if isinstance(v, tuple):
        return {"__tuple__": [enc_value(x) for x in v]}
    if isinstance(v, list):
        return [enc_value(x) for x in v]
    if hasattr(v, "_fields"):  # NamedTuple (e.g. StepInput)
        return {"__tuple__": [enc_value(x) for x in v]}
    return v


def _array_bytes(v) -> int:
    """Array bytes inside an encoded value."""
    if isinstance(v, dict):
        return (len(v["data"]) if "__nd__" in v
                else sum(_array_bytes(x) for x in v.values()))
    if isinstance(v, list):
        return sum(_array_bytes(x) for x in v)
    return 0


def _pieces(req: dict) -> list[dict]:
    """`req` itself, or its arguments cut into frames of PIECE_BYTES."""
    if _array_bytes(req["args"]) <= PIECE_BYTES:
        return [req]
    blob = codec.encode(req["args"])
    cuts = range(0, len(blob), PIECE_BYTES)
    return [{"type": LOCKSTEP_TYPE, "seq": req["seq"],
             "method": req["method"], "piece": i, "pieces": len(cuts),
             "blob": blob[at:at + PIECE_BYTES]}
            for i, at in enumerate(cuts)]


def dec_value(v) -> Any:
    if isinstance(v, dict) and "__nd__" in v:
        a = np.frombuffer(v["data"], dtype=np.dtype(v["__nd__"]))
        return a.reshape(v["shape"])
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(dec_value(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return [dec_value(x) for x in v]
    return v


# --------------------------------------------------------------- controller

class LockstepController:
    """Wraps SpmdEngineFns: every engine call is broadcast to the worker
    set before the local launch. Presents the same callable surface as
    the wrapped fns (duck-typed for DataPlane).

    `inner` is the engine, or a zero-argument factory that builds it; a
    factory runs as the local half of the `configure` call (see the
    module docstring)."""

    def __init__(self, inner, cfg, part_shards: int,
                 workers: list[str], client, rpc_timeout_s: float = 120.0):
        self._workers = list(workers)
        self._client = client
        if getattr(client, "call_async", None) is None:
            raise ValueError(
                "lockstep needs a pipelining transport (call_async): the "
                "controller must launch its own collective WHILE workers "
                "replay, or the mesh rendezvous deadlocks"
            )
        self._timeout = rpc_timeout_s
        self._seq = 0
        self._lock = make_lock("LockstepController._lock")
        # Set (to a reason string) the first time a broadcast or replay
        # fails: the mesh is permanently out of lockstep — no later call
        # can succeed, and the broker reading this flag must surrender
        # the device program (abdication → standby promotion). Never
        # cleared: a broken controller builds a NEW plane, not this one.
        self.broken: str | None = None
        build = inner if callable(inner) else (lambda: inner)
        # bools stay bools (fused_control/packed_writes) so the worker
        # rebuilds the EXACT EngineConfig — ranks that disagree on the
        # program deadlock at the first collective.
        self._inner = self._call("configure", [
            {k: (bool(v) if isinstance(v, bool) else int(v))
             for k, v in cfg.__dict__.items()},
            int(part_shards),
        ], build)
        self.mesh = self._inner.mesh

    def _send(self, method: str, args: list) -> list:
        self._seq += 1
        req = {
            "type": LOCKSTEP_TYPE,
            "seq": self._seq,
            "method": method,
            "args": [enc_value(a) for a in args],
        }
        pieces = _pieces(req)
        futs = []
        for addr in self._workers:
            try:
                for piece in pieces:
                    futs.append((addr, self._client.call_async(addr,
                                                               dict(piece))))
            except Exception as e:
                # A refused connect means nothing listens at the worker's
                # address: its process is gone, and a rank cannot rejoin
                # a world — that is a break, not a transient failure.
                refused = isinstance(e.__cause__ or e, ConnectionRefusedError)
                if not futs and not refused:
                    # Nothing was dispatched: no worker ever saw this
                    # sequence number, so restoring it keeps the stream
                    # replayable — the failure is TRANSIENT (a dropped
                    # connection the next call re-establishes), not a
                    # lockstep break.
                    self._seq -= 1
                    raise LockstepSendError(
                        f"lockstep send to {addr} failed before any "
                        f"dispatch: {type(e).__name__}: {e}"
                    ) from e
                # Partial dispatch: earlier workers WILL replay this seq,
                # later ones never got it — out of lockstep for good.
                raise
        return futs

    def _check(self, futs) -> None:
        for addr, fut in futs:
            resp = fut.result(timeout=self._timeout)
            if not resp.get("ok"):
                raise RuntimeError(
                    f"lockstep worker {addr} failed: {resp.get('error')}"
                )

    def _break(self, e: Exception) -> None:
        from ripplemq_tpu_torch.parallel.mesh import mark_broken

        with self._lock:
            self.broken = f"{type(e).__name__}: {e}"
        mark_broken(self.broken)

    def _call(self, method: str, args: list, local_fn):
        """Broadcast, run the local copy CONCURRENTLY with the workers'
        replay (the collectives need every rank inside the call — waiting
        for acks first would deadlock), then check the acks. The lock
        spans send + local launch so the controller's call order always
        matches the sequence order the workers replay in."""
        try:
            with self._lock:
                futs = self._send(method, args)
                result = local_fn()
        except LockstepSendError:
            # Pre-broadcast failure: _send restored the sequence and no
            # process ran anything — the plane stays healthy.
            raise
        except Exception as e:
            # A broadcast after the stream became non-replayable, or the
            # local copy failed (a collective raised): permanently broken.
            self._break(e)
            raise
        try:
            self._check(futs)
        except Exception as e:
            # The local launch already ran and updated the state in
            # place; attach the result so the caller (DataPlane) adopts
            # it and fails loudly with the lockstep-break diagnostic.
            self._break(e)
            e.lockstep_result = result
            raise
        return result

    # ---- engine surface (mirrors SpmdEngineFns) ----
    def init(self):
        return self._call("init", [], lambda: self._inner.init())

    def init_from(self, image):
        return self._call("init_from", [image],
                          lambda: self._inner.init_from(image))

    def step(self, state, inp, alive, quorum=None, trim=None):
        return self._call(
            "step", [inp, alive, quorum, trim],
            lambda: self._inner.step(state, inp, alive, quorum, trim),
        )

    def step_many(self, state, inputs, alive, quorum=None, trim=None):
        return self._call(
            "step_many", [inputs, alive, quorum, trim],
            lambda: self._inner.step_many(state, inputs, alive, quorum, trim),
        )

    def step_sparse(self, state, inp, entries_c, slot_ids, alive,
                    quorum=None, trim=None):
        return self._call(
            "step_sparse", [inp, entries_c, slot_ids, alive, quorum, trim],
            lambda: self._inner.step_sparse(state, inp, entries_c, slot_ids,
                                            alive, quorum, trim),
        )

    def step_many_sparse(self, state, inputs, entries_c, slot_ids, alive,
                         quorum=None, trim=None):
        return self._call(
            "step_many_sparse",
            [inputs, entries_c, slot_ids, alive, quorum, trim],
            lambda: self._inner.step_many_sparse(
                state, inputs, entries_c, slot_ids, alive, quorum, trim),
        )

    def vote(self, state, cand, cand_term, alive, quorum=None):
        return self._call(
            "vote", [cand, cand_term, alive, quorum],
            lambda: self._inner.vote(state, cand, cand_term, alive, quorum),
        )

    def read(self, state, replica, partition, offset):
        return self._call(
            "read", [replica, partition, offset],
            lambda: self._inner.read(state, replica, partition, offset),
        )

    def read_many(self, state, replicas, partitions, offsets):
        return self._call(
            "read_many", [replicas, partitions, offsets],
            lambda: self._inner.read_many(state, replicas, partitions,
                                          offsets),
        )

    def read_offset(self, state, replica, partition, consumer_slot):
        return self._call(
            "read_offset", [replica, partition, consumer_slot],
            lambda: self._inner.read_offset(state, replica, partition,
                                            consumer_slot),
        )

    def resync(self, state, src, dst, part_mask):
        return self._call(
            "resync", [src, dst, part_mask],
            lambda: self._inner.resync(state, src, dst, part_mask),
        )

    def fetch_state(self, state, field: str) -> np.ndarray:
        """One state leaf on the host as [R, P, ...]: an `all_gather` over
        the whole mesh, so it is broadcast like any other call (every
        rank must launch it). Fused states serve the named scalars
        (log_end/current_term/commit) as ctrl views."""
        return self._call("fetch_state", [field],
                          lambda: self._inner.fetch_state(state, field))


# ------------------------------------------------------------------- worker

class LockstepWorker:
    """Replays the controller's engine-call stream on this rank's cell of
    the mesh. Wire handler for LOCKSTEP_TYPE requests (plug into a
    TcpServer dispatch). `device` is where the engine's shard lives (the
    world's device when None)."""

    def __init__(self, gap_timeout_s: float = 60.0) -> None:
        self._lock = make_lock("LockstepWorker._lock")
        self._turn = make_condition("LockstepWorker._turn", self._lock)
        self._gap_timeout_s = gap_timeout_s
        self._expected_seq = 1
        self._fns = None
        self._state = None
        # Pieces of calls still arriving: seq -> {piece index: bytes}.
        self._pieces: dict[int, dict[int, bytes]] = {}
        self._pieces_lock = make_lock("LockstepWorker._pieces_lock")

    @property
    def expected_seq(self) -> int:
        return self._expected_seq

    def handle(self, req: dict) -> dict:
        try:
            if "pieces" in req:
                req = self._assemble(req)
                if req is None:
                    return {"ok": True}  # held; the last piece runs it
            with self._turn:
                seq = int(req["seq"])
                deadline = time.monotonic() + self._gap_timeout_s
                # An early frame waits for its turn (the server's pool
                # may start call n+1 before call n took the lock).
                while seq > self._expected_seq:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._turn.wait(timeout=left)
                if seq != self._expected_seq:
                    return {"ok": False,
                            "error": f"lockstep break: got seq {seq}, "
                                     f"expected {self._expected_seq}"}
                try:
                    self._execute(str(req["method"]),
                                  [dec_value(a) for a in req["args"]])
                finally:
                    # The turn passes even when the call failed: the
                    # failure is reported, and later frames must not
                    # wait out the gap timeout behind it.
                    self._expected_seq += 1
                    self._turn.notify_all()
            return {"ok": True}
        except Exception as e:  # report, don't kill the server thread
            log.warning("lockstep replay failed: %s: %s",
                        type(e).__name__, e)
            return {"ok": False,
                    "error": f"internal: {type(e).__name__}: {e}"}

    def _assemble(self, piece: dict) -> dict | None:
        """Hold one piece of a call; with its last piece in, the call."""
        seq, n = int(piece["seq"]), int(piece["pieces"])
        with self._pieces_lock:
            got = self._pieces.setdefault(seq, {})
            got[int(piece["piece"])] = piece["blob"]
            if len(got) < n:
                return None
            del self._pieces[seq]
        return {"seq": seq, "method": piece["method"],
                "args": codec.decode(b"".join(got[i] for i in range(n)))}

    def _execute(self, method: str, args: list) -> None:
        from ripplemq_tpu_torch.core.state import ReplicaState, StepInput

        if method == "configure":
            from ripplemq_tpu_torch.core.config import EngineConfig
            from ripplemq_tpu_torch.parallel.engine import make_spmd_fns
            from ripplemq_tpu_torch.parallel.mesh import make_mesh

            cfg_dict, part_shards = args
            cfg = EngineConfig(**{
                k: (v if isinstance(v, bool) else int(v))
                for k, v in cfg_dict.items()
            })
            mesh = make_mesh(cfg.replicas, int(part_shards))
            self._fns = make_spmd_fns(cfg, mesh)
            self._cfg = cfg
            log.info("lockstep worker configured: %s over mesh %s at %s",
                     cfg, mesh.shape, mesh.coords)
            return
        if self._fns is None:
            raise RuntimeError("lockstep worker not configured")
        fns = self._fns
        if method == "init":
            self._state = fns.init()
        elif method == "init_from":
            self._state = fns.init_from(ReplicaState(*args[0]))
        elif method == "step":
            inp_t, alive, quorum, trim = args
            self._state, _ = fns.step(self._state, StepInput(*inp_t),
                                      alive, quorum, trim)
        elif method == "step_many":
            inp_t, alive, quorum, trim = args
            self._state, _ = fns.step_many(self._state, StepInput(*inp_t),
                                           alive, quorum, trim)
        elif method == "step_sparse":
            inp_t, entries_c, slot_ids, alive, quorum, trim = args
            self._state, _ = fns.step_sparse(
                self._state, StepInput(*inp_t), entries_c, slot_ids,
                alive, quorum, trim)
        elif method == "step_many_sparse":
            inp_t, entries_c, slot_ids, alive, quorum, trim = args
            self._state, _ = fns.step_many_sparse(
                self._state, StepInput(*inp_t), entries_c, slot_ids,
                alive, quorum, trim)
        elif method == "vote":
            cand, cand_term, alive, quorum = args
            self._state, _, _ = fns.vote(self._state, cand, cand_term,
                                         alive, quorum)
        elif method == "read":
            replica, partition, offset = args
            fns.read(self._state, replica, partition, offset)
        elif method == "read_many":
            replicas, partitions, offsets = args
            fns.read_many(self._state, replicas, partitions, offsets)
        elif method == "read_offset":
            replica, partition, cslot = args
            fns.read_offset(self._state, replica, partition, cslot)
        elif method == "resync":
            src, dst, mask = args
            self._state = fns.resync(self._state, src, dst, mask)
        elif method == "fetch_state":
            fns.fetch_state(self._state, str(args[0]))
        else:
            raise ValueError(f"unknown lockstep method {method!r}")


__all__ = ["LOCKSTEP_TYPE", "LockstepController", "LockstepSendError",
           "LockstepWorker", "dec_value", "enc_value"]

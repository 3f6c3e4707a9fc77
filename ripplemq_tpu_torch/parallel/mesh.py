"""The distributed world and the (replica, part) mesh (PyTorch port).

Twin of `ripplemq_tpu/parallel/mesh.py`. The reference's mesh is a grid
of devices that ONE process drives through `shard_map`; PyTorch has no
such single-controller form, so here every cell of the mesh is one
process (a rank of a `torch.distributed` world) holding one device:

- ``"replica"`` — the replication factor. Cell (r, s) holds replica r's
  rows; the ballot, the leader broadcasts and the commit index are
  `all_reduce`s over the replica group {(r', s)} (the reference's psums
  over the replica axis);
- ``"part"`` — partition sharding. Cell (r, s) holds partitions
  [s * local_P, (s + 1) * local_P); a round's outputs are gathered over
  the part group {(r, s')}.

Rank r * S + s is cell (r, s), so the controller (rank 0) is cell
(0, 0); every other cell is an engine worker (`parallel.worker`) that
replays the controller's call stream (`parallel.lockstep`). A 1 x 1
mesh is a world of one: it runs in-process, with no worker, and
`make_mesh(1, 1)` forms that world itself when none exists.

The backend rule: NCCL where every rank has its own GPU, gloo where
ranks share one card (NCCL refuses two ranks of a communicator on one
device) and on the CPU. `init_distributed` decides it from what each
rank publishes in the rendezvous store (its host and device). Every
collective the binding uses goes through `Mesh` (`all_reduce` SUM and
MAX, `all_gather`), which counts its calls and their host time.

Failure: a collective whose peer died raises (gloo: the peer's socket
closes; NCCL: `TORCH_NCCL_BLOCKING_WAIT` makes a timeout raise in the
caller, and `TORCH_NCCL_ASYNC_ERROR_HANDLING=2` cleans up without
tearing the process down). `mark_broken` latches the world: no mesh is
built on it again (a broken group is never reused), and it is never
destroyed on that path — destroying a group whose peer died waits for
that peer.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from ripplemq_tpu_torch.ops.rs import indexed_device

# The world this process joined (one per process, like jax.distributed).
_WORLD: dict = {}
_MESHES: dict = {}


def _device_for(rank: int, device) -> torch.device:
    if device is not None:
        return indexed_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the mesh "
            "on the CPU explicitly")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _store(coordinator: str, world: int, rank: int,
           timeout: datetime.timedelta):
    """`host:port` → a TCPStore served by rank 0; `file://PATH` → a
    FileStore (tests)."""
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], world)
    host, port = coordinator.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, is_master=rank == 0,
                         timeout=timeout)


def pick_backend(store, world: int, rank: int, device: torch.device) -> str:
    """The backend rule: gloo on the CPU and where two ranks share a GPU;
    NCCL where every rank holds its own. Each rank publishes its host and
    device in the store and reads everyone's."""
    if device.type != "cuda":
        return "gloo"
    store.set(f"rmq/dev/{rank}", f"{socket.gethostname()}/{device.index}")
    cells = [store.get(f"rmq/dev/{r}").decode() for r in range(world)]
    return "nccl" if len(set(cells)) == world else "gloo"


def init_distributed(
    coordinator: str,
    num_hosts: int,
    host_index: int,
    *,
    device=None,
    timeout_s: float = 120.0,
) -> int:
    """Join this process to the world as rank `host_index` of
    `num_hosts` (one rank per mesh cell) and return the world size.

    `coordinator` is rank 0's "host:port" (rank 0 serves the rendezvous
    store there) or `file://PATH` for a FileStore. `device` is this
    rank's device: CUDA device `rank % device_count` when None, and with
    no GPU present that raises unless the caller passes "cpu". Every
    process group of the world and its meshes waits at most `timeout_s`
    for a peer (the config's `rpc_timeout_s`)."""
    if dist.is_initialized():
        raise RuntimeError("this process already joined a world")
    dev = _device_for(host_index, device)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _store(coordinator, num_hosts, host_index, timeout)
    _join(store, num_hosts, host_index, dev,
          pick_backend(store, num_hosts, host_index, dev), timeout)
    return num_hosts


def _join(store, world: int, rank: int, dev: torch.device, backend: str,
          timeout: datetime.timedelta) -> None:
    if backend == "nccl":
        # A timeout raises in the caller; an async error cleans up the
        # communicator without killing the broker process.
        os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    _WORLD.update(device=dev, backend=backend, timeout=timeout, broken=None)


def world_size() -> int:
    """Ranks in this process's world (1 when it joined none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mark_broken(reason: str) -> None:
    """Latch the world broken: a collective failed or a worker fell out
    of the call stream. No mesh is built on it again."""
    if _WORLD and _WORLD.get("broken") is None:
        _WORLD["broken"] = reason


def shutdown() -> None:
    """Leave a healthy world (tests; a clean exit). A broken world is
    left as it is: destroying a group whose peer died waits for it."""
    if _WORLD.get("broken") is None and dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.clear()
    _MESHES.clear()


def pick_axes(n_devices: int, replicas: int | None = None) -> tuple[int, int]:
    """Choose (replica, part) axis sizes for n devices.

    An explicitly requested replication factor must divide the device
    count — silently degrading RF would weaken quorum durability without
    warning. With no request, pick the largest of (5, 3, 2, 1) that
    divides; remaining devices shard partitions.
    """
    if replicas is not None:
        if n_devices % replicas:
            raise ValueError(
                f"replication factor {replicas} does not divide {n_devices} "
                f"devices; refusing to silently weaken the quorum"
            )
        return replicas, n_devices // replicas
    for r in (5, 3, 2, 1):
        if n_devices % r == 0:
            return r, n_devices // r
    return 1, n_devices


class Mesh:
    """A (replica, part) grid of ranks: `shape` ({"replica": R, "part":
    S}), this rank's `coords` ((r, s), or None for a rank of the world
    outside the mesh), its `device`, and three process groups: the
    `replica_group` (the cells of this rank's partition shard), the
    `part_group` (the cells of this rank's replica) and `group` (every
    cell). `stats` counts collectives and their host µs by name."""

    def __init__(self, replicas: int, part_shards: int) -> None:
        R, S = replicas, part_shards
        self.shape = {"replica": R, "part": S}
        self.size = R * S
        self.rank = dist.get_rank()
        self.device = _WORLD["device"]
        self.backend = _WORLD["backend"]
        self.coords = divmod(self.rank, S) if self.rank < R * S else None
        timeout = _WORLD["timeout"]
        # Every rank of the world creates every group, in one order.
        reps = [dist.new_group([r * S + s for r in range(R)],
                               timeout=timeout) for s in range(S)]
        parts = [dist.new_group([r * S + s for s in range(S)],
                                timeout=timeout) for r in range(R)]
        whole = (dist.group.WORLD if R * S == dist.get_world_size()
                 else dist.new_group(list(range(R * S)), timeout=timeout))
        self.stats: dict[str, list] = {}
        if self.coords is None:
            self.replica_group = self.part_group = self.group = None
            return
        r, s = self.coords
        self.replica_group, self.part_group, self.group = reps[s], parts[r], whole
        # The handshake: every cell in one collective (on NCCL this also
        # sets the communicator up before the first round).
        one = torch.ones(1, dtype=torch.int32, device=self.device)
        dist.all_reduce(one, group=self.group)
        if int(one.item()) != R * S:
            raise RuntimeError(f"mesh handshake counted {int(one.item())} "
                               f"of {R * S} cells")

    @property
    def replica(self) -> int:
        return self.coords[0]

    @property
    def part(self) -> int:
        return self.coords[1]

    def _note(self, name: str, t0: float) -> None:
        s = self.stats.setdefault(name, [0, 0.0])
        s[0] += 1
        s[1] += (time.perf_counter() - t0) * 1e6

    def reset_stats(self) -> None:
        self.stats.clear()

    def all_reduce(self, x: torch.Tensor, op: str, over: str) -> torch.Tensor:
        """`x` reduced in place with SUM or MAX over the "replica" group
        or the whole mesh ("mesh"); a group of one is `x` itself."""
        group, n = ((self.replica_group, self.shape["replica"])
                    if over == "replica" else (self.group, self.size))
        if n == 1:
            return x
        t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
        self._note(f"all_reduce_{op}_{over}", t0)
        return x

    def all_gather(self, x: torch.Tensor, over: str) -> list[torch.Tensor]:
        """Every cell's `x` over the "part" group (by shard) or the whole
        mesh ("mesh", by rank)."""
        group, n = ((self.part_group, self.shape["part"])
                    if over == "part" else (self.group, self.size))
        if n == 1:
            return [x]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(n)]
        t0 = time.perf_counter()
        dist.all_gather(out, x, group=group)
        self._note(f"all_gather_{over}", t0)
        return out


def make_mesh(replicas: int, part_shards: int = 1, device=None) -> Mesh:
    """The (replica, part) mesh over this process's world; a mesh of one
    cell forms a world of one when the process joined none (on `device`:
    CUDA when None, NCCL there, gloo on the CPU). Every rank of the world
    calls it with the same shape, in the same order (forming the groups
    is a rendezvous); the mesh of a shape is built once a world."""
    need = replicas * part_shards
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"need {need} ranks for mesh (replica={replicas}, "
                f"part={part_shards}), the world has 1 (no world joined: "
                f"call init_distributed first)")
        dev = _device_for(0, device)
        _join(dist.HashStore(), 1, 0, dev,
              "nccl" if dev.type == "cuda" else "gloo",
              datetime.timedelta(seconds=120.0))
    if _WORLD.get("broken") is not None:
        raise RuntimeError(f"the world is broken ({_WORLD['broken']}); "
                           f"no mesh is built on it again")
    if device is not None and indexed_device(device) != _WORLD["device"]:
        raise ValueError(f"mesh device {indexed_device(device)} is not this "
                         f"rank's device {_WORLD['device']}")
    world = dist.get_world_size()
    if need > world:
        raise ValueError(
            f"need {need} ranks for mesh (replica={replicas}, "
            f"part={part_shards}), the world has {world}")
    key = (replicas, part_shards)
    if key not in _MESHES:
        _MESHES[key] = Mesh(replicas, part_shards)
    return _MESHES[key]


__all__ = ["Mesh", "init_distributed", "make_mesh", "mark_broken",
           "pick_axes", "pick_backend", "shutdown", "world_size"]

"""ripplemq_tpu_torch — the replication engine of ripplemq_tpu in PyTorch.

A port of the JAX package `ripplemq_tpu` to PyTorch and CUDA on an NVIDIA
H100, file for file (`ripplemq_tpu_torch/core/step.py` is the twin of
`ripplemq_tpu/core/step.py`). The JAX package is the reference the port
is tested against; the port never imports it, nor JAX.

Ported so far (the engine, erasure-coding, DataPlane and host-layer
slices):

- `core` — EngineConfig, the state/input NamedTuples of tensors, the
  host encoder, and the control/vote/read steps over an explicit
  leading replica axis;
- `ops.append` — the log-append write phase: a hand-written CUDA kernel
  (`ops/csrc/append.cu`) on the GPU, its plain PyTorch twin on the CPU;
- `ops.rs` — the GF(2⁸) Reed–Solomon product: a hand-written CUDA
  kernel (`ops/csrc/rs.cu`) on the GPU, its plain twin on the CPU;
- `parallel.engine.make_local_fns` — the single-device engine entry
  points (CUDA by default);
- `stripes` — the stripe codec and the rebuilt-from-any-k recovery;
- `storage` — the segment store, sealed-segment RS(3,2) protection, the
  in-memory round store and the retention log index;
- `broker.dataplane` — the `DataPlane` (append batcher, resolvers,
  settle pipeline, reads; local mode), `recover_image` /
  `replay_records`;
- `broker.hostraft`, `broker.manager`, `broker.replication` — the
  metadata Raft, the `PartitionManager` that turns its committed
  commands into the DataPlane's control tables, elections and resyncs,
  and the `RoundReplicator` that streams committed rounds to standbys;
- `wire`, `metadata`, `groups` — the codec and transports, the cluster
  config, models and assigner, the consumer-group state machine;
- `obs` — the lock witness, metrics registry, flight recorder and span
  ring; `utils` — the host helpers those need;
- `convert` — numpy state/inputs/images from the reference into port
  tensors.

Entry points run on CUDA unless the caller passes `device="cpu"`; with
no GPU and no device given they raise.
"""

__version__ = "0.1.0"

__all__ = [
    "DataPlane",
    "NotCommittedError",
    "PartitionFullError",
    "StoreReadRaceError",
]


def __getattr__(name):
    # Lazy re-exports (PEP 562), as in the reference package: importing
    # the package stays cheap; the DataPlane's module loads on first use.
    if name in __all__:
        from ripplemq_tpu_torch.broker import dataplane

        return getattr(dataplane, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

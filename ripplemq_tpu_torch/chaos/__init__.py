"""Cluster rigs of the chaos plane (PyTorch port).

Twin of `ripplemq_tpu/chaos/__init__.py`, ported so far in part:

- `chaos.cluster` — the library-resident in-proc N-broker cluster
  (`InProcCluster`, `make_cluster_config`, `small_engine`);
- `chaos.proc_cluster` — the process-level backend: real
  `python -m ripplemq_tpu_torch.broker` subprocesses, real TCP, real
  on-disk stores (`ProcCluster`, `free_ports`,
  `make_proc_cluster_config`);
- `chaos.diskfaults` — the disk-fault injector both clusters use.

The seeded nemesis, the history checker and the `run_chaos` harness
come with slice E of the port (ROADMAP.md); their names raise
`NotImplementedError` naming it. Nothing here imports them eagerly.
"""

from ripplemq_tpu_torch.chaos.cluster import InProcCluster, make_cluster_config
from ripplemq_tpu_torch.chaos.proc_cluster import ProcCluster

__all__ = [
    "InProcCluster",
    "ProcCluster",
    "make_cluster_config",
]

_SLICE_E = ("run_chaos", "run_kill_all_drill", "History", "check_history",
            "check_group_history", "Nemesis", "make_schedule")


def __getattr__(name):
    if name in _SLICE_E:
        raise NotImplementedError(
            f"chaos.{name} belongs to the chaos harness (harness, history, "
            "nemesis), slice E of the port")
    raise AttributeError(name)

"""Deterministic chaos plane (PyTorch port): seeded nemesis + end-to-end
safety checker.

Twin of `ripplemq_tpu/chaos/__init__.py`. The pieces (each importable on
its own):

- `chaos.cluster` — the library-resident in-proc N-broker cluster
  (`InProcCluster`, `make_cluster_config`, `small_engine`);
- `chaos.nemesis` — a SEEDED fault scheduler (crash/restart, partitions,
  drop/delay/duplicate, stripe-holder kills, disk faults on the process
  backend); the schedule is a pure function of (seed, roster, shape),
  byte-identical to the reference's;
- `chaos.history` — the operation-history recorder and the
  queue-semantics checker (`check_history`, `check_group_history`);
- `chaos.groups` — consumer-group members under chaos;
- `chaos.harness` — `run_chaos(seed, ...)`, one adversarial run with a
  JSON-able verdict, and `run_kill_all_drill`, the correlated
  full-cluster SIGKILL durability drill; both run on CUDA unless given
  `device="cpu"`;
- `chaos.proc_cluster` — the process-level backend: real
  `python -m ripplemq_tpu_torch.broker` subprocesses, real TCP, real
  on-disk stores (`ProcCluster`, `free_ports`,
  `make_proc_cluster_config`);
- `chaos.diskfaults` — the disk-fault injector both clusters use.
"""

from ripplemq_tpu_torch.chaos.cluster import InProcCluster, make_cluster_config
from ripplemq_tpu_torch.chaos.harness import run_chaos, run_kill_all_drill
from ripplemq_tpu_torch.chaos.history import (
    History,
    check_group_history,
    check_history,
)
from ripplemq_tpu_torch.chaos.nemesis import Nemesis, make_schedule
from ripplemq_tpu_torch.chaos.proc_cluster import ProcCluster

__all__ = [
    "InProcCluster",
    "ProcCluster",
    "make_cluster_config",
    "run_chaos",
    "run_kill_all_drill",
    "History",
    "check_history",
    "check_group_history",
    "Nemesis",
    "make_schedule",
]

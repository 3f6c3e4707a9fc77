"""Slow-marker contract: the tier-1 runtime budget, as a lint rule.

The port's own scope of the reference's `markers` rule: ROADMAP's
tier-1 command runs `-m 'not slow'` under a hard timeout, and that
budget only holds if every test module is either slow-marked or
consciously admitted to FAST_MODULES. The audit enforces MEMBERSHIP,
not runtime — admission is the review point. The port's test modules
are `tests/test_torch_*.py`; every other test module belongs to the
JAX package's rule and is out of this one's scope. Three findings
classes:

- a module neither slow-marked nor allowlisted;
- a stale allowlist entry (names no module, or names a slow-marked one
  — either silently shrinks tier-1 coverage);
- a pinned slow twin that lost its slow mark (reintroduces the
  timeout).

`tests/torch_port_modules.py` takes both tuples from here, so the
port's admission is reviewed in this one list.
"""

from __future__ import annotations

import ast
import pathlib

from ripplemq_tpu_torch.analysis.framework import Finding, Repo

RULE = "markers"

TESTS_DIR = "tests"
MODULE_PREFIX = "test_torch_"

# The port's modules vetted fast on the CPU (per-module times from a
# `-n 6 --dist loadfile` run on a 6-core CPU host). Anything over ~15 s
# is annotated so the next budget squeeze knows where the time goes.
FAST_MODULES = (
    "test_torch_append",           # ~20 s: kernel parity, plain path
    "test_torch_bench",            # ~60 s: bench parity, e2e at 8 partitions
    "test_torch_bench_cluster",    # ~50 s: repl bytes exact, group, SLO, split
    "test_torch_bench_procs",      # ~60 s: fan-out, host-plane sweep at 8 parts
    "test_torch_bench_spmd",       # ~40 s: 1x1 parity states, gloo scaling
    "test_torch_bench_storm",      # ~60 s: the storm against the reference
    "test_torch_broker",
    "test_torch_chain_settle",
    "test_torch_chaos",            # ~65 s: 3-seed smoke, striped, lockstep
    "test_torch_client",
    "test_torch_cold_restart",
    "test_torch_concurrency_triage",
    "test_torch_control_fusion",
    "test_torch_controller_failover",
    "test_torch_core_step",
    "test_torch_dataplane",
    "test_torch_dataplane_parity",
    "test_torch_degradation",
    "test_torch_engine",           # ~17 s: engine twins, reference shapes
    "test_torch_failover",
    "test_torch_follower_reads",   # ~45 s: plane units + chaos smokes (1 proc)
    "test_torch_group_cluster",
    "test_torch_group_waves",
    "test_torch_groups",
    "test_torch_hostplane",
    "test_torch_hostplane_chaos",  # ~15 s: one seeded run + prefix parity
    "test_torch_hostraft",
    "test_torch_idempotence",
    "test_torch_linearizable_reads",
    "test_torch_lint",             # ~16 s: fixtures + 3 whole-tree lint runs
    "test_torch_lint_parity",
    "test_torch_lockstep",
    "test_torch_lockwitness",
    "test_torch_log_matching",
    "test_torch_manager",
    "test_torch_marker_audit",
    "test_torch_metadata",
    "test_torch_model_check",
    "test_torch_multichip_smoke",
    "test_torch_obs",
    "test_torch_obs_dispatch",
    "test_torch_observability",
    "test_torch_packaging",
    "test_torch_pid_expiry",
    "test_torch_planes_parity",
    "test_torch_port_hygiene",     # ~20 s: import scan of every port file
    "test_torch_proc_chaos",       # ~35 s: real-subprocess chaos smoke
    "test_torch_process_cluster",
    "test_torch_profiles",         # ~60 s: soak runs of both packages
    "test_torch_read_batching",
    "test_torch_read_cache",
    "test_torch_readme_bench",
    "test_torch_repl_pipeline",
    "test_torch_replication",
    "test_torch_retention",
    "test_torch_retry_policy",     # ~19 s: retry units + failover clusters
    "test_torch_rs",               # ~18 s: GF(2^8) parity at segment widths
    "test_torch_server_parity",
    "test_torch_settled_gap",
    "test_torch_shard_distribution",
    "test_torch_shmring",
    "test_torch_slo",
    "test_torch_slo_chaos",
    "test_torch_soak",
    "test_torch_spans",
    "test_torch_split",
    "test_torch_split_chaos",      # ~40 s: elastic chaos smokes
    "test_torch_spmd",
    "test_torch_spmd_parity",
    "test_torch_step",
    "test_torch_storage",
    "test_torch_store_migrate",
    "test_torch_stride_rule",
    "test_torch_stripes",
    "test_torch_stripes_cluster",
    "test_torch_term_skew",
    "test_torch_wire",
)

# The port's slow-marked twins of the reference's slow modules: the
# audit accepts them through their `slow` mark, so they stay out of the
# allowlist (a module both allowlisted and slow-marked is refused).
PINNED_SLOW = (
    "test_torch_chaos_soak",
    "test_torch_lockstep_drill",
    "test_torch_multihost",
    "test_torch_obs_soak",
    "test_torch_proc_chaos_soak",
    "test_torch_soak_gc",
    "test_torch_soak_random",
)


def is_slow_marked(tree: ast.AST) -> bool:
    """True iff the module carries a top-level slow pytestmark
    (`pytestmark = pytest.mark.slow` or a list containing it)."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "pytestmark"
                   for t in node.targets):
            continue
        if "slow" in ast.dump(node.value):
            return True
    return False


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    modules = {
        pathlib.PurePosixPath(p).stem: p
        for p in repo.py_files(TESTS_DIR)
        if pathlib.PurePosixPath(p).name.startswith(MODULE_PREFIX)
    }
    slow = {name for name, p in modules.items()
            if is_slow_marked(repo.tree(p))}
    fast = set(FAST_MODULES)

    for name, path in sorted(modules.items()):
        if name not in fast and name not in slow:
            findings.append(Finding(
                rule=RULE, path=path, line=1, key=f"unvetted::{name}",
                message=(f"test module {name} neither slow-marked nor "
                         f"vetted fast — mark `pytestmark = "
                         f"pytest.mark.slow` (soaks/drills) or vet it "
                         f"under ~30 s on CPU and add it to "
                         f"ripplemq_tpu_torch/analysis/markers.py "
                         f"FAST_MODULES"),
            ))
    for name in sorted(fast - set(modules)):
        findings.append(Finding(
            rule=RULE, path="ripplemq_tpu_torch/analysis/markers.py",
            line=1, key=f"stale::{name}",
            message=f"FAST_MODULES entry {name} names no test module",
        ))
    for name in sorted(fast & slow):
        findings.append(Finding(
            rule=RULE, path=modules[name], line=1, key=f"double::{name}",
            message=(f"{name} is both allowlisted and slow-marked — drop "
                     f"one (a stale allowlist entry hides shrinking "
                     f"tier-1 coverage)"),
        ))
    for name in PINNED_SLOW:
        if name not in modules:
            findings.append(Finding(
                rule=RULE, path=TESTS_DIR, line=1,
                key=f"pinned-gone::{name}",
                message=f"pinned slow module {name} vanished",
            ))
        elif name not in slow:
            findings.append(Finding(
                rule=RULE, path=modules[name], line=1,
                key=f"pinned::{name}",
                message=f"{name} lost its slow mark — that puts a slow "
                        f"twin into tier-1's budget",
            ))
    return findings

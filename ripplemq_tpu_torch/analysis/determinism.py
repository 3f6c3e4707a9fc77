"""Determinism purity: no ambient time/randomness in replayable code.

Three subsystems are only correct because they are pure functions of
their declared inputs, and each has already paid for a violation once:

- **Chaos schedule construction** (`chaos/nemesis.py make_schedule`,
  `chaos/diskfaults.py`): a schedule must be a byte-reproducible
  function of (seed, roster, shape, backend) — the replay contract.
  Tuple-`hash` seeding once proved process-unstable and moved to
  sha512 strings; `hash()` is banned here for that reason.
- **Metadata applies** (`broker/manager.py _apply_*`,
  `groups/state.py`, `metadata/assigner.py`): every broker applies the
  same op log and must land in the SAME state — a wall-clock read or
  an unseeded choice in an apply forks replicas.
- **gsn/seed derivation** (`stripes/plane.py` init): identity streams
  feeding recovery ordering. A cross-boot gsn collision was this
  class; its wall-clock SEED is the deliberate, reviewed exception and
  lives in the waiver ledger with its reason.

The rule: in these scopes, no `time.time`/`time.monotonic`/
`perf_counter` CALLS (storing the callable as an injectable-clock
default is fine), no module-level `random.*` (a SEEDED
`random.Random(x)` constructor is fine), no `os.urandom`, `uuid`,
`secrets`, `datetime.now`, and no builtin `hash()`.
"""

from __future__ import annotations

import ast
import re

from ripplemq_tpu_torch.analysis.framework import (
    Finding,
    Repo,
    attr_chain,
    func_defs,
)

RULE = "determinism"

# (module, function-name regex) scopes whose bodies must stay pure.
SCOPES = (
    ("ripplemq_tpu_torch/chaos/nemesis.py", r"^make_schedule$"),
    ("ripplemq_tpu_torch/chaos/diskfaults.py", r".*"),
    ("ripplemq_tpu_torch/broker/manager.py", r"^_apply_"),
    ("ripplemq_tpu_torch/groups/state.py", r".*"),
    ("ripplemq_tpu_torch/metadata/assigner.py", r".*"),
    ("ripplemq_tpu_torch/stripes/plane.py", r"^__init__$"),
)

_TIME_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns"}
_DT_FNS = {"now", "utcnow", "today"}


def impure_calls(fn: ast.AST) -> list[tuple[int, str]]:
    """(line, dotted-name) of every ambient-time/randomness CALL in the
    function body, nested defs included (a helper closure constructed
    in a pure scope still runs in it)."""
    out: list[tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            if f.id == "hash":
                out.append((node.lineno, "hash"))
            continue
        if not isinstance(f, ast.Attribute):
            continue
        chain = attr_chain(f)
        base = f.value.id if isinstance(f.value, ast.Name) else None
        if base == "time" and f.attr in _TIME_FNS:
            out.append((node.lineno, chain))
        elif base == "random":
            # Seeded Random(x) construction is the sanctioned idiom;
            # everything else on the module (incl. Random() with no
            # seed) draws from ambient process state.
            if f.attr == "Random" and (node.args or node.keywords):
                continue
            out.append((node.lineno, chain))
        elif base == "os" and f.attr == "urandom":
            out.append((node.lineno, chain))
        elif base in ("uuid", "secrets"):
            out.append((node.lineno, chain))
        elif f.attr in _DT_FNS and "datetime" in chain:
            out.append((node.lineno, chain))
    return out


def scope_findings(path: str, tree: ast.AST,
                   fn_pattern: str) -> list[Finding]:
    pat = re.compile(fn_pattern)
    findings: list[Finding] = []
    for fn in func_defs(tree):
        if not pat.match(fn.name):
            continue
        for line, name in impure_calls(fn):
            findings.append(Finding(
                rule=RULE, path=path, line=line,
                key=f"{path}::{fn.name}::{name}",
                message=(
                    f"ambient `{name}()` call inside deterministic scope "
                    f"{fn.name}() — this code must be a pure function of "
                    f"its inputs (inject a clock/rng, or waive with the "
                    f"reason the impurity is load-bearing)"
                ),
            ))
    return findings


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    for path, fn_pattern in SCOPES:
        if not repo.exists(path):
            findings.append(Finding(
                rule=RULE, path=path, line=1, key=f"scope::{path}",
                message=f"deterministic scope {path} vanished — update "
                        f"analysis/determinism.py SCOPES",
            ))
            continue
        findings.extend(scope_findings(path, repo.tree(path), fn_pattern))
    return findings

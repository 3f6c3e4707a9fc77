"""Thread inventory: every thread in the repo, derived from its spawn
site, closed over the repo call graph, documented in the README.

The multi-core split (ROADMAP "Multi-core host plane") is a refactor of
the most lock-dense code in the repo — ~20 `threading.Thread` spawn
sites across the dataplane pipeline, the replication senders, the
stripes encoder, the segment-store flusher, hostraft, transports, and
duty loops. Before moving any of them into worker subprocesses, the
repo needs a MECHANICAL answer to "which code runs on which thread":

- Spawn sites are DERIVED, not hand-listed: `threading.Thread(target=
  ...)` calls anywhere in the library, plus `threading.Thread`
  SUBCLASSES (their `run` is the entry point). A spawn whose target
  the AST cannot resolve is itself a finding — an un-inventoried
  thread is exactly the omission this rule exists to prevent.
- Each entry point is closed transitively over the repo call graph
  (`analysis/callgraph.py` — the shard_shapes closure machinery,
  repo-wide), producing the thread → reachable-functions map the
  ownership checker (`analysis/ownership.py`) crosses with guarded-
  field inference.
- The inventory is a README surface (the port's README table,
  "Concurrency model (port)" under "PyTorch/CUDA port"),
  exactly like the configuration-reference table: every derived
  thread entry must appear in the table and every table row must
  still be derivable — drift in either direction fails lint.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

from ripplemq_tpu_torch.analysis import callgraph
from ripplemq_tpu_torch.analysis.framework import (
    Finding,
    Repo,
    markdown_section,
)

RULE = "threads"

README_PATH = "README.md"
README_HEADING = "### Concurrency model (port)"

_CACHE_KEY = "thread_inventory"


@dataclasses.dataclass(frozen=True)
class ThreadEntry:
    key: str          # entry point: "path::Qual" (the stable identity)
    name: str         # runtime thread name ('*' spans f-string holes)
    spawned_in: str   # "path::Qual" of the spawning scope


def _thread_name(call: ast.Call) -> str:
    for kw in call.keywords:
        if kw.arg != "name":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return v.value
        if isinstance(v, ast.JoinedStr):
            parts = []
            for piece in v.values:
                if isinstance(piece, ast.Constant):
                    parts.append(str(piece.value))
                else:
                    parts.append("*")
            return "".join(parts)
    return "<unnamed>"


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "Thread"
            and isinstance(f.value, ast.Name)
            and f.value.id == "threading") or (
        isinstance(f, ast.Name) and f.id == "Thread")


def _target_expr(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    if call.args:
        return call.args[0]
    return None


def inventory(repo: Repo) -> tuple[list[ThreadEntry], list[Finding]]:
    """Derive (thread entries, unresolvable-spawn findings). Memoized
    on the repo so threads/ownership/the chaos smoke share one pass."""
    cached = repo.cache.get(_CACHE_KEY)
    if cached is not None:
        return cached

    g = callgraph.graph(repo)
    entries: dict[str, ThreadEntry] = {}
    findings: list[Finding] = []

    for fi in g.funcs.values():
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call) or not _is_thread_ctor(node):
                continue
            tgt = _target_expr(node)
            if tgt is None:
                # A Thread() with no target inside a non-subclass scope
                # (super().__init__ in Thread subclasses has none — but
                # that call is spelled super().__init__, not Thread()).
                continue
            name = _thread_name(node)
            key: Optional[str] = None
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self" and fi.cls is not None):
                ci = g.classes.get(fi.cls)
                if ci is not None and tgt.attr in ci.methods:
                    key = ci.methods[tgt.attr]
            elif isinstance(tgt, ast.Name):
                parts = fi.qual.split(".")
                for depth in range(len(parts), -1, -1):
                    cand = ".".join(parts[:depth] + [tgt.id])
                    if f"{fi.path}::{cand}" in g.funcs:
                        key = f"{fi.path}::{cand}"
                        break
            if key is None:
                findings.append(Finding(
                    rule=RULE, path=fi.path, line=node.lineno,
                    key=f"{fi.path}::{fi.qual}::unresolved_spawn",
                    message=(
                        f"threading.Thread spawn in {fi.qual}() whose "
                        f"target the inventory cannot resolve — an "
                        f"un-inventoried thread; name the target as a "
                        f"method/local def (analysis/threads.py)"
                    ),
                ))
                continue
            if key not in entries:
                entries[key] = ThreadEntry(
                    key=key, name=name, spawned_in=f"{fi.path}::{fi.qual}")

    # threading.Thread subclasses: run() is the entry point.
    for ci in g.classes.values():
        if "Thread" not in ci.bases:
            continue
        run_key = ci.methods.get("run")
        if run_key is None:
            findings.append(Finding(
                rule=RULE, path=ci.path, line=ci.node.lineno,
                key=f"{ci.path}::{ci.name}::no_run",
                message=(f"threading.Thread subclass {ci.name} defines "
                         f"no run() — entry point underivable"),
            ))
            continue
        if run_key not in entries:
            # Runtime name comes from super().__init__(name=...).
            name = f"{ci.name}.run"
            init = ci.methods.get("__init__")
            if init is not None:
                for n in ast.walk(g.funcs[init].node):
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr == "__init__"):
                        name = _thread_name(n)
            entries[run_key] = ThreadEntry(
                key=run_key, name=name,
                spawned_in=f"{ci.path}::{ci.name}")

    out = (sorted(entries.values(), key=lambda e: e.key), findings)
    repo.cache[_CACHE_KEY] = out
    return out


def reachable_map(repo: Repo) -> dict[str, set[str]]:
    """thread entry key -> every function key reachable from it (the
    map ownership crosses with guarded-field inference)."""
    g = callgraph.graph(repo)
    entries, _ = inventory(repo)
    return {e.key: g.reachable({e.key}) for e in entries}


_README_TOKEN = re.compile(r"`([^`\s]+::[^`\s]+)`")


def readme_findings(repo: Repo,
                    entries: list[ThreadEntry]) -> list[Finding]:
    """The drift check: the README 'Concurrency model (port)' table must
    list exactly the derived thread entry points (backticked
    `path::Qual` tokens), the config-reference discipline applied to
    threads."""
    findings: list[Finding] = []
    if not repo.exists(README_PATH):
        return [Finding(rule=RULE, path=README_PATH, line=1,
                        key="readme::missing",
                        message="README.md absent — thread inventory "
                                "undocumentable")]
    section = markdown_section(repo.text(README_PATH), README_HEADING)
    if not section.strip():
        return [Finding(
            rule=RULE, path=README_PATH, line=1, key="readme::section",
            message=(f'README has no "{README_HEADING}" section — the '
                     f"thread inventory is a documented lint surface "
                     f"(analysis/threads.py)"),
        )]
    documented = set(_README_TOKEN.findall(section))
    derived = {e.key for e in entries}
    for e in sorted(entries, key=lambda e: e.key):
        if e.key not in documented:
            findings.append(Finding(
                rule=RULE, path=README_PATH, line=1,
                key=f"readme::{e.key}",
                message=(
                    f"thread `{e.name}` (entry `{e.key}`, spawned in "
                    f"{e.spawned_in}) missing from the README "
                    f'"Concurrency model (port)" table'
                ),
            ))
    for tok in sorted(documented - derived):
        findings.append(Finding(
            rule=RULE, path=README_PATH, line=1, key=f"dead::{tok}",
            message=(
                f"README Concurrency-model (port) row `{tok}` matches no "
                f"derivable thread entry — stale doc (or the spawn "
                f"site moved; re-derive with analysis/threads.py)"
            ),
        ))
    return findings


def check(repo: Repo) -> list[Finding]:
    entries, findings = inventory(repo)
    if not entries:
        return [Finding(
            rule=RULE, path="ripplemq_tpu_torch", line=1,
            key="structure::empty",
            message=("no threads derivable from any spawn site — the "
                     "derivation in analysis/threads.py no longer "
                     "matches the repo's spawn idiom"),
        )]
    return findings + readme_findings(repo, entries)

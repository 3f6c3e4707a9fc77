"""Ownership matrix: fields writable from two threads with no common
lock — the static race finding.

Crosses the thread inventory (`analysis/threads.py`: spawn-site-derived
entry points closed over the repo call graph) with per-write-site lock
inference (the `lock_discipline` guard conventions): for every class
field in the broker host-path modules, collect its WRITE sites
(`self._x = ...`, `self._x[...] = ...`, augmented assigns), the lock
set held at each site, and the set of threads whose reachable-function
closure covers the enclosing function. A field is a finding when

- write sites are reachable from >= 2 distinct threads (functions no
  spawned thread reaches are attributed to one shared "(caller)"
  pseudo-thread — the RPC worker or client thread that invoked the
  public surface), AND
- the intersection of held-lock sets across all write sites is EMPTY
  (no single mutex orders the writes).

`__init__` is exempt (single-threaded construction precedes every
spawn). The multi-core split (ROADMAP) must start from zero here: a
field this rule flags is exactly the state that silently corrupts when
the GIL stops serializing the broker. Scope is the broker host path —
client modules and the chaos harness run on the caller's side of the
wire and have their own single-writer discipline.
"""

from __future__ import annotations

import ast
from typing import Optional

from ripplemq_tpu_torch.analysis import callgraph, lock_graph, threads
from ripplemq_tpu_torch.analysis.framework import Finding, Repo

RULE = "ownership"

# The broker host path: the lock-dense modules the multi-core split
# refactors. Client/chaos/samples run caller-side.
SCAN_ROOTS = (
    "ripplemq_tpu_torch/broker",
    "ripplemq_tpu_torch/storage",
    "ripplemq_tpu_torch/stripes",
    "ripplemq_tpu_torch/parallel",
    "ripplemq_tpu_torch/wire",
    # The SLO autopilot mutates broker-host-path state (knobs, shed
    # gate, tick rings) from its own control thread — in scope from
    # day one.
    "ripplemq_tpu_torch/slo",
)

CALLER = "(caller)"


def _write_target(node: ast.AST) -> Optional[str]:
    """Attribute name when `node` mutates self.<attr>: a store (direct,
    subscript, augmented) or a delete (`del self._x[k]` rebinds shared
    state exactly like a subscript store — delete targets carry ast.Del
    ctx, not ast.Store, so matching Store alone silently dropped the
    whole mutation class)."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.ctx, (ast.Store, ast.Del)) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    if isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, (ast.Store, ast.Del)):
        v = node.value
        if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                and v.value.id == "self":
            return v.attr
    return None


class _SiteWalker(lock_graph._HeldWalker):
    """Held-lock walker that also records, for every field write, the
    lock set held at that statement."""

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.field_locks: dict[str, list[frozenset]] = {}

    def _stmts(self, body, held):
        for st in body:
            if isinstance(st, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = []
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        targets.extend(
                            [t] if not isinstance(t, ast.Tuple) else t.elts)
                elif isinstance(st, ast.AugAssign):
                    targets = [st.target]
                else:
                    targets = st.targets
                for t in targets:
                    f = _write_target(t)
                    if f is not None:
                        self.field_locks.setdefault(f, []).append(
                            frozenset(held))
        super()._stmts(body, held)


def field_write_locks(g: callgraph.CodeGraph, fi: callgraph.FuncInfo,
                      locks: dict[str, str],
                      aliases: dict) -> dict[str, list[frozenset]]:
    implicit = None
    if fi.qual.endswith("_locked"):
        implicit = lock_graph._primary_lock(g, fi.cls, locks)
    w = _SiteWalker(g, fi, locks, aliases, implicit)
    w.walk()
    return w.field_locks


def check(repo: Repo) -> list[Finding]:
    g = callgraph.graph(repo)
    lg = lock_graph.build_graph(repo)
    reach = threads.reachable_map(repo)
    incoming = lock_graph.incoming_held(repo)

    # function key -> attributed threads. A function is attributed to
    # every spawned thread whose closure reaches it, PLUS the shared
    # "(caller)" pseudo-thread when it is reachable from a public
    # surface — a function with no resolved callers that is not a
    # thread entry point or an __init__ chain (RPC handlers behind the
    # dispatch dict, client API methods). Both can be true at once:
    # RoundReplicator.begin runs on the settle thread AND under the
    # read-barrier's RPC caller.
    attribution: dict[str, set[str]] = {}
    for tkey, funcs in reach.items():
        for fk in funcs:
            attribution.setdefault(fk, set()).add(tkey)
    boot_only = lock_graph.boot_only_funcs(repo)
    thread_entries = set(reach)
    caller_roots = {
        k for k, fi in g.funcs.items()
        if k not in lg.call_sites
        and k not in thread_entries
        and k not in boot_only
        and not lock_graph._is_init(k)
    }
    # The caller closure treats `__init__` frames (and pure boot
    # chains) as OPAQUE: a root reaching a constructor is building a
    # not-yet-shared object, and everything behind that frame is
    # construction, not a concurrent caller (main -> BrokerServer ->
    # _wire_replicator must not read as an RPC-thread write path).
    seen = set(caller_roots)
    frontier = [k for k in caller_roots if k in g.funcs]
    while frontier:
        k = frontier.pop()
        if lock_graph._is_init(k) or k in boot_only:
            continue
        for callee in g.calls.get(k, ()):
            if callee not in seen:
                seen.add(callee)
                frontier.append(callee)
    for fk in seen:
        attribution.setdefault(fk, set()).add(CALLER)

    scan_paths = set(repo.py_files(*SCAN_ROOTS))
    # (cls, field) -> list of (func key, thread set, lock sets)
    per_field: dict[tuple[str, str], list] = {}
    for fi in g.funcs.values():
        if fi.path not in scan_paths or fi.cls is None:
            continue
        if fi.qual.split(".")[-1] == "__init__" or fi.key in boot_only:
            continue  # construction precedes every spawn
        fl = field_write_locks(g, fi, lg.locks, lg.aliases)
        if not fl:
            continue
        thr = attribution.get(fi.key) or {CALLER}
        inc = incoming.get(fi.key, frozenset())
        for field, locksets in fl.items():
            if inc is None:
                # Only reachable through unresolved cycles: effectively
                # guarded-by-everything (dead until a root reaches it).
                continue
            per_field.setdefault((fi.cls, field), []).append(
                (fi, thr, [ls | inc for ls in locksets]))

    findings: list[Finding] = []
    for (cls, field), sites in sorted(per_field.items()):
        all_threads: set[str] = set()
        common: Optional[frozenset] = None
        site_desc: list[str] = []
        for fi, thr, locksets in sites:
            all_threads |= thr
            for ls in locksets:
                common = ls if common is None else (common & ls)
            if len(site_desc) < 4:
                site_desc.append(f"{fi.qual}")
        if len(all_threads) < 2 or (common is not None and common):
            continue
        path = g.classes[cls].path if cls in g.classes else sites[0][0].path
        tnames = sorted(t.split("::")[-1] for t in all_threads)
        findings.append(Finding(
            rule=RULE, path=path, line=sites[0][0].node.lineno,
            key=f"{path}::{cls}::{field}",
            message=(
                f"{cls}.{field} is written from >= 2 threads "
                f"({', '.join(tnames[:5])}) with no common lock "
                f"(writers: {', '.join(sorted(set(site_desc)))}) — "
                f"guard every write with one mutex, or waive with the "
                f"reason the ordering is safe (monotone latch, "
                f"joined-before-read, ...)"
            ),
        ))
    return findings

"""Lock-order graph: acquisition orderings derived from the AST; any
cycle is a deadlock finding.

The repo's ~30 instance locks have, until now, kept a consistent
acquisition order by review convention only (dataplane's control lock
vs device lock, the replicator planes' tracker locks vs their senders'
condition queues, the segment store's lock vs its flusher). This
checker derives the ordering graph mechanically:

- **Lock discovery**: `self.X = threading.Lock()/RLock()/Condition()`
  (or the witnessed factories `obs.lockwitness.make_lock/make_rlock/
  make_condition`) anywhere in a class body → lock node `Class.X`.
  `Condition(self.Y)` ALIASES the condition to its underlying lock —
  acquiring either is the same mutex.
- **Edges**: walking each function with a held-lock stack, `with
  self.X:` nested inside `with self.Y:` adds Y→X; a call made while
  holding Y adds Y→(everything the callee may acquire, transitively
  over the repo call graph — `analysis/callgraph.py`); `*_locked`
  helpers that do not themselves acquire run under their class's
  primary lock (the lock_discipline convention, reused).
- **Cycles**: a strongly-connected component in the resulting digraph
  is a lock-inversion finding keyed by the participating locks —
  waivable ONLY through the reasons-mandatory ledger.
- **Self-edges** on a non-reentrant Lock (acquiring `Class.X` on a
  path that may already hold it) are their own finding class.

`DECLARED_EDGES` documents orderings the AST cannot derive (function-
valued indirection); the runtime witness (`obs/lockwitness.py`) checks
observed edges against closure(derived ∪ declared), so a declared edge
is reviewable knowledge, not a blind spot. The witness-name lint below
keeps factory name literals equal to the `Class.attr` node ids so the
static and dynamic planes can never drift apart.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from ripplemq_tpu_torch.analysis import callgraph
from ripplemq_tpu_torch.analysis.framework import Finding, Repo

RULE = "lock_graph"

_CACHE_KEY = "lock_graph"

# Acquisition orderings that are REAL but underivable from the AST
# (function-valued indirection the call graph cannot follow). Each
# entry is (from_node, to_node, why). The runtime witness validates
# observed edges against closure(derived ∪ declared) — an edge landing
# here must explain which indirection hides it from the derivation.
DECLARED_EDGES: tuple[tuple[str, str, str], ...] = (
    (
        "RaftRunner.lock", "PartitionManager.lock",
        "RaftNode.apply_fn / snapshot_fn / restore_fn are BOUND MANAGER "
        "METHODS (BrokerServer wires apply_fn=self.manager.apply): the "
        "raft pump invokes them while holding RaftRunner.lock, and "
        "manager.apply acquires PartitionManager.lock — function-valued "
        "indirection the call graph does not follow. Witnessed by the "
        "first lock_witness chaos run; the reverse order never "
        "occurs (no manager apply proposes into the raft plane), so the "
        "combined graph stays acyclic — which find_cycles verifies, "
        "since declared edges join the derived set before the SCC pass.",
    ),
    (
        "BrokerServer._intake_drain_lock", "InProcNetwork._lock",
        "_drain_intake holds the drain lock across propose_cmd (waves "
        "must reach the raft plane in formation order — releasing "
        "before the propose would let a duty tick and a full-queue "
        "inline drain reorder two waves), and propose_cmd forwards "
        "through self._raft_client, typed as the abstract Transport "
        "and bound at construction (net.client(...)): INTERFACE "
        "indirection the call graph does not follow. On the in-proc "
        "backend the concrete transport is InProcClient, whose call "
        "path takes InProcNetwork._lock for fault-injection "
        "bookkeeping. Witnessed by the churn-storm chaos runs; "
        "acyclic because InProcNetwork._lock is a strict leaf — "
        "deliver() releases it before dispatching the handler, so the "
        "reverse ordering cannot occur.",
    ),
)

_LOCK_CTORS = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "make_lock": "lock", "make_rlock": "rlock",
    "make_condition": "condition",
}


@dataclasses.dataclass
class LockGraph:
    # node ("Class.attr" / "module.NAME") -> kind
    locks: dict[str, str]
    # (cls, attr) -> (cls, attr): Condition(self.Y) aliasing
    aliases: dict[tuple[str, str], tuple[str, str]]
    # (from, to) -> example sites ["path::qual:line", ...]
    edge_sites: dict[tuple[str, str], list[str]]
    # function key -> lock nodes it may acquire DIRECTLY
    direct_acq: dict[str, set[str]]
    # function key -> transitive acquisition summary
    acq_closure: dict[str, set[str]]
    # callee key -> [(caller key, locks held at the call site)]:
    # ownership's caller-held propagation (a callee whose EVERY resolved
    # call site holds lock L effectively runs under L).
    call_sites: dict[str, list[tuple[str, frozenset]]]

    @property
    def edges(self) -> set[tuple[str, str]]:
        return set(self.edge_sites)

    def closure(self,
                extra: tuple = DECLARED_EDGES) -> set[tuple[str, str]]:
        """Transitive closure of derived ∪ declared edges — the set the
        runtime witness containment check runs against."""
        adj: dict[str, set[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
        for a, b, _why in extra:
            adj.setdefault(a, set()).add(b)
        out: set[tuple[str, str]] = set()
        for start in list(adj):
            seen: set[str] = set()
            frontier = list(adj.get(start, ()))
            while frontier:
                n = frontier.pop()
                if n in seen:
                    continue
                seen.add(n)
                frontier.extend(adj.get(n, ()))
            out.update((start, n) for n in seen)
        return out


def _ctor_kind(value: ast.AST) -> Optional[tuple[str, Optional[ast.AST]]]:
    """(kind, condition-lock-arg) when `value` constructs a lock."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    name = None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in ("threading", "lockwitness"):
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    kind = _LOCK_CTORS.get(name or "")
    if kind is None:
        return None
    lock_arg = None
    if kind == "condition":
        if value.args:
            lock_arg = value.args[0]
        for kw in value.keywords:
            if kw.arg == "lock":
                lock_arg = kw.value
    return kind, lock_arg


# The analysis/witness planes themselves are not host-path lock owners
# (the witness's registry lock and wrapper internals would be pure
# noise in the graph they exist to check).
_EXCLUDED_PREFIXES = ("ripplemq_tpu_torch/analysis/",
                      "ripplemq_tpu_torch/obs/lockwitness")


def _collect_locks(g: callgraph.CodeGraph) -> tuple[
        dict[str, str], dict[tuple[str, str], tuple[str, str]]]:
    locks: dict[str, str] = {}
    aliases: dict[tuple[str, str], tuple[str, str]] = {}
    for ci in g.classes.values():
        if ci.path.startswith(_EXCLUDED_PREFIXES):
            continue
        for m in ci.node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for n in ast.walk(m):
                if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                    continue
                t = n.targets[0]
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                got = _ctor_kind(n.value)
                if got is None:
                    continue
                kind, lock_arg = got
                if (kind == "condition"
                        and isinstance(lock_arg, ast.Attribute)
                        and isinstance(lock_arg.value, ast.Name)
                        and lock_arg.value.id == "self"):
                    aliases[(ci.name, t.attr)] = (ci.name, lock_arg.attr)
                    continue  # the alias IS the lock; no separate node
                locks[f"{ci.name}.{t.attr}"] = kind
    return locks, aliases


def _module_locks(repo: Repo, g: callgraph.CodeGraph,
                  locks: dict[str, str]) -> None:
    for path in repo.py_files(*callgraph.SCAN_ROOTS):
        if path.startswith(_EXCLUDED_PREFIXES):
            continue
        modname = path.rsplit("/", 1)[-1][:-3]
        for st in repo.tree(path).body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                got = _ctor_kind(st.value)
                if got is not None:
                    locks[f"{modname}.{st.targets[0].id}"] = got[0]


class _HeldWalker:
    """Statement walker tracking the held-lock stack through one
    function, emitting (edge, site) pairs for nested acquisitions and
    (held, call) pairs for interprocedural edges."""

    def __init__(self, g: callgraph.CodeGraph, fi: callgraph.FuncInfo,
                 locks: dict[str, str],
                 aliases: dict[tuple[str, str], tuple[str, str]],
                 implicit: Optional[str]) -> None:
        self.g = g
        self.fi = fi
        self.locks = locks
        self.aliases = aliases
        self.resolve_call = callgraph.make_resolver(g, fi)
        self.local_types = callgraph.local_var_types(g, fi)
        self.acquired: list[tuple[str, int]] = []   # every acquisition
        self.nested: list[tuple[str, str, int]] = []  # (held, acq, line)
        # Every resolved call site: (held set — may be empty, callee).
        self.held_calls: list[tuple[frozenset, str, int]] = []
        self.implicit = implicit  # *_locked convention

    def lock_node(self, expr: ast.AST) -> Optional[str]:
        """Resolve `with <expr>:` to a lock node, alias-chased."""
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        base = expr.value
        cls: Optional[str] = None
        if isinstance(base, ast.Name):
            if base.id == "self":
                cls = self.fi.cls
            elif base.id in self.local_types:
                cls = self.local_types[base.id]
        elif (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self" and self.fi.cls):
            ci = self.g.classes.get(self.fi.cls)
            if ci is not None:
                cls = ci.attr_types.get(base.attr)
        if cls is None:
            return None
        seen = set()
        while (cls, attr) in self.aliases and (cls, attr) not in seen:
            seen.add((cls, attr))
            cls, attr = self.aliases[(cls, attr)]
        node = f"{cls}.{attr}"
        return node if node in self.locks else None

    def walk(self) -> None:
        held0 = [self.implicit] if self.implicit else []
        self._stmts(self.fi.node.body, held0)

    def _stmts(self, body, held: list[str]) -> None:
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs run later, outside the lock
            if isinstance(st, (ast.With, ast.AsyncWith)):
                nodes = []
                for item in st.items:
                    ln = self.lock_node(item.context_expr)
                    if ln is not None:
                        nodes.append(ln)
                    else:
                        self._exprs(item.context_expr, held)
                for ln in nodes:
                    for h in held:
                        if h != ln:
                            self.nested.append((h, ln, st.lineno))
                    self.acquired.append((ln, st.lineno))
                    if ln in held:
                        # Re-acquisition of a held mutex: self-edge.
                        self.nested.append((ln, ln, st.lineno))
                self._stmts(st.body, held + [n for n in nodes
                                             if n not in held])
                continue
            if isinstance(st, ast.Try):
                self._stmts(st.body, held)
                for h in st.handlers:
                    self._stmts(h.body, held)
                self._stmts(st.orelse, held)
                self._stmts(st.finalbody, held)
                continue
            if isinstance(st, (ast.If, ast.For, ast.While)):
                for f in ("test", "iter"):
                    if hasattr(st, f):
                        self._exprs(getattr(st, f), held)
                self._stmts(st.body, held)
                self._stmts(st.orelse, held)
                continue
            self._exprs(st, held)

    def _exprs(self, node: ast.AST, held: list[str]) -> None:
        # walk_shallow semantics: a closure/lambda defined here runs
        # later, outside the lock.
        stack = [node]
        while stack:
            n = stack.pop()
            if n is not node and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(n))
            if not isinstance(n, ast.Call):
                continue
            callee = self.resolve_call(n)
            if callee is None:
                continue
            self.held_calls.append((frozenset(held), callee, n.lineno))


def _primary_lock(g: callgraph.CodeGraph, cls: Optional[str],
                  locks: dict[str, str]) -> Optional[str]:
    if cls is None:
        return None
    for attr in ("_lock", "lock"):
        node = f"{cls}.{attr}"
        if node in locks:
            return node
    return None


def build_graph(repo: Repo) -> LockGraph:
    cached = repo.cache.get(_CACHE_KEY)
    if cached is not None:
        return cached
    g = callgraph.graph(repo)
    locks, aliases = _collect_locks(g)
    _module_locks(repo, g, locks)

    direct_acq: dict[str, set[str]] = {}
    nested_sites: list[tuple[str, str, str]] = []   # (held, acq, site)
    walkers: dict[str, _HeldWalker] = {}
    for fi in g.funcs.values():
        implicit = None
        if fi.qual.endswith("_locked"):
            implicit = _primary_lock(g, fi.cls, locks)
        w = _HeldWalker(g, fi, locks, aliases, implicit)
        w.walk()
        acq = {n for n, _ in w.acquired}
        if implicit is not None and acq == {implicit}:
            # A *_locked method that itself takes the class lock (the
            # segment-store idiom: `_append_locked` IS the locked
            # implementation) — the implicit hold double-counted it;
            # re-walk without the convention.
            w = _HeldWalker(g, fi, locks, aliases, None)
            w.walk()
            acq = {n for n, _ in w.acquired}
        direct_acq[fi.key] = acq
        walkers[fi.key] = w
        site = f"{fi.path}::{fi.qual}"
        for h, a, line in w.nested:
            nested_sites.append((h, a, f"{site}:{line}"))

    # Transitive acquisition summaries over the call graph.
    acq_closure = {k: set(v) for k, v in direct_acq.items()}
    changed = True
    while changed:
        changed = False
        for k, callees in g.calls.items():
            mine = acq_closure.setdefault(k, set())
            before = len(mine)
            for c in callees:
                mine |= acq_closure.get(c, set())
            if len(mine) != before:
                changed = True

    edge_sites: dict[tuple[str, str], list[str]] = {}
    call_sites: dict[str, list[tuple[str, frozenset]]] = {}

    def add(a: str, b: str, site: str) -> None:
        sites = edge_sites.setdefault((a, b), [])
        if len(sites) < 4:
            sites.append(site)

    for h, a, site in nested_sites:
        add(h, a, site)
    for key, w in walkers.items():
        fi = g.funcs[key]
        for held, callee, line in w.held_calls:
            call_sites.setdefault(callee, []).append((key, held))
            for h in held:
                for acq in acq_closure.get(callee, ()):
                    if acq != h:
                        add(h, acq, f"{fi.path}::{fi.qual}:{line}"
                                    f" -> {callee}")
                    elif self_reacquire_is_deadlock(locks, h):
                        add(h, h,
                            f"{fi.path}::{fi.qual}:{line} -> {callee}")

    lg = LockGraph(locks=locks, aliases=aliases, edge_sites=edge_sites,
                   direct_acq=direct_acq, acq_closure=acq_closure,
                   call_sites=call_sites)
    repo.cache[_CACHE_KEY] = lg
    return lg


def self_reacquire_is_deadlock(locks: dict[str, str], node: str) -> bool:
    # RLocks are reentrant; standalone Conditions wrap an RLock (raw
    # `threading.Condition()` defaults to one, and the witness factory
    # mirrors that). A Condition ALIASED to a plain lock resolved to
    # the lock node long before this check.
    return locks.get(node) not in ("rlock", "condition")


def _is_init(key: str) -> bool:
    return key.split("::", 1)[-1].split(".")[-1] == "__init__"


def boot_only_funcs(repo: Repo) -> set[str]:
    """Functions whose EVERY resolved call chain originates in an
    `__init__`: they run during single-threaded construction, before
    any spawn — their writes are ordered with everything by the
    thread-start happens-before edge (RaftNode.restore from
    BrokerServer.__init__ is the canonical case)."""
    cached = repo.cache.get("boot_only")
    if cached is not None:
        return cached
    lg = build_graph(repo)
    boot = set(lg.call_sites)  # optimistic greatest fixpoint
    changed = True
    while changed:
        changed = False
        for f in list(boot):
            for caller, _held in lg.call_sites[f]:
                if not _is_init(caller) and caller not in boot:
                    boot.discard(f)
                    changed = True
                    break
    repo.cache["boot_only"] = boot
    return boot


def incoming_held(repo: Repo) -> dict[str, Optional[frozenset]]:
    """Caller-held propagation: for each function, the lock set held at
    EVERY resolved RUNTIME call site (intersection), transitively — the
    RaftNode/RaftRunner convention where the wrapper's lock guards the
    whole inner state machine. Construction-time call sites (`__init__`
    chains) are excluded: they run pre-spawn, where holding no lock is
    correct and must not dilute the runtime guard. Functions with no
    resolved runtime callers (public surfaces, thread entry points,
    dispatch-table handlers) are roots with an empty incoming set;
    `None` marks functions only reachable through not-yet-resolved
    cycles (treated as guarded — dead until a root reaches them)."""
    cached = repo.cache.get("incoming_held")
    if cached is not None:
        return cached
    g = callgraph.graph(repo)
    lg = build_graph(repo)
    boot = boot_only_funcs(repo)

    runtime_sites: dict[str, list[tuple[str, frozenset]]] = {}
    for callee, sites in lg.call_sites.items():
        live = [(c, h) for c, h in sites
                if not _is_init(c) and c not in boot]
        if live:
            runtime_sites[callee] = live

    inc: dict[str, Optional[frozenset]] = {
        k: (None if k in runtime_sites else frozenset())
        for k in g.funcs
    }
    changed = True
    while changed:
        changed = False
        for callee, sites in runtime_sites.items():
            acc: Optional[frozenset] = None  # TOP
            for caller, held in sites:
                ch = inc.get(caller, frozenset())
                if ch is None:
                    continue  # TOP caller: TOP ∩ x = x
                eff = held | ch
                acc = eff if acc is None else (acc & eff)
            if acc is not None and acc != inc[callee]:
                inc[callee] = acc
                changed = True
    repo.cache["incoming_held"] = inc
    return inc


def find_cycles(edges: set[tuple[str, str]],
                locks: dict[str, str]) -> list[list[str]]:
    """SCCs with >1 node, plus self-edges on non-reentrant locks
    (shared Tarjan: utils/graphs.py, the witness's cycle check rides
    the same implementation)."""
    from ripplemq_tpu_torch.utils.graphs import cycles

    return [
        comp for comp in cycles(edges)
        if len(comp) > 1 or self_reacquire_is_deadlock(locks, comp[0])
    ]


# --------------------------------------------- witness-name consistency

_FACTORIES = {"make_lock", "make_rlock", "make_condition"}


def witness_name_findings(repo: Repo) -> list[Finding]:
    """Every `self.X = make_lock("NAME")` literal must equal
    `Class.X` — the witness records under NAME and the containment
    check maps it back onto the static graph's node ids; a drifted
    literal silently detaches the two planes."""
    g = callgraph.graph(repo)
    findings: list[Finding] = []
    for ci in g.classes.values():
        for m in ci.node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for n in ast.walk(m):
                if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                    continue
                t = n.targets[0]
                v = n.value
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and isinstance(v, ast.Call)):
                    continue
                fname = None
                if isinstance(v.func, ast.Name):
                    fname = v.func.id
                elif isinstance(v.func, ast.Attribute):
                    fname = v.func.attr
                if fname not in _FACTORIES:
                    continue
                if not (v.args and isinstance(v.args[0], ast.Constant)
                        and isinstance(v.args[0].value, str)):
                    continue
                want = f"{ci.name}.{t.attr}"
                got = v.args[0].value
                if got != want:
                    findings.append(Finding(
                        rule=RULE, path=ci.path, line=n.lineno,
                        key=f"witness_name::{want}",
                        message=(
                            f"lock witness name {got!r} does not match "
                            f"its static node id {want!r} — the "
                            f"witnessed/static cross-check would "
                            f"silently miss this lock"
                        ),
                    ))
    return findings


_DEFAULT_CLOSURE: Optional[set] = None


def default_closure() -> set:
    """closure(derived ∪ declared) for the REAL repo, memoized at
    module scope — the source tree does not change mid-run, and a
    witnessed chaos sweep must not re-parse the repo per seed."""
    global _DEFAULT_CLOSURE
    if _DEFAULT_CLOSURE is None:
        _DEFAULT_CLOSURE = build_graph(Repo()).closure()
    return _DEFAULT_CLOSURE


def _lock_class_collisions(repo: Repo) -> list[Finding]:
    """The call graph keys classes by BARE name (first definition wins,
    deterministic); that is harmless until two same-named classes BOTH
    own locks — then the shadowed class's locks vanish from the graph
    with no trace. Make exactly that case a finding."""
    g = callgraph.graph(repo)
    owners: dict[str, list[str]] = {}
    for path in repo.py_files(*callgraph.SCAN_ROOTS):
        if path.startswith(_EXCLUDED_PREFIXES):
            continue
        for node in ast.walk(repo.tree(path)):
            if not isinstance(node, ast.ClassDef):
                continue
            has_lock = any(
                _ctor_kind(n.value) is not None
                for n in ast.walk(node)
                if isinstance(n, ast.Assign) and len(n.targets) == 1
            )
            if has_lock:
                owners.setdefault(node.name, []).append(path)
    return [
        Finding(
            rule=RULE, path=paths[1], line=1,
            key=f"collision::{name}",
            message=(
                f"lock-owning class {name} is defined in multiple "
                f"modules ({paths}) — the bare-name class map shadows "
                f"all but {g.classes[name].path}, losing its locks "
                f"from the graph; rename one class"
            ),
        )
        for name, paths in sorted(owners.items()) if len(paths) > 1
    ]


def check(repo: Repo) -> list[Finding]:
    lg = build_graph(repo)
    findings = witness_name_findings(repo)
    findings.extend(_lock_class_collisions(repo))
    if not lg.locks:
        return [Finding(
            rule=RULE, path="ripplemq_tpu_torch", line=1,
            key="structure::locks",
            message=("no locks derivable — the discovery in "
                     "analysis/lock_graph.py no longer matches the "
                     "repo's lock-construction idiom"),
        )]
    edges = set(lg.edges)
    edges.update((a, b) for a, b, _ in DECLARED_EDGES)
    for cyc in find_cycles(edges, lg.locks):
        sites = []
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)] if len(cyc) > 1 else a
            sites.extend(lg.edge_sites.get((a, b), [])[:2])
        findings.append(Finding(
            rule=RULE, path="ripplemq_tpu_torch", line=1,
            key="cycle::" + "<->".join(cyc),
            message=(
                f"lock-order cycle {' -> '.join(cyc + [cyc[0]])}: two "
                f"threads taking these in opposite orders deadlock. "
                f"Example sites: {sites or 'declared edges'} — break "
                f"the inversion (or waive with a reason in "
                f"analysis/ledger.py if provably single-threaded)"
            ),
        ))
    return findings

"""Repo call graph + lightweight type inference: the shared core under
the concurrency checkers (`threads`, `lock_graph`, `ownership`).

This is the `shard_shapes` transitive-closure machinery generalized
from one module's call graph to the whole repo: functions are nodes
(`path::Qual` where Qual is the dotted scope chain, e.g.
`DataPlane._run` or `DataPlane.warm.run` for a nested def), and call
edges are resolved through

- same-class method calls (`self.m()`, `cls.m()`),
- cross-object calls through inferred attribute types
  (`self.store.append()` where `self.store = SegmentStore(...)` or an
  annotated constructor parameter says so),
- one level of local aliasing (`s = self._sender(...); s.enqueue()`
  via the callee's return annotation is NOT chased — but
  `x = ClassName(...)` and `x = self.attr` are),
- module-level functions and repo imports (`from ...core import step
  as core_step; core_step.f()`).

Unresolvable calls (function-valued attributes, duck-typed callbacks)
are simply not followed — that gap is exactly what the RUNTIME witness
(`obs/lockwitness.py`) exists to catch, and the chaos smoke fails when
a witnessed edge proves the static closure missed something.

Everything here is a pure function of parsed ASTs; the computed graph
is memoized on the `Repo` via `graph(repo)` so the three checkers (and
the <60 s lint budget) share ONE closure instead of three.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from ripplemq_tpu_torch.analysis.framework import Repo

# The library the concurrency rules reason about. chip_smoke.py is a
# single-shot verification script; tests are exempt by the usual rule.
SCAN_ROOTS = ("ripplemq_tpu_torch",)

_CACHE_KEY = "callgraph"


@dataclasses.dataclass
class FuncInfo:
    path: str
    qual: str                    # dotted scope chain within the module
    node: ast.FunctionDef
    cls: Optional[str]           # enclosing class name (innermost)

    @property
    def key(self) -> str:
        return f"{self.path}::{self.qual}"


@dataclasses.dataclass
class ClassInfo:
    path: str
    name: str
    node: ast.ClassDef
    bases: list[str] = dataclasses.field(default_factory=list)
    methods: dict[str, str] = dataclasses.field(default_factory=dict)
    # self.<attr> -> inferred class name (constructor calls + annotated
    # ctor params assigned through).
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CodeGraph:
    funcs: dict[str, FuncInfo]               # key -> info
    classes: dict[str, ClassInfo]            # bare class name -> info
    calls: dict[str, set[str]]               # caller key -> callee keys
    module_funcs: dict[str, dict[str, str]]  # path -> {name: key}

    def reachable(self, roots: set[str]) -> set[str]:
        """Transitive closure over the call graph (shard_shapes'
        _close_over_step, repo-wide)."""
        seen = set(r for r in roots if r in self.funcs)
        frontier = list(seen)
        while frontier:
            k = frontier.pop()
            for callee in self.calls.get(k, ()):
                if callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen


def _annotation_classes(node: Optional[ast.AST],
                        known: set[str]) -> Optional[str]:
    """First known class named anywhere in an annotation (handles
    Optional[X], "X" string forms, bare X)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in known:
            return n.id
        if isinstance(n, ast.Attribute) and n.attr in known:
            return n.attr
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value in known):
            return n.value
    return None


def _called_class(call: ast.Call, known: set[str],
                  imports: dict[str, str]) -> Optional[str]:
    """Class name when `call` constructs a known repo class."""
    f = call.func
    if isinstance(f, ast.Name):
        name = imports.get(f.id, f.id)
        name = name.rsplit(".", 1)[-1]
        return name if name in known else None
    if isinstance(f, ast.Attribute) and f.attr in known:
        return f.attr
    return None


def _collect_module(path: str, tree: ast.AST, known_classes: set[str],
                    graph: CodeGraph) -> None:
    """Second pass: functions, methods, attribute types, import map."""
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                imports[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                imports[(a.asname or a.name).split(".")[0]] = a.name

    module_funcs: dict[str, str] = {}

    def visit(body, scope: list[str], cls: Optional[str]) -> None:
        for st in body:
            if isinstance(st, ast.ClassDef):
                ci = graph.classes.get(st.name)
                if ci is not None and ci.path == path:
                    visit(st.body, scope + [st.name], st.name)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(scope + [st.name])
                fi = FuncInfo(path=path, qual=qual, node=st, cls=cls)
                graph.funcs[fi.key] = fi
                if cls is not None and len(scope) >= 1 \
                        and scope[-1] == cls:
                    graph.classes[cls].methods.setdefault(st.name, fi.key)
                if not scope:
                    module_funcs[st.name] = fi.key
                # Nested defs are their own nodes, scoped under us.
                visit(st.body, scope + [st.name], cls)

    visit(tree.body, [], None)
    graph.module_funcs[path] = module_funcs

    # Attribute types: every `self.X = ...` in every method body.
    for ci in graph.classes.values():
        if ci.path != path:
            continue
        for m in ci.node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params: dict[str, str] = {}
            for a in (*m.args.posonlyargs, *m.args.args,
                      *m.args.kwonlyargs):
                t = _annotation_classes(a.annotation, known_classes)
                if t is not None:
                    params[a.arg] = t
            for n in ast.walk(m):
                if not isinstance(n, ast.Assign) or len(n.targets) != 1:
                    continue
                t = n.targets[0]
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                typ: Optional[str] = None
                if isinstance(n.value, ast.Call):
                    typ = _called_class(n.value, known_classes, imports)
                elif isinstance(n.value, ast.Name):
                    typ = params.get(n.value.id)
                if typ is not None:
                    ci.attr_types.setdefault(t.attr, typ)

    graph._imports[path] = imports  # type: ignore[attr-defined]


def local_var_types(graph: CodeGraph, fi: FuncInfo) -> dict[str, str]:
    """Function-local name -> inferred class: `x = ClassName(...)`,
    `x = self.attr` (typed attr), `x = self.method(...)` through the
    method's return annotation, and annotated parameters."""
    imports = graph._imports[fi.path]  # type: ignore[attr-defined]
    cls_info = graph.classes.get(fi.cls) if fi.cls else None
    local_types: dict[str, str] = {}
    for n in ast.walk(fi.node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            tgt = n.targets[0].id
            if isinstance(n.value, ast.Call):
                c = _called_class(n.value, set(graph.classes), imports)
                if c is not None:
                    local_types[tgt] = c
                else:
                    fn = n.value.func
                    if (cls_info is not None
                            and isinstance(fn, ast.Attribute)
                            and isinstance(fn.value, ast.Name)
                            and fn.value.id == "self"
                            and fn.attr in cls_info.methods):
                        callee = graph.funcs[cls_info.methods[fn.attr]]
                        r = _annotation_classes(
                            callee.node.returns, set(graph.classes))
                        if r is not None:
                            local_types[tgt] = r
            elif (isinstance(n.value, ast.Attribute)
                    and isinstance(n.value.value, ast.Name)
                    and n.value.value.id == "self"
                    and cls_info is not None):
                t = cls_info.attr_types.get(n.value.attr)
                if t is not None:
                    local_types[tgt] = t
    for a in (*fi.node.args.posonlyargs, *fi.node.args.args,
              *fi.node.args.kwonlyargs):
        t = _annotation_classes(a.annotation, set(graph.classes))
        if t is not None:
            local_types.setdefault(a.arg, t)
    return local_types


def method_key(graph: CodeGraph, cls_name: str,
               meth: str) -> Optional[str]:
    ci = graph.classes.get(cls_name)
    if ci is None:
        return None
    if meth in ci.methods:
        return ci.methods[meth]
    for b in ci.bases:  # one level of repo-class inheritance
        bi = graph.classes.get(b)
        if bi is not None and meth in bi.methods:
            return bi.methods[meth]
    return None


def make_resolver(graph: CodeGraph, fi: FuncInfo):
    """Per-function call-site resolver: Call node -> callee key (or
    None). Shared by the aggregate edge pass and lock_graph's held-
    region analysis (which needs per-SITE resolution, not the per-
    function union)."""
    imports = graph._imports[fi.path]  # type: ignore[attr-defined]
    module_funcs = graph.module_funcs[fi.path]
    cls_info = graph.classes.get(fi.cls) if fi.cls else None
    local_types = local_var_types(graph, fi)

    def resolve_symbol(dotted: str) -> Optional[str]:
        if "." not in dotted or not dotted.startswith("ripplemq_tpu_torch"):
            return None
        mod, sym = dotted.rsplit(".", 1)
        p = mod.replace(".", "/") + ".py"
        funcs = graph.module_funcs.get(p)
        if funcs and sym in funcs:
            return funcs[sym]
        cls = graph.classes.get(sym)
        if cls is not None and cls.path == p:
            return cls.methods.get("__init__")
        return None

    def resolve(n: ast.Call) -> Optional[str]:
        f = n.func
        if isinstance(f, ast.Name):
            name = f.id
            if name in module_funcs:
                return module_funcs[name]
            if name in imports:
                return resolve_symbol(imports[name])
            if name in graph.classes:
                return graph.classes[name].methods.get("__init__")
            # Nested function defined in an enclosing scope.
            parts = fi.qual.split(".")
            for depth in range(len(parts), 0, -1):
                cand = ".".join(parts[:depth] + [name])
                if f"{fi.path}::{cand}" in graph.funcs:
                    return f"{fi.path}::{cand}"
            return None
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                if fi.cls is not None:
                    return method_key(graph, fi.cls, f.attr)
            elif (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                    and cls_info is not None):
                t = cls_info.attr_types.get(base.attr)
                if t is not None:
                    return method_key(graph, t, f.attr)
            elif isinstance(base, ast.Name):
                if base.id in local_types:
                    return method_key(graph, local_types[base.id], f.attr)
                if base.id in imports:
                    return resolve_symbol(f"{imports[base.id]}.{f.attr}")
        return None

    return resolve


def _resolve_calls(path: str, graph: CodeGraph) -> None:
    for fi in [f for f in graph.funcs.values() if f.path == path]:
        out = graph.calls.setdefault(fi.key, set())
        resolve = make_resolver(graph, fi)
        for n in ast.walk(fi.node):
            if isinstance(n, ast.Call):
                callee = resolve(n)
                if callee is not None:
                    out.add(callee)


def build(repo: Repo, roots: tuple[str, ...] = SCAN_ROOTS) -> CodeGraph:
    graph = CodeGraph(funcs={}, classes={}, calls={}, module_funcs={})
    graph._imports = {}  # type: ignore[attr-defined]
    paths = repo.py_files(*roots)
    # Pass 1: classes (names must be globally known before attr-type
    # inference can resolve cross-module constructions).
    for path in paths:
        for node in ast.walk(repo.tree(path)):
            if isinstance(node, ast.ClassDef):
                bases = []
                for b in node.bases:
                    if isinstance(b, ast.Name):
                        bases.append(b.id)
                    elif isinstance(b, ast.Attribute):
                        bases.append(b.attr)
                # First definition wins on (rare) bare-name collisions;
                # deterministic because paths are sorted.
                graph.classes.setdefault(node.name, ClassInfo(
                    path=path, name=node.name, node=node, bases=bases))
    known = set(graph.classes)
    for path in paths:
        _collect_module(path, repo.tree(path), known, graph)
    for path in paths:
        _resolve_calls(path, graph)
    return graph


def graph(repo: Repo) -> CodeGraph:
    """The memoized repo call graph (shared across the three
    concurrency checkers so the closure is computed once per lint)."""
    cache = getattr(repo, "cache", None)
    if cache is None:
        cache = repo.cache = {}
    if _CACHE_KEY not in cache:
        cache[_CACHE_KEY] = build(repo)
    return cache[_CACHE_KEY]

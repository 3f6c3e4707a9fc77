"""Shard shape rule: no global-P allocations inside the spmd step set.

Under the multi-device binding (`parallel/engine.py::make_spmd_fns`)
each rank holds ONE replica's `[local_P]` SHARD of every per-partition
leaf — but the binding hands the core step functions the GLOBAL `cfg`
(`ctrl_fn(cfg, state, inp, ..., axis=axis)`), so `cfg.partitions` is
still the global count there, and a `torch.zeros((cfg.partitions,))`
inside a step function the binding reaches builds a global-shaped
tensor on every rank: at best a shape error at the first round, at
worst silent wrong masking when broadcasting happens to line up. The
spmd wrappers pass quorum/trim explicitly for exactly that reason; this
checker mechanizes the rule:

- The spmd step set is DERIVED, not hand-listed: parse
  `parallel/engine.py`, take the inner defs of `make_spmd_fns`, and
  collect the `core.step` functions they call — directly
  (`core_step.read_batch_at(...)`) or through one level of indirection
  bound in the factory (`ctrl_fn = core_step.x if fused else
  core_step.y`; `ctrl_fn(...)`). The allocation scan then closes that
  set over `core/step.py`'s internal call graph.
- Inside those functions, any tensor-allocating call (`torch.zeros/
  ones/full/empty/arange/zeros_like/full_like`, the `Tensor.new_zeros/
  new_ones/new_full/new_empty` methods, and `.expand/broadcast_to/tile/
  repeat`) whose arguments reach `cfg.partitions` (directly or through a
  local alias like `P = cfg.partitions`) is a finding — UNLESS it sits
  under the documented local-binding idiom `if <param> is None:` (the
  default fill the spmd wrappers are required to pre-empt).
"""

from __future__ import annotations

import ast
from typing import Optional

from ripplemq_tpu_torch.analysis.framework import Finding, Repo, func_defs

RULE = "shard_shapes"

ENGINE_PATH = "ripplemq_tpu_torch/parallel/engine.py"
STEP_PATH = "ripplemq_tpu_torch/core/step.py"
SPMD_FACTORY = "make_spmd_fns"

_ALLOC_FNS = {"zeros", "ones", "full", "empty", "arange", "zeros_like",
              "full_like", "new_zeros", "new_ones", "new_full",
              "new_empty", "expand", "broadcast_to", "tile", "repeat"}


def _step_imports(tree: ast.AST) -> tuple[dict[str, str], set[str]]:
    """(local name -> step fn name, names bound to the step MODULE) for
    every way the module reaches core.step: `from ...core.step import a
    as b`, `from ...core import step as core_step`, `import
    ...core.step as s`."""
    direct: dict[str, str] = {}
    mod_aliases: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.endswith("core.step"):
                for a in node.names:
                    direct[a.asname or a.name] = a.name
            elif node.module.endswith("core"):
                for a in node.names:
                    if a.name == "step":
                        mod_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("core.step"):
                    mod_aliases.add(a.asname or a.name.split(".")[0])
    return direct, mod_aliases


def _factory(engine_tree: ast.AST) -> Optional[ast.FunctionDef]:
    for fn in func_defs(engine_tree):
        if fn.name == SPMD_FACTORY:
            return fn
    return None


def spmd_step_fns(engine_tree: ast.AST) -> set[str]:
    """Names of the core.step functions `make_spmd_fns`'s inner defs
    call: `core_step.f(...)` (or an imported `f(...)`), and `g(...)`
    where the factory binds `g = <expr naming step fns>` — the one level
    of closure indirection the binding uses to pick a layout."""
    factory = _factory(engine_tree)
    if factory is None:
        return set()
    direct, mod_aliases = _step_imports(engine_tree)

    def step_refs(node: ast.AST) -> set[str]:
        """core.step function names referenced anywhere under node."""
        out: set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and \
                    isinstance(n.value, ast.Name) and \
                    n.value.id in mod_aliases:
                out.add(n.attr)
            elif isinstance(n, ast.Name) and n.id in direct:
                out.add(direct[n.id])
        return out

    # Closure indirections: `name = <expr referencing step fns>`.
    indirect: dict[str, set[str]] = {}
    for node in ast.walk(factory):
        if isinstance(node, ast.Assign):
            refs = step_refs(node.value)
            if refs:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        indirect.setdefault(t.id, set()).update(refs)

    out: set[str] = set()
    for inner in func_defs(factory):
        if inner is factory:
            continue
        for n in ast.walk(inner):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name) and f.id in indirect:
                out |= indirect[f.id]
            else:
                out |= step_refs(f)
    return out


def _close_over_step(step_tree: ast.AST, roots: set[str]) -> set[str]:
    """Transitive closure of `roots` over core/step.py's module-level
    call graph (a helper a spmd step fn calls sees the shards too)."""
    module_fns = {f.name: f for f in func_defs(step_tree)}
    closed = set(roots)
    frontier = list(roots)
    while frontier:
        fn = module_fns.get(frontier.pop())
        if fn is None:
            continue
        for n in ast.walk(fn):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in module_fns
                    and n.func.id not in closed):
                closed.add(n.func.id)
                frontier.append(n.func.id)
    return closed


def _partition_aliases(fn: ast.AST) -> set[str]:
    """Local names bound (anywhere in fn) to `cfg.partitions`."""
    aliases: set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Attribute) \
                and n.value.attr == "partitions":
            for t in n.targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)
        # Tuple unpack `S, B, P = cfg.slots, cfg.max_batch, cfg.partitions`
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Tuple) \
                and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Tuple):
            for tgt, val in zip(n.targets[0].elts, n.value.elts):
                if (isinstance(tgt, ast.Name)
                        and isinstance(val, ast.Attribute)
                        and val.attr == "partitions"):
                    aliases.add(tgt.id)
    return aliases


def _reaches_partitions(node: ast.AST, aliases: set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr == "partitions":
            return True
        if isinstance(n, ast.Name) and n.id in aliases:
            return True
    return False


def _none_guard_params(fn: ast.FunctionDef) -> set[str]:
    args = fn.args
    return {a.arg for a in
            (*args.posonlyargs, *args.args, *args.kwonlyargs)}


def _is_none_guard(test: ast.AST, params: set[str]) -> bool:
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Is)
            and isinstance(test.left, ast.Name)
            and test.left.id in params
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None)


def _alloc_findings_in(fn: ast.FunctionDef, path: str) -> list[Finding]:
    params = _none_guard_params(fn)
    aliases = _partition_aliases(fn)
    findings: list[Finding] = []

    def scan_expr(node: ast.AST, allowed: bool) -> None:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name not in _ALLOC_FNS or allowed:
                continue
            if any(_reaches_partitions(a, aliases)
                   for a in (*n.args, *n.keywords)):
                findings.append(Finding(
                    rule=RULE, path=path, line=n.lineno,
                    key=f"{path}::{fn.name}::{name}",
                    message=(
                        f"`{name}` allocation shaped by cfg.partitions "
                        f"inside spmd step function {fn.name}() — under "
                        f"make_spmd_fns this body sees [local_P] shards "
                        f"with the global cfg; thread the tensor in as an "
                        f"argument (the spmd wrappers fill defaults "
                        f"before the call)"
                    ),
                ))

    def visit(stmts: list, allowed: bool) -> None:
        for st in stmts:
            if isinstance(st, ast.If):
                visit(st.body, allowed or _is_none_guard(st.test, params))
                visit(st.orelse, allowed)
                scan_expr(st.test, allowed)
            elif isinstance(st, (ast.For, ast.While, ast.With, ast.Try)):
                for field in ("body", "orelse", "finalbody"):
                    visit(getattr(st, field, []) or [], allowed)
                for h in getattr(st, "handlers", []) or []:
                    visit(h.body, allowed)
            else:
                scan_expr(st, allowed)

    visit(fn.body, False)
    return findings


def alloc_findings(step_tree: ast.AST, spmd: set[str],
                   path: str = STEP_PATH) -> list[Finding]:
    closed = _close_over_step(step_tree, spmd)
    findings: list[Finding] = []
    for fn in func_defs(step_tree):
        if fn.name in closed:
            findings.extend(_alloc_findings_in(fn, path))
    return findings


def check(repo: Repo) -> list[Finding]:
    spmd = spmd_step_fns(repo.tree(ENGINE_PATH))
    if not spmd:
        return [Finding(
            rule=RULE, path=ENGINE_PATH, line=1, key="structure::spmd",
            message=("no core.step functions derivable from "
                     "parallel/engine.py::make_spmd_fns — the derivation "
                     "in analysis/shard_shapes.py no longer matches the "
                     "binding's idiom"),
        )]
    return alloc_findings(repo.tree(STEP_PATH), spmd)

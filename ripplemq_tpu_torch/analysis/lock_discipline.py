"""Lock discipline: the locked-accessor convention, mechanized.

Two rules, both grown from review findings:

1. **No bare guarded-field reads across modules.** The host-path planes
   (`broker/dataplane.py`, `stripes/plane.py`, `storage/segment.py`)
   guard their mutable state with instance locks and export LOCKED
   ACCESSORS (`mirror_gap_slots()`, `settled_end()`, ...) for outside
   readers. The guarded set is INFERRED, not hand-listed: any `self._x`
   touched inside a `with self.<lock>:` block (or a `*_locked` method,
   whose contract is "caller holds the lock") is guarded. A read of
   such a field from any OTHER module races the owning thread — exactly
   the `_mirror_gap` and `_settled_end` review findings.

2. **No blocking calls while holding a lock.** `time.sleep`, RPC
   (`.call(...)`), `os.fsync`, and `Future.result(...)` under a held
   lock stall every thread contending it (a review pass found an
   O(n) scan under the ack lock; a *blocking* call is the same bug with
   an unbounded n). `Condition.wait` is exempt — it releases the lock.

Both cores are pure AST functions so tier-1 fixtures can seed the
regressions this checker must keep catching.
"""

from __future__ import annotations

import ast
import re

from ripplemq_tpu_torch.analysis.framework import (
    Finding,
    Repo,
    attr_chain,
    func_defs,
    walk_shallow,
)

RULE = "lock_discipline"

# The modules whose classes define the locked-accessor convention.
LOCKED_MODULES = (
    "ripplemq_tpu_torch/broker/dataplane.py",
    "ripplemq_tpu_torch/stripes/plane.py",
    "ripplemq_tpu_torch/storage/segment.py",
)

# Where bare reads and held-lock blocking calls are hunted: the whole
# library plus the card's verification script (the port's counterpart of
# the reference's profiles/ and bench.py). Tests are exempt (white-box
# reach-ins are their job).
SCAN_ROOTS = ("ripplemq_tpu_torch", "chip_smoke.py")

_LOCK_NAME = re.compile(r"^_.*lock$")


def _is_lock_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and bool(_LOCK_NAME.match(node.attr)))


def _lock_withs(fn: ast.AST):
    """With-statements in `fn` that acquire an instance lock
    (`with <expr>._lock:` / `with self._device_lock:` ...), excluding
    nested defs (a closure body runs outside the lock)."""
    for node in walk_shallow(fn):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if any(_is_lock_attr(item.context_expr) for item in node.items):
            yield node


def _self_private_attrs(node: ast.AST) -> set[str]:
    """`self._x` attribute names under `node` (shallow: nested defs are
    separate scopes)."""
    out = set()
    for n in walk_shallow(node):
        if (isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"
                and n.attr.startswith("_")
                and not n.attr.startswith("__")):
            out.add(n.attr)
    return out


def guarded_fields(tree: ast.AST) -> dict[str, set[str]]:
    """Infer each class's lock-guarded field set: `self._x` touched
    under a `with self.<lock>:` block or inside a `*_locked` method.
    Method names and the locks themselves are excluded — the guarded
    set is DATA the accessors wrap, not the accessors."""
    out: dict[str, set[str]] = {}
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        methods = {m.name for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        fields: set[str] = set()
        for m in cls.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for w in _lock_withs(m):
                fields |= _self_private_attrs(w)
            if m.name.endswith("_locked"):
                fields |= _self_private_attrs(m)
        fields -= methods
        fields = {f for f in fields if not _LOCK_NAME.match(f)}
        if fields:
            out[cls.name] = fields
    return out


def bare_reads(path: str, tree: ast.AST,
               guarded: dict[str, set[str]]) -> list[Finding]:
    """Cross-module accesses `<expr>._field` where `_field` is guarded
    by some convention class and this module defines no `self._field`
    of its own (so it cannot be a same-class access)."""
    all_guarded: dict[str, str] = {}
    for cls, fields in guarded.items():
        for f in fields:
            all_guarded[f] = cls
    own = set()
    for n in ast.walk(tree):
        if (isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"
                and isinstance(n.ctx, ast.Store)):
            own.add(n.attr)
    findings: list[Finding] = []

    # Track enclosing function names for stable keys.
    def visit(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            child_scope = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_scope = child.name
            if (isinstance(child, ast.Attribute)
                    and child.attr in all_guarded
                    and child.attr not in own
                    and not (isinstance(child.value, ast.Name)
                             and child.value.id in ("self", "cls"))):
                owner = all_guarded[child.attr]
                findings.append(Finding(
                    rule=RULE, path=path, line=child.lineno,
                    key=f"{path}::{scope}::{child.attr}",
                    message=(
                        f"bare read of lock-guarded field "
                        f"`{attr_chain(child)}` ({owner}.{child.attr} is "
                        f"guarded by the plane's lock) — use or add a "
                        f"locked accessor"
                    ),
                ))
            visit(child, child_scope)

    visit(tree, "<module>")
    return findings


# Blocking calls under a held lock. Attribute-terminal names plus the
# two module-level classics. `.wait(...)` (Condition) releases the lock
# and is exempt by omission.
_BLOCKING_ATTRS = {"result", "call", "call_async_wait"}
_BLOCKING_MODULE_CALLS = {("time", "sleep"), ("os", "fsync")}


def blocking_under_lock(path: str, tree: ast.AST) -> list[Finding]:
    findings: list[Finding] = []
    for fn in func_defs(tree):
        for w in _lock_withs(fn):
            for node in walk_shallow(w):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                hit = None
                if isinstance(f, ast.Attribute):
                    if (isinstance(f.value, ast.Name)
                            and (f.value.id, f.attr)
                            in _BLOCKING_MODULE_CALLS):
                        hit = f"{f.value.id}.{f.attr}"
                    elif f.attr in _BLOCKING_ATTRS:
                        hit = attr_chain(f)
                if hit is not None:
                    findings.append(Finding(
                        rule=RULE, path=path, line=node.lineno,
                        key=f"{path}::{fn.name}::{hit.rsplit('.', 1)[-1]}",
                        message=(
                            f"blocking call `{hit}(...)` while holding a "
                            f"lock in {fn.name}() — every contender stalls "
                            f"behind it; move it outside the critical "
                            f"section"
                        ),
                    ))
    return findings


def check(repo: Repo) -> list[Finding]:
    guarded: dict[str, set[str]] = {}
    defining: dict[str, set[str]] = {}  # field -> defining module paths
    for mod in LOCKED_MODULES:
        if not repo.exists(mod):
            continue
        g = guarded_fields(repo.tree(mod))
        for cls, fields in g.items():
            guarded.setdefault(cls, set()).update(fields)
            for f in fields:
                defining.setdefault(f, set()).add(mod)

    findings: list[Finding] = []
    for path in repo.py_files(*SCAN_ROOTS):
        if path.startswith("ripplemq_tpu_torch/analysis/"):
            continue  # the lint plane itself is not a host-path module
        tree = repo.tree(path)
        # The LOCKED_MODULES are scanned too — a reach-in from one
        # host-path plane into another's guarded state is the same race
        # (dataplane reading a SegmentStore private, say). Fields the
        # scanned module itself DEFINES are excluded here (and again by
        # bare_reads' own-field check), so a plane's access to its own
        # guarded state never trips the cross-module rule.
        per_mod_guarded = {
            cls: {f for f in fields if path not in defining.get(f, ())}
            for cls, fields in guarded.items()
        }
        findings.extend(bare_reads(path, tree, per_mod_guarded))
        findings.extend(blocking_under_lock(path, tree))
    return findings

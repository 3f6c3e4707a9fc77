"""Retry-taxonomy completeness: every wire error is classified.

`wire/retry.py` classifies application error strings retryable-vs-fatal
(`fatal_response_error`). The classification only works if every typed
error the brokers actually EMIT is in the taxonomy: the
`fenced_generation` refusal once shipped unclassified and clients
blind-retried a fence until review caught it. This checker closes the
loop from the emit side:

- An emit site is any dict literal of the wire refusal shape
  (`{"ok": False, ..., "error": <literal>}`) anywhere in the library.
- Its typed prefix (the text before the first `:`) must appear in
  exactly one of `FATAL_ERROR_PREFIXES` / `RETRYABLE_ERROR_PREFIXES`
  in `wire/retry.py`.
- An error string with NO static prefix (a bare f-string) is untyped —
  clients cannot classify what they cannot name.
- The two taxonomy sets must be disjoint (prefix-wise), and every
  taxonomy entry must still have at least one emit site (a dead entry
  is a renamed error whose old classification silently lingers).
"""

from __future__ import annotations

import ast
from typing import Optional

from ripplemq_tpu_torch.analysis.framework import Finding, Repo

RULE = "retry_taxonomy"

RETRY_PATH = "ripplemq_tpu_torch/wire/retry.py"
SCAN_ROOTS = ("ripplemq_tpu_torch",)
FATAL_NAME = "FATAL_ERROR_PREFIXES"
RETRYABLE_NAME = "RETRYABLE_ERROR_PREFIXES"


def taxonomy(retry_tree: ast.AST) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(fatal, retryable) prefix tuples from wire/retry.py's module
    level. Missing assignment -> empty tuple (the checker reports)."""
    out = {FATAL_NAME: (), RETRYABLE_NAME: ()}
    for node in retry_tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in out:
                vals = []
                for elt in ast.walk(node.value):
                    if (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)):
                        vals.append(elt.value)
                out[t.id] = tuple(vals)
    return out[FATAL_NAME], out[RETRYABLE_NAME]


def _static_prefix(value: ast.AST) -> tuple[Optional[str], bool]:
    """(typed prefix, is_literal) of an error-value expression.

    Constant str -> its leading segment. f-string starting with a str
    constant -> that constant's leading segment. f-string starting with
    an interpolation -> (None, True): a LITERAL emit with no type.
    Non-literal (a variable, a call) -> (None, False): not an emit site
    this checker judges — the value was classified where it was built.
    """
    if isinstance(value, ast.Constant) and isinstance(value.value, str):
        return value.value.split(":")[0].strip(), True
    if isinstance(value, ast.JoinedStr):
        if value.values and isinstance(value.values[0], ast.Constant) \
                and isinstance(value.values[0].value, str):
            head = value.values[0].value
            prefix = head.split(":")[0].strip()
            # A leading fragment that runs straight into an
            # interpolation without a `:` separator is not a stable
            # type ("bad shard name {x}" reads as prose, not a type) —
            # still better than nothing; classify on the fragment.
            return (prefix if prefix else None), True
        return None, True
    return None, False


def error_emits(tree: ast.AST) -> list[tuple[int, Optional[str], str]]:
    """(line, typed-prefix-or-None, enclosing-scope) for every wire
    refusal literal: a dict containing both `"ok": False` and an
    `"error"` literal. The scope (function/class name, "<module>" at
    top level) keys untyped findings stably — never a line number."""
    out: list[tuple[int, Optional[str], str]] = []

    def visit(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            child_scope = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_scope = child.name
            if isinstance(child, ast.Dict):
                keys = [k.value if isinstance(k, ast.Constant) else None
                        for k in child.keys]
                if "ok" in keys and "error" in keys:
                    ok_val = child.values[keys.index("ok")]
                    if isinstance(ok_val, ast.Constant) \
                            and ok_val.value is False:
                        err_val = child.values[keys.index("error")]
                        prefix, is_literal = _static_prefix(err_val)
                        if is_literal:
                            out.append((err_val.lineno, prefix, scope))
            visit(child, child_scope)

    visit(tree, "<module>")
    return out


def classify(prefix: str, fatal: tuple[str, ...],
             retryable: tuple[str, ...]) -> Optional[str]:
    """'fatal' / 'retryable' / None (unclassified). Matching mirrors
    fatal_response_error exactly: the emitted string startswith the
    taxonomy prefix (lenience here would classify strings the runtime
    doesn't)."""
    if any(prefix.startswith(p) for p in fatal):
        return "fatal"
    if any(prefix.startswith(p) for p in retryable):
        return "retryable"
    return None


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    fatal, retryable = taxonomy(repo.tree(RETRY_PATH))
    if not fatal or not retryable:
        findings.append(Finding(
            rule=RULE, path=RETRY_PATH, line=1,
            key="taxonomy::missing",
            message=(f"wire/retry.py must define both {FATAL_NAME} and "
                     f"{RETRYABLE_NAME}"),
        ))
        return findings
    for f in fatal:
        for r in retryable:
            if f.startswith(r) or r.startswith(f):
                findings.append(Finding(
                    rule=RULE, path=RETRY_PATH, line=1,
                    key=f"overlap::{f}::{r}",
                    message=(f"taxonomy prefixes overlap: fatal {f!r} vs "
                             f"retryable {r!r} — classification is "
                             f"order-dependent"),
                ))

    seen_prefixes: set[str] = set()
    untyped_ord: dict[tuple[str, str], int] = {}
    for path in repo.py_files(*SCAN_ROOTS):
        if path.startswith("ripplemq_tpu_torch/analysis/"):
            continue
        for line, prefix, scope in error_emits(repo.tree(path)):
            if prefix is None:
                # Stable key: path + enclosing scope + per-scope
                # ordinal (a second untyped emit in the same function
                # gets its own key instead of inheriting a waiver).
                n = untyped_ord.get((path, scope), 0)
                untyped_ord[(path, scope)] = n + 1
                suffix = f"#{n + 1}" if n else ""
                findings.append(Finding(
                    rule=RULE, path=path, line=line,
                    key=f"{path}::{scope}::untyped{suffix}",
                    message=("untyped wire error: the string starts with "
                             "an interpolation, so no client can classify "
                             "it — give it a typed prefix"),
                ))
                continue
            seen_prefixes.add(prefix)
            if classify(prefix, fatal, retryable) is None:
                findings.append(Finding(
                    rule=RULE, path=path, line=line,
                    key=f"unclassified::{prefix}",
                    message=(
                        f"typed wire error {prefix!r} is in neither "
                        f"{FATAL_NAME} nor {RETRYABLE_NAME} — clients "
                        f"fall through to default-retryable without a "
                        f"recorded decision"
                    ),
                ))

    for entry in (*fatal, *retryable):
        if not any(p.startswith(entry) for p in seen_prefixes):
            findings.append(Finding(
                rule=RULE, path=RETRY_PATH, line=1,
                key=f"dead::{entry}",
                message=(f"taxonomy entry {entry!r} has no emit site — a "
                         f"renamed error keeps its stale classification"),
            ))
    return findings

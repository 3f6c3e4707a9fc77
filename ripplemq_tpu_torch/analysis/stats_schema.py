"""admin.stats schema sync: the key-set is DERIVED from emit sites.

The reference's schema lock in `tests/test_observability.py` used to be a
hand-maintained exact key-set — which means adding a stats field was a
three-file convention (emit site, test set, README table) enforced by
nothing. This checker derives the key-set from the one place it is
true by construction — the emit sites — and makes the other two
surfaces follow:

- top-level and engine keys from `BrokerServer._handle_stats` (dict
  literal + subscript assignments; a key assigned only under a
  request-gated `if` is OPTIONAL, e.g. `engine["slots"]`);
- settle keys from `DataPlane.settle_stats`'s returned literal;
- per-group keys from `GroupTable.summary`'s value literal;
- every derived key must be documented in the README
  "admin.stats schema" section.

`tests/test_torch_observability.py` imports this `derive_schema()` and
asserts a port broker's LIVE RPC response matches the derived sets
exactly (the README section is shared with the JAX package, whose
heading names its own test) — so a new stats
field fails lint (undocumented) instead of silently widening the
schema, and a dynamically-added key the AST cannot see fails the test.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Optional

from ripplemq_tpu_torch.analysis.framework import (
    Finding,
    Repo,
    find_func,
    markdown_section,
)

RULE = "stats_schema"

SERVER_PATH = "ripplemq_tpu_torch/broker/server.py"
DATAPLANE_PATH = "ripplemq_tpu_torch/broker/dataplane.py"
GROUPS_PATH = "ripplemq_tpu_torch/groups/coordinator.py"
README_PATH = "README.md"
README_HEADING = ("### admin.stats schema "
                  "(locked by `tests/test_observability.py`)")

# The REMOVAL floor. Deriving the schema from emit sites catches
# additions (new key -> must be documented) but would follow a
# DELETION silently — the derived set shrinks with the emit site and
# every check still passes while bench/profile readers KeyError at
# runtime. These are the keys external consumers already load-bearingly
# read; a key can only leave the schema by deliberately removing it
# HERE in the same change (the old hand-lock's guarantee, kept at
# exactly the place the rule lives). New keys do NOT need to be added.
BASELINE_KEYS = {
    "top": frozenset({
        "ok", "broker", "address", "boot_failures", "store_quarantined",
        "metadata", "controller", "topics", "live", "duty_errors",
        "erasure_errors", "engine", "groups", "producer_ids",
        "dirty_consumer_slots", "stripe_mode", "stripe_holders",
        "stripe_rebuilds",
    }),
    "engine": frozenset({
        "mode", "rounds", "dispatches", "read_queries", "read_dispatches",
        "read_cache_hits", "mirror_gap_slots", "settled_gap_slots",
        "stalled_slots", "committed_entries", "step_errors", "settle",
        "partitions", "degraded_slots", "degraded", "pid_table_size",
    }),
    "settle": frozenset({"window", "occupancy_mean", "samples",
                         "backpressure_waits"}),
    "group": frozenset({"generation", "members", "partitions"}),
}


@dataclasses.dataclass(frozen=True)
class StatsSchema:
    top: frozenset
    engine: frozenset
    engine_optional: frozenset
    settle: frozenset
    group: frozenset


def dict_flow(fn: ast.FunctionDef,
              varname: str) -> tuple[set[str], set[str]]:
    """(required, optional) string keys of the dict named `varname`
    built inside `fn`: literal keys plus `var["k"] = ...` subscript
    assignments, starting at the creation site. A key assigned in both
    arms of an `if` is required; one assigned in only one arm (or under
    a loop/try) is optional."""

    def creation_block(stmts: list) -> Optional[list]:
        for st in stmts:
            if (isinstance(st, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == varname
                            for t in st.targets)
                    and isinstance(st.value, ast.Dict)):
                return stmts
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if sub:
                    found = creation_block(sub)
                    if found is not None:
                        return found
            for h in getattr(st, "handlers", []) or []:
                found = creation_block(h.body)
                if found is not None:
                    return found
        return None

    def literal_keys(d: ast.Dict) -> set[str]:
        return {k.value for k in d.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}

    def visit(stmts: list) -> tuple[set[str], set[str]]:
        req: set[str] = set()
        opt: set[str] = set()
        for st in stmts:
            if (isinstance(st, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == varname
                            for t in st.targets)
                    and isinstance(st.value, ast.Dict)):
                req |= literal_keys(st.value)
            elif isinstance(st, ast.Assign):
                for t in st.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == varname
                            and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)):
                        req.add(t.slice.value)
            if isinstance(st, ast.If):
                r1, o1 = visit(st.body)
                r2, o2 = visit(st.orelse)
                req |= r1 & r2
                opt |= (r1 ^ r2) | o1 | o2
            elif isinstance(st, (ast.For, ast.While, ast.With, ast.Try)):
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if sub:
                        r, o = visit(sub)
                        # With runs unconditionally; loops/try may not.
                        if isinstance(st, ast.With):
                            req |= r
                            opt |= o
                        else:
                            opt |= r | o
                for h in getattr(st, "handlers", []) or []:
                    r, o = visit(h.body)
                    opt |= r | o
        return req, opt

    block = creation_block(fn.body)
    if block is None:
        return set(), set()
    req, opt = visit(block)
    return req, opt - req


def return_dict_keys(fn: Optional[ast.FunctionDef]) -> set[str]:
    """Keys of the first dict literal returned by `fn`."""
    if fn is None:
        return set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return set()


def value_dict_keys(fn: Optional[ast.FunctionDef]) -> set[str]:
    """Keys of the inner (per-entry) dict literal in a summary-style
    `{name: {...}}` comprehension/literal."""
    if fn is None:
        return set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.DictComp, ast.Dict)):
            inner = node.value if isinstance(node, ast.DictComp) else None
            if inner is None and isinstance(node, ast.Dict):
                for v in node.values:
                    if isinstance(v, ast.Dict):
                        inner = v
                        break
            if isinstance(inner, ast.Dict):
                keys = {k.value for k in inner.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
                if keys:
                    return keys
    return set()


def derive(server_tree: ast.AST, dataplane_tree: ast.AST,
           groups_tree: ast.AST) -> tuple[StatsSchema, list[Finding]]:
    findings: list[Finding] = []
    handle = find_func(server_tree, "_handle_stats")
    if handle is None:
        findings.append(Finding(
            rule=RULE, path=SERVER_PATH, line=1, key="structure::handler",
            message="_handle_stats not found — update analysis/"
                    "stats_schema.py to the new emit site"))
        empty = frozenset()
        return StatsSchema(empty, empty, empty, empty, empty), findings
    top, top_opt = dict_flow(handle, "stats")
    if top_opt:
        findings.append(Finding(
            rule=RULE, path=SERVER_PATH, line=handle.lineno,
            key="structure::conditional-top",
            message=(f"top-level admin.stats keys assigned only "
                     f"conditionally: {sorted(top_opt)} — pollers cannot "
                     f"rely on the schema; assign in every branch"),
        ))
    engine, engine_opt = dict_flow(handle, "engine")
    settle = return_dict_keys(find_func(dataplane_tree, "settle_stats"))
    group = value_dict_keys(find_func(groups_tree, "summary"))
    schema = StatsSchema(frozenset(top), frozenset(engine),
                         frozenset(engine_opt), frozenset(settle),
                         frozenset(group))
    return schema, findings


def derive_schema(root: Optional[pathlib.Path] = None) -> StatsSchema:
    """The derived schema (convenience entry for the tier-1 schema-lock
    test). Raises if the emit sites cannot be derived."""
    repo = Repo(root)
    schema, findings = derive(repo.tree(SERVER_PATH),
                              repo.tree(DATAPLANE_PATH),
                              repo.tree(GROUPS_PATH))
    if findings:
        raise RuntimeError(f"stats schema underivable: {findings}")
    return schema


def check(repo: Repo) -> list[Finding]:
    schema, findings = derive(repo.tree(SERVER_PATH),
                              repo.tree(DATAPLANE_PATH),
                              repo.tree(GROUPS_PATH))
    for name, keys in (("top", schema.top), ("engine", schema.engine),
                       ("settle", schema.settle), ("group", schema.group)):
        if not keys:
            findings.append(Finding(
                rule=RULE, path=SERVER_PATH, line=1,
                key=f"structure::{name}-empty",
                message=f"derived {name} stats key-set is empty — the "
                        f"emit-site derivation broke"))
        for gone in sorted(BASELINE_KEYS[name] - keys):
            findings.append(Finding(
                rule=RULE, path=SERVER_PATH, line=1,
                key=f"removed::{name}::{gone}",
                message=(
                    f"admin.stats {name} key `{gone}` vanished from the "
                    f"emit site but external readers consume it — "
                    f"removing a field is a deliberate change to "
                    f"BASELINE_KEYS (analysis/stats_schema.py) and the "
                    f"README table, not a refactor side effect"
                ),
            ))
    section = markdown_section(repo.text(README_PATH), README_HEADING)
    if not section:
        findings.append(Finding(
            rule=RULE, path=README_PATH, line=1, key="readme::section",
            message=f"README section {README_HEADING!r} missing"))
        return findings
    documented = set()
    for token in section.replace("`", " ").replace(",", " ").split():
        documented.add(token.strip("().:;*"))
    for name, keys in (("top", schema.top),
                       ("engine", schema.engine | schema.engine_optional),
                       ("settle", schema.settle), ("group", schema.group)):
        for k in sorted(keys):
            if k not in documented:
                findings.append(Finding(
                    rule=RULE, path=README_PATH, line=1,
                    key=f"readme::{name}::{k}",
                    message=(f"admin.stats {name} key `{k}` is emitted "
                             f"but undocumented in the README schema "
                             f"section"),
                ))
    return findings

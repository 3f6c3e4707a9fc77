"""Config plumbing: every ClusterConfig field reaches every surface.

A ClusterConfig field is only real when it survives three hops a PR
author must each remember by hand:

1. **YAML parsing** — `parse_cluster_config` in
   `metadata/cluster_config.py` (a field missing here cannot be set by
   a deployment file at all);
2. **proc-cluster serialization** — `_config_yaml_dict` in
   `chaos/proc_cluster.py`, the ClusterConfig -> YAML inverse the
   subprocess chaos backend launches real brokers with (a field missing
   here is SILENTLY DROPPED on the proc backend: the in-proc soak tests
   one config, the subprocess soak another);
3. **the README field table** — the "Configuration reference" section
   (an undocumented knob is an unusable knob).

The checker reads the dataclass field list from the AST and demands
each name appear in all three places (string literal or attribute
access in the two functions; verbatim text in the README section), or
be explicitly waived with a reason. EngineConfig rides inside the
`engine:` mapping and is plumbed structurally, so only its top-level
presence is checked.
"""

from __future__ import annotations

import ast
from typing import Optional

from ripplemq_tpu_torch.analysis.framework import (
    Finding,
    Repo,
    attr_names,
    find_class,
    find_func,
    markdown_section,
    str_consts,
)

RULE = "config_plumbing"

CONFIG_PATH = "ripplemq_tpu_torch/metadata/cluster_config.py"
CONFIG_CLASS = "ClusterConfig"
PARSE_FN = "parse_cluster_config"
PROC_PATH = "ripplemq_tpu_torch/chaos/proc_cluster.py"
PROC_FN = "_config_yaml_dict"
README_PATH = "README.md"
README_HEADING = "## Configuration reference"


def config_fields(tree: ast.AST,
                  cls_name: str = CONFIG_CLASS) -> list[str]:
    """Declared field names of the config dataclass, in order."""
    cls = find_class(tree, cls_name)
    if cls is None:
        return []
    out = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            out.append(node.target.id)
    return out


def names_reached(fn: Optional[ast.AST]) -> set[str]:
    """Every way a field name can be threaded through a plumbing
    function: as a string key/lookup or as an attribute access."""
    if fn is None:
        return set()
    return str_consts(fn) | attr_names(fn)


def missing_fields(fields: list[str], reached: set[str],
                   surface: str, path: str) -> list[Finding]:
    out = []
    for f in fields:
        if f not in reached:
            out.append(Finding(
                rule=RULE, path=path, line=1,
                key=f"{surface}::{f}",
                message=(
                    f"ClusterConfig.{f} never reaches {surface} "
                    f"({path}) — the field is silently dropped on that "
                    f"surface; plumb it or waive it with a reason"
                ),
            ))
    return out


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    cfg_tree = repo.tree(CONFIG_PATH)
    fields = config_fields(cfg_tree)
    if not fields:
        return [Finding(rule=RULE, path=CONFIG_PATH, line=1,
                        key="structure::ClusterConfig",
                        message="ClusterConfig dataclass not found")]

    parse = find_func(cfg_tree, PARSE_FN)
    findings += missing_fields(fields, names_reached(parse),
                               "yaml", CONFIG_PATH)

    proc = find_func(repo.tree(PROC_PATH), PROC_FN)
    findings += missing_fields(fields, names_reached(proc),
                               "proc", PROC_PATH)

    section = markdown_section(repo.text(README_PATH), README_HEADING)
    if not section:
        findings.append(Finding(
            rule=RULE, path=README_PATH, line=1,
            key="readme::section",
            message=(f"README has no {README_HEADING!r} section — the "
                     f"config field table is the third plumbing surface"),
        ))
    else:
        for f in fields:
            if f"`{f}`" not in section and f not in section.split():
                findings.append(Finding(
                    rule=RULE, path=README_PATH, line=1,
                    key=f"readme::{f}",
                    message=(f"ClusterConfig.{f} is undocumented in the "
                             f"README {README_HEADING!r} table"),
                ))
    return findings

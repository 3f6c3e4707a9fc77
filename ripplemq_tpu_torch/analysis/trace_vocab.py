"""Trace-event AND span-kind vocabularies: emit sites match the docs.

The flight recorder (`obs/trace.py`) is only a diagnosis surface if
the event names it records are a CLOSED VOCABULARY: timeline tooling,
chaos-verdict readers, and the README all key on them. The
`stripe_rebuild` emits once landed without touching the documented
set — exactly the drift this checker stops. The causal-tracing plane
(`obs/spans.py`) has the same shape and the same failure mode: the assembler, the
trace_view renderer, and the acceptance harness all key on span KINDS,
so the kinds are a second closed vocabulary under the same rule.

- `obs/trace.py` owns the canonical `EVENT_TYPES` frozenset;
  `obs/spans.py` owns the canonical `SPAN_KINDS` frozenset.
- Every library emit site — a positional string literal handed to a
  `.record("name", ...)` call, or to a `.span("kind", ...)` /
  `.span_at("kind", ...)` call — must name a member. (The chaos
  HISTORY's `history.record(op=...)` calls are keyword-only and thus
  naturally out of scope; histories are operation logs, not traces.)
- Every member must still have at least one emit site (a dead name is
  a renamed event whose documentation now lies).
- Every event must appear in the README Observability section; every
  span kind in the README Causal-tracing section.
"""

from __future__ import annotations

import ast

from ripplemq_tpu_torch.analysis.framework import (
    Finding,
    Repo,
    markdown_section,
)

RULE = "trace_vocab"

TRACE_PATH = "ripplemq_tpu_torch/obs/trace.py"
VOCAB_NAME = "EVENT_TYPES"
SPANS_PATH = "ripplemq_tpu_torch/obs/spans.py"
SPAN_VOCAB_NAME = "SPAN_KINDS"
SCAN_ROOTS = ("ripplemq_tpu_torch",)
README_PATH = "README.md"
README_HEADING = "## Observability"
SPAN_README_HEADING = "## Causal tracing"


def vocabulary(tree: ast.AST, name: str = VOCAB_NAME) -> frozenset:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return frozenset(
                n.value for n in ast.walk(node.value)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            )
    return frozenset()


def emit_sites(tree: ast.AST,
               attrs: tuple = ("record",)) -> list[tuple[int, str]]:
    """(line, name) for every `<expr>.<attr>("name", ...)` call with a
    positional string-literal first argument."""
    out: list[tuple[int, str]] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in attrs
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.append((node.lineno, node.args[0].value))
    return out


def _check_vocab(repo, vocab, vocab_path, vocab_name, attrs,
                 heading, surface, section_key) -> list[Finding]:
    findings: list[Finding] = []
    emitted: set[str] = set()
    for path in repo.py_files(*SCAN_ROOTS):
        if path.startswith("ripplemq_tpu_torch/analysis/"):
            continue
        for line, name in emit_sites(repo.tree(path), attrs):
            emitted.add(name)
            if name not in vocab:
                findings.append(Finding(
                    rule=RULE, path=path, line=line,
                    key=f"undocumented::{name}",
                    message=(f"{surface} {name!r} emitted but absent "
                             f"from {vocab_name} ({vocab_path}) — extend "
                             f"the vocabulary (and the README) or rename "
                             f"the emit"),
                ))
    for name in sorted(vocab - emitted):
        findings.append(Finding(
            rule=RULE, path=vocab_path, line=1, key=f"dead::{name}",
            message=(f"vocabulary {surface} {name!r} has no emit site — "
                     f"remove it or restore the emit"),
        ))

    body = markdown_section(repo.text(README_PATH), heading)
    if not body:
        findings.append(Finding(
            rule=RULE, path=README_PATH, line=1, key=section_key,
            message=f"README {heading!r} section missing"))
        return findings
    for name in sorted(vocab):
        if f"`{name}`" not in body:
            findings.append(Finding(
                rule=RULE, path=README_PATH, line=1, key=f"readme::{name}",
                message=(f"{surface} `{name}` undocumented in the README "
                         f"{heading!r} section"),
            ))
    return findings


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []

    vocab = vocabulary(repo.tree(TRACE_PATH), VOCAB_NAME)
    if not vocab:
        findings.append(Finding(
            rule=RULE, path=TRACE_PATH, line=1, key="structure::vocab",
            message=f"{VOCAB_NAME} missing from obs/trace.py — the "
                    f"canonical event vocabulary must live beside the "
                    f"recorder"))
    else:
        findings.extend(_check_vocab(
            repo, vocab, TRACE_PATH, VOCAB_NAME, ("record",),
            README_HEADING, "trace event", "readme::section"))

    span_vocab = (vocabulary(repo.tree(SPANS_PATH), SPAN_VOCAB_NAME)
                  if repo.exists(SPANS_PATH) else frozenset())
    if not span_vocab:
        findings.append(Finding(
            rule=RULE, path=SPANS_PATH, line=1, key="structure::span_vocab",
            message=f"{SPAN_VOCAB_NAME} missing from obs/spans.py — the "
                    f"canonical span-kind vocabulary must live beside the "
                    f"span ring"))
    else:
        findings.extend(_check_vocab(
            repo, span_vocab, SPANS_PATH, SPAN_VOCAB_NAME,
            ("span", "span_at"), SPAN_README_HEADING, "span kind",
            "readme::span_section"))
    return findings

"""ripplelint: the repo-native static-analysis plane.

Every PR since the chaos plane has shipped a review-driven hardening
tail fixing the same mechanical bug classes: bare reads of lock-guarded
fields outside their locked accessors (the `_mirror_gap` /
`_settled_end` lesson, an O(n) scan under the ack lock), config
fields hand-threaded through three serialization surfaces and silently
dropped from one, typed wire errors nobody classified in the retry
taxonomy, and wall-clock/randomness leaking into machinery whose whole
value is determinism. The chaos plane's lesson (Jepsen/Elle,
arXiv:2003.10554) is that checkable invariants beat code review; this
package applies it at LINT time instead of soak time — the bug classes
the chaos plane keeps *finding* stop being *writable*.

Architecture:

- Each checker is a function `check(repo) -> list[Finding]` built on a
  pure core that takes parsed ASTs, so tier-1 fixture tests can prove a
  checker catches its seeded regression without touching the tree.
- Findings are keyed stably (`path::scope::symbol`, never line numbers)
  so the suppression ledger survives unrelated edits.
- The suppression ledger (`analysis/ledger.py`) is the ONLY way to ship
  a finding: every waiver names its rule, its finding key, and a reason
  string. A waiver that stops matching anything is itself a finding
  (stale waivers silently shrink coverage — the FAST_MODULES lesson).
- `run_lint()` produces a machine-readable verdict (per-checker finding
  counts + runtime); `python -m ripplemq_tpu_torch.analysis --json`
  is the CLI and `tests/test_torch_lint.py` asserts the tree is clean
  in tier-1.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import time
from typing import Callable, Iterable, Optional

# Repo root: ripplemq_tpu_torch/analysis/framework.py -> repo
REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    `key` is the stable identity a waiver matches (path + enclosing
    scope + symbol — never a line number, so waivers survive edits
    above the site). `line` is for humans and editors only.
    """

    rule: str
    path: str
    line: int
    key: str
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Waiver:
    """One ledger entry: (rule, key) must match a live finding, and the
    reason string is mandatory — a waiver without a WHY is just a
    deleted check."""

    rule: str
    key: str
    reason: str


class LedgerError(Exception):
    """The suppression ledger itself is malformed (empty reason,
    unknown rule). Lint refuses to run rather than run diluted."""


class Repo:
    """Parsed view of the repo: cached source text + ASTs, path
    enumeration. Checkers never touch the filesystem directly, so
    fixture tests can run their pure cores on `ast.parse(snippet)`."""

    def __init__(self, root: Optional[pathlib.Path] = None) -> None:
        self.root = pathlib.Path(root) if root is not None else REPO_ROOT
        self._texts: dict[str, str] = {}
        self._trees: dict[str, ast.AST] = {}
        # Cross-checker memo: expensive derived artifacts (the repo
        # call graph, the thread inventory) memoize here so one lint
        # run computes each ONCE (analysis/callgraph.graph et al.).
        self.cache: dict = {}

    def exists(self, rel: str) -> bool:
        return (self.root / rel).is_file()

    def text(self, rel: str) -> str:
        if rel not in self._texts:
            self._texts[rel] = (self.root / rel).read_text()
        return self._texts[rel]

    def tree(self, rel: str) -> ast.AST:
        if rel not in self._trees:
            self._trees[rel] = ast.parse(self.text(rel), filename=rel)
        return self._trees[rel]

    def py_files(self, *subdirs: str) -> list[str]:
        """Repo-relative posix paths of every .py under the subdirs
        (files allowed too, e.g. "bench.py"), __pycache__ excluded,
        sorted for deterministic finding order."""
        out: list[str] = []
        for sub in subdirs:
            p = self.root / sub
            if p.is_file():
                out.append(sub)
                continue
            if not p.is_dir():
                continue  # fixture repos carry only the dirs they seed
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" in f.parts:
                    continue
                out.append(f.relative_to(self.root).as_posix())
        return out


# --------------------------------------------------------------- AST helpers
# Shared by several checkers; kept here so fixture tests exercise the
# same traversal the real run uses.


def walk_shallow(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that does NOT descend into nested function/class defs:
    a closure defined under a lock runs later, outside the lock; a
    nested class is its own scope."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def func_defs(tree: ast.AST) -> list[ast.FunctionDef]:
    """Every function def in the tree (any nesting), in source order."""
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def attr_chain(node: ast.AST) -> str:
    """Dotted name for a Name/Attribute chain ('self._rep._lock');
    '<expr>' stands in for non-name links (calls, subscripts)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("<expr>")
    return ".".join(reversed(parts))


def str_consts(node: ast.AST) -> set[str]:
    """All string constants anywhere under `node`."""
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def attr_names(node: ast.AST) -> set[str]:
    """All attribute names accessed anywhere under `node`."""
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def find_class(tree: ast.AST, name: str) -> Optional[ast.ClassDef]:
    for n in ast.walk(tree):
        if isinstance(n, ast.ClassDef) and n.name == name:
            return n
    return None


def find_func(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for n in func_defs(tree):
        if n.name == name:
            return n
    return None


def markdown_section(text: str, heading: str) -> str:
    """The body of one markdown section: from `heading` (a full '## x'
    line) to the next heading of the same-or-higher level. Empty string
    when the heading is absent (checkers turn that into a finding)."""
    lines = text.splitlines()
    level = len(heading) - len(heading.lstrip("#"))
    out: list[str] = []
    active = False
    for ln in lines:
        if ln.strip() == heading:
            active = True
            continue
        if active and ln.startswith("#"):
            this = len(ln) - len(ln.lstrip("#"))
            if this <= level:
                break
        if active:
            out.append(ln)
    return "\n".join(out)


# ------------------------------------------------------------------ running

CheckerFn = Callable[[Repo], list[Finding]]


def validate_ledger(waivers: Iterable[Waiver],
                    known_rules: Iterable[str]) -> None:
    known = set(known_rules)
    for w in waivers:
        if not isinstance(w.reason, str) or not w.reason.strip():
            raise LedgerError(
                f"waiver {w.rule}:{w.key} has no reason — every "
                f"suppression must say WHY (analysis/ledger.py)"
            )
        if w.rule not in known:
            raise LedgerError(
                f"waiver names unknown rule {w.rule!r} "
                f"(known: {sorted(known)})"
            )


def run_lint(
    root: Optional[pathlib.Path] = None,
    rules: Optional[Iterable[str]] = None,
    waivers: Optional[Iterable[Waiver]] = None,
) -> dict:
    """Run every (or the named) checkers over the repo and fold in the
    suppression ledger. Returns the machine-readable verdict
    `python -m ripplemq_tpu_torch.analysis --json` emits:

    {ok, root, checkers: {rule: {findings, waived, count, runtime_s}},
     unwaived_total, stale_waivers, runtime_s}

    `ok` is True iff zero unwaived findings AND zero stale waivers.
    """
    # Imported here (not module top) to keep framework <-> checker
    # imports acyclic: checkers import the framework.
    from ripplemq_tpu_torch.analysis import CHECKERS
    from ripplemq_tpu_torch.analysis.ledger import WAIVERS

    if waivers is None:
        waivers = WAIVERS
    waivers = tuple(waivers)
    validate_ledger(waivers, CHECKERS.keys())

    selected = dict(CHECKERS)
    if rules is not None:
        rules = list(rules)
        unknown = [r for r in rules if r not in selected]
        if unknown:
            raise KeyError(f"unknown rules {unknown}; "
                           f"known: {sorted(selected)}")
        selected = {r: selected[r] for r in rules}

    repo = Repo(root)
    t_start = time.perf_counter()
    report: dict = {"root": str(repo.root), "checkers": {}}
    matched: set[tuple[str, str]] = set()
    unwaived_total = 0
    waiver_index = {(w.rule, w.key): w for w in waivers}

    for rule, fn in selected.items():
        t0 = time.perf_counter()
        findings = fn(repo)
        live: list[dict] = []
        waived: list[dict] = []
        for f in findings:
            w = waiver_index.get((f.rule, f.key))
            if w is not None:
                matched.add((f.rule, f.key))
                waived.append({**f.to_dict(), "reason": w.reason})
            else:
                live.append(f.to_dict())
        unwaived_total += len(live)
        report["checkers"][rule] = {
            "count": len(live),
            "waived": waived,
            "findings": live,
            "runtime_s": round(time.perf_counter() - t0, 4),
        }

    # A stale waiver is only reportable when its rule actually ran.
    ran = set(selected)
    stale = [
        {"rule": w.rule, "key": w.key, "reason": w.reason}
        for w in waivers
        if w.rule in ran and (w.rule, w.key) not in matched
    ]
    report["stale_waivers"] = stale
    report["unwaived_total"] = unwaived_total
    report["runtime_s"] = round(time.perf_counter() - t_start, 4)
    report["ok"] = unwaived_total == 0 and not stale
    return report

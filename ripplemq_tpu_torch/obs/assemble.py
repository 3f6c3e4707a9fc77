"""Trace assembler: span records → per-message critical-path trees.

Input is any bag of span records (the dicts `SpanRing.snapshot` /
`admin.spans` serve) from any number of processes. Output is one tree
per trace id with every span mapped into the ROOT span's monotonic
clock domain — at no point are raw timestamps from two processes
compared.

The skew model: each process records spans against its own
`time.monotonic()`, so a trace that crossed N processes arrives in N
unrelated clock domains. But every cross-process hop left a matched
pair behind — the requesting side's span (client.produce wrapping the
RPC, worker.hop wrapping the shm round trip, repl.send wrapping the
frame) PARENTS the serving side's span (rpc.recv, worker.serve,
repl.apply). Assuming the serve sits at the midpoint of the request
(the classic NTP symmetric-delay assumption), the midpoint difference
IS the offset between the two domains:

    offset[child_proc] = (mid_parent + offset[parent_proc]) - mid_child

BFS from the root's process over parent→child edges propagates offsets
to every reachable process; multiple edges into the same process are
averaged. Spans in processes no edge reaches (orphaned subtrees — a
ring overwrote the parent, a process died mid-span) stay un-normalized
and are reported in `orphans` rather than silently mis-placed.

Coverage is the fraction of the root span's window the attributed
segments actually explain: union length of all normalized child
intervals clipped to the root window, over the root duration. The
acceptance bar for the tracing plane is ≥ 0.9 on a proc-backend
produce — if a hop's time went missing, this number says so.

Twin of `ripplemq_tpu/obs/assemble.py` (PyTorch port): the same code.
"""

from __future__ import annotations

from typing import Optional

_RESERVED = ("seq", "kind", "trace", "span", "parent", "t0", "dur_us",
             "proc")


def _mid(rec: dict) -> float:
    return rec["t0"] + rec["dur_us"] / 2e6


def _union_len(ivals: list[tuple[float, float]]) -> float:
    """Total length of a union of [a, b] intervals."""
    total = 0.0
    end: Optional[float] = None
    for a, b in sorted(ivals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def assemble(spans: list[dict]) -> list[dict]:
    """Join span records by trace id into trees (see module docstring).
    Tolerant by construction: duplicate records (the same ring paged
    twice) collapse on span id, missing parents demote a subtree to an
    orphan, a trace with no recognizable root is still returned (with
    `coverage` None). Returns one wire-encodable dict per trace,
    largest root duration first."""
    by_trace: dict[int, dict[int, dict]] = {}
    for rec in spans:
        try:
            by_trace.setdefault(int(rec["trace"]), {})[int(rec["span"])] \
                = rec
        except (KeyError, TypeError, ValueError):
            continue
    trees = [_assemble_one(t, idx) for t, idx in by_trace.items()]
    trees.sort(key=lambda tr: -(tr["ack_us"] or 0))
    return trees


def _assemble_one(trace_id: int, idx: dict[int, dict]) -> dict:
    children: dict[int, list[dict]] = {}
    roots: list[dict] = []
    for rec in idx.values():
        if rec.get("parent") in idx:
            children.setdefault(rec["parent"], []).append(rec)
        else:
            roots.append(rec)
    # The trace root: prefer the client span (parent id 0 by contract);
    # otherwise the longest parentless span anchors the clock domain.
    roots.sort(key=lambda r: (0 if str(r.get("kind", "")).startswith(
        "client.") else 1, -int(r.get("dur_us", 0))))
    root = roots[0] if roots else None

    # ---- per-process offsets into the root domain (midpoint pairing)
    offsets: dict[str, float] = {}
    if root is not None:
        offsets[root["proc"]] = 0.0
        acc: dict[str, list[float]] = {}
        frontier = [root]
        while frontier:
            nxt: list[dict] = []
            for parent in frontier:
                poff = offsets.get(parent["proc"])
                for ch in children.get(parent["span"], ()):
                    if poff is not None and ch["proc"] not in offsets:
                        if ch["proc"] == parent["proc"]:
                            offsets[ch["proc"]] = poff
                        else:
                            est = (_mid(parent) + poff) - _mid(ch)
                            acc.setdefault(ch["proc"], []).append(est)
                    nxt.append(ch)
            # Commit a BFS level's averaged estimates before descending:
            # deeper edges then chain off already-normalized parents.
            for proc, ests in acc.items():
                if proc not in offsets:
                    offsets[proc] = sum(ests) / len(ests)
            acc.clear()
            frontier = nxt

    # ---- normalize + coverage
    out_spans: list[dict] = []
    orphans = 0
    ivals: list[tuple[float, float]] = []
    for rec in idx.values():
        off = offsets.get(rec["proc"])
        norm = dict(rec)
        if off is None:
            orphans += 1
            norm["t0n"] = None
        else:
            norm["t0n"] = rec["t0"] + off
            if root is not None and rec is not root:
                a = norm["t0n"]
                ivals.append((a, a + rec["dur_us"] / 1e6))
        out_spans.append(norm)
    out_spans.sort(key=lambda r: (r["t0n"] is None, r["t0n"] or 0.0))

    coverage = None
    ack_us = None
    if root is not None:
        ack_us = int(root["dur_us"])
        if ack_us > 0:
            lo, hi = root["t0"], root["t0"] + ack_us / 1e6
            clipped = [(max(a, lo), min(b, hi))
                       for a, b in ivals if b > lo and a < hi]
            coverage = _union_len(clipped) / (ack_us / 1e6)

    # ---- critical path: from the root, follow the child whose
    # normalized END is latest (the hop still holding the ack open).
    path: list[dict] = []
    node = root
    while node is not None:
        path.append({"kind": node["kind"], "proc": node["proc"],
                     "dur_us": int(node["dur_us"])})
        kids = [c for c in children.get(node["span"], ())
                if offsets.get(c["proc"]) is not None]
        node = max(
            kids,
            key=lambda c: c["t0"] + offsets[c["proc"]] + c["dur_us"] / 1e6,
        ) if kids else None

    return {
        "trace": trace_id,
        "root_kind": None if root is None else root["kind"],
        "root_proc": None if root is None else root["proc"],
        "ack_us": ack_us,
        "coverage": coverage,
        "hops": sorted({r["kind"] for r in idx.values()}),
        "procs": sorted({r["proc"] for r in idx.values()}),
        "orphans": orphans,
        "critical_path": path,
        "spans": out_spans,
    }


def render(tree: dict, indent: str = "  ") -> str:
    """Human-readable one-trace decomposition (profiles/trace_view.py
    and chaos postmortem walkthroughs)."""
    cov = tree["coverage"]
    head = (f"trace {tree['trace']:#x} root={tree['root_kind']} "
            f"ack={_fmt_us(tree['ack_us'])} "
            f"coverage={'?' if cov is None else format(cov, '.0%')} "
            f"procs={','.join(tree['procs'])}")
    lines = [head]
    root_t0n = None
    for rec in tree["spans"]:
        if rec["kind"] == tree["root_kind"] and rec["t0n"] is not None:
            root_t0n = rec["t0n"]
            break
    for rec in tree["spans"]:
        if rec["t0n"] is None:
            at = "orphan"
        elif root_t0n is None:
            at = "?"
        else:
            at = f"+{(rec['t0n'] - root_t0n) * 1e3:.3f}ms"
        lines.append(f"{indent}{at:>12} {rec['kind']:<20} "
                     f"{_fmt_us(rec['dur_us']):>10}  [{rec['proc']}]")
    lines.append(f"{indent}critical: "
                 + " -> ".join(f"{p['kind']}({_fmt_us(p['dur_us'])})"
                               for p in tree["critical_path"]))
    return "\n".join(lines)


def _fmt_us(us) -> str:
    if us is None:
        return "?"
    return f"{us / 1000:.3f}ms" if us >= 1000 else f"{us}us"

"""Twin of `ripplemq_tpu/utils/graphs.py`.

Tiny dependency-free graph helpers shared by the static lock-order
checker (`analysis/lock_graph.py`) and the runtime lock witness
(`obs/lockwitness.py`) — one Tarjan, two callers, no drift."""

from __future__ import annotations

from typing import Iterable


def strongly_connected(
        edges: Iterable[tuple[str, str]]) -> list[list[str]]:
    """All strongly connected components (every node appears in exactly
    one, sorted within and across components) — iterative Tarjan, so a
    long chain cannot hit the recursion limit. Callers apply their own
    cycle policy (|SCC| > 1, self-edges, reentrancy exemptions)."""
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        # Iterative DFS: (node, iterator position) frames.
        work = [(root, 0)]
        while work:
            v, i = work.pop()
            if i == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on.add(v)
            recurse = False
            children = adj[v]
            while i < len(children):
                w = children[i]
                i += 1
                if w not in index:
                    work.append((v, i))
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(sorted(comp))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return sorted(out)


def cycles(edges: Iterable[tuple[str, str]],
           self_edge_counts: bool = True) -> list[list[str]]:
    """The deadlock-relevant components: SCCs with more than one node,
    plus single nodes with a self-edge when `self_edge_counts`."""
    edge_set = set(edges)
    selfed = {a for a, b in edge_set if a == b}
    out = []
    for comp in strongly_connected(edge_set):
        if len(comp) > 1:
            out.append(comp)
        elif self_edge_counts and comp[0] in selfed:
            out.append(comp)
    return out

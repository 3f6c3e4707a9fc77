"""The port's static analysis against the JAX package's, exactly.

Both lints run on the live tree: the reference's over `ripplemq_tpu/`,
the port's over `ripplemq_tpu_torch/`. Once a reference path is mapped
onto the port's (`ripplemq_tpu/` -> `ripplemq_tpu_torch/`), every
artifact the rules derive must be equal: the thread inventory, the lock
graph's closure, the `admin.stats` schema, the trace-event and span-kind
vocabularies with their emit sites, the retry taxonomy and the error
prefixes the brokers emit, `ClusterConfig`'s field set, and the
findings (waived ones included) of the rules whose scope is the
package. The README surfaces that carry no path (the configuration
reference, the stats schema, the two vocabularies) are shared by the
two packages; this equality is what lets them be. Finally both
packages' pure cores see the same fixture snippets and must agree
finding for finding.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import textwrap

import pytest

from ripplemq_tpu import analysis as ref
from ripplemq_tpu.analysis import (
    config_plumbing as ref_config,
    determinism as ref_det,
    lock_discipline as ref_lock,
    lock_graph as ref_graph,
    markers as ref_markers,
    retry_taxonomy as ref_retry,
    shard_shapes as ref_shapes,
    stats_schema as ref_stats,
    threads as ref_threads,
    trace_vocab as ref_trace,
)
from ripplemq_tpu_torch import analysis as port
from ripplemq_tpu_torch.analysis import (
    config_plumbing as port_config,
    determinism as port_det,
    lock_discipline as port_lock,
    lock_graph as port_graph,
    markers as port_markers,
    retry_taxonomy as port_retry,
    shard_shapes as port_shapes,
    stats_schema as port_stats,
    threads as port_threads,
    trace_vocab as port_trace,
)
from tests.torch_port_modules import admit

admit(__name__)


def _m(text: str) -> str:
    """A reference path (or key) at the port's path."""
    return re.sub(r"\bripplemq_tpu\b", "ripplemq_tpu_torch", text)


@pytest.fixture(scope="module")
def repos():
    return ref.Repo(), port.Repo()


# ------------------------------------------------- derived artifacts


# Threads only the port's inventory has: the port's bench lives inside
# its package (`ripplemq_tpu_torch/bench.py`), where the reference's
# `bench.py` sits outside the scanned package. (key, runtime name,
# spawning scope), as the inventory derives them.
_BENCH = "ripplemq_tpu_torch/bench.py::"
PORT_ONLY_THREADS = {
    (_BENCH + "_run_latency.worker", "bench-latency-*",
     _BENCH + "_run_latency"),
    (_BENCH + "_run_consume.worker", "bench-consume-*",
     _BENCH + "_run_consume"),
    (_BENCH + "_run_curve.worker", "bench-curve-*", _BENCH + "_run_curve"),
    (_BENCH + "_e2e_client_main.producer", "bench-e2e-producer-*",
     _BENCH + "_e2e_client_main"),
    (_BENCH + "_e2e_client_main.drainer", "bench-e2e-drainer-*",
     _BENCH + "_e2e_client_main"),
    # slice J's runners
    (_BENCH + "_run_group_consume.member", "bench-group-*-*",
     _BENCH + "_run_group_consume"),
    (_BENCH + "_storm_arm.worker", "bench-storm-*", _BENCH + "_storm_arm"),
    (_BENCH + "_storm_arm.beater", "bench-storm-beat-*",
     _BENCH + "_storm_arm"),
    (_BENCH + "_fanout_arm.member", "bench-fanout-*", _BENCH + "_fanout_arm"),
    (_BENCH + "_run_split_rebalance.offered", "bench-split-producer",
     _BENCH + "_run_split_rebalance"),
}


def test_thread_inventory_equal(repos):
    r, p = repos
    r_entries, r_find = ref_threads.inventory(r)
    p_entries, p_find = port_threads.inventory(p)
    assert r_find == [] and p_find == []
    want = sorted((_m(e.key), e.name, _m(e.spawned_in)) for e in r_entries)
    got = sorted((e.key, e.name, e.spawned_in) for e in p_entries)
    assert sorted(e for e in got if e not in PORT_ONLY_THREADS) == want
    assert sorted(e for e in got if e in PORT_ONLY_THREADS) == sorted(
        PORT_ONLY_THREADS)
    assert len(want) == 25
    assert len(got) == len(want) + len(PORT_ONLY_THREADS)


# Locks only the port has: the lockstep worker's in-order replay (its
# reassembly table and the turn condition that holds a call until its
# sequence number is next) and the kernel build's per-process lock.
# Each is a leaf: no ordering starts or ends at one.
PORT_ONLY_LOCKS = {"LockstepWorker._pieces_lock": "lock",
                   "LockstepWorker._turn": "condition",
                   "cuda_build._LOCK": "lock"}


def test_lock_graph_closure_equal(repos):
    r, p = repos
    r_lg, p_lg = ref_graph.build_graph(r), port_graph.build_graph(p)
    assert p_lg.locks == {**r_lg.locks, **PORT_ONLY_LOCKS}
    assert set(p_lg.edges) == set(r_lg.edges)
    assert p_lg.closure() == r_lg.closure()
    assert len(p_lg.closure()) == 24
    assert [(a, b) for a, b, _ in port_graph.DECLARED_EDGES] == [
        (a, b) for a, b, _ in ref_graph.DECLARED_EDGES]


def test_stats_schema_equal():
    got = dataclasses.asdict(port_stats.derive_schema())
    assert got == dataclasses.asdict(ref_stats.derive_schema())


def test_trace_vocabularies_and_emits_equal(repos):
    r, p = repos
    for path, name in ((ref_trace.TRACE_PATH, ref_trace.VOCAB_NAME),
                       (ref_trace.SPANS_PATH, ref_trace.SPAN_VOCAB_NAME)):
        assert port_trace.vocabulary(p.tree(_m(path)), name) == \
            ref_trace.vocabulary(r.tree(path), name)

    def emitted(mod, repo, attrs):
        out = set()
        for path in repo.py_files(*mod.SCAN_ROOTS):
            if "/analysis/" in path:
                continue
            out |= {(_m(path), n)
                    for _, n in mod.emit_sites(repo.tree(path), attrs)}
        return out

    for attrs in (("record",), ("span", "span_at")):
        assert emitted(port_trace, p, attrs) == emitted(ref_trace, r, attrs)


def test_retry_taxonomy_and_emitted_prefixes_equal(repos):
    r, p = repos
    assert port_retry.taxonomy(p.tree(port_retry.RETRY_PATH)) == \
        ref_retry.taxonomy(r.tree(ref_retry.RETRY_PATH))

    def prefixes(mod, repo):
        out = set()
        for path in repo.py_files(*mod.SCAN_ROOTS):
            if "/analysis/" in path:
                continue
            out |= {(_m(path), pre)
                    for _, pre, _ in mod.error_emits(repo.tree(path))}
        return out

    got, want = prefixes(port_retry, p), prefixes(ref_retry, r)
    assert got == want
    assert {pre for _, pre in got} >= {"not_leader", "fenced_generation"}


def test_config_fields_equal(repos):
    r, p = repos
    assert port_config.config_fields(p.tree(port_config.CONFIG_PATH)) == \
        ref_config.config_fields(r.tree(ref_config.CONFIG_PATH))
    for mod, repo in ((ref_config, r), (port_config, p)):
        assert mod.check(repo) == []


@pytest.mark.parametrize("rule", ["lock_discipline", "determinism",
                                  "lock_graph", "ownership",
                                  "retry_taxonomy", "trace_vocab",
                                  "stats_schema", "config_plumbing"])
def test_package_findings_equal(repos, rule):
    """The rules whose scope is the package find the same things in
    both (before the ledger: the waived findings are the same sites,
    which is why the reference's six waivers carry over). The port's
    lock_discipline also scans chip_smoke.py, and the reference's its
    profiles/ and bench.py; those out-of-package findings are set
    aside."""
    r, p = repos
    want = sorted((f.rule, _m(f.key), _m(f.path))
                  for f in ref.CHECKERS[rule](r)
                  if f.path.startswith("ripplemq_tpu/"))
    got = sorted((f.rule, f.key, f.path)
                 for f in port.CHECKERS[rule](p)
                 if f.path.startswith("ripplemq_tpu_torch/"))
    assert got == want


def test_ledgers_equal_at_port_keys():
    from ripplemq_tpu.analysis.ledger import WAIVERS as REF_WAIVERS
    from ripplemq_tpu_torch.analysis.ledger import WAIVERS as PORT_WAIVERS

    carried = [(w.rule, w.key) for w in PORT_WAIVERS
               if w.key.startswith("ripplemq_tpu_torch/")]
    assert carried == [(w.rule, _m(w.key)) for w in REF_WAIVERS]
    # The port's only other waivers are the card script's, each with
    # its reason.
    rest = [w for w in PORT_WAIVERS
            if not w.key.startswith("ripplemq_tpu_torch/")]
    assert {w.key.split("::")[0] for w in rest} == {"chip_smoke.py"}
    assert all(len(w.reason) > 100 for w in rest)


# --------------------------------------- pure cores on shared fixtures


def _parse(src: str) -> ast.AST:
    return ast.parse(textwrap.dedent(src))


def _keys(findings) -> list[tuple[str, str, int]]:
    return [(f.rule, f.key, f.line) for f in findings]


LOCKED_SRC = """
    import threading, time

    class Plane:
        def __init__(self):
            self._lock = threading.Lock()
            self._settled = [0]
            self._end = 0

        def settled(self, slot):
            with self._lock:
                return self._settled[slot]

        def _merge_locked(self, slot):
            self._gaps[slot] = self._end

        def wait(self, fut):
            with self._lock:
                fut.result(timeout=1.0)
                self._cond.wait(0.1)
                def later():
                    time.sleep(1)

    def stats(dp, other):
        return {"end": dp._settled[0], "gaps": other._gaps, "x": dp._end}
"""

DET_SRC = """
    import time, random, os

    def _apply_set_leader(self, cmd):
        stamp = time.time()
        pick = random.choice(cmd)
        salt = hash(cmd["k"])
        clock = time.monotonic
        rng = random.Random(7)
        return stamp, pick, salt, os.urandom(4), clock, rng

    def make_schedule(seed):
        return time.perf_counter()
"""

SHAPE_SRC = """
    def body(cfg, inp, quorum=None, trim=None):
        S, B, P = cfg.slots, cfg.max_batch, cfg.partitions
        a = zeros((P,))
        b = np.arange(cfg.partitions)
        if quorum is None:
            quorum = full((cfg.partitions,), 2)
        if trim is not None:
            trim = tile(trim, P)
        return broadcast_to(a, (B, P))

    def helper(cfg):
        return zeros_like(cfg.partitions)

    def unrelated(cfg):
        return zeros((cfg.partitions,))
"""

RETRY_SRC = """
    def handle(req):
        if bad(req):
            return {"ok": False, "error": "shiny_refusal: nope"}
        if worse(req):
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if req:
            return {"ok": False, "error": f"not_leader: {req}"}
        return {"ok": True, "error": "not an emit"}
"""

TRACE_SRC = """
    class X:
        def go(self, ctx, kind):
            self.recorder.record("rogue_event", a=1)
            self.history.record(op="produce", v=2)
            sp = self.spans.span("rpc.recv", ctx)
            self.spans.span_at("stripe.reconstruct", ctx, 0.0, 1.0)
            self.spans.span(kind, ctx)
"""

STATS_SRC = """
    def _handle_stats(self, req):
        stats = {"ok": True, "broker": 1}
        if self.engine is None:
            stats["engine"] = None
        else:
            engine = {"rounds": 2}
            engine["degraded"] = False
            if req.get("slots"):
                engine["slots"] = {}
            stats["engine"] = engine
        return stats
"""

CONFIG_SRC = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class ClusterConfig:
        brokers: tuple
        rpc_timeout_s: float = 3.0
        shiny_new_knob_s: float = 1.0

    def _config_yaml_dict(config):
        return {"brokers": [], "rpc_timeout_s": config.rpc_timeout_s}
"""

MARK_SRCS = ("import pytest\npytestmark = pytest.mark.slow\n",
             "import pytest\npytestmark = [pytest.mark.slow, pytest.mark.x]\n",
             "x = 1\n", "pytestmark = []\n")


def test_pure_cores_agree_lock_discipline():
    tree = _parse(LOCKED_SRC)
    guarded = ref_lock.guarded_fields(tree)
    assert port_lock.guarded_fields(tree) == guarded
    assert guarded  # the fixture exercises the inference
    got = _keys(port_lock.bare_reads("m.py", tree, guarded))
    assert got == _keys(ref_lock.bare_reads("m.py", tree, guarded)) and got
    got = _keys(port_lock.blocking_under_lock("m.py", tree))
    assert got == _keys(ref_lock.blocking_under_lock("m.py", tree)) and got


@pytest.mark.parametrize("scope", [r"^_apply_", r"^make_schedule$", r".*"])
def test_pure_cores_agree_determinism(scope):
    tree = _parse(DET_SRC)
    got = _keys(port_det.scope_findings("m.py", tree, scope))
    assert got == _keys(ref_det.scope_findings("m.py", tree, scope)) and got


def test_pure_cores_agree_shard_shapes():
    """The allocation names both rules know (the port's list adds the
    torch-only `new_*`, `expand` and `repeat`)."""
    tree = _parse(SHAPE_SRC)
    for roots in ({"body"}, {"body", "helper"}, {"unrelated"}):
        got = _keys(port_shapes.alloc_findings(tree, roots, path="s.py"))
        assert got == _keys(
            ref_shapes.alloc_findings(tree, roots, path="s.py")) and got


def test_pure_cores_agree_retry_trace_stats_config():
    tree = _parse(RETRY_SRC)
    assert port_retry.error_emits(tree) == ref_retry.error_emits(tree)
    fatal, retryable = ("bad_request",), ("not_committed", "not_leader")
    for pre in ("shiny_refusal", "bad_request", "not_leader", "x"):
        assert port_retry.classify(pre, fatal, retryable) == \
            ref_retry.classify(pre, fatal, retryable)
    tree = _parse(TRACE_SRC)
    for attrs in (("record",), ("span", "span_at")):
        assert port_trace.emit_sites(tree, attrs) == \
            ref_trace.emit_sites(tree, attrs)
    fn = _parse(STATS_SRC).body[0]
    for var in ("stats", "engine"):
        assert port_stats.dict_flow(fn, var) == ref_stats.dict_flow(fn, var)
    tree = _parse(CONFIG_SRC)
    fields = ref_config.config_fields(tree)
    assert port_config.config_fields(tree) == fields
    proc = tree.body[-1]
    reached = ref_config.names_reached(proc)
    assert port_config.names_reached(proc) == reached
    got = _keys(port_config.missing_fields(fields, reached, "proc", "p.py"))
    assert got == _keys(
        ref_config.missing_fields(fields, reached, "proc", "p.py")) and got
    for src in MARK_SRCS:
        tree = _parse(src)
        assert port_markers.is_slow_marked(tree) == \
            ref_markers.is_slow_marked(tree)


SEEDED_TREE = {
    "mod.py": """
        import threading

        class P:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()
                self._cond = threading.Condition(self._a_lock)
                self._flag = False
                self._t = threading.Thread(target=self._loop, name="p")

            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        self.helper()

            def two(self):
                with self._b_lock:
                    with self._cond:
                        pass

            def helper(self):
                with self._a_lock:
                    pass

            def _loop(self):
                self._flag = True

            def stop(self):
                self._flag = False
    """,
}


@pytest.mark.parametrize("rule", ["lock_graph", "threads", "ownership"])
def test_pure_cores_agree_on_a_seeded_tree(tmp_path, rule):
    """The call-graph rules over one seeded module, placed under each
    package's own scan root (`broker/`, so ownership scopes it too)."""
    trees = {}
    for name, pkg, mod in (("ref", "ripplemq_tpu", ref),
                           ("port", "ripplemq_tpu_torch", port)):
        root = tmp_path / name
        for rel, src in SEEDED_TREE.items():
            f = root / pkg / "broker" / rel
            f.parent.mkdir(parents=True)
            f.write_text(textwrap.dedent(src))
        (root / "README.md").write_text("")
        trees[name] = sorted(
            (f.rule, _m(f.key), _m(f.path))
            for f in mod.CHECKERS[rule](mod.Repo(root)))
    assert trees["port"] == trees["ref"]
    assert trees["port"]

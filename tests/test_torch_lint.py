"""The port's ripplelint tier-1 gate: twin of `tests/test_lint.py` for
`ripplemq_tpu_torch/analysis/` — the port's tree is clean, and every
checker still catches the regression class it was built from.

Two halves:

- **Fixture tests** — one seeded failing snippet per rule, run through
  the checker's PURE core (`ast.parse(snippet)`), proving the rule
  would catch its motivating bug if it were reintroduced. Each fixture
  is the review finding that motivated the rule, reduced.
- **Whole-tree assertions** — `run_lint()` reports zero unwaived
  findings and zero stale waivers on the actual repo (the clean-tree
  contract), the ledger is well-formed (every
  waiver has a reason), and the JSON verdict carries per-checker
  counts + runtime inside the tier-1 budget.

Port-only additions: a torch `shard_shapes` fixture (a
`torch.zeros((cfg.partitions,))` in a step function `make_spmd_fns`
reaches, through the derivation itself), the derived spmd step set
pinned, the `markers` rule's port scope (a non-port test module is out
of it), and the CLI's exit codes.
"""

from __future__ import annotations

import ast
import json
import textwrap

import pytest

from ripplemq_tpu_torch.analysis import (
    CHECKERS,
    LedgerError,
    Repo,
    Waiver,
    config_plumbing,
    determinism,
    lock_discipline,
    lock_graph,
    markers,
    ownership,
    retry_taxonomy,
    run_lint,
    shard_shapes,
    stats_schema,
    threads,
    trace_vocab,
)
from ripplemq_tpu_torch.analysis.framework import validate_ledger
from ripplemq_tpu_torch.analysis.ledger import WAIVERS
from tests.torch_port_modules import admit

admit(__name__)


def _parse(src: str) -> ast.AST:
    return ast.parse(textwrap.dedent(src))


# ===================================================== per-rule fixtures

# ---- lock_discipline: the `_settled_end` bare-read class -------------

GUARDED_SRC = """
    import threading

    class Plane:
        def __init__(self):
            self._lock = threading.Lock()
            self._settled = [0]
            self._boring = 1

        def settled(self, slot):
            with self._lock:
                return self._settled[slot]

        def _merge_locked(self, slot):
            self._gaps[slot] = 1
"""


def test_lock_guard_inference():
    g = lock_discipline.guarded_fields(_parse(GUARDED_SRC))
    # Fields under the lock (and in *_locked methods) are guarded;
    # plain attributes and the lock itself are not.
    assert g == {"Plane": {"_settled", "_gaps"}}


def test_lock_bare_read_fixture_caught():
    # The seeded regression: an admin surface reaching into the plane's
    # guarded array bare (the exact shape broker/server.py once had).
    reader = _parse("""
        def stats(dp):
            return {"end": dp._settled[0]}
    """)
    guarded = {"Plane": {"_settled"}}
    found = lock_discipline.bare_reads("mod.py", reader, guarded)
    assert len(found) == 1
    assert found[0].key == "mod.py::stats::_settled"
    # Same read through a module that OWNS a _settled field of its own
    # class: not a cross-class reach-in, not flagged.
    owner = _parse("""
        class Other:
            def __init__(self):
                self._settled = []
        def stats(dp):
            return {"end": dp._settled[0]}
    """)
    assert lock_discipline.bare_reads("mod.py", owner, guarded) == []


def test_lock_blocking_call_fixture_caught():
    # The review class: blocking work under the ack-path lock.
    src = _parse("""
        import time

        class Plane:
            def wait(self, fut):
                with self._lock:
                    fut.result(timeout=1.0)
            def pause(self):
                with self._lock:
                    time.sleep(0.1)
            def fine(self):
                with self._lock:
                    self._cond.wait(0.1)   # releases the lock: exempt
            def also_fine(self, fut):
                fut.result(timeout=1.0)    # no lock held
    """)
    found = lock_discipline.blocking_under_lock("mod.py", src)
    assert {f.key for f in found} == {
        "mod.py::wait::result", "mod.py::pause::sleep",
    }


def test_lock_closure_under_lock_not_flagged():
    # A closure DEFINED under the lock runs later, outside it.
    src = _parse("""
        import time
        class P:
            def go(self):
                with self._lock:
                    def later():
                        time.sleep(1)
                    self._cb = later
    """)
    assert lock_discipline.blocking_under_lock("m.py", src) == []


# ---- config_plumbing: the silently-dropped proc field class ----------

CONFIG_SRC = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class ClusterConfig:
        brokers: tuple
        rpc_timeout_s: float = 3.0
        shiny_new_knob_s: float = 1.0
"""


def test_config_field_extraction():
    fields = config_plumbing.config_fields(_parse(CONFIG_SRC))
    assert fields == ["brokers", "rpc_timeout_s", "shiny_new_knob_s"]


def test_config_missing_field_fixture_caught():
    # The seeded regression: a new knob parsed from YAML but absent
    # from the proc-cluster serialization (exactly how coalesce_s/
    # chain_depth/... shipped before this PR).
    proc_fn = _parse("""
        def _config_yaml_dict(config):
            return {
                "brokers": [],
                "rpc_timeout_s": config.rpc_timeout_s,
            }
    """).body[0]
    fields = config_plumbing.config_fields(_parse(CONFIG_SRC))
    reached = config_plumbing.names_reached(proc_fn)
    found = config_plumbing.missing_fields(fields, reached, "proc", "p.py")
    assert [f.key for f in found] == ["proc::shiny_new_knob_s"]


# ---- retry_taxonomy: the unclassified fenced_generation class --------


def test_retry_emit_extraction_and_classification():
    src = _parse("""
        def handle(req):
            if bad(req):
                return {"ok": False, "error": "shiny_refusal: nope"}
            if worse(req):
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}
            return {"ok": True, "error": "not an emit (ok True)"}
    """)
    emits = retry_taxonomy.error_emits(src)
    assert len(emits) == 2
    prefixes = [p for _, p, _ in emits]
    assert "shiny_refusal" in prefixes
    assert None in prefixes  # the untyped f-string
    # Untyped findings are keyed by enclosing scope, not line numbers.
    assert all(scope == "handle" for _, _, scope in emits)
    fatal, retryable = ("bad_request",), ("not_committed",)
    assert retry_taxonomy.classify("shiny_refusal", fatal, retryable) is None
    assert retry_taxonomy.classify("bad_request", fatal, retryable) == "fatal"
    assert retry_taxonomy.classify(
        "not_committed", fatal, retryable) == "retryable"


def test_retry_taxonomy_parses_live_tuples():
    repo = Repo()
    fatal, retryable = retry_taxonomy.taxonomy(
        repo.tree(retry_taxonomy.RETRY_PATH))
    assert "bad_request" in fatal and "no_store" in fatal
    assert "not_committed" in retryable and "bad_stripe_frame" in retryable


# ---- determinism: the wall-clock-in-pure-machinery class -------------


def test_determinism_fixture_caught():
    src = _parse("""
        import time, random, os

        def _apply_set_leader(self, cmd):
            stamp = time.time()            # forks replicas
            pick = random.choice(cmd)      # unseeded
            salt = hash(cmd["k"])          # process-unstable
            return stamp, pick, salt
    """)
    found = determinism.scope_findings("m.py", src, r"^_apply_")
    assert {f.key.rsplit("::", 1)[-1] for f in found} == {
        "time.time", "random.choice", "hash",
    }


def test_determinism_sanctioned_idioms_pass():
    src = _parse("""
        import time, random

        def make_schedule(seed):
            rng = random.Random(seed)      # seeded: fine
            clock = time.monotonic         # stored, not called: fine
            return rng.random(), clock
    """)
    assert determinism.scope_findings("m.py", src, r".*") == []


# ---- shard_shapes: the global-P-allocation-in-a-spmd-step class ------

STEP_FIXTURE = """
    import torch

    def spmd_body(cfg, inp, quorum=None):
        P = cfg.partitions
        bad = torch.zeros((P,), dtype=torch.int32)   # global-P: caught
        wide = inp.new_full((P, 3), 1)               # Tensor.new_*: caught
        rows = inp[None].expand(cfg.partitions, 2)   # broadcast: caught
        if quorum is None:
            quorum = torch.full((cfg.partitions,), 3)  # documented idiom
        return bad + quorum + wide + rows

    def host_side(cfg):
        return torch.zeros((cfg.partitions,))        # not reached: fine
"""


def test_shard_shape_fixture_caught():
    found = shard_shapes.alloc_findings(
        _parse(STEP_FIXTURE), {"spmd_body"}, path="step.py")
    assert [f.key for f in found] == ["step.py::spmd_body::zeros",
                                      "step.py::spmd_body::new_full",
                                      "step.py::spmd_body::expand"]


# The binding's step set, pinned: what make_spmd_fns's inner defs call
# (ctrl_fn and vote_fn pick a layout; the reads call core_step directly).
SPMD_STEP_FNS = {"replica_control", "replica_control_fused", "vote_step",
                 "vote_step_fused", "read_batch_at", "read_offset"}


def test_shard_shape_derivation_matches_engine():
    # The spmd set is derived, not hand-listed, and equals the step
    # functions make_spmd_fns actually calls.
    repo = Repo()
    spmd = shard_shapes.spmd_step_fns(repo.tree(shard_shapes.ENGINE_PATH))
    print("derived spmd step set:", sorted(spmd))
    assert spmd == SPMD_STEP_FNS


def test_shard_shape_torch_fixture_through_the_binding(tmp_path):
    """The seeded regression end to end: a `torch.zeros((cfg.partitions,))`
    in a helper of a step function that `make_spmd_fns` reaches only
    through its `ctrl_fn = core_step.a if fused else core_step.b`
    indirection is caught by `check`; the same allocation under the
    `if quorum is None:` default, or in a step function the binding
    never calls, is not."""
    engine = """
        from ripplemq_tpu_torch.core import step as core_step

        def make_local_fns(cfg):
            return core_step.host_only

        def make_spmd_fns(cfg, mesh):
            ctrl_fn = (core_step.control_fused if cfg.fused_control
                       else core_step.control)

            def one_round(state, inp, alive, quorum):
                return ctrl_fn(cfg, state, inp, alive, quorum)

            def reads(state):
                return core_step.read_at(cfg, state)

            return one_round, reads
    """
    step = """
        import torch

        def _ballot(cfg, alive, quorum=None):
            if quorum is None:
                quorum = torch.full((cfg.partitions,), 2)
            return alive.sum(0) >= quorum

        def _mask(cfg, alive):
            P = cfg.partitions
            return torch.zeros((P,), dtype=torch.bool) | alive.any(1)

        def control(cfg, state, inp, alive, quorum=None):
            return _ballot(cfg, alive, quorum)

        def control_fused(cfg, state, inp, alive, quorum=None):
            return _ballot(cfg, alive, quorum) & _mask(cfg, alive)

        def read_at(cfg, state):
            return state

        def host_only(cfg):
            return torch.zeros((cfg.partitions,))
    """
    repo = _seed_tree(tmp_path, {shard_shapes.ENGINE_PATH: engine,
                                 shard_shapes.STEP_PATH: step})
    assert shard_shapes.spmd_step_fns(
        repo.tree(shard_shapes.ENGINE_PATH)) == {
            "control", "control_fused", "read_at"}
    keys = [f.key for f in shard_shapes.check(repo)]
    assert keys == [f"{shard_shapes.STEP_PATH}::_mask::zeros"]
    # An engine the derivation cannot read is itself a finding.
    (tmp_path / shard_shapes.ENGINE_PATH).write_text(
        "def other():\n    pass\n")
    assert [f.key for f in shard_shapes.check(Repo(tmp_path))] == [
        "structure::spmd"]


# ---- stats_schema: the silently-widened-schema class -----------------


def test_stats_dict_flow_required_vs_optional():
    fn = _parse("""
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
    """).body[0]
    req, opt = stats_schema.dict_flow(fn, "stats")
    assert req == {"ok", "broker", "engine"} and opt == set()
    ereq, eopt = stats_schema.dict_flow(fn, "engine")
    assert ereq == {"rounds", "degraded"} and eopt == {"slots"}


def test_stats_schema_fixture_caught(tmp_path):
    """The seeded regression: a new stats key emitted but undocumented
    in the README schema section — the silent-schema-widening class the
    hand-maintained lock could not see until a human updated it."""
    (tmp_path / "ripplemq_tpu_torch/broker").mkdir(parents=True)
    (tmp_path / "ripplemq_tpu_torch/groups").mkdir(parents=True)
    (tmp_path / stats_schema.SERVER_PATH).write_text(textwrap.dedent("""
        class BrokerServer:
            def _handle_stats(self, req):
                stats = {"ok": True, "rogue_stat": 1}
                engine = {"rounds": 2}
                stats["engine"] = engine
                return stats
    """))
    (tmp_path / stats_schema.DATAPLANE_PATH).write_text(textwrap.dedent("""
        class DataPlane:
            def settle_stats(self):
                return {"window": 1}
    """))
    (tmp_path / stats_schema.GROUPS_PATH).write_text(textwrap.dedent("""
        class GroupTable:
            def summary(self):
                return {n: {"generation": s} for n, s in self.g.items()}
    """))
    (tmp_path / "README.md").write_text(
        f"{stats_schema.README_HEADING}\n\n"
        f"`ok`, `engine`, `rounds`, `window`, `generation`\n")
    keys = {f.key for f in stats_schema.check(Repo(tmp_path))}
    # The addition half: emitted but undocumented.
    assert "readme::top::rogue_stat" in keys
    # The REMOVAL half: this synthetic handler dropped almost every
    # baseline key — each deletion is its own finding (the guard the
    # old hand-maintained lock provided, now in the checker).
    assert "removed::top::broker" in keys
    assert "removed::engine::dispatches" in keys


def test_stats_schema_derivation_matches_live_emitters():
    schema = stats_schema.derive_schema()
    assert "stripe_mode" in schema.top and "ok" in schema.top
    assert "pid_table_size" in schema.engine
    assert schema.engine_optional == {"slots"}
    assert schema.settle == {"window", "occupancy_mean", "samples",
                             "backpressure_waits"}
    assert schema.group == {"generation", "members", "partitions"}


# ---- trace_vocab: the undocumented-event class -----------------------


def test_trace_emit_extraction():
    src = _parse("""
        class X:
            def go(self):
                self.recorder.record("rogue_event", a=1)
                self.history.record(op="produce", v=2)  # keyword-only: history
    """)
    emits = trace_vocab.emit_sites(src)
    assert [(n) for _, n in emits] == ["rogue_event"]


def test_span_emit_extraction():
    src = _parse("""
        class X:
            def go(self, ctx):
                sp = self.spans.span("rpc.recv", ctx)
                self.spans.span_at("stripe.reconstruct", ctx, 0.0, 1.0)
                self.spans.span(kind, ctx)  # non-literal: out of scope
    """)
    emits = trace_vocab.emit_sites(src, ("span", "span_at"))
    assert [n for _, n in emits] == ["rpc.recv", "stripe.reconstruct"]


def test_trace_vocab_fixture_caught(tmp_path):
    """The seeded regression (an actual drift): an event emitted
    with no vocabulary entry — and, symmetrically, a vocabulary entry
    whose emit site was renamed away."""
    (tmp_path / "ripplemq_tpu_torch/obs").mkdir(parents=True)
    (tmp_path / "ripplemq_tpu_torch/broker").mkdir(parents=True)
    (tmp_path / trace_vocab.TRACE_PATH).write_text(
        'EVENT_TYPES = frozenset({"dispatch", "renamed_away"})\n')
    (tmp_path / trace_vocab.SPANS_PATH).write_text(
        'SPAN_KINDS = frozenset({"rpc.recv", "kind_renamed_away"})\n')
    (tmp_path / "ripplemq_tpu_torch/broker/server.py").write_text(
        textwrap.dedent("""
            class S:
                def go(self, ctx):
                    self.recorder.record("dispatch", n=1)
                    self.recorder.record("rogue_event", n=2)
                    self.spans.span("rpc.recv", ctx)
                    self.spans.span_at("rogue.kind", ctx, 0.0, 1.0)
        """))
    (tmp_path / "README.md").write_text(
        f"{trace_vocab.README_HEADING}\n\n`dispatch` `renamed_away`\n\n"
        f"{trace_vocab.SPAN_README_HEADING}\n\n"
        f"`rpc.recv` `kind_renamed_away`\n")
    keys = {f.key for f in trace_vocab.check(Repo(tmp_path))}
    assert keys == {"undocumented::rogue_event", "dead::renamed_away",
                    "undocumented::rogue.kind", "dead::kind_renamed_away"}


def test_trace_vocab_parses_live_set():
    repo = Repo()
    vocab = trace_vocab.vocabulary(repo.tree(trace_vocab.TRACE_PATH))
    # The drift this rule was built from: stripe_rebuild emitted
    # but undocumented; it is now both in the vocabulary and README.
    assert "stripe_rebuild" in vocab and "dispatch" in vocab
    kinds = trace_vocab.vocabulary(
        repo.tree(trace_vocab.SPANS_PATH), trace_vocab.SPAN_VOCAB_NAME)
    # The span-kind vocabulary is the second closed set under this
    # rule; the cross-process skew pairs must both be present.
    assert {"client.rpc", "rpc.recv", "worker.hop", "worker.serve",
            "repl.send", "repl.apply"} <= kinds


# ---- markers: the unmarked-soak class --------------------------------


def test_marker_fixture_caught(tmp_path):
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_rogue_soak.py").write_text(
        "def test_x():\n    pass\n")
    for name in markers.PINNED_SLOW:
        (tests / f"{name}.py").write_text(
            "import pytest\npytestmark = pytest.mark.slow\n")
    found = markers.check(Repo(tmp_path))
    assert any(f.key == "unvetted::test_torch_rogue_soak" for f in found)
    # Marking it slow clears that finding.
    (tests / "test_torch_rogue_soak.py").write_text(
        "import pytest\npytestmark = pytest.mark.slow\ndef test_x():\n"
        "    pass\n")
    found = markers.check(Repo(tmp_path))
    assert not any(f.key == "unvetted::test_torch_rogue_soak"
                   for f in found)


def test_marker_scope_is_the_port_modules(tmp_path):
    """The port's rule audits `tests/test_torch_*.py` only: a JAX-package
    test module, unmarked and unlisted here, is out of its scope (the
    reference's own rule audits it), while the same body under a port
    name is unvetted — and a pinned slow twin that loses its mark is
    caught."""
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_rogue_reference.py").write_text(
        "def test_x():\n    pass\n")
    (tests / "helpers_torch.py").write_text("x = 1\n")
    for name in markers.FAST_MODULES:
        (tests / f"{name}.py").write_text("def test_x():\n    pass\n")
    for name in markers.PINNED_SLOW:
        (tests / f"{name}.py").write_text(
            "import pytest\npytestmark = pytest.mark.slow\n")
    assert markers.check(Repo(tmp_path)) == []
    (tests / "test_torch_rogue.py").write_text("def test_x():\n    pass\n")
    (tests / f"{markers.PINNED_SLOW[0]}.py").write_text("x = 1\n")
    keys = {f.key for f in markers.check(Repo(tmp_path))}
    assert keys == {"unvetted::test_torch_rogue",
                    f"pinned::{markers.PINNED_SLOW[0]}",
                    f"unvetted::{markers.PINNED_SLOW[0]}"}


def test_marker_slow_detection():
    assert markers.is_slow_marked(_parse(
        "import pytest\npytestmark = pytest.mark.slow\n"))
    assert markers.is_slow_marked(_parse(
        "import pytest\npytestmark = [pytest.mark.slow, pytest.mark.x]\n"))
    assert not markers.is_slow_marked(_parse("x = 1\n"))


# ---- threads: the un-inventoried-thread class ------------------------


def _seed_tree(tmp_path, files: dict[str, str]) -> Repo:
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return Repo(tmp_path)


def test_threads_fixture_caught(tmp_path):
    """The seeded regression: a spawn whose target the inventory cannot
    resolve (a thread nobody can map to code), and a derivable thread
    missing from the README Concurrency-model (port) table."""
    repo = _seed_tree(tmp_path, {
        "ripplemq_tpu_torch/mod.py": """
            import threading

            class Plane:
                def start(self):
                    t = threading.Thread(target=self._loop, name="plane")
                    t.start()
                    # Unresolvable: a handler-dict target is a thread
                    # the inventory cannot attribute to any code.
                    threading.Thread(target=self.handlers["x"]).start()

                def _loop(self):
                    pass
        """,
        "README.md": f"{threads.README_HEADING}\n\nno rows here\n",
    })
    keys = {f.key for f in threads.check(repo)}
    assert "ripplemq_tpu_torch/mod.py::Plane.start::unresolved_spawn" in keys
    assert "readme::ripplemq_tpu_torch/mod.py::Plane._loop" in keys
    # Documenting the derived entry clears the drift half; a bogus row
    # is flagged from the other direction.
    (tmp_path / "README.md").write_text(
        f"{threads.README_HEADING}\n\n"
        "| `plane` | `ripplemq_tpu_torch/mod.py::Plane._loop` |\n"
        "| `ghost` | `ripplemq_tpu_torch/mod.py::Plane._gone` |\n")
    keys = {f.key for f in threads.check(Repo(tmp_path))}
    assert "readme::ripplemq_tpu_torch/mod.py::Plane._loop" not in keys
    assert "dead::ripplemq_tpu_torch/mod.py::Plane._gone" in keys


def test_threads_inventory_matches_live_tree():
    repo = Repo()
    entries, findings = threads.inventory(repo)
    assert findings == [], [f.message for f in findings]
    keys = {e.key for e in entries}
    # The load-bearing entries the README table documents.
    assert {"ripplemq_tpu_torch/broker/dataplane.py::DataPlane._run",
            "ripplemq_tpu_torch/broker/dataplane.py::DataPlane._settle_loop",
            "ripplemq_tpu_torch/broker/replication.py::_Sender.run",
            "ripplemq_tpu_torch/stripes/plane.py::StripeReplicator._encode_loop",
            "ripplemq_tpu_torch/storage/segment.py::SegmentStore._flush_loop",
            "ripplemq_tpu_torch/broker/hostraft.py::RaftRunner._run"} <= keys
    # The closure is non-trivial: the duty loop reaches deep.
    reach = threads.reachable_map(repo)
    duty = reach["ripplemq_tpu_torch/broker/server.py::BrokerServer._duty_loop"]
    assert len(duty) > 50


# ---- lock_graph: the two-lock inversion class ------------------------

CYCLE_SRC = {
    "ripplemq_tpu_torch/mod.py": """
        import threading

        class P:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def two(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
    """,
}


def test_lock_graph_cycle_fixture_caught(tmp_path):
    repo = _seed_tree(tmp_path, CYCLE_SRC)
    keys = {f.key for f in lock_graph.check(repo)}
    assert "cycle::P._a_lock<->P._b_lock" in keys
    # Consistent ordering (the fix): no cycle, no finding.
    repo2 = _seed_tree(tmp_path / "fixed", {
        "ripplemq_tpu_torch/mod.py": CYCLE_SRC[
            "ripplemq_tpu_torch/mod.py"].replace(
            "with self._b_lock:\n                    with self._a_lock:",
            "with self._a_lock:\n                    with self._b_lock:"),
    })
    assert {f.key for f in lock_graph.check(repo2)} == set()


def test_lock_graph_interprocedural_and_self_deadlock(tmp_path):
    """A self-re-acquisition through a helper call (plain Lock) is the
    classic hidden deadlock; the same shape through an RLock is legal."""
    repo = _seed_tree(tmp_path, {
        "ripplemq_tpu_torch/mod.py": """
            import threading

            class P:
                def __init__(self):
                    self._lock = threading.Lock()

                def outer(self):
                    with self._lock:
                        self.helper()

                def helper(self):
                    with self._lock:
                        pass

            class R:
                def __init__(self):
                    self.lock = threading.RLock()

                def outer(self):
                    with self.lock:
                        self.helper()

                def helper(self):
                    with self.lock:
                        pass
        """,
    })
    keys = {f.key for f in lock_graph.check(repo)}
    assert "cycle::P._lock" in keys
    assert not any("R.lock" in k for k in keys)


def test_lock_graph_condition_alias_and_witness_name(tmp_path):
    repo = _seed_tree(tmp_path, {
        "ripplemq_tpu_torch/mod.py": """
            import threading
            from ripplemq_tpu_torch.obs.lockwitness import make_lock

            class P:
                def __init__(self):
                    self._lock = make_lock("Wrong.name")
                    self._cond = threading.Condition(self._lock)
        """,
    })
    findings = lock_graph.check(repo)
    assert any(f.key == "witness_name::P._lock" for f in findings)
    lg = lock_graph.build_graph(repo)
    # Condition(self._lock) ALIASES: one node, not two.
    assert ("P", "_cond") in lg.aliases
    assert "P._cond" not in lg.locks and "P._lock" in lg.locks


def test_lock_graph_live_tree_edges_and_closure():
    """The derived graph knows the real cross-object orderings, and the
    closure (derived ∪ declared) covers what the runtime witness
    observes in the chaos smokes."""
    repo = Repo()
    lg = lock_graph.build_graph(repo)
    assert ("PartitionManager.lock", "DataPlane._lock") in lg.edges
    assert ("DataPlane._device_lock",
            "LockstepController._lock") in lg.edges
    closure = lg.closure()
    # The declared RaftRunner→manager edge (apply_fn indirection, found
    # by the first witnessed chaos run) closes transitively onto the
    # plane the manager drives.
    assert ("RaftRunner.lock", "PartitionManager.lock") in closure
    assert ("RaftRunner.lock", "DataPlane._lock") in closure


# ---- ownership: the unowned-shared-write class -----------------------

OWNERSHIP_SRC = """
    import threading

    class Plane:
        def __init__(self):
            self._lock = threading.Lock()
            self._flag = False
            self._t = threading.Thread(target=self._loop)

        def _loop(self):
            self._flag = True

        def stop(self):
            self._flag = False
"""


def test_ownership_fixture_caught(tmp_path):
    repo = _seed_tree(tmp_path, {"ripplemq_tpu_torch/broker/mod.py":
                                 OWNERSHIP_SRC})
    keys = {f.key for f in ownership.check(repo)}
    assert "ripplemq_tpu_torch/broker/mod.py::Plane::_flag" in keys
    # Guarding BOTH writes with one mutex clears it.
    guarded = OWNERSHIP_SRC.replace(
        "            self._flag = True",
        "            with self._lock:\n"
        "                self._flag = True").replace(
        "            self._flag = False\n",
        "            with self._lock:\n"
        "                self._flag = False\n", 1)
    # Only the post-__init__ writes need guards; replace the stop()
    # one too (the __init__ write is exempt by construction).
    guarded = guarded.replace(
        "        def stop(self):\n            self._flag = False",
        "        def stop(self):\n            with self._lock:\n"
        "                self._flag = False")
    repo2 = _seed_tree(tmp_path / "fixed",
                       {"ripplemq_tpu_torch/broker/mod.py": guarded})
    assert {f.key for f in ownership.check(repo2)} == set()


def test_ownership_caller_held_propagation(tmp_path):
    """The RaftNode/RaftRunner convention: the wrapper's lock guards
    the inner state machine — writes inside the inner class are clean
    when every runtime call path holds the wrapper's lock, and flagged
    again the moment one unlocked path exists."""
    base = """
        import threading

        class Node:
            def __init__(self):
                self.x = 0

            def tick(self):
                self.x += 1

        class Runner:
            def __init__(self):
                self.lock = threading.Lock()
                self.node = Node()
                self._t = threading.Thread(target=self._run)

            def _run(self):
                with self.lock:
                    self.node.tick()

            def handle(self):
                with self.lock:
                    self.node.tick()
    """
    repo = _seed_tree(tmp_path, {"ripplemq_tpu_torch/broker/mod.py": base})
    assert {f.key for f in ownership.check(repo)} == set()
    leaky = base + """
        class Leak:
            def __init__(self):
                self.n = Node()

            def poke(self):
                self.n.tick()
    """
    repo2 = _seed_tree(tmp_path / "leaky",
                       {"ripplemq_tpu_torch/broker/mod.py": leaky})
    keys = {f.key for f in ownership.check(repo2)}
    assert "ripplemq_tpu_torch/broker/mod.py::Node::x" in keys


def test_ownership_del_mutation_counts_as_write(tmp_path):
    """`del self._tab[k]` mutates shared state exactly like a
    subscript store — delete targets carry ast.Del ctx, and matching
    Store alone silently dropped the whole mutation class (review
    finding on this PR's first cut)."""
    repo = _seed_tree(tmp_path, {"ripplemq_tpu_torch/broker/mod.py": """
        import threading

        class Plane:
            def __init__(self):
                self._tab = {}
                self._t = threading.Thread(target=self._loop)

            def _loop(self):
                del self._tab[0]

            def drop(self, k):
                del self._tab[k]
    """})
    keys = {f.key for f in ownership.check(repo)}
    assert "ripplemq_tpu_torch/broker/mod.py::Plane::_tab" in keys


def test_lock_graph_flags_lock_owning_class_collision(tmp_path):
    """Two same-named classes that BOTH own locks: the bare-name class
    map shadows one, silently dropping its locks from the graph — made
    a finding instead of a blind spot."""
    repo = _seed_tree(tmp_path, {
        "ripplemq_tpu_torch/a.py": """
            import threading

            class Plane:
                def __init__(self):
                    self._lock = threading.Lock()
        """,
        "ripplemq_tpu_torch/b.py": """
            import threading

            class Plane:
                def __init__(self):
                    self._other_lock = threading.Lock()
        """,
    })
    keys = {f.key for f in lock_graph.check(repo)}
    assert "collision::Plane" in keys


def test_ownership_init_chain_exempt(tmp_path):
    """restore()-style boot helpers called only from __init__ run
    before any spawn: their writes must not read as racy."""
    repo = _seed_tree(tmp_path, {"ripplemq_tpu_torch/broker/mod.py": """
        import threading

        class Node:
            def __init__(self):
                self.x = 0

            def restore(self, v):
                self.x = v

            def tick(self):
                self.x += 1

        class Runner:
            def __init__(self):
                self.lock = threading.Lock()
                self.node = Node()
                self.node.restore(7)
                self._t = threading.Thread(target=self._run)

            def _run(self):
                with self.lock:
                    self.node.tick()
    """})
    assert {f.key for f in ownership.check(repo)} == set()


# ===================================================== whole-tree gates


def test_ledger_wellformed():
    # Every waiver names a known rule and carries a real reason.
    validate_ledger(WAIVERS, CHECKERS.keys())
    for w in WAIVERS:
        assert len(w.reason.strip()) > 20, (
            f"waiver {w.rule}:{w.key}: a reason must actually explain "
            f"why the finding is deliberate"
        )


def test_ledger_rejects_empty_reason():
    with pytest.raises(LedgerError):
        validate_ledger([Waiver("markers", "k", "  ")], CHECKERS.keys())
    with pytest.raises(LedgerError):
        validate_ledger([Waiver("not_a_rule", "k", "reason enough")],
                        CHECKERS.keys())


def test_unmatched_waiver_is_stale():
    report = run_lint(rules=["markers"], waivers=[
        Waiver("markers", "unvetted::no_such_module",
               "stale on purpose for this test"),
    ])
    assert not report["ok"]
    assert report["stale_waivers"][0]["key"] == "unvetted::no_such_module"


def test_tree_is_clean():
    """THE gate: zero unwaived findings, zero stale waivers, on the
    real tree with the real ledger."""
    report = run_lint()
    dirty = {
        rule: c["findings"]
        for rule, c in report["checkers"].items() if c["findings"]
    }
    assert report["ok"], (
        f"ripplelint dirty: {json.dumps(dirty, indent=2)[:4000]}\n"
        f"stale: {report['stale_waivers']}"
    )
    # All the advertised rules ran — including the concurrency plane
    # (threads / lock_graph / ownership).
    assert set(report["checkers"]) == set(CHECKERS)
    assert len(CHECKERS) >= 11
    assert {"threads", "lock_graph", "ownership"} <= set(CHECKERS)


def test_json_verdict_shape_and_budget():
    """The CI surface: per-checker counts + runtimes, JSON-encodable,
    and the whole-tree run fits far inside the tier-1 budget (it is
    AST-only — no imports of checked modules, no device)."""
    report = run_lint()
    json.loads(json.dumps(report))  # wire-encodable, no exotic types
    for rule, c in report["checkers"].items():
        assert {"count", "findings", "waived", "runtime_s"} <= set(c)
        assert c["runtime_s"] >= 0.0
    assert report["runtime_s"] < 60.0, (
        f"lint took {report['runtime_s']}s — it must stay a rounding "
        f"error inside the tier-1 budget"
    )


def test_single_rule_selection():
    report = run_lint(rules=["trace_vocab"])
    assert set(report["checkers"]) == {"trace_vocab"}
    with pytest.raises(KeyError):
        run_lint(rules=["nonsense"])


def test_cli_flags_and_exit_codes(monkeypatch, capsys):
    """`python -m ripplemq_tpu_torch.analysis` keeps `profiles/lint.py`'s
    flags and exit codes: 0 on a clean tree, 1 once a stale waiver (or
    a finding) appears, `--list` names all 11 rules."""
    from ripplemq_tpu_torch.analysis import ledger
    from ripplemq_tpu_torch.analysis.__main__ import main

    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(CHECKERS)
    assert main(["--json", "--rule", "shard_shapes"]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["ok"] and set(verdict["checkers"]) == {"shard_shapes"}
    monkeypatch.setattr(ledger, "WAIVERS", ledger.WAIVERS + (
        Waiver("shard_shapes", "stale::key", "stale on purpose here"),))
    assert main(["--rule", "shard_shapes"]) == 1
    assert "STALE WAIVER shard_shapes::stale::key" in capsys.readouterr().out

"""The port's operator tools (`ripplemq_tpu_torch/profiles/`) against the
reference's (`profiles/`), on the CPU (`--device cpu`).

- `host_edge.e2e_raw_config` is the reference bench's `e2e_raw_config`,
  dict for dict; `host_edge.measure` boots that topology (8 partitions)
  and returns every key the reference's breakdown emits, each timed
  term > 0;
- the soak CLI's verdicts for seeds 0 and 1 carry the reference
  `run_chaos`'s `schedule_digest` and `trace` exactly; `--replay` of a
  port verdict reproduces its digest; a `--sweep 2` document has the
  keys and the exit code of the reference CLI's document built from the
  reference's own verdicts;
- `trace_view --from-json` prints the reference CLI's text for the same
  span records (a bare list, a chaos verdict's postmortem rings, and
  `--json`), and needs no device;
- every CLI that does device work raises without `--device cpu` when no
  GPU is present.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys

import pytest
import torch

from ripplemq_tpu_torch.profiles import chaos_soak, host_edge, trace_view
from tests.torch_port_modules import admit

admit(__name__)

# The soak runs held against the reference: seeds 0 and 1 at a short
# schedule (the trace depends on the seed, phases and ops per phase).
SOAK = dict(phases=2, phase_s=0.4, ops_per_phase=2)
SOAK_ARGV = ["--phases", "2", "--phase-s", "0.4", "--ops-per-phase", "2",
             "--device", "cpu"]


def _run(main, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _run_reference_cli(main, argv, monkeypatch) -> tuple:
    """A reference CLI's `main()` (it parses sys.argv) in this process;
    the environment it sets for JAX is restored after the test."""
    import os

    for name in ("JAX_PLATFORMS", "XLA_FLAGS"):
        if name in os.environ:
            monkeypatch.setenv(name, os.environ[name])
        else:
            monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(sys, "argv", ["ref", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main()
    return rc, buf.getvalue()


# ------------------------------------------------------------- topology


@pytest.mark.parametrize("partitions", [1024, 8])
@pytest.mark.parametrize("host_workers", [1, 2])
def test_e2e_raw_config_is_the_bench_topology(partitions, host_workers):
    import bench

    ports = [9100, 9101, 9102]
    got = host_edge.e2e_raw_config(ports, partitions=partitions,
                                   host_workers=host_workers)
    want = bench.e2e_raw_config(ports, partitions=partitions,
                                host_workers=host_workers)
    assert got == want
    assert json.dumps(got) == json.dumps(want)  # key order too


def _reference_keys(host_workers: int) -> set:
    """Every key the reference's breakdown emits, read from its source."""
    import pathlib

    src = (pathlib.Path(__file__).resolve().parent.parent / "profiles"
           / "host_edge.py").read_text()
    keys = set(re.findall(r'out\["(\w+)"\]', src))
    if host_workers == 1:
        keys -= {"host_workers", "worker_submit256_ms"}
    return keys


@pytest.mark.parametrize("host_workers", [1, 2])
def test_host_edge_measure_returns_every_reference_key(tmp_path,
                                                        host_workers):
    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports

    raw = host_edge.e2e_raw_config(free_ports(3), partitions=8,
                                   host_workers=host_workers)
    out = host_edge.measure(raw, "cpu", str(tmp_path))
    assert set(out) == _reference_keys(host_workers)
    timed = {k: v for k, v in out.items() if k.endswith("_ms")}
    assert timed and all(v > 0 for v in timed.values()), out
    assert out["produce256_wire_bytes"] > 256 * 96
    if host_workers > 1:
        assert out["host_workers"] == host_workers


# ----------------------------------------------------------------- soak


@pytest.fixture(scope="module")
def reference_verdicts():
    from ripplemq_tpu.chaos import run_chaos

    return {seed: run_chaos(seed=seed, converge_timeout_s=30.0, **SOAK)
            for seed in (0, 1)}


@pytest.fixture(scope="module")
def port_sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep") / "sweep.json"
    rc, text = _run(chaos_soak.main,
                    ["--sweep", "2", *SOAK_ARGV, "--out", str(out)])
    doc = json.loads(out.read_text())
    assert json.loads(text) == doc
    return rc, doc


@pytest.mark.parametrize("seed", [0, 1])
def test_soak_verdict_matches_reference_run_chaos(port_sweep,
                                                  reference_verdicts, seed):
    _, doc = port_sweep
    got = doc["runs"][seed]
    want = reference_verdicts[seed]
    assert got["seed"] == seed
    assert got["schedule_digest"] == want["schedule_digest"]
    assert got["trace"] == want["trace"]
    assert got["violations"] == [] and got["safe"]


def test_sweep_document_matches_reference_cli(port_sweep, reference_verdicts,
                                              monkeypatch, tmp_path):
    """The reference CLI's sweep document, built by its own `main` from
    the reference's verdicts, has the port document's keys (the runs'
    too) and the same exit code."""
    import profiles.chaos_soak as ref_cli
    import ripplemq_tpu.chaos as ref_chaos

    monkeypatch.setattr(ref_chaos, "run_chaos",
                        lambda seed, **kw: reference_verdicts[seed])
    out = tmp_path / "ref.json"
    rc, _ = _run_reference_cli(
        ref_cli.main, ["--sweep", "2", "--phases", "2", "--phase-s", "0.4",
                       "--out", str(out)], monkeypatch)
    ref_doc = json.loads(out.read_text())
    port_rc, doc = port_sweep
    assert (port_rc, rc) == (0, 0)
    assert doc.keys() == ref_doc.keys() == {"sweep", "safe", "unsafe_seeds",
                                            "runs"}
    assert (doc["sweep"], doc["safe"], doc["unsafe_seeds"]) == (
        ref_doc["sweep"], ref_doc["safe"], ref_doc["unsafe_seeds"])
    for got, want in zip(doc["runs"], ref_doc["runs"]):
        assert got.keys() == want.keys()


def test_replay_of_a_port_verdict_reproduces_its_digest(port_sweep,
                                                        tmp_path):
    _, doc = port_sweep
    recorded = tmp_path / "verdict.json"
    recorded.write_text(json.dumps(doc["runs"][1]))
    out = tmp_path / "replayed.json"
    rc, _ = _run(chaos_soak.main, ["--replay", str(recorded), *SOAK_ARGV,
                                   "--seed", "1", "--out", str(out)])
    again = json.loads(out.read_text())
    assert rc == 0
    assert again["schedule_digest"] == doc["runs"][1]["schedule_digest"]
    assert again["trace"] == doc["runs"][1]["trace"]


def test_replay_schedule_follows_the_reference_rules():
    """A recorded verdict's backend, replication and splits win over the
    flags; the nemesis's own restarts and heals are stripped."""
    import argparse

    doc = {"backend": "proc", "replication": "striped", "splits": 2,
           "trace": [{"phase": 0, "op": "crash", "broker": 1},
                     {"phase": 0, "op": "restart", "broker": 1},
                     {"phase": 1, "op": "stripe_kill", "holder": 0},
                     {"phase": 1, "op": "restart_holder", "holder": 0},
                     {"phase": 2, "op": "heal"}]}
    args = argparse.Namespace(backend="inproc", replication="full",
                              splits=0)
    schedule = chaos_soak.replay_schedule(doc, args)
    assert (args.backend, args.replication, args.splits) == (
        "proc", "striped", 2)
    assert schedule == [[{"op": "crash", "broker": 1}],
                        [{"op": "stripe_kill", "holder": 0}], []]
    bare = chaos_soak.replay_schedule(doc["trace"][:1], args)
    assert bare == [[{"op": "crash", "broker": 1}]]


# ---------------------------------------------------------------- traces


@pytest.fixture(scope="module")
def span_records():
    records = trace_view.live_spans(messages=3, device="cpu")
    assert any(r["kind"] == "client.produce" for r in records)
    return records


@pytest.mark.parametrize("form", ["list", "verdict", "json"])
def test_from_json_prints_the_reference_text(span_records, form, tmp_path,
                                             monkeypatch):
    import profiles.trace_view as ref_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if form == "verdict":
        half = len(span_records) // 2
        doc = {"postmortems": {"0": {"spans": span_records[:half]},
                               "1": {"spans": span_records[half:]},
                               "2": {"spans": None}}}
    else:
        doc = span_records
    path = tmp_path / "spans.json"
    path.write_text(json.dumps(doc))
    argv = ["--from-json", str(path)] + (["--json"] if form == "json" else [])
    rc, text = _run(trace_view.main, argv)
    ref_rc, ref_text = _run_reference_cli(ref_cli.main, argv, monkeypatch)
    assert (rc, ref_rc) == (0, None)
    assert text == ref_text
    assert f"{len(span_records)} span records" in text or form == "json"


# ---------------------------------------------------------- device rule


@pytest.mark.parametrize("tool,argv", [
    (chaos_soak, ["--seed", "0"]),
    (trace_view, ["--messages", "1"]),
    (host_edge, []),
], ids=["chaos_soak", "trace_view", "host_edge"])
def test_cli_raises_without_device_when_no_gpu(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError,
                       match="no CUDA device available: pass device='cpu'"):
        tool.main(argv)

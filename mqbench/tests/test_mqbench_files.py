"""Every file the benchmark finds by name is there and loads, and nothing
the harness runs imports JAX or the JAX package."""

import ast
import json
import os
import re

import pytest

from mqbench import readers
from mqbench.run import cell_metrics

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "ripplemq_tpu"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_load(cell):
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        wl = json.load(f)
    cfg_entry = next(c for c in b["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == w["config"]
    assert config["message_bytes"] <= config["engine"]["slot_bytes"] - 8
    assert wl["producers"]["loop"] in ("open", "closed")
    for trace in (False, True):
        got = cell_metrics(b, cell, trace)
        assert got, (cell, trace)
        for name in got:
            assert callable(readers.load(name))
    e2e = cell_metrics(b, cell, False)
    assert "setup_s" in e2e and len(e2e) >= 2
    # Every per-layer metric of the cell moves an end-to-end metric the
    # cell reports.
    moves = {m["name"]: m["moves"] for m in b["per_layer"]}
    assert all(moves[n] in e2e for n in cell_metrics(b, cell, True))


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(readers.METRICS_DIR) if f.endswith(".py")))
def test_metric_files_load(name):
    assert callable(readers.load(name))
    b = bench()
    assert name in {m["name"] for m in b["end_to_end"] + b["per_layer"]}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if os.path.basename(path).startswith("reference"):
        assert "ripplemq_tpu_torch" not in tops, path


def test_top_level_names_compare_whole():
    from mqbench.run import forbidden_modules
    import sys

    assert "ripplemq_tpu_torch".split(".")[0] not in FORBIDDEN
    assert forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)

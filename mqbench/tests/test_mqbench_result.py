"""The last line a run prints is exactly the contract's object, and the
compared numbers end both streams."""

import json
import time

import pytest

from mqbench import run
from mqbench.tests.small import small_cell

CELL = "omb-100p-1kb-rf3.produce-max"


def test_result_line_keys(monkeypatch, capsys):
    import torch

    real = run.run_cell
    config, wl = small_cell(CELL)

    def small(_config, _wl, seed, seconds, trace, device, **kw):
        return real(config, wl, seed, 2.0, trace, "cpu",
                    t_start_ns=time.monotonic_ns())

    monkeypatch.setattr(run, "run_cell", small)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    rc = run.main(["--workload", CELL, "--seed", str(2**33 + 1),
                   "--seconds", "2", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    d = json.loads(out.strip().splitlines()[-1])
    assert set(d) == {"correct", "attempted", "failed", "metrics", "device",
                      "compared"}
    assert list(d)[-1] == "compared"
    assert d["correct"] is True and d["failed"] == 0 and d["attempted"] > 0
    assert set(d["metrics"]) == {"appends_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in d["metrics"].values())
    assert set(d["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    last = err.strip().splitlines()[-len(d["compared"]):]
    assert [ln.split()[0] for ln in last] == list(d["compared"])
    assert all(ln.endswith("limit 0") for ln in last)


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


@pytest.mark.card
def test_one_short_cell_on_the_card(card):
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "-m", "mqbench.run", "--workload", CELL,
         "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["correct"] and d["device"]["kind"] == card

"""The arithmetic the metric files share, and the loader that finds them.

A metric is a file `mqbench/metrics/<name>.py` with one function,
`read(run) -> float | None`, where `run` is the record of one run that
`mqbench.run` builds. A reader that finds nothing to read returns None,
and the harness leaves the metric out of the result line.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

METRICS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "metrics")
# The H100 SXM's HBM3 bandwidth, NVIDIA's data sheet (bytes/s).
H100_HBM_BYTES_PER_S = 3.35e12


def load(name: str):
    """The `read` function of metric `name`, by its file."""
    path = os.path.join(METRICS_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"mqbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window_mean(run: dict, hist: str, span: str = "window") -> float | None:
    """Mean of a registry histogram over a span of the run: the
    difference of its `total` over the difference of its `count`
    between the span's two snapshots (units as recorded)."""
    a, b = run["registry"][span]
    n = b["hist"].get(hist, (0, 0))[0] - a["hist"].get(hist, (0, 0))[0]
    if n <= 0:
        return None
    t = b["hist"][hist][1] - a["hist"].get(hist, (0, 0))[1]
    return t / n


def delta(run: dict, name: str, span: str = "window") -> int:
    """Difference of a registry counter (or of a histogram's count, as
    `<hist>.count`, or its total, as `<hist>.total`) over a span."""
    a, b = run["registry"][span]

    def get(s):
        if name.endswith(".count"):
            return s["hist"].get(name[:-6], (0, 0))[0]
        if name.endswith(".total"):
            return s["hist"].get(name[:-6], (0, 0))[1]
        return s["counters"].get(name, 0)

    return get(b) - get(a)


def ratio(run: dict, num: str, den: str, span: str = "window"):
    d = delta(run, den, span)
    return None if d <= 0 else delta(run, num, span) / d


def p95(values) -> float | None:
    v = np.asarray(values, np.float64)
    return None if len(v) == 0 else float(np.percentile(v, 95))


def idle_pct(run: dict) -> float | None:
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

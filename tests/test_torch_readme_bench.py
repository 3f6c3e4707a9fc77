"""README's "Bench (port)" subsection must quote the newest recorded
BENCH_torch_r*.json artifact exactly, beside the card's name and power
limit: the twin of tests/test_readme_bench.py for the port's bench.

The reference's one-round grace applies: the README must quote its
claimed artifact byte-exactly, and that artifact may lag the newest
BENCH_torch_r*.json by at most one round. The subsection also says how
the bench runs on the card, its `--compare` gate and `operating_curve`,
and why the port never writes BENCH_r*.json; README's reference line
("Latest recorded (BENCH_r*.json)") stays the JAX package's.
"""

from __future__ import annotations

import glob
import json
import os
import re

from tests.torch_port_modules import admit

admit(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADING = "### Bench (port)"


def _round_of(path: str) -> int:
    return int(re.search(r"BENCH_torch_r(\d+)", os.path.basename(path))
               .group(1))


def _section() -> str:
    readme = open(os.path.join(REPO, "README.md")).read()
    assert HEADING in readme, f"README lost its {HEADING!r} subsection"
    body = readme.split(HEADING, 1)[1]
    m = re.search(r"^#{2,3} ", body, re.MULTILINE)  # not a code comment
    return body[:m.start()] if m else body


def _quoted() -> tuple:
    sec = _section()
    line = re.search(r"Latest recorded on the card \((BENCH_torch_r\d+"
                     r"\.json)\):(.*?)\n\n", sec, re.DOTALL)
    assert line, "the port's subsection lost its 'Latest recorded on the " \
                 "card (BENCH_torch_r*.json)' figures"
    return line.group(1), line.group(2).replace("\n", " ")


def test_port_readme_quotes_recorded_bench_torch_artifact_exactly():
    name, quoted = _quoted()
    path = os.path.join(REPO, name)
    assert os.path.exists(path), f"README quotes nonexistent artifact {name}"
    arts = glob.glob(os.path.join(REPO, "BENCH_torch_r*.json"))
    newest = max(_round_of(p) for p in arts)
    assert newest - _round_of(name) <= 1, (
        f"README quotes {name} but the newest port artifact is round "
        f"{newest}")
    with open(path) as f:
        data = json.load(f)
    expect = {
        f"value {data['value']} committed appends/s": "engine number",
        f"vs_baseline {data['vs_baseline']}x": "baseline ratio",
        f"shipped shape {data['shipped_shape_appends_per_sec']}":
            "shipped shape",
        f"p50 ack {data['p50_ack_ms']} ms": "ack p50",
        f"p99 ack {data['p99_ack_ms']} ms": "ack p99",
        f"{data['round_rtt_ms']} ms single-round RTT": "round RTT",
        f"consume {data['consume_msgs_per_sec']} msgs/s": "consume rate",
        f"end-to-end {data['e2e_appends_per_sec']} appends/s":
            "e2e produce",
        f"end-to-end consume {data['e2e_consume_msgs_per_sec']} msgs/s":
            "e2e consume",
        f"codec {data['codec_mb_per_sec']} MB/s": "codec",
        f"stripe encode {data['stripe_encode_mb_per_sec']} MB/s":
            "stripe encode",
        data["card"]["nvidia_smi"]: "card name and power limit",
    }
    for needle, label in expect.items():
        assert needle in quoted, (
            f"README's {label} disagrees with {name}: expected {needle!r} "
            f"in {quoted!r}")


def test_port_artifacts_carry_an_nvidia_card():
    arts = glob.glob(os.path.join(REPO, "BENCH_torch_r*.json"))
    assert arts, "no BENCH_torch_r*.json artifact recorded"
    for path in arts:
        with open(path) as f:
            card = json.load(f)["card"]
        assert "NVIDIA" in card["nvidia_smi"] and card["count"] >= 1, path


def test_port_subsection_says_how_to_run_and_gate_the_bench():
    sec = _section()
    for needle in ("python -m ripplemq_tpu_torch.bench",
                   "--compare", "operating_curve",
                   "BENCH_r", "--device cpu"):
        assert needle in sec, f"README's {HEADING} lost {needle!r}"


def test_reference_latest_recorded_line_stays_the_jax_round():
    readme = open(os.path.join(REPO, "README.md")).read()
    line = re.search(r"Latest recorded \(([^)]+)\):", readme)
    assert line and re.fullmatch(r"BENCH_r\d+\.json", line.group(1))

"""The port's bench (`ripplemq_tpu_torch/bench.py`) against the
reference's (`bench.py` at the repository root), on the CPU.

- constants: HEADLINE_GATES, REGRESSION_PCT, _DECOMPOSITION_STAGES, the
  e2e topology and main()'s shipped, baseline and latency engine shapes
  are the reference's;
- the gate: `compare_results` returns the reference's failure lists on
  generated result/baseline pairs, `_load_baseline` the reference's
  dict for every BENCH_r*.json, its wrapper documents and front-truncated
  tails; `--compare` refuses a baseline without an NVIDIA card;
- the rails prior: `_operating_curve_main` writes the reference's
  rails, floor and curve for the same measured curve, and each
  package's SloController loads the same rails from its own file;
- the engine method at P 8, R 3, S 256, SB 128, B 16, chain 4 with 12
  launches (the ring wraps): the staged trims, a sustained window's
  final state byte for byte, the burst and sustained runners with their
  readback, the control-only rounds writing no log row, and a flipped
  log byte failing the ring-tail check;
- the DataPlane runners and the fusion A/B return the reference's keys,
  consume count-exact; `main()`'s artifact has the reference's keys in
  its order (plus `card`), and is archived as BENCH_torch_r*.json only;
  (the remaining runners, slice J, are held in
  `test_torch_bench_{cluster,storm,spmd,procs}.py`);
- the e2e client, a subprocess on the line protocol against 3 CPU
  brokers over TCP, is count-exact and never imports torch; `_run_e2e`
  at 8 partitions returns the reference's keys.
"""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import bench as ref
from ripplemq_tpu_torch import bench
from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.core.config import EngineConfig
from tests.torch_port_modules import admit

admit(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The engine method's shape (PAYLOAD is 100 bytes: a row of SB 128
# holds it with its 8-byte header).
ENGINE = dict(partitions=8, replicas=3, slots=256, slot_bytes=128,
              max_batch=16, read_batch=16, max_consumers=8,
              max_offset_updates=4)
CHAIN = 4
LAUNCHES = 12  # 12 x 4 rounds x 16 rows = 768 rows > 256 slots: wraps

def _ref_cfg(**kw):
    from ripplemq_tpu.core.config import EngineConfig as RefConfig

    return RefConfig(**{**ENGINE, **kw})


def _port_cfg(**kw):
    return EngineConfig(**{**ENGINE, **kw})


# ------------------------------------------------------------ constants


def test_gate_constants_are_the_reference_ones():
    assert bench.HEADLINE_GATES == ref.HEADLINE_GATES
    assert bench.REGRESSION_PCT == ref.REGRESSION_PCT
    assert bench._DECOMPOSITION_STAGES == ref._DECOMPOSITION_STAGES
    assert bench.PAYLOAD == ref.PAYLOAD


@pytest.mark.parametrize("host_workers", [1, 2])
@pytest.mark.parametrize("partitions", [1024, 8])
def test_e2e_raw_config_is_the_reference_topology(host_workers, partitions):
    ports = [9200, 9201, 9202]
    got = bench.e2e_raw_config(ports, partitions=partitions,
                               host_workers=host_workers)
    want = ref.e2e_raw_config(ports, partitions=partitions,
                              host_workers=host_workers)
    assert json.dumps(got) == json.dumps(want)  # key order too


def test_host_edge_takes_the_bench_topology():
    from ripplemq_tpu_torch.profiles import host_edge

    assert host_edge.e2e_raw_config is bench.e2e_raw_config


def _ref_main_engine(var: str) -> dict:
    """The keyword arguments of `var = EngineConfig(...)` in the
    reference's `main()`, read from its source."""
    src = open(os.path.join(REPO, "bench.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets] == [var]
                and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "EngineConfig"):
            return {k.arg: ast.literal_eval(k.value)
                    for k in node.value.keywords}
    raise AssertionError(f"no {var} = EngineConfig(...) in bench.py main")


@pytest.mark.parametrize("var,shape", [("shipped_cfg", "SHIPPED_SHAPE"),
                                       ("base_cfg", "BASE_SHAPE"),
                                       ("lat_cfg", "LAT_SHAPE")])
def test_main_engine_shapes_are_the_reference_ones(var, shape):
    assert getattr(bench, shape) == _ref_main_engine(var)


def test_control_ab_presets_are_the_reference_ones():
    import importlib.util

    from ripplemq_tpu_torch.profiles import control_ab

    spec = importlib.util.spec_from_file_location(
        "ref_control_ab", os.path.join(REPO, "profiles", "control_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert control_ab.PRESETS["cpu"] == mod.PRESETS["cpu"]
    assert control_ab.PRESETS["gpu"] == mod.PRESETS["tpu"]


# ------------------------------------------------------------------ gate

_GATE_KEYS = [k for k, _ in ref.HEADLINE_GATES]
_values = st.one_of(st.just(0.0), st.floats(0.001, 1e9),
                    st.integers(0, 10**9))


def _artifact():
    return st.dictionaries(st.sampled_from(_GATE_KEYS + ["other", "unit"]),
                           _values, max_size=len(_GATE_KEYS) + 2)


@settings(max_examples=150, deadline=None)
@given(result=_artifact(), baseline=_artifact(),
       threshold=st.sampled_from([ref.REGRESSION_PCT, 0.0, 5.0, 50.0]))
def test_compare_results_matches_reference(result, baseline, threshold):
    assert bench.compare_results(result, baseline, threshold) == \
        ref.compare_results(result, baseline, threshold)


def test_compare_results_prints_the_reference_verdict_lines(capsys):
    base = {"value": 100.0, "p99_ack_ms": 10.0, "codec_mb_per_sec": 5}
    cur = {"value": 80.0, "p99_ack_ms": 10.5, "codec_mb_per_sec": 5}
    bench.compare_results(cur, base)
    got = capsys.readouterr().err
    ref.compare_results(cur, base)
    assert got == capsys.readouterr().err
    assert "REGRESSED" in got


_ARTIFACTS = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json")))


@pytest.mark.parametrize("path", _ARTIFACTS, ids=os.path.basename)
def test_load_baseline_matches_reference_on_recorded_artifacts(path):
    assert bench._load_baseline(path) == ref._load_baseline(path)


def _one_artifact() -> dict:
    doc = ref._load_baseline(_ARTIFACTS[-1])
    return {k: doc[k] for k in list(doc)[:20]}


@pytest.mark.parametrize("wrap", ["bare", "parsed", "tail", "tail_prefixed"])
def test_load_baseline_matches_reference_on_wrappers(tmp_path, wrap):
    art = _one_artifact()
    text = json.dumps(art)
    doc = {"bare": art, "parsed": {"parsed": art, "rc": 0},
           "tail": {"tail": text},
           "tail_prefixed": {"tail": "noise line\n" + text}}[wrap]
    path = tmp_path / "b.json"
    path.write_text(json.dumps(doc))
    assert bench._load_baseline(str(path)) == ref._load_baseline(str(path))


@pytest.mark.parametrize("cut", [1, 5, 23, 60, 200, 400])
def test_load_baseline_matches_reference_on_truncated_tails(tmp_path, cut):
    text = json.dumps(_one_artifact())
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"tail": text[cut:]}))

    def load(mod):
        try:
            return mod._load_baseline(str(path))
        except SystemExit as e:
            return ("SystemExit", str(e))

    assert load(bench) == load(ref)


@pytest.mark.parametrize("card", [
    None, {"nvidia_smi": None, "count": 0},
    {"nvidia_smi": "TPU v5 lite", "count": 1}])
def test_compare_refuses_a_baseline_without_an_nvidia_card(tmp_path, card):
    doc = {"metric": "committed_appends_per_sec", "value": 1.0}
    if card is not None:
        doc["card"] = card
    path = tmp_path / "base.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(SystemExit, match="names no NVIDIA card"):
        bench._require_card_baseline(bench._load_baseline(str(path)),
                                     str(path))


# ------------------------------------------------------- operating curve

_CURVES = [
    [  # a knee at 5 ms: the 2 ms point stays within 25% of the floor
        {"coalesce_s": 0.0, "chain_depth": 1, "appends_per_sec": 900.0,
         "p50_ack_ms": 4.0, "p99_ack_ms": 8.0},
        {"coalesce_s": 0.002, "chain_depth": 4, "appends_per_sec": 950.0,
         "p50_ack_ms": 5.0, "p99_ack_ms": 9.5},
        {"coalesce_s": 0.005, "chain_depth": 8, "appends_per_sec": 700.0,
         "p50_ack_ms": 9.0, "p99_ack_ms": 14.0},
        {"coalesce_s": 0.02, "chain_depth": 8, "appends_per_sec": 300.0,
         "p50_ack_ms": 25.0, "p99_ack_ms": 30.0},
        {"coalesce_s": 0.002, "chain_depth": 4, "window": 32, "parts": 4,
         "appends_per_sec": 5000.0, "p50_ack_ms": 30.0, "p99_ack_ms": 40.0},
        {"coalesce_s": 0.005, "chain_depth": 8, "window": 64, "parts": 4,
         "appends_per_sec": 6000.0, "p50_ack_ms": 35.0, "p99_ack_ms": 50.0},
    ],
    [  # 1.24x the floor is inside the 25% budget, 1.30x is not
        {"coalesce_s": 0.0, "chain_depth": 1, "appends_per_sec": 800.0,
         "p50_ack_ms": 6.0, "p99_ack_ms": 10.0},
        {"coalesce_s": 0.002, "chain_depth": 4, "appends_per_sec": 820.0,
         "p50_ack_ms": 6.5, "p99_ack_ms": 12.4},
        {"coalesce_s": 0.005, "chain_depth": 8, "appends_per_sec": 900.0,
         "p50_ack_ms": 7.0, "p99_ack_ms": 13.0},
        {"coalesce_s": 0.02, "chain_depth": 8, "appends_per_sec": 400.0,
         "p50_ack_ms": 20.0, "p99_ack_ms": 24.0},
    ],
    [  # every light point flat: the largest budget wins
        {"coalesce_s": 0.0, "chain_depth": 1, "appends_per_sec": 500.0,
         "p50_ack_ms": 2.0, "p99_ack_ms": 3.0},
        {"coalesce_s": 0.02, "chain_depth": 8, "appends_per_sec": 400.0,
         "p50_ack_ms": 2.1, "p99_ack_ms": 3.1},
        {"coalesce_s": 0.002, "chain_depth": 4, "window": 32, "parts": 4,
         "appends_per_sec": 300.0, "p50_ack_ms": 6.0, "p99_ack_ms": 9.0},
    ],
]


def _rails_of(pkg: str, path) -> tuple:
    """The rails `pkg`'s SloController loads from the prior at `path`."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    config = mod("metadata.cluster_config").ClusterConfig(
        brokers=(mod("metadata.models").BrokerInfo(0, "h", 9000),),
        topics=(), slo_p99_ack_ms=50.0, slo_rails_file=str(path))
    ctl = mod("slo.controller").SloController(
        config, mod("obs.metrics").Metrics(enabled=True),
        mod("obs.trace").FlightRecorder(), dataplane_fn=lambda: None)
    return (ctl.rc_min, ctl.rc_max, ctl.cd_min, ctl.cd_max)


@pytest.mark.parametrize("curve", _CURVES, ids=["knee", "edge", "flat"])
def test_operating_curve_main_writes_the_reference_prior(
        tmp_path, monkeypatch, capsys, curve):
    monkeypatch.setattr(ref, "_run_curve", lambda cfg: [dict(p) for p in curve])
    monkeypatch.setattr(bench, "_run_curve",
                        lambda cfg, device=None: [dict(p) for p in curve])
    ref._operating_curve_main(str(tmp_path / "ref.json"))
    bench._operating_curve_main(str(tmp_path / "port.json"), device="cpu")
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    for key in ("rails", "floor_p99_ack_ms", "curve"):
        assert got[key] == want[key], key
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0])["rails"] == json.loads(lines[1])["rails"]
    rails = _rails_of("ripplemq_tpu_torch", tmp_path / "port.json")
    assert rails == _rails_of("ripplemq_tpu", tmp_path / "ref.json")
    assert rails == tuple(got["rails"][k] for k in (
        "read_coalesce_min_s", "read_coalesce_max_s", "chain_depth_min",
        "chain_depth_max"))


# ------------------------------------------------------------ engine method


@pytest.mark.parametrize("adv_round", [None, 16, 8])
def test_stage_trims_match_reference(adv_round):
    cfg = _port_cfg()
    adv = CHAIN * (adv_round or cfg.max_batch)
    _, _, _, _, put = bench._make(cfg, "cpu")
    got = bench._stage_trims(cfg, adv, LAUNCHES, put, adv_round=adv_round)
    want = ref._stage_trims(_ref_cfg(), adv, LAUNCHES, np.asarray,
                            adv_round=adv_round)
    assert len(got) == len(want) == LAUNCHES
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)


def _ref_window(cfg_kw, bpp):
    import jax

    from ripplemq_tpu.core.config import ALIGN

    cfg = _ref_cfg(**cfg_kw)
    fns, alive, quorum, build = ref._make(cfg)
    adv_round = -(-bpp // ALIGN) * ALIGN
    one = build(cfg, appends={p: [ref.PAYLOAD] * bpp
                              for p in range(cfg.partitions)},
                leader=0, term=1)
    inp = jax.device_put(jax.tree.map(
        lambda x: np.broadcast_to(x, (CHAIN,) + x.shape).copy(), one))
    trims = ref._stage_trims(cfg, CHAIN * adv_round, LAUNCHES,
                             jax.device_put, adv_round=adv_round)
    ref._sustained_warmup(fns, inp, alive, quorum, trims)
    _, state = ref._sustained_window(fns, inp, alive, quorum, trims, 1.0)
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _port_window(cfg_kw, bpp):
    from ripplemq_tpu_torch.core.config import ALIGN

    cfg = _port_cfg(**cfg_kw)
    fns, alive, quorum, build, put = bench._make(cfg, "cpu")
    adv_round = -(-bpp // ALIGN) * ALIGN
    one = build(cfg, appends={p: [bench.PAYLOAD] * bpp
                              for p in range(cfg.partitions)},
                leader=0, term=1)
    inp = bench._stack(one, CHAIN, put)
    # The CUDA kernel takes only contiguous entries: every staged leaf,
    # and each round's slice of it, must be.
    for x in inp:
        if x is not None:
            assert x.is_contiguous() and x[0].is_contiguous()
    trims = bench._stage_trims(cfg, CHAIN * adv_round, LAUNCHES, put,
                               adv_round=adv_round)
    bench._sustained_warmup(fns, inp, alive, quorum, trims)
    _, state = bench._sustained_window(fns, inp, alive, quorum, trims, 1.0)
    return cfg, fns, state, adv_round


@pytest.mark.parametrize("flags,bpp", [
    ({}, 16),
    (dict(fused_control=True), 16),
    (dict(packed_writes=True), 16),
    (dict(fused_control=True, packed_writes=True), 16),
    (dict(fused_control=True, packed_writes=True), 4),
], ids=["legacy", "fused", "packed", "fused_packed", "fused_packed_b4"])
def test_sustained_window_leaves_the_reference_state(flags, bpp):
    want = _ref_window(flags, bpp)
    _, _, state, _ = _port_window(flags, bpp)
    got = convert.state_to_numpy(state)
    assert got.keys() == want.keys()
    for name in want:  # log bytes, log_end (base), commit, terms, offsets
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_verify_ring_tail_catches_a_flipped_log_byte():
    from ripplemq_tpu_torch.core.config import ROW_HEADER

    cfg, fns, state, adv_round = _port_window({}, 16)
    total_rows = LAUNCHES * CHAIN * adv_round
    kw = dict(total_rows=total_rows, batch=16, adv_round=adv_round,
              nparts=cfg.partitions)
    bench._verify_ring_tail(fns, state, **kw)  # intact: passes
    row = (total_rows - adv_round) % cfg.slots  # the last round's first row
    state.log_data[0, cfg.partitions - 1, row, ROW_HEADER + 20] ^= 0x01
    with pytest.raises(AssertionError, match="corrupt payload"):
        bench._verify_ring_tail(fns, state, **kw)


@pytest.mark.parametrize("chain,rounds", [(1, 6), (4, 12)])
def test_run_mode_verifies_readback(chain, rounds):
    rate = bench._run_mode(_port_cfg(), batch_per_partition=16,
                           rounds=rounds, warmup=1, verify=True,
                           chain=chain, device="cpu")
    assert rate > 0


@pytest.mark.parametrize("cfg_kw,kw", [
    ({}, dict()), ({}, dict(batch_per_partition=4)),
    # the baseline's shape: one partition, one entry a round, unchained
    (dict(partitions=1, replicas=5, max_batch=8),
     dict(batch_per_partition=1, partitions=1, chain=1))],
    ids=["full", "partial", "baseline_shape"])
def test_run_sustained_wraps_and_verifies(cfg_kw, kw):
    kw = {"chain": CHAIN, **kw}
    launches = LAUNCHES * (64 if kw["chain"] == 1 else 1)  # still wraps
    assert bench._run_sustained(_port_cfg(**cfg_kw), launches=launches,
                                windows=2, verify=True, device="cpu",
                                **kw) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_run_control_only_writes_no_log_row(monkeypatch, fused):
    states = []
    window = bench._sustained_window

    def keep(*a, **k):
        rate, state = window(*a, **k)
        states.append(convert.state_to_numpy(state))
        return rate, state

    monkeypatch.setattr(bench, "_sustained_window", keep)
    rate = bench._run_control_only(_port_cfg(fused_control=fused),
                                   chain=CHAIN, launches=LAUNCHES,
                                   windows=2, device="cpu")
    assert rate > 0 and len(states) == 2
    for s in states:
        assert not s["log_data"].any()
        assert (s["offsets"][:, :, 0] == 1).all()  # the updates committed


# ------------------------------------------------------ DataPlane runners

_LAT = dict(partitions=16, replicas=3, slots=512, slot_bytes=128,
            max_batch=8, read_batch=16, max_consumers=8,
            max_offset_updates=4)


def _curve_point_keys(pt: dict) -> set:
    """The keys `_run_curve` gives a point, read from the reference's
    source (its `curve.append({**pt, ...})` literal)."""
    src = open(os.path.join(REPO, "bench.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_run_curve")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "append"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return set(pt) | {k.value for k in node.args[0].keys
                              if k is not None}
    raise AssertionError("no curve point literal in bench.py")


def test_run_latency_returns_the_reference_percentiles():
    got = bench._run_latency(_port_cfg(**_LAT), submitters=4, per_thread=12,
                             device="cpu")
    assert set(got) == {"p50", "p99", "p999"}
    assert 0 < got["p50"] <= got["p99"] <= got["p999"]


def test_run_consume_is_count_exact():
    cfg = _port_cfg(**_LAT)
    # _run_consume asserts every produced message drained exactly once.
    assert bench._run_consume(cfg, consumers=4, rows_per_part=16,
                              device="cpu") > 0


def test_run_curve_returns_the_reference_point_keys():
    points = [{"coalesce_s": 0.0, "chain_depth": 1},
              {"coalesce_s": 0.002, "chain_depth": 4, "window": 4,
               "parts": 2}]
    curve = bench._run_curve(_port_cfg(**_LAT), points=points, submitters=2,
                             per_thread=8, device="cpu")
    assert len(curve) == 2
    for pt, got in zip(points, curve):
        assert set(got) == _curve_point_keys(pt)
        assert got["appends_per_sec"] > 0
        assert got["p50_ack_ms"] <= got["p99_ack_ms"]


def _ref_fusion_keys(monkeypatch, shape) -> set:
    monkeypatch.setattr(ref, "_run_control_only", lambda cfg, **kw: 1.0)
    monkeypatch.setattr(ref, "_run_sustained", lambda cfg, **kw: 1.0)
    return set(ref._run_fusion_ab(shape=shape))


def test_control_ab_cli_returns_the_reference_fusion_keys(monkeypatch,
                                                          capsys):
    from ripplemq_tpu_torch.profiles import control_ab

    shape = control_ab.PRESETS["cpu"]["shape"]
    rc = control_ab.main(["--preset", "cpu", "--device", "cpu",
                          "--launches", str(LAUNCHES),
                          "--control-launches", str(LAUNCHES)])
    out = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rc == 0
    assert set(out) == _ref_fusion_keys(monkeypatch, shape)
    assert out["config"] == "P=64 R=3 B=32 chain=4 sustained"
    assert all(v > 0 for k, v in out.items() if k != "config")


# ------------------------------------------------------------ main schema

def _ref_e2e_keys() -> list:
    """`_run_e2e`'s artifact keys, in order, read from the reference's
    source (the dict literal it returns)."""
    src = open(os.path.join(REPO, "bench.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_run_e2e")
    rets = [n.value for n in ast.walk(fn)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(rets) == 1
    return [k.value for k in rets[0].keys]


def _stub_common(monkeypatch, mod):
    e2e = {k: 1.0 for k in _ref_e2e_keys()}
    lat = {"p50": 1.0, "p99": 2.0, "p999": 3.0}
    codec = {"codec_mb_per_sec": 1.0, "encode_mb_per_sec_bulk": 1.0}
    stubs = {
        "_run_sustained": lambda *a, **k: 1.0,
        "_run_mode": lambda *a, **k: 1.0,
        "_run_latency": lambda *a, **k: dict(lat),
        "_round_rtt": lambda *a, **k: 1.0,
        "_run_curve": lambda *a, **k: [],
        "_run_consume": lambda *a, **k: 1.0,
        "_run_fusion_ab": lambda *a, **k: {"config": "x"},
        "_run_codec": lambda *a, **k: dict(codec),
        "_run_stripe_encode": lambda *a, **k: 1.0,
        "_run_e2e": lambda *a, **k: dict(e2e),
        "_run_spmd_parity": lambda *a, **k: {},
        "_run_spmd_scaling": lambda *a, **k: {},
        "_run_repl_bytes": lambda *a, **k: {},
        "_run_slo_convergence": lambda *a, **k: {},
        "_run_split_rebalance": lambda *a, **k: {},
        "_run_consume_fanout": lambda *a, **k: {},
        "_run_host_plane_scaling": lambda *a, **k: {},
        # the two runners whose dicts splat into the artifact
        "_run_control_plane_storm": lambda *a, **k: {
            "control_plane_storm": {}},
        "_run_group_consume": lambda *a, **k: {
            "e2e_group_consume_msgs_per_sec": 1.0, "group_consume": {}},
    }
    for name, fn in stubs.items():
        monkeypatch.setattr(mod, name, fn)


def _reference_main_keys(monkeypatch, capsys) -> list:
    _stub_common(monkeypatch, ref)
    archived = []
    monkeypatch.setattr(ref, "_archive_result",
                        lambda result: archived.append(result) or "x")
    ref.main()
    keys = list(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert archived and list(archived[0]) == keys
    return keys


def test_result_keys_are_the_reference_main_keys_less_slice_j(
        monkeypatch, capsys):
    """Since slice J, nothing is left out: the artifact's keys are the
    reference main()'s, in its order, plus `card` (the name is kept)."""
    ref_keys = _reference_main_keys(monkeypatch, capsys)
    assert [k for k in bench.RESULT_KEYS if k != "card"] == ref_keys
    assert bench.RESULT_KEYS[-1] == "card"


def test_main_archives_bench_torch_rounds_with_the_result_keys(
        monkeypatch, capsys, tmp_path):
    _stub_common(monkeypatch, bench)
    bench.main(device="cpu", out_dir=str(tmp_path))
    bench.main(device="cpu", out_dir=str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == ["BENCH_torch_r01.json", "BENCH_torch_r02.json"]
    doc = json.loads((tmp_path / names[0]).read_text())
    assert tuple(doc) == bench.RESULT_KEYS
    assert doc["card"]["nvidia_smi"] is None and doc["card"]["count"] == 0
    captured = capsys.readouterr()
    printed = captured.out.splitlines()
    assert json.loads(printed[0]) == doc
    # the kernels' counters: the CPU's plain versions launch nothing
    assert ("kernel launches in this process: {'append_active': 0, "
            "'append_active_packed': 0, 'gf_matmul': 0}") in captured.err
    assert not glob.glob(str(tmp_path / "BENCH_r*.json"))


def test_main_compare_refuses_a_tpu_round_before_running(monkeypatch,
                                                          tmp_path):
    ran = []
    monkeypatch.setattr(bench, "_collect", lambda *a, **k: ran.append(1))
    with pytest.raises(SystemExit, match="names no NVIDIA card"):
        bench.main(compare=_ARTIFACTS[-1], device="cpu",
                   out_dir=str(tmp_path))
    assert not ran and not os.listdir(tmp_path)


@pytest.mark.parametrize("ratio,ok", [(1.0, True), (0.5, False)])
def test_main_compare_gates_against_an_nvidia_baseline(
        monkeypatch, capsys, tmp_path, ratio, ok):
    _stub_common(monkeypatch, bench)
    out = tmp_path / "out"
    out.mkdir()
    bench.main(device="cpu", out_dir=str(out))
    base = json.loads((out / "BENCH_torch_r01.json").read_text())
    base["card"] = {"nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W",
                    "count": 1}
    base["value"] = base["value"] / ratio
    path = tmp_path / "base.json"
    path.write_text(json.dumps(base))
    capsys.readouterr()
    if ok:
        bench.main(compare=str(path), device="cpu", out_dir=str(out))
        assert "bench regression gate: ok" in capsys.readouterr().err
    else:
        with pytest.raises(SystemExit, match="gate FAILED"):
            bench.main(compare=str(path), device="cpu", out_dir=str(out))


@pytest.mark.parametrize("argv", [[], ["operating_curve", "rails.json"],
                                  ["--compare", "x.json"],
                                  ["consume_fanout"], ["split_rebalance"],
                                  ["control_plane_storm"]])
def test_cli_raises_without_device_when_no_gpu(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    if argv[:1] == ["--compare"]:  # a valid baseline, so the run starts
        (tmp_path / "x.json").write_text(json.dumps({
            "metric": "m", "card": {"nvidia_smi": "NVIDIA H100, 700 W"}}))
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        bench._cli(argv)
    assert not glob.glob(str(tmp_path / "BENCH_*.json"))
    assert not (tmp_path / "rails.json").exists()


# -------------------------------------------------------------------- e2e


@pytest.fixture
def tcp_cluster(tmp_path):
    """3 CPU brokers over loopback TCP in this process, topic "bench" of
    8 partitions at RF 3 (the e2e topology at 8 partitions)."""
    import time

    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.chaos.proc_cluster import free_ports
    from ripplemq_tpu_torch.metadata.cluster_config import (
        parse_cluster_config,
    )
    from ripplemq_tpu_torch.wire.transport import TcpClient

    raw = bench.e2e_raw_config(free_ports(3), partitions=8)
    config = parse_cluster_config(raw)
    brokers = []
    try:
        for b in config.brokers:
            brokers.append(BrokerServer(
                b.broker_id, config, net=None, device="cpu",
                data_dir=str(tmp_path / f"d{b.broker_id}")))
            brokers[-1].start()
        addr = f"127.0.0.1:{config.brokers[0].port}"
        client = TcpClient()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            r = client.call(addr, {"type": "meta.topics"}, timeout=5.0)
            t = r.get("topics", [])
            if r.get("ok") and t and all(a["leader"] is not None
                                         for a in t[0]["assignments"]):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("cluster never elected leaders")
        client.close()
        yield raw
    finally:
        for b in brokers:
            b.stop()


def test_e2e_client_is_count_exact_and_torch_free(tcp_cluster, tmp_path):
    raw = tcp_cluster
    spec = {"bootstrap": [f"127.0.0.1:{b['port']}" for b in raw["brokers"]],
            "proc_id": 0, "nprocs": 1, "threads": 2, "batch": 64,
            "window": 4, "duration_s": 0.5, "partitions": 8,
            "read_batch": raw["engine"]["read_batch"]}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    # The CLI entry, run as `python -m ripplemq_tpu_torch.bench
    # _e2e_client SPEC` would run it; afterwards the process reports
    # whether torch was ever imported.
    code = ("import runpy, sys; sys.argv = ['bench', '_e2e_client', "
            "sys.argv[1]]; runpy.run_module('ripplemq_tpu_torch.bench', "
            "run_name='__main__', alter_sys=True); "
            "print('TORCH', 'torch' in sys.modules, flush=True)")
    c = subprocess.Popen([sys.executable, "-c", code, str(spec_path)],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        assert c.stdout.readline().strip() == "READY"
        acked = 0
        for phase in range(2):
            c.stdin.write("PRODUCE\n")
            c.stdin.flush()
            line = c.stdout.readline()
            assert line.startswith("RESULT "), line
            res = json.loads(line[len("RESULT "):])
            assert res["acked"] > 0 and res["nbytes"] == 100 * res["acked"]
            acked += res["acked"]
            c.stdin.write(f"DRAIN {phase}\n")
            c.stdin.flush()
            line = c.stdout.readline()
            assert line.startswith("RESULT "), line
            drained = json.loads(line[len("RESULT "):])
            assert drained["warmups"] == 0
            assert drained["drained"] == acked  # the whole topic, exactly
            assert drained["dbytes"] == 100 * acked
        c.stdin.write("EXIT\n")
        c.stdin.flush()
        assert c.stdout.readline().strip() == "TORCH False"
        assert c.wait(timeout=30) == 0
    finally:
        if c.poll() is None:
            c.kill()
            c.wait()


def test_run_e2e_returns_the_reference_keys_count_exact():
    out = bench._run_e2e(duration_s=0.5, phases=1, threads=2,
                         client_procs=1, window=4, batch=64,
                         device="cpu", partitions=8)
    assert list(out) == _ref_e2e_keys()
    assert out["e2e_readback"] == "verified"
    assert out["e2e_consume_verified"] == "count-exact"
    assert out["e2e_consumed"] == out["e2e_acked"] + 8  # + the warmup batch
    assert out["e2e_appends_per_sec"] > 0
    assert out["e2e_consume_msgs_per_sec"] > 0
    assert set(out["latency_decomposition"]) <= set(
        bench._DECOMPOSITION_STAGES)


def test_port_bench_never_imports_the_reference():
    """The port's bench and its control_ab and spmd_scaling twins import
    neither JAX nor the reference package nor the root bench, anywhere in
    their source."""
    for rel in ("ripplemq_tpu_torch/bench.py",
                "ripplemq_tpu_torch/profiles/control_ab.py",
                "ripplemq_tpu_torch/profiles/spmd_scaling.py"):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "ripplemq_tpu", "bench"}, rel
        assert "torch" not in {
            a.name for n in tree.body if isinstance(n, ast.Import)
            for a in n.names}, f"{rel} imports torch at module level"

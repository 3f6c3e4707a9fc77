"""The port bench's spmd runners against the reference's (`bench.py` and
`profiles/spmd_scaling.py` at the repository root), on the CPU:

- the parity method: one `_sustained_window` (ring wrapped, 12 launches
  of chain 4) through the port's spmd binding on a 1 x 1 mesh, fused and
  legacy control, leaves the reference's `make_spmd_fns` state on its
  1 x 1 mesh byte for byte, and the port's local binding's state (named
  fields); the shape is test_torch_bench's engine at R 1 (the runner's
  own shape is the chip's 1.6 GB ring);
- `_run_spmd_parity` returns the reference's keys and leaves no process
  group behind, unless the caller had joined one;
- `_run_spmd_scaling` at rank counts 1 and 2 on CPU gloo worlds: the
  reference's point keys and `partitions` / `local_P` / `max_batch`, the
  ring tail verified on every rank, `vs_1dev` by the reference's
  formula; a world past its time is killed whole;
- the profile's SHAPE and the parity shape are the reference's.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import bench as ref
from ripplemq_tpu_torch import bench, convert
from ripplemq_tpu_torch.core.config import EngineConfig
from tests.torch_helpers import dict_keys, ref_return_keys
from tests.torch_port_modules import admit

admit(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_torch_bench's engine at R 1 (a 1 x 1 mesh has one replica cell).
ENGINE = dict(partitions=8, replicas=1, slots=256, slot_bytes=128,
              max_batch=16, read_batch=16, max_consumers=8,
              max_offset_updates=4)
CHAIN = 4
LAUNCHES = 12  # 12 x 4 rounds x 16 rows = 768 rows > 256 slots: wraps


def _ref_spmd_window(fused: bool) -> dict:
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec

    from ripplemq_tpu.core.config import EngineConfig as RefConfig
    from ripplemq_tpu.core.encode import build_step_input
    from ripplemq_tpu.parallel.engine import make_spmd_fns
    from ripplemq_tpu.parallel.mesh import make_mesh

    cfg = RefConfig(**ENGINE, fused_control=fused)
    mesh = make_mesh(1, 1)
    rep = NamedSharding(mesh, PartitionSpec())

    def put(x):
        return jax.device_put(x, rep)

    fns = make_spmd_fns(cfg, mesh)
    B = cfg.max_batch
    one = build_step_input(cfg, appends={p: [ref.PAYLOAD] * B
                                         for p in range(cfg.partitions)},
                           leader=0, term=1)
    inp = put(jax.tree.map(
        lambda x: np.broadcast_to(x, (CHAIN,) + x.shape).copy(), one))
    alive = put(np.ones((cfg.partitions, 1), bool))
    quorum = put(np.ones((cfg.partitions,), np.int32))
    trims = ref._stage_trims(cfg, CHAIN * B, LAUNCHES, put)
    ref._sustained_warmup(fns, inp, alive, quorum, trims)
    _, state = ref._sustained_window(fns, inp, alive, quorum, trims, 1.0)
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _port_window(fns, cfg, put, alive, quorum, build):
    B = cfg.max_batch
    one = build(cfg, appends={p: [bench.PAYLOAD] * B
                              for p in range(cfg.partitions)},
                leader=0, term=1)
    inp = bench._stack(one, CHAIN, put)
    trims = bench._stage_trims(cfg, CHAIN * B, LAUNCHES, put)
    bench._sustained_warmup(fns, inp, alive, quorum, trims)
    _, state = bench._sustained_window(fns, inp, alive, quorum, trims, 1.0)
    return state


def _named(state) -> dict:
    from ripplemq_tpu_torch.core.state import unfuse_state

    return convert.state_to_numpy(
        unfuse_state(state) if hasattr(state, "ctrl") else state)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_spmd_window_leaves_the_reference_and_local_states(fused):
    from ripplemq_tpu_torch.parallel import mesh as _mesh
    from ripplemq_tpu_torch.parallel.engine import make_spmd_fns

    cfg = EngineConfig(**ENGINE)
    local, alive, quorum, build, put = bench._make(cfg, "cpu")
    try:
        spmd = make_spmd_fns(dataclasses.replace(cfg, fused_control=fused),
                             _mesh.make_mesh(1, 1, device="cpu"))
        state = _port_window(spmd, cfg, put, alive, quorum, build)
        got = convert.state_to_numpy(state)
        named = _named(state)
    finally:
        _mesh.shutdown()
    want = _ref_spmd_window(fused)
    assert got.keys() == want.keys()
    for name in want:  # the binding's own layout, against the reference's
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    local_state = _named(_port_window(local, cfg, put, alive, quorum, build))
    assert named.keys() == local_state.keys()
    for name in local_state:
        np.testing.assert_array_equal(named[name], local_state[name],
                                      err_msg=name)
    assert named["log_data"].any()


def test_run_spmd_parity_has_the_reference_keys_and_leaves_the_world():
    assert not dist.is_initialized()
    got = bench._run_spmd_parity(chain=CHAIN, launches=LAUNCHES,
                                 shape=ENGINE, device="cpu")
    assert not dist.is_initialized()  # no process group outlives it
    assert dict_keys(got) == ref_return_keys("_run_spmd_parity")
    assert got["spmd_binding"] == "fused_control"
    for k in ("local_appends_per_sec", "spmd_appends_per_sec",
              "spmd_legacy_appends_per_sec"):
        assert got[k] > 0
    want = round(100 * (got["spmd_appends_per_sec"]
                        - got["local_appends_per_sec"])
                 / got["local_appends_per_sec"], 2)
    assert abs(got["delta_pct"] - want) <= 0.02  # rounded inputs, 2 places


def test_run_spmd_parity_keeps_a_world_the_caller_joined():
    from ripplemq_tpu_torch.parallel import mesh as _mesh

    _mesh.make_mesh(1, 1, device="cpu")
    try:
        bench._run_spmd_parity(chain=CHAIN, launches=LAUNCHES, shape=ENGINE,
                               device="cpu")
        assert dist.is_initialized()
    finally:
        _mesh.shutdown()
    assert not dist.is_initialized()


def _ref_profile():
    spec = importlib.util.spec_from_file_location(
        "ref_spmd_scaling", os.path.join(REPO, "profiles", "spmd_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shapes_are_the_reference_ones():
    from ripplemq_tpu_torch.profiles import spmd_scaling

    assert spmd_scaling.SHAPE == _ref_profile().SHAPE
    # the engine literal of the reference's _run_spmd_parity
    import ast

    src = open(os.path.join(REPO, "bench.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "_run_spmd_parity")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "EngineConfig")
    assert bench.PARITY_SHAPE == {k.arg: ast.literal_eval(k.value)
                                  for k in call.keywords}


def test_spmd_scaling_profile_at_one_and_two_ranks(capsys):
    from ripplemq_tpu_torch.profiles import spmd_scaling

    # 8 launches of chain 8 x 64 rows = 4096 rows > 2496 slots: the ring
    # wraps on every rank (the bench's 24 launches on the card).
    rc = spmd_scaling.main(["--counts", "1,2", "--launches", "8",
                            "--windows", "2", "--device", "cpu"])
    assert rc == 0
    captured = capsys.readouterr()
    got = json.loads(captured.out.splitlines()[0])
    assert list(got) == list(ref_return_keys("_run_spmd_scaling"))
    keys = ref_return_keys("run_inner", "profiles/spmd_scaling.py")
    assert [list(p) for p in got["points"]] == [list(keys)] * 2
    shape = spmd_scaling.SHAPE
    for p, n in zip(got["points"], (1, 2)):
        assert p["devices"] == n
        assert p["partitions"] == shape["partitions"]
        assert p["local_P"] == shape["partitions"] // n
        assert p["max_batch"] == shape["max_batch"]
        assert p["appends_per_sec"] > 0
    base = got["points"][0]["appends_per_sec"]
    assert got["vs_1dev"] == {str(p["devices"]): round(
        p["appends_per_sec"] / base, 3) for p in got["points"]}
    assert "gloo" in got["method"] and "not added silicon" in got["method"]
    assert "ranks=2  local_P=128" in captured.err


def test_spmd_scaling_kills_a_world_past_its_time(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="outlived 0.5 s"):
        bench._run_spmd_scaling(device_counts=(2,), device="cpu",
                                timeout_s=0.5)
    assert not glob.glob(str(tmp_path / "spmd-scaling-*"))  # cleaned up
    assert not torch.distributed.is_initialized()

"""Port hygiene: the admission list, the import boundary, the device rule.

- `tests/torch_port_modules.PORT_TEST_MODULES` names exactly the
  `tests/test_torch_*.py` files on disk (the tier-1 admission is
  reviewed in that one list);
- no file of `ripplemq_tpu_torch/`, and not `chip_smoke.py`, imports
  `jax` or the JAX package `ripplemq_tpu` (checked on the AST, so an
  import inside a function counts too);
- `yaml` is imported only inside `load_cluster_config`;
- the engine and the erasure-coding entry points run on CUDA unless
  asked otherwise: with no device given and no GPU present,
  `make_local_fns`, `gf_matmul`, `encode_group`, `encode_segment`,
  `SegmentStore(erasure=True)`, `recover_image`, `DataPlane` and
  `convert.image_from_numpy` raise instead of falling back; a tensor on
  neither the CPU nor a GPU gets no path;
- so do the broker entry points: `BrokerServer`, `InProcCluster`,
  `ProcCluster` and `python -m ripplemq_tpu_torch.broker` (which exits
  nonzero and names `--device cpu`);
- so does `run_chaos` (and `run_kill_all_drill`), which names
  `device="cpu"`;
- a flag whose module belongs to a later slice of the port raises
  `NotImplementedError` naming that slice; the flags of slice E
  (`host_workers > 1`, `follower_reads`, `replication="striped"`) build
  the port's own planes on the broker's device, and the chaos package's
  names are the port's objects;
- a spawned host worker imports neither torch nor JAX (nor numpy).
"""

from __future__ import annotations

import ast
import pathlib

import pytest
import torch

from tests.torch_port_modules import PORT_TEST_MODULES, SLOW_PORT_MODULES, admit

admit(__name__)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ripplemq_tpu")


def _port_sources() -> list[pathlib.Path]:
    return sorted((REPO / "ripplemq_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_admission_list_matches_files_on_disk():
    on_disk = {p.stem for p in (REPO / "tests").glob("test_torch_*.py")}
    listed = PORT_TEST_MODULES + SLOW_PORT_MODULES
    assert set(listed) == on_disk
    assert len(listed) == len(set(listed))


@pytest.mark.parametrize("sub", ["analysis", "broker", "chaos", "client",
                                 "groups", "obs", "parallel", "profiles",
                                 "samples", "slo", "storage", "stripes"])
def test_import_scan_covers_subpackage(sub):
    """The scan below walks every file of the package, the subpackages
    slice D2 added (client/, slo/, chaos/, samples/), those slice E
    grew (parallel/, stripes/), slice G's analysis/ and slice H's
    profiles/ included."""
    scanned = {p.relative_to(REPO / "ripplemq_tpu_torch").parts[0]
               for p in _port_sources() if "ripplemq_tpu_torch" in p.parts}
    assert sub in scanned
    assert (REPO / "ripplemq_tpu_torch" / sub / "__init__.py").exists()


def test_admit_refuses_unlisted_module():
    with pytest.raises(AssertionError):
        admit("tests.test_torch_not_listed")


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    roots = _imported_roots(ast.parse(path.read_text(), filename=str(path)))
    assert not roots & set(FORBIDDEN), sorted(roots & set(FORBIDDEN))


def test_import_scan_catches_forbidden_forms():
    src = ("import jax.numpy as jnp\n"
           "def f():\n    from ripplemq_tpu.core import step\n"
           "importlib.import_module('jaxlib')\n")
    assert _imported_roots(ast.parse(src)) >= {"jax", "ripplemq_tpu", "jaxlib"}


def test_engine_without_device_raises_when_no_gpu(monkeypatch):
    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.parallel.engine import make_local_fns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(partitions=4, replicas=3, slots=64, slot_bytes=32,
                       max_batch=8, read_batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_fns(cfg)
    fns = make_local_fns(cfg, device="cpu")
    assert fns.init().log_data.device.type == "cpu"


def test_append_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a GPU gets no silent path."""
    from ripplemq_tpu_torch.ops.append import append_rows_active

    dev = "meta"
    log = torch.empty((2, 4, 24, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="no append path"):
        append_rows_active(
            log, torch.empty((1, 8, 32), dtype=torch.uint8, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.zeros((4,), dtype=torch.int32, device=dev),
            torch.zeros((2, 4), dtype=torch.bool, device=dev))


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _sealed_store(tmp_path):
    from ripplemq_tpu_torch.storage.segment import REC_APPEND, SegmentStore

    d = str(tmp_path / "store")
    store = SegmentStore(d, segment_bytes=256, use_native=False)
    for i in range(8):
        store.append(REC_APPEND, 0, 8 * i, bytes(range(64)))
    store.close()
    return d


def test_erasure_entry_points_raise_without_device_when_no_gpu(no_gpu,
                                                                tmp_path):
    import numpy as np

    from ripplemq_tpu_torch.broker.dataplane import recover_image
    from ripplemq_tpu_torch.core.config import EngineConfig
    from ripplemq_tpu_torch.ops.rs import gf_matmul, generator_matrix
    from ripplemq_tpu_torch.storage.erasure import encode_segment
    from ripplemq_tpu_torch.storage.segment import SegmentStore
    from ripplemq_tpu_torch.stripes.codec import encode_group

    shards = np.zeros((3, 16), np.uint8)
    store = _sealed_store(tmp_path)
    seg0 = "segment-00000000.log"
    cfg = EngineConfig(partitions=4, replicas=3, slots=64, slot_bytes=32,
                       max_batch=8, read_batch=8)
    calls = [
        lambda: gf_matmul(generator_matrix(3, 2), shards),
        lambda: encode_group([(1, 0, 0, b"x" * 40)], 1, 0),
        lambda: encode_segment(store, seg0),
        lambda: recover_image(cfg, store),
        lambda: SegmentStore(str(tmp_path / "new"), erasure=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, each runs
    assert tuple(gf_matmul(generator_matrix(3, 2), shards,
                           device="cpu").shape) == (2, 16)
    assert len(encode_group([(1, 0, 0, b"x" * 40)], 1, 0, device="cpu")) == 5
    assert len(encode_segment(store, seg0, device="cpu")) == 5
    assert recover_image(cfg, store, device="cpu") is not None
    SegmentStore(str(tmp_path / "new"), erasure=True, device="cpu").close()


def test_gf_matmul_refuses_other_devices():
    from ripplemq_tpu_torch.ops.rs import gf_matmul, generator_matrix

    shards = torch.empty((3, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no GF"):
        gf_matmul(generator_matrix(3, 2), shards)
    with pytest.raises(ValueError, match="no GF"):
        gf_matmul(generator_matrix(3, 2), torch.zeros((3, 64), dtype=torch.uint8),
                  device="meta")


def test_dataplane_without_device_raises_when_no_gpu(no_gpu):
    from ripplemq_tpu_torch.broker.dataplane import DataPlane
    from ripplemq_tpu_torch.core.config import EngineConfig

    cfg = EngineConfig(partitions=4, replicas=3, slots=64, slot_bytes=32,
                       max_batch=8, read_batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPlane(cfg)
    dp = DataPlane(cfg, device="cpu")  # built, not started: no threads
    assert dp._state.log_data.device.type == "cpu"
    dp.stop()


def test_image_from_numpy_without_device_raises_when_no_gpu(no_gpu):
    import numpy as np

    from ripplemq_tpu_torch import convert
    from ripplemq_tpu_torch.core.state import CTRL_FIELDS

    image = {name: np.zeros(4, np.int32) for name in CTRL_FIELDS}
    image["log_data"] = np.zeros((4, 16, 32), np.uint8)
    image["offsets"] = np.zeros((4, 8), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.image_from_numpy(image)
    got = convert.image_from_numpy(image, device="cpu")
    assert got.log_data.device.type == "cpu"
    assert got.log_data.dtype == torch.uint8


def _yaml_import_sites(tree: ast.AST) -> list[str]:
    """The enclosing function of every `yaml` import ("" at module level)."""
    sites = []

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "yaml" for a in node.names):
            sites.append(fn)
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "yaml"):
            sites.append(fn)
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(tree, "")
    return sites


def test_yaml_is_imported_only_inside_load_cluster_config():
    """A host without PyYAML builds its config from a dict
    (`parse_cluster_config`); only loading a YAML file needs the module."""
    sites = {}
    for path in _port_sources():
        got = _yaml_import_sites(ast.parse(path.read_text()))
        if got:
            sites[path.relative_to(REPO).as_posix()] = got
    assert sites == {"ripplemq_tpu_torch/metadata/cluster_config.py":
                     ["load_cluster_config"]}
    assert _yaml_import_sites(ast.parse("import yaml\n")) == [""]


# ------------------------------------------------------ broker entry points


def _port_cluster_config(**kw):
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config

    return make_cluster_config(n_brokers=3, **kw)


def test_broker_entry_points_raise_without_device_when_no_gpu(no_gpu,
                                                               tmp_path):
    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.chaos.cluster import InProcCluster
    from ripplemq_tpu_torch.chaos.proc_cluster import ProcCluster
    from ripplemq_tpu_torch.wire import InProcNetwork

    config = _port_cluster_config()
    calls = [
        lambda: BrokerServer(0, config, net=InProcNetwork()),
        lambda: BrokerServer(0, config, net=InProcNetwork(),
                             data_dir=str(tmp_path / "b0")),
        lambda: InProcCluster(config),
        lambda: ProcCluster(n_brokers=3, data_dir=str(tmp_path / "proc")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, each builds (nothing started: no threads)
    b = BrokerServer(0, config, net=InProcNetwork(), device="cpu",
                     data_dir=str(tmp_path / "b1"))
    assert b.device == torch.device("cpu")
    assert b._round_store.device == torch.device("cpu")
    b._round_store.close()  # never started: nothing else to stop
    cluster = InProcCluster(config, device="cpu")
    assert {x.device for x in cluster.brokers.values()} == {
        torch.device("cpu")}
    assert ProcCluster(n_brokers=3, data_dir=str(tmp_path / "proc"),
                       device="cpu").device == "cpu"


def _run_cli(tmp_path, *args, env_extra=None):
    import json
    import os
    import subprocess
    import sys

    from ripplemq_tpu_torch.chaos.proc_cluster import (
        _config_yaml_dict,
        free_ports,
        make_proc_cluster_config,
    )

    cfg_path = tmp_path / "cluster.json"
    cfg_path.write_text(json.dumps(_config_yaml_dict(
        make_proc_cluster_config(free_ports(3)))))
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "ripplemq_tpu_torch.broker", "--id", "0",
         "--config", str(cfg_path), *args],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=120)


def test_cli_without_device_exits_nonzero_when_no_gpu(tmp_path):
    # CUDA_VISIBLE_DEVICES="" hides any GPU from the child, so the
    # default (CUDA) finds none wherever this runs.
    out = _run_cli(tmp_path, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "--device cpu" in out.stderr, out.stderr


@pytest.mark.parametrize("args,names", [
    (("--coordinator", "127.0.0.1:1234", "--num-hosts", "2"),
     "--engine-workers"),
    (("--num-hosts", "2", "--coordinator", "127.0.0.1:1234",
      "--engine-workers", "127.0.0.1:1235"), "--engine-mode spmd"),
    (("--engine-workers", " , ", "--coordinator", "127.0.0.1:1234",
      "--num-hosts", "2", "--engine-mode", "spmd"), "--engine-workers"),
    (("--engine-mode", "mesh"), "invalid choice"),
], ids=["coordinator", "num-hosts", "engine-workers", "engine-mode"])
def test_cli_multi_device_flags_name_slice_f(tmp_path, args, names):
    """The multi-process flags are the reference's, with its checks: a
    world of more than one rank needs engine workers and the spmd mode,
    refused (exit 2, naming the missing flag) before the world is
    joined; the engine modes are local and spmd."""
    out = _run_cli(tmp_path, "--device", "cpu", *args)
    assert out.returncode == 2
    assert names in out.stderr, out.stderr


@pytest.mark.parametrize("kw", [
    {"engine_mode": "spmd"},
    {"engine_workers": ["127.0.0.1:1"]},
], ids=["spmd", "engine_workers"])
def test_server_later_slice_flags_raise(kw):
    """`engine_mode="spmd"` and `engine_workers` are taken as the
    reference takes them and reach the controller's DataPlane when it
    boots; building the server starts nothing."""
    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.wire import InProcNetwork

    b = BrokerServer(0, _port_cluster_config(), net=InProcNetwork(),
                     device="cpu", **kw)
    assert b._engine_mode == kw.get("engine_mode", "local")
    assert b._engine_workers == kw.get("engine_workers", [])
    assert b.dataplane is None


def _plane_of(b, flag):
    if flag == "host_workers":
        return b.hostplane
    if flag == "follower_reads":
        return b.follower_plane
    return b._make_replicator()


@pytest.mark.parametrize("flag,value,cls", [
    ("host_workers", 2, "ripplemq_tpu_torch.parallel.hostplane.HostPlane"),
    ("follower_reads", True,
     "ripplemq_tpu_torch.broker.follower.FollowerReadPlane"),
    ("replication", "striped",
     "ripplemq_tpu_torch.stripes.plane.StripeReplicator"),
])
def test_server_slice_e_flags_boot_port_planes(flag, value, cls):
    """Each flag of slice E builds a CPU broker whose plane is the port's
    own class; the striped sender and the follower plane compute on the
    broker's device (nothing is started: no workers, no threads)."""
    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.wire import InProcNetwork

    config = _port_cluster_config(**{flag: value})
    b = BrokerServer(0, config, net=InProcNetwork(), device="cpu")
    plane = _plane_of(b, flag)
    assert f"{type(plane).__module__}.{type(plane).__qualname__}" == cls
    if flag == "follower_reads":
        assert plane._decode_kw == {"device": torch.device("cpu")}
    if flag == "replication":
        assert plane.encode_kw == {"device": torch.device("cpu")}
        plane.stop()


@pytest.mark.parametrize("name", [
    "run_chaos", "run_kill_all_drill", "History", "check_history",
    "check_group_history", "Nemesis", "make_schedule"])
def test_chaos_names_are_port_objects(name):
    import ripplemq_tpu_torch.chaos as chaos

    obj = getattr(chaos, name)
    assert obj.__module__.startswith("ripplemq_tpu_torch.chaos."), (
        obj.__module__)
    assert name in chaos.__all__


def test_run_chaos_without_device_raises_when_no_gpu(no_gpu):
    from ripplemq_tpu_torch.chaos import run_chaos, run_kill_all_drill

    for call in (run_chaos, run_kill_all_drill):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(seed=0)


def test_spawned_host_worker_imports_neither_torch_nor_jax(monkeypatch,
                                                             capfd):
    """A host worker boots from a torch-free import chain. Read from
    outside the worker: CPython's import-time report (the environment
    the spawned process inherits) lists every module it imported, on the
    stderr it shares with this process."""
    import re
    import time

    from ripplemq_tpu_torch.parallel.hostplane import HostPlane

    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    hp = HostPlane(1, slot_bytes=32, payload_bytes=24, max_batch=8)
    hp.start()
    try:
        deadline = time.monotonic() + 60
        while True:  # a worker still spawning answers late, never wrongly
            try:
                hp.submit(0, [b"m"], timeout_s=5.0)
                break
            except Exception:
                assert time.monotonic() < deadline
    finally:
        hp.stop()
    imported = re.findall(r"^import time:.*\|\s*([\w.]+)\s*$",
                          capfd.readouterr().err, re.M)
    assert "ripplemq_tpu_torch.parallel.hostplane" in imported
    assert not [m for m in imported if m.split(".")[0] in (
        "torch", "jax", "jaxlib", "ripplemq_tpu", "numpy")]

"""Shared helpers of the port's DataPlane tests (not collected: the name
does not start with `test_`).

Port planes run on the CPU (`device="cpu"`) with the reference tests'
engine shape: `port_cfg(**kw)` is the port's `EngineConfig` built from
the fields of `tests.helpers.small_cfg(**kw)`. `make_config` is the
port's `chaos.cluster.make_cluster_config` and `InProcCluster` the
port's in-proc cluster on the CPU: the names the reference tests import
from `tests/broker_harness.py`. `run_chaos` is the port's harness on the
CPU. `TwinFns` drives the reference's engine and the port's in
lockstep on one config, checking every call (`make_input` is the
reference helper's, on the port's encoder, held to the reference's).
"""

from __future__ import annotations

import dataclasses

from ripplemq_tpu_torch.broker.dataplane import DataPlane
from ripplemq_tpu_torch.chaos.cluster import InProcCluster as _InProcCluster
from ripplemq_tpu_torch.chaos.cluster import (  # noqa: F401
    make_cluster_config as make_config,
)
from ripplemq_tpu_torch.core.config import EngineConfig
from tests.helpers import small_cfg, wait_until  # noqa: F401


def port_cfg(**kw) -> EngineConfig:
    return EngineConfig(**dataclasses.asdict(small_cfg(**kw)))


class InProcCluster(_InProcCluster):
    """The port's in-proc cluster with every broker on the CPU (the
    reference tests' `tests.broker_harness.InProcCluster`, on the port)."""

    def __init__(self, config=None, n_brokers=3, data_dir=None,
                 broker_kwargs=None, device="cpu"):
        super().__init__(config, n_brokers, data_dir=data_dir,
                         broker_kwargs=broker_kwargs, device=device)


def port_dp(cfg: EngineConfig, **kw) -> DataPlane:
    """A port DataPlane on the CPU (mode "local"), not started."""
    return DataPlane(cfg, mode="local", device="cpu", **kw)


def read_all(dp, slot, replica=0, start=0):
    """Walk a slot's readable log from `start`, continuing from each
    answer's next_offset, until an answer does not advance."""
    msgs, offset = [], start
    while True:
        got, nxt = dp.read(slot, offset, replica=replica)
        if nxt == offset:
            return msgs
        msgs.extend(got)
        offset = nxt


def read_committed(fns, state, replica, partition, start=0):
    """`tests.helpers.read_all` on the port: drain a partition's committed
    messages by polling storage windows (offsets are storage offsets;
    rounds are ALIGN-padded)."""
    from ripplemq_tpu_torch.core.encode import decode_entries

    out = []
    offset = start
    while True:
        data, lens, count = fns.read(state, replica, partition, offset)
        if int(count) == 0:
            return out
        out.extend(decode_entries(data, lens, count))
        offset += int(count)


def run_chaos(*args, device="cpu", **kw):
    """The port's `run_chaos` on the CPU."""
    from ripplemq_tpu_torch.chaos.harness import run_chaos as _run

    return _run(*args, device=device, **kw)


# ------------------------------------------------- the engine in lockstep


def make_input(cfg, appends=None, offset_updates=None, leader=0, term=1):
    """`tests.helpers.make_input` on the port's encoder (the same
    defaults), held equal to the reference encoder's input."""
    import numpy as np

    from ripplemq_tpu.core.encode import build_step_input as ref_build
    from ripplemq_tpu_torch.core.encode import build_step_input

    got = build_step_input(cfg, appends=appends,
                           offset_updates=offset_updates, leader=leader,
                           term=term)
    want = ref_build(cfg, appends=appends, offset_updates=offset_updates,
                     leader=leader, term=term)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    return got


def _np(x):
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_same(got, want, what):
    """Port outputs (tensors, tuples of them) equal the reference's."""
    import numpy as np

    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
        return
    np.testing.assert_array_equal(_np(got), np.asarray(want),
                                  err_msg=what)


class TwinState:
    """Both engines' states after the same calls; attribute reads answer
    from the port's (`state.log_end` is the port's tensor)."""

    def __init__(self, ref, port):
        self.ref = ref
        self.port = port

    def __getattr__(self, name):
        return getattr(self.port, name)


class TwinFns:
    """The reference's and the port's `make_local_fns` on one config,
    driven in lockstep: every call runs on both engines, and every output
    and every state leaf must be equal after it (all integers: exact).
    Each call returns the port's values, so a reference test body runs
    unchanged on the port while the reference checks every step."""

    def __init__(self, cfg):
        from ripplemq_tpu.core.config import EngineConfig as RefConfig
        from ripplemq_tpu.parallel.engine import make_local_fns as ref_make
        from ripplemq_tpu_torch.parallel.engine import make_local_fns

        self.cfg = cfg
        self.ref = ref_make(RefConfig(**dataclasses.asdict(cfg)))
        self.port = make_local_fns(cfg, device="cpu")

    @staticmethod
    def _ref_input(inp):
        import numpy as np

        from ripplemq_tpu.core.state import StepInput as RefStepInput

        return RefStepInput(*(None if x is None else np.asarray(x)
                              for x in inp))

    def _check(self, st: TwinState, what: str) -> TwinState:
        import numpy as np

        from ripplemq_tpu_torch import convert

        want = {k: np.asarray(v) for k, v in st.ref._asdict().items()}
        got = convert.state_to_numpy(st.port)
        assert got.keys() == want.keys(), what
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{what}: state.{name}")
        return st

    def init(self) -> TwinState:
        return self._check(TwinState(self.ref.init(), self.port.init()),
                           "init")

    def init_from(self, image) -> TwinState:
        from ripplemq_tpu.core.state import ReplicaState as RefReplicaState

        ref_image = RefReplicaState(*(_np(x) for x in image))
        return self._check(TwinState(self.ref.init_from(ref_image),
                                     self.port.init_from(image)), "init_from")

    def _mutate(self, name, st, inputs, args, kw, n_out):
        ref_args = [self._ref_input(x) for x in inputs] + list(args)
        r = getattr(self.ref, name)(st.ref, *ref_args, **kw)
        p = getattr(self.port, name)(st.port, *inputs, *args, **kw)
        if n_out == 0:
            return self._check(TwinState(r, p), name)
        _assert_same(tuple(p[1:]), tuple(r[1:]), name)
        return (self._check(TwinState(r[0], p[0]), name), *p[1:])

    def step(self, st, inp, *args, **kw):
        return self._mutate("step", st, [inp], args, kw, 1)

    def step_many(self, st, inp, *args, **kw):
        return self._mutate("step_many", st, [inp], args, kw, 1)

    def step_sparse(self, st, inp, *args, **kw):
        return self._mutate("step_sparse", st, [inp], args, kw, 1)

    def step_many_sparse(self, st, inp, *args, **kw):
        return self._mutate("step_many_sparse", st, [inp], args, kw, 1)

    def vote(self, st, *args, **kw):
        return self._mutate("vote", st, [], args, kw, 2)

    def resync(self, st, *args, **kw):
        return self._mutate("resync", st, [], args, kw, 0)

    def _query(self, name, st, *args):
        p = getattr(self.port, name)(st.port, *args)
        r = getattr(self.ref, name)(st.ref, *args)
        _assert_same(p if isinstance(p, tuple) else (p,),
                     tuple(r) if isinstance(r, tuple) else (r,), name)
        return p

    def read(self, st, *args):
        return self._query("read", st, *args)

    def read_many(self, st, *args):
        return self._query("read_many", st, *args)

    def read_offset(self, st, *args):
        return self._query("read_offset", st, *args)


def ref_return_keys(func: str, source: str = "bench.py"):
    """The keys of the dict literal a reference function returns, read
    from its source (`bench.py` at the repository root by default):
    {key: the nested literal's keys in the same form, or None}. `func`
    may name a nested function as "outer.inner" (the reference's
    `one_arm`s). A function with no dict-literal return gives None."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    node = ast.parse(open(os.path.join(root, source)).read())
    for name in func.split("."):
        node = next(n for n in ast.walk(node)
                    if isinstance(n, ast.FunctionDef) and n.name == name)

    def keys(v):
        if not isinstance(v, ast.Dict):
            return None
        return {k.value: keys(x) for k, x in zip(v.keys, v.values)
                if isinstance(k, ast.Constant)}

    def own_returns(n):  # not those of functions nested in `n`
        for child in ast.iter_child_nodes(n):
            if isinstance(child, ast.FunctionDef):
                continue
            if isinstance(child, ast.Return):
                yield child
            yield from own_returns(child)

    rets = [r.value for r in own_returns(node)
            if isinstance(r.value, ast.Dict)]
    return keys(rets[-1]) if rets else None


def dict_keys(d):
    """`d`'s keys in `ref_return_keys`'s form (nested dicts recursed)."""
    if not isinstance(d, dict):
        return None
    return {k: dict_keys(v) for k, v in d.items()}
